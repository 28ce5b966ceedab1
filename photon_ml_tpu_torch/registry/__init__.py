"""Model lifecycle: versioned registry, delta publish, promotion gate
(counterpart of ``photon_ml_tpu/registry``; host code, except the gate's
scoring, which runs on the entry points' device).

The training drivers produce model directories; the serving stack keeps
one resident. This package is the seam between them: the train->deploy
pipeline as a first-class system, not a "restart the server at a new
path" afterthought:

* :class:`~photon_ml_tpu_torch.registry.store.ModelRegistry` — append-only
  versioned store: every publish lands an immutable ``versions/<v>/``
  via temp-dir + atomic rename, with a manifest carrying per-artifact
  content fingerprints (``parallel/resilience.ResumeManager``'s
  fingerprint contract) and a
  ``LATEST`` pointer written last; retention GC never collects the live
  version or its delta ancestry.
* :mod:`~photon_ml_tpu_torch.registry.delta` — incremental publish: a version
  may carry only the CHANGED per-entity random-effect records (plus
  optional replacement fixed-effect coordinates), resolved against its
  parent chain at load time — a retrain that touched 1% of entities
  publishes 1% of the bytes.
* :mod:`~photon_ml_tpu_torch.registry.gate` — promotion gate: score a
  held-out Avro shard through ``game/scoring.py``, compare
  ``evaluation/`` metrics against the live version, refuse to move
  ``LATEST`` on regression beyond tolerance, and record the verdict in
  the manifest.

Serving-side hot swap lives in ``serve/`` (``ScoringSession.swap``,
``/admin/reload``, ``serve/watcher.py``).
"""

from photon_ml_tpu_torch.registry.store import (
    ModelRegistry,
    RegistryError,
    ResolvedVersion,
)
from photon_ml_tpu_torch.registry.delta import (
    compute_delta,
    materialize,
    publish_delta,
)
from photon_ml_tpu_torch.registry.gate import GateVerdict, run_gate

__all__ = [
    "ModelRegistry", "RegistryError", "ResolvedVersion",
    "compute_delta", "materialize", "publish_delta",
    "GateVerdict", "run_gate",
]
