"""Online GAME scoring (counterpart of ``photon_ml_tpu/serve``, in part).

The batch path (``cli/game_scoring_driver.py``) loads a model, scores a
dataset and exits; this package keeps a model RESIDENT on the card and
answers scoring requests while it stays loaded:

* :class:`~photon_ml_tpu_torch.serve.session.ScoringSession` — the fixed
  effects resident on the card, one CUDA graph captured per rung of a
  bounded ladder of padded batch shapes (steady-state traffic never
  captures), random effects through the paged table or the LRU, hot swap
  and rollback;
* :class:`~photon_ml_tpu_torch.serve.batcher.MicroBatcher` — deadline-based
  micro-batching (``max_batch`` / ``max_delay_ms``) with a bounded
  admission queue, explicit load shedding and a stuck-batch watchdog;
* :class:`~photon_ml_tpu_torch.serve.brownout.BrownoutController` — raises
  the default degradation level under sustained queue-wait overload;
* :class:`~photon_ml_tpu_torch.serve.server.ScoringService` /
  :class:`~photon_ml_tpu_torch.serve.server.ScoringServer` — the
  stdlib-only JSON endpoint (``/score``, ``/admin/reload``,
  ``/admin/membership``, ``/healthz``, ``/metrics``) on a threaded HTTP
  server;
* :class:`~photon_ml_tpu_torch.serve.aserver.AsyncScoringServer` — the
  same endpoints on an asyncio event loop, and
  :class:`~photon_ml_tpu_torch.serve.aserver.AsyncFrontDoor` — the reverse
  proxy over N replica processes (least-loaded or round-robin, circuit
  breakers, hedging, entity-affinity routing, ``/fd/metrics``);
* :class:`~photon_ml_tpu_torch.serve.watcher.RegistryWatcher` — follows a
  model registry's ``LATEST`` and hot-swaps the session;
* :class:`~photon_ml_tpu_torch.serve.paged_table.PagedCoefficientTable` —
  the hot entities' random-effect coefficients resident on the card in
  pages, scored by the hand-written kernel
  ``ops.kernels.paged_gather_score``;
* :class:`~photon_ml_tpu_torch.serve.coeff_cache.EntityCoefficientLRU`
  over :class:`~photon_ml_tpu_torch.serve.coeff_cache
  .ModelDirCoefficientStore` (or a delta chain,
  :class:`~photon_ml_tpu_torch.serve.coeff_cache.LayeredCoefficientStore`)
  — the host tier that faults cold entities in from a saved model;
* :class:`~photon_ml_tpu_torch.serve.membership.MembershipManager` /
  :class:`~photon_ml_tpu_torch.serve.membership.MembershipView` — which
  replica owns which entity;
* :class:`~photon_ml_tpu_torch.serve.metrics.ServingMetrics` and
  :class:`~photon_ml_tpu_torch.serve.metrics.Histogram`.
"""

from photon_ml_tpu_torch.serve.batcher import (
    BatchWatchdogTimeout,
    MicroBatcher,
    QueueFullError,
    ScoreContext,
)
from photon_ml_tpu_torch.serve.brownout import BrownoutController
from photon_ml_tpu_torch.serve.coeff_cache import (
    CoeffEntry,
    EntityCoefficientLRU,
    LayeredCoefficientStore,
    ModelDirCoefficientStore,
)
from photon_ml_tpu_torch.serve.membership import (
    MembershipEpoch,
    MembershipManager,
    MembershipView,
)
from photon_ml_tpu_torch.serve.metrics import Histogram, ServingMetrics
from photon_ml_tpu_torch.serve.paged_table import PagedCoefficientTable
from photon_ml_tpu_torch.serve.server import ScoringServer, ScoringService
from photon_ml_tpu_torch.serve.session import ScoringSession
from photon_ml_tpu_torch.serve.aserver import AsyncFrontDoor, AsyncScoringServer
from photon_ml_tpu_torch.serve.watcher import RegistryWatcher

__all__ = [
    "ScoringSession", "MicroBatcher", "QueueFullError", "ScoreContext",
    "BrownoutController", "BatchWatchdogTimeout", "CoeffEntry",
    "EntityCoefficientLRU", "LayeredCoefficientStore",
    "ModelDirCoefficientStore", "Histogram", "ServingMetrics",
    "PagedCoefficientTable", "ScoringService", "ScoringServer",
    "AsyncScoringServer", "AsyncFrontDoor", "RegistryWatcher",
    "MembershipEpoch", "MembershipManager", "MembershipView",
]
