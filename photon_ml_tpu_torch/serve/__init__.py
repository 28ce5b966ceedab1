"""The device tier of online GAME scoring (counterpart of
``photon_ml_tpu/serve``, in part).

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

The scoring session, the micro-batcher, the servers, the brownout ladder
and the registry watcher are ROADMAP items 18b and 19.
"""

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

__all__ = [
    "CoeffEntry", "EntityCoefficientLRU", "LayeredCoefficientStore",
    "ModelDirCoefficientStore", "Histogram", "ServingMetrics",
    "PagedCoefficientTable", "MembershipEpoch", "MembershipManager",
    "MembershipView",
]
