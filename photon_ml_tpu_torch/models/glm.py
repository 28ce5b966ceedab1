"""Model types: coefficients, GLMs, fixed/random-effect and GAME composites
(counterpart of ``photon_ml_tpu/models/glm.py``, as plain dataclasses).

A random-effect model is a set of dense coefficient matrices, one
``[num_entities, local_dim]`` array per size bucket, plus host-side entity
ids and per-entity projections into the global feature space. Task type is
carried as the loss name; the inverse link for scoring comes from the loss
(``PointwiseLoss.mean``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.types import Features, margins as _margins


@dataclasses.dataclass(frozen=True)
class Coefficients:
    """Means + optional variances."""

    means: torch.Tensor
    variances: Optional[torch.Tensor] = None

    @property
    def dim(self) -> int:
        return self.means.shape[-1]


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    """A single GLM: score = margin = x.w (+ offset); mean = inv_link(margin)."""

    coefficients: Coefficients
    task: str = "logistic"

    @property
    def loss(self):
        return get_loss(self.task)

    def score(self, features: Features, offsets=0.0) -> torch.Tensor:
        return _margins(features, self.coefficients.means) + offsets

    def predict_mean(self, features: Features, offsets=0.0) -> torch.Tensor:
        return self.loss.mean(self.score(features, offsets))


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """Global coefficients over one feature shard."""

    model: GeneralizedLinearModel
    feature_shard: str = "global"

    def score(self, features: Features, offsets=0.0) -> torch.Tensor:
        return self.model.score(features, offsets)


@dataclasses.dataclass(frozen=True)
class RandomEffectBucket:
    """Per-entity coefficients for one size bucket.

    Attributes:
      entity_ids: host-side sequence of entity keys, length E.
      coefficients: [E, D_local] per-entity coefficients in local subspace.
      projection: int32 [E, D_local], the global feature id of each local
        slot, -1 for padding slots.
      variances: optional [E, D_local].
      sketch: set when the bucket's local space is a count-sketch instead of
        an exact subspace; projection is then all -1.
    """

    entity_ids: Sequence
    coefficients: np.ndarray | torch.Tensor
    projection: np.ndarray | torch.Tensor
    variances: Optional[np.ndarray] = None
    sketch: Optional[object] = None


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """All per-entity GLMs for one random effect (e.g. per user), in
    bucketed dense matrices plus an entity -> (bucket, row) index."""

    effect_name: str
    buckets: Sequence[RandomEffectBucket]
    task: str = "logistic"
    feature_shard: str = "global"
    # which dataset entity-id column keys this effect (e.g. "userId")
    entity_column: str = ""

    def entity_index(self) -> Dict:
        """entity id -> (bucket_idx, row) mapping (host side)."""
        out = {}
        for b, bucket in enumerate(self.buckets):
            for r, eid in enumerate(bucket.entity_ids):
                out[eid] = (b, r)
        return out

    @property
    def num_entities(self) -> int:
        return sum(len(b.entity_ids) for b in self.buckets)

    def coefficients_for(self, entity_id) -> Optional[np.ndarray]:
        """Dense global-space coefficient vector for one entity (host-side
        convenience; bulk scoring uses the bucketed arrays directly)."""
        for bucket in self.buckets:
            try:
                row = list(bucket.entity_ids).index(entity_id)
            except ValueError:
                continue
            proj = _host(bucket.projection[row])
            coef = _host(bucket.coefficients[row])
            dim = int(proj.max()) + 1 if (proj >= 0).any() else 0
            out = np.zeros(max(dim, 0))
            valid = proj >= 0
            out[proj[valid]] = coef[valid]
            return out
        return None


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Composite additive model: total score = sum of coordinate scores.
    Keys are coordinate names in training order."""

    coordinates: Mapping[str, FixedEffectModel | RandomEffectModel]
    task: str = "logistic"

    def __getitem__(self, name):
        return self.coordinates[name]

    @property
    def loss(self):
        return get_loss(self.task)
