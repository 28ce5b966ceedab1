"""Score datasets with a trained GameModel (counterpart of
``photon_ml_tpu/game/scoring.py``).

Fixed effects add ``x . w`` per row; random effects join rows to their
entity's model through a host-side projection onto each entity's local
subspace, then the same bucketed gather/dot/row-write used in training
(``random_effect.score_random_effect``). Scores land on ``device``
(default ``cuda``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.game.data import (
    build_score_buckets, group_rows_by_slot, host_sparse_from_features,
)
from photon_ml_tpu_torch.game.random_effect import score_random_effect
from photon_ml_tpu_torch.models import (
    FixedEffectModel, GameModel, RandomEffectModel,
)
from photon_ml_tpu_torch.types import (
    SparseFeatures, margins as _margins, resolve_device,
)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def fixed_effect_margins(sp, coord: FixedEffectModel, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Per-row margins of one fixed-effect coordinate over a HostSparse
    batch."""
    dev = resolve_device(device)
    feats = SparseFeatures(
        torch.as_tensor(sp.indices, dtype=torch.int32, device=dev),
        None if sp.values is None
        else torch.as_tensor(sp.values, device=dev).to(dtype),
        dim=sp.dim)
    w = torch.as_tensor(coord.model.coefficients.means, device=dev).to(dtype)
    return _margins(feats, w)


def build_model_score_views(
    model: GameModel,
    host: Dict[str, object],
    entity_ids: Dict[str, np.ndarray],
) -> Dict[str, tuple]:
    """Random-effect score views for every random coordinate: coordinate
    name -> (views, coeffs) as :func:`score_single_batch` consumes them."""
    out = {}
    for name, coord in model.coordinates.items():
        if isinstance(coord, RandomEffectModel):
            ids = _entity_ids_for(entity_ids, coord, name)
            out[name] = _model_score_view(coord, host[coord.feature_shard],
                                          ids)
    return out


def score_single_batch(
    model: GameModel,
    features: Dict[str, object],
    score_views: Dict[str, tuple],
    offsets: Optional[np.ndarray] = None,
    dtype=torch.float32,
    per_coordinate: bool = False,
    fixed_scorer=None,
    device=None,
):
    """Score one batch through pre-built random-effect score views
    (``score_views``: coordinate name -> ``(views, coeffs)``).
    ``fixed_scorer(name, coord, host_sparse) -> [n] margins`` optionally
    overrides how a fixed-effect coordinate's margins are computed."""
    dev = resolve_device(device)
    host = {k: host_sparse_from_features(v) for k, v in features.items()}
    n = next(iter(host.values())).num_rows
    total = (torch.zeros(n, dtype=dtype, device=dev) if offsets is None
             else torch.as_tensor(offsets, device=dev).to(dtype))
    parts = {}
    for name, coord in model.coordinates.items():
        if isinstance(coord, FixedEffectModel):
            sp = host[coord.feature_shard]
            s = (fixed_scorer(name, coord, sp) if fixed_scorer is not None
                 else fixed_effect_margins(sp, coord, dtype, dev))
        else:
            views, coeffs = score_views[name]
            s = score_random_effect(views, coeffs, n, dtype, device=dev)
        parts[name] = s
        total = total + s
    if per_coordinate:
        return total, parts
    return total


def _model_score_view(re_model: RandomEffectModel, sp, entity_ids):
    """Score-view buckets built directly from a RandomEffectModel's
    projections (scoring without the original training data)."""
    per_bucket_rows = group_rows_by_slot(
        entity_ids, re_model.entity_index(),
        [len(b.entity_ids) for b in re_model.buckets],
    )
    local_maps_per_bucket = []
    coeffs = []
    for bucket in re_model.buckets:
        if bucket.sketch is not None:
            local_maps_per_bucket.append(
                [bucket.sketch] * len(bucket.entity_ids))
        else:
            proj = _host(bucket.projection)
            local_maps_per_bucket.append(
                [{int(g): s for s, g in enumerate(proj[r]) if g >= 0}
                 for r in range(len(bucket.entity_ids))])
        coeffs.append(_host(bucket.coefficients))
    views = build_score_buckets(sp, per_bucket_rows, local_maps_per_bucket)
    return views, coeffs


def score_game_model(
    model: GameModel,
    features: Dict[str, object],
    entity_ids: Optional[Dict[str, np.ndarray]] = None,
    offsets: Optional[np.ndarray] = None,
    dtype=torch.float32,
    per_coordinate: bool = False,
    device=None,
):
    """Total score (sum of coordinate scores + offsets) for each row.
    Random-effect coordinates look up ids under their entity column (or
    the coordinate or effect name)."""
    entity_ids = entity_ids or {}
    host = {k: host_sparse_from_features(v) for k, v in features.items()}
    views = build_model_score_views(model, host, entity_ids)
    return score_single_batch(model, host, views, offsets=offsets,
                              dtype=dtype, per_coordinate=per_coordinate,
                              device=device)


def _entity_ids_for(entity_ids: Dict, coord: RandomEffectModel, name: str):
    for key in (coord.entity_column, name, coord.effect_name):
        if key and key in entity_ids:
            return entity_ids[key]
    raise ValueError(
        f"scoring random effect '{name}' needs entity ids under key "
        f"'{coord.entity_column or name}' (have: {sorted(entity_ids)})")
