"""Carry state from numpy arrays into the port's objects and back.

A JAX array becomes a numpy array under ``np.asarray``; these functions take
such arrays (or any numpy input) and build the port's tensors on ``device``
(default ``cuda``). A GLM's only weights are its coefficient vector ``w``
and the normalization vectors. Host-side objects of the JAX package cross
by their numpy fields (duck-typed, so nothing of that package is imported
here): a ``HostSparse`` becomes a port batch, a ``GameDataset`` the port's
``GameDataset``, and a ``GameModel`` the port's ``GameModel``. Saved models make the same crossing through files
(``io/model_io.py`` writes the JAX package's layout).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.game.data import HostSparse, SketchProjection
from photon_ml_tpu_torch.models import (
    Coefficients, FixedEffectModel, GameModel, GeneralizedLinearModel,
    RandomEffectBucket, RandomEffectModel,
)
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.types import (
    CSCTranspose, LabeledBatch, SparseFeatures, resolve_device,
)


def _tensor(a, dtype, dev) -> torch.Tensor:
    # np.array copies: arrays exported from JAX are read-only
    return torch.from_numpy(np.array(a)).to(device=dev, dtype=dtype)


def w_from_numpy(w, dtype=torch.float32, device=None) -> torch.Tensor:
    return _tensor(w, dtype, resolve_device(device))


def w_to_numpy(w: torch.Tensor) -> np.ndarray:
    return w.detach().cpu().numpy()


def batch_from_numpy(indices, values, labels, offsets=None, weights=None,
                     dim: Optional[int] = None, dtype=torch.float32,
                     device=None) -> LabeledBatch:
    """An ELL LabeledBatch from numpy ``indices`` [n, k] and ``values``
    [n, k] (None: implicit ones). ``dim`` defaults to max index + 1."""
    dev = resolve_device(device)
    indices = np.asarray(indices)
    if dim is None:
        dim = int(indices.max()) + 1 if indices.size else 0
    n = indices.shape[0]
    feats = SparseFeatures(
        indices=_tensor(indices, torch.int32, dev),
        values=None if values is None else _tensor(values, dtype, dev),
        dim=int(dim))
    return LabeledBatch(
        feats,
        _tensor(labels, dtype, dev),
        (torch.zeros(n, dtype=dtype, device=dev) if offsets is None
         else _tensor(offsets, dtype, dev)),
        (torch.ones(n, dtype=dtype, device=dev) if weights is None
         else _tensor(weights, dtype, dev)),
    )


def csc_from_numpy(values, rows, col_starts, dtype=torch.float32,
                   device=None) -> CSCTranspose:
    """A CSCTranspose from the numpy form of the JAX package's view (its
    ``values`` may be None: implicit ones)."""
    dev = resolve_device(device)
    return CSCTranspose(
        values=None if values is None else _tensor(values, dtype, dev),
        rows=_tensor(rows, torch.int32, dev),
        col_starts=_tensor(col_starts, torch.int32, dev))


def normalization_from_numpy(factors, shifts, intercept_index: int = -1,
                             dtype=torch.float32,
                             device=None) -> NormalizationContext:
    dev = resolve_device(device)
    return NormalizationContext(
        factors=None if factors is None else _tensor(factors, dtype, dev),
        shifts=None if shifts is None else _tensor(shifts, dtype, dev),
        intercept_index=intercept_index)


def batch_from_host_sparse(features, labels, offsets=None, weights=None,
                           dtype=torch.float32, device=None) -> LabeledBatch:
    """A LabeledBatch from a host-side padded sparse matrix: the port's or
    the JAX package's ``HostSparse`` (numpy ``indices``, ``values`` or None,
    and ``dim``)."""
    return batch_from_numpy(features.indices, features.values, labels,
                            offsets, weights, dim=features.dim, dtype=dtype,
                            device=device)


def _optional(a, dtype, dev) -> Optional[torch.Tensor]:
    return None if a is None else _tensor(a, dtype, dev)


def game_model_from_numpy(model, dtype=torch.float64,
                          device=None) -> GameModel:
    """The port's GameModel from a GameModel of the JAX package (or any
    object of the same shape): fixed-effect coefficients become tensors on
    ``device`` (default ``cuda``); random-effect buckets stay host numpy
    arrays, as the port's model loader keeps them."""
    dev = resolve_device(device)
    coords = {}
    for name, coord in model.coordinates.items():
        if hasattr(coord, "buckets"):  # a random effect
            buckets = [RandomEffectBucket(
                list(b.entity_ids), np.array(b.coefficients),
                np.array(b.projection),
                None if b.variances is None else np.array(b.variances),
                sketch=(None if b.sketch is None
                        else SketchProjection(b.sketch.dim, b.sketch.seed)))
                for b in coord.buckets]
            coords[name] = RandomEffectModel(
                coord.effect_name, buckets, coord.task, coord.feature_shard,
                entity_column=coord.entity_column)
        else:
            glm = coord.model
            coef = glm.coefficients
            coords[name] = FixedEffectModel(
                GeneralizedLinearModel(
                    Coefficients(_tensor(coef.means, dtype, dev),
                                 _optional(coef.variances, dtype, dev)),
                    glm.task),
                coord.feature_shard)
    return GameModel(coords, model.task)


def game_dataset_from_numpy(dataset):
    """The port's GameDataset from a GameDataset of the JAX package (or any
    object of the same shape): host numpy throughout, as both packages keep
    it. Disk-backed shards (``feature_sources``) are not carried: the JAX
    package's chunk sources cannot cross."""
    from photon_ml_tpu_torch.game.descent import GameDataset

    if getattr(dataset, "feature_sources", None):
        raise ValueError(
            "a GameDataset with feature_sources (disk-backed shards) cannot "
            "cross: build the port's io.stream_source.AvroChunkSource over "
            "the same files and pass it as the port's "
            "GameDataset(feature_sources=...)")
    features = {
        name: HostSparse(np.array(sp.indices),
                         None if sp.values is None else np.array(sp.values),
                         int(sp.dim))
        for name, sp in dataset.features.items()}
    return GameDataset(
        features, np.array(dataset.labels), np.array(dataset.weights),
        np.array(dataset.offsets),
        {k: np.array(v) for k, v in dataset.entity_ids.items()},
        None if dataset.group_ids is None else np.array(dataset.group_ids))
