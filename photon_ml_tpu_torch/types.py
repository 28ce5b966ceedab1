"""Core batched data types (counterpart of ``photon_ml_tpu/types.py``).

A :class:`LabeledBatch` holds one batch of weighted, offset labeled examples
as device tensors. Sparse features use the row-padded ELL layout
(``indices``/``values`` of shape ``[n, k]``): padding slots carry value 0 and
contribute nothing, whatever their index. ``values=None`` is the
implicit-ones layout of one-hot rows.

``X^T d`` has two forms here: the scatter-add :func:`transpose_apply`
(``index_add_``, which on CUDA sums in atomic order) and the scatter-free,
deterministic column-sorted form (:class:`CSCTranspose`,
:func:`csc_transpose_apply`, :func:`blocked_boundary_combine`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point places its tensors on: ``cuda`` unless the
    caller names another. Raises when CUDA is asked for (explicitly or by
    default) and none is present, so that nothing silently runs on the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class SparseFeatures:
    """Row-padded sparse feature matrix (ELL layout).

    Attributes:
      indices: int32 ``[n, k]`` column ids.
      values: ``[n, k]`` feature values, 0 in padding slots; ``None`` for the
        implicit-ones layout (every slot is a real feature of value 1).
      dim: number of feature columns.
    """

    indices: torch.Tensor
    values: Optional[torch.Tensor]
    dim: int


Features = Union[torch.Tensor, SparseFeatures]


@dataclasses.dataclass(frozen=True)
class CSCTranspose:
    """Column-sorted view of a SparseFeatures batch for scatter-free
    transpose products. The sparsity pattern is fixed across optimizer
    iterations, so the nonzeros are sorted by column once and ``X^T d`` is
    computed as gather -> tile-local prefix sum -> boundary combine: no
    atomics, so the result does not depend on scheduling.

    Attributes:
      values: [nnz] feature values sorted by column id (None: implicit ones).
      rows: [nnz] int32 row id of each sorted nonzero.
      col_starts: [dim+1] int32; column j's nonzeros occupy
        ``[col_starts[j], col_starts[j+1])``.
    """

    values: Optional[torch.Tensor]
    rows: torch.Tensor
    col_starts: torch.Tensor


def build_csc_transpose(indices: torch.Tensor, values: Optional[torch.Tensor],
                        dim: int) -> CSCTranspose:
    """Sort the padded ELL nonzeros by column. The sort is stable, so ties
    keep row order and the view is identical to the JAX package's (whose
    ``jnp.argsort`` is stable). Padding slots (value 0) are kept: they land
    in their index's run and contribute 0."""
    k = indices.shape[1]
    flat_idx = indices.reshape(-1)
    order = torch.argsort(flat_idx, stable=True)
    sorted_cols = flat_idx[order].to(torch.int32)
    return CSCTranspose(
        values=None if values is None else values.reshape(-1)[order],
        rows=torch.div(order, k, rounding_mode="floor").to(torch.int32),
        col_starts=torch.searchsorted(
            sorted_cols,
            torch.arange(dim + 1, dtype=torch.int32, device=indices.device),
            side="left", out_int32=True),
    )


def csc_transpose_apply(csc: CSCTranspose, d: torch.Tensor,
                        block: int = 1 << 16) -> torch.Tensor:
    """``X^T d`` from the column-sorted view, with no scatter.

    Blocked two-level scheme whose f32 error does not grow with nnz: the
    contributions reshape to ``[B, block]``, each block gets a local
    inclusive cumsum, and :func:`blocked_boundary_combine` forms each
    column's sum from block-local prefixes (a single global prefix would
    cancel catastrophically once it dwarfs a column's own sum)."""
    dg = d[csc.rows]
    contrib = dg if csc.values is None else csc.values * dg
    nnz = contrib.shape[0]
    if nnz == 0:
        return torch.zeros(csc.col_starts.shape[0] - 1, dtype=d.dtype,
                           device=d.device)
    T = min(block, nnz)
    B = -(-nnz // T)
    padded = torch.zeros(B * T, dtype=contrib.dtype, device=contrib.device)
    padded[:nnz] = contrib
    local = torch.cumsum(padded.view(B, T), dim=1)
    return blocked_boundary_combine(local.reshape(-1), local[:, -1],
                                    csc.col_starts, T).to(d.dtype)


def blocked_boundary_combine(local_flat: torch.Tensor, bt: torch.Tensor,
                             col_starts: torch.Tensor, T: int) -> torch.Tensor:
    """Column sums from BLOCK-LOCAL inclusive prefixes.

    ``local_flat``: [B*T] inclusive prefix sums that restart at every block
    boundary; ``bt``: [B] block totals. A column inside one block
    differences local prefixes only; a spanning column takes first-block
    suffix + interior block totals + last-block head, so no difference
    cancels against a prefix that outgrew the column's own sum."""
    B = bt.shape[0]
    zero = torch.zeros(1, dtype=bt.dtype, device=bt.device)
    # exclusive prefix of block totals; read only for spanning columns
    BP = torch.cat([zero, torch.cumsum(bt, 0)])
    cs = col_starts.to(torch.int64)
    b, r = cs // T, cs % T
    # local exclusive prefix at each boundary: local[b, r-1], 0 at r == 0
    lp = torch.where(r > 0, local_flat[torch.clamp(cs - 1, min=0)], zero)
    b0, b1 = b[:-1], b[1:]
    lp0, lp1 = lp[:-1], lp[1:]
    suffix0 = bt[torch.clamp(b0, max=B - 1)] - lp0
    mid = BP[b1] - BP[torch.clamp(b0 + 1, max=B)]  # exact 0 when b1 == b0+1
    return torch.where(b0 == b1, lp1 - lp0, suffix0 + mid + lp1)


def margins(features: Features, w: torch.Tensor) -> torch.Tensor:
    """Per-row margin ``x_i . w`` for dense ``[n, d]`` or sparse features."""
    if isinstance(features, SparseFeatures):
        gathered = w[features.indices]
        if features.values is None:  # implicit ones: no value read
            return gathered.sum(dim=-1)
        return (features.values * gathered).sum(dim=-1)
    return features @ w


def transpose_apply(features: Features, d: torch.Tensor) -> torch.Tensor:
    """``X^T d`` as a scatter-add over the padded layout (``index_add_``;
    on CUDA it sums in atomic order)."""
    if isinstance(features, SparseFeatures):
        n, k = features.indices.shape
        if features.values is None:
            contrib = d[:, None].expand(n, k)
        else:
            contrib = features.values * d[:, None]
        out = torch.zeros(features.dim, dtype=contrib.dtype, device=d.device)
        return out.index_add_(0, features.indices.reshape(-1),
                              contrib.reshape(-1))
    return features.T @ d


@dataclasses.dataclass(frozen=True)
class LabeledBatch:
    """A batch of weighted, offset labeled examples. Objectives use sum
    semantics; ``offsets`` add to margins and ``weights`` multiply
    per-example losses (weight-0 rows are padding)."""

    features: Features
    labels: torch.Tensor
    offsets: torch.Tensor
    weights: torch.Tensor

    @property
    def num_examples(self) -> int:
        return self.labels.shape[0]

    @property
    def dim(self) -> int:
        if isinstance(self.features, SparseFeatures):
            return self.features.dim
        return self.features.shape[1]

    @property
    def device(self) -> torch.device:
        return self.labels.device


def make_batch(features, labels, offsets=None, weights=None,
               dtype=torch.float32, device=None) -> LabeledBatch:
    """Build a LabeledBatch on ``device`` (default ``cuda``) from host or
    device data: ``features`` is a SparseFeatures or a dense ``[n, d]``
    array."""
    dev = resolve_device(device)

    def real(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    labels = real(labels)
    n = labels.shape[0]
    offsets = (torch.zeros(n, dtype=dtype, device=dev) if offsets is None
               else real(offsets))
    weights = (torch.ones(n, dtype=dtype, device=dev) if weights is None
               else real(weights))
    if isinstance(features, SparseFeatures):
        features = SparseFeatures(
            indices=torch.as_tensor(features.indices, dtype=torch.int32,
                                    device=dev),
            values=(None if features.values is None
                    else real(features.values)),
            dim=features.dim)
    else:
        features = real(features)
    return LabeledBatch(features, labels, offsets, weights)
