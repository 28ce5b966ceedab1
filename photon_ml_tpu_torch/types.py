"""Core batched data types (counterpart of ``photon_ml_tpu/types.py``).

A :class:`LabeledBatch` holds one batch of weighted, offset labeled examples
as device tensors. Sparse features use the row-padded ELL layout
(``indices``/``values`` of shape ``[n, k]``): padding slots carry value 0 and
contribute nothing, whatever their index. ``values=None`` is the
implicit-ones layout of one-hot rows.

``X^T d`` has two forms here: the scatter-add :func:`transpose_apply`
(``index_add_``, which on CUDA sums in atomic order) and the scatter-free,
deterministic column-sorted forms (:class:`CSCTranspose`:
:func:`csc_transpose_apply` with :func:`blocked_boundary_combine`, and the
sorted segment sum :func:`csc_segment_apply`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
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

    @property
    def num_rows(self) -> int:
        return self.indices.shape[0]

    def slice_rows(self, start: int, size: int) -> "SparseFeatures":
        return SparseFeatures(
            indices=self.indices[start:start + size],
            values=(None if self.values is None
                    else self.values[start:start + size]),
            dim=self.dim)

    def todense(self) -> torch.Tensor:
        n, k = self.indices.shape
        dev = self.indices.device
        dtype = torch.float32 if self.values is None else self.values.dtype
        vals = (torch.ones((n, k), dtype=dtype, device=dev)
                if self.values is None else self.values)
        out = torch.zeros(n * self.dim, dtype=dtype, device=dev)
        rows = torch.arange(n, device=dev)[:, None] * self.dim
        flat = (rows + self.indices.to(torch.int64)).reshape(-1)
        return out.index_add_(0, flat, vals.reshape(-1)).view(n, self.dim)


Features = Union[torch.Tensor, SparseFeatures]


@dataclasses.dataclass(frozen=True)
class CSCTranspose:
    """Column-sorted view of a SparseFeatures batch for scatter-free
    transpose products. The sparsity pattern is fixed across optimizer
    iterations, so the nonzeros are sorted by column once and ``X^T d`` is
    computed from them with no atomics (the plain blocked prefix of
    :func:`csc_transpose_apply`, or the kernel's one-pass column sums), so
    the result does not depend on scheduling.

    Attributes:
      values: [nnz] feature values sorted by column id (None: implicit ones).
      rows: [nnz] int32 row id of each sorted nonzero.
      col_starts: [dim+1] int32; column j's nonzeros occupy
        ``[col_starts[j], col_starts[j+1])``.
      cols: [nnz] int32 sorted column id of each nonzero, or None; only
        :func:`csc_segment_apply` reads it.
    """

    values: Optional[torch.Tensor]
    rows: torch.Tensor
    col_starts: torch.Tensor
    cols: Optional[torch.Tensor] = None


def build_csc_transpose(indices: torch.Tensor, values: Optional[torch.Tensor],
                        dim: int, with_cols: bool = True) -> CSCTranspose:
    """Sort the padded ELL nonzeros by column. The sort is stable, so ties
    keep row order and the view is identical to the JAX package's (whose
    ``jnp.argsort`` is stable). Padding slots (value 0) are kept: they land
    in their index's run and contribute 0. ``with_cols=False`` drops the
    sorted column ids (4 B per nonzero) when the segment apply is not
    used."""
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
        cols=sorted_cols if with_cols else None,
    )


def csc_transpose_apply(csc: CSCTranspose, d: torch.Tensor,
                        precise: bool = False,
                        block: int = 1 << 16) -> torch.Tensor:
    """``X^T d`` from the column-sorted view, with no scatter.

    Blocked two-level scheme whose f32 error does not grow with nnz: the
    contributions reshape to ``[B, block]``, each block gets a local
    inclusive cumsum, and :func:`blocked_boundary_combine` forms each
    column's sum from block-local prefixes (a single global prefix would
    cancel catastrophically once it dwarfs a column's own sum). The local
    prefixes are float64 whatever the input dtype, so each column sum
    rounds once, after the difference. ``precise=True`` takes one float64 global prefix
    instead and differences it at the column boundaries."""
    dg = d[csc.rows]
    contrib = dg if csc.values is None else csc.values * dg
    if precise:
        prefix = torch.cat([
            torch.zeros(1, dtype=torch.float64, device=d.device),
            torch.cumsum(contrib.to(torch.float64), 0)])
        cs = csc.col_starts.to(torch.int64)
        return (prefix[cs[1:]] - prefix[cs[:-1]]).to(d.dtype)
    nnz = contrib.shape[0]
    if nnz == 0:
        return torch.zeros(csc.col_starts.shape[0] - 1, dtype=d.dtype,
                           device=d.device)
    T = min(block, nnz)
    B = -(-nnz // T)
    padded = torch.zeros(B * T, dtype=contrib.dtype, device=contrib.device)
    padded[:nnz] = contrib
    local = torch.cumsum(padded.view(B, T), dim=1, dtype=torch.float64)
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


def csc_segment_apply(csc: CSCTranspose, d: torch.Tensor) -> torch.Tensor:
    """``X^T d`` from the column-sorted view as a sorted segment sum: each
    column sums its own run of ``col_starts`` in order, with no atomics."""
    if csc.cols is None:
        raise ValueError("csc.cols missing: rebuild the CSC view with "
                         "with_cols=True")
    dg = d[csc.rows]
    contrib = dg if csc.values is None else csc.values * dg
    lengths = torch.diff(csc.col_starts.to(torch.int64))
    return torch.segment_reduce(contrib, "sum", lengths=lengths, unsafe=True)


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


def row_squares_apply(features: Features, d: torch.Tensor) -> torch.Tensor:
    """``sum_i d_i * x_i^2`` (elementwise square), the diagonal-Hessian and
    second-moment contraction, as a scatter-add like
    :func:`transpose_apply`."""
    if isinstance(features, SparseFeatures):
        if features.values is None:  # 1^2 == 1
            return transpose_apply(features, d)
        contrib = (features.values ** 2) * d[:, None]
        out = torch.zeros(features.dim, dtype=contrib.dtype, device=d.device)
        return out.index_add_(0, features.indices.reshape(-1),
                              contrib.reshape(-1))
    return (features ** 2).T @ d


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

    def with_offsets(self, offsets: torch.Tensor) -> "LabeledBatch":
        return dataclasses.replace(self, offsets=offsets)

    def slice_rows(self, start: int, size: int) -> "LabeledBatch":
        def sl(a):
            return a[start:start + size]

        feats = (self.features.slice_rows(start, size)
                 if isinstance(self.features, SparseFeatures)
                 else sl(self.features))
        return LabeledBatch(feats, sl(self.labels), sl(self.offsets),
                            sl(self.weights))


def make_batch(features, labels, offsets=None, weights=None,
               dtype=torch.float32, device=None) -> LabeledBatch:
    """Build a LabeledBatch on ``device`` (default ``cuda``) from host or
    device data: ``features`` is a SparseFeatures, a scipy.sparse matrix or
    a dense ``[n, d]`` array."""
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
    elif _is_scipy_sparse(features):
        features = sparse_from_scipy(features, dtype=dtype, device=dev)
    else:
        features = real(features)
    return LabeledBatch(features, labels, offsets, weights)


def _is_scipy_sparse(features) -> bool:
    try:
        import scipy.sparse as sp
    except ImportError:  # pragma: no cover
        return False
    return sp.issparse(features)


def _ell_features(indices, values, dim, dtype, device) -> SparseFeatures:
    dev = resolve_device(device)
    return SparseFeatures(
        torch.from_numpy(indices).to(dev),
        torch.from_numpy(values).to(device=dev, dtype=dtype), dim=dim)


def sparse_from_scipy(mat, dtype=torch.float32, pad_to: Optional[int] = None,
                      allow_truncate: bool = False,
                      device=None) -> SparseFeatures:
    """Convert a scipy.sparse matrix to the padded ELL layout on ``device``
    (default ``cuda``). Raises if ``pad_to`` would drop nonzeros, unless
    ``allow_truncate`` (deliberate feature capping)."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(mat)
    n, d = csr.shape
    nnz_per_row = np.diff(csr.indptr)
    max_nnz = int(nnz_per_row.max()) if n else 0
    k = int(pad_to) if pad_to is not None else max_nnz
    if k < max_nnz and not allow_truncate:
        raise ValueError(
            f"pad_to={k} < max row nnz {max_nnz}; pass allow_truncate=True "
            "to cap")
    k = max(k, 1)
    indices = np.zeros((n, k), np.int32)
    values = np.zeros((n, k), np.float64)
    # position of each nonzero within its row
    rows = np.repeat(np.arange(n), nnz_per_row)
    cols = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], nnz_per_row)
    keep = cols < k
    indices[rows[keep], cols[keep]] = csr.indices[keep]
    values[rows[keep], cols[keep]] = csr.data[keep]
    return _ell_features(indices, values, d, dtype, device)


def sparse_from_rows(rows, dim: int, dtype=torch.float32,
                     pad_to: Optional[int] = None,
                     allow_truncate: bool = False,
                     device=None) -> SparseFeatures:
    """Padded sparse features on ``device`` (default ``cuda``) from per-row
    lists of (index, value) pairs. Indices are checked on the host:
    out-of-range ids would otherwise train on the wrong feature."""
    n = len(rows)
    max_nnz = max((len(r) for r in rows), default=0)
    k = int(pad_to) if pad_to is not None else max_nnz
    if k < max_nnz and not allow_truncate:
        raise ValueError(
            f"pad_to={k} < max row nnz {max_nnz}; pass allow_truncate=True "
            "to cap")
    k = max(k, 1)
    indices = np.zeros((n, k), np.int32)
    values = np.zeros((n, k), np.float64)
    for i, row in enumerate(rows):
        for j, (idx, val) in enumerate(row[:k]):
            indices[i, j] = idx
            values[i, j] = val
    if n and indices.max() >= dim:
        raise ValueError(f"feature index {indices.max()} out of range for "
                         f"dim={dim}")
    if n and indices.min() < 0:
        raise ValueError(f"negative feature index {indices.min()}")
    return _ell_features(indices, values, dim, dtype, device)
