"""Per-feature summary statistics (counterpart of
``photon_ml_tpu/ops/statistics.py``, with the streamed form).

Equivalent of the reference's ``stat.BasicStatisticalSummary`` (SURVEY.md
§3.1; reference mount empty): per-feature mean, variance, min/max, nonzero
count — feeding normalization contexts and the feature-summarization output
(``FeatureSummarizationResultAvro``). Accumulated on the host in float64;
sparse features are handled without densifying (zeros counted analytically).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.types import LabeledBatch


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


@dataclasses.dataclass(frozen=True)
class FeatureSummary:
    mean: np.ndarray
    variance: np.ndarray
    std: np.ndarray
    min: np.ndarray
    max: np.ndarray
    num_nonzeros: np.ndarray
    count: int

    @property
    def dim(self) -> int:
        return self.mean.shape[0]


def summarize_features(batch: LabeledBatch) -> FeatureSummary:
    """Unweighted per-feature moments (matching the reference's summary used
    for normalization; weights affect training, not summarization).

    Accumulates on host in float64 regardless of the device dtype: with f32
    accumulation the E[x^2]-E[x]^2 subtraction loses the variance entirely
    for large-mean features, which would silently corrupt standardization.
    Summarization is a one-shot preprocessing stage (a dedicated job in the
    reference — SURVEY.md §4.1), so host-side f64 is the right trade."""
    feats = batch.features
    n = batch.num_examples
    # duck-typed so host-resident HostSparse (the streaming path, which never
    # moves the training set to device) summarizes identically; a dense
    # tensor has an ``indices`` method too, so it is tested for first
    if not isinstance(feats, torch.Tensor) and hasattr(feats, "indices"):
        d = feats.dim
        flat_idx = _host(feats.indices).reshape(-1)
        if feats.values is None:
            # implicit-ones layout: every slot is a real 1.0 feature, so
            # s1 == s2 == nnz == bincount and max == min == 1 where present
            # (no n*k float materialization — the layout exists to avoid it)
            nnz = np.bincount(flat_idx, minlength=d).astype(np.float64)
            s1 = nnz.copy()
            s2 = nnz.copy()
            mx = np.where(nnz > 0, 1.0, -np.inf)
            mn = np.where(nnz > 0, 1.0, np.inf)
        else:
            flat_val = _host(feats.values).astype(np.float64).reshape(-1)
            present = flat_val != 0.0
            idx, val = flat_idx[present], flat_val[present]
            s1 = np.zeros(d)
            s2 = np.zeros(d)
            nnz = np.zeros(d)
            np.add.at(s1, idx, val)
            np.add.at(s2, idx, val**2)
            np.add.at(nnz, idx, 1.0)
            mx = np.full(d, -np.inf)
            mn = np.full(d, np.inf)
            np.maximum.at(mx, idx, val)
            np.minimum.at(mn, idx, val)
        # features absent from a row are implicit zeros
        has_zero = nnz < n
        mx = np.where(has_zero, np.maximum(mx, 0.0), mx)
        mn = np.where(has_zero, np.minimum(mn, 0.0), mn)
        mx = np.where(np.isfinite(mx), mx, 0.0)
        mn = np.where(np.isfinite(mn), mn, 0.0)
    else:
        X = _host(feats).astype(np.float64)
        d = X.shape[1]
        s1 = X.sum(axis=0)
        s2 = (X**2).sum(axis=0)
        nnz = (X != 0.0).sum(axis=0).astype(np.float64)
        mx = X.max(axis=0) if n else np.zeros(d)
        mn = X.min(axis=0) if n else np.zeros(d)
    mean = s1 / max(n, 1)
    var = np.maximum(s2 / max(n, 1) - mean**2, 0.0)
    return FeatureSummary(
        mean=mean,
        variance=var,
        std=np.sqrt(var),
        min=mn,
        max=mx,
        num_nonzeros=nnz,
        count=n,
    )


def summarize_features_streamed(chunks, dim: int, num_rows: int,
                                total_rows: Optional[int] = None,
                                part_reduce=None) -> FeatureSummary:
    """:func:`summarize_features` over ONE streamed pass of a chunk source
    (``parallel.streaming.HostChunk`` iterable: in-RAM lists or the
    disk-backed ``io.stream_source.AvroChunkSource``): per-feature float64
    moments accumulate across chunks, so out-of-core shards feed
    normalization contexts without a resident copy.

    ``num_rows`` is the REAL row count: chunks are fixed-shape with
    trailing padding rows in the final chunk, and padding must not count as
    rows of implicit zeros. A genuine weight-0 row still counts
    (summarization is unweighted, as in the in-RAM function).

    Multi-process runs stream only this process's part: pass the GLOBAL
    row count as ``total_rows`` (``num_rows`` stays the LOCAL count that
    caps the final chunk's padding) and a ``part_reduce(s1, s2, nnz, mx,
    mn)`` that reduces the raw moments across processes
    (``parallel.multihost.allreduce_summary_moments``), so that every
    process finalizes the same global summary."""
    s1 = np.zeros(dim)
    s2 = np.zeros(dim)
    nnz = np.zeros(dim)
    mx = np.full(dim, -np.inf)
    mn = np.full(dim, np.inf)
    at = 0
    for c in chunks:
        rows = c.indices.shape[0]
        live = max(0, min(rows, num_rows - at))
        at += rows
        if live == 0:
            continue
        idxs = np.asarray(c.indices[:live]).reshape(-1)
        if c.values is None:
            # implicit ones: every slot is a real 1.0 feature
            cnt = np.bincount(idxs, minlength=dim).astype(np.float64)
            s1 += cnt
            s2 += cnt
            nnz += cnt
            mx = np.where(cnt > 0, np.maximum(mx, 1.0), mx)
            mn = np.where(cnt > 0, np.minimum(mn, 1.0), mn)
        else:
            vals = np.asarray(c.values[:live], np.float64).reshape(-1)
            present = vals != 0.0
            idx, val = idxs[present], vals[present]
            np.add.at(s1, idx, val)
            np.add.at(s2, idx, val ** 2)
            np.add.at(nnz, idx, 1.0)
            np.maximum.at(mx, idx, val)
            np.minimum.at(mn, idx, val)
    if part_reduce is not None:
        s1, s2, nnz, mx, mn = part_reduce(s1, s2, nnz, mx, mn)
    n = num_rows if total_rows is None else total_rows
    has_zero = nnz < n
    mx = np.where(has_zero, np.maximum(mx, 0.0), mx)
    mn = np.where(has_zero, np.minimum(mn, 0.0), mn)
    mx = np.where(np.isfinite(mx), mx, 0.0)
    mn = np.where(np.isfinite(mn), mn, 0.0)
    mean = s1 / max(n, 1)
    var = np.maximum(s2 / max(n, 1) - mean ** 2, 0.0)
    return FeatureSummary(mean=mean, variance=var, std=np.sqrt(var),
                          min=mn, max=mx, num_nonzeros=nnz, count=n)
