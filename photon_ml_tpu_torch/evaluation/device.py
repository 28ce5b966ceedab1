"""On-device evaluation metrics (counterpart of
``photon_ml_tpu/evaluation/device.py``).

The host evaluators (``evaluators.py``) are exact float64 references; these
keep the score vector on the device:

- ``device_auc``: exact weighted mid-rank AUC (device sort + segment sums).
- ``histogram_auc_contrib`` / ``histogram_auc``: AUC from weighted score
  histograms, additive across shards. Exact when every tied-score pair
  lands in one bin; otherwise the error is O(within-bin mass^2).

Segment sums over sorted ids use ``torch.segment_reduce`` (each segment
sums its own run in order), not ``index_add_``, whose CUDA sums follow
atomic order; the results are reproducible from run to run. The histogram
bins are the exception: they are ``index_add_`` sums, as in the JAX
package, and may differ in the last bits between runs on CUDA.

Entry points take numpy arrays or tensors. Tensors stay on their device;
numpy inputs, and everything an evaluator is called with, go to ``device``
(default ``cuda``).

With a mesh (``parallel.mesh.make_mesh``) of more than one rank, every
rank passes the same whole score vector and AUC is the shardable
:func:`histogram_auc`: each rank takes its own contiguous block of the
rows, the global ``lo``/``hi`` are all-reduced (MIN, MAX), then the two
histograms (SUM), over the mesh's ``axis``. The blocks are
``multihost.span_of`` spans, uneven where the rows do not divide, so no
padding row enters a histogram or the score range. The pointwise and
grouped evaluators read the whole vector on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.types import resolve_device


def _on(x, dev: Optional[torch.device]) -> torch.Tensor:
    """``x`` as a tensor on ``dev`` (a tensor's own device when None)."""
    if isinstance(x, torch.Tensor):
        return x if dev is None else x.to(dev)
    return torch.as_tensor(np.asarray(x), device=resolve_device(dev))


def _inputs(scores, labels, weights, device):
    dev = None if device is None else resolve_device(device)
    scores = _on(scores, dev)
    dev = scores.device
    labels = _on(labels, dev)
    weights = (torch.ones_like(scores) if weights is None
               else _on(weights, dev))
    return scores, labels, weights


def _on_device(fn, dev: torch.device) -> Callable:
    """``fn(scores, labels, weights)`` with its inputs placed on ``dev``
    (weights default to ones)."""
    def f(scores, labels, weights=None):
        return fn(*_inputs(scores, labels, weights, dev))

    return f


def _multi(mesh) -> bool:
    return mesh is not None and mesh.size() > 1


def _run_lengths(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Lengths of the runs of equal values in a sorted 1-D tensor."""
    return torch.unique_consecutive(sorted_keys, return_counts=True)[1]


def _tie_ranks(ranks, w, block_start):
    """Weighted mid-ranks with ties sharing their block's weighted mean
    rank; ``block_start`` marks the first row of each tied block."""
    block_id = torch.cumsum(block_start.to(torch.int64), 0) - 1
    lengths = _run_lengths(block_id)
    block_w = torch.segment_reduce(w, "sum", lengths=lengths, unsafe=True)
    block_rw = torch.segment_reduce(ranks * w, "sum", lengths=lengths,
                                    unsafe=True)
    return (block_rw / block_w)[block_id]


def device_auc(scores, labels, weights=None, device=None) -> torch.Tensor:
    """Exact weighted AUC with average-rank tie handling, on the device.

    Matches ``evaluators.auc`` (the host float64 reference) up to dtype:
    ties share the weighted mid-rank of their tied-score block. Returns nan
    for single-class inputs."""
    scores, labels, weights = _inputs(scores, labels, weights, device)
    nan = torch.full((), float("nan"), dtype=weights.dtype,
                     device=weights.device)
    if scores.shape[0] == 0:
        return nan
    pos = labels > 0.5
    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    w_pos = torch.sum(torch.where(pos, weights, zero))
    w_neg = torch.sum(torch.where(pos, zero, weights))
    order = torch.argsort(scores, stable=True)
    s, w, p = scores[order], weights[order], pos[order]
    block_start = torch.ones_like(p)
    block_start[1:] = s[1:] != s[:-1]
    ranks = _tie_ranks(torch.cumsum(w, 0) - w / 2.0, w, block_start)
    r_pos = torch.sum(torch.where(p, w * ranks, zero))
    out = (r_pos - w_pos * w_pos / 2.0) / (w_pos * w_neg)
    return torch.where((w_pos > 0) & (w_neg > 0), out, nan)


def histogram_auc_contrib(scores, labels, weights, lo, hi,
                          n_bins: int = 4096):
    """Per-shard AUC contribution: weighted histograms of positive and
    negative scores over [lo, hi] with ``n_bins`` equal bins. The outputs
    add elementwise across shards; finish with
    :func:`histogram_auc_from_hists`. Rows may carry weight 0 (padding)."""
    pos = labels > 0.5
    width = (hi - lo) / n_bins
    bins = torch.clamp(((scores - lo) / width).to(torch.int32), 0,
                       n_bins - 1)
    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    hist = torch.zeros(n_bins, dtype=weights.dtype, device=weights.device)
    pos_hist = hist.index_add(0, bins, torch.where(pos, weights, zero))
    neg_hist = hist.index_add(0, bins, torch.where(pos, zero, weights))
    return pos_hist, neg_hist


def histogram_auc_from_hists(pos_hist, neg_hist) -> torch.Tensor:
    """AUC from reduced histograms: P(score+ > score-) + P(tie)/2, treating
    all mass within one bin as tied (trapezoid / mid-rank rule)."""
    w_pos = torch.sum(pos_hist)
    w_neg = torch.sum(neg_hist)
    neg_below = torch.cumsum(neg_hist, 0) - neg_hist
    pairs = torch.sum(pos_hist * (neg_below + neg_hist / 2.0))
    return torch.where((w_pos > 0) & (w_neg > 0), pairs / (w_pos * w_neg),
                       torch.full_like(pairs, float("nan")))


def histogram_auc(scores, labels, weights=None, n_bins: int = 4096,
                  mesh=None, axis=None, device=None) -> torch.Tensor:
    """Histogram AUC over the whole score vector. With a mesh, every rank
    passes the whole vector and bins its own block of rows over ``axis``
    (default: ``"data"``, else the mesh's first axis); the score range and
    then the histograms are all-reduced, so every rank returns the same
    value."""
    scores, labels, weights = _inputs(scores, labels, weights, device)
    if mesh is None:
        lo = torch.min(scores)
        hi = torch.max(scores)
    else:
        import torch.distributed as dist

        from photon_ml_tpu_torch.parallel.multihost import span_of

        names = mesh.mesh_dim_names
        group = mesh.get_group(axis or ("data" if "data" in names
                                        else names[0]))
        s0, s1 = span_of(scores.shape[0], dist.get_rank(group),
                         dist.get_world_size(group))
        scores, labels, weights = (scores[s0:s1], labels[s0:s1],
                                   weights[s0:s1])
        inf = torch.full((1,), float("inf"), dtype=scores.dtype,
                         device=scores.device)
        # MIN then MAX: the global range every rank bins over
        lo = torch.min(scores).reshape(1) if s1 > s0 else inf
        hi = torch.max(scores).reshape(1) if s1 > s0 else -inf
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        lo, hi = lo[0], hi[0]
    hi = torch.where(hi > lo, hi, lo + 1.0)
    hists = torch.stack(histogram_auc_contrib(scores, labels, weights, lo,
                                              hi, n_bins=n_bins))
    if mesh is not None:
        dist.all_reduce(hists, op=dist.ReduceOp.SUM, group=group)
    return histogram_auc_from_hists(hists[0], hists[1])


def _logistic_point(s, l):
    return torch.logaddexp(torch.zeros_like(s), s) - l * s


def _smoothed_hinge_point(s, l):
    z = (2.0 * l - 1.0) * s
    zero = torch.zeros_like(z)
    return torch.where(z <= 0, 0.5 - z,
                       torch.where(z < 1, 0.5 * (1 - z) ** 2, zero))


_POINTWISE = {
    "rmse": lambda s, l: (s - l) ** 2,
    "logistic_loss": _logistic_point,
    "poisson_loss": lambda s, l: torch.exp(s) - l * s,
    "squared_loss": lambda s, l: 0.5 * (s - l) ** 2,
    "smoothed_hinge_loss": _smoothed_hinge_point,
}


def make_device_evaluator(name: str, mesh=None,
                          device=None) -> Optional[Callable]:
    """Device form of a host evaluator, for per-iteration validation
    without copying score vectors to the host. Returns
    ``(scores, labels, weights) -> 0-d tensor`` on ``device`` (default
    ``cuda``), or None when the metric has no device form (grouped
    variants: :func:`make_grouped_device_evaluator`).

    AUC is the exact :func:`device_auc` on one device and the shardable
    :func:`histogram_auc` over a mesh of more than one rank; the pointwise
    losses mirror the definitions of ``evaluators.py``. Final reported
    metrics should still come from the host float64 evaluators."""
    dev = resolve_device(device)
    key = name.lower()
    if key == "auc":
        if _multi(mesh):
            return _on_device(
                lambda s, l, w: histogram_auc(s, l, w, mesh=mesh), dev)
        return _on_device(device_auc, dev)
    if key in _POINTWISE:
        point = _POINTWISE[key]
        post = torch.sqrt if key == "rmse" else (lambda x: x)

        def wmean(scores, labels, weights):
            return post(torch.sum(weights * point(scores, labels))
                        / torch.sum(weights))

        return _on_device(wmean, dev)
    if key.startswith("precision_at_"):
        k = int(key[len("precision_at_"):])

        def pk(scores, labels, weights):
            # ties at the k boundary may resolve differently than the host
            # mergesort: monitoring only; finals are host float64
            idx = torch.topk(scores, min(k, scores.shape[0])).indices
            return torch.mean((labels[idx] > 0.5).to(scores.dtype))

        return _on_device(pk, dev)
    return None


def _finite_mean(vals):
    """Mean over finite entries (nan when none): the grouped evaluators'
    aggregation rule (``evaluators.Evaluator.evaluate``)."""
    ok = torch.isfinite(vals)
    cnt = torch.sum(ok)
    total = torch.sum(torch.where(ok, vals, torch.zeros_like(vals)))
    return torch.where(cnt > 0, total / cnt,
                       torch.full_like(total, float("nan")))


def make_grouped_device_evaluator(name: str, group_ids, mesh=None,
                                  device=None) -> Optional[Callable]:
    """Device form of a ``per_group_*`` evaluator, closed over the
    factorized group ids (factorized once on the host; every call then runs
    segment sums on ``device``, default ``cuda``). Returns
    ``(scores, labels, weights) -> 0-d tensor`` mirroring the host
    ``grouped_fn`` + finite-mean aggregation, or None when the metric has
    no grouped device form. With a mesh, as in the JAX package, each rank
    evaluates the whole score vector it holds (no collective)."""
    key = name.lower()
    if not key.startswith("per_group_"):
        return None
    inner = key[len("per_group_"):]
    _, inv_np = np.unique(np.asarray(group_ids), return_inverse=True)
    inv_np = inv_np.reshape(-1)
    G = int(inv_np.max()) + 1 if len(inv_np) else 0
    if G == 0:
        return None
    dev = resolve_device(device)
    inv = torch.as_tensor(inv_np, dtype=torch.int64, device=dev)
    # group sizes are fixed by the ids: rows sorted by group form runs of
    # exactly these lengths
    counts = torch.as_tensor(np.bincount(inv_np, minlength=G),
                             dtype=torch.int64, device=dev)
    by_group = torch.argsort(inv, stable=True)

    def seg_sorted(x):
        """Per-group sums of ``x`` already in group-sorted order."""
        return torch.segment_reduce(x, "sum", lengths=counts, unsafe=True)

    def lexsort(scores):
        """Row order by (group, score), stable: ``np.lexsort((s, inv))``."""
        o1 = torch.argsort(scores, stable=True)
        return o1[torch.argsort(inv[o1], stable=True)]

    if inner == "auc":
        def grouped_auc_dev(scores, labels, weights):
            order = lexsort(scores)
            g, s, w = inv[order], scores[order], weights[order]
            p = labels[order] > 0.5
            zero = torch.zeros((), dtype=w.dtype, device=w.device)
            w_grp = seg_sorted(w)
            before = torch.cumsum(w_grp, 0) - w_grp
            block_start = torch.ones_like(p)
            block_start[1:] = (g[1:] != g[:-1]) | (s[1:] != s[:-1])
            ranks = _tie_ranks(torch.cumsum(w, 0) - before[g] - w / 2.0, w,
                               block_start)
            w_pos = seg_sorted(torch.where(p, w, zero))
            w_neg = seg_sorted(torch.where(p, zero, w))
            r_pos = seg_sorted(torch.where(p, w * ranks, zero))
            vals = (r_pos - w_pos * w_pos / 2.0) / (w_pos * w_neg)
            vals = torch.where((w_pos > 0) & (w_neg > 0), vals,
                               torch.full_like(vals, float("nan")))
            return _finite_mean(vals)

        return _on_device(grouped_auc_dev, dev)

    if inner.startswith("precision_at_"):
        k = int(inner[len("precision_at_"):])
        starts = torch.cumsum(counts, 0) - counts

        def grouped_pk_dev(scores, labels, weights):
            order = lexsort(-scores)
            g, lab = inv[order], labels[order]
            rank = torch.arange(g.shape[0], device=g.device) - starts[g]
            hits = seg_sorted(torch.where(
                rank < k, (lab > 0.5).to(scores.dtype),
                torch.zeros((), dtype=scores.dtype, device=scores.device)))
            return _finite_mean(hits / torch.clamp(counts, max=k))

        return _on_device(grouped_pk_dev, dev)

    point = _POINTWISE.get(inner)
    if point is None:
        return None
    post = torch.sqrt if inner == "rmse" else (lambda x: x)

    def grouped_mean_dev(scores, labels, weights):
        num = seg_sorted((weights * point(scores, labels))[by_group])
        den = seg_sorted(weights[by_group])
        vals = post(num / den)
        return _finite_mean(torch.where(den > 0, vals,
                                        torch.full_like(vals, float("nan"))))

    return _on_device(grouped_mean_dev, dev)
