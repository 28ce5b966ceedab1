"""Evaluation metrics on scored data (a copy of
``photon_ml_tpu/evaluation/evaluators.py``, which is numpy-only).

Pointwise metrics (AUC, RMSE, logistic / Poisson / squared / smoothed-hinge
loss) plus grouped variants that compute the metric per group (e.g.
per-query AUC) and average. Metrics are computed on the host in float64:
they sit outside the training loop, and exact tie handling in AUC matters
more than speed here. ``evaluation.device`` holds the on-device forms.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Evaluator:
    name: str
    fn: Callable  # (scores, labels, weights) -> float
    higher_is_better: bool
    grouped: bool = False  # average the metric over groups (Multi- variant)
    # vectorized grouped implementation: (scores, labels, weights,
    # inverse_group_indices, n_groups) -> per-group value array (nan = skip).
    # Grouped evaluation is segment-op based (a Python loop over np.unique
    # groups walls at 1e5+ query groups), with the loop kept only for fns
    # without a registered vectorized form.
    grouped_fn: Optional[Callable] = None

    def evaluate(self, scores, labels, weights=None, group_ids=None) -> float:
        scores = np.asarray(scores, np.float64)
        labels = np.asarray(labels, np.float64)
        weights = (
            np.ones_like(labels) if weights is None else np.asarray(weights, np.float64)
        )
        if not self.grouped:
            v = self.fn(scores, labels, weights)
            return float("nan") if v is None else float(v)
        if group_ids is None:
            raise ValueError(f"evaluator '{self.name}' needs group_ids")
        group_ids = np.asarray(group_ids)
        _, inv = np.unique(group_ids, return_inverse=True)
        n_groups = int(inv.max()) + 1 if len(inv) else 0
        if self.grouped_fn is not None:
            vals = self.grouped_fn(scores, labels, weights, inv, n_groups)
            vals = vals[np.isfinite(vals)]
            return float(np.mean(vals)) if len(vals) else float("nan")
        vals = []
        for g in range(n_groups):
            m = inv == g
            v = self.fn(scores[m], labels[m], weights[m])
            if v is not None and np.isfinite(v):
                vals.append(v)
        return float(np.mean(vals)) if vals else float("nan")

    def better(self, a: float, b: float) -> bool:
        """True if metric value a is better than b."""
        return a > b if self.higher_is_better else a < b


@dataclasses.dataclass(frozen=True)
class EvaluationResults:
    """Per-evaluator metric values; the first evaluator is primary for
    model selection."""

    metrics: Dict[str, float]
    primary: str

    @property
    def primary_value(self) -> float:
        return self.metrics[self.primary]


def auc(scores, labels, weights):
    """Area under the ROC curve with average-rank tie handling (matches
    sklearn.roc_auc_score on unweighted data); weighted generalization uses
    weighted ranks. Returns None for degenerate single-class groups."""
    pos = labels > 0.5
    w_pos = weights[pos].sum()
    w_neg = weights[~pos].sum()
    if w_pos == 0 or w_neg == 0:
        return None
    order = np.argsort(scores, kind="mergesort")
    s, w, p = scores[order], weights[order], pos[order]
    # weighted mid-ranks with ties sharing the average rank
    cw = np.cumsum(w)
    ranks = cw - w / 2.0  # midpoint rank of each item
    # collapse ties: average rank within each tied score block
    block_start = np.concatenate(([True], s[1:] != s[:-1]))
    block_id = np.cumsum(block_start) - 1
    block_w = np.zeros(block_id[-1] + 1)
    block_rw = np.zeros_like(block_w)
    np.add.at(block_w, block_id, w)
    np.add.at(block_rw, block_id, ranks * w)
    ranks = (block_rw / block_w)[block_id]
    r_pos = np.sum(w[p] * ranks[p])
    return (r_pos - w_pos * w_pos / 2.0) / (w_pos * w_neg)


def grouped_auc(scores, labels, weights, inv, n_groups):
    """Per-group weighted mid-rank AUC, fully vectorized: one lexsort by
    (group, score) then segment ops — no per-group Python. Exactly matches
    ``auc`` applied per group (ties share the weighted average rank within
    a group's tied-score block); single-class groups come back nan."""
    if n_groups == 0:
        return np.empty(0)
    pos = labels > 0.5
    order = np.lexsort((scores, inv))
    g, s, w, p = inv[order], scores[order], weights[order], pos[order]
    counts = np.bincount(g, minlength=n_groups)
    cw = np.cumsum(w)
    starts = np.concatenate(([0], np.cumsum(counts[:-1])))
    # cumulative weight before each group, broadcast to its rows
    group_offset = np.repeat(np.concatenate(([0.0], cw[starts[1:] - 1]))
                             if n_groups > 1 else np.zeros(1), counts)
    ranks = cw - group_offset - w / 2.0
    # collapse ties within a group: same average rank per tied-score block
    block_start = np.concatenate(
        ([True], (g[1:] != g[:-1]) | (s[1:] != s[:-1])))
    block_id = np.cumsum(block_start) - 1
    block_w = np.bincount(block_id, w)
    block_rw = np.bincount(block_id, ranks * w)
    ranks = (block_rw / block_w)[block_id]
    w_pos = np.bincount(g, w * p, minlength=n_groups)
    w_neg = np.bincount(g, w * ~p, minlength=n_groups)
    r_pos = np.bincount(g, w * p * ranks, minlength=n_groups)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = (r_pos - w_pos * w_pos / 2.0) / (w_pos * w_neg)
    out[(w_pos == 0) | (w_neg == 0)] = np.nan
    return out


def _grouped_weighted_mean(pointwise, post=None):
    """Lift a pointwise loss row->value into a vectorized per-group
    weighted-mean implementation (segment sums via bincount); ``post``
    maps the per-group mean (e.g. sqrt for RMSE)."""

    def fn(scores, labels, weights, inv, n_groups):
        loss = pointwise(scores, labels)
        num = np.bincount(inv, weights * loss, minlength=n_groups)
        den = np.bincount(inv, weights, minlength=n_groups)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = num / den
        return out if post is None else post(out)

    return fn


def grouped_precision_at_k(k: int):
    """Vectorized per-group precision@k: one stable lexsort by
    (group, -score), rank-within-group via segment offsets."""

    def fn(scores, labels, weights, inv, n_groups):
        if n_groups == 0:
            return np.empty(0)
        order = np.lexsort((-scores, inv))
        g, lab = inv[order], labels[order]
        counts = np.bincount(g, minlength=n_groups)
        starts = np.concatenate(([0], np.cumsum(counts[:-1])))
        rank = np.arange(len(g)) - np.repeat(starts, counts)
        top = rank < k
        hits = np.bincount(g[top], lab[top] > 0.5, minlength=n_groups)
        return hits / np.minimum(counts, k)

    return fn


def rmse(scores, labels, weights):
    return np.sqrt(np.sum(weights * (scores - labels) ** 2) / weights.sum())


def logistic_loss_metric(scores, labels, weights):
    """Mean weighted logistic loss of raw margins."""
    return np.sum(weights * (np.logaddexp(0.0, scores) - labels * scores)) / weights.sum()


def poisson_loss_metric(scores, labels, weights):
    return np.sum(weights * (np.exp(scores) - labels * scores)) / weights.sum()


def squared_loss_metric(scores, labels, weights):
    return np.sum(weights * 0.5 * (scores - labels) ** 2) / weights.sum()


def _smoothed_hinge_pointwise(scores, labels):
    z = (2.0 * labels - 1.0) * scores
    return np.where(z <= 0, 0.5 - z, np.where(z < 1, 0.5 * (1 - z) ** 2, 0.0))


def smoothed_hinge_loss_metric(scores, labels, weights):
    return np.sum(weights * _smoothed_hinge_pointwise(scores, labels)) / weights.sum()


def precision_at_k(k: int):
    def fn(scores, labels, weights):
        if len(scores) == 0:
            return None
        top = np.argsort(-scores, kind="mergesort")[:k]
        return float(np.mean(labels[top] > 0.5))

    return fn


def is_regression(evaluator: Evaluator, candidate: float, live: float,
                  tolerance: float = 0.0) -> bool:
    """True when ``candidate`` is worse than ``live`` by more than
    ``tolerance`` in the metric's own units (a promotion gate's refusal
    predicate). Fails safe on NaN: a candidate
    that could not be evaluated regresses; a live side that could not be
    evaluated cannot block the candidate."""
    import math

    if math.isnan(candidate):
        return not math.isnan(live)
    if math.isnan(live):
        return False
    delta = (live - candidate) if evaluator.higher_is_better else (
        candidate - live)
    return delta > tolerance


_BASE = {
    "auc": Evaluator("auc", auc, higher_is_better=True,
                     grouped_fn=grouped_auc),
    "rmse": Evaluator(
        "rmse", rmse, higher_is_better=False,
        grouped_fn=_grouped_weighted_mean(
            lambda s, l: (s - l) ** 2, post=np.sqrt)),
    "logistic_loss": Evaluator(
        "logistic_loss", logistic_loss_metric, higher_is_better=False,
        grouped_fn=_grouped_weighted_mean(
            lambda s, l: np.logaddexp(0.0, s) - l * s)),
    "poisson_loss": Evaluator(
        "poisson_loss", poisson_loss_metric, higher_is_better=False,
        grouped_fn=_grouped_weighted_mean(lambda s, l: np.exp(s) - l * s)),
    "squared_loss": Evaluator(
        "squared_loss", squared_loss_metric, higher_is_better=False,
        grouped_fn=_grouped_weighted_mean(lambda s, l: 0.5 * (s - l) ** 2)),
    "smoothed_hinge_loss": Evaluator(
        "smoothed_hinge_loss", smoothed_hinge_loss_metric,
        higher_is_better=False,
        grouped_fn=_grouped_weighted_mean(_smoothed_hinge_pointwise)),
}

# default evaluator per task (the reference ties it to TaskType)
TASK_DEFAULT_EVALUATOR = {
    "logistic": "auc",
    "squared": "rmse",
    "linear": "rmse",
    "poisson": "poisson_loss",
    "smoothed_hinge": "auc",
}


def get_evaluator(name: str) -> Evaluator:
    """Resolve an evaluator by name. Grouped variants: "per_group_auc" (the
    reference's MultiAUCEvaluator), "precision_at_K" / "per_group_precision_at_K"."""
    key = name.lower()
    if key in _BASE:
        return _BASE[key]
    if key.startswith("per_group_"):
        inner = get_evaluator(key[len("per_group_") :])
        return dataclasses.replace(inner, name=key, grouped=True)
    if key.startswith("precision_at_"):
        k = int(key[len("precision_at_") :])
        return Evaluator(key, precision_at_k(k), higher_is_better=True,
                         grouped_fn=grouped_precision_at_k(k))
    raise ValueError(f"unknown evaluator '{name}'; known: {sorted(_BASE)}, "
                     "per_group_<name>, precision_at_<k>")
