"""Model diagnostics — the classic driver's diagnostic stage (counterpart of
``photon_ml_tpu/diagnostics.py``).

The reference's legacy ``Driver`` ends with a diagnostics stage (SURVEY.md
§3.3: "staged pipeline (... → validate → diagnostics)"): goodness-of-fit
and model-quality reports alongside the trained models:

* ``hosmer_lemeshow``: decile goodness-of-fit test for binary models.
* ``bootstrap_coefficients``: coefficient confidence intervals via
  multinomial-weight bootstrap. The JAX package draws the counts with
  ``jax.random`` and ``vmap``s the replicate L-BFGS fits into one program;
  here the counts come from an explicit ``torch.Generator`` and
  :func:`bootstrap_replicate_fits` runs the replicates one after another on
  the batch's device. The two packages draw different counts from the same
  seed, so a test feeds both the same ``counts``.
* ``feature_importance``: |w_j| * std_j ranking (scale-adjusted weight
  magnitude).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.optimize.lbfgs import lbfgs
from photon_ml_tpu_torch.types import LabeledBatch


def hosmer_lemeshow(
    probabilities: np.ndarray,
    labels: np.ndarray,
    n_bins: int = 10,
) -> Dict[str, float]:
    """Hosmer–Lemeshow chi-square over probability deciles. Returns the
    statistic, degrees of freedom, and p-value (chi2 survival function)."""
    probabilities = np.asarray(probabilities, np.float64)
    labels = np.asarray(labels, np.float64)
    order = np.argsort(probabilities)
    p_sorted = probabilities[order]
    y_sorted = labels[order]
    bins = np.array_split(np.arange(len(p_sorted)), n_bins)
    stat = 0.0
    used = 0
    for idx in bins:
        if len(idx) == 0:
            continue
        exp = float(p_sorted[idx].sum())
        obs = float(y_sorted[idx].sum())
        n = len(idx)
        denom = exp * (1.0 - exp / n)
        if denom <= 0:
            continue
        stat += (obs - exp) ** 2 / denom
        used += 1
    dof = max(used - 2, 1)
    from scipy.stats import chi2

    return {"statistic": stat, "dof": dof, "p_value": float(chi2.sf(stat, dof))}


def bootstrap_counts(n: int, n_replicates: int,
                     generator: torch.Generator) -> torch.Tensor:
    """Multinomial resampling counts ``[n_replicates, n]`` (each row sums to
    ``n``: ``n`` draws with replacement over the rows), drawn on the
    generator's device."""
    dev = generator.device
    probs = torch.full((n_replicates, n), 1.0 / n, dtype=torch.float64,
                       device=dev)
    draws = torch.multinomial(probs, n, replacement=True,
                              generator=generator)
    counts = torch.zeros((n_replicates, n), dtype=torch.float64, device=dev)
    return counts.scatter_add_(1, draws, torch.ones_like(counts))


def bootstrap_replicate_fits(
    objective: GLMObjective,
    batch: LabeledBatch,
    w_hat: torch.Tensor,
    counts: torch.Tensor,
    l2: float = 0.0,
    config: Optional[OptimizerConfig] = None,
) -> torch.Tensor:
    """One L-BFGS fit per row of ``counts`` (``[R, n]`` example multiplicities;
    the weight-space form of resampling, no data copy), each warm-started
    from ``w_hat``. Returns the replicate coefficients ``[R, d]``."""
    if config is None:
        config = OptimizerConfig(max_iters=50)
    counts = torch.as_tensor(counts, device=batch.device).to(
        batch.weights.dtype)
    ws = []
    for boot_counts in counts:
        b = dataclasses.replace(batch, weights=batch.weights * boot_counts)
        res = lbfgs(lambda w, b=b: objective.value_and_grad(w, b, l2),
                    w_hat, config)
        ws.append(res.w)
    return torch.stack(ws)


def bootstrap_coefficients(
    objective: GLMObjective,
    batch: LabeledBatch,
    w_hat: torch.Tensor,
    l2: float = 0.0,
    n_replicates: int = 32,
    seed: int = 0,
    config: Optional[OptimizerConfig] = None,
    ci: float = 0.95,
) -> Dict[str, np.ndarray]:
    """Percentile confidence intervals for coefficients from
    ``n_replicates`` bootstrap refits (:func:`bootstrap_counts` from a
    generator seeded with ``seed`` on the batch's device, then
    :func:`bootstrap_replicate_fits`)."""
    gen = torch.Generator(device=batch.device)
    gen.manual_seed(seed)
    counts = bootstrap_counts(batch.num_examples, n_replicates, gen)
    ws = bootstrap_replicate_fits(objective, batch, w_hat, counts, l2,
                                  config).cpu().numpy()  # [R, d]
    alpha = (1.0 - ci) / 2.0
    return {
        "mean": ws.mean(axis=0),
        "std": ws.std(axis=0, ddof=1),
        "lower": np.quantile(ws, alpha, axis=0),
        "upper": np.quantile(ws, 1.0 - alpha, axis=0),
        "replicates": ws,
    }


def feature_importance(
    w: np.ndarray,
    feature_std: Optional[np.ndarray] = None,
    top_k: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Rank features by scale-adjusted coefficient magnitude
    ``|w_j| * std_j`` (plain ``|w_j|`` when no summary is available)."""
    w = np.asarray(w)
    score = np.abs(w) * (np.asarray(feature_std) if feature_std is not None
                         else 1.0)
    order = np.argsort(-score)
    if top_k is not None:
        order = order[:top_k]
    return {"index": order, "score": score[order]}
