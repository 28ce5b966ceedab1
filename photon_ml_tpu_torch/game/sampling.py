"""Down-samplers for coordinate training data (a copy of
``photon_ml_tpu/game/sampling.py``, which is numpy-only).

Equivalent of the reference's ``sampling.{DownSampler,
BinaryClassificationDownSampler, DefaultDownSampler}`` (SURVEY.md §3.2;
reference mount empty): binary tasks keep all positives and sample negatives
at ``rate`` with weights rescaled by 1/rate (so gradient expectations are
unchanged); other tasks sample uniformly with the same weight compensation.
Host-side: sampling decides *which rows* enter a coordinate's training set.
"""

from __future__ import annotations

import numpy as np


def down_sample(
    labels: np.ndarray,
    weights: np.ndarray,
    rate: float,
    task: str = "logistic",
    seed: int = 0,
):
    """Returns (row_indices, adjusted_weights). rate >= 1 is a no-op."""
    n = len(labels)
    if rate >= 1.0:
        return np.arange(n), np.asarray(weights, np.float64)
    if not (0.0 < rate):
        raise ValueError(f"down-sampling rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    keep = rng.random(n) < rate
    if task in ("logistic", "smoothed_hinge"):
        # binary: all positives survive; kept negatives get 1/rate weight
        pos = np.asarray(labels) > 0.5
        sel = pos | keep
        idx = np.nonzero(sel)[0]
        w = np.asarray(weights, np.float64)[idx].copy()
        w[np.asarray(labels)[idx] <= 0.5] /= rate
        return idx, w
    idx = np.nonzero(keep)[0]
    return idx, np.asarray(weights, np.float64)[idx] / rate
