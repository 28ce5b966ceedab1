"""Pre-training data validation (a copy of ``photon_ml_tpu/io/validators.py``).

Equivalent of the reference's ``DataValidators`` (SURVEY.md §3.3, legacy
classic driver row; reference mount empty, path unverified): sanity checks on
labels / features / offsets / weights run before any compute is spent, with
task-specific label rules (binary labels for logistic and smoothed-hinge,
non-negative counts for Poisson). Checks run on host over the already-decoded
arrays — validation is a one-shot preprocessing stage, not a jit concern.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from photon_ml_tpu_torch.game.data import HostSparse


class DataValidationError(ValueError):
    """Raised when a dataset fails validation; message lists every failure."""


def validate_training_data(
    features,
    labels: np.ndarray,
    offsets: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    task: str = "logistic",
) -> None:
    """Validate one dataset; raises DataValidationError listing all problems.

    ``features`` is a HostSparse, a dense [n, d] array, or a dict of either
    (per-shard). Rules mirror the reference's validator set:
      * labels finite; binary tasks need labels in {0, 1}; poisson needs >= 0
      * feature values finite
      * offsets finite
      * weights finite and strictly positive
    """
    problems: List[str] = []
    labels = np.asarray(labels)

    if labels.size and not np.all(np.isfinite(labels)):
        problems.append(f"{np.sum(~np.isfinite(labels))} non-finite labels")
    if task in ("logistic", "smoothed_hinge"):
        bad = labels[np.isfinite(labels)]
        bad = bad[(bad != 0.0) & (bad != 1.0)]
        if bad.size:
            problems.append(
                f"{bad.size} labels outside {{0,1}} for binary task "
                f"'{task}' (first: {bad[:3].tolist()})"
            )
    elif task == "poisson":
        neg = np.sum(labels[np.isfinite(labels)] < 0)
        if neg:
            problems.append(f"{neg} negative labels for poisson task")

    shards: Dict[str, object] = (
        features if isinstance(features, dict) else {"global": features}
    )
    for shard, feats in shards.items():
        vals = feats.values if isinstance(feats, HostSparse) else np.asarray(feats)
        if vals.size and not np.all(np.isfinite(vals)):
            problems.append(
                f"{np.sum(~np.isfinite(vals))} non-finite feature values "
                f"in shard '{shard}'"
            )

    if offsets is not None:
        offsets = np.asarray(offsets)
        if offsets.size and not np.all(np.isfinite(offsets)):
            problems.append(f"{np.sum(~np.isfinite(offsets))} non-finite offsets")
    if weights is not None:
        weights = np.asarray(weights)
        if weights.size and not np.all(np.isfinite(weights)):
            problems.append(f"{np.sum(~np.isfinite(weights))} non-finite weights")
        nonpos = np.sum(weights[np.isfinite(weights)] <= 0)
        if nonpos:
            problems.append(f"{nonpos} non-positive weights")

    if problems:
        raise DataValidationError(
            "training data failed validation: " + "; ".join(problems)
        )
