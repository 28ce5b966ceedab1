"""LIBSVM format reader (for the a1a baseline config — BASELINE.md #1; a
copy of ``photon_ml_tpu/io/libsvm.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.game.data import HostSparse


def read_libsvm(
    path: str,
    dim: Optional[int] = None,
    zero_based: bool = False,
    add_intercept: bool = False,
) -> Tuple[HostSparse, np.ndarray, int]:
    """Parse a LIBSVM file -> (HostSparse features, labels in {0,1} for
    binary or raw values, intercept_index or -1). Labels -1/+1 map to 0/1."""
    rows, labels = [], []
    max_idx = -1
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            row = []
            for tok in parts[1:]:
                idx_s, val_s = tok.split(":")
                idx = int(idx_s) - (0 if zero_based else 1)
                if idx < 0:
                    raise ValueError(f"feature index {idx_s} < 1 in 1-based file")
                row.append((idx, float(val_s)))
                max_idx = max(max_idx, idx)
            rows.append(row)
    d = dim if dim is not None else max_idx + 1
    intercept_index = -1
    if add_intercept:
        intercept_index = d
        d += 1
        for row in rows:
            row.append((intercept_index, 1.0))
    n = len(rows)
    k = max(max((len(r) for r in rows), default=0), 1)
    indices = np.zeros((n, k), np.int32)
    values = np.zeros((n, k))
    for i, row in enumerate(rows):
        for j, (idx, val) in enumerate(row):
            indices[i, j] = idx
            values[i, j] = val
    labels = np.asarray(labels)
    if set(np.unique(labels)) <= {-1.0, 1.0}:
        labels = (labels + 1.0) / 2.0  # -1/+1 -> 0/1
    return HostSparse(indices, values, d), labels, intercept_index
