"""Serving metrics (counterpart of ``photon_ml_tpu/serve/metrics.py``):
the serving tier's import path for the metrics core, which lives in
:mod:`photon_ml_tpu_torch.obs.metrics` so that training and serving share
its primitives and exposition."""

from __future__ import annotations

from photon_ml_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS_MS,
    Histogram,
    ServingMetrics,
    _fmt,
)

__all__ = ["Histogram", "ServingMetrics"]
