"""Process-wide observability core: spans, metrics, structured logging
(counterpart of ``photon_ml_tpu/obs``; host-only, so the same code).

Three pillars, one package:

* :mod:`photon_ml_tpu_torch.obs.trace` — nestable, thread-safe spans with
  explicit context propagation across thread handoffs and (simulated or
  real) process boundaries, exported as Perfetto/Chrome-trace JSON per
  rank. Off by default; ``span()`` is a shared null object until a
  tracer is installed (``PHOTON_TRACE=…`` or ``trace.start()``).
* :mod:`photon_ml_tpu_torch.obs.metrics` — the Prometheus-text metrics core
  (histograms, counters, gauges) generalized out of ``serve/metrics.py``
  into a shared registry so training records per-sweep solve/eval/comm,
  chunk-cache and prefetch counters next to the serving series.
* :mod:`photon_ml_tpu_torch.obs.logging` — rank / trace-id / request-id
  stamping for every ``photon_ml_tpu_torch.*`` log record, plus the top-N
  slow-request exemplar log.

``python -m photon_ml_tpu_torch.obs.trace_cli`` merges per-rank trace
files into one Perfetto-loadable timeline, aligning ranks on the
collective-site labels threaded through ``resilience.collective_site``.
"""

from photon_ml_tpu_torch.obs.metrics import (  # noqa: F401
    Histogram,
    MetricsRegistry,
    ServingMetrics,
    TrainingMetrics,
    escape_label_value,
    training_metrics,
)
from photon_ml_tpu_torch.obs.trace import (  # noqa: F401
    TraceContext,
    current_context,
    span,
    use_context,
)

__all__ = [
    "Histogram", "MetricsRegistry", "ServingMetrics", "TrainingMetrics",
    "escape_label_value", "training_metrics",
    "TraceContext", "current_context", "span", "use_context",
]
