"""Structured logging: rank / trace-id / request-id on every record
(counterpart of ``photon_ml_tpu/obs/logging.py``).

One :class:`ContextFilter` installed on the ``photon_ml_tpu_torch`` logger
stamps three fields into every record emitted anywhere in the package:

* ``rank`` — ``resilience.current_process_index()`` resolved on the
  emitting thread (so the simulated harness's per-thread ranks come out
  right, the same rule the tracer uses);
* ``trace_id`` / ``request_id`` — the ambient
  :class:`~photon_ml_tpu_torch.obs.trace.TraceContext`, ``-`` when absent.

This replaces ad-hoc prefixes (the old ``[CD]`` tag in descent, the
driver's hand-rolled rank prefixes): a log line's identity is carried
in record *fields*, formatted once by :func:`configure`, instead of
re-encoded in every message string. Library code never calls
``configure`` — drivers do; tests attach the filter to their own
handlers when they want the stamps.

Slow-request exemplars: :class:`SlowRequestLog` keeps the top-N
requests by latency with their span breakdown (queue-wait / compute /
rows) and logs each new entrant, so "what were the worst requests and
where did their time go" is answerable from the log stream alone.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
from typing import Dict, List, Optional

from photon_ml_tpu_torch.obs import trace as _trace

__all__ = ["ContextFilter", "SlowRequestLog", "configure",
           "DEFAULT_FORMAT"]

DEFAULT_FORMAT = ("%(asctime)s %(levelname)s rank=%(rank)s "
                  "trace=%(trace_id)s req=%(request_id)s "
                  "%(name)s: %(message)s")


def _rank() -> int:
    try:
        from photon_ml_tpu_torch.parallel.resilience import (
            current_process_index,
        )
        return int(current_process_index())
    except Exception:
        return 0


class ContextFilter(logging.Filter):
    """Stamp rank/trace_id/request_id into the record (always passes).
    Safe to install on handlers or loggers; fields default to ``-`` so
    format strings never KeyError on un-traced threads."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.rank = _rank()
        ctx = _trace.current_context()
        record.trace_id = ctx.trace_id if ctx is not None else "-"
        record.request_id = (ctx.request_id
                             if ctx is not None and ctx.request_id
                             else "-")
        return True


def configure(level: int = logging.INFO,
              fmt: str = DEFAULT_FORMAT,
              logger_name: str = "photon_ml_tpu_torch") -> logging.Logger:
    """Driver-side setup: one stream handler with the structured format
    and the context filter on the package logger. Idempotent — a second
    call reuses the installed handler (so repeated driver invocations
    in one process don't duplicate lines)."""
    logger = logging.getLogger(logger_name)
    flt = _ensure_filter(logger)
    logger.addFilter(flt)
    for handler in logger.handlers:
        if getattr(handler, "_photon_obs_handler", False):
            break
    else:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(fmt))
        handler._photon_obs_handler = True
        logger.addHandler(handler)
    # a logger's filters never see what its children log; a handler's do,
    # so the children's records get the fields the format names
    if flt not in handler.filters:
        handler.addFilter(flt)
    logger.setLevel(level)
    return logger


def _ensure_filter(logger: logging.Logger) -> ContextFilter:
    for f in logger.filters:
        if isinstance(f, ContextFilter):
            return f
    return ContextFilter()


class SlowRequestLog:
    """Top-N requests by latency, with span breakdown exemplars.

    ``note()`` is called by the batcher worker once per resolved
    request; an entry that makes the top-N is logged at INFO with its
    breakdown (the log stream carries the exemplars even if nobody
    polls ``snapshot()``). Thread-safe; bounded at ``top_n`` entries."""

    def __init__(self, top_n: int = 10,
                 logger: Optional[logging.Logger] = None):
        self.top_n = int(top_n)
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._heap: List[tuple] = []  # min-heap of (latency, seq, entry)
        self._log = logger or logging.getLogger(__name__)

    def note(self, request_id: Optional[str], latency_ms: float,
             **breakdown) -> None:
        entry = {"request_id": request_id or "-",
                 "latency_ms": round(float(latency_ms), 3), **breakdown}
        item = (float(latency_ms), next(self._seq), entry)
        with self._lock:
            if len(self._heap) < self.top_n:
                heapq.heappush(self._heap, item)
            elif item[0] > self._heap[0][0]:
                heapq.heapreplace(self._heap, item)
            else:
                return
        self._log.info("slow-request exemplar %s", entry)

    def snapshot(self) -> List[Dict]:
        """Entries sorted worst-first."""
        with self._lock:
            return [e for _, _, e in
                    sorted(self._heap, key=lambda t: -t[0])]
