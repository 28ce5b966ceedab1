"""Span tracer: nestable, thread-safe, near-zero cost when off
(counterpart of ``photon_ml_tpu/obs/trace.py``; host-only, the same code
over the port's ``resilience`` and ``io.durable``).

Design constraints, in priority order:

1. **Off means off.** Every hot path calls ``span(...)`` unconditionally
   (descent sweeps, the streamed-pass ring, the batcher worker, the
   fused scoring dispatch). With no tracer installed the call is one
   module-global load, one ``is None`` test, and the return of a shared
   immutable null context manager — no allocation, no lock, no clock
   read. A span never reads the device: its arguments are host values
   the caller already holds, so tracing on or off launches the same
   kernels and makes the same host reads.
2. **Context is explicit at thread handoffs.** A span's trace-id and
   request-id live in a :class:`TraceContext` carried in a
   ``contextvars.ContextVar`` — ambient per thread AND per asyncio
   task, so the async front end's interleaved requests don't bleed
   trace ids into each other across awaits.
   Code that hands work to another thread captures
   ``current_context()`` and the receiving thread enters
   ``use_context(ctx)`` — the batcher worker, the prefetch ring's
   transfer thread, and the session's installer thread all do this, so
   one request's spans line up under one trace-id across every thread
   that touched it.
3. **Rank is resolved per span, on the recording thread.** In the
   simulated multi-controller harness each "process" is a thread with
   an ambient per-thread transport, so the rank CANNOT be captured at
   tracer start; each span asks ``resilience.current_process_index()``
   when it closes. Real runs resolve the same call to the
   ``torch.distributed`` rank. The Chrome-trace ``pid`` field carries the rank, which is
   what lets ``photon-trace merge`` lay N ranks side by side.
4. **Crash-safe export.** Spans land in a bounded in-memory ring; a
   dedicated export thread (``photon-trace-export`` — a registered
   photon thread prefix, so the thread-leak sanitizer owns it) flushes
   a complete ``trace-rank{r}.json`` per rank via write-temp +
   ``os.replace``, the registry's atomic-publish idiom. A killed
   process leaves the last complete flush, never a torn file.

Sampling: ``PHOTON_TRACE_SAMPLE`` (or ``start(sample=…)``) decides at
trace-root creation whether the whole trace records — a sampled-out
request costs the same as tracing-off for every nested span.

Enable via ``PHOTON_TRACE=<dir>`` (any truthy non-path value uses
``./photon-trace``) or programmatically::

    tracer = trace.start("/tmp/run1-traces", sample=1.0)
    ...
    trace.stop()          # bounded join + final flush

Spans::

    with trace.span("cd.coordinate", cat="train", coordinate=cfg.name):
        ...

Collective spans carry ``cat="collective"`` and a ``site`` arg (the
``resilience.collective_site`` label); the merge tool matches the k-th
occurrence of each site across ranks to align clocks.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import os
import random
import threading
import time
import uuid
from typing import Dict, Iterator, Optional

from photon_ml_tpu_torch.io.durable import durable_replace

__all__ = [
    "TraceContext", "Tracer", "current_context", "use_context",
    "span", "start", "stop", "enabled", "active_tracer",
    "maybe_start_from_env", "new_request_id", "current_request_id",
    "request_context",
]

# Shared clock origin: one value per process, taken at import. In the
# simulated harness every rank is a thread of this process, so per-rank
# timestamps are directly comparable; across real processes the merge
# tool re-aligns on collective sites.
_ORIGIN = time.perf_counter()

_DEFAULT_RING = 65536
_DEFAULT_FLUSH_S = 1.0


def _now_us() -> float:
    return (time.perf_counter() - _ORIGIN) * 1e6


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


class TraceContext:
    """Ambient identity for one trace: trace-id, optional request-id,
    and the per-trace sampling verdict. Immutable after creation so it
    is safe to share across threads (each thread only reads it)."""

    __slots__ = ("trace_id", "request_id", "sampled")

    def __init__(self, trace_id: Optional[str] = None,
                 request_id: Optional[str] = None, sampled: bool = True):
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.request_id = request_id
        self.sampled = bool(sampled)

    def __repr__(self) -> str:
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"request_id={self.request_id!r}, sampled={self.sampled})")


_CTX: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("photon_trace_ctx", default=None)


def current_context() -> Optional[TraceContext]:
    """The ambient trace context of the calling thread / asyncio task
    (None outside any trace). Capture this before handing work to
    another thread."""
    return _CTX.get()


@contextlib.contextmanager
def use_context(ctx: Optional[TraceContext]) -> Iterator[None]:
    """Adopt a captured context on the receiving side of a thread
    handoff (batcher worker, transfer thread, installer thread).
    ``use_context(None)`` is a no-op nesting, so call sites don't need
    to branch on whether the submitter was traced."""
    token = _CTX.set(ctx if ctx is not None else _CTX.get())
    try:
        yield
    finally:
        _CTX.reset(token)


def current_request_id() -> Optional[str]:
    ctx = _CTX.get()
    return ctx.request_id if ctx is not None else None


@contextlib.contextmanager
def request_context(request_id: Optional[str] = None,
                    trace_id: Optional[str] = None) -> Iterator[None]:
    """Root context for one served request: a fresh trace carrying the
    request id, so every span under it (batcher, session, installer)
    correlates. No-op (no allocation) when tracing is off — request-id
    propagation through the serving stack rides explicit parameters,
    not this ambient context."""
    t = _TRACER
    if t is None:
        yield
        return
    ctx = TraceContext(trace_id=trace_id, request_id=request_id,
                       sampled=t.sample_decision())
    with use_context(ctx):
        yield


class _NullSpan:
    """The disabled-path span: one shared immutable instance, usable as
    a context manager any number of times concurrently."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **kwargs):  # parity with _Span.set
        return self


_NULL_SPAN = _NullSpan()


def _rank() -> int:
    try:
        from photon_ml_tpu_torch.parallel.resilience import (
            current_process_index,
        )
        return int(current_process_index())
    except Exception:
        return 0


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_owns_ctx")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self._owns_ctx = None  # a _CTX reset token when this span roots

    def set(self, **kwargs) -> "_Span":
        """Attach args discovered mid-span (batch size, fault count)."""
        self.args.update(kwargs)
        return self

    def __enter__(self) -> "_Span":
        ctx = _CTX.get()
        if ctx is None:
            ctx = TraceContext(sampled=self._tracer.sample_decision())
            # keep the reset token so __exit__ restores the outer state
            self._owns_ctx = _CTX.set(ctx)
        self._t0 = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now_us()
        ctx = _CTX.get()
        if self._owns_ctx is not None:
            _CTX.reset(self._owns_ctx)
        if ctx is None or not ctx.sampled:
            return False
        args = self.args
        args["trace_id"] = ctx.trace_id
        if ctx.request_id is not None:
            args["request_id"] = ctx.request_id
        if exc_type is not None:
            args["error"] = exc_type.__name__
        self._tracer.record(
            name=self.name, cat=self.cat, ts=self._t0, dur=t1 - self._t0,
            rank=_rank(), args=args)
        return False


class Tracer:
    """Bounded-ring span recorder with a periodic atomic exporter."""

    def __init__(self, trace_dir: str, *, sample: float = 1.0,
                 ring_size: int = _DEFAULT_RING,
                 flush_interval_s: float = _DEFAULT_FLUSH_S):
        self.trace_dir = str(trace_dir)
        self.sample = float(sample)
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=max(1, int(ring_size)))
        self._dropped = 0
        self._thread_names: Dict[int, str] = {}
        self._flush_interval_s = float(flush_interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(self.trace_dir, exist_ok=True)

    # -- recording (hot side) ----------------------------------------------
    def sample_decision(self) -> bool:
        return self.sample >= 1.0 or random.random() < self.sample

    def span(self, name: str, cat: str, args: dict):
        ctx = _CTX.get()
        if ctx is not None and not ctx.sampled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def record(self, *, name: str, cat: str, ts: float, dur: float,
               rank: int, args: dict) -> None:
        th = threading.current_thread()
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": round(ts, 3), "dur": round(dur, 3),
              "pid": rank, "tid": th.ident, "args": args}
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)
            self._thread_names.setdefault(th.ident, th.name)

    def instant(self, name: str, cat: str = "app", **args) -> None:
        """A zero-duration marker (install drops, fault hits)."""
        ctx = _CTX.get()
        if ctx is not None and not ctx.sampled:
            return
        if ctx is not None:
            args.setdefault("trace_id", ctx.trace_id)
            if ctx.request_id is not None:
                args.setdefault("request_id", ctx.request_id)
        self.record(name=name, cat=cat, ts=_now_us(), dur=0.0,
                    rank=_rank(), args=args)

    # -- export (cold side) -------------------------------------------------
    def start_export_thread(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._export_loop, daemon=True,
            name="photon-trace-export")
        self._thread.start()

    def _export_loop(self) -> None:
        # bounded wait per cycle; stop() sets the event and joins
        while not self._stop.wait(self._flush_interval_s):
            self.flush()

    def flush(self) -> None:
        """Write one complete Chrome-trace JSON per rank seen so far —
        snapshot under the lock, serialize and write outside it (no I/O
        or callbacks run while holding the recording lock)."""
        with self._lock:
            events = list(self._events)
            names = dict(self._thread_names)
            dropped = self._dropped
        by_rank: Dict[int, list] = {}
        for ev in events:
            by_rank.setdefault(ev["pid"], []).append(ev)
        for rank, evs in by_rank.items():
            meta = [{"name": "process_name", "ph": "M", "pid": rank,
                     "tid": 0, "args": {"name": f"rank {rank}"}}]
            for tid in sorted({e["tid"] for e in evs}):
                meta.append({"name": "thread_name", "ph": "M",
                             "pid": rank, "tid": tid,
                             "args": {"name": names.get(tid, str(tid))}})
            doc = {"traceEvents": meta + evs,
                   "displayTimeUnit": "ms",
                   "metadata": {"rank": rank, "dropped_events": dropped,
                                "producer": "photon-trace"}}
            final = os.path.join(self.trace_dir, f"trace-rank{rank}.json")
            tmp = final + f".tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            durable_replace(tmp, final)

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None
        self.flush()  # final flush on the caller's thread


# -- module-global switch ----------------------------------------------------
_TRACER: Optional[Tracer] = None


def active_tracer() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def span(name: str, cat: str = "app", **args):
    """The one instrumentation entry point. Disabled: returns the shared
    null span (no allocation). Enabled: a recording span whose trace
    context comes from — or is installed into — the calling thread."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, cat, args)


def instant(name: str, cat: str = "app", **args) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, cat, **args)


def start(trace_dir: str, *, sample: float = 1.0,
          ring_size: int = _DEFAULT_RING,
          flush_interval_s: float = _DEFAULT_FLUSH_S,
          export_thread: bool = True) -> Tracer:
    """Install the process-wide tracer (idempotent per process: a second
    start replaces the first after stopping it)."""
    global _TRACER
    if _TRACER is not None:
        _TRACER.stop()
    t = Tracer(trace_dir, sample=sample, ring_size=ring_size,
               flush_interval_s=flush_interval_s)
    if export_thread:
        t.start_export_thread()
    _TRACER = t
    return t


def stop(timeout_s: float = 5.0) -> None:
    """Stop and uninstall the tracer: bounded export-thread join, then a
    final flush so the files on disk are complete."""
    global _TRACER
    t = _TRACER
    _TRACER = None  # flip the off switch before the (slow) join
    if t is not None:
        t.stop(timeout_s)


def maybe_start_from_env() -> Optional[Tracer]:
    """Driver hook: honor ``PHOTON_TRACE`` / ``PHOTON_TRACE_SAMPLE`` /
    ``PHOTON_TRACE_RING`` without any CLI plumbing. ``PHOTON_TRACE``
    that looks like a path (contains a separator or names an existing
    dir) is the trace dir; any other truthy value traces into
    ``./photon-trace``."""
    val = os.environ.get("PHOTON_TRACE", "").strip()
    if not val or val.lower() in ("0", "false", "off", "no"):
        return None
    if os.sep in val or os.path.isdir(val) or val.startswith("."):
        trace_dir = val
    else:
        trace_dir = "photon-trace"
    sample = float(os.environ.get("PHOTON_TRACE_SAMPLE", "1.0"))
    ring = int(os.environ.get("PHOTON_TRACE_RING", str(_DEFAULT_RING)))
    return start(trace_dir, sample=sample, ring_size=ring)
