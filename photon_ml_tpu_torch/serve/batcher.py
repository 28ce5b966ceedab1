"""Deadline-based micro-batcher with a bounded admission queue
(counterpart of ``photon_ml_tpu/serve/batcher.py``; host only).

The device scores padded batches; requests arrive one at a time. The
micro-batcher bridges the two: an admitted request waits at most
``max_delay_ms`` for companions, and a batch dispatches as soon as it
reaches ``max_batch`` rows — the classic throughput/latency knob
("right-sized batches keep the device fed", PAPERS.md GPU-learning
entry; Snap ML's pipelined host tier).

**Bounded, not elastic.** The admission queue holds at most ``max_queue``
requests. When it is full, :meth:`MicroBatcher.submit` raises
:class:`QueueFullError` IMMEDIATELY — explicit load shedding the caller
can convert into HTTP 429/503 — instead of queuing unboundedly and
converting overload into unbounded latency for everyone. (A server that
melts down by latency is much harder to operate than one that says no.)

**Stuck-batch watchdog.** A scoring execution that wedges (a device gone
bad, a capture that never returns) would otherwise hang the worker and
every queued request behind it. Each execution runs under the watchdog
discipline of ``parallel/resilience.py``: the batch is scored on a
helper thread joined with a timeout, and on expiry every request of that
batch fails with :class:`BatchWatchdogTimeout` (a
``resilience.WatchdogTimeout`` subclass) while the worker moves on —
same abandon-the-thread semantics as the health barrier's allgather
watchdog, for the same reason.
"""

from __future__ import annotations

import inspect
import logging
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

from photon_ml_tpu_torch.obs import trace as obs_trace
from photon_ml_tpu_torch.obs.logging import SlowRequestLog
from photon_ml_tpu_torch.parallel.resilience import WatchdogTimeout

_log = logging.getLogger(__name__)

__all__ = ["QueueFullError", "BatchWatchdogTimeout", "MicroBatcher",
           "PendingRequest", "ScoreContext"]


class ScoreContext:
    """Per-batch scoring budget + degradation state, threaded from the
    batcher into ``ScoringSession.score_rows``. ``deadline_at`` is an
    absolute ``time.monotonic()`` instant (None = no deadline);
    ``level`` is the ladder FLOOR the brownout controller set for this
    batch (0 full fidelity, 1 resident-coefficients-only, 2
    fixed-effect-only); the session raises ``degraded`` to the level it
    actually served at and appends a reason per escalation (``budget``,
    ``store_fault``, ``brownout``)."""

    __slots__ = ("deadline_at", "level", "degraded", "reasons")

    def __init__(self, deadline_at: Optional[float] = None,
                 level: int = 0):
        self.deadline_at = deadline_at
        self.level = int(level)
        self.degraded = int(level)
        self.reasons: List[str] = (["brownout"] if level > 0 else [])

    def remaining_s(self) -> Optional[float]:
        """Seconds of budget left (None = unlimited; may be <= 0)."""
        if self.deadline_at is None:
            return None
        return self.deadline_at - time.monotonic()


class QueueFullError(RuntimeError):
    """The request was SHED, not queued — either the admission queue was
    at capacity (``cause="queue_full"``) or the request's deadline
    expired while it waited for a batch slot (``cause="deadline"``).
    Callers should surface this as retryable backpressure (HTTP 429);
    ``retry_after_s`` is the server's backoff hint — the backlog ahead
    of a retry divided by the MEASURED drain rate (EWMA of batch
    service time), i.e. roughly how long a retry would wait."""

    def __init__(self, depth: int, capacity: int,
                 retry_after_s: float = 0.0, cause: str = "queue_full"):
        what = ("admission queue full" if cause == "queue_full"
                else "deadline expired while queued")
        super().__init__(
            f"{what} ({depth}/{capacity}); request shed — "
            "retry with backoff or scale out")
        self.depth = depth
        self.capacity = capacity
        self.retry_after_s = float(retry_after_s)
        self.cause = cause


class BatchWatchdogTimeout(WatchdogTimeout):
    """One scoring execution exceeded the batch watchdog; the batch's
    requests fail, the worker abandons the execution thread and
    continues (fail-stop discipline from ``parallel/resilience.py``)."""


class PendingRequest:
    """One admitted request: rows in, (scores, parts) or an exception
    out. ``result()`` blocks the submitting thread until the batcher's
    worker resolves it; ``add_done_callback`` is the non-blocking
    alternative the asyncio front end uses (the callback fires on the
    batcher's worker thread — bridge back to the event loop with
    ``loop.call_soon_threadsafe``)."""

    __slots__ = ("rows", "per_coordinate", "_event", "_result", "_error",
                 "admitted_at", "_callbacks", "_cb_lock", "request_id",
                 "trace_ctx", "deadline_at", "degraded")

    def __init__(self, rows: Sequence[dict], per_coordinate: bool,
                 request_id: Optional[str] = None,
                 deadline_at: Optional[float] = None):
        self.rows = list(rows)
        self.per_coordinate = per_coordinate
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._callbacks: List[Callable] = []
        self._cb_lock = threading.Lock()
        self.admitted_at = time.monotonic()
        # absolute budget expiry (monotonic) — every later stage checks
        # remaining = deadline_at - now before spending work on this
        # request; the ladder level the session actually served at lands
        # in `degraded` for the response body
        self.deadline_at = deadline_at
        self.degraded = 0
        # identity captured at admission: the submitting thread's trace
        # context rides the request across the worker-thread handoff, so
        # batcher/session/install spans land under the request's trace
        self.request_id = request_id
        self.trace_ctx = obs_trace.current_context()

    def set_result(self, value) -> None:
        self._result = value
        self._event.set()
        self._fire_callbacks()

    def set_error(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()
        self._fire_callbacks()

    def _fire_callbacks(self) -> None:
        with self._cb_lock:
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self)

    def add_done_callback(self, cb: Callable) -> None:
        """Invoke ``cb(self)`` when the request resolves (immediately if
        it already has). Runs on whichever thread resolves the request —
        the submitter may race the worker, so registration is locked
        against the resolution's callback drain."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("scoring request not resolved in time")
        if self._error is not None:
            raise self._error
        return self._result


class MicroBatcher:
    """Coalesce scoring requests into bounded, deadline-dispatched batches.

    ``score_fn(rows, per_coordinate)`` is the execution target — in the
    serving stack, ``ScoringSession.score_rows``. Requests carrying
    multiple rows are admitted atomically and their scores sliced back
    out of the batch result in order. ``max_batch`` bounds the rows per
    execution; a single request larger than ``max_batch`` is rejected at
    submit (ValueError) — the transport layer splits if it wants to.

    ``watchdog_s=None`` disables the stuck-batch watchdog (execution runs
    inline on the worker); the default keeps it armed.

    ``request_deadline_s`` arms queued-request expiry: a request that is
    still waiting when its admission time + deadline passes is shed by
    the worker (:class:`QueueFullError` with ``cause="deadline"``)
    instead of being scored — under sustained overload the queue would
    otherwise serve only requests whose clients already gave up. A
    per-request ``deadline_s`` at :meth:`submit` (the propagated
    ``X-Deadline-Ms`` budget) overrides it; either way the expiry is
    checked at every stage BEFORE work is spent (admission, queue,
    pre-compute), with the drop stage recorded in
    ``photon_serve_deadline_drop_total{stage}``.

    ``brownout`` is an optional
    :class:`~photon_ml_tpu_torch.serve.brownout.BrownoutController`: the
    batcher feeds it every request's queue wait and stamps its current
    level into each batch's :class:`ScoreContext` as the degradation
    floor (the session may degrade further on budget/faults).
    """

    def __init__(self, score_fn: Callable, *, max_batch: int = 64,
                 max_delay_ms: float = 5.0, max_queue: int = 256,
                 watchdog_s: Optional[float] = 60.0,
                 request_deadline_s: Optional[float] = None, metrics=None,
                 brownout=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._score_fn = score_fn
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.watchdog_s = watchdog_s
        self.request_deadline_s = (None if request_deadline_s is None
                                   else float(request_deadline_s))
        self.brownout = brownout
        # does score_fn accept the ScoreContext? Checked ONCE here so
        # plain fakes (tests pass lambdas) keep working ctx-less
        try:
            sig = inspect.signature(score_fn)
            self._ctx_ok = ("ctx" in sig.parameters or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in sig.parameters.values()))
        except (TypeError, ValueError):
            self._ctx_ok = False
        # measured drain rate for retry_after_s: EWMA of batch service
        # time + EWMA of requests per batch (worker writes, admission
        # reads — both under _ewma_lock)
        self._ewma_lock = threading.Lock()
        self._svc_ewma_s: Optional[float] = None
        self._rpb_ewma: Optional[float] = None
        self._queue: "queue.Queue[Optional[PendingRequest]]" = queue.Queue(
            maxsize=int(max_queue))
        self._metrics = metrics
        self._closed = False
        self._stop = threading.Event()
        # worker joins that outlived the drain grace (a wedged scoring
        # execution); counted + logged, mirroring producer_join_timeouts
        self.join_timeouts = 0
        # top-N slow-request exemplars (request id + queue/compute split)
        self.slow_log = SlowRequestLog(top_n=10)
        self._carry: Optional[PendingRequest] = None  # worker-only state
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="photon-serve-batcher")
        self._worker.start()

    # -- submission --------------------------------------------------------
    def submit(self, rows: Sequence[dict],
               per_coordinate: bool = False,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None) -> PendingRequest:
        """Admit a request (non-blocking). Raises :class:`QueueFullError`
        when the queue is at capacity and ValueError for oversized or
        empty requests; never blocks the caller on a full queue.
        ``deadline_s`` is this request's remaining budget (overrides the
        batcher-wide ``request_deadline_s``); a request arriving with no
        budget left is dropped HERE — the cheapest possible point."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        rows = list(rows)
        if not rows:
            raise ValueError("empty request (no rows)")
        if len(rows) > self.max_batch:
            raise ValueError(
                f"request of {len(rows)} rows exceeds max_batch="
                f"{self.max_batch}; split it client-side")
        budget = (float(deadline_s) if deadline_s is not None
                  else self.request_deadline_s)
        if budget is not None and budget <= 0.0:
            if self._metrics is not None:
                self._metrics.record_shed(cause="deadline")
                self._metrics.record_deadline_drop("admission")
            raise QueueFullError(self._queue.qsize(), self._queue.maxsize,
                                 retry_after_s=self.retry_after_s,
                                 cause="deadline")
        deadline_at = (None if budget is None
                       else time.monotonic() + budget)
        req = PendingRequest(rows, per_coordinate, request_id=request_id,
                             deadline_at=deadline_at)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            if self._metrics is not None:
                self._metrics.record_shed(cause="queue_full")
            raise QueueFullError(self._queue.qsize(), self._queue.maxsize,
                                 retry_after_s=self.retry_after_s,
                                 cause="queue_full") from None
        if self._metrics is not None:
            self._metrics.set_queue_depth(self._queue.qsize())
        return req

    @property
    def retry_after_s(self) -> float:
        """Backoff hint for shed requests: the backlog ahead of a retry
        divided by the MEASURED drain rate — queue depth over the EWMA
        of requests-per-batch, times the EWMA of batch service time.
        The previous static queue-depth x batching-deadline estimate
        ignored how long batches actually take, so it under-advised
        whenever scoring dominated the delay and over-advised under
        sparse traffic with mixed batch sizes. Before the first batch
        completes (no measurement yet) the static estimate remains the
        fallback. Floored at one batching deadline either way."""
        qsize = self._queue.qsize()
        with self._ewma_lock:
            svc, rpb = self._svc_ewma_s, self._rpb_ewma
        if svc is not None and rpb:
            return max(self.max_delay_s, (qsize / max(rpb, 1.0)) * svc)
        batches_queued = qsize / max(self.max_batch, 1)
        return max(self.max_delay_s, batches_queued * self.max_delay_s)

    def score(self, rows: Sequence[dict], per_coordinate: bool = False,
              timeout: Optional[float] = None,
              request_id: Optional[str] = None):
        """Blocking convenience: submit + wait for the result."""
        return self.submit(rows, per_coordinate,
                           request_id=request_id).result(timeout)

    @property
    def queue_depth(self) -> int:
        return self._queue.qsize()

    def close(self, drain_timeout_s: float = 5.0) -> None:
        """Stop admitting, let the worker drain queued requests, join it
        with a bounded timeout; a worker that outlives the grace (wedged
        execution) is counted and logged, never waited on forever."""
        if self._closed:
            return
        self._closed = True
        try:
            self._queue.put_nowait(None)  # wake the worker for shutdown
        except queue.Full:
            pass  # the stop event below wakes the idle poll instead
        self._stop.set()
        self._worker.join(drain_timeout_s)
        if self._worker.is_alive():
            self.join_timeouts += 1
            _log.warning(
                "MicroBatcher: worker thread %r still alive %.1fs after "
                "close() (wedged scoring execution?); leaking it as a "
                "daemon (join timeouts so far: %d)",
                self._worker.name, drain_timeout_s, self.join_timeouts)

    # -- worker ------------------------------------------------------------
    # idle-poll interval (seconds) for the worker's first-request wait; a
    # class attribute so tests can shrink it without monkeypatching
    _idle_poll_s = 0.2

    def _expired(self, req: PendingRequest, stage: str = "queue") -> bool:
        """Shed a request whose deadline passed (worker-side; returns
        True when the request was shed and must be skipped). ``stage``
        labels WHERE the budget ran out in the drop counter — the
        acceptance gate for "dropped before device compute"."""
        if req.deadline_at is None or time.monotonic() < req.deadline_at:
            return False
        if self._metrics is not None:
            self._metrics.record_shed(cause="deadline")
            self._metrics.record_deadline_drop(stage)
        req.set_error(QueueFullError(
            self._queue.qsize(), self._queue.maxsize,
            retry_after_s=self.retry_after_s, cause="deadline"))
        return True

    def _collect_batch(self) -> Optional[List[PendingRequest]]:
        """Block for the first request, then coalesce companions until
        the deadline (first request's arrival + max_delay) or max_batch
        rows. Requests are admitted whole: one whose rows would overflow
        the batch stays queued for the next one. Requests whose own
        deadline expired while queued are shed, not scored."""
        first = None
        while first is None:
            if self._carry is not None:
                first, self._carry = self._carry, None
            else:
                try:
                    # bounded idle poll: each expiry rechecks the stop
                    # event, so a closed batcher can never leave the
                    # worker parked in a blocking get forever
                    first = self._queue.get(timeout=self._idle_poll_s)
                except queue.Empty:
                    if self._stop.is_set():
                        return None
                    continue
                if first is None:
                    return None
            if self._expired(first):
                first = None
        batch = [first]
        rows = len(first.rows)
        deadline = time.monotonic() + self.max_delay_s
        while rows < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-post the shutdown token
                break
            if self._expired(nxt):
                continue
            if rows + len(nxt.rows) > self.max_batch:
                # no peeking API on queue.Queue: hold the overflow
                # request back; it seeds the next batch
                self._carry = nxt
                break
            batch.append(nxt)
            rows += len(nxt.rows)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._collect_batch()
            if batch is None:
                return
            self._execute(batch)
            if self._metrics is not None:
                self._metrics.set_queue_depth(self._queue.qsize())
            if (self._closed and self._carry is None
                    and self._queue.empty()):
                return

    def _score_with_watchdog(self, rows: List[dict], per_coordinate: bool,
                             ctx: Optional[ScoreContext] = None):
        kwargs = {"ctx": ctx} if ctx is not None else {}
        if self.watchdog_s is None:
            return self._score_fn(rows, per_coordinate, **kwargs)
        box: dict = {}
        tctx = obs_trace.current_context()  # ride into the helper thread

        def run():
            try:
                with obs_trace.use_context(tctx):
                    box["result"] = self._score_fn(rows, per_coordinate,
                                                   **kwargs)
            except BaseException as e:  # surfaced to the batch below
                box["error"] = e

        t = threading.Thread(target=run, daemon=True,
                             name="photon-serve-score")
        t.start()
        t.join(self.watchdog_s)
        if t.is_alive():
            raise BatchWatchdogTimeout(
                f"scoring execution exceeded the {self.watchdog_s:.1f}s "
                "batch watchdog (stuck device or compile); abandoning it "
                "and failing this batch's requests")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _execute(self, batch: List[PendingRequest]) -> None:
        # last budget check BEFORE device compute: a request that expired
        # between queue pickup and execution is dropped here, stage
        # "pre_compute" — never after scoring has been paid for
        batch = [req for req in batch
                 if not self._expired(req, stage="pre_compute")]
        if not batch:
            return
        rows: List[dict] = []
        for req in batch:
            rows.extend(req.rows)
        t0 = time.monotonic()
        queue_waits = [(t0 - req.admitted_at) * 1e3 for req in batch]
        per_coord = any(r.per_coordinate for r in batch)
        # the batch's scoring budget is its TIGHTEST member's deadline;
        # the brownout level is the ladder floor for the whole batch
        ctx: Optional[ScoreContext] = None
        if self._ctx_ok:
            deadlines = [r.deadline_at for r in batch
                         if r.deadline_at is not None]
            level = self.brownout.level if self.brownout is not None else 0
            ctx = ScoreContext(
                deadline_at=min(deadlines) if deadlines else None,
                level=level)
        # adopt the first traced request's context so the batch's session
        # and device-compute spans carry its trace/request id (a batch is
        # one execution; per-request attribution is the args list below)
        tctx = next((r.trace_ctx for r in batch
                     if r.trace_ctx is not None), None)
        try:
            with obs_trace.use_context(tctx), \
                    obs_trace.span(
                        "batch.execute", cat="serve", rows=len(rows),
                        requests=len(batch),
                        request_ids=[r.request_id for r in batch
                                     if r.request_id]):
                result = self._score_with_watchdog(rows, per_coord,
                                                   ctx=ctx)
        except BaseException as e:
            for req in batch:
                req.set_error(e)
            if self._metrics is not None:
                self._metrics.record_error()
            return
        if per_coord:
            scores, parts = result
        else:
            scores, parts = result, {}
        elapsed_ms = (time.monotonic() - t0) * 1e3
        if self._metrics is not None:
            self._metrics.record_batch(len(rows), self.max_batch,
                                       elapsed_ms)
        # fold this batch into the drain-rate EWMAs retry_after_s reads
        alpha = 0.2
        elapsed_s = elapsed_ms / 1e3
        with self._ewma_lock:
            self._svc_ewma_s = (
                elapsed_s if self._svc_ewma_s is None else
                self._svc_ewma_s + alpha * (elapsed_s - self._svc_ewma_s))
            self._rpb_ewma = (
                float(len(batch)) if self._rpb_ewma is None else
                self._rpb_ewma + alpha * (len(batch) - self._rpb_ewma))
        degraded = ctx.degraded if ctx is not None else 0
        now = time.monotonic()
        start = 0
        for req, waited_ms in zip(batch, queue_waits):
            end = start + len(req.rows)
            sl = {k: v[start:end] for k, v in parts.items()}
            req.degraded = degraded
            req.set_result((scores[start:end], sl)
                           if req.per_coordinate else scores[start:end])
            if self._metrics is not None:
                # queue_wait: admission -> execution start; compute: the
                # batch's scoring wall attributed to each of its requests
                self._metrics.record_request(
                    len(req.rows), (now - req.admitted_at) * 1e3,
                    queue_wait_ms=waited_ms, compute_ms=elapsed_ms)
                if degraded:
                    self._metrics.record_degraded(degraded)
            if self.brownout is not None:
                self.brownout.note_queue_wait(waited_ms)
            self.slow_log.note(
                req.request_id, (now - req.admitted_at) * 1e3,
                queue_wait_ms=round(waited_ms, 3),
                compute_ms=round(elapsed_ms, 3), rows=len(req.rows))
            start = end
