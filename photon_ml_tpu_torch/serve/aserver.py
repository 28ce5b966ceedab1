"""Asyncio serving front end + multi-replica front door (stdlib-only; a
copy of ``photon_ml_tpu/serve/aserver.py`` over the port's service, with
its close path repaired — see "Closing" below).

The threaded transport is ``http.server.ThreadingHTTPServer``: one OS
thread per connection, JSON parsed on the request thread, and every
blocked reader holding a thread while it waits on the batcher. At
production QPS the thread churn and per-connection stacks dominate the
host budget before the scoring stack is even warm. This module replaces
that edge with an event loop:

* :class:`AsyncScoringServer` — protocol-level HTTP/1.1 over
  ``asyncio.start_server`` (uvloop is used when importable; the stdlib
  loop is the floor). Requests are parsed ON the loop, handed to the
  existing :class:`~photon_ml_tpu_torch.serve.batcher.MicroBatcher` through
  its non-blocking ``submit`` (a bounded ``put_nowait`` — the loop never
  blocks on admission), and resolved back onto the loop via
  ``PendingRequest.add_done_callback`` + ``call_soon_threadsafe``. The
  200/400/404/429/503/504 status contract, ``Retry-After`` hints,
  graceful SIGTERM drain, and Prometheus ``/metrics`` all carry over
  (the response shaping is shared with the threaded server through
  :class:`~photon_ml_tpu_torch.serve.server.ScoringService`).

* :class:`AsyncFrontDoor` — the multi-replica edge: a tiny asyncio
  reverse proxy that spreads ``/score`` traffic across N replica
  servers, least-loaded first (ties round-robin), with per-backend
  connection pooling, failure cool-down, and one retry on another
  backend. Replicas stay consistent under hot swap by all watching the
  same registry (``serve/watcher.py``); the front door is deliberately
  model-oblivious.

Entity-affinity routing (``affinity=True``): the front door additionally
runs a :class:`~photon_ml_tpu_torch.serve.membership.MembershipManager` — the
training tier's stable-hash owner map over the live replica set — and
routes each ``/score`` row to the replica that OWNS its entity (mixed
batches are scattered by owner and the per-row scores merged at the
door). Replicas learn their slice through ``POST /admin/membership``
broadcasts; on churn (join/leave/breaker-open) the door proposes a new
epoch, pushes the moved hot ids into their new owners' paged tables,
and commits the epoch only AFTER every member acknowledged — a
rebalance is a bounded warm handoff, not a cold-fault storm. When an
owner is unroutable the request fails over to any live replica (which
serves the foreign entities through its store/LRU path) and the
response carries ``"routing": "fallback"`` — degraded residency, never
a 5xx.

Admin/scoring split: ``/admin/reload`` and ``/admin/membership`` run in
a worker thread (``run_in_executor``) because a swap or a prefetch
legitimately takes milliseconds to seconds — the loop keeps serving
scores while they build off to the side.

Closing: since Python 3.12, ``Server.wait_closed()`` waits until every
client connection has closed, and a front door keeps pooled keep-alive
connections to each replica, so a close that awaits it before dropping
connections never returns while a client holds one. Each ``aclose`` here
stops accepting, closes the connections idle between requests (those
waiting for the next request head), gives in-flight requests up to the
drain timeout, drains the batcher (a replica), cancels the stragglers and
only then waits for ``wait_closed`` — and that wait is bounded too. A
connection that finishes a request while its listener drains answers
``Connection: close`` and is closed.
"""

from __future__ import annotations

import asyncio
import json
import signal
import time
from typing import Dict, List, Optional, Sequence, Tuple

from photon_ml_tpu_torch.obs import trace as obs_trace
from photon_ml_tpu_torch.obs.metrics import Histogram, escape_label_value
from photon_ml_tpu_torch.parallel import fault_injection
from photon_ml_tpu_torch.serve.membership import MembershipEpoch, MembershipManager
from photon_ml_tpu_torch.serve.server import ScoringService

__all__ = ["AsyncScoringServer", "AsyncFrontDoor", "install_uvloop"]

_MAX_HEAD = 64 * 1024
_MAX_BODY = 64 * 1024 * 1024
_WAIT_CLOSED_S = 1.0  # bound on Server.wait_closed once connections are down


def install_uvloop() -> bool:
    """Install uvloop's event-loop policy when the wheel is present.
    Optional by design: the container may not ship uvloop, and the
    stdlib loop must remain a correct (slower) floor."""
    try:
        import uvloop  # type: ignore
    except ImportError:
        return False
    uvloop.install()
    return True


def _http_date() -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime())


def _encode_response(status: int, body, content_type="application/json",
                     keep_alive=True, extra_headers: Sequence[Tuple[str,
                                                                    str]] = ()
                     ) -> bytes:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              409: "Conflict", 429: "Too Many Requests",
              500: "Internal Server Error", 503: "Service Unavailable",
              504: "Gateway Timeout"}.get(status, "Status")
    data = body if isinstance(body, (bytes, str)) else json.dumps(body)
    if isinstance(data, str):
        data = data.encode("utf-8")
    head = [f"HTTP/1.1 {status} {reason}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(data)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}"]
    for k, v in extra_headers:
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode("ascii") + data


async def _read_request(reader: asyncio.StreamReader, on_head=None):
    """One HTTP/1.1 request: ``(method, path, headers, body)`` or None
    on clean EOF. Raises ValueError on malformed input (caller answers
    400 and closes). ``on_head()`` is called once the request head has
    arrived (the connection is no longer idle)."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None  # clean close between requests
        raise ValueError("truncated request head") from None
    except asyncio.LimitOverrunError:
        raise ValueError(f"request head over {_MAX_HEAD} bytes") from None
    if on_head is not None:
        on_head()
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, path, _version = lines[0].split(" ", 2)
    except ValueError:
        raise ValueError(f"bad request line {lines[0]!r}") from None
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        raise ValueError("chunked request bodies are not supported")
    length = int(headers.get("content-length", "0") or 0)
    if length < 0 or length > _MAX_BODY:
        raise ValueError(f"bad content-length {length}")
    body = await reader.readexactly(length) if length else b""
    return method, path, headers, body


def _request_id_from(headers: Dict[str, str]) -> str:
    """Honor a client-supplied X-Request-Id (trimmed, bounded); assign
    one otherwise — the same contract as the threaded handler."""
    rid = (headers.get("x-request-id") or "").strip()
    return rid[:128] if rid else obs_trace.new_request_id()


class _Connections:
    """The open client connections of one listener, one task each, and
    which of them are idle: waiting for the next request head. A close
    cancels the idle ones at once (again and again while it waits, as
    busy ones come back to idle), gives the busy ones a bounded time,
    then cancels what is left — so a close never waits on a client that
    simply keeps its connection open."""

    def __init__(self):
        self.tasks: set = set()
        self.idle: set = set()

    def __len__(self) -> int:
        return len(self.tasks)

    def opened(self, task) -> None:
        self.tasks.add(task)

    def closed(self, task) -> None:
        self.tasks.discard(task)
        self.idle.discard(task)

    def cancel_idle(self) -> None:
        for task in list(self.idle):
            task.cancel()

    async def drain(self, timeout_s: float) -> None:
        """Close the idle connections and wait (up to ``timeout_s``) for
        the busy ones to answer and close."""
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        while True:
            self.cancel_idle()
            if not self.tasks or time.monotonic() >= deadline:
                return
            await asyncio.sleep(0.01)

    async def cancel_all(self, timeout_s: float = _WAIT_CLOSED_S) -> None:
        tasks = list(self.tasks)
        for task in tasks:
            task.cancel()
        if tasks:
            await asyncio.wait(tasks, timeout=timeout_s)


async def _close_listener(server: Optional[asyncio.AbstractServer]) -> None:
    """``wait_closed`` with a bound: by now every connection is closed or
    cancelled, so it returns at once; the bound keeps a transport that
    never reports its loss from hanging the close."""
    if server is None:
        return
    try:
        await asyncio.wait_for(server.wait_closed(), _WAIT_CLOSED_S)
    except asyncio.TimeoutError:
        pass


class AsyncScoringServer:
    """Event-loop HTTP endpoint over a :class:`ScoringService`.

    Same endpoints and status contract as the threaded
    :class:`~photon_ml_tpu_torch.serve.server.ScoringServer`; the difference
    is the execution model — parsing on the loop, scoring resolved
    through batcher callbacks, no thread per connection. ``start()`` /
    ``aclose()`` are the async API (tests, in-process bench);
    :meth:`run_forever` is the driver entry (installs SIGTERM/SIGINT
    drain handlers on the loop)."""

    def __init__(self, service: ScoringService, host: str = "127.0.0.1",
                 port: int = 0):
        self.service = service
        self._host_arg, self._port_arg = host, port
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.host: str = host
        self.port: int = 0
        self._conns = _Connections()
        self._draining = False

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "AsyncScoringServer":
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._serve_connection, self._host_arg, self._port_arg,
            limit=_MAX_HEAD)
        addr = self._server.sockets[0].getsockname()
        self.host, self.port = addr[0], addr[1]
        return self

    async def aclose(self, drain_timeout_s: float = 5.0) -> None:
        """Graceful drain: stop accepting, close the connections idle
        between requests, let in-flight requests finish (bounded), flush
        the batcher, drop stragglers, then a bounded ``wait_closed``."""
        self._draining = True
        if self._server is not None:
            self._server.close()
        await self._conns.drain(drain_timeout_s)
        # batcher drain blocks: keep the loop alive in an executor
        await asyncio.get_running_loop().run_in_executor(
            None, self.service.close, drain_timeout_s)
        await self._conns.cancel_all()
        await _close_listener(self._server)

    def run_forever(self, drain_timeout_s: float = 30.0,
                    ready_callback=None, stop_callback=None) -> int:
        """Foreground serve (the CLI driver's main loop): SIGTERM/SIGINT
        stop the listener, the batcher drains, then return 0 — the same
        rolling-restart contract as the threaded server.
        ``stop_callback(signum)`` runs once the signal arrived, before
        the drain."""
        install_uvloop()

        async def main():
            stop = asyncio.Event()
            fired = []
            loop = asyncio.get_running_loop()

            def on_signal(sig):
                fired.append(sig)
                stop.set()

            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    loop.add_signal_handler(sig, on_signal, sig)
                except (NotImplementedError, RuntimeError):
                    pass  # non-main thread / platforms without support
            await self.start()
            if ready_callback is not None:
                # ready callbacks are opaque and the driver's write
                # JSONL logs — file IO stays off the loop
                await loop.run_in_executor(None, ready_callback, self)
            await stop.wait()
            if stop_callback is not None:
                await loop.run_in_executor(None, stop_callback, fired[0])
            await self.aclose(drain_timeout_s)

        asyncio.run(main())
        return 0

    # -- connection handling ----------------------------------------------
    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        conns = self._conns
        conns.opened(task)
        try:
            while not self._draining:
                conns.idle.add(task)
                try:
                    req = await _read_request(
                        reader, on_head=lambda: conns.idle.discard(task))
                except ValueError as e:
                    writer.write(_encode_response(
                        400, {"error": str(e)}, keep_alive=False))
                    await writer.drain()
                    return
                except (ConnectionError, asyncio.IncompleteReadError):
                    return
                if req is None:
                    return
                method, path, headers, body = req
                data = await self._dispatch(method, path, body, headers)
                keep = (headers.get("connection", "").lower() != "close"
                        and not self._draining)
                writer.write(data if keep else
                             data.replace(b"Connection: keep-alive",
                                          b"Connection: close", 1))
                await writer.drain()
                if not keep:
                    return
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            conns.closed(task)
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, method: str, path: str, body: bytes,
                        headers: Optional[Dict[str, str]] = None) -> bytes:
        svc = self.service
        rid = _request_id_from(headers or {})
        rid_hdr = (("X-Request-Id", rid),)
        if method == "GET":
            if path == "/healthz":
                status, payload = svc.handle_healthz()
                payload["server"] = "asyncio"
                return _encode_response(status, payload,
                                        extra_headers=rid_hdr)
            if path == "/metrics":
                status, text = svc.handle_metrics()
                return _encode_response(
                    status, text, content_type="text/plain; version=0.0.4",
                    extra_headers=rid_hdr)
            return _encode_response(404, {"error": f"unknown path {path}"},
                                    extra_headers=rid_hdr)
        if method != "POST" or path not in ("/score", "/admin/reload",
                                            "/admin/membership"):
            return _encode_response(404, {"error": f"unknown path {path}"},
                                    extra_headers=rid_hdr)
        try:
            payload = json.loads(body or b"null")
        except (ValueError, json.JSONDecodeError) as e:
            return _encode_response(
                400, {"error": f"bad JSON: {e}", "requestId": rid},
                extra_headers=rid_hdr)
        if path == "/admin/reload":
            # swaps take ms-seconds: off the loop, scores keep flowing
            status, resp = await asyncio.get_running_loop().run_in_executor(
                None, svc.handle_reload, payload)
            return _encode_response(status, resp, extra_headers=rid_hdr)
        if path == "/admin/membership":
            # the prefetch half does store IO — off the loop,
            # like reload; the reply still means "pages are warm"
            status, resp = await asyncio.get_running_loop().run_in_executor(
                None, svc.handle_membership, payload)
            return _encode_response(status, resp, extra_headers=rid_hdr)
        try:
            deadline_ms = svc.parse_deadline_ms(
                (headers or {}).get("x-deadline-ms"))
        except ValueError as e:
            return _encode_response(
                400, {"error": str(e), "requestId": rid},
                extra_headers=rid_hdr)
        # contextvars-ambient context: safe across the await (each
        # asyncio task carries its own copy, no cross-request bleed)
        with obs_trace.request_context(request_id=rid):
            status, resp = await self.score_async(payload, request_id=rid,
                                                  deadline_ms=deadline_ms)
        extra = rid_hdr
        if status == 429 and isinstance(resp, dict):
            after = max(1, int(-(-float(resp.get("retryAfterS", 1.0)) // 1)))
            extra = rid_hdr + (("Retry-After", str(after)),)
        return _encode_response(status, resp, extra_headers=extra)

    async def score_async(self, payload,
                          request_id: Optional[str] = None,
                          deadline_ms: Optional[float] = None
                          ) -> Tuple[int, dict]:
        """``/score`` without blocking the loop: validate inline, admit
        through the batcher's non-blocking submit, await the worker's
        resolution via done-callback. ``deadline_ms`` is the propagated
        ``X-Deadline-Ms`` budget."""
        svc = self.service
        valid, err = svc.validate_score_payload(payload)
        if valid is None:
            if request_id:
                err = dict(err, requestId=request_id)
            return 400, err
        rows, per_coord = valid
        loop = asyncio.get_running_loop()
        fut: "asyncio.Future" = loop.create_future()

        def _resolve(req):
            if not fut.cancelled():
                loop.call_soon_threadsafe(_complete, req)

        def _complete(req):
            if fut.cancelled():
                return
            if req.error is not None:
                fut.set_exception(req.error)
            else:
                # the ladder level rides along with the scores so the
                # response body can report "degraded"
                fut.set_result((req.result(0), req.degraded))

        try:
            with obs_trace.span("http.score", cat="serve", rows=len(rows)):
                pending = svc.batcher.submit(
                    rows, per_coord, request_id=request_id,
                    deadline_s=svc.deadline_s(deadline_ms))
            pending.add_done_callback(_resolve)
            result, degraded = await asyncio.wait_for(
                fut, svc.request_timeout_s)
        except Exception as e:
            return svc.score_error_response(e, request_id=request_id)
        return 200, svc.score_body(rows, per_coord, result,
                                   degraded=degraded)


_BACKEND_STATE_NUM = {"closed": 0, "half_open": 1, "open": 2}

# Hedge-policy latency resolution: ~1.25x geometric steps. The default
# exposition buckets step 2-2.5x, and a p99 read at bucket granularity
# can overstate the true tail by that whole ratio — a hedge that fires
# 2.5x late cannot bound the tail it exists to cut. This histogram is
# policy-internal (never rendered), so density costs nothing on the wire.
_HEDGE_LAT_BUCKETS_MS = (
    0.5, 1.0, 1.5, 2.0, 2.5, 3.2, 4.0, 5.0, 6.5, 8.0, 10.0, 13.0, 16.0,
    20.0, 25.0, 32.0, 40.0, 50.0, 65.0, 80.0, 100.0, 130.0, 160.0, 200.0,
    250.0, 320.0, 400.0, 500.0, 650.0, 800.0, 1000.0, 1300.0, 1600.0,
    2000.0, 2500.0, 5000.0,
)


class _Backend:
    """One replica behind the front door: address, pooled connections,
    in-flight count, and a per-backend circuit breaker.

    Breaker states: ``closed`` (serving), ``open`` (ejected after
    ``threshold`` CONSECUTIVE failures; nothing is routed here until a
    timed health probe readmits it), ``half_open`` (a ``/healthz`` probe
    is in flight; success closes the breaker, failure reopens it with an
    escalated jittered cool-down). A single failure no longer ejects a
    replica — one slow GC pause used to eject-and-readmit on a fixed
    timer with no health evidence at all."""

    __slots__ = ("host", "port", "inflight", "pool", "picked", "cooldowns",
                 "state", "fails", "opened", "next_probe_at",
                 "probe_inflight", "backoff", "lat_ms")

    def __init__(self, host: str, port: int, cooldown_s: float = 1.0):
        from photon_ml_tpu_torch.parallel.resilience import Backoff

        self.host = host
        self.port = int(port)
        self.inflight = 0
        self.pool: List[tuple] = []  # (reader, writer) keep-alive pairs
        self.picked = 0     # times selected to carry a proxied request
        self.cooldowns = 0  # failure events observed (counter continuity)
        self.state = "closed"
        self.fails = 0      # CONSECUTIVE failures; any success resets
        self.opened = 0     # times the breaker tripped open
        self.next_probe_at = 0.0
        self.probe_inflight = False
        # open-state cool-down: exponential with jitter so N front doors
        # probing one recovering replica don't re-slam it in lockstep
        self.backoff = Backoff(base_s=cooldown_s, factor=2.0,
                               max_s=max(30.0, cooldown_s), jitter=0.1)
        # observed exchange latency — the hedging policy's p99 source
        self.lat_ms = Histogram(_HEDGE_LAT_BUCKETS_MS)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def note_latency(self, ms: float) -> None:
        self.lat_ms.observe(ms)

    def record_failure(self, threshold: int, now: float) -> None:
        self.fails += 1
        self.cooldowns += 1
        if self.state == "half_open" or self.fails >= threshold:
            if self.state != "open":
                self.opened += 1
            self.state = "open"
            self.next_probe_at = now + self.backoff.next_delay()

    def record_success(self) -> None:
        self.fails = 0
        self.state = "closed"
        self.backoff.reset()


class AsyncFrontDoor:
    """Least-loaded/round-robin HTTP front door for N scoring replicas.

    Policy: among backends whose circuit breaker is CLOSED, pick the
    lowest in-flight count (ties resolved round-robin). A backend that
    fails to connect or mid-exchange gets the request retried ONCE on
    another backend; ``breaker_threshold`` consecutive failures open its
    breaker — nothing is routed there until a timed ``/healthz`` probe
    (half-open state, jittered exponential cool-down starting at
    ``retry_backend_s``) readmits it. With every backend open the client
    sees 503 (the front door never queues — queueing and shedding live
    in the replicas' batchers, one admission-control point per
    process).

    The probe readmits only on a ``/healthz`` body whose ``status`` is
    ``ok``: a replica still prewarming pages after a swap reports
    ``warming`` (HTTP 200 — the process is alive) and is HELD half-open
    with a quick re-probe instead of being readmitted into a cold-fault
    storm or backed off as if it had failed.

    Hedging (``hedge_enabled``): when a picked backend's exchange runs
    past its own observed p99 (from at least ``hedge_min_samples``
    samples, floored at ``hedge_min_s``), the front door fires a
    DUPLICATE of the request at a second backend; the first success
    wins and the loser is cancelled — a cancelled loser is never
    counted as a backend failure, so hedging cannot trip breakers. Use
    only for idempotent traffic (scoring is).

    Deadline guard: a ``/score`` carrying ``X-Deadline-Ms <= 0`` is
    shed HERE (429, ``photon_fd_deadline_rejects_total``) — the
    cheapest drop point of all — and a positive budget is forwarded to
    the replica, whose batcher/session spend it stage by stage.

    Entity affinity (``affinity=True``): ``/score`` rows are routed to
    the replica owning their entity under the committed
    :class:`~photon_ml_tpu_torch.serve.membership.MembershipEpoch` (a batch
    spanning owners is scattered and its per-row scores merged back in
    request order). The failover ladder per owner group: owner closed →
    route; owner open/unknown → any live replica + ``"routing":
    "fallback"`` label (``photon_fd_owner_miss_total{reason}``: a
    breaker-open owner is ``breaker``, an owner outside the backend
    list is ``epoch_skew``, a hedge duplicate winning on a non-owner is
    ``hedge``); nothing live → the plain 503. Membership changes flow
    through :meth:`_rebalance` — propose over the live set, broadcast
    ``/admin/membership`` (with the moved hot ids to prefetch) to every
    member, commit only after all acknowledged. Routing is by the
    row's first ``entityIds`` column (sorted by name): co-residency is
    an optimization, so additional entity columns simply resolve
    through their replica's LRU path at full fidelity."""

    def __init__(self, backends: Sequence[str], host: str = "127.0.0.1",
                 port: int = 0, policy: str = "least_loaded",
                 retry_backend_s: float = 1.0, breaker_threshold: int = 3,
                 hedge_enabled: bool = False, hedge_min_s: float = 0.05,
                 hedge_min_samples: int = 20, affinity: bool = False,
                 affinity_id_kind: str = "auto", hot_track: int = 4096):
        if not backends:
            raise ValueError("front door needs at least one backend")
        if policy not in ("least_loaded", "round_robin"):
            raise ValueError(f"unknown policy {policy!r}")
        if breaker_threshold < 1:
            raise ValueError(f"breaker_threshold must be >= 1, got "
                             f"{breaker_threshold}")
        self._backends = []
        for b in backends:
            h, _, p = str(b).rpartition(":")
            self._backends.append(_Backend(h or "127.0.0.1", int(p),
                                           cooldown_s=float(retry_backend_s)))
        self.policy = policy
        self.retry_backend_s = float(retry_backend_s)
        self.breaker_threshold = int(breaker_threshold)
        self._rr = 0
        self._host_arg, self._port_arg = host, port
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns = _Connections()
        self._draining = False
        self.host: str = host
        self.port: int = 0
        self.hedge_enabled = bool(hedge_enabled)
        self.hedge_min_s = float(hedge_min_s)
        self.hedge_min_samples = int(hedge_min_samples)
        self.proxied = 0
        self.retried = 0
        self.unavailable = 0
        self.readmitted = 0  # breakers closed again by a healthz probe
        self.hedged = 0           # duplicate requests fired
        self.hedge_wins = 0       # duplicates that answered first
        self.deadline_rejects = 0  # X-Deadline-Ms <= 0 shed at the door
        self.warming_holds = 0    # probes held half-open on "warming"
        # -- entity-affinity membership state ------------------------------
        self._membership: Optional[MembershipManager] = (
            MembershipManager([b.address for b in self._backends],
                              id_kind=affinity_id_kind,
                              hot_track=hot_track)
            if affinity else None)
        self._announced = False        # epoch pushed to every member yet?
        self._rebalance_lock = asyncio.Lock()
        self._bg_tasks: set = set()    # live rebalances and health probes
        self.owner_routed = 0     # groups answered by their owner
        self.scattered = 0        # batches split across owners
        self.fallback_served = 0  # responses served off the fallback path
        self.owner_miss: Dict[str, int] = {"breaker": 0, "epoch_skew": 0,
                                           "hedge": 0}
        self.epoch_commits = 0
        self.membership_faults = 0  # rebalance failures (fd.membership)
        self.route_faults = 0       # routing failures (fd.route)
        self.prefetch_entities_sent = 0  # replica-reported prefetch sums
        self.prefetch_bytes_sent = 0

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "AsyncFrontDoor":
        self._server = await asyncio.start_server(
            self._serve_connection, self._host_arg, self._port_arg,
            limit=_MAX_HEAD)
        addr = self._server.sockets[0].getsockname()
        self.host, self.port = addr[0], addr[1]
        return self

    async def aclose(self, drain_timeout_s: float = 5.0) -> None:
        """Stop accepting, close the pooled backend connections, close
        the client connections idle between requests, give in-flight
        proxied requests up to ``drain_timeout_s``, cancel the rest and
        the background rebalances, then a bounded ``wait_closed``. A
        backend connection freed while draining is closed, not pooled."""
        self._draining = True
        if self._server is not None:
            self._server.close()
        for b in self._backends:
            self._close_pool(b)
        await self._conns.drain(drain_timeout_s)
        await self._conns.cancel_all()
        for task in list(self._bg_tasks):
            task.cancel()
        for b in self._backends:
            self._close_pool(b)
        await _close_listener(self._server)

    @staticmethod
    def _close_pool(backend: "_Backend") -> None:
        for _r, w in backend.pool:
            try:
                w.close()
            except Exception:
                pass
        backend.pool.clear()

    def run_forever(self, ready_callback=None) -> int:
        install_uvloop()

        async def main():
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    loop.add_signal_handler(sig, stop.set)
                except (NotImplementedError, RuntimeError):
                    pass
            await self.start()
            if self._membership is not None:
                # announce the initial epoch so every replica pages its
                # owned slice from the first request (a failed announce
                # is retried lazily from the request path)
                await self._rebalance()
            if ready_callback is not None:
                # same contract as AsyncScoringServer.run_forever: the
                # driver's ready callback logs to disk — executor it
                await loop.run_in_executor(None, ready_callback, self)
            await stop.wait()
            await self.aclose()

        asyncio.run(main())
        return 0

    # -- circuit breaker ---------------------------------------------------
    def _maybe_probe(self, backend: _Backend, now: float) -> None:
        """Lazy open→half_open transition: when an open backend's
        cool-down has elapsed, fire ONE async ``/healthz`` probe (guarded
        so concurrent picks don't stack probes). Runs from the request
        path — no timer thread; an idle front door simply probes on its
        next request or metrics scrape. A HALF-OPEN backend re-probes
        too: a warming replica parks there until its installer drains."""
        if (backend.state not in ("open", "half_open")
                or now < backend.next_probe_at or backend.probe_inflight):
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (sync caller): stay open until a real request
        backend.state = "half_open"
        backend.probe_inflight = True
        task = loop.create_task(self._probe(backend))
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    async def _probe(self, backend: _Backend) -> None:
        probe = (b"GET /healthz HTTP/1.1\r\nHost: backend\r\n"
                 b"Content-Length: 0\r\nConnection: keep-alive\r\n\r\n")
        warming = False
        try:
            data = await self._backend_exchange(backend, probe)
            is_200 = b" 200 " in data.split(b"\r\n", 1)[0]
            # a 200 readmits UNLESS the body explicitly says the replica
            # is still prewarming pages after a swap ({"status":
            # "warming"}) — alive, but it must stay out of rotation
            # until its installer drains; health endpoints without the
            # status body keep their plain 200-is-healthy contract
            warming = is_200 and b'"status": "warming"' in data
            ok = is_200 and not warming
        except Exception:
            ok = False
        finally:
            backend.probe_inflight = False
        if ok:
            backend.record_success()
            self.readmitted += 1
        elif warming:
            # alive but cold: hold half-open with a quick re-probe and
            # WITHOUT escalating the failure backoff
            self.warming_holds += 1
            backend.next_probe_at = time.monotonic() + self.retry_backend_s
        else:
            backend.record_failure(self.breaker_threshold, time.monotonic())

    # -- backend selection -------------------------------------------------
    def _pick(self, exclude: set) -> Optional[_Backend]:
        now = time.monotonic()
        live = []
        for b in self._backends:
            self._maybe_probe(b, now)
            if b.address not in exclude and b.state == "closed":
                live.append(b)
        if not live:
            return None
        if self.policy == "round_robin":
            self._rr += 1
            chosen = live[self._rr % len(live)]
        else:
            best = min(b.inflight for b in live)
            tied = [b for b in live if b.inflight == best]
            self._rr += 1
            chosen = tied[self._rr % len(tied)]
        chosen.picked += 1
        return chosen

    async def _backend_exchange(self, backend: _Backend,
                                request: bytes) -> bytes:
        """Send one request on a pooled (or fresh) connection; return
        the full response bytes (head + body, content-length framed)."""
        if backend.pool:
            reader, writer = backend.pool.pop()
        else:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(backend.host, backend.port,
                                        limit=_MAX_HEAD), timeout=5.0)
        try:
            writer.write(request)
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            length = 0
            for line in head.split(b"\r\n")[1:]:
                if line.lower().startswith(b"content-length:"):
                    length = int(line.split(b":", 1)[1])
                    break
            body = await reader.readexactly(length) if length else b""
            if self._draining:
                writer.close()
            else:
                backend.pool.append((reader, writer))
            return head + body
        except BaseException:
            try:
                writer.close()
            except Exception:
                pass
            raise

    # -- proxy loop --------------------------------------------------------
    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        conns = self._conns
        conns.opened(task)
        try:
            while not self._draining:
                conns.idle.add(task)
                try:
                    req = await _read_request(
                        reader, on_head=lambda: conns.idle.discard(task))
                except ValueError as e:
                    writer.write(_encode_response(
                        400, {"error": str(e)}, keep_alive=False))
                    await writer.drain()
                    return
                except (ConnectionError, asyncio.IncompleteReadError):
                    return
                if req is None:
                    return
                method, path, headers, body = req
                rid = _request_id_from(headers)
                rid_hdr = (("X-Request-Id", rid),)
                if method == "GET" and path == "/fd/healthz":
                    writer.write(_encode_response(200, self.stats(),
                                                  extra_headers=rid_hdr))
                    await writer.drain()
                    continue
                if method == "GET" and path == "/fd/metrics":
                    text = await self._fd_metrics()
                    writer.write(_encode_response(
                        200, text, content_type="text/plain; version=0.0.4",
                        extra_headers=rid_hdr))
                    await writer.drain()
                    continue
                if (method == "POST"
                        and path in ("/fd/admin/join", "/fd/admin/leave")):
                    writer.write(await self._handle_admin(path, body, rid))
                    await writer.drain()
                    continue
                deadline_ms = None
                if method == "POST":
                    try:
                        deadline_ms = ScoringService.parse_deadline_ms(
                            headers.get("x-deadline-ms"))
                    except ValueError as e:
                        writer.write(_encode_response(
                            400, {"error": str(e), "requestId": rid},
                            extra_headers=rid_hdr))
                        await writer.drain()
                        continue
                    if deadline_ms is not None and deadline_ms <= 0:
                        # the budget is already spent: drop at the door,
                        # before any backend connection is even touched
                        self.deadline_rejects += 1
                        writer.write(_encode_response(
                            429, {"error": "deadline budget exhausted "
                                           "before proxy", "shed": True,
                                  "cause": "deadline", "requestId": rid},
                            extra_headers=rid_hdr))
                        await writer.drain()
                        continue
                if (self._membership is not None and method == "POST"
                        and path == "/score"):
                    data = await self._score_affinity(body, rid,
                                                      deadline_ms)
                else:
                    data = await self._proxy(method, path, body,
                                             request_id=rid,
                                             deadline_ms=deadline_ms)
                writer.write(data)
                await writer.drain()
                if headers.get("connection", "").lower() == "close":
                    return
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            conns.closed(task)
            try:
                writer.close()
            except Exception:
                pass

    def _hedge_delay(self, backend: _Backend) -> Optional[float]:
        """How long to wait on ``backend`` before firing a duplicate at a
        second replica — its own observed p99 (floored at ``hedge_min_s``)
        — or None when hedging is off, there is no second replica to
        hedge to, or the backend has too few samples to call a tail."""
        if (not self.hedge_enabled or len(self._backends) < 2
                or backend.lat_ms.total < self.hedge_min_samples):
            return None
        return max(self.hedge_min_s, backend.lat_ms.quantile(0.99) / 1e3)

    async def _timed_exchange(self, backend: _Backend,
                              request: bytes, path: str) -> bytes:
        """One breaker-aware exchange: inflight bookkeeping, fault hook,
        latency sample + breaker close on success, breaker failure on
        error. A ``CancelledError`` (hedge loser being reaped) is NOT a
        backend failure — cancelling the slow-but-healthy replica must
        never trip its breaker."""
        backend.inflight += 1
        try:
            with obs_trace.span("fd.proxy", cat="serve", path=path,
                                backend=backend.address):
                t0 = time.monotonic()
                await fault_injection.async_check("fd.proxy")
                data = await self._backend_exchange(backend, request)
            backend.record_success()
            backend.note_latency((time.monotonic() - t0) * 1e3)
            return data
        except asyncio.CancelledError:
            raise
        except BaseException:
            backend.record_failure(self.breaker_threshold, time.monotonic())
            raise
        finally:
            backend.inflight -= 1

    async def _hedged_exchange(self, primary: _Backend, request: bytes,
                               path: str, tried: set
                               ) -> Tuple[Optional[bytes], bool]:
        """Race ``primary`` against (at most one) hedge duplicate: wait
        ``_hedge_delay`` on the primary; if it hasn't answered, fire the
        same request at a second backend and take whichever answers
        first, cancelling the loser. Returns ``(response, hedge_won)``;
        the response is None when every attempted backend failed
        (addresses added to ``tried``). ``hedge_won`` lets the affinity
        router know the answer came from a NON-owner (the duplicate) so
        it can label the response as fallback-served."""
        task_backend: Dict["asyncio.Task", _Backend] = {}

        def _spawn(b: _Backend) -> "asyncio.Task":
            t = asyncio.ensure_future(
                self._timed_exchange(b, request, path))
            task_backend[t] = b
            return t

        pending = {_spawn(primary)}
        delay = self._hedge_delay(primary)
        winner: Optional[bytes] = None
        winner_was_hedge = False
        hedge_task: Optional["asyncio.Task"] = None
        while pending:
            done, pending = await asyncio.wait(
                pending, timeout=delay,
                return_when=asyncio.FIRST_COMPLETED)
            if not done:
                # primary ran past its own p99: duplicate onto a second
                # replica (once), then wait for whichever answers first
                delay = None
                alt = self._pick(tried | {primary.address})
                if alt is not None:
                    self.hedged += 1
                    hedge_task = _spawn(alt)
                    pending.add(hedge_task)
                continue
            delay = None
            for task in done:
                backend = task_backend[task]
                if task.cancelled() or task.exception() is not None:
                    tried.add(backend.address)
                    continue
                if winner is None:
                    winner = task.result()
                    if task is hedge_task:
                        self.hedge_wins += 1
                        winner_was_hedge = True
            if winner is not None:
                for task in pending:
                    task.cancel()
                if pending:
                    await asyncio.gather(*pending, return_exceptions=True)
                return winner, winner_was_hedge
        return None, False

    @staticmethod
    def _build_request(method: str, path: str, body: bytes, rid: str,
                       deadline_ms: Optional[float] = None) -> bytes:
        deadline_hdr = ("" if deadline_ms is None
                        else f"X-Deadline-Ms: {deadline_ms:g}\r\n")
        return (
            f"{method} {path} HTTP/1.1\r\n"
            f"Host: backend\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"X-Request-Id: {rid}\r\n{deadline_hdr}"
            f"Connection: keep-alive\r\n\r\n").encode("ascii") + body

    async def _proxy(self, method: str, path: str, body: bytes,
                     request_id: Optional[str] = None,
                     deadline_ms: Optional[float] = None,
                     exclude: Optional[set] = None) -> bytes:
        rid = request_id or obs_trace.new_request_id()
        request = self._build_request(method, path, body, rid, deadline_ms)
        tried: set = set(exclude or ())
        with obs_trace.request_context(request_id=rid):
            for _attempt in range(2):
                backend = self._pick(tried)
                if backend is None:
                    break
                data, _hedge_won = await self._hedged_exchange(
                    backend, request, path, tried)
                if data is not None:
                    self.proxied += 1
                    return data
                self.retried += 1
        self.unavailable += 1
        return _encode_response(
            503, {"error": "no live backend replica", "requestId": rid},
            extra_headers=(("X-Request-Id", rid),))

    # -- entity-affinity membership ----------------------------------------
    def _backend_by_address(self, address: str) -> Optional[_Backend]:
        for b in self._backends:
            if b.address == address:
                return b
        return None

    @property
    def membership_epoch(self) -> Optional[MembershipEpoch]:
        """The committed epoch (None when affinity is disabled)."""
        return None if self._membership is None else self._membership.epoch

    def _live_addresses(self) -> List[str]:
        return sorted(b.address for b in self._backends
                      if b.state == "closed")

    def _membership_stale(self) -> bool:
        """Does the committed epoch disagree with the live replica set
        (or has the initial epoch never been announced)? Cheap enough to
        ask per request — the rebalance itself is lazy."""
        if self._membership is None:
            return False
        if not self._announced:
            return True
        live = tuple(self._live_addresses())
        return bool(live) and live != self._membership.epoch.replicas

    def _maybe_rebalance(self) -> None:
        """Kick a background rebalance when the live set drifted from
        the committed epoch. Fire-and-forget from the request path: the
        current request routes on the committed epoch (the failover
        ladder covers its dead owner), the NEXT requests get the new
        one. The task set keeps strong references (a GC'd task would
        silently drop the rebalance)."""
        if not self._membership_stale() or self._rebalance_lock.locked():
            return
        task = asyncio.get_running_loop().create_task(self._rebalance())
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    async def sync_membership(self) -> dict:
        """Run one rebalance to completion — propose over the live set,
        broadcast + prefetch, commit — and report it. The await-able
        form of :meth:`_maybe_rebalance` for drivers, benches, and
        tests that need 'the epoch is committed' as a postcondition."""
        if self._membership is None:
            return {"committed": False, "reason": "affinity disabled"}
        return await self._rebalance()

    async def _rebalance(self) -> dict:
        """One membership transition, serialized by the rebalance lock:
        propose a successor epoch over the live replicas, push it (plus
        each new owner's moved hot ids to prefetch) to EVERY member,
        and only then commit — so by the time requests route on the new
        map, the handed-over pages are already warm. Failures are
        counted (``membership_faults``), never raised: the committed
        epoch keeps routing and a later request retries the
        transition."""
        if self._membership is None:
            return {"committed": False, "reason": "affinity disabled"}
        async with self._rebalance_lock:
            try:
                await fault_injection.async_check("fd.membership")
                live = self._live_addresses()
                if not live:
                    return {"committed": False,
                            "reason": "no live replicas"}
                new = self._membership.propose(live)
                if new is None and self._announced:
                    return {"committed": False, "reason": "unchanged",
                            "epoch": self._membership.epoch.epoch}
                # first rebalance: the constructor epoch exists but the
                # replicas have never heard it — announce before routing
                target = new if new is not None else self._membership.epoch
                moved = (self._membership.moved_ids(target)
                         if new is not None else {})
                with obs_trace.span("fd.rebalance", cat="serve",
                                    epoch=target.epoch,
                                    replicas=target.num_shards,
                                    moved=sum(len(v)
                                              for v in moved.values())):
                    ok = await self._broadcast_epoch(target, moved)
                if new is None:
                    self._announced = ok
                    return {"committed": ok, "epoch": target.epoch,
                            "replicas": list(target.replicas)}
                if not ok:
                    self.membership_faults += 1
                    return {"committed": False,
                            "reason": "broadcast failed",
                            "epoch": target.epoch}
                if self._membership.commit(new):
                    self.epoch_commits += 1
                self._announced = True
                return {"committed": True, "epoch": new.epoch,
                        "replicas": list(new.replicas)}
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.membership_faults += 1
                return {"committed": False, "error": str(e)}

    async def _broadcast_epoch(self, epoch: MembershipEpoch,
                               moved: Dict[int, List[str]]) -> bool:
        """Push ``epoch`` (and each member's moved-id prefetch list) to
        every replica in it. True only when EVERY member replied 200 —
        the commit gate."""
        ok = True
        for i, addr in enumerate(epoch.replicas):
            backend = self._backend_by_address(addr)
            if backend is None:
                ok = False
                continue
            body = json.dumps(epoch.payload(i, moved.get(i))
                              ).encode("utf-8")
            request = self._build_request(
                "POST", "/admin/membership", body,
                obs_trace.new_request_id())
            try:
                data = await self._timed_exchange(backend, request,
                                                  "/admin/membership")
            except asyncio.CancelledError:
                raise
            except Exception:
                ok = False
                continue
            status, reply = self._parse_response(data)
            if status != 200:
                ok = False
                continue
            if isinstance(reply, dict):
                self.prefetch_entities_sent += int(
                    reply.get("prefetched", 0))
                self.prefetch_bytes_sent += int(
                    reply.get("prefetchBytes", 0))
        return ok

    async def add_backend(self, address: str) -> dict:
        """Join a replica (``POST /fd/admin/join``): register it and
        rebalance so it owns (and has prefetched) its slice before the
        epoch routes to it."""
        address = str(address)
        if self._backend_by_address(address) is None:
            h, _, p = address.rpartition(":")
            self._backends.append(
                _Backend(h or "127.0.0.1", int(p),
                         cooldown_s=self.retry_backend_s))
        if self._membership is None:
            return {"committed": False, "reason": "affinity disabled"}
        return await self._rebalance()

    async def remove_backend(self, address: str) -> dict:
        """Drain a replica out (``POST /fd/admin/leave``): deregister,
        close its pooled connections, re-own its slice across the
        survivors. The last backend cannot leave."""
        address = str(address)
        b = self._backend_by_address(address)
        if b is not None:
            if len(self._backends) <= 1:
                return {"committed": False,
                        "reason": "cannot remove the last backend"}
            self._backends.remove(b)
            self._close_pool(b)
        if self._membership is None:
            return {"committed": False, "reason": "affinity disabled"}
        return await self._rebalance()

    async def _handle_admin(self, path: str, body: bytes,
                            rid: str) -> bytes:
        """``POST /fd/admin/join`` / ``/fd/admin/leave`` with
        ``{"address": "host:port"}``: mutate the replica set and run
        the rebalance to completion before replying — a 200 here means
        the new epoch is committed (or reports why it is not)."""
        rid_hdr = (("X-Request-Id", rid),)
        try:
            payload = json.loads(body or b"null")
            address = str(payload["address"])
            if ":" not in address:
                raise ValueError(f"address must be host:port, "
                                 f"got {address!r}")
            int(address.rpartition(":")[2])
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as e:
            return _encode_response(
                400, {"error": f"bad admin payload: {e}",
                      "requestId": rid}, extra_headers=rid_hdr)
        if path.endswith("/join"):
            result = await self.add_backend(address)
        else:
            result = await self.remove_backend(address)
            if result.get("reason") == "cannot remove the last backend":
                return _encode_response(
                    409, {"error": result["reason"], "requestId": rid},
                    extra_headers=rid_hdr)
        return _encode_response(
            200, {"backends": [b.address for b in self._backends],
                  "rebalance": result, "requestId": rid},
            extra_headers=rid_hdr)

    # -- affinity routing --------------------------------------------------
    @staticmethod
    def _row_entity(row) -> Optional[str]:
        """The routing entity id of a score row: the value of its
        first ``entityIds`` column (sorted by column name, so routing
        is deterministic for multi-coordinate models); None routes the
        row with whatever owner group goes first."""
        ids = row.get("entityIds") if isinstance(row, dict) else None
        if not isinstance(ids, dict) or not ids:
            return None
        value = (next(iter(ids.values())) if len(ids) == 1
                 else ids[min(ids)])
        return None if value is None else str(value)

    def _owner_groups(self, payload: dict, epoch: MembershipEpoch
                      ) -> Optional[List[Tuple[str, List[int]]]]:
        """Group a batch's row indices by owning replica address under
        ``epoch``; None when no row carries an entity id (plain proxy
        is the right path). Rows without an entity ride with the
        lowest-indexed owner group — they score identically anywhere."""
        rows = payload.get("rows")
        if not isinstance(rows, list) or not rows:
            return None
        eids = [self._row_entity(r) for r in rows]
        with_id = [(i, e) for i, e in enumerate(eids) if e is not None]
        if not with_id:
            return None
        ids = [e for _i, e in with_id]
        owners = epoch.owner_of(ids)
        for e in ids:
            self._membership.note_routed(e)
        groups: Dict[int, List[int]] = {}
        for (i, _e), o in zip(with_id, owners):
            groups.setdefault(int(o), []).append(i)
        free = [i for i, e in enumerate(eids) if e is None]
        if free:
            first = min(groups)
            groups[first] = sorted(groups[first] + free)
        return [(epoch.replicas[o], idxs)
                for o, idxs in sorted(groups.items())]

    def _note_owner_miss(self, reason: str) -> None:
        self.owner_miss[reason] = self.owner_miss.get(reason, 0) + 1

    @staticmethod
    def _parse_response(data: bytes) -> Tuple[int, Optional[dict]]:
        head, _, payload = data.partition(b"\r\n\r\n")
        try:
            status = int(head.split(b" ", 2)[1])
        except (IndexError, ValueError):
            return 500, None
        try:
            body = json.loads(payload) if payload else None
        except (ValueError, json.JSONDecodeError):
            body = None
        return status, body if isinstance(body, dict) else None

    def _label_fallback(self, data: bytes) -> bytes:
        """Stamp ``"routing": "fallback"`` into a 200 JSON response
        served off the non-owner path — the contract's degraded-
        residency marker (clients alert on fidelity, not availability).
        Forwarded headers the status contract pins (X-Request-Id,
        Retry-After) survive the rewrite; non-200s and non-JSON bodies
        pass through untouched."""
        head, _, payload = data.partition(b"\r\n\r\n")
        if b" 200 " not in head.split(b"\r\n", 1)[0]:
            return data
        try:
            body = json.loads(payload)
        except (ValueError, json.JSONDecodeError):
            return data
        if not isinstance(body, dict):
            return data
        body["routing"] = "fallback"
        extra = []
        for line in head.split(b"\r\n")[1:]:
            k, _, v = line.partition(b":")
            if k.strip().lower() in (b"x-request-id", b"retry-after"):
                extra.append((k.decode("latin-1").strip(),
                              v.decode("latin-1").strip()))
        self.fallback_served += 1
        return _encode_response(200, body, extra_headers=tuple(extra))

    async def _owner_send(self, owner_addr: str, body: bytes, rid: str,
                          deadline_ms: Optional[float]
                          ) -> Tuple[bytes, bool]:
        """Send one owner group's rows down the failover ladder:
        owner's breaker closed → route to it (hedging may still
        duplicate onto a non-owner; if the duplicate wins the response
        is fallback-labeled and counted ``owner_miss{reason=hedge}``);
        owner open (``breaker``) / not a registered backend
        (``epoch_skew``) / failed mid-exchange → any live replica,
        fallback-labeled. Returns ``(response_bytes, fell_back)``."""
        backend = self._backend_by_address(owner_addr)
        reason: Optional[str] = None
        if backend is None:
            reason = "epoch_skew"
        elif backend.state != "closed":
            self._maybe_probe(backend, time.monotonic())
            reason = "breaker"
        else:
            request = self._build_request("POST", "/score", body, rid,
                                          deadline_ms)
            tried: set = set()
            data, hedge_won = await self._hedged_exchange(
                backend, request, "/score", tried)
            if data is not None:
                self.proxied += 1
                self.owner_routed += 1
                if hedge_won:
                    # the duplicate landed on a NON-owner: it served the
                    # foreign entities off its store/LRU path — correct
                    # scores, degraded residency, so label it
                    self._note_owner_miss("hedge")
                    return self._label_fallback(data), True
                return data, False
            reason = "breaker"
        self._note_owner_miss(reason)
        data = await self._proxy("POST", "/score", body, request_id=rid,
                                 deadline_ms=deadline_ms,
                                 exclude={owner_addr})
        return self._label_fallback(data), True

    async def _score_affinity(self, body: bytes, rid: str,
                              deadline_ms: Optional[float]) -> bytes:
        """The affinity ``/score`` path: group rows by owner under the
        committed epoch, route each group down the owner ladder,
        scatter/merge when the batch spans owners. Any routing failure
        (``fd.route``, malformed rows) degrades to the plain
        least-loaded proxy — a non-owner serves every entity correctly
        through its LRU path, so routing is never allowed to fail a
        request that a dumb proxy would have served."""
        self._maybe_rebalance()
        epoch = self._membership.epoch
        groups = None
        try:
            await fault_injection.async_check("fd.route")
            payload = json.loads(body or b"null")
            if isinstance(payload, dict):
                groups = self._owner_groups(payload, epoch)
        except asyncio.CancelledError:
            raise
        except Exception:
            self.route_faults += 1
            groups = None
        if not groups:
            return await self._proxy("POST", "/score", body,
                                     request_id=rid,
                                     deadline_ms=deadline_ms)
        if len(groups) == 1:
            # single-owner batch: forward the ORIGINAL bytes untouched
            data, _fell_back = await self._owner_send(
                groups[0][0], body, rid, deadline_ms)
            return data
        self.scattered += 1
        return await self._scatter_merge(groups, payload, rid,
                                         deadline_ms)

    async def _scatter_merge(self, groups: List[Tuple[str, List[int]]],
                             payload: dict, rid: str,
                             deadline_ms: Optional[float]) -> bytes:
        """Fan a mixed-owner batch out by owner group (concurrently)
        and reassemble the per-row results in request order: the row
        partition is disjoint and exhaustive, so scores/uids/
        scoreComponents merge by position; ``degraded`` is the worst
        level any group was served at; ``routing`` is ``fallback`` if
        ANY group missed its owner, else ``scatter``. A group answering
        non-200 fails the whole batch with THAT response — merging
        partial scores would silently misreport rows."""
        rows = payload["rows"]

        async def one(addr: str, idxs: List[int]) -> Tuple[bytes, bool]:
            sub = {k: v for k, v in payload.items() if k != "rows"}
            sub["rows"] = [rows[i] for i in idxs]
            return await self._owner_send(
                addr, json.dumps(sub).encode("utf-8"), rid, deadline_ms)

        results = await asyncio.gather(
            *(one(addr, idxs) for addr, idxs in groups))
        n = len(rows)
        scores = [0.0] * n
        uids: List[object] = [None] * n
        comps: Dict[str, List[float]] = {}
        degraded = 0
        have_uids = False
        any_fallback = any(fb for _d, fb in results)
        for (addr, idxs), (data, _fb) in zip(groups, results):
            status, resp = self._parse_response(data)
            if status != 200 or resp is None:
                return data
            if resp.get("routing") == "fallback":
                any_fallback = True
            degraded = max(degraded, int(resp.get("degraded", 0)))
            for pos, s in zip(idxs, resp.get("scores", ())):
                scores[pos] = float(s)
            got_uids = resp.get("uids")
            if got_uids is not None:
                have_uids = True
                for pos, u in zip(idxs, got_uids):
                    uids[pos] = u
            for cname, vals in (resp.get("scoreComponents") or {}).items():
                dst = comps.setdefault(cname, [0.0] * n)
                for pos, v in zip(idxs, vals):
                    dst[pos] = float(v)
        merged = {"scores": scores, "degraded": degraded,
                  "routing": "fallback" if any_fallback else "scatter"}
        if have_uids:
            merged["uids"] = uids
        if comps:
            merged["scoreComponents"] = comps
        return _encode_response(200, merged,
                                extra_headers=(("X-Request-Id", rid),))

    async def _fd_metrics(self) -> str:
        """Aggregate ``/metrics`` across replicas: each backend's samples
        re-emitted with an injected ``replica="host:port"`` label
        (``# TYPE`` lines deduplicated across replicas), followed by the
        front door's own ``photon_fd_*`` counters. A backend that fails
        the scrape is cooled down exactly like a failed proxy exchange
        and simply omitted from this scrape."""
        scrape = (b"GET /metrics HTTP/1.1\r\nHost: backend\r\n"
                  b"Content-Length: 0\r\nConnection: keep-alive\r\n\r\n")
        out: List[str] = []
        seen_meta: set = set()
        now = time.monotonic()
        for b in self._backends:
            self._maybe_probe(b, now)
            if b.state != "closed":
                continue
            try:
                data = await self._backend_exchange(b, scrape)
            except Exception:
                b.record_failure(self.breaker_threshold, time.monotonic())
                continue
            head, _, payload = data.partition(b"\r\n\r\n")
            if b" 200 " not in head.split(b"\r\n", 1)[0]:
                continue
            replica = escape_label_value(b.address)
            for line in payload.decode("utf-8", "replace").splitlines():
                if not line:
                    continue
                if line.startswith("#"):
                    if line not in seen_meta:
                        seen_meta.add(line)
                        out.append(line)
                    continue
                series, _, value = line.rpartition(" ")
                if "{" in series:
                    name, _, rest = series.partition("{")
                    series = f'{name}{{replica="{replica}",{rest}'
                else:
                    series = f'{series}{{replica="{replica}"}}'
                out.append(f"{series} {value}")
        out.append("# TYPE photon_fd_proxied_total counter")
        out.append(f"photon_fd_proxied_total {self.proxied}")
        out.append("# TYPE photon_fd_retried_total counter")
        out.append(f"photon_fd_retried_total {self.retried}")
        out.append("# TYPE photon_fd_unavailable_total counter")
        out.append(f"photon_fd_unavailable_total {self.unavailable}")
        out.append("# TYPE photon_fd_backend_picked_total counter")
        for b in self._backends:
            out.append(f'photon_fd_backend_picked_total'
                       f'{{backend="{escape_label_value(b.address)}"}} '
                       f'{b.picked}')
        out.append("# TYPE photon_fd_backend_cooldowns_total counter")
        for b in self._backends:
            out.append(f'photon_fd_backend_cooldowns_total'
                       f'{{backend="{escape_label_value(b.address)}"}} '
                       f'{b.cooldowns}')
        out.append("# TYPE photon_fd_backend_state gauge")
        for b in self._backends:
            # 0 = closed (serving), 1 = half_open (probing), 2 = open
            out.append(f'photon_fd_backend_state'
                       f'{{backend="{escape_label_value(b.address)}"}} '
                       f'{_BACKEND_STATE_NUM[b.state]}')
        out.append("# TYPE photon_fd_readmitted_total counter")
        out.append(f"photon_fd_readmitted_total {self.readmitted}")
        out.append("# TYPE photon_fd_hedged_total counter")
        out.append(f"photon_fd_hedged_total {self.hedged}")
        out.append("# TYPE photon_fd_hedge_wins_total counter")
        out.append(f"photon_fd_hedge_wins_total {self.hedge_wins}")
        out.append("# TYPE photon_fd_deadline_rejects_total counter")
        out.append(f"photon_fd_deadline_rejects_total {self.deadline_rejects}")
        out.append("# TYPE photon_fd_warming_holds_total counter")
        out.append(f"photon_fd_warming_holds_total {self.warming_holds}")
        if self._membership is not None:
            epoch = self._membership.epoch
            out.append("# TYPE photon_fd_membership_epoch gauge")
            out.append(f"photon_fd_membership_epoch {epoch.epoch}")
            out.append("# TYPE photon_fd_membership_replicas gauge")
            out.append(f"photon_fd_membership_replicas {epoch.num_shards}")
            out.append("# TYPE photon_fd_owner_routed_total counter")
            out.append(f"photon_fd_owner_routed_total {self.owner_routed}")
            out.append("# TYPE photon_fd_scattered_total counter")
            out.append(f"photon_fd_scattered_total {self.scattered}")
            out.append("# TYPE photon_fd_fallback_served_total counter")
            out.append(f"photon_fd_fallback_served_total "
                       f"{self.fallback_served}")
            out.append("# TYPE photon_fd_owner_miss_total counter")
            for reason in sorted(self.owner_miss):
                out.append(
                    f'photon_fd_owner_miss_total'
                    f'{{reason="{escape_label_value(reason)}"}} '
                    f'{self.owner_miss[reason]}')
            out.append("# TYPE photon_fd_epoch_commits_total counter")
            out.append(f"photon_fd_epoch_commits_total "
                       f"{self.epoch_commits}")
            out.append("# TYPE photon_fd_membership_faults_total counter")
            out.append(f"photon_fd_membership_faults_total "
                       f"{self.membership_faults}")
            out.append("# TYPE photon_fd_route_faults_total counter")
            out.append(f"photon_fd_route_faults_total {self.route_faults}")
            out.append("# TYPE photon_fd_prefetch_entities_total counter")
            out.append(f"photon_fd_prefetch_entities_total "
                       f"{self.prefetch_entities_sent}")
            out.append("# TYPE photon_fd_prefetch_bytes_total counter")
            out.append(f"photon_fd_prefetch_bytes_total "
                       f"{self.prefetch_bytes_sent}")
        return "\n".join(out) + "\n"

    def stats(self) -> Dict[str, object]:
        out = {
            "policy": self.policy,
            "backends": [
                {"address": b.address, "inflight": b.inflight,
                 "state": b.state, "down": b.state != "closed",
                 "picked": b.picked, "cooldowns": b.cooldowns,
                 "opened": b.opened}
                for b in self._backends
            ],
            "proxied": self.proxied,
            "retried": self.retried,
            "unavailable": self.unavailable,
            "readmitted": self.readmitted,
            "hedged": self.hedged,
            "hedgeWins": self.hedge_wins,
            "deadlineRejects": self.deadline_rejects,
            "warmingHolds": self.warming_holds,
        }
        if self._membership is not None:
            epoch = self._membership.epoch
            out["affinity"] = {
                "epoch": epoch.epoch,
                "replicas": list(epoch.replicas),
                "idKind": epoch.id_kind,
                "announced": self._announced,
                "ownerRouted": self.owner_routed,
                "scattered": self.scattered,
                "fallbackServed": self.fallback_served,
                "ownerMiss": dict(self.owner_miss),
                "epochCommits": self.epoch_commits,
                "membershipFaults": self.membership_faults,
                "routeFaults": self.route_faults,
                "prefetchedEntities": self.prefetch_entities_sent,
                "prefetchedBytes": self.prefetch_bytes_sent,
            }
        return out
