"""Stdlib-only JSON scoring endpoint over the resident session
(counterpart of ``photon_ml_tpu/serve/server.py``; host only).

Two layers, deliberately separated:

* :class:`ScoringService` — transport-agnostic request handling: parse /
  validate a payload dict, run it through the micro-batcher, shape the
  response and status code. The tier-1 tests exercise THIS layer
  in-process (no sockets, no ports, no flakes).
* :class:`ScoringServer` — a ``http.server.ThreadingHTTPServer`` wrapper
  exposing ``POST /score``, ``POST /admin/reload``,
  ``POST /admin/membership``, ``GET /healthz``, and ``GET /metrics``
  (Prometheus text). One real-HTTP smoke test covers the wire.

Status-code contract (the load-shedding contract callers program
against):

  200 scored; 400 malformed request; 404 unknown path;
  429 shed — admission queue full OR deadline budget expired, retry
      with backoff (explicit backpressure instead of unbounded
      queueing latency);
  503 scoring failed; 504 batch watchdog expired (stuck execution).

Deadline propagation: an ``X-Deadline-Ms`` request header (or the
service's ``default_deadline_ms``) becomes the request's remaining
budget — checked at admission, in-queue, and pre-compute by the batcher
(``photon_serve_deadline_drop_total{stage}``) and spent deliberately by
the session's degradation ladder. Every ``/score`` response carries
``"degraded"``: 0 full fidelity, 1 resident-coefficients-only, 2
fixed-effect-only margin.

``/admin/reload`` drives the zero-downtime hot swap: an empty body
follows the registry's ``LATEST``; ``{"version": "vNNNNNN"}`` pins a
version (rollback = reload an older one); ``{"modelDir": path}`` swaps to
a bare model directory (``"force": true`` swaps even to the directory
already served). Replies 200 with the active version (``"swapped":
false`` when already there), 400 when neither a model directory nor a
registry is given, 404 for an unknown version, 409 when the registry has
no live version, and 503 when the swap itself failed (the previous model
keeps serving — a failed swap never tears down the live state).

``/metrics`` adds four series to the serving metrics:
``photon_serve_kernel_launches_total{kernel="paged_gather_score"}``, the
hand kernel's launches in this process (a CUDA-graph replay counts each
kernel it runs), which takes the place of the JAX service's XLA
executable counts as the proof that requests ran on the card; and the
session's counts of work that left the batch rungs:
``photon_serve_fixed_eager_batches_total`` (rows wider than the pad
width), ``photon_serve_fused_fallback_batches_total`` (batches the fused
rung could not take) and ``photon_serve_overflow_rows_total`` (rows whose
entities the table could not hold, scored by host math).

``/admin/membership`` applies an entity-affinity epoch: the front door
tells this
replica which slice of the entity universe it owns — ``{"epoch": N,
"replicas": [...], "selfIndex": i, "idKind": "auto",
"prefetchEntityIds"?: [...]}``. The session drops non-owned paged rows,
prefetches the handed-over ids SYNCHRONOUSLY (so the 200 reply means
"the pages are warm" — the front door commits the epoch only after
every member replied), and reports ``applied: false`` for stale epochs
(a replayed broadcast, never an error)."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from photon_ml_tpu_torch.obs import trace as obs_trace
from photon_ml_tpu_torch.serve.batcher import (
    BatchWatchdogTimeout,
    MicroBatcher,
    QueueFullError,
)
from photon_ml_tpu_torch.serve.metrics import ServingMetrics
from photon_ml_tpu_torch.serve.session import ScoringSession

__all__ = ["ScoringService", "ScoringServer"]

# the session's counters of batches and rows that left the fused rung,
# each exported by /metrics as photon_serve_<name>_total
_SESSION_COUNTERS = ("fixed_eager_batches", "fused_fallback_batches",
                     "overflow_rows")


class ScoringService:
    """Session + batcher + metrics behind a payload-in/payload-out API."""

    def __init__(self, session: ScoringSession,
                 batcher: Optional[MicroBatcher] = None,
                 request_timeout_s: float = 30.0,
                 registry=None,
                 default_deadline_ms: Optional[float] = None,
                 brownout=None):
        self.session = session
        self.metrics: ServingMetrics = session.metrics
        self.batcher = batcher or MicroBatcher(
            session.score_rows, max_batch=session.max_batch,
            metrics=self.metrics, brownout=brownout)
        self.request_timeout_s = float(request_timeout_s)
        # budget applied to requests that carry no X-Deadline-Ms header
        self.default_deadline_ms = (
            None if default_deadline_ms is None
            else float(default_deadline_ms))
        self.brownout = brownout if brownout is not None else getattr(
            self.batcher, "brownout", None)
        self.registry = registry  # optional registry.ModelRegistry
        self._reload_lock = threading.Lock()

    # -- endpoints ---------------------------------------------------------
    @staticmethod
    def validate_score_payload(payload):
        """``(rows, per_coordinate) | None, error_body | None`` — the
        parse/validate half of ``/score``, shared by the sync handler
        and the asyncio front end (which must not block the event loop
        on the scoring half)."""
        if not isinstance(payload, dict) or not isinstance(
                payload.get("rows"), list):
            return None, {"error": "payload must be "
                                   '{"rows": [...], "perCoordinate"?: '
                                   'bool}'}
        rows = payload["rows"]
        if not rows:
            return None, {"error": "empty rows"}
        if not all(isinstance(r, dict) for r in rows):
            return None, {"error": "every row must be an object"}
        return (rows, bool(payload.get("perCoordinate"))), None

    @staticmethod
    def score_error_response(e: BaseException,
                             request_id: Optional[str] = None
                             ) -> Tuple[int, dict]:
        """Map a scoring-path exception onto the status contract — ONE
        definition for the threaded and asyncio transports. Shed/error
        bodies carry the request id so a client's 429/503 is greppable
        against the server's slow-request and error logs."""
        if isinstance(e, QueueFullError):
            body = {"error": str(e), "shed": True, "cause": e.cause,
                    "retryAfterS": round(e.retry_after_s, 3)}
            status = 429
        elif isinstance(e, ValueError):
            status, body = 400, {"error": str(e)}
        elif isinstance(e, (BatchWatchdogTimeout, TimeoutError)):
            status, body = 504, {"error": str(e)}
        else:
            status, body = 503, {"error": f"scoring failed: {e}"}
        if request_id:
            body["requestId"] = request_id
        return status, body

    @staticmethod
    def score_body(rows, per_coord: bool, result, degraded: int = 0
                   ) -> dict:
        """Shape a resolved batcher result into the response body.
        ``degraded`` is the ladder level the batch was actually served
        at — always present so clients can alert on fidelity, not just
        availability."""
        if per_coord:
            scores, parts = result
        else:
            scores, parts = result, {}
        body = {"scores": [float(s) for s in scores],
                "degraded": int(degraded)}
        uids = [r.get("uid") for r in rows]
        if any(u is not None for u in uids):
            body["uids"] = uids
        if per_coord:
            body["scoreComponents"] = {
                k: [float(x) for x in v] for k, v in parts.items()}
        return body

    @staticmethod
    def parse_deadline_ms(raw) -> Optional[float]:
        """Parse an ``X-Deadline-Ms`` header value. None/blank means no
        per-request deadline; a malformed value raises ValueError (the
        transports turn that into a 400 — a client that SENT a budget
        but garbled it must not silently run unbounded)."""
        if raw is None:
            return None
        raw = str(raw).strip()
        if not raw:
            return None
        try:
            return float(raw)
        except ValueError:
            raise ValueError(
                f"bad X-Deadline-Ms value {raw!r}: must be a number "
                "of milliseconds") from None

    def deadline_s(self, deadline_ms: Optional[float]) -> Optional[float]:
        """The effective budget in seconds: the request's own header
        wins; otherwise the service default; otherwise None."""
        ms = (deadline_ms if deadline_ms is not None
              else self.default_deadline_ms)
        return None if ms is None else ms / 1e3

    def handle_score(self, payload, request_id: Optional[str] = None,
                     deadline_ms: Optional[float] = None
                     ) -> Tuple[int, dict]:
        """``{"rows": [...], "perCoordinate": bool}`` -> scores. Each row
        as ``ScoringSession.score_rows`` documents (features /
        entityIds / offset, plus an optional echoed ``uid``).
        ``request_id`` rides the pending request through the batcher and
        appears in shed/error bodies; ``deadline_ms`` is the propagated
        remaining budget (``X-Deadline-Ms``)."""
        valid, err = self.validate_score_payload(payload)
        if valid is None:
            if request_id:
                err = dict(err, requestId=request_id)
            return 400, err
        rows, per_coord = valid
        try:
            pending = self.batcher.submit(
                rows, per_coord, request_id=request_id,
                deadline_s=self.deadline_s(deadline_ms))
            result = pending.result(self.request_timeout_s)
        except Exception as e:
            return self.score_error_response(e, request_id=request_id)
        return 200, self.score_body(rows, per_coord, result,
                                    degraded=pending.degraded)

    def handle_healthz(self) -> Tuple[int, dict]:
        """Liveness + readiness in one: HTTP 200 whenever the process
        can serve, but ``status`` distinguishes ``ok`` from ``warming``
        (background page installs still draining after a swap) — the
        front door's half-open probe readmits only on ``ok``."""
        warming = bool(getattr(self.session, "warming", False))
        body = {
            "status": "warming" if warming else "ok",
            "model_dir": self.session.model_dir,
            "active_version": self.session.active_version,
            "task": self.session.task,
            "queue_depth": self.batcher.queue_depth,
            "max_batch": self.batcher.max_batch,
        }
        if self.brownout is not None:
            body["brownout_level"] = self.brownout.level
        # duck-typed test sessions may not carry a membership view
        membership = getattr(self.session, "membership", None)
        if membership is not None and membership.epoch > 0:
            body["membership"] = membership.describe()
        return 200, body

    def handle_reload(self, payload) -> Tuple[int, dict]:
        """Hot-swap the session (``POST /admin/reload``). Serialized by
        a lock — two concurrent reloads would race the session's
        prev-state rollback slot; requests keep flowing either way."""
        payload = payload if isinstance(payload, dict) else {}
        model_dir = payload.get("modelDir")
        version = payload.get("version")
        with self._reload_lock:
            if model_dir:
                source, version = model_dir, str(model_dir)
            elif self.registry is not None:
                try:
                    version = version or self.registry.read_latest()
                except Exception as e:
                    return 503, {"error": f"registry unreadable: {e}"}
                if version is None:
                    return 409, {"error": "registry has no live version "
                                          "(nothing promoted yet)"}
                try:
                    source = self.registry.open_version(version)
                except Exception as e:
                    return 404, {"error": f"unknown version "
                                          f"{version!r}: {e}"}
            else:
                return 400, {"error": "no registry configured; pass "
                                      '{"modelDir": ...}'}
            if (version == self.session.active_version
                    and not payload.get("force")):
                return 200, {"activeVersion": self.session.active_version,
                             "swapped": False}
            try:
                active = self.session.swap(source, version=version)
            except Exception as e:
                # the old state keeps serving; surface the failure
                return 503, {"error": f"swap failed: {e}",
                             "activeVersion": self.session.active_version}
        return 200, {"activeVersion": active, "swapped": True}

    def handle_membership(self, payload) -> Tuple[int, dict]:
        """Apply a membership epoch (``POST /admin/membership``). The
        reply is sent only after the owned-slice eviction AND the moved-
        id prefetch completed — the front door's prefetch-before-commit
        contract hangs on this reply meaning "done", not "queued"."""
        if not isinstance(payload, dict):
            return 400, {"error": "membership payload must be an object"}
        try:
            epoch = int(payload["epoch"])
            if "replicas" in payload:
                replicas = [str(r) for r in payload["replicas"]]
                num_shards = len(replicas)
                shard_index = int(payload["selfIndex"])
            else:
                num_shards = int(payload["numShards"])
                shard_index = int(payload["shardIndex"])
            id_kind = str(payload.get("idKind", "auto"))
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": f"bad membership payload: {e}"}
        try:
            applied = self.session.set_membership(
                epoch=epoch, num_shards=num_shards,
                shard_index=shard_index, id_kind=id_kind)
        except ValueError as e:
            return 400, {"error": str(e)}
        body = {"applied": bool(applied),
                "membership": self.session.membership.describe()}
        if applied and payload.get("prefetchEntityIds"):
            n, nbytes = self.session.prefetch_entities(
                payload["prefetchEntityIds"])
            body["prefetched"] = n
            body["prefetchBytes"] = nbytes
        return 200, body

    def handle_metrics(self) -> Tuple[int, str]:
        from photon_ml_tpu_torch.ops.kernels import paged_gather_score

        out = [self.metrics.render(),
               "# TYPE photon_serve_kernel_launches_total counter\n",
               'photon_serve_kernel_launches_total{kernel='
               f'"paged_gather_score"}} {paged_gather_score.launches}\n']
        for name in _SESSION_COUNTERS:
            out.append(f"# TYPE photon_serve_{name}_total counter\n"
                       f"photon_serve_{name}_total "
                       f"{getattr(self.session, name, 0)}\n")
        return 200, "".join(out)

    def close(self, drain_timeout_s: float = 5.0) -> None:
        self.batcher.close(drain_timeout_s)
        # duck-typed test sessions may not carry the installer thread
        close = getattr(self.session, "close", None)
        if close is not None:
            close()


class _Handler(BaseHTTPRequestHandler):
    service: ScoringService  # injected by ScoringServer via subclassing
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet; metrics carry the signal
        pass

    def _reply(self, status: int, body, content_type="application/json",
               request_id=None):
        retry_after = (body.get("retryAfterS")
                       if status == 429 and isinstance(body, dict) else None)
        data = (body if isinstance(body, (bytes, str))
                else json.dumps(body))
        if isinstance(data, str):
            data = data.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        if request_id is not None:
            self.send_header("X-Request-Id", request_id)
        if retry_after is not None:
            # ceil to whole seconds: Retry-After is integral per RFC 9110
            self.send_header("Retry-After",
                             str(max(1, int(-(-float(retry_after) // 1)))))
        self.end_headers()
        self.wfile.write(data)

    def _request_id(self) -> str:
        """Honor a client-supplied X-Request-Id (trimmed, bounded);
        assign one otherwise — every response echoes it."""
        rid = (self.headers.get("X-Request-Id") or "").strip()
        return rid[:128] if rid else obs_trace.new_request_id()

    def do_GET(self):
        rid = self._request_id()
        if self.path == "/healthz":
            status, body = self.service.handle_healthz()
            self._reply(status, body, request_id=rid)
        elif self.path == "/metrics":
            status, text = self.service.handle_metrics()
            self._reply(status, text,
                        content_type="text/plain; version=0.0.4",
                        request_id=rid)
        else:
            self._reply(404, {"error": f"unknown path {self.path}"},
                        request_id=rid)

    def do_POST(self):
        rid = self._request_id()
        if self.path not in ("/score", "/admin/reload",
                             "/admin/membership"):
            self._reply(404, {"error": f"unknown path {self.path}"},
                        request_id=rid)
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length) or b"null")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad JSON: {e}",
                              "requestId": rid}, request_id=rid)
            return
        try:
            deadline_ms = self.service.parse_deadline_ms(
                self.headers.get("X-Deadline-Ms"))
        except ValueError as e:
            self._reply(400, {"error": str(e), "requestId": rid},
                        request_id=rid)
            return
        with obs_trace.request_context(request_id=rid):
            if self.path == "/admin/reload":
                status, body = self.service.handle_reload(payload)
            elif self.path == "/admin/membership":
                status, body = self.service.handle_membership(payload)
            else:
                status, body = self.service.handle_score(
                    payload, request_id=rid, deadline_ms=deadline_ms)
        self._reply(status, body, request_id=rid)


class ScoringServer:
    """Threaded HTTP server over a :class:`ScoringService`. ``port=0``
    binds an ephemeral port (tests); ``start()`` serves on a daemon
    thread, ``close()`` shuts the listener and drains the batcher."""

    def __init__(self, service: ScoringService, host: str = "127.0.0.1",
                 port: int = 0):
        self.service = service
        handler = type("BoundHandler", (_Handler,), {"service": service})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None
        self._serving = False

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "ScoringServer":
        self._serving = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="photon-serve-http")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Foreground serve (the CLI driver's main loop)."""
        self._serving = True
        self._httpd.serve_forever()

    def close(self, drain_timeout_s: float = 5.0) -> None:
        # shutdown() handshakes with a RUNNING serve_forever loop and
        # blocks forever without one — only call it when a loop started
        if self._serving:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
        self.service.close(drain_timeout_s)
