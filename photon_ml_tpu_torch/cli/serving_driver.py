"""Online scoring driver: serve a saved GAME model over HTTP (counterpart of
``photon_ml_tpu/cli/serving_driver.py``).

The fourth driver next to train/score/index: load a model ONCE, keep it
resident on ``--device`` (``serve/session.py``: one CUDA graph per rung of
the padded batch ladder, the paged coefficient table and the entity LRU),
and answer JSON scoring requests through the micro-batcher on a threaded
HTTP server (``serve/server.py``):

    python -m photon_ml_tpu_torch.cli.serving_driver --model-dir out/best \\
        --port 8471 --max-batch 64 --max-delay-ms 5

``--device`` defaults to ``cuda``, which raises without a GPU; ``--device
cpu`` serves from the CPU. The JAX driver's front end defaults to its
asyncio server; that server, the front door with its replicas and the
model registry are ROADMAP Queue 1 item 19, so ``--server`` defaults to
``thread`` here until that item restores ``async``. Their flags
(``--registry``, ``--model-version``, ``--replicas`` > 1,
``--front-door-policy``, ``--hedge*``, ``--affinity*``, ``--server
async``) are accepted by the parser and raise, naming the item.

Once the model is loaded and every rung captured, the driver prints one
line, ``serving <version> on http://<host>:<port> (...)``; ``--port 0``
binds an ephemeral port and that line names it.

Shutdown contract: SIGTERM/SIGINT stop the listener (no new requests),
DRAIN the micro-batcher (in-flight and queued batches finish and their
responses go out), then exit 0 — a rolling restart never kills requests
mid-batch.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading
from typing import Sequence

from photon_ml_tpu_torch.cli._common import check_deferred, positive_int
from photon_ml_tpu_torch.utils import PhotonLogger, Timed

# flags of the JAX driver whose code paths are not ported yet, by the
# ROADMAP Queue 1 item that ports them; each raises when set to anything
# but its default
_DEFERRED = {
    "registry": "19 (serving and lifecycle: the model registry)",
    "model_version": "19 (serving and lifecycle: the model registry)",
    "replicas": "19 (serving and lifecycle: the front door and replicas)",
    "front_door_policy": "19 (serving and lifecycle: the front door)",
    "hedge": "19 (serving and lifecycle: the front door)",
    "hedge_min_ms": "19 (serving and lifecycle: the front door)",
    "affinity": "19 (serving and lifecycle: the front door)",
    "affinity_id_kind": "19 (serving and lifecycle: the front door)",
    "server": "19 (serving and lifecycle: the asyncio server)",
}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="GAME online scoring server (PyTorch port)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model-dir",
                     help="serve one fixed saved-model directory")
    src.add_argument("--registry",
                     help="model-registry root (not ported yet: ROADMAP "
                          "item 19)")
    p.add_argument("--model-version", default=None,
                   help="with --registry: pin a version (not ported yet: "
                        "ROADMAP item 19)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8471,
                   help="0 binds an ephemeral port (printed at startup)")
    p.add_argument("--max-batch", type=positive_int, default=64,
                   help="rows per scoring execution; also the top of the "
                        "captured shape ladder")
    p.add_argument("--max-delay-ms", type=float, default=5.0,
                   help="longest a request waits for batch companions")
    p.add_argument("--max-queue", type=positive_int, default=256,
                   help="admission-queue bound; beyond it requests are "
                        "shed with HTTP 429")
    p.add_argument("--pad-nnz", type=positive_int, default=64,
                   help="padded nonzeros per row in the captured shapes")
    p.add_argument("--coeff-cache-entries", type=positive_int, default=4096,
                   help="resident entities per random effect (LRU)")
    p.add_argument("--server", choices=["async", "thread"], default="thread",
                   help="front end: the thread-per-request http.server "
                        "stack (default here; the JAX driver's default, "
                        "the asyncio server, is ROADMAP item 19, which "
                        "makes it the default again)")
    p.add_argument("--replicas", type=positive_int, default=1,
                   help="N > 1 spawns N serving processes behind a front "
                        "door (not ported yet: ROADMAP item 19)")
    p.add_argument("--front-door-policy", default="least_loaded",
                   choices=["least_loaded", "round_robin"],
                   help="replica selection at the front door (ROADMAP "
                        "item 19)")
    p.add_argument("--no-paged-table", action="store_true",
                   help="disable the paged coefficient table on the "
                        "device (host-LRU scoring path only)")
    p.add_argument("--re-pages", type=positive_int, default=4,
                   help="paged-table pages per random effect")
    p.add_argument("--re-page-rows", type=positive_int, default=256,
                   help="entities per paged-table page")
    p.add_argument("--re-dense-dim-max", type=positive_int, default=4096,
                   help="widest random-effect feature space to densify "
                        "into pages; wider coordinates use the LRU path")
    p.add_argument("--queue-deadline-s", type=float, default=0.0,
                   help="> 0 sheds requests still queued after this long "
                        "(429 cause=deadline) instead of scoring them")
    p.add_argument("--default-deadline-ms", type=float, default=0.0,
                   help="> 0 gives requests WITHOUT an X-Deadline-Ms "
                        "header this budget; expired requests drop at "
                        "the cheapest stage (429 cause=deadline)")
    p.add_argument("--brownout", action="store_true",
                   help="enable the brownout controller: sustained "
                        "queue-wait overload raises the default "
                        "degraded-scoring level (resident-only, then "
                        "fixed-effect-only) before any 429 shedding")
    p.add_argument("--brownout-l1-ms", type=float, default=50.0,
                   help="queue-wait EWMA (ms) at which brownout level 1 "
                        "(resident-coefficients-only) engages")
    p.add_argument("--brownout-l2-ms", type=float, default=200.0,
                   help="queue-wait EWMA (ms) at which brownout level 2 "
                        "(fixed-effect-only) engages")
    p.add_argument("--hedge", action="store_true",
                   help="front door request hedging (ROADMAP item 19)")
    p.add_argument("--hedge-min-ms", type=float, default=50.0,
                   help="floor on the hedge trigger delay (ROADMAP item "
                        "19)")
    p.add_argument("--affinity", action="store_true",
                   help="front door entity-affinity routing (ROADMAP "
                        "item 19)")
    p.add_argument("--affinity-id-kind", default="auto",
                   choices=["auto", "int", "str"],
                   help="entity-id hashing domain of the front door's "
                        "owner map (ROADMAP item 19)")
    p.add_argument("--watchdog-s", type=float, default=60.0,
                   help="stuck-batch watchdog; <= 0 disables")
    p.add_argument("--request-timeout-s", type=float, default=30.0)
    p.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="longest a SIGTERM/SIGINT shutdown waits for the "
                        "micro-batcher to flush in-flight batches")
    p.add_argument("--log-dir", default=None,
                   help="photon.log.jsonl location (default: the model "
                        "dir)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--device", default="cuda",
                   help="torch device the model is served from (default "
                        "cuda, which raises without a GPU)")
    p.add_argument("--trace-dir", default=None,
                   help="write photon-trace span files here (merge with "
                        "`python -m photon_ml_tpu_torch.obs.trace_cli "
                        "merge`). Also honors PHOTON_TRACE / "
                        "PHOTON_TRACE_SAMPLE")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="fraction of requests traced under --trace-dir")
    return p


def build_service(args):
    """Session + batcher + service from parsed args (the batcher and the
    brownout controller as the JAX driver builds them). Returns the
    service."""
    from photon_ml_tpu_torch.serve import (
        BrownoutController,
        MicroBatcher,
        ScoringService,
        ScoringSession,
    )

    session = ScoringSession(
        args.model_dir, dtype=args.dtype, max_batch=args.max_batch,
        pad_nnz=args.pad_nnz, coeff_cache_entries=args.coeff_cache_entries,
        paged_table=not args.no_paged_table, re_pages=args.re_pages,
        re_page_rows=args.re_page_rows,
        re_dense_dim_max=args.re_dense_dim_max, device=args.device)
    brownout = None
    if args.brownout:
        brownout = BrownoutController(
            enter_ms={1: args.brownout_l1_ms, 2: args.brownout_l2_ms},
            metrics=session.metrics)
    batcher = MicroBatcher(
        session.score_rows, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, max_queue=args.max_queue,
        watchdog_s=(None if args.watchdog_s <= 0 else args.watchdog_s),
        request_deadline_s=(args.queue_deadline_s
                            if args.queue_deadline_s > 0 else None),
        metrics=session.metrics, brownout=brownout)
    return ScoringService(
        session, batcher, request_timeout_s=args.request_timeout_s,
        default_deadline_ms=(args.default_deadline_ms
                             if args.default_deadline_ms > 0 else None),
        brownout=brownout)


def build_server(args):
    """The threaded server over :func:`build_service`."""
    from photon_ml_tpu_torch.serve import ScoringServer

    return ScoringServer(build_service(args), host=args.host,
                         port=args.port)


def install_signal_handlers(server, signals=(signal.SIGTERM, signal.SIGINT)):
    """Arm graceful drain: the first SIGTERM/SIGINT stops the HTTP
    accept loop FROM A HELPER THREAD (``shutdown()`` handshakes with the
    running ``serve_forever`` loop and would deadlock if called inside
    the signal handler on the same thread), letting ``main`` fall
    through to ``server.close()`` — which drains the micro-batcher —
    and return 0. A second signal is ignored (drain is already
    running); must be called from the main thread (CPython restriction
    on ``signal.signal``). Returns the handler's state dict
    (``state["signal"]`` is the signum that fired, for logging)."""
    state = {"signal": None, "thread": None}

    def handler(signum, frame):
        if state["signal"] is not None:
            return
        state["signal"] = signum
        # the helper's bounded join lives in join_shutdown_helper (run
        # by main's finally): a signal handler joining its own helper
        # would stall the very drain it triggers
        t = threading.Thread(target=server._httpd.shutdown, daemon=True,
                             name="photon-serve-shutdown")
        state["thread"] = t
        t.start()

    for sig in signals:
        signal.signal(sig, handler)
    state["handler"] = handler
    return state


def join_shutdown_helper(state, timeout_s: float = 5.0,
                         logger=None) -> None:
    """Bounded join of the signal handler's shutdown helper thread (no
    thread leaks without a counter and a log line). By the time main's
    finally runs, ``serve_forever`` has returned, so the join is instant
    in the healthy case."""
    t = state.get("thread")
    if t is None:
        return
    t.join(timeout_s)
    if t.is_alive():
        state["join_timeouts"] = state.get("join_timeouts", 0) + 1
        if logger is not None:
            logger.log("shutdown_helper_join_timeout",
                       timeout_s=timeout_s,
                       join_timeouts=state["join_timeouts"])


def _announce(logger, session, host, port, compiled, transport):
    logger.log("serving_ready", host=host, port=port,
               active_version=session.active_version,
               precompiled_executables=compiled, transport=transport,
               device=str(session.device))
    paged = "paged" if session.paged_active else "host-LRU"
    print(f"serving {session.active_version} on http://{host}:{port} "
          f"({transport}, {paged} coefficients, {compiled} captured "
          f"rungs on {session.device}; POST /score, POST /admin/reload, "
          "POST /admin/membership, GET /healthz, GET /metrics)", flush=True)


def main(argv: Sequence[str] | None = None) -> int:
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    check_deferred(args, parser, _DEFERRED)
    from photon_ml_tpu_torch.obs import logging as obs_logging
    from photon_ml_tpu_torch.obs import trace as obs_trace
    from photon_ml_tpu_torch.types import resolve_device

    resolve_device(args.device)  # raises before any load without a GPU
    obs_logging.configure()
    if args.trace_dir:
        started = obs_trace.start(args.trace_dir, sample=args.trace_sample)
    else:
        started = obs_trace.maybe_start_from_env()
    try:
        return _serve(args)
    finally:
        if started is not None:  # only stop a tracer this call started
            obs_trace.stop()


def _serve(args) -> int:
    from photon_ml_tpu_torch.ops.kernels import paged_gather_score

    log_dir = args.log_dir or args.model_dir
    os.makedirs(log_dir, exist_ok=True)
    logger = PhotonLogger(os.path.join(log_dir, "photon.log.jsonl"))
    logger.log("driver_start", driver="serving", args=vars(args))
    with Timed(logger, "load_and_warmup"):
        server = build_server(args)
    session = server.service.session
    compiled = session.compile_count
    _announce(logger, session, server.host, server.port, compiled,
              "threaded")
    stop = install_signal_handlers(server)
    try:
        server.serve_forever()
    except KeyboardInterrupt:  # pre-handler window / non-main-thread use
        pass
    finally:
        if stop["signal"] is not None:
            logger.log("draining", signal=int(stop["signal"]),
                       queue_depth=server.service.batcher.queue_depth)
        server.close(drain_timeout_s=args.drain_timeout_s)
        join_shutdown_helper(stop, logger=logger)
        logger.log("driver_done", drained=True,
                   kernel_launches={
                       "paged_gather_score": paged_gather_score.launches},
                   **server.service.metrics.snapshot())
        logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
