"""Online scoring driver: serve a saved GAME model over HTTP (counterpart of
``photon_ml_tpu/cli/serving_driver.py``).

The fourth driver next to train/score/index: load a model ONCE, keep it
resident on ``--device`` (``serve/session.py``: one CUDA graph per rung of
the padded batch ladder, the paged coefficient table and the entity LRU),
and answer JSON scoring requests through the micro-batcher:

    python -m photon_ml_tpu_torch.cli.serving_driver --model-dir out/best \
        --port 8471 --max-batch 64 --max-delay-ms 5

    # registry mode: serve LATEST, follow promotions, hot-swap in place
    python -m photon_ml_tpu_torch.cli.serving_driver \
        --registry /models/registry --watch-interval-s 10

    # multi-replica: N serving processes behind an asyncio front door,
    # every replica watching the same registry for consistent hot swap
    python -m photon_ml_tpu_torch.cli.serving_driver \
        --registry /models/registry --replicas 4 --port 8471

``--device`` defaults to ``cuda``, which raises without a GPU; ``--device
cpu`` serves from the CPU. Replicas inherit ``--device``; the parent of a
multi-replica run only runs the front door and creates no CUDA context.
The front end defaults to the asyncio server (``--server async``,
``serve/aserver.py``); ``--server thread`` keeps the thread-per-request
``ThreadingHTTPServer`` stack.

Once the model is loaded and every rung captured, a serving process
prints one line, ``serving <version> on http://<host>:<port> (...)``; a
multi-replica parent prints ``front door on http://<host>:<port> -> ...``
once every replica answers ``/healthz``. ``--port 0`` binds an ephemeral
port and that line names it.

Shutdown contract: SIGTERM/SIGINT stop the listener (no new requests),
DRAIN the micro-batcher (in-flight and queued batches finish and their
responses go out), then exit 0 — a rolling restart never kills requests
mid-batch. In multi-replica mode the parent forwards the signal to
every replica and waits for their drains.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Sequence

from photon_ml_tpu_torch.cli._common import positive_int
from photon_ml_tpu_torch.utils import PhotonLogger, Timed

REPLICA_STARTUP_S = 180.0  # longest a replica may take to answer /healthz


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="GAME online scoring server (PyTorch port)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model-dir",
                     help="serve one fixed saved-model directory")
    src.add_argument("--registry",
                     help="model-registry root (registry/): serve the "
                          "LATEST version and hot-swap on promotion")
    p.add_argument("--model-version", default=None,
                   help="with --registry: pin a specific version instead "
                        "of LATEST (also disables the watcher)")
    p.add_argument("--watch-interval-s", type=float, default=10.0,
                   help="with --registry: poll LATEST this often and "
                        "hot-swap on change; <= 0 disables the watcher")
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
    p.add_argument("--server", choices=["async", "thread"], default="async",
                   help="front end: asyncio event loop (default) or the "
                        "thread-per-request http.server stack")
    p.add_argument("--replicas", type=positive_int, default=1,
                   help="N > 1 spawns N serving processes on successive "
                        "free ports behind an asyncio front door on --port")
    p.add_argument("--front-door-policy", default="least_loaded",
                   choices=["least_loaded", "round_robin"],
                   help="replica selection at the front door")
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
                   help="multi-replica front door: duplicate a request "
                        "onto a second replica when the first exceeds "
                        "its observed p99 (first answer wins)")
    p.add_argument("--hedge-min-ms", type=float, default=50.0,
                   help="floor on the hedge trigger delay")
    p.add_argument("--affinity", action="store_true",
                   help="multi-replica front door: route each row to "
                        "the replica OWNING its entity (stable-hash "
                        "membership epochs; join/leave/breaker churn "
                        "re-owns the moved slice with prefetch before "
                        "the epoch commits)")
    p.add_argument("--affinity-id-kind", default="auto",
                   choices=["auto", "int", "str"],
                   help="entity-id hashing domain for the owner map; "
                        "auto decides per id (digits hash as int64, "
                        "anything else as a string) to match the "
                        "training shard map")
    p.add_argument("--watchdog-s", type=float, default=60.0,
                   help="stuck-batch watchdog; <= 0 disables")
    p.add_argument("--request-timeout-s", type=float, default=30.0)
    p.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="longest a SIGTERM/SIGINT shutdown waits for the "
                        "micro-batcher to flush in-flight batches")
    p.add_argument("--log-dir", default=None,
                   help="photon.log.jsonl location (default: model dir "
                        "or registry root)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--device", default="cuda",
                   help="torch device the model is served from (default "
                        "cuda, which raises without a GPU; replicas "
                        "inherit it)")
    p.add_argument("--trace-dir", default=None,
                   help="write photon-trace span files here (replicas "
                        "get per-replica subdirectories; merge with "
                        "`python -m photon_ml_tpu_torch.obs.trace_cli "
                        "merge`). Also honors PHOTON_TRACE / "
                        "PHOTON_TRACE_SAMPLE")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="fraction of requests traced under --trace-dir")
    return p


def open_source(args):
    """The model the driver serves: ``--model-dir``, or the registry's
    pinned (``--model-version``) or live version. Returns (source,
    registry or None); raises ``RegistryError`` when the registry has no
    live version or not the pinned one. Reads files only."""
    if not args.registry:
        return args.model_dir, None
    from photon_ml_tpu_torch.registry import ModelRegistry, RegistryError

    registry = ModelRegistry(args.registry)
    version = args.model_version or registry.read_latest()
    if version is None:
        raise RegistryError(
            f"registry {args.registry} has no live version; publish and "
            "promote one (python -m photon_ml_tpu_torch.cli"
            ".model_publish_driver) or pass --model-version")
    return registry.open_version(version), registry


def build_service(args):
    """Session + batcher + service (+ registry) from parsed args (the
    batcher and the brownout controller as the JAX driver builds them).
    Returns the service; ``service.registry`` is the registry or None."""
    from photon_ml_tpu_torch.serve import (
        BrownoutController,
        MicroBatcher,
        ScoringService,
        ScoringSession,
    )

    source, registry = open_source(args)
    session = ScoringSession(
        source, dtype=args.dtype, max_batch=args.max_batch,
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
        registry=registry, default_deadline_ms=(args.default_deadline_ms
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


def _maybe_watcher(args, registry, session, logger):
    if (registry is None or args.watch_interval_s <= 0
            or args.model_version):
        return None
    from photon_ml_tpu_torch.serve import RegistryWatcher

    return RegistryWatcher(
        registry, session, interval_s=args.watch_interval_s,
        jitter_s=min(1.0, args.watch_interval_s / 10.0),
        on_swap=lambda v: logger.log("hot_swap", version=v,
                                     source="watcher"),
        on_error=lambda e: logger.log("watch_error", error=str(e)),
    ).start()


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


def _done(logger, service, **fields):
    from photon_ml_tpu_torch.ops.kernels import paged_gather_score

    logger.log("driver_done", drained=True,
               kernel_launches={
                   "paged_gather_score": paged_gather_score.launches},
               **fields, **service.metrics.snapshot())
    logger.close()


def _run_async(args, logger) -> int:
    from photon_ml_tpu_torch.serve import AsyncScoringServer

    with Timed(logger, "load_and_warmup"):
        service = build_service(args)
    session = service.session
    compiled = session.compile_count
    watcher = _maybe_watcher(args, service.registry, session, logger)
    server = AsyncScoringServer(service, host=args.host, port=args.port)
    try:
        server.run_forever(
            drain_timeout_s=args.drain_timeout_s,
            ready_callback=lambda srv: _announce(
                logger, session, srv.host, srv.port, compiled, "asyncio"),
            stop_callback=lambda signum: logger.log(
                "draining", signal=int(signum),
                queue_depth=service.batcher.queue_depth))
    except KeyboardInterrupt:
        pass
    finally:
        if watcher is not None:
            watcher.stop()
        _done(logger, service,
              watcher_join_timeouts=getattr(watcher, "join_timeouts", 0))
    return 0


def _free_port(host: str) -> int:
    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _replica_argv(args, port: int, log_dir: str) -> list:
    argv = [sys.executable, "-m", "photon_ml_tpu_torch.cli.serving_driver",
            "--replicas", "1", "--server", "async",
            "--host", args.host, "--port", str(port),
            "--max-batch", str(args.max_batch),
            "--max-delay-ms", str(args.max_delay_ms),
            "--max-queue", str(args.max_queue),
            "--pad-nnz", str(args.pad_nnz),
            "--coeff-cache-entries", str(args.coeff_cache_entries),
            "--re-pages", str(args.re_pages),
            "--re-page-rows", str(args.re_page_rows),
            "--re-dense-dim-max", str(args.re_dense_dim_max),
            "--queue-deadline-s", str(args.queue_deadline_s),
            "--default-deadline-ms", str(args.default_deadline_ms),
            "--brownout-l1-ms", str(args.brownout_l1_ms),
            "--brownout-l2-ms", str(args.brownout_l2_ms),
            "--watchdog-s", str(args.watchdog_s),
            "--request-timeout-s", str(args.request_timeout_s),
            "--drain-timeout-s", str(args.drain_timeout_s),
            "--watch-interval-s", str(args.watch_interval_s),
            "--dtype", args.dtype, "--device", args.device,
            "--log-dir", log_dir]
    if args.trace_dir:
        # each replica process writes its own trace subdir; merge across
        # replica-*/ afterwards
        argv += ["--trace-dir",
                 os.path.join(args.trace_dir, os.path.basename(log_dir)),
                 "--trace-sample", str(args.trace_sample)]
    if args.no_paged_table:
        argv.append("--no-paged-table")
    if args.brownout:
        argv.append("--brownout")
    if args.registry:
        argv += ["--registry", args.registry]
        if args.model_version:
            argv += ["--model-version", args.model_version]
    else:
        argv += ["--model-dir", args.model_dir]
    return argv


def _wait_healthy(host: str, port: int, timeout_s: float,
                  proc=None) -> bool:
    import urllib.request

    deadline = time.monotonic() + timeout_s
    url = f"http://{host}:{port}/healthz"
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            return False  # replica died during warmup
        try:
            with urllib.request.urlopen(url, timeout=1.0) as resp:
                if resp.status == 200:
                    return True
        except Exception:
            time.sleep(0.2)
    return False


def _run_multi_replica(args, logger) -> int:
    """N replica processes + asyncio front door. Every replica loads the
    same source; in registry mode each runs its own watcher (with
    jitter), so a promotion reaches all replicas within one poll
    interval — the front door needs no model awareness at all. Each
    replica's output goes to ``replica-<i>/replica.out`` beside its log;
    ``driver_done`` records each replica's exit code."""
    import torch

    from photon_ml_tpu_torch.serve import AsyncFrontDoor

    open_source(args)  # a registry without the version fails here
    log_root = args.log_dir or args.model_dir or args.registry
    ports = [_free_port(args.host) for _ in range(args.replicas)]
    procs = []
    for i, port in enumerate(ports):
        rep_log = os.path.join(log_root, f"replica-{i}")
        os.makedirs(rep_log, exist_ok=True)
        with open(os.path.join(rep_log, "replica.out"), "ab") as out:
            procs.append(subprocess.Popen(
                _replica_argv(args, port, rep_log), stdout=out,
                stderr=subprocess.STDOUT))
    logger.log("replicas_spawned", ports=ports,
               pids=[p.pid for p in procs])
    ok = all(_wait_healthy(args.host, port, timeout_s=REPLICA_STARTUP_S,
                           proc=p)
             for port, p in zip(ports, procs))
    if not ok:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(30.0)
            except subprocess.TimeoutExpired:
                p.kill()
        logger.log("replica_startup_failed", ports=ports,
                   exit_codes=[p.poll() for p in procs])
        logger.close()
        print("replica startup failed (see replica logs)", flush=True)
        return 1
    door = AsyncFrontDoor([f"{args.host}:{p}" for p in ports],
                          host=args.host, port=args.port,
                          policy=args.front_door_policy,
                          hedge_enabled=args.hedge,
                          hedge_min_s=args.hedge_min_ms / 1e3,
                          affinity=args.affinity,
                          affinity_id_kind=args.affinity_id_kind)

    def ready(d):
        epoch = d.membership_epoch
        logger.log("front_door_ready", host=d.host, port=d.port,
                   backends=[f"{args.host}:{p}" for p in ports],
                   affinity=bool(args.affinity),
                   membership_epoch=(None if epoch is None
                                     else epoch.epoch))
        routing = (f", entity-affinity epoch {epoch.epoch}"
                   if epoch is not None else "")
        print(f"front door on http://{d.host}:{d.port} -> "
              f"{len(ports)} replicas on {ports} "
              f"({args.front_door_policy}{routing})", flush=True)

    try:
        door.run_forever(ready_callback=ready)
    except KeyboardInterrupt:
        pass
    finally:
        for p in procs:
            p.terminate()  # SIGTERM -> each replica drains
        deadline = time.monotonic() + args.drain_timeout_s + 10.0
        for p in procs:
            try:
                p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        logger.log("driver_done", replicas=len(procs),
                   replica_exit_codes=[p.returncode for p in procs],
                   front_door=door.stats(),
                   cuda_initialized=torch.cuda.is_initialized())
        logger.close()
    return 0


def main(argv: Sequence[str] | None = None) -> int:
    args = build_arg_parser().parse_args(argv)
    from photon_ml_tpu_torch.obs import logging as obs_logging
    from photon_ml_tpu_torch.obs import trace as obs_trace
    from photon_ml_tpu_torch.types import resolve_device

    # raises before any load without a GPU (asks whether one is present;
    # creates no CUDA context)
    resolve_device(args.device)
    obs_logging.configure()
    started = None
    if args.trace_dir and args.replicas == 1:
        # single-replica: trace in-process; multi-replica runs trace in
        # the replica processes (the front door stays untraced here)
        started = obs_trace.start(args.trace_dir, sample=args.trace_sample)
    elif args.replicas == 1:
        started = obs_trace.maybe_start_from_env()
    try:
        return _serve(args)
    finally:
        if started is not None:  # only stop a tracer this call started
            obs_trace.stop()


def _serve(args) -> int:
    log_dir = args.log_dir or args.model_dir or args.registry
    os.makedirs(log_dir, exist_ok=True)
    logger = PhotonLogger(os.path.join(log_dir, "photon.log.jsonl"))
    logger.log("driver_start", driver="serving", args=vars(args))
    if args.replicas > 1:
        return _run_multi_replica(args, logger)
    if args.server == "async":
        return _run_async(args, logger)
    with Timed(logger, "load_and_warmup"):
        server = build_server(args)
    session = server.service.session
    compiled = session.compile_count
    watcher = _maybe_watcher(args, server.service.registry, session, logger)
    _announce(logger, session, server.host, server.port, compiled,
              "threaded")
    stop = install_signal_handlers(server)
    try:
        server.serve_forever()
    except KeyboardInterrupt:  # pre-handler window / non-main-thread use
        pass
    finally:
        if watcher is not None:
            watcher.stop()
        if stop["signal"] is not None:
            logger.log("draining", signal=int(stop["signal"]),
                       queue_depth=server.service.batcher.queue_depth)
        server.close(drain_timeout_s=args.drain_timeout_s)
        join_shutdown_helper(stop, logger=logger)
        _done(logger, server.service,
              watcher_join_timeouts=getattr(watcher, "join_timeouts", 0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
