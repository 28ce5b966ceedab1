"""The port's asyncio serving path (``photon_ml_tpu_torch/serve/aserver.py``:
the asyncio server and the front door), its delta swap and the serving
driver's registry and multi-replica modes, on the CPU.

The asyncio server is held against the port's threaded server over real
sockets: the same scenarios (``tests/test_torch_serve_http.py``'s fake
session) give the same statuses, bodies and ``Retry-After`` through both
transports, and a real session scores bit for bit alike through both.
The front door is held against the JAX front door where the two are the
same host code (owner groups, membership epochs, ``/fd/metrics``), and on
its own for failover, hedging and scatter-merge, which must equal a plain
proxy bit for bit. Its close path differs from the JAX one on purpose:
``aclose`` returns while a client still holds a keep-alive connection
(the JAX close waits on ``Server.wait_closed``, which since Python 3.12
waits for every client connection to close).

Every asyncio test runs under ``asyncio.wait_for(..., BOUND)``, every
other wait is bounded by ``WAIT`` seconds, and the driver's subprocess by
``DRIVER_WAIT``. Scores: bit-equal where the same code scores the same
rows; within ``TOL_SCORE`` of ``score_game_model`` in float64."""

import asyncio
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from photon_ml_tpu.serve.aserver import AsyncFrontDoor as JaxFrontDoor
from photon_ml_tpu_torch.cli import serving_driver
from photon_ml_tpu_torch.game.scoring import score_game_model
from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.parallel import fault_injection
from photon_ml_tpu_torch.registry import ModelRegistry, materialize
from photon_ml_tpu_torch.registry import publish_delta
from photon_ml_tpu_torch.serve import (
    AsyncFrontDoor, AsyncScoringServer, MicroBatcher, ScoringServer,
    ScoringService, ScoringSession,
)
from photon_ml_tpu_torch.serve import aserver
from photon_ml_tpu_torch.serve.coeff_cache import ModelDirCoefficientStore
from tests.conftest import serving_rows
from tests.test_torch_serve_http import SCENARIOS, _http, _rows, _service
from tests.test_torch_serve_session import save_small_game_model

BOUND = 20.0  # seconds: the bound of every asyncio test
WAIT = 10.0  # seconds: every other wait
DRIVER_WAIT = 60.0  # seconds: the driver's start-up, swap and exit
TOL_SCORE = 1e-9  # |served - score_game_model|, float64 on the CPU
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RE_FILE = os.path.join("random-effect", "per-user", "coefficients.avro")


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND))


class _AsyncInThread:
    """An ``AsyncScoringServer`` on its own event loop in a thread, so the
    blocking client of the threaded server's tests drives both."""

    def __init__(self, service):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.server = self._call(AsyncScoringServer(service).start())
        self.port = self.server.port

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            BOUND)

    def close(self):
        try:
            self._call(self.server.aclose(drain_timeout_s=WAIT))
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(WAIT)
            self.loop.close()


def _transport(kind, service):
    if kind == "thread":
        server = ScoringServer(service, port=0).start()
        return server.port, lambda: server.close(drain_timeout_s=WAIT)
    server = _AsyncInThread(service)
    return server.port, server.close


def _until(cond):
    deadline = time.monotonic() + WAIT
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not met in time")
        time.sleep(0.002)


def _held_queue(svc, session, base):
    """One batch held on the gate, one request queued behind it: the
    next ``/score`` is shed."""
    session.gate.clear()
    held = svc.batcher.submit(_rows(1))
    _until(lambda: session.batches)
    queued = svc.batcher.submit(_rows(2))
    try:
        return _http(f"{base}/score", {"rows": _rows(3)},
                     {"X-Request-Id": "r-9"})
    finally:
        session.gate.set()
        held.result(WAIT)
        queued.result(WAIT)


def _post(body, headers=None, path="/score"):
    return lambda svc, s, base: _http(f"{base}{path}", body,
                                      dict({"X-Request-Id": "r-1"},
                                           **(headers or {})))


# name -> (status, kwargs of _service, the request)
HTTP_SCENARIOS = {
    "scored": (200, {}, _post({"rows": _rows(1, 2, 3),
                               "perCoordinate": True})),
    "empty_rows": (400, {}, _post({"rows": []})),
    "bad_json": (400, {}, _post(b"{not json")),
    "bad_deadline_header": (400, {}, _post({"rows": _rows(1)},
                                           {"X-Deadline-Ms": "soon"})),
    "unknown_get": (404, {}, lambda svc, s, base: _http(
        f"{base}/nope", None, {"X-Request-Id": "r-1"})),
    "unknown_post": (404, {}, _post({"rows": []}, path="/nope")),
    "reload_without_registry": (400, {}, _post({"version": "v000002"},
                                               path="/admin/reload")),
    "queue_full": (429, {"batcher_kw": {"max_queue": 1}}, _held_queue),
    "deadline_spent": (429, {}, _post({"rows": _rows(1)},
                                      {"X-Deadline-Ms": "0"})),
    "scoring_failed": (503, SCENARIOS["scoring_failed"][1],
                       _post({"rows": _rows(1)})),
    "watchdog": (504, SCENARIOS["watchdog"][1], _post({"rows": _rows(1)})),
}


@pytest.mark.parametrize("name", sorted(HTTP_SCENARIOS))
def test_async_server_answers_as_the_threaded_server(name):
    """Each scenario over real sockets through both transports: the same
    status, body and ``Retry-After`` (the shed body's retry hint only in
    kind: it follows measured timings)."""
    want, kw, run = HTTP_SCENARIOS[name]
    out = {}
    for kind in ("thread", "async"):
        svc, session = _service("port", **kw)
        port, close = _transport(kind, svc)
        try:
            status, text, headers = run(svc, session,
                                        f"http://127.0.0.1:{port}")
        finally:
            close()
        body = json.loads(text)
        if isinstance(body, dict) and "retryAfterS" in body:
            assert isinstance(body.pop("retryAfterS"), float)
        out[kind] = (status, body, headers.get("Retry-After"),
                     headers.get("X-Request-Id"))
    assert out["async"] == out["thread"]
    assert out["async"][0] == want
    assert (out["async"][2] is not None) == (want == 429)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The small saved model, a delta candidate (users 1 and 4 scaled by
    0.5), request rows of every user, and ``score_game_model``'s float64
    scores of them under both models."""
    root = tmp_path_factory.mktemp("serve_async")
    model_dir, bundle = save_small_game_model(root)
    delta_dir = str(root / "delta")
    shutil.copytree(model_dir, delta_dir)
    records, schema = read_avro_file(os.path.join(delta_dir, RE_FILE))
    for rec in records:
        if rec["modelId"] in ("1", "4"):
            for coef in rec["means"]:
                coef["value"] *= 0.5
    write_avro_file(os.path.join(delta_dir, RE_FILE), records, schema)
    idx = list(range(24))
    refs = {}
    for name, d in (("v1", model_dir), ("v2", delta_dir)):
        refs[name] = score_game_model(
            load_game_model(d, device="cpu"),
            {"g": bundle["Xg"][idx], "u": bundle["Xu"][idx]},
            {"userId": np.asarray([str(bundle["uid"][i]) for i in idx])},
            dtype=torch.float64, device="cpu").numpy()
    return dict(root=root, model_dir=model_dir, delta_dir=delta_dir,
                bundle=bundle, rows=serving_rows(bundle, idx), refs=refs,
                users=bundle["uid"][idx].astype(str))


def _real_service(source, registry=None, max_batch=8):
    session = ScoringSession(source, device="cpu", dtype="float64",
                             max_batch=max_batch, coeff_cache_entries=32)
    batcher = MicroBatcher(session.score_rows, max_batch=max_batch,
                           max_delay_ms=1.0, metrics=session.metrics)
    return ScoringService(session, batcher, registry=registry)


def test_async_server_scores_bit_equal_to_the_threaded_server(small):
    got = {}
    for kind in ("thread", "async"):
        port, close = _transport(kind, _real_service(small["model_dir"]))
        try:
            status, text, _ = _http(f"http://127.0.0.1:{port}/score",
                                    {"rows": small["rows"][:8],
                                     "perCoordinate": True})
        finally:
            close()
        assert status == 200
        got[kind] = json.loads(text)
    assert got["async"] == got["thread"]
    assert np.abs(np.asarray(got["async"]["scores"])
                  - small["refs"]["v1"][:8]).max() <= TOL_SCORE


async def _ahttp(host, port, method, path, payload=None, keep=None):
    """(status, headers, body) over a fresh or kept-alive connection."""
    reader, writer = keep or await asyncio.open_connection(host, port)
    body = b"" if payload is None else json.dumps(payload).encode()
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    head = (await reader.readuntil(b"\r\n\r\n")).decode().split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, _, v in
               (line.partition(":") for line in head[1:] if ":" in line)}
    raw = await reader.readexactly(int(headers.get("content-length", 0)))
    if keep is None:
        writer.close()
    return int(head[0].split(" ")[1]), headers, raw


def test_front_door_spreads_and_fails_over(small):
    """The JAX test of the same name on the port: both replicas serve, a
    dead replica is failed over with no client error, every replica down
    answers 503 — and each ``aclose`` returns although a client keeps an
    idle keep-alive connection open to the door and the door keeps its
    pooled connections to the replicas."""
    services = [_real_service(small["model_dir"]) for _ in range(2)]
    rows = small["rows"][:3]

    async def run():
        a = await AsyncScoringServer(services[0]).start()
        b = await AsyncScoringServer(services[1]).start()
        door = await AsyncFrontDoor(
            [f"127.0.0.1:{a.port}", f"127.0.0.1:{b.port}"],
            retry_backend_s=0.2).start()
        idle = await asyncio.open_connection(door.host, door.port)
        ok = await asyncio.gather(*[_ahttp(door.host, door.port, "POST",
                                           "/score", {"rows": rows})
                                    for _ in range(12)])
        await _ahttp(door.host, door.port, "GET", "/fd/healthz", keep=idle)
        await a.aclose()  # replica A dies while the door pools to it
        after = await asyncio.gather(*[_ahttp(door.host, door.port, "POST",
                                              "/score", {"rows": rows})
                                       for _ in range(6)])
        await b.aclose()
        dead = await _ahttp(door.host, door.port, "POST", "/score",
                            {"rows": rows})
        await door.aclose()  # the idle client connection is still open
        idle[1].close()
        return ok, after, dead, door

    ok, after, dead, door = _run(run())
    assert all(r[0] == 200 for r in ok + after)
    assert door.retried >= 1 and dead[0] == 503
    for svc in services:
        assert svc.metrics.snapshot()["requests_total"] > 0


def test_front_door_hedges_a_delayed_replica(small):
    """A ``delay`` fault at ``fd.proxy`` holds the primary exchange past
    its p99: the door duplicates the request onto the other replica, the
    duplicate answers first with the same scores, and the delayed,
    healthy replica's breaker stays closed."""
    services = [_real_service(small["model_dir"]) for _ in range(2)]
    rows = small["rows"][:4]

    async def run():
        servers = [await AsyncScoringServer(s).start() for s in services]
        door = await AsyncFrontDoor(
            [f"127.0.0.1:{s.port}" for s in servers], policy="round_robin",
            hedge_enabled=True, hedge_min_s=0.05,
            hedge_min_samples=1).start()
        warm = [await _ahttp(door.host, door.port, "POST", "/score",
                             {"rows": rows}) for _ in range(4)]
        fault_injection.install([fault_injection.Fault(
            site="fd.proxy", kind="delay", at=0, delay_s=2.0)])
        try:
            t0 = time.monotonic()
            hedged = await _ahttp(door.host, door.port, "POST", "/score",
                                  {"rows": rows})
            seconds = time.monotonic() - t0
        finally:
            fault_injection.clear()
        stats = door.stats()
        await door.aclose()
        for s in servers:
            await s.aclose()
        return warm, hedged, seconds, stats

    warm, hedged, seconds, stats = _run(run())
    assert hedged[0] == 200 and seconds < 2.0
    assert json.loads(hedged[2]) == json.loads(warm[0][2])
    assert (stats["hedged"], stats["hedgeWins"]) == (1, 1)
    assert [b["state"] for b in stats["backends"]] == ["closed", "closed"]
    assert all(b["opened"] == 0 for b in stats["backends"])


def _doors(backends, **kw):
    return {"jax": JaxFrontDoor(backends, **kw),
            "port": AsyncFrontDoor(backends, **kw)}


def test_owner_groups_match_the_jax_door():
    """The same payload under the same epoch: rows grouped by owning
    replica alike (numeric and string ids, rows without an entity)."""
    backends = [f"127.0.0.1:{9000 + i}" for i in range(3)]
    rng = np.random.default_rng(4)
    rows = []
    for i in range(200):
        ids = {}
        if i % 7:
            ids["userId"] = (str(int(rng.integers(0, 10**6))) if i % 3
                             else f"user-{int(rng.integers(0, 500))}")
        if i % 5 == 0:
            ids["itemId"] = str(int(rng.integers(0, 50)))
        rows.append({"features": [], "entityIds": ids})
    numeric = [r for r in rows
               if all(v.isdigit() for v in r["entityIds"].values())]
    for kind in ("auto", "int", "str"):
        doors = _doors(backends, affinity=True, affinity_id_kind=kind)
        payload = {"rows": numeric if kind == "int" else rows}
        got = {name: d._owner_groups(payload, d.membership_epoch)
               for name, d in doors.items()}
        assert got["port"] == got["jax"]
        assert len(got["port"]) == 3


async def _fake_backend(metrics_text):
    """A replica stand-in: ``/admin/membership`` acknowledges (with a
    prefetch count), ``/metrics`` answers ``metrics_text``, ``/healthz``
    ok."""
    async def handle(reader, writer):
        try:
            while True:
                req = await aserver._read_request(reader)
                if req is None:
                    return
                method, path, _headers, body = req
                if path == "/admin/membership":
                    payload = json.loads(body)
                    data = aserver._encode_response(200, {
                        "applied": True, "epoch": payload["epoch"],
                        "prefetched": len(payload.get(
                            "prefetchEntityIds") or ()),
                        "prefetchBytes": 0})
                elif path == "/metrics":
                    data = aserver._encode_response(
                        200, metrics_text, content_type="text/plain")
                else:
                    data = aserver._encode_response(200, {"status": "ok"})
                writer.write(data)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    return server, f"127.0.0.1:{server.sockets[0].getsockname()[1]}"


METRICS_TEXT = ("# TYPE photon_serve_requests_total counter\n"
                "photon_serve_requests_total 7\n"
                "# TYPE photon_serve_request_latency_ms histogram\n"
                'photon_serve_request_latency_ms_bucket{le="5"} 3\n'
                'photon_serve_request_latency_ms_bucket{le="+Inf"} 7\n'
                "photon_serve_compile_cache_misses_total 7\n")


def test_membership_epochs_and_fd_metrics_match_the_jax_door():
    """Both doors over the same stand-in replicas: the first announce, a
    join and a leave commit the same epochs over the same replicas, and
    ``/fd/metrics`` gives the same series, labels and order."""

    async def run():
        fakes = [await _fake_backend(METRICS_TEXT) for _ in range(3)]
        addrs = [a for _s, a in fakes]
        out = {}
        for name, door in _doors(addrs[:2], affinity=True).items():
            first = await door._rebalance()
            joined = await door.add_backend(addrs[2])
            left = await door.remove_backend(addrs[0])
            epoch = door.membership_epoch
            out[name] = ([first, joined, left],
                         (epoch.epoch, list(epoch.replicas)),
                         await door._fd_metrics())
            for b in door._backends:
                for _r, w in b.pool:
                    w.close()
        for server, _a in fakes:
            server.close()
        return out

    out = _run(run())
    assert out["port"] == out["jax"]
    assert out["port"][1] == (3, out["port"][0][2]["replicas"])
    assert 'photon_serve_requests_total{replica="' in out["port"][2]


def test_affinity_scatter_merge_scores_as_its_owners(small):
    """Three replicas: a batch whose users span owners is scattered by
    owner and merged back in row order, bit for bit the scores each owner
    gives its group sent to it directly, and within ``TOL_SCORE`` of the
    same batch through a door without affinity (one batch at another
    rung of the ladder, so not bit for bit on the CPU)."""
    services = [_real_service(small["model_dir"], max_batch=32)
                for _ in range(3)]

    payload = {"rows": small["rows"], "perCoordinate": True}

    async def run():
        servers = [await AsyncScoringServer(s).start() for s in services]
        addrs = [f"127.0.0.1:{s.port}" for s in servers]
        out = {}
        for affinity in (True, False):
            door = await AsyncFrontDoor(addrs, affinity=affinity).start()
            if affinity:
                assert (await door._rebalance())["committed"]
                groups = door._owner_groups(payload, door.membership_epoch)
            out[affinity] = await _ahttp(door.host, door.port, "POST",
                                         "/score", payload)
            out[f"stats-{affinity}"] = door.stats()
            await door.aclose()
        # each owner's group sent to it directly, at the same rung
        direct = {}
        for addr, idxs in groups:
            server = servers[addrs.index(addr)]
            status, _h, raw = await _ahttp(
                server.host, server.port, "POST", "/score",
                {"rows": [small["rows"][i] for i in idxs],
                 "perCoordinate": True})
            assert status == 200
            direct[addr] = (idxs, json.loads(raw))
        for s in servers:
            await s.aclose()
        return out, direct

    out, direct = _run(run())
    assert out[True][0] == out[False][0] == 200
    got, plain = json.loads(out[True][2]), json.loads(out[False][2])
    assert len(direct) == 3
    assert out["stats-True"]["affinity"]["scattered"] == 1
    want = [None] * len(small["rows"])
    parts = {k: [None] * len(want) for k in got["scoreComponents"]}
    for idxs, body in direct.values():
        for j, i in enumerate(idxs):
            want[i] = body["scores"][j]
            for k in parts:
                parts[k][i] = body["scoreComponents"][k][j]
    assert got["scores"] == want and got["scoreComponents"] == parts
    # the unscattered batch runs at another rung: equal to rounding
    assert np.abs(np.asarray(got["scores"])
                  - np.asarray(plain["scores"])).max() <= TOL_SCORE


def test_delta_swap_reads_only_the_delta_layer(small, tmp_path):
    """A session serving v1 swaps to a delta on top of it: the parent's
    coefficient file is not read again (its store and resident entries
    are kept), the delta's users change, and the scores equal a fresh
    session on the same version bit for bit and ``score_game_model`` on
    the materialized delta."""
    registry = ModelRegistry(str(tmp_path / "registry"))
    v1 = registry.publish(small["model_dir"], set_latest=True)
    session = ScoringSession(registry.open_version(v1), device="cpu",
                             dtype="float64", max_batch=32,
                             coeff_cache_entries=32)
    before = session.score_rows(small["rows"])
    v2 = publish_delta(registry, small["delta_dir"], set_latest=True)
    reads = []
    real = ModelDirCoefficientStore.load_many

    def spy(self, ids):
        reads.append(self.model_dir)
        return real(self, ids)

    ModelDirCoefficientStore.load_many = spy
    try:
        assert session.swap(registry.open_version(v2), version=v2) == v2
        after = session.score_rows(small["rows"])
    finally:
        ModelDirCoefficientStore.load_many = real
    session.close()
    assert registry.model_dir(v1) not in reads
    fresh = ScoringSession(registry.open_version(v2), device="cpu",
                           dtype="float64", max_batch=32,
                           coeff_cache_entries=32)
    assert np.array_equal(after, fresh.score_rows(small["rows"]))
    fresh.close()
    moved = np.isin(small["users"], ["1", "4"])
    assert np.array_equal(before[~moved], after[~moved])
    assert (before[moved] != after[moved]).all()
    assert np.abs(after - small["refs"]["v2"]).max() <= TOL_SCORE
    want = score_game_model(
        load_game_model(materialize(registry, v2), device="cpu"),
        {"g": small["bundle"]["Xg"][:24], "u": small["bundle"]["Xu"][:24]},
        {"userId": small["users"]}, dtype=torch.float64, device="cpu")
    assert np.array_equal(small["refs"]["v2"], want.numpy())


ITEM_19_FLAGS = [
    ["--registry", "reg"],
    ["--model-version", "v000001"],
    ["--replicas", "2"],
    ["--front-door-policy", "round_robin"],
    ["--hedge"],
    ["--hedge-min-ms", "10"],
    ["--affinity"],
    ["--affinity-id-kind", "int"],
    ["--server", "thread"],
]


@pytest.mark.parametrize("flags", ITEM_19_FLAGS, ids=lambda f: f[0])
def test_each_item_19_flag_is_accepted(flags):
    """The flags the driver once refused are parsed to their value, and
    ``--server`` defaults to ``async`` as in the JAX driver."""
    parser = serving_driver.build_arg_parser()
    argv = flags + (["--model-dir", "m"] if flags[0] != "--registry"
                    else [])
    args = parser.parse_args(argv)
    dest = flags[0][2:].replace("-", "_")
    assert getattr(args, dest) != parser.get_default(dest)
    assert parser.get_default("server") == "async"
    assert not hasattr(serving_driver, "_DEFERRED")


def _healthz(port):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=WAIT) as resp:
        return json.loads(resp.read())


def test_driver_serves_a_registry_through_two_replicas(small, tmp_path):
    """``serving_driver --registry R --replicas 2 --device cpu --port 0``:
    the door scores as ``score_game_model`` for v1; a delta promoted in
    the registry reaches both replicas' watchers, which swap to it, and
    the door then scores as ``score_game_model`` for the delta; SIGTERM
    drains both replicas and the driver exits 0. The parent creates no
    CUDA context (``cuda_initialized`` in its log)."""
    registry = ModelRegistry(str(tmp_path / "registry"))
    registry.publish(small["model_dir"], set_latest=True)
    log_dir = tmp_path / "log"
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.serving_driver",
         "--registry", registry.root, "--replicas", "2", "--device", "cpu",
         "--port", "0", "--dtype", "float64", "--max-batch", "32",
         "--watch-interval-s", "0.2", "--log-dir", str(log_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=REPO))
    out = []
    reader = threading.Thread(target=lambda: out.extend(proc.stdout),
                              daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + DRIVER_WAIT
        m = None
        while m is None:
            assert time.monotonic() < deadline and proc.poll() is None, out
            time.sleep(0.05)
            m = next((re.search(r"^front door on http://[\d.]+:(\d+) -> 2 "
                                r"replicas on \[(\d+), (\d+)\]", line)
                      for line in list(out) if line.startswith("front")),
                     None)
        door, replicas = int(m.group(1)), [int(m.group(2)),
                                           int(m.group(3))]
        base = f"http://127.0.0.1:{door}"
        for ref in ("v1", "v2"):
            if ref == "v2":
                v2 = publish_delta(registry, small["delta_dir"],
                                   set_latest=True)
                _until_versions(replicas, v2, deadline)
            for _ in range(2):  # each replica at least once
                status, text, _ = _http(f"{base}/score",
                                        {"rows": small["rows"]})
                assert status == 200
                got = np.asarray(json.loads(text)["scores"])
                assert np.abs(got - small["refs"][ref]).max() <= TOL_SCORE
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=DRIVER_WAIT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
    reader.join(WAIT)
    with open(log_dir / "photon.log.jsonl") as f:
        done = [json.loads(line) for line in f][-1]
    assert done["event"] == "driver_done"
    assert done["replica_exit_codes"] == [0, 0]
    assert done["cuda_initialized"] is False
    for i in range(2):
        with open(log_dir / f"replica-{i}" / "photon.log.jsonl") as f:
            events = [json.loads(line) for line in f]
        assert [e["version"] for e in events if e["event"] == "hot_swap"] \
            == [v2]
        assert events[-1]["event"] == "driver_done"


def _until_versions(ports, version, deadline):
    while {_healthz(p)["active_version"] for p in ports} != {version}:
        assert time.monotonic() < deadline, "the replicas did not swap"
        time.sleep(0.05)


def test_install_uvloop_is_optional(monkeypatch):
    """Without an importable ``uvloop`` the servers keep the stdlib loop:
    ``install_uvloop`` returns False and changes no policy."""
    policy = asyncio.get_event_loop_policy()
    monkeypatch.setitem(sys.modules, "uvloop", None)
    assert aserver.install_uvloop() is False
    assert asyncio.get_event_loop_policy() is policy
