"""The port's host-side serving path (``photon_ml_tpu_torch/serve/{batcher,
brownout,server}.py`` and ``cli/serving_driver.py``) against the JAX
package's, on the CPU.

Service, batcher and brownout cases run the same scenario through both
packages over the same fake session (rows score as their ``x`` field, a
gate holds a batch "on the device", a delay or an error stands for a slow
or failed execution) and compare the status codes and bodies exactly: the
code is host code in both. The real-socket cases bind ``127.0.0.1`` port
0; the driver's ``main`` runs as a subprocess (its signal handlers need
the main thread) and must exit 0 after SIGTERM. Every wait in this file
is bounded by ``WAIT`` seconds."""

import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.game.scoring import score_game_model as jax_score_game
from photon_ml_tpu.serve.batcher import MicroBatcher as JaxBatcher
from photon_ml_tpu.serve.brownout import (
    BrownoutController as JaxBrownout,
)
from photon_ml_tpu.serve.metrics import ServingMetrics as JaxMetrics
from photon_ml_tpu.serve.server import ScoringService as JaxService
from photon_ml_tpu_torch.cli import serving_driver
from photon_ml_tpu_torch.serve import (
    BatchWatchdogTimeout, BrownoutController, MicroBatcher, QueueFullError,
    ScoringServer, ScoringService, ServingMetrics,
)
from tests.conftest import serving_rows
from tests.test_torch_serve_session import save_small_game_model

WAIT = 10.0  # seconds: the bound of every wait in this file
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {
    "jax": (JaxService, JaxBatcher, JaxMetrics),
    "port": (ScoringService, MicroBatcher, ServingMetrics),
}


class FakeSession:
    """Stands in for the scoring session: row i scores its ``x`` value
    (per coordinate: all of it to ``fixed``), after waiting for ``gate``
    and sleeping ``delay_s``; ``fail`` is raised instead when set."""

    model_dir = "fake-model"
    active_version = "v-fake"
    task = "logistic"
    warming = False

    def __init__(self, metrics, max_batch=8, delay_s=0.0, fail=None):
        self.metrics = metrics
        self.max_batch = max_batch
        self.delay_s = delay_s
        self.fail = fail
        self.gate = threading.Event()
        self.gate.set()
        self.batches = []

    def score_rows(self, rows, per_coordinate=False, ctx=None):
        self.batches.append(len(rows))
        if not self.gate.wait(WAIT):
            raise TimeoutError("the test's gate was never opened")
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail is not None:
            raise self.fail
        scores = np.asarray([float(r.get("x", 0.0)) for r in rows])
        return (scores, {"fixed": scores}) if per_coordinate else scores


def _rows(*xs):
    return [{"x": float(x)} for x in xs]


def _service(package, *, session_kw=None, batcher_kw=None, **service_kw):
    service_cls, batcher_cls, metrics_cls = PACKAGES[package]
    session = FakeSession(metrics_cls(), **(session_kw or {}))
    kw = dict(max_batch=session.max_batch, max_delay_ms=1.0, max_queue=8,
              metrics=session.metrics)
    kw.update(batcher_kw or {})
    batcher = batcher_cls(session.score_rows, **kw)
    return service_cls(session, batcher, **service_kw), session


def _until(cond):
    deadline = time.monotonic() + WAIT
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not met in time")
        time.sleep(0.002)


def _queue_full(svc, session):
    """One batch held on the gate, one request queued behind it, a third
    request shed."""
    session.gate.clear()
    held = svc.batcher.submit(_rows(1))
    _until(lambda: session.batches)
    queued = svc.batcher.submit(_rows(2))
    status, body = svc.handle_score({"rows": _rows(3)})
    session.gate.set()
    assert held.result(WAIT).tolist() == [1.0]
    assert queued.result(WAIT).tolist() == [2.0]
    return status, body


def _expired_in_queue(svc, session):
    """A request whose 20 ms budget runs out behind a held batch."""
    session.gate.clear()
    held = svc.batcher.submit(_rows(1))
    _until(lambda: session.batches)
    result = {}
    t = threading.Thread(target=lambda: result.update(
        out=svc.handle_score({"rows": _rows(2)}, deadline_ms=20.0)))
    t.start()
    time.sleep(0.1)
    session.gate.set()
    t.join(WAIT)
    assert not t.is_alive() and held.result(WAIT).tolist() == [1.0]
    return result["out"]


SCENARIOS = {
    "scored": (200, {}, lambda svc, s: svc.handle_score(
        {"rows": _rows(1, 2, 3) + [{"x": 4.0, "uid": "u4"}],
         "perCoordinate": True})),
    "payload_not_an_object": (400, {}, lambda svc, s: svc.handle_score(
        ["rows"], request_id="r-1")),
    "empty_rows": (400, {}, lambda svc, s: svc.handle_score({"rows": []})),
    "row_not_an_object": (400, {}, lambda svc, s: svc.handle_score(
        {"rows": [42]})),
    "oversized": (400, {}, lambda svc, s: svc.handle_score(
        {"rows": _rows(*range(9))})),
    "queue_full": (429, dict(batcher_kw={"max_queue": 1}), _queue_full),
    "deadline_spent_at_admission": (429, {}, lambda svc, s: svc.handle_score(
        {"rows": _rows(1)}, deadline_ms=0.0)),
    "default_deadline_spent": (429, {"default_deadline_ms": 0.0},
                               lambda svc, s: svc.handle_score(
                                   {"rows": _rows(1)})),
    "deadline_expired_in_queue": (429, {}, _expired_in_queue),
    "scoring_failed": (503, dict(session_kw={"fail": RuntimeError("boom")}),
                       lambda svc, s: svc.handle_score({"rows": _rows(1)},
                                                       request_id="r-2")),
    "watchdog": (504, dict(session_kw={"delay_s": 0.3},
                           batcher_kw={"watchdog_s": 0.05}),
                 lambda svc, s: svc.handle_score({"rows": _rows(1)})),
    "request_timeout": (504, dict(session_kw={"delay_s": 0.3},
                                  request_timeout_s=0.05),
                        lambda svc, s: svc.handle_score({"rows": _rows(1)})),
    "reload_without_model_dir": (400, {}, lambda svc, s: svc.handle_reload(
        {"version": "v000002"})),
    "reload_same_dir": (200, {}, lambda svc, s: svc.handle_reload(
        {"modelDir": "fake-model-dir"})),
    "membership_bad_payload": (400, {}, lambda svc, s: svc.handle_membership(
        {"epoch": "x"})),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_service_status_codes_match_jax(name):
    """Each scenario answers with the status the contract names (200,
    400, 429, 503, 504) and the same body in both packages (the shed
    bodies' retry hint only in kind: it follows measured timings)."""
    want_status, kw, run = SCENARIOS[name]
    out = {}
    for package in PACKAGES:
        svc, session = _service(package, **kw)
        if name == "reload_same_dir":
            session.active_version = "fake-model-dir"
        try:
            out[package] = run(svc, session)
        finally:
            svc.close(drain_timeout_s=WAIT)
    (jax_status, jax_body), (status, body) = out["jax"], out["port"]
    assert status == jax_status == want_status, (out, name)
    if status == 429:
        assert isinstance(body.pop("retryAfterS"), float)
        jax_body.pop("retryAfterS")
    assert body == jax_body
    if name == "scored":
        assert body == {"scores": [1.0, 2.0, 3.0, 4.0], "degraded": 0,
                        "uids": [None, None, None, "u4"],
                        "scoreComponents": {"fixed": [1.0, 2.0, 3.0, 4.0]}}


@pytest.mark.parametrize("raw,want", [(None, None), ("", None),
                                      (" 12.5 ", 12.5), ("oops", ValueError)])
def test_deadline_header_parsing_matches_jax(raw, want):
    if want is ValueError:
        for cls in (ScoringService, JaxService):
            with pytest.raises(ValueError, match="X-Deadline-Ms"):
                cls.parse_deadline_ms(raw)
    else:
        assert (ScoringService.parse_deadline_ms(raw)
                == JaxService.parse_deadline_ms(raw) == want)


def test_batcher_coalesces_requests_like_jax():
    """Eight one-row requests admitted while the first batch is held run
    as the same batches in both packages, and each request gets its own
    row back."""
    runs = {}
    for package in PACKAGES:
        svc, session = _service(package, batcher_kw={"max_delay_ms": 50.0})
        try:
            session.gate.clear()
            first = svc.batcher.submit(_rows(0))
            _until(lambda: session.batches)
            pending = [svc.batcher.submit(_rows(i)) for i in range(1, 8)]
            session.gate.set()
            got = [first.result(WAIT)[0]] + [p.result(WAIT)[0]
                                             for p in pending]
            assert got == [float(i) for i in range(8)]
            runs[package] = (list(session.batches),
                             svc.metrics.snapshot()["batches_total"])
        finally:
            svc.close(drain_timeout_s=WAIT)
    assert runs["port"] == runs["jax"] == ([1, 7], 2)


def test_batcher_watchdog_fails_the_stuck_batch_and_worker_survives():
    """A batch past the watchdog fails with ``BatchWatchdogTimeout`` (a
    ``WatchdogTimeout``), is counted as an error, and the next request is
    scored by the same worker; a full queue sheds with its cause and
    capacity."""
    from photon_ml_tpu_torch.parallel.resilience import WatchdogTimeout

    session = FakeSession(ServingMetrics(), delay_s=0.3)
    batcher = MicroBatcher(session.score_rows, max_batch=8, max_delay_ms=1.0,
                           max_queue=1, watchdog_s=0.05,
                           metrics=session.metrics)
    try:
        with pytest.raises(BatchWatchdogTimeout) as stuck:
            batcher.submit(_rows(1)).result(WAIT)
        assert isinstance(stuck.value, WatchdogTimeout)
        session.delay_s = 0.0
        assert batcher.submit(_rows(2)).result(WAIT).tolist() == [2.0]
        batcher.watchdog_s = WAIT
        session.gate.clear()
        held = batcher.submit(_rows(3))
        _until(lambda: len(session.batches) == 3)
        queued = batcher.submit(_rows(4))
        with pytest.raises(QueueFullError) as shed:
            batcher.submit(_rows(5))
        assert shed.value.cause == "queue_full" and shed.value.capacity == 1
        session.gate.set()
        assert held.result(WAIT).tolist() == [3.0]
        assert queued.result(WAIT).tolist() == [4.0]
        snap = session.metrics.snapshot()
        assert snap["errors_total"] == 1
        assert snap["shed_queue_full_total"] == 1
    finally:
        batcher.close(drain_timeout_s=WAIT)
    assert batcher.join_timeouts == 0


@pytest.mark.parametrize("waits", [
    [10.0, 80.0, 500.0, 30.0, 5.0],
    [60.0, 60.0, 20.0, 20.0, 1.0, 1.0],
    [250.0, 90.0, 40.0, 0.0, 0.0, 300.0],
])
def test_brownout_levels_match_jax(waits):
    """The same queue waits, on the same clock (one second per wait),
    move both controllers through the same levels and transitions."""
    levels = {}
    for name, cls in (("jax", JaxBrownout), ("port", BrownoutController)):
        clock = {"now": 0.0}
        ctl = cls(alpha=0.5, min_dwell_s=1.5, time_fn=lambda: clock["now"])
        seen = []
        for w in waits:
            clock["now"] += 1.0
            seen.append(ctl.note_queue_wait(w))
        levels[name] = (seen, ctl.transitions, ctl.queue_wait_ewma_ms)
    assert levels["port"] == levels["jax"]
    assert max(levels["port"][0]) >= 1


def _http(url, payload=None, headers=None):
    data = None if payload is None else (
        payload if isinstance(payload, bytes) else json.dumps(payload)
        .encode())
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def test_http_round_trip_on_an_ephemeral_port():
    svc, session = _service("port")
    server = ScoringServer(svc, port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        status, text, headers = _http(f"{base}/score", {"rows": _rows(5, 6)},
                                      {"X-Request-Id": "req-7"})
        assert status == 200 and json.loads(text)["scores"] == [5.0, 6.0]
        assert headers["X-Request-Id"] == "req-7"
        status, text, _ = _http(f"{base}/healthz")
        assert status == 200 and json.loads(text)["status"] == "ok"
        status, text, _ = _http(f"{base}/metrics")
        assert status == 200 and "photon_serve_requests_total 1" in text
        assert re.search(r'photon_serve_kernel_launches_total\{kernel='
                         r'"paged_gather_score"\} \d+', text)
        assert _http(f"{base}/nope")[0] == 404
        assert _http(f"{base}/nope", {"rows": []})[0] == 404
        assert _http(f"{base}/score", b"{not json")[0] == 400
        status, text, _ = _http(f"{base}/score", {"rows": _rows(1)},
                                {"X-Deadline-Ms": "soon"})
        assert status == 400 and "X-Deadline-Ms" in text
    finally:
        server.close(drain_timeout_s=WAIT)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Rows of a small saved model (``save_small_game_model``) and their
    JAX ``score_game_model`` scores in float64."""
    model_dir, bundle = save_small_game_model(
        tmp_path_factory.mktemp("driver"))
    idx = list(range(6))
    ref = jax_score_game(
        bundle["loaded"], {"g": bundle["Xg"][idx], "u": bundle["Xu"][idx]},
        {"userId": np.asarray([str(bundle["uid"][i]) for i in idx])},
        dtype=jnp.float64)
    return model_dir, serving_rows(bundle, idx), np.asarray(ref)


def test_driver_build_server_round_trip(reference):
    """The driver's own parser and ``build_server`` on the CPU: one
    ``/score`` round trip within 1e-9 of ``score_game_model``, then
    ``close``."""
    model_dir, rows, ref = reference
    args = serving_driver.build_arg_parser().parse_args([
        "--model-dir", model_dir, "--device", "cpu", "--port", "0",
        "--dtype", "float64", "--max-batch", "8"])
    assert args.server == "async"  # build_server is the threaded one
    server = serving_driver.build_server(args).start()
    try:
        session = server.service.session
        assert session.device.type == "cpu" and session.paged_active
        assert session.compile_count == len(session.row_ladder)
        base = f"http://127.0.0.1:{server.port}"
        status, text, _ = _http(f"{base}/score", {"rows": rows})
        assert status == 200
        got = np.asarray(json.loads(text)["scores"])
        assert np.abs(got - ref).max() <= 1e-9
        # the rows came out of the fused rung: nothing left it
        status, text, _ = _http(f"{base}/metrics")
        for name in ("fixed_eager_batches", "fused_fallback_batches",
                     "overflow_rows"):
            assert f"\nphoton_serve_{name}_total 0\n" in text
    finally:
        server.close(drain_timeout_s=WAIT)
    assert not session._installer.is_alive()


def test_driver_main_serves_then_drains_on_sigterm(reference, tmp_path):
    """``python -m photon_ml_tpu_torch.cli.serving_driver --device cpu
    --port 0``: the ready line names the port, one request is scored,
    SIGTERM drains and the process exits 0."""
    model_dir, rows, ref = reference
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.serving_driver",
         "--model-dir", model_dir, "--device", "cpu", "--port", "0",
         "--dtype", "float64", "--max-batch", "8", "--log-dir",
         str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(line) for line in proc.stdout],
        daemon=True)
    reader.start()
    try:
        port, seen = None, []
        deadline = time.monotonic() + 6 * WAIT
        while port is None:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            seen.append(line)
            m = re.search(r"^serving .* on http://127\.0\.0\.1:(\d+) ", line)
            port = int(m.group(1)) if m else None
        status, text, _ = _http(f"http://127.0.0.1:{port}/score",
                                {"rows": rows})
        assert status == 200, seen
        assert np.abs(np.asarray(json.loads(text)["scores"]) - ref).max() \
            <= 1e-9
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=3 * WAIT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
    reader.join(WAIT)
    with open(tmp_path / "photon.log.jsonl") as f:
        events = [json.loads(line)["event"] for line in f]
    assert events[0] == "driver_start" and events[-1] == "driver_done"
    assert "draining" in events


def test_driver_serves_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default device raises only without a GPU")
    args = serving_driver.build_arg_parser().parse_args(
        ["--model-dir", "no-such-model"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_driver.main(["--model-dir", "no-such-model", "--port", "0"])
