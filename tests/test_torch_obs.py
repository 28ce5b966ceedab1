"""The port's observability (``photon_ml_tpu_torch/obs``,
``utils/tracing.py``, the training hooks and the drivers' ``--trace-dir``,
``--trace-sample`` and ``--profile-dir``) against the JAX package's, on the
CPU.

The JAX references run once per module: a screened elastic-net path walk
and one GAME sweep (a fixed coordinate and a per-user random one), each
under a fresh tracer and fresh training metrics in both packages; the
streamed pass's spans are the port's alone (the JAX streamed sweep
compiles for ~15 s).
Spans are compared by name, category, parent span and argument keys, and
by the argument values both packages compute alike (the screen's counts
exactly, the lambdas within 1e-12 relative); metrics by their counts (the
seconds differ). Expositions are compared byte for byte."""

import io
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game.descent import (
    CoordinateConfig as JaxConfig, CoordinateDescent as JaxCD,
    make_game_dataset as jax_dataset,
)
from photon_ml_tpu.obs import metrics as jax_metrics
from photon_ml_tpu.obs import trace as jax_trace
from photon_ml_tpu.obs import trace_cli as jax_cli
from photon_ml_tpu.ops.objective import make_objective as jax_objective
from photon_ml_tpu.ops.regularization import RegularizationContext as JaxReg
from photon_ml_tpu.optimize import (
    OptimizerConfig as JaxOptConfig, PathConfig as JaxPathConfig,
    PathSolver as JaxPathSolver,
)
from photon_ml_tpu.parallel.mesh import make_mesh
from photon_ml_tpu.types import (
    SparseFeatures as JaxSparse, make_batch as jax_batch,
)
from photon_ml_tpu_torch.cli import game_training_driver, glm_driver
from photon_ml_tpu_torch.game.descent import (
    CoordinateConfig, CoordinateDescent,
)
from photon_ml_tpu_torch.game.random_effect import (
    re_solver_host_reads, train_random_effect,
)
from photon_ml_tpu_torch.interop import game_dataset_from_numpy
from photon_ml_tpu_torch.obs import logging as obs_logging
from photon_ml_tpu_torch.obs import metrics, trace, trace_cli
from photon_ml_tpu_torch.ops import kernels
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig, PathConfig
from photon_ml_tpu_torch.optimize import path as path_mod
from photon_ml_tpu_torch.optimize.path import PathSolver
from photon_ml_tpu_torch.parallel import data_parallel
from photon_ml_tpu_torch.types import SparseFeatures, make_batch
from photon_ml_tpu_torch.utils import annotate, profile_trace

ALPHA = 0.9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU tensors are tiny: torch's thread pool only adds waits
    (a walk here took 6-45 s at 8 threads, 0.6 s at 1). Restored after
    the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
LAMBDAS = 3
SCREEN_ARGS = ("candidates", "screened_dim", "frozen", "kkt_rounds",
               "kkt_violations", "fallback", "rule")


def _sparse_problem(n=600, d=64, k=6, seed=1):
    r = np.random.default_rng(seed)
    idx = r.integers(1, d, (n, k)).astype(np.int32)
    idx[:, -1] = 0  # the intercept in every row's last slot
    vals = r.normal(size=(n, k))
    vals[:, -1] = 1.0
    w = np.zeros(d)
    w[r.choice(np.arange(1, d), 6, replace=False)] = r.normal(size=6) * 2.0
    m = (vals * w[idx]).sum(1)
    y = (r.random(n) < 1.0 / (1.0 + np.exp(-m))).astype(np.float64)
    return idx, vals, y, np.ones(n) / n, d


def _port_batch():
    idx, vals, y, wts, d = _sparse_problem()
    return make_batch(SparseFeatures(torch.from_numpy(idx),
                                     torch.from_numpy(vals), d),
                      y, np.zeros(len(y)), wts, dtype=torch.float64,
                      device="cpu")


def _port_solver(batch=None):
    return PathSolver(
        make_objective("logistic", None, False, 0),
        RegularizationContext("elastic_net", alpha=ALPHA),
        batch=_port_batch() if batch is None else batch, optimizer="auto",
        config=OptimizerConfig(tolerance=1e-15),
        path_config=PathConfig(screen="strong", min_bucket=8))


def _path_walks():
    idx, vals, y, wts, d = _sparse_problem()
    js = JaxPathSolver(
        jax_objective("logistic", None, False, 0),
        JaxReg("elastic_net", alpha=ALPHA),
        batch=jax_batch(JaxSparse(jnp.asarray(idx), jnp.asarray(vals), d),
                        y, np.zeros(len(y)), wts, dtype=jnp.float64),
        mesh=make_mesh(), optimizer="auto",
        config=JaxOptConfig(tolerance=1e-15),
        path_config=JaxPathConfig(screen="strong", min_bucket=8),
        dtype=jnp.float64)
    hi = 0.95 * js.lambda_max() / ALPHA
    grid = np.geomspace(hi, hi / 30.0, LAMBDAS)
    ps = _port_solver()
    return ([lambda: [js.solve(lam) for lam in grid]],
            [lambda: [ps.solve(lam) for lam in grid]])


def _game_data(seed, n_users=30, d_g=6, d_u=4):
    rng = np.random.default_rng(seed)
    w_fixed = rng.normal(size=d_g)
    U = rng.normal(size=(n_users, d_u))
    xs, us, ys, ids = [], [], [], []
    for u in range(n_users):
        m = int(rng.integers(10, 24))
        xg, xu = rng.normal(size=(m, d_g)), rng.normal(size=(m, d_u))
        marg = xg @ w_fixed + xu @ U[u]
        ys.append((rng.random(m) < 1 / (1 + np.exp(-marg))).astype(float))
        xs.append(xg)
        us.append(xu)
        ids.append(np.full(m, u))
    xs, us, ys, ids = map(np.concatenate, (xs, us, ys, ids))
    return jax_dataset({"g": xs, "u": us}, ys, entity_ids={"userId": ids})


def _cd_configs(Config):
    return [Config("fixed", feature_shard="g", reg_type="l2",
                   reg_weight=2.0, max_iters=8, tolerance=0.0),
            Config("per-user", coordinate_type="random", feature_shard="u",
                   entity_column="userId", reg_type="l2", reg_weight=2.0,
                   tolerance=1e-6, optimizer="newton", num_buckets=1)]


def _cd_runs():
    """One sweep without validation (the JAX evaluators' compile would
    dominate the file's time)."""
    train = _game_data(0)
    ptrain = game_dataset_from_numpy(train)
    return (lambda: JaxCD(_cd_configs(JaxConfig), task="logistic",
                          n_iterations=1, dtype=jnp.float64).run(train),
            lambda: CoordinateDescent(
                _cd_configs(CoordinateConfig), task="logistic",
                n_iterations=1, dtype=torch.float64,
                device="cpu").run(ptrain))


def _traced(tmod, mmod, trace_dir, fn):
    """``fn()`` under a fresh tracer and fresh training metrics of one
    package: (result, the rank-0 trace document, the metrics snapshot)."""
    saved = mmod._TRAINING
    mmod._TRAINING = mmod.TrainingMetrics()
    tmod.start(str(trace_dir), export_thread=False)
    try:
        out = fn()
    finally:
        tmod.stop()
        snap = mmod._TRAINING.snapshot()
        mmod._TRAINING = saved
    with open(os.path.join(trace_dir, "trace-rank0.json")) as f:
        return out, json.load(f), snap


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs")
    (jpath,), (ppath,) = _path_walks()
    jcd, pcd = _cd_runs()
    out = {}
    for name, (jfn, pfn) in {"path": (jpath, ppath),
                             "cd": (jcd, pcd)}.items():
        out[name] = {
            "jax": _traced(jax_trace, jax_metrics, root / f"{name}-jax", jfn),
            "port": _traced(trace, metrics, root / f"{name}-port", pfn),
            "dirs": (root / f"{name}-jax", root / f"{name}-port")}
    return out


def _spans(doc):
    return [e for e in doc["traceEvents"] if e["ph"] == "X"]


def _parent(span, spans):
    """The innermost other span whose interval holds ``span``'s (any
    thread: a transfer thread's spans nest in the step that fed it)."""
    best = None
    for p in spans:
        if p is span or p["args"].get("trace_id") != \
                span["args"].get("trace_id"):
            continue
        if (p["ts"] - 0.01 <= span["ts"] and span["ts"] + span["dur"]
                <= p["ts"] + p["dur"] + 0.01 and p["dur"] >= span["dur"]):
            if best is None or p["dur"] < best["dur"]:
                best = p
    return None if best is None else best["name"]


def _shape(doc, skip=()):
    spans = _spans(doc)
    return [(s["name"], s["cat"], _parent(s, spans),
             sorted(k for k in s["args"] if k != "trace_id"))
            for s in spans if s["name"] not in skip]


def test_path_walk_spans_and_metrics_match_jax(runs):
    (jw, jdoc, jsnap), (pw, pdoc, psnap) = runs["path"]["jax"], \
        runs["path"]["port"]
    assert _shape(pdoc) == _shape(jdoc)
    assert [s["name"] for s in _spans(pdoc)] == ["glm.path_lambda"] * LAMBDAS
    for js, ps in zip(_spans(jdoc), _spans(pdoc)):
        for key in SCREEN_ARGS:
            assert ps["args"][key] == js["args"][key], key
        for key in ("lam", "l1", "l2"):
            assert ps["args"][key] == pytest.approx(js["args"][key],
                                                    rel=1e-12)
    assert psnap == jsnap
    assert psnap["photon_train_path_lambdas_total"] == {"": LAMBDAS}


def _counts(snap):
    """Counters as they are, histograms by their count (seconds differ)."""
    return {name: {k: (v["count"] if isinstance(v, dict) else v)
                   for k, v in vals.items()}
            for name, vals in snap.items()
            if "seconds_total" not in name}


def test_cd_sweep_spans_and_metrics_match_jax(runs):
    (_, jdoc, jsnap), (_, pdoc, psnap) = runs["cd"]["jax"], \
        runs["cd"]["port"]
    assert _shape(pdoc) == _shape(jdoc)
    coords = [(s["args"]["coordinate"], s["args"]["iteration"])
              for s in _spans(pdoc) if s["name"] == "cd.coordinate"]
    assert coords == [("fixed", 0), ("per-user", 0)]
    assert _counts(psnap) == _counts(jsnap)
    assert psnap["photon_train_sweep_steps_total"] == {
        'coordinate="fixed"': 1.0, 'coordinate="per-user"': 1.0}


def test_streamed_sweep_uploads_nest_in_the_step(tmp_path):
    """A streamed fixed coordinate: the transfer thread's ``stream.upload``
    spans carry the step's trace id and nest in its ``cd.coordinate``
    span; the prefetch counters move."""
    configs = _cd_configs(CoordinateConfig)
    configs[0] = CoordinateConfig(
        "fixed", feature_shard="g", reg_type="l2", reg_weight=2.0,
        streaming=True, chunk_rows=128, max_iters=4, tolerance=0.0)
    _, doc, snap = _traced(trace, metrics, tmp_path, lambda: (
        CoordinateDescent(configs, task="logistic", n_iterations=1,
                          dtype=torch.float64, device="cpu")
        .run(game_dataset_from_numpy(_game_data(0)))))
    spans = _spans(doc)
    uploads = [s for s in spans if s["name"] == "stream.upload"]
    assert uploads and all(_parent(s, spans) == "cd.coordinate"
                           for s in uploads)
    steps = {s["tid"] for s in spans if s["name"] == "cd.coordinate"}
    assert steps.isdisjoint(s["tid"] for s in uploads)  # transfer threads
    assert snap["photon_train_prefetch_transfer_seconds_total"][""] > 0


def test_trace_files_merge_and_validate_across_packages(runs, tmp_path):
    """Each package's merge/validate reads the other's trace files; the
    two merges of the same files are equal."""
    jdir, pdir = runs["cd"]["dirs"]
    jfile, pfile = jdir / "trace-rank0.json", pdir / "trace-rank0.json"
    assert trace_cli.main(["validate", str(jfile)]) == 0
    assert jax_cli.main(["validate", str(pfile)]) == 0
    doc = json.loads(jfile.read_text())
    doc["metadata"]["rank"] = 1
    for e in doc["traceEvents"]:
        e["pid"] = 1
    other = tmp_path / "trace-rank1.json"
    other.write_text(json.dumps(doc))
    paths = [str(pfile), str(other)]
    assert trace_cli.merge_traces(paths) == jax_cli.merge_traces(paths)
    out = tmp_path / "merged.json"
    assert trace_cli.main(["merge", "--files", *paths, "-o", str(out)]) == 0
    assert trace_cli.validate_trace(json.loads(out.read_text())) == []
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X"}]}))
    assert trace_cli.main(["validate", str(bad)]) == 1
    assert trace_cli.validate_trace({"traceEvents": [{"ph": "X"}]}) == \
        jax_cli.validate_trace({"traceEvents": [{"ph": "X"}]})


def test_trace_cli_smoke_runs_two_simulated_ranks(tmp_path):
    """``python -m photon_ml_tpu_torch.obs.trace_cli smoke``: two simulated
    ranks exchange through the entity-shard allgather; the merged trace
    holds both ranks' collective spans."""
    assert trace_cli.main(["smoke", "--trace-dir", str(tmp_path)]) == 0
    merged = trace_cli.merge_traces(
        sorted(str(p) for p in tmp_path.glob("trace-rank*.json")))
    assert merged["metadata"]["ranks"] == [0, 1]
    assert merged["metadata"]["unaligned_ranks"] == []
    sites = {e["args"]["site"] for e in merged["traceEvents"]
             if e.get("cat") == "collective"}
    assert {"smoke:0", "smoke:1", "barrier:smoke:0"} <= sites


def test_metrics_expositions_match_jax():
    t, jt = metrics.TrainingMetrics(), jax_metrics.TrainingMetrics()
    s, js = metrics.ServingMetrics(), jax_metrics.ServingMetrics()
    for m in (t, jt):
        m.record_step("fixed", 0.02, 0.003, 0.0)
        m.record_step('per "user"', 1.5, 0.2, 0.01)
        m.record_chunk_cache_pass("warm")
        m.record_chunk_cache_pass("cold")
        m.record_prefetch(0.5, 1.25, 0.75)
        m.record_path_lambda(3, 2, 1, 4, True)
        m.record_exchange(100, 300, 0.5)
    for m in (s, js):
        m.record_request(3, 4.2, queue_wait_ms=1.0, compute_ms=3.0)
        m.record_batch(3, 8, 3.5)
        m.record_compile(hit=False)
        m.record_compile(hit=True)
        m.record_coeff(hits=2, misses=1, evictions=1)
        m.record_paged(installs=4, page_evictions=1, faults=2)
        m.record_shed("deadline")
        m.record_degraded(1, 2)
        m.record_deadline_drop("queue")
        m.record_membership(prefetch_entities=2, evictions=1)
        m.set_membership_epoch(3)
        m.record_swap("v2", 12.0)
    assert t.render() == jt.render() and t.snapshot() == jt.snapshot()
    assert s.render() == js.render() and s.snapshot() == js.snapshot()
    h, jh = metrics.Histogram(), jax_metrics.Histogram()
    for v in (0.1, 3.0, 7.0, 7000.0):
        h.observe(v)
        jh.observe(v)
    assert [h.quantile(q) for q in (0.5, 0.9, 0.99)] == \
        [jh.quantile(q) for q in (0.5, 0.9, 0.99)]


def test_spans_cost_nothing_when_off_and_sampling_drops_whole_traces(
        tmp_path):
    assert not trace.enabled()
    assert trace.span("x") is trace.span("y")  # the shared null span
    trace.start(str(tmp_path), sample=0.0, export_thread=False)
    try:
        with trace.span("root"):
            with trace.span("child", cat="train", k=1):
                pass
        with trace.use_context(trace.TraceContext(request_id="r1")):
            with trace.span("kept") as sp:
                sp.set(rows=3)
            assert trace.current_request_id() == "r1"
    finally:
        trace.stop()
    (ev,) = _spans(json.loads((tmp_path / "trace-rank0.json").read_text()))
    assert ev["name"] == "kept" and ev["args"]["rows"] == 3
    assert ev["args"]["request_id"] == "r1"


def test_structured_log_records_carry_rank_and_trace(tmp_path):
    logger = obs_logging.configure(level=logging.INFO)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    handler.addFilter(obs_logging.ContextFilter())
    logger.addHandler(handler)
    try:
        with trace.use_context(trace.TraceContext(trace_id="t1",
                                                  request_id="q1")):
            logging.getLogger("photon_ml_tpu_torch.x").info("hello")
        logging.getLogger("photon_ml_tpu_torch.x").info("bare")
    finally:
        logger.removeHandler(handler)
    assert [(r.rank, r.trace_id, r.request_id) for r in records] == \
        [(0, "t1", "q1"), (0, "-", "-")]
    # the configured handler formats a child logger's record too
    (configured,) = [h for h in logger.handlers
                     if getattr(h, "_photon_obs_handler", False)]
    old = configured.setStream(io.StringIO())
    try:
        logging.getLogger("photon_ml_tpu_torch.x").info("child")
        written = configured.stream.getvalue()
    finally:
        configured.setStream(old)
    assert "rank=0 trace=- req=- photon_ml_tpu_torch.x: child" in written
    slow = obs_logging.SlowRequestLog(top_n=2)
    for i, ms in enumerate((5.0, 1.0, 9.0)):
        slow.note(f"r{i}", ms, rows=1)
    assert [e["request_id"] for e in slow.snapshot()] == ["r2", "r0"]


def test_profile_trace_writes_chrome_trace_and_raises_when_unwritable(
        tmp_path):
    with profile_trace(str(tmp_path / "prof")):
        with annotate("photon.block"):
            torch.ones(8).sum()
    (path,) = (tmp_path / "prof").glob("profile-pid*.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "photon.block" in names
    with profile_trace(None):  # no-op
        pass
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(OSError):
        with profile_trace(str(blocker / "prof")):
            pass


def test_path_solver_counts_launches_and_host_reads(monkeypatch):
    """In place of XLA compile counts: the walk's kernel launches (here the
    plain version, counted as the kernel would be) and host reads, equal
    for two identical walks; a fit's launches on its result."""
    real_plain = kernels.csc_column_sums_plain

    def counted(csc, d):
        kernels.csc_column_sums.launches += 1
        return real_plain(csc, d)

    monkeypatch.setattr(kernels, "csc_column_sums_plain", counted)
    solves = []
    real_fit = path_mod.fit_shard
    monkeypatch.setattr(path_mod, "fit_shard", lambda *a, **k: solves.append(
        real_fit(*a, **k)) or solves[-1])
    batch = _port_batch()
    walks = []
    for _ in range(2):
        solver = _port_solver(batch)
        grid = np.geomspace(solver.lambda_max(), solver.lambda_max() / 30,
                            LAMBDAS)
        before = kernels.csc_column_sums.launches
        solves.clear()
        stats = [solver.solve(lam)[1] for lam in grid]
        launched = kernels.csc_column_sums.launches - before
        assert solver.kernel_launches == launched > 0
        assert solver.host_reads >= sum(r.host_syncs for r in solves) \
            + LAMBDAS
        assert sum(s.full_grad_passes for s in stats) <= launched
        walks.append((solver.kernel_launches, solver.host_reads))
    assert walks[0] == walks[1]
    objective = make_objective("logistic")
    for opt in ("lbfgs", "tron"):
        before = kernels.csc_column_sums.launches
        res = data_parallel.fit_distributed(
            objective, batch, torch.zeros(batch.dim, dtype=torch.float64),
            l2=1.0, optimizer=opt, config=OptimizerConfig(max_iters=4,
                                                          tolerance=0.0))
        assert res.kernel_launches == \
            kernels.csc_column_sums.launches - before > 0
        assert res.host_syncs > 0


def test_random_effect_solves_count_host_reads():
    from photon_ml_tpu_torch.game.data import build_random_effect_data

    r = np.random.default_rng(3)
    n, d = 300, 4
    x = r.normal(size=(n, d))
    data = build_random_effect_data(
        x, (r.random(n) < 0.5).astype(float), np.ones(n),
        r.integers(0, 20, n), num_buckets=1)
    for optimizer in ("newton", "lbfgs"):
        before = re_solver_host_reads()
        res = train_random_effect(
            data, np.zeros(n), l2=1.0, optimizer=optimizer,
            config=OptimizerConfig(max_iters=6, tolerance=0.0),
            dtype=torch.float64, device="cpu")
        reads = re_solver_host_reads() - before
        if optimizer == "newton":  # one per iteration, one to stop
            assert reads == sum(int(it.max()) + 1 for it in res.iterations)
        else:
            assert reads > 0


def _write_svm(path, seed, n=300, d=20):
    r = np.random.default_rng(seed)
    w = r.normal(size=d)
    with open(path, "w") as f:
        for _ in range(n):
            cols = np.sort(r.choice(d, 5, replace=False))
            vals = r.normal(size=5)
            y = int(r.random() < 1 / (1 + np.exp(-(vals * w[cols]).sum())))
            f.write(f"{y} " + " ".join(f"{c + 1}:{v:.6f}"
                                       for c, v in zip(cols, vals)) + "\n")


def _same_tree(a, b):
    import filecmp

    for dirpath, _, files in os.walk(a):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), a)
            assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                               shallow=False), rel


def test_glm_driver_trace_and_profile_dirs(tmp_path):
    """The GLM driver's screened path with ``--trace-dir`` and
    ``--profile-dir``: one valid trace file with a ``glm.path_lambda`` span
    per lambda, a profile, models byte-identical to the untraced run's,
    and each lambda's logged launches and host reads equal to its."""
    _write_svm(tmp_path / "train.svm", 0)
    grid = ["1", "0.1", "0.01"]
    argv = ["--train-data", str(tmp_path / "train.svm"), "--input-format",
            "libsvm", "--reg-type", "elastic_net", "--path-screen", "strong",
            "--reg-weights", *grid, "--device", "cpu"]
    assert glm_driver.main(argv + ["--output-dir", str(tmp_path / "a")]) \
        == 0
    assert glm_driver.main(argv + [
        "--output-dir", str(tmp_path / "b"), "--trace-dir",
        str(tmp_path / "tr"), "--trace-sample", "1", "--profile-dir",
        str(tmp_path / "prof")]) == 0
    assert not trace.enabled()
    for sub in ("best", "all"):
        _same_tree(tmp_path / "a" / sub, tmp_path / "b" / sub)
    costs = []
    for run in ("a", "b"):
        with open(tmp_path / run / "photon.log.jsonl") as f:
            costs.append([(e["kernel_launches"], e["host_reads"])
                          for e in map(json.loads, f)
                          if e["event"] == "lambda_trained"])
    assert costs[0] == costs[1] and len(costs[0]) == len(grid)
    assert all(reads > 0 for _, reads in costs[0])
    trace_file = tmp_path / "tr" / "trace-rank0.json"
    assert trace_cli.main(["validate", str(trace_file)]) == 0
    spans = _spans(json.loads(trace_file.read_text()))
    assert [s["name"] for s in spans] == ["glm.path_lambda"] * len(grid)
    assert [s["args"]["lam"] for s in spans] == [float(g) for g in grid]
    (prof,) = (tmp_path / "prof").glob("profile-pid*.json")
    assert json.loads(prof.read_text())["traceEvents"]
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    with pytest.raises(OSError):
        glm_driver.main(argv + ["--output-dir", str(tmp_path / "c"),
                                "--profile-dir", str(blocker / "p")])


def test_game_driver_trace_and_profile_dirs(tmp_path, monkeypatch):
    """The GAME training driver with ``--trace-dir``, ``--trace-sample`` and
    ``--profile-dir``: a ``cd.coordinate`` span per coordinate per sweep,
    a profile, and models byte-identical to the untraced run's;
    ``PHOTON_TRACE`` starts the tracer without the flag."""
    from photon_ml_tpu_torch.io.data_reader import write_training_examples

    r = np.random.default_rng(3)
    n, dim = 400, 16
    x = (r.random((n, dim)) < 0.3) * r.normal(size=(n, dim))
    users = r.integers(0, 12, n)
    y = (r.random(n) < 1 / (1 + np.exp(-x @ r.normal(size=dim)))).astype(
        float)
    write_training_examples(
        str(tmp_path / "train.avro"),
        ([(f"f{j}", "", float(x[i, j])) for j in np.nonzero(x[i])[0]]
         for i in range(n)), y, entity_ids={"user": users})
    coords = json.dumps([
        {"name": "fixed", "reg_type": "l2", "reg_weight": 1.0,
         "max_iters": 5},
        {"name": "per_user", "coordinate_type": "random",
         "entity_column": "user", "reg_type": "l2", "reg_weight": 1.0,
         "max_iters": 3}])
    argv = ["--train-data", str(tmp_path / "train.avro"), "--coordinates",
            coords, "--n-iterations", "2", "--device", "cpu"]
    assert game_training_driver.main(
        argv + ["--output-dir", str(tmp_path / "a")]) == 0
    monkeypatch.setenv("PHOTON_TRACE", str(tmp_path / "env"))
    assert game_training_driver.main(argv + [
        "--output-dir", str(tmp_path / "b"), "--trace-dir",
        str(tmp_path / "tr"), "--trace-sample", "1.0", "--profile-dir",
        str(tmp_path / "prof")]) == 0
    _same_tree(tmp_path / "a" / "best", tmp_path / "b" / "best")
    spans = _spans(json.loads((tmp_path / "tr" / "trace-rank0.json")
                              .read_text()))
    steps = [(s["args"]["iteration"], s["args"]["coordinate"])
             for s in spans if s["name"] == "cd.coordinate"]
    assert steps == [(0, "fixed"), (0, "per_user"), (1, "fixed"),
                     (1, "per_user")]
    assert list((tmp_path / "prof").glob("profile-pid*.json"))
    assert not (tmp_path / "env").exists()  # the flag wins
    assert game_training_driver.main(
        argv + ["--output-dir", str(tmp_path / "c")]) == 0
    env_spans = _spans(json.loads((tmp_path / "env" / "trace-rank0.json")
                                  .read_text()))
    assert sum(s["name"] == "cd.coordinate" for s in env_spans) == 4
