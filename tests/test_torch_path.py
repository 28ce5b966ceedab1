"""The port's pathwise solver (``photon_ml_tpu_torch/optimize/path.py``),
its estimator and the GLM driver's ``--path-screen`` against the JAX
package, at float64 on the CPU.

The JAX walks run once per module. Tolerances: ``w`` within 1e-6 relative
L2 of JAX's per lambda, with identical supports, candidate sets, KKT rounds
and restricted widths (the two packages sum in different orders; the
certificate is exact); within the port, screened and unscreened walks
agree to 1e-7 max-abs per lambda (the stopping rule's floor at tolerance
1e-15, as in ``tests/test_path.py``)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli.glm_driver import main as jax_driver
from photon_ml_tpu.ops.objective import make_objective as jax_objective
from photon_ml_tpu.ops.regularization import (
    RegularizationContext as JaxReg,
)
from photon_ml_tpu.optimize import (
    OptimizerConfig as JaxConfig, PathConfig as JaxPathConfig,
    PathSolver as JaxPathSolver,
)
from photon_ml_tpu.parallel.mesh import make_mesh
from photon_ml_tpu.types import (
    SparseFeatures as JaxSparse, make_batch as jax_batch,
)
from photon_ml_tpu_torch.cli import glm_driver
from photon_ml_tpu_torch.estimators import GlmPathEstimator
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import kkt_residuals, make_objective
from photon_ml_tpu_torch.ops.regularization import (
    RegularizationContext, kkt_slack,
)
from photon_ml_tpu_torch.optimize import OptimizerConfig, PathConfig
from photon_ml_tpu_torch.optimize.path import (
    PathSolver, next_power_of_two, pad_to_bucket,
)
from photon_ml_tpu_torch.types import SparseFeatures, make_batch

TOL_JAX = 1e-6
TOL_SCREEN = 1e-7
ALPHA = 0.9


def _dense_problem(n=400, d=24, seed=0, support=4):
    """Dense logistic problem with a sparse ground truth (column 0 is the
    intercept), mean-loss weights: numpy arrays."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, d))
    x[:, 0] = 1.0
    w = np.zeros(d)
    w[r.choice(np.arange(1, d), size=support, replace=False)] = \
        r.normal(size=support) * 2.0
    w[0] = 0.25
    y = (r.random(n) < 1.0 / (1.0 + np.exp(-(x @ w)))).astype(np.float64)
    return x, y, np.ones(n) / n


def _sparse_problem(n=600, d=64, k=6, seed=1):
    """ELL sparse problem: (indices, values) with the intercept in the last
    slot of every row (column 0)."""
    r = np.random.default_rng(seed)
    idx = r.integers(1, d, (n, k)).astype(np.int32)
    idx[:, -1] = 0
    vals = r.normal(size=(n, k))
    vals[:, -1] = 1.0
    w = np.zeros(d)
    w[r.choice(np.arange(1, d), 6, replace=False)] = r.normal(size=6) * 2.0
    m = (vals * w[idx]).sum(1)
    y = (r.random(n) < 1.0 / (1.0 + np.exp(-m))).astype(np.float64)
    return idx, vals, y, np.ones(n) / n, d


def _port_solver(batch, screen, **pc):
    return PathSolver(
        make_objective("logistic", None, False, 0),
        RegularizationContext("elastic_net", alpha=ALPHA), batch=batch,
        optimizer="auto", config=OptimizerConfig(tolerance=1e-15),
        path_config=PathConfig(screen=screen, min_bucket=8, **pc))


def _jax_solver(batch, screen):
    return JaxPathSolver(
        jax_objective("logistic", None, False, 0), JaxReg("elastic_net",
                                                          alpha=ALPHA),
        batch=batch, mesh=make_mesh(), optimizer="auto",
        config=JaxConfig(tolerance=1e-15),
        path_config=JaxPathConfig(screen=screen, min_bucket=8),
        dtype=jnp.float64)


def _grid(lmax, n=8, span=30.0):
    hi = 0.95 * lmax / ALPHA
    return np.geomspace(hi, hi / span, n)


def _batches(kind):
    if kind == "dense":
        x, y, wts = _dense_problem()
        return (jax_batch(jnp.asarray(x), y, np.zeros(len(y)), wts,
                          dtype=jnp.float64),
                make_batch(x, y, np.zeros(len(y)), wts, dtype=torch.float64,
                           device="cpu"))
    idx, vals, y, wts, d = _sparse_problem()
    return (jax_batch(JaxSparse(jnp.asarray(idx), jnp.asarray(vals), d), y,
                      np.zeros(len(y)), wts, dtype=jnp.float64),
            make_batch(SparseFeatures(torch.from_numpy(idx),
                                      torch.from_numpy(vals), d),
                       y, np.zeros(len(y)), wts, dtype=torch.float64,
                       device="cpu"))


_WALKS = {}


def _walks(kind, rule):
    """(grid, JAX [(w, stats)], port [(w, stats)]) for one problem and
    rule, each walked once per module."""
    key = (kind, rule)
    if key not in _WALKS:
        jb, pb = _batches(kind)
        js, ps = _jax_solver(jb, rule), _port_solver(pb, rule)
        assert ps.lambda_max() == pytest.approx(js.lambda_max(), rel=1e-12)
        grid = _grid(js.lambda_max(), n=8 if kind == "dense" else 5)
        jw, pw = [], []
        for lam in grid:
            rj, sj = js.solve(lam)
            rp, sp = ps.solve(lam)
            jw.append((np.asarray(rj.w), sj))
            pw.append((rp.w.numpy(), sp))
        _WALKS[key] = (grid, jw, pw)
    return _WALKS[key]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("kind, rule", [("dense", "strong"),
                                        ("dense", "safe"),
                                        ("sparse", "strong")])
def test_path_matches_jax_per_lambda(kind, rule):
    grid, jw, pw = _walks(kind, rule)
    screened = False
    for lam, (wj, sj), (wp, sp) in zip(grid, jw, pw):
        assert sp.certified and sj.certified
        np.testing.assert_array_equal(wp != 0, wj != 0)
        assert _rel(wp, wj) <= TOL_JAX, f"lambda={lam}"
        assert (sp.kkt_rounds, sp.candidate_size, sp.screened_dim,
                sp.features_frozen, sp.kkt_violations, sp.full_grad_passes) \
            == (sj.kkt_rounds, sj.candidate_size, sj.screened_dim,
                sj.features_frozen, sj.kkt_violations, sj.full_grad_passes)
        assert set(sp.as_dict()) == set(sj.as_dict())
        screened = screened or sp.features_frozen > 0
    assert screened or rule == "safe"


_REF = {}


def _ref_path():
    """The port's unscreened warm walk from an anchor solve (as
    ``tests/test_path.py``'s reference)."""
    if not _REF:
        batch = _batches("dense")[1]
        ref = _port_solver(batch, "off")
        grid = _grid(ref.lambda_max())
        anchor = 1.3 * grid[0]
        res_a, _ = ref.solve(anchor)
        sols = [ref.solve(lam)[0].w.numpy() for lam in grid]
        _REF.update(batch=batch, grid=grid, anchor=anchor,
                    w_anchor=res_a.w, sols=sols)
    return _REF


@pytest.mark.parametrize("rule", ["strong", "safe"])
def test_screened_matches_unscreened_per_lambda(rule):
    ref = _ref_path()
    ps = _port_solver(ref["batch"], rule)
    ps.seed_state(ref["anchor"], ref["w_anchor"])
    screened_any = False
    for lam, wo in zip(ref["grid"], ref["sols"]):
        res, st = ps.solve(lam)
        ws = res.w.numpy()
        assert st.certified
        np.testing.assert_array_equal(ws != 0, wo != 0)
        assert float(np.max(np.abs(ws - wo))) <= TOL_SCREEN
        assert res.screened_dim == st.screened_dim
        assert res.solver_tolerance == pytest.approx(1e-15)
        if st.features_frozen > 0:
            screened_any = True
            assert st.screened_dim < st.dim
    assert screened_any


def test_adversarial_overscreen_repaired():
    """``screen_slack`` freezes active features on purpose; the KKT check
    re-admits them and the walk still lands on the unscreened solutions."""
    ref = _ref_path()
    ps = _port_solver(ref["batch"], "strong", screen_slack=50.0)
    violations = 0
    for lam, wo in zip(ref["grid"], ref["sols"]):
        res, st = ps.solve(lam)
        assert st.certified
        violations += st.kkt_violations
        assert float(np.max(np.abs(res.w.numpy() - wo))) <= 1e-6
    assert violations > 0


def test_certified_solution_satisfies_kkt_residuals():
    ref = _ref_path()
    ps = _port_solver(ref["batch"], "strong")
    lam = float(ref["grid"][2])
    res, _ = ps.solve(lam)
    g = ps._full_grad(res.w)
    l1 = ALPHA * lam
    mask = torch.ones_like(res.w)
    mask[0] = 0.0  # unpenalized intercept
    r = kkt_residuals(res.w, g, l1, mask)
    at_zero = (res.w == 0) & (mask > 0)
    assert bool(at_zero.any())
    assert float(r[at_zero].max()) <= kkt_slack(l1, 1e-6) + 1e-12


def test_out_of_order_solves_share_warm_states():
    x, y, wts = _dense_problem(d=32, support=10)
    batch = make_batch(x, y, np.zeros(len(y)), wts, dtype=torch.float64,
                       device="cpu")
    shared = _port_solver(batch, "strong")
    grid = _grid(shared.lambda_max(), n=6, span=200.0)
    for lam in grid:
        shared.solve(lam)
    before = shared.total_iterations
    lam_mid = float(np.sqrt(grid[-2] * grid[-1]))
    _, st = shared.solve(lam_mid)
    warm_cost = shared.total_iterations - before
    cold = _port_solver(batch, "strong")
    _, st_cold = cold.solve(lam_mid)
    assert st.certified and st_cold.certified
    assert warm_cost < cold.total_iterations


def test_reset_states_repeats_the_walk():
    batch = _batches("sparse")[1]
    ps = _port_solver(batch, "strong")
    grid = _grid(ps.lambda_max(), n=3)
    first = [ps.solve(lam)[0].w for lam in grid]
    ps.reset_states()
    again = [ps.solve(lam)[0].w for lam in grid]
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_glm_path_estimator_fit_and_select_best():
    """The estimator walks the grid through one solver (its results are
    the solver's own), scores validation data and selects the best AUC."""
    x, y, wts = _dense_problem(n=600)
    train = make_batch(x[:400], y[:400], None, wts[:400],
                       dtype=torch.float64, device="cpu")
    val = make_batch(x[400:], y[400:], None, None, dtype=torch.float64,
                     device="cpu")
    est = GlmPathEstimator(reg_type="elastic_net", elastic_net_alpha=ALPHA,
                           evaluators=["auc"], intercept_index=0,
                           device="cpu",
                           config=OptimizerConfig(tolerance=1e-12),
                           path_config=PathConfig(min_bucket=8))
    grid = _grid(est.solver(batch=train).lambda_max(), n=5)
    results = est.fit(grid, batch=train, validation_batch=val)
    ref = PathSolver(make_objective("logistic", intercept_index=0),
                     RegularizationContext("elastic_net", alpha=ALPHA),
                     batch=train, optimizer="auto",
                     config=OptimizerConfig(tolerance=1e-12),
                     path_config=PathConfig(min_bucket=8))
    for r, lam in zip(results, grid):
        assert r.reg_weight == float(lam) and r.stats.certified
        assert 0.5 < r.metrics["auc"] <= 1.0
        assert torch.equal(r.result.w, ref.solve(lam)[0].w)
    best = est.select_best(results)
    assert best.metrics["auc"] == max(r.metrics["auc"] for r in results)
    with pytest.raises(ValueError, match="no fit results"):
        est.select_best([])


def test_normalization_and_chunks_refused(tmp_path):
    batch = _batches("dense")[1]
    norm = NormalizationContext(torch.ones(24, dtype=torch.float64), None, 0)
    obj = make_objective("logistic", norm, False, 0)
    reg = RegularizationContext("elastic_net", alpha=ALPHA)
    with pytest.raises(ValueError, match="normalization"):
        PathSolver(obj, reg, batch=batch, path_config=PathConfig("strong"))
    PathSolver(obj, reg, batch=batch, path_config=PathConfig("off"))
    with pytest.raises(ValueError, match="needs dim"):
        PathSolver(make_objective("logistic"), reg, chunks=[])
    with pytest.raises(ValueError, match="exactly one"):
        PathSolver(make_objective("logistic"), reg, chunks=[], batch=batch)
    with pytest.raises(ValueError, match="normalization"):
        PathSolver(obj, reg, chunks=[], dim=24,
                   path_config=PathConfig("strong"), device="cpu")
    with pytest.raises(SystemExit, match="--normalization"):
        glm_driver.main(["--train-data", "absent.svm", "--input-format",
                         "libsvm", "--output-dir", str(tmp_path / "o"),
                         "--device", "cpu", "--path-screen", "strong",
                         "--normalization", "standardization"])


def test_bucket_ladder():
    assert [next_power_of_two(n) for n in (0, 1, 2, 3, 64, 65)] == \
        [1, 1, 2, 4, 64, 128]
    assert pad_to_bucket(3, 64) == 64 and pad_to_bucket(100, 64) == 128


def _write_libsvm(path, x, y):
    with open(path, "w") as f:
        for i in range(x.shape[0]):
            toks = [f"{int(y[i]) * 2 - 1}"]
            toks += [f"{j + 1}:{x[i, j]:.6f}" for j in np.nonzero(x[i])[0]]
            f.write(" ".join(toks) + "\n")


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """The JAX driver with --path-screen strong, and the port's with strong
    and off, on one LIBSVM fixture (float64, elastic net)."""
    root = tmp_path_factory.mktemp("path_driver")
    r = np.random.default_rng(3)
    n, d = 400, 30
    x = (r.random((n, d)) < 0.5) * r.normal(size=(n, d))
    w = np.zeros(d)
    w[:4] = [2.0, -1.5, 1.0, 0.8]
    y = (r.random(n) < 1 / (1 + np.exp(-(x @ w)))).astype(float)
    _write_libsvm(root / "train.svm", x[:300], y[:300])
    _write_libsvm(root / "val.svm", x[300:], y[300:])
    common = ["--train-data", str(root / "train.svm"), "--validation-data",
              str(root / "val.svm"), "--input-format", "libsvm",
              "--reg-type", "elastic_net", "--elastic-net-alpha", "0.9",
              "--reg-weights", "40", "20", "10", "5", "--dtype", "float64",
              "--tolerance", "1e-12", "--max-iters", "200",
              "--path-min-bucket", "8"]
    outs = {}
    for name, main, extra in (
            ("jax", jax_driver, ["--path-screen", "strong"]),
            ("strong", glm_driver.main, ["--path-screen", "strong",
                                         "--device", "cpu"]),
            ("off", glm_driver.main, ["--device", "cpu"])):
        out = str(root / name)
        assert main(common + extra + ["--output-dir", out]) == 0
        with open(os.path.join(out, "photon.log.jsonl")) as f:
            outs[name] = [e for e in map(json.loads, f)
                          if e["event"] == "lambda_trained"]
    return outs


def test_driver_path_screen_matches_off_and_jax(driver_runs):
    jax_l, strong, off = (driver_runs[k] for k in ("jax", "strong", "off"))
    assert len(jax_l) == len(strong) == len(off) == 4
    for ej, es, eo in zip(jax_l, strong, off):
        assert es["path"]["certified"] and "path" not in eo
        assert set(es["path"]) == set(ej["path"])
        for key in ("candidate_size", "screened_dim", "kkt_rounds",
                    "features_frozen"):
            assert es["path"][key] == ej["path"][key], key
        assert es["screened_dim"] == ej["screened_dim"]
        assert eo["screened_dim"] == 31  # 30 features + the intercept
        assert abs(es["metrics"]["auc"] - ej["metrics"]["auc"]) <= 1e-6
        assert abs(es["metrics"]["auc"] - eo["metrics"]["auc"]) <= 1e-6
        assert es["loss"] == pytest.approx(ej["loss"], rel=1e-9)
        assert es["loss"] == pytest.approx(eo["loss"], rel=1e-9)


def test_chunks_path_matches_jax_chunks_path():
    """The out-of-core mode: both packages walk the sparse problem's path
    over host chunks of 256 rows (streamed restricted solves through
    ``_RestrictedChunks``, streamed certification passes); per lambda the
    same screening record, supports equal and ``w`` within 1e-6."""
    from photon_ml_tpu.game.data import HostSparse as JaxHostSparse
    from photon_ml_tpu.parallel.streaming import (
        make_host_chunks as jax_chunks,
    )
    from photon_ml_tpu_torch.game.data import HostSparse
    from photon_ml_tpu_torch.parallel.streaming import make_host_chunks

    idx, vals, y, wts, d = _sparse_problem()
    zeros = np.zeros(len(y))
    jc, _ = jax_chunks(JaxHostSparse(idx, vals, d), y, zeros, wts,
                       chunk_rows=256)
    pc, _ = make_host_chunks(HostSparse(idx, vals, d), y, zeros, wts,
                             chunk_rows=256)
    cfg = dict(tolerance=1e-12, max_iters=40)
    js = JaxPathSolver(
        jax_objective("logistic", None, False, 0),
        JaxReg("elastic_net", alpha=ALPHA), chunks=jc, dim=d,
        optimizer="auto", config=JaxConfig(**cfg),
        path_config=JaxPathConfig(screen="strong", min_bucket=8),
        dtype=jnp.float64)
    ps = PathSolver(
        make_objective("logistic", None, False, 0),
        RegularizationContext("elastic_net", alpha=ALPHA), chunks=pc, dim=d,
        optimizer="auto", config=OptimizerConfig(**cfg),
        path_config=PathConfig(screen="strong", min_bucket=8),
        dtype=torch.float64, device="cpu")
    assert ps.lambda_max() == pytest.approx(js.lambda_max(), rel=1e-12)
    screened = False
    for lam in _grid(js.lambda_max(), n=3):
        rj, sj = js.solve(lam)
        rp, sp = ps.solve(lam)
        wj, wp = np.asarray(rj.w), rp.w.numpy()
        assert sp.certified and sj.certified
        np.testing.assert_array_equal(wp != 0, wj != 0)
        assert _rel(wp, wj) <= TOL_JAX, f"lambda={lam}"
        assert (sp.candidate_size, sp.screened_dim, sp.kkt_rounds) == \
            (sj.candidate_size, sj.screened_dim, sj.kkt_rounds)
        assert rp.stream_stats is not None
        screened = screened or sp.features_frozen > 0
    assert screened
