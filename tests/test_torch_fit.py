"""Parity of the port's optimizers and its fit with the JAX package: the
two-loop direction, the strong-Wolfe search, and whole ``fit_distributed``
runs against JAX's ``fit_distributed(..., sparse_grad="csc_pallas")`` on a
one-device mesh (the Pallas kernel in interpret mode). Tolerances: rtol
1e-8 at f64 and 1e-4 at f32 for the fits (two packages, two summation
orders, compounded over the iterations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.objective import make_objective as j_make_objective
from photon_ml_tpu.optimize import OptimizerConfig as JConfig
from photon_ml_tpu.optimize.lbfgs import lbfgs as j_lbfgs
from photon_ml_tpu.optimize.lbfgs import two_loop_direction as j_two_loop
from photon_ml_tpu.optimize.linesearch import strong_wolfe as j_strong_wolfe
from photon_ml_tpu.parallel.data_parallel import fit_distributed as j_fit
from photon_ml_tpu.parallel.mesh import make_mesh
from photon_ml_tpu.types import LabeledBatch as JBatch
from photon_ml_tpu.types import SparseFeatures as JSparse
from photon_ml_tpu_torch.interop import batch_from_numpy, w_to_numpy
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.optimize.common import OptimizerConfig
from photon_ml_tpu_torch.optimize.lbfgs import lbfgs, two_loop_direction
from photon_ml_tpu_torch.optimize.linesearch import strong_wolfe
from photon_ml_tpu_torch.parallel.data_parallel import (
    build_csc, fit_distributed,
)

RTOL = {"float64": 1e-8, "float32": 1e-4}


@pytest.mark.parametrize("k", [0, 1, 3, 5, 8])
def test_two_loop_direction_matches(k):
    """m = 5 slots; k = 8 wraps the circular buffer."""
    r = np.random.default_rng(k)
    m, d = 5, 16
    g = r.normal(size=d)
    s_hist, y_hist = r.normal(size=(m, d)), r.normal(size=(m, d))
    y_hist = s_hist + 0.1 * y_hist  # sy > 0, as stored pairs have
    rho = 1.0 / np.sum(s_hist * y_hist, axis=1)
    want = j_two_loop(jnp.asarray(g), jnp.asarray(s_hist), jnp.asarray(y_hist),
                      jnp.asarray(rho), jnp.asarray(k), m)
    got = two_loop_direction(torch.from_numpy(g), torch.from_numpy(s_hist),
                             torch.from_numpy(y_hist), torch.from_numpy(rho),
                             k, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def _logistic_fg(X, y):
    """(f, g) of an L2-regularized dense logistic loss, in each package."""
    def j_fg(w):
        m = jnp.asarray(X) @ w
        f = jnp.sum(jnp.logaddexp(0.0, m) - jnp.asarray(y) * m) + 0.5 * w @ w
        return f, jax.grad(lambda v: jnp.sum(
            jnp.logaddexp(0.0, jnp.asarray(X) @ v) - jnp.asarray(y)
            * (jnp.asarray(X) @ v)) + 0.5 * v @ v)(w)

    tX, ty = torch.from_numpy(X), torch.from_numpy(y)

    def t_fg(w):
        m = tX @ w
        f = torch.sum(torch.logaddexp(torch.zeros_like(m), m) - ty * m)
        return f + 0.5 * w @ w, tX.T @ (torch.sigmoid(m) - ty) + w

    return j_fg, t_fg


@pytest.mark.parametrize("alpha0", [1.0, 1e-3, 30.0])
def test_strong_wolfe_matches(alpha0):
    """alpha0 = 1 accepts at once, 1e-3 brackets outward, 30 zooms."""
    r = np.random.default_rng(3)
    X, y = r.normal(size=(60, 8)), (r.random(60) < 0.5).astype(float)
    j_fg, t_fg = _logistic_fg(X, y)
    w = r.normal(size=8)
    jf, jg = j_fg(jnp.asarray(w))
    p = -np.asarray(jg)
    want = j_strong_wolfe(j_fg, jnp.asarray(w), jnp.asarray(p), jf, jg,
                          alpha0=alpha0)
    tw = torch.from_numpy(w)
    tf, tg = t_fg(tw)
    got = strong_wolfe(t_fg, tw, torch.from_numpy(p), tf, tg, alpha0=alpha0)
    assert got.n_evals == int(want.n_evals)
    assert bool(got.ok) == bool(want.ok)
    for a, b in ((got.alpha, want.alpha), (got.f, want.f), (got.g, want.g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-10)


def test_lbfgs_matches():
    r = np.random.default_rng(4)
    X, y = r.normal(size=(80, 10)), (r.random(80) < 0.5).astype(float)
    j_fg, t_fg = _logistic_fg(X, y)
    want = jax.jit(lambda w: j_lbfgs(j_fg, w, JConfig(max_iters=15,
                                                      tolerance=1e-10)))(
        jnp.zeros(10))
    got = lbfgs(t_fg, torch.zeros(10, dtype=torch.float64),
                OptimizerConfig(max_iters=15, tolerance=1e-10))
    assert abs(got.iterations - int(want.iterations)) <= 1
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=1e-8,
                               atol=1e-10)


def _sparse_data(with_values, seed=5, n=2048, dim=256, k=8):
    r = np.random.default_rng(seed)
    idx = r.integers(0, dim, (n, k)).astype(np.int32)
    vals = r.normal(size=(n, k)) if with_values else None
    w_true = r.normal(size=dim) * 0.5
    logits = (w_true[idx] * (1.0 if vals is None else vals)).sum(1)
    y = (r.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(float)
    offsets = r.normal(scale=0.1, size=n) if with_values else None
    weights = None
    if with_values:  # weighted rows, some of them padding
        weights = r.random(n) + 0.5
        weights[::29] = 0.0
    return idx, vals, y, offsets, weights, dim


def _fit_pair(dtype, with_values, tol, max_iters=10):
    idx, vals, y, offsets, weights, dim = _sparse_data(with_values)
    jdt = getattr(jnp, dtype)
    n = idx.shape[0]
    jb = JBatch(
        JSparse(jnp.asarray(idx), None if vals is None
                else jnp.asarray(vals, jdt), dim=dim),
        jnp.asarray(y, jdt),
        jnp.asarray(np.zeros(n) if offsets is None else offsets, jdt),
        jnp.asarray(np.ones(n) if weights is None else weights, jdt))
    want = j_fit(j_make_objective("logistic"), jb,
                 make_mesh(devices=jax.devices()[:1]), jnp.zeros(dim, jdt),
                 l2=1.0, config=JConfig(max_iters=max_iters, tolerance=tol),
                 sparse_grad="csc_pallas")
    tb = batch_from_numpy(idx, vals, y, offsets, weights, dim=dim,
                          dtype=getattr(torch, dtype), device="cpu")
    got = fit_distributed(make_objective("logistic"), tb,
                          torch.zeros(dim, dtype=getattr(torch, dtype)),
                          l2=1.0, config=OptimizerConfig(max_iters=max_iters,
                                                         tolerance=tol),
                          sparse_grad="csc_kernel")
    return got, want


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fit_matches_jax_csc_pallas(dtype, with_values):
    """n=2048, d=256, k=8, l2=1, 10 iterations at tolerance 0."""
    got, want = _fit_pair(dtype, with_values, tol=0.0)
    rtol = RTOL[dtype]
    assert got.iterations == int(want.iterations) == 10
    np.testing.assert_allclose(w_to_numpy(got.w), np.asarray(want.w),
                               rtol=rtol, atol=rtol * np.abs(want.w).max())
    np.testing.assert_allclose(float(got.value), float(want.value), rtol=rtol)
    np.testing.assert_allclose(got.loss_history.numpy(),
                               np.asarray(want.loss_history), rtol=rtol)
    # one read per line-search trial plus one per iteration
    assert got.host_syncs >= 2 * got.iterations


def test_converged_fit_matches_jax():
    got, want = _fit_pair("float64", False, tol=1e-9, max_iters=100)
    assert bool(want.converged) and got.converged
    assert abs(got.iterations - int(want.iterations)) <= 1
    np.testing.assert_allclose(w_to_numpy(got.w), np.asarray(want.w),
                               rtol=1e-8, atol=1e-8 * np.abs(want.w).max())


def test_sparse_grad_modes_and_black_box_agree():
    """scatter, csc and csc_kernel give the same fit; the margin-space fit
    and the black-box L-BFGS on the objective reach the same optimum."""
    idx, vals, y, offsets, weights, dim = _sparse_data(True)
    tb = batch_from_numpy(idx, vals, y, offsets, weights, dim=dim,
                          dtype=torch.float64, device="cpu")
    obj = make_objective("logistic")
    w0 = torch.zeros(dim, dtype=torch.float64)
    cfg = OptimizerConfig(max_iters=200, tolerance=1e-12)
    csc = build_csc(tb)
    fits = {mode: fit_distributed(obj, tb, w0, l2=1.0, config=cfg,
                                  sparse_grad=mode,
                                  precomputed_csc=None if mode == "scatter"
                                  else csc)
            for mode in ("scatter", "csc", "csc_kernel", "auto")}
    ref = fits["csc_kernel"].w.numpy()
    for mode, res in fits.items():
        np.testing.assert_allclose(res.w.numpy(), ref, rtol=1e-9, atol=1e-9)
    bb = lbfgs(lambda w: obj.value_and_grad(w, tb, 1.0), w0, cfg)
    np.testing.assert_allclose(bb.w.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_fit_rejects_unported_paths():
    """Every optimizer, line search and sparse_grad mode of the JAX
    package's one-device fit is ported; what is left to reject is what JAX
    rejects too (a precomputed view the mode does not use, an unknown
    optimizer) and names that no package knows."""
    idx, vals, y, offsets, weights, dim = _sparse_data(False, n=64)
    tb = batch_from_numpy(idx, vals, y, dim=dim, dtype=torch.float64,
                          device="cpu")
    obj, w0 = make_objective("logistic"), torch.zeros(dim, dtype=torch.float64)
    cfg = OptimizerConfig(max_iters=2, tolerance=0.0)
    for optimizer in ("owlqn", "tron"):
        assert fit_distributed(obj, tb, w0, l1=0.1, optimizer=optimizer,
                               config=cfg).iterations == 2
    for mode in ("csc_precise", "csc_segment"):
        assert fit_distributed(obj, tb, w0, config=cfg, sparse_grad=mode,
                               line_search="full").iterations == 2
    with pytest.raises(ValueError):
        fit_distributed(obj, tb, w0, optimizer="sgd")
    with pytest.raises(ValueError):
        fit_distributed(obj, tb, w0, line_search="exact")
    with pytest.raises(ValueError):
        fit_distributed(obj, tb, w0, sparse_grad="csc_pallas")
    with pytest.raises(ValueError):
        fit_distributed(obj, tb, w0, sparse_grad="scatter",
                        precomputed_csc=build_csc(tb))
