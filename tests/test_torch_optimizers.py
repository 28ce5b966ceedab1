"""Parity of the port's OWL-QN, TRON and backtracking search with the JAX
package, on small dense logistic problems made from a seed (n=200, d=10,
f64). Each JAX reference runs once per module. Tolerances: rtol 1e-6 on
the final ``w`` (two packages, two summation orders, compounded over the
iterations), rtol 1e-10 on single line searches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.objective import make_objective as j_make_objective
from photon_ml_tpu.optimize import OptimizerConfig as JConfig
from photon_ml_tpu.optimize.linesearch import backtracking as j_backtracking
from photon_ml_tpu.optimize.owlqn import owlqn as j_owlqn
from photon_ml_tpu.optimize.owlqn import pseudo_gradient as j_pseudo_gradient
from photon_ml_tpu.optimize.tron import tron as j_tron
from photon_ml_tpu.types import make_batch as j_make_batch
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.optimize import (
    OptimizerConfig, get_optimizer, lbfgs, owlqn, tron,
)
from photon_ml_tpu_torch.optimize.linesearch import backtracking
from photon_ml_tpu_torch.optimize.owlqn import pseudo_gradient
from photon_ml_tpu_torch.types import make_batch

RTOL_FIT = 1e-6
RTOL_STEP = 1e-10
CFG = dict(max_iters=100, tolerance=1e-9)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1.0))


class Problem:
    """A logistic problem in both packages; ``scales`` > 1 makes it badly
    scaled (the case the Jacobi preconditioner is for). Column 0 is an
    intercept of ones."""

    def __init__(self, seed, n=200, d=10, l2=1.0, scales=1.0):
        r = np.random.default_rng(seed)
        X = r.normal(size=(n, d)) * scales
        X[:, 0] = 1.0
        w_true = np.where(r.random(d) < 0.5, 0.0, r.normal(size=d)) / scales
        y = (r.random(n) < 1 / (1 + np.exp(-X @ w_true))).astype(float)
        self.d, self.l2 = d, l2
        jb = j_make_batch(jnp.asarray(X), y, dtype=jnp.float64)
        tb = make_batch(X, y, dtype=torch.float64, device="cpu")
        self.jobj = j_make_objective("logistic", intercept_index=0)
        self.tobj = make_objective("logistic", intercept_index=0)
        self.j_fg = lambda w: self.jobj.value_and_grad(w, jb, l2)
        self.j_hvp = lambda w, v: self.jobj.hvp(w, v, jb, l2)
        self.j_diag = lambda w: self.jobj.diagonal_hessian(w, jb, l2)
        self.t_fg = lambda w: self.tobj.value_and_grad(w, tb, l2)
        self.t_value = lambda w: self.tobj.value(w, tb, l2)
        self.t_hvp = lambda w, v: self.tobj.hvp(w, v, tb, l2)
        self.t_diag = lambda w: self.tobj.diagonal_hessian(w, tb, l2)

    def j_w0(self):
        return jnp.zeros(self.d)

    def t_w0(self):
        return torch.zeros(self.d, dtype=torch.float64)


@pytest.fixture(scope="module")
def owlqn_case():
    """L1 = 3 with the intercept unpenalized, and L1 = 0; JAX's runs."""
    p = Problem(0, l2=0.0)
    mask = np.ones(p.d)
    mask[0] = 0.0
    run = jax.jit(lambda w0, l1: j_owlqn(p.j_fg, w0, l1, JConfig(**CFG),
                                         l1_mask=jnp.asarray(mask)))
    return p, mask, {l1: run(p.j_w0(), l1) for l1 in (3.0, 0.0)}


@pytest.mark.parametrize("value_only", [False, True])
def test_owlqn_matches(owlqn_case, value_only):
    """With and without the value-only trials: the same iterates."""
    p, mask, want = owlqn_case
    got = owlqn(p.t_fg, p.t_w0(), 3.0, OptimizerConfig(**CFG),
                l1_mask=torch.from_numpy(mask),
                fun=p.t_value if value_only else None)
    ref = want[3.0]
    assert got.converged == bool(ref.converged)
    assert got.iterations == int(ref.iterations)
    _close(got.w, ref.w, RTOL_FIT)
    _close(got.value, ref.value, RTOL_FIT)
    w = got.w.numpy()
    assert (w[1:] == 0).sum() > 0 and w[0] != 0  # sparse, intercept free
    # one read per backtracking trial plus one per iteration
    assert got.host_syncs >= 2 * got.iterations


def test_owlqn_zero_l1_equals_lbfgs(owlqn_case):
    p, mask, want = owlqn_case
    cfg = OptimizerConfig(**CFG)
    got = owlqn(p.t_fg, p.t_w0(), 0.0, cfg, fun=p.t_value)
    _close(got.w, want[0.0].w, RTOL_FIT)
    plain = lbfgs(p.t_fg, p.t_w0(), cfg)
    np.testing.assert_allclose(float(got.value), float(plain.value),
                               rtol=1e-7)


def test_pseudo_gradient_matches():
    r = np.random.default_rng(1)
    w = np.where(r.random(40) < 0.4, 0.0, r.normal(size=40))
    g = r.normal(size=40) * 2
    lam = np.full(40, 0.8)
    _close(pseudo_gradient(torch.from_numpy(w), torch.from_numpy(g),
                           torch.from_numpy(lam)),
           j_pseudo_gradient(jnp.asarray(w), jnp.asarray(g),
                             jnp.asarray(lam)), 1e-15)


@pytest.mark.parametrize("project", [False, True])
@pytest.mark.parametrize("alpha0", [1.0, 40.0])
def test_backtracking_matches(project, alpha0):
    """alpha0 = 1 accepts at once, 40 shrinks several times; the orthant
    projection zeroes coordinates that change sign."""
    p = Problem(2)
    r = np.random.default_rng(2)
    w = r.normal(size=p.d)
    jf, jg = p.j_fg(jnp.asarray(w))
    pdir = -np.asarray(jg)
    xi = np.sign(w)

    def j_proj(x):
        return jnp.where(x * jnp.asarray(xi) > 0, x, 0.0)

    def t_proj(x):
        return torch.where(x * torch.from_numpy(xi) > 0, x,
                           torch.zeros((), dtype=x.dtype))

    want = j_backtracking(lambda x: p.j_fg(x)[0], jnp.asarray(w),
                          jnp.asarray(pdir), jf, jg, alpha0=alpha0,
                          project=j_proj if project else None)
    tw = torch.from_numpy(w)
    tf, tg = p.t_fg(tw)
    got = backtracking(p.t_value, tw, torch.from_numpy(pdir), tf, tg,
                       alpha0=alpha0, project=t_proj if project else None)
    assert got.n_evals == int(want[2]) and got.ok == bool(want[3])
    _close(got.w, want[0], RTOL_STEP)
    _close(got.f, want[1], RTOL_STEP)


@pytest.fixture(scope="module")
def tron_case():
    """A badly-scaled problem; JAX's TRON without and with the Jacobi
    preconditioner."""
    p = Problem(3, n=400, d=12, scales=np.logspace(-1, 1, 12))
    cfg = JConfig(**CFG)
    want = {
        False: jax.jit(lambda w0: j_tron(p.j_fg, w0, cfg,
                                         hvp=p.j_hvp))(p.j_w0()),
        True: jax.jit(lambda w0: j_tron(p.j_fg, w0, cfg, hvp=p.j_hvp,
                                        precond=p.j_diag))(p.j_w0()),
    }
    return p, want


@pytest.mark.parametrize("precond", [False, True])
def test_tron_matches(tron_case, precond):
    p, want = tron_case
    got = tron(p.t_fg, p.t_w0(), OptimizerConfig(**CFG), hvp=p.t_hvp,
               precond=p.t_diag if precond else None)
    ref = want[precond]
    assert got.converged == bool(ref.converged)
    assert got.iterations == int(ref.iterations)
    _close(got.w, ref.w, RTOL_FIT)
    _close(got.value, ref.value, RTOL_FIT)
    # one read per CG step plus one per outer iteration
    assert got.host_syncs > got.iterations


def test_tron_default_hvp_and_preconditioner(tron_case):
    """Without an ``hvp`` TRON differentiates the gradient (forward mode),
    as JAX's does; the preconditioner needs fewer outer iterations on the
    badly-scaled problem and reaches the same optimum."""
    p, want = tron_case
    cfg = OptimizerConfig(**CFG)
    auto = tron(p.t_fg, p.t_w0(), cfg)
    _close(auto.w, want[False].w, RTOL_FIT)
    assert auto.iterations == int(want[False].iterations)
    assert int(want[True].iterations) < int(want[False].iterations)


def test_get_optimizer():
    assert get_optimizer("LBFGS") is lbfgs
    assert get_optimizer("owlqn") is owlqn and get_optimizer("tron") is tron
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("sgd")


def test_tolerance_schedule_and_path_config_match():
    from photon_ml_tpu.optimize import common as jc
    from photon_ml_tpu_torch.optimize import common as tc

    for spec in ("1e-3:0.1", "off", "0.5:0.5"):
        j, t = jc.parse_tolerance_schedule(spec), \
            tc.parse_tolerance_schedule(spec)
        assert (j is None) == (t is None)
        if t is not None:
            assert [t.at(s, 1e-6) for s in range(6)] == \
                [j.at(s, 1e-6) for s in range(6)]
            assert t.at(3, 0.0) == 0.0
    for bad in ("1e-3", "a:b", "0:0.1", "1e-3:1.5"):
        with pytest.raises(ValueError):
            tc.parse_tolerance_schedule(bad)
    assert tc.PathConfig() == tc.PathConfig(screen="strong")
    for bad in (dict(screen="x"), dict(kkt_tol=-1), dict(max_kkt_rounds=0),
                dict(min_bucket=0)):
        with pytest.raises(ValueError):
            tc.PathConfig(**bad)
