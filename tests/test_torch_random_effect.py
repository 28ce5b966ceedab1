"""The port's random-effect solvers and scoring
(``photon_ml_tpu_torch/game/random_effect.py``, ``optimize/batched.py``)
against the JAX package's, at float64 on the CPU. The TRON cases hold the
batched TRON to ``jax.vmap`` of the JAX package's scalar TRON.

One dataset of 40 entities in 2 size buckets whose entities converge at
different iterations; each JAX reference runs once per module.
Tolerances: coefficients and variances within 1e-6 relative L2 per bucket,
per-entity iteration counts and convergence flags identical (the batched
solvers make the same decisions as JAX's ``vmap`` of its scalar ones; the
two packages sum in different orders); scores within 1e-12. Within the
port, blocked and active-set solves are bit-identical to the full solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game.data import (
    build_random_effect_data as jax_re_data, build_score_view as jax_view,
)
from photon_ml_tpu.game.random_effect import (
    score_random_effect as jax_score, train_random_effect as jax_train,
)
from photon_ml_tpu.ops.normalization import (
    NormalizationContext as JaxNorm,
)
from photon_ml_tpu.optimize import OptimizerConfig as JaxConfig
from photon_ml_tpu_torch.game import random_effect as re_mod
from photon_ml_tpu_torch.game.data import (
    build_random_effect_data, build_score_view,
)
from photon_ml_tpu_torch.game.random_effect import (
    resolve_re_optimizer, score_random_effect, train_random_effect,
)
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.optimize import batched
from photon_ml_tpu_torch.optimize.common import OptimizerConfig

TOL = 1e-6
N, D, E = 900, 6, 40
CONFIG = dict(max_iters=30, tolerance=1e-9, history=5)


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(0)
    X = r.normal(size=(N, D))
    X[r.random((N, D)) < 0.3] = 0.0
    X[:, 0] = 1.0  # an intercept column in every entity's subspace
    ids = r.integers(0, E, N)
    y = (r.random(N) < 0.5).astype(float)
    offs = r.normal(size=N) * 0.3
    return dict(
        X=X, ids=ids, y=y, offs=offs,
        jax=jax_re_data(X, y, np.ones(N), ids, num_buckets=2),
        port=build_random_effect_data(X, y, np.ones(N), ids, num_buckets=2))


def _norms(kind):
    f = np.linspace(0.5, 2.0, D)
    s = np.linspace(-0.3, 0.3, D) if kind == "shift" else None
    return (JaxNorm(jnp.asarray(f), None if s is None else jnp.asarray(s), 0),
            NormalizationContext(torch.from_numpy(f),
                                 None if s is None else torch.from_numpy(s),
                                 0))


# (optimizer, l1, compute_variance, normalization, tolerance). Newton
# converges quadratically: at 1e-9 its last iteration's decisions are made
# on differences at the rounding floor, so its cases stop at 1e-7.
CASES = {
    "newton": ("newton", 0.0, "full", None, 1e-7),
    "lbfgs_factors": ("lbfgs", 0.0, "diagonal", "factors", 1e-9),
    "owlqn": ("owlqn", 0.3, False, None, 1e-9),
    "newton_shift": ("newton", 0.0, "diagonal", "shift", 1e-7),
    "tron": ("tron", 0.0, "diagonal", None, 1e-9),
    "tron_shift_full": ("tron", 0.0, "full", "shift", 1e-9),
}
_FITS = {}


def _fits(data, case):
    """(JAX fit, port fit) for one case, each run once per module."""
    if case not in _FITS:
        opt, l1, var, norm, tol = CASES[case]
        jn, pn = (None, None) if norm is None else _norms(norm)
        config = dict(CONFIG, tolerance=tol)
        rj = jax_train(data["jax"], jnp.asarray(data["offs"]), l2=0.7, l1=l1,
                       optimizer=opt, config=JaxConfig(**config),
                       dtype=jnp.float64, compute_variance=var,
                       normalization=jn)
        rp = train_random_effect(data["port"], data["offs"], l2=0.7, l1=l1,
                                 optimizer=opt,
                                 config=OptimizerConfig(**config),
                                 dtype=torch.float64, compute_variance=var,
                                 normalization=pn, device="cpu")
        _FITS[case] = (rj, rp)
    return _FITS[case]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_random_effect_matches_jax(data, case):
    rj, rp = _fits(data, case)
    assert rp.entities_solved == E
    assert rp.converged_fraction == pytest.approx(rj.converged_fraction)
    assert rp.mean_iterations == pytest.approx(rj.mean_iterations)
    spread = set()
    for b in range(2):
        assert _rel(rp.coefficients[b], rj.coefficients[b]) <= TOL
        np.testing.assert_array_equal(rp.iterations[b],
                                      np.asarray(rj.iterations[b]))
        np.testing.assert_array_equal(rp.converged[b],
                                      np.asarray(rj.converged[b]))
        spread |= set(rp.iterations[b].tolist())
        if CASES[case][2]:
            assert _rel(rp.variances[b], rj.variances[b]) <= TOL
    # the entities converge at different iterations
    assert len(spread) > 1
    if CASES[case][1] > 0:  # OWL-QN leaves exact zeros
        assert any((c == 0).any() for c in rp.coefficients)


def test_blocked_matches_unblocked_bit_for_bit(data, monkeypatch):
    """Entity blocks of 7 (padded) give the full block's result."""
    cfg = OptimizerConfig(**CONFIG)
    full = train_random_effect(data["port"], data["offs"], l2=0.7,
                               optimizer="lbfgs", config=cfg,
                               dtype=torch.float64, device="cpu")
    monkeypatch.setattr(re_mod, "_block_entities", lambda *a, **k: 7)
    blocked = train_random_effect(data["port"], data["offs"], l2=0.7,
                                  optimizer="lbfgs", config=cfg,
                                  dtype=torch.float64, device="cpu")
    for a, b in zip(full.coefficients, blocked.coefficients):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(full.iterations, blocked.iterations):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("optimizer", ["newton", "lbfgs", "tron"])
def test_active_set_carries_frozen_entities(data, optimizer):
    """A partial solve re-solves only the masked entities (in a padded
    sub-bucket): they match the full warm re-solve bit for bit, the frozen
    ones carry ``w0`` and their variances, converged with 0 iterations."""
    cfg = OptimizerConfig(**CONFIG)
    kw = dict(l2=0.7, optimizer=optimizer, config=cfg, dtype=torch.float64,
              device="cpu", compute_variance="diagonal")
    first = train_random_effect(data["port"], data["offs"], **kw)
    offs2 = data["offs"] + 0.1
    full = train_random_effect(data["port"], offs2, w0=first.coefficients,
                               **kw)
    masks = [np.arange(b.num_entities) % 3 == 0
             for b in data["port"].buckets]
    part = train_random_effect(data["port"], offs2, w0=first.coefficients,
                               active=masks,
                               prev_variances=first.variances, **kw)
    assert part.entities_solved == sum(int(m.sum()) for m in masks)
    for b, m in enumerate(masks):
        np.testing.assert_array_equal(part.coefficients[b][m],
                                      full.coefficients[b][m])
        np.testing.assert_array_equal(part.coefficients[b][~m],
                                      first.coefficients[b][~m])
        np.testing.assert_array_equal(part.variances[b][~m],
                                      first.variances[b][~m])
        assert part.converged[b][~m].all()
        assert (part.iterations[b][~m] == 0).all()
    frozen = train_random_effect(
        data["port"], offs2, w0=first.coefficients,
        active=[np.zeros(b.num_entities, bool)
                for b in data["port"].buckets], **kw)
    assert frozen.entities_solved == 0
    with pytest.raises(ValueError, match="needs w0"):
        train_random_effect(data["port"], offs2, active=masks, **kw)


def test_score_random_effect_matches_jax(data):
    """Full and incremental scoring against JAX's, with the same
    coefficients, on the training view and on a view of other rows (unseen
    entities score 0)."""
    coeffs = [np.asarray(c) for c in _fits(data, "lbfgs_factors")[0]
              .coefficients]
    r = np.random.default_rng(1)
    X2 = r.normal(size=(200, D))
    ids2 = r.integers(0, E + 5, 200)
    for X, ids in ((data["X"], data["ids"]), (X2, ids2)):
        n = X.shape[0]
        vj = jax_view(data["jax"], X, ids)
        vp = build_score_view(data["port"], X, ids)
        sj = np.asarray(jax_score(vj, coeffs, n, jnp.float64))
        sp = score_random_effect(vp, coeffs, n, torch.float64,
                                 device="cpu").numpy()
        assert np.max(np.abs(sp - sj)) <= 1e-12
        # incremental: only the masked entities' rows are rewritten
        changed = [np.arange(b.num_entities) % 2 == 0
                   for b in data["port"].buckets]
        new = [c * 2.0 for c in coeffs]
        prev = torch.from_numpy(sp)
        inc = score_random_effect(vp, new, n, torch.float64, prev=prev,
                                  changed=changed, device="cpu").numpy()
        inc_j = np.asarray(jax_score(vj, new, n, jnp.float64,
                                     prev=jnp.asarray(sj), changed=changed))
        assert np.max(np.abs(inc - inc_j)) <= 1e-12
        fresh = score_random_effect(
            vp, [np.where(c[:, None], w2, w)
                 for c, w, w2 in zip(changed, coeffs, new)],
            n, torch.float64, device="cpu").numpy()
        np.testing.assert_array_equal(inc, fresh)


def test_deferred_and_unknown_optimizers_raise(data):
    with pytest.raises(ValueError, match="unknown random-effect optimizer"):
        train_random_effect(data["port"], data["offs"], optimizer="sgd",
                            device="cpu")


def test_resolve_re_optimizer():
    assert resolve_re_optimizer("newton") == "newton"
    assert resolve_re_optimizer("owlqn") == "owlqn"
    assert resolve_re_optimizer("auto") == "lbfgs"
    dev = torch.device("cpu")
    assert re_mod._block_budget(dev) == 1 << 30  # the host block
    assert re_mod._block_entities(64, 32, 8, "newton",
                                  OptimizerConfig(), 4, False, dev) == \
        (1 << 30) // re_mod._entity_bytes(64, 32, 8, "newton", 10, 4, False)


def test_batched_lbfgs_matches_scalar_runs():
    """The batched L-BFGS and OWL-QN give each entity the scalar solver's
    iterates (``optimize/lbfgs.py``, ``optimize/owlqn.py``) up to
    rounding, with the scalar iteration counts."""
    from photon_ml_tpu_torch.optimize.lbfgs import lbfgs
    from photon_ml_tpu_torch.optimize.owlqn import owlqn

    r = np.random.default_rng(4)
    A = torch.from_numpy(r.normal(size=(5, 12, 4)))
    b = torch.from_numpy(r.normal(size=(5, 12)))
    scale = torch.from_numpy(np.geomspace(0.01, 100.0, 5))

    def fg(W):  # per-entity least squares, conditioned differently
        res = torch.einsum("end,ed->en", A, W) - b
        f = 0.5 * scale * torch.sum(res * res, 1)
        return f, scale[:, None] * torch.einsum("end,en->ed", A, res)

    cfg = OptimizerConfig(max_iters=40, tolerance=1e-10, history=4)
    W0 = torch.zeros(5, 4, dtype=torch.float64)
    for name, run, one in (
            ("lbfgs", lambda: batched.lbfgs(fg, W0, cfg),
             lambda e: lbfgs(lambda w: _one(fg, e, w), W0[e], cfg)),
            ("owlqn", lambda: batched.owlqn(fg, W0, 0.5, cfg),
             lambda e: owlqn(lambda w: _one(fg, e, w), W0[e], 0.5, cfg))):
        res = run()
        for e in range(5):
            s = one(e)
            assert int(res.iterations[e]) == s.iterations, name
            assert bool(res.converged[e]) == s.converged, name
            assert _rel(res.w[e], s.w) <= 1e-9, name


def test_batched_tron_matches_scalar_runs():
    """The batched TRON gives each entity the scalar TRON's iterates
    (``optimize/tron.py``, unpreconditioned) up to rounding, with the
    scalar iteration counts, on problems conditioned differently."""
    from photon_ml_tpu_torch.optimize.tron import tron

    r = np.random.default_rng(5)
    A = torch.from_numpy(r.normal(size=(5, 30, 6)))
    y = torch.from_numpy((r.random((5, 30)) < 0.5).astype(float))
    scale = torch.from_numpy(np.geomspace(0.05, 20.0, 5))

    def fg(W):  # per-entity logistic loss plus 0.1 |w|^2 / 2
        m = torch.einsum("end,ed->en", A, W) * scale[:, None]
        f = torch.sum(torch.nn.functional.softplus(m) - y * m, 1) \
            + 0.05 * torch.sum(W * W, 1)
        d1 = (torch.sigmoid(m) - y) * scale[:, None]
        return f, torch.einsum("end,en->ed", A, d1) + 0.1 * W

    def hvp(W):
        m = torch.einsum("end,ed->en", A, W) * scale[:, None]
        d2 = torch.sigmoid(m) * (1 - torch.sigmoid(m)) * scale[:, None] ** 2
        return lambda V: torch.einsum(
            "end,en->ed", A, d2 * torch.einsum("end,ed->en", A, V)) + 0.1 * V

    cfg = OptimizerConfig(max_iters=40, tolerance=1e-10)
    W0 = torch.zeros(5, 6, dtype=torch.float64)
    res = batched.tron(fg, W0, hvp, cfg)
    iters = set()
    for e in range(5):
        s = tron(lambda w: _one(fg, e, w), W0[e], cfg,
                 hvp=lambda w, v: _one_hvp(hvp, e, w, v))
        assert int(res.iterations[e]) == s.iterations
        assert bool(res.converged[e]) == s.converged
        assert _rel(res.w[e], s.w) <= 1e-9
        iters.add(s.iterations)
    assert len(iters) > 1


def _one_hvp(hvp, e, w, v):
    W = torch.zeros(5, w.shape[0], dtype=w.dtype)
    V = torch.zeros_like(W)
    W[e], V[e] = w, v
    return hvp(W)(V)[e]


def _one(fg, e, w):
    W = torch.zeros(5, w.shape[0], dtype=w.dtype)
    W[e] = w
    f, g = fg(W)
    return f[e], g[e]


@pytest.mark.parametrize("width", [0, 1, 3, 8, 13])
def test_padded_sum_ignores_trailing_padding(width):
    """``batched.padded_sum`` gives the same bits however many zeros pad
    the last axis, and agrees with a float64 sum."""
    x = torch.from_numpy(np.random.default_rng(width).normal(
        size=(4, width)).astype(np.float32))
    got = batched.padded_sum(x)
    for pad in (1, 5, 64):
        assert torch.equal(
            batched.padded_sum(torch.nn.functional.pad(x, (0, pad))), got)
    np.testing.assert_allclose(got.double().numpy(),
                               x.double().sum(-1).numpy(), rtol=1e-6,
                               atol=1e-6)
