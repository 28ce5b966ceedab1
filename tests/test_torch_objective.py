"""Parity of the port's losses, normalization and objective with the JAX
package. The port's loss derivatives are closed forms; here they are held
against ``jax.grad`` of the JAX losses. Tolerance: rtol 1e-12 at f64 (the
closed forms and autodiff round differently in the last bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.ops import normalization as jn
from photon_ml_tpu.ops.objective import kkt_residuals as j_kkt
from photon_ml_tpu.ops.objective import make_objective as j_make_objective
from photon_ml_tpu.ops.statistics import FeatureSummary
from photon_ml_tpu.types import SparseFeatures as JSparse
from photon_ml_tpu.types import make_batch as j_make_batch
from photon_ml_tpu_torch.interop import batch_from_numpy
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.ops import normalization as tn
from photon_ml_tpu_torch.ops.objective import kkt_residuals as t_kkt
from photon_ml_tpu_torch.ops.objective import make_objective as t_make_objective
from photon_ml_tpu_torch.types import make_batch as t_make_batch

RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("name", ["logistic", "squared", "poisson",
                                  "smoothed_hinge"])
def test_loss_and_derivatives_match(name):
    r = np.random.default_rng(0)
    m = np.concatenate([r.normal(scale=3.0, size=200),
                        [0.0, 1.0, -1.0, 0.5, -0.5]])  # hinge kinks
    y = (r.random(m.size) < 0.5).astype(float)
    if name == "poisson":
        y = r.poisson(2.0, m.size).astype(float)
    jloss, tloss = jl.get_loss(name), tl.get_loss(name)
    tm, ty = torch.from_numpy(m), torch.from_numpy(y)
    jm, jy = jnp.asarray(m), jnp.asarray(y)
    _close(tloss.loss(tm, ty), jloss.loss(jm, jy))
    _close(tloss.d1(tm, ty),
           jax.vmap(jax.grad(jloss.loss))(jm, jy))
    _close(tloss.d2(tm, ty), jloss.d2(jm, jy))
    _close(tloss.mean(tm), jloss.mean(jm))


def test_weight_masking_matches():
    w = np.array([1.0, 0.0, 2.0, 0.0])
    per = np.array([1.0, np.inf, 3.0, np.nan])
    m = np.array([0.5, 1e6, -2.0, np.inf])
    _close(tl.apply_weights(torch.from_numpy(w), torch.from_numpy(per)),
           jl.apply_weights(jnp.asarray(w), jnp.asarray(per)))
    _close(tl.mask_margins(torch.from_numpy(w), torch.from_numpy(m)),
           jl.mask_margins(jnp.asarray(w), jnp.asarray(m)))


def _summary(X):
    return FeatureSummary(mean=X.mean(0), variance=X.var(0), std=X.std(0),
                          min=X.min(0), max=X.max(0),
                          num_nonzeros=(X != 0).sum(0), count=X.shape[0])


def _data(seed=1, n=120, k=5, dim=12):
    r = np.random.default_rng(seed)
    idx = r.integers(0, dim, (n, k)).astype(np.int32)
    idx[:, 0] = 0  # column 0 is the intercept feature
    vals = np.abs(r.normal(size=(n, k))) + 0.1
    vals[:, 0] = 1.0
    y = (r.random(n) < 0.5).astype(float)
    offsets = r.normal(scale=0.1, size=n)
    weights = r.random(n) + 0.5
    weights[::17] = 0.0  # padding rows
    dense = np.zeros((n, dim))
    np.add.at(dense, (np.repeat(np.arange(n), k), idx.reshape(-1)),
              vals.reshape(-1))
    return idx, vals, y, offsets, weights, dense, r.normal(size=dim) * 0.3


@pytest.mark.parametrize("norm", ["none", "scale_with_standard_deviation",
                                  "standardization"])
@pytest.mark.parametrize("features", ["sparse", "implicit_ones", "dense"])
def test_value_and_grad_match(features, norm):
    idx, vals, y, offsets, weights, dense, w = _data()
    dim = dense.shape[1]
    if features == "implicit_ones":
        vals = None
    intercept = 0 if norm == "standardization" else -1
    jctx = jn.build_normalization_context(norm, _summary(dense), intercept)
    tctx = tn.build_normalization_context(norm, _summary(dense), intercept,
                                          dtype=torch.float64, device="cpu")
    jobj = j_make_objective("logistic", jctx, intercept_index=intercept)
    tobj = t_make_objective("logistic", tctx, intercept_index=intercept)
    if features == "dense":
        jb = j_make_batch(jnp.asarray(dense), y, offsets, weights,
                          dtype=jnp.float64)
        tb = t_make_batch(dense, y, offsets, weights, dtype=torch.float64,
                          device="cpu")
    else:
        jb = j_make_batch(
            JSparse(jnp.asarray(idx),
                    None if vals is None else jnp.asarray(vals), dim=dim),
            y, offsets, weights, dtype=jnp.float64)
        tb = batch_from_numpy(idx, vals, y, offsets, weights, dim=dim,
                              dtype=torch.float64, device="cpu")
    jf, jg = jobj.value_and_grad(jnp.asarray(w), jb, 0.7)
    tw = torch.from_numpy(w)
    tf, tg = tobj.value_and_grad(tw, tb, 0.7)
    _close(tf, jf)
    _close(tg, jg)
    _close(tobj.value(tw, tb, 0.7), jf)
    _close(tobj.grad(tw, tb, 0.7), jg)
    _close(tobj.predict(tw, tb), jobj.predict(jnp.asarray(w), jb))
    if tctx is not None:
        _close(tctx.to_model_space(tw), jctx.to_model_space(jnp.asarray(w)))
        _close(tctx.to_training_space(tw),
               jctx.to_training_space(jnp.asarray(w)))
        _close(tctx.to_training_space(tctx.to_model_space(tw)), w)


def test_normalization_contexts_match():
    X = _data()[5]
    for norm in ("scale_with_standard_deviation", "scale_with_max_magnitude",
                 "standardization"):
        j = jn.build_normalization_context(norm, _summary(X), 0)
        t = tn.build_normalization_context(norm, _summary(X), 0,
                                           dtype=torch.float64, device="cpu")
        _close(t.factors, j.factors)
        assert (t.shifts is None) == (j.shifts is None)
        if t.shifts is not None:
            _close(t.shifts, j.shifts)
    assert tn.build_normalization_context("none", _summary(X)) is None
    with pytest.raises(ValueError):
        tn.build_normalization_context("standardization", _summary(X), -1,
                                       device="cpu")


def test_kkt_residuals_match():
    r = np.random.default_rng(2)
    w = np.where(r.random(30) < 0.4, 0.0, r.normal(size=30))
    g = r.normal(size=30)
    mask = (r.random(30) < 0.8).astype(float)
    _close(t_kkt(torch.from_numpy(w), torch.from_numpy(g), 0.5,
                 torch.from_numpy(mask)),
           j_kkt(jnp.asarray(w), jnp.asarray(g), 0.5, jnp.asarray(mask)))


def test_regularization_matches():
    """The copied host-side module gives the JAX package's weights,
    thresholds and slack."""
    from photon_ml_tpu.ops import regularization as jr
    from photon_ml_tpu_torch.ops import regularization as tr

    for kind in ("none", "l1", "l2", "elastic_net"):
        j = jr.RegularizationContext(kind, alpha=0.3)
        t = tr.RegularizationContext(kind, alpha=0.3)
        assert (t.l1_weight(2.0), t.l2_weight(2.0), t.needs_owlqn) == (
            j.l1_weight(2.0), j.l2_weight(2.0), j.needs_owlqn)
    for rule in ("strong", "safe"):
        assert tr.screening_threshold(rule, 1.0, 1.5, 0.2) == \
            jr.screening_threshold(rule, 1.0, 1.5, 0.2)
    assert tr.kkt_slack(0.5, 1e-6) == jr.kkt_slack(0.5, 1e-6)
    with pytest.raises(ValueError):
        tr.RegularizationContext("l1", alpha=1.5)
    with pytest.raises(ValueError):
        tr.screening_threshold("bogus", 1.0, 2.0)
