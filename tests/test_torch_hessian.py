"""Parity of the port's second-order pieces with the JAX package: the
Hessian-vector product, the diagonal and full Hessians and the coefficient
variances of ``GLMObjective``, the CSC path's closures (``make_csc_path``
and TRON's CSC preconditioner) over every column-sorted mode, and the
``types`` contractions they rest on (``row_squares_apply``,
``csc_segment_apply``, ``csc_transpose_apply(precise=True)``).

Tolerance: rtol 1e-10 at f64. The port's Hessian products are closed forms
and JAX's come from autodiff; the two sum the same terms in different
orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu import types as jt
from photon_ml_tpu.ops import normalization as jn
from photon_ml_tpu.ops.objective import make_objective as j_make_objective
from photon_ml_tpu.ops.statistics import FeatureSummary
from photon_ml_tpu.types import SparseFeatures as JSparse
from photon_ml_tpu.types import make_batch as j_make_batch
from photon_ml_tpu_torch import types as tt
from photon_ml_tpu_torch.interop import batch_from_numpy
from photon_ml_tpu_torch.ops import normalization as tn
from photon_ml_tpu_torch.ops.objective import make_objective as t_make_objective
from photon_ml_tpu_torch.parallel.data_parallel import (
    build_csc, make_csc_diagonal_hessian, make_csc_path,
)

RTOL = 1e-10
L2 = 0.7


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1.0))


def _data(seed=1, n=150, k=5, dim=12):
    """ELL rows with column 0 the intercept feature, positive values,
    weighted rows (some weight 0: padding) and offsets."""
    r = np.random.default_rng(seed)
    idx = r.integers(0, dim, (n, k)).astype(np.int32)
    idx[:, 0] = 0
    vals = np.abs(r.normal(size=(n, k))) + 0.1
    vals[:, 0] = 1.0
    y = (r.random(n) < 0.5).astype(float)
    offsets = r.normal(scale=0.1, size=n)
    weights = r.random(n) + 0.5
    weights[::17] = 0.0
    dense = np.zeros((n, dim))
    np.add.at(dense, (np.repeat(np.arange(n), k), idx.reshape(-1)),
              vals.reshape(-1))
    return idx, vals, y, offsets, weights, dense, r


def _summary(X):
    return FeatureSummary(mean=X.mean(0), variance=X.var(0), std=X.std(0),
                          min=X.min(0), max=X.max(0),
                          num_nonzeros=(X != 0).sum(0), count=X.shape[0])


def _problem(features, norm, loss="logistic"):
    idx, vals, y, offsets, weights, dense, r = _data()
    dim = dense.shape[1]
    if features == "implicit_ones":
        vals = None
        dense = np.zeros_like(dense)
        np.add.at(dense, (np.repeat(np.arange(idx.shape[0]), idx.shape[1]),
                          idx.reshape(-1)), 1.0)
    intercept = 0 if norm == "standardization" else -1
    jctx = jn.build_normalization_context(norm, _summary(dense), intercept)
    tctx = tn.build_normalization_context(norm, _summary(dense), intercept,
                                          dtype=torch.float64, device="cpu")
    jobj = j_make_objective(loss, jctx, intercept_index=intercept)
    tobj = t_make_objective(loss, tctx, intercept_index=intercept)
    if features == "dense":
        jb = j_make_batch(jnp.asarray(dense), y, offsets, weights,
                          dtype=jnp.float64)
        tb = tt.make_batch(dense, y, offsets, weights, dtype=torch.float64,
                           device="cpu")
    else:
        jb = j_make_batch(
            JSparse(jnp.asarray(idx),
                    None if vals is None else jnp.asarray(vals), dim=dim),
            y, offsets, weights, dtype=jnp.float64)
        tb = batch_from_numpy(idx, vals, y, offsets, weights, dim=dim,
                              dtype=torch.float64, device="cpu")
    w, v = r.normal(size=dim) * 0.3, r.normal(size=dim)
    return jobj, tobj, jb, tb, w, v


CASES = [(f, n) for f in ("sparse", "implicit_ones", "dense")
         for n in ("none", "standardization")]


@pytest.mark.parametrize("features,norm", CASES)
def test_hessians_match(features, norm):
    """hvp, diagonal_hessian, full_hessian (in chunks of 64 rows) and both
    variance modes; n=150, d=12, k=5, l2=0.7."""
    jobj, tobj, jb, tb, w, v = _problem(features, norm)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    tv = torch.from_numpy(v)
    _close(tobj.hvp(tw, tv, tb, L2), jobj.hvp(jw, jnp.asarray(v), jb, L2))
    _close(tobj.diagonal_hessian(tw, tb, L2),
           jobj.diagonal_hessian(jw, jb, L2))
    H = tobj.full_hessian(tw, tb, L2, chunk_rows=64)
    _close(H, jobj.full_hessian(jw, jb, L2, chunk_rows=64))
    # the full Hessian's product agrees with the HVP (its diagonal differs
    # from diagonal_hessian where a row repeats a column: that sums the
    # squares of the entries, not the square of their sum)
    _close(H @ tv, np.asarray(jobj.hvp(jw, jnp.asarray(v), jb, L2)))
    for mode in ("diagonal", "full"):
        _close(tobj.coefficient_variances(tw, tb, L2, mode=mode),
               jobj.coefficient_variances(jw, jb, L2, mode=mode))
    with pytest.raises(ValueError):
        tobj.coefficient_variances(tw, tb, L2, mode="bogus")


@pytest.mark.parametrize("loss", ["poisson", "smoothed_hinge", "squared"])
def test_hvp_other_losses_match(loss):
    jobj, tobj, jb, tb, w, v = _problem("sparse", "none", loss)
    _close(tobj.hvp(torch.from_numpy(w), torch.from_numpy(v), tb, L2),
           jobj.hvp(jnp.asarray(w), jnp.asarray(v), jb, L2))


MODES = ["csc", "csc_kernel", "csc_precise", "csc_segment"]


@pytest.mark.parametrize("features,norm",
                         [c for c in CASES if c[0] != "dense"])
def test_csc_path_closures_match(features, norm):
    """``make_csc_path``'s fg and hvp and the CSC preconditioner, over every
    column-sorted mode (the kernel's plain version on the CPU), against the
    JAX objective's value_and_grad, hvp and diagonal_hessian."""
    jobj, tobj, jb, tb, w, v = _problem(features, norm)
    jw, tw, tv = jnp.asarray(w), torch.from_numpy(w), torch.from_numpy(v)
    jf, jg = jobj.value_and_grad(jw, jb, L2)
    jhv = jobj.hvp(jw, jnp.asarray(v), jb, L2)
    jdiag = jobj.diagonal_hessian(jw, jb, L2)
    csc = build_csc(tb)
    for mode in MODES:
        _, fg, hvp = make_csc_path(tobj, use_kernel=mode == "csc_kernel",
                                   precise=mode == "csc_precise",
                                   segment=mode == "csc_segment")
        f, g = fg(tw, tb, csc, L2)
        _close(f, jf)
        _close(g, jg)
        _close(hvp(tw, tv, tb, csc, L2), jhv)
        squares, diag = make_csc_diagonal_hessian(tobj, mode)
        _close(diag(tw, tb, csc, squares(csc), L2), jdiag)
    with pytest.raises(ValueError, match="precise"):
        make_csc_path(tobj, use_kernel=True, precise=True)


@pytest.mark.parametrize("kind", ["sparse", "implicit_ones", "dense"])
def test_row_squares_apply_matches(kind):
    idx, vals, y, offsets, weights, dense, r = _data(2)
    d = r.normal(size=idx.shape[0])
    if kind == "dense":
        jf, tf = jnp.asarray(dense), torch.from_numpy(dense)
    else:
        vals = None if kind == "implicit_ones" else vals
        jf = JSparse(jnp.asarray(idx),
                     None if vals is None else jnp.asarray(vals), dim=12)
        tf = tt.SparseFeatures(torch.from_numpy(idx),
                               None if vals is None
                               else torch.from_numpy(vals), 12)
    _close(tt.row_squares_apply(tf, torch.from_numpy(d)),
           jt.row_squares_apply(jf, jnp.asarray(d)), rtol=1e-12)


@pytest.mark.parametrize("with_values", [False, True])
def test_csc_applies_match(with_values):
    """The sorted segment sum and the float64-prefix apply against JAX's;
    the view's sorted column ids bit for bit; 300 rows, 7 slots, 50
    columns (many ties, some empty columns)."""
    r = np.random.default_rng(3)
    idx = r.integers(0, 60, (300, 7)).astype(np.int32)
    idx[idx >= 50] = 0
    vals = r.normal(size=(300, 7)) if with_values else None
    d = r.normal(size=300)
    jcsc = jt.build_csc_transpose(
        jnp.asarray(idx), None if vals is None else jnp.asarray(vals), 50)
    tcsc = tt.build_csc_transpose(
        torch.from_numpy(idx), None if vals is None
        else torch.from_numpy(vals), 50)
    np.testing.assert_array_equal(tcsc.cols.numpy(), np.asarray(jcsc.cols))
    td = torch.from_numpy(d)
    _close(tt.csc_segment_apply(tcsc, td),
           jt.csc_segment_apply(jcsc, jnp.asarray(d)), rtol=1e-12)
    _close(tt.csc_transpose_apply(tcsc, td, precise=True),
           jt.csc_transpose_apply(jcsc, jnp.asarray(d), precise=True),
           rtol=1e-12)
    bare = tt.build_csc_transpose(torch.from_numpy(idx), None, 50,
                                  with_cols=False)
    assert bare.cols is None
    with pytest.raises(ValueError, match="cols"):
        tt.csc_segment_apply(bare, td)
