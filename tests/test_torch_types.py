"""Parity of the port's ``types`` module with ``photon_ml_tpu.types``: the
column-sorted view bit for bit, and the margin / transpose products within
a stated tolerance (the two packages sum in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu import types as jt
from photon_ml_tpu_torch import types as tt
from photon_ml_tpu_torch.interop import batch_from_numpy

# f64: both sides sum the same terms in a different order; f32: the same
# at single precision
RTOL = {"float64": 1e-12, "float32": 1e-5}


def _ell(seed, n=300, k=7, dim=50):
    r = np.random.default_rng(seed)
    idx = r.integers(0, dim, (n, k)).astype(np.int32)  # many ties per column
    vals = r.normal(size=(n, k))
    return idx, vals, dim


@pytest.mark.parametrize("with_values", [False, True])
def test_build_csc_transpose_bit_equal(with_values):
    idx, vals, dim = _ell(0)
    vals = vals if with_values else None
    want = jt.build_csc_transpose(
        jnp.asarray(idx), None if vals is None else jnp.asarray(vals), dim)
    got = tt.build_csc_transpose(
        torch.from_numpy(idx), None if vals is None else torch.from_numpy(vals),
        dim)
    assert got.rows.dtype == torch.int32 and got.col_starts.dtype == torch.int32
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.col_starts.numpy(),
                                  np.asarray(want.col_starts))
    if with_values:
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values))
    else:
        assert got.values is None and want.values is None


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("with_values", [False, True])
def test_sparse_products_match(dtype, with_values):
    idx, vals, dim = _ell(1)
    vals = vals if with_values else None
    r = np.random.default_rng(2)
    w = r.normal(size=dim).astype(dtype)
    d = r.normal(size=idx.shape[0]).astype(dtype)
    jdt = getattr(jnp, dtype)
    jf = jt.SparseFeatures(jnp.asarray(idx),
                           None if vals is None else jnp.asarray(vals, jdt),
                           dim=dim)
    tb = batch_from_numpy(idx, vals, np.zeros(idx.shape[0]), dim=dim,
                          dtype=getattr(torch, dtype), device="cpu")
    jcsc = jt.build_csc_transpose(jf.indices, jf.values, dim)
    tcsc = tt.build_csc_transpose(tb.features.indices, tb.features.values, dim)
    rtol = RTOL[dtype]
    pairs = [
        (tt.margins(tb.features, torch.from_numpy(w)),
         jt.margins(jf, jnp.asarray(w))),
        (tt.transpose_apply(tb.features, torch.from_numpy(d)),
         jt.transpose_apply(jf, jnp.asarray(d))),
        # block 1<<16 holds every nonzero in one block; block 64 makes
        # columns span blocks and exercises the boundary combine
        (tt.csc_transpose_apply(tcsc, torch.from_numpy(d)),
         jt.csc_transpose_apply(jcsc, jnp.asarray(d))),
        (tt.csc_transpose_apply(tcsc, torch.from_numpy(d), block=64),
         jt.csc_transpose_apply(jcsc, jnp.asarray(d), block=64)),
    ]
    for got, want in pairs:
        assert str(got.dtype) == f"torch.{dtype}"
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                                   atol=rtol * np.abs(np.asarray(want)).max())


def test_dense_products_match():
    r = np.random.default_rng(3)
    X, w, d = r.normal(size=(40, 6)), r.normal(size=6), r.normal(size=40)
    np.testing.assert_allclose(
        tt.margins(torch.from_numpy(X), torch.from_numpy(w)).numpy(),
        np.asarray(jt.margins(jnp.asarray(X), jnp.asarray(w))), rtol=1e-12)
    np.testing.assert_allclose(
        tt.transpose_apply(torch.from_numpy(X), torch.from_numpy(d)).numpy(),
        np.asarray(jt.transpose_apply(jnp.asarray(X), jnp.asarray(d))),
        rtol=1e-12)


def test_make_batch_defaults():
    idx, vals, dim = _ell(4, n=10)
    labels = np.arange(10) % 2
    b = tt.make_batch(tt.SparseFeatures(idx, vals, dim), labels,
                      dtype=torch.float64, device="cpu")
    jb = jt.make_batch(jt.SparseFeatures(jnp.asarray(idx), jnp.asarray(vals),
                                         dim=dim), labels, dtype=jnp.float64)
    for got, want in ((b.labels, jb.labels), (b.offsets, jb.offsets),
                      (b.weights, jb.weights)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert b.features.indices.dtype == torch.int32
    assert (b.num_examples, b.dim) == (10, dim)
