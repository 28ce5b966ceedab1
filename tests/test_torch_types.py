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


@pytest.mark.parametrize("pad_to", [None, 9])
def test_sparse_conversions_match(pad_to):
    """``sparse_from_scipy`` / ``sparse_from_rows`` / scipy input to
    ``make_batch`` give JAX's ELL arrays bit for bit; ``todense`` and the
    row slices of both packages agree exactly."""
    import scipy.sparse as sp

    r = np.random.default_rng(5)
    dense = r.normal(size=(12, 9)) * (r.random((12, 9)) < 0.35)
    mat = sp.csr_matrix(dense)
    got = tt.sparse_from_scipy(mat, dtype=torch.float64, pad_to=pad_to,
                               device="cpu")
    want = jt.sparse_from_scipy(mat, dtype=jnp.float64, pad_to=pad_to)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.todense().numpy(), dense)
    np.testing.assert_array_equal(got.todense().numpy(),
                                  np.asarray(want.todense()))
    rows = [list(zip(np.nonzero(row)[0], row[np.nonzero(row)[0]]))
            for row in dense]
    from_rows = tt.sparse_from_rows(rows, 9, dtype=torch.float64,
                                    pad_to=pad_to, device="cpu")
    want_rows = jt.sparse_from_rows(rows, 9, dtype=jnp.float64,
                                    pad_to=pad_to)
    np.testing.assert_array_equal(from_rows.indices.numpy(),
                                  np.asarray(want_rows.indices))
    np.testing.assert_array_equal(from_rows.values.numpy(),
                                  np.asarray(want_rows.values))
    b = tt.make_batch(mat, np.ones(12), dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(b.features.todense().numpy(), dense)
    sl, jsl = b.slice_rows(3, 5), jt.make_batch(
        mat, np.ones(12), dtype=jnp.float64).slice_rows(3, 5)
    assert sl.num_examples == 5 and sl.features.num_rows == 5
    np.testing.assert_array_equal(sl.features.todense().numpy(),
                                  np.asarray(jsl.features.todense()))
    moved = sl.with_offsets(torch.full((5,), 2.0, dtype=torch.float64))
    assert float(moved.offsets.sum()) == 10.0 and moved.labels is sl.labels
    with pytest.raises(ValueError, match="pad_to"):
        tt.sparse_from_scipy(mat, pad_to=1, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        tt.sparse_from_rows([[(9, 1.0)]], 9, device="cpu")
    with pytest.raises(ValueError, match="negative"):
        tt.sparse_from_rows([[(-1, 1.0)]], 9, device="cpu")


def test_dense_batch_slice_rows():
    X = np.arange(24.0).reshape(8, 3)
    b = tt.make_batch(X, np.zeros(8), dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(b.slice_rows(2, 3).features.numpy(),
                                  X[2:5])
