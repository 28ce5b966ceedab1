"""The port's kernel module on the CPU, where ``multiply_prefix_sum`` takes
its plain version: held against the Pallas kernel run in interpret mode (as
``tests/test_pallas_kernels.py`` runs it), and its input checks. The CUDA
kernel itself is checked on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.ops import pallas_kernels as jpk
from photon_ml_tpu.types import build_csc_transpose, sparse_from_scipy
from photon_ml_tpu_torch import types as tt
from photon_ml_tpu_torch.interop import csc_from_numpy
from photon_ml_tpu_torch.ops.kernels import (
    csc_transpose_apply_kernel, multiply_prefix_sum,
)


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("block_rows", [256, 8])
@pytest.mark.parametrize("nnz", [1, 100, 32768, 3 * 32768 + 17])
def test_multiply_prefix_sum_matches_pallas(nnz, block_rows, with_values):
    """Same (local, totals, tile) as the Pallas kernel, padded tail included:
    f64 at rtol/atol 1e-10 (the two scan in different orders)."""
    r = np.random.default_rng(nnz)
    v, d = r.normal(size=nnz), r.normal(size=nnz)
    want = jpk.multiply_prefix_sum(
        jnp.asarray(v if with_values else np.ones(nnz)), jnp.asarray(d),
        block_rows=block_rows)
    launches = multiply_prefix_sum.launches
    local, totals, tile = multiply_prefix_sum(
        torch.from_numpy(v) if with_values else None, torch.from_numpy(d),
        tile=block_rows * 128)
    assert multiply_prefix_sum.launches == launches  # the plain version ran
    assert tile == want[2] == block_rows * 128
    np.testing.assert_allclose(local.numpy(), np.asarray(want[0]),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(totals.numpy(), np.asarray(want[1]),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("with_values", [False, True])
def test_csc_transpose_apply_kernel_matches_pallas(with_values):
    X = sp.random(300, 50, density=0.2, random_state=5, format="csr")
    feats = sparse_from_scipy(X, dtype=jnp.float64)
    values = feats.values if with_values else None
    jcsc = build_csc_transpose(feats.indices, values, feats.dim)
    d = np.random.default_rng(6).normal(size=300)
    want = jpk.csc_transpose_apply_pallas(jcsc, jnp.asarray(d))
    tcsc = csc_from_numpy(None if values is None else np.asarray(jcsc.values),
                          np.asarray(jcsc.rows), np.asarray(jcsc.col_starts),
                          dtype=torch.float64, device="cpu")
    got = csc_transpose_apply_kernel(tcsc, torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-10, atol=1e-10)


def test_kernel_blocked_accuracy_all_positive():
    """f32 through the tile-local scan + blocked combine against an f64
    reference on all-positive contributions at several tiles of growth:
    relative error < 1e-4 (as test_csc.py holds the Pallas path)."""
    r = np.random.default_rng(7)
    n, k, dim = 1 << 14, 32, 1 << 10
    indices = torch.from_numpy(r.integers(0, dim, (n, k)).astype(np.int32))
    csc = tt.build_csc_transpose(indices, None, dim)
    d = r.random(n) + 0.5
    d32 = torch.from_numpy(d).float()
    local, totals, _ = multiply_prefix_sum(None, d32[csc.rows])
    assert local.dtype == totals.dtype == torch.float64  # float64 prefix
    got = csc_transpose_apply_kernel(csc, d32)
    assert got.dtype == torch.float32
    ref = np.zeros(dim)
    np.add.at(ref, indices.numpy().reshape(-1), np.repeat(d, k))
    rel = np.abs(got.double().numpy() - ref) / np.maximum(ref, 1e-30)
    assert float(rel.max()) < 1e-4, float(rel.max())


def _bad_inputs():
    d = torch.ones(8)
    return {
        "int dtype": (None, torch.ones(8, dtype=torch.int32), 32768),
        "2-D": (None, torch.ones(2, 4), 32768),
        "non-contiguous": (None, torch.ones(16)[::2], 32768),
        "values shape": (torch.ones(7), d, 32768),
        "values dtype": (torch.ones(8, dtype=torch.float64), d, 32768),
        "values non-contiguous": (torch.ones(16)[::2], d, 32768),
        "tile 0": (None, d, 0),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_multiply_prefix_sum_rejects(case):
    values, d, tile = _bad_inputs()[case]
    with pytest.raises(ValueError):
        multiply_prefix_sum(values, d, tile)
