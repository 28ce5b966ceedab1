"""The port's kernel module on the CPU, where ``multiply_prefix_sum`` and
``csc_column_sums`` take their plain versions: held against the Pallas
kernel run in interpret mode (as ``tests/test_pallas_kernels.py`` runs it)
and the JAX package's plain transpose, and their input checks. The CUDA
kernels themselves are checked on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``)."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.ops import pallas_kernels as jpk
from photon_ml_tpu.types import CSCTranspose as JCSCTranspose
from photon_ml_tpu.types import build_csc_transpose, sparse_from_scipy
from photon_ml_tpu.types import csc_transpose_apply as jax_csc_apply
from photon_ml_tpu_torch import types as tt
from photon_ml_tpu_torch.interop import csc_from_numpy
from photon_ml_tpu_torch.ops import kernel_build, kernels
from photon_ml_tpu_torch.ops.kernels import (
    csc_column_sums, csc_column_sums_plain, csc_transpose_apply_kernel,
    multiply_prefix_sum,
)
from photon_ml_tpu_torch.utils import is_device_loss


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


# -- csc_column_sums: X^T d in one pass --------------------------------------
RANGE = 2048  # nonzeros per block of the CUDA kernel (photon_csc_range)
N_ROWS = 400


def _column_lengths(case, r):
    """Column lengths of each case over 1,000 columns; all but "nnz 0" and
    "whole ranges" hold 3 * RANGE + 17 nonzeros, so the last of the
    kernel's ranges is ragged (and JAX compiles one shape for them)."""
    dim, nnz = 1000, 3 * RANGE + 17
    lengths = np.zeros(dim, np.int64)
    if case == "one column":
        lengths[17] = nnz
    elif case == "many empty":  # 24 nonempty columns
        cols = r.choice(dim, 24, replace=False)
        lengths[cols] = r.multinomial(nnz - 24, np.full(24, 1 / 24)) + 1
    elif case != "nnz 0":
        total = 3 * RANGE if case == "whole ranges" else nnz
        lengths = r.multinomial(total, np.full(dim, 1 / dim))
    return lengths


def _column_sums_inputs(case, with_values):
    r = np.random.default_rng(list(_COLUMN_CASES).index(case))
    lengths = _column_lengths(case, r)
    col_starts = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    nnz = int(col_starts[-1])
    rows = r.integers(0, N_ROWS, nnz).astype(np.int32)
    values = r.normal(size=nnz) if with_values else None
    return values, rows, col_starts, r.normal(size=N_ROWS)


_COLUMN_CASES = ("spread", "nnz 0", "one column", "many empty",
                 "whole ranges")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("case", _COLUMN_CASES)
def test_csc_column_sums_matches_jax(case, with_values, dtype):
    """``csc_transpose_apply_kernel`` (on the CPU: ``csc_column_sums``'s
    plain version, which sums in the CUDA kernel's order) and
    ``csc_column_sums_plain`` against JAX's
    ``csc_transpose_apply_pallas`` (the Pallas kernel in interpret mode)
    and ``types.csc_transpose_apply``, on the same numpy inputs. float64:
    all four within rtol/atol 1e-10. float32: the port within one float32
    ulp of the float64 column sum ``ref`` plus ``1e-12 * sum_j |x|`` (one
    rounding of an exact float64 sum); JAX's float32 routes difference
    float32 prefixes, so they are held to ``1e-5 * sum |x|`` over all
    nonzeros."""
    values, rows, col_starts, d = _column_sums_inputs(case, with_values)
    vals = None if values is None else values.astype(dtype)
    d = d.astype(dtype)
    jcsc = JCSCTranspose(values=None if vals is None else jnp.asarray(vals),
                         rows=jnp.asarray(rows),
                         col_starts=jnp.asarray(col_starts))
    jax_outs = [np.asarray(jpk.csc_transpose_apply_pallas(jcsc,
                                                          jnp.asarray(d))),
                np.asarray(jax_csc_apply(jcsc, jnp.asarray(d)))]
    tcsc = tt.CSCTranspose(
        values=None if vals is None else torch.from_numpy(vals),
        rows=torch.from_numpy(rows), col_starts=torch.from_numpy(col_starts))
    td = torch.from_numpy(d)
    launches = csc_column_sums.launches
    ours = [csc_transpose_apply_kernel(tcsc, td).numpy(),
            csc_column_sums_plain(tcsc, td).numpy()]
    assert csc_column_sums.launches == launches  # the plain version ran
    x = d.astype(np.float64)[rows]
    if values is not None:
        x = x * vals.astype(np.float64)
    splits = col_starts[1:-1]
    ref = np.array([p.sum() for p in np.split(x, splits)])
    scale = np.array([np.abs(p).sum() for p in np.split(x, splits)])
    for out in ours + jax_outs:
        assert out.shape == ref.shape and out.dtype == dtype
    assert np.all(ours[0][scale == 0] == 0)  # empty columns: exactly 0
    if dtype == np.float64:
        for out in ours + jax_outs:
            np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-10)
        return
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    for out in ours:
        err = np.abs(out.astype(np.float64) - ref)
        assert np.all(err <= ulp + 1e-12 * scale), float(err.max())
    for out in jax_outs:
        err = np.abs(out.astype(np.float64) - ref)
        assert np.all(err <= 1e-5 * max(scale.sum(), 1e-30)), float(err.max())


def _bad_views():
    rows = torch.zeros(8, dtype=torch.int32)
    starts = torch.tensor([0, 3, 8], dtype=torch.int32)
    d = torch.ones(4)
    view = tt.CSCTranspose(values=None, rows=rows, col_starts=starts)
    return {
        "int64 rows": (tt.CSCTranspose(None, rows.long(), starts), d),
        "int64 col_starts": (tt.CSCTranspose(None, rows, starts.long()), d),
        "empty col_starts": (tt.CSCTranspose(
            None, rows, torch.zeros(0, dtype=torch.int32)), d),
        "2-D col_starts": (tt.CSCTranspose(None, rows, starts[None]), d),
        "non-contiguous rows": (tt.CSCTranspose(
            None, torch.zeros(16, dtype=torch.int32)[::2], starts), d),
        "values dtype": (tt.CSCTranspose(torch.ones(8, dtype=torch.float64),
                                         rows, starts), d),
        "values shape": (tt.CSCTranspose(torch.ones(7), rows, starts), d),
        "int d": (view, torch.ones(4, dtype=torch.int32)),
        "2-D d": (view, torch.ones(2, 2)),
        "devices": (view, torch.ones(4, device="meta")),
        "other device": (tt.CSCTranspose(None, rows.to("meta"),
                                         starts.to("meta")),
                         torch.ones(4, device="meta")),
    }


@pytest.mark.parametrize("case", list(_bad_views()))
def test_csc_column_sums_rejects(case):
    csc, d = _bad_views()[case]
    with pytest.raises(ValueError):
        csc_column_sums(csc, d)


class _RefusingLib:
    """The kernel library's C interface, whose launch returns a chosen
    CUDA status (the runtime's names and descriptions)."""

    NAMES = {700: (b"cudaErrorIllegalAddress",
                   b"an illegal memory access was encountered"),
             9: (b"cudaErrorInvalidConfiguration",
                 b"invalid configuration argument")}

    def __init__(self, status):
        self.status = status

    def photon_csc_column_sums_f32(self, *args):
        return self.status

    photon_csc_column_sums_f64 = photon_csc_column_sums_f32

    def photon_cuda_error_name(self, err):
        return self.NAMES[err][0]

    def photon_cuda_error_string(self, err):
        return self.NAMES[err][1]


@pytest.mark.parametrize("status, lost", [(700, True), (9, False)])
def test_column_sums_launch_failure_raises_uncounted(monkeypatch, status,
                                                     lost):
    """A refused launch raises the ``torch.AcceleratorError`` form of
    torch's own CUDA checks (``is_device_loss`` for a sticky status only)
    and is not counted."""
    monkeypatch.setattr(kernel_build, "load_library",
                        lambda: _RefusingLib(status))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    csc = tt.CSCTranspose(None, torch.zeros(64, dtype=torch.int32),
                          torch.tensor([0, 64], dtype=torch.int32))
    before = csc_column_sums.launches
    with pytest.raises(torch.AcceleratorError) as ei:
        kernels._launch_column_sums(csc, torch.zeros(4))
    msg = str(ei.value)
    assert msg.startswith("CUDA error: ")
    assert _RefusingLib.NAMES[status][0].decode() in msg
    assert f"cudaError {status}" in msg
    assert is_device_loss(ei.value) is lost
    assert csc_column_sums.launches == before
