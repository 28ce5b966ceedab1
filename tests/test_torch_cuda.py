"""The hand-written CUDA kernel on the card, against its plain version.

Skipped without a CUDA device. This file imports neither JAX nor the JAX
package, so on a GPU machine without JAX it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""

import pytest
import torch

from photon_ml_tpu_torch.ops.kernels import (
    TILE, csc_transpose_apply_kernel, multiply_prefix_sum,
    multiply_prefix_sum_plain,
)
from photon_ml_tpu_torch.types import build_csc_transpose, csc_transpose_apply

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nnz", [0, 1, 100, TILE, 3 * TILE + 17])
def test_kernel_matches_plain(cuda, nnz, dtype, with_values):
    """Per element, |kernel - plain| <= tol * cumsum(|x|) within the tile:
    the two scan in different orders; tol is a few dozen ulps."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(nnz)
    d = torch.randn(nnz, generator=gen, device=cuda, dtype=dtype)
    values = (torch.randn(nnz, generator=gen, device=cuda, dtype=dtype)
              if with_values else None)
    launches = multiply_prefix_sum.launches
    local, totals, tile = multiply_prefix_sum(values, d)
    assert multiply_prefix_sum.launches == launches + 1
    torch.cuda.synchronize()
    want, want_totals, _ = multiply_prefix_sum_plain(values, d, TILE)
    x = d if values is None else values * d
    scale = multiply_prefix_sum_plain(None, x.abs(), TILE)[0]
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    assert tile == TILE and local.shape == want.shape
    assert bool(((local - want).abs() <= tol * scale).all())
    n_tiles = totals.shape[0]
    assert torch.equal(totals, local.view(n_tiles, TILE)[:, -1])
    again = multiply_prefix_sum(values, d)
    assert torch.equal(local, again[0]) and torch.equal(totals, again[1])


def test_csc_transpose_apply_kernel_accuracy(cuda):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    n, k, dim = 1 << 15, 39, 1 << 12
    idx = torch.randint(0, dim, (n, k), generator=gen, device=cuda,
                        dtype=torch.int32)
    csc = build_csc_transpose(idx, None, dim)
    d = torch.rand(n, generator=gen, device=cuda) + 0.5
    got = csc_transpose_apply_kernel(csc, d).double()
    ref = csc_transpose_apply(csc, d.double())
    assert float(((got - ref).abs() / ref.clamp(min=1e-30)).max()) < 1e-4


def test_kernel_rejects_other_tiles(cuda):
    with pytest.raises(ValueError):
        multiply_prefix_sum(None, torch.ones(10, device=cuda), tile=1024)
