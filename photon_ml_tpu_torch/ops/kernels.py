"""Hand-written kernels of the sparse-gradient hot path (counterpart of
``photon_ml_tpu/ops/pallas_kernels.py``).

``multiply_prefix_sum`` replaces the Pallas kernel ``_mps_kernel``: the fused
product ``values * d_sorted`` and its TILE-LOCAL inclusive prefix sum plus
per-tile totals, exactly the pair ``types.blocked_boundary_combine``
consumes. The product is formed in the input dtype; the prefix and totals
are float64 whatever the input dtype, so each column sum rounds once, after
the boundary difference (see the kernel's header note). On a CUDA tensor it launches the CUDA kernel
(``csrc/multiply_prefix_sum.cu``) or raises; on a CPU tensor it takes the
plain PyTorch version below, which the tests and ``chip_smoke.py`` hold the
kernel against.
"""

from __future__ import annotations

from typing import Optional

import torch

from photon_ml_tpu_torch.types import CSCTranspose, blocked_boundary_combine

TILE = 32768  # elements per tile, as the TPU kernel's 256 x 128 block
_FLOATS = (torch.float32, torch.float64)


def multiply_prefix_sum_plain(values: Optional[torch.Tensor],
                              d_sorted: torch.Tensor, tile: int = TILE):
    """Plain version: a per-tile float64 ``torch.cumsum`` of the zero-padded
    product. Returns ``(local [n_tiles * tile], totals [n_tiles], tile)``,
    both float64."""
    nnz = d_sorted.shape[0]
    n_tiles = max(-(-nnz // tile), 1)
    x = (d_sorted if values is None else values * d_sorted).to(torch.float64)
    padded = torch.zeros(n_tiles * tile, dtype=x.dtype, device=x.device)
    padded[:nnz] = x
    local = torch.cumsum(padded.view(n_tiles, tile), dim=1)
    return local.reshape(-1), local[:, -1].contiguous(), tile


def _check(values, d_sorted, tile):
    if not isinstance(tile, int) or tile <= 0:
        raise ValueError(f"tile must be a positive int, got {tile!r}")
    if d_sorted.dim() != 1 or d_sorted.dtype not in _FLOATS:
        raise ValueError("d_sorted must be a 1-D float32 or float64 tensor, "
                         f"got {tuple(d_sorted.shape)} {d_sorted.dtype}")
    if not d_sorted.is_contiguous():
        raise ValueError("d_sorted must be contiguous")
    if values is not None:
        if (values.shape != d_sorted.shape or values.dtype != d_sorted.dtype
                or values.device != d_sorted.device):
            raise ValueError(
                "values must match d_sorted in shape, dtype and device: "
                f"{tuple(values.shape)} {values.dtype} {values.device} vs "
                f"{tuple(d_sorted.shape)} {d_sorted.dtype} {d_sorted.device}")
        if not values.is_contiguous():
            raise ValueError("values must be contiguous")


def launch_error(lib, err: int, where: str) -> RuntimeError:
    """The ``torch.AcceleratorError`` torch's own CUDA checks raise for the
    CUDA runtime status ``err`` (its name and description from the kernel
    library's runtime), so ``utils.is_device_loss`` can tell a sticky
    error (the context is gone: exit 75) from one that is not."""
    from photon_ml_tpu_torch.utils.config import cuda_error

    return cuda_error(lib.photon_cuda_error_name(err).decode(),
                      lib.photon_cuda_error_string(err).decode(),
                      f"{where} (cudaError {err})")


def _launch(values, d_sorted, tile):
    from photon_ml_tpu_torch.ops.kernel_build import load_library

    lib = load_library()
    if tile != lib.photon_mps_tile():
        raise ValueError(f"the CUDA kernel scans tiles of "
                         f"{lib.photon_mps_tile()}, not {tile}")
    for name, t in (("d_sorted", d_sorted), ("values", values)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    nnz = d_sorted.shape[0]
    n_tiles = max(-(-nnz // tile), 1)
    local = torch.empty(n_tiles * tile, dtype=torch.float64,
                        device=d_sorted.device)
    totals = torch.empty(n_tiles, dtype=torch.float64, device=d_sorted.device)
    fn = (lib.photon_mps_f32 if d_sorted.dtype == torch.float32
          else lib.photon_mps_f64)
    with torch.cuda.device(d_sorted.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(None if values is None else values.data_ptr(),
                 d_sorted.data_ptr(), local.data_ptr(), totals.data_ptr(),
                 nnz, n_tiles, stream)
    if err != 0:
        raise launch_error(lib, err, "multiply_prefix_sum kernel launch")
    multiply_prefix_sum.launches += 1
    return local, totals, tile


def multiply_prefix_sum(values: Optional[torch.Tensor],
                        d_sorted: torch.Tensor, tile: int = TILE):
    """TILE-LOCAL inclusive prefix sums of ``values * d_sorted`` (both
    [nnz], float32 or float64; ``values=None`` is implicit ones), plus
    per-tile totals.

    Returns ``(local, totals, tile)``: ``local`` is float64 [n_tiles * tile]
    with the prefix restarting every ``tile`` elements; beyond nnz each
    element of the last tile holds that tile's total. CUDA tensors go to the kernel (tile
    32768 only), CPU tensors to the plain version; anything else raises.
    ``multiply_prefix_sum.launches`` counts kernel launches."""
    _check(values, d_sorted, tile)
    if d_sorted.device.type == "cuda":
        return _launch(values, d_sorted, tile)
    if d_sorted.device.type == "cpu":
        return multiply_prefix_sum_plain(values, d_sorted, tile)
    raise ValueError(f"unsupported device {d_sorted.device}")


multiply_prefix_sum.launches = 0


def csc_transpose_apply_kernel(csc: CSCTranspose,
                               d: torch.Tensor) -> torch.Tensor:
    """``X^T d`` from the column-sorted view through
    :func:`multiply_prefix_sum` and the shared blocked boundary combine
    (counterpart of ``csc_transpose_apply_pallas``; same accuracy
    guarantee: the error does not grow with nnz; the combine runs in float64
    and rounds each column sum once). Implicit ones pass ``values=None``, so
    the kernel reads no ones vector."""
    local, totals, tile = multiply_prefix_sum(csc.values, d[csc.rows])
    return blocked_boundary_combine(local, totals, csc.col_starts,
                                    tile).to(d.dtype)
