"""Hand-written kernels of the sparse-gradient hot path (counterpart of
``photon_ml_tpu/ops/pallas_kernels.py``).

``csc_column_sums`` is the paths' ``X^T d``: the column sums of ``values *
d[rows]`` over the column-sorted view in one pass
(``csrc/csc_column_sums.cu``), what ``csc_transpose_apply_pallas``
computes as a gather, the Pallas kernel ``_mps_kernel`` and a boundary
combine. Every product is exact in float64 and every sum is taken in a
fixed order, rounded once to ``d``'s dtype, so a column's error does not
grow with nnz.

``multiply_prefix_sum`` is ``_mps_kernel``'s literal counterpart: the
fused product ``values * d_sorted`` and its TILE-LOCAL inclusive float64
prefix sum plus per-tile totals, the pair ``types.blocked_boundary_combine``
consumes (``csrc/multiply_prefix_sum.cu``). No path runs it; the tests
hold it against the JAX package's kernel.

``paged_gather_score`` is the serving tier's per-row random-effect score
against a device-resident paged entity table (``serve/paged_table.py``),
the counterpart of the JAX module's plain-``jnp`` ``paged_gather_score``
(``csrc/paged_gather_score.cu``). ``paged_gather_score_at`` launches the
same kernel through its second entry, which reads the table's address
from the card when it runs: the scoring session's CUDA graphs launch it,
so a graph captured once scores whichever snapshot of the table its
batch holds. The kernel sums a row in a fixed order that depends on k
alone (``paged_lanes`` lanes a row, each adding its ``paged_chunk``
entries in index order, then a halving tree over the lanes), which
``paged_gather_score_ordered_plain`` repeats bit for bit; the tests and
``chip_smoke.py`` hold the kernel to it, and no path runs it.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it takes its plain PyTorch version below, which the tests and
``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

from typing import Optional

import torch

from photon_ml_tpu_torch.types import CSCTranspose

TILE = 32768  # elements per tile, as the TPU kernel's 256 x 128 block
_FLOATS = (torch.float32, torch.float64)
COLUMN_RANGE = 2048  # nonzeros per block of the CUDA kernel (its kRange)
COLUMN_SUB = 8  # nonzeros per thread of the CUDA kernel (its kPerThread);
# load_library checks both against the library
_MAX_NNZ = (1 << 31) - 1 - COLUMN_RANGE  # int32 positions, and a range


def paged_lanes(k: int) -> int:
    """Lanes that sum one row of ``paged_gather_score``'s kernel (its
    ``group_lanes``; load_library checks the two agree)."""
    return 8 if k <= 64 else 16 if k <= 128 else 32


def paged_chunk(k: int) -> int:
    """Entries of a row each lane sums, in index order (the kernel's
    ``chunk_len``): lane ``l`` owns ``[l * c, min((l + 1) * c, k))``."""
    return -(-k // paged_lanes(k))


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


def csc_column_sums_plain(csc: CSCTranspose,
                          d: torch.Tensor) -> torch.Tensor:
    """Plain version, in the kernel's order: the exact float64 products
    ``values * d[rows]`` summed in order (``torch.segment_reduce``, which
    adds from 0, one term after another, on the CPU) at three levels:
    runs cut at the column starts and at every multiple of
    ``COLUMN_SUB``; those runs' sums per piece, cut at the column starts
    and at every multiple of ``COLUMN_RANGE``; the pieces' sums per
    column. Rounded once to ``d``'s dtype; on the CPU it gives the
    kernel's bits."""
    x = d.to(torch.float64)[csc.rows]
    if csc.values is not None:
        x = csc.values.to(torch.float64) * x
    starts = csc.col_starts.to(torch.int64)
    nnz, dim = x.shape[0], starts.shape[0] - 1
    column_start = torch.zeros(nnz, dtype=torch.bool, device=x.device)
    column_start[starts[starts < nnz]] = True
    cuts = []
    for step in (COLUMN_SUB, COLUMN_RANGE):
        cut = column_start.clone()
        cut[::step] = True
        cuts.append(torch.nonzero(cut).squeeze(1))
    sub_cuts, piece_cuts = cuts
    end = sub_cuts.new_tensor([nnz])
    subs = torch.segment_reduce(x, "sum", lengths=torch.diff(
        sub_cuts, append=end), unsafe=True)
    pieces = torch.segment_reduce(subs, "sum", lengths=torch.diff(
        torch.searchsorted(sub_cuts, piece_cuts),
        append=end.new_tensor([sub_cuts.shape[0]])), unsafe=True)
    column = torch.searchsorted(starts, piece_cuts, right=True) - 1
    return torch.segment_reduce(
        pieces, "sum", lengths=torch.bincount(column, minlength=dim),
        unsafe=True).to(d.dtype)


def _check_csc(csc: CSCTranspose, d: torch.Tensor):
    rows, starts, values = csc.rows, csc.col_starts, csc.values
    if d.dim() != 1 or d.dtype not in _FLOATS or not d.is_contiguous():
        raise ValueError("d must be a contiguous 1-D float32 or float64 "
                         f"tensor, got {tuple(d.shape)} {d.dtype}")
    for name, t in (("rows", rows), ("col_starts", starts)):
        if t.dim() != 1 or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if starts.shape[0] < 1:
        raise ValueError("col_starts must hold dim + 1 >= 1 entries")
    if rows.shape[0] > _MAX_NNZ:
        raise ValueError(f"nnz {rows.shape[0]} exceeds {_MAX_NNZ}")
    if values is not None and (values.shape != rows.shape
                               or values.dtype != d.dtype
                               or not values.is_contiguous()):
        raise ValueError(
            "values must be contiguous, of rows' shape and of d's dtype: "
            f"{tuple(values.shape)} {values.dtype} vs rows "
            f"{tuple(rows.shape)}, d {d.dtype}")
    for t in (rows, starts, values):
        if t is not None and t.device != d.device:
            raise ValueError(f"the view lies on {t.device}, d on {d.device}")


def _launch_column_sums(csc: CSCTranspose, d: torch.Tensor) -> torch.Tensor:
    from photon_ml_tpu_torch.ops.kernel_build import load_library

    lib = load_library()
    for name, t in (("rows", csc.rows), ("values", csc.values)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    nnz, dim = csc.rows.shape[0], csc.col_starts.shape[0] - 1
    n_ranges = max(-(-nnz // COLUMN_RANGE), 1)
    out = torch.empty(dim, dtype=d.dtype, device=d.device)
    # one scratch buffer: the ranges' float64 heads and tails, then their
    # int32 spanning columns
    scratch = torch.empty(2 * n_ranges + (n_ranges + 1) // 2,
                          dtype=torch.float64, device=d.device)
    head = scratch.data_ptr()
    fn = (lib.photon_csc_column_sums_f32 if d.dtype == torch.float32
          else lib.photon_csc_column_sums_f64)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(None if csc.values is None else csc.values.data_ptr(),
                 csc.rows.data_ptr(), csc.col_starts.data_ptr(),
                 d.data_ptr(), out.data_ptr(), head, head + 8 * n_ranges,
                 head + 16 * n_ranges, nnz, dim, n_ranges, stream)
    if err != 0:
        raise launch_error(lib, err, "csc_column_sums kernel launch")
    csc_column_sums.launches += 1
    return out


def csc_column_sums(csc: CSCTranspose, d: torch.Tensor) -> torch.Tensor:
    """``X^T d`` from the column-sorted view: ``out[j]`` sums ``values[p] *
    d[rows[p]]`` (``d[rows[p]]`` for implicit ones) over column ``j``'s
    nonzeros ``[col_starts[j], col_starts[j+1])``, in float64, rounded
    once to ``d``'s dtype; an empty column gives exactly 0.

    ``rows`` and ``col_starts`` (``dim + 1`` entries) are contiguous int32;
    ``values`` (or None) and ``d`` are float32 or float64 of one dtype, all
    on one device. CUDA tensors go to the kernel, CPU tensors to the plain
    version; anything else raises. ``csc_column_sums.launches`` counts the
    kernel's calls (one per call, which launches two CUDA kernels)."""
    _check_csc(csc, d)
    if d.device.type == "cuda":
        return _launch_column_sums(csc, d)
    if d.device.type == "cpu":
        return csc_column_sums_plain(csc, d)
    raise ValueError(f"unsupported device {d.device}")


csc_column_sums.launches = 0


def csc_transpose_apply_kernel(csc: CSCTranspose,
                               d: torch.Tensor) -> torch.Tensor:
    """``X^T d`` from the column-sorted view through :func:`csc_column_sums`
    (counterpart of ``csc_transpose_apply_pallas``, whose gather, scan and
    boundary combine it does in one pass: each column sum carries only its
    own float64 rounding and one rounding to ``d``'s dtype). Implicit ones
    pass no values, so the kernel reads no ones vector."""
    return csc_column_sums(csc, d)


def paged_gather_score_plain(table: torch.Tensor, slots: torch.Tensor,
                             indices: torch.Tensor,
                             values: torch.Tensor) -> torch.Tensor:
    """Plain version: one flat ``index_select`` over ``slot * D + index``
    (int64) and a row sum, then 0 selected where ``slots < 0``."""
    score = _paged_products(table, slots, indices, values).sum(dim=-1)
    return torch.where(slots >= 0, score, torch.zeros((), dtype=table.dtype,
                                                      device=table.device))


def _paged_products(table, slots, indices, values):
    dim = table.shape[1]
    flat = (slots.clamp(min=0).to(torch.int64)[:, None] * dim
            + indices.to(torch.int64))
    picked = table.reshape(-1).index_select(0, flat.reshape(-1))
    return picked.view(flat.shape) * values


def paged_gather_score_ordered_plain(table: torch.Tensor,
                                     slots: torch.Tensor,
                                     indices: torch.Tensor,
                                     values: torch.Tensor) -> torch.Tensor:
    """:func:`paged_gather_score_plain` in the kernel's order, on tensors
    of any device: the products cut into ``paged_lanes(k)`` chunks of
    ``paged_chunk(k)`` (the last ones short or empty, padded with +0,
    which adds nothing to a sum that starts at +0), each chunk summed in
    index order from 0, then the chunks' sums added first half plus second
    half until one is left (the kernel's xor butterfly), 0 selected where
    ``slots < 0``. Every step is one IEEE multiply or add, so it gives the
    kernel's bits. Used by the tests and ``chip_smoke.py`` only."""
    b, k = indices.shape
    lanes, c = paged_lanes(k), paged_chunk(k)
    padded = table.new_zeros(b, lanes * c)
    padded[:, :k] = _paged_products(table, slots, indices, values)
    chunks = padded.view(b, lanes, c)
    acc = table.new_zeros(b, lanes)
    for j in range(c):
        acc = acc + chunks[:, :, j]
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    return torch.where(slots >= 0, acc[:, 0], torch.zeros(
        (), dtype=table.dtype, device=table.device))


def _check_paged(table, slots, indices, values):
    if table.dim() != 2 or table.dtype not in _FLOATS \
            or not table.is_contiguous():
        raise ValueError("table must be a contiguous [S, D] float32 or "
                         f"float64 tensor, got {tuple(table.shape)} "
                         f"{table.dtype}")
    if slots.dim() != 1 or slots.dtype != torch.int32 \
            or not slots.is_contiguous():
        raise ValueError("slots must be a contiguous 1-D int32 tensor, got "
                         f"{tuple(slots.shape)} {slots.dtype}")
    b = slots.shape[0]
    if (indices.dim() != 2 or indices.shape[0] != b
            or indices.dtype != torch.int32 or not indices.is_contiguous()):
        raise ValueError("indices must be a contiguous [B, k] int32 tensor "
                         f"with B = {b}, got {tuple(indices.shape)} "
                         f"{indices.dtype}")
    if (values.shape != indices.shape or values.dtype != table.dtype
            or not values.is_contiguous()):
        raise ValueError("values must be contiguous, of indices' shape and "
                         f"of the table's dtype: {tuple(values.shape)} "
                         f"{values.dtype} vs {tuple(indices.shape)}, "
                         f"{table.dtype}")
    for t in (slots, indices, values):
        if t.device != table.device:
            raise ValueError(f"the batch lies on {t.device}, the table on "
                             f"{table.device}")


def _launch_paged(entry, first, table, slots, indices, values, counted):
    """Launch ``photon_paged_gather_score{entry}_f32/_f64`` with ``first``
    (the table, or the int64 that holds its address) and add one to
    ``counted.launches``."""
    from photon_ml_tpu_torch.ops.kernel_build import load_library

    lib = load_library()
    b, k = indices.shape
    out = torch.empty(b, dtype=table.dtype, device=table.device)
    if b == 0:
        return out  # nothing to launch
    fn = getattr(lib, f"photon_paged_gather_score{entry}_"
                      f"{'f32' if table.dtype == torch.float32 else 'f64'}")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(first.data_ptr(), slots.data_ptr(), indices.data_ptr(),
                 values.data_ptr(), out.data_ptr(), b, k, table.shape[1],
                 stream)
    if err != 0:
        raise launch_error(lib, err, "paged_gather_score kernel launch")
    counted.launches += 1
    return out


def paged_gather_score(table: torch.Tensor, slots: torch.Tensor,
                       indices: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """Per-row margin of a batch against a paged entity table:
    ``out[i] = sum_j table[slots[i], indices[i, j]] * values[i, j]``,
    exactly 0 where ``slots[i] < 0`` (no resident entity model).

    ``table`` is the paged coefficient buffer ``[S, D]`` (``S = pages *
    page_rows``), float32 or float64; ``slots`` int32 ``[B]``, each
    nonnegative one below ``S``; ``indices`` int32 ``[B, k]`` in ``[0, D)``
    and ``values`` ``[B, k]`` of the table's dtype, all contiguous on one
    device. The offsets are formed in 64 bits. CUDA tensors go to the
    kernel (one launch; the sum in the fixed order of
    :func:`paged_gather_score_ordered_plain`), CPU tensors to the plain
    version; anything else raises.
    ``paged_gather_score.launches`` counts the kernel's launches."""
    _check_paged(table, slots, indices, values)
    if table.device.type == "cuda":
        return _launch_paged("", table, table, slots, indices, values,
                             paged_gather_score)
    if table.device.type == "cpu":
        return paged_gather_score_plain(table, slots, indices, values)
    raise ValueError(f"unsupported device {table.device}")


paged_gather_score.launches = 0


def paged_gather_score_at(table_at: torch.Tensor, table: torch.Tensor,
                          slots: torch.Tensor, indices: torch.Tensor,
                          values: torch.Tensor) -> torch.Tensor:
    """:func:`paged_gather_score` for a CUDA graph: the kernel reads the
    table's address from ``table_at`` (one int64 on the card) when it runs,
    not when it is launched, so a graph captured once scores whichever
    table the caller's stream-ordered write left there. ``table`` is a
    table of the shape, dtype and device that address will name (the
    checks read it; the kernel does not); the caller keeps the named table
    alive until the kernel has run. CUDA tensors go to the kernel's second
    entry (one launch, counted in ``paged_gather_score.launches``), CPU
    tensors to the plain version on ``table`` itself."""
    _check_paged_at(table_at, table, slots, indices, values)
    if table.device.type == "cuda":
        return _launch_paged("_at", table_at, table, slots, indices, values,
                             paged_gather_score)
    if table.device.type == "cpu":
        return paged_gather_score_plain(table, slots, indices, values)
    raise ValueError(f"unsupported device {table.device}")


def _check_paged_at(table_at, table, slots, indices, values):
    _check_paged(table, slots, indices, values)
    if (table_at.numel() != 1 or table_at.dtype != torch.int64
            or table_at.device != table.device):
        raise ValueError("table_at must be one int64 on the table's device, "
                         f"got {tuple(table_at.shape)} {table_at.dtype} on "
                         f"{table_at.device}")


def paged_gather_score_previous(table: torch.Tensor, slots: torch.Tensor,
                                indices: torch.Tensor, values: torch.Tensor,
                                table_at: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """The kernel's previous design (one warp per row, the products summed
    in index order through shuffles), through its direct entry or, given
    ``table_at``, its pointer entry: a yardstick that ``chip_smoke.py``
    times beside the kernel, on no path. Counted in its own
    ``paged_gather_score_previous.launches``, never in
    ``paged_gather_score.launches``. CPU tensors take the plain version."""
    if table_at is None:
        _check_paged(table, slots, indices, values)
    else:
        _check_paged_at(table_at, table, slots, indices, values)
    if table.device.type == "cuda":
        at = table_at is not None
        return _launch_paged("_prev_at" if at else "_prev",
                             table_at if at else table, table, slots,
                             indices, values, paged_gather_score_previous)
    if table.device.type == "cpu":
        return paged_gather_score_plain(table, slots, indices, values)
    raise ValueError(f"unsupported device {table.device}")


paged_gather_score_previous.launches = 0
