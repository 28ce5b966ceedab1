"""Build and load the port's hand-written CUDA kernels.

``nvcc`` compiles every source under ``ops/csrc/`` for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use into ``ops/_build/`` (not committed), named by a hash of
the sources so an edited source is never served a stale library. Nothing
here runs at import time; a failed build raises with the compiler's output.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

from photon_ml_tpu_torch.ops.kernels import (
    COLUMN_RANGE, COLUMN_SUB, paged_chunk, paged_lanes,
)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# the row widths at which the loader holds paged_gather_score's order
# against its plain twin's: every k up to 1,024, then powers of two
PAGED_ORDER_KS = list(range(1025)) + [1 << p for p in range(11, 31)]


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libphoton_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc is needed to build "
                           "the port's kernels; set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile the sources into the library unless it is already built;
    ``-Xptxas -v`` writes each kernel's registers and spills to
    ``<library>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in sources]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        logs = list(pool.map(_run, [
            [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
             "-Xcompiler", "-fPIC", "-c", "-o", str(o), str(p)]
            for p, o in zip(sources, objs)]))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    logs.append(_run([_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objs)]))
    for o in objs:
        o.unlink()
    so.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, so)  # atomic: a concurrent build never loads a half file
    return so


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use, with every function's
    argument types declared (pointers and the stream as ``c_void_p``);
    raises if its column-sum order or its paged score order is not the
    plain version's."""
    lib = ctypes.CDLL(str(build()))
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    for name in ("photon_mps_f32", "photon_mps_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, ptr]
        fn.restype = ctypes.c_int
    for name in ("photon_csc_column_sums_f32", "photon_csc_column_sums_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 8 + [i64, i64, i64, ptr]
        fn.restype = ctypes.c_int
    for entry in ("", "_at", "_prev", "_prev_at"):
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"photon_paged_gather_score{entry}_{dt}")
            fn.argtypes = [ptr] * 5 + [i64, i64, i64, ptr]
            fn.restype = ctypes.c_int
    lib.photon_paged_empty.argtypes = [i64, i64, ptr]
    lib.photon_paged_empty.restype = ctypes.c_int
    lib.photon_paged_lanes.argtypes = [i64]
    lib.photon_paged_lanes.restype = ctypes.c_int
    lib.photon_paged_chunk.argtypes = [i64]
    lib.photon_paged_chunk.restype = i64
    for name in ("photon_mps_tile", "photon_csc_range", "photon_csc_sub"):
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = ctypes.c_int
    # csc_column_sums_plain repeats the kernel's summation order
    got = (lib.photon_csc_range(), lib.photon_csc_sub())
    if got != (COLUMN_RANGE, COLUMN_SUB):
        raise RuntimeError(
            f"csc_column_sums sums ranges of {got[0]} in runs of {got[1]}, "
            f"its plain version {COLUMN_RANGE} and {COLUMN_SUB}")
    check_paged_order(lib)
    for name in ("photon_cuda_error_name", "photon_cuda_error_string"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
    return lib


def check_paged_order(lib) -> None:
    """Raise unless the library's paged_gather_score cuts a row of every
    width in ``PAGED_ORDER_KS`` into the lanes and chunks that
    ``paged_gather_score_ordered_plain`` forms."""
    for k in PAGED_ORDER_KS:
        got = (lib.photon_paged_lanes(k), lib.photon_paged_chunk(k))
        if got != (paged_lanes(k), paged_chunk(k)):
            raise RuntimeError(
                f"paged_gather_score sums a row of k = {k} in {got[0]} "
                f"lanes of {got[1]}, its ordered plain twin in "
                f"{paged_lanes(k)} of {paged_chunk(k)}")
