"""Native (C++) host libraries, built on demand with the system ``g++``
and loaded via ctypes (a copy of ``photon_ml_tpu/native/__init__.py``; the
port keeps its own copies of the C++ sources beside this file).

``feature_index_store.cpp`` is the persistent feature index store (the
PalDB replacement) and ``avro_decoder.cpp`` the Avro training-example
decoder. Both run on the host; neither is a device kernel. Libraries build
at first use into ``_build/`` beside the sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_BUILD_LOCK = threading.Lock()
_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))


class NativeBuildError(RuntimeError):
    pass


def _source_digest(src_path: str, extra: tuple = ()) -> str:
    """Digest of source + build flags — flag changes must rebuild too."""
    h = hashlib.sha256()
    with open(src_path, "rb") as f:
        h.update(f.read())
    for item in extra:
        h.update(item.encode())
    return h.hexdigest()[:16]


def _build_dir() -> str:
    """Writable cache dir for compiled libraries: the package tree when
    writable (repo checkouts), else a per-user cache (pip installs into
    root-owned site-packages must not be written to)."""
    in_tree = os.path.join(_NATIVE_DIR, "_build")
    probe_dir = in_tree if os.path.isdir(in_tree) else _NATIVE_DIR
    if os.access(probe_dir, os.W_OK):
        return in_tree
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "photon_ml_tpu_torch", "native")


# extra link flags per native library
_LINK_FLAGS = {"avro_decoder": ("-pthread", "-lz")}


def build_library(name: str, *, cxx: str | None = None) -> str:
    """Compile ``<name>.cpp`` into a cached ``.so`` and return its path.
    The cache key includes a source digest, so editing the .cpp rebuilds."""
    src = os.path.join(_NATIVE_DIR, f"{name}.cpp")
    if not os.path.exists(src):
        raise NativeBuildError(f"no such native source: {src}")
    out_dir = _build_dir()
    flags = _LINK_FLAGS.get(name, ())
    lib = os.path.join(out_dir, f"lib{name}-{_source_digest(src, flags)}.so")
    with _BUILD_LOCK:
        if os.path.exists(lib):
            return lib
        os.makedirs(out_dir, exist_ok=True)
        cxx = cxx or os.environ.get("CXX", "g++")
        # a per-process temporary: test workers may build the same library
        # at once, and each publishes its own complete file by rename
        tmp = f"{lib}.tmp-{os.getpid()}"
        cmd = [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", src, "-o",
               tmp, *flags]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise NativeBuildError(f"compiler not found: {cxx}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"native build failed ({' '.join(cmd)}):\n{proc.stderr}"
            )
        os.replace(tmp, lib)
    return lib


_LOADED: dict[str, ctypes.CDLL] = {}


def load_library(name: str) -> ctypes.CDLL:
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(build_library(name))
    return _LOADED[name]
