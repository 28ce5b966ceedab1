"""Persistent (off-heap) feature index map backed by the native store (a
copy of ``photon_ml_tpu/io/paldb.py`` over the port's own native loader).

Equivalent of the reference's ``index.{PalDBIndexMap, PalDBIndexMapBuilder}``
(SURVEY.md §3.3; reference mount empty, paths unverified): feature
name/term → index maps too large for a per-process Python dict are built
once into an mmap-backed file (``photon_ml_tpu_torch/native/feature_index_store
.cpp``) and opened with zero parse time. Duck-types ``IndexMap`` (size,
intercept_index, index_of, inverse, save/load) so every driver accepts
either backend.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.io.schemas import INTERCEPT_KEY, feature_key
from photon_ml_tpu_torch.native import load_library

_ENC = "utf-8"


def _lib() -> ctypes.CDLL:
    lib = load_library("feature_index_store")
    if not getattr(lib, "_fis_configured", False):
        lib.fis_build.restype = ctypes.c_int
        lib.fis_build.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_uint64, ctypes.c_char_p,
        ]
        lib.fis_open.restype = ctypes.c_void_p
        lib.fis_open.argtypes = [ctypes.c_char_p]
        lib.fis_close.argtypes = [ctypes.c_void_p]
        lib.fis_size.restype = ctypes.c_uint64
        lib.fis_size.argtypes = [ctypes.c_void_p]
        lib.fis_num_slots.restype = ctypes.c_uint64
        lib.fis_num_slots.argtypes = [ctypes.c_void_p]
        lib.fis_lookup.restype = ctypes.c_int32
        lib.fis_lookup.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint32]
        lib.fis_lookup_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.fis_entry.restype = ctypes.c_int
        lib.fis_entry.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.fis_keys_blob.restype = ctypes.c_void_p
        lib.fis_keys_blob.argtypes = [ctypes.c_void_p]
        lib._fis_configured = True
    return lib


def build_store(forward: Dict[str, int], path: str) -> None:
    """Write a persistent store from a key→index dict (the
    PalDBIndexMapBuilder role)."""
    lib = _lib()
    keys = [k.encode(_ENC) for k in forward]
    n = len(keys)
    lens = np.array([len(k) for k in keys], np.uint32)
    offsets = np.zeros(n, np.uint64)
    if n:
        np.cumsum(lens[:-1], out=offsets[1:])
    blob = b"".join(keys)
    indices = np.fromiter(forward.values(), np.int32, count=n)
    rc = lib.fis_build(
        blob,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_uint64(n),
        path.encode(),
    )
    if rc != 0:
        raise OSError(-rc, f"fis_build failed for {path} (rc={rc})")


class PersistentIndexMap:
    """Read-only mmap-backed feature index map (the PalDBIndexMap role)."""

    def __init__(self, path: str):
        self.path = path
        self._lib = _lib()
        self._handle = self._lib.fis_open(path.encode())
        if not self._handle:
            raise OSError(f"cannot open feature index store: {path}")
        self._intercept = self._lookup_key(INTERCEPT_KEY.encode(_ENC))

    # -- IndexMap duck-type surface ------------------------------------------
    @property
    def size(self) -> int:
        return int(self._lib.fis_size(self._handle))

    @property
    def intercept_index(self) -> int:
        return self._intercept

    def index_of(self, name: str, term: str = "") -> Optional[int]:
        idx = self._lookup_key(feature_key(name, term).encode(_ENC))
        return None if idx < 0 else idx

    def inverse(self) -> Dict[int, str]:
        return {idx: key for key, idx in self.items()}

    @property
    def forward(self) -> Dict[str, int]:
        """Materialized key→index dict. Only for small-map interop paths
        (e.g. per-shard filtering); bulk lookups should use lookup_batch."""
        return dict(self.items())

    def digest(self) -> str:
        """Feature-space fingerprint (chunk-cache invalidation key): the
        store file's content hash. O(file) once per job — the store is
        immutable after build, so callers may cache the result."""
        import hashlib

        h = hashlib.sha256()
        with open(self.path, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
        return h.hexdigest()

    def save(self, path: str) -> None:
        """Copy the store file (saving alongside models, as drivers do)."""
        if os.path.abspath(path) != os.path.abspath(self.path):
            import shutil

            shutil.copyfile(self.path, path)

    @classmethod
    def load(cls, path: str) -> "PersistentIndexMap":
        return cls(path)

    @classmethod
    def build(cls, forward: Dict[str, int], path: str) -> "PersistentIndexMap":
        build_store(forward, path)
        return cls(path)

    # -- extras ---------------------------------------------------------------
    def _lookup_key(self, key: bytes) -> int:
        return int(self._lib.fis_lookup(self._handle, key,
                                        ctypes.c_uint32(len(key))))

    def items(self) -> Iterator[Tuple[str, int]]:
        keys_ptr = self._lib.fis_keys_blob(self._handle)
        key_off = ctypes.c_uint64()
        key_len = ctypes.c_uint32()
        index = ctypes.c_int32()
        for slot in range(int(self._lib.fis_num_slots(self._handle))):
            if self._lib.fis_entry(self._handle, ctypes.c_uint64(slot),
                                   ctypes.byref(key_off), ctypes.byref(key_len),
                                   ctypes.byref(index)):
                key = ctypes.string_at(keys_ptr + key_off.value, key_len.value)
                yield key.decode(_ENC), int(index.value)

    def lookup_batch(self, keys) -> np.ndarray:
        """Vectorized lookup: list of key strings -> int32 indices (-1 if
        absent). One C call for the whole batch — the bulk ingestion path."""
        enc = [k.encode(_ENC) for k in keys]
        n = len(enc)
        lens = np.array([len(k) for k in enc], np.uint32)
        offsets = np.zeros(n, np.uint64)
        if n:
            np.cumsum(lens[:-1], out=offsets[1:])
        blob = b"".join(enc)
        out = np.empty(n, np.int32)
        self._lib.fis_lookup_batch(
            self._handle, blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_uint64(n),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.fis_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def load_index_map(path: str):
    """Open either backend by sniffing the file: native store (binary magic)
    or JSON, dispatched on the parsed top-level key — never on raw-byte
    substrings, which key order/whitespace or feature names could fool.
    Drivers use this so --index-map takes any format."""
    with open(path, "rb") as f:
        head = f.read(1)
    if head != b"{":  # native store starts with its binary magic
        return PersistentIndexMap(path)
    import json

    with open(path) as f:
        doc = json.load(f)
    if "hashing" in doc:
        from photon_ml_tpu_torch.io.hashing import HashingIndexMap

        cfg = doc["hashing"]
        return HashingIndexMap(cfg["dim"], add_intercept=cfg["add_intercept"])
    from photon_ml_tpu_torch.io.index_map import IndexMap

    return IndexMap(doc["features"])
