"""Native (C++) Avro training-example ingestion (a copy of
``photon_ml_tpu/io/native_reader.py`` over the port's own native loader).

SURVEY.md §7 flags the host-side decode/index pipeline as the likely real
bottleneck at TB scale — the reference leans on the JVM + Spark for decode
throughput (``AvroDataReader``, SURVEY.md §3.3); the TPU-native equivalent
is ``native/avro_decoder.cpp``. This module is the Python half:

1. parse the container header and validate the writer schema shape;
2. compile a compact per-record *field program* (capture opcodes for
   response/offset/weight/uid/features/metadataMap, structural skip opcodes
   for everything else);
3. stream raw block payloads to the decoder via ctypes (the decoder
   inflates and decodes entirely in C++, resolving feature name/term
   against the mmap'd feature index store or by FNV-1a hashing);
4. assemble the columnar outputs into the same values
   ``read_training_examples`` produces.

Any schema shape or index-map backend the native path cannot serve raises
``NativeUnsupported``; ``data_reader`` then silently falls back to the
pure-Python codec (``io/avro.py``), so the native path is a transparent
accelerator, never a new failure mode.
"""

from __future__ import annotations

import ctypes
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.io.avro import _read_header, _read_long_or_eof, _expand

# capture opcodes (must match avro_decoder.cpp)
_CAP_LABEL_D, _CAP_LABEL_ND = 0x01, 0x02
_CAP_OFFSET_D, _CAP_OFFSET_ND = 0x03, 0x04
_CAP_WEIGHT_D, _CAP_WEIGHT_ND = 0x05, 0x06
_CAP_FEATURES, _CAP_METADATA, _CAP_UID = 0x07, 0x08, 0x09
# skip opcodes
_SKIP = {"null": 0x10, "boolean": 0x11, "int": 0x12, "long": 0x12,
         "float": 0x13, "double": 0x14, "bytes": 0x15, "string": 0x15,
         "enum": 0x12}
_SKIP_UNION, _SKIP_ARRAY, _SKIP_MAP, _SKIP_RECORD = 0x16, 0x17, 0x18, 0x19


class NativeUnsupported(Exception):
    """Schema/backend shape the native decoder does not cover."""


def _stype(schema) -> str:
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    return schema["type"]


def _compile_skip(schema, out: bytearray) -> None:
    t = _stype(schema)
    if t in _SKIP:
        out.append(_SKIP[t])
    elif t == "union":
        if len(schema) > 255:
            raise NativeUnsupported("union too wide")
        out.append(_SKIP_UNION)
        out.append(len(schema))
        for branch in schema:
            _compile_skip(branch, out)
    elif t == "array":
        out.append(_SKIP_ARRAY)
        _compile_skip(schema["items"], out)
    elif t == "map":
        out.append(_SKIP_MAP)
        _compile_skip(schema["values"], out)
    elif t == "record":
        fields = schema["fields"]
        if len(fields) > 255:
            raise NativeUnsupported("record too wide")
        out.append(_SKIP_RECORD)
        out.append(len(fields))
        for f in fields:
            _compile_skip(f["type"], out)
    else:  # fixed (needs a size operand the program lacks), logical exotics
        raise NativeUnsupported(f"cannot skip schema type {t!r}")


def _nullable_double(schema) -> Optional[int]:
    """For union [null,double]-shaped fields: the null branch index."""
    if _stype(schema) == "double":
        return None  # plain double, not nullable
    if (isinstance(schema, list) and len(schema) == 2
            and "null" in schema and "double" in schema):
        return schema.index("null")
    raise NativeUnsupported(f"field is not double / [null,double]: {schema}")


def _is_feature_array(schema) -> bool:
    if _stype(schema) != "array":
        return False
    item = schema["items"]
    if _stype(item) != "record":
        return False
    fields = item["fields"]
    return ([f["name"] for f in fields] == ["name", "term", "value"]
            and [_stype(f["type"]) for f in fields]
            == ["string", "string", "double"])


def compile_field_program(schema, columns, capture_metadata: bool) -> bytes:
    """Compile the writer schema's top-level record into the decoder's field
    program. Raises NativeUnsupported for shapes the decoder cannot walk —
    including a missing features field, so the Python fallback raises the
    same KeyError it always did instead of this path silently yielding
    intercept-only rows."""
    if _stype(schema) != "record":
        raise NativeUnsupported("top-level schema is not a record")
    if not any(f["name"] == columns.features for f in schema["fields"]):
        raise NativeUnsupported(f"no '{columns.features}' field in schema")
    prog = bytearray()
    for f in schema["fields"]:
        name, ftype = f["name"], f["type"]
        if name == columns.response:
            nb = _nullable_double(ftype)
            prog += (bytes([_CAP_LABEL_D]) if nb is None
                     else bytes([_CAP_LABEL_ND, nb]))
        elif name == columns.offset:
            nb = _nullable_double(ftype)
            prog += (bytes([_CAP_OFFSET_D]) if nb is None
                     else bytes([_CAP_OFFSET_ND, nb]))
        elif name == columns.weight:
            nb = _nullable_double(ftype)
            prog += (bytes([_CAP_WEIGHT_D]) if nb is None
                     else bytes([_CAP_WEIGHT_ND, nb]))
        elif name == columns.features:
            if not _is_feature_array(ftype):
                raise NativeUnsupported(
                    f"features field shape unsupported: {ftype}")
            prog.append(_CAP_FEATURES)
        elif name == columns.metadata_map and capture_metadata:
            if (_stype(ftype) != "map"
                    or _stype(ftype["values"]) != "string"):
                raise NativeUnsupported("metadataMap is not map<string>")
            prog.append(_CAP_METADATA)
        elif name == columns.uid:
            is_union = isinstance(ftype, list)
            branches = ftype if is_union else [ftype]
            kinds = []
            for b in branches:
                bt = _stype(b)
                if bt == "null":
                    kinds.append(0)
                elif bt == "string":
                    kinds.append(1)
                elif bt in ("int", "long"):
                    kinds.append(2)
                else:
                    raise NativeUnsupported(f"uid branch {bt!r}")
            # Avro writes a branch index for every union, even 1-branch ones
            prog += bytes([_CAP_UID, int(is_union), len(kinds), *kinds])
        else:
            _compile_skip(ftype, prog)
    return bytes(prog)


# -- ctypes surface ---------------------------------------------------------
def _lib() -> ctypes.CDLL:
    from photon_ml_tpu_torch.native import load_library

    lib = load_library("avro_decoder")
    if not getattr(lib, "_avd_configured", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.avd_create.restype = ctypes.c_void_p
        lib.avd_create.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_uint32),
                                   ctypes.c_uint32, ctypes.c_uint32]
        lib.avd_decode_block.restype = ctypes.c_int
        lib.avd_decode_block.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_uint32,
        ]
        lib.avd_decode_blocks_mt.restype = ctypes.c_int
        lib.avd_decode_blocks_mt.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_uint64, ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_uint32, ctypes.c_uint32,
        ]
        for fn, res in [("avd_rows", ctypes.c_uint64),
                        ("avd_nnz", ctypes.c_uint64),
                        ("avd_labels", ctypes.POINTER(ctypes.c_double)),
                        ("avd_has_label", u8p),
                        ("avd_offsets", ctypes.POINTER(ctypes.c_double)),
                        ("avd_weights", ctypes.POINTER(ctypes.c_double)),
                        ("avd_feat_counts", ctypes.POINTER(ctypes.c_int32)),
                        ("avd_feat_values", ctypes.POINTER(ctypes.c_double)),
                        ("avd_error", ctypes.c_char_p)]:
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.avd_feat_indices.restype = ctypes.POINTER(ctypes.c_int32)
        lib.avd_feat_indices.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.avd_uid.restype = ctypes.c_int
        lib.avd_uid.argtypes = [ctypes.c_void_p, ctypes.POINTER(u8p),
                                ctypes.POINTER(u64p), ctypes.POINTER(u8p),
                                u64p]
        lib.avd_entity_col.restype = ctypes.c_int
        lib.avd_entity_col.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                       ctypes.POINTER(u8p),
                                       ctypes.POINTER(u64p),
                                       ctypes.POINTER(u8p), u64p]
        lib.avd_free.argtypes = [ctypes.c_void_p]
        lib._avd_configured = True
    return lib


class _Resolver:
    """Native feature resolution backing for one index map: either the
    mmap'd feature index store (handle + lookup fn pointer) or FNV hashing.
    Plain in-memory IndexMaps are converted into a temporary native store —
    a one-time O(#features) build that keeps per-feature lookups in C++."""

    def __init__(self, imap):
        from photon_ml_tpu_torch.io.hashing import HashingIndexMap
        from photon_ml_tpu_torch.io.paldb import PersistentIndexMap, build_store

        self._tmp = None
        self._store = None
        self.hash_dim = 0
        if isinstance(imap, HashingIndexMap):
            self.hash_dim = imap._hash_dim
        elif isinstance(imap, PersistentIndexMap):
            self._store = imap
        else:  # in-memory IndexMap (or any duck-type exposing .forward)
            forward = getattr(imap, "forward", None)
            if forward is None:
                raise NativeUnsupported(
                    f"no native resolution for {type(imap).__name__}")
            self._tmp = tempfile.NamedTemporaryFile(
                suffix=".fis", delete=False)
            self._tmp.close()
            build_store(dict(forward), self._tmp.name)
            self._store = PersistentIndexMap(self._tmp.name)

    @property
    def fis_handle(self):
        return self._store._handle if self._store is not None else None

    @property
    def fis_lookup_ptr(self):
        if self._store is None:
            return None
        return ctypes.cast(self._store._lib.fis_lookup, ctypes.c_void_p)

    def close(self):
        if self._tmp is not None:
            self._store.close()
            os.unlink(self._tmp.name)
            self._tmp = None


# Parallel decode knobs: thread count (0 = all cores) and the per-wave byte
# budget that bounds how much raw payload is staged in memory at once.
_DECODE_THREADS_ENV = "PHOTON_ML_DECODE_THREADS"
_WAVE_BYTES = 256 << 20


def _decode_threads() -> int:
    env = os.environ.get(_DECODE_THREADS_ENV)
    if env:
        n = int(env)  # loud on bad values
        if n > 0:
            return n
    return max(os.cpu_count() or 1, 1)


def _decode_file(path: str, columns, entity_columns: Sequence[str],
                 resolvers: Sequence[_Resolver], lib) -> ctypes.c_void_p:
    """Decode one container file (once, for all shards) into a fresh native
    Output handle. Blocks are staged in bounded waves and decoded by
    ``avd_decode_blocks_mt`` — container blocks are independent, so decode
    parallelizes across cores while this loop keeps at most ``_WAVE_BYTES``
    of raw payload in memory (TB-scale files never fully stage)."""
    keys = [c.encode() for c in entity_columns]
    blob = b"".join(keys)
    lens = (ctypes.c_uint32 * max(len(keys), 1))(*[len(k) for k in keys])
    n_shards = len(resolvers)
    handle = lib.avd_create(blob, lens, len(keys), n_shards)
    fis_handles = (ctypes.c_void_p * n_shards)(
        *[r.fis_handle for r in resolvers])
    lookup_ptrs = (ctypes.c_void_p * n_shards)(
        *[r.fis_lookup_ptr for r in resolvers])
    hash_dims = (ctypes.c_int64 * n_shards)(
        *[r.hash_dim for r in resolvers])
    n_threads = _decode_threads()

    def flush(wave: List[Tuple[bytes, int]], deflate: int, prog: bytes):
        if not wave:
            return
        n = len(wave)
        datas = (ctypes.c_char_p * n)(*[p for p, _ in wave])
        blens = (ctypes.c_uint64 * n)(*[len(p) for p, _ in wave])
        counts = (ctypes.c_int64 * n)(*[c for _, c in wave])
        rc = lib.avd_decode_blocks_mt(
            handle, datas, blens, counts, n, deflate, prog, len(prog),
            fis_handles, lookup_ptrs, hash_dims, n_shards, n_threads,
        )
        if rc != 0:
            err = lib.avd_error(handle)
            raise ValueError(f"{path}: native decode failed: "
                             f"{err.decode() if err else rc}")

    try:
        with open(path, "rb") as f:
            schema, codec, sync = _read_header(f, path)
            prog = compile_field_program(schema, columns,
                                         bool(entity_columns))
            deflate = 1 if codec == "deflate" else 0
            wave: List[Tuple[bytes, int]] = []
            wave_bytes = 0
            while True:
                count = _read_long_or_eof(f)
                if count is None:
                    break
                size = _read_long_or_eof(f)
                if size is None or size < 0:
                    raise ValueError(f"{path}: truncated block header")
                payload = f.read(size)
                if len(payload) != size:
                    raise ValueError(f"{path}: truncated block")
                if f.read(16) != sync:
                    raise ValueError(f"{path}: sync marker mismatch "
                                     "(corrupt file)")
                wave.append((payload, count))
                wave_bytes += size
                if wave_bytes >= _WAVE_BYTES:
                    flush(wave, deflate, prog)
                    wave, wave_bytes = [], 0
            flush(wave, deflate, prog)
    except Exception:
        lib.avd_free(handle)
        raise
    return handle


def _np_from(ptr, n, dtype):
    if n == 0:
        return np.empty(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def _ragged_strings(blob_p, off_p, n) -> List[bytes]:
    if n == 0:
        return []
    offs = np.ctypeslib.as_array(off_p, shape=(n + 1,))
    raw = (ctypes.string_at(ctypes.cast(blob_p, ctypes.c_void_p),
                            int(offs[n])) if offs[n] else b"")
    return [raw[offs[i]:offs[i + 1]] for i in range(n)]


def _pad_features(counts: np.ndarray, flat_idx: np.ndarray,
                  flat_val: np.ndarray, intercept: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged (counts, indices, values) -> padded (n,k) arrays, dropping
    unresolved (-1) entries and appending the intercept column. Matches
    ``_rows_to_host_sparse`` + the per-row intercept append."""
    n = len(counts)
    row_ids = np.repeat(np.arange(n), counts)
    keep = flat_idx >= 0
    row_ids, idx, val = row_ids[keep], flat_idx[keep], flat_val[keep]
    valid = np.bincount(row_ids, minlength=n).astype(np.int64)
    extra = 1 if intercept >= 0 else 0
    k = max(int(valid.max(initial=0)) + extra, 1)
    starts = np.zeros(n, np.int64)
    np.cumsum(valid[:-1], out=starts[1:])
    pos = np.arange(len(row_ids)) - np.repeat(starts, valid)
    indices = np.zeros((n, k), np.int32)
    values = np.zeros((n, k))
    indices[row_ids, pos] = idx
    values[row_ids, pos] = val
    if intercept >= 0:
        rows = np.arange(n)
        indices[rows, valid] = intercept
        values[rows, valid] = 1.0
    return indices, values


def read_training_examples_native(
    paths,
    index_maps: Dict[str, object],
    entity_columns: Sequence[str],
    columns,
    require_response: bool,
):
    """Native-path equivalent of ``data_reader.read_training_examples``.
    Raises NativeUnsupported when this path cannot serve the request (the
    caller falls back to the Python codec)."""
    from photon_ml_tpu_torch.game.data import HostSparse
    from photon_ml_tpu_torch.native import NativeBuildError

    try:
        lib = _lib()
    except NativeBuildError as e:
        raise NativeUnsupported(str(e)) from e

    shards = sorted(index_maps)
    if not shards:
        # scalars/entity-columns-only read (every feature shard is
        # disk-backed out of core): the decoder requires >=1 shard, and
        # the python codec handles the no-features case directly
        raise NativeUnsupported("no feature shards requested")
    resolvers: List[_Resolver] = []
    try:
        for s in shards:
            resolvers.append(_Resolver(index_maps[s]))
        file_list = _expand(paths)
        if not file_list:
            raise NativeUnsupported("no input files")
        # one decode pass per file resolves features for every shard
        per_file: List[dict] = []
        scalars: List[tuple] = []
        for path in file_list:
            handle = _decode_file(path, columns, entity_columns,
                                  resolvers, lib)
            try:
                rows = int(lib.avd_rows(handle))
                nnz = int(lib.avd_nnz(handle))
                per_file.append({
                    "counts": _np_from(lib.avd_feat_counts(handle), rows,
                                       np.int64),
                    "values": _np_from(lib.avd_feat_values(handle), nnz,
                                       np.float64),
                    "indices": [
                        _np_from(lib.avd_feat_indices(handle, si), nnz,
                                 np.int32)
                        for si in range(len(shards))
                    ],
                })
                scalars.append(_extract_scalars(
                    lib, handle, rows, entity_columns))
            finally:
                lib.avd_free(handle)
        counts = np.concatenate([p["counts"] for p in per_file])
        flat_val = np.concatenate([p["values"] for p in per_file])
        features: Dict[str, HostSparse] = {}
        for si, shard in enumerate(shards):
            imap = index_maps[shard]
            flat_idx = np.concatenate([p["indices"][si] for p in per_file])
            indices, values = _pad_features(counts, flat_idx, flat_val,
                                            imap.intercept_index)
            features[shard] = HostSparse(indices, values, imap.size)
        labels = np.concatenate([s[0] for s in scalars])
        has_label = np.concatenate([s[1] for s in scalars])
        offsets = np.concatenate([s[2] for s in scalars])
        weights = np.concatenate([s[3] for s in scalars])
        uids = [u for s in scalars for u in s[4]]
        entity_vals = {
            c: np.concatenate([s[5][c] for s in scalars])
            for c in entity_columns
        }
    finally:
        for r in resolvers:
            r.close()

    missing = ~has_label.astype(bool)
    if require_response:
        if missing.any():
            i = int(np.argmax(missing))
            raise ValueError(
                f"record uid={uids[i]} has no '{columns.response}' — "
                "training data must be labeled")
    else:
        labels = labels.copy()
        labels[missing] = np.nan
    return features, labels, offsets, weights, entity_vals, uids


def _extract_scalars(lib, handle, rows: int, entity_columns: Sequence[str]):
    labels = _np_from(lib.avd_labels(handle), rows, np.float64)
    has_label = _np_from(lib.avd_has_label(handle), rows, np.uint8)
    offs = _np_from(lib.avd_offsets(handle), rows, np.float64)
    weights = _np_from(lib.avd_weights(handle), rows, np.float64)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    blob_p, off_p, kind_p = u8p(), u64p(), u8p()
    n_uid = ctypes.c_uint64()
    lib.avd_uid(handle, ctypes.byref(blob_p), ctypes.byref(off_p),
                ctypes.byref(kind_p), ctypes.byref(n_uid))
    n_uid = int(n_uid.value)
    if n_uid == 0:  # schema has no uid field
        uids = [None] * rows
    else:
        raw = _ragged_strings(blob_p, off_p, n_uid)
        kinds = np.ctypeslib.as_array(kind_p, shape=(n_uid,))
        uids = [None if k == 0 else
                (int(r) if k == 2 else r.decode("utf-8"))
                for k, r in zip(kinds, raw)]

    entity_vals: Dict[str, np.ndarray] = {}
    for ci, col in enumerate(entity_columns):
        blob_p, off_p, pres_p = u8p(), u64p(), u8p()
        n = ctypes.c_uint64()
        lib.avd_entity_col(handle, ci, ctypes.byref(blob_p),
                           ctypes.byref(off_p), ctypes.byref(pres_p),
                           ctypes.byref(n))
        n_rows = int(n.value)
        vals = _ragged_strings(blob_p, off_p, n_rows)
        present = (np.ctypeslib.as_array(pres_p, shape=(n_rows,))
                   if n_rows else np.zeros(0, np.uint8))
        if not present.all():
            i = int(np.argmin(present))
            raise ValueError(f"record uid={uids[i]} missing entity column "
                             f"'{col}' in metadataMap")
        entity_vals[col] = np.asarray([v.decode("utf-8") for v in vals])
    return labels, has_label, offs, weights, uids, entity_vals
