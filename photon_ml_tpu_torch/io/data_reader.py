"""Avro training-data reader/writer honoring the TrainingExampleAvro contract
(counterpart of ``photon_ml_tpu/io/data_reader.py``: the bulk reader, the
chunked scoring reader, the record parser and the writer).

Equivalent of the reference's ``data.avro.AvroDataReader`` +
``NameAndTermFeatureMapUtils`` (SURVEY.md §3.3; reference mount empty):
reads records with name/term/value feature arrays, maps them through
per-shard feature index maps into padded sparse matrices, and carries
response/offset/weight/uid plus entity-id columns (from ``metadataMap``)
for GAME random effects.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.game.data import HostSparse
from photon_ml_tpu_torch.io.avro import iter_avro_records, write_avro_file
from photon_ml_tpu_torch.io.index_map import IndexMap
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA
import dataclasses


@dataclasses.dataclass(frozen=True)
class InputColumnsNames:
    """Record-field name overrides — the reference's ``InputColumnsNames``
    (SURVEY.md §3.2 GAME data layer row): datasets whose response / offset /
    weight / uid / features / metadata fields use different names are read
    without rewriting."""

    response: str = "response"
    offset: str = "offset"
    weight: str = "weight"
    uid: str = "uid"
    features: str = "features"
    metadata_map: str = "metadataMap"

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "InputColumnsNames":
        if not d:
            return cls()
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown input column keys: {sorted(unknown)}")
        return cls(**d)


def read_training_examples(
    paths,
    index_maps: IndexMap | Dict[str, IndexMap],
    entity_columns: Sequence[str] = (),
    columns: Optional[InputColumnsNames] = None,
    require_response: bool = True,
):
    """Read Avro training examples into per-shard sparse features.

    Returns (features: dict shard->HostSparse, labels, offsets, weights,
    entity_ids: dict column->np.ndarray, uids: list). Features absent from a
    shard's index map are dropped for that shard (per-shard feature
    selection, as in the reference's feature bags).

    Decoding runs through the native C++ decoder (io/native_reader.py —
    the host-ingestion hot path, SURVEY.md §7) whenever the writer schema
    and index-map backend support it, falling back to the pure-Python codec
    otherwise. Set PHOTON_ML_TPU_NO_NATIVE=1 to force the Python path."""
    return decode_training_examples(paths, index_maps, entity_columns,
                                    columns, require_response)[0]


def decode_training_examples(
    paths,
    index_maps: IndexMap | Dict[str, IndexMap],
    entity_columns: Sequence[str] = (),
    columns: Optional[InputColumnsNames] = None,
    require_response: bool = True,
):
    """:func:`read_training_examples` plus the name of the decoder that ran:
    returns ``(result, decoder)`` with ``decoder`` ``"native"`` or
    ``"python"``, so a driver can record which one served its data."""
    if not isinstance(index_maps, dict):  # any IndexMap-like backend
        index_maps = {"global": index_maps}
    cols = columns or InputColumnsNames()
    if not index_maps:
        # scalars/entity-columns-only read: keep the fast native decode by
        # resolving against a 1-wide dummy hash shard and dropping it
        from photon_ml_tpu_torch.io.hashing import HashingIndexMap

        out, decoder = decode_training_examples(
            paths, {"__scalars__": HashingIndexMap(1, add_intercept=False)},
            entity_columns, cols, require_response)
        return ({},) + out[1:], decoder
    if not os.environ.get("PHOTON_ML_TPU_NO_NATIVE"):
        from photon_ml_tpu_torch.io.native_reader import (
            NativeUnsupported,
            read_training_examples_native,
        )

        try:
            return read_training_examples_native(
                paths, index_maps, entity_columns, cols, require_response
            ), "native"
        except NativeUnsupported:
            pass
    rows_per_shard: Dict[str, List[List[Tuple[int, float]]]] = {
        s: [] for s in index_maps
    }
    labels: List[float] = []
    offsets: List[float] = []
    weights: List[float] = []
    uids: List = []
    entity_vals: Dict[str, List] = {c: [] for c in entity_columns}

    for rec in iter_avro_records(paths):
        label, offset, weight, uid, evals, shard_rows = _parse_record(
            rec, cols, index_maps, entity_columns, require_response)
        labels.append(label)
        offsets.append(offset)
        weights.append(weight)
        uids.append(uid)
        for c, v in zip(entity_columns, evals):
            entity_vals[c].append(v)
        for shard, row in shard_rows.items():
            rows_per_shard[shard].append(row)

    features = {
        shard: _rows_to_host_sparse(rows, index_maps[shard].size)
        for shard, rows in rows_per_shard.items()
    }
    return (
        features,
        np.asarray(labels),
        np.asarray(offsets),
        np.asarray(weights),
        {c: np.asarray(v) for c, v in entity_vals.items()},
        uids,
    ), "python"


def _parse_record(rec, cols: InputColumnsNames, index_maps, entity_columns,
                  require_response: bool):
    """Parse ONE TrainingExampleAvro record — the single definition of the
    record contract (the JAX package's chunked scoring reader shares it).
    Returns (label, offset, weight, uid, entity_values, per-shard rows)."""
    val = rec.get(cols.response)
    if val is None:
        if require_response:
            raise ValueError(
                f"record uid={rec.get(cols.uid)} has no "
                f"'{cols.response}' — training data must be labeled")
        label = float("nan")
    else:
        label = float(val)
    offset = (float(rec[cols.offset])
              if rec.get(cols.offset) is not None else 0.0)
    weight = (float(rec[cols.weight])
              if rec.get(cols.weight) is not None else 1.0)
    uid = rec.get(cols.uid)
    meta = rec.get(cols.metadata_map) or {}
    evals = []
    for c in entity_columns:
        if c not in meta:
            raise ValueError(f"record uid={uid} missing entity column "
                             f"'{c}' in {cols.metadata_map}")
        evals.append(meta[c])
    shard_rows = {}
    for shard, imap in index_maps.items():
        row: List[Tuple[int, float]] = []
        for feat in rec[cols.features]:
            idx = imap.index_of(feat["name"], feat.get("term", ""))
            if idx is not None:
                row.append((idx, float(feat["value"])))
        if imap.intercept_index >= 0:
            row.append((imap.intercept_index, 1.0))
        shard_rows[shard] = row
    return label, offset, weight, uid, evals, shard_rows


def _rows_to_host_sparse(rows: List[List[Tuple[int, float]]], dim: int) -> HostSparse:
    n = len(rows)
    k = max(max((len(r) for r in rows), default=0), 1)
    indices = np.zeros((n, k), np.int32)
    values = np.zeros((n, k))
    for i, row in enumerate(rows):
        for j, (idx, val) in enumerate(row):
            indices[i, j] = idx
            values[i, j] = val
    return HostSparse(indices, values, dim)


def write_training_examples(
    path: str,
    features: Iterable[Iterable[Tuple[str, str, float]]],
    labels: Optional[Sequence[float]] = None,
    offsets: Optional[Sequence[float]] = None,
    weights: Optional[Sequence[float]] = None,
    entity_ids: Optional[Dict[str, Sequence]] = None,
    uids: Optional[Sequence] = None,
    codec: str = "deflate",
    block_size: int = 4096,
) -> None:
    """Write TrainingExampleAvro records; ``features`` yields per-row lists
    of (name, term, value). ``labels=None`` writes unlabeled scoring data.
    ``block_size`` (records per container block) controls the granularity
    available to block-level consumers."""
    entity_ids = entity_ids or {}

    def records():
        for i, row in enumerate(features):
            label = None if labels is None else labels[i]
            yield {
                "uid": str(uids[i]) if uids is not None else str(i),
                "response": None if label is None else float(label),
                "offset": float(offsets[i]) if offsets is not None else None,
                "weight": float(weights[i]) if weights is not None else None,
                "features": [
                    {"name": name, "term": term, "value": float(v)}
                    for name, term, v in row
                ],
                "metadataMap": {c: str(vals[i]) for c, vals in entity_ids.items()},
            }

    write_avro_file(path, records(), TRAINING_EXAMPLE_SCHEMA, codec=codec,
                    block_size=block_size)


def feature_tuples_from_dense(X: np.ndarray, prefix: str = "f"):
    """Helper for fixtures: dense matrix -> per-row (name, term, value)."""
    for row in np.asarray(X):
        yield [(f"{prefix}{j}", "", float(v)) for j, v in enumerate(row) if v != 0]


def read_training_examples_chunked(
    paths,
    index_maps: IndexMap | Dict[str, IndexMap],
    entity_columns: Sequence[str] = (),
    columns: Optional[InputColumnsNames] = None,
    chunk_rows: int = 1 << 16,
    require_response: bool = True,
):
    """Generator form of :func:`read_training_examples` for out-of-core
    bulk scoring: yields windows of ~``chunk_rows`` rows as the same tuple
    (features-per-shard, labels, offsets, weights, entity_vals, uids),
    decoding container block ranges one window at a time, so host RAM holds
    one window, never the dataset. Windows follow block boundaries (Avro
    blocks are the atomic decode unit): a window's row count is the
    smallest block-aligned count >= ``chunk_rows`` (the final window is
    whatever remains).

    Unlike the training-path ``io.stream_source.AvroChunkSource`` (one
    shard, fixed shapes, re-iterable), this reader serves the scoring
    driver: all feature shards resolve in one decode, uid and entity
    columns are captured, and one forward pass per window is the whole
    consumption pattern."""
    from photon_ml_tpu_torch.io.stream_source import scan_blocks

    if not isinstance(index_maps, dict):
        index_maps = {"global": index_maps}
    cols = columns or InputColumnsNames()
    blocks, _schema = scan_blocks(paths)

    windows: List[List] = []
    cur: List = []
    rows = 0
    for b in blocks:
        cur.append(b)
        rows += b.count
        if rows >= chunk_rows:
            windows.append(cur)
            cur, rows = [], 0
    if cur:
        windows.append(cur)

    if not os.environ.get("PHOTON_ML_TPU_NO_NATIVE"):
        from photon_ml_tpu_torch.io.native_reader import NativeUnsupported

        try:
            yield from _chunked_native(windows, index_maps, entity_columns,
                                       cols, require_response)
            return
        except NativeUnsupported:
            pass
    yield from _chunked_python(windows, index_maps, entity_columns, cols,
                               require_response)


def _chunked_native(windows, index_maps, entity_columns, cols,
                    require_response):
    import ctypes

    from photon_ml_tpu_torch.io.avro import _read_header
    from photon_ml_tpu_torch.io.native_reader import (
        NativeUnsupported, _Resolver, _decode_threads, _extract_scalars, _lib,
        _np_from, _pad_features, compile_field_program,
    )
    from photon_ml_tpu_torch.native import NativeBuildError

    try:
        lib = _lib()
    except NativeBuildError as e:
        raise NativeUnsupported(str(e)) from e
    shards = sorted(index_maps)
    if not shards:
        raise NativeUnsupported("no feature shards requested")
    # every file's field program is compiled before the first window is
    # yielded: NativeUnsupported must fire before the caller's Python
    # fallback could replay windows already yielded
    prog_cache: Dict[str, bytes] = {}
    for w_ in windows:
        for b_ in w_:
            if b_.path not in prog_cache:
                with open(b_.path, "rb") as fh:
                    schema, _, _ = _read_header(fh, b_.path)
                prog_cache[b_.path] = compile_field_program(
                    schema, cols, bool(entity_columns))
    resolvers = [_Resolver(index_maps[s]) for s in shards]
    try:
        keys = [c.encode() for c in entity_columns]
        blob = b"".join(keys)
        lens = (ctypes.c_uint32 * max(len(keys), 1))(
            *[len(k) for k in keys])
        n_shards = len(resolvers)
        fis = (ctypes.c_void_p * n_shards)(
            *[r.fis_handle for r in resolvers])
        ptrs = (ctypes.c_void_p * n_shards)(
            *[r.fis_lookup_ptr for r in resolvers])
        hdims = (ctypes.c_int64 * n_shards)(
            *[r.hash_dim for r in resolvers])
        threads = _decode_threads()

        for window in windows:
            handle = lib.avd_create(blob, lens, len(keys), n_shards)
            try:
                # one native decode per file of the window
                at = 0
                while at < len(window):
                    path = window[at].path
                    prog = prog_cache[path]
                    part = []
                    with open(path, "rb") as f:
                        while at < len(window) and window[at].path == path:
                            b = window[at]
                            f.seek(b.payload_offset)
                            payload = f.read(b.payload_size)
                            if len(payload) != b.payload_size:
                                raise ValueError(f"{path}: truncated block")
                            part.append((payload, b))
                            at += 1
                    datas = (ctypes.c_char_p * len(part))(
                        *[p for p, _ in part])
                    blens = (ctypes.c_uint64 * len(part))(
                        *[len(p) for p, _ in part])
                    counts = (ctypes.c_int64 * len(part))(
                        *[b.count for _, b in part])
                    deflate = 1 if part[0][1].codec == "deflate" else 0
                    rc = lib.avd_decode_blocks_mt(
                        handle, datas, blens, counts, len(part), deflate,
                        prog, len(prog), fis, ptrs, hdims, n_shards,
                        threads)
                    if rc != 0:
                        err = lib.avd_error(handle)
                        raise ValueError(
                            f"{path}: native decode failed: "
                            f"{err.decode() if err else rc}")
                rows = int(lib.avd_rows(handle))
                nnz = int(lib.avd_nnz(handle))
                counts_a = _np_from(lib.avd_feat_counts(handle), rows,
                                    np.int64)
                flat_val = _np_from(lib.avd_feat_values(handle), nnz,
                                    np.float64)
                features = {}
                for si, shard in enumerate(shards):
                    imap = index_maps[shard]
                    flat_idx = _np_from(lib.avd_feat_indices(handle, si),
                                        nnz, np.int32)
                    idx, val = _pad_features(counts_a, flat_idx, flat_val,
                                             imap.intercept_index)
                    features[shard] = HostSparse(idx, val, imap.size)
                (labels, has_label, offsets, weights, uids,
                 entity_vals) = _extract_scalars(lib, handle, rows,
                                                 entity_columns)
            finally:
                lib.avd_free(handle)
            labels = labels.copy()
            missing = ~has_label.astype(bool)
            if require_response and missing.any():
                i = int(np.argmax(missing))
                raise ValueError(
                    f"record uid={uids[i]} has no '{cols.response}' — "
                    "training data must be labeled")
            labels[missing] = np.nan
            yield features, labels, offsets, weights, entity_vals, uids
    finally:
        for r in resolvers:
            r.close()


def _chunked_python(windows, index_maps, entity_columns, cols,
                    require_response):
    from photon_ml_tpu_torch.io.stream_source import iter_block_records

    for window in windows:
        rows_per_shard = {s: [] for s in index_maps}
        labels, offsets, weights, uids = [], [], [], []
        entity_vals = {c: [] for c in entity_columns}
        for rec in iter_block_records(window):
            label, offset, weight, uid, evals, shard_rows = _parse_record(
                rec, cols, index_maps, entity_columns, require_response)
            labels.append(label)
            offsets.append(offset)
            weights.append(weight)
            uids.append(uid)
            for c, v in zip(entity_columns, evals):
                entity_vals[c].append(v)
            for shard, row in shard_rows.items():
                rows_per_shard[shard].append(row)
        features = {
            shard: _rows_to_host_sparse(rows, index_maps[shard].size)
            for shard, rows in rows_per_shard.items()
        }
        yield (features, np.asarray(labels), np.asarray(offsets),
               np.asarray(weights),
               {c: np.asarray(v) for c, v in entity_vals.items()}, uids)
