"""Out-of-core chunk source: stream on-disk Avro through ``fit_streaming``
(counterpart of ``photon_ml_tpu/io/stream_source.py``).

:class:`AvroChunkSource` is a drop-in replacement for the chunk LIST that
``parallel.streaming.fit_streaming`` consumes (it needs only ``len()`` and
repeated ``iter()``):

1. **Scan once, cheaply.** Avro container block headers carry the record
   count and payload size, so the total rows, and hence the fixed chunk
   count, come from a header walk that decodes no payload.
2. **Decode per pass, bounded.** Each ``iter()`` starts a background
   producer thread that decodes consecutive block waves through the native
   C++ decoder (``native/avro_decoder.cpp``: inflate, decode and feature
   resolution outside the GIL) into a ``queue.Queue(maxsize=prefetch)`` of
   fixed-shape :class:`~photon_ml_tpu_torch.parallel.streaming.HostChunk`.
   Host RAM holds at most ``prefetch + 2`` chunks whatever the dataset
   size.
3. **Fixed shapes.** Every chunk is exactly ``(chunk_rows, pad_nnz)``, with
   trailing zero-weight padding rows, as ``make_host_chunks`` makes them.

Without the native library the producer falls back to the pure-Python
codec's block-at-a-time record stream: same bounded-memory contract,
slower decode.

``process_part=(i, n)`` keeps one contiguous share of the container blocks
per process, so a multi-process streamed fit reads each row once.

Fault-injection sites: ``stream.block_payload`` (a ``truncate`` fault
halves a block's bytes, driving the real truncated-block error) and
``stream.chunk`` (the consumer side, once per chunk taken). The producer
thread decodes on behalf of the consuming process, so it carries that
process's index for per-process fault plans.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import logging
import os
import queue
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.io.avro import (
    _decoder, _expand, _read_header, _read_long_or_eof,
)
from photon_ml_tpu_torch.parallel import fault_injection
from photon_ml_tpu_torch.parallel.streaming import HostChunk

_log = logging.getLogger("photon_ml_tpu_torch")

__all__ = ["AvroChunkSource", "ScalarOverlaySource", "scan_blocks",
           "iter_block_records", "BlockRef"]


@dataclasses.dataclass(frozen=True)
class BlockRef:
    """One container block located during the header scan (no decode)."""

    path: str
    payload_offset: int
    payload_size: int
    count: int  # records in the block
    codec: str  # "null" | "deflate", per owning file


def scan_blocks(paths) -> Tuple[List[BlockRef], object]:
    """Walk container block headers (seeking past payloads): returns
    (blocks, writer_schema). O(#blocks) reads of ~20 bytes each."""
    blocks: List[BlockRef] = []
    schema = None
    for path in _expand(paths):
        with open(path, "rb") as f:
            file_schema, codec, sync = _read_header(f, path)
            if schema is None:
                schema = file_schema
            while True:
                count = _read_long_or_eof(f)
                if count is None:
                    break
                size = _read_long_or_eof(f)
                if count < 0 or size is None or size < 0:
                    raise ValueError(f"{path}: truncated block header")
                off = f.tell()
                f.seek(size, 1)
                if f.read(16) != sync:
                    raise ValueError(
                        f"{path}: sync marker mismatch (corrupt file)")
                blocks.append(BlockRef(path, off, size, count, codec))
    if schema is None:
        raise ValueError(f"no Avro input files under {paths!r}")
    return blocks, schema


def iter_block_records(blocks: Sequence[BlockRef]) -> Iterator[dict]:
    """Decode an explicit block list with the pure-Python codec, one block
    payload resident at a time; shared by the chunk source's Python
    fallback and the chunked scoring reader (``io/data_reader.py``)."""
    open_path, f, dec = None, None, None
    try:
        for blk in blocks:
            if blk.path != open_path:
                if f is not None:
                    f.close()
                f = open(blk.path, "rb")
                dec = _decoder(_read_header(f, blk.path)[0])
                open_path = blk.path
            f.seek(blk.payload_offset)
            payload = fault_injection.mangle_payload(
                "stream.block_payload", f.read(blk.payload_size))
            if len(payload) != blk.payload_size:
                raise ValueError(f"{blk.path}: truncated block")
            if blk.codec == "deflate":
                payload = zlib.decompress(payload, -15)
            pos = 0
            for _ in range(blk.count):
                rec, pos = dec(payload, pos)
                yield rec
    finally:
        if f is not None:
            f.close()


class _Ragged:
    """Pending decoded rows in ragged layout, FIFO across wave appends."""

    def __init__(self):
        self.counts: List[np.ndarray] = []
        self.flat_idx: List[np.ndarray] = []
        self.flat_val: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []
        self.offsets: List[np.ndarray] = []
        self.weights: List[np.ndarray] = []

    def rows(self) -> int:
        return sum(len(c) for c in self.counts)

    def append(self, counts, fi, fv, lab, off, wt):
        self.counts.append(counts)
        self.flat_idx.append(fi)
        self.flat_val.append(fv)
        self.labels.append(lab)
        self.offsets.append(off)
        self.weights.append(wt)

    def take(self, n: int):
        """Split off the first ``n`` rows (ragged concatenate + slice)."""
        counts = np.concatenate(self.counts)
        fi = np.concatenate(self.flat_idx)
        fv = np.concatenate(self.flat_val)
        lab = np.concatenate(self.labels)
        off = np.concatenate(self.offsets)
        wt = np.concatenate(self.weights)
        nnz_head = int(counts[:n].sum())
        head = (counts[:n], fi[:nnz_head], fv[:nnz_head],
                lab[:n], off[:n], wt[:n])
        self.__init__()
        if len(counts) > n:
            self.append(counts[n:], fi[nnz_head:], fv[nnz_head:],
                        lab[n:], off[n:], wt[n:])
        return head


def _pad_fixed(counts, flat_idx, flat_val, intercept: int, k: int,
               dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged rows -> fixed (n, k) padded arrays, dropping unresolved (-1)
    entries and appending the intercept column, at a CALLER-FIXED width so
    every chunk has one shape; overflow is a loud error."""
    n = len(counts)
    row_ids = np.repeat(np.arange(n), counts)
    keep = flat_idx >= 0
    row_ids, idx, val = row_ids[keep], flat_idx[keep], flat_val[keep]
    valid = np.bincount(row_ids, minlength=n).astype(np.int64)
    extra = 1 if intercept >= 0 else 0
    need = int(valid.max(initial=0)) + extra
    if need > k:
        raise ValueError(
            f"row with {need} features exceeds pad_nnz={k} — raise pad_nnz "
            "(or let AvroChunkSource measure it with pad_nnz=None)")
    starts = np.zeros(n, np.int64)
    np.cumsum(valid[:-1], out=starts[1:])
    pos = np.arange(len(row_ids)) - np.repeat(starts, valid)
    indices = np.zeros((n, k), np.int32)
    values = np.zeros((n, k), dtype)
    indices[row_ids, pos] = idx
    values[row_ids, pos] = val
    if intercept >= 0:
        rows = np.arange(n)
        indices[rows, valid] = intercept
        values[rows, valid] = 1.0
    return indices, values


class ScalarOverlaySource:
    """Wrap a chunk source, substituting the scalar columns
    (labels/offsets/weights) from dataset-level host arrays addressed by
    running row index; feature columns stream from the wrapped source
    untouched. This lets a GAME coordinate-descent step run its fixed
    effect out of core: the residual offsets change every step and live in
    host RAM, while the shard's features re-decode per pass. Trailing
    padding rows of the last chunk keep zeroed scalars (weight 0)."""

    def __init__(self, src, labels=None, offsets=None, weights=None):
        self._src = src
        self._labels = labels
        self._offsets = offsets
        self._weights = weights

    def __len__(self) -> int:
        return len(self._src)

    def __iter__(self) -> Iterator[HostChunk]:
        at = 0
        for c in self._src:
            rows = c.indices.shape[0]

            def take(arr, cur):
                if arr is None:
                    return cur
                seg = np.asarray(arr[at:at + rows], dtype=cur.dtype)
                if len(seg) < rows:  # final-chunk padding rows stay inert
                    seg = np.pad(seg, (0, rows - len(seg)))
                return seg

            yield dataclasses.replace(
                c,
                labels=take(self._labels, c.labels),
                offsets=take(self._offsets, c.offsets),
                weights=take(self._weights, c.weights),
            )
            at += rows


class AvroChunkSource:
    """Re-iterable, disk-backed, bounded-memory chunk source.

    Parameters
    ----------
    paths: Avro file / directory / list (``io.avro._expand`` semantics).
    index_map: feature index map (``IndexMap``, ``PersistentIndexMap`` or
        ``HashingIndexMap``) resolving name/term -> column, as the in-RAM
        reader does.
    chunk_rows: rows per emitted chunk (fixed; the last chunk zero-weight
        padded).
    pad_nnz: fixed per-row feature width including the intercept. ``None``
        measures it with one extra decode pass at construction.
    columns: ``InputColumnsNames`` overrides (default names).
    implicit_ones: emit the value-free layout (``values=None``, half the
        per-chunk transfer) after verifying every resolved value is 1.0.
    prefetch: producer queue depth; host RAM holds at most ``prefetch + 2``
        chunks at any moment.
    require_response: unlabeled records raise (training contract).
    process_part: ``(part, n_parts)``: keep only this process's contiguous
        share of the container blocks, split by block start row (balanced
        by rows). Each process's streamed partials are then summed across
        processes (``parallel.streaming._cross_process_sum``), which does
        not care where the split falls, so block-granular parts need no
        padding. Every part's row span is recorded in ``part_spans`` (and
        this part's in ``row_span``) for reassembling global vectors
        (``parallel.multihost.allgather_varspans``).
    """

    def __init__(self, paths, index_map, *, chunk_rows: int,
                 pad_nnz: Optional[int] = None, columns=None,
                 implicit_ones: bool = False, dtype=np.float32,
                 prefetch: int = 2, require_response: bool = True,
                 process_part: Optional[Tuple[int, int]] = None):
        from photon_ml_tpu_torch.io.data_reader import InputColumnsNames

        # first, so close()/__del__ stay safe on a half-built instance
        self._resolver_lock = threading.Lock()
        self._resolver_cached = None  # built once, reused across passes
        self._paths = paths
        self._imap = index_map
        self.chunk_rows = int(chunk_rows)
        self._columns = columns or InputColumnsNames()
        self._implicit_ones = bool(implicit_ones)
        self._dtype = np.dtype(dtype)
        self._prefetch = max(int(prefetch), 0)
        self._require_response = bool(require_response)
        self._blocks, self._schema = scan_blocks(paths)
        self.total_rows = sum(b.count for b in self._blocks)
        self.row_span = (0, self.total_rows)
        self.part_spans = None
        if process_part is not None:
            self._keep_part(*process_part)
        self.rows = sum(b.count for b in self._blocks)
        if self.rows == 0:
            raise ValueError(f"no records under {paths!r}")
        self.dim = index_map.size
        self._use_native = self._native_usable()
        self._prog_cache: Dict[str, bytes] = {}
        # producer-side instrumentation (tests assert boundedness)
        self.chunks_produced = 0
        self.passes = 0
        # producer threads that outlived the end-of-pass join (a wedged
        # decoder), each with a logged warning
        self.producer_join_timeouts = 0
        if pad_nnz is None:
            pad_nnz = self._measure_pad_nnz()
        self.pad_nnz = int(pad_nnz)

    def _keep_part(self, part: int, n_parts: int) -> None:
        """Keep the blocks whose start row falls in ``[part * total //
        n_parts, (part + 1) * total // n_parts)`` and record every part's
        row span. The spans come from the global block layout, the same on
        every process, so a part with no block raises on every process
        alike (none is left waiting in a collective)."""
        if not 0 <= part < n_parts:
            raise ValueError(f"process_part {(part, n_parts)} out of range")
        counts = np.asarray([b.count for b in self._blocks])
        starts = np.cumsum(counts) - counts
        total = int(counts.sum())
        lows = np.asarray([i * total // n_parts for i in range(n_parts + 1)])
        edges = np.searchsorted(starts, lows, side="left")
        self.part_spans = []
        for i in range(n_parts):
            e0, e1 = int(edges[i]), int(edges[i + 1])
            if e0 < e1:
                s0 = int(starts[e0])
                s1 = int(starts[e1 - 1]) + self._blocks[e1 - 1].count
            else:
                s0 = s1 = 0
            self.part_spans.append((s0, s1))
        starved = [i for i, (s0, s1) in enumerate(self.part_spans)
                   if s0 == s1]
        if starved:
            raise ValueError(
                f"process_part {starved[0]}/{n_parts} owns no container "
                f"blocks ({len(counts)} blocks for {n_parts} parts; starved "
                f"parts {starved}, detected on every process): rewrite the "
                "dataset with a smaller block_size so that every process "
                "gets at least one block")
        e0, e1 = int(edges[part]), int(edges[part + 1])
        self._blocks = self._blocks[e0:e1]
        self.row_span = self.part_spans[part]

    @property
    def decoder(self) -> str:
        """``"native"`` or ``"python"``: what decodes this source's
        blocks."""
        return "native" if self._use_native else "python"

    # -- sizing ------------------------------------------------------------
    def __len__(self) -> int:
        return -(-self.rows // self.chunk_rows)

    def _measure_pad_nnz(self) -> int:
        """One bounded decode pass recording the widest row (+intercept)."""
        widest = 0
        for counts, fi, _fv, *_ in self._ragged_waves():
            if len(counts) == 0:
                continue
            n = len(counts)
            row_ids = np.repeat(np.arange(n), counts)
            valid = np.bincount(row_ids[fi >= 0], minlength=n)
            widest = max(widest, int(valid.max(initial=0)))
        extra = 1 if self._imap.intercept_index >= 0 else 0
        return max(widest + extra, 1)

    # -- decode backends ---------------------------------------------------
    def _native_usable(self) -> bool:
        if os.environ.get("PHOTON_ML_TPU_NO_NATIVE"):
            return False
        from photon_ml_tpu_torch.io.native_reader import (
            NativeUnsupported, _lib, compile_field_program,
        )
        from photon_ml_tpu_torch.native import NativeBuildError

        try:
            _lib()
            compile_field_program(self._schema, self._columns, False)
            return True
        except (NativeBuildError, NativeUnsupported):
            return False

    def _ragged_waves(self) -> Iterator[tuple]:
        """Yield ragged decoded waves (counts, flat_idx, flat_val, labels,
        offsets, weights), each roughly chunk-sized, bounded memory."""
        if self._use_native:
            yield from self._native_waves()
        else:
            yield from self._python_waves()

    def _resolver(self):
        """The native feature resolver, built ONCE and reused by every
        decode pass (for an in-memory IndexMap the build serializes the
        whole map into a temporary store). Built lazily on the producer
        thread but torn down by ``close()`` on the caller's, so the slot is
        lock-owned."""
        with self._resolver_lock:
            if self._resolver_cached is None:
                from photon_ml_tpu_torch.io.native_reader import _Resolver

                self._resolver_cached = _Resolver(self._imap)
            return self._resolver_cached

    def close(self) -> None:
        """Release the native resolver's temporary store (idempotent)."""
        with self._resolver_lock:
            r = self._resolver_cached
            self._resolver_cached = None
        if r is not None:
            r.close()

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    def _native_waves(self) -> Iterator[tuple]:
        from photon_ml_tpu_torch.io.native_reader import (
            _decode_threads, _lib, _np_from, compile_field_program,
        )

        lib = _lib()
        resolver = self._resolver()
        prog_cache = self._prog_cache
        fis_handles = (ctypes.c_void_p * 1)(resolver.fis_handle)
        lookup_ptrs = (ctypes.c_void_p * 1)(resolver.fis_lookup_ptr)
        hash_dims = (ctypes.c_int64 * 1)(resolver.hash_dim)
        lens = (ctypes.c_uint32 * 1)()
        n_threads = _decode_threads()
        wave: List[Tuple[bytes, BlockRef]] = []
        wave_rows = 0
        open_path, f = None, None

        def decode(wave):
            b0 = wave[0][1]
            prog = prog_cache.get(b0.path)
            if prog is None:
                with open(b0.path, "rb") as fh:
                    schema, _, _ = _read_header(fh, b0.path)
                prog = compile_field_program(schema, self._columns, False)
                prog_cache[b0.path] = prog
            n = len(wave)
            datas = (ctypes.c_char_p * n)(*[p for p, _ in wave])
            blens = (ctypes.c_uint64 * n)(*[len(p) for p, _ in wave])
            counts = (ctypes.c_int64 * n)(*[b.count for _, b in wave])
            deflate = 1 if b0.codec == "deflate" else 0
            handle = lib.avd_create(b"", lens, 0, 1)
            try:
                rc = lib.avd_decode_blocks_mt(
                    handle, datas, blens, counts, n, deflate, prog,
                    len(prog), fis_handles, lookup_ptrs, hash_dims, 1,
                    n_threads)
                if rc != 0:
                    err = lib.avd_error(handle)
                    raise ValueError(
                        f"{b0.path}: native decode failed: "
                        f"{err.decode() if err else rc}")
                rows = int(lib.avd_rows(handle))
                nnz = int(lib.avd_nnz(handle))
                out = (
                    _np_from(lib.avd_feat_counts(handle), rows, np.int64),
                    _np_from(lib.avd_feat_indices(handle, 0), nnz,
                             np.int32),
                    _np_from(lib.avd_feat_values(handle), nnz,
                             np.float64),
                    _np_from(lib.avd_labels(handle), rows, np.float64),
                    _np_from(lib.avd_has_label(handle), rows, np.uint8),
                    _np_from(lib.avd_offsets(handle), rows, np.float64),
                    _np_from(lib.avd_weights(handle), rows, np.float64),
                )
            finally:
                lib.avd_free(handle)
            counts_a, fi, fv, lab, has, off, wt = out
            if self._require_response and not has.all():
                raise ValueError(
                    f"{b0.path}: unlabeled record — training data must "
                    f"carry '{self._columns.response}'")
            return counts_a, fi, fv, lab, off, wt

        try:
            for blk in self._blocks:
                if blk.path != open_path:
                    # flush across file boundaries: one wave, one codec
                    if wave:
                        yield decode(wave)
                        wave, wave_rows = [], 0
                    if f is not None:
                        f.close()
                    f = open(blk.path, "rb")
                    open_path = blk.path
                f.seek(blk.payload_offset)
                payload = fault_injection.mangle_payload(
                    "stream.block_payload", f.read(blk.payload_size))
                if len(payload) != blk.payload_size:
                    raise ValueError(f"{blk.path}: truncated block")
                wave.append((payload, blk))
                wave_rows += blk.count
                if wave_rows >= self.chunk_rows:
                    yield decode(wave)
                    wave, wave_rows = [], 0
            if wave:
                yield decode(wave)
        finally:
            if f is not None:
                f.close()

    def _python_waves(self) -> Iterator[tuple]:
        """Pure-Python fallback: block-at-a-time record streaming through
        the codec, mapped through the index map."""
        cols, imap = self._columns, self._imap
        counts: List[int] = []
        fi: List[int] = []
        fv: List[float] = []
        lab: List[float] = []
        off: List[float] = []
        wt: List[float] = []

        def flush():
            return (np.asarray(counts, np.int64),
                    np.asarray(fi, np.int32), np.asarray(fv, np.float64),
                    np.asarray(lab, np.float64), np.asarray(off, np.float64),
                    np.asarray(wt, np.float64))

        for rec in iter_block_records(self._blocks):
            val = rec.get(cols.response)
            if val is None:
                if self._require_response:
                    raise ValueError(
                        f"record uid={rec.get(cols.uid)} has no "
                        f"'{cols.response}' — training data must be labeled")
                val = float("nan")
            lab.append(float(val))
            off.append(float(rec[cols.offset])
                       if rec.get(cols.offset) is not None else 0.0)
            wt.append(float(rec[cols.weight])
                      if rec.get(cols.weight) is not None else 1.0)
            c = 0
            for feat in rec[cols.features]:
                idx = imap.index_of(feat["name"], feat.get("term", ""))
                if idx is not None:
                    fi.append(idx)
                    fv.append(float(feat["value"]))
                    c += 1
            counts.append(c)
            if len(counts) >= self.chunk_rows:
                yield flush()
                counts, fi, fv, lab, off, wt = [], [], [], [], [], []
        if counts:
            yield flush()

    # -- chunk assembly ----------------------------------------------------
    def _emit(self, counts, fi, fv, lab, off, wt) -> HostChunk:
        rows = len(counts)
        indices, values = _pad_fixed(counts, fi, fv,
                                     self._imap.intercept_index,
                                     self.pad_nnz, self._dtype)
        pad = self.chunk_rows - rows
        if pad:
            indices = np.pad(indices, ((0, pad), (0, 0)))
            values = np.pad(values, ((0, pad), (0, 0)))
            lab = np.pad(lab, (0, pad))
            off = np.pad(off, (0, pad))
            wt = np.pad(wt, (0, pad))  # pad weight = 0: inert rows
        if self._implicit_ones:
            # padding slots carry value 0, so the value-free layout needs
            # every row to fill pad_nnz exactly with ones (one-hot data of
            # uniform arity) and no padded chunk tail
            full = counts + (1 if self._imap.intercept_index >= 0 else 0)
            if not (np.all(values[:rows] == 1.0)
                    and np.all(full == self.pad_nnz) and pad == 0):
                raise ValueError(
                    "implicit_ones=True needs uniform-arity all-ones rows "
                    "filling pad_nnz exactly with no padded chunk tail "
                    "(chunk_rows must divide the row count)")
            values = None
        return HostChunk(indices=indices, values=values,
                         labels=lab.astype(self._dtype),
                         offsets=off.astype(self._dtype),
                         weights=wt.astype(self._dtype))

    # end-of-pass producer join timeout (seconds); a class attribute so
    # tests can shrink it
    _join_timeout = 30.0
    # consumer-side queue poll (seconds): each expiry rechecks producer
    # liveness, so a decoder that dies without relaying its sentinel fails
    # the pass instead of hanging the consumer
    _consumer_poll_s = 0.5

    @staticmethod
    def _put_or_stop(q: queue.Queue, stop: threading.Event, item) -> bool:
        """Stop-aware bounded put, for chunks, the end-of-pass sentinel and
        errors alike, so an abandoned consumer never wedges the
        producer."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, q: queue.Queue, stop: threading.Event,
                 fault_proc: Optional[int] = None):
        # the producer thread acts on behalf of the consuming process:
        # per-process fault plans address its decode faults
        ctx = (fault_injection.process_context(fault_proc)
               if fault_proc is not None else contextlib.nullcontext())
        with ctx:
            self._produce_inner(q, stop)

    def _produce_inner(self, q: queue.Queue, stop: threading.Event):
        try:
            pending = _Ragged()
            for wave in self._ragged_waves():
                if stop.is_set():
                    return
                pending.append(*wave)
                while pending.rows() >= self.chunk_rows:
                    chunk = self._emit(*pending.take(self.chunk_rows))
                    self.chunks_produced += 1
                    if not self._put_or_stop(q, stop, chunk):
                        return
            n_left = pending.rows()
            if n_left:
                chunk = self._emit(*pending.take(n_left))
                self.chunks_produced += 1
                if not self._put_or_stop(q, stop, chunk):
                    return
            self._put_or_stop(q, stop, None)  # end-of-pass sentinel
        except BaseException as e:  # surfaced in the consumer
            self._put_or_stop(q, stop, e)

    def __iter__(self) -> Iterator[HostChunk]:
        self.passes += 1
        q: queue.Queue = queue.Queue(maxsize=max(self._prefetch, 1))
        stop = threading.Event()
        from photon_ml_tpu_torch.parallel.resilience import (
            current_process_index,
        )

        t = threading.Thread(target=self._produce,
                             args=(q, stop, current_process_index()),
                             daemon=True, name="avro-chunk-producer")
        t.start()
        emitted = 0
        try:
            while True:
                # consumer-side injection point: raise-at-chunk-N faults
                # fire in the consuming thread
                fault_injection.check("stream.chunk")
                try:
                    item = q.get(timeout=self._consumer_poll_s)
                except queue.Empty:
                    if t.is_alive():
                        continue
                    try:
                        # the producer may have parked its last item
                        # between our timeout and its exit
                        item = q.get_nowait()
                    except queue.Empty:
                        raise RuntimeError(
                            "avro-chunk-producer thread died without "
                            "delivering its end-of-pass sentinel") from None
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                emitted += 1
                yield item
        finally:
            stop.set()
            t.join(timeout=self._join_timeout)
            if t.is_alive():
                # a wedged decoder cannot be killed from here: count and
                # name it rather than leaking the thread invisibly
                self.producer_join_timeouts += 1
                _log.warning(
                    "AvroChunkSource: producer thread %r still alive %.0fs "
                    "after the pass ended (wedged decoder?); leaking it as "
                    "a daemon (join timeouts so far: %d)",
                    t.name, self._join_timeout, self.producer_join_timeouts)
        if emitted != len(self):
            raise RuntimeError(
                f"chunk source produced {emitted} chunks, expected "
                f"{len(self)} — dataset changed under a running fit?")
