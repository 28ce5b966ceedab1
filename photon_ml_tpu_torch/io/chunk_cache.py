"""Decode-once packed chunk cache for out-of-core streamed training
(counterpart of ``photon_ml_tpu/io/chunk_cache.py``; same on-disk format).

The out-of-core fixed-effect path re-decodes the Avro shard on EVERY
optimizer pass. :class:`ChunkCacheSource` wraps any re-iterable chunk
source and makes the job pay the decode exactly ONCE:

* **Cold pass**: chunks are served from the wrapped source unchanged while
  being teed into one packed ``np.memmap`` file per field under a ``.tmp-``
  staging dir, renamed into place in one ``os.rename`` when the pass
  completes: a cache directory is complete the instant it exists, and an
  interrupted write leaves only an invisible staging dir (swept on the next
  construction).
* **Warm passes**: chunks are zero-copy views into the read-only memmaps.
  Per-pass scalars still change under ``ScalarOverlaySource``, which
  overlays them on whatever source it wraps, cached or not.
* **Invalidation**: the cache is keyed by a fingerprint over the source
  files (path, size, mtime_ns), the chunk geometry (chunk_rows, pad_nnz,
  dim, dtype, implicit_ones, row_span) and the index map's content digest.
  A stale cache is never opened, and is swept.
* **Disk budget**: ``max_bytes`` bounds the packed size; a dataset that does
  not fit falls through to plain re-decode with a logged warning.

The cache holds the chunks only: each chunk's column-sorted view is built
on the device after the chunk lands (``parallel/streaming.py``), so the
format is the JAX package's. Fault-injection sites: ``chunk_cache.spill``
(before each chunk's write to the staging directory) and
``chunk_cache.commit`` (before the staging directory's rename). Every
pass ticks the training metrics' warm, cold or fallthrough counter.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import os
import shutil
from typing import Iterator, Optional

import numpy as np

from photon_ml_tpu_torch.parallel import fault_injection
from photon_ml_tpu_torch.parallel.streaming import HostChunk

__all__ = ["ChunkCacheSource", "source_fingerprint"]

_log = logging.getLogger("photon_ml_tpu_torch")

_FIELDS = ("indices", "values", "labels", "offsets", "weights")
_META = "META.json"
_FORMAT = 1
_tmp_seq = itertools.count()


def _index_map_digest(imap) -> str:
    dig = getattr(imap, "digest", None)
    if callable(dig):
        return str(dig())
    # duck-typed maps without a content digest: coarse, but any size or
    # intercept change still invalidates
    return f"{type(imap).__name__}:{imap.size}:{imap.intercept_index}"


def source_fingerprint(source) -> dict:
    """Invalidation fingerprint of a disk-backed chunk source (the
    ``AvroChunkSource`` attribute surface): source files with size and
    mtime, chunk geometry, and the index map's content digest. Raises for
    sources it cannot introspect: pass ``fingerprint=`` then."""
    from photon_ml_tpu_torch.io.avro import _expand

    paths = getattr(source, "_paths", None)
    imap = getattr(source, "_imap", None)
    if paths is None or imap is None:
        raise ValueError(
            f"cannot fingerprint a {type(source).__name__} (no _paths/_imap "
            "surface); pass ChunkCacheSource(..., fingerprint=...) with a "
            "caller-provided invalidation key")
    files = []
    for p in sorted(_expand(paths)):
        st = os.stat(p)
        files.append([p, st.st_size, st.st_mtime_ns])
    return {
        "format": _FORMAT,
        "files": files,
        "chunk_rows": int(source.chunk_rows),
        "pad_nnz": int(source.pad_nnz),
        "dim": int(source.dim),
        "dtype": str(np.dtype(getattr(source, "_dtype", np.float32))),
        "implicit_ones": bool(getattr(source, "_implicit_ones", False)),
        "row_span": list(getattr(source, "row_span", (0, source.rows))),
        "index_map": _index_map_digest(imap),
    }


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class _PackedWriter:
    """Spill fixed-shape chunks into one packed memmap file per field."""

    def __init__(self, staging: str, n_chunks: int, first_chunk: HostChunk):
        self.maps = {}
        self.meta_fields = {}
        for name in _FIELDS:
            arr = getattr(first_chunk, name)
            if arr is None:
                continue
            arr = np.asarray(arr)
            shape = (n_chunks,) + arr.shape
            self.maps[name] = np.memmap(os.path.join(staging, name + ".bin"),
                                        dtype=arr.dtype, mode="w+",
                                        shape=shape)
            self.meta_fields[name] = {"dtype": str(arr.dtype),
                                      "shape": list(shape)}

    @property
    def nbytes(self) -> int:
        return sum(mm.nbytes for mm in self.maps.values())

    def write(self, i: int, chunk: HostChunk) -> None:
        for name, mm in self.maps.items():
            mm[i] = getattr(chunk, name)

    def finalize(self) -> None:
        for mm in self.maps.values():
            mm.flush()
        self.maps = {}


class ChunkCacheSource:
    """Re-iterable wrapper that decodes the wrapped source once, then
    serves memmap-backed chunks. Drop-in for ``fit_streaming``'s chunk list
    (``len()`` + repeated ``iter()``); every other attribute (``dim``,
    ``rows``, ``row_span``, ...) delegates to the wrapped source.

    Parameters
    ----------
    source: the chunk source to cache (typically ``AvroChunkSource``).
    cache_dir: directory owned by this source's cache (created lazily).
    max_bytes: disk budget; a packed size above it disables the cache with
        a warning and every pass falls through to ``source``.
    fingerprint: explicit invalidation key for sources
        :func:`source_fingerprint` cannot introspect (e.g. in-RAM chunk
        lists).
    """

    def __init__(self, source, cache_dir: str,
                 max_bytes: Optional[int] = None, *,
                 fingerprint: Optional[dict] = None):
        self._src = source
        self.cache_dir = str(cache_dir)
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        fp = fingerprint if fingerprint is not None \
            else source_fingerprint(source)
        self._fingerprint = fp
        self._fp_hex = hashlib.sha256(
            json.dumps(fp, sort_keys=True).encode()).hexdigest()
        self.cache_path = os.path.join(self.cache_dir,
                                       f"chunks-{self._fp_hex[:16]}")
        self.enabled = True
        self.cold_passes = 0
        self.warm_passes = 0
        self.fallthrough_passes = 0
        self.bytes_written = 0
        self._maps = None
        self._meta = None
        self._sweep()

    # -- sizing / delegation ------------------------------------------------
    def __len__(self) -> int:
        return len(self._src)

    @property
    def passes(self) -> int:
        return self.cold_passes + self.warm_passes + self.fallthrough_passes

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        try:
            src = self.__dict__["_src"]
        except KeyError:
            raise AttributeError(name) from None
        return getattr(src, name)

    def close(self) -> None:
        """Release the memmaps (idempotent); delegates to the source."""
        self._maps = None
        close = getattr(self._src, "close", None)
        if close is not None:
            close()

    # -- housekeeping -------------------------------------------------------
    def _sweep(self) -> None:
        """Remove invisible garbage: staging dirs whose writer process is
        dead, and committed caches with a stale fingerprint."""
        if not os.path.isdir(self.cache_dir):
            return
        for name in sorted(os.listdir(self.cache_dir)):
            full = os.path.join(self.cache_dir, name)
            if name.startswith(".tmp-"):
                try:
                    pid = int(name.split("-")[1])
                except (IndexError, ValueError):
                    pid = 0
                if not pid or not _pid_alive(pid):
                    shutil.rmtree(full, ignore_errors=True)
            elif (name.startswith("chunks-")
                    and full != self.cache_path and os.path.isdir(full)):
                _log.info("chunk cache: sweeping stale %s (fingerprint "
                          "changed)", full)
                shutil.rmtree(full, ignore_errors=True)

    # -- warm side ----------------------------------------------------------
    def _try_open_warm(self) -> bool:
        """Open the committed cache read-only; a corrupt or mismatched one
        is removed and reported as absent (forcing a clean re-decode)."""
        if self._maps is not None:
            return True
        meta_path = os.path.join(self.cache_path, _META)
        if not os.path.exists(meta_path):
            return False
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("fingerprint") != self._fp_hex:
                raise ValueError("fingerprint mismatch")
            if meta.get("n_chunks") != len(self._src):
                raise ValueError("chunk count mismatch")
            maps = {}
            for name, spec in meta["fields"].items():
                path = os.path.join(self.cache_path, name + ".bin")
                dtype = np.dtype(spec["dtype"])
                shape = tuple(spec["shape"])
                want = int(np.prod(shape)) * dtype.itemsize
                if os.path.getsize(path) != want:
                    raise ValueError(f"{name}.bin truncated")
                maps[name] = np.memmap(path, dtype=dtype, mode="r",
                                       shape=shape)
        except Exception as e:
            _log.warning("chunk cache: %s unreadable (%s); removing and "
                         "re-decoding", self.cache_path, e)
            self._maps = None
            shutil.rmtree(self.cache_path, ignore_errors=True)
            return False
        self._maps = maps
        self._meta = meta
        return True

    def _iter_warm(self) -> Iterator[HostChunk]:
        maps = self._maps
        values = maps.get("values")
        for i in range(self._meta["n_chunks"]):
            yield HostChunk(indices=maps["indices"][i],
                            values=None if values is None else values[i],
                            labels=maps["labels"][i],
                            offsets=maps["offsets"][i],
                            weights=maps["weights"][i])

    # -- cold side ----------------------------------------------------------
    def _iter_cold(self) -> Iterator[HostChunk]:
        n_chunks = len(self._src)
        os.makedirs(self.cache_dir, exist_ok=True)
        staging = os.path.join(
            self.cache_dir, f".tmp-{os.getpid()}-{next(_tmp_seq)}")
        os.makedirs(staging)
        writer = None
        done = 0
        committed = False
        try:
            for i, chunk in enumerate(self._src):
                if self.enabled and writer is None:
                    writer = _PackedWriter(staging, n_chunks, chunk)
                    if (self.max_bytes is not None
                            and writer.nbytes > self.max_bytes):
                        _log.warning(
                            "chunk cache: packed size %.1f MB exceeds the "
                            "%.1f MB disk budget; disabling the cache — "
                            "every pass will re-decode from source",
                            writer.nbytes / 1e6, self.max_bytes / 1e6)
                        writer.maps = {}
                        self.enabled = False
                        writer = None
                if writer is not None:
                    fault_injection.check("chunk_cache.spill")
                    writer.write(i, chunk)
                done += 1
                yield chunk
            if writer is not None and done == n_chunks:
                total = writer.nbytes
                writer.finalize()
                with open(os.path.join(staging, _META), "w") as f:
                    json.dump({
                        "format": _FORMAT,
                        "fingerprint": self._fp_hex,
                        "source": self._fingerprint,
                        "n_chunks": n_chunks,
                        "bytes": total,
                        "fields": writer.meta_fields,
                    }, f, indent=2)
                fault_injection.check("chunk_cache.commit")
                try:
                    os.rename(staging, self.cache_path)
                    committed = True
                    self.bytes_written = total
                except OSError:
                    # a concurrent iterator committed first; theirs is
                    # identical (same fingerprint): discard ours
                    pass
        finally:
            if not committed:
                shutil.rmtree(staging, ignore_errors=True)

    def __iter__(self) -> Iterator[HostChunk]:
        from photon_ml_tpu_torch.obs.metrics import training_metrics

        if self.enabled and self._try_open_warm():
            self.warm_passes += 1
            training_metrics().record_chunk_cache_pass("warm")
            return self._iter_warm()
        if not self.enabled:
            self.fallthrough_passes += 1
            training_metrics().record_chunk_cache_pass("fallthrough")
            return iter(self._src)
        self.cold_passes += 1
        training_metrics().record_chunk_cache_pass("cold")
        return self._iter_cold()
