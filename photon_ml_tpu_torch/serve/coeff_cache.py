"""Per-entity random-effect coefficient store with LRU eviction
(counterpart of ``photon_ml_tpu/serve/coeff_cache.py``; host-only, the
same code over the port's ``io`` and ``game.data``).

A GAME model's random effects can hold millions of per-entity coefficient
rows; a serving process must NOT require them all resident (that is the
batch loader's trade). This module keeps the HOT entities' coefficients in
memory behind an LRU and re-reads cold entities from the saved model
directory — the same ``coefficients.avro`` + index-map layout
``io/model_io`` writes, decoded through the same per-record helpers
(``entity_support_from_record`` / ``sketch_coefficients_from_record``), so
a cache entry can never diverge from what ``load_game_model`` would build.

An entity absent from the store is cached as ``None`` (negative entry):
the serving tier then scores it with fixed effects only — the fallback
``game/scoring.py`` applies to unknown entities (their rows
are dropped from every random-effect score view, contributing score 0).
Negative entries occupy LRU slots like positive ones, so a scan of unknown
ids cannot pin the whole store in memory.

Cost model: a cold miss streams the coordinate's Avro file until the
entity's record (O(file) worst case); a first access builds a known-id set
in one streaming pass so ABSENT ids answer without touching the file
again. The LRU exists to make cold misses rare; size it to the working
set, not the model.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.parallel import fault_injection

__all__ = ["CoeffEntry", "EntityCoefficientLRU", "LayeredCoefficientStore",
           "ModelDirCoefficientStore"]


class CoeffEntry:
    """One entity's serving payload: ``local_map`` (global feature id ->
    local slot dict, or a shared SketchProjection) plus the matching local
    coefficient vector — exactly the pair ``_model_score_view`` derives
    from a loaded RandomEffectModel bucket row."""

    __slots__ = ("local_map", "coefficients")

    def __init__(self, local_map, coefficients: np.ndarray):
        self.local_map = local_map
        self.coefficients = np.asarray(coefficients, np.float64)

    @property
    def local_dim(self) -> int:
        return int(self.coefficients.shape[0])


class ModelDirCoefficientStore:
    """Cold-path loader over one random-effect coordinate of a saved model
    directory (the PalDB-backed-store role from the reference, built on
    this repo's persisted index maps + Avro records)."""

    def __init__(self, model_dir: str, name: str, imap,
                 projection_meta: Optional[dict] = None):
        self.model_dir = model_dir
        self.name = name
        self.imap = imap
        self.projection_meta = projection_meta
        self._sketch = None
        if projection_meta and projection_meta.get("type") == "random":
            from photon_ml_tpu_torch.game.data import SketchProjection

            self._sketch = SketchProjection(
                int(projection_meta["dim"]),
                int(projection_meta.get("seed", 0)))
        self._known: Optional[frozenset] = None
        self._lock = threading.Lock()

    def _path(self) -> str:
        return os.path.join(self.model_dir, "random-effect", self.name,
                            "coefficients.avro")

    def known_ids(self) -> frozenset:
        """Every entity id present in the store (one streaming pass, ids
        only — payloads are not retained)."""
        with self._lock:
            if self._known is None:
                from photon_ml_tpu_torch.io.avro import iter_avro_records

                self._known = frozenset(
                    str(rec["modelId"])
                    for rec in iter_avro_records([self._path()]))
            return self._known

    def _parse(self, rec) -> CoeffEntry:
        if self._sketch is not None:
            from photon_ml_tpu_torch.io.model_io import (
                sketch_coefficients_from_record,
            )

            w = sketch_coefficients_from_record(rec, self._sketch.dim)
            return CoeffEntry(self._sketch, w)
        from photon_ml_tpu_torch.io.model_io import (
            entity_support_from_record,
        )

        ids, vals = entity_support_from_record(rec, self.imap)
        local_map = {int(g): s for s, g in enumerate(ids)}
        return CoeffEntry(local_map, vals)

    def load(self, entity_id: str) -> Optional[CoeffEntry]:
        """The entity's coefficients, or None when the store has no model
        for it (the caller caches that outcome as a negative entry)."""
        fault_injection.check("store.load")
        if str(entity_id) not in self.known_ids():
            return None
        from photon_ml_tpu_torch.io.avro import iter_avro_records

        for rec in iter_avro_records([self._path()]):
            if str(rec["modelId"]) == str(entity_id):
                return self._parse(rec)
        return None  # pragma: no cover - known_ids guarantees a record

    def load_many(self, entity_ids: Sequence[str]
                  ) -> Dict[str, Optional[CoeffEntry]]:
        """Resolve a batch of ids in ONE streaming pass over the
        coordinate's file — a cold fault of m entities costs O(file), not
        O(m * file) as m single-entity :meth:`load` calls would (the
        paged table's install path and the LRU's batched misses come
        through here). Absent ids resolve to None without a file read
        once the known ids are built; the first call builds them in the
        same pass that parses its records (one pass over the file, where
        the JAX store makes an ids pass first and then a second)."""
        fault_injection.check("store.load")
        from photon_ml_tpu_torch.io.avro import iter_avro_records

        with self._lock:
            known = self._known
        # the first call reads the whole file and records every id in it
        ids = set() if known is None else None
        out: Dict[str, Optional[CoeffEntry]] = {}
        wanted = set()
        for eid in entity_ids:
            key = str(eid)
            if known is None or key in known:
                wanted.add(key)
            else:
                out[key] = None
        if wanted or ids is not None:
            for rec in iter_avro_records([self._path()]):
                key = str(rec["modelId"])
                if ids is not None:
                    ids.add(key)
                if key in wanted:
                    out[key] = self._parse(rec)
                    wanted.discard(key)
                    if not wanted and ids is None:
                        break
        if ids is not None:
            with self._lock:
                if self._known is None:
                    self._known = frozenset(ids)
            out.update((key, None) for key in wanted)
        return out


class LayeredCoefficientStore:
    """Delta-chain resolution for per-entity coefficients: stores are
    ordered topmost (newest delta layer) first, and an entity resolves
    from the FIRST layer that knows it — a delta version's changed
    entities shadow the parent's records while untouched entities fall
    through to the parent chain (registry/delta.py). Same
    ``load``/``known_ids`` surface as :class:`ModelDirCoefficientStore`,
    so the LRU cannot tell a delta view from a full model."""

    def __init__(self, stores: Sequence):
        if not stores:
            raise ValueError("layered store needs at least one layer")
        self.stores = list(stores)

    def known_ids(self) -> frozenset:
        out: frozenset = frozenset()
        for s in self.stores:
            out = out | s.known_ids()
        return out

    def load(self, entity_id: str) -> Optional[CoeffEntry]:
        key = str(entity_id)
        for s in self.stores:
            if key in s.known_ids():
                return s.load(key)
        return None

    def load_many(self, entity_ids: Sequence[str]
                  ) -> Dict[str, Optional[CoeffEntry]]:
        """Batched delta-chain resolution: route each id to the FIRST
        layer that knows it, then one :meth:`load_many` pass per layer
        that owns any of the requested ids."""
        out: Dict[str, Optional[CoeffEntry]] = {}
        per_store: Dict[int, list] = {}
        routed = set()
        for eid in entity_ids:
            key = str(eid)
            if key in out or key in routed:
                continue
            for si, s in enumerate(self.stores):
                if key in s.known_ids():
                    per_store.setdefault(si, []).append(key)
                    routed.add(key)
                    break
            else:
                out[key] = None
        for si, keys in per_store.items():
            out.update(self.stores[si].load_many(keys))
        return out


class EntityCoefficientLRU:
    """Bounded LRU over :class:`CoeffEntry` payloads (negative entries
    included). ``loader`` is any ``entity_id -> CoeffEntry | None``
    callable — production passes :meth:`ModelDirCoefficientStore.load`;
    tests pass fakes to pin eviction/counter behaviour."""

    def __init__(self, loader: Callable[[str], Optional[CoeffEntry]],
                 capacity: int, metrics=None, batch_loader=None):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self._loader = loader
        self._batch_loader = batch_loader  # ids -> {id: entry|None}
        self.capacity = int(capacity)
        self._data: "OrderedDict[str, Optional[CoeffEntry]]" = OrderedDict()
        self._lock = threading.Lock()
        self._metrics = metrics
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def cached_ids(self) -> Sequence[str]:
        """Current residents, least-recently-used first."""
        with self._lock:
            return list(self._data)

    def get(self, entity_id) -> Optional[CoeffEntry]:
        key = str(entity_id)
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                if self._metrics is not None:
                    self._metrics.record_coeff(hits=1)
                return self._data[key]
            self.misses += 1
        # load OUTSIDE the lock: a cold miss may stream the model file
        entry = self._loader(key)
        evicted = 0
        with self._lock:
            self._data[key] = entry
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                evicted += 1
            self.evictions += evicted
            if self._metrics is not None:
                self._metrics.record_coeff(misses=1, evictions=evicted)
        return entry

    def prefetch(self, entity_ids) -> int:
        """Warm the cache with ``entity_ids`` WITHOUT touching the
        hit/miss counters — the hot-swap path seeds the new version's
        cache from the previous cache's resident set so the first
        post-swap requests do not pay a cold-read storm. Evictions are
        still counted (capacity is capacity). Returns the number of ids
        actually loaded."""
        loaded = 0
        for eid in entity_ids:
            key = str(eid)
            with self._lock:
                if key in self._data:
                    continue
            entry = self._loader(key)
            loaded += 1
            evicted = 0
            with self._lock:
                self._data[key] = entry
                self._data.move_to_end(key)
                while len(self._data) > self.capacity:
                    self._data.popitem(last=False)
                    evicted += 1
                self.evictions += evicted
                if self._metrics is not None and evicted:
                    self._metrics.record_coeff(evictions=evicted)
        return loaded

    def warm_entries(self, entity_ids) -> Dict[str, Optional[CoeffEntry]]:
        """Prefetch + return: load ``entity_ids`` WITHOUT touching the
        hit/miss counters (like :meth:`prefetch`) and hand the resolved
        entries back — the hot-swap path uses this to seed BOTH the new
        version's LRU and its paged device table from the previous hot
        set in one store pass (evictions still count)."""
        out: Dict[str, Optional[CoeffEntry]] = {}
        missing: list = []
        missing_set: set = set()  # the list keeps the ids' order
        with self._lock:
            for eid in entity_ids:
                key = str(eid)
                if key in out or key in missing_set:
                    continue
                if key in self._data:
                    out[key] = self._data[key]
                else:
                    missing.append(key)
                    missing_set.add(key)
        if missing:
            if self._batch_loader is not None:
                loaded = self._batch_loader(missing)
            else:
                loaded = {key: self._loader(key) for key in missing}
            evicted = 0
            with self._lock:
                for key in missing:
                    entry = loaded.get(key)
                    out[key] = entry
                    self._data[key] = entry
                    self._data.move_to_end(key)
                while len(self._data) > self.capacity:
                    self._data.popitem(last=False)
                    evicted += 1
                self.evictions += evicted
            if self._metrics is not None and evicted:
                self._metrics.record_coeff(evictions=evicted)
        return out

    def seed(self, entries: Dict[str, Optional[CoeffEntry]]) -> None:
        """Insert already-resolved entries (in the dict's order) without
        a loader call or hit/miss accounting — a delta swap carries the
        previous version's entries for entities its new layers do not
        touch (evictions still count)."""
        evicted = 0
        with self._lock:
            for key, entry in entries.items():
                self._data[str(key)] = entry
                self._data.move_to_end(str(key))
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                evicted += 1
            self.evictions += evicted
        if self._metrics is not None and evicted:
            self._metrics.record_coeff(evictions=evicted)

    def resident_many(self, entity_ids) -> Dict[str, Optional[CoeffEntry]]:
        """Resolve ONLY the already-resident subset of ``entity_ids`` —
        the degraded-level-1 read: no loader call, no LRU reordering, no
        hit/miss accounting, so a brownout scoring pass cannot perturb
        the cache state the healthy path will resume with. Ids not in
        the cache are simply absent from the result."""
        out: Dict[str, Optional[CoeffEntry]] = {}
        with self._lock:
            for eid in entity_ids:
                key = str(eid)
                if key not in out and key in self._data:
                    out[key] = self._data[key]
        return out

    def get_many(self, entity_ids) -> Dict[str, Optional[CoeffEntry]]:
        """Resolve a batch of ids (deduplicated; order-preserving dict).
        With a ``batch_loader``, all of the batch's cold misses load in
        ONE store pass instead of one file scan per missing entity."""
        out: Dict[str, Optional[CoeffEntry]] = {}
        if self._batch_loader is None:
            for eid in entity_ids:
                key = str(eid)
                if key not in out:
                    out[key] = self.get(key)
            return out
        missing: list = []
        missing_set = set()
        hits = 0
        with self._lock:
            for eid in entity_ids:
                key = str(eid)
                if key in out or key in missing_set:
                    continue
                if key in self._data:
                    self._data.move_to_end(key)
                    hits += 1
                    out[key] = self._data[key]
                else:
                    missing.append(key)
                    missing_set.add(key)
            self.hits += hits
            self.misses += len(missing)
        if self._metrics is not None and hits:
            self._metrics.record_coeff(hits=hits)
        if not missing:
            return out
        # load OUTSIDE the lock: a cold batch may stream the model file
        loaded = self._batch_loader(missing)
        evicted = 0
        with self._lock:
            for key in missing:
                entry = loaded.get(key)
                out[key] = entry
                self._data[key] = entry
                self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                evicted += 1
            self.evictions += evicted
        if self._metrics is not None:
            self._metrics.record_coeff(misses=len(missing),
                                       evictions=evicted)
        return out

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
