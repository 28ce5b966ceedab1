"""Device-resident paged table of per-entity random-effect coefficients
(counterpart of ``photon_ml_tpu/serve/paged_table.py``).

The host-side :class:`~photon_ml_tpu_torch.serve.coeff_cache
.EntityCoefficientLRU` keeps the hot working set in host memory, which
forces every batch through a host gather. This module is the device tier
of that hierarchy: the hot entities' coefficients live in a
``[pages * page_rows, dim]`` tensor on the card, densified into the
shard's global feature space, and a warm batch's random-effect margins
are one launch of the hand-written kernel
:func:`~photon_ml_tpu_torch.ops.kernels.paged_gather_score` over
:meth:`PagedCoefficientTable.lookup`'s snapshot.

Design points:

* **Pages are the unit of eviction.** When the table is full, an install
  evicts the least-recently-used page: all of its entities leave the
  slot map at once and its rows are zeroed on the device. A page counts
  as used when a lookup hits it and when an install writes into it, and
  an install evicts no page it has written while another is left. The
  JAX table counts lookups only, so an install into a full table can
  evict the page it has just written: one of more new entities than a
  page holds keeps only its last page of them, and a batch whose
  entities need more than one page never becomes resident.
* **Rows, not pages, are the unit of transfer.** An install uploads only
  its entities' nonzero coefficients (row, global column, value), through
  ``utils.transfer_budget``, and scatters them into their zeroed rows on
  the device. The JAX table re-uploads every touched page from a host
  mirror; at ``dim = 2^16`` float32 a page of 256 rows is 64 MB, so a
  page refresh per install would move pages for a few rows. There is no
  host mirror either (1.07 GB at 4,096 x 2^16 float32): a compaction
  (:meth:`~PagedCoefficientTable.retain_only`) gathers the survivors'
  rows on the device.
* **Snapshots stay consistent (copy on write).** A scoring call takes
  ``(device_buffer, slots)`` under the table lock. The JAX table builds a
  new device array on every install, so such a snapshot keeps scoring
  its old rows however an install races the batch. Here a row that no
  slot has named since the buffer was made is written in place: no
  snapshot can read it. A write that could change a row a snapshot may
  read (a row of an evicted page, a re-installed entity) first clones
  the whole buffer on the device (``snapshot_copies`` counts them), so
  the snapshot's buffer keeps its rows; a compaction always builds a new
  buffer. The kernel's sum depends on the row's width alone, so a
  snapshot scores bit for bit as before an install. A clone moves the table twice through device memory (2.1 GB at
  4,096 x 2^16 float32) and holds a second table while the snapshot
  lives.
* **Negative entries are host-side only.** Entities the store does not
  know get a ``slot -1`` sentinel (the kernel scores them exactly 0, the
  fixed-effect-only fallback) and are remembered in an absent set, so a
  scan of unknown ids cannot trigger repeated store faults; they never
  occupy device rows.
* **Dense rows bound the shard size.** A row is the entity's coefficient
  vector scattered into ``dim`` dense global columns; sketch-projected
  coordinates (whose "local map" is a hash, not a dict) stay off this
  tier (:func:`entry_supported`).

Trace spans ``paged.page_refresh`` and ``paged.retain_only`` wrap the
device writes; ``paged.install`` is a fault-injection site.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.obs import trace as obs_trace
from photon_ml_tpu_torch.ops.kernels import paged_gather_score
from photon_ml_tpu_torch.parallel import fault_injection
from photon_ml_tpu_torch.serve.coeff_cache import CoeffEntry
from photon_ml_tpu_torch.types import resolve_device
from photon_ml_tpu_torch.utils import transfer_budget

__all__ = ["PagedCoefficientTable", "entry_supported"]


def entry_supported(entry: Optional[CoeffEntry]) -> bool:
    """Only plain global-id->slot dict local maps densify into a page
    row; sketch-projected entries (shared hash map) do not."""
    return entry is None or isinstance(entry.local_map, dict)


class PagedCoefficientTable:
    """Paged device residency for one random-effect coordinate.

    ``dim`` — dense width of a row (the shard's index-map size);
    ``pages`` x ``page_rows`` bound the device working set; ``dtype``
    ``torch.float32`` or ``torch.float64``; ``device`` the card by
    default.
    The table only stores what its caller installs: cold entities are
    faulted through the LRU, so hit and miss accounting stays there.
    """

    def __init__(self, dim: int, *, pages: int = 4, page_rows: int = 256,
                 dtype=torch.float32, name: str = "", metrics=None,
                 device=None):
        if dim < 1:
            raise ValueError(f"dense dim must be >= 1, got {dim}")
        if pages < 1 or page_rows < 1:
            raise ValueError(
                f"need pages >= 1 and page_rows >= 1, got "
                f"{pages}x{page_rows}")
        self.dim = int(dim)
        self.pages = int(pages)
        self.page_rows = int(page_rows)
        self.name = name
        self.dtype = dtype
        self.device = resolve_device(device)
        self._metrics = metrics
        self._lock = threading.Lock()
        # made on the device: no host bytes move, so nothing is charged
        self._device = torch.zeros(self.capacity, self.dim,
                                   dtype=self.dtype, device=self.device)
        # rows some slot has named since the buffer was made: a snapshot
        # may read them, so writing one copies the buffer first
        self._named = np.zeros(self.capacity, bool)
        self._slots: Dict[str, int] = {}
        self._absent: set = set()
        self._page_ids: List[List[str]] = [[] for _ in range(self.pages)]
        self._fill = [0] * self.pages
        self._clock = 0
        self._page_last = [0] * self.pages
        # counters (exposed through stats + /metrics)
        self.installs = 0
        self.page_evictions = 0
        self.absent_marks = 0
        self.membership_drops = 0
        self.snapshot_copies = 0

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    @property
    def capacity(self) -> int:
        return self.pages * self.page_rows

    @property
    def device_buffer(self) -> torch.Tensor:
        return self._device

    def resident_ids(self) -> List[str]:
        with self._lock:
            return list(self._slots)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "resident": len(self._slots),
                "capacity": self.capacity,
                "installs": self.installs,
                "page_evictions": self.page_evictions,
                "absent": len(self._absent),
                "membership_drops": self.membership_drops,
            }

    # -- lookup ------------------------------------------------------------
    def lookup(self, entity_ids: Sequence[str]
               ) -> Tuple[torch.Tensor, np.ndarray, List[str]]:
        """One consistent read for a batch: ``(device_buffer, slots,
        missing)``. ``slots`` is int32 per id (-1 for absent/unknown);
        ``missing`` lists the deduplicated ids that are neither resident
        nor known-absent — the caller faults those through the LRU and
        installs them. Touches the hit pages' LRU clocks. The buffer and
        slots stay a valid pair whatever is installed afterwards."""
        slots = np.empty(len(entity_ids), np.int32)
        missing: List[str] = []
        seen_missing: set = set()
        with self._lock:
            self._clock += 1
            clock = self._clock
            get = self._slots.get
            for i, eid in enumerate(entity_ids):
                s = get(eid)
                if s is None:
                    slots[i] = -1
                    if eid not in self._absent and eid not in seen_missing:
                        missing.append(eid)
                        seen_missing.add(eid)
                else:
                    slots[i] = s
                    self._page_last[s // self.page_rows] = clock
            return self._device, slots, missing

    def warm_device_path(self) -> None:
        """Build (on first use) and launch the scoring kernel once on a
        one-row batch with no resident entity, so the first scored batch
        does not pay the build; nothing in the table changes."""
        with self._lock:
            buf = self._device
        one = torch.zeros((1, 1), dtype=torch.int32, device=self.device)
        paged_gather_score(
            buf, torch.full((1,), -1, dtype=torch.int32, device=self.device),
            one, torch.zeros((1, 1), dtype=self.dtype, device=self.device))

    def retain_only(self, keep) -> int:
        """Drop every resident entity for which ``keep(entity_id)`` is
        falsy and compact the survivors into the low rows — the membership
        re-own path: when a replica's owned slice shrinks under a new
        epoch, the pages its no-longer-owned entities held must be free
        for the owned slice immediately. The absent set is kept (store
        absence is a property of the model version, not of ownership).
        Returns the number of rows dropped. The survivors are gathered on
        the device into a new buffer, so in-flight batches keep scoring
        their snapshot."""
        with self._lock:
            survivors = [(eid, slot) for eid, slot in
                         sorted(self._slots.items(), key=lambda kv: kv[1])
                         if keep(eid)]
            dropped = len(self._slots) - len(survivors)
            if dropped == 0:
                return 0
            pages_before = sum(1 for f in self._fill if f)
            self._slots.clear()
            self._page_ids = [[] for _ in range(self.pages)]
            self._fill = [0] * self.pages
            for slot, (eid, _) in enumerate(survivors):
                page = slot // self.page_rows
                self._slots[eid] = slot
                self._page_ids[page].append(eid)
                self._fill[page] = slot % self.page_rows + 1
            self.membership_drops += dropped
            pages_after = sum(1 for f in self._fill if f)
            with obs_trace.span("paged.retain_only", cat="serve",
                                table=self.name, dropped=dropped,
                                pages=max(pages_before, pages_after)):
                old = transfer_budget.device_put(
                    np.asarray([s for _, s in survivors], np.int64),
                    self.device, what=f"serve.paged_retain[{self.name}]")
                buf = torch.zeros_like(self._device)
                buf[:old.shape[0]] = self._device.index_select(0, old)
                self._device = buf
            self._named[:] = False
            self._named[:len(survivors)] = True
        if self._metrics is not None:
            self._metrics.record_membership(evictions=dropped)
        return dropped

    # -- install / evict ---------------------------------------------------
    def dense_row(self, entry: CoeffEntry) -> np.ndarray:
        """The entity's coefficients scattered into a ``dim``-wide row."""
        row = np.zeros(self.dim, torch.empty(0, dtype=self.dtype).numpy()
                       .dtype)
        cols, vals = self._row_entries(entry)
        row[cols] = vals
        return row

    def _row_entries(self, entry: CoeffEntry):
        """(global columns, coefficients) of ``entry`` that land in a row
        (columns in ``[0, dim)``, local slots within the vector)."""
        lm = entry.local_map
        gids = np.fromiter(lm.keys(), np.int64, len(lm))
        locs = np.fromiter(lm.values(), np.int64, len(lm))
        coeffs = entry.coefficients
        ok = (gids >= 0) & (gids < self.dim) & (locs < coeffs.shape[0])
        return gids[ok], coeffs[locs[ok]]

    def _allocate(self, written: set) -> Tuple[int, Optional[int]]:
        """A free flat slot, evicting the least-recently-used full page
        when the table is at capacity, never one of the ``written`` pages
        of this install while another is left (caller holds the lock).
        Returns ``(slot, evicted page or None)``."""
        for p in range(self.pages):
            if self._fill[p] < self.page_rows:
                self._page_last[p] = self._clock
                written.add(p)
                return p * self.page_rows + self._fill[p], None
        pool = [p for p in range(self.pages) if p not in written] \
            or range(self.pages)
        victim = min(pool, key=self._page_last.__getitem__)
        self._page_last[victim] = self._clock
        written.add(victim)
        for eid in self._page_ids[victim]:
            self._slots.pop(eid, None)
        self._page_ids[victim] = []
        self._fill[victim] = 0
        self.page_evictions += 1
        if self._metrics is not None:
            self._metrics.record_paged(page_evictions=1)
        return victim * self.page_rows, victim

    def install(self, entries: Dict[str, Optional[CoeffEntry]]) -> int:
        """Install a fault's resolutions: positive entries get rows
        (allocating, and evicting a page when full) and their coefficients
        are written on the device; ``None`` resolutions join the absent
        set. Returns the number of entries installed. Safe to call while
        batches score their snapshots."""
        fault_injection.check("paged.install")
        for entry in entries.values():
            if not entry_supported(entry):
                raise ValueError(
                    f"paged table {self.name!r} cannot hold sketch-"
                    "projected entries; gate the coordinate off the "
                    "paged path")
        writes: Dict[int, CoeffEntry] = {}
        evicted: List[int] = []
        written: set = set()
        copy = False
        installed = 0
        with self._lock:
            for eid, entry in entries.items():
                if entry is None:
                    if eid not in self._absent:
                        self._absent.add(eid)
                        self.absent_marks += 1
                    continue
                slot = self._slots.get(eid)
                if slot is None:
                    slot, victim = self._allocate(written)
                    if victim is not None:
                        evicted.append(victim)
                        lo = victim * self.page_rows
                        for s in [s for s in writes
                                  if lo <= s < lo + self.page_rows]:
                            del writes[s]
                    page = slot // self.page_rows
                    self._slots[eid] = slot
                    self._page_ids[page].append(eid)
                    self._fill[page] = max(self._fill[page],
                                           slot % self.page_rows + 1)
                copy = copy or bool(self._named[slot])
                self._named[slot] = True
                writes[slot] = entry
                installed += 1
            if installed:
                self.installs += installed
                self._write(writes, evicted, copy)
        if installed and self._metrics is not None:
            self._metrics.record_paged(installs=installed)
        return installed

    def _write(self, writes: Dict[int, CoeffEntry], evicted: List[int],
               copy: bool) -> None:
        """The device side of an install (caller holds the lock): copy
        the buffer if a snapshot may read a row being written, zero the
        evicted pages and the written rows, scatter the coefficients."""
        rows, cols, vals = [], [], []
        for slot, entry in writes.items():
            c, v = self._row_entries(entry)
            rows.append(np.full(c.shape[0], slot, np.int64))
            cols.append(c)
            vals.append(v)
        what = f"serve.paged_install[{self.name}]"
        put = transfer_budget.device_put
        slots_t = put(np.fromiter(writes, np.int64, len(writes)),
                      self.device, what=what)
        rows_t = put(np.concatenate(rows), self.device, what=what)
        cols_t = put(np.concatenate(cols), self.device, what=what)
        vals_t = put(np.concatenate(vals), self.device, self.dtype, what)
        with obs_trace.span("paged.page_refresh", cat="serve",
                            table=self.name, rows=len(writes),
                            pages=len({s // self.page_rows for s in writes}),
                            copied=copy):
            buf = self._device
            if copy:
                buf = buf.clone()
                self.snapshot_copies += 1
                self._named[:] = False
                self._named[list(self._slots.values())] = True
            for page in evicted:
                buf[page * self.page_rows:(page + 1) * self.page_rows] = 0
            buf.index_fill_(0, slots_t, 0)
            buf.index_put_((rows_t, cols_t), vals_t)
            self._device = buf
