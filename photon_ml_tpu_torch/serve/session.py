"""Resident scoring session: the device-side half of the serving stack
(counterpart of ``photon_ml_tpu/serve/session.py``).

A :class:`ScoringSession` loads a saved GAME model ONCE and answers
scoring batches for as long as the process lives:

* **Fixed effects resident on the card.** Each fixed coordinate's
  coefficient vector is uploaded once per model version (through
  ``utils/transfer_budget``) and copied, on the card, into a
  session-owned buffer that the captured batch rungs read, so
  steady-state requests move only the batch's padded index/value arrays
  and a hot swap to a new version reuses every captured rung.

* **One CUDA graph per batch rung.** The JAX session jits one executable
  per padded row count and counts compile-cache hits and misses. Here
  every batch is padded up a bounded power-of-two ladder of row counts
  (and one fixed nnz width per shard), and each rung's scoring body is
  captured ONCE into a ``torch.cuda.CUDAGraph`` over static input
  buffers, at :meth:`~ScoringSession.warmup`: a capture counts as a
  cache miss, a replay as a hit, so a capture in steady state is
  observable (the tests pin the miss counter flat). Rungs are keyed by
  shape, not by model version: a batch copies its padded arrays into the
  rung's buffers, the snapshot's fixed vectors into the session's weight
  buffers and the snapshot's table addresses into the rung's address
  slots (all stream-ordered), replays, and reads the outputs back before
  the next replay. On the CPU the same body runs eagerly on the same
  buffers, through the kernels' plain versions.

* **Random effects through a paged table on the card** (default) or the
  host entity LRU. The hot slice of per-entity coefficients lives in a
  :class:`~photon_ml_tpu_torch.serve.paged_table.PagedCoefficientTable`,
  and a batch whose entities are warm scores in ONE replay: fixed
  margins + one :func:`~photon_ml_tpu_torch.ops.kernels
  .paged_gather_score_at` launch per random coordinate + offsets. The
  table gives its buffer a new address on a copy-on-write install, so
  the kernel reads the address of the snapshot it scores from the card
  when it runs instead of baking it into the graph. Cold entities fault
  through the :class:`~photon_ml_tpu_torch.serve.coeff_cache
  .EntityCoefficientLRU` (one batched store pass) and are installed into
  pages before the batch's replay; a background installer rebuilds pages
  after a hot swap so the swap's critical path stays flat. Coordinates
  the table cannot hold (sketch projections, feature spaces wider than
  ``re_dense_dim_max``) keep the LRU path: per-entity coefficients from
  the LRU, score views from the same ``build_score_buckets`` /
  ``score_random_effect`` machinery the batch path uses, and the whole
  batch through ``game.scoring.score_single_batch``. Entities without a
  model contribute score 0 (fixed-effect-only fallback), identical to
  ``score_game_model``.

* **Zero-downtime hot swap** (:meth:`~ScoringSession.swap`). All
  per-version state lives in ONE immutable ``_ModelState``; a swap builds
  the next state off to the side and installs it with a single reference
  assignment, so an in-flight ``score_rows`` keeps its consistent
  snapshot and the next request sees the new version. The previous state
  is retained for :meth:`~ScoringSession.rollback`. Sources: a model
  directory path, or any object with ``.chain`` (model-dir layers,
  topmost first, resolved through ``LayeredCoefficientStore``) and
  ``.version``.

Fallbacks the JAX session has on purpose stay, and are counted: rows
wider than ``pad_nnz`` (``fixed_eager_batches``) and batches the fused
path cannot take (``fused_fallback_batches``). None of them hides the
card: on CUDA a failed capture, replay or kernel build raises.
"""

from __future__ import annotations

import logging
import os
import queue as _queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.game.data import HostSparse
from photon_ml_tpu_torch.game.scoring import score_single_batch
from photon_ml_tpu_torch.io.model_io import (
    load_fixed_effect_coordinate,
    load_model_metadata,
)
from photon_ml_tpu_torch.models import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.obs import trace as obs_trace
from photon_ml_tpu_torch.ops.kernels import (
    paged_gather_score,
    paged_gather_score_at,
)
from photon_ml_tpu_torch.serve.coeff_cache import (
    CoeffEntry,
    EntityCoefficientLRU,
    LayeredCoefficientStore,
    ModelDirCoefficientStore,
)
from photon_ml_tpu_torch.serve.membership import MembershipView
from photon_ml_tpu_torch.serve.metrics import ServingMetrics
from photon_ml_tpu_torch.serve.paged_table import PagedCoefficientTable
from photon_ml_tpu_torch.types import (
    SparseFeatures,
    margins as _margins,
    resolve_device,
)
from photon_ml_tpu_torch.utils import resolve_dtype, transfer_budget

_log = logging.getLogger(__name__)

__all__ = ["ScoringSession", "bucket_ladder", "bucketize"]

# per-row sentinel for "no entity id for this effect" — never a real id,
# never faulted against the store
_NO_ENTITY = "\x00<no-entity>"


def bucket_ladder(top: int, start: int = 1) -> List[int]:
    """Power-of-two ladder ``[start, 2*start, ...]`` whose last rung is
    the smallest power of two >= ``top``."""
    if top < 1:
        raise ValueError(f"ladder top must be >= 1, got {top}")
    out, b = [], max(1, start)
    while b < top:
        out.append(b)
        b *= 2
    out.append(b)
    return out


def bucketize(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder rung >= n; above the ladder, the next power of two
    (an off-ladder capture — counted as a cache miss, never silent)."""
    for b in ladder:
        if n <= b:
            return b
    b = ladder[-1]
    while b < n:
        b *= 2
    return b


class _ModelState:
    """Everything that changes when the served model changes — installed
    and read as one reference, never mutated after construction (the
    paged tables' interiors mutate behind their own locks; the REFERENCES
    here do not, so a swap rebuilds pages by building new tables)."""

    __slots__ = ("chain", "version", "task", "index_maps", "k_pad",
                 "model", "coeff_caches", "resident", "router",
                 "shard_order", "intercepts", "paged", "plan", "fused_sig",
                 "stores")

    def __init__(self, chain, version, task, index_maps, k_pad, model,
                 coeff_caches, resident, router=None, shard_order=(),
                 intercepts=(), paged=None, plan=(), fused_sig=None,
                 stores=None):
        self.chain = chain
        self.version = version
        self.task = task
        self.index_maps = index_maps
        self.k_pad = k_pad
        self.model = model
        self.coeff_caches = coeff_caches
        self.resident = resident
        # -- fused-path plumbing (None fused_sig = fused path disabled)
        self.router = router          # feature key -> ((shard_pos, idx),..)
        self.shard_order = shard_order
        self.intercepts = intercepts  # per shard_order: intercept idx or -1
        self.paged = paged or {}      # RE name -> PagedCoefficientTable
        self.plan = plan              # ordered (kind, name, shard_pos)
        self.fused_sig = fused_sig    # rung key component
        self.stores = stores or {}    # RE name -> its layers' stores


class _Rung:
    """One padded batch shape's scoring body over its static buffers. On
    CUDA the body is captured into ``graph`` once and ``outputs`` are the
    graph's own tensors, overwritten by every replay; ``launches`` is the
    number of ``paged_gather_score`` kernels one replay runs. On the CPU
    (``graph`` None) the body runs eagerly on each call."""

    __slots__ = ("body", "graph", "outputs", "launches", "buffers",
                 "tables")

    def __init__(self, body, buffers: dict):
        self.body = body
        self.buffers = buffers
        self.graph = None
        self.outputs = None
        self.launches = 0
        self.tables: List[torch.Tensor] = []  # the snapshot's tables (CPU)

    def run(self):
        if self.graph is None:
            return self.body()
        self.graph.replay()
        paged_gather_score.launches += self.launches
        return self.outputs


def _layer_with(chain: Sequence[str], rel: str) -> Optional[str]:
    for d in chain:
        if os.path.exists(os.path.join(d, rel)):
            return d
    return None


def _host_copy(t: torch.Tensor, n: int) -> np.ndarray:
    """The first ``n`` entries of ``t`` as a host array of their own (a
    rung's outputs are overwritten by its next run)."""
    return t[:n].to("cpu", copy=True).numpy()


class ScoringSession:
    """One resident GAME model + its captured scoring rungs.

    Thread-safety: ``score_rows`` is safe to call from any thread (the
    rung cache takes a lock, the copy-replay-read of a batch holds
    another, per-version state is snapshotted once per call); the
    intended topology is a single
    :class:`~photon_ml_tpu_torch.serve.batcher.MicroBatcher` worker
    calling it, with :meth:`swap` arriving from an admin endpoint.

    Parameters:
      model_dir: saved model directory (``io/model_io`` layout) or an
        object with ``.chain`` + ``.version``.
      dtype: scoring dtype ("float32"/"float64" or a torch dtype).
      max_batch: top of the row-count bucket ladder; the micro-batcher's
        ``max_batch`` should equal it so no steady-state batch exceeds
        the captured shapes.
      pad_nnz: padded nonzero width per row (one per shard, clamped to
        the shard's feature-map size). A request row with more resolved
        features than this takes the eager path (counted in
        ``fixed_eager_batches``) instead of capturing a new rung.
      coeff_cache_entries: LRU capacity per random-effect coordinate.
      paged_table: keep the hot entity coefficients on the card in a
        paged table and score warm batches through the fused one-replay
        rung (False keeps the host-LRU path; sketched or too-wide
        coordinates take it regardless).
      re_pages / re_page_rows: paged-table geometry per random
        coordinate — ``re_pages * re_page_rows`` resident entities.
      re_dense_dim_max: widest random-effect feature space the paged
        table will densify; beyond it the coordinate stays on the LRU
        path.
      warmup: capture the full ladder at construction (recommended;
        tests that exercise lazy capture pass False).
      device: where the model is served (default ``cuda``, which raises
        without a GPU; ``"cpu"`` runs the bodies eagerly).
    """

    def __init__(self, model_dir, *, dtype="float32",
                 max_batch: int = 64, pad_nnz: int = 64,
                 coeff_cache_entries: int = 4096,
                 paged_table: bool = True, re_pages: int = 4,
                 re_page_rows: int = 256, re_dense_dim_max: int = 4096,
                 metrics: Optional[ServingMetrics] = None,
                 warmup: bool = True, device=None):
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype) if isinstance(dtype, str) else dtype
        self._np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        self.max_batch = int(max_batch)
        self.metrics = metrics or ServingMetrics()
        self.row_ladder = bucket_ladder(self.max_batch)
        self.fixed_eager_batches = 0
        self.fused_fallback_batches = 0
        self.overflow_rows = 0
        self._pad_nnz = int(pad_nnz)
        self._coeff_cache_entries = int(coeff_cache_entries)
        self._paged_enabled = bool(paged_table)
        self._re_pages = int(re_pages)
        self._re_page_rows = int(re_page_rows)
        self._re_dense_dim_max = int(re_dense_dim_max)
        # EWMA of observed cold-fault service time (store read + page
        # install): the degradation ladder's budget check
        self._fault_ewma_s: Optional[float] = None

        # -- background page installer ---------------------------------
        self._install_q: "_queue.Queue" = _queue.Queue(maxsize=256)
        self._install_drops = 0
        self._install_stop = threading.Event()
        # installer joins that outlived close()'s grace (a wedged device
        # install); counted + logged
        self.join_timeouts = 0
        self._installer = threading.Thread(
            target=self._install_worker, daemon=True,
            name="photon-serve-page-install")
        self._installer.start()

        # -- entity-affinity membership (session-level: survives swaps)
        self._membership = MembershipView()

        # -- captured rungs: survive swaps by design -------------------
        self._compiled: Dict[tuple, _Rung] = {}
        self._compile_lock = threading.Lock()
        # held by a capture and by every table write the session issues,
        # so no other thread writes the card's tables mid-capture
        self._device_lock = threading.Lock()
        # held from a batch's first copy into a rung to its read-back: a
        # rung's buffers and outputs serve one batch at a time
        self._replay_lock = threading.Lock()
        # session-owned fixed-coefficient buffers the rungs read, and the
        # resident tensor each last received
        self._weights: Dict[tuple, torch.Tensor] = {}
        self._weight_src: Dict[tuple, torch.Tensor] = {}
        self._swap_lock = threading.Lock()
        self._prev_state: Optional[_ModelState] = None
        self._state = self._build_state(model_dir)
        self.metrics.set_active_version(self._state.version)
        if warmup:
            self.warmup()

    # -- per-version state -------------------------------------------------
    def _build_state(self, source, version: Optional[str] = None,
                     prev: Optional[_ModelState] = None) -> _ModelState:
        """Load one model version into an installable state: metadata,
        index maps, eager fixed-effect coordinates (uploaded to the card
        through ``transfer_budget``), and entity-coefficient caches
        layered down a delta chain when the source carries one.

        When ``prev``'s chain is a proper suffix of the new chain (a
        registry delta published on top of the served version), the
        layers they share keep ``prev``'s store objects: registry
        versions are immutable, so the entity ids a store has read stay
        valid and the delta's swap does not read the shared layers
        again."""
        from photon_ml_tpu_torch.io.paldb import load_index_map

        chain = (list(source.chain) if hasattr(source, "chain")
                 else [str(source)])
        shared = set()
        if (prev is not None and len(chain) > len(prev.chain)
                and chain[len(chain) - len(prev.chain):] == list(prev.chain)):
            shared = set(prev.chain)
        layer_stores: Dict[str, list] = {}
        if version is None:
            version = getattr(source, "version", None) or chain[0]
        meta = load_model_metadata(chain[0])
        task = meta["task"]
        index_maps: Dict[str, object] = {}
        k_pad: Dict[str, int] = {}
        coords: Dict[str, object] = {}
        coeff_caches: Dict[str, EntityCoefficientLRU] = {}
        re_sketched: Dict[str, bool] = {}
        for c in meta["coordinates"]:
            shard = c["feature_shard"]
            if shard not in index_maps:
                layer = _layer_with(chain, f"index-map.{shard}.json")
                if layer is None:
                    raise FileNotFoundError(
                        f"index-map.{shard}.json missing from every "
                        f"layer of {chain}")
                imap = load_index_map(
                    os.path.join(layer, f"index-map.{shard}.json"))
                index_maps[shard] = imap
                k_pad[shard] = max(1, min(self._pad_nnz, imap.size))
            imap = index_maps[shard]
            if c["type"] == "fixed":
                rel = os.path.join("fixed-effect", c["name"],
                                   "coefficients.avro")
                layer = _layer_with(chain, rel)
                if layer is None:
                    raise FileNotFoundError(
                        f"{rel} missing from every layer of {chain}")
                coords[c["name"]] = load_fixed_effect_coordinate(
                    layer, c["name"], imap, task, shard, device="cpu")
            else:
                # bucketless stub: the coordinate takes part in the shared
                # scoring loop, but its per-entity coefficients come from
                # the LRU, never from resident buckets
                coords[c["name"]] = RandomEffectModel(
                    c["name"], [], task, shard,
                    entity_column=c.get("entity_column", ""))
                rel = os.path.join("random-effect", c["name"],
                                   "coefficients.avro")
                kept = {st.model_dir: st for st in (
                    prev.stores.get(c["name"], ()) if shared else ())}
                stores = [
                    kept[d] if d in kept
                    else ModelDirCoefficientStore(d, c["name"], imap,
                                                  c.get("projection"))
                    for d in chain
                    if os.path.exists(os.path.join(d, rel))
                ]
                layer_stores[c["name"]] = stores
                store = (stores[0] if len(stores) == 1
                         else LayeredCoefficientStore(stores))
                coeff_caches[c["name"]] = EntityCoefficientLRU(
                    store.load, self._coeff_cache_entries,
                    metrics=self.metrics, batch_loader=store.load_many)
                proj = c.get("projection")
                re_sketched[c["name"]] = bool(
                    proj and proj.get("type") == "random")
        model = GameModel(coords, task)

        # -- device residency: one budget-accounted upload per fixed
        # coordinate per VERSION (swaps re-upload; rungs persist)
        resident: Dict[str, torch.Tensor] = {}
        for name, coord in model.coordinates.items():
            if isinstance(coord, FixedEffectModel):
                resident[name] = transfer_budget.device_put(
                    coord.model.coefficients.means.numpy(), self.device,
                    self.dtype, what=f"serve.fixed[{name}]")

        # -- one-pass feature router: feature key -> every (shard, index)
        # it resolves to
        shard_order = tuple(index_maps)
        shard_pos = {s: i for i, s in enumerate(shard_order)}
        router: Dict[str, tuple] = {}
        for s, imap in index_maps.items():
            si = shard_pos[s]
            for key, idx in imap.forward.items():
                router[key] = router.get(key, ()) + ((si, idx),)
        intercepts = tuple(index_maps[s].intercept_index
                           for s in shard_order)

        # -- paged residency + the fused one-replay plan: eligible when
        # EVERY random coordinate can live in a paged table
        paged: Dict[str, PagedCoefficientTable] = {}
        plan: List[tuple] = []
        fused_ok = self._paged_enabled
        for name, coord in model.coordinates.items():
            si = shard_pos[coord.feature_shard]
            if isinstance(coord, FixedEffectModel):
                plan.append(("fixed", name, si))
                continue
            plan.append(("random", name, si))
            dim = index_maps[coord.feature_shard].size
            if (not self._paged_enabled or re_sketched.get(name)
                    or dim > self._re_dense_dim_max):
                fused_ok = False
                continue
            paged[name] = PagedCoefficientTable(
                dim, pages=self._re_pages, page_rows=self._re_page_rows,
                dtype=self.dtype, name=name, metrics=self.metrics,
                device=self.device)
        fused_sig = None
        if fused_ok:
            # same signature <=> same rungs: a hot swap between
            # same-shaped models reuses the whole captured ladder
            fused_sig = (
                tuple(plan),
                tuple((s, index_maps[s].size, k_pad[s])
                      for s in shard_order),
                tuple((n, paged[n].capacity, paged[n].dim)
                      for _, n, _ in plan if n in paged),
            )
        return _ModelState(chain, str(version), task, index_maps, k_pad,
                           model, coeff_caches, resident, router=router,
                           shard_order=shard_order, intercepts=intercepts,
                           paged=paged, plan=tuple(plan),
                           fused_sig=fused_sig, stores=layer_stores)

    # -- compatibility views over the active state ------------------------
    @property
    def model_dir(self) -> str:
        return self._state.chain[0]

    @property
    def model(self) -> GameModel:
        return self._state.model

    @property
    def task(self) -> str:
        return self._state.task

    @property
    def active_version(self) -> str:
        return self._state.version

    # -- hot swap ----------------------------------------------------------
    def swap(self, source, *, version: Optional[str] = None,
             warm_from_previous: bool = True) -> str:
        """Atomically switch to another model version with zero downtime.

        Builds the whole next state off to the side — new fixed-effect
        coefficients uploaded through ``transfer_budget``, new entity
        caches, optionally pre-warmed with the previous caches' resident
        hot set — then installs it with one reference assignment. The
        captured rungs are untouched: they are keyed by shape, not
        version, so a swap between same-dimensioned models never
        captures (the tests pin the miss counter flat across a swap). The
        previous state is retained until the next swap so
        :meth:`rollback` is instant."""
        t0 = time.perf_counter()
        new = self._build_state(source, version, prev=self._state)
        if warm_from_previous:
            for name, cache in new.coeff_caches.items():
                old = self._state.coeff_caches.get(name)
                old_paged = self._state.paged.get(name)
                hot = list(old.cached_ids()) if old is not None else []
                if old_paged is not None:
                    seen = set(hot)
                    hot += [e for e in old_paged.resident_ids()
                            if e not in seen]
                if hot and self._membership.active:
                    # under a membership epoch, prewarm only the owned
                    # slice
                    owned = self._membership.owned_many(hot)
                    hot = [e for e, o in zip(hot, owned) if o]
                if not hot:
                    continue
                carried = self._carried_entries(name, new, old, hot)
                if carried:
                    hot = [e for e in hot if e not in carried]
                table = new.paged.get(name)
                if table is None:
                    cache.prefetch(hot)
                    cache.seed(carried)
                else:
                    # the LRU warms synchronously (one store pass, or
                    # none for a delta's untouched entities), page
                    # installs ride the background installer
                    entries = cache.warm_entries(hot) if hot else {}
                    cache.seed(carried)
                    entries.update(carried)
                    self._install_async(table, entries)
        with self._swap_lock:
            self._prev_state, self._state = self._state, new
        self.metrics.record_swap(new.version,
                                 (time.perf_counter() - t0) * 1e3)
        return new.version

    def _carried_entries(self, name: str, new: _ModelState, old, hot
                         ) -> Dict[str, Optional[CoeffEntry]]:
        """The previous version's cached entries that a delta swap can
        keep: when the new state's lower layers for coordinate ``name``
        are the previous state's own store objects (``_build_state``
        kept them), an entity that none of the new top layers knows
        resolves to the same record as before. Empty otherwise."""
        new_layers = new.stores.get(name, [])
        old_layers = self._state.stores.get(name, [])
        n_top = len(new_layers) - len(old_layers)
        if (old is None or not old_layers or n_top < 0 or any(
                a is not b for a, b in zip(new_layers[n_top:], old_layers))):
            return {}
        top_known = set()
        for st in new_layers[:n_top]:
            top_known |= st.known_ids()
        return {e: entry for e, entry in old.resident_many(hot).items()
                if e not in top_known}

    # -- entity-affinity membership ---------------------------------------
    @property
    def membership(self) -> MembershipView:
        return self._membership

    def set_membership(self, *, epoch: int, num_shards: int,
                       shard_index: int, id_kind: str = "auto") -> bool:
        """Apply a membership epoch (``POST /admin/membership``): this
        session is shard ``shard_index`` of ``num_shards`` replicas.
        Stale epochs are refused (returns False, nothing changes). On a
        real ownership change, every paged table drops and compacts the
        rows this replica no longer owns; non-owned entities keep scoring
        correctly through the host LRU path."""
        if not self._membership.apply(epoch, num_shards, shard_index,
                                      id_kind):
            return False
        self.metrics.set_membership_epoch(self._membership.epoch)
        if self._membership.active:
            mv = self._membership
            for table in self._state.paged.values():
                with self._device_lock:
                    table.retain_only(mv.owned)
        return True

    def prefetch_entities(self, entity_ids) -> tuple:
        """Warm the moved slice of a membership rebalance: load
        ``entity_ids`` through each coordinate's batched store pass and
        install them into the paged tables SYNCHRONOUSLY. Ids this
        replica does not own under the applied epoch are skipped. Returns
        ``(entities, bytes)`` actually landed."""
        ids = [str(e) for e in entity_ids]
        mv = self._membership
        if mv.active and ids:
            owned = mv.owned_many(ids)
            ids = [e for e, o in zip(ids, owned) if o]
        if not ids:
            return 0, 0
        st = self._state
        total = moved_bytes = 0
        with obs_trace.span("membership.prefetch", cat="serve",
                            entities=len(ids)):
            for name, cache in st.coeff_caches.items():
                entries = cache.warm_entries(ids)
                present = {k: v for k, v in entries.items()
                           if v is not None}
                if not present:
                    continue
                total += len(present)
                table = st.paged.get(name)
                if table is not None:
                    with self._device_lock:
                        installed = table.install(present)
                    moved_bytes += (installed * table.dim
                                    * table.device_buffer.element_size())
                else:
                    moved_bytes += sum(
                        v.coefficients.nbytes for v in present.values())
        if total:
            self.metrics.record_membership(prefetch_entities=total,
                                           prefetch_bytes=moved_bytes)
        return total, moved_bytes

    def rollback(self) -> str:
        """Re-install the state the last swap replaced. Counts as a swap
        in the metrics."""
        t0 = time.perf_counter()
        with self._swap_lock:
            if self._prev_state is None:
                raise RuntimeError("no previous version to roll back to")
            self._prev_state, self._state = self._state, self._prev_state
            version = self._state.version
        self.metrics.record_swap(version, (time.perf_counter() - t0) * 1e3)
        return version

    # -- background page installer -----------------------------------------
    # idle-poll interval (seconds) for the installer's queue wait; a
    # class attribute so tests can shrink it without monkeypatching
    _install_poll_s = 0.2

    def _install_worker(self) -> None:
        while True:
            try:
                # bounded idle poll: each expiry rechecks the stop event
                item = self._install_q.get(timeout=self._install_poll_s)
            except _queue.Empty:
                if self._install_stop.is_set():
                    return
                continue
            if item is None:  # shutdown sentinel from close()
                self._install_q.task_done()
                return
            table, entries, tctx = item
            try:
                with obs_trace.use_context(tctx), \
                        obs_trace.span("paged.install_async", cat="serve",
                                       entries=len(entries)), \
                        self._device_lock:
                    table.install(entries)
            except Exception:  # residency is an optimization
                _log.exception("ScoringSession: background page install "
                               "failed; the entities keep faulting in")
            finally:
                self._install_q.task_done()

    def _install_async(self, table: PagedCoefficientTable,
                       entries: Dict[str, object]) -> None:
        """Queue a page install; under install-queue pressure the entries
        are DROPPED (residency is an optimization, and blocking the
        scoring thread on it would recreate the round trip the table
        removes)."""
        if not entries:
            return
        try:
            self._install_q.put_nowait(
                (table, entries, obs_trace.current_context()))
        except _queue.Full:
            self._install_drops += 1

    def drain_installs(self, timeout_s: float = 10.0) -> bool:
        """Block until queued page installs have been applied (tests use
        this to make residency deterministic)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._install_q.unfinished_tasks == 0:
                return True
            time.sleep(0.002)
        return False

    @property
    def warming(self) -> bool:
        """True while background page installs are still pending;
        ``/healthz`` reports ``warming``."""
        return self._install_q.unfinished_tasks > 0

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop the background page installer with a bounded join
        (idempotent). Pending installs are abandoned. An installer that
        outlives the grace is counted and logged, never waited on
        forever."""
        if self._install_stop.is_set():
            return
        self._install_stop.set()
        try:
            self._install_q.put_nowait(None)  # wake the idle poll now
        except _queue.Full:
            pass  # the stop event wakes the bounded poll instead
        self._installer.join(timeout_s)
        if self._installer.is_alive():
            self.join_timeouts += 1
            _log.warning(
                "ScoringSession: installer thread %r still alive %.1fs "
                "after close() (wedged device install?); leaking it as "
                "a daemon (join timeouts so far: %d)",
                self._installer.name, timeout_s, self.join_timeouts)

    # -- rung cache --------------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Number of rungs captured so far (== rung-cache misses); the
        no-steady-state-capture tests watch this."""
        return self.metrics.compile_cache_misses

    def _weight(self, key: tuple, w: torch.Tensor) -> torch.Tensor:
        """The session-owned buffer that rungs read for ``key``'s fixed
        coefficients, holding ``w`` (a device-to-device copy, in stream
        order, only when the buffer last received another tensor). Caller
        holds the replay lock."""
        buf = self._weights.get(key)
        if buf is None:
            buf = self._weights[key] = torch.empty_like(w)
        if self._weight_src.get(key) is not w:
            buf.copy_(w)
            self._weight_src[key] = w
        return buf

    def _capture(self, rung: _Rung) -> _Rung:
        """Capture ``rung``'s body on CUDA (on the CPU it stays eager).
        The kernel library is built first; the body runs once eagerly on
        a side stream (its kernels run on the card and count), then is
        captured. The capture's own launches are taken back out of the
        count (a capture runs nothing), and each replay adds them again.
        Caller holds the compile and replay locks."""
        if self.device.type != "cuda":
            return rung
        from photon_ml_tpu_torch.ops.kernel_build import load_library

        load_library()
        with self._device_lock, torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                rung.body()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = paged_gather_score.launches
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = rung.body()
            rung.launches = paged_gather_score.launches - before
            paged_gather_score.launches = before
        rung.graph, rung.outputs = graph, outputs
        return rung

    def _executable(self, dim: int, B: int, k: int, w: torch.Tensor
                    ) -> _Rung:
        """The (coefficient dim, rows, nnz)-shaped fixed-margin rung,
        captured on first use; ``w`` is the resident vector it captures
        against (its buffer is refilled per batch)."""
        key = (dim, B, k)
        with self._compile_lock:
            rung = self._compiled.get(key)
            if rung is not None:
                self.metrics.record_compile(hit=True)
                return rung
            self.metrics.record_compile(hit=False)
            dev = self.device
            idx = torch.zeros((B, k), dtype=torch.int32, device=dev)
            val = torch.zeros((B, k), dtype=self.dtype, device=dev)
            with self._replay_lock:
                wbuf = self._weight(("margins", dim), w)

                def body():
                    return _margins(SparseFeatures(idx, val, dim=dim), wbuf)

                rung = self._capture(_Rung(body, {"idx": idx, "val": val}))
            self._compiled[key] = rung
            return rung

    def _fused_executable(self, B: int, st: _ModelState) -> _Rung:
        """The whole-batch one-replay rung for row bucket ``B``: offsets
        + every fixed coordinate's margins + one paged gather per random
        coordinate. Keyed by the state's ``fused_sig`` (coordinate plan +
        shard dims + table shapes) — NOT by version, so a hot swap
        between same-shaped models reuses the captured ladder."""
        key = ("fused", B, st.fused_sig)
        with self._compile_lock:
            rung = self._compiled.get(key)
            if rung is not None:
                self.metrics.record_compile(hit=True)
                return rung
            self.metrics.record_compile(hit=False)
            dev, dt = self.device, self.dtype
            plan = st.plan
            dims = tuple(st.index_maps[s].size for s in st.shard_order)
            idx = [torch.zeros((B, st.k_pad[s]), dtype=torch.int32,
                               device=dev) for s in st.shard_order]
            val = [torch.zeros((B, st.k_pad[s]), dtype=dt, device=dev)
                   for s in st.shard_order]
            tables = [st.paged[name].device_buffer
                      for kind, name, _ in plan if kind == "random"]
            slots = [torch.full((B,), -1, dtype=torch.int32, device=dev)
                     for _ in tables]
            table_at = torch.tensor([t.data_ptr() for t in tables],
                                    dtype=torch.int64, device=dev)
            offsets = torch.zeros(B, dtype=dt, device=dev)

            def body():
                total = offsets
                parts = []
                fi = ri = 0
                for kind, _name, si in plan:
                    if kind == "fixed":
                        m = _margins(SparseFeatures(idx[si], val[si],
                                                    dim=dims[si]),
                                     weights[fi])
                        fi += 1
                    else:
                        m = paged_gather_score_at(
                            table_at[ri:ri + 1], rung.tables[ri],
                            slots[ri], idx[si], val[si])
                        ri += 1
                    parts.append(m)
                    total = total + m
                return total, parts

            rung = _Rung(body, {"offsets": offsets, "idx": idx, "val": val,
                                "slots": slots, "table_at": table_at})
            # the tables the capture sees stand for every snapshot of the
            # same shapes: a replay reads the addresses in ``table_at``
            rung.tables = tables
            with self._replay_lock:
                weights = [self._weight((name, dims[si]), st.resident[name])
                           for kind, name, si in plan if kind == "fixed"]
                self._capture(rung)
            self._compiled[key] = rung
            return rung

    def warmup(self) -> int:
        """Capture the rungs the configured hot path uses for every row
        bucket, so steady-state traffic inside the ladder never waits on
        a capture — the fused ladder when the paged path is live, the
        per-fixed-coordinate ladder otherwise. Returns the number of
        rungs captured."""
        st = self._state
        before = self.metrics.compile_cache_misses
        if st.fused_sig is not None:
            for B in self.row_ladder:
                self._fused_executable(B, st)
            for table in st.paged.values():
                table.warm_device_path()
        else:
            for name, coord in st.model.coordinates.items():
                if not isinstance(coord, FixedEffectModel):
                    continue
                k = st.k_pad[coord.feature_shard]
                w = st.resident[name]
                for B in self.row_ladder:
                    self._executable(int(w.shape[0]), B, k, w)
        return self.metrics.compile_cache_misses - before

    # -- scoring -----------------------------------------------------------
    def _fixed_scorer(self, n: int, st: _ModelState):
        """The ``fixed_scorer`` hook for ``score_single_batch``: route a
        fixed coordinate through its padded rung (or the eager path for
        rows wider than the shard's pad width)."""

        def score(name, coord, sp: HostSparse):
            k = st.k_pad[coord.feature_shard]
            w_dev = st.resident[name]
            put = transfer_budget.device_put
            if sp.indices.shape[1] > k and _max_live_nnz(sp) > k:
                self.fixed_eager_batches += 1
                what = f"serve.eager_batch[{name}]"
                feats = SparseFeatures(
                    put(sp.indices, self.device, torch.int32, what),
                    None if sp.values is None
                    else put(sp.values, self.device, self.dtype, what),
                    dim=sp.dim)
                return _margins(feats, w_dev)
            B = bucketize(max(n, 1), self.row_ladder)
            dim = int(w_dev.shape[0])
            rung = self._executable(dim, B, k, w_dev)
            idx = np.zeros((B, k), np.int32)
            val = np.zeros((B, k), self._np_dtype)
            kc = min(sp.indices.shape[1], k)
            idx[:n, :kc] = sp.indices[:, :kc]
            val[:n, :kc] = 1.0 if sp.values is None else sp.values[:, :kc]
            transfer_budget.charge(idx.nbytes + val.nbytes,
                                   f"serve.batch[{name}]")
            with self._replay_lock:
                rung.buffers["idx"].copy_(torch.from_numpy(idx))
                rung.buffers["val"].copy_(torch.from_numpy(val))
                self._weight(("margins", dim), w_dev)
                return rung.run()[:n].clone()

        return score

    # -- degradation ladder ------------------------------------------------
    @staticmethod
    def _ladder_level(ctx) -> int:
        """The effective degradation level for this point of the batch:
        the brownout floor raised by any budget/fault escalation earlier
        in the same batch (0 = full, 1 = resident-only, 2 = fixed-only)."""
        return 0 if ctx is None else max(ctx.level, ctx.degraded)

    @staticmethod
    def _note_degrade(ctx, level: int, reason: str) -> None:
        if ctx.degraded < level:
            ctx.degraded = level
        ctx.reasons.append(reason)

    def _note_fault_cost(self, elapsed_s: float) -> None:
        """Fold one observed cold-fault service time into the EWMA the
        budget check compares the remaining deadline against."""
        prev = self._fault_ewma_s
        self._fault_ewma_s = (elapsed_s if prev is None
                              else prev + 0.3 * (elapsed_s - prev))

    def _budget_blocks_fault(self, ctx) -> bool:
        """True when the batch's remaining budget cannot cover one more
        cold-store fault (by the measured EWMA; with no measurement yet
        only an already-expired budget blocks)."""
        if ctx is None:
            return False
        rem = ctx.remaining_s()
        return rem is not None and rem <= (self._fault_ewma_s or 0.0)

    def _re_views(self, name: str, coord: RandomEffectModel,
                  entity_ids: np.ndarray, host: Dict[str, HostSparse],
                  st: _ModelState, ctx=None):
        """(views, coeffs) for one random coordinate of one batch, from
        cached entity coefficients — the same structures
        ``build_model_score_views`` derives from a fully-loaded model.
        Under a degraded ``ctx`` the store is never touched: level >= 2
        contributes nothing, level 1 scores from the LRU's resident
        entries only, and level 0 escalates to 1 when the remaining
        budget cannot cover a cold fault or the store itself fails."""
        from photon_ml_tpu_torch.game.data import (
            build_score_buckets,
            group_rows_by_slot,
        )

        cache = st.coeff_caches[name]
        level = self._ladder_level(ctx)
        if level >= 2:
            return [], []
        if level >= 1:
            resolved = cache.resident_many(entity_ids)
        elif self._budget_blocks_fault(ctx):
            self._note_degrade(ctx, 1, "budget")
            resolved = cache.resident_many(entity_ids)
        else:
            try:
                misses0 = cache.misses
                t0 = time.monotonic()
                resolved = cache.get_many(entity_ids)
                if cache.misses > misses0:
                    self._note_fault_cost(time.monotonic() - t0)
            except Exception:
                if ctx is None:
                    raise
                self._note_fault_cost(time.monotonic() - t0)
                self._note_degrade(ctx, 1, "store_fault")
                resolved = cache.resident_many(entity_ids)
        present = [eid for eid, entry in resolved.items()
                   if entry is not None]
        if not present:
            return [], []
        entity_to_slot = {eid: (0, j) for j, eid in enumerate(present)}
        per_bucket_rows = group_rows_by_slot(
            entity_ids, entity_to_slot, [len(present)])
        local_maps = [[resolved[eid].local_map for eid in present]]
        D = max(max(resolved[eid].local_dim for eid in present), 1)
        coeffs = np.zeros((len(present), D))
        for j, eid in enumerate(present):
            row = resolved[eid].coefficients
            coeffs[j, : row.shape[0]] = row
        views = build_score_buckets(
            host[coord.feature_shard], per_bucket_rows, local_maps)
        return views, [coeffs]

    def score_rows(self, rows: List[dict], per_coordinate: bool = False,
                   ctx=None):
        """Score a batch of request rows.

        Each row is a dict: ``features`` — list of ``{"name", "term",
        "value"}`` feature dicts (or ``(name, term, value)`` tuples);
        ``entityIds`` — entity-column -> id for the random effects;
        ``offset`` — optional margin offset. Returns ``np.ndarray [n]``
        scores (plus a per-coordinate dict when requested), in row order.

        Warm batches take the fused paged path (one replay); a batch with
        rows wider than a shard's pad width — or a model the paged table
        cannot hold — takes the per-coordinate path. Both give the same
        scores within float64 rounding.

        ``ctx`` (a :class:`~photon_ml_tpu_torch.serve.batcher
        .ScoreContext`) arms the degradation ladder: its remaining
        deadline budget gates cold-store faults, its brownout level floors
        the fidelity, and the level actually served lands back in
        ``ctx.degraded``. With ``ctx=None`` (or a level-0 ctx, no faults,
        ample budget) the code path — and every score bit — is
        unchanged."""
        st = self._state  # one consistent snapshot across the batch
        n = len(rows)
        if n == 0:
            return ((np.zeros(0), {}) if per_coordinate else np.zeros(0))
        if n > self.max_batch:
            raise ValueError(
                f"batch of {n} rows exceeds max_batch={self.max_batch}; "
                "split it (the micro-batcher never sends oversized "
                "batches)")
        with obs_trace.span("session.resolve", cat="serve", rows=n):
            host = self._resolve_all(rows, st)
        offsets = np.asarray(
            [float(r.get("offset") or 0.0) for r in rows], self._np_dtype)
        if st.fused_sig is not None:
            if all(host[s].indices.shape[1] <= st.k_pad[s]
                   for s in st.shard_order):
                return self._score_fused(rows, host, offsets, n, st,
                                         per_coordinate, ctx)
            self.fused_fallback_batches += 1
        score_views = {}
        for name, coord in st.model.coordinates.items():
            if isinstance(coord, RandomEffectModel):
                ids = self._entity_column_values(rows, coord, name)
                score_views[name] = self._re_views(name, coord, ids, host,
                                                   st, ctx)
        result = score_single_batch(
            st.model, host, score_views, offsets=offsets,
            dtype=self.dtype, per_coordinate=per_coordinate,
            fixed_scorer=self._fixed_scorer(n, st), device=self.device)
        if per_coordinate:
            total, parts = result
            return (_host_copy(total, n),
                    {k: _host_copy(v, n) for k, v in parts.items()})
        return _host_copy(result, n)

    # rounds of fault, install and replay one batch may take; rows whose
    # entities its own installs keep evicting then get host math
    _max_rounds = 4

    def _score_fused(self, rows, host, offsets, n, st: _ModelState,
                     per_coordinate: bool, ctx=None):
        """The paged hot path: pad the batch onto the row-bucket ladder,
        resolve entity ids to table slots, and score everything in one
        replay. Cold entities (resident in neither pages nor the absent
        set) fault through the LRU and are installed into pages BEFORE
        the replay — the disk read dominates a cold fault anyway, and one
        margin path keeps scores bitwise-stable across identical swaps:
        the kernel sums a row in an order fixed by its width alone
        (``ops.kernels.paged_gather_score_ordered_plain``), whichever
        slot, page or snapshot holds its entity.

        An install may evict a page that holds entities the same batch
        found resident (every page was touched by the batch). The JAX
        session then scores those rows by host math; here the rows whose
        entities are all resident are taken from the replay and the rest
        go round again — fault, install, replay — so every row comes from
        the one margin path (each replay is a rung hit). Only rows still
        unresolved in the last of ``_max_rounds`` rounds (a batch with
        more distinct entities than the table) take the JAX session's
        host math for their missing entities (``overflow_rows``)."""
        dt = self._np_dtype
        B = bucketize(max(n, 1), self.row_ladder)
        shard_idx, shard_val = [], []
        batch_bytes = 0
        for s in st.shard_order:
            sp = host[s]
            k = st.k_pad[s]
            idx = np.zeros((B, k), np.int32)
            val = np.zeros((B, k), dt)
            kk = sp.indices.shape[1]
            idx[:n, :kk] = sp.indices
            val[:n, :kk] = sp.values
            batch_bytes += idx.nbytes + val.nbytes
            shard_idx.append(idx)
            shard_val.append(val)
        off = np.zeros(B, dt)
        off[:n] = offsets
        batch_bytes += off.nbytes
        coords = [(pos, name, si) for pos, (kind, name, si)
                  in enumerate(st.plan) if kind == "random"]
        ids = {name: self._entity_column_values(
            rows, st.model.coordinates[name], name).tolist()
            for _, name, _ in coords}
        total = np.zeros(n, dt)
        parts = np.zeros((len(st.plan), n), dt)
        pending = np.arange(n)
        for rnd in range(self._max_rounds):
            last = rnd == self._max_rounds - 1
            ready = np.ones(pending.size, bool)
            re_bufs, re_slots, extras = [], [], []
            for pos, name, si in coords:
                table = st.paged[name]
                sub = [ids[name][i] for i in pending]
                if self._ladder_level(ctx) >= 2:
                    # fixed-effect-only margin: every slot is the -1
                    # sentinel, so the gather contributes exactly 0
                    buf, slots = table.device_buffer, np.full(
                        pending.size, -1, np.int32)
                    still, entries = set(), {}
                else:
                    buf, slots, still, entries = self._table_slots(
                        name, table, sub, st, ctx)
                if still:
                    evicted = np.array([e in still for e in sub])
                    if last:
                        self.overflow_rows += int(evicted.sum())
                        extras.append((pos, self._host_margins(
                            table, st.coeff_caches[name], entries,
                            host[st.shard_order[si]], pending[evicted],
                            [e for e, x in zip(sub, evicted) if x], n)))
                    else:
                        ready &= ~evicted
                slots_pad = np.full(B, -1, np.int32)
                slots_pad[pending] = slots
                re_bufs.append(buf)
                re_slots.append(slots_pad)
            # ONE budget charge for the round's host->device bytes
            transfer_budget.charge(
                batch_bytes + sum(sl.nbytes for sl in re_slots),
                "serve.fused_batch")
            out_total, out_parts = self._replay(
                B, st, n, off, shard_idx, shard_val, re_bufs, re_slots,
                per_coordinate)
            done = pending[ready]
            total[done] = out_total[done]
            if per_coordinate:
                parts[:, done] = out_parts[:, done]
            for pos, extra in extras:
                total[done] += extra[done]
                parts[pos, done] += extra[done]
            pending = pending[~ready]
            if pending.size == 0:
                break
        if not per_coordinate:
            return total
        return total, {name: parts[pos]
                       for pos, (_kind, name, _si) in enumerate(st.plan)}

    def _table_slots(self, name: str, table: PagedCoefficientTable,
                     ids: List[str], st: _ModelState, ctx):
        """One coordinate's snapshot for one round: ``(buffer, slots,
        still, entries)``. Missing entities fault through the LRU and are
        installed first (unless the degradation ladder or the budget
        forbids the store, when they keep slot -1); ``still`` holds the
        entities this round's install evicted again, ``entries`` the
        fault's resolutions."""
        buf, slots, missing = table.lookup(ids)
        missing = [m for m in missing if m != _NO_ENTITY]
        if missing and self._ladder_level(ctx) >= 1:
            # resident-pages-only: the missing entities keep slot -1
            missing = []
        elif missing and self._budget_blocks_fault(ctx):
            self._note_degrade(ctx, 1, "budget")
            missing = []
        if not missing:
            return buf, slots, set(), {}
        self.metrics.record_paged(faults=len(missing))
        t0_fault = time.monotonic()
        entries: Dict[str, object] = {}
        try:
            with obs_trace.span("paged.fault_install", cat="serve",
                                coordinate=name, entities=len(missing)):
                entries = st.coeff_caches[name].get_many(missing)
                to_install = entries
                if self._membership.active:
                    # non-owned entities never take pages: they resolve
                    # through the host math below
                    owned = self._membership.owned_many(list(entries))
                    to_install = {e: entries[e]
                                  for e, o in zip(entries, owned) if o}
                    skipped = len(entries) - len(to_install)
                    if skipped:
                        self.metrics.record_membership(
                            non_owned_skips=skipped)
                with self._device_lock:
                    table.install(to_install)
                # re-read: fresh buffer + installed slots
                buf, slots, still = table.lookup(ids)
            self._note_fault_cost(time.monotonic() - t0_fault)
        except Exception:
            if ctx is None:
                raise
            # store/install failure: serve this batch from what is
            # resident (the failed entities keep slot -1)
            self._note_fault_cost(time.monotonic() - t0_fault)
            self._note_degrade(ctx, 1, "store_fault")
            return buf, slots, set(), entries
        return buf, slots, set(still) - {_NO_ENTITY}, entries

    def _host_margins(self, table, cache, entries, sp: HostSparse, rows,
                      row_ids, n: int) -> np.ndarray:
        """Host math for ``rows`` (batch positions) whose entities
        ``row_ids`` are not resident: each entity's coefficients densified
        into a table row and dotted with the row's features."""
        dt = self._np_dtype
        extra = np.zeros(n, dt)
        dense: Dict[str, np.ndarray] = {}
        for i, eid in zip(rows, row_ids):
            entry = entries.get(eid) or cache.get(eid)
            if entry is None:
                continue
            drow = dense.get(eid)
            if drow is None:
                drow = dense[eid] = table.dense_row(entry)
            extra[i] = np.dot(drow[sp.indices[i]], sp.values[i].astype(dt))
        return extra

    def _replay(self, B: int, st: _ModelState, n: int, off, shard_idx,
                shard_val, re_bufs, re_slots, per_coordinate: bool):
        """One run of the batch's fused rung: copy the padded batch, the
        snapshot's table addresses and fixed vectors into the rung's and
        the session's buffers, replay, and read the first ``n`` outputs
        back (total, and per plan position when asked) before the lock
        lets another batch in. ``re_bufs`` keeps the snapshot's tables
        alive until then."""
        rung = self._fused_executable(B, st)
        bufs = rung.buffers
        addresses = torch.tensor([b.data_ptr() for b in re_bufs],
                                 dtype=torch.int64)
        with obs_trace.span("session.device_compute", cat="serve",
                            rows=n, bucket=B), self._replay_lock:
            bufs["offsets"].copy_(torch.from_numpy(off))
            for si in range(len(shard_idx)):
                bufs["idx"][si].copy_(torch.from_numpy(shard_idx[si]))
                bufs["val"][si].copy_(torch.from_numpy(shard_val[si]))
            for ri in range(len(re_slots)):
                bufs["slots"][ri].copy_(torch.from_numpy(re_slots[ri]))
            bufs["table_at"].copy_(addresses)
            for kind, name, si in st.plan:
                if kind == "fixed":
                    self._weight(
                        (name, st.index_maps[st.shard_order[si]].size),
                        st.resident[name])
            # the eager (CPU) body reads the snapshot's tables; a replay
            # reads the addresses just written
            rung.tables = re_bufs
            total_d, parts_d = rung.run()
            total = _host_copy(total_d, n)
            parts = (np.stack([_host_copy(p, n) for p in parts_d])
                     if per_coordinate else None)
        return total, parts

    # -- request parsing ---------------------------------------------------
    def _resolve_all(self, rows: List[dict],
                     st: _ModelState) -> Dict[str, HostSparse]:
        """Resolve every row's features for EVERY shard in one pass
        through the state's feature router — the same resolution (+
        implicit intercept) the Avro data reader applies, so served rows
        see the exact training-time feature space. Unknown features are
        dropped (per-shard feature selection, as in the batch path)."""
        S = len(st.shard_order)
        rget = st.router.get  # hoisted: this runs once per FEATURE
        per: List[List[list]] = [[] for _ in range(S)]
        for r in rows:
            rowbufs: List[Optional[list]] = [None] * S
            feats = r.get("features") or ()
            if feats and type(feats[0]) is dict:
                keyed = [
                    (rget(f["name"] if type(f["name"]) is str
                          else str(f["name"]))
                     if not f.get("term") else
                     rget(f"{f['name']}\x01{f['term']}"),
                     f.get("value", 1.0))
                    for f in feats if "name" in f]
            else:
                keyed = []
                for name, term, value in feats:
                    if type(name) is not str:
                        name = str(name)
                    if term:
                        key = (f"{name}\x01{term}" if type(term) is str
                               else f"{name}\x01{term!s}")
                    else:
                        key = name
                    keyed.append((rget(key), value))
            for hits, value in keyed:
                if hits:
                    for si, idx in hits:
                        b = rowbufs[si]
                        if b is None:
                            b = rowbufs[si] = []
                        b.append((idx, value))
            for si in range(S):
                per[si].append(rowbufs[si] if rowbufs[si] is not None
                               else [])
        out: Dict[str, HostSparse] = {}
        for si, shard in enumerate(st.shard_order):
            parsed = per[si]
            intercept = st.intercepts[si]
            if intercept is not None and intercept >= 0:
                for p in parsed:
                    p.append((intercept, 1.0))
            k = max(max((len(p) for p in parsed), default=0), 1)
            indices = np.zeros((len(rows), k), np.int32)
            values = np.zeros((len(rows), k))
            for i, p in enumerate(parsed):
                for j, (idx, val) in enumerate(p):
                    indices[i, j] = idx
                    values[i, j] = val
            out[shard] = HostSparse(indices, values,
                                    st.index_maps[shard].size)
        return out

    @staticmethod
    def _entity_column_values(rows: List[dict], coord: RandomEffectModel,
                              name: str) -> np.ndarray:
        """Per-row entity ids for one random coordinate; a row without an
        id for this effect gets a sentinel no real id can equal, so it
        falls into the fixed-effect-only path."""
        keys = [k for k in (coord.entity_column, name, coord.effect_name)
                if k]
        out = []
        for r in rows:
            ids = r.get("entityIds") or {}
            val = None
            for key in keys:
                if key in ids:
                    val = ids[key]
                    break
            out.append(_NO_ENTITY if val is None else str(val))
        return np.asarray(out)

    # -- introspection -----------------------------------------------------
    def coeff_cache_stats(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"hits": c.hits, "misses": c.misses,
                   "evictions": c.evictions, "size": len(c),
                   "hit_rate": c.hit_rate}
            for name, c in self._state.coeff_caches.items()
        }

    def paged_table_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-coordinate device-residency stats (empty when the paged
        path is off or no coordinate is eligible)."""
        return {name: t.stats() for name, t in self._state.paged.items()}

    @property
    def paged_active(self) -> bool:
        """True when the fused paged hot path serves this model."""
        return self._state.fused_sig is not None


def _max_live_nnz(sp: HostSparse) -> int:
    """Widest row by LIVE (nonzero-value) entries — rows narrower than
    the storage width still fit the pad width."""
    if sp.values is None:
        return sp.indices.shape[1]
    return int((np.asarray(sp.values) != 0).sum(axis=1).max(initial=0))
