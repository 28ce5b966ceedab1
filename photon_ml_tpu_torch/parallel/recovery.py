"""In-job rollback-recovery: coordinated failure becomes coordinated recovery
(counterpart of ``photon_ml_tpu/parallel/recovery.py``).

PR 1 made failure *coordinated*: every process of a multi-controller job
raises :class:`~photon_ml_tpu_torch.parallel.resilience.PeerFailure` together at
the same collective round. This module adds the other half — coordinated
RECOVERY — so a transient fault or a lost rank costs one rolled-back sweep
instead of the whole multi-hour fit (the explicit failure handling that
distributed block-CD solvers assume — arXiv:1611.02101, Snap ML
arXiv:1803.06333 — and that Spark gave the reference for free).

Three layers:

* **Classification** (:func:`classify_failure`): a coordinated abort is
  ``ROLLBACK`` (some rank reported a generic local error — under
  fail-stop, every rank is still alive and can retry together),
  ``RANK_LOSS`` (a watchdog fired: some rank stopped participating and
  will never return), or ``FATAL`` (device loss — the drivers' existing
  resume-marker/exit-75 whole-job restart path — or a deterministic data
  error that would recur on every retry).

* **Commit protocol** (:meth:`RecoveryManager.commit`): each rank writes
  a sweep-stamped shard snapshot through
  :class:`~photon_ml_tpu_torch.parallel.resilience.ResumeManager` (fingerprint
  discipline + durable rename), *then* passes a health barrier, *then*
  advances its local committed pointer and prunes older files. Barrier
  passage is all-or-nothing among live ranks, so every survivor of a
  later failure agrees on the last committed sweep — and because each
  rank's write *precedes* its barrier deposit, every member's file for
  that sweep (including a rank that died later) exists on disk. Each
  snapshot records the membership it was committed under, so a recovery
  knows exactly whose files compose the full table.

* **Recovery** (:meth:`RecoveryManager.on_failure`): ``ROLLBACK`` sleeps
  a jittered backoff, re-aligns on a recovery barrier, and agrees on the
  rollback sweep via a payload gather — this works on ANY transport,
  including the production ``torch.distributed`` world. ``RANK_LOSS``
  additionally needs the transport to *shrink*: survivors rendezvous
  through ``transport.recover`` (only the simulated thread transport
  supports this — the production transport has no ``recover``, as the
  reference's has none, so there the loss escalates to the existing
  whole-job restart), install the shrunk endpoint via
  :func:`~photon_ml_tpu_torch.parallel.resilience.set_transport`, and the
  caller (``game/descent.py``) recomputes the
  :class:`~photon_ml_tpu_torch.parallel.entity_shard.EntityShardSpec` owner map
  over the survivors and redistributes the dead rank's entities from the
  agreed snapshot. Budgets (``max_rank_failures`` / ``max_rollbacks``)
  bound the loop; every decision is a deterministic function of state
  that advances identically on every rank, so ranks never split-brain on
  whether to recover.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import time
from typing import Callable, Dict, List, Optional

from photon_ml_tpu_torch.parallel import fault_injection, resilience

__all__ = [
    "FATAL", "ROLLBACK", "RANK_LOSS", "classify_failure",
    "recovery_supported", "RecoveryPlan", "RecoveryManager",
    "retry_collective",
]

_log = logging.getLogger(__name__)

# failure classes (strings so they read well in logs and BENCH json)
ROLLBACK = "rollback"    # all ranks alive: back off, roll back, retry
RANK_LOSS = "rank_loss"  # some rank is gone: shrink + redistribute
FATAL = "fatal"          # device loss / deterministic data error: abort


def classify_failure(exc: BaseException) -> str:
    """Map a coordinated-abort exception onto its recovery class.

    * :class:`~.resilience.WatchdogTimeout` — a peer stopped
      participating entirely; under fail-stop it will never return:
      ``RANK_LOSS``.
    * Any other :class:`~.resilience.PeerFailure` came through a
      COMPLETED status round, so every rank is alive and aligned:
      ``FATAL`` when the cause was a device loss (the whole job must
      take the resume-marker path) or a data error (deterministic — a
      retry re-reads the same bad input), else ``ROLLBACK``.
    * Anything else is not a coordinated abort: ``FATAL``.
    """
    if isinstance(exc, resilience.WatchdogTimeout):
        return RANK_LOSS
    if isinstance(exc, resilience.PeerFailure):
        if exc.device_loss:
            return FATAL
        if resilience.CODE_DATA in exc.failed.values():
            return FATAL
        return ROLLBACK
    return FATAL


def recovery_supported(transport=None) -> bool:
    """Whether ELASTIC (surviving-set) recovery is available on the
    ambient transport: trivially true single-process (no peer can fail),
    true on transports exposing ``recover`` (the simulated thread
    transport), false on the production ``torch.distributed`` transport,
    which still gets
    ROLLBACK-class in-job retry, but escalates rank loss to the
    whole-job resume path."""
    tp = transport if transport is not None else resilience.current_transport()
    try:
        if tp.process_count() <= 1:
            return True
    except Exception:
        return True
    return hasattr(tp, "recover")


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    """What the caller needs to roll back and resume: the agreed sweep,
    every committed member's snapshot at that sweep, the membership the
    snapshot was committed under (``old_members``, ordered — old shard
    index ``i`` belonged to original rank ``old_members[i]``), and the
    surviving membership (``members``, same ordering rule for the new
    owner map)."""

    sweep: int
    snapshots: Dict[int, dict]
    old_members: List[int]
    members: List[int]
    own_rank: int
    failure_class: str

    @property
    def remapped(self) -> bool:
        return self.members != self.old_members

    @property
    def new_shard_index(self) -> int:
        return self.members.index(self.own_rank)

    @property
    def new_num_shards(self) -> int:
        return len(self.members)


class RecoveryManager:
    """Per-rank recovery state machine for one training run.

    Constructed once per driver invocation (``--max-rank-failures`` > 0
    enables it) and handed to :class:`~photon_ml_tpu_torch.game.descent.
    CoordinateDescent`; the descent loop calls :meth:`commit` at each
    snapshot sweep and :meth:`on_failure` from its ``PeerFailure``
    handler. All counters advance identically on every rank (commit and
    recovery are collective), so budget decisions can never split-brain.

    ``snapshot_every`` trades snapshot cost against replay: a failure
    rolls back to the last committed sweep, re-running at most
    ``snapshot_every`` sweeps. ``max_rank_failures`` bounds cumulative
    lost ranks; ``max_rollbacks`` (default ``2 * max_rank_failures + 2``)
    bounds ROLLBACK-class retries; ``deadline_s`` caps total wall time
    spent backing off across recoveries."""

    def __init__(self, directory: str, fingerprint: Optional[dict] = None,
                 *, max_rank_failures: int = 1, snapshot_every: int = 1,
                 max_rollbacks: Optional[int] = None,
                 backoff_s: float = 0.05, backoff_factor: float = 2.0,
                 jitter: float = 0.1, deadline_s: Optional[float] = None,
                 barrier_timeout: Optional[float] = None,
                 sleep: Callable = time.sleep):
        if max_rank_failures < 0:
            raise ValueError(f"max_rank_failures must be >= 0, got "
                             f"{max_rank_failures}")
        if snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, got "
                             f"{snapshot_every}")
        self.directory = directory
        self.fingerprint = fingerprint
        self.max_rank_failures = int(max_rank_failures)
        self.snapshot_every = int(snapshot_every)
        self.max_rollbacks = (2 * self.max_rank_failures + 2
                              if max_rollbacks is None else int(max_rollbacks))
        self.barrier_timeout = barrier_timeout
        self._sleep = sleep
        self._backoff = resilience.Backoff(
            base_s=backoff_s, factor=backoff_factor, jitter=jitter,
            deadline_s=deadline_s)
        # bound lazily to the transport of the thread that runs the fit
        # (simulated processes construct one manager per thread)
        self._bound = False
        self.rank: Optional[int] = None
        self._members: List[int] = []
        self._last_committed: Optional[int] = None
        self.epoch = 0
        self.rank_failures = 0
        self.rollbacks = 0
        self._recovery_t0: Optional[float] = None
        self.stats: Dict[str, float] = {
            "recoveries": 0, "rank_failures": 0, "rollbacks": 0,
            "snapshots": 0, "snapshot_seconds": 0.0,
            "recovery_seconds": 0.0,
        }

    # -- wiring ----------------------------------------------------------
    def _bind(self, tp) -> None:
        if self._bound:
            return
        self._bound = True
        self.rank = tp.process_index()
        self._members = list(range(tp.process_count()))

    def enabled(self) -> bool:
        """Recovery only has work to do in multi-process runs (a single
        process never sees PeerFailure)."""
        tp = resilience.current_transport()
        return tp.process_count() > 1

    def reset_for_run(self) -> None:
        """Start a fresh fit (a new grid point): stale snapshots from a
        previous run must never be rolled back into. Cumulative budgets
        and stats survive — they bound the whole job, not one fit."""
        self._last_committed = None
        if self.rank is not None:
            self._prune(keep_sweep=None)

    def _path(self, rank: int, sweep: int) -> str:
        return os.path.join(self.directory,
                            f"shard-r{rank}-s{sweep}.snap.npz")

    def _manager(self, rank: int, sweep: int) -> resilience.ResumeManager:
        return resilience.ResumeManager(self._path(rank, sweep),
                                        fingerprint=self.fingerprint,
                                        is_lead=True)

    def _prune(self, keep_sweep: Optional[int]) -> None:
        """Delete this rank's OWN snapshot files other than ``keep_sweep``
        (each rank prunes only its own files, so a dead rank's last
        committed snapshot stays on disk for the survivors to merge)."""
        if not os.path.isdir(self.directory):
            return
        prefix = f"shard-r{self.rank}-s"
        keep = (None if keep_sweep is None
                else os.path.basename(self._path(self.rank, keep_sweep)))
        for name in sorted(os.listdir(self.directory)):
            if name.startswith(prefix) and name != keep:
                try:
                    os.remove(os.path.join(self.directory, name))
                except OSError:
                    pass

    # -- commit protocol -------------------------------------------------
    def commit(self, sweep: int, build_payload: Callable[[], dict],
               *, force: bool = False) -> bool:
        """Commit a sweep-start snapshot: write this rank's file (durable
        rename through ResumeManager), pass the commit barrier, advance
        the committed pointer, prune older own files. ``build_payload``
        is only called when this sweep actually commits (it copies
        arrays). Returns True when a commit happened."""
        tp = resilience.current_transport()
        if tp.process_count() == 1:
            return False
        self._bind(tp)
        if not force and sweep % self.snapshot_every != 0:
            return False
        if not force and self._last_committed == sweep:
            return False
        t0 = time.perf_counter()
        fault_injection.check("recovery.commit")
        record = dict(build_payload())
        record["sweep"] = int(sweep)
        record["members"] = list(self._members)
        os.makedirs(self.directory, exist_ok=True)
        self._manager(self.rank, sweep).save(record)
        resilience.health_barrier(f"recovery.commit:{sweep}",
                                  timeout=self.barrier_timeout)
        self._last_committed = int(sweep)
        self._prune(keep_sweep=sweep)
        self.stats["snapshots"] += 1
        self.stats["snapshot_seconds"] += time.perf_counter() - t0
        if force and self._recovery_t0 is not None:
            # the post-restore commit closes the recovery window
            self.stats["recovery_seconds"] += (time.perf_counter()
                                               - self._recovery_t0)
            self._recovery_t0 = None
        return True

    # -- recovery --------------------------------------------------------
    def on_failure(self, exc: BaseException) -> RecoveryPlan:
        """Decide and run the collective half of recovery. Returns a
        :class:`RecoveryPlan` for the caller to restore from, or
        re-raises ``exc`` when the failure is fatal, budgets are
        exhausted, nothing was ever committed, or the transport cannot
        shrink. Every branch below depends only on state that advances
        identically on every rank."""
        cls = classify_failure(exc)
        tp = resilience.current_transport()
        if cls == FATAL or tp.process_count() == 1:
            raise exc
        self._bind(tp)
        if self._last_committed is None:
            raise exc
        if self._backoff.expired():
            _log.error("recovery: backoff deadline exhausted; escalating")
            raise exc
        self._recovery_t0 = time.perf_counter()
        self.epoch += 1
        if cls == ROLLBACK:
            if self.rollbacks >= self.max_rollbacks:
                _log.error("recovery: rollback budget (%d) exhausted; "
                           "escalating", self.max_rollbacks)
                raise exc
            self.rollbacks += 1
            self.stats["rollbacks"] += 1
            self._sleep(self._backoff.next_delay())
            payloads = self._gather(f"recovery.rollback:{self.epoch}")
            survivors = list(self._members)
        else:  # RANK_LOSS
            recover = getattr(tp, "recover", None)
            if recover is None:
                _log.error(
                    "recovery: transport cannot shrink (the production "
                    "torch.distributed world); escalating rank loss to the "
                    "whole-job resume path")
                raise exc
            if self.rank_failures >= self.max_rank_failures:
                _log.error("recovery: rank-failure budget (%d) exhausted; "
                           "escalating", self.max_rank_failures)
                raise exc
            timeout = (self.barrier_timeout
                       if self.barrier_timeout is not None
                       else resilience.default_timeout())
            self._sleep(self._backoff.next_delay())
            cur_ranks, payloads, new_tp = recover(
                {"rank": self.rank, "committed": self._last_committed},
                timeout)
            # recover() speaks CURRENT-transport ranks; membership is
            # tracked in ORIGINAL ranks across successive shrinks
            survivors = [self._members[i] for i in cur_ranks]
            lost = len(self._members) - len(survivors)
            self.rank_failures += lost
            self.stats["rank_failures"] += lost
            if lost == 0:
                # every "lost" rank turned out alive (a stalled peer hit
                # the watchdog): same membership on a fresh group —
                # account it against the rollback budget instead
                self.rollbacks += 1
                self.stats["rollbacks"] += 1
                if self.rollbacks > self.max_rollbacks:
                    raise exc
            elif self.rank_failures > self.max_rank_failures:
                _log.error(
                    "recovery: lost %d rank(s), cumulative %d > budget %d; "
                    "escalating", lost, self.rank_failures,
                    self.max_rank_failures)
                raise exc
            resilience.set_transport(new_tp)
            self._members = survivors
        agreed = min(int(p["committed"]) for p in payloads)
        own = self._manager(self.rank, agreed).load()
        if own is None:
            raise exc
        old_members = [int(m) for m in own["members"]]
        snapshots = {r: (own if r == self.rank
                         else self._manager(r, agreed).load())
                     for r in old_members}
        self.stats["recoveries"] += 1
        _log.warning(
            "recovery: %s at sweep pointer %d — %d survivor(s) of %s, "
            "rolling back to committed sweep %d",
            cls, self._last_committed, len(survivors), old_members, agreed)
        self._last_committed = agreed
        return RecoveryPlan(sweep=agreed, snapshots=snapshots,
                            old_members=old_members, members=survivors,
                            own_rank=self.rank, failure_class=cls)

    def _gather(self, tag: str) -> List[dict]:
        """Align every (live) member on a recovery barrier and exchange
        committed pointers — works on any transport (the production
        world gathers pickled blobs over gloo)."""
        from photon_ml_tpu_torch.parallel.entity_shard import allgather_blobs

        resilience.health_barrier(tag, timeout=self.barrier_timeout)
        with resilience.collective_site(tag):
            blobs = allgather_blobs(
                pickle.dumps({"rank": self.rank,
                              "committed": self._last_committed}),
                timeout=self.barrier_timeout)
        return [pickle.loads(b) for b in blobs]

    def as_dict(self) -> dict:
        out = dict(self.stats)
        out["last_committed"] = self._last_committed
        out["members"] = list(self._members)
        out["max_rank_failures"] = self.max_rank_failures
        out["snapshot_every"] = self.snapshot_every
        return out


def retry_collective(fn: Callable, *, max_retries: int = 1,
                     backoff_s: float = 0.05, backoff_factor: float = 2.0,
                     jitter: float = 0.1, deadline_s: Optional[float] = None,
                     tag: str = "recovery.retry",
                     sleep: Callable = time.sleep):
    """Collectively-aligned bounded retry of a guarded collective phase
    (the GLM driver wraps each lambda's distributed fit in this): a
    ROLLBACK-class :class:`~.resilience.PeerFailure` sleeps a jittered
    backoff, re-aligns every rank on a health barrier, and re-runs
    ``fn``. Rank loss, device loss, data errors, budget exhaustion and
    single-process runs all propagate unchanged. Every rank takes the
    same branch (the exception and counters are identical everywhere),
    so the retry barrier can never mismatch."""
    backoff = resilience.Backoff(base_s=backoff_s, factor=backoff_factor,
                                 jitter=jitter, deadline_s=deadline_s)
    retries = 0
    while True:
        try:
            return fn()
        except resilience.PeerFailure as e:
            if (classify_failure(e) != ROLLBACK or retries >= max_retries
                    or backoff.expired()):
                raise
            retries += 1
            _log.warning("retry_collective[%s]: transient coordinated "
                         "abort (%s); retry %d/%d", tag, e, retries,
                         max_retries)
            sleep(backoff.next_delay())
            resilience.health_barrier(f"{tag}:{retries}")
