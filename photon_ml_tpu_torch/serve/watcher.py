"""Registry-polling watcher: follow ``LATEST`` and hot-swap the session
(a copy of ``photon_ml_tpu/serve/watcher.py``; host only).

The push path is ``POST /admin/reload``; this is the pull path — a
daemon thread that polls the registry's ``LATEST`` pointer and swaps the
resident :class:`~photon_ml_tpu_torch.serve.session.ScoringSession` when it
moves, so a gate promotion on another machine reaches every serving
process without an orchestrator fanning out reload calls.

Concurrent-publish tolerance (the failure mode this must survive): the
registry's atomic-rename discipline means a COMPLETE version appears in
one step, but the watcher can still observe (a) no ``LATEST`` yet —
``read_latest`` already retries ENOENT briefly and then reports None,
(b) a ``.tmp-`` staging dir next to real versions — never listed as a
version, (c) a crashed publisher that landed a version without moving
``LATEST`` — the pointer still names the old live version, so nothing
swaps. Any error opening or swapping to the new version is logged,
counted, and RETRIED on the next tick — the previous model keeps
serving; the watcher never tears down live state on a bad poll.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

from photon_ml_tpu_torch.parallel import fault_injection

__all__ = ["RegistryWatcher"]

_log = logging.getLogger(__name__)


class RegistryWatcher:
    """Poll ``registry.read_latest()`` every ``interval_s`` and swap the
    session when it names a version other than the active one.
    ``on_swap(version)`` / ``on_error(exc)`` are optional observation
    hooks (the serving driver logs through them).

    ``jitter_s`` adds a uniform random extra sleep per tick: in
    multi-replica mode every replica watches the SAME registry, and
    identical intervals would have N processes stat the same files (and
    then all swap) on the same tick — jitter de-synchronizes the
    stampede while keeping every replica within one interval+jitter of a
    promotion (the consistency the front door relies on).

    Consecutive FAILED polls back off exponentially (jittered, capped at
    ``error_backoff_max_s``) instead of hammering a down registry at the
    fixed interval — N replicas polling a struggling shared filesystem
    every tick is exactly the thundering herd that keeps it struggling.
    The first successful poll resets the schedule."""

    def __init__(self, registry, session, interval_s: float = 10.0,
                 on_swap: Optional[Callable[[str], None]] = None,
                 on_error: Optional[Callable[[Exception], None]] = None,
                 jitter_s: float = 0.0,
                 error_backoff_max_s: float = 300.0):
        self.registry = registry
        self.session = session
        self.interval_s = float(interval_s)
        self.jitter_s = max(0.0, float(jitter_s))
        self.on_swap = on_swap
        self.on_error = on_error
        self.errors = 0
        self.checks = 0
        # jittered exponential backoff applied ONLY after failed polls;
        # healthy ticks use interval_s + uniform jitter as before
        from photon_ml_tpu_torch.parallel.resilience import Backoff

        self._error_backoff = Backoff(
            base_s=self.interval_s, factor=2.0,
            max_s=max(float(error_backoff_max_s), self.interval_s),
            jitter=0.1)
        # stop() joins that expired (a poll wedged inside a swap);
        # counted + logged, mirroring producer_join_timeouts
        self.join_timeouts = 0
        # stale-model serving: a failing registry (corrupt LATEST,
        # gate-refused version, unreadable manifest) must pin the live
        # model, not wedge reload — staleness_s is how long the process
        # has been serving without a confirmed-fresh poll, exported as
        # photon_serve_model_staleness_seconds so on-call sees a stuck
        # publish pipeline instead of a silent old model (poll thread
        # writes, metrics/healthz readers — both under _age_lock)
        self._age_lock = threading.Lock()
        self.last_success_at = time.monotonic()
        self._metrics = getattr(session, "metrics", None)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def staleness_s(self) -> float:
        """Seconds since the last SUCCESSFUL poll (0 right after one —
        an up-to-date pointer counts as success even with no swap)."""
        with self._age_lock:
            last = self.last_success_at
        return max(0.0, time.monotonic() - last)

    def check_once(self) -> Optional[str]:
        """One poll: returns the version swapped to, or None (no change,
        no live version yet, or a tolerated transient error)."""
        self.checks += 1
        try:
            fault_injection.check("registry.read")
            latest = self.registry.read_latest()
            if latest is None or latest == self.session.active_version:
                self._note_success()
                return None
            resolved = self.registry.open_version(latest)
            self.session.swap(resolved, version=latest)
        except Exception as e:
            # mid-publish registry states and swap failures are
            # transient by construction: keep serving, retry next tick —
            # the live _ModelState stays pinned and staleness age rises
            self.errors += 1
            if self._metrics is not None:
                self._metrics.set_model_staleness(self.staleness_s)
            if self.on_error is not None:
                self.on_error(e)
            return None
        self._note_success()
        membership = getattr(self.session, "membership", None)
        if membership is not None and membership.epoch > 0:
            # under an entity-affinity epoch the swap prewarmed only
            # this replica's owned slice — worth a line when reading a
            # replica's log against the front door's rebalance spans
            _log.info(
                "RegistryWatcher: swapped to %s under membership epoch "
                "%d (shard %d of %d); prewarmed owned slice only",
                latest, membership.epoch, membership.shard_index,
                membership.num_shards)
        if self.on_swap is not None:
            self.on_swap(latest)
        return latest

    def _note_success(self) -> None:
        with self._age_lock:
            self.last_success_at = time.monotonic()
        if self._metrics is not None:
            self._metrics.set_model_staleness(0.0)

    def _next_delay(self, rng) -> float:
        """Sleep before the next poll: the plain jittered interval while
        healthy, the escalating error backoff while the registry is
        failing (split out so tests can drive the schedule without
        sleeping)."""
        if self._error_backoff.attempts:
            return self._error_backoff.next_delay()
        return self.interval_s + rng.uniform(0.0, self.jitter_s)

    def _observe(self, before_errors: int) -> None:
        if self.errors > before_errors:
            if not self._error_backoff.attempts:
                # enter backoff: the next delay is the SECOND rung (the
                # first failed tick already waited one interval)
                self._error_backoff.next_delay()
        else:
            self._error_backoff.reset()

    def _run(self) -> None:
        import random

        rng = random.Random(os.getpid())
        delay = self.interval_s + rng.uniform(0.0, self.jitter_s)
        while not self._stop.wait(delay):
            before = self.errors
            self.check_once()
            self._observe(before)
            delay = self._next_delay(rng)

    def start(self) -> "RegistryWatcher":
        if self._thread is not None:
            raise RuntimeError("watcher already started")
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="photon-serve-watcher")
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        """Signal the poll loop and join it with a bounded timeout; a
        watcher wedged inside a swap (stuck registry IO, hung compile)
        is counted and logged, never waited on forever."""
        self._stop.set()
        if self._thread is None:
            return
        self._thread.join(timeout_s)
        if self._thread.is_alive():
            self.join_timeouts += 1
            _log.warning(
                "RegistryWatcher: poll thread %r still alive %.1fs "
                "after stop() (wedged swap?); leaking it as a daemon "
                "(join timeouts so far: %d)",
                self._thread.name, timeout_s, self.join_timeouts)
