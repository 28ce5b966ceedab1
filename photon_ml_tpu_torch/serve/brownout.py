"""Brownout controller: move the DEFAULT degradation level under load
(counterpart of ``photon_ml_tpu/serve/brownout.py``; host only).

The degradation ladder (session.py) answers a per-request question —
"can this request's remaining budget cover a cold-coefficient fault?".
This module answers the fleet-health one: when the admission queue's
wait EWMA shows SUSTAINED overload, every request should start at a
cheaper ladder level (resident-only, then fixed-effect-only) so the
replica sheds work before it sheds requests — 429 becomes the last
resort, not the first. Snap ML's hierarchical-composition argument
(arXiv:1803.06333) applied to operations: each model level must stay
useful when the level below it is unavailable, and an overloaded store
IS an unavailable level.

Mechanics: the batcher feeds every request's observed queue wait into
:meth:`note_queue_wait`; the controller keeps an EWMA and compares it
against per-level enter thresholds (level 2's above level 1's) with
hysteresis on the way down (``exit_ratio`` of the enter threshold) and
a minimum dwell so the level cannot flap batch-to-batch. The current
level becomes the FLOOR of every new request's :class:`ScoreContext`;
a request may still degrade further on its own budget. Level changes
are exported through ``photon_serve_brownout_level`` — the metrics call
happens AFTER the controller's lock is released (never call foreign code
under your own lock).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["BrownoutController"]


class BrownoutController:
    """Queue-wait-EWMA keyed ladder-level controller.

    ``enter_ms`` maps level -> the EWMA (ms) at which that level engages
    (defaults: level 1 at 50ms, level 2 at 200ms). The level drops back
    only when the EWMA falls below ``exit_ratio`` of the CURRENT level's
    enter threshold AND the level has been held for ``min_dwell_s`` —
    both guards exist because an engaged brownout itself shortens queue
    waits, which without hysteresis immediately argues for disengaging.

    ``time_fn`` is injectable so tests drive the dwell clock without
    sleeping. Thread-safe; every method is safe from the batcher's
    worker thread and from request threads concurrently.
    """

    def __init__(self, enter_ms: Optional[dict] = None,
                 exit_ratio: float = 0.5, alpha: float = 0.1,
                 min_dwell_s: float = 2.0, max_level: int = 2,
                 metrics=None,
                 time_fn: Callable[[], float] = time.monotonic):
        self.enter_ms = dict(enter_ms) if enter_ms else {1: 50.0, 2: 200.0}
        if not (0.0 < exit_ratio < 1.0):
            raise ValueError(f"exit_ratio must be in (0,1), {exit_ratio}")
        self.exit_ratio = float(exit_ratio)
        self.alpha = float(alpha)
        self.min_dwell_s = float(min_dwell_s)
        self.max_level = int(max_level)
        self._metrics = metrics
        self._time = time_fn
        self._lock = threading.Lock()
        self._ewma_ms: Optional[float] = None
        self._level = 0
        self._level_since = self._time()
        self.transitions = 0

    @property
    def level(self) -> int:
        """The current default ladder level (the floor for new requests)."""
        return self._level

    @property
    def queue_wait_ewma_ms(self) -> float:
        with self._lock:
            return self._ewma_ms or 0.0

    def note_queue_wait(self, wait_ms: float) -> int:
        """Fold one request's observed queue wait into the EWMA and
        re-evaluate the level. Returns the (possibly new) level."""
        changed_to: Optional[int] = None
        with self._lock:
            if self._ewma_ms is None:
                self._ewma_ms = float(wait_ms)
            else:
                self._ewma_ms += self.alpha * (wait_ms - self._ewma_ms)
            target = self._target_level_locked()
            if target != self._level:
                now = self._time()
                # escalation is immediate (overload is now); de-escalation
                # waits out the dwell so recovery cannot flap
                if (target > self._level
                        or now - self._level_since >= self.min_dwell_s):
                    self._level = target
                    self._level_since = now
                    self.transitions += 1
                    changed_to = target
            level = self._level
        if changed_to is not None and self._metrics is not None:
            self._metrics.set_brownout_level(changed_to)
        return level

    def _target_level_locked(self) -> int:
        """The level the current EWMA argues for, with hysteresis: to
        ENTER level L the EWMA must exceed enter_ms[L]; to LEAVE the
        current level it must fall below exit_ratio * enter_ms[level]."""
        ewma = self._ewma_ms or 0.0
        target = 0
        for lvl in sorted(self.enter_ms):
            if lvl <= self.max_level and ewma >= self.enter_ms[lvl]:
                target = lvl
        if target < self._level:
            # de-escalate only once clearly below the held level's band
            floor = self.exit_ratio * self.enter_ms.get(
                self._level, float("inf"))
            if ewma >= floor:
                return self._level
        return target
