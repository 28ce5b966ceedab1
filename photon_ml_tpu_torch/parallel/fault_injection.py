"""Deterministic fault injection for the multi-process runtime (counterpart
of ``photon_ml_tpu/parallel/fault_injection.py``: the same sites, kinds and
``PHOTON_ML_TPU_FAULTS`` plan, so a fault plan means the same thing to both
packages).

Every failure path the resilience layer promises to handle must be
EXERCISABLE in tier-1 tests — otherwise the coordinated-abort machinery is
dead code until the first real pod outage. This module plants named
injection sites in the hot paths (stream-source block decode, streamed
pass boundaries, CD steps, multihost init) and lets a test arm a
:class:`FaultPlan` that fires per-process, per-occurrence faults:

* ``kind="raise"`` — a local exception (:class:`InjectedFault`) at the
  site, exactly like a data/compute error in that process;
* ``kind="device_loss"`` — the ``torch.AcceleratorError`` a sticky CUDA
  error raises (``utils.config.cuda_error``, an illegal address), so the
  injected error takes the same path through ``utils.is_device_loss`` as
  a real one: the drivers' resume-marker/exit-75 path without a real
  device fault;
* ``kind="truncate"`` — corrupt the bytes at a decode site
  (:func:`mangle_payload`), driving the REAL truncated-block error path;
* ``kind="drop"`` — simulated fail-stop-silent: raises
  :class:`DroppedProcess` (a ``BaseException``), which the simulated
  runner (``testing.run_simulated_processes``) treats as the process
  going dark — it never reaches another health barrier, so peers must
  surface :class:`~.resilience.WatchdogTimeout` within the watchdog;
* ``kind="delay"`` — a latency fault: the site sleeps ``delay_s``
  before continuing, driving the serving tier's deadline/degrade
  machinery (a slow coefficient store or a wedged backend) without
  raising. Sites on an event loop use :func:`async_check`, which awaits
  the delay instead of blocking the loop.

Determinism: faults address a (site, process, occurrence) triple.
``at=-1`` fires at EVERY occurrence (the chaos-storm form: "100% of
store loads are slow/failing").
Occurrence counters are per-thread (each simulated process counts its own
visits) and reset when a new plan is installed. Real multi-process runs
can arm a plan through the ``PHOTON_ML_TPU_FAULTS`` env var (JSON list of
fault dicts) so spawned worker processes inject without code changes.

Zero overhead when disarmed: every site is a single truthiness check of a
module global.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import List, Optional, Sequence

__all__ = ["Fault", "InjectedFault", "DroppedProcess", "install", "clear",
           "installed", "check", "async_check", "mangle_payload",
           "process_context", "crash_schedule"]


class InjectedFault(RuntimeError):
    """The generic injected local failure."""


class DroppedProcess(BaseException):
    """Simulated silent process death (fail-stop without a report). A
    ``BaseException`` so generic ``except Exception`` recovery — including
    :class:`~.resilience.CollectiveGuard` — cannot convert it into a
    reported failure: the whole point is that this process never reports."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One armed fault: fire at the ``at``-th visit (0-based, per process)
    of ``site`` by process ``process`` (None = every process). ``at=-1``
    fires at every visit. ``delay_s`` is the sleep for ``kind="delay"``."""

    site: str
    kind: str = "raise"  # raise | device_loss | truncate | drop | delay
    process: Optional[int] = None
    at: int = 0
    message: str = "injected fault"
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in ("raise", "device_loss", "truncate", "drop",
                             "delay"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


_lock = threading.Lock()
_plan: List[Fault] = []
_armed = False  # fast-path gate: sites check this single global
_tls = threading.local()


def _counters() -> dict:
    c = getattr(_tls, "counters", None)
    if c is None or getattr(_tls, "generation", -1) != _generation:
        c = {}
        _tls.counters = c
        _tls.generation = _generation
    return c


_generation = 0


def install(faults: Sequence[Fault]) -> None:
    """Arm a plan (replacing any previous one; all occurrence counters
    reset). Tests normally use this through a fixture/finally with
    :func:`clear`."""
    global _plan, _armed, _generation
    with _lock:
        _plan = [f if isinstance(f, Fault) else Fault(**f) for f in faults]
        _generation += 1
        _armed = bool(_plan)


def clear() -> None:
    install(())


def installed() -> List[Fault]:
    return list(_plan)


def _env_plan_loaded() -> None:
    """One-shot: arm from PHOTON_ML_TPU_FAULTS (JSON list of fault dicts)
    so real spawned worker processes can inject."""
    global _env_checked
    if _env_checked:
        return
    _env_checked = True
    raw = os.environ.get("PHOTON_ML_TPU_FAULTS")
    if raw:
        install([Fault(**d) for d in json.loads(raw)])


_env_checked = False


def process_context(index: int):
    """Thread-local process-index override for fault matching — simulated
    processes (threads) and worker threads acting on behalf of a process
    (the stream source's producer) set this; real runs resolve the index
    through the resilience transport."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        prev = getattr(_tls, "process_index", None)
        _tls.process_index = index
        try:
            yield
        finally:
            _tls.process_index = prev

    return cm()


def _current_process() -> int:
    idx = getattr(_tls, "process_index", None)
    if idx is not None:
        return idx
    from photon_ml_tpu_torch.parallel.resilience import current_process_index

    try:
        return current_process_index()
    except Exception:
        return 0


def _match(site: str, kinds: Sequence[str]) -> Optional[Fault]:
    n = _counters().setdefault(site, 0)
    _counters()[site] = n + 1
    proc = _current_process()
    for f in _plan:
        if (f.site == site and f.kind in kinds and (f.at == n or f.at < 0)
                and (f.process is None or f.process == proc)):
            return f
    return None


def _fire(site: str, f: Fault) -> None:
    """Raise the exception a matched control-flow fault calls for (shared
    by the sync and async injection points)."""
    if f.kind == "drop":
        raise DroppedProcess(f"{site}: {f.message}")
    if f.kind == "device_loss":
        from photon_ml_tpu_torch.utils.config import cuda_error

        raise cuda_error("cudaErrorIllegalAddress",
                         "an illegal memory access was encountered",
                         f"{f.message} (injected device loss at {site})")
    raise InjectedFault(f"{site}: {f.message}")


def check(site: str) -> None:
    """Injection point for control-flow faults. No-op unless a plan is
    armed; otherwise fires any (site, process, occurrence)-matching fault.
    A matched ``kind="delay"`` fault sleeps ``delay_s`` and returns —
    callers on an event loop must use :func:`async_check` instead."""
    _env_plan_loaded()
    if not _armed:
        return
    f = _match(site, ("raise", "device_loss", "drop", "delay"))
    if f is None:
        return
    if f.kind == "delay":
        import time

        time.sleep(f.delay_s)
        return
    _fire(site, f)


async def async_check(site: str) -> None:
    """Event-loop-safe injection point: identical matching to
    :func:`check`, but a ``kind="delay"`` fault is awaited via
    ``asyncio.sleep`` so an armed latency fault never blocks the loop
    (the front door's proxy path runs here)."""
    _env_plan_loaded()
    if not _armed:
        return
    f = _match(site, ("raise", "device_loss", "drop", "delay"))
    if f is None:
        return
    if f.kind == "delay":
        import asyncio

        await asyncio.sleep(f.delay_s)
        return
    _fire(site, f)


def crash_schedule(*kills, kind: str = "drop") -> List[Fault]:
    """Build a crash schedule: each ``(rank, site, occurrence)`` triple
    kills process ``rank`` at its ``occurrence``-th visit (0-based) of
    fault site ``site``. ``kind`` selects how it dies: ``"drop"`` (silent
    fail-stop — the recovery harness's shrink path), ``"raise"`` (a
    reported local failure — the rollback path) or ``"device_loss"``
    (the drivers' resume-marker/exit-75 path). Sites include the
    mid-collective ``transport.allgather`` point inside the simulated
    transport itself, so a rank can die INSIDE a rendezvous, not only
    between collectives. Feed the result to :func:`install` (or merge
    with other faults first)::

        fault_injection.install(fault_injection.crash_schedule(
            (2, "cd.step", 5),                   # rank 2, 6th CD step
            (1, "transport.allgather", 3),       # rank 1, mid-collective
        ))
    """
    plan = []
    for rank, site, occurrence in kills:
        plan.append(Fault(site=site, kind=kind, process=int(rank),
                          at=int(occurrence),
                          message=f"scheduled crash of rank {rank}"))
    return plan


def mangle_payload(site: str, payload: bytes) -> bytes:
    """Injection point for data-corruption faults: a matching
    ``kind="truncate"`` fault halves the payload, driving the caller's
    genuine truncated-read error path. Identity unless armed."""
    _env_plan_loaded()
    if not _armed:
        return payload
    f = _match(site, ("truncate",))
    if f is None:
        return payload
    return payload[: len(payload) // 2]
