"""Coordinated failure propagation for the multi-process runtime
(counterpart of ``photon_ml_tpu/parallel/resilience.py``; its jax
transport becomes :class:`TorchTransport`, a status round over the
``torch.distributed`` world's gloo backend).

The reference inherits fault tolerance from Spark (task retry, lineage
recompute — SURVEY/PAPER.md §5.8); a multi-process ``torch.distributed``
job has none of that, and its failure mode is worse than a crash: a
process that raises locally (a bad input block, an OOM, an assertion)
simply stops calling collectives, and every OTHER process blocks inside
its next ``all_reduce``/``all_gather`` until the transport times out —
minutes to forever, with no indication of which peer died or why. The distributed-training
literature treats hierarchical execution as viable only with explicit
failure handling at the communication boundary (Snap ML, arXiv:1803.06333;
distributed CD, arXiv:1611.02101); this module is that boundary.

Fault model: **fail-stop** — a process either follows the SPMD program or
stops participating (crash, hang, injected fault). No Byzantine behavior:
a live process's status report is trusted. Three mechanisms:

1. **Health barrier** (:func:`health_barrier`): a cheap status-code
   allgather run at phase boundaries (feature summarization, CD sweep
   boundaries, streamed-pass boundaries). Every process reports OK or a
   coarse failure class; any non-OK status converts into a
   :class:`PeerFailure` raised on *every* process, so the job dies
   together — loudly, promptly, resumably — instead of deadlocking.
2. **Guarded phases** (:class:`CollectiveGuard` / :func:`guarded`): the
   with-block form — a local exception inside the guard is reported
   through the barrier (then re-raised wrapped, preserving the cause);
   a peer's failure raises :class:`PeerFailure` before this process can
   enter the next collective. The barrier itself runs under a watchdog:
   a peer that stopped responding entirely (fail-stop without a report)
   surfaces as :class:`WatchdogTimeout` within ``timeout`` seconds.
3. **Bounded retry** (:func:`retry_transient`): coordinator/rendezvous
   setup in ``initialize_multihost`` retries transient failures with
   exponential backoff instead of failing a job on one slow peer.

Single-process runs pay nothing: every barrier is a no-op passthrough and
local exceptions propagate unchanged.

The transport is pluggable (thread-local override) so the deterministic
fault-injection harness (``parallel/fault_injection.py`` +
``testing.run_simulated_processes``) can exercise every path above with
simulated processes on one CPU host; production uses the
``torch.distributed`` transport (:class:`TorchTransport`).

This module also hosts the unified :class:`ResumeManager` — the
resume-marker lifecycle (atomic write, kept until success, fingerprinted
against inputs) shared by the CLI drivers' device-loss recovery.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

__all__ = [
    "PeerFailure", "WatchdogTimeout", "ResumeMismatch",
    "health_barrier", "CollectiveGuard", "guarded", "retry_transient",
    "Backoff", "ResumeManager", "current_transport", "use_transport",
    "set_transport", "current_process_index", "default_timeout",
    "TorchTransport", "abandoned_world", "code_for",
    "collective_site", "current_collective_site",
    "CODE_OK", "CODE_ERROR", "CODE_DEVICE_LOSS", "CODE_DATA",
]

# -- status codes ----------------------------------------------------------
# Coarse failure classes exchanged through the barrier (one int32 per
# process). Classes, not messages: the payload must stay O(bytes) so the
# barrier is cheap enough to run at every phase boundary; the failing
# process logs its own full traceback locally.
CODE_OK = 0
CODE_ERROR = 1        # any local exception
CODE_DEVICE_LOSS = 2  # accelerator backend died (utils.is_device_loss)
CODE_DATA = 3         # data/input error (ValueError family)

_CODE_NAMES = {CODE_OK: "ok", CODE_ERROR: "error",
               CODE_DEVICE_LOSS: "device_loss", CODE_DATA: "data_error"}


def code_for(exc: BaseException) -> int:
    """Map a local exception onto its barrier status class."""
    from photon_ml_tpu_torch.utils.config import is_device_loss

    if is_device_loss(exc):
        return CODE_DEVICE_LOSS
    if isinstance(exc, ValueError):
        return CODE_DATA
    return CODE_ERROR


class PeerFailure(RuntimeError):
    """Raised on EVERY process when any process of the multi-controller
    job reports failure at a health barrier (or, for the reporting process
    itself, wraps its local exception as ``__cause__``). ``failed`` maps
    process index -> status code of each non-OK peer."""

    def __init__(self, message: str, *, tag: str = "",
                 failed: Optional[Dict[int, int]] = None):
        super().__init__(message)
        self.tag = tag
        self.failed = dict(failed or {})

    @property
    def device_loss(self) -> bool:
        """True when the coordinated abort was caused by an accelerator
        loss somewhere in the job — every process should take the
        resume-marker exit path, not just the one whose device died."""
        return CODE_DEVICE_LOSS in self.failed.values()


class WatchdogTimeout(PeerFailure):
    """A health barrier did not complete within the watchdog timeout: some
    peer stopped participating entirely (fail-stop without a report)."""


class ResumeMismatch(ValueError):
    """A resume marker's input fingerprint does not match the current run's
    inputs; resuming would silently mix datasets/settings."""


def default_timeout() -> float:
    """Watchdog timeout (seconds) for health barriers; generous by default
    (it only bounds how long peers wait on a DEAD process — live peers
    answer in milliseconds). Override with PHOTON_ML_TPU_BARRIER_TIMEOUT_S."""
    return float(os.environ.get("PHOTON_ML_TPU_BARRIER_TIMEOUT_S", 600.0))


# -- transport -------------------------------------------------------------
class TorchTransport:
    """Production transport: the initialized ``torch.distributed`` world
    (``parallel.multihost.initialize_multihost``), or one process without
    one. The status allgather moves one int32 per process as a CPU tensor
    over gloo (the world's ``cpu:gloo`` half on CUDA, the whole world on
    the CPU), never over NCCL: a status round must not queue behind, or
    wedge, the device's collective stream. It runs in a worker thread so
    the caller can enforce the watchdog timeout even when a dead peer
    would block the collective forever (the thread is abandoned on
    timeout, and the group with it: under fail-stop the whole process
    exits right after, which is the point)."""

    def process_index(self) -> int:
        return dist.get_rank() if _world_up() else 0

    def process_count(self) -> int:
        return dist.get_world_size() if _world_up() else 1

    def allgather_status(self, code: int, timeout: float) -> List[int]:
        return _watchdog(lambda: [int(c) for c in _gather_host(
            torch.tensor([code], dtype=torch.int32))], timeout,
            "health barrier")


def _world_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def _gather_host(t: "torch.Tensor") -> "torch.Tensor":
    """Every process's equal-shaped CPU tensor ``t``, concatenated in rank
    order, over the world's gloo backend."""
    backend = str(dist.get_backend())
    if "gloo" not in backend:
        raise RuntimeError(
            f"the resilience transport gathers host tensors over gloo; the "
            f"world's backend is {backend!r} (initialize_multihost gives "
            "'cpu:gloo,cuda:nccl' on CUDA)")
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts)


def _watchdog(fn: Callable, timeout: float, what: str):
    """Run the collective ``fn`` in a daemon thread joined with
    ``timeout``; raise :class:`WatchdogTimeout` if it does not finish."""
    box: dict = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # surfaced to the caller below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True,
                         name="photon-health-barrier")
    t.start()
    t.join(timeout)
    if t.is_alive():
        global _abandoned
        _abandoned = True
        raise WatchdogTimeout(
            f"{what} timed out after {timeout:.0f}s: a peer "
            "process stopped participating (fail-stop without a "
            "report); aborting so this process does not hang in the "
            "next collective")
    if "error" in box:
        raise box["error"]
    return box["out"]


# True once a watchdog abandoned a collective: the world's groups are then
# out of step and must not be torn down collectively (abandoned_world)
_abandoned = False


def abandoned_world() -> bool:
    """True when a watchdog abandoned a collective in this process: its
    process group can no longer be destroyed cleanly (a teardown would
    wait on the stuck collective), so the caller just exits."""
    return _abandoned


_default_transport = TorchTransport()
_tls = threading.local()


def current_transport():
    return getattr(_tls, "transport", None) or _default_transport


def current_process_index() -> int:
    """Process index through the ambient transport (0 without a
    distributed runtime)."""
    tp = getattr(_tls, "transport", None)
    if tp is not None:
        return tp.process_index()
    return _default_transport.process_index()


def current_collective_site() -> str:
    """The ambient label of the collective being issued on this thread.

    Purely observational: the collective-trace sanitizer
    (``analysis/sanitizers.py``) records it per simulated process so a
    sequence mismatch can name the SITE that diverged, not just a step
    number. Empty when no labeled collective is in flight."""
    return getattr(_tls, "collective_site", "")


@contextlib.contextmanager
def collective_site(tag: str):
    """Thread-locally label the collective(s) issued inside the block
    (the trace hook the barrier and the entity-shard exchange use)."""
    prev = getattr(_tls, "collective_site", "")
    _tls.collective_site = tag
    try:
        yield
    finally:
        _tls.collective_site = prev


@contextlib.contextmanager
def use_transport(transport):
    """Thread-locally override the transport (simulated processes install
    their per-thread endpoint here; production never calls this)."""
    prev = getattr(_tls, "transport", None)
    _tls.transport = transport
    try:
        yield transport
    finally:
        _tls.transport = prev


def set_transport(transport) -> None:
    """Replace this thread's transport IN PLACE — the elastic-recovery
    hook: after a surviving-set rendezvous shrinks the process group,
    the survivor installs its new (remapped-rank) endpoint here so every
    subsequent collective runs over the surviving set. An enclosing
    :func:`use_transport` context still restores its own previous value
    on exit, so the swap never leaks past the simulated process."""
    _tls.transport = transport


# -- health barrier / guarded phases ---------------------------------------
def health_barrier(tag: str, failure: Optional[BaseException] = None,
                   *, timeout: Optional[float] = None) -> None:
    """Exchange health status with every peer before the next collective
    phase. Raises :class:`PeerFailure` on every process when any process
    reports non-OK (the local reporter gets its exception chained as
    ``__cause__``); no-op passthrough in single-process mode (a local
    ``failure`` is re-raised unchanged there)."""
    tp = current_transport()
    if tp.process_count() == 1:
        if failure is not None:
            raise failure
        return
    code = CODE_OK if failure is None else code_for(failure)
    with collective_site(tag):
        codes = tp.allgather_status(code, timeout or default_timeout())
    failed = {i: c for i, c in enumerate(codes) if c != CODE_OK}
    if not failed:
        return
    who = ", ".join(f"process {i} ({_CODE_NAMES.get(c, c)})"
                    for i, c in sorted(failed.items()))
    msg = (f"coordinated abort at '{tag}': {who} failed; every process "
           "raises instead of deadlocking in the next collective")
    if failure is not None:
        raise PeerFailure(msg, tag=tag, failed=failed) from failure
    raise PeerFailure(msg, tag=tag, failed=failed)


class CollectiveGuard:
    """Guard one phase that ends at a collective: convert any process's
    local exception into a :class:`PeerFailure` on every process.

    ::

        with CollectiveGuard("stream.fg"):
            ...local per-process work...
        # all processes healthy here -> safe to enter the collective

    Single-process: zero-cost passthrough (local exceptions propagate
    unchanged). ``PeerFailure`` raised inside the block (a nested guard
    already coordinated) passes through without a second barrier."""

    def __init__(self, tag: str, *, timeout: Optional[float] = None):
        self.tag = tag
        self.timeout = timeout

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        from photon_ml_tpu_torch.parallel.fault_injection import DroppedProcess

        if exc is not None and isinstance(exc, (PeerFailure, DroppedProcess)):
            return False  # already coordinated / simulated silent death
        tp = current_transport()
        if tp.process_count() == 1:
            return False
        health_barrier(self.tag, failure=exc, timeout=self.timeout)
        return False


def guarded(fn: Callable, tag: Optional[str] = None,
            *, timeout: Optional[float] = None) -> Callable:
    """Wrap ``fn`` so every call runs inside a :class:`CollectiveGuard`."""
    import functools

    label = tag or getattr(fn, "__name__", "guarded")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with CollectiveGuard(label, timeout=timeout):
            return fn(*args, **kwargs)

    return wrapper


# -- bounded retry ---------------------------------------------------------
class Backoff:
    """Jittered exponential backoff schedule with an optional total
    deadline — the ONE delay policy shared by :func:`retry_transient`,
    the registry watcher's error backoff, the front door's circuit
    breaker, and the chaos harness's respawn supervision (so every
    retry loop in the tree jitters the same way instead of four fixed
    waits stampeding in sync).

    ``next_delay()`` returns ``base_s * factor^k``, clamped to ``max_s``,
    plus a uniform jitter of up to ``jitter`` (a FRACTION of the delay).
    ``reset()`` restarts the schedule (call it on success).
    ``expired()`` reports whether ``deadline_s`` of wall time has passed
    since construction or the last reset — callers stop retrying then."""

    def __init__(self, base_s: float = 0.5, factor: float = 2.0,
                 max_s: float = 60.0, jitter: float = 0.1,
                 deadline_s: Optional[float] = None,
                 rng=None, clock: Callable = time.monotonic):
        if base_s < 0 or factor < 1.0 or jitter < 0:
            raise ValueError(
                f"need base_s >= 0, factor >= 1, jitter >= 0; got "
                f"base_s={base_s}, factor={factor}, jitter={jitter}")
        import random as _random

        self.base_s = float(base_s)
        self.factor = float(factor)
        self.max_s = float(max_s)
        self.jitter = float(jitter)
        self.deadline_s = deadline_s
        self._rng = rng if rng is not None else _random.Random()
        self._clock = clock
        self.attempts = 0
        self._start = clock()

    def next_delay(self) -> float:
        delay = min(self.base_s * (self.factor ** self.attempts), self.max_s)
        self.attempts += 1
        if self.jitter > 0.0:
            delay += self._rng.uniform(0.0, self.jitter * delay)
        return delay

    def reset(self) -> None:
        self.attempts = 0
        self._start = self._clock()

    def expired(self) -> bool:
        if self.deadline_s is None:
            return False
        return (self._clock() - self._start) >= self.deadline_s

    def remaining(self) -> Optional[float]:
        """Seconds left under the deadline (None when unbounded)."""
        if self.deadline_s is None:
            return None
        return max(0.0, self.deadline_s - (self._clock() - self._start))


def retry_transient(fn: Callable, *, attempts: int = 3,
                    backoff_s: float = 0.5, backoff_factor: float = 2.0,
                    jitter: float = 0.0,
                    deadline_s: Optional[float] = None,
                    retriable=(RuntimeError, ConnectionError, OSError),
                    on_retry: Optional[Callable] = None,
                    sleep: Callable = time.sleep,
                    rng=None, clock: Callable = time.monotonic):
    """Call ``fn`` with bounded retry-with-backoff on transient failures
    (coordinator rendezvous races, slow peers). Non-``retriable``
    exceptions propagate immediately; the last attempt's exception
    propagates unchanged so callers see the real error.

    ``jitter`` adds up to that FRACTION of each delay as uniform random
    extra sleep (multi-process rendezvous retries must not re-collide in
    lockstep); ``deadline_s`` caps TOTAL wall time across attempts — the
    next retry is abandoned (and the last error raised) once the deadline
    passes or the upcoming sleep would overrun it. ``jitter=0`` and
    ``deadline_s=None`` reproduce the original fixed schedule exactly."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    backoff = Backoff(base_s=backoff_s, factor=backoff_factor,
                      max_s=float("inf"), jitter=jitter,
                      deadline_s=deadline_s, rng=rng, clock=clock)
    for attempt in range(attempts):
        try:
            return fn()
        except retriable as e:
            if attempt + 1 >= attempts:
                raise
            delay = backoff.next_delay()
            remaining = backoff.remaining()
            if remaining is not None and delay >= remaining:
                raise  # the deadline would pass mid-sleep: escalate now
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(delay)


# -- unified resume/checkpoint marker lifecycle ----------------------------
class ResumeManager:
    """One resume-marker contract for every driver (subsumes the GAME
    driver's ``RESUME.json`` and the GLM driver's ``RESUME_GLM.npz``):

    * **written atomically and durably** — temp file + fsync +
      ``os.replace`` + parent-dir fsync (``io/durable.py``), so a crash
      mid-write can never leave a half-marker that hijacks a rerun, and
      a power loss after "committed" cannot un-commit it;
    * **kept until success** — the marker is consumed only when the
      protected work COMPLETES (``consume()``), so a second failure of
      any kind (OOM, SIGKILL, another device loss) does not silently
      discard resume state;
    * **fingerprinted against inputs** — ``save`` embeds the constructor's
      fingerprint (e.g. training/validation paths + row counts) and
      ``load`` refuses with :class:`ResumeMismatch` when the rerun's
      inputs differ, so restored state never silently mixes datasets.

    Codec by extension: ``.json`` for string payloads, ``.npz`` (numpy,
    pickled payload dict) when the payload carries arrays. Multi-process:
    construct with ``is_lead=False`` on non-lead processes — their
    ``save``/``consume`` become no-ops (every process may ``load``)."""

    _FP_KEY = "__fingerprint__"

    def __init__(self, path: str, fingerprint: Optional[dict] = None,
                 *, is_lead: bool = True):
        self.path = path
        self.fingerprint = fingerprint
        self.is_lead = bool(is_lead)
        self._npz = path.endswith(".npz")

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def save(self, payload: dict) -> None:
        if not self.is_lead:
            return
        record = dict(payload)
        if self.fingerprint is not None:
            record[self._FP_KEY] = self.fingerprint
        tmp = f"{self.path}.tmp-{os.getpid()}"
        if self._npz:
            import numpy as np

            np.savez(tmp, payload=record)
            # np.savez appends .npz to names without it
            tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
        else:
            with open(tmp, "w") as f:
                json.dump(record, f)
        # durable commit: fsync content + parent dir around the rename — a
        # marker that claims "committed" must survive power loss, not just
        # concurrent readers (io/durable.py)
        from photon_ml_tpu_torch.io.durable import durable_replace

        durable_replace(tmp, self.path)

    def load(self, verify: bool = True) -> Optional[dict]:
        """Marker payload, or None when absent. ``verify=False`` skips the
        fingerprint check (callers that run their own ordering of
        driver-specific checks first call :meth:`verify` afterwards)."""
        if not self.exists():
            return None
        if self._npz:
            import numpy as np

            record = np.load(self.path,
                             allow_pickle=True)["payload"].item()
        else:
            with open(self.path) as f:
                record = json.load(f)
        if verify:
            self.verify(record)
        return record

    def verify(self, record: dict) -> None:
        """Refuse resume when the marker was written against different
        inputs. Markers from before fingerprinting (no embedded
        fingerprint) are accepted."""
        stored = record.get(self._FP_KEY)
        if stored is None or self.fingerprint is None:
            return
        if stored != self.fingerprint:
            diffs = sorted(set(stored) | set(self.fingerprint))
            detail = "; ".join(
                f"{k}: marker={stored.get(k)!r} run={self.fingerprint.get(k)!r}"
                for k in diffs if stored.get(k) != self.fingerprint.get(k))
            raise ResumeMismatch(
                f"{os.path.basename(self.path)} was written for different "
                f"inputs ({detail}); refusing to resume — restored state "
                "would mix datasets. Rerun with the original inputs or "
                f"delete the marker ({self.path})")

    def consume(self) -> None:
        """Remove the marker — call ONLY after the protected work
        completed and its outputs are published."""
        if not self.is_lead:
            return
        with contextlib.suppress(FileNotFoundError):
            os.remove(self.path)
