"""Test scaffolding: synthetic datasets, fixtures and the simulated
multi-process harness (counterpart of ``photon_ml_tpu/testing.py``).

The deterministic synthetic data generators: plain GLM problems,
mixed-effect (GAME) datasets with known fixed/random-effect structure, and
Avro fixture writers for driver-level integration tests, built on the
port's own ``game/descent`` and ``io/data_reader``. Then the simulated
multi-process runtime: N "processes" as N threads, each with its own
resilience transport endpoint, so every coordinated-abort and recovery
path runs the production code against deterministic injected faults
(``parallel/fault_injection.py``) on one CPU host.

Not here: the reference harness's sanitizers (collective-trace,
lock-order, thread-leak and determinism checks, its ``verify_*`` flags,
and the per-rank collective traces they read) are ROADMAP item 20.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticGLM:
    X: np.ndarray  # [n, d] dense
    y: np.ndarray  # [n]
    w_true: np.ndarray  # [d]
    offsets: np.ndarray
    weights: np.ndarray


def synthetic_glm_data(
    n: int = 500,
    d: int = 10,
    task: str = "logistic",
    seed: int = 0,
    density: float = 1.0,
    with_offsets: bool = False,
    with_weights: bool = False,
) -> SyntheticGLM:
    """A well-specified GLM problem with known coefficients."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    if density < 1.0:
        X *= rng.random((n, d)) < density
    w = rng.normal(size=d)
    offsets = rng.normal(size=n) * 0.1 if with_offsets else np.zeros(n)
    weights = rng.uniform(0.5, 2.0, size=n) if with_weights else np.ones(n)
    m = X @ w + offsets
    if task == "logistic" or task == "smoothed_hinge":
        y = (rng.random(n) < 1.0 / (1.0 + np.exp(-m))).astype(float)
    elif task == "poisson":
        y = rng.poisson(np.exp(np.clip(m, None, 5.0))).astype(float)
    else:  # squared / linear
        y = m + rng.normal(size=n) * 0.1
    return SyntheticGLM(X, y, w, offsets, weights)


@dataclasses.dataclass(frozen=True)
class SyntheticGame:
    """Mixed-effect data with known structure: global fixed effect plus one
    coefficient vector per entity per random effect."""

    features: Dict[str, np.ndarray]  # shard -> [n, d_shard]
    labels: np.ndarray
    entity_ids: Dict[str, np.ndarray]  # column -> [n]
    w_fixed: np.ndarray
    random_effects: Dict[str, np.ndarray]  # column -> [n_entities, d_shard]


def synthetic_game_data(
    n_entities: Dict[str, int] = None,
    d_fixed: int = 6,
    d_random: int = 3,
    rows_per_entity: Tuple[int, int] = (15, 45),
    task: str = "logistic",
    seed: int = 0,
) -> SyntheticGame:
    """Generate GAME data: every row belongs to one entity per random-effect
    column; margins sum the fixed effect and each entity's effect (the model
    ``CoordinateDescent`` should recover — SURVEY.md §4.1)."""
    if n_entities is None:
        n_entities = {"userId": 20}
    rng = np.random.default_rng(seed)
    w_fixed = rng.normal(size=d_fixed)
    effects = {
        col: rng.normal(size=(count, d_random)) * 1.5
        for col, count in n_entities.items()
    }
    # rows are grouped by the FIRST entity column; other columns get random
    # entity assignments (crossed random effects)
    first = next(iter(n_entities))
    Xg_parts, Xr_parts, y_parts, ids = [], [], [], {c: [] for c in n_entities}
    for e in range(n_entities[first]):
        m_rows = int(rng.integers(*rows_per_entity))
        xg = rng.normal(size=(m_rows, d_fixed))
        xr = rng.normal(size=(m_rows, d_random))
        margin = xg @ w_fixed + xr @ effects[first][e]
        ids[first].append(np.full(m_rows, e))
        for col in list(n_entities)[1:]:
            assign = rng.integers(0, n_entities[col], size=m_rows)
            ids[col].append(assign)
            margin = margin + np.sum(xr * effects[col][assign], axis=1)
        if task == "logistic":
            y = (rng.random(m_rows) < 1 / (1 + np.exp(-margin))).astype(float)
        else:
            y = margin + rng.normal(size=m_rows) * 0.1
        Xg_parts.append(xg)
        Xr_parts.append(xr)
        y_parts.append(y)
    features = {
        "global": np.concatenate(Xg_parts),
        "entity": np.concatenate(Xr_parts),
    }
    return SyntheticGame(
        features=features,
        labels=np.concatenate(y_parts),
        entity_ids={c: np.concatenate(v) for c, v in ids.items()},
        w_fixed=w_fixed,
        random_effects=effects,
    )


def game_dataset_from_synthetic(data: SyntheticGame, share_features: bool = False):
    """Build a GameDataset (both shards, entity ids) from synthetic data.
    ``share_features=True`` exposes only the 'global' shard (fixed-effect-
    only tests)."""
    from photon_ml_tpu_torch.game.descent import make_game_dataset

    feats = ({"global": data.features["global"]} if share_features
             else dict(data.features))
    return make_game_dataset(feats, labels=data.labels,
                             entity_ids=dict(data.entity_ids))


def write_game_avro_fixture(
    path: str,
    data: SyntheticGame,
    rows: Optional[np.ndarray] = None,
    feature_prefixes: Dict[str, str] = None,
) -> None:
    """Write synthetic GAME rows as TrainingExampleAvro for driver tests.
    Feature names are ``<prefix><j>`` per shard (prefix defaults: 'g' for
    global, 'u' for entity), so shard configs can select by prefix."""
    from photon_ml_tpu_torch.io.data_reader import write_training_examples

    if feature_prefixes is None:
        feature_prefixes = {"global": "g", "entity": "u"}
    if rows is None:
        rows = np.arange(len(data.labels))

    def tuples():
        for i in rows:
            row = []
            for shard, prefix in feature_prefixes.items():
                X = data.features[shard]
                row += [(f"{prefix}{j}", "", float(X[i, j]))
                        for j in range(X.shape[1])]
            yield row

    write_training_examples(
        path, tuples(), data.labels[rows],
        entity_ids={c: v[rows] for c, v in data.entity_ids.items()},
        uids=[str(i) for i in rows],
    )


# -- simulated multi-process runtime ---------------------------------------
# The moral equivalent of local-mode Spark for FAILURE paths: N "processes"
# are N threads sharing one interpreter, each with its own resilience
# transport endpoint, so every coordinated-abort path (health barriers,
# guards, watchdog) runs the production code against deterministic injected
# faults (parallel/fault_injection.py) without real OS processes or a real
# rendezvous. torch itself stays single-process (a mesh= collective is not
# simulated here; entity-shard exchanges and barriers go through the
# resilience transport, which is what makes the harness cheap enough for
# tier-1).

class Dropped:
    """Outcome sentinel: the simulated process died silently (fail-stop
    without a report — fault kind 'drop') or never finished in time."""

    def __repr__(self):  # pragma: no cover - debugging aid
        return "<Dropped>"


class _SimGroup:
    """Shared N-way status-exchange rendezvous (generation-counted so
    consecutive barriers don't mix). A participant that never arrives
    starves the round; waiters raise WatchdogTimeout — the simulated
    equivalent of a dead peer wedging a real allgather. Deaths are
    DECLARED by the runner supervisor when a simulated process's thread
    exits (for any reason), so waiters fail a starved round immediately
    instead of sitting out the full watchdog, and the elastic-recovery
    rendezvous (:meth:`recover`) knows which peers can still arrive."""

    def __init__(self, n: int):
        self.n = n
        self.cond = threading.Condition()
        self.gen = 0
        self.slots: Dict[int, Dict[int, int]] = {}
        self.results: Dict[int, List[int]] = {}
        # ranks whose thread has exited (cleanly, dropped, or crashed);
        # under fail-stop an exited rank can never deposit again
        self.deaths: set = set()
        # elastic recovery state: per-epoch survivor registration and the
        # shrunk child group each completed epoch produced
        self.recovery_epoch = 0
        self.recovery_reg: Dict[int, dict] = {}
        self.recovery_done: Dict[int, tuple] = {}
        # (child_group, {parent_rank: child_rank}) per completed recovery
        # — death declarations cascade into live children
        self.children: List[tuple] = []

    def declare_dead(self, rank: int) -> None:
        """Mark ``rank``'s simulated process as gone (its thread exited).
        Wakes every waiter — a round the dead rank never joined fails
        immediately — and cascades into shrunk child groups so
        post-recovery collectives learn about it too."""
        with self.cond:
            self.deaths.add(rank)
            self.cond.notify_all()
            children = list(self.children)
        for child, rank_map in children:
            if rank in rank_map:
                child.declare_dead(rank_map[rank])

    def exchange(self, rank: int, code: int, timeout: float) -> List[int]:
        from photon_ml_tpu_torch.parallel.resilience import CODE_ERROR, WatchdogTimeout

        deadline = time.monotonic() + timeout
        with self.cond:
            gen = self.gen
            slot = self.slots.setdefault(gen, {})
            slot[rank] = code
            if len(slot) == self.n:
                self.results[gen] = [slot[i] for i in range(self.n)]
                self.gen += 1
                self.cond.notify_all()
                return list(self.results[gen])
            while gen not in self.results:
                # a declared-dead peer that never deposited can never
                # complete this round: fail fast with the same taxonomy
                # the watchdog would use, naming the dead ranks
                dead_missing = sorted(self.deaths - set(slot))
                if dead_missing:
                    raise WatchdogTimeout(
                        f"simulated peer process(es) {dead_missing} died "
                        "before joining this collective round (fail-stop)",
                        failed={r: CODE_ERROR for r in dead_missing})
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    missing = sorted(set(range(self.n)) - set(slot))
                    raise WatchdogTimeout(
                        f"simulated health barrier timed out after "
                        f"{timeout:.1f}s: processes {missing} never "
                        "reported (fail-stop)",
                        failed={r: CODE_ERROR for r in missing})
                self.cond.wait(remaining)
            return list(self.results[gen])

    def recover(self, rank: int, payload, timeout: float):
        """Surviving-set recovery rendezvous: every LIVE rank registers a
        payload; when the registered set covers every not-declared-dead
        rank, a shrunk child :class:`_SimGroup` is created once and every
        survivor returns ``(survivor_ranks, payloads, child_group)`` —
        survivor ranks sorted, payloads in that order, and each
        survivor's child rank is its index in the sorted list. A live
        rank that never registers starves the rendezvous; waiters raise
        WatchdogTimeout (recovery itself is bounded, never a hang)."""
        from photon_ml_tpu_torch.parallel.resilience import CODE_ERROR, WatchdogTimeout

        deadline = time.monotonic() + timeout
        with self.cond:
            epoch = self.recovery_epoch
            reg = self.recovery_reg.setdefault(epoch, {})
            reg[rank] = payload
            self.cond.notify_all()
            while epoch not in self.recovery_done:
                live = set(range(self.n)) - self.deaths
                if set(reg) >= live:
                    survivors = sorted(reg)
                    child = _SimGroup(len(survivors))
                    rank_map = {r: i for i, r in enumerate(survivors)}
                    # a survivor that registered and then died before the
                    # group formed is already gone: seed the child's
                    # deaths so its first round fails fast
                    child.deaths = {rank_map[r] for r in survivors
                                    if r in self.deaths}
                    self.children.append((child, rank_map))
                    self.recovery_done[epoch] = (
                        survivors, [reg[r] for r in survivors], child)
                    self.recovery_epoch = epoch + 1
                    self.cond.notify_all()
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    missing = sorted(live - set(reg))
                    raise WatchdogTimeout(
                        f"recovery rendezvous timed out after "
                        f"{timeout:.1f}s: live processes {missing} never "
                        "joined recovery",
                        failed={r: CODE_ERROR for r in missing})
                self.cond.wait(remaining)
            return self.recovery_done[epoch]


class ThreadTransport:
    """One simulated process's endpoint onto a :class:`_SimGroup`.

    Both allgather legs pass the ``transport.allgather`` fault site on
    the way in — a crash schedule can kill a rank MID-COLLECTIVE (after
    peers committed to the round, before this rank deposits), the
    nastiest point in the fail-stop state space."""

    def __init__(self, group: _SimGroup, rank: int):
        self._group = group
        self._rank = rank

    def process_index(self) -> int:
        return self._rank

    def process_count(self) -> int:
        return self._group.n

    def allgather_status(self, code: int, timeout: float) -> List[int]:
        from photon_ml_tpu_torch.parallel import fault_injection

        fault_injection.check("transport.allgather")
        return self._group.exchange(self._rank, code, timeout)

    def allgather_payload(self, payload, timeout: float) -> list:
        """Generation-counted N-way PAYLOAD exchange (the data leg of the
        simulated transport, used by the entity-shard score exchange):
        returns every process's payload in rank order. It shares the
        status-exchange rendezvous, so payload and status collectives
        stay SPMD-ordered exactly like the real runtime's in-order
        collective stream — and a peer that never arrives surfaces as
        WatchdogTimeout here too."""
        from photon_ml_tpu_torch.parallel import fault_injection

        fault_injection.check("transport.allgather")
        return self._group.exchange(self._rank, payload, timeout)

    def recover(self, payload, timeout: float):
        """Elastic-recovery rendezvous over the surviving set: block until
        every live rank registers, then return ``(survivor_ranks,
        payloads, new_transport)`` where the new transport is this
        process's endpoint onto the SHRUNK group (its rank is its index
        in the sorted survivor list). Only the simulated transport
        supports shrink — the production ``torch.distributed`` transport
        does not resize a running job, which is why
        ``recovery.recovery_supported`` capability-gates on this method."""
        survivors, payloads, child = self._group.recover(
            self._rank, payload, timeout)
        return (survivors, payloads,
                ThreadTransport(child, survivors.index(self._rank)))


def run_simulated_processes(n: int, fn: Callable, *,
                            join_timeout: float = 120.0) -> list:
    """Run ``fn(process_index)`` on ``n`` simulated processes (threads,
    each under its own resilience transport + fault-injection process
    context) and return the per-process OUTCOMES: the return value,
    the raised exception object, or :class:`Dropped` for a process that
    died silently / never finished. Exceptions are captured, not raised —
    fault tests assert on the whole outcome vector.

    Each thread pins torch's intra-op thread count to the caller's, so a
    CPU reduction partitions the same way in every simulated process as
    in the caller (bit parity then tests the algorithm, not the pool)."""
    import torch

    from photon_ml_tpu_torch.parallel import fault_injection, resilience

    group = _SimGroup(n)
    outcomes: list = [Dropped() for _ in range(n)]
    n_threads = torch.get_num_threads()

    def run(rank: int):
        transport = ThreadTransport(group, rank)
        try:
            torch.set_num_threads(n_threads)
            with resilience.use_transport(transport), \
                    fault_injection.process_context(rank):
                outcomes[rank] = fn(rank)
        except fault_injection.DroppedProcess:
            pass  # stays Dropped: this process reports nothing to anyone
        except BaseException as e:
            outcomes[rank] = e
        finally:
            # fail-stop bookkeeping: however this process ended, it will
            # never deposit into another round — peers stuck waiting on
            # it fail their round immediately instead of eating the full
            # watchdog, and the recovery rendezvous stops expecting it
            group.declare_dead(rank)

    threads = [threading.Thread(target=run, args=(i,), daemon=True,
                                name=f"sim-process-{i}")
               for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + join_timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    return outcomes


def run_supervised_processes(n: int, fn: Callable, *,
                             max_restarts: int = 2,
                             backoff_s: float = 0.05,
                             backoff_factor: float = 2.0,
                             jitter: float = 0.1,
                             sleep: Callable = time.sleep,
                             **sim_kwargs) -> Tuple[list, int]:
    """Whole-job respawn-with-backoff supervision over
    :func:`run_simulated_processes` — the simulated equivalent of a pod
    scheduler relaunching a failed multi-controller job. Each attempt
    runs on a FRESH rendezvous group (a production job cannot rejoin a
    single rank into a live SPMD job; restart granularity is the job,
    which is exactly the drivers' resume-marker/exit-75 contract). A
    failed attempt (any exception or Dropped outcome) respawns after a
    jittered exponential backoff, up to ``max_restarts`` restarts.

    ``fn`` may accept ``(rank)`` or ``(rank, attempt)`` — the attempt
    index lets a driver-style body enable ``--auto-resume`` behavior on
    respawns. ``sim_kwargs`` go to :func:`run_simulated_processes`.
    Returns ``(outcomes, attempts)`` where ``outcomes`` is the LAST
    attempt's outcome vector."""
    import inspect

    from photon_ml_tpu_torch.parallel.resilience import Backoff

    try:
        params = inspect.signature(fn).parameters
        wants_attempt = len(params) >= 2
    except (TypeError, ValueError):
        wants_attempt = False
    backoff = Backoff(base_s=backoff_s, factor=backoff_factor,
                      max_s=60.0, jitter=jitter)
    attempts = 0
    while True:
        a = attempts
        call = (lambda rank: fn(rank, a)) if wants_attempt else fn
        outcomes = run_simulated_processes(n, call, **sim_kwargs)
        attempts += 1
        failed = any(isinstance(o, (BaseException, Dropped))
                     for o in outcomes)
        if not failed or attempts > max_restarts:
            return outcomes, attempts
        sleep(backoff.next_delay())
