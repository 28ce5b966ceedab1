"""The port's in-job recovery (``photon_ml_tpu_torch/parallel/recovery.py``
and ``game/descent.py``'s ``recovery=``), mirroring the coordinate-descent
half of ``tests/test_recovery.py`` in simulated processes:

* rank 2 of 4 drop-killed mid-sweep: the three survivors shrink onto a
  3-shard owner map and redistribute its entities from the last committed
  snapshot;
* a transient raise (every rank alive) rolls back to the last committed
  sweep on the same membership;
* 2 ranks, one killed: the lone survivor absorbs the whole table;
* device loss stays fatal on every rank (the drivers' exit-75 path);
* losing more ranks than ``max_rank_failures`` escalates.

Each recovered run is held BIT for bit to the port's uninterrupted run
(coefficients, fixed effect, AUC history). The uninterrupted run is held
to the JAX package's uninterrupted CD on the same numpy dataset within
TOL_JAX_COEF (max |coefficient diff|) and TOL_JAX_AUC, float64, 4 sweeps;
the JAX package's own recovered runs equal its uninterrupted one by its
contract, so no JAX run needs four simulated processes here. The
simulated processes pin torch's intra-op thread count to the caller's
(``testing.run_simulated_processes``), so bit parity tests the recovery,
not the thread pool.
"""

import numpy as np
import pytest

from photon_ml_tpu_torch.parallel import fault_injection as fi
from photon_ml_tpu_torch.parallel.entity_shard import EntityShardSpec
from photon_ml_tpu_torch.parallel.recovery import (
    RecoveryManager, retry_collective,
)
from photon_ml_tpu_torch.parallel.resilience import (
    CODE_DEVICE_LOSS, CODE_ERROR, PeerFailure,
)
from photon_ml_tpu_torch.testing import (
    Dropped, run_simulated_processes, run_supervised_processes,
)
from photon_ml_tpu_torch.utils import is_device_loss
from tests.test_torch_entity_shard import (
    coeff_map, config_kwargs, fixed_w, jax_dataset, make_arrays,
    port_dataset, run_cd,
)

N_SWEEPS = 4
TOL_JAX_COEF = 1e-12
TOL_JAX_AUC = 1e-12


@pytest.fixture(autouse=True)
def _clear_faults(monkeypatch):
    # a dead peer must fail its survivors' barriers quickly
    monkeypatch.setenv("PHOTON_ML_TPU_BARRIER_TIMEOUT_S", "30")
    fi.clear()
    yield
    fi.clear()


@pytest.fixture(scope="module")
def reference_fit():
    """The port's uninterrupted single-host run, which every recovered run
    must reproduce bit for bit, and the JAX package's."""
    import jax.numpy as jnp

    from photon_ml_tpu.game.descent import (
        CoordinateConfig as JaxConfig, CoordinateDescent as JaxCD,
    )

    a_train, a_val = make_arrays(with_val=True)
    ds, val = port_dataset(a_train), port_dataset(a_val)
    model, history = run_cd(ds, val, sweeps=N_SWEEPS, evaluators=["auc"])
    jax_model, jax_history = JaxCD(
        [JaxConfig(**kw) for kw in config_kwargs()], task="logistic",
        n_iterations=N_SWEEPS, dtype=jnp.float64, evaluators=["auc"]).run(
            jax_dataset(a_train), validation=jax_dataset(a_val))
    return dict(ds=ds, val=val, model=model, history=history,
                jax_model=jax_model, jax_history=jax_history)


def assert_bit_parity(model, history, ref):
    want = coeff_map(ref["model"])
    got = coeff_map(model)
    assert set(got) == set(want)
    assert max(float(np.max(np.abs(got[k] - want[k]))) for k in want) == 0.0
    np.testing.assert_array_equal(fixed_w(model), fixed_w(ref["model"]))
    if history is not None:
        assert [r["auc"] for r in history] == [r["auc"]
                                               for r in ref["history"]]


def sharded_fit(ref, rank, n, recovery, with_val=True, sweeps=N_SWEEPS):
    val = ref["val"] if with_val else None
    model, history = run_cd(ref["ds"], val, spec=EntityShardSpec(n, rank),
                            sweeps=sweeps, recovery=recovery,
                            evaluators=["auc"] if with_val else ())
    return model, history, recovery.as_dict()


def manager(tmp_path, max_rank_failures):
    return RecoveryManager(str(tmp_path / "rec"),
                           max_rank_failures=max_rank_failures,
                           backoff_s=0.01, jitter=0.0)


def test_uninterrupted_run_matches_jax(reference_fit):
    got = coeff_map(reference_fit["model"])
    want = coeff_map(reference_fit["jax_model"])
    assert max(float(np.max(np.abs(got[k] - want[k])))
               for k in want) <= TOL_JAX_COEF
    assert float(np.max(np.abs(
        fixed_w(reference_fit["model"])
        - fixed_w(reference_fit["jax_model"])))) <= TOL_JAX_COEF
    pairs = zip(reference_fit["history"], reference_fit["jax_history"])
    assert max(abs(a["auc"] - b["auc"]) for a, b in pairs) <= TOL_JAX_AUC


def test_rank_loss_recovery_bit_parity_4_ranks(reference_fit, tmp_path):
    # cd.step fires once per (sweep, coordinate): occurrence 5 dies in
    # sweep 2's random-effect step, after sweep 2's snapshot committed
    fi.install(fi.crash_schedule((2, "cd.step", 5)))
    outs = run_simulated_processes(
        4, lambda rank: sharded_fit(reference_fit, rank, 4,
                                    manager(tmp_path, 1)), join_timeout=300)
    assert isinstance(outs[2], Dropped)
    for r in (0, 1, 3):
        assert not isinstance(outs[r], (BaseException, Dropped)), (
            f"rank {r}: {outs[r]!r}")
        model, history, stats = outs[r]
        assert_bit_parity(model, history, reference_fit)
        assert stats["recoveries"] == 1
        assert stats["rank_failures"] == 1 and stats["rollbacks"] == 0
        assert stats["members"] == [0, 1, 3]
        assert stats["recovery_seconds"] > 0.0


def test_rollback_recovery_bit_parity(reference_fit, tmp_path):
    fi.install(fi.crash_schedule((1, "entity_shard.exchange", 2),
                                 kind="raise"))
    outs = run_simulated_processes(
        2, lambda rank: sharded_fit(reference_fit, rank, 2,
                                    manager(tmp_path, 0)), join_timeout=300)
    for r, o in enumerate(outs):
        assert not isinstance(o, (BaseException, Dropped)), f"rank {r}: {o!r}"
        model, history, stats = o
        assert_bit_parity(model, history, reference_fit)
        assert stats["rollbacks"] == 1 and stats["rank_failures"] == 0
        assert stats["recoveries"] == 1


def test_recovery_shrinks_to_single_survivor(reference_fit, tmp_path):
    fi.install(fi.crash_schedule((1, "cd.step", 3)))
    outs = run_simulated_processes(
        2, lambda rank: sharded_fit(reference_fit, rank, 2,
                                    manager(tmp_path, 1), with_val=False),
        join_timeout=300)
    assert isinstance(outs[1], Dropped)
    assert not isinstance(outs[0], (BaseException, Dropped)), repr(outs[0])
    model, _history, stats = outs[0]
    assert_bit_parity(model, None, reference_fit)
    assert stats["members"] == [0] and stats["rank_failures"] == 1


def test_device_loss_stays_fatal_coordinated_abort(reference_fit, tmp_path):
    fi.install([fi.Fault(site="cd.step", process=1, at=2,
                         kind="device_loss")])
    outs = run_simulated_processes(
        2, lambda rank: sharded_fit(reference_fit, rank, 2,
                                    manager(tmp_path, 1), with_val=False),
        join_timeout=300)
    assert all(isinstance(o, PeerFailure) for o in outs), outs
    assert outs[0].device_loss and all(is_device_loss(o) for o in outs)


def test_rank_failure_budget_bounds_escalation(reference_fit, tmp_path):
    # rank 2 dies in sweep 1; after the shrink, rank 3's occurrence counter
    # runs on and kills it later: a second loss, over max_rank_failures=1
    fi.install(fi.crash_schedule((2, "cd.step", 3), (3, "cd.step", 9)))
    outs = run_simulated_processes(
        4, lambda rank: sharded_fit(reference_fit, rank, 4,
                                    manager(tmp_path, 1), with_val=False,
                                    sweeps=6), join_timeout=300)
    assert isinstance(outs[2], Dropped) and isinstance(outs[3], Dropped)
    for r in (0, 1):
        assert isinstance(outs[r], PeerFailure), f"rank {r}: {outs[r]!r}"


def test_retry_collective_and_supervised_respawn():
    calls = {}

    def fn(rank):
        def body():
            calls[rank] = calls.get(rank, 0) + 1
            if calls[rank] == 1:
                raise PeerFailure("transient exchange", tag="t",
                                  failed={rank: CODE_ERROR})
            return rank

        return retry_collective(body, max_retries=1, backoff_s=0.01,
                                jitter=0.0, tag="test.retry")

    assert run_simulated_processes(2, fn, join_timeout=60) == [0, 1]
    assert calls == {0: 2, 1: 2}
    fatal = []

    def device_gone():
        fatal.append(1)
        raise PeerFailure("device gone", tag="t",
                          failed={0: CODE_DEVICE_LOSS})

    with pytest.raises(PeerFailure):
        retry_collective(device_gone, max_retries=3, backoff_s=0.0)
    assert len(fatal) == 1  # fatal: no retry, no barrier

    sleeps = []

    def job(rank, attempt):
        if attempt == 0 and rank == 1:
            raise RuntimeError("first attempt dies")
        return attempt

    outs, attempts = run_supervised_processes(
        2, job, max_restarts=2, backoff_s=0.01, jitter=0.0,
        sleep=sleeps.append)
    assert outs == [1, 1] and attempts == 2
    assert sleeps == [pytest.approx(0.01)]


def test_recovery_manager_single_process_is_inert(reference_fit, tmp_path):
    """One process never commits a snapshot, and a recovery-enabled run is
    the plain run bit for bit."""
    rec = manager(tmp_path, 1)
    model, history = run_cd(reference_fit["ds"], reference_fit["val"],
                            sweeps=N_SWEEPS, recovery=rec,
                            evaluators=["auc"])
    assert_bit_parity(model, history, reference_fit)
    assert rec.stats["snapshots"] == 0 and not (tmp_path / "rec").exists()
    with pytest.raises(ValueError):
        RecoveryManager(str(tmp_path), snapshot_every=0)
