"""The port's entity-sharded random effects (``photon_ml_tpu_torch/parallel/
entity_shard.py`` and ``game/descent.py``'s ``entity_shard=``), mirroring
``tests/test_entity_shard.py``.

* ``stable_entity_hash`` is bit-equal to the JAX package's on int,
  numpy-int and string ids, so both packages put every entity on the same
  shard; the owned masks partition the ids.
* ``exchange_score_updates``/``allgather_objects`` round-trip in simulated
  processes, and a fault at the exchange becomes a coordinated abort.
* Entity-sharded CD in 2 and 3 simulated processes is held against the
  JAX package's single-host CD on the same numpy dataset (24 users of 4
  rows, dense features, float64, 3 sweeps): coefficients within
  TOL_JAX_COEF max |diff| and each tracked AUC within TOL_JAX_AUC (the two
  packages sum in different orders). It is held against the port's own
  single-host run BIT for bit (coefficients, AUC history), as the
  reference promises for itself; so are a warm-started sharded run and a
  gathered checkpoint. On uneven entity sizes with sparse features the
  shards' padded shapes differ from one rank's, and the sharded run is
  held to one rank's within TOL_UNEVEN (float64 rounding).
* The table budget fails fast and sharding relieves it.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.game.data import build_random_effect_data
from photon_ml_tpu_torch.game.descent import (
    CoordinateConfig, CoordinateDescent, make_game_dataset,
)
from photon_ml_tpu_torch.parallel import fault_injection as fi
from photon_ml_tpu_torch.parallel.entity_shard import (
    EntityShardSpec, EntityTableBudgetError, ShardCommStats,
    allgather_objects, exchange_score_updates, serving_owner_of,
    stable_entity_hash,
)
from photon_ml_tpu_torch.parallel.resilience import PeerFailure
from photon_ml_tpu_torch.testing import Dropped, run_simulated_processes

TOL_JAX_COEF = 1e-12  # port vs JAX package, max |coefficient diff|
TOL_JAX_AUC = 1e-12  # port vs JAX package, each tracked auc
TOL_UNEVEN = 1e-12  # sharded vs one rank on uneven entities, float64
SWEEPS = 3
N_ENTITIES, ROWS_PER_ENTITY, D_G, D_U = 24, 4, 4, 6


def make_arrays(seed=0, n_entities=N_ENTITIES, with_val=False):
    """(train, val) as dicts of numpy arrays: a global shard ``g``, a
    per-user shard ``u``, labels, user ids; equal rows per entity and
    dense features, so every entity's solve has the same shape whatever
    the bucket holds."""
    rng = np.random.default_rng(seed)
    w_fixed = rng.normal(size=D_G)
    U = rng.normal(size=(n_entities, D_U))

    def block(rows_per_entity):
        Xg, Xu, y, uid = [], [], [], []
        for u in range(n_entities):
            xg = rng.normal(size=(rows_per_entity, D_G))
            xu = rng.normal(size=(rows_per_entity, D_U))
            marg = xg @ w_fixed + xu @ U[u]
            y.append((rng.random(rows_per_entity)
                      < 1 / (1 + np.exp(-marg))).astype(float))
            Xg.append(xg)
            Xu.append(xu)
            uid.append(np.full(rows_per_entity, u))
        Xg, Xu, y, uid = map(np.concatenate, (Xg, Xu, y, uid))
        return {"g": Xg, "u": Xu, "y": y, "uid": uid}

    train = block(ROWS_PER_ENTITY)
    return train, (block(3) if with_val else None)


def port_dataset(a):
    return None if a is None else make_game_dataset(
        {"g": a["g"], "u": a["u"]}, a["y"], entity_ids={"userId": a["uid"]})


def jax_dataset(a):
    from photon_ml_tpu.game.descent import make_game_dataset as jax_make

    return None if a is None else jax_make(
        {"g": a["g"], "u": a["u"]}, a["y"], entity_ids={"userId": a["uid"]})


def config_kwargs():
    return [
        dict(name="fixed", feature_shard="g", reg_type="l2", reg_weight=2.0,
             tolerance=1e-10, max_iters=40),
        dict(name="per-user", coordinate_type="random", feature_shard="u",
             entity_column="userId", reg_type="l2", reg_weight=2.0,
             tolerance=1e-9, max_iters=40, num_buckets=2, optimizer="lbfgs",
             active_set=True, refresh_every=3, active_tol=1e-10),
    ]


def configs():
    return [CoordinateConfig(**kw) for kw in config_kwargs()]


def coeff_map(model, d_u=D_U):
    """entity id -> its dense per-user coefficient vector."""
    out = {}
    for b in model.coordinates["per-user"].buckets:
        proj = np.asarray(b.projection)
        C = np.asarray(b.coefficients)
        for r, eid in enumerate(b.entity_ids):
            valid = proj[r] >= 0
            w = np.zeros(d_u)
            w[proj[r][valid]] = C[r][valid]
            out[str(eid)] = w
    return out


def fixed_w(model):
    w = model.coordinates["fixed"].model.coefficients.means
    return w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)


def run_cd(ds, val=None, spec=None, sweeps=SWEEPS, budget=None, warm=None,
           evaluators=(), ckpt=None, recovery=None):
    cd = CoordinateDescent(
        configs(), task="logistic", n_iterations=sweeps,
        dtype=torch.float64, entity_shard=spec, evaluators=list(evaluators),
        entity_table_budget_bytes=budget, recovery=recovery, device="cpu")
    return cd.run(ds, validation=val, warm_start=warm,
                  checkpoint_callback=ckpt)


def assert_all_ok(outcomes):
    for i, o in enumerate(outcomes):
        assert not isinstance(o, (BaseException, Dropped)), (
            f"simulated process {i}: {o!r}")


# -- owner map --------------------------------------------------------------
def test_stable_entity_hash_bit_equal_to_jax():
    from photon_ml_tpu.parallel.entity_shard import (
        serving_owner_of as jax_serving_owner_of,
        stable_entity_hash as jax_hash,
    )

    cases = [np.arange(-50, 300), np.arange(100, dtype=np.uint32),
             np.asarray([0, 2 ** 62, -(2 ** 63)], np.int64),
             np.asarray([f"user-{i}" for i in range(40)] + ["", "é"])]
    for ids in cases:
        np.testing.assert_array_equal(stable_entity_hash(ids), jax_hash(ids))
        for n in (2, 3, 4):
            np.testing.assert_array_equal(
                EntityShardSpec(n, 0).owner_of(ids),
                (jax_hash(ids) % np.uint64(n)).astype(np.int64))
    wire = [7, "7", "user-3", -12, "-12", "x1"]
    for kind in ("auto", "str"):
        np.testing.assert_array_equal(serving_owner_of(wire, 4, kind),
                                      jax_serving_owner_of(wire, 4, kind))
    assert len(set(stable_entity_hash(cases[3]).tolist())) == len(cases[3])


def test_owned_masks_partition_entities():
    ids = np.arange(257)
    masks = [EntityShardSpec(4, i).owned_mask(ids) for i in range(4)]
    np.testing.assert_array_equal(np.sum(masks, axis=0), np.ones(257))
    assert all(m.sum() > 0 for m in masks)
    with pytest.raises(ValueError, match="num_shards"):
        EntityShardSpec(0, 0)
    with pytest.raises(ValueError, match="shard_index"):
        EntityShardSpec(2, 2)
    assert not EntityShardSpec(1, 0).active


def test_sharded_bucket_build_partitions_entities():
    ds = port_dataset(make_arrays()[0])
    args = (ds.features["u"], ds.labels, ds.weights, ds.entity_ids["userId"])
    full = build_random_effect_data(*args)
    shards = [build_random_effect_data(*args,
                                       entity_shard=EntityShardSpec(4, i))
              for i in range(4)]
    got = sorted(str(e) for s in shards for b in s.buckets
                 for e in b.entity_ids)
    assert got == sorted(str(e) for b in full.buckets for e in b.entity_ids)
    for s in shards:
        assert 0 < s.table_bytes() < full.table_bytes()


# -- exchange primitives ----------------------------------------------------
def test_exchange_and_allgather_round_trip():
    rows = np.asarray([3, 5], np.int32)
    stats = ShardCommStats()
    out = exchange_score_updates([rows, np.asarray([1.5, -2.0])], tag="t",
                                 stats=stats)
    np.testing.assert_array_equal(out[0][0], rows)
    assert stats.exchanges == 1 and stats.bytes_sent > 0

    def fn(rank):
        got = exchange_score_updates(
            [np.asarray([rank * 2, rank * 2 + 1], np.int32),
             np.asarray([float(rank), rank + 0.5]),
             np.zeros(0, np.float64)], tag="t")
        objs = allgather_objects({"rank": rank, "arr": np.arange(rank + 1)},
                                 tag="m")
        return ([(g[0].tolist(), g[1].tolist(), g[2].shape) for g in got],
                [(o["rank"], o["arr"].tolist()) for o in objs])

    outs = run_simulated_processes(3, fn)
    assert_all_ok(outs)
    for o in outs:
        assert o == outs[0]
    assert outs[0][0][2] == ([4, 5], [2.0, 2.5], (0,))
    assert outs[0][1] == [(0, [0]), (1, [0, 1]), (2, [0, 1, 2])]


def test_exchange_fault_becomes_coordinated_abort():
    ds = port_dataset(make_arrays()[0])
    fi.install([fi.Fault(site="entity_shard.exchange", process=1, at=0)])
    try:
        outs = run_simulated_processes(
            2, lambda rank: run_cd(ds, spec=EntityShardSpec(2, rank),
                                   sweeps=2))
    finally:
        fi.clear()
    assert all(isinstance(o, PeerFailure) for o in outs), outs


# -- end-to-end parity ------------------------------------------------------
@pytest.fixture(scope="module")
def references():
    """The JAX package's single-host CD and the port's, once per module."""
    import jax.numpy as jnp

    from photon_ml_tpu.game.descent import (
        CoordinateConfig as JaxConfig, CoordinateDescent as JaxCD,
    )

    a_train, a_val = make_arrays(with_val=True)
    jax_model, jax_history = JaxCD(
        [JaxConfig(**kw) for kw in config_kwargs()], task="logistic",
        n_iterations=SWEEPS, dtype=jnp.float64, evaluators=["auc"]).run(
            jax_dataset(a_train), validation=jax_dataset(a_val))
    ds, val = port_dataset(a_train), port_dataset(a_val)
    model, history = run_cd(ds, val, evaluators=["auc"])
    return dict(ds=ds, val=val, model=model, history=history,
                jax_model=jax_model, jax_history=jax_history)


def test_port_single_host_cd_matches_jax(references):
    got, want = coeff_map(references["model"]), coeff_map(
        references["jax_model"])
    assert set(got) == set(want)
    assert max(float(np.max(np.abs(got[k] - want[k])))
               for k in want) <= TOL_JAX_COEF
    assert float(np.max(np.abs(fixed_w(references["model"])
                               - fixed_w(references["jax_model"])))) \
        <= TOL_JAX_COEF
    aucs = [r["auc"] for r in references["history"]]
    jaucs = [r["auc"] for r in references["jax_history"]]
    assert len(aucs) == len(jaucs) == 2 * SWEEPS
    assert max(abs(x - y) for x, y in zip(aucs, jaucs)) <= TOL_JAX_AUC


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_cd_matches_single_host_and_jax(references, n):
    ds, val = references["ds"], references["val"]
    outs = run_simulated_processes(
        n, lambda rank: run_cd(ds, val, spec=EntityShardSpec(n, rank),
                               evaluators=["auc"]), join_timeout=300)
    assert_all_ok(outs)
    ref, jref = coeff_map(references["model"]), coeff_map(
        references["jax_model"])
    ref_aucs = [r["auc"] for r in references["history"]]
    for model, history in outs:
        got = coeff_map(model)
        assert set(got) == set(ref)
        # bit for bit against the port's single host
        assert max(float(np.max(np.abs(got[k] - ref[k]))) for k in ref) == 0
        np.testing.assert_array_equal(fixed_w(model),
                                      fixed_w(references["model"]))
        assert [r["auc"] for r in history] == ref_aucs
        # within the stated tolerance of the JAX package's single host
        assert max(float(np.max(np.abs(got[k] - jref[k])))
                   for k in jref) <= TOL_JAX_COEF
        re_records = [r for r in history if r["coordinate"] == "per-user"]
        assert all("comm_bytes" in r for r in re_records)
        assert sum(r["comm_bytes"] for r in re_records) > 0


def test_sharded_cd_uneven_entities_float64_matches_single_host():
    """Uneven entity sizes and sparse features: each shard's buckets hold
    other entities, so their padded shapes differ from one rank's and the
    sums run over other lengths. In float64 that costs only rounding
    (TOL_UNEVEN); an owner map or an exchange that lost entities would
    miss by the size of a coefficient. ROADMAP Queue 3 holds the float32
    counterpart at chip_smoke's phase 18 shape."""
    rng = np.random.default_rng(3)
    n_users, d_u = 30, 12
    sizes = rng.integers(1, 13, n_users)
    uid = np.repeat(np.arange(n_users), sizes)
    rng.shuffle(uid)
    n = len(uid)
    Xg = rng.normal(size=(n, D_G))
    Xu = (rng.random((n, d_u)) < 0.25) * rng.normal(size=(n, d_u))
    U = rng.normal(size=(n_users, d_u))
    y = (rng.random(n) < 1 / (1 + np.exp(
        -(Xg @ rng.normal(size=D_G) + (Xu * U[uid]).sum(1))))).astype(float)
    ds = make_game_dataset({"g": Xg, "u": Xu}, y, entity_ids={"userId": uid})

    def shapes(spec):
        data = build_random_effect_data(
            ds.features["u"], ds.labels, ds.weights, ds.entity_ids["userId"],
            num_buckets=2, entity_shard=spec)
        return {b.indices.shape[1:] + b.projection.shape[1:]
                for b in data.buckets}

    one = shapes(None)
    assert all(shapes(EntityShardSpec(2, r)) != one for r in range(2))
    model, history = run_cd(ds, ds, evaluators=["auc"])
    outs = run_simulated_processes(
        2, lambda rank: run_cd(ds, ds, spec=EntityShardSpec(2, rank),
                               evaluators=["auc"]), join_timeout=300)
    assert_all_ok(outs)
    ref = coeff_map(model, d_u)
    for got_model, got_history in outs:
        got = coeff_map(got_model, d_u)
        assert set(got) == set(ref) and len(ref) == n_users
        assert max(float(np.max(np.abs(got[k] - ref[k]))) for k in ref) \
            <= TOL_UNEVEN
        assert float(np.max(np.abs(fixed_w(got_model) - fixed_w(model)))) \
            <= TOL_UNEVEN
        assert max(abs(a["auc"] - b["auc"])
                   for a, b in zip(got_history, history)) <= TOL_UNEVEN


def test_sharded_warm_start_and_checkpoints_match_single_host(references):
    ds, val, m_ref = references["ds"], references["val"], references["model"]
    m1, _ = run_cd(ds, val, sweeps=1, warm=m_ref)

    def fn(rank):
        seen = []
        model, _ = run_cd(ds, val, spec=EntityShardSpec(2, rank), sweeps=1,
                          warm=m_ref, ckpt=lambda it, m: seen.append(
                              m.coordinates["per-user"].num_entities))
        return model, seen

    outs = run_simulated_processes(2, fn, join_timeout=300)
    assert_all_ok(outs)
    ref = coeff_map(m1)
    for model, seen in outs:
        got = coeff_map(model)
        assert max(float(np.max(np.abs(got[k] - ref[k]))) for k in ref) == 0
        assert seen == [N_ENTITIES]  # the checkpoint sees the full table


# -- budget enforcement -----------------------------------------------------
def test_entity_table_budget_enforced_and_relieved_by_sharding():
    ds = port_dataset(make_arrays()[0])
    full = build_random_effect_data(
        ds.features["u"], ds.labels, ds.weights, ds.entity_ids["userId"])
    budget = int(full.table_bytes() * 0.45)
    with pytest.raises(EntityTableBudgetError, match="entity-shards"):
        run_cd(ds, sweeps=1, budget=budget)

    def fn(rank):
        model, _ = run_cd(ds, spec=EntityShardSpec(4, rank), sweeps=1,
                          budget=budget)
        return model.coordinates["per-user"].num_entities

    outs = run_simulated_processes(4, fn, join_timeout=300)
    assert_all_ok(outs)
    assert outs == [N_ENTITIES] * 4
