"""The port's GAME coordinate descent, scoring and estimators
(``photon_ml_tpu_torch/game/{descent,scoring,sampling}.py``,
``photon_ml_tpu_torch/estimators.py``) against the JAX package's, at
float64 on the CPU.

The data is ``tests/test_active_set.py``'s: 60 users with a dense fixed
shard ``g`` and a per-user shard ``u``. Each JAX run happens once per
module. Tolerances: coefficients within 1e-6 relative L2 (JAX's fixed
effect sums by scatter on the CPU, the port's through the column-sorted
kernel path's plain version), history metrics within 1e-9, scores within
1e-12 for the same model. Within the port, the active-set run equals the
full-sweep run bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game.descent import (
    CoordinateConfig as JaxConfig, CoordinateDescent as JaxCD,
    make_game_dataset as jax_dataset,
)
from photon_ml_tpu.game.sampling import down_sample as jax_down_sample
from photon_ml_tpu.game.scoring import score_game_model as jax_score
from photon_ml_tpu_torch.estimators import GameEstimator, GameTransformer
from photon_ml_tpu_torch.game.descent import (
    CoordinateConfig, CoordinateDescent, GameDataset, make_game_dataset,
)
from photon_ml_tpu_torch.game.random_effect import train_random_effect
from photon_ml_tpu_torch.game.sampling import down_sample
from photon_ml_tpu_torch.game.scoring import score_game_model
from photon_ml_tpu_torch.interop import (
    game_dataset_from_numpy, game_model_from_numpy,
)
from photon_ml_tpu_torch.parallel.entity_shard import (
    EntityShardSpec, EntityTableBudgetError,
)
from photon_ml_tpu_torch.parallel.recovery import RecoveryManager

TOL = 1e-6
TOL_METRIC = 1e-9
N_USERS = 60


def _synth(seed=0, n_users=N_USERS, d_g=6, d_u=4):
    rng = np.random.default_rng(seed)
    w_fixed = rng.normal(size=d_g)
    U = rng.normal(size=(n_users, d_u))
    Xg, Xu, y, uid = [], [], [], []
    for u in range(n_users):
        m = int(rng.integers(10, 24))
        xg, xu = rng.normal(size=(m, d_g)), rng.normal(size=(m, d_u))
        marg = xg @ w_fixed + xu @ U[u]
        y.append((rng.random(m) < 1 / (1 + np.exp(-marg))).astype(float))
        Xg.append(xg)
        Xu.append(xu)
        uid.append(np.full(m, u))
    Xg, Xu, y, uid = map(np.concatenate, (Xg, Xu, y, uid))
    return jax_dataset({"g": Xg, "u": Xu}, y, entity_ids={"userId": uid})


@pytest.fixture(scope="module")
def data():
    train, val = _synth(0), _synth(1)
    return dict(jax=(train, val), port=(game_dataset_from_numpy(train),
                                        game_dataset_from_numpy(val)))


def _configs(Config, mixed=True, active_set=True, fixed_kw=None, **re_kw):
    fixed = dict(feature_shard="g", reg_type="l2", reg_weight=2.0,
                 tolerance=1e-12)
    fixed.update(fixed_kw or {})
    re = dict(coordinate_type="random", feature_shard="u",
              entity_column="userId", reg_type="l2", reg_weight=2.0,
              active_set=active_set, tolerance=1e-11, optimizer="newton",
              refresh_every=5, active_tol=1e-10)
    re.update(re_kw)
    out = [Config("fixed", **fixed)]
    if mixed:
        out.append(Config("per-user", **re))
    return out


def _port_cd(configs, n_it, **kw):
    return CoordinateDescent(configs, task="logistic", n_iterations=n_it,
                             dtype=torch.float64, device="cpu", **kw)


_RUNS = {}


def _runs(data, name):
    """(JAX (model, history), port (model, history)) for one scenario."""
    if name not in _RUNS:
        # the random-effect solves stop at 1e-6: Newton's quadratic steps
        # reach the rounding floor within an iteration of tighter
        # tolerances, where the two packages' convergence flags may split
        # on noise
        kw, n_it, evals = {
            "fixed": (dict(mixed=False), 3, ["auc"]),
            "mixed": (dict(tolerance=1e-6), 4, ["auc", "logistic_loss"]),
            "owlqn": (dict(optimizer="lbfgs", reg_type="elastic_net",
                           elastic_net_alpha=0.5), 2, ["auc"]),
            "tron": (dict(optimizer="tron", tolerance=1e-8), 3, ["auc"]),
            "streaming": (dict(tolerance=1e-6, fixed_kw=dict(
                streaming=True, chunk_rows=256, max_iters=15,
                tolerance=0.0)), 2, ["auc"]),
        }[name]
        (jt, jv), (pt, pv) = data["jax"], data["port"]
        j = JaxCD(_configs(JaxConfig, **kw), task="logistic",
                  n_iterations=n_it, dtype=jnp.float64,
                  evaluators=evals).run(jt, jv)
        p = _port_cd(_configs(CoordinateConfig, **kw), n_it,
                     evaluators=evals).run(pt, pv)
        _RUNS[name] = (j, p)
    return _RUNS[name]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _fixed_w(model):
    return np.asarray(model.coordinates["fixed"].model.coefficients.means)


@pytest.mark.parametrize("name", ["fixed", "mixed", "owlqn", "tron",
                                  "streaming"])
def test_coordinate_descent_matches_jax(data, name):
    (jm, jh), (pm, ph) = _runs(data, name)
    assert _rel(_fixed_w(pm), _fixed_w(jm)) <= TOL
    if "per-user" in jm.coordinates:
        for bj, bp in zip(jm.coordinates["per-user"].buckets,
                          pm.coordinates["per-user"].buckets):
            assert list(bp.entity_ids) == list(bj.entity_ids)
            np.testing.assert_array_equal(bp.projection, bj.projection)
            assert _rel(bp.coefficients, bj.coefficients) <= TOL
    assert len(ph) == len(jh)
    for rj, rp in zip(jh, ph):
        assert (rp["iteration"], rp["coordinate"]) == \
            (rj["iteration"], rj["coordinate"])
        for key in ("auc", "logistic_loss", "converged_fraction",
                    "entities_solved", "loss"):
            if key in rj:
                assert rp[key] == pytest.approx(rj[key], rel=TOL_METRIC,
                                                abs=TOL_METRIC), key
        assert set(rj) - set(rp) <= {"solve_seconds"} and \
            set(rp) - set(rj) == set()
        if "stream" in rj:
            assert rp["stream"]["kernel_passes"] >= 1
    assert ph[-1]["stop_reason"] == jh[-1]["stop_reason"]


@pytest.mark.parametrize("optimizer", ["newton", "lbfgs"])
def test_active_set_matches_full_sweeps_bit_for_bit(data, optimizer):
    """Active-set CD (freezing, incremental rescoring, drift
    re-activation) gives the full-sweep model bit for bit while the
    frontier shrinks."""
    train = data["port"][0]
    m_act, h_act = _port_cd(_configs(CoordinateConfig, optimizer=optimizer),
                            14).run(train)
    m_full, h_full = _port_cd(_configs(CoordinateConfig, active_set=False,
                                       optimizer=optimizer), 14).run(train)
    assert np.array_equal(_fixed_w(m_act), _fixed_w(m_full))
    for ba, bf in zip(m_act.coordinates["per-user"].buckets,
                      m_full.coordinates["per-user"].buckets):
        np.testing.assert_array_equal(ba.coefficients, bf.coefficients)
    solved = [r["entities_solved"] for r in h_act
              if r["coordinate"] == "per-user"]
    assert solved[0] == N_USERS and min(solved) < N_USERS
    assert all(r["entities_solved"] == N_USERS for r in h_full
               if r["coordinate"] == "per-user")


def test_partial_frontier_matches_full_sweeps_bit_for_bit(data):
    """A loose drift tolerance leaves part of the users active in some
    sweeps (padded sub-buckets); the result still equals full sweeps
    whose solves of the frozen users are no-ops."""
    train = data["port"][0]
    kw = dict(fixed_kw={"max_iters": 2}, active_tol=3e-2, refresh_every=3,
              optimizer="lbfgs")
    snaps = {}
    m, h = _port_cd(_configs(CoordinateConfig, **kw), 8).run(
        train, checkpoint_callback=lambda it, model: snaps.update(
            {it: [np.array(b.coefficients) for b in
                  model.coordinates["per-user"].buckets]}))
    solved = [r["entities_solved"] for r in h if r["coordinate"] == "per-user"]
    assert any(0 < s < N_USERS for s in solved) or 0 in solved
    frozen = [r["iteration"] for r in h
              if r["coordinate"] == "per-user" and r["entities_solved"] == 0]
    for s in frozen:  # a fully frozen sweep carries every coefficient
        for a, b in zip(snaps[s - 1], snaps[s]):
            np.testing.assert_array_equal(a, b)


def test_warm_start_and_locked(data):
    """Both packages warm-started from JAX's model with the fixed effect
    locked: the locked coefficients carry over exactly, the random effect
    and the metrics match."""
    (jm, _), _ = _runs(data, "mixed")
    (jt, jv), (train, val) = data["jax"], data["port"]
    kw = dict(tolerance=1e-6)
    jm2, jh2 = JaxCD(_configs(JaxConfig, **kw), task="logistic",
                     n_iterations=2, dtype=jnp.float64,
                     evaluators=["auc"]).run(jt, jv, warm_start=jm,
                                             locked=["fixed"])
    m, h = _port_cd(_configs(CoordinateConfig, **kw), 2,
                    evaluators=["auc"]).run(
        train, val, warm_start=game_model_from_numpy(jm, device="cpu"),
        locked=["fixed"])
    np.testing.assert_array_equal(_fixed_w(m), _fixed_w(jm))
    assert all(r["coordinate"] != "fixed" or "loss" not in r for r in h)
    for bj, bm in zip(jm2.coordinates["per-user"].buckets,
                      m.coordinates["per-user"].buckets):
        assert _rel(bm.coefficients, bj.coefficients) <= TOL
    assert h[-1]["auc"] == pytest.approx(jh2[-1]["auc"], abs=TOL_METRIC)
    with pytest.raises(ValueError, match="need a warm_start"):
        _port_cd(_configs(CoordinateConfig), 1).run(train, locked=["fixed"])
    with pytest.raises(ValueError, match="not in configs"):
        _port_cd(_configs(CoordinateConfig), 1).run(train, locked=["x"])


@pytest.mark.parametrize("task", ["logistic", "squared"])
def test_down_sample_matches_jax(task):
    r = np.random.default_rng(2)
    labels = (r.random(500) < 0.3).astype(float)
    weights = r.random(500) + 0.5
    for rate in (0.3, 1.0):
        rows, w = down_sample(labels, weights, rate, task=task, seed=4)
        rows_j, w_j = jax_down_sample(labels, weights, rate, task=task,
                                      seed=4)
        np.testing.assert_array_equal(rows, rows_j)
        np.testing.assert_array_equal(w, w_j)
    with pytest.raises(ValueError, match="rate must be > 0"):
        down_sample(labels, weights, 0.0)


def test_down_sampled_fixed_effect_matches_jax(data):
    (jt, _), (pt, _) = data["jax"], data["port"]
    kw = dict(mixed=False, fixed_kw={"down_sampling_rate": 0.5})
    jm, _ = JaxCD(_configs(JaxConfig, **kw), task="logistic",
                  n_iterations=1, dtype=jnp.float64).run(jt)
    pm, _ = _port_cd(_configs(CoordinateConfig, **kw), 1).run(pt)
    assert _rel(_fixed_w(pm), _fixed_w(jm)) <= TOL


def test_game_estimator_grid_and_transformer(data):
    """GameEstimator over a two-point grid with one shared dataset cache:
    each point equals its own CoordinateDescent run, select_best picks the
    best AUC, and GameTransformer scores the validation rows as CD's final
    metrics saw them."""
    train, val = data["port"]
    grid = [_configs(CoordinateConfig),
            _configs(CoordinateConfig, reg_weight=8.0)]
    cache = {}
    est = GameEstimator(n_iterations=2, evaluators=["auc"], device="cpu",
                        dtype=torch.float64)
    calls = []
    results = est.fit(train, val, grid, dataset_cache=cache,
                      fit_callback=lambda gi, r: calls.append(gi),
                      checkpoint_callback=lambda gi, it, m: calls.append(
                          (gi, it)))
    assert calls == [(0, 0), (0, 1), 0, (1, 0), (1, 1), 1]
    assert sum(1 for k in cache if k[0] == "re_data") == 1
    for configs, res in zip(grid, results):
        model, hist = _port_cd(configs, 2, evaluators=["auc"]).run(train,
                                                                   val)
        np.testing.assert_array_equal(_fixed_w(res.model), _fixed_w(model))
        assert res.evaluation.primary_value == hist[-1]["auc"]
        tr = GameTransformer(res.model, dtype=torch.float64, device="cpu")
        assert tr.evaluate(val, ["auc"])["auc"] == pytest.approx(
            hist[-1]["auc"], abs=1e-12)
        probs = tr.predict_mean(val)
        assert probs.shape == (val.num_samples,)
        assert ((probs > 0) & (probs < 1)).all()
    best = est.select_best(results)
    assert best.evaluation.primary_value == max(
        r.evaluation.primary_value for r in results)
    with pytest.raises(ValueError, match="at least one"):
        est.fit(train, val, [])


def test_score_game_model_matches_jax(data):
    (jm, _), _ = _runs(data, "mixed")
    jv = data["jax"][1]
    pv = data["port"][1]
    port_model = game_model_from_numpy(jm, device="cpu")
    total_j, parts_j = jax_score(jm, jv.features, jv.entity_ids,
                                 offsets=jv.offsets, dtype=jnp.float64,
                                 per_coordinate=True)
    total_p, parts_p = score_game_model(
        port_model, pv.features, pv.entity_ids, offsets=pv.offsets,
        dtype=torch.float64, per_coordinate=True, device="cpu")
    assert np.max(np.abs(total_p.numpy() - np.asarray(total_j))) <= 1e-12
    for name in parts_j:
        assert np.max(np.abs(parts_p[name].numpy()
                             - np.asarray(parts_j[name]))) <= 1e-12
    with pytest.raises(ValueError, match="needs entity ids"):
        score_game_model(port_model, pv.features, {}, device="cpu")


def _mixed_port_cd(**kw):
    """The "mixed" scenario's port run with extra CoordinateDescent
    options."""
    return _port_cd(_configs(CoordinateConfig, tolerance=1e-6), 4,
                    evaluators=["auc", "logistic_loss"], **kw)


def _assert_same_run(got, want):
    (m, h), (m_ref, h_ref) = got, want
    np.testing.assert_array_equal(_fixed_w(m), _fixed_w(m_ref))
    for b, b_ref in zip(m.coordinates["per-user"].buckets,
                        m_ref.coordinates["per-user"].buckets):
        np.testing.assert_array_equal(np.asarray(b.coefficients),
                                      np.asarray(b_ref.coefficients))
    assert [r["auc"] for r in h] == [r["auc"] for r in h_ref]


def test_entity_shard_of_one_is_the_single_host_run(data):
    """A one-shard owner map is the single-host layout: no exchange, the
    same run bit for bit (the sharded runs are in
    test_torch_entity_shard.py)."""
    pt, pv = data["port"]
    _assert_same_run(
        _mixed_port_cd(entity_shard=EntityShardSpec(1, 0)).run(pt, pv),
        _runs(data, "mixed")[1])


def test_entity_table_budget_fails_before_the_first_sweep(data):
    pt, pv = data["port"]
    calls = []
    with pytest.raises(EntityTableBudgetError, match="per-user"):
        _mixed_port_cd(entity_table_budget_bytes=1).run(
            pt, pv, checkpoint_callback=lambda it, m: calls.append(it))
    assert calls == []
    _assert_same_run(
        _mixed_port_cd(entity_table_budget_bytes=1 << 30).run(pt, pv),
        _runs(data, "mixed")[1])


def test_recovery_on_one_process_is_the_plain_run(data, tmp_path):
    """One process never sees a PeerFailure: a recovery-enabled run
    commits no snapshot and is the plain run bit for bit (the recovered
    runs are in test_torch_recovery.py)."""
    pt, pv = data["port"]
    rec = RecoveryManager(str(tmp_path / "rec"), max_rank_failures=1)
    _assert_same_run(_mixed_port_cd(recovery=rec).run(pt, pv),
                     _runs(data, "mixed")[1])
    assert rec.stats["snapshots"] == 0 and rec.stats["recoveries"] == 0


def test_game_estimator_passes_sharding_and_recovery_through(data,
                                                             tmp_path):
    pt, pv = data["port"]
    rec = RecoveryManager(str(tmp_path / "rec"), max_rank_failures=1)
    est = GameEstimator(task="logistic", n_iterations=4, device="cpu",
                        evaluators=["auc", "logistic_loss"],
                        dtype=torch.float64,
                        entity_shard=EntityShardSpec(1, 0),
                        entity_table_budget_bytes=1 << 30, recovery=rec)
    res = est.fit(pt, pv, [_configs(CoordinateConfig, tolerance=1e-6)])[0]
    _assert_same_run((res.model, res.history), _runs(data, "mixed")[1])
    with pytest.raises(EntityTableBudgetError):
        GameEstimator(device="cpu", dtype=torch.float64,
                      entity_table_budget_bytes=1).fit(
            pt, None, [_configs(CoordinateConfig)])


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CoordinateDescent([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GameEstimator()


def test_game_dataset_from_numpy(data):
    jt, pt = data["jax"][0], data["port"][0]
    assert isinstance(pt, GameDataset)
    for name in jt.features:
        np.testing.assert_array_equal(pt.features[name].indices,
                                      jt.features[name].indices)
        np.testing.assert_array_equal(pt.features[name].values,
                                      jt.features[name].values)
    np.testing.assert_array_equal(pt.labels, jt.labels)
    np.testing.assert_array_equal(pt.entity_ids["userId"],
                                  jt.entity_ids["userId"])
    assert make_game_dataset(pt.features["g"], pt.labels).features.keys() \
        == {"global"}


def test_streamed_fixed_coordinate_options(data, tmp_path):
    """The streamed fixed coordinate's checks, and a disk-backed shard
    (``feature_sources``) trained through the scalar overlay: the same
    model as the in-RAM streamed run, bit for bit."""
    from photon_ml_tpu_torch.io.data_reader import write_training_examples
    from photon_ml_tpu_torch.io.index_map import IndexMap
    from photon_ml_tpu_torch.io.stream_source import AvroChunkSource

    with pytest.raises(ValueError, match="fixed effects"):
        CoordinateConfig("r", coordinate_type="random", entity_column="u",
                         streaming=True)
    with pytest.raises(ValueError, match="compute_variance='full'"):
        CoordinateConfig("f", streaming=True, compute_variance="full")
    train = data["port"][0]
    g = train.features["g"]
    path = str(tmp_path / "g.avro")
    write_training_examples(
        path, ([(f"g{j}", "", float(v)) for j, v in zip(row_i, row_v)]
               for row_i, row_v in zip(g.indices, g.values)),
        train.labels, weights=train.weights, block_size=64)
    imap = IndexMap({f"g{j}": j for j in range(g.dim)})
    source = AvroChunkSource(path, imap, chunk_rows=256, dtype=np.float64)
    ooc = GameDataset({"u": train.features["u"]}, train.labels,
                      train.weights, train.offsets, train.entity_ids,
                      feature_sources={"g": source})
    kw = dict(tolerance=1e-6, fixed_kw=dict(
        streaming=True, chunk_rows=256, max_iters=5, tolerance=0.0,
        compute_variance=True))
    with pytest.raises(ValueError, match="set streaming=True"):
        _port_cd(_configs(CoordinateConfig, fixed_kw=dict(max_iters=1)),
                 1).run(ooc)
    m_ooc, h_ooc = _port_cd(_configs(CoordinateConfig, **kw), 2).run(ooc)
    m_ram, _ = _port_cd(_configs(CoordinateConfig, **kw), 2).run(train)
    assert np.array_equal(_fixed_w(m_ooc), _fixed_w(m_ram))
    var = [m.coordinates["fixed"].model.coefficients.variances
           for m in (m_ooc, m_ram)]
    assert var[0] is not None and torch.equal(var[0], var[1])
    assert h_ooc[0]["stream"]["kernel_passes"] >= 6
