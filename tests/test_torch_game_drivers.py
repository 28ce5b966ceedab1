"""The port's GAME drivers (``photon_ml_tpu_torch/cli/{feature_indexing_
driver,game_training_driver,game_scoring_driver}.py``) against the JAX
package's on the same Avro fixture, each run once per module in both
packages with ``--dtype float64`` on the CPU.

The fixture is ``tests/test_drivers.py::game_fixture``'s shape: about 600
training rows of 20 users, a global shard ``g*`` and a per-user shard
``u*``; the per-user coordinate keeps its 20 users in one size bucket, so
the JAX driver compiles one bucket shape, not four (the port's multi-bucket
path is held against JAX's in ``test_torch_random_effect.py`` and
``test_torch_game.py``). Scenarios of the training driver:

* ``base``: one grid point, 2 sweeps, one Bayesian tuning round, all
  models saved, a checkpoint per sweep;
* ``warm_locked_normalized``: warm start from ``base``'s best model with
  the fixed coordinate locked, standardization, the feature summary, the
  exact (non-active-set) sweeps and a solver tolerance schedule;
* ``streaming_out_of_core``: the fixed coordinate streamed in chunks of
  128 rows from its shard decoded off disk every pass, through the
  decode-once chunk cache (``--streaming --out-of-core-shards global
  --chunk-cache-dir``), 2 sweeps; its best model scored out of core
  (``--out-of-core``) by each package's scoring driver.

Tolerances: index maps equal; every saved model's coefficients within 1e-6
relative L2 (the two packages sum in different orders); every logged
validation metric within 1e-9; the scoring drivers' scores of the same
saved model within 1e-9 and their metrics within 1e-9; each package's
scores of its own model within 1e-6 of the other's. The sharding and
recovery flags on one process leave the model as it was bit for bit, and
the default ``--device`` raises without CUDA."""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import (
    feature_indexing_driver as jax_index, game_scoring_driver as jax_score,
    game_training_driver as jax_train,
)
from photon_ml_tpu_torch.cli import (
    feature_indexing_driver, game_scoring_driver, game_training_driver,
)
from photon_ml_tpu_torch.io.avro import iter_avro_records
from photon_ml_tpu_torch.io.data_reader import write_training_examples
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.io.paldb import load_index_map

TOL_W = 1e-6
TOL_METRIC = 1e-9
TOL_SCORE = 1e-9
PKGS = {"jax": (jax_index, jax_train, jax_score, []),
        "port": (feature_indexing_driver, game_training_driver,
                 game_scoring_driver, ["--device", "cpu"])}
SCENARIOS = {
    "base": lambda root, pkg: [
        "--n-iterations", "2", "--tuning-mode", "bayesian",
        "--tuning-iters", "1", "--save-all-models", "--checkpoint"],
    "warm_locked_normalized": lambda root, pkg: [
        "--n-iterations", "2",
        "--warm-start-model", str(root / f"base-{pkg}" / "best"),
        "--locked-coordinates", "fixed", "--normalization",
        "standardization", "--summarize-features", "--no-re-active-set",
        "--solver-tol-schedule", "1e-3:0.1"],
    "streaming_out_of_core": lambda root, pkg: [
        "--n-iterations", "2", "--streaming", "--chunk-rows", "128",
        "--out-of-core-shards", "global",
        "--chunk-cache-dir", str(root / f"chunk-cache-{pkg}")],
}


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("game_drivers")
    rng = np.random.default_rng(0)
    n_users, d_g, d_u = 20, 6, 3
    w_fixed = rng.normal(size=d_g)
    U = rng.normal(size=(n_users, d_u)) * 1.5
    Xg, Xu, y, uid = [], [], [], []
    for u in range(n_users):
        m = int(rng.integers(15, 45))
        xg, xu = rng.normal(size=(m, d_g)), rng.normal(size=(m, d_u))
        marg = xg @ w_fixed + xu @ U[u]
        y.append((rng.random(m) < 1 / (1 + np.exp(-marg))).astype(float))
        Xg.append(xg)
        Xu.append(xu)
        uid.append(np.full(m, u))
    Xg, Xu, y, uid = map(np.concatenate, (Xg, Xu, y, uid))
    perm = rng.permutation(len(y))
    cut = int(len(y) * 0.8)

    def write(path, rows):
        def tuples():
            for i in rows:
                yield ([(f"g{j}", "", float(Xg[i, j])) for j in range(d_g)]
                       + [(f"u{j}", "", float(Xu[i, j])) for j in range(d_u)])

        write_training_examples(str(path), tuples(), y[rows],
                                entity_ids={"userId": uid[rows]},
                                uids=[str(i) for i in rows])

    write(root / "train.avro", perm[:cut])
    write(root / "val.avro", perm[cut:])
    coords = [
        {"name": "fixed", "coordinate_type": "fixed",
         "feature_shard": "global", "reg_type": "l2", "reg_weight": 1.0,
         "max_iters": 100},
        {"name": "per-user", "coordinate_type": "random",
         "feature_shard": "user", "entity_column": "userId",
         "reg_type": "l2", "reg_weight": 1.0, "max_iters": 50,
         "num_buckets": 1},
    ]
    (root / "coords.json").write_text(json.dumps(coords))
    (root / "shards.json").write_text(json.dumps({"global": ["g"],
                                                  "user": ["u"]}))
    return root


def _train_argv(root, index_map):
    return ["--train-data", str(root / "train.avro"),
            "--validation-data", str(root / "val.avro"),
            "--coordinates", str(root / "coords.json"),
            "--feature-shards", str(root / "shards.json"),
            "--index-map", str(index_map), "--evaluators", "auc",
            "--dtype", "float64"]


@pytest.fixture(scope="module")
def runs(fixture):
    """scenario -> {pkg: output dir}; the index maps built first, each
    scenario run once per package (``base`` before the scenarios that warm
    start from it)."""
    for pkg, (index, _, _, _) in PKGS.items():
        assert index.main(["--data", str(fixture / "train.avro"),
                           "--output", str(fixture / f"imap-{pkg}.json")]) == 0
    done = {}

    def get(scenario):
        if scenario not in done:
            if scenario != "base":
                get("base")
            outs = {}
            for pkg, (_, train, _, extra) in PKGS.items():
                out = fixture / f"{scenario}-{pkg}"
                argv = (_train_argv(fixture, fixture / f"imap-{pkg}.json")
                        + SCENARIOS[scenario](fixture, pkg)
                        + ["--output-dir", str(out)] + extra)
                assert train.main(argv) == 0
                outs[pkg] = out
            done[scenario] = outs
        return done[scenario]

    return get


def _log(out):
    with open(os.path.join(out, "photon.log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _tree(out):
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, files in os.walk(out) for f in files)


def test_index_maps_equal(fixture, runs):
    runs("base")
    maps = {pkg: json.loads((fixture / f"imap-{pkg}.json").read_text())
            for pkg in PKGS}
    assert maps["port"] == maps["jax"]
    store = fixture / "imap.store"
    assert feature_indexing_driver.main(
        ["--data", str(fixture / "train.avro"), "--output", str(store),
         "--store-format", "paldb"]) == 0
    native = load_index_map(str(store))
    want = load_index_map(str(fixture / "imap-jax.json"))
    assert native.size == want.size
    assert dict(native.items()) == dict(want.forward)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_saved_models_match_the_jax_driver(runs, scenario):
    outs = runs(scenario)
    trees = {pkg: _tree(out) for pkg, out in outs.items()}
    assert trees["port"] == trees["jax"]
    models = [os.path.dirname(p) for p in trees["port"]
              if os.path.basename(p) == "metadata.json"]
    assert "best" in models
    for sub in models:
        got = load_game_model(str(outs["port"] / sub), device="cpu")
        want = load_game_model(str(outs["jax"] / sub), device="cpu")
        assert set(got.coordinates) == set(want.coordinates) == \
            {"fixed", "per-user"}
        assert _rel(got["fixed"].model.coefficients.means,
                    want["fixed"].model.coefficients.means) <= TOL_W, sub
        for bg, bw in zip(got["per-user"].buckets, want["per-user"].buckets):
            assert list(bg.entity_ids) == list(bw.entity_ids)
            assert _rel(bg.coefficients, bw.coefficients) <= TOL_W, sub


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_logged_events_match_the_jax_driver(runs, scenario):
    logs = {pkg: _log(out) for pkg, out in runs(scenario).items()}
    events = {pkg: [(e["event"], e.get("stage")) for e in log]
              for pkg, log in logs.items()}
    assert events["port"] == events["jax"]
    for key in ("cd_iteration", "tuning_round"):
        got = [e for e in logs["port"] if e["event"] == key]
        want = [e for e in logs["jax"] if e["event"] == key]
        for g, w in zip(got, want):
            for name in ("iteration", "coordinate", "round", "reg_weights"):
                assert g.get(name) == pytest.approx(w.get(name),
                                                    rel=TOL_W), name
            for name in ("auc", "entities_solved", "converged_fraction"):
                if name in w:
                    assert abs(g[name] - w[name]) <= TOL_METRIC, name
            if key == "tuning_round":
                assert abs(g["metrics"]["auc"] - w["metrics"]["auc"]) \
                    <= TOL_METRIC
    done = {pkg: log[-1] for pkg, log in logs.items()}
    assert done["port"]["event"] == "driver_done"
    assert abs(done["port"]["best_metrics"]["auc"]
               - done["jax"]["best_metrics"]["auc"]) <= TOL_METRIC
    for g, w in zip(done["port"]["best_config"], done["jax"]["best_config"]):
        assert g["name"] == w["name"]
        assert g["reg_weight"] == pytest.approx(w["reg_weight"], rel=TOL_W)
    start = logs["port"][0]
    assert start["event"] == "driver_start" and start["platform"] == "cpu"


def test_locked_coordinate_keeps_the_warm_start(runs):
    base = runs("base")["port"]
    warm = runs("warm_locked_normalized")["port"]
    got = load_game_model(str(warm / "best"), device="cpu")
    want = load_game_model(str(base / "best"), device="cpu")
    np.testing.assert_array_equal(got["fixed"].model.coefficients.means,
                                  want["fixed"].model.coefficients.means)
    assert (warm / "feature-summary.avro").exists()
    assert (warm / "feature-summary.user.avro").exists()


def _score(fixture, pkg, model_dir, name, *extra):
    out = fixture / f"score-{name}-{pkg}"
    _, _, score, dev = PKGS[pkg]
    assert score.main(["--data", str(fixture / "val.avro"), "--model-dir",
                       str(model_dir), "--output-dir", str(out),
                       "--evaluators", "auc", "--dtype", "float64",
                       *extra, *dev]) == 0
    records = list(iter_avro_records(str(out / "scores.avro")))
    metric = [e for e in _log(out) if e["event"] == "evaluation"][0]["auc"]
    return records, metric


def test_scoring_drivers_match_on_one_model(fixture, runs):
    """Both scoring drivers on the JAX driver's best model: the same rows,
    uids, labels and per-coordinate parts; scores and AUC within 1e-9.
    ``--batch-rows`` scores the same."""
    best = runs("base")["jax"] / "best"
    got, got_auc = _score(fixture, "port", best, "one",
                          "--per-coordinate-scores")
    want, want_auc = _score(fixture, "jax", best, "one",
                            "--per-coordinate-scores")
    assert [r["uid"] for r in got] == [r["uid"] for r in want]
    assert [r["label"] for r in got] == [r["label"] for r in want]
    for g, w in zip(got, want):
        assert abs(g["predictionScore"] - w["predictionScore"]) <= TOL_SCORE
        assert g["scoreComponents"].keys() == w["scoreComponents"].keys() \
            == {"fixed", "per-user"}
        for k, v in w["scoreComponents"].items():
            assert abs(g["scoreComponents"][k] - v) <= TOL_SCORE
    assert abs(got_auc - want_auc) <= TOL_METRIC
    batched, batched_auc = _score(fixture, "port", best, "batched",
                                  "--batch-rows", "17")
    np.testing.assert_allclose([r["predictionScore"] for r in batched],
                               [r["predictionScore"] for r in got],
                               rtol=0, atol=1e-12)
    assert batched_auc == pytest.approx(got_auc, abs=1e-12)


def test_each_package_scores_its_own_model_alike(fixture, runs):
    outs = runs("warm_locked_normalized")
    got, got_auc = _score(fixture, "port", outs["port"] / "best", "own")
    want, want_auc = _score(fixture, "jax", outs["jax"] / "best", "own")
    s_got = np.array([r["predictionScore"] for r in got])
    s_want = np.array([r["predictionScore"] for r in want])
    assert _rel(s_got, s_want) <= TOL_W
    assert abs(got_auc - want_auc) <= TOL_W


def _port_argv(fixture, out, *flags):
    return (_train_argv(fixture, fixture / "imap-port.json")
            + ["--n-iterations", "2", "--device", "cpu", "--output-dir",
               str(out), *flags])


_ONE_PROCESS_FLAGS = {
    "entity_shards": ["--entity-shards", "1"],
    "re_table_budget_mb": ["--re-table-budget-mb", "10"],
    "auto_resume": ["--auto-resume"],
    "max_rank_failures": ["--max-rank-failures", "1",
                          "--recovery-snapshot-every", "2"],
}


@pytest.mark.parametrize("name", list(_ONE_PROCESS_FLAGS))
def test_sharding_and_recovery_flags_on_one_process(fixture, runs, tmp_path,
                                                    name):
    """On one process each flag leaves the run as it was: one shard is the
    single-host layout, a table under budget trains, --auto-resume
    without a marker does nothing, and recovery commits no snapshot. The
    best model equals the plain run's bit for bit."""
    runs("base")  # builds the index maps
    plain = fixture / "plain-port"
    if not plain.exists():
        assert game_training_driver.main(_port_argv(fixture, plain)) == 0
    out = tmp_path / "o"
    assert game_training_driver.main(
        _port_argv(fixture, out, *_ONE_PROCESS_FLAGS[name])) == 0
    got = load_game_model(str(out / "best"), device="cpu")
    want = load_game_model(str(plain / "best"), device="cpu")
    np.testing.assert_array_equal(
        got["fixed"].model.coefficients.means.numpy(),
        want["fixed"].model.coefficients.means.numpy())
    for b, b_ref in zip(got["per-user"].buckets, want["per-user"].buckets):
        np.testing.assert_array_equal(np.asarray(b.coefficients),
                                      np.asarray(b_ref.coefficients))
    assert not (out / "recovery").exists()
    assert not (out / "RESUME.json").exists()


def test_entity_shards_and_table_budget_fail_fast(fixture, runs, tmp_path):
    from photon_ml_tpu_torch.parallel.entity_shard import (
        EntityTableBudgetError,
    )

    runs("base")
    with pytest.raises(SystemExit, match="process count"):
        game_training_driver.main(_port_argv(fixture, tmp_path / "a",
                                             "--entity-shards", "2"))
    assert not (tmp_path / "a").exists()  # before any data is read
    with pytest.raises(EntityTableBudgetError, match="entity-shards"):
        game_training_driver.main(_port_argv(
            fixture, tmp_path / "b", "--re-table-budget-mb", "1e-6"))
    assert not any(e["event"] == "cd_iteration"
                   for e in _log(tmp_path / "b"))


def test_scoring_out_of_core_raises(tmp_path):
    """``--out-of-core`` scores in windows of ``--batch-rows`` rows, which
    must be positive."""
    with pytest.raises(SystemExit):
        game_scoring_driver.main(["--data", "absent.avro", "--model-dir",
                                  "m", "--output-dir", str(tmp_path / "o"),
                                  "--out-of-core", "--batch-rows", "0",
                                  "--device", "cpu"])
    assert not (tmp_path / "o").exists()


def test_streamed_out_of_core_run_scores_as_the_jax_driver(fixture, runs):
    """Each package's out-of-core scoring driver on its own streamed,
    out-of-core trained model: scores within 1e-6; every fixed fit
    streamed (its pass accounting in the sweep log), and the scoring
    driver's out-of-core windows score exactly as its resident path."""
    outs = runs("streaming_out_of_core")
    got, got_auc = _score(fixture, "port", outs["port"] / "best", "ooc",
                          "--out-of-core", "--batch-rows", "40")
    want, want_auc = _score(fixture, "jax", outs["jax"] / "best", "ooc",
                            "--out-of-core", "--batch-rows", "40")
    assert [r["uid"] for r in got] == [r["uid"] for r in want]
    s_got = np.array([r["predictionScore"] for r in got])
    s_want = np.array([r["predictionScore"] for r in want])
    assert np.max(np.abs(s_got - s_want)) <= 1e-6
    assert abs(got_auc - want_auc) <= 1e-6
    resident, resident_auc = _score(fixture, "port", outs["port"] / "best",
                                    "resident")
    np.testing.assert_array_equal(
        s_got, [r["predictionScore"] for r in resident])
    assert resident_auc == got_auc
    fits = [e for e in _log(outs["port"]) if e["event"] == "cd_iteration"
            and e["coordinate"] == "fixed"]
    assert len(fits) == 2 and all(e["stream"]["kernel_passes"] > 0
                                  for e in fits)
    assert os.listdir(fixture / "chunk-cache-port" / "global")


def test_bad_tuning_flags_fail_before_reading(fixture, tmp_path):
    base = _train_argv(fixture, fixture / "absent.json") + [
        "--device", "cpu", "--output-dir", str(tmp_path / "o")]
    no_val = [a for a in base if a not in ("--validation-data",
                                           str(fixture / "val.avro"))]
    with pytest.raises(SystemExit, match="requires --validation-data"):
        game_training_driver.main(no_val + ["--tuning-mode", "random"])
    with pytest.raises(SystemExit, match="0 < LOW < HIGH"):
        game_training_driver.main(base + ["--tuning-mode", "random",
                                          "--tuning-range", "5", "1"])
    with pytest.raises(SystemExit, match="--tuning-coordinates"):
        game_training_driver.main(base + ["--tuning-mode", "random",
                                          "--tuning-coordinates", "nope"])


def test_default_device_raises_without_cuda(fixture, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        game_training_driver.main(
            _train_argv(fixture, fixture / "imap-port.json")
            + ["--output-dir", str(tmp_path / "t")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        game_scoring_driver.main(["--data", str(fixture / "val.avro"),
                                  "--model-dir", "m", "--output-dir",
                                  str(tmp_path / "s")])


def test_durable_replace_commits_and_leaves_no_temporary(fixture, runs,
                                                         tmp_path):
    from photon_ml_tpu_torch.io.durable import durable_replace

    dst, tmp = tmp_path / "out.bin", tmp_path / "out.bin.tmp-1"
    dst.write_bytes(b"old")
    tmp.write_bytes(b"new")
    durable_replace(str(tmp), str(dst))
    assert dst.read_bytes() == b"new" and not tmp.exists()
    _score(fixture, "port", runs("base")["port"] / "best", "durable")
    out = fixture / "score-durable-port"
    assert sorted(os.listdir(out)) == ["photon.log.jsonl", "scores.avro"]
