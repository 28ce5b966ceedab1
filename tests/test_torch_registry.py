"""The port's model lifecycle (``photon_ml_tpu_torch/registry/``, the watcher,
``cli/model_publish_driver.py`` and the GAME training driver's
``--publish-to``) against the JAX package's, on the CPU.

Both registries publish the same saved model (``save_small_game_model``:
fixed effects over shard ``g``, ``per-user`` over shard ``u``) and must
leave the same visible state: versions, ``LATEST``, artifact fingerprints
(sha256 of every payload file, so equal fingerprints mean byte-equal
payloads), manifest keys, delta specs and materialized trees byte for
byte. The gate scores a labeled holdout drawn from the model's own
margins (seed 5) on the CPU in float64; its metrics agree with the JAX
gate's within ``TOL_METRIC``."""

import json
import os
import shutil

import numpy as np
import pytest

from photon_ml_tpu.cli import model_publish_driver as jax_publish_driver
from photon_ml_tpu.parallel import fault_injection as jax_faults
from photon_ml_tpu.registry import delta as jax_delta
from photon_ml_tpu.registry import gate as jax_gate
from photon_ml_tpu.registry import store as jax_store
from photon_ml_tpu.serve.watcher import RegistryWatcher as JaxWatcher
from photon_ml_tpu_torch.cli import model_publish_driver
from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu_torch.io.data_reader import write_training_examples
from photon_ml_tpu_torch.parallel import fault_injection
from photon_ml_tpu_torch.registry import delta, gate, store
from photon_ml_tpu_torch.serve.watcher import RegistryWatcher
from tests.test_torch_serve_session import save_small_game_model

TOL_METRIC = 1e-9  # |port gate metric - JAX gate metric|, float64 on the CPU
PACKAGES = {
    "jax": (jax_store, jax_delta, jax_gate, jax_faults),
    "port": (store, delta, gate, fault_injection),
}
RE_FILE = os.path.join("random-effect", "per-user", "coefficients.avro")
FE_FILE = os.path.join("fixed-effect", "fixed", "coefficients.avro")


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    jax_faults.clear()
    fault_injection.clear()


def _rewrite(model_dir, dst, rel, change):
    """Copy ``model_dir`` to ``dst`` and rewrite the records of ``rel``
    with ``change(record)`` (which returns whether it changed it)."""
    shutil.copytree(model_dir, str(dst))
    path = os.path.join(str(dst), rel)
    records, schema = read_avro_file(path)
    changed = sum(bool(change(r)) for r in records)
    write_avro_file(path, records, schema)
    return str(dst), changed


def _scale_users(model_dir, dst, users, scale):
    def change(rec):
        if str(rec["modelId"]) not in users:
            return False
        for coef in rec["means"]:
            coef["value"] *= scale
        return True

    out, changed = _rewrite(model_dir, dst, RE_FILE, change)
    assert changed == len(users)
    return out


def _negate_fixed(model_dir, dst):
    def change(rec):
        for coef in rec["means"]:
            coef["value"] = -coef["value"]
        return True

    return _rewrite(model_dir, dst, FE_FILE, change)[0]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The saved model, a delta candidate (users 1 and 4 scaled by 0.5),
    a regressing candidate (fixed effects negated) and a labeled holdout
    whose labels follow the model's own margins."""
    root = tmp_path_factory.mktemp("registry")
    model_dir, bundle = save_small_game_model(root)
    coefs = {str(r["modelId"]): r for r in
             read_avro_file(os.path.join(model_dir, RE_FILE))[0]}
    fixed = read_avro_file(os.path.join(model_dir, FE_FILE))[0][0]
    w = np.zeros(bundle["d_fix"])
    for c in fixed["means"]:
        w[int(c["name"][1:])] = c["value"]
    u = np.zeros((bundle["n_entities"], bundle["d_re"]))
    for e, rec in coefs.items():
        for c in rec["means"]:
            u[int(e), int(c["name"][1:])] = c["value"]
    margins = (bundle["Xg"] @ w
               + np.einsum("ij,ij->i", bundle["Xu"], u[bundle["uid"]]))
    r = np.random.default_rng(5)
    y = (r.random(margins.size) < 1 / (1 + np.exp(-margins))).astype(float)
    holdout = str(root / "holdout.avro")
    rows = ([(f"g{j}", "", float(bundle["Xg"][i, j]))
             for j in range(bundle["d_fix"])]
            + [(f"u{j}", "", float(bundle["Xu"][i, j]))
               for j in range(bundle["d_re"])]
            for i in range(margins.size))
    write_training_examples(holdout, rows, y,
                            entity_ids={"userId": bundle["uid"].astype(str)})
    return {
        "model_dir": model_dir, "bundle": bundle, "holdout": holdout,
        "delta_dir": _scale_users(model_dir, root / "delta", {"1", "4"},
                                  0.5),
        "bad_dir": _negate_fixed(model_dir, root / "bad"),
    }


def _tree_bytes(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            full = os.path.join(dirpath, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


def test_publish_fingerprints_and_manifest_keys_match_jax(models, tmp_path):
    got = {}
    for name, (st, _d, _g, _f) in PACKAGES.items():
        reg = st.ModelRegistry(str(tmp_path / name))
        v1 = reg.publish(models["model_dir"], metrics={"auc": 0.5},
                         set_latest=True)
        reg.verify(v1)
        got[name] = (v1, reg.read_latest(),
                     st.artifact_fingerprints(reg.version_dir(v1)),
                     sorted(reg.manifest(v1)))
    assert got["port"] == got["jax"]
    assert "metadata.json" in got["port"][2]


def test_publish_gc_rollback_sequence_matches_jax(models, tmp_path):
    """publish (bootstrap), delta on top (live), two full versions, GC
    keeping one plus the live chain, rollback to the parent."""
    got = {}
    for name, (st, dl, _g, _f) in PACKAGES.items():
        reg = st.ModelRegistry(str(tmp_path / name))
        trail = [reg.publish(models["model_dir"], set_latest=True),
                 dl.publish_delta(reg, models["delta_dir"], set_latest=True),
                 reg.publish(models["model_dir"]),
                 reg.publish(models["bad_dir"])]
        removed = reg.gc(keep=1)
        after_gc = (reg.list_versions(), reg.read_latest(),
                    reg.protected_versions())
        reg.set_latest(trail[0])
        got[name] = (trail, removed, after_gc, reg.list_versions(),
                     reg.read_latest())
    assert got["port"] == got["jax"]
    assert got["port"][1] == ["v000003"]


def test_compute_delta_and_materialize_match_jax(models, tmp_path):
    specs, trees = {}, {}
    for name, (st, dl, _g, _f) in PACKAGES.items():
        spec = dl.compute_delta(models["delta_dir"], models["model_dir"])
        specs[name] = (spec.changed_fixed,
                       {k: sorted(json.dumps(r, sort_keys=True) for r in v)
                        for k, v in spec.random_effect_updates.items()},
                       spec.unchanged_entities, spec.empty)
        reg = st.ModelRegistry(str(tmp_path / name))
        reg.publish(models["model_dir"], set_latest=True)
        v2 = dl.publish_delta(reg, models["delta_dir"])
        trees[name] = (_tree_bytes(reg.model_dir(v2)),
                       _tree_bytes(dl.materialize(reg, v2)),
                       reg.manifest(v2)["delta_summary"])
    assert specs["port"] == specs["jax"]
    assert len(specs["port"][1]["per-user"]) == 2
    assert trees["port"] == trees["jax"]
    # the materialized delta equals the candidate it was computed from
    # record for record
    port_resolved = tmp_path / "port" / ".resolved" / "v000002"
    want = read_avro_file(os.path.join(models["delta_dir"], RE_FILE))[0]
    got = read_avro_file(str(port_resolved / RE_FILE))[0]
    assert sorted(got, key=lambda r: r["modelId"]) == sorted(
        want, key=lambda r: r["modelId"])


@pytest.mark.parametrize("site", ["registry.publish_prepared",
                                  "registry.published"])
def test_publish_crash_windows_match_jax(models, tmp_path, site):
    got = {}
    for name, (st, _d, _g, faults) in PACKAGES.items():
        reg = st.ModelRegistry(str(tmp_path / name))
        v1 = reg.publish(models["model_dir"], set_latest=True)
        faults.install([faults.Fault(site=site, kind="raise")])
        with pytest.raises(faults.InjectedFault):
            reg.publish(models["model_dir"], set_latest=True)
        faults.clear()
        staged = sorted(d for d in os.listdir(reg.versions_root)
                        if d.startswith(".tmp-"))
        state = (reg.list_versions(), reg.read_latest(), len(staged),
                 reg.gc(keep=10))
        got[name] = (v1, state, reg.publish(models["model_dir"]))
    assert got["port"] == got["jax"]


def test_gate_metrics_match_jax(models):
    evaluators = ["auc", "logistic_loss"]
    want = jax_gate.evaluate_model_dir(models["model_dir"],
                                       [models["holdout"]], evaluators)
    got = gate.evaluate_model_dir(models["model_dir"], [models["holdout"]],
                                  evaluators, device="cpu")
    assert set(got) == set(want) == set(evaluators)
    for k in evaluators:
        assert abs(got[k] - want[k]) <= TOL_METRIC, (k, got[k], want[k])
    assert got["auc"] > 0.6  # the labels follow the model's margins


@pytest.mark.parametrize("candidate", ["bad_dir", "delta_dir"])
def test_run_gate_verdicts_match_jax(models, tmp_path, candidate):
    """The negated fixed effects regress AUC beyond 0.02 and are refused
    (LATEST stays v1); the scaled delta is within 0.05 and promoted."""
    out = {}
    for name, (st, dl, gt, _f) in PACKAGES.items():
        reg = st.ModelRegistry(str(tmp_path / name))
        v1 = reg.publish(models["model_dir"], set_latest=True)
        if candidate == "delta_dir":
            v2 = dl.publish_delta(reg, models[candidate])
        else:
            v2 = reg.publish(models[candidate], parent=v1)
        kw = {"device": "cpu"} if name == "port" else {}
        verdict = gt.run_gate(reg, v2, [models["holdout"]],
                              evaluators=["auc"],
                              tolerance=0.02 if candidate == "bad_dir"
                              else 0.05, **kw)
        out[name] = (verdict, reg.read_latest(), reg.manifest(v2)["gate"])
    (jv, j_latest, j_gate), (pv, p_latest, p_gate) = out["jax"], out["port"]
    assert (pv.passed, pv.promoted, p_latest, sorted(pv.regressions)) == (
        jv.passed, jv.promoted, j_latest, sorted(jv.regressions))
    assert abs(pv.candidate_metrics["auc"]
               - jv.candidate_metrics["auc"]) <= TOL_METRIC
    assert abs(pv.live_metrics["auc"] - jv.live_metrics["auc"]) <= TOL_METRIC
    assert sorted(p_gate) == sorted(j_gate)
    assert pv.passed == (candidate == "delta_dir")
    assert p_latest == ("v000002" if pv.passed else "v000001")


def _drive(main, argv, capsys):
    rc = main(argv)
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines() if line.startswith("{")]
    return rc, lines


def _fields(lines):
    """The driver's JSON lines with the keys they carry and the values
    that do not depend on float rounding."""
    out = []
    for line in lines:
        out.append({k: (sorted(v) if isinstance(v, dict) else v)
                    for k, v in line.items()})
    return out


def test_publish_driver_matches_jax(models, tmp_path, capsys):
    """The same argv sequence through both drivers: bootstrap, a delta
    promoted without a gate, a refused candidate (exit 3), the listing,
    a rollback, GC and nothing to do (exit 2)."""
    runs = {}
    for name, main in (("jax", jax_publish_driver.main),
                       ("port", model_publish_driver.main)):
        root = str(tmp_path / name)
        dev = ["--device", "cpu"] if name == "port" else []
        steps = [
            ["--model-dir", models["model_dir"], "--set-latest"],
            ["--model-dir", models["delta_dir"], "--delta", "--set-latest"],
            ["--model-dir", models["bad_dir"], "--gate-data",
             models["holdout"], "--evaluators", "auc", "--tolerance",
             "0.02"] + dev,
            ["--list"],
            ["--rollback-to", "v000001", "--gc-keep", "1"],
            [],
        ]
        runs[name] = [_drive(main, ["--registry", root] + s, capsys)
                      for s in steps]
    rcs = [rc for rc, _ in runs["port"]]
    assert rcs == [rc for rc, _ in runs["jax"]] == [0, 0, 3, 0, 0, 2]
    for (_, got), (_, want) in zip(runs["port"], runs["jax"]):
        assert _fields(got) == _fields(want)


def test_watcher_backoff_schedule_matches_jax(models, tmp_path):
    """A registry whose reads fail: both watchers, on the same seeded
    rng, sleep the same schedule (interval, then the jittered backoff),
    reset on the first good poll, and ``stop`` joins within its bound."""
    import random

    from photon_ml_tpu.parallel.resilience import Backoff as JaxBackoff
    from photon_ml_tpu_torch.parallel.resilience import Backoff

    class Session:
        active_version = "v000001"
        metrics = None

    class Flaky:
        def __init__(self):
            self.fail = True

        def read_latest(self):
            if self.fail:
                raise OSError("registry down")
            return "v000001"

    schedules = {}
    for name, cls, backoff in (("jax", JaxWatcher, JaxBackoff),
                               ("port", RegistryWatcher, Backoff)):
        reg = Flaky()
        w = cls(reg, Session(), interval_s=0.5, jitter_s=0.2,
                error_backoff_max_s=3.0)
        w._error_backoff = backoff(base_s=0.5, factor=2.0, max_s=3.0,
                                   jitter=0.1, rng=random.Random(3),
                                   clock=lambda: 0.0)
        rng = random.Random(7)
        seen = []
        for tick in range(8):
            reg.fail = tick < 6
            before = w.errors
            w.check_once()
            w._observe(before)
            seen.append(round(w._next_delay(rng), 12))
        schedules[name] = (seen, w.errors, w.checks)
    assert schedules["port"] == schedules["jax"]
    assert schedules["port"][1] == 6

    w = RegistryWatcher(Flaky(), Session(), interval_s=0.01).start()
    w.stop(timeout_s=5.0)
    assert not w._thread.is_alive() and w.join_timeouts == 0


def test_training_driver_publish_to_bootstraps_then_stays_a_candidate(
        tmp_path):
    """``game_training_driver --publish-to``: the first publish into an
    empty registry is v1 and LATEST, its payload byte for byte the saved
    ``best/``; a second run publishes v2 as a candidate and LATEST stays
    v1."""
    import json as _json

    from photon_ml_tpu_torch.cli import (
        feature_indexing_driver, game_training_driver,
    )

    rng = np.random.default_rng(2)
    n, d_g, d_u = 120, 3, 2
    Xg, Xu = rng.normal(size=(n, d_g)), rng.normal(size=(n, d_u))
    uid = rng.integers(0, 6, n)
    y = (rng.random(n) < 1 / (1 + np.exp(-Xg.sum(1)))).astype(float)
    for name, rows in (("train", range(0, 90)), ("val", range(90, n))):
        rows = list(rows)
        write_training_examples(
            str(tmp_path / f"{name}.avro"),
            ([(f"g{j}", "", float(Xg[i, j])) for j in range(d_g)]
             + [(f"u{j}", "", float(Xu[i, j])) for j in range(d_u)]
             for i in rows), y[rows], entity_ids={"userId": uid[rows]})
    (tmp_path / "coords.json").write_text(_json.dumps([
        {"name": "fixed", "coordinate_type": "fixed",
         "feature_shard": "global", "reg_weight": 1.0},
        {"name": "per-user", "coordinate_type": "random",
         "feature_shard": "user", "entity_column": "userId",
         "reg_weight": 1.0, "num_buckets": 1}]))
    (tmp_path / "shards.json").write_text(_json.dumps(
        {"global": ["g"], "user": ["u"]}))
    imap = str(tmp_path / "imap.json")
    assert feature_indexing_driver.main(
        ["--data", str(tmp_path / "train.avro"), "--output", imap]) == 0
    root = str(tmp_path / "registry")
    reg = store.ModelRegistry(root)
    for run, want_latest in (("a", "v000001"), ("b", "v000001")):
        out = tmp_path / run
        assert game_training_driver.main([
            "--train-data", str(tmp_path / "train.avro"),
            "--validation-data", str(tmp_path / "val.avro"),
            "--coordinates", str(tmp_path / "coords.json"),
            "--feature-shards", str(tmp_path / "shards.json"),
            "--index-map", imap, "--evaluators", "auc", "--dtype",
            "float64", "--device", "cpu", "--output-dir", str(out),
            "--publish-to", root]) == 0
        assert reg.read_latest() == want_latest
        with open(out / "photon.log.jsonl") as f:
            published = [_json.loads(line) for line in f
                         if '"model_published"' in line]
        assert [(e["version"], e["set_latest"]) for e in published] == [
            ("v000001", True) if run == "a" else ("v000002", False)]
        version = published[0]["version"]
        assert _tree_bytes(reg.model_dir(version)) == _tree_bytes(
            str(out / "best"))
    assert reg.list_versions() == ["v000001", "v000002"]
