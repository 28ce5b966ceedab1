"""The port's GLM driver (``photon_ml_tpu_torch/cli/glm_driver.py``) against
the JAX driver on the same fixtures, each run once per module in both
packages with ``--dtype float64 --tolerance 0 --max-iters 15`` (tolerance 0
pins the iteration count, so both fit the same number of steps):

* ``libsvm_l2``: LIBSVM input, L2 grid [10, 1, 0.1], L-BFGS;
* ``avro_elastic_net``: Avro input, elastic net (forces OWL-QN);
* ``avro_standardized``: Avro input, standardization, coefficient
  variances and diagnostics;
* ``avro_streaming``: Avro input held in host RAM and streamed in chunks
  of 128 rows (``--streaming``), with coefficient variances;
* ``avro_out_of_core``: Avro input decoded from disk on every pass
  (``--out-of-core``, hashed into 64 columns);
* ``avro_chunk_cache``: the same through the decode-once chunk cache
  (``--chunk-cache-dir``), prefetch depth 0.

All of them score validation data. Tolerances: relative L2 of 1e-6 on every
lambda's coefficients and variances (the JAX driver's gradient is a
scatter-add on the CPU, the port's the column-sorted kernel path's plain
version: two summation orders, compounded over the iterations); 1e-9 on
every validation metric and on the Hosmer-Lemeshow statistic. The
recovery flags leave a clean run's models byte for byte,
a killed screened path resumes to the uninterrupted path's models byte
for byte, and the default ``--device`` raises without CUDA."""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli.glm_driver import main as jax_main
from photon_ml_tpu.io.model_io import load_game_model as jax_load
from photon_ml_tpu_torch.cli import glm_driver
from photon_ml_tpu_torch.io.data_reader import (
    feature_tuples_from_dense, write_training_examples,
)
from photon_ml_tpu_torch.io.model_io import load_game_model as port_load

TOL_W = 1e-6
TOL_METRIC = 1e-9
GRID = ["10", "1", "0.1"]
COMMON = ["--dtype", "float64", "--tolerance", "0", "--max-iters", "15",
          "--reg-weights", *GRID]
SCENARIOS = {
    "libsvm_l2": ["--input-format", "libsvm"],
    "avro_elastic_net": ["--reg-type", "elastic_net",
                         "--elastic-net-alpha", "0.5"],
    "avro_standardized": ["--normalization", "standardization",
                          "--compute-variances", "--diagnostics"],
    "avro_streaming": ["--streaming", "--chunk-rows", "128",
                       "--compute-variances"],
    "avro_out_of_core": ["--out-of-core", "--chunk-rows", "128",
                         "--hash-dim", "64"],
    "avro_chunk_cache": ["--out-of-core", "--chunk-rows", "128",
                         "--hash-dim", "64", "--prefetch-depth", "0"],
}


def _write_libsvm(path, X, y):
    with open(path, "w") as f:
        for i in range(X.shape[0]):
            toks = [f"{int(y[i]) * 2 - 1}"]
            toks += [f"{j + 1}:{X[i, j]:.6f}" for j in np.nonzero(X[i])[0]]
            f.write(" ".join(toks) + "\n")


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("glm")
    r = np.random.default_rng(0)
    n, d = 400, 10
    X = (r.random((n, d)) < 0.4) * r.normal(size=(n, d)) + 0.0
    X[:, 2] += 3.0 * (X[:, 2] != 0)  # a feature with a large mean
    w = r.normal(size=d)
    y = (r.random(n) < 1 / (1 + np.exp(-(X @ w)))).astype(float)
    _write_libsvm(root / "train.svm", X[:300], y[:300])
    _write_libsvm(root / "val.svm", X[300:], y[300:])
    write_training_examples(str(root / "train.avro"),
                            feature_tuples_from_dense(X[:300]), y[:300])
    write_training_examples(str(root / "val.avro"),
                            feature_tuples_from_dense(X[300:]), y[300:])
    return root


@pytest.fixture(scope="module")
def runs(fixtures):
    """scenario -> {"jax": out_dir, "port": out_dir}, each run once."""
    done = {}

    def get(scenario):
        if scenario not in done:
            ext = "svm" if scenario == "libsvm_l2" else "avro"
            argv = ["--train-data", str(fixtures / f"train.{ext}"),
                    "--validation-data", str(fixtures / f"val.{ext}"),
                    *COMMON, *SCENARIOS[scenario]]
            outs = {}
            for pkg, main, extra in (("jax", jax_main, []),
                                     ("port", glm_driver.main,
                                      ["--device", "cpu"])):
                out = str(fixtures / f"{scenario}-{pkg}")
                if scenario == "avro_chunk_cache":
                    extra = extra + ["--chunk-cache-dir",
                                     str(fixtures / f"cache-{pkg}")]
                assert main(argv + ["--output-dir", out] + extra) == 0
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


def _coef(model):
    c = model["global"].model.coefficients
    return (np.asarray(c.means),
            None if c.variances is None else np.asarray(c.variances))


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_every_lambda_matches_the_jax_driver(runs, scenario):
    outs = runs(scenario)
    logs = {pkg: [e for e in _log(out) if e["event"] == "lambda_trained"]
            for pkg, out in outs.items()}
    assert [e["reg_weight"] for e in logs["port"]] == [10.0, 1.0, 0.1]
    for got, want in zip(logs["port"], logs["jax"]):
        assert got["iterations"] == want["iterations"] == 15
        assert got["metrics"].keys() == want["metrics"].keys() == {"auc"}
        for name, value in want["metrics"].items():
            assert abs(got["metrics"][name] - value) <= TOL_METRIC
        assert abs(got["loss"] - want["loss"]) <= TOL_W * abs(want["loss"])
    for lam in GRID:
        sub = os.path.join("all", f"lambda-{lam}")
        gw, gv = _coef(port_load(os.path.join(outs["port"], sub),
                                 device="cpu"))
        ww, wv = _coef(jax_load(os.path.join(outs["jax"], sub)))
        assert _rel(gw, ww) <= TOL_W
        assert (gv is None) == (wv is None)
        if wv is not None:
            assert _rel(gv, wv) <= TOL_W


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_best_lambda_stages_and_output_tree_match(runs, scenario):
    outs = runs(scenario)
    logs = {pkg: _log(out) for pkg, out in outs.items()}
    stages = {pkg: [(e["event"], e.get("stage")) for e in log]
              for pkg, log in logs.items()}
    assert stages["port"] == stages["jax"]
    done = {pkg: log[-1] for pkg, log in logs.items()}
    assert done["port"]["event"] == "driver_done"
    assert done["port"]["best_reg_weight"] == done["jax"]["best_reg_weight"]
    trees = {pkg: sorted(os.path.relpath(os.path.join(d, f), out)
                         for d, _, files in os.walk(out) for f in files)
             for pkg, out in outs.items()}
    assert trees["port"] == trees["jax"]
    read = [e for e in logs["port"] if e["event"] == "data_read"][0]
    assert read["decoder"] == ("libsvm" if scenario == "libsvm_l2"
                               else "native")


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_best_model_loads_in_the_other_package(runs, scenario):
    outs = runs(scenario)
    jax_best = os.path.join(outs["jax"], "best")
    port_best = os.path.join(outs["port"], "best")
    for got, want in ((_coef(port_load(jax_best, device="cpu")),
                       _coef(jax_load(jax_best))),
                      (_coef(jax_load(port_best)),
                       _coef(port_load(port_best, device="cpu")))):
        np.testing.assert_array_equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if want[1] is not None:
            np.testing.assert_array_equal(got[1], want[1])


def test_diagnostics_report_matches(runs):
    outs = runs("avro_standardized")
    reports = {}
    for pkg, out in outs.items():
        with open(os.path.join(out, "diagnostics.json")) as f:
            reports[pkg] = json.load(f)
    got, want = reports["port"], reports["jax"]
    assert got["reg_weight"] == want["reg_weight"]
    hl, jhl = got["hosmer_lemeshow"], want["hosmer_lemeshow"]
    assert hl["dof"] == jhl["dof"]
    assert abs(hl["statistic"] - jhl["statistic"]) <= TOL_METRIC * max(
        1.0, jhl["statistic"])
    scores = {e["feature"]: e["score"] for e in got["feature_importance"]}
    jscores = {e["feature"]: e["score"] for e in want["feature_importance"]}
    assert scores.keys() == jscores.keys()
    assert _rel([scores[k] for k in jscores], list(jscores.values())) <= TOL_W


def _svm_argv(fixtures, out, *flags):
    return ["--train-data", str(fixtures / "train.svm"),
            "--validation-data", str(fixtures / "val.svm"),
            "--input-format", "libsvm", *COMMON, "--device", "cpu",
            "--output-dir", str(out), *flags]


def _same_models(a, b):
    import filecmp

    for sub in ("best", *(os.path.join("all", f"lambda-{float(g):g}")
                          for g in GRID)):
        d = os.path.join(sub, "fixed-effect", "global")
        names = sorted(os.listdir(a / d))
        match, mismatch, errors = filecmp.cmpfiles(a / d, b / d, names,
                                                   shallow=False)
        assert match == names and not mismatch and not errors, sub


@pytest.mark.parametrize("flags", [["--auto-resume"],
                                   ["--max-rank-failures", "1"]],
                         ids=["auto_resume", "max_rank_failures"])
def test_recovery_flags_on_a_clean_run(fixtures, tmp_path, flags):
    """Without a marker --auto-resume does nothing, and on one process
    --max-rank-failures never retries: the models are the plain run's
    byte for byte, and no marker is left."""
    plain = tmp_path / "plain"
    assert glm_driver.main(_svm_argv(fixtures, plain)) == 0
    out = tmp_path / "o"
    assert glm_driver.main(_svm_argv(fixtures, out, *flags)) == 0
    _same_models(plain, out)
    assert not (out / "RESUME_GLM.npz").exists()


def test_screened_path_resumes_from_the_marker(fixtures, tmp_path):
    """A screened path killed by a device loss at its second lambda exits
    75; --auto-resume seeds the path solver with the first lambda's
    solution instead of re-solving it and saves the uninterrupted path's
    models byte for byte."""
    from photon_ml_tpu_torch.parallel import fault_injection as fi

    flags = ["--reg-type", "elastic_net", "--path-screen", "strong"]
    clean = tmp_path / "clean"
    assert glm_driver.main(_svm_argv(fixtures, clean, *flags)) == 0
    out = tmp_path / "o"
    fi.install([fi.Fault(site="glm.lambda", at=1, kind="device_loss")])
    try:
        assert glm_driver.main(_svm_argv(fixtures, out, *flags)) == 75
    finally:
        fi.clear()
    assert (out / "RESUME_GLM.npz").exists()
    with pytest.raises(Exception, match="path_screen"):
        glm_driver.main(_svm_argv(fixtures, out, "--reg-type", "elastic_net",
                                  "--auto-resume"))
    assert glm_driver.main(_svm_argv(fixtures, out, *flags,
                                     "--auto-resume")) == 0
    assert not (out / "RESUME_GLM.npz").exists()
    events = [e["event"] for e in _log(out)]
    resumed = _log(out)[events.index("auto_resume"):]
    # only the unfinished lambdas are trained after the resume
    assert [e["reg_weight"] for e in resumed
            if e["event"] == "lambda_trained"] == [float(g)
                                                   for g in GRID[1:]]
    _same_models(clean, out)


def test_default_device_raises_without_cuda(fixtures, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        glm_driver.main(["--train-data", str(fixtures / "train.svm"),
                         "--input-format", "libsvm",
                         "--output-dir", str(tmp_path / "o")])


def test_streamed_runs_log_their_pipeline(runs):
    """Each streamed lambda logs its pass accounting; out of core, the
    validation of the training data is skipped as in the JAX driver, and
    the chunk cache's warm passes fit exactly as the uncached run."""
    for scenario in ("avro_streaming", "avro_out_of_core",
                     "avro_chunk_cache"):
        log = _log(runs(scenario)["port"])
        trained = [e for e in log if e["event"] == "lambda_trained"]
        assert all(e["stream"]["kernel_passes"] >= 15 for e in trained)
        skipped = any(e["event"] == "validate_skipped_out_of_core"
                      for e in log)
        assert skipped == (scenario != "avro_streaming")
    for lam in GRID:
        sub = os.path.join("all", f"lambda-{lam}")
        a, b = (_coef(port_load(os.path.join(runs(s)["port"], sub),
                                device="cpu"))[0]
                for s in ("avro_out_of_core", "avro_chunk_cache"))
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flags, message", [
    (["--chunk-cache-dir", "cache"], "requires --out-of-core"),
    (["--out-of-core", "--chunk-cache-gb", "1"], "requires --chunk-cache-dir"),
    (["--out-of-core", "--input-format", "libsvm"], "--input-format avro"),
    (["--out-of-core"], "pinned feature space"),
    (["--out-of-core", "--hash-dim", "8", "--summarize-features"],
     "cannot summarize"),
])
def test_streaming_flag_validation(tmp_path, flags, message):
    argv = ["--train-data", "absent.avro", "--output-dir", str(tmp_path / "o"),
            "--device", "cpu", *flags]
    with pytest.raises(SystemExit, match=message):
        glm_driver.main(argv)
