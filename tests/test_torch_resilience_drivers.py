"""Kill-and-rerun tests of the port's drivers through its fault injection,
mirroring ``tests/test_resilience_drivers.py``, ``tests/test_resume.py``
and the driver half of ``tests/test_recovery.py``.

For each training driver an injected device loss (``kind="device_loss"``,
the ``torch.AcceleratorError`` of a sticky CUDA error) exits 75 and leaves
its marker; a rerun with ``--auto-resume`` resumes from it and consumes it
only on completion, the marker survives a second failure of another kind,
and a rerun on different validation data refuses it
(``ResumeMismatch``). The resumed GLM grid's saved models are
byte-identical to an uninterrupted run's, and the resumed GAME run (one
checkpointed sweep, then two from it) ends within 5e-2 relative of three
uninterrupted sweeps, the reference's own bound for a coarse checkpoint
(``tests/test_resume.py``). The scoring driver exits 75 on device loss.
``--entity-shards`` must equal the process count, and the recovery flags
keep the reference's defaults and validation.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.cli import game_scoring_driver
from photon_ml_tpu_torch.cli.game_training_driver import (
    build_arg_parser, main as train_main,
)
from photon_ml_tpu_torch.cli.glm_driver import (
    build_arg_parser as glm_parser, main as glm_main,
)
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.parallel import fault_injection as fi
from photon_ml_tpu_torch.parallel.resilience import ResumeMismatch
from photon_ml_tpu_torch.testing import (
    Dropped, run_simulated_processes, synthetic_game_data,
    write_game_avro_fixture,
)
from photon_ml_tpu_torch.utils.config import cuda_error


@pytest.fixture(autouse=True)
def _clear_faults():
    fi.clear()
    yield
    fi.clear()


def _write_libsvm(path, X, y):
    with open(path, "w") as f:
        for i in range(X.shape[0]):
            toks = [f"{int(y[i]) * 2 - 1}"]
            toks += [f"{j + 1}:{X[i, j]:.6f}" for j in np.nonzero(X[i])[0]]
            f.write(" ".join(toks) + "\n")


def _events(out):
    return [json.loads(line)["event"]
            for line in (out / "photon.log.jsonl").read_text().splitlines()]


def _same_files(a, b):
    names = sorted(os.listdir(a))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    return match == names and not mismatch and not errors


# -- GLM driver -------------------------------------------------------------
def test_glm_kill_rerun_and_validation_fingerprint(tmp_path):
    rng = np.random.default_rng(0)
    n, d = 260, 8
    X = (rng.random((n, d)) < 0.5) * rng.normal(size=(n, d))
    w = rng.normal(size=d)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ w)))).astype(float)
    _write_libsvm(tmp_path / "train.svm", X[:180], y[:180])
    _write_libsvm(tmp_path / "val.svm", X[180:], y[180:])

    def argv(out):
        return ["--train-data", str(tmp_path / "train.svm"),
                "--validation-data", str(tmp_path / "val.svm"),
                "--input-format", "libsvm", "--reg-weights", "10.0", "1.0",
                "--max-iters", "40", "--dtype", "float64", "--device", "cpu",
                "--output-dir", str(out)]

    clean = tmp_path / "clean"
    assert glm_main(argv(clean)) == 0
    out = tmp_path / "out"
    # die entering the SECOND lambda: the first one's result is resume state
    fi.install([fi.Fault(site="glm.lambda", at=1, kind="device_loss")])
    assert glm_main(argv(out)) == 75
    marker = out / "RESUME_GLM.npz"
    assert marker.exists() and "device_lost" in _events(out)
    fi.clear()

    # the same path with other rows: the restored metrics would mix
    # datasets, so the rerun refuses and keeps the marker
    _write_libsvm(tmp_path / "val.svm", X[170:], y[170:])
    with pytest.raises(ResumeMismatch, match="validation_rows"):
        glm_main(argv(out) + ["--auto-resume"])
    assert marker.exists()

    _write_libsvm(tmp_path / "val.svm", X[180:], y[180:])
    assert glm_main(argv(out) + ["--auto-resume"]) == 0
    assert not marker.exists()
    assert "auto_resume" in _events(out)
    # the resumed grid saved the same models byte for byte
    for sub in ("best", "all/lambda-10", "all/lambda-1"):
        coef = os.path.join(sub, "fixed-effect", "global")
        assert _same_files(clean / coef, out / coef), sub


def test_glm_device_loss_marker_written_without_reading_the_card(
        tmp_path, monkeypatch):
    """A real sticky error leaves every later read from the card failing:
    the marker must come from the host copies taken as each lambda
    finished. Here a poisoned context is mimicked by making every tensor
    read raise once the second lambda's site has fired."""
    rng = np.random.default_rng(1)
    n, d = 200, 6
    X = (rng.random((n, d)) < 0.5) * rng.normal(size=(n, d))
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ rng.normal(size=d))))
         ).astype(float)
    _write_libsvm(tmp_path / "train.svm", X[:150], y[:150])
    _write_libsvm(tmp_path / "val.svm", X[150:], y[150:])

    def argv(out):
        return ["--train-data", str(tmp_path / "train.svm"),
                "--validation-data", str(tmp_path / "val.svm"),
                "--input-format", "libsvm", "--reg-weights", "10.0", "1.0",
                "--max-iters", "40", "--dtype", "float64",
                "--compute-variances", "--device", "cpu",
                "--output-dir", str(out)]

    clean = tmp_path / "clean"
    assert glm_main(argv(clean)) == 0

    poisoned, lambdas = [False], []
    real_check = fi.check

    def sticky_check(site):
        if site == "glm.lambda":
            lambdas.append(site)
            if len(lambdas) == 2:
                poisoned[0] = True
                raise cuda_error("cudaErrorAssert",
                                 "device-side assert triggered")
        real_check(site)

    def poison(name):
        real = getattr(torch.Tensor, name)

        def read(self, *a, **k):
            if poisoned[0]:
                raise cuda_error("cudaErrorAssert",
                                 "device-side assert triggered")
            return real(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, read)

    for name in ("cpu", "numpy", "item", "tolist", "__float__", "__int__"):
        poison(name)
    monkeypatch.setattr(fi, "check", sticky_check)
    out = tmp_path / "out"
    assert glm_main(argv(out)) == 75
    assert (out / "RESUME_GLM.npz").exists() and "device_lost" in _events(out)

    poisoned[0] = False
    monkeypatch.setattr(fi, "check", real_check)
    assert glm_main(argv(out) + ["--auto-resume"]) == 0
    assert not (out / "RESUME_GLM.npz").exists()
    for sub in ("best", "all/lambda-10", "all/lambda-1"):
        coef = os.path.join(sub, "fixed-effect", "global")
        assert _same_files(clean / coef, out / coef), sub


# -- GAME training driver ---------------------------------------------------
@pytest.fixture
def game_case(tmp_path):
    data = synthetic_game_data({"userId": 8}, seed=4)
    train, val = str(tmp_path / "train.avro"), str(tmp_path / "val.avro")
    n = len(data.labels)
    write_game_avro_fixture(train, data, rows=np.arange(0, n - 40))
    write_game_avro_fixture(val, data, rows=np.arange(n - 40, n))
    coords = json.dumps([
        {"name": "fixed", "coordinate_type": "fixed",
         "feature_shard": "global", "reg_type": "l2", "reg_weight": 0.5,
         "max_iters": 25},
        {"name": "per-user", "coordinate_type": "random",
         "feature_shard": "entity", "entity_column": "userId",
         "reg_type": "l2", "reg_weight": 1.0, "max_iters": 15,
         "optimizer": "lbfgs", "tolerance": 1e-9},
    ])
    shards = json.dumps({"global": ["g"], "entity": ["u"]})

    def argv(out, val_path=val, iters="2"):
        return ["--train-data", train, "--validation-data", val_path,
                "--output-dir", str(out), "--task", "logistic_regression",
                "--coordinates", coords, "--feature-shards", shards,
                "--n-iterations", iters, "--checkpoint", "--dtype",
                "float64", "--device", "cpu"]

    return tmp_path, data, argv


def _fixed(path):
    return load_game_model(str(path), device="cpu")[
        "fixed"].model.coefficients.means.numpy()


def test_game_kill_rerun_marker_survives_second_failure(game_case):
    tmp_path, _data, argv = game_case
    out = tmp_path / "out"
    # cd.step fires once per (sweep, coordinate): at=2 dies in the second
    # sweep, after sweep 0's checkpoint was written
    fi.install([fi.Fault(site="cd.step", at=2, kind="device_loss")])
    assert train_main(argv(out)) == 75
    marker = out / "RESUME.json"
    ckpt = json.loads(marker.read_text())["checkpoint"]
    assert ckpt and ckpt.endswith("config-0-iter-0")
    assert not (out / "best" / "metadata.json").exists()

    # a second failure of another kind keeps the resume state
    fi.install([fi.Fault(site="cd.step", at=0, kind="raise")])
    with pytest.raises(fi.InjectedFault):
        train_main(argv(out) + ["--auto-resume"])
    assert marker.exists()

    fi.clear()
    assert train_main(argv(out) + ["--auto-resume"]) == 0
    assert not marker.exists()
    events = _events(out)
    assert "device_lost" in events and "auto_resume" in events
    # one sweep checkpointed, then two more from it: against three
    # uninterrupted sweeps. The coefficients carry over, not the solvers'
    # internals (active sets, warm L-BFGS memory), so resumed ~ clean
    clean = tmp_path / "clean"
    assert train_main(argv(clean, iters="3")) == 0
    np.testing.assert_allclose(_fixed(out / "best"), _fixed(clean / "best"),
                               rtol=5e-2, atol=5e-3)


def test_game_resume_refuses_mismatched_validation(game_case):
    tmp_path, data, argv = game_case
    out = tmp_path / "out2"
    fi.install([fi.Fault(site="cd.step", at=2, kind="device_loss")])
    assert train_main(argv(out)) == 75
    fi.clear()
    other = str(tmp_path / "val_b.avro")
    write_game_avro_fixture(other, data, rows=np.arange(
        len(data.labels) - 30, len(data.labels)))
    with pytest.raises(ResumeMismatch, match="refusing to resume"):
        train_main(argv(out, val_path=other) + ["--auto-resume"])
    assert (out / "RESUME.json").exists()
    assert train_main(argv(out) + ["--auto-resume"]) == 0
    assert not (out / "RESUME.json").exists()


def test_game_device_loss_without_checkpoints_propagates(game_case):
    """Without --checkpoint there is nothing to resume from: the error
    propagates instead of exiting 75."""
    tmp_path, _data, argv = game_case
    args = [a for a in argv(tmp_path / "o") if a != "--checkpoint"]
    fi.install([fi.Fault(site="cd.step", at=0, kind="device_loss")])
    with pytest.raises(torch.AcceleratorError):
        train_main(args)
    assert not (tmp_path / "o" / "RESUME.json").exists()


def test_scoring_driver_exits_75_on_device_loss(monkeypatch, tmp_path):
    def lost(*a, **kw):
        raise cuda_error("cudaErrorAssert", "device-side assert triggered")

    monkeypatch.setattr(game_scoring_driver, "load_game_model", lost)
    argv = ["--data", "absent.avro", "--model-dir", "m", "--output-dir",
            str(tmp_path / "o"), "--device", "cpu"]
    assert game_scoring_driver.main(argv) == 75

    def invalid(*a, **kw):
        raise cuda_error("cudaErrorInvalidValue", "invalid argument")

    monkeypatch.setattr(game_scoring_driver, "load_game_model", invalid)
    with pytest.raises(torch.AcceleratorError):
        game_scoring_driver.main(argv)


# -- flags ------------------------------------------------------------------
def test_entity_shards_must_equal_the_process_count(tmp_path):
    with pytest.raises(SystemExit, match="process count"):
        train_main(["--train-data", str(tmp_path / "nope.avro"),
                    "--output-dir", str(tmp_path / "out"),
                    "--coordinates", '[{"name": "fixed"}]',
                    "--entity-shards", "2", "--device", "cpu"])
    assert not (tmp_path / "out").exists()  # before any data is read
    args = build_arg_parser().parse_args(
        ["--train-data", "x", "--output-dir", "y", "--coordinates", "z",
         "--entity-shards", "1", "--re-table-budget-mb", "64"])
    assert args.entity_shards == 1 and args.re_table_budget_mb == 64.0
    with pytest.raises(SystemExit):
        build_arg_parser().parse_args(
            ["--train-data", "x", "--output-dir", "y", "--coordinates", "z",
             "--entity-shards", "0"])


def test_recovery_flags_defaults_and_validation():
    base = ["--train-data", "x", "--output-dir", "y", "--coordinates", "z"]
    args = build_arg_parser().parse_args(base)
    assert args.max_rank_failures == 0 and args.recovery_snapshot_every == 1
    assert not args.auto_resume
    args = build_arg_parser().parse_args(
        base + ["--max-rank-failures", "2", "--recovery-snapshot-every", "3"])
    assert args.max_rank_failures == 2 and args.recovery_snapshot_every == 3
    g = glm_parser().parse_args(["--train-data", "x", "--output-dir", "y"])
    assert g.max_rank_failures == 0 and g.recovery_snapshot_every == 1
    for parser, argv in ((build_arg_parser(), base),
                         (glm_parser(), ["--train-data", "x",
                                         "--output-dir", "y"])):
        with pytest.raises(SystemExit):
            parser.parse_args(argv + ["--recovery-snapshot-every", "0"])


def _sharded_driver_argv(tmp_path, train, out, n):
    coords = json.dumps([
        {"name": "fixed", "coordinate_type": "fixed",
         "feature_shard": "global", "reg_type": "l2", "reg_weight": 0.5,
         "tolerance": 1e-10, "max_iters": 25},
        {"name": "per-user", "coordinate_type": "random",
         "feature_shard": "entity", "entity_column": "userId",
         "reg_type": "l2", "reg_weight": 1.0, "max_iters": 15,
         "optimizer": "lbfgs", "tolerance": 1e-9},
    ])
    return ["--train-data", train, "--output-dir", str(out),
            "--task", "logistic_regression", "--coordinates", coords,
            "--feature-shards", json.dumps({"global": ["g"],
                                            "entity": ["u"]}),
            "--n-iterations", "3", "--dtype", "float64", "--device", "cpu",
            "--entity-shards", str(n), "--max-rank-failures", "1"]


def _coeff_map(model):
    out = {}
    for b in model.coordinates["per-user"].buckets:
        C, proj = np.asarray(b.coefficients), np.asarray(b.projection)
        for r, eid in enumerate(b.entity_ids):
            valid = proj[r] >= 0
            out[str(eid)] = sorted(zip(proj[r][valid].tolist(),
                                       C[r][valid].tolist()))
    return out


@pytest.mark.slow
def test_game_driver_entity_sharded_recovery(tmp_path):
    """The reference's acceptance run: the training driver with
    ``--entity-shards 4 --max-rank-failures 1`` in 4 simulated processes,
    one killed mid-sweep; the job finishes in-job and saves the model of
    an uninterrupted 4-shard run bit for bit."""
    data = synthetic_game_data({"userId": 8}, seed=4)
    train = str(tmp_path / "train.avro")
    write_game_avro_fixture(train, data)

    def run(out):
        return run_simulated_processes(4, lambda rank: train_main(
            _sharded_driver_argv(tmp_path, train, out, 4)),
            join_timeout=600)

    assert run(tmp_path / "clean") == [0] * 4
    fi.install(fi.crash_schedule((2, "cd.step", 3)))
    crashed = run(tmp_path / "crashed")
    fi.clear()
    assert isinstance(crashed[2], (BaseException, Dropped))
    assert [crashed[r] for r in (0, 1, 3)] == [0, 0, 0]
    ref = load_game_model(str(tmp_path / "clean" / "best"), device="cpu")
    got = load_game_model(str(tmp_path / "crashed" / "best"), device="cpu")
    np.testing.assert_array_equal(
        ref["fixed"].model.coefficients.means.numpy(),
        got["fixed"].model.coefficients.means.numpy())
    assert _coeff_map(ref) == _coeff_map(got)
    assert "in_job_recovery" in _events(tmp_path / "crashed")
