"""Package rules of the port: it imports neither ``jax``, ``flax`` nor
``photon_ml_tpu`` (checked in the source of every module and in a fresh
interpreter that imports them all), and its entry points refuse to run
without CUDA unless given ``device="cpu"``."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch import interop, types
from photon_ml_tpu_torch.evaluation import device as evaluation
from photon_ml_tpu_torch.game.data import HostSparse
from photon_ml_tpu_torch.models import (
    Coefficients, FixedEffectModel, GameModel, GeneralizedLinearModel,
)
from photon_ml_tpu_torch.ops import normalization
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.optimize.common import OptimizerConfig
from photon_ml_tpu_torch.parallel.data_parallel import fit_distributed
from photon_ml_tpu_torch.parallel.streaming import (
    fit_streaming, make_host_chunks, streaming_coefficient_variances,
    streaming_value_and_grad,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "photon_ml_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_multiprocess_worker.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "photon_ml_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_every_module_is_checked():
    """The checks above walk the package, so every module of each slice is
    covered; this pins the ones that must be there."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("types", "interop", "ops/objective", "ops/regularization",
                   "ops/kernels", "optimize/owlqn", "optimize/tron",
                   "optimize/linesearch", "parallel/data_parallel",
                   "evaluation/evaluators", "evaluation/device",
                   "models/glm", "game/data", "io/avro", "io/data_reader",
                   "io/native_reader", "io/paldb", "io/model_io",
                   "native/__init__", "ops/statistics", "diagnostics",
                   "cli/glm_driver", "optimize/path", "optimize/batched",
                   "game/random_effect", "game/descent", "game/scoring",
                   "game/sampling", "estimators", "tuning/__init__",
                   "tuning/gp", "tuning/search", "tuning/game_tuner",
                   "io/durable", "cli/feature_indexing_driver",
                   "cli/game_training_driver", "cli/game_scoring_driver",
                   "cli/_common", "parallel/streaming", "io/stream_source",
                   "io/chunk_cache", "utils/transfer_budget",
                   "parallel/mesh", "parallel/multihost"):
        assert f"photon_ml_tpu_torch/{module}.py" in names, module
    assert "tests/torch_multiprocess_worker.py" in names


def test_import_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "photon_ml_tpu_torch").rglob("*.py")
        if p.name != "__init__.py") + ["chip_smoke"]
    code = (f"import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"print(sorted(m for m in sys.modules "
            f"if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


class _Summary:
    mean = std = max = min = np.ones(3)


def _fit(optimizer):
    """A two-iteration fit of a tiny batch built on ``device``."""
    def run(device):
        batch = interop.batch_from_numpy(
            np.array([[0, 1], [1, 2], [2, 0]], np.int32), None,
            np.array([1.0, 0.0, 1.0]), dim=3, device=device)
        w0 = interop.w_from_numpy(np.zeros(3), device=device)
        return fit_distributed(make_objective("logistic"), batch, w0, l2=1.0,
                               l1=0.1, optimizer=optimizer,
                               config=OptimizerConfig(max_iters=2),
                               line_search="full")

    return run


_SCORES = (np.array([0.1, 0.7, 0.3, 0.9]), np.array([0.0, 1.0, 0.0, 1.0]))


def _game():
    """A four-row GAME dataset with one user per pair of rows, and its
    per-user random-effect data."""
    from photon_ml_tpu_torch.game.data import (
        build_random_effect_data, build_score_view,
    )
    from photon_ml_tpu_torch.game.descent import make_game_dataset

    x = np.array([[1.0, 0.5], [0.2, 1.0], [1.0, -0.3], [0.4, 0.1]])
    ds = make_game_dataset({"global": x}, _SCORES[1],
                           entity_ids={"user": np.array([0, 0, 1, 1])})
    data = build_random_effect_data(x, ds.labels, ds.weights,
                                    ds.entity_ids["user"])
    return ds, data, build_score_view(data, x, ds.entity_ids["user"])


def _game_entry(name):
    from photon_ml_tpu_torch import estimators
    from photon_ml_tpu_torch.game import descent, random_effect, scoring

    cfgs = [descent.CoordinateConfig("fixed", max_iters=2),
            descent.CoordinateConfig("per_user", coordinate_type="random",
                                     entity_column="user", max_iters=2)]

    def run(device):
        ds, data, view = _game()
        if name == "train_random_effect":
            return random_effect.train_random_effect(
                data, np.zeros(4), config=OptimizerConfig(max_iters=2),
                device=device)
        if name == "score_random_effect":
            return random_effect.score_random_effect(
                view, [np.ones((b.num_entities, b.local_dim))
                       for b in data.buckets], 4, device=device)
        model = descent.CoordinateDescent(cfgs, device="cpu").run(ds)[0]
        if name == "CoordinateDescent":
            return descent.CoordinateDescent(cfgs, device=device)
        if name == "GameEstimator":
            return estimators.GameEstimator(device=device)
        if name == "GameTransformer":
            return estimators.GameTransformer(model, device=device)
        if name == "GlmPathEstimator":
            return estimators.GlmPathEstimator(device=device)
        return scoring.score_game_model(model, ds.features, ds.entity_ids,
                                        device=device)

    return run


def _game_driver(name):
    """The GAME training or scoring driver on a 40-row Avro fixture of 4
    users (the scoring driver scores a model trained on the CPU)."""
    def run(device):
        import json
        import tempfile

        from photon_ml_tpu_torch.cli import (
            game_scoring_driver, game_training_driver,
        )
        from photon_ml_tpu_torch.io.data_reader import (
            write_training_examples,
        )

        dev = [] if device is None else ["--device", device]
        r = np.random.default_rng(0)
        with tempfile.TemporaryDirectory() as root:
            data = f"{root}/train.avro"
            write_training_examples(
                data, ([(f"f{j}", "", float(v)) for j, v in enumerate(row)]
                       for row in r.normal(size=(40, 3))),
                (r.random(40) < 0.5).astype(float),
                entity_ids={"user": np.arange(40) % 4})
            coords = json.dumps([
                {"name": "fixed", "max_iters": 2},
                {"name": "per_user", "coordinate_type": "random",
                 "entity_column": "user", "max_iters": 2}])
            train = ["--train-data", data, "--coordinates", coords]
            if name == "game_training_driver":
                return game_training_driver.main(
                    train + ["--output-dir", f"{root}/t", *dev])
            game_training_driver.main(train + ["--output-dir", f"{root}/t",
                                               "--device", "cpu"])
            return game_scoring_driver.main(
                ["--data", data, "--model-dir", f"{root}/t/best",
                 "--output-dir", f"{root}/s", *dev])

    return run


def _chunks():
    return make_host_chunks(
        HostSparse(np.array([[0, 1], [1, 2], [2, 0]], np.int32), None, 3),
        np.array([1.0, 0.0, 1.0]), chunk_rows=2)[0]


ENTRY_POINTS = {
    "make_batch": lambda device: types.make_batch(
        np.ones((2, 3)), np.ones(2), device=device),
    "batch_from_numpy": lambda device: interop.batch_from_numpy(
        np.zeros((2, 1), np.int32), None, np.ones(2), dim=3, device=device),
    "csc_from_numpy": lambda device: interop.csc_from_numpy(
        None, np.zeros(2, np.int32), np.array([0, 2], np.int32),
        device=device),
    "normalization_from_numpy": lambda device:
        interop.normalization_from_numpy(np.ones(3), None, device=device),
    "w_from_numpy": lambda device: interop.w_from_numpy(np.ones(3),
                                                        device=device),
    "batch_from_host_sparse": lambda device: interop.batch_from_host_sparse(
        HostSparse(np.zeros((2, 1), np.int32), np.ones((2, 1)), 3),
        np.ones(2), device=device),
    "game_model_from_numpy": lambda device: interop.game_model_from_numpy(
        GameModel({"global": FixedEffectModel(GeneralizedLinearModel(
            Coefficients(np.ones(3))))}), device=device),
    "build_normalization_context": lambda device:
        normalization.build_normalization_context(
            "scale_with_standard_deviation", _Summary(), device=device),
    "sparse_from_scipy": lambda device: types.sparse_from_scipy(
        np.eye(3), device=device),
    "sparse_from_rows": lambda device: types.sparse_from_rows(
        [[(0, 1.0)], [(2, 0.5)]], 3, device=device),
    "fit_distributed[lbfgs]": _fit("lbfgs"),
    "fit_distributed[owlqn]": _fit("owlqn"),
    "fit_distributed[tron]": _fit("tron"),
    "device_auc": lambda device: evaluation.device_auc(*_SCORES,
                                                       device=device),
    "histogram_auc": lambda device: evaluation.histogram_auc(*_SCORES,
                                                             device=device),
    "make_device_evaluator": lambda device:
        evaluation.make_device_evaluator("auc", device=device),
    "make_grouped_device_evaluator": lambda device:
        evaluation.make_grouped_device_evaluator(
            "per_group_auc", [0, 0, 1, 1], device=device),
    **{name: _game_entry(name) for name in (
        "train_random_effect", "score_random_effect", "CoordinateDescent",
        "GameEstimator", "GameTransformer", "GlmPathEstimator",
        "score_game_model")},
    **{name: _game_driver(name) for name in (
        "game_training_driver", "game_scoring_driver")},
    "fit_streaming": lambda device: fit_streaming(
        make_objective("logistic"), _chunks(), 3,
        config=OptimizerConfig(max_iters=2), device=device),
    "streaming_value_and_grad": lambda device: streaming_value_and_grad(
        make_objective("logistic"), _chunks(), 3, device=device),
    "streaming_coefficient_variances": lambda device:
        streaming_coefficient_variances(make_objective("logistic"),
                                        _chunks(), 3, np.zeros(3),
                                        device=device),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_need_cuda_unless_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]("cuda")
    assert ENTRY_POINTS[name]("cpu") is not None
