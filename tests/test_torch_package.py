"""Package rules of the port: it imports neither ``jax`` nor
``photon_ml_tpu`` (checked in the source and in a fresh interpreter), and
its entry points refuse to run without CUDA unless given ``device="cpu"``."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch import interop, types
from photon_ml_tpu_torch.ops import normalization

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "photon_ml_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
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
    "build_normalization_context": lambda device:
        normalization.build_normalization_context(
            "scale_with_standard_deviation", _Summary(), device=device),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_need_cuda_unless_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]("cuda")
    assert ENTRY_POINTS[name]("cpu") is not None
