"""Parity of the port's model I/O (``photon_ml_tpu_torch/io/model_io.py``)
with ``photon_ml_tpu/io/model_io.py``: fixed-effect, random-effect and
sketched random-effect models, with variances, saved by either package,
load in the other and score the same (tolerance 1e-12 at float64: the
values cross as doubles, so any difference is the scoring sum's order); two
saves of one model are byte-identical across the packages; and
``interop.game_model_from_numpy`` carries a JAX model across in memory."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu import models as jm
from photon_ml_tpu.game.data import SketchProjection as JSketch
from photon_ml_tpu.io import index_map as jindex
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu.types import SparseFeatures as JSparse
from photon_ml_tpu_torch import models as tm
from photon_ml_tpu_torch.game.data import SketchProjection
from photon_ml_tpu_torch.interop import game_model_from_numpy
from photon_ml_tpu_torch.io import index_map as tindex
from photon_ml_tpu_torch.io import model_io as tio
from photon_ml_tpu_torch.types import SparseFeatures

TOL = 1e-12
DIM = 12  # 11 features and the intercept
KINDS = ["fixed", "random", "sketched"]


def _arrays(kind):
    r = np.random.default_rng({"fixed": 1, "random": 2, "sketched": 3}[kind])
    if kind == "fixed":
        w = r.normal(size=DIM)
        w[[2, 7]] = 0.0  # zeros are not written and load back as zeros
        return {"w": w, "var": r.random(DIM) + 0.1}
    if kind == "random":
        # two buckets of different support sizes; -1 marks padding slots
        return {"buckets": [
            (["u0", "u1"], r.normal(size=(2, 3)),
             np.array([[0, 4, 11], [2, 3, 5]], np.int32),
             r.random((2, 3)) + 0.1),
            (["u2"], r.normal(size=(1, 2)),
             np.array([[1, 9]], np.int32), r.random((1, 2)) + 0.1)]}
    return {"buckets": [(["s0", "s1", "s2"], r.normal(size=(3, 8)),
                         np.full((3, 8), -1, np.int32),
                         r.random((3, 8)) + 0.1)]}


def _model(pkg, kind):
    """The same model in the port (``"port"``) or the JAX package."""
    a = _arrays(kind)
    m = tm if pkg == "port" else jm
    arr = torch.from_numpy if pkg == "port" else jnp.asarray
    if kind == "fixed":
        coord = m.FixedEffectModel(m.GeneralizedLinearModel(
            m.Coefficients(arr(a["w"]), arr(a["var"])), "logistic"))
        return m.GameModel({"global": coord}, task="logistic")
    sketch = None
    if kind == "sketched":
        sketch = (SketchProjection if pkg == "port" else JSketch)(8, seed=3)
    buckets = [m.RandomEffectBucket(list(ids), coef, proj, var, sketch=sketch)
               for ids, coef, proj, var in a["buckets"]]
    coord = m.RandomEffectModel("per_user", buckets, "logistic",
                                entity_column="userId")
    return m.GameModel({"per_user": coord}, task="logistic")


def _index_map(pkg):
    forward = {f"f{i}": i for i in range(DIM - 1)}
    return (tindex if pkg == "port" else jindex).IndexMap(
        forward, add_intercept=True)


def _rows():
    r = np.random.default_rng(9)
    return (r.integers(0, DIM, (40, 4)).astype(np.int32),
            r.normal(size=(40, 4)), r.choice(["u0", "u1", "u2", "s0", "s1",
                                              "s2", "new"], 40))


def _scores(model, pkg):
    """Per-row scores of the model's one coordinate on ``_rows()``: the
    package's own ``score`` for a fixed effect; for a random effect the dot
    of each row with its entity's coefficients (in the global space for a
    subspace model, through the count-sketch for a sketched one)."""
    idx, vals, ents = _rows()
    (name, coord), = model.coordinates.items()
    if name == "global":
        if pkg == "port":
            out = coord.score(SparseFeatures(torch.from_numpy(idx),
                                             torch.from_numpy(vals), DIM))
        else:
            out = coord.score(JSparse(jnp.asarray(idx), jnp.asarray(vals),
                                      dim=DIM))
        return np.asarray(out)
    index = coord.entity_index()
    out = np.zeros(len(ents))
    for i, e in enumerate(ents):
        if e not in index:
            continue
        b, row = index[e]
        bucket = coord.buckets[b]
        if bucket.sketch is not None:
            slots, signs = bucket.sketch.slots_signs(idx[i])
            out[i] = np.sum(vals[i] * signs
                            * np.asarray(bucket.coefficients)[row][slots])
        else:
            w = np.zeros(DIM)
            dense = coord.coefficients_for(e)
            w[:len(dense)] = dense
            out[i] = vals[i] @ w[idx[i]]
    return out


def _variances(model):
    """Variances by entity, in the global feature space (the slot space for
    a sketched effect): the loader regroups buckets by support size."""
    (_, coord), = model.coordinates.items()
    if not hasattr(coord, "buckets"):
        return {None: np.asarray(coord.model.coefficients.variances)}
    out = {}
    for b in coord.buckets:
        var, proj = np.asarray(b.variances), np.asarray(b.projection)
        for row, eid in enumerate(b.entity_ids):
            if b.sketch is not None:
                out[eid] = var[row]
                continue
            dense = np.zeros(DIM)
            dense[proj[row][proj[row] >= 0]] = var[row][proj[row] >= 0]
            out[eid] = dense
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("saved_by", ["port", "jax"])
def test_saved_model_loads_and_scores_the_same_in_the_other(tmp_path, kind,
                                                            saved_by):
    loaded_by = "jax" if saved_by == "port" else "port"
    save = tio.save_game_model if saved_by == "port" else jio.save_game_model
    save(_model(saved_by, kind), str(tmp_path / "m"), _index_map(saved_by))
    if loaded_by == "port":
        loaded = tio.load_game_model(str(tmp_path / "m"), device="cpu")
    else:
        loaded = jio.load_game_model(str(tmp_path / "m"))
    assert loaded.task == "logistic"
    want = _model(loaded_by, kind)
    got_scores, want_scores = (_scores(loaded, loaded_by),
                               _scores(want, loaded_by))
    assert np.abs(want_scores).max() > 0
    np.testing.assert_allclose(got_scores, want_scores, rtol=TOL, atol=TOL)
    got_var, want_var = _variances(loaded), _variances(want)
    assert got_var.keys() == want_var.keys()
    for key, ref in want_var.items():
        np.testing.assert_allclose(got_var[key], ref, rtol=TOL, atol=TOL)


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_saves_are_byte_identical_across_packages(tmp_path, kind):
    tio.save_game_model(_model("port", kind), str(tmp_path / "port"),
                        _index_map("port"))
    jio.save_game_model(_model("jax", kind), str(tmp_path / "jax"),
                        _index_map("jax"))
    port, jax_tree = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert "metadata.json" in port and len(port) == 3
    assert port == jax_tree


@pytest.mark.parametrize("kind", KINDS)
def test_game_model_from_numpy_carries_a_jax_model(kind):
    moved = game_model_from_numpy(_model("jax", kind), device="cpu")
    np.testing.assert_allclose(_scores(moved, "port"),
                               _scores(_model("port", kind), "port"),
                               rtol=TOL, atol=TOL)
    got_var, want_var = _variances(moved), _variances(_model("port", kind))
    assert got_var.keys() == want_var.keys()
    for key, ref in want_var.items():
        np.testing.assert_array_equal(got_var[key], ref)
