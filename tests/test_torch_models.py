"""Parity of the port's model containers with ``photon_ml_tpu/models``:
``score`` and ``predict_mean`` of a GLM and a fixed-effect model over
sparse, implicit-ones and dense features for each task, and the
random-effect and GAME containers' host-side lookups. Inputs: 80 rows, 20
columns, made from a seed, f64. Tolerance: rtol 1e-12 (the packages sum
each row's terms in a different order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu import models as jm
from photon_ml_tpu.types import SparseFeatures as JSparse
from photon_ml_tpu_torch import models as tm
from photon_ml_tpu_torch.types import SparseFeatures

RTOL = 1e-12


def _features(kind, r, n=80, dim=20, k=4):
    idx = r.integers(0, dim, (n, k)).astype(np.int32)
    vals = r.normal(size=(n, k))
    if kind == "dense":
        X = r.normal(size=(n, dim))
        return jnp.asarray(X), torch.from_numpy(X)
    vals = None if kind == "implicit_ones" else vals
    return (JSparse(jnp.asarray(idx),
                    None if vals is None else jnp.asarray(vals), dim=dim),
            SparseFeatures(torch.from_numpy(idx),
                           None if vals is None else torch.from_numpy(vals),
                           dim))


@pytest.mark.parametrize("task", ["logistic", "poisson", "squared",
                                  "smoothed_hinge"])
@pytest.mark.parametrize("kind", ["sparse", "implicit_ones", "dense"])
def test_score_and_predict_mean_match(kind, task):
    r = np.random.default_rng(5)
    jf, tf = _features(kind, r)
    w = r.normal(size=20) * 0.3
    offsets = r.normal(size=80) * 0.1
    jglm = jm.GeneralizedLinearModel(jm.Coefficients(jnp.asarray(w)), task)
    tglm = tm.GeneralizedLinearModel(tm.Coefficients(torch.from_numpy(w)),
                                     task)
    assert tglm.coefficients.dim == jglm.coefficients.dim == 20
    for got, want in (
            (tglm.score(tf), jglm.score(jf)),
            (tglm.score(tf, torch.from_numpy(offsets)),
             jglm.score(jf, jnp.asarray(offsets))),
            (tglm.predict_mean(tf, torch.from_numpy(offsets)),
             jglm.predict_mean(jf, jnp.asarray(offsets))),
            (tm.FixedEffectModel(tglm).score(tf),
             jm.FixedEffectModel(jglm).score(jf))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=RTOL)


def test_random_effect_and_game_containers_match():
    r = np.random.default_rng(6)
    coef = r.normal(size=(3, 4))
    proj = np.array([[0, 5, 7, -1], [2, 3, -1, -1], [-1, -1, -1, -1]],
                    np.int32)
    ids = ["a", "b", "c"]
    jre = jm.RandomEffectModel("per_user", [jm.RandomEffectBucket(
        ids, jnp.asarray(coef), jnp.asarray(proj))], entity_column="uid")
    tre = tm.RandomEffectModel("per_user", [tm.RandomEffectBucket(
        ids, torch.from_numpy(coef), torch.from_numpy(proj))],
        entity_column="uid")
    assert tre.entity_index() == jre.entity_index()
    assert tre.num_entities == jre.num_entities == 3
    for eid in ids + ["missing"]:
        got, want = tre.coefficients_for(eid), jre.coefficients_for(eid)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
    fixed = tm.FixedEffectModel(tm.GeneralizedLinearModel(
        tm.Coefficients(torch.zeros(8, dtype=torch.float64))))
    game = tm.GameModel({"global": fixed, "per_user": tre}, task="poisson")
    assert game["per_user"] is tre and game.loss.name == "poisson"
    assert list(game.coordinates) == ["global", "per_user"]
