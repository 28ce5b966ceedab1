"""The port's hyperparameter tuning (``photon_ml_tpu_torch/tuning/``)
against the JAX package's, at float64 on the CPU.

``gp.py`` and ``search.py`` are copies: the Matérn-5/2 kernel, the fitted
GP and every proposal of ``RandomSearch``/``GaussianProcessSearch`` under
the same seed equal JAX's within 1e-12. ``tune_game`` runs on a small GAME
dataset (20 users, in one size bucket so that the JAX reference compiles
one bucket shape) and ``tune_glm_path`` on a small dense logistic
problem, each JAX run once per module: the rounds' reg weights and
validation metrics within 1e-6 relative of JAX's (the fits themselves
agree to about 1e-12; the GP's proposal is an argmax over a seeded
candidate pool, so it matches exactly unless two candidates' expected
improvements tie within the metrics' noise, which the equal reg weights
asserted here rule out for this data)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.estimators import (
    GameEstimator as JaxGameEstimator, GlmPathEstimator as JaxPathEstimator,
)
from photon_ml_tpu.game.descent import (
    CoordinateConfig as JaxConfig, make_game_dataset as jax_dataset,
)
from photon_ml_tpu.optimize import (
    OptimizerConfig as JaxOptConfig, PathConfig as JaxPathConfig,
)
from photon_ml_tpu.tuning import gp as jax_gp, search as jax_search
from photon_ml_tpu.tuning import tune_game as jax_tune_game
from photon_ml_tpu.tuning import tune_glm_path as jax_tune_path
from photon_ml_tpu.types import make_batch as jax_batch
from photon_ml_tpu_torch.estimators import GameEstimator, GlmPathEstimator
from photon_ml_tpu_torch.game.descent import CoordinateConfig
from photon_ml_tpu_torch.interop import game_dataset_from_numpy
from photon_ml_tpu_torch.optimize import OptimizerConfig, PathConfig
from photon_ml_tpu_torch.tuning import (
    GaussianProcessSearch, ParamRange, RandomSearch, fit_gp, matern52,
    resolve_tuned_coordinates, tune_game, tune_glm_path,
)
from photon_ml_tpu_torch.types import make_batch

TOL_COPY = 1e-12
TOL_TUNE = 1e-6


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.allclose(a, b, rtol=tol, atol=tol)


def test_matern52_and_fit_gp_equal_jax():
    r = np.random.default_rng(0)
    x1, x2 = r.random((7, 3)), r.random((5, 3))
    for ls, amp in ((0.3, 1.0), (1.7, 2.5)):
        assert _close(matern52(x1, x2, ls, amp),
                      jax_gp.matern52(x1, x2, ls, amp), TOL_COPY)
    y = np.sin(6 * x1[:, 0]) + 0.1 * x1[:, 1]
    got, want = fit_gp(x1, y), jax_gp.fit_gp(x1, y)
    assert (got.lengthscale, got.noise) == (want.lengthscale, want.noise)
    for name in ("alpha", "chol"):
        assert _close(getattr(got, name), getattr(want, name), TOL_COPY)
    q = r.random((11, 3))
    for a, b in zip(got.predict(q), want.predict(q)):
        assert _close(a, b, TOL_COPY)


def _objective(params):
    """A smooth metric with its peak inside the box."""
    return -(np.log10(params["a"]) - 0.7) ** 2 - 0.5 * (params["b"] - 3.0) ** 2


@pytest.mark.parametrize("mode, batch", [("random", 1), ("bayesian", 1),
                                         ("bayesian", 3)])
def test_search_proposals_equal_jax(mode, batch):
    """The same seed, priors and evaluation function give the same
    observations in both packages, round by round."""
    def run(pkg):
        cls = {("port", "random"): RandomSearch,
               ("port", "bayesian"): GaussianProcessSearch,
               ("jax", "random"): jax_search.RandomSearch,
               ("jax", "bayesian"): jax_search.GaussianProcessSearch}[
            pkg, mode]
        rng_cls = ParamRange if pkg == "port" else jax_search.ParamRange
        ranges = [rng_cls("a", 1e-3, 1e3, log=True),
                  rng_cls("b", 0.0, 10.0, integer=True)]
        s = cls(ranges, _objective, seed=3, maximize=True)
        s.on_prior_observation({"a": 1.0, "b": 2}, _objective({"a": 1.0,
                                                               "b": 2}))
        s.find(4, batch=batch, eval_order=lambda p: -p["a"])
        return s.observations, s.best()

    (got, got_best), (want, want_best) = run("port"), run("jax")
    assert len(got) == len(want) == 1 + 4 * batch
    for o, w in zip(got, want):
        assert o.params.keys() == w.params.keys()
        for k in w.params:
            assert _close(o.params[k], w.params[k], TOL_COPY)
        assert _close(o.value, w.value, TOL_COPY)
    assert _close(got_best.value, want_best.value, TOL_COPY)


def test_param_range_rejects_bad_bounds():
    with pytest.raises(ValueError, match="high > low"):
        ParamRange("x", 1.0, 1.0)
    with pytest.raises(ValueError, match="low > 0"):
        ParamRange("x", 0.0, 1.0, log=True)
    with pytest.raises(ValueError, match="duplicate"):
        RandomSearch([ParamRange("x", 0, 1), ParamRange("x", 0, 2)], _objective)


def _synth(seed, n_users=20, d_g=5, d_u=3):
    rng = np.random.default_rng(seed)
    w_fixed = rng.normal(size=d_g)
    U = rng.normal(size=(n_users, d_u))
    Xg, Xu, y, uid = [], [], [], []
    for u in range(n_users):
        m = int(rng.integers(10, 20))
        xg, xu = rng.normal(size=(m, d_g)), rng.normal(size=(m, d_u))
        marg = xg @ w_fixed + xu @ U[u]
        y.append((rng.random(m) < 1 / (1 + np.exp(-marg))).astype(float))
        Xg.append(xg)
        Xu.append(xu)
        uid.append(np.full(m, u))
    Xg, Xu, y, uid = map(np.concatenate, (Xg, Xu, y, uid))
    return jax_dataset({"g": Xg, "u": Xu}, y, entity_ids={"userId": uid})


def _game_configs(Config):
    return [Config("fixed", feature_shard="g", reg_type="l2", reg_weight=1.0,
                   tolerance=1e-10),
            Config("per-user", coordinate_type="random", feature_shard="u",
                   entity_column="userId", reg_type="l2", reg_weight=1.0,
                   tolerance=1e-10, max_iters=50, num_buckets=1)]


@pytest.fixture(scope="module")
def game_runs():
    """(JAX rounds, port rounds) of a grid fit then 2 Bayesian rounds
    tuning only the random coordinate, then 1 random round tuning both."""
    train, val = _synth(0), _synth(1)
    data = {"jax": (train, val),
            "port": (game_dataset_from_numpy(train),
                     game_dataset_from_numpy(val))}
    out = {}
    for pkg, Est, Config, tune in (
            ("jax", JaxGameEstimator, JaxConfig, jax_tune_game),
            ("port", GameEstimator, CoordinateConfig, tune_game)):
        kw = (dict(dtype=jnp.float64) if pkg == "jax"
              else dict(dtype=torch.float64, device="cpu"))
        est = Est(task="logistic", n_iterations=2, evaluators=["auc"], **kw)
        tr, va = data[pkg]
        base = _game_configs(Config)
        grid = est.fit(tr, va, config_grid=[base])
        seen = []
        bayes = tune(est, tr, va, base, n_iterations=2, mode="bayesian",
                     reg_range=(1e-2, 1e2), prior_results=grid, seed=1,
                     tuned_coordinates=["per-user"],
                     fit_callback=lambda i, r: seen.append(i))
        rand = tune(est, tr, va, base, n_iterations=1, mode="random",
                    reg_range=(1e-2, 1e2), seed=2)
        out[pkg] = (grid + bayes + rand, seen)
    return out


def test_tune_game_rounds_match_jax(game_runs):
    (got, seen), (want, _) = game_runs["port"], game_runs["jax"]
    assert seen == [0, 1]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        gw = {c.name: c.reg_weight for c in g.configs}
        ww = {c.name: c.reg_weight for c in w.configs}
        assert gw.keys() == ww.keys()
        for k in ww:
            assert _close(gw[k], ww[k], TOL_TUNE), (k, gw[k], ww[k])
        assert _close(g.evaluation.metrics["auc"],
                      w.evaluation.metrics["auc"], TOL_TUNE)
    # the Bayesian rounds moved only the tuned coordinate
    assert {c.reg_weight for r in got[1:3] for c in r.configs
            if c.name == "fixed"} == {1.0}


def test_tune_game_validates_inputs():
    base = _game_configs(CoordinateConfig)
    with pytest.raises(ValueError, match="not in configs"):
        resolve_tuned_coordinates(base, ["nope"])
    with pytest.raises(ValueError, match="no coordinates"):
        resolve_tuned_coordinates(base, None, locked=["fixed", "per-user"])
    assert resolve_tuned_coordinates(base, None, locked=["fixed"]) == \
        ["per-user"]
    est = GameEstimator(device="cpu")
    with pytest.raises(ValueError, match="at least one evaluator"):
        tune_game(est, None, None, base, 1)
    with pytest.raises(ValueError, match="random|bayesian"):
        tune_game(GameEstimator(evaluators=["auc"], device="cpu"), None,
                  None, base, 1, mode="grid")


def _path_data(seed, n=300, d=12):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, d))
    x[:, 0] = 1.0
    w = np.zeros(d)
    w[[2, 5, 7]] = [1.5, -2.0, 1.0]
    y = (r.random(n) < 1 / (1 + np.exp(-(x @ w)))).astype(float)
    return x, y


@pytest.fixture(scope="module")
def path_runs():
    """(JAX trials, port trials): 2 Bayesian rounds, then 1 random round
    of 2 lambdas walked in decreasing order, over one estimator."""
    (x, y), (xv, yv) = _path_data(0), _path_data(1)
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            est = JaxPathEstimator(
                task="logistic", evaluators=["auc"], intercept_index=0,
                dtype=jnp.float64, config=JaxOptConfig(tolerance=1e-10),
                path_config=JaxPathConfig(min_bucket=8))
            batch = jax_batch(x, y, dtype=jnp.float64)
            val = jax_batch(xv, yv, dtype=jnp.float64)
            tune = jax_tune_path
        else:
            est = GlmPathEstimator(
                task="logistic", evaluators=["auc"], intercept_index=0,
                device="cpu", config=OptimizerConfig(tolerance=1e-10),
                path_config=PathConfig(min_bucket=8))
            batch = make_batch(x, y, dtype=torch.float64, device="cpu")
            val = make_batch(xv, yv, dtype=torch.float64, device="cpu")
            tune = tune_glm_path
        trials = tune(est, 2, batch=batch, validation_batch=val,
                      reg_range=(1e-2, 1e2), seed=0)
        trials += tune(est, 1, batch=batch, validation_batch=val,
                       mode="random", reg_range=(1e-2, 1e2), seed=4,
                       round_size=2, prior_results=trials)
        out[pkg] = trials
    return out


def test_tune_glm_path_trials_match_jax(path_runs):
    got, want = path_runs["port"], path_runs["jax"]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert _close(g.reg_weight, w.reg_weight, TOL_TUNE)
        assert _close(g.metrics["auc"], w.metrics["auc"], TOL_TUNE)
    # the random round walks its two lambdas in decreasing order
    assert got[2].reg_weight > got[3].reg_weight


def test_tune_glm_path_deferred_and_invalid():
    est = GlmPathEstimator(evaluators=["auc"], device="cpu")
    with pytest.raises(ValueError, match="validation batch"):
        tune_glm_path(est, 1, batch=object())
    with pytest.raises(ValueError, match="at least one evaluator"):
        tune_glm_path(GlmPathEstimator(device="cpu"), 1)


def test_tune_glm_path_over_chunks_matches_the_batch(path_runs):
    """``tune_glm_path(chunks=)``: the same two Bayesian rounds over the
    training rows as host chunks streamed through the path solver give
    the in-memory tuner's trials (reg weights and AUCs within 1e-6)."""
    from photon_ml_tpu_torch.parallel.streaming import make_host_chunks

    (x, y), (xv, yv) = _path_data(0), _path_data(1)
    chunks, dim = make_host_chunks(x, y, chunk_rows=128)
    est = GlmPathEstimator(
        task="logistic", evaluators=["auc"], intercept_index=0,
        device="cpu", dtype=torch.float64,
        config=OptimizerConfig(tolerance=1e-10),
        path_config=PathConfig(min_bucket=8))
    val = make_batch(xv, yv, dtype=torch.float64, device="cpu")
    trials = tune_glm_path(est, 2, chunks=chunks, dim=dim,
                           validation_batch=val, reg_range=(1e-2, 1e2),
                           seed=0)
    for got, want in zip(trials, path_runs["port"][:2]):
        assert _close(got.reg_weight, want.reg_weight, 1e-6)
        assert _close(got.metrics["auc"], want.metrics["auc"], 1e-6)
