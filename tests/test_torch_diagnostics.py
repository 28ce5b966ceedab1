"""Parity of the port's feature summary (``ops/statistics.py``) and
diagnostics (``diagnostics.py``) with the JAX package, on data made from a
seed with numpy (f64). Tolerances: 1e-12 for ``summarize_features`` (both
accumulate on the host in float64, in the same order); exact for
``hosmer_lemeshow`` and ``feature_importance`` (copies over numpy); 1e-6
relative L2 for a bootstrap replicate (two L-BFGS loops in two packages
over the same reweighted batch, compounded over 15 iterations)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu import diagnostics as jdiag
from photon_ml_tpu.ops.objective import make_objective as j_make_objective
from photon_ml_tpu.ops.statistics import summarize_features as j_summarize
from photon_ml_tpu.optimize import OptimizerConfig as JConfig
from photon_ml_tpu.optimize.lbfgs import lbfgs as j_lbfgs
from photon_ml_tpu.types import SparseFeatures as JSparse
from photon_ml_tpu.types import make_batch as j_make_batch
from photon_ml_tpu_torch import diagnostics
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.ops.statistics import summarize_features
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.types import SparseFeatures, make_batch

TOL_SUMMARY = 1e-12
TOL_BOOT = 1e-6
N, DIM, K = 200, 15, 5


def _data(layout, seed=0):
    r = np.random.default_rng(seed)
    idx = r.integers(0, DIM - 1, (N, K)).astype(np.int32)
    vals = None if layout == "implicit_ones" else r.normal(size=(N, K)) * 3
    if layout == "explicit_values":
        vals[r.random((N, K)) < 0.2] = 0.0  # padding slots
    labels = (r.random(N) < 0.4).astype(float)
    return idx, vals, labels


def _batches(layout, seed=0):
    idx, vals, labels = _data(layout, seed)
    if layout == "dense":
        X = np.zeros((N, DIM))
        np.add.at(X, (np.arange(N)[:, None], idx), 1.0)
        X[:, 3] += 50.0  # a large-mean column
        return (make_batch(X, labels, dtype=torch.float64, device="cpu"),
                j_make_batch(jnp.asarray(X), labels, dtype=jnp.float64))
    tv = None if vals is None else torch.from_numpy(vals)
    jv = None if vals is None else jnp.asarray(vals)
    return (make_batch(SparseFeatures(torch.from_numpy(idx), tv, DIM), labels,
                       dtype=torch.float64, device="cpu"),
            j_make_batch(JSparse(jnp.asarray(idx), jv, dim=DIM), labels,
                         dtype=jnp.float64))


@pytest.mark.parametrize("layout", ["implicit_ones", "explicit_values",
                                    "dense"])
def test_summarize_features_matches(layout):
    batch, jbatch = _batches(layout)
    got, want = summarize_features(batch), j_summarize(jbatch)
    assert got.count == want.count == N and got.dim == want.dim == DIM
    for field in ("mean", "variance", "std", "min", "max", "num_nonzeros"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=TOL_SUMMARY, atol=TOL_SUMMARY,
                                   err_msg=field)


def test_hosmer_lemeshow_and_feature_importance_match_exactly():
    r = np.random.default_rng(4)
    probs = r.random(300)
    labels = (r.random(300) < probs).astype(float)
    for n_bins in (10, 7):
        assert (diagnostics.hosmer_lemeshow(probs, labels, n_bins)
                == jdiag.hosmer_lemeshow(probs, labels, n_bins))
    w = r.normal(size=40)
    std = r.random(40)
    for feature_std, top_k in ((None, None), (std, 10)):
        got = diagnostics.feature_importance(w, feature_std, top_k)
        want = jdiag.feature_importance(w, feature_std, top_k)
        np.testing.assert_array_equal(got["index"], want["index"])
        np.testing.assert_array_equal(got["score"], want["score"])


def test_bootstrap_replicate_matches_jax_lbfgs_on_the_same_counts():
    batch, jbatch = _batches("explicit_values", seed=1)
    r = np.random.default_rng(7)
    counts = r.multinomial(N, np.full(N, 1.0 / N), size=2).astype(float)
    w_hat = r.normal(size=DIM) * 0.1
    l2 = 1.0
    got = diagnostics.bootstrap_replicate_fits(
        make_objective("logistic"), batch, torch.from_numpy(w_hat),
        torch.from_numpy(counts), l2=l2,
        config=OptimizerConfig(max_iters=15, tolerance=0.0)).numpy()
    jobj = j_make_objective("logistic")
    for rep in range(2):
        b = jbatch.replace(weights=jbatch.weights * jnp.asarray(counts[rep]))
        want = np.asarray(j_lbfgs(
            lambda w: jobj.value_and_grad(w, b, l2), jnp.asarray(w_hat),
            JConfig(max_iters=15, tolerance=0.0)).w)
        rel = np.linalg.norm(got[rep] - want) / np.linalg.norm(want)
        assert rel <= TOL_BOOT
        assert np.linalg.norm(want - w_hat) > 0.1  # the fit moved


def test_bootstrap_counts_and_intervals():
    batch, _ = _batches("explicit_values", seed=2)
    gen = torch.Generator().manual_seed(3)
    counts = diagnostics.bootstrap_counts(N, 4, gen)
    assert counts.shape == (4, N)
    assert torch.all(counts.sum(dim=1) == N)
    assert torch.all(counts == counts.round()) and torch.all(counts >= 0)
    again = diagnostics.bootstrap_counts(N, 4,
                                         torch.Generator().manual_seed(3))
    assert torch.equal(counts, again)
    cfg = OptimizerConfig(max_iters=5, tolerance=0.0)
    obj = make_objective("logistic")
    w_hat = torch.zeros(DIM, dtype=torch.float64)
    out = diagnostics.bootstrap_coefficients(obj, batch, w_hat, l2=1.0,
                                             n_replicates=4, seed=3,
                                             config=cfg)
    assert out["replicates"].shape == (4, DIM)
    np.testing.assert_array_equal(
        out["replicates"],
        diagnostics.bootstrap_replicate_fits(obj, batch, w_hat, counts, 1.0,
                                             cfg).numpy())
    assert np.all(out["lower"] <= out["upper"])
    assert dataclasses.is_dataclass(batch)
