"""Parity of the port's evaluation with the JAX package: the on-device
metrics of ``evaluation/device.py`` against JAX's and against the host
float64 evaluators, and the host evaluators (a copy) against the JAX
package's. Inputs: 600 scores made from a seed, rounded so that many tie,
with weighted rows and 6 groups, one of them single-class. The rows'
weights are positive, or positive with every 13th row 0 (padding); the
host evaluators are held only to positive weights, since a tied block of
weight 0 gives them and JAX's device forms different NaN patterns. Tolerances: 1e-12 for the exact metrics
(``device_auc``, the grouped and pointwise evaluators), the same for the
histogram AUC against JAX's (both bin the same scores)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.evaluation import device as jd
from photon_ml_tpu.evaluation import evaluators as je
from photon_ml_tpu_torch.evaluation import device as td
from photon_ml_tpu_torch.evaluation import evaluators as te

TOL = 1e-12


@pytest.fixture(scope="module", params=["positive", "with_zeros"])
def scored(request):
    r = np.random.default_rng(4)
    n = 600
    labels = (r.random(n) < 0.4).astype(float)
    scores = np.round(r.normal(size=n) + labels, 1)  # many ties
    weights = r.random(n) + 0.2
    if request.param == "with_zeros":
        weights[::13] = 0.0
    groups = r.integers(0, 7, n)
    groups[groups == 6] = 5  # six groups
    labels[groups == 3] = 1.0  # a single-class group: nan, skipped
    return scores, labels, weights, groups, request.param == "positive"


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def test_device_auc_matches(scored):
    scores, labels, weights, _, positive = scored
    got = float(td.device_auc(_t(scores), _t(labels), _t(weights)))
    want = float(jd.device_auc(jnp.asarray(scores), jnp.asarray(labels),
                               jnp.asarray(weights)))
    assert abs(got - want) <= TOL
    if positive:
        assert abs(got - je.auc(scores, labels, weights)) <= TOL
    # numpy inputs go to the named device
    again = td.device_auc(scores, labels, weights, device="cpu")
    assert float(again) == got
    assert np.isnan(float(td.device_auc(_t(scores), _t(np.ones(600)),
                                        _t(weights))))


def test_histogram_auc_matches(scored):
    scores, labels, weights, _, positive = scored
    got = float(td.histogram_auc(_t(scores), _t(labels), _t(weights),
                                 n_bins=64))
    want = float(jd.histogram_auc(jnp.asarray(scores), jnp.asarray(labels),
                                  jnp.asarray(weights), n_bins=64))
    assert abs(got - want) <= TOL
    if positive:  # 4096 bins: close to the exact AUC
        fine = float(td.histogram_auc(_t(scores), _t(labels), _t(weights)))
        assert abs(fine - je.auc(scores, labels, weights)) <= 1e-3


POINTWISE = ["auc", "rmse", "logistic_loss", "poisson_loss", "squared_loss",
             "smoothed_hinge_loss", "precision_at_10"]


@pytest.mark.parametrize("name", POINTWISE)
def test_device_evaluators_match(scored, name):
    scores, labels, weights, _, positive = scored
    if name.startswith("precision"):  # distinct scores: no tie at the top
        scores = scores + np.arange(scores.size) * 1e-6
    got = float(td.make_device_evaluator(name, device="cpu")(
        _t(scores), _t(labels), _t(weights)))
    want = float(jd.make_device_evaluator(name)(
        jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(weights)))
    assert abs(got - want) <= TOL * max(abs(want), 1.0)
    if positive:
        host = te.get_evaluator(name).evaluate(scores, labels, weights)
        assert abs(got - host) <= 1e-10 * max(abs(host), 1.0)


GROUPED = ["per_group_auc", "per_group_rmse", "per_group_logistic_loss",
           "per_group_precision_at_5", "per_group_smoothed_hinge_loss"]


@pytest.mark.parametrize("name", GROUPED)
def test_grouped_device_evaluators_match(scored, name):
    scores, labels, weights, groups, positive = scored
    if "precision" in name:
        scores = scores + np.arange(scores.size) * 1e-6
    got = float(td.make_grouped_device_evaluator(name, groups,
                                                 device="cpu")(
        _t(scores), _t(labels), _t(weights)))
    want = float(jd.make_grouped_device_evaluator(name, groups)(
        jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(weights)))
    assert abs(got - want) <= TOL * max(abs(want), 1.0)
    if positive:
        host = te.get_evaluator(name).evaluate(scores, labels, weights,
                                               group_ids=groups)
        assert abs(got - host) <= 1e-10 * max(abs(host), 1.0)


def test_no_device_form():
    assert td.make_device_evaluator("per_group_auc", device="cpu") is None
    assert td.make_grouped_device_evaluator("auc", [0, 1],
                                            device="cpu") is None
    assert td.make_grouped_device_evaluator("per_group_bogus", [0, 1],
                                            device="cpu") is None


@pytest.mark.parametrize("name", POINTWISE + GROUPED)
def test_host_evaluators_match(scored, name):
    """The copied host evaluators give the JAX package's values."""
    scores, labels, weights, groups, positive = scored
    got = te.get_evaluator(name).evaluate(scores, labels, weights,
                                          group_ids=groups)
    want = je.get_evaluator(name).evaluate(scores, labels, weights,
                                           group_ids=groups)
    assert got == want or (np.isnan(got) and np.isnan(want))
    e = te.get_evaluator(name)
    assert te.is_regression(e, want - 1.0 if e.higher_is_better
                            else want + 1.0, want)
