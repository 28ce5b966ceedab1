"""Bayesian hyperparameter tuning (counterpart of ``photon_ml_tpu/tuning``;
SURVEY.md §3.1 "Hyperparameter tuning", §4.5 call stack).

Equivalent of the reference's ``hyperparameter.estimators.{GaussianProcess-
Estimator, GaussianProcessModel}`` and ``hyperparameter.search.{RandomSearch,
GaussianProcessSearch}``: a Gaussian-process surrogate with a Matérn-5/2
kernel fit to (hyperparameter-vector, metric) observations, maximizing
expected improvement to propose the next configuration; random search as the
baseline strategy. Used by the GAME training driver to auto-tune
regularization weights after the explicit grid is evaluated.
"""

from photon_ml_tpu_torch.tuning.gp import GaussianProcessModel, fit_gp, matern52
from photon_ml_tpu_torch.tuning.search import (
    GaussianProcessSearch,
    ParamRange,
    RandomSearch,
)
from photon_ml_tpu_torch.tuning.game_tuner import (
    resolve_tuned_coordinates,
    tune_game,
    tune_glm_path,
)

__all__ = [
    "GaussianProcessModel",
    "GaussianProcessSearch",
    "ParamRange",
    "RandomSearch",
    "fit_gp",
    "matern52",
    "resolve_tuned_coordinates",
    "tune_game",
    "tune_glm_path",
]
