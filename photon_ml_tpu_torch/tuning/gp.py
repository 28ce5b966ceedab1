"""Gaussian-process regression with a Matérn-5/2 kernel (a copy of
``photon_ml_tpu/tuning/gp.py``: numpy only, so the same observations give
the same surrogate in both packages).

Equivalent of the reference's ``hyperparameter.estimators.{GaussianProcess-
Estimator, GaussianProcessModel}`` (SURVEY.md §3.1; reference mount empty —
upstream linkedin/photon-ml uses a Matérn-5/2 GP surrogate for GAME
regularization-weight auto-tuning). Plain NumPy: the observation sets are
tiny (tens of points), so a jitted path would be all compile time.

Inputs are expected in the unit hypercube (the search layer normalizes);
targets are standardized internally. Kernel length-scale and noise are
chosen by log-marginal-likelihood over a small grid — the same "fit the
surrogate each round" role as the reference's estimator, without an external
optimizer dependency.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def matern52(x1: np.ndarray, x2: np.ndarray, lengthscale: float,
             amplitude: float = 1.0) -> np.ndarray:
    """Matérn-5/2 kernel matrix between row-stacked points."""
    x1 = np.atleast_2d(np.asarray(x1, np.float64))
    x2 = np.atleast_2d(np.asarray(x2, np.float64))
    d2 = ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1)
    r = np.sqrt(np.maximum(d2, 0.0)) / max(lengthscale, 1e-12)
    s5r = np.sqrt(5.0) * r
    return amplitude * (1.0 + s5r + 5.0 / 3.0 * r * r) * np.exp(-s5r)


@dataclasses.dataclass(frozen=True)
class GaussianProcessModel:
    """Posterior GP over standardized targets; ``predict`` de-standardizes."""

    x_train: np.ndarray
    alpha: np.ndarray          # K⁻¹ y (via Cholesky solves)
    chol: np.ndarray           # lower Cholesky factor of K + σ²I
    lengthscale: float
    amplitude: float
    noise: float
    y_mean: float
    y_std: float

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and stddev at query points (original target scale)."""
        x = np.atleast_2d(np.asarray(x, np.float64))
        k_star = matern52(x, self.x_train, self.lengthscale, self.amplitude)
        mean = k_star @ self.alpha
        v = np.linalg.solve(self.chol, k_star.T)
        var = self.amplitude - (v * v).sum(axis=0)
        var = np.maximum(var, 1e-12)
        return (mean * self.y_std + self.y_mean, np.sqrt(var) * self.y_std)


def _log_marginal_likelihood(y: np.ndarray, chol: np.ndarray,
                             alpha: np.ndarray) -> float:
    n = len(y)
    return float(
        -0.5 * y @ alpha
        - np.log(np.diag(chol)).sum()
        - 0.5 * n * np.log(2.0 * np.pi)
    )


def fit_gp(
    x: np.ndarray,
    y: np.ndarray,
    lengthscales: Optional[np.ndarray] = None,
    noises: Optional[np.ndarray] = None,
) -> GaussianProcessModel:
    """Fit hyperparameters by exact log-marginal-likelihood over a grid.

    ``x``: (n, d) in the unit hypercube; ``y``: (n,) raw metric values.
    """
    x = np.atleast_2d(np.asarray(x, np.float64))
    y = np.asarray(y, np.float64)
    y_mean = float(y.mean())
    y_std = float(y.std())
    if y_std < 1e-12:
        y_std = 1.0
    ys = (y - y_mean) / y_std

    if lengthscales is None:
        lengthscales = np.geomspace(0.05, 2.0, 8)
    if noises is None:
        noises = np.array([1e-6, 1e-4, 1e-2])

    best = None
    n = len(ys)
    for ls in lengthscales:
        k_base = matern52(x, x, float(ls), 1.0)
        for noise in noises:
            try:
                chol = np.linalg.cholesky(k_base + noise * np.eye(n))
            except np.linalg.LinAlgError:
                continue
            alpha = np.linalg.solve(chol.T, np.linalg.solve(chol, ys))
            lml = _log_marginal_likelihood(ys, chol, alpha)
            if best is None or lml > best[0]:
                best = (lml, float(ls), float(noise), chol, alpha)
    if best is None:  # pathological inputs: fall back to heavy jitter
        noise = 1.0
        chol = np.linalg.cholesky(matern52(x, x, 1.0, 1.0) + noise * np.eye(n))
        alpha = np.linalg.solve(chol.T, np.linalg.solve(chol, ys))
        best = (0.0, 1.0, noise, chol, alpha)
    _, ls, noise, chol, alpha = best
    return GaussianProcessModel(
        x_train=x, alpha=alpha, chol=chol, lengthscale=ls, amplitude=1.0,
        noise=noise, y_mean=y_mean, y_std=y_std,
    )
