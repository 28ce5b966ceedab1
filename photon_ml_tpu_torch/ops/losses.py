"""Pointwise GLM losses as functions of (margin, label) (counterpart of
``photon_ml_tpu/ops/losses.py``).

The JAX package gets the margin derivative ``d1`` by autodiff; here it is
the closed form, held against ``jax.grad`` in the tests. Labels follow the
reference's conventions: {0, 1} for binary tasks, real for regression,
non-negative counts for Poisson.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def apply_weights(weights, per_example):
    """``w * l`` per example with exact-zero weights annihilating
    non-finite losses. Zero-weight rows are padding; under the
    implicit-ones layout they carry arbitrary margins, so e.g. a Poisson
    ``exp(margin)`` overflow would turn ``0 * inf`` into NaN. Margins must
    ALSO go through :func:`mask_margins` before the loss (or its
    derivative) touches them, so no pad-row intermediate is non-finite."""
    return torch.where(weights != 0, weights * per_example,
                       torch.zeros((), dtype=per_example.dtype,
                                   device=per_example.device))


def mask_margins(weights, margins):
    """Zero the margin on exactly-zero-weight (padding) rows before the
    loss is evaluated; ``loss(0, label)`` is finite for every family."""
    return torch.where(weights != 0, margins,
                       torch.zeros((), dtype=margins.dtype,
                                   device=margins.device))


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    """A pointwise loss: ``loss(margin, label)``, the inverse link
    ``mean(margin)``, and the margin derivatives ``d1`` and ``d2``."""

    name: str
    loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    mean: Callable[[torch.Tensor], torch.Tensor]
    d1: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    d2: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# The logistic functions are built from exp and log1p only. On the CPU,
# torch.logaddexp and torch.sigmoid round an element differently in their
# vectorized body and their scalar tail, so a value would depend on its
# position in the tensor; exp and log1p do not. The batched random-effect
# solvers rely on that: an entity gives the same bits wherever it sits in a
# block.
def _softplus(margin):
    """``log(1 + e^m)``, stable on both sides; each branch is evaluated at
    a clamped margin, so neither overflows and forward-mode derivatives are
    right at 0."""
    neg = torch.log1p(torch.exp(torch.clamp(margin, max=0.0)))
    pos = margin + torch.log1p(torch.exp(-torch.clamp(margin, min=0.0)))
    return torch.where(margin > 0, pos, neg)


def _sigmoid(margin):
    """``1 / (1 + e^-m)``, built the same way as :func:`_softplus`."""
    pos = 1.0 / (1.0 + torch.exp(-torch.clamp(margin, min=0.0)))
    e = torch.exp(torch.clamp(margin, max=0.0))
    return torch.where(margin >= 0, pos, e / (1.0 + e))


def _logistic_loss(margin, label):
    # -log p(y|m) for y in {0,1}, p = sigmoid(m)
    return _softplus(margin) - label * margin


def _logistic_d1(margin, label):
    return _sigmoid(margin) - label


def _logistic_d2(margin, label):
    p = _sigmoid(margin)
    return p * (1.0 - p)


def _squared_loss(margin, label):
    return 0.5 * (margin - label) ** 2


def _poisson_loss(margin, label):
    # NLL of Poisson with rate exp(m), dropping the label-only log(y!)
    return torch.exp(margin) - label * margin


def _smoothed_hinge_loss(margin, label):
    # Rennie's smoothed hinge on z = (2y-1)*m:
    #   1/2 - z      z <= 0
    #   (1-z)^2 / 2  0 < z < 1
    #   0            z >= 1
    z = (2.0 * label - 1.0) * margin
    zero = torch.zeros_like(z)
    return torch.where(z <= 0.0, 0.5 - z,
                       torch.where(z < 1.0, 0.5 * (1.0 - z) ** 2, zero))


def _smoothed_hinge_d1(margin, label):
    sign = 2.0 * label - 1.0
    z = sign * margin
    dz = torch.where(z <= 0.0, -torch.ones_like(z),
                     torch.where(z < 1.0, z - 1.0, torch.zeros_like(z)))
    return sign * dz


def _smoothed_hinge_d2(margin, label):
    z = (2.0 * label - 1.0) * margin
    return ((z > 0.0) & (z < 1.0)).to(margin.dtype)


LOGISTIC = PointwiseLoss("logistic", _logistic_loss, torch.sigmoid,
                         _logistic_d1, _logistic_d2)
SQUARED = PointwiseLoss("squared", _squared_loss, lambda m: m,
                        lambda m, y: m - y, lambda m, y: torch.ones_like(m))
POISSON = PointwiseLoss("poisson", _poisson_loss, torch.exp,
                        lambda m, y: torch.exp(m) - y,
                        lambda m, y: torch.exp(m))
SMOOTHED_HINGE = PointwiseLoss(
    "smoothed_hinge",
    _smoothed_hinge_loss,
    lambda m: (m + 1.0) * 0.5,  # affine score->[~0,1] mapping for ranking
    _smoothed_hinge_d1,
    _smoothed_hinge_d2,
)

_REGISTRY = {
    "logistic": LOGISTIC,
    "squared": SQUARED,
    "linear": SQUARED,
    "poisson": POISSON,
    "smoothed_hinge": SMOOTHED_HINGE,
    "hinge": SMOOTHED_HINGE,
}

# The reference's TaskType names.
TASK_TO_LOSS = {
    "logistic_regression": "logistic",
    "linear_regression": "squared",
    "poisson_regression": "poisson",
    "smoothed_hinge_loss_linear_svm": "smoothed_hinge",
}


def get_loss(name: str) -> PointwiseLoss:
    key = name.lower()
    key = TASK_TO_LOSS.get(key, key)
    if key not in _REGISTRY:
        raise ValueError(f"unknown loss '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]
