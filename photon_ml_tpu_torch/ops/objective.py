"""GLM objective: value and gradient over a batch (counterpart of
``photon_ml_tpu/ops/objective.py``).

Sum semantics (not mean), weights multiply per-example losses, offsets add
to margins, and the L2 term is ``0.5 * l2 * ||w_masked||^2``. The gradient
is the explicit chain rule ``X'^T (w * l'(m)) + l2 * w_masked`` with the
loss's closed-form margin derivative, so no autograd is involved.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.ops.losses import (
    PointwiseLoss, apply_weights, get_loss, mask_margins,
)
from photon_ml_tpu_torch.ops.normalization import (
    NormalizationContext, eff_coeffs, norm_chain_t,
)
from photon_ml_tpu_torch.types import (
    LabeledBatch, margins as _margins, transpose_apply,
)


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    """A GLM training objective.

    Attributes:
      loss: the pointwise loss.
      normalization: optional NormalizationContext folded into margins.
      regularize_intercept: whether L2 touches the intercept coordinate.
      intercept_index: column of the constant-1 intercept feature, -1 if none.
    """

    loss: PointwiseLoss
    normalization: Optional[NormalizationContext] = None
    regularize_intercept: bool = False
    intercept_index: int = -1

    def margins(self, w: torch.Tensor, batch: LabeledBatch) -> torch.Tensor:
        w_eff, adjust = eff_coeffs(self.normalization, w)
        return _margins(batch.features, w_eff) + batch.offsets + adjust

    def predict(self, w: torch.Tensor, batch: LabeledBatch) -> torch.Tensor:
        """Mean response (inverse link of the margin)."""
        return self.loss.mean(self.margins(w, batch))

    def reg_mask(self, w: torch.Tensor) -> torch.Tensor:
        """w with the unpenalized intercept slot zeroed."""
        if self.regularize_intercept or self.intercept_index < 0:
            return w
        w = w.clone()
        w[self.intercept_index] = 0.0
        return w

    def value(self, w, batch: LabeledBatch, l2=0.0) -> torch.Tensor:
        m = mask_margins(batch.weights, self.margins(w, batch))
        wr = self.reg_mask(w)
        return (torch.sum(apply_weights(batch.weights,
                                        self.loss.loss(m, batch.labels)))
                + 0.5 * l2 * torch.sum(wr * wr))

    def value_and_grad(self, w, batch: LabeledBatch, l2=0.0):
        m = mask_margins(batch.weights, self.margins(w, batch))
        data_term = torch.sum(apply_weights(batch.weights,
                                            self.loss.loss(m, batch.labels)))
        d1 = apply_weights(batch.weights, self.loss.d1(m, batch.labels))
        wr = self.reg_mask(w)
        g = norm_chain_t(self.normalization,
                         transpose_apply(batch.features, d1), torch.sum(d1))
        return data_term + 0.5 * l2 * torch.sum(wr * wr), g + l2 * wr

    def grad(self, w, batch: LabeledBatch, l2=0.0) -> torch.Tensor:
        return self.value_and_grad(w, batch, l2)[1]


def kkt_residuals(w: torch.Tensor, g: torch.Tensor, lam_l1,
                  l1_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-coordinate KKT stationarity residual of
    ``min f(w) + lam_l1 * ||w * mask||_1`` given ``g`` = grad f(w):
    ``|g_j|`` on unpenalized coordinates, ``max(|g_j| - lam_l1, 0)`` at
    zero coordinates, ``|g_j + lam_l1 * sign(w_j)|`` elsewhere."""
    lam = torch.as_tensor(lam_l1, dtype=g.dtype, device=g.device)
    mask = (torch.ones_like(g) if l1_mask is None
            else torch.as_tensor(l1_mask, dtype=g.dtype, device=g.device))
    lam_eff = lam * mask
    at_zero = torch.clamp(torch.abs(g) - lam_eff, min=0.0)
    away = torch.abs(g + lam_eff * torch.sign(w))
    return torch.where(w == 0, at_zero, away)


def make_objective(
    loss: str | PointwiseLoss,
    normalization: Optional[NormalizationContext] = None,
    regularize_intercept: bool = False,
    intercept_index: int = -1,
) -> GLMObjective:
    if isinstance(loss, str):
        loss = get_loss(loss)
    return GLMObjective(
        loss=loss,
        normalization=normalization,
        regularize_intercept=regularize_intercept,
        intercept_index=intercept_index,
    )
