"""GLM objective: value, gradient and Hessian products over a batch
(counterpart of ``photon_ml_tpu/ops/objective.py``).

Sum semantics (not mean), weights multiply per-example losses, offsets add
to margins, and the L2 term is ``0.5 * l2 * ||w_masked||^2``. The gradient
is the explicit chain rule ``X'^T (w * l'(m)) + l2 * w_masked`` with the
loss's closed-form margin derivative, and the Hessian-vector product the
same with ``l''``: ``X'^T (w * l''(m) * X' v) + l2 * v_masked``, so no
autograd is involved (the JAX package differentiates instead).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from photon_ml_tpu_torch.ops.losses import (
    PointwiseLoss, apply_weights, get_loss, mask_margins,
)
from photon_ml_tpu_torch.ops.normalization import (
    NormalizationContext, eff_coeffs, norm_chain_t, norm_fixed_fs,
)
from photon_ml_tpu_torch.types import (
    LabeledBatch, SparseFeatures, margins as _margins, row_squares_apply,
    transpose_apply,
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

    def curvature(self, w, batch: LabeledBatch) -> torch.Tensor:
        """Per-row ``weight * l''(margin)``, 0 on padding rows."""
        m = mask_margins(batch.weights, self.margins(w, batch))
        return apply_weights(batch.weights, self.loss.d2(m, batch.labels))

    def reg_diagonal(self, like: torch.Tensor, l2) -> torch.Tensor:
        """The L2 term's Hessian diagonal: ``l2``, 0 at an unpenalized
        intercept."""
        return self.reg_mask(torch.zeros_like(like) + l2)

    def hvp(self, w, v, batch: LabeledBatch, l2=0.0) -> torch.Tensor:
        """Hessian-vector product ``X'^T (d2 * X' v) + l2 * v_masked``; the
        margin is linear in w, so ``v`` maps through the same normalization
        as ``w`` (without offsets)."""
        d2 = self.curvature(w, batch)
        v_eff, v_adjust = eff_coeffs(self.normalization, v)
        dv = d2 * (_margins(batch.features, v_eff) + v_adjust)
        hv = norm_chain_t(self.normalization,
                          transpose_apply(batch.features, dv), torch.sum(dv))
        return hv + l2 * self.reg_mask(v)

    def diagonal_hessian(self, w, batch: LabeledBatch, l2=0.0):
        """Exact diagonal of the Hessian: ``sum_i d2_i x'_ij^2 + l2`` with
        the (virtually) normalized ``x'_j = (x_j - s_j) f_j``, expanded so
        the shifted square never materializes:
        ``f^2 (sum d2 x^2 - 2 s sum d2 x + s^2 sum d2)``."""
        d2 = self.curvature(w, batch)
        diag = row_squares_apply(batch.features, d2)
        f, s = norm_fixed_fs(self.normalization, diag.dtype)
        if s is not None:
            diag = (diag - 2.0 * s * transpose_apply(batch.features, d2)
                    + s * s * torch.sum(d2))
        if f is not None:
            diag = diag * f * f
        return diag + self.reg_diagonal(diag, l2)

    def full_hessian(self, w, batch: LabeledBatch, l2=0.0,
                     chunk_rows: int = 4096) -> torch.Tensor:
        """Explicit ``d x d`` Hessian ``X'^T diag(d2) X' + l2 * mask``, for
        small dims only (O(d^2) memory, O(n d^2) operations). Rows go
        through in chunks of ``chunk_rows``, so the dense ``[n, d]`` view
        never materializes."""
        d2 = self.curvature(w, batch)
        dim, n = batch.dim, batch.num_examples
        f, s = norm_fixed_fs(self.normalization, d2.dtype)
        H = torch.zeros((dim, dim), dtype=d2.dtype, device=d2.device)
        for start in range(0, n, chunk_rows):
            size = min(chunk_rows, n - start)
            feats = batch.slice_rows(start, size).features
            X = (feats.todense().to(d2.dtype)
                 if isinstance(feats, SparseFeatures) else feats)
            if s is not None:
                X = X - s[None, :]
            if f is not None:
                X = X * f[None, :]
            H += X.T @ (d2[start:start + size, None] * X)
        return H + torch.diag(self.reg_diagonal(H[0], l2))

    def coefficient_variances(self, w, batch: LabeledBatch, l2=0.0,
                              mode: str = "diagonal",
                              reduce: Optional[Callable] = None
                              ) -> torch.Tensor:
        """Coefficient variances: ``"diagonal"`` is ``1 / diag(H)`` (cheap
        at any dim); ``"full"`` is ``diag(H^-1)``, which accounts for
        feature correlations (an O(d^3) solve, small dims only).
        ``reduce`` sums the data term's Hessian over row blocks (``batch``
        is then one block); the L2 term is added once, after it."""
        if mode == "full":
            H = self.full_hessian(w, batch, 0.0)
        elif mode == "diagonal":
            H = self.diagonal_hessian(w, batch, 0.0)
        else:
            raise ValueError(f"unknown variance mode {mode!r}")
        if reduce is not None:
            H = reduce(H)
        if mode == "full":
            H = H + torch.diag(self.reg_diagonal(H[0], l2))
            eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
            return torch.diagonal(torch.linalg.solve(H, eye))
        diag = H + self.reg_diagonal(H, l2)
        return 1.0 / torch.clamp(diag, min=torch.finfo(diag.dtype).tiny)


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
