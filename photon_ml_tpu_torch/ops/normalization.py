"""Feature normalization applied inside the objective, never materialized
(counterpart of ``photon_ml_tpu/ops/normalization.py``).

For normalized features ``x'_j = (x_j - s_j) * f_j`` the margin factors as
``x' . w = x . (f * w) - sum_j s_j f_j w_j``, so the (small, dense)
coefficient vector is transformed instead of the (large, sparse) data, and
the shift term folds into the intercept.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.types import resolve_device


class NormalizationType(str, enum.Enum):
    NONE = "none"
    SCALE_WITH_STANDARD_DEVIATION = "scale_with_standard_deviation"
    SCALE_WITH_MAX_MAGNITUDE = "scale_with_max_magnitude"
    STANDARDIZATION = "standardization"


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """factors/shifts over the feature axis; ``intercept_index`` is the
    column holding the constant-1 intercept feature (-1 if none)."""

    factors: Optional[torch.Tensor]  # [d] or None
    shifts: Optional[torch.Tensor]  # [d] or None
    intercept_index: int = -1

    def model_coefficients(self, w: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Map optimizer-space w to (w_eff, margin_adjust) applied to RAW x:
        margin_normalized(x) = x . w_eff + margin_adjust."""
        w_eff = w
        adjust = torch.zeros((), dtype=w.dtype, device=w.device)
        if self.factors is not None:
            f = self.factors.clone()
            if self.intercept_index >= 0:
                f[self.intercept_index] = 1.0
            w_eff = w_eff * f
        if self.shifts is not None:
            s = self.shifts.clone()
            if self.intercept_index >= 0:
                s[self.intercept_index] = 0.0
            adjust = -torch.sum(s * w_eff)
        return w_eff, adjust

    def to_model_space(self, w: torch.Tensor) -> torch.Tensor:
        """Optimizer-space coefficients -> raw-feature-space model."""
        if self.shifts is not None and self.intercept_index < 0:
            # with no intercept to absorb it, the shift adjustment would be
            # silently dropped and every saved-model prediction off by it
            raise ValueError("shift normalization requires an intercept feature")
        w_eff, adjust = self.model_coefficients(w)
        if self.intercept_index >= 0:
            w_eff = w_eff.clone()
            w_eff[self.intercept_index] += adjust
        return w_eff

    def to_training_space(self, w_model: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`to_model_space` (for warm starts)."""
        w = w_model
        if self.shifts is not None and self.intercept_index >= 0:
            # undo the intercept fold: adjust was -sum(s * w_eff_nonint)
            s = self.shifts.clone()
            s[self.intercept_index] = 0.0
            w_no_int = w.clone()
            w_no_int[self.intercept_index] = 0.0
            w = w.clone()
            w[self.intercept_index] += torch.sum(s * w_no_int)
        if self.factors is not None:
            f = self.factors.clone()
            if self.intercept_index >= 0:
                f[self.intercept_index] = 1.0
            w = w / f
        return w


# The three helpers below are the JAX package's ``_eff_coeffs``,
# ``_norm_fixed_fs`` and ``_norm_chain_t`` (parallel/data_parallel.py); they
# live here so the objective and the margin path share them.

def eff_coeffs(norm: Optional[NormalizationContext], w: torch.Tensor):
    """Optimizer-space w -> (raw-space effective w, scalar margin adjust)."""
    if norm is None:
        return w, torch.zeros((), dtype=w.dtype, device=w.device)
    return norm.model_coefficients(w)


def norm_fixed_fs(norm: Optional[NormalizationContext], dtype):
    """Normalization (factors, shifts) with the intercept slot pinned 1/0."""
    f = s = None
    if norm is not None and norm.factors is not None:
        f = norm.factors.to(dtype=dtype, copy=True)
        if norm.intercept_index >= 0:
            f[norm.intercept_index] = 1.0
    if norm is not None and norm.shifts is not None:
        s = norm.shifts.to(dtype=dtype, copy=True)
        if norm.intercept_index >= 0:
            s[norm.intercept_index] = 0.0
    return f, s


def norm_chain_t(norm: Optional[NormalizationContext], gx: torch.Tensor,
                 d_sum: torch.Tensor) -> torch.Tensor:
    """Raw-space ``X^T d`` (plus ``sum(d)``) -> optimizer-space gradient:
    ``g = f * (X^T d) - f * s * sum(d)``."""
    if norm is None:
        return gx
    f, s = norm_fixed_fs(norm, gx.dtype)
    if f is not None:
        gx = gx * f
    if s is not None:
        fs = s if f is None else f * s
        gx = gx - fs * d_sum
    return gx


def build_normalization_context(
    norm_type: NormalizationType | str,
    summary,
    intercept_index: int = -1,
    dtype=torch.float32,
    device=None,
) -> Optional[NormalizationContext]:
    """Build from a per-feature summary with numpy ``mean``, ``std``,
    ``max`` and ``min`` attributes, on ``device`` (default ``cuda``)."""
    norm_type = NormalizationType(norm_type)
    if norm_type == NormalizationType.NONE:
        return None
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=dev)

    std = np.asarray(summary.std)
    safe_std = np.where(std > 0, std, 1.0)
    if norm_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        return NormalizationContext(t(1.0 / safe_std), None, intercept_index)
    if norm_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        mx = np.maximum(np.abs(np.asarray(summary.max)),
                        np.abs(np.asarray(summary.min)))
        mx = np.where(mx > 0, mx, 1.0)
        return NormalizationContext(t(1.0 / mx), None, intercept_index)
    if norm_type == NormalizationType.STANDARDIZATION:
        if intercept_index < 0:
            raise ValueError("STANDARDIZATION requires an intercept feature")
        return NormalizationContext(t(1.0 / safe_std), t(summary.mean),
                                    intercept_index)
    raise ValueError(f"unhandled normalization type {norm_type}")
