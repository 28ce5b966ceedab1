"""Shared optimizer machinery: config, convergence, history (counterpart of
``photon_ml_tpu/optimize/common.py``).

The optimizer loops are Python loops over device tensors. Their state stays
on the device; the host reads it only where a decision depends on the data,
and each loop counts those reads (``OptimizationResult.host_syncs``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer config surface (max iters, tolerance, history length and
    the line-search evaluation cap per iteration)."""

    max_iters: int = 100
    tolerance: float = 1e-7
    history: int = 10
    max_line_search_steps: int = 25


class OptimizationResult(NamedTuple):
    """Final point + convergence record. ``loss_history`` and
    ``grad_norm_history`` are [max_iters], NaN past ``iterations``;
    ``host_syncs`` counts the device-to-host reads the loop made."""

    w: torch.Tensor
    value: torch.Tensor
    grad_norm: torch.Tensor
    iterations: int
    converged: bool
    loss_history: torch.Tensor
    grad_norm_history: torch.Tensor
    host_syncs: int


def _clamped_tol(tol, dtype, device) -> torch.Tensor:
    # a positive tol is clamped to a few ulps of the working dtype so a tol
    # tuned for f64 still terminates in f32; tol <= 0 is honored exactly
    eps = torch.finfo(dtype).eps
    tol = torch.as_tensor(tol, dtype=dtype, device=device)
    return torch.where(tol > 0, torch.clamp(tol, min=4 * eps), tol)


def converged_check(f_prev, f, g_norm, g0_norm, tol, f_scale=None):
    """Reference-style stopping rule: relative loss change below tol OR
    gradient norm below tol * max(1, ||g0||). An explicit tol <= 0 disables
    both tests, pinning the iteration count at max_iters.

    ``f_scale``: override for the relative-test scale. Delta-space callers
    pass the accurately-summed improvement as ``f_prev=0, f=-delta`` with
    ``f_scale`` = the current loss value."""
    tol = _clamped_tol(tol, f.dtype, f.device)
    scale = torch.abs(f_prev if f_scale is None else f_scale)
    rel_loss = torch.abs(f_prev - f) <= tol * torch.clamp(scale, min=1.0)
    grad_small = g_norm <= tol * torch.clamp(g0_norm, min=1.0)
    return (tol > 0) & (rel_loss | grad_small)


def grad_converged(g_norm, g0_norm, tol):
    """The gradient-norm half of :func:`converged_check` alone (same tol
    clamping): a failed line search invalidates the relative-loss test but
    a search that fails AT the optimum must still report convergence."""
    tol = _clamped_tol(tol, g_norm.dtype, g_norm.device)
    return (tol > 0) & (g_norm <= tol * torch.clamp(g0_norm, min=1.0))


def init_history(max_iters: int, dtype, device):
    nan = torch.full((max_iters,), float("nan"), dtype=dtype, device=device)
    return nan, nan.clone()


def l2_norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(a * a))
