"""Shared optimizer machinery: config, convergence, history (counterpart of
``photon_ml_tpu/optimize/common.py``).

The optimizer loops are Python loops over device tensors. Their state stays
on the device; the host reads it only where a decision depends on the data,
and each loop counts those reads (``OptimizationResult.host_syncs``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer config surface (max iters, tolerance, history length and
    the line-search evaluation cap per iteration)."""

    max_iters: int = 100
    tolerance: float = 1e-7
    history: int = 10
    max_line_search_steps: int = 25


@dataclasses.dataclass(frozen=True)
class ToleranceSchedule:
    """Inexact-outer-loop solver tolerance schedule: ``at(step, final_tol)``
    starts at ``start`` and tightens geometrically by ``decay`` per outer
    step, clamped from below at the caller's final tolerance (early
    block-coordinate sweeps need no exact inner solves)."""

    start: float = 1e-3
    decay: float = 0.1

    def __post_init__(self):
        if not (math.isfinite(self.start) and self.start > 0):
            raise ValueError(f"schedule start must be finite and > 0, "
                             f"got {self.start}")
        if not (0 < self.decay < 1):
            raise ValueError(f"schedule decay must be in (0, 1), "
                             f"got {self.decay}")

    def at(self, step: int, final_tol: float) -> float:
        if final_tol <= 0:
            # an explicit tol <= 0 disables convergence tests entirely
            # (pinned iteration counts); a schedule must not re-enable them
            return final_tol
        return max(float(final_tol), self.start * self.decay ** max(step, 0))


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """Pathwise fixed-effect solver settings, beside
    :class:`OptimizerConfig`. ``screen``: ``"strong"``, ``"safe"`` or
    ``"off"``; ``kkt_tol``: relative slack on the L1 weight in the
    violation test ``|g_j| > l1 + kkt_tol * max(l1, 1)``;
    ``max_kkt_rounds``: screen -> solve -> check rounds before a
    full-feature solve; ``min_bucket``: floor of the power-of-two restricted
    width; ``screen_slack``: over-screening on purpose (0 = the published
    rules); ``keep_states``: keep one (lambda, w, gradient) snapshot per
    solved lambda for warm starts."""

    screen: str = "strong"
    kkt_tol: float = 1e-6
    max_kkt_rounds: int = 5
    min_bucket: int = 64
    screen_slack: float = 0.0
    keep_states: bool = True

    def __post_init__(self):
        if self.screen not in ("strong", "safe", "off"):
            raise ValueError(f"screen must be strong|safe|off, "
                             f"got {self.screen!r}")
        if not (self.kkt_tol >= 0):
            raise ValueError(f"kkt_tol must be >= 0, got {self.kkt_tol}")
        if self.max_kkt_rounds < 1:
            raise ValueError(f"max_kkt_rounds must be >= 1, "
                             f"got {self.max_kkt_rounds}")
        if self.min_bucket < 1:
            raise ValueError(f"min_bucket must be >= 1, "
                             f"got {self.min_bucket}")


def parse_tolerance_schedule(spec: str) -> Optional[ToleranceSchedule]:
    """Parse a ``START:DECAY`` spec (e.g. ``1e-3:0.1``) into a
    :class:`ToleranceSchedule`; ``off``/``none`` disable it."""
    s = spec.strip().lower()
    if s in ("off", "none", ""):
        return None
    parts = s.split(":")
    if len(parts) != 2:
        raise ValueError(
            f"expected START:DECAY (e.g. 1e-3:0.1) or 'off', got {spec!r}")
    try:
        start, decay = float(parts[0]), float(parts[1])
    except ValueError:
        raise ValueError(
            f"expected numeric START:DECAY, got {spec!r}") from None
    return ToleranceSchedule(start, decay)


class OptimizationResult(NamedTuple):
    """Final point + convergence record. ``loss_history`` and
    ``grad_norm_history`` are [max_iters], NaN past ``iterations``;
    ``host_syncs`` counts the device-to-host reads the loop made.
    ``solver_tolerance`` and ``screened_dim`` are set by the path solver
    (``optimize/path.py``): the tolerance the fit ran to and the width of
    the problem it finally solved. ``stream_stats`` is a streamed fit's
    pipeline accounting (``parallel.streaming.StreamStats.as_dict``).
    ``kernel_launches`` is set by ``parallel.data_parallel.fit_shard``:
    the ``ops.kernels.csc_column_sums`` launches the fit made."""

    w: torch.Tensor
    value: torch.Tensor
    grad_norm: torch.Tensor
    iterations: int
    converged: bool
    loss_history: torch.Tensor
    grad_norm_history: torch.Tensor
    host_syncs: int
    solver_tolerance: Optional[float] = None
    screened_dim: Optional[int] = None
    stream_stats: Optional[dict] = None
    kernel_launches: Optional[int] = None


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
