"""OWL-QN (Orthant-Wise Limited-memory Quasi-Newton) for L1 and
elastic-net objectives (counterpart of ``photon_ml_tpu/optimize/owlqn.py``).

Minimizes ``F(w) = f(w) + l1 * ||w * mask||_1`` where f is smooth (the
elastic net's L2 part lives inside f). Andrew & Gao (2007): pseudo-gradient,
L-BFGS direction from the smooth-gradient history, orthant projection of
both the direction and the line-search iterates.

The backtracking trials need only ``F``. The JAX version evaluates
``fun_and_grad`` there and lets XLA drop the unused gradient; run eagerly,
that gradient would cost a transpose pass per trial. So :func:`owlqn`
takes an optional value-only ``fun``: each trial is then one forward pass,
and each iteration computes one gradient, at the accepted point. The
iterates are the same either way.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from photon_ml_tpu_torch.optimize.common import (
    OptimizationResult, OptimizerConfig, converged_check, init_history,
    l2_norm,
)
from photon_ml_tpu_torch.optimize.lbfgs import two_loop_direction
from photon_ml_tpu_torch.optimize.linesearch import backtracking


def pseudo_gradient(w, g, l1):
    """Directional-derivative-minimizing subgradient of f + l1*|w|_1."""
    right = g + l1
    left = g - l1
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    at_zero = torch.where(right < 0, right, torch.where(left > 0, left, zero))
    return torch.where(w > 0, right, torch.where(w < 0, left, at_zero))


def owlqn(
    fun_and_grad: Callable,
    w0: torch.Tensor,
    l1_weight,
    config: OptimizerConfig = OptimizerConfig(),
    l1_mask: Optional[torch.Tensor] = None,
    fun: Optional[Callable] = None,
) -> OptimizationResult:
    """Minimize ``f(w) + l1_weight * ||w * l1_mask||_1``; ``fun_and_grad``
    is the smooth part, ``fun`` (optional) its value alone. ``l1_mask``
    defaults to all ones (mask the intercept with 0).

    The host reads the Armijo flag once per line-search trial and
    (store, converged) once per iteration; ``host_syncs`` counts both."""
    m = config.history
    d = w0.shape[0]
    dtype, dev = w0.dtype, w0.device
    tiny = torch.finfo(dtype).tiny
    mask = (torch.ones(d, dtype=dtype, device=dev) if l1_mask is None
            else l1_mask.to(dtype))
    lam = torch.as_tensor(l1_weight, dtype=dtype, device=dev) * mask
    if fun is None:
        def fun(w):
            return fun_and_grad(w)[0]

    def full_value(w):
        return fun(w) + torch.sum(lam * torch.abs(w))

    f0, g = fun_and_grad(w0)
    w, F = w0, f0 + torch.sum(lam * torch.abs(w0))
    pg0_norm = l2_norm(pseudo_gradient(w0, g, lam))
    loss_hist, gnorm_hist = init_history(config.max_iters, F.dtype, dev)
    s_hist = torch.zeros((m, d), dtype=dtype, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros(m, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    k, it, syncs, converged = 0, 0, 0, False
    while it < config.max_iters:
        pg = pseudo_gradient(w, g, lam)
        p = two_loop_direction(pg, s_hist, y_hist, rho, k, m)
        # align the direction with -pg (orthant-wise projection)
        p = torch.where(p * (-pg) > 0, p, zero)
        p = torch.where(torch.sum(p * pg) < 0, p, -pg)
        # orthant choice: sign(w), or sign(-pg) where w == 0
        xi = torch.where(w != 0, torch.sign(w), torch.sign(-pg))

        def project(w_trial):
            return torch.where(w_trial * xi > 0, w_trial, zero)

        alpha0 = 1.0 if k > 0 else 1.0 / torch.clamp(l2_norm(pg), min=1.0)
        ls = backtracking(full_value, w, p, F, pg, alpha0=alpha0,
                          max_evals=config.max_line_search_steps,
                          project=project)
        _, g_new = fun_and_grad(ls.w)  # the iteration's one gradient
        step = ls.w - w
        y = g_new - g
        sy = torch.sum(step * y)
        store = ls.ok & (sy > 1e-10 * torch.clamp(l2_norm(step) * l2_norm(y),
                                                  min=tiny))
        pg_new_norm = l2_norm(pseudo_gradient(ls.w, g_new, lam))
        conv = converged_check(F, ls.f, pg_new_norm, pg0_norm,
                               config.tolerance)
        loss_hist[it] = ls.f
        gnorm_hist[it] = pg_new_norm
        store, converged = torch.stack([store, conv]).tolist()
        syncs += ls.n_evals + 1
        if store:
            slot = k % m
            s_hist[slot] = step
            y_hist[slot] = y
            rho[slot] = 1.0 / torch.where(sy == 0, torch.ones_like(sy), sy)
            k += 1
        w, F, g = ls.w, ls.f, g_new
        it += 1
        if converged or not ls.ok:
            break
    return OptimizationResult(
        w=w, value=F, grad_norm=l2_norm(pseudo_gradient(w, g, lam)),
        iterations=it, converged=converged, loss_history=loss_hist,
        grad_norm_history=gnorm_hist, host_syncs=syncs,
    )
