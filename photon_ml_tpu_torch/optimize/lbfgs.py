"""L-BFGS with strong-Wolfe line search (counterpart of
``photon_ml_tpu/optimize/lbfgs.py``).

The (s, y) history is a circular buffer of ``m`` slots on the device; the
number of pairs ever stored, ``k``, is a host integer (it changes only on
the per-iteration host read), so the two-loop recursion visits exactly the
valid slots.
"""

from __future__ import annotations

from typing import Callable

import torch

from photon_ml_tpu_torch.optimize.common import (
    OptimizationResult, OptimizerConfig, converged_check, grad_converged,
    init_history, l2_norm,
)
from photon_ml_tpu_torch.optimize.linesearch import strong_wolfe


def two_loop_direction(g, s_hist, y_hist, rho, k: int, m: int):
    """Two-loop recursion over a circular buffer; slot (k-1-i) mod m is the
    i-th most recent pair, for i < min(k, m)."""
    n_valid = min(k, m)
    q = g
    alphas = [None] * m
    for i in range(n_valid):
        j = (k - 1 - i) % m
        a = rho[j] * torch.sum(s_hist[j] * q)
        q = q - a * y_hist[j]
        alphas[j] = a
    if k > 0:
        newest = (k - 1) % m
        sy = torch.sum(s_hist[newest] * y_hist[newest])
        yy = torch.sum(y_hist[newest] * y_hist[newest])
        tiny = torch.finfo(g.dtype).tiny
        gamma = torch.where(yy > 0, sy / torch.clamp(yy, min=tiny),
                            torch.ones_like(yy))
        r = gamma * q
    else:
        r = q
    for i in range(n_valid):
        rank = n_valid - 1 - i  # recency rank, oldest first
        j = (k - 1 - rank) % m
        beta = rho[j] * torch.sum(y_hist[j] * r)
        r = r + s_hist[j] * (alphas[j] - beta)
    return -r


def lbfgs(
    fun_and_grad: Callable,
    w0: torch.Tensor,
    config: OptimizerConfig = OptimizerConfig(),
) -> OptimizationResult:
    """Minimize fun(w); fun_and_grad(w) -> (f, g)."""
    m = config.history
    dtype, dev = w0.dtype, w0.device
    tiny = torch.finfo(dtype).tiny
    f, g = fun_and_grad(w0)
    w = w0
    g0_norm = l2_norm(g)
    loss_hist, gnorm_hist = init_history(config.max_iters, f.dtype, dev)
    s_hist = torch.zeros((m, w0.shape[0]), dtype=dtype, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros(m, dtype=dtype, device=dev)
    k, it, syncs, converged = 0, 0, 0, False
    while it < config.max_iters:
        p = two_loop_direction(g, s_hist, y_hist, rho, k, m)
        # ensure descent; fall back to steepest descent if the metric degraded
        p = torch.where(torch.sum(p * g) < 0, p, -g)
        alpha0 = 1.0 if k > 0 else 1.0 / torch.clamp(l2_norm(g), min=1.0)
        ls = strong_wolfe(fun_and_grad, w, p, f, g, alpha0=alpha0,
                          max_evals=config.max_line_search_steps)
        step = ls.alpha * p
        y = ls.g - g
        sy = torch.sum(step * y)
        store = ls.ok & (sy > 1e-10 * torch.clamp(l2_norm(step) * l2_norm(y),
                                                  min=tiny))
        gnorm = l2_norm(ls.g)
        # a failed search leaves f unchanged, so only the gradient half of
        # the convergence test stays meaningful
        conv = torch.where(
            ls.ok, converged_check(f, ls.f, gnorm, g0_norm, config.tolerance),
            grad_converged(gnorm, g0_norm, config.tolerance))
        store, ok, converged = torch.stack([store, ls.ok, conv]).tolist()
        syncs += ls.host_syncs + 1
        if store:
            slot = k % m
            s_hist[slot] = step
            y_hist[slot] = y
            rho[slot] = 1.0 / torch.where(sy == 0, torch.ones_like(sy), sy)
        # on line-search failure reset the history and retry from steepest
        # descent; stall only if -g itself failed (k == 0)
        stalled = (not ok) and k == 0
        k = k + 1 if store else (k if ok else 0)
        # a fit that converges on its FIRST iteration was already at its
        # stopping point: it returns w0 unchanged
        if not (converged and it == 0):
            w, f, g = w + step, ls.f, ls.g
        loss_hist[it] = f
        gnorm_hist[it] = l2_norm(g)
        it += 1
        if converged or stalled:
            break
    return OptimizationResult(
        w=w, value=f, grad_norm=l2_norm(g), iterations=it,
        converged=converged, loss_history=loss_hist,
        grad_norm_history=gnorm_hist, host_syncs=syncs,
    )
