"""L-BFGS specialized for linear-margin objectives (counterpart of
``photon_ml_tpu/optimize/lbfgs_margin.py``).

A GLM's data term factors through the margins, and margins are linear in
the coefficients: ``m(w + a*p) = m(w) + a * m_dir(p)``. So one gather per
iteration (the direction's margin) makes every line-search trial an O(n)
pointwise evaluation on cached margin vectors, and only the accepted point
pays the transpose for its gradient: exactly two O(nnz) passes per
iteration (one gather, one transpose), however hard the search works. The
L2 term is quadratic along the ray, handled with three scalars.

The loop's state (w, margins, gradient, history) stays on the device. The
host reads the device once per line-search trial (the phase flags) and
once per iteration (store / ok / converged), and counts those reads in
``OptimizationResult.host_syncs``.
"""

from __future__ import annotations

from typing import Callable

import torch

from photon_ml_tpu_torch.optimize.common import (
    OptimizationResult, OptimizerConfig, converged_check, grad_converged,
    init_history, l2_norm,
)
from photon_ml_tpu_torch.optimize.lbfgs import two_loop_direction
from photon_ml_tpu_torch.optimize.linesearch import strong_wolfe


def lbfgs_margin(
    dir_margin: Callable,  # p [d] -> m_p [n] (linear; no offsets)
    loss_and_dir: Callable,  # (m, m_p) -> (sum w_i l(m_i), sum w_i l'(m_i) m_p_i)
    data_grad: Callable,  # m [n] -> data-term gradient [d] (chain rule incl.)
    reg_mask: Callable,  # w [d] -> w with unpenalized slots zeroed
    w0: torch.Tensor,
    m0: torch.Tensor,
    l2,
    config: OptimizerConfig = OptimizerConfig(),
    loss_delta_and_dir: Callable | None = None,
    # (m, m_p, alpha) -> (sum w_i (l(m_i + a m_p_i) - l(m_i)),
    #                     sum w_i l'(m_i + a m_p_i) m_p_i)
) -> OptimizationResult:
    """Minimize  sum_i w_i l(m_i(w)) + 0.5*l2*||reg_mask(w)||^2  where the
    margin map is affine in w.

    When ``loss_delta_and_dir`` is given, the line search and the
    relative-loss convergence test run in DELTA space: per-row loss
    differences are summed instead of differencing two rounded totals. In
    f32 a total's resolution is eps*|f|, far coarser than late-stage
    per-iteration improvements, so total-space Wolfe tests stall the fit;
    delta sums keep relative accuracy in the improvement itself."""
    m = config.history
    dtype, dev = w0.dtype, w0.device
    tiny = torch.finfo(dtype).tiny
    l2 = torch.as_tensor(l2, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def full_g(mw, w):
        return data_grad(mw) + l2 * reg_mask(w)

    w, mw = w0, m0
    wr0 = reg_mask(w0)
    f = loss_and_dir(m0, m0)[0] + 0.5 * l2 * torch.sum(wr0 * wr0)
    g = full_g(m0, w0)
    g0_norm = l2_norm(g)
    loss_hist, gnorm_hist = init_history(config.max_iters, f.dtype, dev)
    s_hist = torch.zeros((m, w0.shape[0]), dtype=dtype, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros(m, dtype=dtype, device=dev)
    k, it, syncs, converged = 0, 0, 0, False
    while it < config.max_iters:
        p = two_loop_direction(g, s_hist, y_hist, rho, k, m)
        p = torch.where(torch.sum(p * g) < 0, p, -g)

        mp = dir_margin(p)  # the iteration's ONE gather pass
        # L2 along the ray: ||reg(w) + a*reg(p)||^2 = c0 + 2*a*c1 + a^2*c2
        wr, pr = reg_mask(w), reg_mask(p)
        c1 = torch.sum(wr * pr)
        c2 = torch.sum(pr * pr)

        if loss_delta_and_dir is not None:
            # strong_wolfe's tests are translation-invariant, so searching
            # f(w + a p) - f(w) from f0 = 0 keeps its semantics exactly
            def phi(alpha):
                delta_data, df_data = loss_delta_and_dir(mw, mp, alpha)
                delta = delta_data + l2 * (alpha * c1
                                           + 0.5 * alpha * alpha * c2)
                return delta, df_data + l2 * (c1 + alpha * c2)

            ls_f0 = zero
        else:
            def phi(alpha):
                f_data, df_data = loss_and_dir(mw + alpha * mp, mp)
                f_a = f_data + 0.5 * l2 * (torch.sum(wr * wr)
                                           + 2.0 * alpha * c1
                                           + alpha * alpha * c2)
                return f_a, df_data + l2 * (c1 + alpha * c2)

            ls_f0 = f

        # phi'(0) == p . g exactly (g includes the L2 term)
        df0 = torch.sum(p * g)
        alpha0 = 1.0 if k > 0 else 1.0 / torch.clamp(l2_norm(g), min=1.0)
        ls = strong_wolfe(phi, zero, torch.ones_like(zero), ls_f0, df0,
                          alpha0=alpha0,
                          max_evals=config.max_line_search_steps)
        # in delta space ls.f is the accepted IMPROVEMENT (0 on failure)
        f_new = (f + ls.f) if loss_delta_and_dir is not None else ls.f
        step = ls.alpha * p
        w_new = w + step
        mw_new = mw + ls.alpha * mp
        g_new = full_g(mw_new, w_new)  # the iteration's ONE transpose pass

        y = g_new - g
        sy = torch.sum(step * y)
        store = ls.ok & (sy > 1e-10 * torch.clamp(l2_norm(step) * l2_norm(y),
                                                  min=tiny))
        gnorm = l2_norm(g_new)
        if loss_delta_and_dir is not None:
            # test |improvement| directly against tol * max(|f|, 1)
            full = converged_check(zero, -ls.f, gnorm, g0_norm,
                                   config.tolerance, f_scale=f)
        else:
            full = converged_check(f, f_new, gnorm, g0_norm, config.tolerance)
        # a failed search leaves f unchanged: only the gradient test counts
        conv = torch.where(ls.ok, full,
                           grad_converged(gnorm, g0_norm, config.tolerance))
        loss_hist[it] = f_new
        gnorm_hist[it] = gnorm
        store, ok, converged = torch.stack([store, ls.ok, conv]).tolist()
        syncs += ls.host_syncs + 1
        if store:
            slot = k % m
            s_hist[slot] = step
            y_hist[slot] = y
            rho[slot] = 1.0 / torch.where(sy == 0, torch.ones_like(sy), sy)
        # line-search failure: RESET the history and retry from steepest
        # descent (in f32 the metric goes stale near convergence); stall only
        # if the search failed with an already-empty history (p was -g)
        stalled = (not ok) and k == 0
        k = k + 1 if store else (k if ok else 0)
        w, mw, f, g = w_new, mw_new, f_new, g_new
        it += 1
        if converged or stalled:
            break
    return OptimizationResult(
        w=w, value=f, grad_norm=l2_norm(g), iterations=it,
        converged=converged, loss_history=loss_hist,
        grad_norm_history=gnorm_hist, host_syncs=syncs,
    )
