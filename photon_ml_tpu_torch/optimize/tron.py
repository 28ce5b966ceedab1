"""TRON: trust-region Newton with a conjugate-gradient inner loop
(counterpart of ``photon_ml_tpu/optimize/tron.py``; LIBLINEAR's algorithm,
Lin & More).

Both loops are Python loops over device state. Each CG step costs one
Hessian-vector product, a full pass over the data in a fit, and one host
read (whether the step ends the inner loop); each outer iteration costs one
more read (accepted / converged / stalled). ``host_syncs`` therefore counts
CG steps plus outer iterations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from photon_ml_tpu_torch.optimize.common import (
    OptimizationResult, OptimizerConfig, converged_check, init_history,
    l2_norm,
)

# Lin-More / LIBLINEAR constants
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0


class CGResult(NamedTuple):
    s: torch.Tensor  # the step
    r: torch.Tensor  # the residual -(g + H s)
    steps: int


def _steihaug_cg(hvp: Callable, g: torch.Tensor, delta, cg_tol,
                 max_cg: int, m_diag: Optional[torch.Tensor] = None
                 ) -> CGResult:
    """Approximately minimize ``q(s) = g.s + 0.5 s.H.s`` within a trust
    region of radius ``delta``.

    ``m_diag``: optional Jacobi preconditioner, the positive diagonal of an
    approximation to H; the trust region is then measured in the M-norm.
    With ``m_diag=None`` every M-product is Euclidean and the iteration is
    classic Steihaug. The residual invariant ``r == -(g + H s)`` holds
    either way, so the caller forms the predicted reduction from (s, r)."""
    tiny = torch.finfo(g.dtype).tiny
    if m_diag is None:
        def mdot(a, b):
            return torch.sum(a * b)

        def prec(r):
            return r
    else:
        minv = 1.0 / m_diag

        def mdot(a, b):
            return torch.sum(a * m_diag * b)

        def prec(r):
            return minv * r

    def boundary_tau(s, d):
        sd, dd, ss = mdot(s, d), mdot(d, d), mdot(s, s)
        disc = torch.sqrt(torch.clamp(sd * sd + dd * (delta * delta - ss),
                                      min=0.0))
        return (-sd + disc) / torch.clamp(dd, min=tiny)

    s = torch.zeros_like(g)
    r = -g
    d = prec(r)
    rz = torch.sum(r * d)
    i = 0
    while i < max_cg:
        Hd = hvp(d)
        dHd = torch.sum(d * Hd)
        neg_curv = dHd <= 0
        alpha = rz / torch.where(neg_curv, torch.ones_like(dHd), dHd)
        s_alpha = s + alpha * d
        hit = neg_curv | (torch.sqrt(mdot(s_alpha, s_alpha)) >= delta)
        # one uniform update keeps r == -(g + H s) exact even on the
        # boundary step
        step = torch.where(hit, boundary_tau(s, d), alpha)
        s = s + step * d
        r = r - step * Hd
        z = prec(r)
        rz_new = torch.sum(r * z)
        d = z + rz_new / torch.clamp(rz, min=tiny) * d
        rz = rz_new
        i += 1
        if bool(hit | (l2_norm(r) <= cg_tol)):  # the step's one host read
            break
    return CGResult(s, r, i)


def _default_hvp(fun_and_grad: Callable) -> Callable:
    """``hvp(w, v)`` by forward-mode differentiation of the gradient: the
    counterpart of the JAX package's ``jvp`` of ``grad``, for a
    ``fun_and_grad`` built from differentiable torch operations."""
    def hvp(w, v):
        return torch.func.jvp(lambda x: fun_and_grad(x)[1], (w,), (v,))[1]

    return hvp


def tron(
    fun_and_grad: Callable,
    w0: torch.Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    hvp: Optional[Callable] = None,
    max_cg_iters: Optional[int] = None,
    precond: Optional[Callable] = None,
) -> OptimizationResult:
    """Minimize fun(w). ``hvp(w, v)`` defaults to forward-mode
    differentiation of the gradient part of ``fun_and_grad``.
    ``precond(w)`` optionally returns the Hessian diagonal at w (one extra
    data pass per accepted outer iteration) for Jacobi-preconditioned CG."""
    dtype, dev = w0.dtype, w0.device
    eps = torch.finfo(dtype).eps
    if hvp is None:
        hvp = _default_hvp(fun_and_grad)
    max_cg = max_cg_iters if max_cg_iters is not None else max(w0.shape[0],
                                                               20)

    def guard(md):
        # positivity guard: the M-norm needs a positive diagonal
        return torch.clamp(md, min=eps * torch.clamp(torch.max(md), min=1.0))

    f, g = fun_and_grad(w0)
    w = w0
    g0_norm = l2_norm(g)
    delta = g0_norm
    m_diag = guard(precond(w0)) if precond is not None else None
    loss_hist, gnorm_hist = init_history(config.max_iters, f.dtype, dev)
    it, syncs, converged = 0, 0, False
    while it < config.max_iters:
        cg = _steihaug_cg(lambda v: hvp(w, v), g, delta, 0.1 * l2_norm(g),
                          max_cg, m_diag=m_diag)
        step, r = cg.s, cg.r
        w_try = w + step
        f_try, g_try = fun_and_grad(w_try)
        gs = torch.sum(g * step)
        # r == -(g + H step) from CG, so prered = 0.5 * (r.s - g.s): no
        # extra HVP
        prered = 0.5 * (torch.sum(step * r) - gs)
        actred = f - f_try
        # the radius lives in the same norm the CG boundary used
        snorm = (l2_norm(step) if m_diag is None
                 else torch.sqrt(torch.sum(step * m_diag * step)))
        # Lin-More radius update via quadratic interpolation
        denom = f_try - f - gs
        alpha = torch.where(
            denom <= 0, torch.full_like(denom, _SIGMA3),
            torch.clamp(-0.5 * (gs / torch.where(denom == 0,
                                                 torch.ones_like(denom),
                                                 denom)), min=_SIGMA1))
        a_snorm = alpha * snorm
        delta = torch.where(
            actred < _ETA0 * prered,
            torch.minimum(torch.clamp(alpha, min=_SIGMA1) * snorm,
                          _SIGMA2 * delta),
            torch.where(
                actred < _ETA1 * prered,
                torch.maximum(_SIGMA1 * delta,
                              torch.minimum(a_snorm, _SIGMA2 * delta)),
                torch.where(
                    actred < _ETA2 * prered,
                    torch.maximum(_SIGMA1 * delta,
                                  torch.minimum(a_snorm, _SIGMA3 * delta)),
                    torch.maximum(delta,
                                  torch.minimum(a_snorm, _SIGMA3 * delta)))))
        accept = actred > _ETA0 * prered
        w_new = torch.where(accept, w_try, w)
        f_new = torch.where(accept, f_try, f)
        g_new = torch.where(accept, g_try, g)
        gnorm = l2_norm(g_new)
        conv = accept & converged_check(f, f_new, gnorm, g0_norm,
                                        config.tolerance)
        # the quadratic model predicting no significant reduction IS
        # convergence (nothing left to gain at this dtype's resolution)
        conv = conv | (prered <= eps * torch.clamp(torch.abs(f), min=1.0))
        # radius below step resolution at w: further steps can't move w
        stalled = delta < eps * torch.clamp(l2_norm(w_new), min=1.0)
        loss_hist[it] = f_new
        gnorm_hist[it] = gnorm
        accepted, converged, stop = torch.stack(
            [accept, conv, stalled]).tolist()
        syncs += cg.steps + 1
        w, f, g = w_new, f_new, g_new
        if accepted and precond is not None:
            # the diagonal costs a data pass: recompute only on acceptance
            # (w unchanged on rejection -> same diagonal)
            m_diag = guard(precond(w))
        it += 1
        if converged or stop:
            break
    return OptimizationResult(
        w=w, value=f, grad_norm=l2_norm(g), iterations=it,
        converged=converged, loss_history=loss_hist,
        grad_norm_history=gnorm_hist, host_syncs=syncs,
    )
