"""Batched L-BFGS, OWL-QN and TRON over an entity axis: ``E`` independent
small problems solved in lockstep (counterpart of the ``jax.vmap`` of a
``lax.while_loop`` optimizer in ``photon_ml_tpu/game/random_effect.py``'s
``_solver_for_bucket``).

``vmap`` of a ``while_loop`` runs the loop body for every entity until no
entity's condition holds, and selects the old state for the entities whose
condition is already false. The functions here do the same by hand: the
state is ``[E, D]`` (``[E]`` for scalars, ``[E, m, D]`` for the history),
every carried tensor is updated through ``torch.where`` on a per-entity
``active`` mask, and the loop stops when ``active.any()`` is false. An
entity that has converged, stalled, or ended its line search keeps its state
exactly. The nested line searches are batched the same way: each entity is
in its own bracket or zoom phase (strong Wolfe) or its own backtracking
step, both branches are evaluated under masks, and the search ends when no
entity is still searching. TRON's Steihaug CG loop is batched the same
way, with its own per-entity ``active`` mask.

The host reads the device once per outer iteration and once per
line-search trial or CG step (``any`` of a mask), never once per entity.
Per entity the iterates are those of the scalar ``optimize/lbfgs.py``,
``optimize/owlqn.py`` and ``optimize/tron.py`` up to rounding.

``fun_and_grad(W) -> (f [E], g [E, D])`` and ``fun(W) -> f [E]`` evaluate
every entity's objective at once.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from photon_ml_tpu_torch.optimize.common import (
    OptimizerConfig, converged_check, grad_converged,
)
from photon_ml_tpu_torch.optimize.tron import (
    _ETA0, _ETA1, _ETA2, _SIGMA1, _SIGMA2, _SIGMA3,
)

_BRACKET, _ZOOM, _DONE = 0, 1, 2


class BatchedResult(NamedTuple):
    """Per-entity final point and convergence record."""

    w: torch.Tensor            # [E, D]
    value: torch.Tensor        # [E]
    converged: torch.Tensor    # [E] bool
    iterations: torch.Tensor   # [E] int32
    host_syncs: int


def padded_sum(x: torch.Tensor) -> torch.Tensor:
    """Each entity's sum over the last axis, folded in halves over the next
    power of two: the pairs are those of a width that padding with zeros
    at the end cannot change (a zero half adds exact zeros), so an entity
    padded to other widths, as an entity-sharded run pads it, sums to the
    same bits. Only element-wise adds, so the CPU and the card round
    alike (``torch.sum`` groups its terms by the row's length and the
    device)."""
    width = x.shape[-1]
    full = 1 << (width - 1).bit_length()
    if full != width:
        x = torch.nn.functional.pad(x, (0, full - width))
    while full > 1:
        full //= 2
        x = x[..., :full] + x[..., full:]
    return x[..., 0]


def _rows_norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(padded_sum(a * a))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return padded_sum(a * b)


def _sel(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """``new`` where ``mask`` (per entity), else ``old``."""
    m = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim()))
    return torch.where(m, new, old)


def _slot(hist: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``hist[e, j[e]]`` for a per-entity slot index."""
    ar = torch.arange(hist.shape[0], device=hist.device)
    return hist[ar, j]


def two_loop_direction(g, s_hist, y_hist, rho, k, m: int):
    """Batched two-loop recursion over per-entity circular buffers
    ``s_hist``/``y_hist`` [E, m, D]; ``k`` [E] counts the pairs each entity
    ever stored; slots past ``min(k, m)`` are masked out."""
    n_valid = torch.clamp(k, max=m)
    q = g
    alphas = torch.zeros(rho.shape, dtype=g.dtype, device=g.device)
    ar = torch.arange(g.shape[0], device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for i in range(m):
        j = torch.remainder(k - 1 - i, m)
        a = torch.where(i < n_valid,
                        rho[ar, j] * _dot(s_hist[ar, j], q), zero)
        q = q - a[:, None] * y_hist[ar, j]
        alphas[ar, j] = a
    newest = torch.remainder(k - 1, m)
    sy = _dot(s_hist[ar, newest], y_hist[ar, newest])
    yy = _dot(y_hist[ar, newest], y_hist[ar, newest])
    tiny = torch.finfo(g.dtype).tiny
    gamma = torch.where((k > 0) & (yy > 0), sy / torch.clamp(yy, min=tiny),
                        torch.ones_like(yy))
    r = gamma[:, None] * q
    for i in range(m):
        rank = n_valid - 1 - i  # recency rank, oldest first
        j = torch.remainder(k - 1 - rank, m)
        beta = rho[ar, j] * _dot(y_hist[ar, j], r)
        upd = s_hist[ar, j] * (alphas[ar, j] - beta)[:, None]
        r = r + torch.where((rank >= 0)[:, None], upd, zero)
    return -r


def _store(s_hist, y_hist, rho, k, m, store, step, y, sy):
    """Write (step, y, 1/sy) into slot ``k mod m`` of the entities that
    ``store``; the others keep their history."""
    ar = torch.arange(k.shape[0], device=k.device)
    slot = torch.remainder(k, m)
    s_new, y_new, rho_new = s_hist.clone(), y_hist.clone(), rho.clone()
    s_new[ar, slot] = step
    y_new[ar, slot] = y
    rho_new[ar, slot] = 1.0 / torch.where(sy == 0, torch.ones_like(sy), sy)
    return (_sel(store, s_new, s_hist), _sel(store, y_new, y_hist),
            _sel(store, rho_new, rho))


def strong_wolfe(fun_and_grad: Callable, w, p, f0, g0, alpha0, searching,
                 c1: float = 1e-4, c2: float = 0.9, max_evals: int = 25,
                 alpha_max: float = 1e6):
    """Batched strong-Wolfe search (bracketing + zoom, Nocedal & Wright
    alg. 3.5/3.6) along ``p`` [E, D] from ``w``; ``searching`` [E] marks the
    entities that search at all (the others come back as if their
    direction were not a descent direction and are ignored by the caller).
    Returns ``(alpha, f, g, ok, host_syncs)``."""
    dtype, dev = f0.dtype, f0.device
    dphi0 = _dot(g0, p).to(dtype)
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def interp(a_lo, f_lo, dg_lo, a_hi, f_hi):
        denom = 2.0 * (f_hi - f_lo - dg_lo * (a_hi - a_lo))
        quad = a_lo - dg_lo * (a_hi - a_lo) ** 2 / torch.where(
            denom == 0, one, denom)
        mid = 0.5 * (a_lo + a_hi)
        lo, hi = torch.minimum(a_lo, a_hi), torch.maximum(a_lo, a_hi)
        width = hi - lo
        bad = (~torch.isfinite(quad) | (quad <= lo + 0.1 * width)
               | (quad >= hi - 0.1 * width) | (denom == 0))
        return torch.where(bad, mid, quad)

    E = f0.shape[0]
    phase = torch.full((E,), _BRACKET, dtype=torch.int32, device=dev)
    i = torch.zeros(E, dtype=torch.int32, device=dev)
    alpha = alpha0.to(dtype)
    f, dg, g = f0, dphi0, g0
    a_prev, f_prev, dg_prev = torch.zeros_like(f0), f0, dphi0
    a_lo, f_lo, dg_lo, g_lo = torch.zeros_like(f0), f0, dphi0, g0
    a_hi, f_hi = torch.full_like(f0, alpha_max), f0
    running = searching.clone()
    syncs = 0
    while True:
        syncs += 1
        if not bool(running.any()):  # the trial's one host read
            break
        f_t, g_t = fun_and_grad(w + alpha[:, None] * p)
        dg_t = _dot(g_t, p)
        armijo_fail = ((f_t > f0 + c1 * alpha * dphi0)
                       | ((f_t >= f_prev) & (i > 0)))
        curvature_ok = torch.abs(dg_t) <= -c2 * dphi0
        # bracket step
        b_zoom_hi = armijo_fail
        b_done = (~armijo_fail) & curvature_ok
        b_zoom_lo = (~armijo_fail) & (~curvature_ok) & (dg_t >= 0)
        b_phase = torch.where(
            b_done, _DONE, torch.where(b_zoom_hi | b_zoom_lo, _ZOOM,
                                       _BRACKET)).to(torch.int32)
        b_a_lo = torch.where(b_zoom_hi, a_prev, alpha)
        b_f_lo = torch.where(b_zoom_hi, f_prev, f_t)
        b_dg_lo = torch.where(b_zoom_hi, dg_prev, dg_t)
        b_g_lo = _sel(b_zoom_hi, g, g_t)
        b_a_hi = torch.where(b_zoom_hi, alpha, a_prev)
        b_f_hi = torch.where(b_zoom_hi, f_t, f_prev)
        b_alpha = torch.where(
            b_phase == _ZOOM, interp(b_a_lo, b_f_lo, b_dg_lo, b_a_hi, b_f_hi),
            torch.where(b_done, alpha,
                        torch.clamp(2.0 * alpha, max=alpha_max)))
        # zoom step
        hi_update = (f_t > f0 + c1 * alpha * dphi0) | (f_t >= f_lo)
        z_done = (~hi_update) & curvature_ok
        flip = (~hi_update) & (~curvature_ok) & (dg_t * (a_hi - a_lo) >= 0)
        z_a_hi = torch.where(hi_update, alpha,
                             torch.where(flip, a_lo, a_hi))
        z_f_hi = torch.where(hi_update, f_t, torch.where(flip, f_lo, f_hi))
        z_a_lo = torch.where(hi_update, a_lo, alpha)
        z_f_lo = torch.where(hi_update, f_lo, f_t)
        z_dg_lo = torch.where(hi_update, dg_lo, dg_t)
        z_g_lo = _sel(hi_update, g_lo, g_t)
        z_phase = torch.where(z_done, _DONE, _ZOOM).to(torch.int32)
        z_alpha = torch.where(z_done, alpha,
                              interp(z_a_lo, z_f_lo, z_dg_lo, z_a_hi, z_f_hi))
        br = phase == _BRACKET
        upd = running
        new_phase = torch.where(br, b_phase, z_phase)
        a_lo = torch.where(upd, torch.where(br, b_a_lo, z_a_lo), a_lo)
        f_lo = torch.where(upd, torch.where(br, b_f_lo, z_f_lo), f_lo)
        dg_lo = torch.where(upd, torch.where(br, b_dg_lo, z_dg_lo), dg_lo)
        g_lo = _sel(upd, _sel(br, b_g_lo, z_g_lo), g_lo)
        a_hi = torch.where(upd, torch.where(br, b_a_hi, z_a_hi), a_hi)
        f_hi = torch.where(upd, torch.where(br, b_f_hi, z_f_hi), f_hi)
        a_prev = torch.where(upd, alpha, a_prev)
        f_prev = torch.where(upd, f_t, f_prev)
        dg_prev = torch.where(upd, dg_t, dg_prev)
        f = torch.where(upd, f_t, f)
        dg = torch.where(upd, dg_t, dg)
        g = _sel(upd, g_t, g)
        alpha = torch.where(upd, torch.where(br, b_alpha, z_alpha), alpha)
        phase = torch.where(upd, new_phase, phase)
        i = i + upd.to(i.dtype)
        running = running & (phase != _DONE) & (i < max_evals)

    finished = phase == _DONE
    alpha = torch.where(finished, alpha, a_lo)
    f = torch.where(finished, f, f_lo)
    g = _sel(finished, g, g_lo)
    took_step = alpha > 0
    bad_direction = dphi0 >= 0
    alpha = torch.where(bad_direction, zero, alpha)
    f = torch.where(bad_direction, f0, f)
    g = _sel(bad_direction, g0, g)
    return alpha, f, g, (finished | took_step) & ~bad_direction, syncs


def lbfgs(fun_and_grad: Callable, w0: torch.Tensor,
          config: OptimizerConfig = OptimizerConfig()) -> BatchedResult:
    """Minimize each entity's ``f_e(w_e)``; ``fun_and_grad(W) -> (f, g)``
    over all entities at once. The per-entity rules are those of
    ``optimize/lbfgs.py``: strong-Wolfe search, history reset on a failed
    search, a stall when steepest descent itself fails, and a fit that
    converges on its first iteration keeps ``w0``."""
    m = config.history
    E, D = w0.shape
    dtype, dev = w0.dtype, w0.device
    tiny = torch.finfo(dtype).tiny
    f, g = fun_and_grad(w0)
    w = w0
    g0_norm = _rows_norm(g)
    s_hist = torch.zeros((E, m, D), dtype=dtype, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros((E, m), dtype=dtype, device=dev)
    k = torch.zeros(E, dtype=torch.int64, device=dev)
    it = torch.zeros(E, dtype=torch.int32, device=dev)
    converged = torch.zeros(E, dtype=torch.bool, device=dev)
    active = torch.ones(E, dtype=torch.bool, device=dev) \
        if config.max_iters > 0 else torch.zeros(E, dtype=torch.bool,
                                                 device=dev)
    syncs = 0
    while True:
        syncs += 1
        if not bool(active.any()):  # the iteration's one host read
            break
        p = two_loop_direction(g, s_hist, y_hist, rho, k, m)
        p = _sel(_dot(p, g) < 0, p, -g)
        alpha0 = torch.where(k > 0, torch.ones_like(f),
                             1.0 / torch.clamp(_rows_norm(g), min=1.0))
        alpha, f_ls, g_ls, ok, ls_syncs = strong_wolfe(
            fun_and_grad, w, p, f, g, alpha0, active,
            max_evals=config.max_line_search_steps)
        syncs += ls_syncs
        step = alpha[:, None] * p
        y = g_ls - g
        sy = _dot(step, y)
        store = ok & (sy > 1e-10 * torch.clamp(
            _rows_norm(step) * _rows_norm(y), min=tiny))
        s_new, y_new, rho_new = _store(s_hist, y_hist, rho, k, m, store,
                                       step, y, sy)
        k_new = torch.where(store, k + 1, torch.where(ok, k,
                                                      torch.zeros_like(k)))
        stalled = (~ok) & (k == 0)
        gnorm = _rows_norm(g_ls)
        # a failed search leaves f unchanged: only the gradient half of
        # the convergence test stays meaningful
        conv = torch.where(
            ok, converged_check(f, f_ls, gnorm, g0_norm, config.tolerance),
            grad_converged(gnorm, g0_norm, config.tolerance))
        take = active & ~(conv & (it == 0))
        w = _sel(take, w + step, w)
        f = torch.where(take, f_ls, f)
        g = _sel(take, g_ls, g)
        s_hist = _sel(active, s_new, s_hist)
        y_hist = _sel(active, y_new, y_hist)
        rho = _sel(active, rho_new, rho)
        k = torch.where(active, k_new, k)
        converged = torch.where(active, conv, converged)
        it = it + active.to(it.dtype)
        active = active & ~conv & ~stalled & (it < config.max_iters)
    return BatchedResult(w, f, converged, it, syncs)


def pseudo_gradient(w, g, l1):
    """Directional-derivative-minimizing subgradient of f + l1*|w|_1."""
    right = g + l1
    left = g - l1
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    at_zero = torch.where(right < 0, right, torch.where(left > 0, left, zero))
    return torch.where(w > 0, right, torch.where(w < 0, left, at_zero))


def backtracking(fun: Callable, w, p, f0, pseudo_grad, alpha0, searching,
                 project: Callable, c1: float = 1e-4, shrink: float = 0.5,
                 max_evals: int = 30):
    """Batched Armijo backtracking with orthant projection (the OWL-QN
    form ``f_new <= f0 + c1 * pseudo_grad . (w_new - w)``). Returns
    ``(w_new, f_new, ok, host_syncs)``; an entity that fails keeps ``w``
    and ``f0``."""
    alpha = alpha0.to(f0.dtype)
    w_new, f_new = w, f0
    i = torch.zeros(f0.shape, dtype=torch.int32, device=f0.device)
    ok = torch.zeros(f0.shape, dtype=torch.bool, device=f0.device)
    running = searching.clone()
    syncs = 0
    while True:
        syncs += 1
        if not bool(running.any()):  # the trial's one host read
            break
        w_t = project(w + alpha[:, None] * p)
        f_t = fun(w_t)
        ok_t = f_t <= f0 + c1 * _dot(pseudo_grad, w_t - w)
        alpha = torch.where(running & ~ok_t, alpha * shrink, alpha)
        w_new = _sel(running, w_t, w_new)
        f_new = torch.where(running, f_t, f_new)
        ok = torch.where(running, ok_t, ok)
        i = i + running.to(i.dtype)
        running = running & ~ok & (i < max_evals)
    return _sel(ok, w_new, w), torch.where(ok, f_new, f0), ok, syncs


def owlqn(fun_and_grad: Callable, w0: torch.Tensor, l1_weight,
          config: OptimizerConfig = OptimizerConfig(),
          fun: Optional[Callable] = None) -> BatchedResult:
    """Minimize each entity's ``f_e(w_e) + l1_weight * ||w_e||_1``
    (per-entity rules of ``optimize/owlqn.py``; every coordinate
    penalized, as the JAX package's per-entity OWL-QN runs without a mask).
    ``fun`` is the value alone, for the line-search trials."""
    m = config.history
    E, D = w0.shape
    dtype, dev = w0.dtype, w0.device
    tiny = torch.finfo(dtype).tiny
    lam = torch.as_tensor(l1_weight, dtype=dtype, device=dev)
    if fun is None:
        def fun(W):
            return fun_and_grad(W)[0]

    def full_value(W):
        return fun(W) + padded_sum(lam * torch.abs(W))

    f0, g = fun_and_grad(w0)
    w, F = w0, f0 + padded_sum(lam * torch.abs(w0))
    pg0_norm = _rows_norm(pseudo_gradient(w0, g, lam))
    s_hist = torch.zeros((E, m, D), dtype=dtype, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros((E, m), dtype=dtype, device=dev)
    k = torch.zeros(E, dtype=torch.int64, device=dev)
    it = torch.zeros(E, dtype=torch.int32, device=dev)
    converged = torch.zeros(E, dtype=torch.bool, device=dev)
    active = torch.full((E,), config.max_iters > 0, dtype=torch.bool,
                        device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    syncs = 0
    while True:
        syncs += 1
        if not bool(active.any()):  # the iteration's one host read
            break
        pg = pseudo_gradient(w, g, lam)
        p = two_loop_direction(pg, s_hist, y_hist, rho, k, m)
        p = torch.where(p * (-pg) > 0, p, zero)
        p = _sel(_dot(p, pg) < 0, p, -pg)
        xi = torch.where(w != 0, torch.sign(w), torch.sign(-pg))

        def project(w_trial, xi=xi):
            return torch.where(w_trial * xi > 0, w_trial, zero)

        alpha0 = torch.where(k > 0, torch.ones_like(F),
                             1.0 / torch.clamp(_rows_norm(pg), min=1.0))
        w_ls, F_ls, ok, ls_syncs = backtracking(
            full_value, w, p, F, pg, alpha0, active, project,
            max_evals=config.max_line_search_steps)
        syncs += ls_syncs
        _, g_new = fun_and_grad(w_ls)
        step = w_ls - w
        y = g_new - g
        sy = _dot(step, y)
        store = ok & (sy > 1e-10 * torch.clamp(
            _rows_norm(step) * _rows_norm(y), min=tiny))
        s_new, y_new, rho_new = _store(s_hist, y_hist, rho, k, m, store,
                                       step, y, sy)
        pg_new_norm = _rows_norm(pseudo_gradient(w_ls, g_new, lam))
        conv = converged_check(F, F_ls, pg_new_norm, pg0_norm,
                               config.tolerance)
        w = _sel(active, w_ls, w)
        F = torch.where(active, F_ls, F)
        g = _sel(active, g_new, g)
        s_hist = _sel(active, s_new, s_hist)
        y_hist = _sel(active, y_new, y_hist)
        rho = _sel(active, rho_new, rho)
        k = torch.where(active & store, k + 1, k)
        converged = torch.where(active, conv, converged)
        it = it + active.to(it.dtype)
        active = active & ~conv & ok & (it < config.max_iters)
    return BatchedResult(w, F, converged, it, syncs)


def steihaug_cg(hvp: Callable, g, delta, cg_tol, max_cg: int, searching):
    """Batched Steihaug CG (``optimize/tron.py::_steihaug_cg`` without a
    preconditioner): each entity approximately minimizes
    ``g.s + 0.5 s.H.s`` within its radius ``delta`` [E]; ``hvp(V) -> [E, D]``
    applies every entity's Hessian at once. ``searching`` [E] marks the
    entities that run at all. An entity stops at the trust-region boundary,
    on negative curvature, once ``|r| <= cg_tol`` [E], or after ``max_cg``
    steps; the others keep stepping. Returns ``(s, r, host_syncs)`` with the
    residual ``r == -(g + H s)``."""
    tiny = torch.finfo(g.dtype).tiny
    one = torch.ones((), dtype=g.dtype, device=g.device)

    def boundary_tau(s, d):
        sd, dd, ss = _dot(s, d), _dot(d, d), _dot(s, s)
        disc = torch.sqrt(torch.clamp(sd * sd + dd * (delta * delta - ss),
                                      min=0.0))
        return (-sd + disc) / torch.clamp(dd, min=tiny)

    s = torch.zeros_like(g)
    r = -g
    d = r
    rz = _dot(r, r)
    i = torch.zeros(g.shape[0], dtype=torch.int32, device=g.device)
    running = searching.clone()
    syncs = 0
    while True:
        syncs += 1
        if not bool(running.any()):  # the step's one host read
            break
        Hd = hvp(d)
        dHd = _dot(d, Hd)
        neg_curv = dHd <= 0
        alpha = rz / torch.where(neg_curv, one, dHd)
        s_alpha = s + alpha[:, None] * d
        hit = neg_curv | (_rows_norm(s_alpha) >= delta)
        # one uniform update keeps r == -(g + H s) exact on the boundary
        step = torch.where(hit, boundary_tau(s, d), alpha)
        s_new = s + step[:, None] * d
        r_new = r - step[:, None] * Hd
        rz_new = _dot(r_new, r_new)
        d_new = r_new + (rz_new / torch.clamp(rz, min=tiny))[:, None] * d
        s = _sel(running, s_new, s)
        r = _sel(running, r_new, r)
        d = _sel(running, d_new, d)
        rz = torch.where(running, rz_new, rz)
        i = i + running.to(i.dtype)
        done = hit | (_rows_norm(r_new) <= cg_tol)
        running = running & ~done & (i < max_cg)
    return s, r, syncs


def tron(fun_and_grad: Callable, w0: torch.Tensor, hvp: Callable,
         config: OptimizerConfig = OptimizerConfig()) -> BatchedResult:
    """Minimize each entity's ``f_e(w_e)`` by trust-region Newton with a
    Steihaug CG inner loop (per-entity rules of ``optimize/tron.py``,
    unpreconditioned, as the JAX package's per-entity TRON runs).
    ``hvp(W)`` returns the Hessian-vector product at ``W`` as an operator
    ``V -> [E, D]`` (each entity's Hessian applied to its row of ``V``); it
    is built once per outer iteration, so the curvature at ``W`` is paid
    once, not once per CG step. CG runs at most ``max(D, 20)`` steps per
    outer iteration to ``0.1 |g|``, as in the reference."""
    E, D = w0.shape
    dtype, dev = w0.dtype, w0.device
    eps = torch.finfo(dtype).eps
    max_cg = max(D, 20)
    f, g = fun_and_grad(w0)
    w = w0
    g0_norm = _rows_norm(g)
    delta = g0_norm
    it = torch.zeros(E, dtype=torch.int32, device=dev)
    converged = torch.zeros(E, dtype=torch.bool, device=dev)
    active = torch.full((E,), config.max_iters > 0, dtype=torch.bool,
                        device=dev)
    sigma3 = torch.full((), _SIGMA3, dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    syncs = 0
    while True:
        syncs += 1
        if not bool(active.any()):  # the iteration's one host read
            break
        step, r, cg_syncs = steihaug_cg(hvp(w), g, delta,
                                        0.1 * _rows_norm(g), max_cg, active)
        syncs += cg_syncs
        w_try = w + step
        f_try, g_try = fun_and_grad(w_try)
        gs = _dot(g, step)
        # r == -(g + H step), so prered = 0.5 * (r.s - g.s): no extra HVP
        prered = 0.5 * (_dot(step, r) - gs)
        actred = f - f_try
        snorm = _rows_norm(step)
        # Lin-More radius update via quadratic interpolation
        denom = f_try - f - gs
        alpha = torch.where(
            denom <= 0, sigma3,
            torch.clamp(-0.5 * (gs / torch.where(denom == 0, one, denom)),
                        min=_SIGMA1))
        a_snorm = alpha * snorm
        delta_new = torch.where(
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
        w_new = _sel(accept, w_try, w)
        f_new = torch.where(accept, f_try, f)
        g_new = _sel(accept, g_try, g)
        conv = accept & converged_check(f, f_new, _rows_norm(g_new), g0_norm,
                                        config.tolerance)
        # the quadratic model predicting no significant reduction IS
        # convergence (nothing left to gain at this dtype's resolution)
        conv = conv | (prered <= eps * torch.clamp(torch.abs(f), min=1.0))
        # radius below step resolution at w: further steps can't move w
        stalled = delta_new < eps * torch.clamp(_rows_norm(w_new), min=1.0)
        w = _sel(active, w_new, w)
        f = torch.where(active, f_new, f)
        g = _sel(active, g_new, g)
        delta = torch.where(active, delta_new, delta)
        converged = torch.where(active, conv, converged)
        it = it + active.to(it.dtype)
        active = active & ~conv & ~stalled & (it < config.max_iters)
    return BatchedResult(w, f, converged, it, syncs)
