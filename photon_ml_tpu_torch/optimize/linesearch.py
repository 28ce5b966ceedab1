"""Line searches (counterpart of ``photon_ml_tpu/optimize/linesearch.py``).

:func:`strong_wolfe`: bracketing + zoom (Nocedal & Wright alg. 3.5/3.6)
with safeguarded quadratic interpolation and bisection fallback. The JAX
version is one ``lax.while_loop`` over a phase state machine; here it is a
Python loop whose numeric state stays on the device as 0-d tensors, updated
with the same ``where`` arithmetic. The host reads one small tensor per
trial (the phase flags), which decides whether to stop and which step runs
next.

:func:`backtracking`: Armijo backtracking with an optional orthant
projection (OWL-QN); the host reads the Armijo flag once per trial.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

_BRACKET, _ZOOM, _DONE = 0, 1, 2


class LineSearchResult(NamedTuple):
    alpha: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor  # gradient at w + alpha * p
    n_evals: int
    ok: torch.Tensor  # strong-Wolfe satisfied (else best-effort Armijo point)
    host_syncs: int


def strong_wolfe(
    fun_and_grad: Callable,
    w: torch.Tensor,
    p: torch.Tensor,
    f0: torch.Tensor,
    g0: torch.Tensor,
    alpha0=1.0,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_evals: int = 25,
    alpha_max: float = 1e6,
) -> LineSearchResult:
    """Search along p from w. fun_and_grad(w) -> (f, g). Requires p a descent
    direction (dphi0 < 0); otherwise returns alpha=0, ok=False."""
    dtype, dev = f0.dtype, f0.device

    def scalar(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    one = scalar(1.0)
    dphi0 = torch.sum(g0 * p).to(dtype)

    def phi(alpha):
        f, g = fun_and_grad(w + alpha * p)
        return f, torch.sum(g * p), g

    def interp(a_lo, f_lo, dg_lo, a_hi, f_hi):
        # safeguarded quadratic interpolation on [lo, hi]
        denom = 2.0 * (f_hi - f_lo - dg_lo * (a_hi - a_lo))
        quad = a_lo - dg_lo * (a_hi - a_lo) ** 2 / torch.where(denom == 0,
                                                               one, denom)
        mid = 0.5 * (a_lo + a_hi)
        lo, hi = torch.minimum(a_lo, a_hi), torch.maximum(a_lo, a_hi)
        width = hi - lo
        bad = (~torch.isfinite(quad) | (quad <= lo + 0.1 * width)
               | (quad >= hi - 0.1 * width) | (denom == 0))
        return torch.where(bad, mid, quad)

    zero = scalar(0.0)
    alpha = scalar(alpha0)
    f, dg, g = f0, dphi0, g0
    a_prev, f_prev, dg_prev = zero, f0, dphi0
    a_lo, f_lo, dg_lo, g_lo = zero, f0, dphi0, g0
    a_hi, f_hi = scalar(alpha_max), f0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    phase, i, syncs = _BRACKET, 0, 0
    while True:
        f, dg, g_new = phi(alpha)
        curvature_ok = torch.abs(dg) <= -c2 * dphi0
        if phase == _BRACKET:
            # cases per Nocedal & Wright alg 3.5
            armijo_fail = f > f0 + c1 * alpha * dphi0
            if i > 0:
                armijo_fail = armijo_fail | (f >= f_prev)
            to_zoom_hi = armijo_fail  # zoom(prev, cur)
            done = (~armijo_fail) & curvature_ok
            to_zoom_lo = (~armijo_fail) & (~curvature_ok) & (dg >= 0)
            zoom = to_zoom_hi | to_zoom_lo
            a_lo = torch.where(to_zoom_hi, a_prev, alpha)
            f_lo = torch.where(to_zoom_hi, f_prev, f)
            dg_lo = torch.where(to_zoom_hi, dg_prev, dg)
            g_lo = torch.where(to_zoom_hi, g, g_new)  # best-known g
            a_hi = torch.where(to_zoom_hi, alpha, a_prev)
            f_hi = torch.where(to_zoom_hi, f, f_prev)
            alpha_next = torch.where(
                zoom, interp(a_lo, f_lo, dg_lo, a_hi, f_hi),
                torch.where(done, alpha,
                            torch.clamp(2.0 * alpha, max=alpha_max)))
            flags = torch.stack([done, zoom])
        else:
            hi_update = (f > f0 + c1 * alpha * dphi0) | (f >= f_lo)
            done = (~hi_update) & curvature_ok
            flip = (~hi_update) & (~curvature_ok) & (dg * (a_hi - a_lo) >= 0)
            a_hi, f_hi = (
                torch.where(hi_update, alpha, torch.where(flip, a_lo, a_hi)),
                torch.where(hi_update, f, torch.where(flip, f_lo, f_hi)))
            a_lo = torch.where(hi_update, a_lo, alpha)
            f_lo = torch.where(hi_update, f_lo, f)
            dg_lo = torch.where(hi_update, dg_lo, dg)
            g_lo = torch.where(hi_update, g_lo, g_new)
            alpha_next = torch.where(done, alpha,
                                     interp(a_lo, f_lo, dg_lo, a_hi, f_hi))
            flags = done[None]
        i += 1
        g = g_new
        a_prev, f_prev, dg_prev = alpha, f, dg
        if i >= max_evals:
            alpha = alpha_next
            break
        alpha = alpha_next
        flags = flags.tolist()  # the trial's one host read
        syncs += 1
        if flags[0]:
            break
        if phase == _BRACKET and flags[1]:
            phase = _ZOOM

    # On exhaustion fall back to the best bracket point (a_lo satisfies
    # Armijo by construction once zoom is entered); if nothing worked, take
    # no step.
    alpha = torch.where(done, alpha, a_lo)
    f = torch.where(done, f, f_lo)
    g = torch.where(done, g, g_lo)
    took_step = alpha > 0
    bad_direction = dphi0 >= 0
    alpha = torch.where(bad_direction, zero, alpha)
    f = torch.where(bad_direction, f0, f)
    g = torch.where(bad_direction, g0, g)
    return LineSearchResult(alpha, f, g, i, (done | took_step) & ~bad_direction,
                            syncs)


class BacktrackingResult(NamedTuple):
    w: torch.Tensor  # the accepted point (w itself on failure)
    f: torch.Tensor  # its value (f0 on failure)
    n_evals: int  # trials made; the host read the Armijo flag after each
    ok: bool


def backtracking(
    fun: Callable,
    w: torch.Tensor,
    p: torch.Tensor,
    f0: torch.Tensor,
    pseudo_grad: torch.Tensor,
    alpha0=1.0,
    c1: float = 1e-4,
    shrink: float = 0.5,
    max_evals: int = 30,
    project: Optional[Callable] = None,
) -> BacktrackingResult:
    """Armijo backtracking with optional orthant projection (OWL-QN style).

    ``fun(w) -> f``. ``project(w_trial)`` maps the trial point back to the
    feasible orthant before evaluation (identity if None). The sufficient
    decrease test is the OWL-QN form
    ``f_new <= f0 + c1 * pseudo_grad . (w_new - w)``, plain Armijo when
    ``project`` is None and ``pseudo_grad`` is the gradient."""
    alpha = torch.as_tensor(alpha0, dtype=f0.dtype, device=f0.device)
    w_new, f_new, ok, i = w, f0, False, 0
    while i < max_evals:
        w_new = w + alpha * p
        if project is not None:
            w_new = project(w_new)
        f_new = fun(w_new)
        i += 1
        ok = bool(f_new <= f0 + c1 * torch.sum(pseudo_grad * (w_new - w)))
        if ok:
            break
        alpha = alpha * shrink
    if not ok:
        w_new, f_new = w, f0
    return BacktrackingResult(w_new, f_new, i, ok)
