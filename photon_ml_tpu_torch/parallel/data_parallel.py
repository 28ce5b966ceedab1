"""The fixed-effect GLM fit (counterpart of
``photon_ml_tpu/parallel/data_parallel.py``), on one device or sharded by
rows over a mesh.

The JAX package shards the batch over a mesh and joins per-shard partial
sums with ``psum``. Here a mesh is ``parallel.mesh.make_mesh``'s
``DeviceMesh``, one process per device: each rank keeps its own row block
of the batch (``parallel.mesh.shard_batch``) on its own device, computes
its partial data terms, and joins them with one ``all_reduce`` over the
mesh's ``axis`` group per pass (a [d] gradient and its value in one
buffer; a line-search trial's two scalars in one 2-vector). The L2 term
is added once, after the reduction. Every rank then runs the same
optimizer arithmetic on the same reduced values, so every rank ends with
the same ``w`` bit for bit. ``mesh=None`` is one device with no collective.

A fit takes one of three paths:

* the margin path (``optimizer="lbfgs"``, ``line_search="margin"``):
  :func:`~photon_ml_tpu_torch.optimize.lbfgs_margin.lbfgs_margin` on cached
  margin vectors, two data passes per iteration;
* the CSC path (any other optimizer or line search, ``sparse_grad`` a
  column-sorted mode): the optimizer runs against the closures of
  :func:`make_csc_path`;
* the full path (``"scatter"`` or dense features): the optimizer runs
  against the objective itself.

``X^T d`` is computed in one of five modes:

* ``"scatter"``: ``index_add_`` over the ELL layout (on CUDA it sums in
  atomic order, so two runs may differ in the last bits);
* ``"csc"``: the plain blocked column-sorted path
  (``types.csc_transpose_apply``);
* ``"csc_kernel"``: the column-sorted path through the hand-written kernel
  (``ops.kernels.csc_transpose_apply_kernel``), on each rank's own block;
* ``"csc_precise"``: the column-sorted path with one float64 global prefix;
* ``"csc_segment"``: the column-sorted path as a sorted segment sum
  (``types.csc_segment_apply``).

The column-sorted modes use no atomics, so their fits are bit-reproducible
from run to run; TRON's Jacobi preconditioner goes through the same view.

In place of the JAX module's ``compiled_kernel_count`` (the XLA executables
cached per objective, which eager torch does not build), each fit's result
carries what the fit cost the card: ``kernel_launches`` (the
``ops.kernels.csc_column_sums`` launches it made) beside ``host_syncs``
(its device-to-host reads).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from photon_ml_tpu_torch.ops.kernels import (
    TILE, csc_column_sums, csc_transpose_apply_kernel,
)
from photon_ml_tpu_torch.ops.losses import apply_weights, mask_margins
from photon_ml_tpu_torch.ops.normalization import (
    eff_coeffs, norm_chain_t, norm_fixed_fs,
)
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optimize import get_optimizer
from photon_ml_tpu_torch.optimize.common import (
    OptimizationResult, OptimizerConfig,
)
from photon_ml_tpu_torch.optimize.lbfgs_margin import lbfgs_margin
from photon_ml_tpu_torch.parallel.mesh import (
    all_reduce_sum, replicate, shard_batch,
)
from photon_ml_tpu_torch.types import (
    CSCTranspose, LabeledBatch, SparseFeatures, build_csc_transpose,
    csc_segment_apply, csc_transpose_apply, margins as ell_margins,
    transpose_apply,
)

SPARSE_GRAD_MODES = ("scatter", "csc", "csc_kernel", "csc_precise",
                     "csc_segment")
_CSC_APPLY = {
    # the plain path differences float64 prefixes local to blocks of the
    # TPU kernel's tile (32,768 elements); "csc_kernel" sums each column
    # in float64 in one pass, so the two round a column sum apart
    "csc": functools.partial(csc_transpose_apply, block=TILE),
    "csc_kernel": csc_transpose_apply_kernel,
    "csc_precise": functools.partial(csc_transpose_apply, precise=True),
    "csc_segment": csc_segment_apply,
}
LINE_SEARCHES = ("margin", "full")


def _reducer(mesh, axis: str) -> Optional[Callable]:
    """``red(*parts) -> parts`` summed over the mesh's ``axis`` in ONE
    ``all_reduce`` (the parts share a dtype and device), or None for
    ``mesh=None``."""
    if mesh is None:
        return None

    def red(*parts):
        flat = torch.cat([p.reshape(-1) for p in parts])
        all_reduce_sum(flat, mesh, axis)
        out, at = [], 0
        for p in parts:
            out.append(flat[at:at + p.numel()].reshape(p.shape))
            at += p.numel()
        return out

    return red


def distributed_value_and_grad(objective: GLMObjective, *, mesh=None,
                               axis: str = "data") -> Callable:
    """``fg(w, batch, l2) -> (value, grad)`` on the batch's device; with a
    mesh, ``batch`` is this rank's block and the data terms are summed over
    ``axis`` before the L2 term is added once."""
    red = _reducer(mesh, axis)

    def fg(w, batch, l2=0.0):
        if red is None:
            return objective.value_and_grad(w, batch, l2)
        f, g = red(*objective.value_and_grad(w, batch, 0.0))
        wr = objective.reg_mask(w)
        return f + 0.5 * l2 * torch.sum(wr * wr), g + l2 * wr

    return fg


def distributed_value(objective: GLMObjective, *, mesh=None,
                      axis: str = "data") -> Callable:
    """``value(w, batch, l2)``: the objective's value alone, one forward
    pass (OWL-QN's line-search trials), reduced like
    :func:`distributed_value_and_grad`."""
    red = _reducer(mesh, axis)

    def value(w, batch, l2=0.0):
        if red is None:
            return objective.value(w, batch, l2)
        (f,) = red(objective.value(w, batch, 0.0))
        wr = objective.reg_mask(w)
        return f + 0.5 * l2 * torch.sum(wr * wr)

    return value


def distributed_hvp(objective: GLMObjective, *, mesh=None,
                    axis: str = "data") -> Callable:
    """``hvp(w, v, batch, l2)``: one Hessian-vector product, a full pass
    over the data (the closed form of ``GLMObjective.hvp``)."""
    red = _reducer(mesh, axis)

    def hvp(w, v, batch, l2=0.0):
        if red is None:
            return objective.hvp(w, v, batch, l2)
        (hv,) = red(objective.hvp(w, v, batch, 0.0))
        return hv + l2 * objective.reg_mask(v)

    return hvp


def distributed_diagonal_hessian(objective: GLMObjective, *, mesh=None,
                                 axis: str = "data") -> Callable:
    """``diag(w, batch, l2)``: the exact Hessian diagonal, one data pass;
    feeds TRON's Jacobi preconditioner on the full path."""
    red = _reducer(mesh, axis)

    def diag(w, batch, l2=0.0):
        if red is None:
            return objective.diagonal_hessian(w, batch, l2)
        (d,) = red(objective.diagonal_hessian(w, batch, 0.0))
        return d + objective.reg_diagonal(d, l2)

    return diag


def distributed_coefficient_variances(objective: GLMObjective, *, mesh=None,
                                      axis: str = "data") -> Callable:
    """``var(w, batch, l2, mode)``: ``GLMObjective.coefficient_variances``
    with the data term's Hessian (diagonal or full) summed over the axis
    before the L2 term is added and the result inverted."""
    red = _reducer(mesh, axis)
    reduce = None if red is None else (lambda h: red(h)[0])

    def var(w, batch, l2=0.0, mode: str = "diagonal"):
        return objective.coefficient_variances(w, batch, l2, mode=mode,
                                               reduce=reduce)

    return var


def resolve_sparse_grad(sparse_grad: str, features=None) -> str:
    """Resolve ``"auto"``: sparse features take ``"csc_kernel"``, chosen
    because the column-sorted path is deterministic and scatter-free, not
    because it was measured faster (on a CPU tensor the kernel's wrapper
    takes its plain version). Dense features take ``"scatter"``, where
    ``X^T d`` is a plain matmul."""
    if sparse_grad == "auto":
        if features is not None and not isinstance(features, SparseFeatures):
            return "scatter"
        return "csc_kernel"
    if sparse_grad not in SPARSE_GRAD_MODES:
        raise ValueError(f"unknown sparse_grad {sparse_grad!r}; known: "
                         f"{('auto',) + SPARSE_GRAD_MODES}")
    return sparse_grad


def make_csc_path(objective: GLMObjective, use_kernel: bool = False,
                  precise: bool = False, segment: bool = False,
                  with_cols: Optional[bool] = None, *, mesh=None,
                  axis: str = "data"):
    """Scatter-free sparse gradient path (see ``types.CSCTranspose``).

    Returns ``(build, fg, hvp)``: ``build(batch)`` sorts the nonzeros by
    column (once per fit, or once per dataset through
    :func:`build_csc`); ``fg(w, batch, csc, l2)`` and
    ``hvp(w, v, batch, csc, l2)`` evaluate the objective with explicit
    margin-space derivatives: forward is the ELL gather, backward is ``X^T
    d`` through the column-sorted view, and normalization maps through
    ``eff_coeffs`` / ``norm_chain_t``. Requires SparseFeatures. With a
    mesh, ``batch`` and ``csc`` are this rank's block and its view, and
    the data terms are summed over ``axis`` (the normalization chain is
    linear, so it commutes with the sum)."""
    if with_cols is None:
        with_cols = segment
    if use_kernel:
        if precise:
            raise ValueError("precise (one global f64 prefix) accumulation "
                             "is not available in the kernel; use "
                             "sparse_grad='csc_precise'")
        apply_t = _CSC_APPLY["csc_kernel"]
    elif segment:
        apply_t = _CSC_APPLY["csc_segment"]
    elif precise:
        apply_t = _CSC_APPLY["csc_precise"]
    else:
        apply_t = _CSC_APPLY["csc"]
    norm = objective.normalization
    red = _reducer(mesh, axis)

    def build(batch: LabeledBatch) -> CSCTranspose:
        return build_csc(batch, with_cols=with_cols)

    def fg(w, batch, csc, l2=0.0):
        m = mask_margins(batch.weights, objective.margins(w, batch))
        f = torch.sum(apply_weights(batch.weights,
                                    objective.loss.loss(m, batch.labels)))
        d1 = apply_weights(batch.weights, objective.loss.d1(m, batch.labels))
        g = norm_chain_t(norm, apply_t(csc, d1), torch.sum(d1))
        if red is not None:
            f, g = red(f, g)
        wr = objective.reg_mask(w)
        return f + 0.5 * l2 * torch.sum(wr * wr), g + l2 * wr

    def hvp(w, v, batch, csc, l2=0.0):
        # the margin is linear in w, so v maps through the same
        # effective-coefficient map (no offset term)
        v_eff, v_adjust = eff_coeffs(norm, v)
        dv = (objective.curvature(w, batch)
              * (ell_margins(batch.features, v_eff) + v_adjust))
        hv = norm_chain_t(norm, apply_t(csc, dv), torch.sum(dv))
        if red is not None:
            (hv,) = red(hv)
        return hv + l2 * objective.reg_mask(v)

    return build, fg, hvp


def make_csc_diagonal_hessian(objective: GLMObjective,
                              sparse_grad: str = "csc", *, mesh=None,
                              axis: str = "data"):
    """TRON's Jacobi preconditioner through the column-sorted view, so a
    CSC fit stays free of atomics (``GLMObjective.diagonal_hessian``
    scatters). Returns ``(squares, diag)``: ``squares(csc)`` is the view of
    squared values (the view itself for implicit ones, since 1^2 == 1),
    built once per fit; ``diag(w, batch, csc, csc_sq, l2)`` is the exact
    Hessian diagonal, with the normalization expansion of
    ``GLMObjective.diagonal_hessian``; with a mesh the data diagonal is
    summed over ``axis`` before the L2 diagonal is added."""
    apply_t = _CSC_APPLY[sparse_grad]
    red = _reducer(mesh, axis)

    def squares(csc: CSCTranspose) -> CSCTranspose:
        if csc.values is None:
            return csc
        return dataclasses.replace(csc, values=csc.values * csc.values)

    def diag(w, batch, csc, csc_sq, l2=0.0):
        d2 = objective.curvature(w, batch)
        out = apply_t(csc_sq, d2)
        f, s = norm_fixed_fs(objective.normalization, out.dtype)
        if s is not None:
            xd2 = out if csc_sq is csc else apply_t(csc, d2)
            out = out - 2.0 * s * xd2 + s * s * torch.sum(d2)
        if f is not None:
            out = out * f * f
        if red is not None:
            (out,) = red(out)
        return out + objective.reg_diagonal(out, l2)

    return squares, diag


def build_csc(batch: LabeledBatch, with_cols: bool = True, *, mesh=None,
              axis: str = "data") -> CSCTranspose:
    """The column-sorted (CSC) view of a batch, built once per dataset for
    reuse across fits (``fit_distributed(..., precomputed_csc=...)``).
    ``with_cols`` keeps the sorted column ids that ``"csc_segment"``
    reads, so one view serves every mode. With a mesh, the view is of
    this rank's block, padded and cut as ``fit_distributed`` cuts it."""
    if mesh is not None:
        batch = shard_batch(batch, mesh, axis)
    feats = batch.features
    if not isinstance(feats, SparseFeatures):
        raise ValueError("CSC path needs SparseFeatures")
    return build_csc_transpose(feats.indices, feats.values, feats.dim,
                               with_cols=with_cols)


def make_margin_path(objective: GLMObjective, transpose: str = "scatter",
                     *, mesh=None, axis: str = "data"):
    """Margin-space primitives for :func:`lbfgs_margin`.

    Returns ``(init_margin, dir_margin, loss_and_dir, make_data_grad,
    delta_and_dir)``:

    * ``init_margin(w, batch)``: margins of the starting point, offsets and
      normalization adjust included.
    * ``dir_margin(batch)(p)``: the linear margin of a direction, no offsets
      (the per-iteration gather pass).
    * ``loss_and_dir(batch)(m, mp)``: ``(sum w_i l(m_i), sum w_i l'(m_i)
      mp_i)``, the O(n) line-search trial evaluation.
    * ``make_data_grad(batch, csc)(m)``: the data-term gradient from margins
      (the per-iteration transpose pass), normalization chain rule included.
    * ``delta_and_dir(batch)(m, mp, alpha)``: the trial evaluation in DELTA
      space, summing per-row loss differences ``l(m + a*mp) - l(m)`` so the
      improvement keeps its relative accuracy in f32.

    With a mesh, margins stay this rank's rows; each trial's two scalars
    are summed over ``axis`` as one 2-vector, and the gradient as one [d]
    vector, so the host reads per fit are those of one device.
    """
    norm = objective.normalization
    loss = objective.loss
    red = _reducer(mesh, axis)
    if transpose != "scatter" and transpose not in _CSC_APPLY:
        raise ValueError(f"unknown transpose {transpose!r}")

    def d1_of(m, labels, weights):
        return apply_weights(weights,
                             loss.d1(mask_margins(weights, m), labels))

    def init_margin(w, batch):
        w_eff, adjust = eff_coeffs(norm, w)
        return ell_margins(batch.features, w_eff) + batch.offsets + adjust

    def dir_margin(batch):
        def f(p):
            p_eff, p_adjust = eff_coeffs(norm, p)
            return ell_margins(batch.features, p_eff) + p_adjust

        return f

    def loss_and_dir(batch):
        labels, weights = batch.labels, batch.weights

        def f(m, mp):
            value = torch.sum(apply_weights(
                weights, loss.loss(mask_margins(weights, m), labels)))
            out = value, torch.sum(d1_of(m, labels, weights) * mp)
            return out if red is None else red(torch.stack(out))[0].unbind()

        return f

    def delta_and_dir(batch):
        labels, weights = batch.labels, batch.weights

        def f(m, mp, alpha):
            m1 = m + alpha * mp
            diffs = apply_weights(
                weights,
                loss.loss(mask_margins(weights, m1), labels)
                - loss.loss(mask_margins(weights, m), labels))
            out = (torch.sum(diffs),
                   torch.sum(d1_of(m1, labels, weights) * mp))
            return out if red is None else red(torch.stack(out))[0].unbind()

        return f

    def make_data_grad(batch, csc: Optional[CSCTranspose] = None):
        labels, weights = batch.labels, batch.weights
        if transpose == "scatter":
            def apply_t(d1):
                return transpose_apply(batch.features, d1)
        else:
            if csc is None:
                raise ValueError(f"transpose={transpose!r} needs a CSC view")

            def apply_t(d1):
                return _CSC_APPLY[transpose](csc, d1)

        def grad(m):
            d1 = d1_of(m, labels, weights)
            g = norm_chain_t(norm, apply_t(d1), torch.sum(d1))
            return g if red is None else red(g)[0]

        return grad

    return (init_margin, dir_margin, loss_and_dir, make_data_grad,
            delta_and_dir)


def _fit_distributed_margin(objective, batch, w0, l2, config,
                            transpose: str = "scatter",
                            precomputed_csc=None, mesh=None,
                            axis: str = "data") -> OptimizationResult:
    """L-BFGS fit with the margin-space line search: two data passes per
    iteration (one gather, one transpose). The csc modes sort the
    nonzeros once, outside the optimizer loop, or reuse
    ``precomputed_csc`` across fits."""
    use_csc = transpose in _CSC_APPLY
    if precomputed_csc is not None and not use_csc:
        raise ValueError(
            f"precomputed_csc given but sparse_grad={transpose!r} does not "
            "use it; pass sparse_grad='csc' (or a csc variant)")
    (init_margin, dir_margin, loss_and_dir, make_data_grad,
     delta_and_dir) = make_margin_path(objective, transpose, mesh=mesh,
                                       axis=axis)
    csc = precomputed_csc
    if use_csc and csc is None:
        csc = build_csc(batch, with_cols=transpose == "csc_segment")
    return lbfgs_margin(
        dir_margin(batch), loss_and_dir(batch), make_data_grad(batch, csc),
        objective.reg_mask, w0, init_margin(w0, batch), l2, config,
        loss_delta_and_dir=delta_and_dir(batch),
    )


def _l1_mask(objective: GLMObjective, w0: torch.Tensor):
    """OWL-QN's L1 mask: None, or ones with the unpenalized intercept 0
    (consistent with the L2 mask)."""
    if objective.intercept_index < 0 or objective.regularize_intercept:
        return None
    mask = torch.ones_like(w0)
    mask[objective.intercept_index] = 0.0
    return mask


def _run_optimizer(optimizer, objective, w0, l1, config, fun_and_grad,
                   value, hvp, precond) -> OptimizationResult:
    """Run ``optimizer`` on the closures of one fit path. OWL-QN's
    line-search trials take the value-only ``value``, so each trial is one
    forward pass."""
    opt = get_optimizer(optimizer)
    if optimizer == "owlqn":
        return opt(fun_and_grad, w0, l1, config,
                   l1_mask=_l1_mask(objective, w0), fun=value)
    if optimizer == "tron":
        return opt(fun_and_grad, w0, config, hvp=hvp, precond=precond)
    return opt(fun_and_grad, w0, config)


def _fit_distributed_csc(objective, batch, w0, l2, l1, optimizer, config,
                         transpose: str = "csc",
                         precomputed_csc=None, mesh=None,
                         axis: str = "data") -> OptimizationResult:
    """CSC-path fit: sort the nonzeros by column once (or reuse
    ``precomputed_csc`` from :func:`build_csc`), then run the optimizer
    against the sorted view. Every gradient, Hessian-vector product and
    preconditioner pass goes through ``transpose``'s apply."""
    build, fg, hvp = make_csc_path(
        objective, use_kernel=transpose == "csc_kernel",
        precise=transpose == "csc_precise",
        segment=transpose == "csc_segment", mesh=mesh, axis=axis)
    csc = build(batch) if precomputed_csc is None else precomputed_csc
    value = distributed_value(objective, mesh=mesh, axis=axis)
    precond = None
    if optimizer == "tron":
        squares, diag = make_csc_diagonal_hessian(objective, transpose,
                                                  mesh=mesh, axis=axis)
        csc_sq = squares(csc)

        def precond(w):
            return diag(w, batch, csc, csc_sq, l2)

    return _run_optimizer(
        optimizer, objective, w0, l1, config,
        fun_and_grad=lambda w: fg(w, batch, csc, l2),
        value=lambda w: value(w, batch, l2),
        hvp=lambda w, v: hvp(w, v, batch, csc, l2),
        precond=precond)


def _fit_distributed_full(objective, batch, w0, l2, l1, optimizer,
                          config, mesh=None,
                          axis: str = "data") -> OptimizationResult:
    """Full-path fit: the optimizer evaluates the objective itself at every
    trial (``X^T d`` by ``index_add_`` for sparse features, a matmul for
    dense ones)."""
    fg = distributed_value_and_grad(objective, mesh=mesh, axis=axis)
    value = distributed_value(objective, mesh=mesh, axis=axis)
    hvp = distributed_hvp(objective, mesh=mesh, axis=axis)
    diag = distributed_diagonal_hessian(objective, mesh=mesh, axis=axis)
    return _run_optimizer(
        optimizer, objective, w0, l1, config,
        fun_and_grad=lambda w: fg(w, batch, l2),
        value=lambda w: value(w, batch, l2),
        hvp=lambda w, v: hvp(w, v, batch, l2),
        precond=lambda w: diag(w, batch, l2))


def _check_fit_args(optimizer: str, line_search: str) -> None:
    """Unknown names raise before any data moves or pass runs."""
    if line_search not in LINE_SEARCHES:
        raise ValueError(f"unknown line_search {line_search!r}; known: "
                         f"{LINE_SEARCHES}")
    get_optimizer(optimizer)


def fit_distributed(
    objective: GLMObjective,
    batch: LabeledBatch,
    w0: torch.Tensor,
    l2=0.0,
    l1=0.0,
    optimizer: str = "lbfgs",
    config: OptimizerConfig = OptimizerConfig(),
    sparse_grad: str = "auto",
    line_search: str = "margin",
    precomputed_csc: Optional[CSCTranspose] = None,
    *,
    mesh=None,
    axis: str = "data",
) -> OptimizationResult:
    """Run a full fit on the device the batch lies on (``mesh=None``), or
    sharded by rows over the mesh's ``axis``.

    With a mesh every rank passes the same whole ``batch`` (on any
    device) and the same ``w0``: each rank keeps its own padded row block
    on its own device (``parallel.mesh.shard_batch``), ``w0`` is rank 0's
    (``parallel.mesh.replicate``), and every pass sums the ranks' partial
    data terms over ``axis``. Every rank returns the same result.

    ``optimizer``: "lbfgs", "owlqn" (minimizes the objective plus
    ``l1 * ||w||_1``, the intercept unpenalized unless the objective
    regularizes it) or "tron" (Jacobi-preconditioned). ``l1`` is read by
    OWL-QN only.

    ``sparse_grad``: "auto" (see :func:`resolve_sparse_grad`), "scatter",
    "csc", "csc_kernel", "csc_precise" or "csc_segment".

    ``line_search``: "margin" (L-BFGS only) runs the strong-Wolfe search on
    cached margin vectors, two data passes per iteration; "full" evaluates
    the objective at every trial. OWL-QN and TRON take the full path
    whatever ``line_search`` says.

    ``precomputed_csc``: reuse a :func:`build_csc` result (built with the
    same ``mesh``) across fits on the same dataset so the per-dataset
    column sort is paid once."""
    _check_fit_args(optimizer, line_search)
    if mesh is not None:
        batch = shard_batch(batch, mesh, axis)
        w0 = replicate(w0, mesh)
    return fit_shard(objective, batch, w0, l2, l1, optimizer, config,
                     sparse_grad, line_search, precomputed_csc, mesh=mesh,
                     axis=axis)


def fit_shard(
    objective: GLMObjective,
    batch: LabeledBatch,
    w0: torch.Tensor,
    l2=0.0,
    l1=0.0,
    optimizer: str = "lbfgs",
    config: OptimizerConfig = OptimizerConfig(),
    sparse_grad: str = "auto",
    line_search: str = "margin",
    precomputed_csc: Optional[CSCTranspose] = None,
    *,
    mesh=None,
    axis: str = "data",
) -> OptimizationResult:
    """:func:`fit_distributed` on a batch that is already this rank's
    block (``parallel.mesh.shard_batch``), with ``w0`` the same on every
    rank and on the block's device: what a caller that shards once and
    fits many times (the path solver) runs."""
    _check_fit_args(optimizer, line_search)
    if w0.device != batch.device:
        raise ValueError(f"w0 lies on {w0.device}, the batch on "
                         f"{batch.device}")
    sparse_grad = resolve_sparse_grad(sparse_grad, batch.features)
    launches = csc_column_sums.launches
    if optimizer == "lbfgs" and line_search == "margin":
        res = _fit_distributed_margin(
            objective, batch, w0, l2, config, transpose=sparse_grad,
            precomputed_csc=precomputed_csc, mesh=mesh, axis=axis)
    elif sparse_grad in _CSC_APPLY:
        res = _fit_distributed_csc(
            objective, batch, w0, l2, l1, optimizer, config,
            transpose=sparse_grad, precomputed_csc=precomputed_csc,
            mesh=mesh, axis=axis)
    elif precomputed_csc is not None:
        raise ValueError(
            f"precomputed_csc given but sparse_grad={sparse_grad!r} does "
            "not use it; pass sparse_grad='csc' (or a csc variant)")
    else:
        res = _fit_distributed_full(objective, batch, w0, l2, l1, optimizer,
                                    config, mesh=mesh, axis=axis)
    return res._replace(kernel_launches=csc_column_sums.launches - launches)
