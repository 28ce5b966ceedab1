"""The fixed-effect GLM fit on one device (counterpart of
``photon_ml_tpu/parallel/data_parallel.py``'s margin path).

The JAX package shards the batch over a mesh and joins per-shard partial
sums with ``psum``; on one device those reductions are plain sums, so there
is no mesh here. The margin-space primitives feed
:func:`~photon_ml_tpu_torch.optimize.lbfgs_margin.lbfgs_margin` with
explicit margin-space derivatives (the loss's closed-form ``d1``): forward
is the ELL gather, backward is ``X^T d`` in one of three modes:

* ``"scatter"``: ``index_add_`` over the ELL layout (on CUDA it sums in
  atomic order, so two runs may differ in the last bits);
* ``"csc"``: the plain blocked column-sorted path
  (``types.csc_transpose_apply``);
* ``"csc_kernel"``: the column-sorted path through the hand-written kernel
  (``ops.kernels.csc_transpose_apply_kernel``).
"""

from __future__ import annotations

from typing import Optional

import torch

from photon_ml_tpu_torch.ops.kernels import csc_transpose_apply_kernel
from photon_ml_tpu_torch.ops.losses import apply_weights, mask_margins
from photon_ml_tpu_torch.ops.normalization import eff_coeffs, norm_chain_t
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optimize.common import (
    OptimizationResult, OptimizerConfig,
)
from photon_ml_tpu_torch.optimize.lbfgs_margin import lbfgs_margin
from photon_ml_tpu_torch.types import (
    CSCTranspose, LabeledBatch, SparseFeatures, build_csc_transpose,
    csc_transpose_apply, margins as ell_margins, transpose_apply,
)

SPARSE_GRAD_MODES = ("scatter", "csc", "csc_kernel")
_CSC_APPLY = {"csc": csc_transpose_apply,
              "csc_kernel": csc_transpose_apply_kernel}


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


def build_csc(batch: LabeledBatch) -> CSCTranspose:
    """The column-sorted (CSC) view of a batch, built once per dataset for
    reuse across fits (``fit_distributed(..., precomputed_csc=...)``)."""
    feats = batch.features
    if not isinstance(feats, SparseFeatures):
        raise ValueError("CSC path needs SparseFeatures")
    return build_csc_transpose(feats.indices, feats.values, feats.dim)


def make_margin_path(objective: GLMObjective, transpose: str = "scatter"):
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
    """
    norm = objective.normalization
    loss = objective.loss
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
            return value, torch.sum(d1_of(m, labels, weights) * mp)

        return f

    def delta_and_dir(batch):
        labels, weights = batch.labels, batch.weights

        def f(m, mp, alpha):
            m1 = m + alpha * mp
            diffs = apply_weights(
                weights,
                loss.loss(mask_margins(weights, m1), labels)
                - loss.loss(mask_margins(weights, m), labels))
            return (torch.sum(diffs),
                    torch.sum(d1_of(m1, labels, weights) * mp))

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
            return norm_chain_t(norm, apply_t(d1), torch.sum(d1))

        return grad

    return (init_margin, dir_margin, loss_and_dir, make_data_grad,
            delta_and_dir)


def _fit_distributed_margin(objective, batch, w0, l2, config,
                            transpose: str = "scatter",
                            precomputed_csc=None) -> OptimizationResult:
    """L-BFGS fit with the margin-space line search: two data passes per
    iteration (one gather, one transpose) regardless of line-search effort.
    The csc modes sort the nonzeros once, outside the optimizer loop, or
    reuse ``precomputed_csc`` across fits."""
    use_csc = transpose in _CSC_APPLY
    if precomputed_csc is not None and not use_csc:
        raise ValueError(
            f"precomputed_csc given but sparse_grad={transpose!r} does not "
            "use it; pass sparse_grad='csc' or 'csc_kernel'")
    (init_margin, dir_margin, loss_and_dir, make_data_grad,
     delta_and_dir) = make_margin_path(objective, transpose)
    csc = precomputed_csc
    if use_csc and csc is None:
        csc = build_csc(batch)
    return lbfgs_margin(
        dir_margin(batch), loss_and_dir(batch), make_data_grad(batch, csc),
        objective.reg_mask, w0, init_margin(w0, batch), l2, config,
        loss_delta_and_dir=delta_and_dir(batch),
    )


def fit_distributed(
    objective: GLMObjective,
    batch: LabeledBatch,
    w0: torch.Tensor,
    l2=0.0,
    optimizer: str = "lbfgs",
    config: OptimizerConfig = OptimizerConfig(),
    sparse_grad: str = "auto",
    line_search: str = "margin",
    precomputed_csc: Optional[CSCTranspose] = None,
) -> OptimizationResult:
    """Run a full fit on the device the batch lies on.

    ``sparse_grad``: "auto" (see :func:`resolve_sparse_grad`), "scatter",
    "csc" or "csc_kernel". Only ``optimizer="lbfgs"`` with
    ``line_search="margin"`` is ported so far.

    ``precomputed_csc``: reuse a :func:`build_csc` result across fits on
    the same dataset so the per-dataset column sort is paid once."""
    if optimizer != "lbfgs" or line_search != "margin":
        raise NotImplementedError(
            f"optimizer={optimizer!r}, line_search={line_search!r} is not "
            "ported yet; only lbfgs with the margin line search is")
    if w0.device != batch.device:
        raise ValueError(f"w0 lies on {w0.device}, the batch on "
                         f"{batch.device}")
    sparse_grad = resolve_sparse_grad(sparse_grad, batch.features)
    return _fit_distributed_margin(
        objective, batch, w0, l2, config, transpose=sparse_grad,
        precomputed_csc=precomputed_csc)
