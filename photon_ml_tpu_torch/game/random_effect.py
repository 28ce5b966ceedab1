"""Per-entity random-effect training and scoring (counterpart of
``photon_ml_tpu/game/random_effect.py``).

Each size bucket solves all its entities at once on one device. The JAX
package runs a ``jax.vmap`` of its scalar optimizers; here the bucket's rows
are densified once to ``X [E, N, D]`` (a k-step masked add, no scatter),
every objective pass is a batched contraction over that block, and the
solvers are either the batched dense Newton method (:func:`_newton_dense_
solver`: gradient and Hessian by ``einsum``, ``torch.linalg.cholesky_ex`` and
``cholesky_solve``, a 4-level per-entity step-halving safeguard) or the
batched L-BFGS / OWL-QN / TRON of ``optimize/batched.py`` (TRON's
Hessian-vector product is the explicit ``X^T diag(d2) X v + l2 v`` over the
block, where the JAX package differentiates the gradient forward).
Normalization folds into the block as ``x' = (x - s) * f`` per local slot,
exactly the sparse path's effective-coefficient fold.

Nothing on this path accumulates with atomics: the densify is an ordered
masked add, every reduction runs over a fixed axis, and scoring writes each
row with a plain index copy (every row belongs to at most one entity per
coordinate; only the discarded pad slot takes several writes, all of them
0). So a re-solve of the same entities gives the same bits, which the
active-set coordinate descent relies on.

Entity blocks are sized from the bucket's bytes per entity against a stated
share of the device's memory (:func:`_block_entities`), not from the TPU's
constants.

With a mesh (``parallel.mesh.make_mesh``) whose ``entity`` axis has S
ranks, each rank solves one contiguous block of every bucket's entities
(the bucket padded to a multiple of S with inert zero-weight entities),
and the coefficients, variances and convergence flags are all-gathered in
rank order, so every rank holds the whole model. Entities are
independent, so the sharded solve equals the unsharded one entity by
entity.

In place of the JAX module's ``re_solver_compile_count`` (the XLA
executables its bucket solvers built), :func:`re_solver_host_reads`
counts the device-to-host reads the bucket solves made. They launch no
hand-written kernel: their contractions and Cholesky solves are torch's.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.game.data import (
    RandomEffectTrainData, REScoreBucket, SketchProjection,
)
from photon_ml_tpu_torch.ops.losses import (
    apply_weights, get_loss, mask_margins,
)
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.optimize import batched
from photon_ml_tpu_torch.optimize.common import OptimizerConfig
from photon_ml_tpu_torch.parallel.mesh import all_reduce_sum
from photon_ml_tpu_torch.types import resolve_device

RE_OPTIMIZERS = ("lbfgs", "owlqn", "tron", "newton")

_HOST_READS = [0]
_HOST_READS_LOCK = threading.Lock()


def re_solver_host_reads() -> int:
    """Device-to-host reads of every random-effect bucket solve in this
    process so far (Newton: one per iteration and one at the end of its
    loop; the batched L-BFGS, OWL-QN and TRON: their ``host_syncs``)."""
    with _HOST_READS_LOCK:
        return _HOST_READS[0]


def _note_host_reads(n: int) -> None:
    with _HOST_READS_LOCK:
        _HOST_READS[0] += int(n)


@dataclasses.dataclass(frozen=True)
class RandomEffectFitResult:
    coefficients: List[np.ndarray]  # per bucket [E, D]
    variances: Optional[List[np.ndarray]]
    converged_fraction: float
    mean_iterations: float  # over the entities actually solved this call
    # per-entity detail (one array per bucket); entities not re-solved this
    # call (active-set frozen) report converged=True and iterations=0
    converged: Optional[List[np.ndarray]] = None  # bool [E] per bucket
    iterations: Optional[List[np.ndarray]] = None  # int32 [E] per bucket
    entities_solved: int = 0


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _densify(indices: torch.Tensor, values: torch.Tensor,
             D: int) -> torch.Tensor:
    """``X[e, n, idx[e, n, j]] += val[e, n, j]`` as a k-step masked add in
    slot order (no scatter: the sum order is fixed). Padding slots carry
    value 0 and add nothing wherever they point."""
    E, N, k = indices.shape
    iota = torch.arange(D, dtype=indices.dtype, device=indices.device)
    X = torch.zeros((E, N, D), dtype=values.dtype, device=values.device)
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    for j in range(k):
        X = X + torch.where(indices[:, :, j, None] == iota,
                            values[:, :, j, None], zero)
    return X


class _BucketObjective:
    """Every entity's GLM objective over a densified block: ``X`` [E, N, D]
    (normalization folded in), ``labels``/``weights``/``offsets`` [E, N]
    (weight-0 rows are padding), L2 on every local slot."""

    def __init__(self, X, labels, weights, offsets, l2, task):
        self.X, self.labels, self.weights, self.offsets = (
            X, labels, weights, offsets)
        self.l2 = l2
        self.loss = get_loss(task)

    def margins(self, W):
        m = torch.einsum("end,ed->en", self.X, W) + self.offsets
        return mask_margins(self.weights, m)

    def value(self, W):
        per = apply_weights(self.weights,
                            self.loss.loss(self.margins(W), self.labels))
        return (batched.padded_sum(per)
                + 0.5 * self.l2 * batched.padded_sum(W * W))

    def value_and_grad(self, W):
        m = self.margins(W)
        per = apply_weights(self.weights, self.loss.loss(m, self.labels))
        d1 = apply_weights(self.weights, self.loss.d1(m, self.labels))
        f = (batched.padded_sum(per)
             + 0.5 * self.l2 * batched.padded_sum(W * W))
        return f, torch.einsum("end,en->ed", self.X, d1) + self.l2 * W

    def hvp(self, W):
        """The Hessian-vector product at ``W`` as an operator
        ``V -> X^T diag(d2) X V + l2 V`` [E, D]: the curvature is taken
        once, each product is two contractions over the block."""
        d2 = self.curvature(W)

        def apply(V):
            xv = torch.einsum("end,ed->en", self.X, V)
            return torch.einsum("end,en->ed", self.X, d2 * xv) + self.l2 * V

        return apply

    def curvature(self, W):
        return apply_weights(self.weights,
                             self.loss.d2(self.margins(W), self.labels))

    def hessian(self, W, d2=None):
        """``X^T diag(d2) X + l2 I`` per entity, [E, D, D]."""
        D = self.X.shape[2]
        if d2 is None:
            d2 = self.curvature(W)
        H = torch.einsum("end,enf->edf", self.X, d2[:, :, None] * self.X)
        return H + self.l2 * torch.eye(D, dtype=W.dtype, device=W.device)

    def grad_hess(self, W):
        """Gradient and Hessian from one margin pass."""
        m = self.margins(W)
        d1 = apply_weights(self.weights, self.loss.d1(m, self.labels))
        d2 = apply_weights(self.weights, self.loss.d2(m, self.labels))
        g = torch.einsum("end,en->ed", self.X, d1) + self.l2 * W
        return g, self.hessian(W, d2)

    def variances(self, W, mode):
        """Per-entity coefficient variances: ``1 / diag(H)`` (diagonal) or
        ``diag(H^-1)`` (full)."""
        if mode == "full":
            return torch.diagonal(_spd_solve(
                self.hessian(W), torch.eye(W.shape[1], dtype=W.dtype,
                                           device=W.device).expand(
                    W.shape[0], -1, -1)), dim1=1, dim2=2)
        d2 = self.curvature(W)
        diag = torch.einsum("end,en->ed", self.X * self.X, d2) + self.l2
        return 1.0 / torch.clamp(diag, min=torch.finfo(diag.dtype).tiny)


def _spd_solve(H: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve through a Cholesky factorization. An entity whose
    ``H`` is not positive definite gets NaN, as the reference's LU solve
    gives for a singular Hessian; the Newton loop masks its step away."""
    L, info = torch.linalg.cholesky_ex(H)
    X = torch.cholesky_solve(B, L)
    bad = (info != 0).reshape((-1,) + (1,) * (X.dim() - 1))
    return torch.where(bad, torch.full_like(X, float("nan")), X)


def _newton_dense_solver(local_dim: int, task: str, config: OptimizerConfig,
                         compute_variance, norm_mode: int = 0):
    """Batched dense Newton (IRLS) bucket solver. Each iteration is two
    contractions (gradient ``X^T d1``, Hessian ``X^T diag(d2) X``), one
    batched Cholesky solve and four trial values (step lengths 1, 1/2, 1/4,
    1/8; the largest that does not increase f is kept, per entity).

    Returns ``solve(indices, values, labels, weights, offsets, w0, f_loc,
    s_loc, l2, l1) -> (W, variances, converged, iterations)``. L1 is not
    supported (the caller routes l1 > 0 to OWL-QN)."""
    tol = config.tolerance
    max_iters = config.max_iters

    def solve(indices, values, labels, weights, offs, w0, f_loc, s_loc,
              l2, l1):
        del l1  # the caller guarantees 0
        obj = _objective(indices, values, labels, weights, offs, f_loc,
                         s_loc, l2, task, local_dim, norm_mode)
        dt = values.dtype
        dev = values.device
        E = indices.shape[0]
        f0 = obj.value(w0)
        g0 = obj.value_and_grad(w0)[1]
        g0n = torch.sqrt(batched.padded_sum(g0 * g0))
        # converged_check semantics, batched: tol <= 0 disables the tests;
        # a positive tol is clamped to a few ulps of the dtype
        eff_tol = (max(float(tol), 4 * torch.finfo(dt).eps) if tol > 0
                   else 0.0)
        alphas = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=dt, device=dev)
        W, f = w0, f0
        active = torch.ones(E, dtype=torch.bool, device=dev)
        conv_seen = torch.zeros(E, dtype=torch.bool, device=dev)
        iters = torch.zeros(E, dtype=torch.int32, device=dev)
        reads = 0
        while bool(active.any()):  # the iteration's one host read
            reads += 1
            g, H = obj.grad_hess(W)
            step = _spd_solve(H, g[..., None])[..., 0]
            f_tries = torch.stack([obj.value(W - a * step) for a in alphas])
            ok = f_tries <= f[None, :]
            first_ok = torch.argmax(ok.to(torch.int8), dim=0)
            any_ok = torch.any(ok, dim=0)
            a_sel = torch.where(any_ok, alphas[first_ok],
                                torch.zeros((), dtype=dt, device=dev))
            f_new = torch.where(
                any_ok, torch.gather(f_tries, 0, first_ok[None, :])[0], f)
            gnorm = torch.sqrt(batched.padded_sum(g * g))
            # the relative-loss half needs an accepted step; the gradient
            # half fires regardless (step-halving failing at the optimum is
            # convergence, not a stall)
            delta = torch.abs(f - f_new)
            conv = active & (eff_tol > 0) & (
                (any_ok & (delta <= eff_tol * torch.clamp(torch.abs(f),
                                                          min=1.0)))
                | (gnorm <= eff_tol * torch.clamp(g0n, min=1.0)))
            # a rejected step is masked, not zero-multiplied (a NaN step
            # would poison W); an entity that converges on its first
            # iteration keeps its incoming point, so a warm re-solve of a
            # converged entity is a no-op
            keep = conv & (iters == 0)
            take = active & any_ok & ~keep
            W = torch.where(take[:, None], W - a_sel[:, None] * step, W)
            f = torch.where(active & ~keep, f_new, f)
            iters = iters + active.to(iters.dtype)
            conv_seen = conv_seen | conv
            active = active & ~conv & any_ok & (iters < max_iters)
        _note_host_reads(reads + 1)
        var = _variances(obj, W, compute_variance)
        return W, var, conv_seen, iters

    return solve


def _variances(obj: _BucketObjective, W, compute_variance):
    if not compute_variance:
        return torch.zeros((W.shape[0], 0), dtype=W.dtype, device=W.device)
    mode = "full" if compute_variance == "full" else "diagonal"
    return obj.variances(W, mode)


def _objective(indices, values, labels, weights, offs, f_loc, s_loc, l2,
               task, local_dim, norm_mode) -> _BucketObjective:
    X = _densify(indices, values, local_dim)
    # normalization in data space: x' = (x - s) * f per local slot
    if norm_mode == 2:
        X = (X - s_loc[:, None, :]) * f_loc[:, None, :]
    elif norm_mode == 1:
        X = X * f_loc[:, None, :]
    return _BucketObjective(X, labels, weights, offs, l2, task)


def _solver_for_bucket(local_dim: int, task: str, optimizer: str,
                       config: OptimizerConfig, compute_variance,
                       norm_mode: int = 0):
    """The bucket solve function for ``optimizer``: ``"newton"`` (batched
    dense Newton), ``"lbfgs"``, ``"owlqn"`` or ``"tron"``
    (``optimize/batched.py``).
    ``norm_mode``: 0 none, 1 per-entity factors, 2 factors and shifts (the
    intercept slot pre-pinned to 1/0)."""
    if optimizer == "newton":
        return _newton_dense_solver(local_dim, task, config,
                                    compute_variance, norm_mode)
    _check_re_optimizer(optimizer)

    def solve(indices, values, labels, weights, offs, w0, f_loc, s_loc,
              l2, l1):
        obj = _objective(indices, values, labels, weights, offs, f_loc,
                         s_loc, l2, task, local_dim, norm_mode)
        if optimizer == "owlqn":
            res = batched.owlqn(obj.value_and_grad, w0, l1, config,
                                fun=obj.value)
        elif optimizer == "tron":
            res = batched.tron(obj.value_and_grad, w0, obj.hvp, config)
        else:
            res = batched.lbfgs(obj.value_and_grad, w0, config)
        _note_host_reads(res.host_syncs)
        var = _variances(obj, res.w, compute_variance)
        return res.w, var, res.converged, res.iterations

    return solve


def _check_re_optimizer(optimizer: str) -> None:
    if optimizer not in RE_OPTIMIZERS + ("auto",):
        raise ValueError(f"unknown random-effect optimizer {optimizer!r}; "
                         f"known: {('auto',) + RE_OPTIMIZERS}")


def _local_normalization(buckets, norm: NormalizationContext):
    """Gather the global normalization context into per-entity local
    vectors: for each bucket, (f_loc [E,D], s_loc [E,D] | None,
    intercept_pos [E] | None). Padding slots (projection -1) get f=1, s=0;
    the global intercept slot is pinned (f=1, s=0), so the fold-back is
    explicit."""
    f_g = None if norm.factors is None else _host(norm.factors).copy()
    s_g = None if norm.shifts is None else _host(norm.shifts).copy()
    ii = norm.intercept_index
    if f_g is not None and ii >= 0:
        f_g[ii] = 1.0
    if s_g is not None and ii >= 0:
        s_g[ii] = 0.0
    out = []
    for bucket in buckets:
        if any(isinstance(lm, SketchProjection) for lm in bucket.local_maps):
            raise ValueError(
                "normalization is not supported with projection='random' "
                "(count-sketch slots mix features); use projection='subspace'")
        proj = np.asarray(bucket.projection)
        safe = np.maximum(proj, 0)
        f_loc = (np.where(proj >= 0, f_g[safe], 1.0) if f_g is not None
                 else np.ones_like(proj, np.float64))
        s_loc = None
        pos = None
        if s_g is not None:
            s_loc = np.where(proj >= 0, s_g[safe], 0.0)
            has = proj == ii
            if ii < 0 or not has.any(axis=1).all():
                raise ValueError(
                    "shift normalization requires the intercept feature in "
                    "every entity's feature subspace")
            pos = has.argmax(axis=1)
        out.append((f_loc, s_loc, pos))
    return out


def _re_to_training_space(W_raw: np.ndarray, f_loc, s_loc, pos) -> np.ndarray:
    """Per-entity inverse of the model-space fold (warm starts)."""
    W = np.array(W_raw, np.float64, copy=True)
    E = W.shape[0]
    if s_loc is not None:
        w_noint = W.copy()
        w_noint[np.arange(E), pos] = 0.0
        W[np.arange(E), pos] += np.sum(s_loc * w_noint, axis=1)
    return W / f_loc


def _re_to_model_space(W_opt: np.ndarray, f_loc, s_loc, pos) -> np.ndarray:
    """Optimizer-space bucket coefficients -> raw-feature space."""
    W = np.asarray(W_opt, np.float64) * f_loc
    if s_loc is not None:
        E = W.shape[0]
        adjust = -np.sum(s_loc * W, axis=1)  # s_loc is 0 at the intercept
        W[np.arange(E), pos] += adjust
    return W


# One entity block's solver state may take this share of the card's memory
# (the rest holds the dataset, the fixed effect and the allocator's slack);
# on the CPU a block is held to _RE_HOST_BLOCK_BYTES.
_RE_MEMORY_SHARE = 0.25
_RE_HOST_BLOCK_BYTES = 1 << 30


def _block_budget(device: torch.device) -> int:
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        return int(_RE_MEMORY_SHARE * total)
    return _RE_HOST_BLOCK_BYTES


def _entity_bytes(N: int, D: int, k: int, optimizer: str, history: int,
                  itemsize: int, compute_variance) -> int:
    """Device bytes one entity's solve holds at its peak, in elements of
    ``itemsize``:

    * the input rows: indices and values, 2 N k;
    * the densified block X, its normalized copy, and the one [N, D]
      intermediate an objective pass makes: 3 N D;
    * Newton: the Hessian, its Cholesky factor and the solve's output
      (also the full variances' identity right-hand side): 4 D^2, plus four
      trial points and the carried vectors, 12 D;
    * L-BFGS / OWL-QN: the s and y histories, 2 m D, plus about 16 carried
      [D] vectors (w, g, the direction, the line search's trial point,
      gradient and best gradient, the two-loop temporaries);
    * TRON: about 16 carried [D] vectors (w, g, the trial point and its
      gradient, CG's s, r, d and H d and their updates) and the curvature
      and ``X v`` rows of a Hessian-vector product, 2 N;
    * full variances on the L-BFGS, OWL-QN and TRON paths: 4 D^2.

    E.g. chip_smoke.py phase 11's shape (N=64, D=32, k=8, float32):
    Newton 11,648 elements = 46,592 bytes per entity; a quarter of an
    H100 80GB's 85,017,493,504 bytes holds 456,180 entities, so 100,000
    entities solve in one block."""
    elems = 2 * N * k + 3 * N * D
    if optimizer == "newton":
        elems += 4 * D * D + 12 * D
    else:
        elems += 16 * D + (2 * N if optimizer == "tron" else 2 * history * D)
        if compute_variance == "full":
            elems += 4 * D * D
    return elems * itemsize


def _block_entities(N, D, k, optimizer, config, itemsize, compute_variance,
                    device) -> int:
    """Entities per solver block: the device budget over the bytes per
    entity (at least 1)."""
    per = _entity_bytes(N, D, k, optimizer, config.history, itemsize,
                        compute_variance)
    return max(1, _block_budget(device) // max(per, 1))


def resolve_re_optimizer(optimizer: str) -> str:
    """Resolve ``"auto"`` to the batched L-BFGS on every device: the JAX
    package's CPU choice, and on the H100 the faster of the two solvers in
    chip_smoke.py phase 11 (the root PERF.md has the numbers and the
    card)."""
    return "lbfgs" if optimizer == "auto" else optimizer


def _pad_entities(a: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad axis 0 to ``width`` (padded entities have weight-0 rows:
    their objective is ``0.5 l2 |w|^2`` at w = 0, nothing moves)."""
    pad = width - a.shape[0]
    if pad == 0:
        return a
    return torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]),
                                     dtype=a.dtype, device=a.device)])


def _active_width(n_active: int, block: int, n_dev: int = 1) -> int:
    """Padded width for an active-set sub-bucket: the next power of two
    (at least 32, rounded up to the device count), capped at the block
    width, so the solver sees a short ladder of shapes."""
    w = 1 << max(n_active - 1, 0).bit_length()
    w = -(-max(w, 32) // n_dev) * n_dev
    return min(w, block)


def _run_entity_blocks(run, args, n_entities: int, bs: int,
                       compute_variance):
    """Drive the bucket solver over fixed-width entity blocks and fetch
    per-entity results to the host. ``args`` holds 8 per-entity tensors and
    the two scalars; each block is padded to ``bs``."""
    W_parts, V_parts, conv_parts, iter_parts = [], [], [], []
    for s in range(0, n_entities, bs):
        e = min(s + bs, n_entities)
        if s == 0 and e == n_entities == bs:
            blk = args  # one full block: no slice or pad copies
        else:
            blk = tuple(_pad_entities(a[s:e], bs) if i < 8 else a
                        for i, a in enumerate(args))
        Wb, Vb, convb, itersb = run(*blk)
        W_parts.append(_host(Wb)[: e - s])
        V_parts.append(_host(Vb)[: e - s] if compute_variance else None)
        conv_parts.append(_host(convb)[: e - s])
        iter_parts.append(_host(itersb)[: e - s])

    def cat(parts):
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    W = cat(W_parts)
    V = cat(V_parts) if compute_variance else None
    return W, V, cat(conv_parts).astype(bool), cat(iter_parts)


def _entity_part(n_solve: int, sel, mesh, axis: str):
    """None without a mesh; else ``(rows, per_rank)``: this rank's entity
    rows of the bucket (indices into it, taken from ``sel`` when only the
    active entities solve) when the ``n_solve`` entities are padded to a
    multiple of the axis size and cut into equal contiguous blocks."""
    if mesh is None:
        return None
    from photon_ml_tpu_torch.parallel.mesh import axis_index, axis_size

    per = -(-n_solve // axis_size(mesh, axis))
    lo = min(axis_index(mesh, axis) * per, n_solve)
    hi = min(lo + per, n_solve)
    rows = np.arange(lo, hi) if sel is None else sel[lo:hi]
    return rows, per


def _run_sharded_blocks(run, args, n_solve: int, per: int, width: int,
                        compute_variance, mesh, axis: str):
    """Solve this rank's entity block (padded to ``per`` entities with
    zero-weight entities) and all-gather every rank's results over the
    entity axis, in rank order, trimmed to the bucket's ``n_solve``."""
    from photon_ml_tpu_torch.parallel.multihost import allgather_host

    local = tuple(_pad_entities(a, per) if i < 8 else a
                  for i, a in enumerate(args))
    outs = _run_entity_blocks(run, local, per, min(width, per),
                              compute_variance)
    group = mesh.get_group(axis)
    gathered = []
    for o in outs:
        if o is None:
            gathered.append(None)
            continue
        parts = allgather_host(np.ascontiguousarray(o), group)
        gathered.append(np.concatenate(parts)[:n_solve])
    return tuple(gathered)


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def train_random_effect(
    data: RandomEffectTrainData,
    offsets,
    task: str = "logistic",
    l2=0.0,
    l1=0.0,
    optimizer: str = "lbfgs",
    config: OptimizerConfig = OptimizerConfig(max_iters=50, history=5),
    w0: Optional[List[np.ndarray]] = None,
    mesh=None,
    axis: str = "entity",
    compute_variance=False,  # False | True/"diagonal" | "full"
    dtype=torch.float32,
    normalization: Optional[NormalizationContext] = None,
    active: Optional[Sequence[Optional[np.ndarray]]] = None,
    prev_variances: Optional[List[Optional[np.ndarray]]] = None,
    device=None,
) -> RandomEffectFitResult:
    """Solve every entity's local GLM on ``device`` (default ``cuda``).
    ``offsets`` is the full-dataset residual-offset vector [n] from the
    coordinate-descent loop. An L1 weight routes to OWL-QN.

    ``normalization`` (the shard's global context) is applied inside each
    per-entity objective through gathered local factor/shift vectors;
    incoming ``w0`` and returned coefficients stay in raw feature space.

    ``active``: one boolean mask [E] per bucket (or None: the whole
    bucket). Only masked entities are re-solved, in a power-of-two padded
    sub-bucket (``_active_width``); frozen entities carry their ``w0``
    coefficients (and ``prev_variances``) and report converged=True /
    iterations=0. Requires ``w0``.

    ``mesh``: shard every bucket's entities over the mesh's ``axis``
    (module docstring); ``device`` then defaults to the mesh's device."""
    if float(l1) > 0 and optimizer != "owlqn":
        optimizer = "owlqn"
    _check_re_optimizer(optimizer)
    if active is not None and w0 is None:
        raise ValueError("active-set training needs w0 (frozen entities "
                         "carry their previous coefficients)")
    if mesh is not None and device is None:
        from photon_ml_tpu_torch.parallel.mesh import mesh_device

        device = mesh_device(mesh)
    dev = resolve_device(device)
    np_dt = _np_dtype(dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    offsets = torch.as_tensor(offsets, device=dev).to(dtype)
    local_norm = (None if normalization is None
                  else _local_normalization(data.buckets, normalization))
    norm_mode = 0
    if normalization is not None:
        norm_mode = 2 if normalization.shifts is not None else 1
    coeffs, variances = [], []
    conv_list, iter_list = [], []
    conv_sum, iter_sum, total, solved_total = 0, 0, 0, 0
    for b, bucket in enumerate(data.buckets):
        E, D = bucket.num_entities, bucket.local_dim
        if E == 0:
            coeffs.append(np.zeros((0, D), np_dt))
            variances.append(np.zeros((0, D), np_dt)
                             if compute_variance else None)
            conv_list.append(np.zeros(0, bool))
            iter_list.append(np.zeros(0, np.int32))
            continue
        mask = None if active is None else active[b]
        if mask is not None:
            mask = np.asarray(mask, bool)
            if mask.shape != (E,):
                raise ValueError(
                    f"active mask for bucket {b} has shape {mask.shape}, "
                    f"expected ({E},)")
            if mask.all():
                mask = None  # full solve: the unsliced path
        if mask is not None and not mask.any():
            # fully frozen bucket: nothing touches the device
            coeffs.append(np.array(np.asarray(w0[b]), copy=True))
            variances.append(
                None if not compute_variance else
                (np.array(prev_variances[b], copy=True)
                 if prev_variances is not None and prev_variances[b]
                 is not None else np.zeros((E, D), np_dt)))
            conv_list.append(np.ones(E, bool))
            iter_list.append(np.zeros(E, np.int32))
            conv_sum += E
            total += E
            continue
        sel = None if mask is None else np.flatnonzero(mask)
        n_solve = E if sel is None else len(sel)
        opt_b = resolve_re_optimizer(optimizer)
        run = _solver_for_bucket(D, task, opt_b, config, compute_variance,
                                 norm_mode)
        N, k = bucket.indices.shape[1], bucket.indices.shape[2]
        # this rank's entities: all of them, or one contiguous block
        part = _entity_part(n_solve, sel, mesh, axis)
        take = sel if part is None else part[0]
        n_here = n_solve if part is None else len(take)
        per = n_solve if part is None else part[1]
        bs = min(_block_entities(N, D, k, opt_b, config, itemsize,
                                 compute_variance, dev),
                 E if part is None else per)
        width = (bs if sel is None and part is None
                 else _active_width(per, bs))

        def pick(a):
            return a if take is None else a[take]

        ln_b = ln_all = None
        if local_norm is not None:
            f_np, s_np, pos_np = local_norm[b]
            ln_b = (pick(f_np), None if s_np is None else pick(s_np),
                    None if pos_np is None else pick(pos_np))
            # every solved entity's (gathered) coefficients map back
            ln_all = ln_b if part is None else tuple(
                None if a is None else (a if sel is None else a[sel])
                for a in (f_np, s_np, pos_np))
        sidx = torch.as_tensor(pick(bucket.sample_idx), device=dev)
        # padding rows (sidx == -1) carry weight 0; their offset is 0
        off = offsets[torch.clamp(sidx, min=0).long()] * (sidx >= 0)
        if w0 is not None:
            w_init = pick(np.asarray(w0[b]))
            if ln_b is not None:
                w_init = _re_to_training_space(w_init, *ln_b)
            w_init = torch.as_tensor(np.asarray(w_init), device=dev).to(dtype)
        else:
            w_init = torch.zeros((n_here, D), dtype=dtype, device=dev)
        if ln_b is not None:
            f_loc = torch.as_tensor(ln_b[0], device=dev).to(dtype)
            s_loc = (torch.zeros((n_here, 1), dtype=dtype, device=dev)
                     if ln_b[1] is None
                     else torch.as_tensor(ln_b[1], device=dev).to(dtype))
        else:  # unused
            f_loc = torch.zeros((n_here, 1), dtype=dtype, device=dev)
            s_loc = torch.zeros((n_here, 1), dtype=dtype, device=dev)
        args = (
            torch.as_tensor(pick(bucket.indices), device=dev),
            torch.as_tensor(pick(bucket.values), device=dev).to(dtype),
            torch.as_tensor(pick(bucket.labels), device=dev).to(dtype),
            torch.as_tensor(pick(bucket.weights), device=dev).to(dtype),
            off.to(dtype),
            w_init,
            f_loc,
            s_loc,
            float(l2),
            float(l1),
        )
        if part is None:
            W, V, conv, iters = _run_entity_blocks(run, args, n_solve, width,
                                                   compute_variance)
        else:
            W, V, conv, iters = _run_sharded_blocks(
                run, args, n_solve, per, width, compute_variance, mesh, axis)
        if ln_all is not None:
            W = _re_to_model_space(W, *ln_all)
        if sel is None:
            conv_arr, iter_arr = conv, iters.astype(np.int32)
        else:
            # scatter solved entities back; frozen rows carry over
            W_full = np.array(np.asarray(w0[b]), copy=True)
            W_full[sel] = W
            W = W_full
            if compute_variance:
                V_full = (np.array(prev_variances[b], copy=True)
                          if prev_variances is not None
                          and prev_variances[b] is not None
                          else np.zeros((E, V.shape[1]), V.dtype))
                V_full[sel] = V
                V = V_full
            conv_arr = np.ones(E, bool)
            conv_arr[sel] = conv
            iter_arr = np.zeros(E, np.int32)
            iter_arr[sel] = iters
        coeffs.append(W)
        variances.append(V)
        conv_list.append(conv_arr)
        iter_list.append(iter_arr)
        conv_sum += int(conv_arr.sum())
        iter_sum += int(iter_arr.sum())
        total += E
        solved_total += n_solve
    return RandomEffectFitResult(
        coefficients=coeffs,
        variances=variances if compute_variance else None,
        converged_fraction=conv_sum / max(total, 1),
        mean_iterations=iter_sum / max(solved_total, 1),
        converged=conv_list,
        iterations=iter_list,
        entities_solved=solved_total,
    )


def _bucket_margins(W: torch.Tensor, idx: torch.Tensor,
                    val: torch.Tensor) -> torch.Tensor:
    """``m[e, r] = sum_j val[e, r, j] * W[e, idx[e, r, j]]`` [E, M]."""
    E, M, k = idx.shape
    g = torch.gather(W, 1, idx.reshape(E, M * k).long()).reshape(E, M, k)
    return torch.sum(val * g, dim=-1)


def _write_rows(scores, n, view_sidx, m):
    """Write each row's margin into ``scores`` [n + 1] with a plain index
    copy; padding slots all land on the discarded slot ``n`` with 0."""
    target = torch.where(view_sidx >= 0, view_sidx.long(),
                         torch.full_like(view_sidx, n, dtype=torch.long))
    vals = torch.where(view_sidx >= 0, m, torch.zeros((), dtype=m.dtype,
                                                       device=m.device))
    scores[target.reshape(-1)] = vals.reshape(-1)


def score_random_effect(
    score_view: Sequence[REScoreBucket],
    coefficients: Sequence[np.ndarray],
    num_samples: int,
    dtype=torch.float32,
    prev: Optional[torch.Tensor] = None,
    changed: Optional[Sequence[Optional[np.ndarray]]] = None,
    device=None,
    mesh=None,
    axis: str = "entity",
) -> torch.Tensor:
    """Margins of every sample under its entity's model, in a
    full-dataset score vector on ``device`` (default ``cuda``). Samples
    with no entity model score 0.

    Incremental mode (``prev`` + ``changed``): recompute margins only for
    the rows owned by re-solved entities and overwrite them in the previous
    score vector. ``changed`` holds one boolean mask [E] per bucket (None:
    the whole bucket); the changed entities are padded to a power-of-two
    width.

    ``mesh``: each rank scores only its own ``span_of`` block of every
    bucket's entities over ``axis`` into a zero vector (with, in
    incremental mode, a 0/1 vector marking the rows it wrote), and one
    all-reduce SUM joins them. Each row belongs to at most one entity, so
    the sum adds only zeros to each score: exact, and the same on every
    rank."""
    dev = resolve_device(device)
    own = _own_entities(mesh, axis)
    if prev is None or changed is None:
        scores = torch.zeros(num_samples + 1, dtype=dtype, device=dev)
        for view, W in zip(score_view, coefficients):
            E = view.sample_idx.shape[0]
            if E == 0:
                continue
            e0, e1 = own(E)
            if e0 == e1:
                continue
            m = _bucket_margins(
                torch.as_tensor(np.asarray(W)[e0:e1], device=dev).to(dtype),
                torch.as_tensor(view.indices[e0:e1], device=dev),
                torch.as_tensor(view.values[e0:e1], device=dev).to(dtype))
            _write_rows(scores, num_samples,
                        torch.as_tensor(view.sample_idx[e0:e1], device=dev),
                        m)
        if mesh is not None:
            all_reduce_sum(scores, mesh, axis)
        return scores[:num_samples]

    prev = torch.as_tensor(prev, device=dev).to(dtype)
    if mesh is None:
        scores = torch.cat([prev, torch.zeros(1, dtype=dtype, device=dev)])
    else:  # this rank's rewritten rows and their marks
        scores = torch.zeros(num_samples + 1, dtype=dtype, device=dev)
        hit = torch.zeros(num_samples + 1, dtype=dtype, device=dev)
    for view, W, mask in zip(score_view, coefficients, changed):
        E = view.sample_idx.shape[0]
        if E == 0:
            continue
        e0, e1 = own(E)
        sel = np.arange(e0, e1)
        if mask is not None:
            sel = sel[np.asarray(mask, bool)[e0:e1]]
        if len(sel) == 0:
            continue
        width = _active_width(len(sel), E, 1)
        W_t = _pad_entities(torch.as_tensor(np.asarray(W)[sel],
                                            device=dev).to(dtype), width)
        idx = _pad_entities(torch.as_tensor(view.indices[sel], device=dev),
                            width)
        val = _pad_entities(torch.as_tensor(view.values[sel],
                                            device=dev).to(dtype), width)
        sidx_np = view.sample_idx[sel]
        pad = width - len(sel)
        if pad:
            sidx_np = np.concatenate(
                [sidx_np, np.full((pad,) + sidx_np.shape[1:], -1,
                                  sidx_np.dtype)])
        m = _bucket_margins(W_t, idx, val)
        sidx = torch.as_tensor(sidx_np, device=dev)
        # overwrite, do not add: these rows' previous margins are stale
        _write_rows(scores, num_samples, sidx, m)
        if mesh is not None:
            _write_rows(hit, num_samples, sidx, torch.ones_like(m))
    if mesh is None:
        return scores[:num_samples]
    both = torch.stack([scores, hit])
    all_reduce_sum(both, mesh, axis)
    return torch.where(both[1, :num_samples] > 0, both[0, :num_samples],
                       prev)


def _own_entities(mesh, axis: str):
    """``own(E) -> (e0, e1)``: the whole bucket without a mesh, else this
    rank's ``span_of`` block of its ``E`` entities along ``axis``."""
    if mesh is None:
        return lambda E: (0, E)
    from photon_ml_tpu_torch.parallel.mesh import axis_index, axis_size
    from photon_ml_tpu_torch.parallel.multihost import span_of

    r, size = axis_index(mesh, axis), axis_size(mesh, axis)
    return lambda E: span_of(E, r, size)
