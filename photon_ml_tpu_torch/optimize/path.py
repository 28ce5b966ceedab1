"""Pathwise fixed-effect GLM training with KKT-certified screening
(counterpart of ``photon_ml_tpu/optimize/path.py``).

Walking the lambda grid in decreasing order, a feature whose data-gradient
magnitude at the previous lambda's solution falls below the sequential
threshold (``ops.regularization.screening_threshold``) is frozen at zero,
the restricted problem is solved over the survivors, and a full-gradient
KKT check certifies the screen: violators re-enter and the solve repeats,
so a screened fit matches the unscreened fit within solver tolerance by
construction.

Cost per lambda (no repair round): one restricted solve over a
power-of-two bucket of the candidate width plus one full data pass, the
certification gradient, which is reused as the next lambda's screening
gradient.

Restriction is an ELL column remap done on the device: member columns map
through a LUT to ``[0, bucket)`` (the intercept pinned to restricted slot
0), non-member slots keep index 0 with value 0. The restricted batch has
the same ``[n, k]`` shape with explicit values and only ``dim`` shrunk.
Dense features restrict by a column gather from a copy with one trailing
all-zero column (pad slots index it).

Every full-gradient pass and every restricted solve of sparse features goes
through the column-sorted ``X^T d`` of the resolved ``sparse_grad`` mode:
``"auto"`` resolves to ``"csc_kernel"``, so on the card each of them
launches ``ops.kernels.csc_column_sums``. The full problem's
column-sorted view is built once (or taken from ``precomputed_csc``); each
restricted solve builds its own inside ``fit_distributed``.

With a mesh (``parallel.mesh.make_mesh``), the in-memory batch is cut
into row blocks once (``parallel.mesh.shard_batch``): every certification
pass and every restricted solve runs on this rank's block, summed over the
mesh's ``axis``, so every rank screens, solves and certifies alike. In
the out-of-core mode each process streams its own rows and the streamed
passes sum across processes (``parallel.streaming``).

Normalization does not compose with screening (the virtual shift couples
every column through the margin adjustment), so :class:`PathSolver`
refuses the combination.

Every lambda runs inside a ``glm.path_lambda`` trace span and adds its
screening work to the training metrics (``obs``). In place of the JAX
solver's ``compiled_kernel_count`` (XLA executables, which eager torch
does not build), :class:`PathSolver` counts what a walk costs the card:
``kernel_launches`` (``ops.kernels.csc_column_sums`` launches) and
``host_reads`` (device-to-host reads: its solves' and its own), both
running totals over every ``solve``.

The out-of-core mode (``chunks=`` host chunks, e.g. a disk-backed
``io.stream_source.AvroChunkSource``) runs every solve through
``parallel.streaming.fit_streaming``: a restricted solve streams
:class:`_RestrictedChunks`, which remaps each chunk's columns through the
LUT on the host as the transfer thread pulls it, and the certification
pass is one ``streaming_value_and_grad`` pass. Under a chunk cache the
whole path is one decode of the data.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.obs import metrics as obs_metrics
from photon_ml_tpu_torch.obs import trace as obs_trace
from photon_ml_tpu_torch.ops import kernels
from photon_ml_tpu_torch.ops.objective import GLMObjective, make_objective
from photon_ml_tpu_torch.ops.regularization import (
    RegularizationContext, kkt_slack, screening_threshold,
)
from photon_ml_tpu_torch.optimize.common import (
    OptimizationResult, OptimizerConfig, PathConfig,
)
from photon_ml_tpu_torch.parallel.data_parallel import (
    build_csc, distributed_value_and_grad, fit_shard, make_csc_path,
    resolve_sparse_grad,
)
from photon_ml_tpu_torch.parallel.mesh import mesh_device, shard_batch
from photon_ml_tpu_torch.parallel.streaming import (
    HostChunk, fit_streaming, streaming_value_and_grad,
)
from photon_ml_tpu_torch.types import (
    LabeledBatch, SparseFeatures, resolve_device,
)

_log = logging.getLogger("photon_ml_tpu_torch")

__all__ = ["PathSolver", "PathLambdaStats", "next_power_of_two",
           "pad_to_bucket"]


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def pad_to_bucket(n: int, floor: int = 1) -> int:
    """Power-of-two bucket width for a candidate set of size ``n`` with a
    lower bound of ``floor``."""
    return next_power_of_two(max(int(n), int(floor)))


@dataclasses.dataclass
class PathLambdaStats:
    """Per-lambda screening record, with the JAX package's keys.
    ``screened_dim`` is the restricted width the final solve ran over (the
    bucket; ``dim`` when the solve fell through to full width)."""

    lam: float
    lam_l1: float
    lam_l2: float
    dim: int
    candidate_size: int      # candidates entering the first restricted solve
    screened_dim: int        # restricted width of the final (accepted) solve
    features_frozen: int     # dim - final candidate count (0 on full solves)
    kkt_rounds: int          # solve rounds total; 1 = screen held first try
    kkt_violations: int      # violators re-admitted across repair rounds
    solver_iterations: int   # optimizer iterations summed over rounds
    full_grad_passes: int    # full data passes paid for screen init + certs
    fallback_full: bool      # repair budget exhausted -> full-width solve
    screen_rule: str
    certified: bool          # always True on return (full solves trivially)
    solver_tolerance: float
    solve_seconds: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _PathState:
    """One warm snapshot per solved lambda: the solution and (lazily) the
    certified data gradient at it, the next lambda's screening input.
    ``g`` is None for seeded states and full-width solves."""

    lam: float
    lam_l1: float
    w: torch.Tensor
    g: Optional[torch.Tensor]


class _RestrictedChunks:
    """Lazy LUT-remapped view of a host chunk sequence: each access
    rebuilds the chunk with member columns remapped into ``[0, bucket)``
    and non-member slots zeroed, at the same ``[rows, k]`` shape.
    Implicit-ones chunks materialize values here (the member mask is the
    value)."""

    def __init__(self, chunks: Sequence, member: np.ndarray,
                 lut: np.ndarray, value_dtype):
        self._chunks = chunks
        self._member = member
        self._lut = lut
        self._vdtype = value_dtype

    def __len__(self) -> int:
        return len(self._chunks)

    def _remap(self, c):
        m = self._member[c.indices]
        idx = np.where(m, self._lut[c.indices], 0)
        ones = np.ones(c.indices.shape, self._vdtype)
        vals = ones if c.values is None else c.values
        return HostChunk(
            indices=np.ascontiguousarray(idx, np.int32),
            values=np.where(m, vals, np.zeros((), self._vdtype)),
            labels=c.labels, offsets=c.offsets, weights=c.weights)

    def __getitem__(self, i):
        return self._remap(self._chunks[i])

    def __iter__(self):
        for c in self._chunks:
            yield self._remap(c)


class PathSolver:
    """Pathwise fixed-effect solver: screen -> restricted solve -> KKT
    certify, one lambda at a time, with warm state shared across calls.

    Exactly one of ``batch`` (a LabeledBatch on its device; every tensor
    the solver makes lies there) and ``chunks`` (host chunks, with ``dim``,
    ``dtype`` and ``device``, default ``cuda``) is given. With ``mesh``,
    every rank passes the same whole ``batch`` (each keeps its row block
    on its own device, and ``precomputed_csc`` is ``build_csc(batch,
    mesh=mesh)``), or its own rows as ``chunks`` (streamed on the mesh's
    device).
    ``solve(reg_weight)`` returns ``(OptimizationResult, PathLambdaStats)``
    with the result's ``w`` scattered back to full width and
    ``solver_tolerance``/``screened_dim`` set."""

    def __init__(
        self,
        objective: GLMObjective,
        reg: RegularizationContext,
        *,
        batch: Optional[LabeledBatch] = None,
        chunks=None,
        dim: Optional[int] = None,
        optimizer: str = "lbfgs",
        config: OptimizerConfig = OptimizerConfig(),
        path_config: PathConfig = PathConfig(),
        sparse_grad: str = "auto",
        precomputed_csc=None,
        w0=None,
        dtype=torch.float32,
        prefetch_depth: Optional[int] = None,
        device=None,
        mesh=None,
        axis: str = "data",
    ):
        if (batch is None) == (chunks is None):
            raise ValueError("pass exactly one of batch= or chunks=")
        if objective.normalization is not None \
                and path_config.screen != "off":
            raise ValueError(
                "screening does not compose with normalization (the "
                "virtual shift couples all columns through the margin "
                "adjustment); fit unnormalized or pass screen='off'")
        self._objective = objective
        self._reg = reg
        self._optimizer = optimizer
        self._config = config
        self._pc = path_config
        self._sparse_grad = sparse_grad
        self._states: List[_PathState] = []
        self._init_probe = None  # (w_init, g_init, lam1_max), lazy
        self.total_iterations = 0  # across every solve
        self.kernel_launches = 0  # csc_column_sums launches, every solve
        self.host_reads = 0  # device-to-host reads, every solve
        # one restricted objective serves every bucket: the intercept sits
        # in restricted slot 0 whatever the width
        self._robj = make_objective(
            objective.loss, None, objective.regularize_intercept,
            0 if objective.intercept_index >= 0 else -1)
        self._chunks = chunks
        self._prefetch_depth = prefetch_depth
        self._mesh, self._axis = mesh, axis
        if chunks is not None:
            if dim is None:
                raise ValueError("chunks= mode needs dim=")
            self._batch = None
            self._dev = (mesh_device(mesh) if mesh is not None
                         and device is None else resolve_device(device))
            self._dtype = dtype
            self._dim = int(dim)
            self._csc = None
            fg = streaming_value_and_grad(
                objective, chunks, self._dim, dtype, prefetch_depth,
                sparse_grad=sparse_grad, device=self._dev)
            self._full_fg = lambda w: fg(w, 0.0)
        else:
            self._init_batch(batch, objective, sparse_grad, precomputed_csc)
        self._w_init = (torch.zeros(self._dim, dtype=self._dtype,
                                    device=self._dev) if w0 is None
                        else torch.as_tensor(w0, dtype=self._dtype,
                                             device=self._dev))
        self._penalized = torch.ones(self._dim, dtype=torch.bool,
                                     device=self._dev)
        if objective.intercept_index >= 0 \
                and not objective.regularize_intercept:
            self._penalized[objective.intercept_index] = False

    def _init_batch(self, batch, objective, sparse_grad, precomputed_csc):
        mesh, axis = self._mesh, self._axis
        if mesh is not None:
            batch = shard_batch(batch, mesh, axis)
        self._batch = batch
        self._dev = batch.device
        self._dtype = batch.labels.dtype
        feats = batch.features
        self._dim = batch.dim
        resolved = resolve_sparse_grad(sparse_grad, feats)
        if isinstance(feats, SparseFeatures):
            self._dense_z = None
            self._ones = (torch.ones(feats.indices.shape, dtype=self._dtype,
                                     device=self._dev)
                          if feats.values is None else None)
        else:
            # one trailing all-zero column: restricted batches gather
            # columns from it, pad slots index the zero column
            self._dense_z = torch.nn.functional.pad(feats, (0, 1))
        # the full problem's column-sorted view serves the certification
        # passes and full-width solves; restricted solves build their own
        self._csc = None
        self._full_fg = None
        if resolved in ("csc", "csc_kernel", "csc_precise", "csc_segment"):
            self._csc = (precomputed_csc if precomputed_csc is not None
                         else build_csc(batch,
                                        with_cols=resolved == "csc_segment"))
            _, fg, _ = make_csc_path(
                objective, use_kernel=resolved == "csc_kernel",
                precise=resolved == "csc_precise",
                segment=resolved == "csc_segment", mesh=mesh, axis=axis)
            csc = self._csc
            self._full_fg = lambda w: fg(w, batch, csc, 0.0)
        else:
            if precomputed_csc is not None:
                raise ValueError(
                    f"precomputed_csc given but sparse_grad={resolved!r} "
                    "does not use it")
            fg = distributed_value_and_grad(objective, mesh=mesh, axis=axis)
            self._full_fg = lambda w: fg(w, batch, 0.0)

    # -- full data-gradient pass (screen init + certification) -------------
    def _full_grad(self, w: torch.Tensor) -> torch.Tensor:
        """Data-only gradient (l2 = 0) at ``w``: the quantity the screening
        rules and the zero-coordinate KKT condition are stated in."""
        return self._full_fg(w)[1]

    def _ensure_grad(self, state: _PathState) -> int:
        if state.g is not None:
            return 0
        state.g = self._full_grad(state.w)
        return 1

    # -- warm/screening source ----------------------------------------------
    def _warm_source(self, lam: float) -> Optional[_PathState]:
        """Nearest solved lambda above ``lam``; failing that, the largest
        solved lambda below (its over-screening is repaired by the KKT
        loop)."""
        above = [s for s in self._states if s.lam >= lam]
        if above:
            return min(above, key=lambda s: s.lam)
        if self._states:
            return max(self._states, key=lambda s: s.lam)
        return None

    def _probe(self):
        """First-lambda screening source: the data gradient at the start
        point, whose max penalized magnitude is lambda_max. Computed once."""
        if self._init_probe is None:
            g0 = self._full_grad(self._w_init)
            lam1_max = float(torch.max(torch.abs(g0) * self._penalized))
            self.host_reads += 1
            self._init_probe = (self._w_init, g0, lam1_max)
        return self._init_probe

    def lambda_max(self) -> float:
        """Max penalized |data gradient| at the start point: the L1 weight
        above which the penalized solution is all zero."""
        return self._probe()[2]

    def seed_state(self, lam: float, w) -> None:
        """Install a solved lambda's solution without re-solving; its
        gradient is computed on first use."""
        w = torch.as_tensor(w, dtype=self._dtype, device=self._dev)
        self._keep(_PathState(lam=float(lam),
                              lam_l1=self._reg.l1_weight(float(lam)),
                              w=w, g=None))

    def _keep(self, state: _PathState) -> None:
        if self._pc.keep_states:
            self._states.append(state)
        else:
            self._states = [state]

    def reset_states(self) -> None:
        """Drop every warm/screening state and the lambda_max probe."""
        self._states = []
        self._init_probe = None
        self.total_iterations = 0

    # -- restricted problem construction -------------------------------------
    def _selection(self, member: torch.Tensor):
        """(cols, lut) for a member mask, the intercept pinned to
        restricted slot 0."""
        ii = self._objective.intercept_index
        cols = torch.nonzero(member).reshape(-1)  # its size: a host read
        self.host_reads += 1
        if ii >= 0:
            cols = torch.cat([torch.tensor([ii], dtype=cols.dtype,
                                           device=cols.device),
                              cols[cols != ii]])
            self.host_reads += 1  # the mask's count
        lut = torch.zeros(self._dim, dtype=torch.int32, device=self._dev)
        lut[cols] = torch.arange(cols.shape[0], dtype=torch.int32,
                                 device=self._dev)
        return cols, lut

    def _restrict_batch(self, member, cols, lut, bucket) -> LabeledBatch:
        b = self._batch
        if self._dense_z is not None:
            idx = torch.full((bucket,), self._dim, dtype=torch.int64,
                             device=self._dev)
            idx[: cols.shape[0]] = cols
            feats = self._dense_z[:, idx]
        else:
            f = b.features
            m = member[f.indices]
            idx = torch.where(m, lut[f.indices], 0).to(torch.int32)
            vals = self._ones if f.values is None else f.values
            feats = SparseFeatures(
                indices=idx.contiguous(),
                values=torch.where(m, vals, 0.0).contiguous(),
                dim=bucket)
        return LabeledBatch(feats, b.labels, b.offsets, b.weights)

    # -- solves ---------------------------------------------------------------
    def _resolve_opt(self, lam_l1: float) -> str:
        # the smooth optimizers cannot represent the L1 subgradient
        opt = "lbfgs" if self._optimizer == "auto" else self._optimizer
        return "owlqn" if lam_l1 > 0 else opt

    def _solve_restricted(self, member, cols, lut, bucket, w_warm, lam_l1,
                          lam_l2, run_cfg) -> OptimizationResult:
        w0 = torch.zeros(bucket, dtype=self._dtype, device=self._dev)
        w0[: cols.shape[0]] = w_warm[cols]
        if self._chunks is not None:
            rchunks = _RestrictedChunks(
                self._chunks, member.cpu().numpy(), lut.cpu().numpy(),
                torch.empty((), dtype=self._dtype).numpy().dtype)
            self.host_reads += 2
            return self._counted(fit_streaming(
                self._robj, rchunks, bucket, w0, l2=lam_l2, config=run_cfg,
                dtype=self._dtype, optimizer=self._resolve_opt(lam_l1),
                l1=lam_l1, prefetch_depth=self._prefetch_depth,
                sparse_grad=self._sparse_grad, device=self._dev))
        rbatch = self._restrict_batch(member, cols, lut, bucket)
        return self._counted(fit_shard(
            self._robj, rbatch, w0, l2=lam_l2, l1=lam_l1,
            optimizer=self._resolve_opt(lam_l1), config=run_cfg,
            sparse_grad=self._sparse_grad, mesh=self._mesh,
            axis=self._axis))

    def _solve_full(self, w_warm, lam_l1, lam_l2,
                    run_cfg) -> OptimizationResult:
        if self._chunks is not None:
            return self._counted(fit_streaming(
                self._objective, self._chunks, self._dim, w_warm, l2=lam_l2,
                config=run_cfg, dtype=self._dtype,
                optimizer=self._resolve_opt(lam_l1), l1=lam_l1,
                prefetch_depth=self._prefetch_depth,
                sparse_grad=self._sparse_grad, device=self._dev))
        return self._counted(fit_shard(
            self._objective, self._batch, w_warm, l2=lam_l2, l1=lam_l1,
            optimizer=self._resolve_opt(lam_l1), config=run_cfg,
            sparse_grad=self._sparse_grad, precomputed_csc=self._csc,
            mesh=self._mesh, axis=self._axis))

    def _counted(self, res: OptimizationResult) -> OptimizationResult:
        self.host_reads += int(res.host_syncs)
        return res

    # -- the per-lambda walk --------------------------------------------------
    def solve(self, reg_weight: float, tolerance: Optional[float] = None
              ) -> tuple:
        """Solve one lambda: screen from the warm source's certified
        gradient, solve the restricted problem on the bucket ladder,
        KKT-certify, repair and re-solve on violations (full-width fallback
        after ``max_kkt_rounds``). Returns ``(OptimizationResult,
        PathLambdaStats)``."""
        lam = float(reg_weight)
        lam_l1 = self._reg.l1_weight(lam)
        lam_l2 = self._reg.l2_weight(lam)
        tol = self._config.tolerance if tolerance is None else tolerance
        run_cfg = (self._config if tolerance is None
                   else dataclasses.replace(self._config,
                                            tolerance=tolerance))
        t0 = time.perf_counter()
        launches = kernels.csc_column_sums.launches
        with obs_trace.span("glm.path_lambda", cat="train", lam=lam,
                            l1=lam_l1, l2=lam_l2,
                            rule=self._pc.screen) as sp:
            res, stats = self._solve_one(lam, lam_l1, lam_l2, run_cfg,
                                         float(tol))
            stats.solve_seconds = time.perf_counter() - t0
            sp.set(candidates=stats.candidate_size,
                   screened_dim=stats.screened_dim,
                   frozen=stats.features_frozen,
                   kkt_rounds=stats.kkt_rounds,
                   kkt_violations=stats.kkt_violations,
                   fallback=stats.fallback_full,
                   iterations=stats.solver_iterations)
        self.kernel_launches += kernels.csc_column_sums.launches - launches
        obs_metrics.training_metrics().record_path_lambda(
            frozen=stats.features_frozen, rounds=stats.kkt_rounds,
            violations=stats.kkt_violations,
            full_grad_passes=stats.full_grad_passes,
            fallback=stats.fallback_full)
        self.total_iterations = self.total_iterations \
            + stats.solver_iterations
        _log.info(
            "path lambda=%g rule=%s: candidates=%d/%d screened_dim=%d "
            "frozen=%d kkt_rounds=%d violations=%d iters=%d tol=%g "
            "fallback=%s", lam, stats.screen_rule, stats.candidate_size,
            stats.dim, stats.screened_dim, stats.features_frozen,
            stats.kkt_rounds, stats.kkt_violations,
            stats.solver_iterations, stats.solver_tolerance,
            stats.fallback_full)
        return res, stats

    def _solve_one(self, lam, lam_l1, lam_l2, run_cfg, tol):
        stats = PathLambdaStats(
            lam=lam, lam_l1=lam_l1, lam_l2=lam_l2, dim=self._dim,
            candidate_size=self._dim, screened_dim=self._dim,
            features_frozen=0, kkt_rounds=0, kkt_violations=0,
            solver_iterations=0, full_grad_passes=0, fallback_full=False,
            screen_rule=self._pc.screen, certified=False,
            solver_tolerance=tol, solve_seconds=0.0)

        src = self._warm_source(lam)
        if self._pc.screen == "off" or lam_l1 <= 0:
            # warm-started full-width fit (also the no-L1 case, where
            # nothing is exactly zero): certified by the solver's own test
            w_warm = src.w if src is not None else self._w_init
            res = self._solve_full(w_warm, lam_l1, lam_l2, run_cfg)
            stats.kkt_rounds = 1
            stats.solver_iterations = int(res.iterations)
            stats.certified = True
            self._keep(_PathState(lam, lam_l1, res.w, None))
            return self._finish(res, res.w, self._dim, tol), stats

        if src is not None:
            stats.full_grad_passes = stats.full_grad_passes \
                + self._ensure_grad(src)
            w_prev, g_prev, lam_l1_prev = src.w, src.g, src.lam_l1
        else:
            w_prev, g_prev, lam1_max = self._probe()
            stats.full_grad_passes = stats.full_grad_passes + 1
            lam_l1_prev = max(lam1_max, lam_l1)

        thr = screening_threshold(self._pc.screen, lam_l1,
                                  max(lam_l1_prev, lam_l1),
                                  self._pc.screen_slack)
        member = ((torch.abs(g_prev) >= thr) | (w_prev != 0)
                  | ~self._penalized)
        n_sel = int(torch.count_nonzero(member))
        self.host_reads += 1
        stats.candidate_size = n_sel

        w_full = w_prev
        res = None
        g_cert: Optional[torch.Tensor] = None
        while True:
            stats.kkt_rounds = stats.kkt_rounds + 1
            bucket = pad_to_bucket(n_sel, self._pc.min_bucket)
            over_budget = stats.kkt_rounds > self._pc.max_kkt_rounds
            if bucket >= self._dim or over_budget:
                # nothing to gain from restriction (or the repair budget
                # is spent): full-width solve, certified by construction
                stats.fallback_full = over_budget
                res = self._solve_full(w_full, lam_l1, lam_l2, run_cfg)
                stats.solver_iterations = stats.solver_iterations \
                    + int(res.iterations)
                stats.screened_dim = self._dim
                stats.features_frozen = 0
                stats.certified = True
                w_full = res.w
                g_cert = None  # the next lambda recomputes it (one pass)
                break
            cols, lut = self._selection(member)
            res = self._solve_restricted(member, cols, lut, bucket, w_full,
                                         lam_l1, lam_l2, run_cfg)
            stats.solver_iterations = stats.solver_iterations \
                + int(res.iterations)
            w_full = torch.zeros(self._dim, dtype=self._dtype,
                                 device=self._dev)
            w_full[cols] = res.w[: cols.shape[0]]
            # certification: one full data pass; at screened (zero)
            # coordinates the elastic-net KKT condition is |g_j| <= l1
            g_cert = self._full_grad(w_full)
            stats.full_grad_passes = stats.full_grad_passes + 1
            slack = kkt_slack(lam_l1, self._pc.kkt_tol)
            viol = (~member) & (torch.abs(g_cert) > lam_l1 + slack)
            nv = int(torch.count_nonzero(viol))
            self.host_reads += 1
            if nv == 0:
                stats.screened_dim = bucket
                stats.features_frozen = self._dim - n_sel
                stats.certified = True
                break
            stats.kkt_violations = stats.kkt_violations + nv
            member = member | viol
            n_sel = n_sel + nv

        self._keep(_PathState(lam, lam_l1, w_full, g_cert))
        return self._finish(res, w_full, stats.screened_dim, tol), stats

    def _finish(self, res: OptimizationResult, w_full: torch.Tensor,
                screened_dim: int, tol: float) -> OptimizationResult:
        return res._replace(w=w_full, solver_tolerance=float(tol),
                            screened_dim=int(screened_dim))
