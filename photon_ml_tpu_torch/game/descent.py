"""GAME coordinate descent: the training algorithm (counterpart of
``photon_ml_tpu/game/descent.py``).

An outer loop over iterations x coordinates, sequential by design; per
coordinate, the offsets fed to training are ``base + total_scores - this
coordinate's scores`` (the residual trick), the coordinate retrains
warm-started from its previous model, then its scores are recomputed and
validation metrics tracked.

Everything runs on one device per process (``device``, default ``cuda``,
or the mesh's device). A fixed
effect over sparse features takes the column-sorted gradient path: its
``CSCTranspose`` is built once per coordinate, and every gradient and TRON
Hessian-vector product of its fits goes through the resolved ``sparse_grad``
mode's ``X^T d`` (``"auto"`` is ``"csc_kernel"``: on the card, the
``csc_column_sums`` kernel). A fixed coordinate with ``streaming=True``
keeps its shard in host RAM as fixed-shape chunks and streams them through
the device on every pass (``parallel.streaming.fit_streaming``, the same
kernel per chunk); a shard in ``GameDataset.feature_sources`` (a
disk-backed ``io.stream_source.AvroChunkSource``) never materializes on the
host, and each CD step's residual offsets ride over it through
``ScalarOverlaySource``. Random effects solve their buckets with
``game/random_effect.py``'s batched solvers.

Optimizer-space coefficients (normalization folded into the objective)
stay internal; scoring and saved models use model-space coefficients.

With a mesh (``parallel.mesh.make_mesh``), one process per device:

* a ``data`` axis of more than one rank shards an in-memory fixed
  coordinate's rows (each rank fits on its own block, every pass summed
  over the axis); its scores are all-gathered into the full residual
  vector that every rank keeps, and device AUC is the histogram AUC over
  the axis;
* an ``entity`` axis of more than one rank shards the random coordinates:
  each rank solves one block of every bucket's entities and the model is
  all-gathered (``train_random_effect(mesh=)``); each rank scores its own
  entities' rows, and since each row's score comes from one entity, an
  all-reduce SUM of the disjoint per-rank score vectors is exact;
* whenever the world holds more than one process, a streamed fixed
  coordinate streams this process's ``process_span`` of the rows (or its
  ``AvroChunkSource(process_part=)`` share) and its partials sum across
  processes, as in the reference.

Entity sharding (``entity_shard``, a ``parallel.entity_shard.
EntityShardSpec``), as in the reference: each process builds and solves
only the random-effect entities it owns, and every sweep publishes only
the rows whose score bitwise changed (the delta-only exchange). The full
tables cross the wire only at save points (``allgather_objects``), so
checkpoints and saved models keep the single-file layout.
``entity_table_budget_bytes`` fails a coordinate whose local table is
over it before the first sweep. Every coordinate step runs inside a
``cd.coordinate`` trace span and records its solve, eval and exchange
seconds in the training metrics (``obs``). Every step runs inside a
``resilience.CollectiveGuard`` (with the ``cd.step`` fault site), so one
process's failure raises ``PeerFailure`` on every process; with
``recovery`` (a ``parallel.recovery.RecoveryManager``) each sweep starts
with a committed snapshot and a ``PeerFailure`` rolls the run back to it
(or, on a transport that can shrink, redistributes a lost rank's
entities over the survivors). The exchanges and barriers go through the
resilience transport, the ``mesh=`` collectives through
``torch.distributed``: so the same CD runs in simulated processes on the
CPU and as real ranks on the card.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from photon_ml_tpu_torch.evaluation import get_evaluator
from photon_ml_tpu_torch.evaluation.device import (
    make_device_evaluator, make_grouped_device_evaluator,
)
from photon_ml_tpu_torch.game.data import (
    HostSparse, RandomEffectTrainData, SketchProjection,
    build_random_effect_data, build_score_view, host_sparse_from_features,
)
from photon_ml_tpu_torch.game.random_effect import (
    _check_re_optimizer, score_random_effect, train_random_effect,
)
from photon_ml_tpu_torch.game.sampling import down_sample
from photon_ml_tpu_torch.obs import metrics as obs_metrics
from photon_ml_tpu_torch.obs import trace as obs_trace
from photon_ml_tpu_torch.models import (
    Coefficients, FixedEffectModel, GameModel, GeneralizedLinearModel,
    RandomEffectBucket, RandomEffectModel,
)
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.ops.regularization import (
    RegularizationContext, RegularizationType,
)
from photon_ml_tpu_torch.optimize import OptimizerConfig, get_optimizer
from photon_ml_tpu_torch.io.stream_source import ScalarOverlaySource
from photon_ml_tpu_torch.parallel import fault_injection
from photon_ml_tpu_torch.parallel.data_parallel import (
    distributed_coefficient_variances, distributed_hvp, distributed_value,
    distributed_value_and_grad, make_csc_path, resolve_sparse_grad,
)
from photon_ml_tpu_torch.parallel.entity_shard import (
    EntityShardSpec, ShardCommStats, allgather_objects, check_table_budget,
    exchange_score_updates,
)
from photon_ml_tpu_torch.parallel.mesh import (
    axis_size, mesh_device, pad_rows, shard_rows,
)
from photon_ml_tpu_torch.parallel.multihost import (
    allgather_spans, allgather_varspans, process_count, process_span,
)
from photon_ml_tpu_torch.parallel.resilience import (
    CollectiveGuard, PeerFailure, health_barrier,
)
from photon_ml_tpu_torch.parallel.streaming import (
    PinnedRing, fit_streaming, iter_device_chunks, make_host_chunks,
    resolve_prefetch_depth, streaming_coefficient_variances,
)
from photon_ml_tpu_torch.types import (
    LabeledBatch, SparseFeatures, margins as _margins, resolve_device,
)

_log = logging.getLogger(__name__)

_CSC_MODES = ("csc", "csc_kernel", "csc_precise", "csc_segment")


def _changed_rows(new_np: np.ndarray, old_np: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """This shard's bitwise-changed rows and their new values: the
    published delta."""
    rows = np.flatnonzero(new_np != old_np).astype(np.int32)
    return rows, new_np[rows]


def _scatter_rows(prev_np: np.ndarray, row_parts: Sequence[np.ndarray],
                  val_parts: Sequence[np.ndarray]) -> np.ndarray:
    """Scatter every shard's published rows (disjoint by entity
    ownership) into a copy of the previous global vector."""
    out = np.array(prev_np, copy=True)
    rows = np.concatenate(list(row_parts))
    if len(rows):
        out[rows] = np.concatenate(list(val_parts))
    return out


@dataclasses.dataclass(frozen=True)
class CoordinateConfig:
    """Per-coordinate optimization configuration (the reference's
    ``FixedEffectOptimizationConfiguration`` /
    ``RandomEffectOptimizationConfiguration`` parameter surface)."""

    name: str
    coordinate_type: str = "fixed"  # "fixed" | "random"
    feature_shard: str = "global"
    entity_column: Optional[str] = None  # required for random
    # "auto": L-BFGS for fixed and random coordinates
    # (random_effect.resolve_re_optimizer). Explicit: "lbfgs" |
    # "tron" | "owlqn", plus "newton" (random only)
    optimizer: str = "auto"
    max_iters: int = 100
    tolerance: float = 1e-8
    reg_type: str | RegularizationType = RegularizationType.NONE
    reg_weight: float = 0.0
    elastic_net_alpha: float = 0.5
    down_sampling_rate: float = 1.0  # fixed-effect only
    # fixed-effect sparse gradient: "auto" (resolve_sparse_grad: the
    # column-sorted kernel path for sparse features), "scatter", "csc",
    # "csc_kernel", "csc_precise" or "csc_segment"
    sparse_grad: str = "auto"
    # larger-than-device-memory fixed effect: the shard stays on the host
    # as fixed-shape chunks streamed through the device every pass
    streaming: bool = False
    chunk_rows: int = 1 << 16
    # streamed transfer-ring depth (parallel.streaming.iter_device_chunks)
    prefetch_depth: Optional[int] = None
    active_cap: Optional[int] = None  # random-effect only
    num_buckets: int = 4  # random-effect entity size buckets
    # Active-set coordinate descent (random-effect only): entities whose
    # solver converged are frozen; a later sweep re-solves an entity only
    # if its residual offsets drifted by more than active_tol (max-abs over
    # its rows, relative to max(1, |offsets|)) since its last solve. Every
    # refresh_every-th sweep re-solves every entity. active_tol=None is a
    # few ulps of the working dtype.
    active_set: bool = True
    refresh_every: int = 4
    active_tol: Optional[float] = None
    # random-effect projector: "subspace" (exact per-entity maps) or
    # "random" (shared count-sketch of width projection_dim)
    projection: str = "subspace"
    projection_dim: Optional[int] = None
    projection_seed: int = 0
    # False | True/"diagonal" (1/diag(H)) | "full" (diag(H^-1))
    compute_variance: bool | str = False
    normalization: Optional[NormalizationContext] = None
    intercept_index: int = -1

    def reg_context(self) -> RegularizationContext:
        return RegularizationContext(RegularizationType(self.reg_type),
                                     self.elastic_net_alpha)

    def opt_config(self) -> OptimizerConfig:
        return OptimizerConfig(max_iters=self.max_iters,
                               tolerance=self.tolerance)

    def __post_init__(self):
        if self.coordinate_type not in ("fixed", "random"):
            raise ValueError(f"coordinate_type must be fixed|random, got "
                             f"{self.coordinate_type}")
        if self.coordinate_type == "random" and self.entity_column is None:
            raise ValueError(f"random coordinate '{self.name}' needs "
                             "entity_column")
        if self.streaming and self.coordinate_type != "fixed":
            raise ValueError(
                f"coordinate '{self.name}': streaming applies to fixed "
                "effects (random-effect data is per-entity bucketed)")
        if self.optimizer == "newton" and self.coordinate_type != "random":
            raise ValueError(
                f"coordinate '{self.name}': optimizer='{self.optimizer}' "
                "selects a batched per-entity solver — random coordinates "
                "only (fixed effects use lbfgs/owlqn/tron)")
        if self.coordinate_type == "random":
            _check_re_optimizer(self.optimizer)
        if (self.coordinate_type == "random" and self.normalization is not None
                and self.projection == "random"):
            raise ValueError(
                f"random coordinate '{self.name}': normalization is not "
                "supported with projection='random' (count-sketch slots mix "
                "features); use projection='subspace'")
        if self.compute_variance not in (False, True, "diagonal", "full"):
            raise ValueError(
                f"compute_variance={self.compute_variance!r}; expected "
                "False, True, 'diagonal' or 'full'")
        # fail at config time, not after a long streamed fit
        if self.compute_variance == "full" and self.streaming:
            raise ValueError(
                "compute_variance='full' needs the d x d Hessian in device "
                "memory; not available with streaming=True (use 'diagonal')")
        if self.prefetch_depth is not None and self.prefetch_depth < 0:
            raise ValueError(
                f"coordinate '{self.name}': prefetch_depth must be >= 0, "
                f"got {self.prefetch_depth}")
        if self.refresh_every < 1:
            raise ValueError(
                f"coordinate '{self.name}': refresh_every must be >= 1, "
                f"got {self.refresh_every}")
        if self.active_tol is not None and not (
                np.isfinite(self.active_tol) and self.active_tol >= 0):
            raise ValueError(
                f"coordinate '{self.name}': active_tol must be finite and "
                f">= 0, got {self.active_tol}")


@dataclasses.dataclass
class GameDataset:
    """Host-resident GAME dataset: shared labels/weights/offsets plus one
    feature matrix per shard and one id column per entity type."""

    features: Dict[str, HostSparse]
    labels: np.ndarray
    weights: np.ndarray
    offsets: np.ndarray
    entity_ids: Dict[str, np.ndarray]
    group_ids: Optional[np.ndarray] = None  # for per_group_* evaluators
    # larger-than-host-RAM shards: a disk-backed chunk source (e.g.
    # io.stream_source.AvroChunkSource over the same rows, in order) per
    # shard that is NOT materialized in `features`; a streaming fixed
    # coordinate on it re-decodes its features every optimizer pass
    feature_sources: Optional[Dict[str, object]] = None

    def __post_init__(self):
        self.labels = np.asarray(self.labels, np.float64)
        n = len(self.labels)
        self.weights = (np.ones(n) if self.weights is None
                        else np.asarray(self.weights, np.float64))
        self.offsets = (np.zeros(n) if self.offsets is None
                        else np.asarray(self.offsets, np.float64))
        self.features = {k: host_sparse_from_features(v)
                         for k, v in self.features.items()}

    @property
    def num_samples(self) -> int:
        return len(self.labels)


def make_game_dataset(features, labels, weights=None, offsets=None,
                      entity_ids=None, group_ids=None) -> GameDataset:
    if not isinstance(features, dict):
        features = {"global": features}
    return GameDataset(features, labels, weights, offsets, entity_ids or {},
                       group_ids)


def _device_features(sp: HostSparse, dtype, device) -> SparseFeatures:
    return SparseFeatures(
        torch.as_tensor(sp.indices, dtype=torch.int32, device=device),
        None if sp.values is None
        else torch.as_tensor(sp.values, device=device).to(dtype),
        dim=sp.dim)


class _ResidualTotal:
    """Running residual total ``base + sum(coordinate scores)``, updated
    by subtract/add on the changed coordinate and re-derived once per sweep
    (``resync``, summing in the configs' order) so the running updates'
    rounding cannot accumulate across sweeps."""

    def __init__(self, base):
        self.base = base
        self.total = base

    def resync(self, scores: Dict[str, torch.Tensor]) -> None:
        self.total = self.base + sum(scores.values())

    def excluding(self, name: str, scores: Dict[str, torch.Tensor]):
        """Residual offsets for one coordinate: everything but its own
        scores."""
        return self.total - scores[name]

    def replace(self, old_scores, new_scores) -> None:
        self.total = self.total - old_scores + new_scores


def _drift_active_masks(buckets, frozen, offs_np: np.ndarray,
                        snap: np.ndarray, tol: float) -> List[np.ndarray]:
    """Per-bucket active masks for a non-refresh sweep: an entity is
    re-solved when it never converged (``~frozen``) or when its residual
    offsets drifted: the max-abs change over its rows since its last solve
    exceeds ``tol * max(1, |snapshot|_inf over its rows)``."""
    d_all = np.abs(offs_np - snap)
    masks: List[np.ndarray] = []
    for b, bucket in enumerate(buckets):
        E = bucket.num_entities
        if E == 0:
            masks.append(np.zeros(0, bool))
            continue
        sidx = bucket.sample_idx
        valid = sidx >= 0
        safe = np.maximum(sidx, 0)
        drift = np.max(d_all[safe] * valid, axis=1)
        scale = np.maximum(1.0, np.max(np.abs(snap)[safe] * valid, axis=1))
        masks.append(~frozen[b] | (drift > tol * scale))
    return masks


def _gather_rows(local: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """The full [n] vector from every data rank's equal padded block of
    it, in rank order."""
    parts = [torch.empty_like(local) for _ in range(axis_size(mesh, "data"))]
    dist.all_gather(parts, local, group=mesh.get_group("data"))
    return torch.cat(parts)[:n]


class _FixedState:
    """Per-coordinate fixed-effect state: the device batch, the
    column-sorted view (sparse features) and the fit closure. ``mesh`` is
    a mesh whose ``data`` axis (more than one rank) shards the in-memory
    rows, else None."""

    def __init__(self, cfg: CoordinateConfig, data: GameDataset, dtype,
                 task: str, device: torch.device, mesh=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = device
        self.mesh = mesh
        self.n_all = data.num_samples
        self.w: Optional[torch.Tensor] = None  # optimizer (training) space
        self.variances = None
        reg = cfg.reg_context()
        self.l2 = reg.l2_weight(cfg.reg_weight)
        self.l1 = reg.l1_weight(cfg.reg_weight)
        optimizer = "lbfgs" if cfg.optimizer == "auto" else cfg.optimizer
        if self.l1 > 0 and optimizer != "owlqn":
            optimizer = "owlqn"  # the reference routes L1 to OWL-QN
        self.optimizer = optimizer
        self.obj = make_objective(task, normalization=cfg.normalization,
                                  intercept_index=cfg.intercept_index)
        self._opt = get_optimizer(optimizer)
        self.streaming = cfg.streaming
        self._ooc = None
        if self.streaming:
            self._ring = PinnedRing(device,
                                    resolve_prefetch_depth(
                                        cfg.prefetch_depth) + 2)
        source = (data.feature_sources or {}).get(cfg.feature_shard)
        if source is not None:
            self._init_out_of_core(data, source)
            return
        sp = data.features[cfg.feature_shard]
        self.dim = sp.dim
        if cfg.down_sampling_rate < 1.0:
            rows, w = down_sample(data.labels, data.weights,
                                  cfg.down_sampling_rate, task=task, seed=0)
        else:
            rows, w = np.arange(data.num_samples), data.weights
        full = rows.shape[0] == data.num_samples
        if self.streaming:
            self._init_streaming(sp, data, rows, w, full)
            return
        pad = 0
        if mesh is not None:  # this rank's block of the training rows
            start, per = shard_rows(rows.shape[0], mesh, "data")
            rows, w = rows[start:start + per], w[start:start + per]
            pad = per - rows.shape[0]
            full = False
        self.train_rows = torch.as_tensor(
            np.concatenate([rows, np.zeros(pad, rows.dtype)]),
            dtype=torch.long, device=device)
        block = pad_rows(LabeledBatch(
            SparseFeatures(
                torch.as_tensor(sp.indices if full else sp.indices[rows],
                                dtype=torch.int32, device=device),
                # implicit-ones shards stay value-free
                (None if sp.values is None else
                 torch.as_tensor(sp.values if full else sp.values[rows],
                                 device=device).to(dtype)),
                dim=sp.dim),
            torch.as_tensor(data.labels[rows], device=device).to(dtype),
            torch.zeros(rows.shape[0], dtype=dtype, device=device),
            torch.as_tensor(w, device=device).to(dtype)), rows.shape[0] + pad)
        feats = block.features
        self.labels, self.weights = block.labels, block.weights
        self.feats = feats
        self.l1_mask = None
        if cfg.intercept_index >= 0:
            self.l1_mask = torch.ones(self.dim, dtype=dtype, device=device)
            self.l1_mask[cfg.intercept_index] = 0.0

        self.sparse_grad = resolve_sparse_grad(cfg.sparse_grad, feats)
        self.csc = None
        axis = dict(mesh=mesh, axis="data")
        self._fg = distributed_value_and_grad(self.obj, **axis)
        self._value = distributed_value(self.obj, **axis)
        self._hvp = distributed_hvp(self.obj, **axis)
        if self.sparse_grad in _CSC_MODES:
            build, self._fg_csc, self._hvp_csc = make_csc_path(
                self.obj, use_kernel=self.sparse_grad == "csc_kernel",
                precise=self.sparse_grad == "csc_precise",
                segment=self.sparse_grad == "csc_segment", **axis)
            # sorted once here: offsets change every step, the sparsity
            # pattern never does
            self.csc = build(self._batch(torch.zeros_like(self.labels)))
        # the training copy is the scoring copy when every row trains (a
        # data rank's training block is then its scoring block)
        if mesh is None:
            self.full_features = (feats if full
                                  else _device_features(sp, dtype, device))
        elif cfg.down_sampling_rate >= 1.0:
            self.full_features = feats
        else:
            start, per = shard_rows(self.n_all, mesh, "data")
            stop = min(start + per, self.n_all)
            scored = HostSparse(
                sp.indices[start:stop],
                None if sp.values is None else sp.values[start:stop], sp.dim)
            zeros = torch.zeros(stop - start, dtype=dtype, device=device)
            self.full_features = pad_rows(LabeledBatch(
                _device_features(scored, dtype, device), zeros, zeros,
                zeros), per).features

    def _init_streaming(self, sp: HostSparse, data: GameDataset, rows, w,
                        full: bool) -> None:
        """The shard stays on the host as fixed-shape chunks; no device
        copy of its features exists. With more than one process, this
        process keeps its ``process_span`` of the training rows and of the
        scored rows."""
        t0, t1 = process_span(rows.shape[0])
        s0, s1 = process_span(self.n_all)
        rows, w = rows[t0:t1], w[t0:t1]
        self.train_rows = torch.as_tensor(rows, dtype=torch.long,
                                          device=self.device)
        self._score_span = (s0, s1)
        train_sp = HostSparse(
            np.asarray(sp.indices)[rows],
            None if sp.values is None else np.asarray(sp.values)[rows],
            sp.dim)
        cr = self.cfg.chunk_rows
        self._chunks, _ = make_host_chunks(train_sp, data.labels[rows], None,
                                           w, chunk_rows=cr)
        if full:  # same rows in the same order
            self._score_chunks = self._chunks
        else:
            scored = HostSparse(
                np.asarray(sp.indices)[s0:s1],
                None if sp.values is None else np.asarray(sp.values)[s0:s1],
                sp.dim)
            self._score_chunks = make_host_chunks(
                scored, data.labels[s0:s1], chunk_rows=cr)[0]
        self._last_chunks = self._chunks

    def _init_out_of_core(self, data: GameDataset, source) -> None:
        """A shard that never materializes in host RAM: every optimizer
        pass re-decodes the source's chunks, with the CD residual offsets
        (host arrays) overlaid onto the streamed scalars."""
        cfg = self.cfg
        if not cfg.streaming:
            raise ValueError(
                f"coordinate '{cfg.name}': shard '{cfg.feature_shard}' is "
                "disk-backed (feature_sources) — set streaming=True")
        if cfg.down_sampling_rate < 1.0:
            raise ValueError(
                f"coordinate '{cfg.name}': down-sampling needs row "
                "indexing; not supported out of core")
        total_rows = getattr(source, "total_rows", source.rows)
        pc = process_count()
        spans = getattr(source, "part_spans", None)
        if pc > 1:
            # every process streams its own block share of the same files
            # (AvroChunkSource(process_part=(i, pc))); scores reassemble
            # through the parts' recorded row spans
            if not spans or len(spans) != pc:
                raise ValueError(
                    f"coordinate '{cfg.name}': multi-process out-of-core "
                    "training needs a per-process "
                    f"AvroChunkSource(process_part=(i, {pc})); this source "
                    "has no matching part_spans")
            if (spans[0][0] != 0 or spans[-1][1] != total_rows or any(
                    spans[i][1] != spans[i + 1][0] for i in range(pc - 1))):
                raise ValueError(
                    f"coordinate '{cfg.name}': part spans {spans} do not "
                    "tile the dataset")
        if total_rows != data.num_samples:
            raise ValueError(
                f"coordinate '{cfg.name}': source has {total_rows} rows, "
                f"dataset has {data.num_samples} — they must be the same "
                "data in the same order")
        lo, hi = getattr(source, "row_span", (0, source.rows))
        self.dim = source.dim
        self.train_rows = torch.arange(lo, hi, device=self.device)
        labels, weights = data.labels[lo:hi], data.weights[lo:hi]
        self._ooc = (source, labels, weights)
        self._ooc_spans = spans if pc > 1 else None
        self._score_span = (lo, hi)
        self._score_chunks = source
        self._last_chunks = ScalarOverlaySource(source, labels=labels,
                                                weights=weights)

    def _streamed_chunks(self, offs: torch.Tensor):
        """This step's chunks: the residual offsets over the host chunks
        (or the disk-backed source)."""
        offs_np = offs.cpu().numpy()
        if self._ooc is not None:
            source, labels, weights = self._ooc
            return ScalarOverlaySource(source, labels=labels,
                                       weights=weights, offsets=offs_np)
        cr = self.cfg.chunk_rows
        out = []
        for i, c in enumerate(self._chunks):
            seg = offs_np[i * cr:(i + 1) * cr]
            if len(seg) < cr:
                seg = np.pad(seg, (0, cr - len(seg)))
            out.append(dataclasses.replace(c, offsets=seg))
        return out

    def _batch(self, offs) -> LabeledBatch:
        return LabeledBatch(self.feats, self.labels, offs, self.weights)

    def _closures(self, batch: LabeledBatch):
        """(fun_and_grad, value, hvp) of this step's objective."""
        l2 = self.l2
        value = (lambda w: self._value(w, batch, l2))
        if self.csc is not None:
            csc = self.csc
            return (lambda w: self._fg_csc(w, batch, csc, l2), value,
                    lambda w, v: self._hvp_csc(w, v, batch, csc, l2))
        return (lambda w: self._fg(w, batch, l2), value,
                lambda w, v: self._hvp(w, v, batch, l2))

    def fit(self, offsets_full: torch.Tensor, opt_config=None):
        run_cfg = self.cfg.opt_config() if opt_config is None else opt_config
        offs = offsets_full[self.train_rows].to(self.dtype)
        if self.streaming:
            return self._fit_streaming(offs, run_cfg)
        batch = self._batch(offs)
        fg, value, hvp = self._closures(batch)
        w0 = self.w if self.w is not None else torch.zeros(
            self.dim, dtype=self.dtype, device=self.device)
        if self.optimizer == "owlqn":
            res = self._opt(fg, w0, self.l1, run_cfg, l1_mask=self.l1_mask,
                            fun=value)
        elif self.optimizer == "tron":
            res = self._opt(fg, w0, run_cfg, hvp=hvp)
        else:
            res = self._opt(fg, w0, run_cfg)
        self.w = res.w
        if self.cfg.compute_variance:
            mode = ("full" if self.cfg.compute_variance == "full"
                    else "diagonal")
            self.variances = distributed_coefficient_variances(
                self.obj, mesh=self.mesh, axis="data")(
                    res.w, batch, self.l2, mode=mode)
        return res

    def _fit_streaming(self, offs: torch.Tensor, run_cfg):
        cfg = self.cfg
        chunks = self._streamed_chunks(offs)
        self._last_chunks = chunks
        w0 = self.w if self.w is not None else torch.zeros(
            self.dim, dtype=self.dtype, device=self.device)
        res = fit_streaming(
            self.obj, chunks, self.dim, w0=w0, l2=self.l2, l1=self.l1,
            optimizer=self.optimizer, config=run_cfg, dtype=self.dtype,
            prefetch_depth=cfg.prefetch_depth, sparse_grad=cfg.sparse_grad,
            device=self.device)
        self.w = res.w
        if cfg.compute_variance:
            self.variances = streaming_coefficient_variances(
                self.obj, chunks, self.dim, res.w, self.l2, dtype=self.dtype,
                prefetch_depth=cfg.prefetch_depth,
                sparse_grad=cfg.sparse_grad, device=self.device)
        return res

    def train_scores(self, w_model: torch.Tensor) -> torch.Tensor:
        """This coordinate's margins over every training row; streamed, in
        one pass over the chunks' features (no device copy of the shard).
        Each data rank (each process, streamed) scores its own rows, and
        the blocks are gathered in rank order. The gather is a collective
        boundary reachable outside the sweep's guard (warm start), so a
        health barrier (with the ``cd.score_gather`` fault site) precedes
        it: a peer whose pass failed aborts every process here."""
        if not self.streaming:
            local = _margins(self.full_features, w_model)
            if self.mesh is None:
                return local
            _score_gather_barrier()
            return _gather_rows(local, self.n_all, self.mesh)
        w_model = w_model.to(self.dtype)

        def features(c):
            fields = {"indices": (c.indices, torch.int32)}
            if c.values is not None:
                fields["values"] = (c.values, self.dtype)
            return self._ring.put(fields, "score chunk")

        outs = [_margins(SparseFeatures(t["indices"], t.get("values"),
                                        self.dim), w_model)
                for _c, t in iter_device_chunks(
                    self._score_chunks, features, self.cfg.prefetch_depth)]
        s0, s1 = self._score_span
        local = torch.cat(outs)[: s1 - s0]
        if process_count() == 1:
            return local
        _score_gather_barrier()
        # host gathers of the span margins, in global row order
        local = local.cpu().numpy()
        whole = (allgather_spans(local, self.n_all) if self._ooc is None
                 else allgather_varspans(local, self._ooc_spans))
        return torch.as_tensor(whole, device=self.device)

    def model_space_w(self) -> torch.Tensor:
        """Raw-feature-space coefficients for scoring/saving."""
        if self.cfg.normalization is not None:
            return self.cfg.normalization.to_model_space(self.w)
        return self.w


def _score_gather_barrier() -> None:
    fault_injection.check("cd.score_gather")
    health_barrier("cd.score_gather")


class _RandomState:
    def __init__(self, cfg: CoordinateConfig, data: GameDataset,
                 cache: Optional[dict] = None,
                 entity_shard: Optional[EntityShardSpec] = None,
                 table_budget_bytes: Optional[int] = None):
        sp = data.features[cfg.feature_shard]
        ids = data.entity_ids[cfg.entity_column]
        shard_key = (None if entity_shard is None
                     else (entity_shard.num_shards, entity_shard.shard_index))
        key = ("re_data", id(data), cfg.name, cfg.feature_shard,
               cfg.entity_column, cfg.num_buckets, cfg.active_cap,
               cfg.projection, cfg.projection_dim, cfg.projection_seed,
               shard_key)
        if cache is not None and key in cache:
            # entry[0] pins the keyed dataset alive so its id() cannot be
            # recycled while the cache lives
            _, self.train_data, self.train_view = cache[key]
        else:
            self.train_data: RandomEffectTrainData = build_random_effect_data(
                sp, data.labels, data.weights, ids,
                effect_name=cfg.name, num_buckets=cfg.num_buckets,
                active_cap=cfg.active_cap,
                projection=cfg.projection,
                projection_dim=cfg.projection_dim,
                projection_seed=cfg.projection_seed,
                entity_shard=entity_shard,
            )
            self.train_view = build_score_view(self.train_data, sp, ids)
            if cache is not None:
                cache[key] = (data, self.train_data, self.train_view)
        # fail before the first sweep when the local entity table is over
        # the per-process budget (the error points at --entity-shards)
        check_table_budget(
            self.train_data.table_bytes(), table_budget_bytes,
            coordinate=cfg.name,
            num_shards=1 if entity_shard is None else entity_shard.num_shards)
        self.coeffs: Optional[List[np.ndarray]] = None
        self.variances = None
        # active-set tracking: per-bucket masks of frozen entities (their
        # solver converged at their last solve); None until the first solve
        self.frozen: Optional[List[np.ndarray]] = None
        # residual offsets as of each row's entity's last solve: the drift
        # reference for re-activation (length-n host vector)
        self.offs_snap: Optional[np.ndarray] = None
        # entity-sharded: this shard's OWN score vectors (zeros on unowned
        # rows); the published delta each sweep is the rows where these
        # bitwise changed, while the loop's scores[name] stays the
        # assembled global vector on every process
        self.local_scores: Optional[torch.Tensor] = None
        self.local_val_scores: Optional[torch.Tensor] = None


class CoordinateDescent:
    """Run the GAME block-coordinate loop over a list of coordinates on one
    device per process (``device``, default ``cuda``, or the mesh's
    device). ``mesh``: a ``parallel.mesh.make_mesh`` mesh whose ``data``
    and ``entity`` axes shard the fixed and random coordinates (module
    docstring); every rank passes the same datasets and ends with the same
    model. ``entity_shard``, ``entity_table_budget_bytes`` and
    ``recovery``: entity sharding, its budget and in-job recovery (module
    docstring); an active ``entity_shard`` excludes a mesh ``entity``
    axis, which shards the same tables another way."""

    def __init__(
        self,
        configs: Sequence[CoordinateConfig],
        task: str = "logistic",
        n_iterations: int = 1,
        mesh=None,
        evaluators: Sequence[str] = (),
        dtype=torch.float32,
        verbose: bool = False,
        dataset_cache: Optional[dict] = None,
        cd_tolerance: float = 0.0,
        solver_tol_schedule=None,
        entity_shard=None,
        entity_table_budget_bytes: Optional[int] = None,
        recovery=None,
        device=None,
    ):
        names = [c.name for c in configs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate coordinate names: {names}")
        if not np.isfinite(cd_tolerance) or cd_tolerance < 0:
            raise ValueError(f"cd_tolerance must be finite and >= 0, got "
                             f"{cd_tolerance}")
        self.configs = list(configs)
        self.task = task
        self.n_iterations = n_iterations
        self.evaluator_names = list(evaluators)
        self.dtype = dtype
        self.verbose = verbose
        # sweep-level early exit: stop when every coordinate's score vector
        # moved by at most cd_tolerance (max-abs) over a sweep; 0 disables
        self.cd_tolerance = float(cd_tolerance)
        # optimize.ToleranceSchedule (or None): loose solver tolerance on
        # early sweeps, tightening to each coordinate's own tolerance
        self.solver_tol_schedule = solver_tol_schedule
        # shared across runs by GameEstimator so the per-entity bucketing
        # is built once per dataset, not once per grid point
        self.dataset_cache = dataset_cache
        self.mesh = mesh
        # the axes that actually shard: more than one rank along them
        self._data_mesh = (mesh if mesh is not None
                           and axis_size(mesh, "data") > 1 else None)
        self._entity_mesh = (mesh if mesh is not None
                             and axis_size(mesh, "entity") > 1 else None)
        self.device = (mesh_device(mesh) if mesh is not None
                       and device is None else resolve_device(device))
        self.entity_shard = entity_shard
        self.entity_table_budget_bytes = entity_table_budget_bytes
        self._sharded = entity_shard is not None and entity_shard.active
        if self._sharded and self._entity_mesh is not None:
            raise ValueError(
                "entity_shard and a mesh 'entity' axis both shard the "
                "random-effect tables; pass one of them")
        self._comm = ShardCommStats()
        # one manager serves every grid point of an estimator fit (run()
        # calls reset_for_run(); its budgets are job-cumulative)
        self.recovery = recovery

    # -- main loop -------------------------------------------------------
    def run(
        self,
        train: GameDataset,
        validation: Optional[GameDataset] = None,
        warm_start: Optional[GameModel] = None,
        locked: Sequence[str] = (),
        checkpoint_callback=None,
    ) -> Tuple[GameModel, List[dict]]:
        dtype, dev = self.dtype, self.device
        n = train.num_samples
        locked = set(locked)
        unknown_locked = locked - {c.name for c in self.configs}
        if unknown_locked:
            raise ValueError(f"locked coordinates not in configs: "
                             f"{unknown_locked}")
        if locked:
            covered = (set() if warm_start is None
                       else set(warm_start.coordinates))
            uncovered = locked - covered
            if uncovered:
                raise ValueError(
                    f"locked coordinates {sorted(uncovered)} need a "
                    "warm_start model providing their coefficients")

        states: Dict[str, object] = {}
        val_states: Dict[str, object] = {}
        val_feats: Dict[str, SparseFeatures] = {}
        for cfg in self.configs:
            if cfg.coordinate_type == "fixed":
                states[cfg.name] = _FixedState(cfg, train, dtype, self.task,
                                               dev, self._data_mesh)
                if validation is not None:
                    val_feats[cfg.name] = _device_features(
                        validation.features[cfg.feature_shard], dtype, dev)
        self._build_random_states(train, validation, states, val_states)

        scores = {c.name: torch.zeros(n, dtype=dtype, device=dev)
                  for c in self.configs}
        val_n = validation.num_samples if validation is not None else 0
        val_scores = {c.name: torch.zeros(val_n, dtype=dtype, device=dev)
                      for c in self.configs}
        if self._sharded:
            for cfg in self.configs:
                if cfg.coordinate_type == "random":
                    st = states[cfg.name]
                    st.local_scores = torch.zeros(n, dtype=dtype, device=dev)
                    st.local_val_scores = torch.zeros(val_n, dtype=dtype,
                                                      device=dev)
        if warm_start is not None:
            self._load_warm_start(warm_start, states, scores, val_scores,
                                  train, validation, val_states, val_feats)
            if self._sharded:
                # a sharded random coordinate's warm scores are LOCAL
                # (owned rows only): publish every shard's rows once so the
                # loop starts from the same global vector everywhere
                for cfg in self.configs:
                    if (cfg.coordinate_type != "random"
                            or warm_start.coordinates.get(cfg.name) is None):
                        continue
                    st = states[cfg.name]
                    has_val = validation is not None and cfg.name in val_states
                    zeros_v = torch.zeros(val_n, dtype=dtype, device=dev)
                    scores[cfg.name], val_scores[cfg.name], _, _ = (
                        self._exchange_scores(
                            f"warm:{cfg.name}", st, scores[cfg.name],
                            torch.zeros(n, dtype=dtype, device=dev),
                            val_scores[cfg.name] if has_val else None,
                            zeros_v if has_val else val_scores[cfg.name]))

        base = torch.as_tensor(train.offsets, device=dev).to(dtype)
        history: List[dict] = []
        evaluators = [get_evaluator(e) for e in self.evaluator_names]

        # per-iteration validation metrics run on the device where a device
        # form exists; the definitive host float64 numbers are recomputed
        # once for the final history record below
        device_evals: dict = {}
        if validation is not None and evaluators:
            for ev in evaluators:
                if ev.grouped:
                    device_evals[ev.name] = (
                        None if validation.group_ids is None
                        else make_grouped_device_evaluator(
                            ev.name, validation.group_ids, mesh=self.mesh,
                            device=dev))
                else:
                    device_evals[ev.name] = make_device_evaluator(
                        ev.name, mesh=self._data_mesh, device=dev)
            val_labels_dev = torch.as_tensor(validation.labels,
                                             device=dev).to(dtype)
            val_weights_dev = torch.as_tensor(validation.weights,
                                              device=dev).to(dtype)
            val_offsets_dev = torch.as_tensor(validation.offsets,
                                              device=dev).to(dtype)

        rt = _ResidualTotal(base)
        vt = (_ResidualTotal(val_offsets_dev)
              if validation is not None and evaluators else None)
        eps = float(torch.finfo(dtype).eps)
        stop_reason = "max_iterations"

        def one_sweep(it: int) -> bool:
            """One full CD sweep; True when the cd_tolerance early exit
            fired. A closure so that recovery can re-run a sweep from a
            restored snapshot."""
            nonlocal stop_reason
            rt.resync(scores)
            if vt is not None:
                vt.resync(val_scores)
            sweep_deltas: Dict[str, float] = {}
            for cfg in self.configs:
                st = states[cfg.name]
                t0 = time.time()
                offs = rt.excluding(cfg.name, scores)
                record = {"iteration": it, "coordinate": cfg.name}
                run_cfg = None
                if self.solver_tol_schedule is not None:
                    run_cfg = dataclasses.replace(
                        cfg.opt_config(),
                        tolerance=self.solver_tol_schedule.at(
                            it, cfg.tolerance))
                    record["solver_tolerance"] = run_cfg.tolerance
                score_delta = 0.0
                # a step boundary is a collective phase boundary with more
                # than one process: the guard turns any process's local
                # failure inside the step into PeerFailure on every process
                # instead of leaving the others in the next collective
                with obs_trace.span("cd.coordinate", cat="train",
                                    coordinate=cfg.name, iteration=it), \
                        CollectiveGuard(f"cd:{it}:{cfg.name}"):
                    fault_injection.check("cd.step")
                    if cfg.name not in locked:
                        if cfg.coordinate_type == "fixed":
                            score_delta = self._fixed_step(
                                cfg, st, offs, run_cfg, scores, val_scores,
                                val_feats, rt, vt, n, validation, record)
                        else:
                            score_delta = self._random_step(
                                cfg, st, it, offs, run_cfg, scores,
                                val_scores, val_states, rt, vt, n, val_n,
                                validation, eps, record)
                    record.setdefault("comm_seconds", 0.0)
                    record["solve_seconds"] = time.time() - t0
                    t_eval = time.time()
                    if vt is not None:
                        v_total_host = None
                        for ev in evaluators:
                            fn = device_evals.get(ev.name)
                            if fn is not None:
                                record[ev.name] = float(fn(
                                    vt.total, val_labels_dev,
                                    val_weights_dev))
                            else:  # grouped without ids / no device form
                                if v_total_host is None:
                                    v_total_host = vt.total.cpu().numpy()
                                record[ev.name] = ev.evaluate(
                                    v_total_host, validation.labels,
                                    validation.weights,
                                    validation.group_ids)
                    record["eval_seconds"] = time.time() - t_eval
                    record["seconds"] = time.time() - t0
                    record["score_delta"] = score_delta
                    sweep_deltas[cfg.name] = score_delta
                obs_metrics.training_metrics().record_step(
                    cfg.name, record["solve_seconds"],
                    record["eval_seconds"], record["comm_seconds"])
                _log.log(logging.INFO if self.verbose else logging.DEBUG,
                         "cd.step %s", record)
                history.append(record)
            if checkpoint_callback is not None:
                checkpoint_callback(it, self._build_model(states))
            if (self.cd_tolerance > 0 and sweep_deltas and
                    all(d <= self.cd_tolerance
                        for d in sweep_deltas.values())):
                # every coordinate's scores are stationary to within
                # cd_tolerance: the remaining sweeps would re-derive the
                # same model
                stop_reason = "cd_tolerance"
                _log.log(logging.INFO if self.verbose else logging.DEBUG,
                         "cd.early_exit after sweep %d: max score delta "
                         "%.3g <= cd_tolerance %.3g", it,
                         max(sweep_deltas.values()), self.cd_tolerance)
                return True
            return False

        recovery = self.recovery
        if recovery is not None:
            recovery.reset_for_run()
        it = 0
        while it < self.n_iterations:
            try:
                if recovery is not None:
                    # sweep-start commit: the rollback target for a failure
                    # inside this sweep (its barrier is all-or-nothing, so
                    # every survivor agrees on the committed sweep)
                    recovery.commit(it, lambda: self._recovery_payload(
                        states, scores, val_scores, validation))
                stop = one_sweep(it)
                it += 1
                if stop:
                    break
            except PeerFailure as exc:
                if recovery is None:
                    raise
                # re-raises when the failure is fatal, a budget is spent or
                # nothing was committed; a failure DURING recovery leaves
                # on_failure or _recovery_restore as a coordinated abort
                plan = recovery.on_failure(exc)
                it = self._recovery_restore(
                    plan, train, validation, states, val_states,
                    scores, val_scores, history, recovery)
        if history:
            history[-1]["stop_reason"] = stop_reason

        # definitive final metrics: the host float64 evaluators (model
        # selection reads history[-1])
        if history and validation is not None and evaluators:
            v_total = (val_offsets_dev
                       + sum(val_scores.values())).cpu().numpy()
            for ev in evaluators:
                history[-1][ev.name] = ev.evaluate(
                    v_total, validation.labels, validation.weights,
                    validation.group_ids)

        return self._build_model(states), history

    # -- helpers ---------------------------------------------------------
    def _build_random_states(self, train, validation, states, val_states):
        """(Re)build every random coordinate's ``_RandomState`` and its
        validation score view against the CURRENT ``self.entity_shard``:
        at run() entry, and again by recovery after a shrink (the cache
        keys carry the shard spec, so a new owner map rebuilds)."""
        for cfg in self.configs:
            if cfg.coordinate_type != "random":
                continue
            states[cfg.name] = _RandomState(
                cfg, train, cache=self.dataset_cache,
                entity_shard=self.entity_shard,
                table_budget_bytes=self.entity_table_budget_bytes)
            if validation is not None:
                st: _RandomState = states[cfg.name]
                key = ("val_view", id(validation), id(st.train_data))
                cache = self.dataset_cache
                if cache is not None and key in cache:
                    val_states[cfg.name] = cache[key][2]
                else:
                    sp = validation.features[cfg.feature_shard]
                    ids = validation.entity_ids[cfg.entity_column]
                    val_states[cfg.name] = build_score_view(st.train_data,
                                                            sp, ids)
                    if cache is not None:
                        cache[key] = (validation, st.train_data,
                                      val_states[cfg.name])

    def _fixed_step(self, cfg, st, offs, run_cfg, scores, val_scores,
                    val_feats, rt, vt, n, validation, record) -> float:
        """One fixed-effect coordinate step: fit, rescore, update the
        residual totals. Returns the coordinate's score delta."""
        res = st.fit(offs, opt_config=run_cfg)
        record.update(loss=float(res.value), converged=bool(res.converged),
                      optimizer_iterations=int(res.iterations))
        if res.stream_stats is not None:
            # a streamed fixed effect's pass accounting
            record["stream"] = res.stream_stats
        w_model = st.model_space_w()
        new_scores = st.train_scores(w_model)
        delta = float(torch.max(torch.abs(
            new_scores - scores[cfg.name]))) if n else 0.0
        rt.replace(scores[cfg.name], new_scores)
        scores[cfg.name] = new_scores
        if validation is not None:
            new_v = _margins(val_feats[cfg.name], w_model)
            if vt is not None:
                vt.replace(val_scores[cfg.name], new_v)
            val_scores[cfg.name] = new_v
        return delta

    def _random_step(self, cfg, st, it, offs, run_cfg, scores, val_scores,
                     val_states, rt, vt, n, val_n, validation, eps,
                     record) -> float:
        """One random-effect coordinate step with active-set freezing and
        incremental rescoring. Returns the coordinate's score delta.

        Entity-sharded: the solve and rescore run over this shard's owned
        entities only, then the step publishes the rows whose local score
        bitwise changed and scatters every shard's rows into the global
        vector (:meth:`_exchange_scores`). The exchange runs EVERY sweep,
        with an empty payload too, so the collective sequence is the same
        on every process whatever each shard's active set."""
        dev = self.device
        sharded = self._sharded
        refresh = (st.coeffs is None or st.frozen is None
                   or st.offs_snap is None or not cfg.active_set
                   or it % cfg.refresh_every == 0)
        active = None
        offs_np = None
        solve = True
        if not refresh:
            offs_np = offs.cpu().numpy()
            tol = cfg.active_tol if cfg.active_tol is not None else 0.0
            # floor at a few ulps of the working dtype: a tolerance below
            # the arithmetic noise would never skip anything
            tol = max(float(tol), 8.0 * eps)
            active = _drift_active_masks(st.train_data.buckets, st.frozen,
                                         offs_np, st.offs_snap, tol)
            if sum(int(a.sum()) for a in active) == 0:
                # every (local) entity frozen with stationary offsets:
                # solve and rescore are skipped outright
                record.update(converged_fraction=1.0,
                              mean_optimizer_iterations=0.0,
                              entities_solved=0, refresh=False)
                if not sharded:
                    return 0.0
                solve = False  # still takes part in the exchange below
        prev_local = st.local_scores if sharded else scores[cfg.name]
        prev_val_local = (st.local_val_scores if sharded
                          else val_scores.get(cfg.name))
        new_local, new_val_local = prev_local, None
        if solve:
            reg = cfg.reg_context()
            fit = train_random_effect(
                st.train_data, offs, task=self.task,
                l2=reg.l2_weight(cfg.reg_weight),
                l1=reg.l1_weight(cfg.reg_weight),
                optimizer=cfg.optimizer,
                config=run_cfg if run_cfg is not None else cfg.opt_config(),
                w0=st.coeffs, compute_variance=cfg.compute_variance,
                dtype=self.dtype, normalization=cfg.normalization,
                active=active, prev_variances=st.variances, device=dev,
                mesh=self._entity_mesh)
            if cfg.active_set:
                st.frozen = [np.asarray(c) for c in fit.converged]
                if offs_np is None:
                    offs_np = offs.cpu().numpy()
                if active is None or st.offs_snap is None:
                    st.offs_snap = np.array(offs_np, copy=True)
                else:
                    # re-solved entities get a fresh drift reference;
                    # frozen ones keep the offsets they last solved against
                    for b, bucket in enumerate(st.train_data.buckets):
                        if bucket.num_entities == 0 or not active[b].any():
                            continue
                        rows = bucket.sample_idx[active[b]]
                        rows = rows[rows >= 0]
                        st.offs_snap[rows] = offs_np[rows]
            st.coeffs = fit.coefficients
            st.variances = fit.variances
            record.update(
                converged_fraction=fit.converged_fraction,
                mean_optimizer_iterations=fit.mean_iterations,
                entities_solved=fit.entities_solved,
                refresh=bool(refresh))
            # incremental rescoring after a partial solve: only rows of
            # re-solved entities are recomputed and overwritten (in the
            # LOCAL vector when sharded: unowned rows stay zero there)
            new_local = score_random_effect(
                st.train_view, st.coeffs, n, self.dtype,
                prev=None if active is None else prev_local,
                changed=active, device=dev, mesh=self._entity_mesh)
            if validation is not None and cfg.name in val_states:
                new_val_local = score_random_effect(
                    val_states[cfg.name], st.coeffs, val_n, self.dtype,
                    prev=None if active is None else prev_val_local,
                    changed=active, device=dev, mesh=self._entity_mesh)

        if not sharded:
            delta = (float(torch.max(torch.abs(new_local - scores[cfg.name])))
                     if n else 0.0)
            rt.replace(scores[cfg.name], new_local)
            scores[cfg.name] = new_local
            if new_val_local is not None:
                if vt is not None:
                    vt.replace(val_scores[cfg.name], new_val_local)
                val_scores[cfg.name] = new_val_local
            return delta

        # -- entity-sharded: the delta-only exchange ------------------------
        has_val = validation is not None and cfg.name in val_states
        if has_val and new_val_local is None:
            new_val_local = st.local_val_scores  # skipped solve: unchanged
        new_global, new_val_global, comm_bytes, comm_s = (
            self._exchange_scores(
                f"cd:{it}:{cfg.name}", st, new_local, scores[cfg.name],
                new_val_local if has_val else None, val_scores[cfg.name]))
        record["comm_seconds"] = comm_s
        record["comm_bytes"] = comm_bytes
        delta = (float(torch.max(torch.abs(new_global - scores[cfg.name])))
                 if n else 0.0)
        rt.replace(scores[cfg.name], new_global)
        scores[cfg.name] = new_global
        if has_val:
            if vt is not None:
                vt.replace(val_scores[cfg.name], new_val_global)
            val_scores[cfg.name] = new_val_global
        return delta

    def _exchange_scores(self, tag, st, new_local, prev_global,
                         new_val_local, prev_val_global):
        """Publish this shard's bitwise-changed rows (train and
        validation) and scatter the union of every shard's rows into the
        global vectors. Each row's entity has one owner, so the row sets
        are disjoint and the scatter lands on the vector the single-host
        loop computes; unchanged rows are not shipped, which keeps the
        bytes per sweep proportional to the moving frontier, not the
        table. Returns ``(global, val_global, bytes, seconds)``."""
        dev = self.device
        new_np = new_local.cpu().numpy()
        rows, vals = _changed_rows(new_np, st.local_scores.cpu().numpy())
        if new_val_local is not None:
            vrows, vvals = _changed_rows(new_val_local.cpu().numpy(),
                                         st.local_val_scores.cpu().numpy())
        else:
            vrows = np.zeros(0, np.int32)
            vvals = np.zeros(0, new_np.dtype)
        b0, t0 = self._comm.bytes_gathered, self._comm.seconds
        gathered = exchange_score_updates([rows, vals, vrows, vvals],
                                          tag=tag, stats=self._comm)
        comm_bytes = self._comm.bytes_gathered - b0
        comm_s = self._comm.seconds - t0
        new_global = torch.as_tensor(_scatter_rows(
            prev_global.cpu().numpy(), [g[0] for g in gathered],
            [g[1] for g in gathered]), device=dev)
        new_val_global = prev_val_global
        if new_val_local is not None:
            new_val_global = torch.as_tensor(_scatter_rows(
                prev_val_global.cpu().numpy(), [g[2] for g in gathered],
                [g[3] for g in gathered]), device=dev)
            st.local_val_scores = new_val_local
        st.local_scores = new_local
        return new_global, new_val_global, comm_bytes, comm_s

    def _build_model(self, states) -> GameModel:
        coords = {}
        for cfg in self.configs:
            st = states[cfg.name]
            if cfg.coordinate_type == "fixed":
                coef = Coefficients(st.model_space_w(), st.variances)
                coords[cfg.name] = FixedEffectModel(
                    GeneralizedLinearModel(coef, self.task),
                    cfg.feature_shard)
            else:
                buckets = []
                for b, bucket in enumerate(st.train_data.buckets):
                    lm0 = bucket.local_maps[0] if bucket.local_maps else None
                    buckets.append(RandomEffectBucket(
                        entity_ids=bucket.entity_ids,
                        coefficients=st.coeffs[b],
                        projection=bucket.projection,
                        variances=(None if st.variances is None
                                   else st.variances[b]),
                        sketch=(lm0 if isinstance(lm0, SketchProjection)
                                else None)))
                if self._sharded:
                    # the one place the full entity table crosses the wire:
                    # save points (checkpoints and the final model), never
                    # per sweep. A collective: every process reaches
                    # _build_model at the same points (the sharded drivers
                    # give other ranks a no-op checkpoint callback)
                    gathered = allgather_objects(
                        buckets, tag=f"model:{cfg.name}", stats=self._comm)
                    buckets = [b for shard in gathered for b in shard]
                coords[cfg.name] = RandomEffectModel(
                    cfg.name, buckets, self.task, cfg.feature_shard,
                    entity_column=cfg.entity_column)
        return GameModel(coords, self.task)

    # -- in-job recovery -------------------------------------------------
    def _recovery_payload(self, states, scores, val_scores, validation):
        """This rank's sweep-start snapshot: everything a survivor set
        needs to resume the sweep bit for bit. The replicated state (fixed
        coefficients, global score vectors) plus this shard's
        random-effect tables; sharded runs also record the bucket-level
        entity table (ids, projections, coefficients) so that a SHRUNK
        survivor set can redistribute a dead rank's entities through the
        warm-start remap. All host numpy copies."""
        fixed, random = {}, {}
        for cfg in self.configs:
            st = states[cfg.name]
            if cfg.coordinate_type == "fixed":
                fixed[cfg.name] = {"w": _host_or_none(st.w),
                                   "variances": _host_or_none(st.variances)}
                continue
            buckets = None
            if self._sharded and st.coeffs is not None:
                buckets = []
                for b, bucket in enumerate(st.train_data.buckets):
                    lm0 = bucket.local_maps[0] if bucket.local_maps else None
                    buckets.append({
                        "entity_ids": np.asarray(bucket.entity_ids),
                        "projection": _host_or_none(bucket.projection),
                        "coefficients": np.array(st.coeffs[b], copy=True),
                        "frozen": (None if st.frozen is None
                                   else np.array(st.frozen[b], copy=True)),
                        "sketch": (lm0 if isinstance(lm0, SketchProjection)
                                   else None),
                    })
            random[cfg.name] = {
                "coeffs": (None if st.coeffs is None
                           else [np.array(c, copy=True) for c in st.coeffs]),
                "frozen": (None if st.frozen is None
                           else [np.array(f, copy=True) for f in st.frozen]),
                "offs_snap": (None if st.offs_snap is None
                              else np.array(st.offs_snap, copy=True)),
                "local_scores": _host_or_none(st.local_scores),
                "local_val_scores": _host_or_none(st.local_val_scores),
                "buckets": buckets,
            }
        return {
            "fixed": fixed,
            "random": random,
            "scores": {k: _host(v) for k, v in scores.items()},
            "val_scores": (None if validation is None else
                           {k: _host(v) for k, v in val_scores.items()}),
        }

    def _recovery_restore(self, plan, train, validation, states, val_states,
                          scores, val_scores, history, recovery) -> int:
        """Roll the run back to the plan's agreed committed sweep. A pure
        rollback (same membership) restores every table from this rank's
        own snapshot in place. A shrink also recomputes the entity owner
        map over the survivors, rebuilds the random states against it and
        redistributes the dead rank's entities from the old members'
        committed bucket tables through the warm-start remap; local score
        vectors are re-derived by scoring the redistributed coefficients.
        Random-effect variances are not snapshotted (they are
        O(entities * dim^2)): a recovered run recomputes them at its next
        solve. Returns the sweep to resume from."""
        dtype, dev = self.dtype, self.device
        n = train.num_samples
        val_n = validation.num_samples if validation is not None else 0

        def tensor(a):
            return torch.as_tensor(np.asarray(a), device=dev)

        def zeros(k):
            return torch.zeros(k, dtype=dtype, device=dev)

        own = plan.snapshots[plan.own_rank]
        remap = plan.remapped and self._sharded
        old_spec = self.entity_shard
        if remap:
            self.entity_shard = EntityShardSpec(plan.new_num_shards,
                                                plan.new_shard_index)
            self._sharded = self.entity_shard.active
            self._build_random_states(train, validation, states, val_states)
        for cfg in self.configs:
            if cfg.coordinate_type != "fixed":
                continue
            snap = own["fixed"][cfg.name]
            st = states[cfg.name]
            st.w = None if snap["w"] is None else tensor(snap["w"])
            st.variances = (None if snap["variances"] is None
                            else tensor(snap["variances"]))
        for name, arr in own["scores"].items():
            scores[name] = tensor(arr)
        if validation is not None and own.get("val_scores") is not None:
            for name, arr in own["val_scores"].items():
                val_scores[name] = tensor(arr)
        for cfg in self.configs:
            if cfg.coordinate_type != "random":
                continue
            st = states[cfg.name]
            snap = own["random"][cfg.name]
            st.variances = None
            if not remap:
                st.coeffs = (None if snap["coeffs"] is None
                             else [np.array(c, copy=True)
                                   for c in snap["coeffs"]])
                st.frozen = (None if snap["frozen"] is None
                             else [np.array(f, copy=True)
                                   for f in snap["frozen"]])
                st.offs_snap = (None if snap["offs_snap"] is None
                                else np.array(snap["offs_snap"], copy=True))
                if self._sharded:
                    st.local_scores = (
                        zeros(n) if snap["local_scores"] is None
                        else tensor(snap["local_scores"]))
                    st.local_val_scores = (
                        zeros(val_n) if snap["local_val_scores"] is None
                        else tensor(snap["local_val_scores"]))
                continue
            merged = []
            for r in plan.old_members:
                b = plan.snapshots[r]["random"][cfg.name]["buckets"]
                if b:
                    merged.extend(b)
            if not merged:
                # the failure came before this coordinate's first solve
                st.coeffs = st.frozen = st.offs_snap = None
                st.local_scores, st.local_val_scores = zeros(n), zeros(val_n)
                continue
            prev = RandomEffectModel(
                cfg.name,
                [RandomEffectBucket(
                    entity_ids=b["entity_ids"],
                    coefficients=b["coefficients"],
                    projection=b["projection"], variances=None,
                    sketch=b["sketch"]) for b in merged],
                self.task, cfg.feature_shard,
                entity_column=cfg.entity_column)
            st.coeffs = _coeffs_from_prev(prev, st.train_data)
            # active-set freeze flags travel per ENTITY (layout-free)
            fmap = {}
            for b in merged:
                if b["frozen"] is None:
                    continue
                for eid, fz in zip(b["entity_ids"], b["frozen"]):
                    fmap[str(eid)] = bool(fz)
            st.frozen = (None if not fmap else [
                np.asarray([fmap.get(str(e), False)
                            for e in bucket.entity_ids], bool)
                for bucket in st.train_data.buckets])
            # each row's residual reference belongs to the entity's OLD
            # owner: that shard solved it last, so its snapshot holds the
            # row's value as of that solve
            snaps_offs = [plan.snapshots[r]["random"][cfg.name]["offs_snap"]
                          for r in plan.old_members]
            if any(o is None for o in snaps_offs):
                st.offs_snap = None
            else:
                old_owner = old_spec.owner_of(
                    train.entity_ids[cfg.entity_column])
                merged_offs = np.array(np.asarray(snaps_offs[0]), copy=True)
                for si in range(1, len(plan.old_members)):
                    rows = old_owner == si
                    merged_offs[rows] = np.asarray(snaps_offs[si])[rows]
                st.offs_snap = merged_offs
            if self._sharded:
                st.local_scores = score_random_effect(
                    st.train_view, st.coeffs, n, dtype, device=dev)
                st.local_val_scores = (
                    score_random_effect(val_states[cfg.name], st.coeffs,
                                        val_n, dtype, device=dev)
                    if validation is not None and cfg.name in val_states
                    else zeros(val_n))
        history[:] = [r for r in history
                      if r.get("iteration", -1) < plan.sweep]
        # re-commit the restored state at the agreed sweep under the NEW
        # membership: the survivors re-enter the loop from an aligned,
        # rollback-able point (this also closes the recovery timer)
        recovery.commit(plan.sweep, lambda: self._recovery_payload(
            states, scores, val_scores, validation), force=True)
        _log.warning(
            "recovery: restored to committed sweep %d on %d shard(s) after "
            "%s; resuming", plan.sweep, len(plan.members),
            plan.failure_class)
        return plan.sweep

    def _load_warm_start(self, model, states, scores, val_scores,
                         train, validation, val_states, val_feats):
        """Initialize coordinate states and scores from a previous
        GameModel. Saved coefficients are model space; internal state is
        optimizer space, converted through the normalization context."""
        dev = self.device
        for cfg in self.configs:
            prev = model.coordinates.get(cfg.name)
            if prev is None:
                continue
            st = states[cfg.name]
            if cfg.coordinate_type == "fixed":
                w_model = torch.as_tensor(
                    prev.model.coefficients.means, device=dev).to(self.dtype)
                st.w = (cfg.normalization.to_training_space(w_model)
                        if cfg.normalization is not None else w_model)
                scores[cfg.name] = st.train_scores(w_model)
                if validation is not None:
                    val_scores[cfg.name] = _margins(val_feats[cfg.name],
                                                    w_model)
            else:
                coeffs = _coeffs_from_prev(prev, st.train_data)
                st.coeffs = coeffs
                scores[cfg.name] = score_random_effect(
                    st.train_view, coeffs, train.num_samples, self.dtype,
                    device=dev)
                if validation is not None and cfg.name in val_states:
                    val_scores[cfg.name] = score_random_effect(
                        val_states[cfg.name], coeffs,
                        validation.num_samples, self.dtype, device=dev)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _host_or_none(a) -> Optional[np.ndarray]:
    """A host copy of ``a`` (None stays None)."""
    return None if a is None else np.array(_host(a), copy=True)


def _coeffs_from_prev(prev, train_data) -> List[np.ndarray]:
    """Fill a training-layout coefficient table from a previous model's
    entity table: one dict probe per entity, the slot remapping in numpy
    group operations."""
    prev_index = prev.entity_index()
    coeffs = []
    for bucket in train_data.buckets:
        W = np.zeros((bucket.num_entities, bucket.local_dim))
        rows, pbs, prs = [], [], []
        for r, eid in enumerate(bucket.entity_ids):
            slot = prev_index.get(eid)
            if slot is None:  # loaded models key entities as str
                slot = prev_index.get(str(eid))
            if slot is not None:
                rows.append(r)
                pbs.append(slot[0])
                prs.append(slot[1])
        if rows:
            rows_a = np.asarray(rows)
            pbs_a = np.asarray(pbs)
            prs_a = np.asarray(prs)
            for pb in np.unique(pbs_a):
                sel = pbs_a == pb
                _warm_fill_bucket(W, bucket, rows_a[sel],
                                  prev.buckets[int(pb)], prs_a[sel])
        coeffs.append(W)
    return coeffs


def _warm_fill_bucket(W, bucket, rows, prev_bucket, prs) -> None:
    """Warm-start slot remap for one (current bucket, previous bucket)
    entity group: ``W[rows]`` receives the previous coefficients of rows
    ``prs`` of ``prev_bucket``, re-addressed from the previous per-entity
    subspaces to the current ones by a composite-key join (entity-local
    row id * 2^32 + global feature id). Identical sketches copy rows
    wholesale; a previous exact subspace warm-starts a sketched coordinate
    through the sketch; a previous sketch cannot be inverted, so those
    entities start cold."""
    cur_lm0 = bucket.local_maps[0] if bucket.num_entities else None
    cur_sketched = isinstance(cur_lm0, SketchProjection)
    C = _host(prev_bucket.coefficients)[prs]             # [M, Dp]
    if prev_bucket.sketch is not None:
        if cur_sketched and cur_lm0 == prev_bucket.sketch:
            W[rows, : C.shape[1]] = C
        return
    P = _host(prev_bucket.projection)[prs]              # [M, Dp] gids, -1 pad
    valid_p = (P >= 0) & (C != 0)
    if cur_sketched:
        slots, signs = cur_lm0.slots_signs(np.maximum(P, 0).ravel())
        flat = valid_p.ravel()
        np.add.at(
            W,
            (np.repeat(rows, P.shape[1])[flat], slots[flat]),
            (C.ravel() * signs)[flat],
        )
        return
    curP = np.asarray(bucket.projection)[rows]           # [M, Dc] gids, -1 pad
    M, Dp = P.shape
    Dc = curP.shape[1]
    BIG = np.int64(1) << 32
    m_ids = np.arange(M, dtype=np.int64)
    kp = (m_ids[:, None] * BIG + P).ravel()[valid_p.ravel()]
    cvals = C.ravel()[valid_p.ravel()]
    if not len(kp):
        return
    order = np.argsort(kp)
    kp, cvals = kp[order], cvals[order]
    valid_c = (curP >= 0).ravel()
    kc = (m_ids[:, None] * BIG + curP).ravel()[valid_c]
    pos = np.minimum(np.searchsorted(kp, kc), len(kp) - 1)
    hit = kp[pos] == kc
    rows_flat = np.repeat(rows, Dc)[valid_c]
    slots_flat = np.tile(np.arange(Dc), M)[valid_c]
    W[rows_flat[hit], slots_flat[hit]] = cvals[pos[hit]]
