"""GameEstimator / GameTransformer and the pathwise GLM estimator
(counterpart of ``photon_ml_tpu/estimators.py``).

``GameEstimator.fit`` trains one GAME model per optimization configuration
in a grid (coordinate datasets built once and shared across configs),
evaluates each on validation, and returns every (model, results, configs)
triple; ``select_best`` picks by the primary evaluator.
``GameTransformer.transform`` scores a dataset with a model.
``GlmPathEstimator`` walks a lambda grid through one shared
``optimize.path.PathSolver``. Each takes ``device`` (default ``cuda``);
the two estimators also take the JAX package's ``mesh``
(``parallel.mesh.make_mesh``), whose device then is the default.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.evaluation import EvaluationResults, get_evaluator
from photon_ml_tpu_torch.game.descent import (
    CoordinateConfig, CoordinateDescent, GameDataset,
)
from photon_ml_tpu_torch.game.scoring import score_game_model
from photon_ml_tpu_torch.models import GameModel
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig, PathConfig
from photon_ml_tpu_torch.optimize.path import PathSolver
from photon_ml_tpu_torch.types import resolve_device


def _device(device, mesh) -> torch.device:
    """``device``, else the mesh's device for this rank, else ``cuda``."""
    if device is None and mesh is not None:
        from photon_ml_tpu_torch.parallel.mesh import mesh_device

        return mesh_device(mesh)
    return resolve_device(device)


@dataclasses.dataclass(frozen=True)
class GameFitResult:
    model: GameModel
    evaluation: Optional[EvaluationResults]
    configs: Tuple[CoordinateConfig, ...]
    history: List[dict]


@dataclasses.dataclass(frozen=True)
class GlmPathFitResult:
    """One lambda of a pathwise fixed-effect fit: the full-width result
    (``solver_tolerance``/``screened_dim`` set), the screening record, and
    validation metrics (empty without evaluators)."""

    reg_weight: float
    result: object          # optimize.common.OptimizationResult
    stats: object           # optimize.path.PathLambdaStats
    metrics: dict


def _select_by(results, ev_of, value_of):
    """The result whose primary metric is best (the first on ties)."""
    if not results:
        raise ValueError("no fit results to select from")
    ev = ev_of(results[0])
    if ev is None:
        return results[0]
    best = results[0]
    for r in results[1:]:
        v = value_of(r)
        if v is not None and ev.better(v, value_of(best)):
            best = r
    return best


class GlmPathEstimator:
    """Pathwise fixed-effect GLM over a lambda grid: screening and KKT
    certification per lambda through one shared ``PathSolver``, so the
    whole grid (and any later ``fit`` on the same estimator) reuses warm
    states. ``fit`` takes an in-memory ``LabeledBatch`` on ``device``, or
    host ``chunks`` (with ``dim``) streamed through ``device`` in
    ``dtype``; the grid is solved in the order given (decreasing lambda
    screens best). With ``mesh``, every rank passes the same whole batch
    (or its own rows as ``chunks``) and the solver shards it by rows."""

    def __init__(
        self,
        task: str = "logistic",
        reg_type: str = "elastic_net",
        elastic_net_alpha: float = 0.5,
        optimizer: str = "auto",
        evaluators: Sequence[str] = (),
        intercept_index: int = -1,
        device=None,
        config: Optional[OptimizerConfig] = None,
        path_config: Optional[PathConfig] = None,
        dtype=torch.float32,
        mesh=None,
    ):
        self.task = task
        self.dtype = dtype
        self.reg = RegularizationContext(reg_type, alpha=elastic_net_alpha)
        self.optimizer = optimizer
        self.evaluator_names = list(evaluators)
        self.intercept_index = intercept_index
        self.mesh = mesh
        self.device = _device(device, mesh)
        self.config = config if config is not None else OptimizerConfig()
        self.path_config = (path_config if path_config is not None
                            else PathConfig())
        self._solver = None

    def solver(self, batch=None, chunks=None, dim=None) -> PathSolver:
        """The shared PathSolver, built on first use and pinned to the
        first dataset seen."""
        if self._solver is None:
            if (batch is not None and self.mesh is None
                    and batch.device != self.device):
                raise ValueError(f"the batch lies on {batch.device}, the "
                                 f"estimator's device is {self.device}")
            objective = make_objective(
                self.task, intercept_index=self.intercept_index)
            self._solver = PathSolver(
                objective, self.reg, batch=batch, chunks=chunks, dim=dim,
                optimizer=self.optimizer, config=self.config,
                path_config=self.path_config, dtype=self.dtype,
                device=self.device, mesh=self.mesh)
        return self._solver

    def fit(
        self,
        reg_weights: Sequence[float],
        batch=None,
        chunks=None,
        dim=None,
        validation_batch=None,
        tol_schedule=None,
    ) -> List[GlmPathFitResult]:
        solver = self.solver(batch=batch, chunks=chunks, dim=dim)
        out: List[GlmPathFitResult] = []
        for li, lam in enumerate(reg_weights):
            tol = None
            if tol_schedule is not None:
                tol = tol_schedule.at(li, self.config.tolerance)
            res, stats = solver.solve(lam, tolerance=tol)
            metrics = {}
            if validation_batch is not None and self.evaluator_names:
                scores = solver._objective.margins(
                    res.w, validation_batch).cpu().numpy()
                for name in self.evaluator_names:
                    metrics[name] = get_evaluator(name).evaluate(
                        scores, validation_batch.labels.cpu().numpy(),
                        validation_batch.weights.cpu().numpy())
            out.append(GlmPathFitResult(float(lam), res, stats, metrics))
        return out

    def select_best(
        self, results: Sequence[GlmPathFitResult]
    ) -> GlmPathFitResult:
        primary = self.evaluator_names[0] if self.evaluator_names else None
        return _select_by(
            results,
            lambda r: (get_evaluator(primary)
                       if primary and r.metrics else None),
            lambda r: r.metrics.get(primary) if r.metrics else None)


class GameEstimator:
    """Train GAME models over a grid of per-coordinate configurations."""

    def __init__(
        self,
        task: str = "logistic",
        n_iterations: int = 1,
        evaluators: Sequence[str] = (),
        device=None,
        dtype=torch.float32,
        verbose: bool = False,
        cd_tolerance: float = 0.0,
        solver_tol_schedule=None,
        mesh=None,
        entity_shard=None,
        entity_table_budget_bytes=None,
        recovery=None,
    ):
        self.task = task
        self.n_iterations = n_iterations
        self.evaluator_names = list(evaluators)
        self.mesh = mesh
        self.device = _device(device, mesh)
        # entity-sharded training, its per-process table budget and in-job
        # recovery, passed straight to CoordinateDescent (one
        # RecoveryManager serves the whole grid: its budgets are per job)
        self.entity_shard = entity_shard
        self.entity_table_budget_bytes = entity_table_budget_bytes
        self.recovery = recovery
        self.dtype = dtype
        self.verbose = verbose
        # sweep-level early exit and inexact inner-solve schedule, passed
        # straight to CoordinateDescent
        self.cd_tolerance = cd_tolerance
        self.solver_tol_schedule = solver_tol_schedule

    def fit(
        self,
        train: GameDataset,
        validation: Optional[GameDataset] = None,
        config_grid: Sequence[Sequence[CoordinateConfig]] = (),
        warm_start: Optional[GameModel] = None,
        locked: Sequence[str] = (),
        checkpoint_callback=None,
        fit_callback=None,
        dataset_cache: Optional[dict] = None,
    ) -> List[GameFitResult]:
        """Train one GAME model per grid point.
        ``checkpoint_callback(config_index, iteration, model)`` fires after
        each outer CD iteration, ``fit_callback(config_index, result)``
        after each grid point. One dataset cache is shared across the grid
        (pass one to share it across ``fit`` calls too)."""
        if not config_grid:
            raise ValueError("config_grid must contain at least one "
                             "configuration")
        results: List[GameFitResult] = []
        if dataset_cache is None:
            dataset_cache = {}
        for gi, configs in enumerate(config_grid):
            cd = CoordinateDescent(
                configs, task=self.task, n_iterations=self.n_iterations,
                evaluators=self.evaluator_names, dtype=self.dtype,
                verbose=self.verbose, dataset_cache=dataset_cache,
                cd_tolerance=self.cd_tolerance,
                solver_tol_schedule=self.solver_tol_schedule,
                device=self.device, mesh=self.mesh,
                entity_shard=self.entity_shard,
                entity_table_budget_bytes=self.entity_table_budget_bytes,
                recovery=self.recovery)
            ckpt = None
            if checkpoint_callback is not None:
                def ckpt(it, model, gi=gi):
                    checkpoint_callback(gi, it, model)
            model, history = cd.run(train, validation, warm_start=warm_start,
                                    locked=locked, checkpoint_callback=ckpt)
            evaluation = None
            if validation is not None and self.evaluator_names:
                metrics = {name: history[-1][name]
                           for name in self.evaluator_names
                           if name in history[-1]}
                evaluation = EvaluationResults(metrics,
                                               self.evaluator_names[0])
            result = GameFitResult(model, evaluation, tuple(configs), history)
            results.append(result)
            if fit_callback is not None:
                fit_callback(gi, result)
        return results

    def select_best(self, results: Sequence[GameFitResult]) -> GameFitResult:
        """The fit with the best primary validation metric."""
        return _select_by(
            results,
            lambda r: (None if r.evaluation is None
                       else get_evaluator(r.evaluation.primary)),
            lambda r: (None if r.evaluation is None
                       else r.evaluation.primary_value))


class GameTransformer:
    """Score datasets with a trained GAME model on ``device``."""

    def __init__(self, model: GameModel, dtype=torch.float32, device=None):
        self.model = model
        self.dtype = dtype
        self.device = resolve_device(device)

    def transform(self, dataset: GameDataset, per_coordinate: bool = False):
        """Total scores (margins with offsets) for every row."""
        return score_game_model(
            self.model, dataset.features, dataset.entity_ids,
            offsets=dataset.offsets, dtype=self.dtype,
            per_coordinate=per_coordinate, device=self.device)

    def predict_mean(self, dataset: GameDataset) -> np.ndarray:
        """Inverse link applied to the total scores."""
        return self.model.loss.mean(self.transform(dataset)).cpu().numpy()

    def evaluate(self, dataset: GameDataset, evaluators: Sequence[str]):
        scores = self.transform(dataset).cpu().numpy()
        return {name: get_evaluator(name).evaluate(
                    scores, dataset.labels, dataset.weights,
                    dataset.group_ids)
                for name in evaluators}
