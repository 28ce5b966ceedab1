"""Auto-tune GAME regularization weights after the explicit grid
(counterpart of ``photon_ml_tpu/tuning/game_tuner.py`` on the port's
estimators: each estimator carries its ``device`` where the JAX package's
carries a ``mesh``; ``tune_glm_path(chunks=)`` tunes over a streamed
dataset through the same shared path solver).

Equivalent of the reference's GAME Bayesian-tuning path (SURVEY.md §4.5:
GameTrainingDriver seeds a GaussianProcessSearch with the evaluated grid
points, then runs fit→evaluate rounds; best model across grid + tuned
points wins). The tunable surface is each coordinate's ``reg_weight`` on a
log scale — the same surface the reference tunes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from photon_ml_tpu_torch.estimators import GameEstimator, GameFitResult
from photon_ml_tpu_torch.evaluation import get_evaluator
from photon_ml_tpu_torch.game.descent import CoordinateConfig, GameDataset
from photon_ml_tpu_torch.tuning.search import (
    GaussianProcessSearch,
    ParamRange,
    RandomSearch,
)


def resolve_tuned_coordinates(
    base_configs: Sequence[CoordinateConfig],
    tuned_coordinates: Optional[Sequence[str]],
    locked: Sequence[str] = (),
) -> List[str]:
    """Which coordinates' reg weights move during tuning: the explicit list,
    else every unlocked coordinate. Shared by the driver's fail-fast check
    and ``tune_game`` so the two can't disagree."""
    tuned = list(tuned_coordinates
                 if tuned_coordinates is not None
                 else [c.name for c in base_configs
                       if c.name not in set(locked)])
    unknown = set(tuned) - {c.name for c in base_configs}
    if unknown:
        raise ValueError(f"tuned coordinates not in configs: {sorted(unknown)}")
    if not tuned:
        raise ValueError("no coordinates to tune")
    return tuned


def tune_glm_path(
    estimator,
    n_iterations: int,
    batch=None,
    chunks=None,
    dim=None,
    validation_batch=None,
    mode: str = "bayesian",
    reg_range: Tuple[float, float] = (1e-4, 1e4),
    prior_results: Sequence = (),
    seed: int = 0,
    round_size: int = 1,
    fit_callback=None,
):
    """Tune the fixed-effect regularization weight over a SHARED pathwise
    solver (``estimators.GlmPathEstimator`` / ``optimize.path``): every
    trial's solve screens and warm-starts from the nearest already-solved
    lambda, so the union of all trials is one incrementally-extended
    regularization path — trials sharing a lambda prefix pay only their
    new tail, not a cold full-feature fit each. ``round_size > 1``
    proposes that many lambdas per round and walks them in decreasing
    order (``search.find(batch=, eval_order=)``), the screening-friendly
    direction. ``prior_results`` (e.g. the driver grid's
    ``GlmPathFitResult`` list) seed the surrogate. Returns one
    ``GlmPathFitResult`` per trial; ``estimator.select_best`` over
    grid + tuned picks the winner. Total solver work is visible as
    ``estimator.solver().total_iterations`` — the tuner test asserts it
    beats independent cold fits."""
    if not estimator.evaluator_names:
        raise ValueError("tuning needs at least one evaluator on the estimator")
    if mode not in ("random", "bayesian"):
        raise ValueError(f"tuning mode must be random|bayesian, got {mode}")
    if validation_batch is None:
        raise ValueError("tune_glm_path needs a validation batch to score")
    primary = estimator.evaluator_names[0]
    evaluator = get_evaluator(primary)
    ranges = [ParamRange("reg_weight", reg_range[0], reg_range[1], log=True)]

    results = []

    def evaluate(params: Dict[str, float]) -> float:
        fit = estimator.fit([params["reg_weight"]], batch=batch,
                            chunks=chunks, dim=dim,
                            validation_batch=validation_batch)[0]
        results.append(fit)
        if fit_callback is not None:
            fit_callback(len(results) - 1, fit)
        return fit.metrics[primary]

    search_cls = GaussianProcessSearch if mode == "bayesian" else RandomSearch
    search = search_cls(ranges, evaluate, seed=seed,
                        maximize=evaluator.higher_is_better)
    for prior in prior_results:
        if primary not in prior.metrics:
            continue
        if reg_range[0] <= prior.reg_weight <= reg_range[1]:
            search.on_prior_observation({"reg_weight": prior.reg_weight},
                                        prior.metrics[primary])
    search.find(n_iterations, batch=round_size,
                eval_order=lambda p: -p["reg_weight"])
    return results


def tune_game(
    estimator: GameEstimator,
    train: GameDataset,
    validation: GameDataset,
    base_configs: Sequence[CoordinateConfig],
    n_iterations: int,
    mode: str = "bayesian",
    reg_range: Tuple[float, float] = (1e-4, 1e4),
    prior_results: Sequence[GameFitResult] = (),
    seed: int = 0,
    tuned_coordinates: Optional[Sequence[str]] = None,
    fit_callback=None,
    warm_start=None,
    locked: Sequence[str] = (),
) -> List[GameFitResult]:
    """Run ``n_iterations`` tuning rounds; returns one GameFitResult per
    round. ``prior_results`` (e.g. the evaluated grid) seed the surrogate.
    ``tuned_coordinates`` restricts which coordinates' reg_weights move
    (default: all). ``fit_callback(round_index, result)`` fires per round.
    """
    if not estimator.evaluator_names:
        raise ValueError("tuning needs at least one evaluator on the estimator")
    if mode not in ("random", "bayesian"):
        raise ValueError(f"tuning mode must be random|bayesian, got {mode}")
    tuned = resolve_tuned_coordinates(base_configs, tuned_coordinates, locked)

    primary = estimator.evaluator_names[0]
    evaluator = get_evaluator(primary)
    ranges = [ParamRange(name, reg_range[0], reg_range[1], log=True)
              for name in tuned]

    results: List[GameFitResult] = []
    dataset_cache: dict = {}  # per-entity bucketing built once, not per round

    def evaluate(params: Dict[str, float]) -> float:
        configs = [
            dataclasses.replace(c, reg_weight=params[c.name])
            if c.name in params else c
            for c in base_configs
        ]
        fits = estimator.fit(train, validation, config_grid=[configs],
                             warm_start=warm_start, locked=locked,
                             dataset_cache=dataset_cache)
        result = fits[0]
        results.append(result)
        if fit_callback is not None:
            fit_callback(len(results) - 1, result)
        return result.evaluation.metrics[primary]

    search_cls = GaussianProcessSearch if mode == "bayesian" else RandomSearch
    search = search_cls(ranges, evaluate, seed=seed,
                        maximize=evaluator.higher_is_better)
    for prior in prior_results:
        if prior.evaluation is None or primary not in prior.evaluation.metrics:
            continue
        by_name = {c.name: c for c in prior.configs}
        if not all(name in by_name for name in tuned):
            continue
        params = {}
        in_range = True
        for name in tuned:
            w = by_name[name].reg_weight
            if not (reg_range[0] <= w <= reg_range[1]):
                in_range = False
                break
            params[name] = w
        if in_range:
            search.on_prior_observation(params,
                                        prior.evaluation.metrics[primary])
    search.find(n_iterations)
    return results
