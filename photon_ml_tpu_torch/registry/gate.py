"""Promotion gate: a candidate version earns ``LATEST`` on held-out data
(counterpart of ``photon_ml_tpu/registry/gate.py``).

The gate scores a held-out Avro shard through the EXISTING batch path —
``io/data_reader`` -> ``game/scoring.score_game_model`` -> the
``evaluation/`` metric registry — for the candidate AND the live
version, then refuses to move the pointer when any metric regresses
beyond the configured tolerance. The verdict (both metric dicts, the
per-metric deltas, pass/fail) is recorded in the candidate's manifest
either way, so a refused version carries its own audit trail.

No live version (bootstrap registry) passes trivially: there is nothing
to regress against.

The port scores on ``device`` (default ``cuda``, which raises without a
GPU) in ``dtype`` (default ``torch.float64``): the JAX gate scores in
float64 too, so the two gates' metrics agree to the float64 floor.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.evaluation import get_evaluator, is_regression
from photon_ml_tpu_torch.evaluation.evaluators import TASK_DEFAULT_EVALUATOR
from photon_ml_tpu_torch.registry.delta import materialize
from photon_ml_tpu_torch.registry.store import ModelRegistry, RegistryError

__all__ = ["GateVerdict", "evaluate_model_dir", "run_gate"]


@dataclasses.dataclass
class GateVerdict:
    """Outcome of one gate run (also serialized into the manifest)."""

    candidate: str
    live: Optional[str]
    passed: bool
    promoted: bool
    candidate_metrics: Dict[str, float]
    live_metrics: Dict[str, float]
    regressions: Dict[str, dict]
    tolerance: float

    def to_manifest(self) -> dict:
        return {
            "against": self.live,
            "passed": self.passed,
            "promoted": self.promoted,
            "candidate_metrics": self.candidate_metrics,
            "live_metrics": self.live_metrics,
            "regressions": self.regressions,
            "tolerance": self.tolerance,
            "at": time.time(),
        }


def evaluate_model_dir(model_dir: str, data_paths: Sequence[str],
                       evaluators: Sequence[str],
                       group_column: Optional[str] = None,
                       dtype=torch.float64, device=None) -> Dict[str, float]:
    """Score a labeled Avro shard with a saved model and compute the
    named metrics — the scoring driver's evaluate leg as a library call
    (one scoring code path for batch, gate, and serving parity).
    ``device`` defaults to ``cuda``."""
    from photon_ml_tpu_torch.game.scoring import score_game_model
    from photon_ml_tpu_torch.io.data_reader import read_training_examples
    from photon_ml_tpu_torch.io.model_io import (
        load_game_model, load_model_metadata,
    )
    from photon_ml_tpu_torch.io.paldb import load_index_map
    from photon_ml_tpu_torch.models import RandomEffectModel
    from photon_ml_tpu_torch.types import resolve_device

    dev = resolve_device(device)
    model = load_game_model(model_dir, device=dev)
    meta = load_model_metadata(model_dir)
    shards = sorted({c["feature_shard"] for c in meta["coordinates"]})
    index_maps = {
        s: load_index_map(os.path.join(model_dir, f"index-map.{s}.json"))
        for s in shards}
    entity_columns = [c.entity_column for c in model.coordinates.values()
                      if isinstance(c, RandomEffectModel) and c.entity_column]
    if group_column and group_column not in entity_columns:
        entity_columns = entity_columns + [group_column]
    feats, labels, offsets, weights, ents, _uids = read_training_examples(
        data_paths, index_maps, entity_columns=entity_columns,
        require_response=True)
    scores = score_game_model(model, feats, ents, offsets=offsets,
                              dtype=dtype, device=dev)
    scores = scores.detach().cpu().numpy().astype(np.float64)
    labeled = ~np.isnan(labels)
    group_ids = ents[group_column][labeled] if group_column else None
    out = {}
    for name in evaluators:
        ev = get_evaluator(name)
        out[name] = ev.evaluate(scores[labeled], labels[labeled],
                                weights[labeled], group_ids)
    return out


def run_gate(registry: ModelRegistry, candidate: str,
             data_paths: Sequence[str], *,
             evaluators: Optional[Sequence[str]] = None,
             tolerance: float = 0.0,
             group_column: Optional[str] = None,
             promote: bool = True,
             metrics_sink=None, dtype=torch.float64,
             device=None) -> GateVerdict:
    """Gate ``candidate`` against the live version on ``data_paths``.

    ``evaluators`` defaults to the candidate task's default metric.
    ``tolerance`` is the largest acceptable regression in a metric's own
    units (AUC points, RMSE units, ...) — strictly-worse-by-more-than-
    tolerance on ANY metric refuses promotion. ``metrics_sink`` (a
    ``serve.ServingMetrics``) gets the verdict counted when provided."""
    from photon_ml_tpu_torch.io.model_io import load_model_metadata

    live = registry.read_latest()
    if live == candidate:
        raise RegistryError(f"candidate {candidate!r} is already live")
    candidate_dir = materialize(registry, candidate)
    if not evaluators:
        task = load_model_metadata(candidate_dir)["task"]
        evaluators = [TASK_DEFAULT_EVALUATOR[task]]
    candidate_metrics = evaluate_model_dir(
        candidate_dir, data_paths, evaluators, group_column, dtype=dtype,
        device=device)
    live_metrics: Dict[str, float] = {}
    regressions: Dict[str, dict] = {}
    if live is not None:
        live_metrics = evaluate_model_dir(
            materialize(registry, live), data_paths, evaluators,
            group_column, dtype=dtype, device=device)
        for name in evaluators:
            ev = get_evaluator(name)
            cand, base = candidate_metrics[name], live_metrics[name]
            if is_regression(ev, cand, base, tolerance):
                regressions[name] = {
                    "candidate": _jsonable(cand), "live": _jsonable(base),
                    "higher_is_better": ev.higher_is_better,
                }
    passed = not regressions
    verdict = GateVerdict(
        candidate=candidate, live=live, passed=passed,
        promoted=passed and promote,
        candidate_metrics={k: _jsonable(v)
                           for k, v in candidate_metrics.items()},
        live_metrics={k: _jsonable(v) for k, v in live_metrics.items()},
        regressions=regressions, tolerance=float(tolerance))
    registry.update_manifest(candidate, gate=verdict.to_manifest())
    if metrics_sink is not None:
        metrics_sink.record_gate(passed)
    if verdict.promoted:
        registry.set_latest(candidate)
    return verdict


def _jsonable(v: float):
    v = float(v)
    return None if math.isnan(v) else v
