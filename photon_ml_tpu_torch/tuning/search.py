"""Hyperparameter search strategies: random and GP-guided (Bayesian) (a
copy of ``photon_ml_tpu/tuning/search.py``: numpy and scipy only, so the
same seed proposes the same configurations in both packages).

Equivalent of the reference's ``hyperparameter.search.{RandomSearch,
GaussianProcessSearch}`` + ``EvaluationFunction`` (SURVEY.md §3.1/§4.5;
reference mount empty). The evaluation function is any callable
``params_dict -> float``; search keeps (vector, value) observations, may be
seeded with prior observations (the reference seeds from the evaluated
grid points), and proposes the next configuration either uniformly at
random or by maximizing expected improvement under a Matérn-5/2 GP
surrogate over a random candidate pool.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence

import numpy as np
from scipy.special import erf as _erf

from photon_ml_tpu_torch.tuning.gp import fit_gp


@dataclasses.dataclass(frozen=True)
class ParamRange:
    """One tunable parameter: bounds plus scale. ``log=True`` searches in
    log-space (the natural scale for regularization weights)."""

    name: str
    low: float
    high: float
    log: bool = False
    integer: bool = False

    def __post_init__(self):
        if not (self.high > self.low):
            raise ValueError(f"{self.name}: need high > low, got "
                             f"[{self.low}, {self.high}]")
        if self.log and self.low <= 0:
            raise ValueError(f"{self.name}: log-scale range needs low > 0")

    def to_unit(self, value: float) -> float:
        if self.log:
            u = (math.log(value) - math.log(self.low)) / (
                math.log(self.high) - math.log(self.low))
        else:
            u = (value - self.low) / (self.high - self.low)
        return min(max(u, 0.0), 1.0)

    def from_unit(self, u: float) -> float:
        u = min(max(float(u), 0.0), 1.0)
        if self.log:
            value = math.exp(
                math.log(self.low)
                + u * (math.log(self.high) - math.log(self.low))
            )
        else:
            value = self.low + u * (self.high - self.low)
        if self.integer:
            value = round(value)
        return value


@dataclasses.dataclass(frozen=True)
class Observation:
    params: Dict[str, float]
    value: float


class RandomSearch:
    """Uniform search over the unit hypercube (log-warped per ParamRange)."""

    def __init__(
        self,
        ranges: Sequence[ParamRange],
        evaluation_function: Callable[[Dict[str, float]], float],
        seed: int = 0,
        maximize: bool = True,
    ):
        if not ranges:
            raise ValueError("need at least one ParamRange")
        names = [r.name for r in ranges]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate parameter names: {names}")
        self.ranges = list(ranges)
        self.evaluation_function = evaluation_function
        self.maximize = maximize
        self.rng = np.random.default_rng(seed)
        self.observations: List[Observation] = []

    # -- observation bookkeeping ----------------------------------------
    def on_prior_observation(self, params: Dict[str, float], value: float):
        """Seed the search with an already-evaluated configuration (the
        reference seeds from the explicit grid — SURVEY.md §4.5)."""
        self.observations.append(Observation(dict(params), float(value)))

    def _vectorize(self, params: Dict[str, float]) -> np.ndarray:
        return np.array([r.to_unit(params[r.name]) for r in self.ranges])

    def _devectorize(self, u: np.ndarray) -> Dict[str, float]:
        return {r.name: r.from_unit(u[i]) for i, r in enumerate(self.ranges)}

    def best(self) -> Observation:
        if not self.observations:
            raise ValueError("no observations yet")
        key = (max if self.maximize else min)
        return key(self.observations, key=lambda o: o.value)

    # -- proposal --------------------------------------------------------
    def propose(self) -> Dict[str, float]:
        return self._devectorize(self.rng.random(len(self.ranges)))

    def propose_batch(self, k: int) -> List[Dict[str, float]]:
        """``k`` proposals from the CURRENT posterior/state, before any of
        them is evaluated (random search: independent draws)."""
        return [self.propose() for _ in range(k)]

    def find(self, n: int, batch: int = 1,
             eval_order: Callable[[Dict[str, float]], float] | None = None,
             ) -> List[Observation]:
        """Run ``n`` propose→evaluate rounds; returns the new observations.

        With ``batch > 1`` each round proposes ``batch`` configurations
        up front and evaluates them all before re-fitting, in ascending
        ``eval_order(params)`` order when given. The GLM path tuner
        (``tuning.game_tuner.tune_glm_path``) orders each round by
        DESCENDING reg weight so the round walks the regularization path
        downward, reusing the shared path solver's warm states
        sequentially instead of cold-starting every trial."""
        new: List[Observation] = []
        for _ in range(n):
            proposals = self.propose_batch(batch)
            if eval_order is not None:
                proposals = sorted(proposals, key=eval_order)
            for params in proposals:
                value = float(self.evaluation_function(params))
                obs = Observation(params, value)
                self.observations.append(obs)
                new.append(obs)
        return new


class GaussianProcessSearch(RandomSearch):
    """Bayesian search: fit a GP to observations each round, propose the
    candidate maximizing expected improvement over a random pool."""

    def __init__(
        self,
        ranges: Sequence[ParamRange],
        evaluation_function: Callable[[Dict[str, float]], float],
        seed: int = 0,
        maximize: bool = True,
        candidate_pool: int = 512,
        exploration: float = 0.01,
    ):
        super().__init__(ranges, evaluation_function, seed, maximize)
        self.candidate_pool = candidate_pool
        self.exploration = exploration

    def _expected_improvement(self, mean, std, best_value) -> np.ndarray:
        # maximize-form EI; minimize flips signs
        if self.maximize:
            improve = mean - best_value - self.exploration
        else:
            improve = best_value - mean - self.exploration
        z = improve / std
        cdf = 0.5 * (1.0 + _erf(z / math.sqrt(2.0)))
        pdf = np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
        return improve * cdf + std * pdf

    def propose(self) -> Dict[str, float]:
        return self.propose_batch(1)[0]

    def propose_batch(self, k: int):
        if len(self.observations) < 2:
            return [super(GaussianProcessSearch, self).propose()
                    for _ in range(k)]
        x = np.stack([self._vectorize(o.params) for o in self.observations])
        y = np.array([o.value for o in self.observations])
        gp = fit_gp(x, y)
        candidates = self.rng.random((self.candidate_pool, len(self.ranges)))
        mean, std = gp.predict(candidates)
        ei = self._expected_improvement(mean, std, self.best().value)
        # batched rounds take the k best-EI pool members (distinct by
        # construction: the pool is k >> batch random candidates) from
        # ONE posterior — a cheap q-EI stand-in that keeps each GLM-path
        # tuning round a single downward walk of the lambda path
        top = np.argsort(ei)[::-1][:k]
        return [self._devectorize(candidates[int(i)]) for i in top]
