#!/usr/bin/env python3
"""How far the card's float64 tolerance-0 solves land from the CPU's, by
seed.

Runs the two card-against-CPU solves of ``tests/test_torch_cuda.py`` at
other seeds: the screened elastic-net path walk
(``test_path_walk_on_card_matches_cpu``: 6 lambdas, OWL-QN, 25 iterations
per solve at tolerance 0, logistic on 4,096 rows of 39 implicit ones over
1,024 columns) and three sweeps of GAME coordinate descent
(``test_game_cd_on_card_matches_cpu``: a fixed effect and Newton and
L-BFGS random effects, tolerance 0). Both run once on the CPU and once on
the card; the script prints, per seed, the largest relative L2 between
the two over the walk's lambdas (with the OWL-QN iterations of both sides
at that lambda) and over the GAME coordinates (with the final AUC gap).
The tests gate both at 1e-9 with seeds 3 and 7.

Needs a CUDA device. Run from the repository root, with the package to
measure first on the path (another commit's checkout, unpacked with
``git archive``, measures that commit):

    PYTHONPATH=. python3 scripts/torch_card_cpu_floor.py [--seeds 0 1 2]

The last line is a JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from photon_ml_tpu_torch.game.data import HostSparse
from photon_ml_tpu_torch.game.descent import (
    CoordinateConfig, CoordinateDescent, make_game_dataset,
)
from photon_ml_tpu_torch.interop import batch_from_numpy
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import PathConfig
from photon_ml_tpu_torch.optimize.common import OptimizerConfig
from photon_ml_tpu_torch.optimize.path import PathSolver


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def path_gap(seed: int) -> dict:
    """The path walk on both devices: the largest rel L2 over lambdas."""
    r = np.random.default_rng(seed)
    n, dim, k = 4096, 1024, 39
    idx = r.integers(0, dim, (n, k)).astype(np.int32)
    w_true = r.normal(size=dim) * 0.5
    y = (r.random(n) < 1 / (1 + np.exp(-w_true[idx].sum(1)))).astype(float)
    walks = {}
    for dev in ("cpu", "cuda"):
        solver = PathSolver(
            make_objective("logistic"),
            RegularizationContext("elastic_net", alpha=0.9),
            batch=batch_from_numpy(idx, None, y, dim=dim,
                                   dtype=torch.float64, device=dev),
            config=OptimizerConfig(max_iters=25, tolerance=0.0),
            path_config=PathConfig(screen="strong"))
        grid = np.geomspace(solver.lambda_max(), 0.05 * solver.lambda_max(),
                            6)
        walks[dev] = [solver.solve(float(lam)) for lam in grid]
    rels = [_rel(rg.w.cpu(), rc.w)
            for (rc, _), (rg, _) in zip(walks["cpu"], walks["cuda"])]
    at = int(np.argmax(rels))
    return {"rel": max(rels), "rels": rels, "at_lambda": at,
            "iterations": [int(walks[dev][at][0].iterations)
                           for dev in ("cpu", "cuda")],
            "support_equal": all(
                torch.equal(rg.w.cpu() != 0, rc.w != 0)
                for (rc, _), (rg, _) in zip(walks["cpu"], walks["cuda"]))}


def game_gap(seed: int) -> dict:
    """Three GAME sweeps on both devices: the largest rel L2 over the
    coordinates' coefficients and the final AUC gap."""
    r = np.random.default_rng(seed)
    n, dim, k = 3000, 256, 12
    idx = r.integers(0, dim, (n, k)).astype(np.int32)
    y = (r.random(n) < 1 / (1 + np.exp(-r.normal(size=dim)[idx].sum(1))))
    users, items = r.integers(0, 120, n), r.integers(0, 30, n)

    def part(rows):
        return make_game_dataset(
            {"global": HostSparse(idx[rows], None, dim)},
            y[rows].astype(float),
            entity_ids={"user": users[rows], "item": items[rows]})

    train, val = part(slice(0, 2400)), part(slice(2400, n))
    configs = [
        CoordinateConfig("fixed", reg_type="l2", reg_weight=1.0,
                         max_iters=10, tolerance=0.0),
        CoordinateConfig("per_user", coordinate_type="random",
                         entity_column="user", optimizer="newton",
                         max_iters=5, tolerance=0.0, reg_type="l2",
                         reg_weight=1.0),
        CoordinateConfig("per_item", coordinate_type="random",
                         entity_column="item", optimizer="lbfgs",
                         max_iters=5, tolerance=0.0, reg_type="l2",
                         reg_weight=1.0),
    ]
    runs = {dev: CoordinateDescent(
        configs, n_iterations=3, evaluators=["auc"], dtype=torch.float64,
        device=dev).run(train, val) for dev in ("cpu", "cuda")}
    (cpu, h_cpu), (card, h_card) = runs["cpu"], runs["cuda"]
    rels = {"fixed": _rel(card["fixed"].model.coefficients.means.cpu(),
                          cpu["fixed"].model.coefficients.means)}
    for name in ("per_user", "per_item"):
        rels[name] = max(_rel(bg.coefficients, bc.coefficients)
                         for bg, bc in zip(card[name].buckets,
                                           cpu[name].buckets))
    return {"rel": max(rels.values()), "rels": rels,
            "auc_gap": abs(h_card[-1]["auc"] - h_cpu[-1]["auc"])}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    out = {"card": smi, "path": {}, "game": {}}
    for seed in args.seeds:
        p, g = path_gap(seed), game_gap(seed)
        out["path"][seed], out["game"][seed] = p, g
        print(f"seed {seed}: path walk rel L2 {p['rel']:.3e} (lambda "
              f"{p['at_lambda']}, OWL-QN iterations cpu/card "
              f"{p['iterations']}, support equal {p['support_equal']}); "
              f"GAME rel L2 {g['rel']:.3e} "
              f"({', '.join(f'{k} {v:.3e}' for k, v in g['rels'].items())}),"
              f" AUC gap {g['auc_gap']:.3e}; on {smi}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
