#!/usr/bin/env python3
"""How far the card's float64 solves land from the CPU's, by seed and
solver setting.

Runs the two card-against-CPU solves of ``tests/test_torch_cuda.py`` at
other seeds: the screened elastic-net path walk
(``test_path_walk_on_card_matches_cpu``: 6 lambdas, OWL-QN, at most 25
iterations per solve, logistic on 4,096 rows of 39 implicit ones over
1,024 columns) and three sweeps of GAME coordinate descent
(``test_game_cd_on_card_matches_cpu``: a fixed effect and Newton and
L-BFGS random effects). The defaults are the tolerance-0 settings those
tests had before they were restated at tolerance 1e-6
(``--path 25:1e-6 --game 10,5,5:1e-6``). Both run once on the CPU and once on
the card; the script prints, per seed, the largest relative L2 between
the two over the walk's lambdas (with the OWL-QN iterations of both sides
at that lambda) and over the GAME coordinates (with the final AUC gap).
Solves run to tolerance 0 stop where their line search can no longer
tell ``f`` values apart, so ``w`` is fixed only to about ``sqrt(eps)``
of its scale there and the two devices' reduction orders pick other last
steps. ``--path`` (``ITERS:TOL``, OWL-QN iterations per lambda and the
solver tolerance) and ``--game`` (``FIXED,NEWTON,LBFGS:TOL``, the three
coordinates' iterations and their tolerance) measure the gap at other
settings: a fixed count that ends while ``f`` still falls, or a tolerance
above the floor, keeps the solves off it. Per path walk the script also
prints the smallest relative fall of ``f`` over the last iteration of any
lambda on the card (0 means a solve reached the floor). The tests use the
settings and gates chosen from this sweep.

Needs a CUDA device. Run from the repository root, with the package to
measure first on the path (another commit's checkout, unpacked with
``git archive``, measures that commit):

    PYTHONPATH=. python3 scripts/torch_card_cpu_floor.py [--seeds 0 1 2] \
        [--path-iters 25 10] [--game-iters 10,5,5 6,2,3]

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


def last_fall(res) -> float:
    """Relative fall of ``f`` over a solve's last iteration."""
    lh = res.loss_history.cpu().numpy()[:int(res.iterations)]
    if lh.shape[0] < 2:
        return float("inf")
    return float((lh[-2] - lh[-1]) / abs(lh[-1]))


def path_gap(seed: int, iters: int = 25, tol: float = 0.0) -> dict:
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
            config=OptimizerConfig(max_iters=iters, tolerance=tol),
            path_config=PathConfig(screen="strong"))
        grid = np.geomspace(solver.lambda_max(), 0.05 * solver.lambda_max(),
                            6)
        walks[dev] = [solver.solve(float(lam)) for lam in grid]
    rels = [_rel(rg.w.cpu(), rc.w)
            for (rc, _), (rg, _) in zip(walks["cpu"], walks["cuda"])]
    at = int(np.argmax(rels))
    return {"rel": max(rels), "rels": rels, "at_lambda": at,
            "last_fall": min(last_fall(res) for res, _ in walks["cuda"]),
            "iterations": [int(walks[dev][at][0].iterations)
                           for dev in ("cpu", "cuda")],
            "support_equal": all(
                torch.equal(rg.w.cpu() != 0, rc.w != 0)
                for (rc, _), (rg, _) in zip(walks["cpu"], walks["cuda"]))}


def game_gap(seed: int, iters=(10, 5, 5), tol: float = 0.0) -> dict:
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
                         max_iters=iters[0], tolerance=tol),
        CoordinateConfig("per_user", coordinate_type="random",
                         entity_column="user", optimizer="newton",
                         max_iters=iters[1], tolerance=tol, reg_type="l2",
                         reg_weight=1.0),
        CoordinateConfig("per_item", coordinate_type="random",
                         entity_column="item", optimizer="lbfgs",
                         max_iters=iters[2], tolerance=tol, reg_type="l2",
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
    ap.add_argument("--path", nargs="+", default=["25:0"],
                    help="ITERS:TOL per path-walk setting")
    ap.add_argument("--game", nargs="+", default=["10,5,5:0"],
                    help="FIXED,NEWTON,LBFGS:TOL per GAME setting")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    out = {"card": smi, "path": {}, "game": {}}
    for spec in args.path:
        iters, tol = spec.split(":")
        for seed in args.seeds:
            p = path_gap(seed, int(iters), float(tol))
            out["path"][f"{spec}/{seed}"] = p
            print(f"path walk {spec}, seed {seed}: rel L2 {p['rel']:.3e} "
                  f"(lambda {p['at_lambda']}, OWL-QN iterations cpu/card "
                  f"{p['iterations']}, support equal {p['support_equal']}, "
                  f"smallest last fall of f {p['last_fall']:.3e}); on {smi}",
                  flush=True)
    for spec in args.game:
        iters, tol = spec.split(":")
        for seed in args.seeds:
            g = game_gap(seed, tuple(int(v) for v in iters.split(",")),
                         float(tol))
            out["game"][f"{spec}/{seed}"] = g
            print(f"GAME {spec}, seed {seed}: rel L2 {g['rel']:.3e} "
                  f"({', '.join(f'{k} {v:.3e}' for k, v in g['rels'].items())}),"
                  f" AUC gap {g['auc_gap']:.3e}; on {smi}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
