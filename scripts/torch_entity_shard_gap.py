#!/usr/bin/env python3
"""How far an entity-sharded GAME sweep lands from one rank's, by dtype.

Draws ``chip_smoke.py``'s phase 12 data (implicit-ones rows, uniform user
and item ids, so entity sizes are uneven) at a size the CPU runs in
seconds, and runs ``GameEstimator.fit`` with phase 12's coordinates for 3
sweeps on the CPU: once on one rank, once as two simulated ranks of
``testing.run_simulated_processes`` with ``EntityShardSpec(2, rank)``.
Each shard buckets only its own entities, so its padded bucket shapes,
and with them the reduction lengths of its solves, differ from one rank's.
Prints, for float32 and float64, the relative L2 and max |diff| of all
coefficients and the final validation AUC of both runs. Run from the
repository root:

    python3 scripts/torch_entity_shard_gap.py [--rows 4096] [--val-rows 1024]
        [--users 500] [--items 50] [--dim 65536]

The last line is a JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from photon_ml_tpu_torch.estimators import GameEstimator  # noqa: E402
from photon_ml_tpu_torch.parallel.entity_shard import (  # noqa: E402
    EntityShardSpec,
)
from photon_ml_tpu_torch.testing import run_simulated_processes  # noqa: E402


def tables(model):
    """The fixed coefficients and each random coordinate's entity table."""
    return [model["fixed"].model.coefficients.means.cpu().numpy()] + [
        cs.entity_table(model, c) for c in ("per_user", "per_item")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--val-rows", type=int, default=1024)
    ap.add_argument("--users", type=int, default=500)
    ap.add_argument("--items", type=int, default=50)
    ap.add_argument("--dim", type=int, default=cs.GAME_DIM)
    args = ap.parse_args()
    cs.GAME_USERS, cs.GAME_ITEMS, cs.GAME_DIM = args.users, args.items, \
        args.dim
    train, val = cs.make_game_data(args.rows, args.val_rows, cs.SEED)

    def fit(dtype, spec=None):
        est = GameEstimator(task="logistic", n_iterations=3,
                            evaluators=["auc"], device="cpu", dtype=dtype,
                            entity_shard=spec)
        res = est.fit(train, val, [cs.game_configs()])[0]
        return tables(res.model), res.history[-1]["auc"]

    report = {"rows": args.rows, "users": args.users, "items": args.items,
              "dim": args.dim}
    for dtype in (torch.float32, torch.float64):
        # one rank runs under the same harness as the two, so both pin the
        # same intra-op thread count
        (one, auc_one), = run_simulated_processes(1, lambda r: fit(dtype))
        outs = run_simulated_processes(
            2, lambda r: fit(dtype, EntityShardSpec(2, r)))
        for o in outs:
            if isinstance(o, BaseException):
                raise o
        two, auc_two = outs[0]
        got, want = [two[0]], [one[0]]
        for (ids1, proj1, c1), (ids2, proj2, c2) in zip(one[1:], two[1:]):
            if not np.array_equal(ids1, ids2):
                raise RuntimeError("the sharded run lost or added entities")
            width = max(c1.shape[1], c2.shape[1])
            want.append(np.pad(c1, ((0, 0), (0, width - c1.shape[1]))))
            got.append(np.pad(c2, ((0, 0), (0, width - c2.shape[1]))))
        g = np.concatenate([a.ravel() for a in got]).astype(np.float64)
        w = np.concatenate([a.ravel() for a in want]).astype(np.float64)
        name = str(dtype).replace("torch.", "")
        report[name] = {
            "rel_l2": float(np.linalg.norm(g - w) / np.linalg.norm(w)),
            "max_abs_diff": float(np.abs(g - w).max()),
            "auc_sharded": float(auc_two), "auc_one_rank": float(auc_one)}
        r = report[name]
        print(f"{name}: coefficients rel L2 {r['rel_l2']:.3e}, max |diff| "
              f"{r['max_abs_diff']:.3e}; final auc {r['auc_sharded']:.6f} "
              f"sharded vs {r['auc_one_rank']:.6f} one rank")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
