"""Worker for the port's multi-process tests (``tests/test_torch_mesh.py``,
``tests/test_torch_multiprocess.py``).

Each rank runs this script: it joins a gloo process group through a
``FileStore`` (no port to collide on), runs the named scenarios on CPU
tensors at float64 and saves its results as ``rank{r}.npz`` for the
parent test to compare across ranks and against the references. It
imports only numpy, torch and the port, as ``tests/multiprocess_worker.py``
imports only the JAX package.

``start`` runs the ranks in the background while the parent builds its
references; its ``wait`` kills every rank when one fails or the timeout
passes, and surfaces each rank's stderr.
"""

import argparse
import datetime
import os
import subprocess
import sys

import numpy as np

SPAWN_TIMEOUT_S = 120
L2, L1 = 1.0, 8.0
ITERS = 8


def free_port() -> int:
    """A TCP port on the loopback that was free a moment ago."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- problems (the parents build their references from the same data) -------
def glm_problem(seed=7, n=301, dim=24, k=5):
    """n rows that neither 2 nor 3 divides (so every shard pads), k values
    per row with the last column an intercept of ones, weighted rows (some
    weight 0) and offsets."""
    r = np.random.default_rng(seed)
    idx = r.integers(0, dim - 1, (n, k)).astype(np.int32)
    idx[:, -1] = dim - 1
    vals = r.normal(size=(n, k))
    vals[:, -1] = 1.0
    w_true = r.normal(size=dim)
    logits = (w_true[idx] * vals).sum(1)
    y = (r.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(float)
    offsets = r.normal(scale=0.1, size=n)
    weights = r.random(n) + 0.5
    weights[::29] = 0.0
    return idx, vals, y, offsets, weights, dim


def point(dim, seed=3):
    """A coefficient vector and a direction to evaluate at."""
    r = np.random.default_rng(seed)
    return r.normal(scale=0.3, size=dim), r.normal(size=dim)


def auc_problem(seed=5, n=301):
    r = np.random.default_rng(seed)
    scores = np.round(r.normal(size=n), 2)  # ties across shards
    labels = (r.random(n) < 1 / (1 + np.exp(-2 * scores))).astype(float)
    weights = r.random(n) + 0.5
    weights[::17] = 0.0
    return scores, labels, weights


def game_problem(seed=11, n=240, dim=10, users=13):
    """A GAME dataset: dense-ish global features with an intercept, one
    user id per row."""
    r = np.random.default_rng(seed)
    k = 4
    idx = r.integers(0, dim - 1, (n, k)).astype(np.int32)
    idx[:, -1] = dim - 1
    vals = r.normal(size=(n, k))
    vals[:, -1] = 1.0
    ids = r.integers(0, users, n)
    w_true = r.normal(size=dim)
    u_eff = r.normal(size=users)
    logits = (w_true[idx] * vals).sum(1) + u_eff[ids]
    y = (r.random(n) < 1 / (1 + np.exp(-logits))).astype(float)
    return idx, vals, y, ids, dim


def game_configs(streaming=False):
    from photon_ml_tpu_torch.game.descent import CoordinateConfig

    return [
        CoordinateConfig("global", reg_type="l2", reg_weight=0.5,
                         max_iters=ITERS, tolerance=0.0,
                         intercept_index=game_problem()[4] - 1,
                         streaming=streaming, chunk_rows=64,
                         compute_variance=True),
        CoordinateConfig("per-user", coordinate_type="random",
                         feature_shard="re", entity_column="userId",
                         reg_type="l2", reg_weight=1.0, max_iters=ITERS,
                         tolerance=0.0),
    ]


def game_dataset():
    from photon_ml_tpu_torch.game.data import HostSparse
    from photon_ml_tpu_torch.game.descent import GameDataset

    idx, vals, y, ids, dim = game_problem()
    sp = HostSparse(idx, vals, dim)
    return GameDataset({"global": sp, "re": sp}, y, None, None,
                       {"userId": ids.astype(str)})


def run_cd(mesh, streaming=False):
    """Two sweeps of GAME CD with AUC on the training rows; returns the
    fixed coefficients and variances, every random bucket's coefficients
    and the AUC history."""
    import torch

    from photon_ml_tpu_torch.game.descent import CoordinateDescent

    ds = game_dataset()
    cd = CoordinateDescent(game_configs(streaming), task="logistic",
                           n_iterations=2, evaluators=["auc"],
                           dtype=torch.float64, device="cpu", mesh=mesh)
    model, history = cd.run(ds, ds)
    fixed = model.coordinates["global"].model.coefficients
    out = {"w_fixed": fixed.means.numpy(),
           "v_fixed": fixed.variances.numpy(),
           "auc": np.asarray([h["auc"] for h in history])}
    for b, bucket in enumerate(model.coordinates["per-user"].buckets):
        out[f"re{b}"] = np.asarray(bucket.coefficients)
    return out


def run_re(mesh):
    """The random coordinate of ``game_problem`` solved and scored twice:
    every entity, then about half of them (an active set, warm from the
    first solve, rescored incrementally), with the variances."""
    import torch

    from photon_ml_tpu_torch.game.data import (
        HostSparse, build_random_effect_data, build_score_view,
    )
    from photon_ml_tpu_torch.game.random_effect import (
        score_random_effect, train_random_effect,
    )
    from photon_ml_tpu_torch.optimize.common import OptimizerConfig

    idx, vals, y, ids, dim = game_problem()
    sp = HostSparse(idx, vals, dim)
    data = build_random_effect_data(sp, y, np.ones(len(y)), ids.astype(str),
                                    num_buckets=2)
    view = build_score_view(data, sp, ids.astype(str))
    offsets = np.random.default_rng(2).normal(scale=0.3, size=len(y))
    cfg = OptimizerConfig(max_iters=ITERS, tolerance=0.0, history=5)
    kw = dict(task="logistic", l2=1.0, config=cfg, compute_variance=True,
              dtype=torch.float64, device="cpu", mesh=mesh)
    first = train_random_effect(data, offsets, **kw)
    scores = score_random_effect(view, first.coefficients, len(y),
                                 torch.float64, device="cpu", mesh=mesh)
    r = np.random.default_rng(9)
    active = [r.random(b.num_entities) < 0.5 for b in data.buckets]
    second = train_random_effect(data, offsets + 0.1, w0=first.coefficients,
                                 active=active,
                                 prev_variances=first.variances, **kw)
    rescored = score_random_effect(view, second.coefficients, len(y),
                                   torch.float64, prev=scores,
                                   changed=active, device="cpu", mesh=mesh)
    out = {"scores": scores.numpy(), "rescored": rescored.numpy()}
    for tag, fit in (("first", first), ("second", second)):
        for b in range(len(data.buckets)):
            out[f"{tag}_w{b}"] = fit.coefficients[b]
            out[f"{tag}_v{b}"] = fit.variances[b]
            out[f"{tag}_conv{b}"] = fit.converged[b]
    return out


def scenario_re(args):
    """``run_re`` with the entities sharded over every rank."""
    from photon_ml_tpu_torch.parallel.mesh import make_mesh

    return run_re(make_mesh({"entity": args.world}, device_type="cpu"))


def port_batch(dtype=None):
    import torch

    from photon_ml_tpu_torch.interop import batch_from_numpy

    idx, vals, y, offsets, weights, dim = glm_problem()
    return batch_from_numpy(idx, vals, y, offsets, weights, dim=dim,
                            dtype=dtype or torch.float64, device="cpu")


# -- scenarios (each rank runs these inside the process group) -------------
def scenario_grads(args):
    """The sharded data terms at one point: the full path, the
    column-sorted path through the kernel's wrapper, and the margin path's
    trial scalars and gradient."""
    import torch

    from photon_ml_tpu_torch.ops.objective import make_objective
    from photon_ml_tpu_torch.parallel import data_parallel as dp
    from photon_ml_tpu_torch.parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh({"data": args.world}, device_type="cpu")
    obj = make_objective("logistic", intercept_index=glm_problem()[5] - 1)
    shard = shard_batch(port_batch(), mesh)
    w, v = (torch.as_tensor(a) for a in point(shard.dim))
    ax = dict(mesh=mesh, axis="data")
    f, g = dp.distributed_value_and_grad(obj, **ax)(w, shard, L2)
    out = {"f": f, "g": g,
           "value": dp.distributed_value(obj, **ax)(w, shard, L2),
           "hv": dp.distributed_hvp(obj, **ax)(w, v, shard, L2),
           "diag": dp.distributed_diagonal_hessian(obj, **ax)(w, shard, L2)}
    build, fg, hvp = dp.make_csc_path(obj, use_kernel=True, **ax)
    csc = build(shard)
    out["f_csc"], out["g_csc"] = fg(w, shard, csc, L2)
    out["hv_csc"] = hvp(w, v, shard, csc, L2)
    squares, diag = dp.make_csc_diagonal_hessian(obj, "csc_kernel", **ax)
    out["diag_csc"] = diag(w, shard, csc, squares(csc), L2)
    init_m, dir_m, loss_dir, data_grad, delta_dir = dp.make_margin_path(
        obj, "csc_kernel", **ax)
    m, mp = init_m(w, shard), dir_m(shard)(v)
    out["loss_dir"] = torch.stack(loss_dir(shard)(m, mp))
    out["delta_dir"] = torch.stack(delta_dir(shard)(m, mp, 0.25))
    out["grad_m"] = data_grad(shard, csc)(m)
    return {k: t.numpy() for k, t in out.items()}


def scenario_fits(args):
    """``fit_distributed`` sharded over every rank: L-BFGS (margin line
    search), TRON and OWL-QN through ``csc_kernel``, and L-BFGS with the
    full line search through ``scatter``, ITERS iterations at tolerance
    0."""
    import torch

    from photon_ml_tpu_torch.ops.objective import make_objective
    from photon_ml_tpu_torch.optimize.common import OptimizerConfig
    from photon_ml_tpu_torch.parallel.data_parallel import fit_distributed
    from photon_ml_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": args.world}, device_type="cpu")
    batch = port_batch()
    obj = make_objective("logistic", intercept_index=batch.dim - 1)
    out = {}
    for name, opt, mode, ls in FITS:
        res = fit_distributed(
            obj, batch, torch.zeros(batch.dim, dtype=torch.float64), l2=L2,
            l1=L1, optimizer=opt,
            config=OptimizerConfig(max_iters=ITERS, tolerance=0.0),
            sparse_grad=mode, line_search=ls, mesh=mesh)
        out[f"{name}_w"] = res.w.numpy()
        out[f"{name}_value"] = np.asarray(float(res.value))
        out[f"{name}_iters"] = np.asarray(res.iterations)
        out[f"{name}_reads"] = np.asarray(res.host_syncs)
    return out


FITS = [("lbfgs", "lbfgs", "csc_kernel", "margin"),
        ("tron", "tron", "csc_kernel", "full"),
        ("owlqn", "owlqn", "csc_kernel", "full"),
        ("lbfgs_full", "lbfgs", "scatter", "full")]


def scenario_auc(args):
    """The histogram AUC sharded over the ranks (every rank passes the
    whole score vector) and the device evaluator that takes it."""
    from photon_ml_tpu_torch.evaluation.device import (
        histogram_auc, make_device_evaluator,
    )
    from photon_ml_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": args.world}, device_type="cpu")
    s, lab, wt = auc_problem()
    ev = make_device_evaluator("auc", mesh=mesh, device="cpu")
    return {"hist": histogram_auc(s, lab, wt, n_bins=64, mesh=mesh,
                                  device="cpu").numpy(),
            "eval": ev(s, lab, wt).numpy()}


def scenario_stream(args):
    """``fit_streaming`` over this process's ``process_span`` of the rows:
    L-BFGS to convergence, and TRON for ITERS iterations."""
    import torch

    from photon_ml_tpu_torch.game.data import HostSparse
    from photon_ml_tpu_torch.ops.objective import make_objective
    from photon_ml_tpu_torch.optimize.common import OptimizerConfig
    from photon_ml_tpu_torch.parallel.multihost import process_span
    from photon_ml_tpu_torch.parallel.streaming import (
        fit_streaming, make_host_chunks,
    )

    idx, vals, y, offsets, weights, dim = glm_problem()
    s0, s1 = process_span(len(y))
    chunks, _ = make_host_chunks(HostSparse(idx[s0:s1], vals[s0:s1], dim),
                                 y[s0:s1], offsets[s0:s1], weights[s0:s1],
                                 chunk_rows=64)
    obj = make_objective("logistic", intercept_index=dim - 1)
    out = {}
    for name, opt, cfg in (
            ("lbfgs", "lbfgs", OptimizerConfig(max_iters=60,
                                                tolerance=1e-12)),
            ("tron", "tron", OptimizerConfig(max_iters=ITERS,
                                              tolerance=0.0))):
        res = fit_streaming(obj, chunks, dim, l2=L2, config=cfg,
                            dtype=torch.float64, optimizer=opt,
                            device="cpu")
        out[f"{name}_w"] = res.w.numpy()
        out[f"{name}_value"] = np.asarray(float(res.value))
        out[f"{name}_comm_s"] = np.asarray(res.stream_stats["comm_s"])
    return out


def scenario_ooc(args):
    """An on-disk Avro file read through this process's
    ``AvroChunkSource(process_part=)`` share: its spans, the streamed
    feature summary reduced across processes, and a streamed fit."""
    import torch

    from photon_ml_tpu_torch.io.index_map import IndexMap
    from photon_ml_tpu_torch.io.stream_source import AvroChunkSource
    from photon_ml_tpu_torch.ops.objective import make_objective
    from photon_ml_tpu_torch.ops.statistics import (
        summarize_features_streamed,
    )
    from photon_ml_tpu_torch.optimize.common import OptimizerConfig
    from photon_ml_tpu_torch.parallel.multihost import (
        allreduce_summary_moments, process_count, process_index,
    )
    from photon_ml_tpu_torch.parallel.streaming import fit_streaming

    dim = glm_problem()[5]
    imap = IndexMap({f"f{j}": j for j in range(dim)}, add_intercept=False)
    src = AvroChunkSource(args.data, imap, chunk_rows=32, dtype=np.float64,
                          process_part=(process_index(), process_count()))
    summ = summarize_features_streamed(
        src, src.dim, src.rows, total_rows=src.total_rows,
        part_reduce=allreduce_summary_moments)
    res = fit_streaming(make_objective("logistic"), src, dim, l2=L2,
                        config=OptimizerConfig(max_iters=60,
                                               tolerance=1e-12),
                        dtype=torch.float64, device="cpu")
    return {"part_spans": np.asarray(src.part_spans),
            "row_span": np.asarray(src.row_span), "rows": np.asarray(src.rows),
            "mean": summ.mean, "variance": summ.variance, "min": summ.min,
            "max": summ.max, "nnz": summ.num_nonzeros,
            "count": np.asarray(summ.count), "w": res.w.numpy()}


def scenario_cd(args):
    """GAME CD with the fixed coordinate's rows sharded (``{"data": W}``),
    then with the random coordinate's entities sharded and the fixed
    coordinate streamed over each process's span
    (``{"data": 1, "entity": W}``)."""
    from photon_ml_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for tag, sizes, streaming in (
            ("data", {"data": args.world}, False),
            ("entity", {"data": 1, "entity": args.world}, True)):
        mesh = make_mesh(sizes, device_type="cpu")
        out.update({f"{tag}_{k}": v
                    for k, v in run_cd(mesh, streaming).items()})
    return out


def scenario_path(args):
    """The screened path sharded by rows: two lambdas, warm and screened
    from the first."""
    from photon_ml_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": args.world}, device_type="cpu")
    return run_path(mesh)


def run_path(mesh):
    from photon_ml_tpu_torch.ops.objective import make_objective
    from photon_ml_tpu_torch.ops.regularization import (
        RegularizationContext,
    )
    from photon_ml_tpu_torch.optimize.common import (
        OptimizerConfig, PathConfig,
    )
    from photon_ml_tpu_torch.optimize.path import PathSolver

    batch = port_batch()
    solver = PathSolver(
        make_objective("logistic", intercept_index=batch.dim - 1),
        RegularizationContext("elastic_net", alpha=0.9), batch=batch,
        config=OptimizerConfig(max_iters=200, tolerance=1e-12),
        path_config=PathConfig(screen="strong"), device="cpu", mesh=mesh)
    lam_max = solver.lambda_max() / 0.9
    out = {"lam_max": np.asarray(lam_max)}
    for i, frac in enumerate((0.5, 0.1)):
        res, stats = solver.solve(frac * lam_max)
        out[f"w{i}"] = res.w.numpy()
        out[f"screened{i}"] = np.asarray(stats.as_dict()["screened_dim"])
    return out


FAULT_SWEEPS = 3
WATCHDOG_S = 3.0  # the barrier timeout of the watchdog leg
WATCHDOG_DELAY_S = 5.0  # rank 1's stall, longer than WATCHDOG_S


def run_sharded_cd(rank, world, recovery=None):
    """Entity-sharded CD of ``game_problem`` over the world's resilience
    transport (no mesh): the fixed coefficients, every local bucket's
    coefficients by entity and the AUC history."""
    import torch

    from photon_ml_tpu_torch.game.descent import CoordinateDescent
    from photon_ml_tpu_torch.parallel.entity_shard import EntityShardSpec

    ds = game_dataset()
    spec = None if world == 1 else EntityShardSpec(world, rank)
    model, history = CoordinateDescent(
        game_configs(), task="logistic", n_iterations=FAULT_SWEEPS,
        evaluators=["auc"], dtype=torch.float64, device="cpu",
        entity_shard=spec, recovery=recovery).run(ds, ds)
    out = {"w_fixed": model.coordinates["global"].model.coefficients
           .means.numpy(),
           "auc": np.asarray([h["auc"] for h in history])}
    ids, coefs = [], []
    for bucket in model.coordinates["per-user"].buckets:
        ids += [str(e) for e in bucket.entity_ids]
        coefs += list(np.asarray(bucket.coefficients))
    order = np.argsort(ids)
    out["re_ids"] = np.asarray(ids)[order]
    out["re_coef"] = np.stack(coefs)[order]
    return out


def scenario_faults(args):
    """The resilience layer over the real gloo world, in order: an
    uninterrupted entity-sharded CD; a raise at ``cd.step`` on rank 1
    (``PeerFailure`` expected on both ranks); the same raise under a
    ``RecoveryManager`` (a rollback, bit-equal to the first run); then
    rank 1 stalls at ``cd.step`` longer than a WATCHDOG_S barrier timeout
    (``WatchdogTimeout`` expected on rank 0). The last leg leaves the
    group unusable, so the process exits without a teardown."""
    import time

    from photon_ml_tpu_torch.parallel import fault_injection as fi
    from photon_ml_tpu_torch.parallel.recovery import RecoveryManager
    from photon_ml_tpu_torch.parallel.resilience import (
        PeerFailure, WatchdogTimeout,
    )

    global _ABANDON
    rank, world = args.rank, args.world
    out = {f"clean_{k}": v for k, v in run_sharded_cd(rank, world).items()}

    # cd.step fires once per (sweep, coordinate): occurrence 3 is sweep
    # 1's random step, after sweep 1's snapshot is committed
    fi.install([fi.Fault(site="cd.step", kind="raise", process=1, at=3)])
    try:
        run_sharded_cd(rank, world)
        out["raise_outcome"] = np.asarray("returned")
    except PeerFailure as e:
        out["raise_outcome"] = np.asarray(type(e).__name__)
        out["raise_failed"] = np.asarray(sorted(e.failed.items()))
    fi.install([fi.Fault(site="cd.step", kind="raise", process=1, at=3)])
    rec = RecoveryManager(os.path.join(args.out, "recovery"),
                          max_rank_failures=0, backoff_s=0.01, jitter=0.0)
    out.update({f"rollback_{k}": v
                for k, v in run_sharded_cd(rank, world, rec).items()})
    out["rollback_stats"] = np.asarray(
        [rec.stats["rollbacks"], rec.stats["recoveries"],
         rec.stats["snapshots"]])

    os.environ["PHOTON_ML_TPU_BARRIER_TIMEOUT_S"] = str(WATCHDOG_S)
    fi.install([fi.Fault(site="cd.step", kind="delay", process=1, at=1,
                         delay_s=WATCHDOG_DELAY_S)])
    _ABANDON = True
    t0 = time.monotonic()
    try:
        run_sharded_cd(rank, world)
        out["watchdog_outcome"] = np.asarray("returned")
    except WatchdogTimeout:
        out["watchdog_outcome"] = np.asarray("WatchdogTimeout")
    except Exception as e:  # the stalled rank meets its dead peer
        out["watchdog_outcome"] = np.asarray(type(e).__name__)
    out["watchdog_s"] = np.asarray(time.monotonic() - t0)
    fi.clear()
    return out


_ABANDON = False  # set by a scenario that leaves the group unusable

SCENARIOS = {"grads": scenario_grads, "fits": scenario_fits,
             "auc": scenario_auc, "stream": scenario_stream,
             "ooc": scenario_ooc, "cd": scenario_cd, "path": scenario_path,
             "re": scenario_re, "faults": scenario_faults}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--scenarios", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--data", default=None)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(args.store, args.world),
        rank=args.rank, world_size=args.world,
        timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S))
    results = {}
    for name in args.scenarios.split(","):
        results.update({f"{name}/{k}": np.asarray(v)
                        for k, v in SCENARIOS[name](args).items()})
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **results)
    if _ABANDON:
        # a collective was abandoned: a teardown would wait on it
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    dist.destroy_process_group()
    return 0


def start(world, scenarios, out_dir, data=None):
    """Start ``world`` ranks of the named scenarios in one gloo group, in
    the background; the returned ``wait(timeout)`` collects each rank's
    results ({"scenario/key": array}) in rank order."""
    os.makedirs(out_dir, exist_ok=True)
    cmd = [sys.executable, os.path.abspath(__file__),
           "--store", os.path.join(out_dir, "store"), "--world", str(world),
           "--scenarios", ",".join(scenarios), "--out", out_dir]
    if data is not None:
        cmd += ["--data", data]
    wait_ranks = launch([cmd + ["--rank", str(r)] for r in range(world)],
                        out_dir)

    def wait(timeout=SPAWN_TIMEOUT_S):
        wait_ranks(timeout)
        return [np.load(os.path.join(out_dir, f"rank{r}.npz"))
                for r in range(world)]

    return wait


def launch(cmds, log_dir):
    """Start one process per command (the repo on ``PYTHONPATH``, one
    thread each); the returned ``wait(timeout)`` waits for all of them.
    When one fails, or the timeout passes, every process still running is
    killed and the error carries each rank's stderr."""
    import time

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    logs = [os.path.join(log_dir, f"rank{r}.stderr") for r in range(len(cmds))]
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "wb") as err:
            procs.append(subprocess.Popen(cmd, env=env, cwd=repo,
                                          stdout=subprocess.DEVNULL,
                                          stderr=err))

    def wait(timeout=SPAWN_TIMEOUT_S):
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if time.monotonic() > deadline:
                failed = "timeout"
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode),
                          None)
        if failed is not None:
            report = [f"rank {failed!r} failed; exit codes "
                      f"{[p.returncode for p in procs]}"]
            for r, log in enumerate(logs):
                with open(log, "rb") as f:
                    report.append(f"rank {r} stderr:\n"
                                  f"{f.read().decode()[-3000:]}")
            raise RuntimeError("\n".join(report))

    return wait


if __name__ == "__main__":
    sys.exit(main())
