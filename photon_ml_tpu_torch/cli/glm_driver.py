"""Classic (non-GAME) GLM training driver — the staged pipeline (counterpart
of ``photon_ml_tpu/cli/glm_driver.py``).

A fixed sequence of stages for a single fixed-effect GLM: read → index →
validate → summarize/normalize → train one model per regularization weight
with **warm start** across the lambda grid → validate + select best →
diagnostics → save. The output tree and the stage names and keys of
``photon.log.jsonl`` are the JAX driver's, so either package's tooling
reads the other's runs, and a model saved here loads there.

The data goes to ``--device`` (default ``cuda``, which raises without a
GPU; ``--device cpu`` runs everything on the CPU). The column-sorted view
behind the sparse gradient is built once for the whole grid, and every
gradient of every lambda's fit goes through ``ops.kernels``'s
``csc_column_sums`` (the hand-written CUDA kernel on the card, its
plain version on the CPU). Each ``lambda_trained`` event carries what
its fit cost the card: ``kernel_launches`` (of that kernel; not for a
plain streamed fit, whose ``stream`` record counts its passes) and
``host_reads`` (device-to-host reads).

``--path-screen strong|safe`` walks the grid through
``optimize.path.PathSolver``: screened restricted solves, each certified by
a full-gradient KKT pass, and each lambda's ``PathLambdaStats`` in its
``lambda_trained`` event under ``path``.

``--streaming`` keeps the training set in host RAM and streams
fixed-shape chunks through the device on every optimizer pass
(``parallel.streaming.fit_streaming``); ``--out-of-core`` never
materializes it, re-decoding Avro block waves from disk each pass
(``io.stream_source.AvroChunkSource``), or once with ``--chunk-cache-dir``
(``io.chunk_cache.ChunkCacheSource``). Each chunk's gradient goes through
the same kernel.

``--coordinator-address HOST:PORT --num-processes N --process-id I`` runs
one process per device (``parallel.multihost.initialize_multihost``):
every process reads the data; the in-memory fit shards its rows over the
world (``parallel.mesh``), ``--streaming`` streams each process's
``process_span`` and ``--out-of-core`` each process's
``AvroChunkSource(process_part=)`` share, their partials summed across
processes. Every process reaches the same models; only rank 0 writes
them (and the diagnostics and feature summary), and each other rank logs
to its own ``photon.log.rank-I.jsonl``.

Device loss (``utils.is_device_loss``: a sticky CUDA error, on any
process) during the grid or after it persists every finished lambda to
``RESUME_GLM.npz`` in the output directory and exits 75; the same command
with ``--auto-resume`` replays them (the path solver is seeded with their
solutions, nothing is re-solved) and trains the rest. The marker is
fingerprinted against the train and validation inputs, so a changed rerun
refuses it, and it is consumed only when the grid completes.
``--max-rank-failures N`` retries a lambda whose fit died in a transient
coordinated abort (every rank alive) up to N times
(``parallel.recovery.retry_collective``).

``--trace-dir`` (or ``PHOTON_TRACE``) writes the run's trace spans, one
``trace-rankN.json`` per process (a ``glm.path_lambda`` span per lambda of
a screened path), ``--trace-sample`` the fraction of traces kept;
``--profile-dir`` a ``torch.profiler`` trace of training.

Usage:
    python -m photon_ml_tpu_torch.cli.glm_driver \\
        --train-data a1a --input-format libsvm --task logistic_regression \\
        --reg-weights 0.1 1.0 10.0 --optimizer lbfgs --output-dir out/
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import diagnostics
from photon_ml_tpu_torch.cli._common import (
    add_trace_args, log_path, positive_int, runtime_info, start_processes,
    stop_processes, tol_schedule, traced, write_feature_summary,
)
from photon_ml_tpu_torch.evaluation import get_evaluator
from photon_ml_tpu_torch.evaluation.evaluators import TASK_DEFAULT_EVALUATOR
from photon_ml_tpu_torch.game.data import HostSparse
from photon_ml_tpu_torch.io.avro import iter_avro_records
from photon_ml_tpu_torch.io.chunk_cache import ChunkCacheSource
from photon_ml_tpu_torch.io.data_reader import decode_training_examples
from photon_ml_tpu_torch.io.index_map import IndexMap, build_index_map
from photon_ml_tpu_torch.io.libsvm import read_libsvm
from photon_ml_tpu_torch.io.model_io import save_game_model
from photon_ml_tpu_torch.io.stream_source import AvroChunkSource
from photon_ml_tpu_torch.io.validators import validate_training_data
from photon_ml_tpu_torch.models import (
    Coefficients,
    FixedEffectModel,
    GameModel,
    GeneralizedLinearModel,
)
from photon_ml_tpu_torch.ops.losses import TASK_TO_LOSS
from photon_ml_tpu_torch.ops.normalization import (
    NormalizationType,
    build_normalization_context,
)
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.ops.statistics import summarize_features
from photon_ml_tpu_torch.optimize import (
    OptimizerConfig, PathConfig,
)
from photon_ml_tpu_torch.optimize.path import PathSolver
from photon_ml_tpu_torch.parallel import fault_injection
from photon_ml_tpu_torch.parallel.data_parallel import (
    build_csc, distributed_coefficient_variances, fit_shard,
    resolve_sparse_grad,
)
from photon_ml_tpu_torch.parallel.mesh import (
    make_mesh, mesh_device, shard_batch,
)
from photon_ml_tpu_torch.parallel.multihost import (
    is_lead, process_count, process_index, process_span,
)
from photon_ml_tpu_torch.parallel.recovery import retry_collective
from photon_ml_tpu_torch.parallel.resilience import ResumeManager
from photon_ml_tpu_torch.parallel.streaming import (
    fit_streaming, make_host_chunks, streaming_coefficient_variances,
)
from photon_ml_tpu_torch.types import (
    LabeledBatch, SparseFeatures, make_batch, resolve_device,
)
from photon_ml_tpu_torch.utils import (
    PhotonLogger, Timed, is_device_loss, profile_trace, resolve_dtype,
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Classic GLM training driver "
                                            "(staged pipeline, PyTorch)")
    p.add_argument("--train-data", required=True, nargs="+")
    p.add_argument("--validation-data", nargs="+", default=None)
    p.add_argument("--input-format", default="avro", choices=["avro", "libsvm"])
    p.add_argument("--output-dir", required=True)
    p.add_argument("--task", default="logistic_regression",
                   choices=sorted(TASK_TO_LOSS) + sorted(set(TASK_TO_LOSS.values())))
    p.add_argument("--optimizer", default="lbfgs",
                   choices=["lbfgs", "owlqn", "tron"])
    p.add_argument("--reg-type", default="l2",
                   choices=["none", "l1", "l2", "elastic_net"])
    p.add_argument("--reg-weights", type=float, nargs="+", default=[0.0],
                   help="lambda grid; trained in order with warm start")
    p.add_argument("--elastic-net-alpha", type=float, default=0.5)
    p.add_argument("--max-iters", type=int, default=100)
    p.add_argument("--tolerance", type=float, default=1e-7)
    p.add_argument("--solver-tol-schedule", type=tol_schedule, default=None,
                   metavar="START:DECAY",
                   help="inexact path-following over the lambda grid: the "
                        "i-th lambda solves to max(--tolerance, START * "
                        "DECAY^i) (e.g. 1e-3:0.1; 'off' disables)")
    p.add_argument("--normalization", default="none",
                   choices=[t.value for t in NormalizationType])
    p.add_argument("--add-intercept", action="store_true", default=True)
    p.add_argument("--no-intercept", dest="add_intercept", action="store_false")
    p.add_argument("--index-map", default=None,
                   help="prebuilt index map (avro input only)")
    p.add_argument("--hash-dim", type=int, default=None,
                   help="feature-hash into this width instead of building an "
                        "index map (avro input only)")
    p.add_argument("--min-feature-count", type=int, default=1)
    p.add_argument("--evaluators", nargs="*", default=None)
    p.add_argument("--validate-data", action="store_true", default=True,
                   help="run DataValidators-style checks before training")
    p.add_argument("--no-validate-data", dest="validate_data",
                   action="store_false")
    p.add_argument("--compute-variances", action="store_true",
                   help="diagonal-inverse-Hessian coefficient variances")
    p.add_argument("--summarize-features", action="store_true")
    p.add_argument("--diagnostics", action="store_true",
                   help="write diagnostics.json for the best model: Hosmer-"
                        "Lemeshow fit test (binary), feature importance, "
                        "optional bootstrap CIs")
    p.add_argument("--bootstrap-replicates", type=int, default=0,
                   help="bootstrap refits for coefficient CIs (0 disables)")
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--device", default="cuda",
                   help="torch device for the data and the fits (default "
                        "cuda, which raises without a GPU)")
    p.add_argument("--path-screen", default="off",
                   choices=["off", "strong", "safe"],
                   help="pathwise training over the lambda grid with "
                        "KKT-certified feature screening (optimize/path.py); "
                        "the grid is walked in the given order, so list it "
                        "decreasing")
    p.add_argument("--path-kkt-tol", type=float, default=1e-6,
                   help="relative slack of the screened-coordinate KKT "
                        "violation test")
    p.add_argument("--path-max-kkt-rounds", type=int, default=5,
                   help="screen -> solve -> certify rounds per lambda "
                        "before a full-width fallback solve")
    p.add_argument("--path-min-bucket", type=int, default=64,
                   help="floor of the power-of-two restricted width")
    p.add_argument("--streaming", action="store_true",
                   help="keep the training set in host RAM and stream "
                        "fixed-shape chunks through the device each "
                        "optimizer pass")
    p.add_argument("--out-of-core", action="store_true",
                   help="implies --streaming: never materialize the "
                        "training set; each pass re-decodes Avro block "
                        "waves from disk on a background thread. Needs "
                        "--input-format avro and --hash-dim or --index-map; "
                        "no summarization or normalization")
    p.add_argument("--pad-nnz", type=int, default=None,
                   help="fixed per-row feature width incl. intercept for "
                        "--out-of-core (default: one measuring decode pass)")
    p.add_argument("--chunk-rows", type=int, default=1 << 16,
                   help="rows per streamed chunk (--streaming)")
    p.add_argument("--chunk-cache-dir", default=None,
                   help="with --out-of-core: decode-once packed chunk cache "
                        "directory; invalidated when the source files, the "
                        "chunk geometry or the index map change")
    p.add_argument("--chunk-cache-gb", type=float, default=None,
                   help="disk budget for --chunk-cache-dir; a dataset that "
                        "does not fit re-decodes every pass, with a warning")
    p.add_argument("--prefetch-depth", type=int, default=None,
                   help="streamed transfer-ring depth: chunks staged ahead "
                        "of compute (default 2 / PHOTON_PREFETCH_DEPTH; 0 = "
                        "synchronous)")
    p.add_argument("--coordinator-address", default=None,
                   help="HOST:PORT of rank 0's rendezvous: one process per "
                        "device, each started with the same flags")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--auto-resume", action="store_true",
                   help="resume a lambda grid that died on device loss "
                        "(RESUME_GLM.npz marker / exit code 75)")
    p.add_argument("--max-rank-failures", type=int, default=0,
                   help="in-job recovery: retry a lambda fit that died in "
                        "a transient coordinated abort (every rank alive, "
                        "a generic local error) up to this many times, "
                        "with jittered backoff and a re-aligning barrier; "
                        "rank loss, device loss and data errors escalate "
                        "to the --auto-resume whole-job path")
    p.add_argument("--recovery-snapshot-every", type=positive_int,
                   default=1,
                   help="accepted for parity with the GAME training "
                        "driver: the grid's recovery unit is one lambda "
                        "(each finished lambda is persisted to the resume "
                        "marker), so there is no finer unit to select")
    add_trace_args(p)
    return p


def _read(paths, fmt, index_map: Optional[IndexMap], add_intercept):
    """-> (HostSparse, labels, offsets, weights, index_map, intercept_index,
    decoder). Host-side only; device conversion happens after validation.
    ``decoder`` names what decoded the records: "native" or "python" for
    Avro, "libsvm" for LIBSVM text."""
    if fmt == "libsvm":
        # read raw (no intercept) so multiple files share one feature space,
        # then append the intercept column at the common dim
        parts = [read_libsvm(p) for p in paths]
        # an index_map (from the training pass) pins the feature space, so
        # validation files line up with the trained model: features beyond it
        # are dropped, missing ones stay implicit zeros
        if index_map is not None:
            base_dim = index_map.size - (
                1 if index_map.intercept_index >= 0 else 0
            )
            for sp, _, _ in parts:
                drop = sp.indices >= base_dim
                sp.indices[drop] = 0
                sp.values[drop] = 0.0
        else:
            base_dim = max(sp.dim for sp, _, _ in parts)
        intercept = base_dim if add_intercept else -1
        dim = base_dim + (1 if add_intercept else 0)
        k = max(sp.values.shape[1] for sp, _, _ in parts) + (
            1 if add_intercept else 0
        )
        n = sum(sp.num_rows for sp, _, _ in parts)
        indices = np.zeros((n, k), np.int32)
        values = np.zeros((n, k))
        at = 0
        for sp, _, _ in parts:
            m, kk = sp.values.shape
            indices[at:at + m, :kk] = sp.indices
            values[at:at + m, :kk] = sp.values
            if add_intercept:
                indices[at:at + m, kk] = intercept
                values[at:at + m, kk] = 1.0
            at += m
        labels = np.concatenate([lab for _, lab, _ in parts])
        feats = HostSparse(indices, values, dim)
        if index_map is None:
            entries = {f"f{i}": i for i in range(base_dim)}
            if intercept >= 0:
                entries["(INTERCEPT)"] = intercept
            index_map = IndexMap(entries)
        return (feats, labels, np.zeros(n), np.ones(n), index_map, intercept,
                "libsvm")
    (feats, labels, offsets, weights, _, _), decoder = \
        decode_training_examples(paths, index_map)
    return (feats["global"], labels, offsets, weights, index_map,
            index_map.intercept_index, decoder)


def _device_batch(host: HostSparse, labels, offsets, weights, dtype, dev):
    feats = SparseFeatures(torch.from_numpy(host.indices),
                           torch.from_numpy(host.values), dim=host.dim)
    return make_batch(feats, labels, offsets, weights, dtype=dtype,
                      device=dev)


def main(argv: Sequence[str] | None = None) -> int:
    args = build_arg_parser().parse_args(argv)
    with traced(args):
        return _run(args)


def _run(args) -> int:
    dev = resolve_device(args.device)
    distributed = start_processes(args, dev.type)
    try:
        return _train(args, dev, distributed)
    finally:
        stop_processes(distributed)


def _train(args, dev: torch.device, distributed: bool) -> int:
    mesh = None
    if distributed:
        mesh = make_mesh({"data": process_count()}, device_type=dev.type)
        dev = mesh_device(mesh)
    lead = is_lead()
    dtype = resolve_dtype(args.dtype)
    task = TASK_TO_LOSS.get(args.task, args.task)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = PhotonLogger(log_path(args.output_dir))
    logger.log("driver_start", driver="glm", args=vars(args),
               distributed=distributed, **runtime_info(dev))

    reg = RegularizationContext(args.reg_type, alpha=args.elastic_net_alpha)
    optimizer = args.optimizer
    if reg.needs_owlqn and optimizer != "owlqn":
        logger.log("optimizer_override", requested=optimizer, used="owlqn",
                   reason=f"reg_type={args.reg_type} needs OWL-QN")
        optimizer = "owlqn"

    if args.path_screen != "off" \
            and NormalizationType(args.normalization) != NormalizationType.NONE:
        raise SystemExit(
            "--path-screen does not compose with --normalization: the "
            "virtual shift couples every column through the margin "
            "adjustment, so a frozen column would still move the margins "
            "(optimize/path.py). Normalize the data on disk or drop one "
            "of the flags")

    out_of_core = args.out_of_core
    if args.chunk_cache_dir and not out_of_core:
        raise SystemExit("--chunk-cache-dir requires --out-of-core (the "
                         "in-RAM streaming path never re-decodes)")
    if args.chunk_cache_gb is not None and not args.chunk_cache_dir:
        raise SystemExit("--chunk-cache-gb requires --chunk-cache-dir")
    if out_of_core:
        if args.input_format != "avro":
            raise SystemExit("--out-of-core requires --input-format avro")
        if not (args.hash_dim or args.index_map):
            raise SystemExit(
                "--out-of-core needs a pinned feature space (--hash-dim or "
                "--index-map): building an index map would scan the full "
                "dataset — run the feature indexing driver first")
        if args.summarize_features or NormalizationType(args.normalization) != NormalizationType.NONE:
            raise SystemExit("--out-of-core cannot summarize/normalize: "
                             "no resident data to scan")

    # -- stage: read + index -------------------------------------------------
    with Timed(logger, "read_train_data"):
        index_map = None
        if args.input_format == "avro":
            if args.hash_dim:
                from photon_ml_tpu_torch.io.hashing import HashingIndexMap

                index_map = HashingIndexMap(args.hash_dim,
                                            add_intercept=args.add_intercept)
            elif args.index_map:
                from photon_ml_tpu_torch.io.paldb import load_index_map

                index_map = load_index_map(args.index_map)
            else:
                index_map = build_index_map(
                    iter_avro_records(args.train_data),
                    add_intercept=args.add_intercept,
                    min_count=args.min_feature_count,
                )
        if out_of_core:
            # multi-process: each process keeps its own block share
            src = AvroChunkSource(
                args.train_data, index_map, chunk_rows=args.chunk_rows,
                pad_nnz=args.pad_nnz,
                dtype=torch.empty((), dtype=dtype).numpy().dtype,
                process_part=((process_index(), process_count())
                              if distributed else None))
            if args.chunk_cache_dir:
                src = ChunkCacheSource(
                    src, args.chunk_cache_dir,
                    max_bytes=(None if args.chunk_cache_gb is None
                               else int(args.chunk_cache_gb * 1e9)))
            host_feats = labels = offsets = weights = None
            intercept_index = index_map.intercept_index
            decoder = src.decoder
        else:
            (host_feats, labels, offsets, weights, index_map,
             intercept_index, decoder) = _read(
                args.train_data, args.input_format, index_map,
                args.add_intercept
            )
    validation = None
    if args.validation_data:
        with Timed(logger, "read_validation_data"):
            vhost, vlabels, voffsets, vweights, _, _, _ = _read(
                args.validation_data, args.input_format, index_map,
                args.add_intercept,
            )
            validation = (vhost, vlabels, voffsets, vweights)
    logger.log("data_read",
               num_train=(src.rows if out_of_core else int(labels.shape[0])),
               num_validation=0 if validation is None else int(vlabels.shape[0]),
               num_features=(index_map.size if out_of_core
                             else host_feats.dim), decoder=decoder)

    # -- stage: validate (on host, before any device transfer) ---------------
    if args.validate_data:
        with Timed(logger, "validate_data"):
            if out_of_core:
                # no resident training data to scan: the source raises on
                # unlabeled or malformed records as it decodes them
                logger.log("validate_skipped_out_of_core")
            else:
                validate_training_data(host_feats, labels, offsets, weights,
                                       task=task)
            if validation is not None:
                validate_training_data(vhost, vlabels, voffsets, vweights,
                                       task=task)

    # -- stage: summarize + normalization ------------------------------------
    streaming = args.streaming or out_of_core
    dim = index_map.size if out_of_core else host_feats.dim
    fit_batch = None
    if out_of_core:
        chunks, batch = src, None
    elif streaming:
        # the training set stays in host RAM; only fixed-shape chunks ever
        # reach the device, each process streaming its own row span
        s0, s1 = process_span(labels.shape[0])
        local = HostSparse(host_feats.indices[s0:s1],
                           host_feats.values[s0:s1], host_feats.dim)
        chunks, _ = make_host_chunks(local, labels[s0:s1], offsets[s0:s1],
                                     weights[s0:s1],
                                     chunk_rows=args.chunk_rows)
        batch = LabeledBatch(host_feats, labels, offsets, weights)
    elif distributed:
        # every process holds the whole batch on the host and fits on its
        # own row block on its device
        batch = _device_batch(host_feats, labels, offsets, weights, dtype,
                              torch.device("cpu"))
        fit_batch = shard_batch(batch, mesh)
    else:
        batch = fit_batch = _device_batch(host_feats, labels, offsets,
                                          weights, dtype, dev)
    validation_batch = None
    if validation is not None:
        validation_batch = _device_batch(vhost, vlabels, voffsets, vweights,
                                         dtype, dev)
    norm_type = NormalizationType(args.normalization)
    normalization = None
    if norm_type != NormalizationType.NONE or args.summarize_features:
        with Timed(logger, "feature_summarization"):
            summary = summarize_features(batch)
            if args.summarize_features and lead:
                write_feature_summary(args.output_dir, summary, index_map)
            if norm_type != NormalizationType.NONE:
                normalization = build_normalization_context(
                    norm_type, summary, intercept_index=intercept_index,
                    dtype=dtype, device=dev,
                )

    objective = make_objective(task, normalization=normalization,
                               intercept_index=intercept_index)
    opt_config = OptimizerConfig(max_iters=args.max_iters,
                                 tolerance=args.tolerance)

    evaluators = args.evaluators
    if evaluators is None:
        evaluators = [TASK_DEFAULT_EVALUATOR[task]] if validation is not None else []

    # -- stage: train over the lambda grid with warm start -------------------
    # lambda-granular device-loss recovery: every finished lambda's host
    # result is persisted on device loss, and a rerun with --auto-resume
    # replays them and resumes the warm-start chain at the first unfinished
    # lambda. The marker is kept until the grid completes and is
    # fingerprinted against the inputs: restored metrics were computed on
    # the crashed run's validation set, so a rerun on other data refuses
    resume = ResumeManager(
        os.path.join(args.output_dir, "RESUME_GLM.npz"),
        fingerprint={
            "train_data": sorted(args.train_data),
            "validation_data": (sorted(args.validation_data)
                                if args.validation_data else None),
            "validation_rows": (None if validation is None
                                else int(vlabels.shape[0])),
            # a resumed path must re-screen the tail as the crashed run
            # would have
            "path_screen": args.path_screen,
        },
        is_lead=lead)
    results = []
    # the marker's host copy of each finished lambda, taken when it
    # finishes: after a sticky CUDA error every later read from the card
    # fails, so the device-loss path must not touch it
    entries = []
    w = torch.zeros((dim,), dtype=dtype, device=dev)
    if args.auto_resume and resume.exists():
        # the driver's own compatibility checks first (their messages name
        # the mismatch), then the input fingerprint
        saved = resume.load(verify=False)
        saved_lams = [e["lam"] for e in saved["entries"]]
        if saved_lams != list(args.reg_weights[: len(saved_lams)]):
            raise ValueError(
                f"RESUME_GLM.npz holds lambdas {saved_lams} which are not a "
                f"prefix of --reg-weights {list(args.reg_weights)}; refusing "
                "to mix grids: rerun with the original grid or delete the "
                "marker")
        if validation is not None and evaluators and any(
                evaluators[0] not in (e["metrics"] or {})
                for e in saved["entries"]):
            raise ValueError(
                "RESUME_GLM.npz entries lack the current evaluator "
                f"{evaluators[0]!r} (the crashed run had different "
                "validation settings); rerun with the original settings or "
                "delete the marker")
        resume.verify(saved)  # refuse changed train/validation inputs
        for e in saved["entries"]:
            res_like = SimpleNamespace(**e["res"])
            res_like.w = torch.as_tensor(res_like.w, device=dev).to(dtype)
            variances = (None if e["variances"] is None else torch.as_tensor(
                e["variances"], device=dev).to(dtype))
            results.append((e["lam"], res_like, e["metrics"], variances))
            entries.append(e)
        w = torch.as_tensor(saved["last_w"], device=dev).to(dtype)
        logger.log("auto_resume", completed_lambdas=len(results))

    def device_lost(err, **where) -> int:
        resume.save({
            "entries": entries,
            "last_w": (entries[-1]["res"]["w"] if entries
                       else np.zeros((dim,))),
            "error": str(err).split("\n")[0],
        })
        logger.log("device_lost", error=str(err).split("\n")[0],
                   completed_lambdas=len(results), **where)
        logger.close()
        print(f"device lost; {len(results)} finished lambdas persisted to "
              f"{resume.path} (rerun with --auto-resume)", file=sys.stderr)
        return 75

    # the column sort behind the csc gradient paths is paid once for the
    # whole lambda grid, not per fit
    grid_csc = None
    if not streaming:
        sparse_grad = resolve_sparse_grad("auto", batch.features)
        if sparse_grad.startswith("csc"):
            grid_csc = build_csc(fit_batch,
                                 with_cols=sparse_grad == "csc_segment")

    path_solver = None
    if args.path_screen != "off":
        pcfg = PathConfig(screen=args.path_screen,
                          kkt_tol=args.path_kkt_tol,
                          max_kkt_rounds=args.path_max_kkt_rounds,
                          min_bucket=args.path_min_bucket)
        if streaming:
            # the restricted passes stream the same chunk sequence (with
            # a chunk cache underneath, the whole path is one decode)
            path_solver = PathSolver(
                objective, reg, chunks=chunks, dim=dim, optimizer=optimizer,
                config=opt_config, path_config=pcfg, dtype=dtype,
                prefetch_depth=args.prefetch_depth, device=dev)
        else:
            path_solver = PathSolver(
                objective, reg, batch=batch, optimizer=optimizer,
                config=opt_config, path_config=pcfg,
                precomputed_csc=grid_csc, mesh=mesh)
        # a resumed path is seeded with the replayed solutions (gradients
        # recomputed on first use), so the resumed tail screens as the
        # uninterrupted run would
        for lam_done, res_done, _m, _v in results:
            path_solver.seed_state(lam_done, res_done.w)

    try:
        with Timed(logger, "training"), profile_trace(args.profile_dir):
            for li in range(len(results), len(args.reg_weights)):
                lam = args.reg_weights[li]
                # per-lambda injection point: kill-and-rerun tests drive
                # the device-loss resume path through here
                fault_injection.check("glm.lambda")
                run_config = opt_config
                if args.solver_tol_schedule is not None:
                    run_config = dataclasses.replace(
                        opt_config,
                        tolerance=args.solver_tol_schedule.at(
                            li, args.tolerance))
                path_stats = [None]

                def fit_lambda(lam=lam, run_config=run_config):
                    if path_solver is not None:
                        res_, path_stats[0] = path_solver.solve(
                            lam, tolerance=run_config.tolerance)
                        return res_
                    if streaming:
                        return fit_streaming(
                            objective, chunks, dim, w0=w,
                            l2=reg.l2_weight(lam), l1=reg.l1_weight(lam),
                            optimizer=optimizer, config=run_config,
                            dtype=dtype, prefetch_depth=args.prefetch_depth,
                            device=dev)
                    return fit_shard(
                        objective, fit_batch, w,
                        l2=reg.l2_weight(lam), l1=reg.l1_weight(lam),
                        optimizer=optimizer, config=run_config,
                        precomputed_csc=grid_csc, mesh=mesh,
                    )

                spent = (None if path_solver is None else
                         (path_solver.kernel_launches,
                          path_solver.host_reads))
                if args.max_rank_failures > 0:
                    # a transient coordinated abort (every rank alive)
                    # re-runs this lambda from the same warm start; anything
                    # else reaches the device-loss handling below
                    res = retry_collective(
                        fit_lambda, max_retries=args.max_rank_failures,
                        tag=f"glm.lambda_retry:{li}")
                else:
                    res = fit_lambda()
                # every fit records the tolerance it solved to and the width
                # it solved over, so the lambda log and the resume marker
                # always carry both
                if res.solver_tolerance is None:
                    res = res._replace(
                        solver_tolerance=float(run_config.tolerance))
                if res.screened_dim is None:
                    res = res._replace(screened_dim=int(dim))
                w = res.w  # warm start the next lambda
                loss_history = res.loss_history.cpu().numpy()
                diag = {
                    "reg_weight": lam,
                    "solver_tolerance": float(res.solver_tolerance),
                    "screened_dim": int(res.screened_dim),
                    "loss": float(res.value),
                    "grad_norm": float(res.grad_norm),
                    "iterations": int(res.iterations),
                    "converged": bool(res.converged),
                    "loss_history": [
                        float(v) for v in loss_history if np.isfinite(v)
                    ],
                }
                # what the lambda cost the card: transpose-kernel
                # launches and device-to-host reads (the path solver's
                # include its screening passes)
                if spent is not None:
                    diag["kernel_launches"] = \
                        path_solver.kernel_launches - spent[0]
                    diag["host_reads"] = path_solver.host_reads - spent[1]
                else:
                    diag["host_reads"] = int(res.host_syncs)
                    if res.kernel_launches is not None:
                        diag["kernel_launches"] = res.kernel_launches
                if res.stream_stats is not None:
                    # this lambda's decode-wait / transfer / compute-stall
                    # seconds over its whole pass sequence
                    diag["stream"] = res.stream_stats
                if path_stats[0] is not None:
                    diag["path"] = path_stats[0].as_dict()
                metrics = {}
                if validation_batch is not None and evaluators:
                    scores = objective.margins(
                        res.w, validation_batch).cpu().numpy()
                    for name in evaluators:
                        metrics[name] = get_evaluator(name).evaluate(
                            scores, vlabels, vweights
                        )
                    diag["metrics"] = metrics
                variances = None
                if args.compute_variances:
                    if streaming:
                        variances = streaming_coefficient_variances(
                            objective, chunks, dim, res.w,
                            l2=reg.l2_weight(lam), dtype=dtype,
                            prefetch_depth=args.prefetch_depth, device=dev)
                    else:
                        variances = distributed_coefficient_variances(
                            objective, mesh=mesh)(res.w, fit_batch,
                                                  reg.l2_weight(lam))
                results.append((lam, res, metrics, variances))
                entries.append({
                    "lam": lam,
                    # the native dtype: a resumed float64 run must
                    # reproduce the uninterrupted one
                    "res": {"w": res.w.cpu().numpy(),
                            "value": float(res.value),
                            "grad_norm": float(res.grad_norm),
                            "iterations": int(res.iterations),
                            "converged": bool(res.converged),
                            "solver_tolerance": res.solver_tolerance,
                            "screened_dim": res.screened_dim,
                            "loss_history": loss_history},
                    "metrics": metrics,
                    "variances": (None if variances is None
                                  else variances.cpu().numpy()),
                })
                logger.log("lambda_trained", **diag)
    except Exception as e:
        if not is_device_loss(e):
            raise
        return device_lost(e)

    try:
        # -- stage: validate + select best -----------------------------------
        best_i = 0
        if validation is not None and evaluators:
            ev = get_evaluator(evaluators[0])
            for i in range(1, len(results)):
                if ev.better(results[i][2][evaluators[0]],
                             results[best_i][2][evaluators[0]]):
                    best_i = i

        if args.diagnostics and lead:
            lam_best, res_best, _, _ = results[best_i]
            report = {"reg_weight": lam_best}
            inverse = index_map.inverse()
            summary_std = None
            if norm_type != NormalizationType.NONE or args.summarize_features:
                summary_std = np.zeros(dim)
                summary_std[:summary.dim] = summary.std
            imp = diagnostics.feature_importance(res_best.w.cpu().numpy(),
                                                 summary_std, top_k=50)
            report["feature_importance"] = [
                {"feature": inverse.get(int(i), str(int(i))),
                 "score": float(s)}
                for i, s in zip(imp["index"], imp["score"])
            ]
            if validation_batch is not None and task in ("logistic",
                                                         "smoothed_hinge"):
                probs = objective.loss.mean(
                    objective.margins(res_best.w, validation_batch)
                ).cpu().numpy()
                report["hosmer_lemeshow"] = diagnostics.hosmer_lemeshow(
                    probs, vlabels)
            if args.bootstrap_replicates > 0 and not streaming:
                with Timed(logger, "bootstrap"):
                    boot_batch = (batch if not distributed
                                  else _device_batch(host_feats, labels,
                                                     offsets, weights, dtype,
                                                     dev))
                    boot = diagnostics.bootstrap_coefficients(
                        objective, boot_batch, res_best.w,
                        l2=reg.l2_weight(lam_best),
                        n_replicates=args.bootstrap_replicates,
                    )
                report["bootstrap"] = {
                    "replicates": args.bootstrap_replicates,
                    "std": boot["std"].tolist(),
                    "lower": boot["lower"].tolist(),
                    "upper": boot["upper"].tolist(),
                }
            with open(os.path.join(args.output_dir, "diagnostics.json"),
                      "w") as f:
                json.dump(report, f, indent=2)
            logger.log("diagnostics_written",
                       hosmer_lemeshow=report.get("hosmer_lemeshow"))

        # -- stage: model output --------------------------------------------
        # every process reaches the same models; only the lead writes them
        with Timed(logger, "save_models"):
            for i, (lam, res, metrics, variances) in enumerate(
                    results if lead else ()):
                model = GameModel(
                    {"global": FixedEffectModel(
                        GeneralizedLinearModel(
                            Coefficients(res.w, variances), task=task
                        )
                    )},
                    task=task,
                )
                every = os.path.join("all", f"lambda-{lam:g}")
                out = os.path.join(args.output_dir,
                                   "best" if i == best_i else every)
                save_game_model(model, out, index_map)
                if i == best_i and len(results) > 1:
                    save_game_model(
                        model, os.path.join(args.output_dir, every),
                        index_map)
    except Exception as e:
        if not is_device_loss(e):
            raise
        return device_lost(e, stage="post_grid")

    # outputs are published: ANY completed grid consumes the marker, so a
    # later --auto-resume cannot replay stale results
    resume.consume()
    logger.log("driver_done", best_reg_weight=results[best_i][0],
               best_metrics=results[best_i][2] or None)
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
