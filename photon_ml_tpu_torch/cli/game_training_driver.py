"""GAME training driver: the end-to-end training entry point (counterpart of
``photon_ml_tpu/cli/game_training_driver.py``).

Equivalent of the reference's ``cli.game.training.GameTrainingDriver``
(SURVEY.md §4.1): parse params, build or load feature index maps, read Avro
training data, optionally normalize, train a GAME model per
optimization-config grid point with validation tracking, optionally tune
the regularization weights (``tuning/``), select the best by the primary
evaluator, save best + all models (Avro), and write a structured log. Warm
start, locked coordinates (partial retrain) and per-iteration checkpoints
are supported. The output tree and the events and keys of
``photon.log.jsonl`` are the JAX driver's, so either package's tooling
reads the other's runs, and a model saved here loads there.

The fits run on ``--device`` (default ``cuda``, which raises without a
GPU; ``--device cpu`` runs everything on the CPU) through
``estimators.GameEstimator``: every gradient of a fixed coordinate's
sparse fits goes through ``ops.kernels``'s ``csc_column_sums`` (the
hand-written CUDA kernel on the card, its plain version on the CPU), the
random coordinates through the batched solvers of ``optimize/batched.py``.

``--streaming`` keeps each fixed coordinate's shard in host RAM and
streams it through the device in chunks of ``--chunk-rows`` rows on every
pass; ``--out-of-core-shards`` never materializes the named shards,
re-decoding them from disk each pass (or once, with ``--chunk-cache-dir``).

``--coordinator-address HOST:PORT --num-processes N --process-id I`` runs
one process per device, as the JAX driver does: every process reads the
data and trains the same model; a streamed fixed coordinate streams each
process's row span (``--out-of-core-shards``: its
``AvroChunkSource(process_part=)`` share) with its partials summed across
processes, a streamed summary reduces its moments across processes, and
only rank 0 writes the models, checkpoints and feature summaries.

``--entity-shards N`` (N must be the process count) partitions every
random coordinate's entities across the processes by a stable hash, each
process building and solving only its own, and ``--re-table-budget-mb``
fails a coordinate whose local table is over budget before any sweep.
``--max-rank-failures N`` turns on in-job recovery: a committed snapshot
under ``<output-dir>/recovery`` every ``--recovery-snapshot-every`` sweeps,
and a coordinated abort rolls the sweep back instead of ending the job
(``parallel/recovery.py``; a lost rank escalates on the production
transport, which cannot shrink). Device loss (``utils.is_device_loss``)
with ``--checkpoint`` writes ``RESUME.json``, pointing at the newest
checkpoint, and exits 75; the same command with ``--auto-resume`` adopts
that checkpoint as its warm start. The marker is fingerprinted against the
inputs and consumed only when a run completes.

``--trace-dir`` (or ``PHOTON_TRACE``) writes the run's trace spans, one
``trace-rankN.json`` per process, ``--trace-sample`` the fraction of
traces kept; ``--profile-dir`` a ``torch.profiler`` trace of training.
``--publish-to`` publishes the best model into a model registry
(``registry/``) after saving it; the first publish into an empty registry
also sets ``LATEST``.

Usage:
    python -m photon_ml_tpu_torch.cli.game_training_driver \\
        --train-data data/train.avro --validation-data data/val.avro \\
        --output-dir out/ --task logistic_regression \\
        --coordinates configs/coordinates.json --evaluators auc \\
        --n-iterations 3

The coordinate config JSON is a list of dicts matching CoordinateConfig
fields; ``reg_weight`` may be a list to define a grid (cross-product over
coordinates is expanded).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import re
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.cli._common import (
    add_trace_args, json_arg, load_input_columns, log_path,
    positive_int, runtime_info, start_processes, stop_processes,
    tol_schedule, traced, write_feature_summary,
)
from photon_ml_tpu_torch.estimators import GameEstimator
from photon_ml_tpu_torch.evaluation.evaluators import TASK_DEFAULT_EVALUATOR
from photon_ml_tpu_torch.game.descent import CoordinateConfig, GameDataset
from photon_ml_tpu_torch.io.avro import iter_avro_records
from photon_ml_tpu_torch.io.chunk_cache import ChunkCacheSource
from photon_ml_tpu_torch.io.data_reader import read_training_examples
from photon_ml_tpu_torch.io.index_map import (
    IndexMap, build_index_map, filter_index_map,
)
from photon_ml_tpu_torch.io.model_io import load_game_model, save_game_model
from photon_ml_tpu_torch.io.stream_source import AvroChunkSource
from photon_ml_tpu_torch.ops.losses import TASK_TO_LOSS
from photon_ml_tpu_torch.ops.normalization import (
    NormalizationType, build_normalization_context,
)
from photon_ml_tpu_torch.ops.statistics import (
    summarize_features, summarize_features_streamed,
)
from photon_ml_tpu_torch.parallel import resilience
from photon_ml_tpu_torch.parallel.entity_shard import EntityShardSpec
from photon_ml_tpu_torch.parallel.multihost import (
    allreduce_summary_moments, process_count, process_index,
)
from photon_ml_tpu_torch.parallel.recovery import RecoveryManager
from photon_ml_tpu_torch.types import SparseFeatures, make_batch, resolve_device
from photon_ml_tpu_torch.utils import (
    PhotonLogger, Timed, is_device_loss, profile_trace, resolve_dtype,
)

def _finite_nonneg_float(value: str) -> float:
    x = float(value)
    if not np.isfinite(x) or x < 0:
        raise argparse.ArgumentTypeError(
            f"expected a finite float >= 0, got {value!r}")
    return x


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GAME training driver "
                                            "(PyTorch port)")
    p.add_argument("--train-data", required=True, nargs="+",
                   help="Avro file(s)/dir(s) of TrainingExampleAvro records")
    p.add_argument("--validation-data", nargs="+", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--task", default="logistic_regression",
                   choices=sorted(TASK_TO_LOSS) + sorted(set(TASK_TO_LOSS.values())))
    p.add_argument("--coordinates", required=True,
                   help="path to coordinate-config JSON, or inline JSON")
    p.add_argument("--evaluators", nargs="*", default=None)
    p.add_argument("--n-iterations", type=int, default=1)
    p.add_argument("--cd-tolerance", type=_finite_nonneg_float, default=0.0,
                   help="sweep-level early exit: stop once every "
                        "coordinate's score vector moved by at most this "
                        "(max-abs) over a whole sweep; 0 disables (exactly "
                        "--n-iterations sweeps run)")
    p.add_argument("--re-active-set", action="store_true", default=None,
                   help="active-set coordinate descent for random effects "
                        "(the CoordinateConfig default): converged "
                        "entities whose coefficients stopped moving are "
                        "frozen and later sweeps solve only the "
                        "unconverged frontier")
    p.add_argument("--no-re-active-set", dest="re_active_set",
                   action="store_false",
                   help="re-solve every entity every sweep (the exact "
                        "fixed-sweep schedule)")
    p.add_argument("--re-refresh-every", type=positive_int, default=None,
                   help="with the active set: every K-th sweep is a full "
                        "refresh that re-solves frozen entities too")
    p.add_argument("--solver-tol-schedule", type=tol_schedule, default=None,
                   metavar="START:DECAY",
                   help="inexact-CD inner-solve tolerance schedule: sweep "
                        "k solves to max(coordinate tolerance, START * "
                        "DECAY^k) (e.g. 1e-3:0.1; 'off' disables)")
    p.add_argument("--index-map", default=None,
                   help="prebuilt index map (JSON, native store, or hashing "
                        "config; else built from data)")
    p.add_argument("--hash-dim", type=int, default=None,
                   help="feature-hash into this width instead of building an "
                        "index map (collisions accepted)")
    p.add_argument("--feature-shards", default=None,
                   help="JSON (inline or path): shard name -> list of feature-"
                        "name prefixes (per-shard feature bags); shards not "
                        "listed get all features")
    p.add_argument("--min-feature-count", type=int, default=1)
    p.add_argument("--input-columns", default=None,
                   help="JSON (inline or path) remapping record field names "
                        "(response/offset/weight/uid/features/metadata_map)")
    p.add_argument("--add-intercept", action="store_true", default=True)
    p.add_argument("--no-intercept", dest="add_intercept", action="store_false")
    p.add_argument("--normalization", default="none",
                   choices=[t.value for t in NormalizationType])
    p.add_argument("--warm-start-model", default=None,
                   help="model dir to warm start from")
    p.add_argument("--locked-coordinates", nargs="*", default=(),
                   help="coordinates kept fixed (partial retrain)")
    p.add_argument("--checkpoint", action="store_true",
                   help="save the model after each outer CD iteration")
    p.add_argument("--save-all-models", action="store_true")
    p.add_argument("--summarize-features", action="store_true",
                   help="write FeatureSummarizationResultAvro output")
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--device", default="cuda",
                   help="torch device for the fits (default cuda, which "
                        "raises without a GPU)")
    p.add_argument("--tuning-mode", default="none",
                   choices=["none", "random", "bayesian"],
                   help="auto-tune reg weights after the grid (SURVEY.md §4.5)")
    p.add_argument("--tuning-iters", type=int, default=10)
    p.add_argument("--tuning-range", type=float, nargs=2, default=(1e-4, 1e4),
                   metavar=("LOW", "HIGH"),
                   help="log-scale search range for regularization weights")
    p.add_argument("--tuning-coordinates", nargs="*", default=None,
                   help="coordinates whose reg weights are tuned (default: all "
                        "unlocked)")
    p.add_argument("--tuning-seed", type=int, default=0)
    p.add_argument("--streaming", action="store_true",
                   help="fixed-effect coordinates keep their features in "
                        "host RAM; each optimizer pass streams fixed-shape "
                        "chunks through the device")
    p.add_argument("--pad-nnz", type=int, default=None,
                   help="fixed per-row feature width incl. intercept for "
                        "--out-of-core-shards sources (default: one "
                        "measuring decode pass per shard)")
    p.add_argument("--out-of-core-shards", nargs="*", default=(),
                   help="feature shards that never materialize in host "
                        "RAM: their coordinates (streaming fixed effects) "
                        "re-decode Avro block waves from disk every pass. "
                        "Needs --hash-dim or --index-map")
    p.add_argument("--chunk-rows", type=int, default=1 << 16,
                   help="rows per streamed chunk (--streaming)")
    p.add_argument("--chunk-cache-dir", default=None,
                   help="with --out-of-core-shards: decode-once packed "
                        "chunk cache root (one subdirectory per shard)")
    p.add_argument("--chunk-cache-gb", type=float, default=None,
                   help="per-shard disk budget for --chunk-cache-dir")
    p.add_argument("--prefetch-depth", type=int, default=None,
                   help="streamed transfer-ring depth: chunks staged ahead "
                        "of compute (default 2 / PHOTON_PREFETCH_DEPTH; 0 = "
                        "synchronous)")
    p.add_argument("--coordinator-address", default=None,
                   help="HOST:PORT of rank 0's rendezvous: one process per "
                        "device, each started with the same flags")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--entity-shards", type=positive_int, default=None,
                   help="entity-sharded random-effect training: partition "
                        "every random coordinate's entities across this "
                        "many processes by a stable hash of the entity id "
                        "(must equal the process count: shard i lives on "
                        "process i); sweeps exchange only changed rows' "
                        "scores")
    p.add_argument("--re-table-budget-mb", type=float, default=None,
                   help="per-process random-effect entity-table budget in "
                        "MB: a coordinate whose local table exceeds it "
                        "fails before the first sweep, pointing at "
                        "--entity-shards")
    p.add_argument("--auto-resume", action="store_true",
                   help="with --checkpoint: adopt the newest checkpoint as "
                        "the warm start when a prior run died on device "
                        "loss (the RESUME.json marker / exit code 75)")
    p.add_argument("--max-rank-failures", type=int, default=0,
                   help="in-job recovery: roll a sweep back to its "
                        "committed snapshot on a coordinated abort, and "
                        "tolerate up to this many lost ranks on a "
                        "transport that can shrink (the production one "
                        "escalates rank loss to the --auto-resume path); "
                        "0 keeps plain fail-stop")
    p.add_argument("--recovery-snapshot-every", type=positive_int,
                   default=1,
                   help="commit a recovery snapshot every N CD sweeps "
                        "(with --max-rank-failures > 0): a failure rolls "
                        "back at most N sweeps")
    add_trace_args(p)
    p.add_argument("--publish-to", default=None,
                   help="model-registry root (registry/): publish the "
                        "best model there as an immutable version after "
                        "saving. The FIRST publish into an empty "
                        "registry also sets LATEST (bootstrap); later "
                        "versions are promoted through the gate "
                        "(python -m photon_ml_tpu_torch.cli"
                        ".model_publish_driver --gate-data ...)")
    return p


def _load_coordinate_grid(spec: str) -> List[List[CoordinateConfig]]:
    raw = json_arg(spec)
    if not isinstance(raw, list) or not raw:
        raise ValueError("coordinate config must be a non-empty JSON list")
    # expand list-valued reg_weight into a grid (the reference's grid of
    # GameOptimizationConfigurations — SURVEY.md §4.1)
    per_coord_options: List[List[dict]] = []
    for c in raw:
        weights = c.get("reg_weight", 0.0)
        if isinstance(weights, list):
            per_coord_options.append([{**c, "reg_weight": w} for w in weights])
        else:
            per_coord_options.append([c])
    return [[CoordinateConfig(**c) for c in combo]
            for combo in itertools.product(*per_coord_options)]


def _entity_columns(grid) -> List[str]:
    cols = []
    for cfg in grid[0]:
        if cfg.coordinate_type == "random" and cfg.entity_column not in cols:
            cols.append(cfg.entity_column)
    return cols


def _read_dataset(paths, index_maps, entity_columns, columns=None) -> GameDataset:
    feats, labels, offsets, weights, ents, _ = read_training_examples(
        paths, index_maps, entity_columns=entity_columns, columns=columns
    )
    return GameDataset(feats, labels, weights, offsets, ents, None)


def _summarize_resident(sp, labels, dev):
    # float32 features, whatever --dtype: the JAX driver summarizes its
    # default-dtype batch (the moments are accumulated in float64 on the
    # host either way)
    feats = SparseFeatures(
        torch.from_numpy(sp.indices),
        None if sp.values is None else torch.from_numpy(sp.values),
        dim=sp.dim)
    return summarize_features(make_batch(feats, labels, device=dev))


def _check_out_of_core(args, grid, shards, ooc_shards) -> Dict[str, int]:
    """Argv-only checks of the out-of-core flags, before any data is read;
    returns each disk-backed shard's chunk rows (the smallest of the
    coordinates that read it)."""
    if args.chunk_cache_dir and not ooc_shards:
        raise SystemExit("--chunk-cache-dir requires --out-of-core-shards "
                         "(only disk-backed shards re-decode per pass)")
    if args.chunk_cache_gb is not None and not args.chunk_cache_dir:
        raise SystemExit("--chunk-cache-gb requires --chunk-cache-dir")
    if not ooc_shards:
        return {}
    unknown = ooc_shards - set(shards)
    if unknown:
        raise SystemExit(f"--out-of-core-shards: {sorted(unknown)} not "
                         f"used by any coordinate (shards: {sorted(shards)})")
    if not (args.hash_dim or args.index_map):
        raise SystemExit("--out-of-core-shards needs a pinned feature "
                         "space (--hash-dim or --index-map): building "
                         "an index map scans the full dataset")
    # only streaming FIXED coordinates can consume a disk-backed shard; a
    # random coordinate's data layer needs resident features
    chunk_rows: Dict[str, int] = {}
    for cfg in grid[0]:
        if cfg.feature_shard not in ooc_shards:
            continue
        if cfg.coordinate_type != "fixed" or not cfg.streaming:
            raise SystemExit(
                f"--out-of-core-shards: shard '{cfg.feature_shard}' is "
                f"used by coordinate '{cfg.name}' ({cfg.coordinate_type}"
                f"{'' if cfg.streaming else ', streaming=false'}) — only "
                "streaming fixed-effect coordinates can train from a "
                "disk-backed shard")
        chunk_rows[cfg.feature_shard] = min(
            cfg.chunk_rows,
            chunk_rows.get(cfg.feature_shard, cfg.chunk_rows))
    return chunk_rows


def _out_of_core_sources(args, index_maps, ooc_shards, chunk_rows, columns,
                         dtype, part=None) -> Dict[str, object]:
    """One disk-backed chunk source per out-of-core shard, behind a
    decode-once cache with ``--chunk-cache-dir`` (the first streamed pass,
    the summarization or the first fit pass, pays the decode). ``part``:
    this process's ``(index, count)`` block share, or None."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    sources = {
        s: AvroChunkSource(args.train_data, index_maps[s],
                           chunk_rows=chunk_rows.get(s, args.chunk_rows),
                           columns=columns, pad_nnz=args.pad_nnz,
                           dtype=np_dtype, process_part=part)
        for s in sorted(ooc_shards)}
    if args.chunk_cache_dir:
        cache_bytes = (None if args.chunk_cache_gb is None
                       else int(args.chunk_cache_gb * 1e9))
        sources = {s: ChunkCacheSource(src, os.path.join(
                       args.chunk_cache_dir, s), max_bytes=cache_bytes)
                   for s, src in sources.items()}
    return sources


def main(argv: Sequence[str] | None = None) -> int:
    args = build_arg_parser().parse_args(argv)
    with traced(args):
        return _run(args)


def _build_index_maps(args, columns, shards) -> Dict[str, IndexMap]:
    if args.hash_dim:
        from photon_ml_tpu_torch.io.hashing import HashingIndexMap

        base_map = HashingIndexMap(args.hash_dim,
                                   add_intercept=args.add_intercept)
    elif args.index_map:
        from photon_ml_tpu_torch.io.paldb import load_index_map

        base_map = load_index_map(args.index_map)
    else:
        base_map = build_index_map(
            iter_avro_records(args.train_data),
            add_intercept=args.add_intercept,
            min_count=args.min_feature_count,
            features_field=columns.features,
        )
    shard_defs = json_arg(args.feature_shards) if args.feature_shards else {}
    if args.hash_dim and any(s in shard_defs for s in shards):
        raise SystemExit(
            "--hash-dim cannot be combined with feature-shard prefix "
            "filtering (a hashing map has no enumerable features); "
            "give each shard its own driver run or drop --hash-dim")
    return {s: (filter_index_map(base_map, shard_defs[s],
                                 add_intercept=args.add_intercept)
                if s in shard_defs else base_map)
            for s in shards}


def _run(args) -> int:
    dev = resolve_device(args.device)
    distributed = start_processes(args, dev.type)
    try:
        return _train(args, dev, distributed)
    finally:
        stop_processes(distributed)


def _train(args, dev: torch.device, distributed: bool) -> int:
    # the transport's rank: the world's in a real run, the simulated
    # process's under testing.run_simulated_processes
    lead = resilience.current_process_index() == 0
    # entity sharding is checked here, before any data is read: the owner
    # map puts entity shard i on process i
    entity_spec = None
    if args.entity_shards is not None:
        pc = resilience.current_transport().process_count()
        if args.entity_shards != pc:
            raise SystemExit(
                f"--entity-shards {args.entity_shards} must equal the "
                f"process count ({pc}): the owner map assigns entity shard "
                "i to process i (run one process per shard with "
                "--coordinator-address/--num-processes)")
        entity_spec = EntityShardSpec(args.entity_shards,
                                      resilience.current_process_index())
    re_table_budget = (None if args.re_table_budget_mb is None
                       else int(args.re_table_budget_mb * 1e6))
    dtype = resolve_dtype(args.dtype)
    task = TASK_TO_LOSS.get(args.task, args.task)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = PhotonLogger(log_path(args.output_dir))
    logger.log("driver_start", driver="game_training", args=vars(args),
               distributed=distributed, **runtime_info(dev))

    columns = load_input_columns(args.input_columns)
    grid = _load_coordinate_grid(args.coordinates)
    fixed_overrides = {}
    if args.streaming:
        fixed_overrides.update(streaming=True, chunk_rows=args.chunk_rows)
    if args.prefetch_depth is not None:
        fixed_overrides["prefetch_depth"] = args.prefetch_depth
    if fixed_overrides:
        grid = [[dataclasses.replace(cfg, **fixed_overrides)
                 if cfg.coordinate_type == "fixed" else cfg
                 for cfg in configs]
                for configs in grid]
    re_overrides = {
        k: v for k, v in (("active_set", args.re_active_set),
                          ("refresh_every", args.re_refresh_every))
        if v is not None
    }
    if re_overrides:  # apply to every random coordinate across the grid
        grid = [[dataclasses.replace(cfg, **re_overrides)
                 if cfg.coordinate_type == "random" else cfg
                 for cfg in configs]
                for configs in grid]
    shards = sorted({cfg.feature_shard for cfg in grid[0]})
    entity_columns = _entity_columns(grid)

    # fail fast on bad tuning flags — tuning runs AFTER the (possibly long)
    # grid training, so catching these there would waste the whole run
    tuned_coords = None
    if args.tuning_mode != "none":
        if not args.validation_data:
            raise SystemExit("--tuning-mode requires --validation-data")
        lo, hi = args.tuning_range
        if not (0 < lo < hi):
            raise SystemExit(f"--tuning-range needs 0 < LOW < HIGH, got "
                             f"{lo} {hi}")
        if args.evaluators is not None and not args.evaluators:
            raise SystemExit("--tuning-mode needs at least one evaluator "
                             "(drop the bare --evaluators flag to use the "
                             "task default)")
        from photon_ml_tpu_torch.tuning import resolve_tuned_coordinates

        try:
            tuned_coords = resolve_tuned_coordinates(
                grid[0], args.tuning_coordinates, args.locked_coordinates)
        except ValueError as e:
            raise SystemExit(f"--tuning-coordinates: {e}")

    ooc_shards = set(args.out_of_core_shards or ())
    ooc_chunk_rows = _check_out_of_core(args, grid, shards, ooc_shards)

    with Timed(logger, "feature_indexing"):
        index_maps = _build_index_maps(args, columns, shards)

    with Timed(logger, "read_train_data"):
        train = _read_dataset(
            args.train_data,
            {s: m for s, m in index_maps.items() if s not in ooc_shards},
            entity_columns, columns)
        if ooc_shards:
            # multi-process: each process keeps its own block share;
            # scores reassemble through the recorded part spans
            train.feature_sources = _out_of_core_sources(
                args, index_maps, ooc_shards, ooc_chunk_rows, columns, dtype,
                part=((process_index(), process_count())
                      if distributed else None))
    validation = None
    if args.validation_data:
        with Timed(logger, "read_validation_data"):
            validation = _read_dataset(args.validation_data, index_maps,
                                       entity_columns, columns)
    logger.log("data_read", num_train=train.num_samples,
               num_validation=0 if validation is None else validation.num_samples,
               num_features={s: m.size for s, m in index_maps.items()})

    norm_type = NormalizationType(args.normalization)
    if norm_type != NormalizationType.NONE or args.summarize_features:
        contexts = {}
        # the first collective phase of a multi-process run (the streamed
        # moments' reduction): one process's read or decode failure aborts
        # every process instead of leaving them in the reduction
        with Timed(logger, "feature_summarization"), \
                resilience.CollectiveGuard("feature_summarization"):
            for shard in shards:
                if shard in ooc_shards:
                    # one extra streamed pass over the disk-backed shard
                    src = train.feature_sources[shard]
                    summary = summarize_features_streamed(
                        src, src.dim, src.rows,
                        total_rows=getattr(src, "total_rows", src.rows),
                        part_reduce=(allreduce_summary_moments
                                     if distributed else None))
                else:
                    summary = _summarize_resident(train.features[shard],
                                                  train.labels, dev)
                if args.summarize_features and lead:
                    name = ("feature-summary.avro" if shard == "global"
                            else f"feature-summary.{shard}.avro")
                    write_feature_summary(args.output_dir, summary,
                                   index_maps[shard], name)
                if norm_type != NormalizationType.NONE:
                    contexts[shard] = build_normalization_context(
                        norm_type, summary,
                        intercept_index=index_maps[shard].intercept_index,
                        dtype=dtype, device=dev)
        if norm_type != NormalizationType.NONE:
            grid = [[dataclasses.replace(
                        cfg, normalization=contexts[cfg.feature_shard],
                        intercept_index=index_maps[
                            cfg.feature_shard].intercept_index)
                     for cfg in configs]
                    for configs in grid]

    warm = (load_game_model(args.warm_start_model, device=dev)
            if args.warm_start_model else None)
    # the resume marker: written on device loss, kept until a run
    # completes (a second failure of any kind keeps it), and fingerprinted
    # against the inputs so a rerun on other data refuses it
    resume = resilience.ResumeManager(
        os.path.join(args.output_dir, "RESUME.json"),
        fingerprint={
            "train_data": sorted(args.train_data),
            "validation_data": (sorted(args.validation_data)
                                if args.validation_data else None),
            "validation_rows": (None if validation is None
                                else int(validation.num_samples)),
        },
        is_lead=lead)
    if args.auto_resume and resume.exists():
        # marker-gated: without one --auto-resume does nothing, so a
        # supervisor may always pass it
        resume_from = resume.load().get("checkpoint")
        if resume_from:
            warm = load_game_model(resume_from, device=dev)
            logger.log("auto_resume", checkpoint=resume_from)
    if args.auto_resume and distributed:
        # every process has adopted the checkpoint (or seen none) before
        # any enters training's first collective; unconditional, since
        # whether the marker exists is a process-local probe
        resilience.health_barrier("auto_resume_loaded")

    evaluators = args.evaluators
    if evaluators is None:
        evaluators = [TASK_DEFAULT_EVALUATOR[task]] if validation is not None else []

    recovery_mgr = None
    if args.max_rank_failures > 0:
        # the resume marker's fingerprint: a snapshot from a run on other
        # inputs refuses to load
        recovery_mgr = RecoveryManager(
            os.path.join(args.output_dir, "recovery"),
            fingerprint=resume.fingerprint,
            max_rank_failures=args.max_rank_failures,
            snapshot_every=args.recovery_snapshot_every)

    estimator = GameEstimator(
        task=task, n_iterations=args.n_iterations, evaluators=evaluators,
        device=dev, dtype=dtype, cd_tolerance=args.cd_tolerance,
        solver_tol_schedule=args.solver_tol_schedule,
        entity_shard=entity_spec, entity_table_budget_bytes=re_table_budget,
        recovery=recovery_mgr,
    )
    ckpt = None
    if args.checkpoint and lead:
        def ckpt(gi, it, model):
            path = os.path.join(args.output_dir, "checkpoints",
                                f"config-{gi}-iter-{it}")
            save_game_model(model, path, index_maps)
            logger.log("checkpoint", config=gi, iteration=it, path=path)
    elif args.checkpoint and entity_spec is not None and entity_spec.active:
        # a sharded checkpoint is a collective (the model build gathers
        # every shard's buckets): the other ranks join it, the lead writes
        def ckpt(gi, it, model):
            del gi, it, model

    def log_fit(gi, result):
        for rec in result.history:
            logger.log("cd_iteration", config=gi, **rec)

    # device loss cannot be recovered in-process (a sticky CUDA error
    # poisons the context), so it is a process boundary: a marker pointing
    # at the newest checkpoint and exit 75 (EX_TEMPFAIL); a supervisor
    # reruns the same command with --auto-resume
    try:
        with Timed(logger, "training"), profile_trace(args.profile_dir):
            results = estimator.fit(
                train, validation, config_grid=grid, warm_start=warm,
                locked=args.locked_coordinates, checkpoint_callback=ckpt,
                fit_callback=log_fit,
            )
    except Exception as e:
        if not is_device_loss(e) or not args.checkpoint:
            raise
        latest = _latest_checkpoint(args.output_dir)
        resume.save({"error": str(e).split("\n")[0], "checkpoint": latest})
        logger.log("device_lost", error=str(e).split("\n")[0],
                   resume_checkpoint=latest)
        logger.close()
        print(f"device lost; resume marker written to {resume.path} "
              "(rerun with --auto-resume)", file=sys.stderr)
        return 75

    if recovery_mgr is not None and recovery_mgr.stats["recoveries"]:
        # the run survived an in-job recovery: the supervisor never saw a
        # restart, so the run log is the only durable trace of it
        logger.log("in_job_recovery", **recovery_mgr.as_dict())

    if args.tuning_mode != "none":
        from photon_ml_tpu_torch.tuning import tune_game

        def log_tune(ri, result):
            logger.log("tuning_round", round=ri,
                       reg_weights={c.name: c.reg_weight for c in result.configs},
                       metrics=result.evaluation.metrics)

        with Timed(logger, "hyperparameter_tuning"):
            tuned = tune_game(
                estimator, train, validation, list(grid[0]),
                n_iterations=args.tuning_iters, mode=args.tuning_mode,
                reg_range=tuple(args.tuning_range), prior_results=results,
                seed=args.tuning_seed, tuned_coordinates=tuned_coords,
                fit_callback=log_tune, warm_start=warm,
                locked=args.locked_coordinates,
            )
        results = results + tuned

    best = estimator.select_best(results)
    with Timed(logger, "save_models"):
        # every process reaches the same model; only the lead writes it
        if lead:
            save_game_model(best.model, os.path.join(args.output_dir, "best"),
                            index_maps)
        if args.save_all_models and lead:
            for gi, r in enumerate(results):
                save_game_model(
                    r.model,
                    os.path.join(args.output_dir, "all", f"config-{gi}"),
                    index_maps)
    if args.publish_to and lead:
        from photon_ml_tpu_torch.registry import ModelRegistry

        registry = ModelRegistry(args.publish_to)
        best_metrics = ({} if best.evaluation is None
                        else dict(best.evaluation.metrics))
        bootstrap = registry.read_latest(retries=1) is None
        version = registry.publish(
            os.path.join(args.output_dir, "best"),
            metrics=best_metrics, set_latest=bootstrap)
        logger.log("model_published", registry=args.publish_to,
                   version=version, set_latest=bootstrap,
                   metrics=best_metrics)
    # outputs are published: ANY completed run consumes the marker, so a
    # later --auto-resume cannot warm-start from an older checkpoint
    resume.consume()
    logger.log("driver_done",
               best_config=[config_asdict(c) for c in best.configs],
               best_metrics=None if best.evaluation is None else best.evaluation.metrics)
    logger.close()
    return 0


def _latest_checkpoint(output_dir: str) -> Optional[str]:
    """The newest checkpoint directory, or None: by mtime, ties (coarse
    mtimes) broken on the parsed config and iteration numbers, so that
    iter-10 ranks above iter-9. A complete ``{name}.old-{pid}`` copy left
    by a save that died between its two renames counts as its base name
    when the base is missing."""
    root = os.path.join(output_dir, "checkpoints")
    if not os.path.isdir(root):
        return None

    def nums(name):
        return tuple(int(x) for x in re.findall(r"\d+", name)) or (-1,)

    entries = [d for d in sorted(os.listdir(root))
               if os.path.isdir(os.path.join(root, d))]
    live = [d for d in entries if ".tmp-" not in d and ".old-" not in d]
    for d in entries:
        if ".old-" in d and d.split(".old-")[0] not in live:
            live.append(d)
    if not live:
        return None
    best = max(live, key=lambda d: (os.path.getmtime(os.path.join(root, d)),
                                    nums(d)))
    return os.path.join(root, best)


def config_asdict(cfg: CoordinateConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("normalization", None)  # device tensors aren't JSON
    return d


if __name__ == "__main__":
    raise SystemExit(main())
