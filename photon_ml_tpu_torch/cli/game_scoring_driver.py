"""GAME scoring driver: batch inference with a saved model (counterpart of
``photon_ml_tpu/cli/game_scoring_driver.py``: its in-memory path).

Equivalent of the reference's ``cli.game.scoring.GameScoringDriver``
(SURVEY.md §4.4): load a saved GAME model + Avro data, score every row
(fixed-effect margins + per-entity random-effect margins + offsets) on
``--device`` (default ``cuda``, which raises without a GPU), write
``ScoringResultAvro`` records and optionally evaluate against labels. The
output file appears only when complete (a temporary file committed by
``io.durable.durable_replace``). A model saved by either package scores
here.

``--out-of-core`` decodes, scores and writes one block window at a time
(``io.data_reader.read_training_examples_chunked``): host RAM holds one
window plus the evaluators' 16 bytes per row.

Device loss (``utils.is_device_loss``) exits 75: scoring is stateless and
its output write is atomic, so no marker is needed, and a rerun of the
same command is a clean retry (the training drivers' contract).

Usage:
    python -m photon_ml_tpu_torch.cli.game_scoring_driver \\
        --data data/val.avro --model-dir out/best --output-dir scores/ \\
        --evaluators auc
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import Sequence

import numpy as np

from photon_ml_tpu_torch.cli._common import load_input_columns, positive_int
from photon_ml_tpu_torch.evaluation import get_evaluator
from photon_ml_tpu_torch.game.data import HostSparse
from photon_ml_tpu_torch.game.scoring import score_game_model
from photon_ml_tpu_torch.io.avro import write_avro_file
from photon_ml_tpu_torch.io.data_reader import (
    read_training_examples, read_training_examples_chunked,
)
from photon_ml_tpu_torch.io.durable import durable_replace
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.io.paldb import load_index_map
from photon_ml_tpu_torch.io.schemas import SCORING_RESULT_SCHEMA
from photon_ml_tpu_torch.models import RandomEffectModel
from photon_ml_tpu_torch.types import resolve_device
from photon_ml_tpu_torch.utils import (
    PhotonLogger, Timed, is_device_loss, resolve_dtype,
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GAME scoring driver "
                                            "(PyTorch port)")
    p.add_argument("--data", required=True, nargs="+")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--evaluators", nargs="*", default=())
    p.add_argument("--group-column", default=None,
                   help="metadataMap column keying grouped (Multi-) "
                        "evaluators, e.g. a query id for per_group_auc")
    p.add_argument("--per-coordinate-scores", action="store_true",
                   help="include a per-coordinate score breakdown")
    p.add_argument("--input-columns", default=None,
                   help="JSON (inline or path) remapping record field names")
    p.add_argument("--batch-rows", type=positive_int, default=None,
                   help="score in row batches of this size (bounds device "
                        "memory for large scoring sets; must be positive)")
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--device", default="cuda",
                   help="torch device for the scoring (default cuda, which "
                        "raises without a GPU)")
    p.add_argument("--out-of-core", action="store_true",
                   help="decode block windows of ~--batch-rows rows one at "
                        "a time, score each and append its records before "
                        "the next window decodes")
    return p


def _scoring_record(uid, score: float, label: float, parts, i: int) -> dict:
    """One ScoringResultAvro record."""
    return {
        "uid": uid,
        "predictionScore": float(score),
        "label": None if np.isnan(label) else float(label),
        "scoreComponents": {k: float(v[i]) for k, v in parts.items()},
    }


def _slice_host_sparse(sp, row_slice):
    return HostSparse(sp.indices[row_slice], sp.values[row_slice], sp.dim)


def main(argv: Sequence[str] | None = None) -> int:
    try:
        return _main(argv)
    except Exception as e:
        if not is_device_loss(e):
            raise
        print("device lost; rerun this command (scoring is idempotent, no "
              "partial output was published)", file=sys.stderr)
        return 75


def _main(argv: Sequence[str] | None = None) -> int:
    args = build_arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    dtype = resolve_dtype(args.dtype)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = PhotonLogger(os.path.join(args.output_dir, "photon.log.jsonl"))
    logger.log("driver_start", driver="game_scoring", args=vars(args))

    with Timed(logger, "load_model"):
        model = load_game_model(args.model_dir, device=dev)
    shards = sorted({c.feature_shard for c in model.coordinates.values()})
    index_maps = {
        s: load_index_map(os.path.join(args.model_dir, f"index-map.{s}.json"))
        for s in shards
    }
    entity_columns = [
        c.entity_column for c in model.coordinates.values()
        if isinstance(c, RandomEffectModel) and c.entity_column
    ]
    if args.group_column and args.group_column not in entity_columns:
        entity_columns = entity_columns + [args.group_column]

    if args.out_of_core:
        return _score_out_of_core(args, model, index_maps, entity_columns,
                                  logger, dtype, dev)

    with Timed(logger, "read_data"):
        feats, labels, offsets, weights, ents, uids = read_training_examples(
            args.data, index_maps, entity_columns=entity_columns,
            columns=load_input_columns(args.input_columns),
            require_response=False,
        )
    logger.log("data_read", num_rows=len(labels))

    def score_rows(row_slice):
        f = {s: _slice_host_sparse(sp, row_slice) for s, sp in feats.items()}
        e = {c: v[row_slice] for c, v in ents.items()}
        result = score_game_model(
            model, f, e, offsets=offsets[row_slice], dtype=dtype,
            per_coordinate=args.per_coordinate_scores, device=dev,
        )
        if args.per_coordinate_scores:
            s, parts = result
            return (s.cpu().numpy(),
                    {k: v.cpu().numpy() for k, v in parts.items()})
        return result.cpu().numpy(), {}

    with Timed(logger, "score"):
        n = len(labels)
        # an empty scoring set is a valid, complete empty output
        step = args.batch_rows or max(n, 1)
        chunks = [score_rows(slice(i, min(i + step, n)))
                  for i in range(0, n, step)]
        scores = np.concatenate([c[0] for c in chunks]) if chunks else np.zeros(0)
        parts = {}
        if chunks and chunks[0][1]:
            parts = {k: np.concatenate([c[1][k] for c in chunks])
                     for k in chunks[0][1]}

    with Timed(logger, "write_scores"):
        if len(scores) != len(uids):
            raise RuntimeError(
                f"scored {len(scores)} rows but read {len(uids)} — "
                "refusing to write a partial scoring set")

        def records():
            for i, uid in enumerate(uids):
                yield _scoring_record(uid, scores[i], labels[i], parts, i)

        _write_scores_atomic(args.output_dir, records())

    labeled = ~np.isnan(labels)
    metrics = {}
    if args.evaluators and not labeled.any():
        logger.log("evaluation_skipped", reason="no labeled rows")
    else:
        group_ids = (ents[args.group_column][labeled]
                     if args.group_column else None)
        for name in args.evaluators:
            metrics[name] = get_evaluator(name).evaluate(
                scores[labeled], labels[labeled], weights[labeled], group_ids)
    if metrics:
        logger.log("evaluation", **metrics)
    logger.log("driver_done", num_scored=len(scores))
    logger.close()
    return 0


def _write_scores_atomic(output_dir: str, records) -> None:
    """scores.avro appears only when COMPLETE: the writer streams into a
    sibling tmp file that is committed into place at the end, so a crash
    mid-scoring can never leave a partial output a consumer would mistake
    for the full scoring set."""
    final = os.path.join(output_dir, "scores.avro")
    tmp = f"{final}.tmp-{os.getpid()}"
    try:
        write_avro_file(tmp, records, SCORING_RESULT_SCHEMA)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
    durable_replace(tmp, final)


def _score_out_of_core(args, model, index_maps, entity_columns, logger,
                       dtype, dev) -> int:
    """Stream decode -> score -> write, one block window at a time. The Avro
    writer consumes a generator, so output records append as each window
    finishes; only the evaluators' inputs (scores, labels, weights, groups:
    16 bytes per row) accumulate in host RAM."""
    chunk_rows = args.batch_rows or (1 << 16)
    acc_scores, acc_labels, acc_weights, acc_groups = [], [], [], []
    n_scored = [0]

    def scored_records():
        windows = read_training_examples_chunked(
            args.data, index_maps, entity_columns=entity_columns,
            columns=load_input_columns(args.input_columns),
            chunk_rows=chunk_rows, require_response=False)
        for feats, labels, offsets, weights, ents, uids in windows:
            result = score_game_model(
                model, feats, ents, offsets=offsets, dtype=dtype,
                per_coordinate=args.per_coordinate_scores, device=dev)
            if args.per_coordinate_scores:
                scores, parts = result
                parts = {k: v.cpu().numpy() for k, v in parts.items()}
            else:
                scores, parts = result, {}
            scores = scores.cpu().numpy()
            if args.evaluators:
                # evaluator state is the only per-row accumulation
                acc_scores.append(scores)
                acc_labels.append(labels)
                acc_weights.append(weights)
                if args.group_column:
                    acc_groups.append(ents[args.group_column])
            n_scored[0] += len(scores)
            for i, uid in enumerate(uids):
                yield _scoring_record(uid, scores[i], labels[i], parts, i)

    with Timed(logger, "score_and_write"):
        _write_scores_atomic(args.output_dir, scored_records())

    metrics = {}
    if args.evaluators:
        scores = np.concatenate(acc_scores) if acc_scores else np.zeros(0)
        labels = np.concatenate(acc_labels) if acc_labels else np.zeros(0)
        weights = (np.concatenate(acc_weights) if acc_weights
                   else np.zeros(0))
        labeled = ~np.isnan(labels)
        if labeled.any():
            groups = (np.concatenate(acc_groups)[labeled]
                      if acc_groups else None)
            for name in args.evaluators:
                metrics[name] = get_evaluator(name).evaluate(
                    scores[labeled], labels[labeled], weights[labeled],
                    groups)
        else:
            logger.log("evaluation_skipped", reason="no labeled rows")
    if metrics:
        logger.log("evaluation", **metrics)
    logger.log("driver_done", num_scored=n_scored[0])
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
