"""Argument parsing and output helpers shared by the command-line drivers
(``glm_driver``, ``game_training_driver``, ``game_scoring_driver``)."""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import torch

from photon_ml_tpu_torch.io.avro import write_avro_file
from photon_ml_tpu_torch.io.data_reader import InputColumnsNames
from photon_ml_tpu_torch.io.index_map import IndexMap
from photon_ml_tpu_torch.io.schemas import (
    FEATURE_SUMMARIZATION_SCHEMA, split_feature_key,
)
from photon_ml_tpu_torch.optimize import parse_tolerance_schedule


def positive_int(value: str) -> int:
    n = int(value)
    if n <= 0:
        raise argparse.ArgumentTypeError(
            f"expected a positive integer, got {value!r}")
    return n


def tol_schedule(value: str):
    try:
        return parse_tolerance_schedule(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def json_arg(spec: str):
    """JSON given inline or as a path to a file."""
    if os.path.exists(spec):
        with open(spec) as f:
            return json.load(f)
    return json.loads(spec)


def load_input_columns(spec) -> InputColumnsNames:
    if not spec:
        return InputColumnsNames()
    return InputColumnsNames.from_dict(json_arg(spec))


def start_processes(args, device: str) -> bool:
    """Join the multi-process runtime when ``--coordinator-address``,
    ``--num-processes`` and ``--process-id`` are given (one process per
    device; ``device``, the driver's ``--device``, picks the backend).
    False for one process; bad flags exit with the reason."""
    from photon_ml_tpu_torch.parallel.multihost import initialize_multihost

    try:
        return initialize_multihost(args.coordinator_address,
                                    args.num_processes, args.process_id,
                                    device=device)
    except ValueError as e:
        raise SystemExit(str(e))


def stop_processes(distributed: bool) -> None:
    """Leave the runtime :func:`start_processes` joined. After a watchdog
    abandoned a collective the group is out of step and its teardown
    would wait on that collective, so the process just exits."""
    from photon_ml_tpu_torch.parallel.resilience import abandoned_world

    if distributed and not abandoned_world():
        torch.distributed.destroy_process_group()


def log_path(output_dir: str) -> str:
    """The structured log: ``photon.log.jsonl`` for rank 0 (the lead), one
    file per other rank beside it, so that ranks never share a file. The
    rank is the resilience transport's: the world's rank in a real run,
    the simulated process's under ``testing.run_simulated_processes``."""
    from photon_ml_tpu_torch.parallel.resilience import current_process_index

    rank = current_process_index()
    name = ("photon.log.jsonl" if rank == 0
            else f"photon.log.rank-{rank}.jsonl")
    return os.path.join(output_dir, name)


def runtime_info(dev: torch.device) -> dict:
    """The JAX driver's topology keys: one device per process."""
    from photon_ml_tpu_torch.parallel.multihost import (
        process_count, process_index,
    )

    info = {"process_index": process_index(),
            "process_count": process_count(), "local_devices": 1,
            "global_devices": process_count(), "platform": dev.type}
    if dev.type == "cuda":
        info["device_name"] = torch.cuda.get_device_name(dev)
    return info


def write_feature_summary(output_dir, summary, imap: IndexMap,
                          name: str = "feature-summary.avro"):
    """``name`` under ``output_dir``: one FeatureSummarizationResultAvro
    record per feature."""
    inverse = imap.inverse()

    def records():
        for i in range(summary.dim):
            feature, term = split_feature_key(inverse[i])
            yield {
                "name": feature, "term": term,
                "mean": float(summary.mean[i]),
                "variance": float(summary.variance[i]),
                "min": float(summary.min[i]), "max": float(summary.max[i]),
                "numNonzeros": float(summary.num_nonzeros[i]),
                "count": summary.count,
            }

    write_avro_file(os.path.join(output_dir, name), records(),
                    FEATURE_SUMMARIZATION_SCHEMA)


def add_trace_args(p: argparse.ArgumentParser) -> None:
    """The training drivers' observability flags (as the JAX drivers')."""
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of training here "
                        "(host activity, and the card's kernels on CUDA; "
                        "one Chrome-trace JSON file per process)")
    p.add_argument("--trace-dir", default=None,
                   help="write photon-trace span files here (one "
                        "trace-rankN.json per process, Chrome-trace "
                        "format; merge with `python -m "
                        "photon_ml_tpu_torch.obs.trace_cli merge`). "
                        "Also honors PHOTON_TRACE / PHOTON_TRACE_SAMPLE")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="fraction of traces recorded under --trace-dir")


@contextlib.contextmanager
def traced(args):
    """Configure the structured log and, with ``--trace-dir`` (or
    ``PHOTON_TRACE``), the span tracer for one driver run. Every exit path,
    device loss's exit 75 included, exports the trace files; only a tracer
    this run started is stopped (the simulated harness's ranks run the
    driver in one process and share one)."""
    from photon_ml_tpu_torch.obs import logging as obs_logging
    from photon_ml_tpu_torch.obs import trace as obs_trace

    obs_logging.configure()
    if args.trace_dir:
        started = obs_trace.start(args.trace_dir, sample=args.trace_sample)
    else:
        started = obs_trace.maybe_start_from_env()
    try:
        yield
    finally:
        if started is not None:
            obs_trace.stop()
