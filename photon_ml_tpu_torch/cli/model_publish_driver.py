"""Model lifecycle driver: publish / gate / promote / roll back / GC
(counterpart of ``photon_ml_tpu/cli/model_publish_driver.py``).

The operator's seam between training output directories and the serving
registry (``PUBLISH`` stands for ``python -m
photon_ml_tpu_torch.cli.model_publish_driver``):

    # bootstrap: first full publish, promoted immediately
    PUBLISH --registry /models/r --model-dir out/best --set-latest

    # incremental retrain: publish only the changed bytes, then earn
    # LATEST on a held-out shard (exit 3 when the gate refuses)
    PUBLISH --registry /models/r --model-dir out2/best \
        --delta --gate-data data/holdout.avro --evaluators auc \
        --tolerance 0.005

    # operations
    PUBLISH --registry /models/r --list
    PUBLISH --registry /models/r --rollback-to v000002
    PUBLISH --registry /models/r --gc-keep 5

The gate scores both versions on ``--device`` (default ``cuda``, which
raises without a GPU; ``--device cpu`` scores on the CPU) in float64.

Exit codes: 0 ok; 2 usage/validation error; 3 the gate REFUSED the
candidate (published but not promoted — LATEST unchanged).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Sequence

__all__ = ["build_arg_parser", "main"]


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="GAME model registry: publish / gate / promote")
    p.add_argument("--registry", required=True,
                   help="registry root directory (created on first publish)")
    p.add_argument("--model-dir", default=None,
                   help="saved model directory to publish")
    p.add_argument("--delta", action="store_true",
                   help="publish only the records that changed against "
                        "the parent (default parent: the live version)")
    p.add_argument("--parent", default=None,
                   help="explicit parent version for --delta")
    p.add_argument("--metrics", default=None,
                   help="JSON (inline or path) of training metrics to "
                        "record in the manifest")
    p.add_argument("--gate-data", nargs="+", default=None,
                   help="held-out labeled Avro shard(s): run the "
                        "promotion gate after publishing (or against "
                        "--candidate) and promote only on pass")
    p.add_argument("--candidate", default=None,
                   help="gate an ALREADY-published version instead of "
                        "publishing --model-dir")
    p.add_argument("--evaluators", nargs="*", default=None,
                   help="gate metrics (default: the task's default)")
    p.add_argument("--group-column", default=None)
    p.add_argument("--tolerance", type=float, default=0.0,
                   help="largest acceptable per-metric regression "
                        "(metric units)")
    p.add_argument("--set-latest", action="store_true",
                   help="promote without a gate (bootstrap / operator "
                        "override)")
    p.add_argument("--rollback-to", default=None,
                   help="repoint LATEST at a retained version")
    p.add_argument("--gc-keep", type=int, default=None,
                   help="after everything else: GC all but the newest N "
                        "versions (the live chain is always kept)")
    p.add_argument("--list", action="store_true", dest="list_versions",
                   help="print every version's manifest summary")
    p.add_argument("--device", default="cuda",
                   help="torch device the gate scores on (default cuda, "
                        "which raises without a GPU)")
    return p


def _load_metrics(spec):
    if not spec:
        return {}
    if os.path.exists(spec):
        with open(spec) as f:
            return json.load(f)
    return json.loads(spec)


def _say(**fields) -> None:
    print(json.dumps(fields), flush=True)


def main(argv: Sequence[str] | None = None) -> int:
    args = build_arg_parser().parse_args(argv)
    from photon_ml_tpu_torch.registry import (
        ModelRegistry,
        RegistryError,
        publish_delta,
        run_gate,
    )

    registry = ModelRegistry(args.registry)
    try:
        if args.list_versions:
            live = registry.read_latest(retries=1)
            for v in registry.list_versions():
                m = registry.manifest(v)
                gate = m.get("gate") or {}
                _say(version=v, live=(v == live), parent=m.get("parent"),
                     delta=bool(m.get("delta")), metrics=m.get("metrics"),
                     gate_passed=gate.get("passed"),
                     promoted=gate.get("promoted"))
            if not registry.list_versions():
                _say(registry=args.registry, versions=0)
            return 0

        if args.rollback_to:
            registry.set_latest(args.rollback_to)
            _say(rolled_back_to=args.rollback_to)
            if args.gc_keep is not None:
                _say(gc_removed=registry.gc(keep=args.gc_keep))
            return 0

        candidate = args.candidate
        if args.model_dir:
            metrics = _load_metrics(args.metrics)
            if args.delta:
                candidate = publish_delta(
                    registry, args.model_dir, parent=args.parent,
                    metrics=metrics)
                summary = registry.manifest(candidate).get("delta_summary")
                _say(published=candidate, delta=True,
                     delta_summary=summary)
            else:
                candidate = registry.publish(
                    args.model_dir, metrics=metrics, parent=args.parent)
                _say(published=candidate, delta=False)
        elif candidate is None and not args.gc_keep and not args.gate_data:
            print("nothing to do: pass --model-dir, --candidate, "
                  "--list, --rollback-to, or --gc-keep", file=sys.stderr)
            return 2

        refused = False
        if args.gate_data:
            if candidate is None:
                print("--gate-data needs --model-dir or --candidate",
                      file=sys.stderr)
                return 2
            verdict = run_gate(
                registry, candidate, args.gate_data,
                evaluators=args.evaluators, tolerance=args.tolerance,
                group_column=args.group_column, device=args.device)
            _say(gate_candidate=candidate, gate_passed=verdict.passed,
                 promoted=verdict.promoted,
                 candidate_metrics=verdict.candidate_metrics,
                 live_metrics=verdict.live_metrics,
                 regressions=verdict.regressions)
            refused = not verdict.passed
        elif candidate is not None and args.set_latest:
            registry.set_latest(candidate)
            _say(promoted=candidate, gate="skipped (--set-latest)")

        if args.gc_keep is not None:
            _say(gc_removed=registry.gc(keep=args.gc_keep))
        live = registry.read_latest(retries=1)
        _say(latest=live)
        return 3 if refused else 0
    except (RegistryError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
