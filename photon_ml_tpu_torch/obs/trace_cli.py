"""``photon-trace``: merge, validate, and smoke-test per-rank traces
(counterpart of ``photon_ml_tpu/obs/trace_cli.py``). Run as
``python -m photon_ml_tpu_torch.obs.trace_cli {merge,validate,smoke}``.

``merge``: combine ``trace-rank*.json`` files (one per process, written
by :mod:`photon_ml_tpu_torch.obs.trace`) into a single Perfetto-loadable
timeline. Ranks that ran as real processes have unrelated
``perf_counter`` origins, so the merge re-aligns clocks on the
collective spans (``cat="collective"``, ``args.site``): the k-th
occurrence of a site on rank N is the *same rendezvous* as the k-th
occurrence on rank 0 — every participant leaves an allgather/barrier
together, so their span *ends* are simultaneous up to network skew.
Rank N's shift is the median of ``end_0 - end_N`` over all matched
occurrences (median: robust to a straggler rank that entered late).
Ranks with no matching collective spans merge unshifted, with a
warning in the output metadata.

``validate``: minimal schema check — a dict with a non-empty ``traceEvents`` list
whose events carry name/ph/pid/tid and numeric ts (plus dur for
``ph="X"``).

``smoke``: end-to-end self-test — run a 2-rank simulated-process trace
through the real tracer and the real sharded exchange, merge it,
validate the merged file. Exercises exactly the path the training
driver uses, on the host alone.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys
from typing import Dict, List, Optional, Tuple

from photon_ml_tpu_torch.io.durable import durable_replace

__all__ = ["merge_traces", "validate_trace", "main"]


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _collective_ends(events: List[dict]) -> Dict[Tuple[str, int], float]:
    """(site, occurrence_index) -> span end µs, for clock alignment."""
    ends: Dict[Tuple[str, int], float] = {}
    seen: Dict[str, int] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != "collective":
            continue
        site = (ev.get("args") or {}).get("site")
        if site is None:
            continue
        k = seen.get(site, 0)
        seen[site] = k + 1
        ends[(site, k)] = float(ev["ts"]) + float(ev.get("dur", 0.0))
    return ends


def merge_traces(paths: List[str]) -> dict:
    """Merge per-rank Chrome-trace files into one document, aligning
    each rank's clock to rank 0 (lowest rank present) via matched
    collective-span end times."""
    if not paths:
        raise ValueError("no trace files to merge")
    docs = []
    for p in sorted(paths):
        doc = _load(p)
        evs = doc.get("traceEvents", [])
        spans = [e for e in evs if e.get("ph") == "X"]
        rank = (doc.get("metadata", {}).get("rank")
                if isinstance(doc.get("metadata"), dict) else None)
        if rank is None:
            rank = spans[0]["pid"] if spans else 0
        docs.append((int(rank), evs, spans, p))
    docs.sort(key=lambda d: d[0])
    base_rank, _, base_spans, _ = docs[0]
    base_ends = _collective_ends(base_spans)

    merged: List[dict] = []
    shifts: Dict[int, Optional[float]] = {}
    for rank, evs, spans, _path in docs:
        if rank == base_rank:
            shift = 0.0
        else:
            ends = _collective_ends(spans)
            deltas = [base_ends[key] - end for key, end in ends.items()
                      if key in base_ends]
            shift = statistics.median(deltas) if deltas else None
        shifts[rank] = shift
        for ev in evs:
            ev = dict(ev)
            if shift and "ts" in ev:
                ev["ts"] = float(ev["ts"]) + shift
            merged.append(ev)
    merged.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "metadata": {
            "producer": "photon-trace merge",
            "ranks": sorted(shifts),
            "clock_shifts_us": {str(r): s for r, s in shifts.items()},
            "unaligned_ranks": sorted(
                r for r, s in shifts.items() if s is None),
        },
    }


def validate_trace(doc: dict) -> List[str]:
    """Return a list of schema problems (empty == valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["top level is not an object"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing {key!r}")
        ph = ev.get("ph")
        if ph == "X":
            for key in ("ts", "dur"):
                if not isinstance(ev.get(key), (int, float)):
                    problems.append(f"event {i}: non-numeric {key!r}")
        elif ph == "M":
            pass  # metadata events carry no timestamps
        elif "ts" in ev and not isinstance(ev["ts"], (int, float)):
            problems.append(f"event {i}: non-numeric 'ts'")
        if problems and len(problems) >= 20:
            problems.append("... (truncated)")
            break
    if not any(e.get("ph") == "X" for e in evs if isinstance(e, dict)):
        problems.append("no complete ('X') span events")
    return problems


def _cmd_merge(args) -> int:
    paths = args.files or sorted(
        glob.glob(os.path.join(args.trace_dir, "trace-rank*.json")))
    if not paths:
        print(f"photon-trace: no trace files under {args.trace_dir!r}",
              file=sys.stderr)
        return 2
    doc = merge_traces(paths)
    out = args.output or os.path.join(
        args.trace_dir or os.path.dirname(paths[0]) or ".",
        "trace-merged.json")
    tmp = out + f".tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    durable_replace(tmp, out)
    meta = doc["metadata"]
    print(f"merged {len(paths)} rank file(s) -> {out} "
          f"({len(doc['traceEvents'])} events, ranks {meta['ranks']})")
    if meta["unaligned_ranks"]:
        print(f"warning: ranks {meta['unaligned_ranks']} had no "
              "collective spans matching rank 0; merged unshifted",
              file=sys.stderr)
    return 0


def _cmd_validate(args) -> int:
    problems = validate_trace(_load(args.file))
    if problems:
        for p in problems:
            print(f"photon-trace: {args.file}: {p}", file=sys.stderr)
        return 1
    print(f"{args.file}: valid ({len(_load(args.file)['traceEvents'])} "
          "events)")
    return 0


def _smoke_rank(rank: int):
    import numpy as np

    from photon_ml_tpu_torch.obs import trace
    from photon_ml_tpu_torch.parallel.entity_shard import (
        exchange_score_updates,
    )

    with trace.span("smoke.fit", cat="train", rank=rank):
        for it in range(2):
            rows = np.asarray([rank, rank + 10], np.int64)
            vals = np.asarray([0.5 * rank, 1.5], np.float64)
            exchange_score_updates(
                (rows, vals), tag=f"smoke:{it}")


def _cmd_smoke(args) -> int:
    import tempfile

    from photon_ml_tpu_torch.obs import trace
    from photon_ml_tpu_torch.testing import run_simulated_processes

    with tempfile.TemporaryDirectory() as td:
        trace_dir = args.trace_dir or os.path.join(td, "traces")
        trace.start(trace_dir, export_thread=False)
        try:
            outcomes = run_simulated_processes(2, _smoke_rank)
        finally:
            trace.stop()
        bad = [o for o in outcomes if isinstance(o, BaseException)]
        if bad:
            for o in bad:
                print(f"photon-trace smoke: rank failed: {o!r}",
                      file=sys.stderr)
            return 1
        paths = sorted(
            glob.glob(os.path.join(trace_dir, "trace-rank*.json")))
        if len(paths) != 2:
            print(f"photon-trace smoke: expected 2 rank files, got "
                  f"{paths}", file=sys.stderr)
            return 1
        doc = merge_traces(paths)
        problems = validate_trace(doc)
        if problems:
            for p in problems:
                print(f"photon-trace smoke: {p}", file=sys.stderr)
            return 1
        sites = {(e.get("args") or {}).get("site")
                 for e in doc["traceEvents"] if e.get("cat") == "collective"}
        if not sites & {"smoke:0", "smoke:1"}:
            print("photon-trace smoke: merged trace has no collective "
                  "spans for the smoke sites", file=sys.stderr)
            return 1
    print("photon-trace smoke: OK (2 ranks merged, schema valid, "
          f"collective sites {sorted(s for s in sites if s)})")
    return 0


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon-trace",
        description="merge / validate / smoke-test photon trace files")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("merge", help="merge per-rank trace files")
    m.add_argument("trace_dir", nargs="?", default=".",
                   help="directory holding trace-rank*.json")
    m.add_argument("--files", nargs="*", default=None,
                   help="explicit trace files (overrides trace_dir glob)")
    m.add_argument("-o", "--output", default=None,
                   help="merged output path (default: "
                        "<trace_dir>/trace-merged.json)")
    m.set_defaults(fn=_cmd_merge)

    v = sub.add_parser("validate", help="schema-check one trace file")
    v.add_argument("file")
    v.set_defaults(fn=_cmd_validate)

    s = sub.add_parser("smoke", help="2-rank end-to-end self test")
    s.add_argument("--trace-dir", default=None,
                   help="keep the smoke trace files here (default: "
                        "a temp dir)")
    s.set_defaults(fn=_cmd_smoke)
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
