#!/usr/bin/env python3
"""Where the time of one GAME coordinate-descent sweep goes, on the card.

Builds ``chip_smoke.py`` phase 12's data and coordinates (n = 2^17 rows,
d = 2^16, k = 39 implicit ones, user ids uniform over 100,000 and item ids
over 10,000; a fixed coordinate and two random ones), runs one sweep to
warm up, then one more from zero coefficients under ``torch.profiler``, and
prints each coordinate's wall-clock, the sweep's device busy time and the
device's idle share, the device time by kernel (largest first) and the
host operations with the most self time. Run from the repository root on a
machine with one GPU:

    python3 scripts/torch_game_profile.py

The last line is a JSON object with the same numbers.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _device_rows(prof, top=12):
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return busy_ms, [{"kernel": e.key[:100], "calls": e.count,
                      "ms": e.self_device_time_total / 1e3}
                     for e in kernels[:top]]


def _host_rows(prof, top=8):
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    ops.sort(key=lambda e: -e.self_cpu_time_total)
    return [{"op": e.key[:80], "calls": e.count,
             "ms": e.self_cpu_time_total / 1e3} for e in ops[:top]]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_game_profile: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (
        GAME_ROWS, GAME_VAL_ROWS, SEED, game_configs, make_game_data,
    )
    from photon_ml_tpu_torch.game.descent import CoordinateDescent

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    train, _ = make_game_data(GAME_ROWS, GAME_VAL_ROWS, SEED)
    cache = {}
    configs = game_configs()
    t0 = time.perf_counter()
    CoordinateDescent(configs, device=dev, dataset_cache=cache) \
        ._build_random_states(train, None, {}, {})
    build_s = time.perf_counter() - t0
    CoordinateDescent(configs, n_iterations=1, device=dev,
                      dataset_cache=cache).run(train)  # warm sweep

    cd = CoordinateDescent(configs, n_iterations=1, device=dev,
                           dataset_cache=cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, hist = cd.run(train)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    busy_ms, kernels = _device_rows(prof)
    out = {"profiled_sweep_s": wall_s,
           "seconds": {r["coordinate"]: r["seconds"] for r in hist},
           "device_busy_ms": busy_ms,
           "idle_share": (1.0 - busy_ms / (wall_s * 1e3) if busy_ms > 0
                          else None),
           "kernels": kernels, "host": _host_rows(prof)}
    print(f"card: {smi}")
    print(f"random-effect buckets built on the host in {build_s:.3f} s")
    print(f"profiled sweep: {out['profiled_sweep_s']:.3f} s; per "
          f"coordinate: " + ", ".join(f"{k} {v:.4f} s"
                                      for k, v in out["seconds"].items()))
    if out["idle_share"] is None:
        print("profiler recorded no device time: breakdown not measured")
    else:
        print(f"device busy {out['device_busy_ms']:.3f} ms; idle share "
              f"{out['idle_share']:.4f}")
    for r in out["kernels"]:
        print(f"{r['ms']:9.3f} ms {r['calls']:6d}x  {r['kernel']}")
    print("host self time:")
    for r in out["host"]:
        print(f"{r['ms']:9.3f} ms {r['calls']:6d}x  {r['op']}")
    print(json.dumps({"card": smi, "re_build_s": build_s, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
