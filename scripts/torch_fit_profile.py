#!/usr/bin/env python3
"""Where the device time of the port's main path goes, on the card.

Fits the same Criteo-shaped problem as ``chip_smoke.py`` (n=2^21, d=2^18,
k=39 implicit ones, float32, at tolerance 0, through
``sparse_grad="csc_kernel"``) once without and once under
``torch.profiler``, then prints the wall-clock of both fits, the device
time by kernel (largest first), and the device's idle share of the
profiled fit. The optimizer is the main path's L-BFGS with the margin line
search (20 iterations) unless one of ``owlqn`` (20 iterations, l1 as in
``chip_smoke.py``) or ``tron`` (at most 10 outer iterations) is named. Run
from the repository root on a machine with one GPU:

    python3 scripts/torch_fit_profile.py [lbfgs|owlqn|tron]

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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fit_profile: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (
        DIM, ITERS, K, L1, N_ROWS, SEED, TRON_ITERS, make_data,
    )
    from photon_ml_tpu_torch.ops.objective import make_objective
    from photon_ml_tpu_torch.optimize.common import OptimizerConfig
    from photon_ml_tpu_torch.parallel.data_parallel import (
        build_csc, fit_distributed,
    )
    from photon_ml_tpu_torch.types import SparseFeatures, make_batch

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    indices, labels = make_data(N_ROWS, DIM, K, gen, dev)
    batch = make_batch(SparseFeatures(indices, None, DIM), labels, device=dev)
    csc = build_csc(batch)
    obj = make_objective("logistic")
    w0 = torch.zeros(DIM, device=dev)

    optimizer = sys.argv[1] if len(sys.argv) > 1 else "lbfgs"
    iters = TRON_ITERS if optimizer == "tron" else ITERS

    def fit(max_iters=iters):
        res = fit_distributed(
            obj, batch, w0, l2=1.0, l1=L1, optimizer=optimizer,
            sparse_grad="csc_kernel",
            config=OptimizerConfig(max_iters=max_iters, tolerance=0.0),
            precomputed_csc=csc)
        float(res.value)  # scalar fetch: the fit has run
        return res

    fit(2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit()
    plain_s = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        profiled_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    rows = [{"kernel": e.key[:120], "calls": e.count,
             "ms": e.self_device_time_total / 1e3,
             "share": e.self_device_time_total / 1e3 / busy_ms}
            for e in kernels] if busy_ms > 0 else []
    print(f"card: {smi}")
    print(f"fit {optimizer} ({res.iterations} iterations): "
          f"{plain_s * 1e3:.3f} ms unprofiled, "
          f"{profiled_s * 1e3:.3f} ms profiled")
    if not rows:
        print("profiler recorded no device time: breakdown not measured")
    for r in rows[:15]:
        print(f"{r['ms']:9.3f} ms {r['share'] * 100:6.2f}% "
              f"{r['calls']:5d}x  {r['kernel']}")
    idle = 1.0 - busy_ms / (profiled_s * 1e3) if rows else None
    print(f"device busy {busy_ms:.3f} ms; idle share of the profiled fit: "
          f"{'not measured' if idle is None else f'{idle:.4f}'}")
    print(json.dumps({"card": smi, "optimizer": optimizer,
                      "iterations": res.iterations, "fit_ms": plain_s * 1e3,
                      "profiled_fit_ms": profiled_s * 1e3,
                      "device_busy_ms": busy_ms, "idle_share": idle,
                      "kernels": rows[:15]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
