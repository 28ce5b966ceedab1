#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``photon_ml_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (so any failure exits non-zero):

1. the card: its name, and its name and power limit from ``nvidia-smi``;
2. the kernel build from ``photon_ml_tpu_torch/ops/csrc`` (nvcc, sm_90a);
3. the hand-written ``multiply_prefix_sum`` kernel (float64 prefix of a
   float32 product) against its plain PyTorch version and a per-tile
   float64 reference, on the card, at the
   main path's nnz and at a ragged size, with and without values; its
   bit-for-bit determinism; ``csc_transpose_apply_kernel`` against a
   float64 reference on all-positive ``d``; and the kernel's, the plain
   version's and ``torch.cumsum``'s times beside the memory bound;
4. a small fit on the card against the same fit in float64 on the CPU;
5. the main path at full width: a Criteo-shaped sparse logistic regression
   (n=2^21 rows, d=2^18 features, k=39 implicit-ones nonzeros per row,
   float32) fitted with L-BFGS for 20 iterations at tolerance 0 through
   ``fit_distributed(..., sparse_grad="csc_kernel")``. The kernel's launch
   count is reset just before the fit and read just after (it must be
   iterations + 1), and the final ``w`` must agree with the plain ``"csc"``
   fit of the same data within 1e-3 relative L2;
6. OWL-QN on the same data (l2=1, l1=10, which leaves part of ``w`` at
   zero), 20 iterations at tolerance 0 through ``"csc_kernel"``: the kernel
   launches exactly iterations + 1 times (the line-search trials take the
   value alone), and ``w`` agrees with the plain ``"csc"`` fit within 1e-3;
7. TRON with the Jacobi preconditioner on the same data, at most 10 outer
   iterations at tolerance 0: at least 2 * iterations + 1 launches (every
   gradient, CG step and preconditioner pass goes through the kernel), two
   runs bit-identical, ``w`` within 1e-3 of the plain ``"csc"`` fit;
8. L-BFGS with ``line_search="full"`` at n=2^15, d=2^14 (20 iterations):
   ``w`` within 1e-3 of the margin-path fit; then the phase-5 model's
   scores: ``device_auc`` on the card (float64) within 1e-6 of the host
   ``evaluators.auc``, and ``histogram_auc`` within 1e-3.

Each fit's launch count is set to 0 just before it and read just after.

The last three lines are the card's name and power limit as ``nvidia-smi``
gives them, a ``{"kernels": [...]}`` JSON object, and
``{"ok": true, "device": {...}}``. Without CUDA the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

N_ROWS, DIM, K, ITERS = 1 << 21, 1 << 18, 39, 20
N_SMALL, DIM_SMALL = 1 << 15, 1 << 14  # the CPU-shape cross-check
L1 = 10.0  # leaves part of w at zero at this data's density
TRON_ITERS = 10
SEED = 0
TOL_SCAN = 1e-5  # |err_i| <= TOL_SCAN * cumsum(|x|)_i within the tile
TOL_APPLY = 1e-4  # relative error of X^T d on all-positive d
TOL_FIT = 1e-3  # relative L2 difference of w between two fits
TOL_AUC = 1e-6  # device_auc against the host float64 auc
TOL_HIST_AUC = 1e-3  # the 4096-bin histogram AUC against the host auc
# peak device-memory rate and float32 (non-tensor-core) rate, by card
# (NVIDIA data sheets, SXM parts)
PEAKS = {"H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no peak rates known for {name!r}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls, after
    one warm-up call, timed with CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tile_reference(x64: torch.Tensor, tile: int):
    """Per-tile inclusive prefix sums of a float64 product and of its
    absolute values (the error scale)."""
    from photon_ml_tpu_torch.ops.kernels import multiply_prefix_sum_plain

    ref = multiply_prefix_sum_plain(None, x64, tile)[0]
    scale = multiply_prefix_sum_plain(None, x64.abs(), tile)[0]
    return ref, scale


def check_scan(nnz: int, with_values: bool, gen, dev):
    """The kernel and the plain version against the float64 reference, the
    kernel's determinism and its totals; returns the kernel's max abs
    error."""
    from photon_ml_tpu_torch.ops.kernels import (
        TILE, multiply_prefix_sum, multiply_prefix_sum_plain,
    )

    d = torch.randn(nnz, generator=gen, device=dev)
    values = torch.randn(nnz, generator=gen, device=dev) if with_values else None
    x64 = d.double() if values is None else values.double() * d.double()
    ref, scale = tile_reference(x64, TILE)
    local, totals, tile = multiply_prefix_sum(values, d)
    again = multiply_prefix_sum(values, d)
    torch.cuda.synchronize()
    plain = multiply_prefix_sum_plain(values, d, TILE)[0]
    n_tiles = max(-(-nnz // TILE), 1)
    if tile != TILE or local.shape != (n_tiles * TILE,) or totals.shape != (n_tiles,):
        raise RuntimeError(f"kernel output shape {tuple(local.shape)} "
                           f"{tuple(totals.shape)} for nnz={nnz}")
    if not (torch.equal(local, again[0]) and torch.equal(totals, again[1])):
        raise RuntimeError(f"kernel not deterministic at nnz={nnz}")
    if not torch.equal(totals, local.view(n_tiles, TILE)[:, -1]):
        raise RuntimeError("kernel totals differ from each tile's last element")
    errs = {}
    for name, out in (("kernel", local), ("plain", plain)):
        err = (out.double() - ref).abs()
        bad = int((err > TOL_SCAN * scale).sum())
        if bad or not torch.isfinite(out).all():
            raise RuntimeError(
                f"{name} scan off at nnz={nnz} values={with_values}: {bad} "
                f"elements beyond {TOL_SCAN} * cumsum|x|, max err "
                f"{float(err.max()):.3e}")
        errs[name] = float(err.max())
    print(f"scan nnz={nnz} values={with_values}: max abs err kernel "
          f"{errs['kernel']:.3e} plain {errs['plain']:.3e} "
          f"(tol {TOL_SCAN} * cumsum|x| per tile); two runs bit-identical")
    return errs["kernel"]


def time_scan(nnz: int, gen, dev, peaks):
    """Kernel, plain and torch.cumsum times at the main path's shape
    (implicit ones, float32), and the bound for the same work."""
    from photon_ml_tpu_torch.ops.kernels import (
        TILE, multiply_prefix_sum, multiply_prefix_sum_plain,
    )

    d = torch.randn(nnz, generator=gen, device=dev)
    n_tiles = max(-(-nnz // TILE), 1)
    padded = torch.zeros(n_tiles * TILE, device=dev)
    padded[:nnz] = d
    view = padded.view(n_tiles, TILE)
    reps = 20
    kernel_ms = cuda_ms(lambda: multiply_prefix_sum(None, d), reps)
    plain_ms = cuda_ms(lambda: multiply_prefix_sum_plain(None, d, TILE), reps)
    library_ms = cuda_ms(
        lambda: torch.cumsum(view, dim=1, dtype=torch.float64), reps)
    # read the float32 d_sorted once, write the float64 local and totals
    # once; one add per element
    nbytes = 4 * nnz + 8 * (n_tiles * TILE + n_tiles)
    bw, flops = peaks
    bytes_ms, ops_ms = nbytes / bw * 1e3, nnz / flops * 1e3
    return {
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bytes": nbytes,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def check_apply(csc, n_rows, gen, dev):
    """X^T d through the kernel against a float64 reference on all-positive
    d."""
    from photon_ml_tpu_torch.ops.kernels import csc_transpose_apply_kernel
    from photon_ml_tpu_torch.types import csc_transpose_apply

    d = torch.rand(n_rows, generator=gen, device=dev) + 0.5
    got = csc_transpose_apply_kernel(csc, d).double()
    ref = csc_transpose_apply(csc, d.double())
    rel = float(((got - ref).abs() / ref.clamp(min=1e-30)).max())
    if not rel < TOL_APPLY:
        raise RuntimeError(f"csc_transpose_apply_kernel rel err {rel:.3e} "
                           f">= {TOL_APPLY}")
    print(f"csc_transpose_apply_kernel vs float64, all-positive d: max rel "
          f"err {rel:.3e} (tol {TOL_APPLY})")


def make_data(n_rows, dim, k, gen, dev):
    """Criteo-shaped implicit-ones data drawn on the card: labels are
    Bernoulli(sigmoid(x . w_true)) with w_true ~ N(0, 0.5^2)."""
    indices = torch.randint(0, dim, (n_rows, k), generator=gen, device=dev,
                            dtype=torch.int32)
    w_true = torch.randn(dim, generator=gen, device=dev) * 0.5
    logits = w_true[indices].sum(dim=1)
    labels = (torch.rand(n_rows, generator=gen, device=dev)
              < torch.sigmoid(logits)).float()
    return indices, labels


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def check_small_fit(gen, dev):
    """A small fit through the kernel on the card against the same fit in
    float64 on the CPU (plain versions)."""
    from photon_ml_tpu_torch.ops.objective import make_objective
    from photon_ml_tpu_torch.optimize.common import OptimizerConfig
    from photon_ml_tpu_torch.parallel.data_parallel import fit_distributed
    from photon_ml_tpu_torch.types import SparseFeatures, make_batch

    indices, labels = make_data(1 << 12, 1 << 10, K, gen, dev)
    cfg = OptimizerConfig(max_iters=10, tolerance=0.0)
    fits = {}
    for where, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        batch = make_batch(SparseFeatures(indices, None, 1 << 10), labels,
                           dtype=dtype, device=where)
        fits[where] = fit_distributed(
            make_objective("logistic"), batch,
            torch.zeros(1 << 10, dtype=dtype, device=where), l2=1.0,
            config=cfg, sparse_grad="csc_kernel")
    rel = rel_l2(fits[dev].w, fits["cpu"].w)
    if not rel <= TOL_FIT or fits[dev].iterations != 10:
        raise RuntimeError(f"small fit: card f32 vs CPU f64 rel {rel:.3e}, "
                           f"{fits[dev].iterations} iterations")
    print(f"small fit (n=4096, d=1024, 10 iters): card f32 csc_kernel vs CPU "
          f"f64 rel L2 {rel:.3e} (tol {TOL_FIT})")


def run_counted(fn):
    """Run the fit ``fn()`` with the kernel's launch count set to 0 just
    before and read just after; returns (result, seconds, launches)."""
    from photon_ml_tpu_torch.ops.kernels import multiply_prefix_sum

    torch.cuda.synchronize()
    multiply_prefix_sum.launches = 0
    t0 = time.perf_counter()
    res = fn()
    float(res.value)  # scalar fetch: the fit has run
    return res, time.perf_counter() - t0, multiply_prefix_sum.launches


def check_descent(name, res, dim, f0):
    """Finite output of the right shape, a loss history that never rises
    and ends below its start value ``f0``."""
    lh = res.loss_history.cpu()[:res.iterations]
    if not (res.iterations > 0 and torch.isfinite(lh).all()
            and torch.isfinite(res.w).all() and res.w.shape == (dim,)):
        raise RuntimeError(f"{name}: output not finite or of the wrong shape")
    if not (lh[-1] < f0 and bool((lh[1:] <= lh[:-1]).all())):
        raise RuntimeError(f"{name}: loss did not fall: {lh.tolist()}")


def check_plain(name, res, plain):
    rel = rel_l2(res.w, plain.w)
    print(f"{name}: |w_kernel - w_csc| / |w_csc| = {rel:.3e} (tol "
          f"{TOL_FIT}); the plain csc fit ran {plain.iterations} iterations")
    if not rel <= TOL_FIT:
        raise RuntimeError(f"{name}: kernel fit differs from the plain fit: "
                           f"{rel:.3e}")


def phase_owlqn(fit, f0, smi):
    """OWL-QN at full width: one kernel launch per iteration plus one."""
    from photon_ml_tpu_torch.optimize.common import OptimizerConfig

    cfg = OptimizerConfig(max_iters=ITERS, tolerance=0.0)
    fit("csc_kernel", optimizer="owlqn", l1=L1,
        config=OptimizerConfig(max_iters=1, tolerance=0.0))  # warm-up
    res, sec, launches = run_counted(
        lambda: fit("csc_kernel", optimizer="owlqn", l1=L1, config=cfg))
    zeros = int((res.w == 0).sum())
    print(f"fit owlqn csc_kernel (l1={L1}): {res.iterations} iterations, "
          f"{launches} kernel launches, {res.host_syncs} host syncs, "
          f"{zeros} of {DIM} coefficients zero, objective "
          f"{float(res.value):.4f}, {sec:.4f} s on {smi}")
    check_descent("owlqn", res, DIM, f0)
    if launches != res.iterations + 1:
        raise RuntimeError(f"owlqn: {launches} kernel launches, not "
                           f"{res.iterations + 1}")
    if not 0 < zeros < DIM:
        raise RuntimeError(f"owlqn: {zeros} zero coefficients")
    t0 = time.perf_counter()
    plain = fit("csc", optimizer="owlqn", l1=L1, config=cfg)
    float(plain.value)
    print(f"fit owlqn csc (plain): {time.perf_counter() - t0:.4f} s")
    check_plain("owlqn", res, plain)
    return launches


def phase_tron(fit, f0, smi):
    """TRON with the Jacobi preconditioner at full width: every gradient,
    CG step and preconditioner pass launches the kernel; bit-reproducible."""
    from photon_ml_tpu_torch.optimize.common import OptimizerConfig

    cfg = OptimizerConfig(max_iters=TRON_ITERS, tolerance=0.0)
    fit("csc_kernel", optimizer="tron",
        config=OptimizerConfig(max_iters=1, tolerance=0.0))  # warm-up
    res, sec, launches = run_counted(
        lambda: fit("csc_kernel", optimizer="tron", config=cfg))
    cg_steps = res.host_syncs - res.iterations  # one read per CG step
    print(f"fit tron csc_kernel: {res.iterations} outer iterations "
          f"(converged {res.converged}), {cg_steps} CG steps, {launches} "
          f"kernel launches, loss {float(res.value):.4f}, {sec:.4f} s on "
          f"{smi}")
    check_descent("tron", res, DIM, f0)
    if launches < 2 * res.iterations + 1:
        raise RuntimeError(f"tron: {launches} kernel launches, fewer than "
                           f"{2 * res.iterations + 1}")
    again = fit("csc_kernel", optimizer="tron", config=cfg)
    if not torch.equal(res.w, again.w):
        raise RuntimeError("tron: two csc_kernel runs differ")
    print("fit tron csc_kernel: two runs bit-identical")
    t0 = time.perf_counter()
    plain = fit("csc", optimizer="tron", config=cfg)
    float(plain.value)
    print(f"fit tron csc (plain): {time.perf_counter() - t0:.4f} s")
    check_plain("tron", res, plain)
    return launches


def phase_full_line_search(gen, dev, smi):
    """L-BFGS through the full line search at the CPU shape, against the
    margin-path fit of the same data."""
    from photon_ml_tpu_torch.ops.objective import make_objective
    from photon_ml_tpu_torch.optimize.common import OptimizerConfig
    from photon_ml_tpu_torch.parallel.data_parallel import (
        build_csc, fit_distributed,
    )
    from photon_ml_tpu_torch.types import SparseFeatures, make_batch

    indices, labels = make_data(N_SMALL, DIM_SMALL, K, gen, dev)
    batch = make_batch(SparseFeatures(indices, None, DIM_SMALL), labels,
                       device=dev)
    csc = build_csc(batch)
    w0 = torch.zeros(DIM_SMALL, device=dev)

    def fit(line_search, iters=ITERS):
        return fit_distributed(
            make_objective("logistic"), batch, w0, l2=1.0,
            config=OptimizerConfig(max_iters=iters, tolerance=0.0),
            sparse_grad="csc_kernel", line_search=line_search,
            precomputed_csc=csc)

    fit("full", iters=1)  # warm-up
    res, sec, launches = run_counted(lambda: fit("full"))
    margin = fit("margin")
    rel = rel_l2(res.w, margin.w)
    print(f"fit lbfgs line_search=full csc_kernel (n={N_SMALL}, "
          f"d={DIM_SMALL}): {res.iterations} iterations, {launches} kernel "
          f"launches, {res.host_syncs} host syncs, {sec:.4f} s on {smi}; "
          f"|w_full - w_margin| / |w_margin| = {rel:.3e} (tol {TOL_FIT})")
    check_descent("lbfgs full", res, DIM_SMALL, N_SMALL * math.log(2.0))
    if res.iterations != ITERS or not rel <= TOL_FIT:
        raise RuntimeError(f"full line search: {res.iterations} iterations, "
                           f"rel {rel:.3e} to the margin fit")
    if launches < res.iterations + 1:
        raise RuntimeError(f"full line search: {launches} kernel launches")
    return launches


def phase_auc(w, batch, smi):
    """The phase-5 model's scores on the card: exact and histogram AUC
    against the host float64 evaluator."""
    import numpy as np

    from photon_ml_tpu_torch.evaluation.device import (
        device_auc, histogram_auc,
    )
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.models import Coefficients, GeneralizedLinearModel

    scores = GeneralizedLinearModel(Coefficients(w)).score(batch.features)
    labels = batch.labels
    # the host evaluator computes in float64; so does the exact check here
    s64, l64 = scores.double(), labels.double()
    host = auc(s64.cpu().numpy(), l64.cpu().numpy(),
               np.ones(scores.shape[0]))
    results = {}
    for name, fn in (
            ("device_auc f64", lambda: device_auc(s64, l64)),
            ("device_auc f32", lambda: device_auc(scores, labels)),
            ("histogram_auc f32", lambda: histogram_auc(scores, labels))):
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = float(fn())
        results[name] = (value, (time.perf_counter() - t0) * 1e3)
    for name, (value, ms) in results.items():
        print(f"{name} of the phase-5 model's {scores.shape[0]} scores: "
              f"{value:.9f}, |diff| to host auc {abs(value - host):.3e}, "
              f"{ms:.3f} ms on {smi}")
    if not abs(results["device_auc f64"][0] - host) <= TOL_AUC:
        raise RuntimeError(f"device_auc differs from the host auc {host}")
    if not abs(results["histogram_auc f32"][0] - host) <= TOL_HIST_AUC:
        raise RuntimeError(f"histogram_auc differs from the host auc {host}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from photon_ml_tpu_torch.ops import kernel_build
    from photon_ml_tpu_torch.ops.kernels import TILE, multiply_prefix_sum
    from photon_ml_tpu_torch.ops.objective import make_objective
    from photon_ml_tpu_torch.optimize.common import OptimizerConfig
    from photon_ml_tpu_torch.parallel.data_parallel import (
        build_csc, fit_distributed,
    )
    from photon_ml_tpu_torch.types import SparseFeatures, make_batch

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {kind} | nvidia-smi: {smi}")
    peaks = card_peaks(smi)

    t0 = time.perf_counter()
    lib_path = kernel_build.build()
    kernel_build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    nnz_main = N_ROWS * K
    max_err = 0.0
    for nnz in (nnz_main, 3 * TILE + 17):
        for with_values in (False, True):
            max_err = max(max_err, check_scan(nnz, with_values, gen, dev))
    timing = time_scan(nnz_main, gen, dev, peaks)
    print(f"multiply_prefix_sum at nnz={nnz_main} (implicit ones, f32): "
          f"kernel {timing['kernel_ms']:.4f} ms, plain "
          f"{timing['plain_ms']:.4f} ms, torch.cumsum "
          f"{timing['library_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms "
          f"({timing['bytes'] / 1e6:.1f} MB by {timing['bound_by']}) on "
          f"{smi}")

    check_small_fit(gen, dev)

    indices, labels = make_data(N_ROWS, DIM, K, gen, dev)
    batch = make_batch(SparseFeatures(indices, None, DIM), labels, device=dev)
    obj = make_objective("logistic")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    csc = build_csc(batch)
    torch.cuda.synchronize()
    print(f"build_csc (nnz={nnz_main}): {time.perf_counter() - t0:.3f} s")
    check_apply(csc, N_ROWS, gen, dev)

    w0 = torch.zeros(DIM, device=dev)
    cfg = OptimizerConfig(max_iters=ITERS, tolerance=0.0)

    def fit(mode, config=cfg, **kw):
        return fit_distributed(obj, batch, w0, l2=1.0, config=config,
                               sparse_grad=mode, precomputed_csc=csc, **kw)

    fit("csc_kernel", OptimizerConfig(max_iters=2, tolerance=0.0))  # warm-up
    torch.cuda.synchronize()
    multiply_prefix_sum.launches = 0
    t0 = time.perf_counter()
    res = fit("csc_kernel")
    value = float(res.value)  # scalar fetch: the fit has run
    elapsed = time.perf_counter() - t0
    launches = multiply_prefix_sum.launches
    lh = res.loss_history.cpu()
    f0 = N_ROWS * math.log(2.0)  # the loss at w0 = 0
    print(f"fit csc_kernel: {res.iterations} iterations, {launches} kernel "
          f"launches, {res.host_syncs} host syncs, loss {f0:.1f} -> "
          f"{value:.4f}, {elapsed:.4f} s, "
          f"{N_ROWS * res.iterations / elapsed:.1f} example-passes/s on {smi}")
    if res.iterations != ITERS:
        raise RuntimeError(f"fit ran {res.iterations} iterations, not {ITERS}")
    if launches != ITERS + 1:
        raise RuntimeError(f"{launches} kernel launches, not {ITERS + 1}")
    if not (torch.isfinite(lh).all() and torch.isfinite(res.w).all()
            and res.w.shape == (DIM,)):
        raise RuntimeError("fit output not finite or of the wrong shape")
    if not (lh[-1] < lh[0] < f0 and bool((lh[1:] <= lh[:-1]).all())):
        raise RuntimeError(f"loss did not fall: {lh.tolist()}")

    t0 = time.perf_counter()
    res_csc = fit("csc")
    float(res_csc.value)
    elapsed_csc = time.perf_counter() - t0
    rel = rel_l2(res.w, res_csc.w)
    print(f"fit csc (plain): {elapsed_csc:.4f} s; |w_kernel - w_csc| / "
          f"|w_csc| = {rel:.3e} (tol {TOL_FIT})")
    if not rel <= TOL_FIT:
        raise RuntimeError(f"kernel fit differs from the plain fit: {rel:.3e}")

    launches_by_path = {
        "lbfgs_margin": launches,
        "owlqn": phase_owlqn(fit, f0, smi),
        "tron": phase_tron(fit, f0, smi),
        f"lbfgs_full_n{N_SMALL}_d{DIM_SMALL}": phase_full_line_search(
            gen, dev, smi),
    }
    phase_auc(res.w, batch, smi)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "multiply_prefix_sum",
        "route": "cuda",
        "source": "photon_ml_tpu_torch/ops/csrc/multiply_prefix_sum.cu",
        "replaces": "photon_ml_tpu/ops/pallas_kernels.py:34",
        "launches": launches,
        "launches_by_path": launches_by_path,
        "max_abs_err": max_err,
        "max_err": max_err,
        "tol": f"{TOL_SCAN} * cumsum(|x|) per tile",
        "ms": timing["kernel_ms"],
        "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
