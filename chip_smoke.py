#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``photon_ml_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (so any failure exits non-zero):

1. the card: its name, and its name and power limit from ``nvidia-smi``;
2. the kernel build from ``photon_ml_tpu_torch/ops/csrc`` (nvcc, sm_90a);
3. the hand-written kernels. ``multiply_prefix_sum`` (float64 prefix of a
   float32 product; the TPU kernel's literal counterpart, on no path)
   against its plain PyTorch version and a per-tile float64 reference, at
   the main path's nnz and at a ragged size, with and without values, and
   in float64; its bit-for-bit determinism; its, the plain version's and
   ``torch.cumsum``'s times beside the memory bound. Then, on the main
   path's view, ``csc_column_sums`` (the path's ``X^T d`` in one pass):
   ``csc_transpose_apply_kernel`` against a float64 reference on
   all-positive ``d``; the kernel and its plain version within the
   per-column gate (one float32 ulp of the float64 column sum ``|ref_j|``
   plus ``1e-12 * sum_j |x|``), two runs bit-identical, empty columns 0;
   its, the plain version's, the previous route's (the torch gather,
   ``multiply_prefix_sum`` and ``blocked_boundary_combine``, in turns with
   the kernel) and cuSPARSE's SpMV times beside its bound; one call adds
   at most 32 MB of device memory above its inputs; one column of 2^24
   nonzeros (8,192 ranges) within the gate; a refused launch raises and
   is not a device loss. Phases 9, 10 and 14 check and time it the same
   way at the GLM driver's shape, at an out-of-core chunk's, at the
   path's float64 with-values view and at a streamed chunk's;
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

9. the GLM driver (``photon_ml_tpu_torch.cli.glm_driver.main``) in this
   process, on a Criteo-shaped Avro dataset that the port's own writer
   builds from a seed in 10 worker processes: 39 categorical features per
   row (``c0`` ... ``c38``), hashed into 2^18 slots plus the intercept (k =
   40 explicit-values nonzeros per row), labels from a planted logistic
   model over the hashed slots, 2^17 training rows in 8 files (cut from the
   main path's 2^21 so that the pure-Python writer finishes in under half
   a minute) and
   2^15 validation rows. Lambda grid [10, 1, 0.1], L-BFGS, 20 iterations at
   tolerance 0, AUC on the validation data. It prints which Avro decoder
   ran, each stage's seconds from ``photon.log.jsonl``, and per lambda the
   iterations, fit seconds, kernel launches, loss and AUC. Gates: the
   kernel launches at least once per lambda; the first lambda's ``w`` is
   within 1e-3 relative L2 of the plain ``"csc"`` fit of the same batch;
   ``best/``, reloaded by ``load_game_model``, scores the validation rows
   exactly as the run did; the best validation AUC is above 0.6. The
   kernel is checked and timed at this path's view and at an out-of-core
   chunk's (its first 2^14 rows).

10. the screened regularization path (``optimize.path.PathSolver``) on the
    main path's rows and columns: elastic net (alpha 0.9), 20 lambdas
    geometric from ``lambda_max()`` down to 1e-2 of it, walked with
    ``screen="strong"`` and with ``screen="off"``, first in float32 with the
    GLM driver's default solver settings (100 iterations, tolerance 1e-7),
    then in float64 over the grid's first 3 lambdas (OWL-QN, at most 200
    iterations per solve at tolerance 0). Per lambda it prints the candidates, the restricted width, the KKT
    rounds, both solve times and how far the two walks' solutions differ.
    Gates, in both dtypes: every lambda certified; at the coordinates
    each restricted solve froze a fresh full gradient within the KKT slack;
    the kernel's full and restricted gradients at the last restricted
    solution equal to the plain ``"csc"`` ones (rel L2 1e-6 in float32,
    1e-10 in float64). In float64 also: the kernel's float64 with-values
    variant (the restricted solves') checked and timed on the main view
    with float64 values, the screened support
    identical to the unscreened one and ``w`` within 1e-3 relative L2;
11. the random-effect bucket solve at ``scripts/bench_game.py``'s chip
    shape (100,000 entities x 64 rows x 32 local dims, 8 nonzeros per row,
    float32, drawn on the card; 10 iterations at tolerance 0, l2 0.5) by the
    batched Newton solver, the batched L-BFGS and the batched TRON:
    entities per second of each, what ``optimizer="auto"`` resolves to, and
    the first 1,024 entities re-solved on the CPU in float64 by the same
    solver (each within 1e-3 relative L2);
12. GAME coordinate descent through ``GameEstimator.fit`` at
    ``scripts/bench_game.py``'s CD shape: n = 2^17 rows, d = 2^16, k = 39
    implicit ones, user ids uniform over 100,000 and item ids over 10,000,
    labels from a planted logistic model; a fixed coordinate (l2 1, 10
    iterations at tolerance 0) and two random ones (l2 1, 5 iterations, 2
    buckets), 3 sweeps, AUC on 2^15 validation rows. It prints the host
    time to build the random-effect buckets, each coordinate's seconds per
    sweep, entities solved and kernel launches per fixed fit. Gates: every
    fixed fit launches the kernel; the first sweep's fixed ``w`` within
    1e-3 of a run with ``sparse_grad="csc"``; ``GameTransformer`` scores
    the validation rows as CD's final validation scores within 1e-5;
13. the GAME command-line path at phase 12's shape: the same rows written
    as Avro files of named features (``f0`` ... ``f65535``, value 1, plus
    the intercept the driver adds) with ``user`` and ``item`` in
    ``metadataMap``, by 10 spawn workers; ``feature_indexing_driver.main``
    builds the index map; ``game_training_driver.main`` trains phase 12's
    coordinates (``per_item`` by the batched TRON) for 3 sweeps, then one
    Bayesian tuning round of the fixed coordinate's reg weight (two until
    phases 14-16 were added; cut to keep the script near 500 s), and saves
    ``best``; ``game_scoring_driver.main`` scores the validation files with
    the saved model. It prints each driver stage's seconds, the host
    bucket builds, each sweep's seconds per coordinate and each fixed fit's
    launches. Gates: every fixed fit launches the kernel; the tuning round
    logged; the scoring driver's scores of the reloaded ``best`` within
    1e-5 of the training run's final validation scores of the selected
    configuration, and its AUC within 1e-6 of ``driver_done``'s.

14. the streamed main path (``parallel.streaming.fit_streaming``), run
    after phase 8: phase 5's rows as numpy on the host, cut by
    ``make_host_chunks`` into 32 chunks of 2^16 rows (9.98 MB of indices
    each), prefetch depth 2, fed to the card through the pinned ring.
    Gates: (a) one streamed gradient pass at w = 0 and at phase 5's final
    w against the in-memory kernel pass on the whole batch, f within 1e-6
    relative and ``|g - g_mem| <= 1e-5 |g_mem(w = 0)|``; (b) the L-BFGS
    (margin, 20 iterations), TRON (10) and OWL-QN (l1 = 10, 20) fits
    through ``"csc_kernel"`` each within 1e-3 relative L2 of the same fit
    through plain ``"csc"`` (the in-memory gate of phases 5-7; it prints
    whether the two are bit-identical: the kernel sums each column in
    float64, ``"csc"`` differences float64 tile prefixes, so a column sum
    can round to another float32); (c) L-BFGS at depth 0 equal to depth 2 bit for
    bit; (d) kernel launches = 32 x the fit's gradient, Hessian-vector and
    diagonal passes; (e) at n = 2^15, d = 2^14, the streamed and the
    in-memory L-BFGS, both 100 iterations at tolerance 0 in float32 (the
    float32 floor), within 1e-3 relative L2 of ``w``. It prints each fit's
    seconds and seconds per pass, ``StreamStats``, the host-to-device rate,
    host reads per pass, and per chunk the kernel checked and timed on
    the first chunk's view (2,555,904 nonzeros) as in phase 3, the CSC
    sort's and a pinned copy's ms;
15. the GLM driver out of core, run inside phase 9's temporary directory
    on its files: lambda 1.0, 200 iterations at the driver's default
    tolerance 1e-7 (the streamed and the in-memory L-BFGS search their
    lines differently, so only fits near the optimum are comparable),
    chunks of 2^14 rows, four runs: in memory, ``--streaming``, then
    ``--out-of-core --chunk-cache-dir`` twice (cold, warm). Gates: the
    warm run's model files equal the cold run's byte for byte; the
    out-of-core ``w`` within 1e-5 relative L2 of the ``--streaming`` one;
    every streamed run's AUC within 1e-3 of the in-memory run's, and
    every run launches the kernel. It prints each stage's seconds and
    the peak-RSS growth beside the ring's bound;
16. GAME with the fixed coordinate streamed, run after phase 13: phase
    12's data and coordinates, the fixed coordinate in chunks of 2^15 rows,
    one sweep through ``GameEstimator.fit`` sharing phase 12's
    random-effect buckets. Gates: kernel launches = 4 chunks x the fixed
    fit's passes, and the AUC within 1e-3 of phase 12's first sweep.

17. multi-process, after phase 16 (``parallel.mesh``,
    ``parallel.multihost``), three legs and the driver's:
    (a) a one-rank group over NCCL in this process
    (``initialize_multihost("127.0.0.1:<free port>", 1, 0)``, backend
    ``cpu:gloo,cuda:nccl``) and phase 5's fit through
    ``fit_distributed(..., sparse_grad="csc_kernel", mesh=make_mesh({"data":
    1}))``: ITERS + 1 launches and ``w`` within 1e-3 of phase 5's (0
    expected); (b) two ranks of this script on the one card
    (``--mp-rank``), over gloo on CUDA tensors (NCCL refuses two ranks on
    one device): each checks gloo's all_reduce and all_gather on CUDA
    float32 and float64 tensors, shards phase 5's data (written by this
    process) once, keeping its 2^20 rows on the card, and runs L-BFGS
    (margin, 20 iterations) and TRON (10) on that block through
    ``fit_shard``, and the streamed L-BFGS over its span (16 chunks of 2^16
    rows), all through ``"csc_kernel"``; the ranks' ``w`` equal bit for
    bit, each fit within 1e-3 of phase 5's, 7's or 14's, L-BFGS launching
    ITERS + 1 times, TRON 2 + host reads + accepted steps (its one-device
    cost model, the accepted steps read from its loss history, on each
    rank and on one device) and the streamed fit 16 times per kernel
    pass; each rank prints its launches, seconds, the seconds in
    collectives and its host reads per fit; (c) in the same two ranks, one
    GAME sweep of phase 12's data and coordinates with the random
    coordinates sharded over ``{"data": 1, "entity": 2}``: the
    coefficients within 1e-5 of a one-rank sweep and the AUC within 1e-6.
    The driver leg, inside phase 9's directory: the GLM driver with
    ``--num-processes 1 --process-id 0 --coordinator-address`` on phase 9's
    files (one lambda) writes a model byte-identical to the run without
    the flags.
18. recovery, after phase 17 (``parallel.resilience``, ``recovery``,
    ``entity_shard``, ``fault_injection``), four legs:
    (a) two ranks of this script on the one card over gloo
    (``--recovery-rank``), each building its own half of phase 12's
    random-effect buckets once (``EntityShardSpec(2, rank)``, a
    ``dataset_cache``) and running 3 entity-sharded sweeps of phase 12's
    data and coordinates in float32 through ``GameEstimator.fit``, twice:
    uninterrupted, then with ``Fault(site="cd.step", kind="raise",
    process=1, at=4)`` (sweep 1's ``per_user`` step, after sweep 1's
    commit) under a fresh ``RecoveryManager(max_rank_failures=0)``. Gates:
    one rollback and one recovery; the second run's coefficients and AUC
    history bit-equal to the first's on each rank and the ranks equal;
    its kernel launches the first run's plus the rolled-back sweep's
    fixed fit; the first run within 1e-3 relative L2 (coefficients) and
    1e-3 (AUC) of phase 12's one-rank sweeps: the sharded buckets' widths
    differ from one rank's, so their float32 sums round apart (ROADMAP
    Queue 3). Each rank prints the launches, the
    snapshot and recovery seconds and the rows and bytes exchanged per
    sweep. (b) Inside phase 9's directory, the GLM driver at
    ``--num-processes 1`` with a grid of 2 lambdas: uninterrupted; killed
    in a child process with ``PHOTON_ML_TPU_FAULTS=[{"site": "glm.lambda",
    "kind": "device_loss", "at": 1}]`` (exit 75, ``RESUME_GLM.npz``
    left); rerun with ``--auto-resume`` (exit 0, the marker consumed,
    ITERS + 1 launches: only the second lambda is fitted), its models
    byte-identical to the uninterrupted run's. (c) In the same two ranks
    as (a), last: rank 1 stalls at ``cd.step`` for T + 30 s with
    ``PHOTON_ML_TPU_BARRIER_TIMEOUT_S=T`` (T = 10): rank 0 raises
    ``WatchdogTimeout`` within T + 5 s of entering its barrier,
    ``classify_failure`` maps it to ``rank_loss`` and the production
    transport, which cannot shrink, escalates it; this process reaps both
    ranks. (d) A child process (``--sticky-error``) runs the GLM driver on
    the card over a grid of 2 lambdas and provokes a device-side assert
    (an out-of-range CUDA index, then a synchronize) as the second lambda
    starts: torch's ``torch.AcceleratorError`` must satisfy
    ``is_device_loss``, the driver must exit 75 with a marker holding the
    first lambda (written without reading the card), a later CUDA call
    must fail too, and the injected ``device_loss`` must have the same
    type and message form; the kernel launched on an empty grid
    (a real, non-sticky ``cudaErrorInvalidConfiguration``) must not
    satisfy it, and the card must go on working.

19. observability and the device tier of serving, three legs:
    (a) tracing on the training paths: inside phase 9's directory, phase
    9's GLM driver run twice more with ``--path-screen strong`` (its L2
    grid: every lambda a warm-started full-width solve through
    ``PathSolver``) and ``--profile-dir``, untraced and with
    ``--trace-dir``; after phase 18, phase 12's GAME fit twice more,
    untraced and under the span tracer. Each pair differs in the tracer
    alone and runs under torch's sync debug mode, which counts every call
    that makes the host wait for the card. Gates: each trace file passes
    the port's ``trace_cli validate``; one ``glm.path_lambda`` span per
    lambda and one ``cd.coordinate`` span per coordinate per sweep, as
    many as the training metrics count; the profiles name the
    ``csc_column_sums`` kernel; the launches, the counted host reads (the
    driver's per-lambda log, ``re_solver_host_reads``) and the
    synchronizing calls equal the untraced run's, and the launches phase
    9's and phase 12's; the models equal theirs bit for bit. It prints
    each run's wall time. (b) Inside phase 13's
    directory, the saved model's per-user coordinate through
    ``ModelDirCoefficientStore`` -> ``EntityCoefficientLRU`` (one pass over
    the file for the validation users, which learns the known ids) into a
    ``PagedCoefficientTable`` of 16 pages of 256 rows on the card (4,096
    resident users, dim 2^16 plus the intercept, 1.07 GB of float32);
    phase 12's validation rows (39 features and the intercept, about 27%
    of the users unknown to the model) scored in batches of 32 and of
    4,096: each batch looks its users up, faults the missing through the
    LRU, installs them and launches ``paged_gather_score`` on the
    snapshot (users an install evicted again go round once more). Gates:
    the scores within 1e-5 of ``score_random_effect`` on the same
    coefficients and rows; unknown users exactly 0; pages evicted; one
    launch per round; a snapshot taken before an evicting install scores
    bit-equal after it. It prints the rows per second, the installs'
    median times with and without a copy of the table, and one copy's
    device time. (c) ``paged_gather_score`` on the float32 table and a
    float64 copy at (b)'s shapes (B = 32 and 4,096, k = 40), at the
    served rung through the pointer entry (B = 64, k = 64: the first 64
    rows padded with index 0 and value 0, as the session pads them) and
    at all 2^15 validation rows with slots drawn uniformly over the
    table's 4,096 rows from the seed (every row resident): bit for bit
    its ordered plain twin (``paged_gather_score_ordered_plain``) and its
    other entry, within 4 eps of the row's sum of |terms| of its plain
    version and of its previous design, unknown rows 0, two calls
    bit-identical; then, per call and on the device's own clock, its and
    its previous design's times in turns (previous, new, new, previous),
    the plain version's, ``embedding_bag``'s and an empty kernel's on the
    new grid (the floor no launch beats), beside the byte bound, and
    which of the bound and the floor is the larger.

20. the serving path (``serve/session.py``, ``batcher.py``,
    ``server.py``, ``cli/serving_driver.py``), inside phase 13's
    directory, beside phase 21's two lifecycle workers (PR 14 on): the
    serving driver as a subprocess (``--device cuda``, the
    script's own device) on the saved ``best`` model at full width (d =
    2^16 and the intercept, 100,000 users, 10,000 items), both random
    coordinates on paged tables (``--re-dense-dim-max 65537 --re-pages 16
    --re-page-rows 256``), ``--max-batch 64``, ``--coeff-cache-entries
    65536`` (every validation user and item stays in the LRU: without it
    each cold batch costs a pass of the Avro file), ``--trace-dir``. It
    warms the validation users and items with one ``POST
    /admin/membership`` carrying ``prefetchEntityIds`` (one store pass per
    coordinate), then sends phase 12's 2^15 validation rows as ``POST
    /score`` requests of 1-64 rows (sizes from the seed) from 4 client
    threads. Gates: every request 200 and every score within 1e-5 of the
    scoring driver's ``score_game_model`` scores of the same rows; the
    users the model does not know (about 27%) get the fixed-only margin
    (their ``per_user`` part exactly 0); ``/metrics`` shows one capture
    per rung of the ladder after warmup and no capture after it; the
    ``paged_gather_score`` launches equal twice the replays (one per
    random coordinate per round), and the replays at least the batches;
    an identical ``/admin/reload`` (``"force": true``) captures nothing,
    and 32 requests sent one at a time score bit for bit as before it;
    SIGTERM drains and the driver exits 0, its log ending with
    ``driver_done``. It prints the seconds to ready, of the prefetch and
    of the reload, rows/s, p50/p99 request latency, batches, replays and
    launches, and per rung the copy + replay + read-back time
    (``session.device_compute`` spans of the driver's trace). Then the
    kernel's pointer entry (``paged_gather_score_at``, the one the
    captured graphs launch) against its plain version, and bit for bit
    the direct entry and the ordered plain twin, at the served shape (B =
    64, k = 64), and its, the plain version's and ``embedding_bag``'s
    times.

21. the model lifecycle and multi-replica serving (``registry/``,
    ``serve/aserver.py``, ``serve/watcher.py``,
    ``cli/model_publish_driver.py``, the serving driver's registry and
    replica modes), inside phase 13's directory: (a) phase 13's training
    driver ran with ``--publish-to``: the registry holds v000001, LATEST,
    whose artifact fingerprints equal ``best/``'s; (b) the serving driver
    as a subprocess with ``--registry --replicas 2 --server async --hedge
    --watch-interval-s 1`` and phase 20's table flags on the card: the
    front door and two replica processes, each replica's
    ``/admin/membership`` prefetch of the served users and items at the
    same time, then the first 2^13 validation rows as requests of 1-64
    rows from 4 clients through the door and 128 of those requests one at
    a time; meanwhile two worker processes (``chip_smoke.py
    --registry-worker refused|delta``, started after phase 19 (c), so
    that their model reads and writes overlap phase 20): one publishes a candidate with the
    fixed effect negated through ``model_publish_driver`` with the
    validation files as gate data (AUC on the card, a tolerance of 0.01);
    the other builds the delta candidate (``best/`` with 1,024 seeded
    served users' per-user records scaled by 0.5), publishes it with
    ``--delta`` once the first candidate is in the registry, materializes
    it and gates it, and the gate's promotion waits until the door's
    v000001 traffic is done. Gates: the refused candidate exits 3 and LATEST stays v000001; the delta holds those
    users' records only; every request 200, every score within 1e-5 of
    the scoring driver's ``score_game_model`` under v000001 and of the
    gate's ``score_game_model`` of the materialized delta after it; both
    replicas' watchers serve the delta within 60 s of the promotion; the
    probes' per-user parts of the scaled users exactly halved and every
    other part bit-equal; per replica one capture per rung and none after
    (across the swap), the off-rung counters 0, launches twice the
    replays; SIGTERM: the door stops, each replica drains and exits 0, the
    driver exits 0, and its parent process never created a CUDA context.
    It prints the seconds to ready, to prefetch, to swap and to gate,
    rows/s, p50/p99 through the door, batches, replays and launches per
    replica, and the hedges fired.

Each fit's launch count (``csc_column_sums.launches``) is set to 0 just
before it and read just after (for phases 9, 13 and 15: before and after
each driver run; for phases 10 and 12: before and after each of the four
walks and the estimator's fit; in phases 17 and 18, in each rank's own
process). ``multiply_prefix_sum`` must not launch on any path: after
phase 3 its count may move only by the timings that call it by name, and
each rank of phases 17 and 18 ends with a count of 0.

``paged_gather_score.launches`` is set to 0 just before each of phase
19's scoring runs and read just after; in phase 20 the driver process's
count is read from its ``/metrics`` just before and just after the
scoring window, and in phase 21 each replica's from the door's
``/fd/metrics`` just before the first scoring window and just after the
last probe. Its comparisons and timings do not count; the previous
design has a count of its own (``paged_gather_score_previous.launches``)
and runs only by name in those timings.

The last three lines are the card's name and power limit as ``nvidia-smi``
gives them, a ``{"kernels": [...]}`` JSON object (all three kernels), and
``{"ok": true, "device": {...}}``. Without CUDA the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
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
# phase 9, the GLM driver: 8 training files of 2^14 rows, 2^15 validation
# rows written as 2 files, 39 hashed categorical features plus the intercept
DRIVER_FILES, DRIVER_FILE_ROWS, DRIVER_VAL_FILES = 8, 1 << 14, 2
DRIVER_FEATURES, DRIVER_HASH_DIM = 39, 1 << 18
DRIVER_GRID = ("10", "1", "0.1")
DRIVER_MIN_AUC = 0.6
# phase 10, the screened path: elastic net as in BENCH_path.json, 20
# lambdas from lambda_max down to 1e-2 lambda_max
PATH_ALPHA, PATH_LAMBDAS, PATH_SPAN = 0.9, 20, 1e-2
PATH_ITERS = 200  # per float64 solve, tolerance 0 (see phase_path)
# the float64 walks stop after the grid's first 3 lambdas, down to about
# 0.62 lambda_max (6 until the serving driver's phase 20 needed the time):
# the last 17 run in float32 as well, and the script's
# time limit holds phase 18 too
PATH_F64_LAMBDAS = 3
PATH_F32_ITERS, PATH_F32_TOL = 100, 1e-7  # the GLM driver's defaults
TOL_SCAN_F64 = 1e-12  # the float64 kernel: |err_i| <= this * cumsum|x|
# csc_column_sums: |err_j| <= TOL_COLUMN * sum_j |x| (+ one float32 ulp of
# |ref_j| for float32 outputs); one main-path call adds at most
# COLUMN_MEM_GATE bytes of device memory; the heavy-column case puts
# HEAVY_NNZ more nonzeros in one column of HEAVY_DIM than the spread ones
TOL_COLUMN = 1e-12
COLUMN_MEM_GATE = 32_000_000
HEAVY_NNZ, HEAVY_DIM = 1 << 24, 1 << 18
# multiply_prefix_sum launches made by name (checks and timings); every
# other launch of it after phase 3 would be a path's, and fails the run
EXPLICIT_MPS = [0]
SLEEP_CYCLES = 200_000_000  # about 0.1 s of the card's clock (device_ms)
TOL_GRAD = {torch.float32: 1e-6, torch.float64: 1e-10}  # rel L2 of a
# gradient through the kernel against the plain "csc" path, same inputs
# phase 11, the random-effect solve at scripts/bench_game.py's chip shape
RE_ENTITIES, RE_ROWS, RE_DIM, RE_NNZ, RE_L2 = 100_000, 64, 32, 8, 0.5
RE_CHECK = 1024  # entities re-solved on the CPU in float64
# phase 12, GAME coordinate descent at scripts/bench_game.py's CD shape
GAME_ROWS, GAME_VAL_ROWS, GAME_DIM = 1 << 17, 1 << 15, 1 << 16
GAME_USERS, GAME_ITEMS, GAME_SWEEPS = 100_000, 10_000, 3
TOL_SCORE = 1e-5  # max |diff| of two scorings of the validation rows
# phase 13, the GAME drivers at phase 12's shape: Avro files of 2^14 rows,
# one Bayesian tuning round after the one grid point
GAME_FILE_ROWS, GAME_TUNING_ROUNDS = 1 << 14, 1
TOL_DRIVER_AUC = 1e-6  # the scoring driver's auc against driver_done's
# phase 14, the streamed main path: chunks of 2^16 rows (32 chunks),
# prefetch depth 2; gate (a) on f relative and on g scaled by |g_mem(w=0)|
STREAM_CHUNK_ROWS, STREAM_DEPTH = 1 << 16, 2
TOL_STREAM_F, TOL_STREAM_G = 1e-6, 1e-5
STREAM_CONV_ITERS = 100  # gate (e): both fits to the float32 floor
# phase 15, the GLM driver out of core on phase 9's files: 8 chunks, lambda
# 1.0, 200 iterations at the driver's default tolerance (1e-7): near the
# optimum, where the in-memory and the streamed L-BFGS (their line searches
# differ) agree
OOC_CHUNK_ROWS, OOC_ITERS, OOC_TOL = 1 << 14, 200, 1e-7
TOL_OOC_W = 1e-5  # out-of-core against --streaming, rel L2 of w
TOL_OOC_AUC = 1e-3  # each streamed run's auc against the in-memory run's
# phase 16, GAME with the fixed coordinate streamed: chunks of 2^15 rows
GAME_STREAM_CHUNK_ROWS = 1 << 15
TOL_GAME_STREAM_AUC = 1e-3  # against phase 12's first-sweep auc
# peak device-memory rate, float32 and float64 (non-tensor-core) rates, by
# card (NVIDIA data sheets, SXM parts)
PEAKS = {"H200": (4.8e12, 67e12, 34e12), "H100": (3.35e12, 67e12, 34e12)}


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


def check_scan(nnz: int, with_values: bool, gen, dev, dtype=torch.float32):
    """The kernel and the plain version against the float64 reference, the
    kernel's determinism and its totals, for inputs of ``dtype``; returns
    the kernel's max abs error."""
    from photon_ml_tpu_torch.ops.kernels import (
        TILE, multiply_prefix_sum, multiply_prefix_sum_plain,
    )

    tol = TOL_SCAN if dtype == torch.float32 else TOL_SCAN_F64
    d = torch.randn(nnz, generator=gen, device=dev, dtype=dtype)
    values = (torch.randn(nnz, generator=gen, device=dev, dtype=dtype)
              if with_values else None)
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
        bad = int((err > tol * scale).sum())
        if bad or not torch.isfinite(out).all():
            raise RuntimeError(
                f"{name} scan off at nnz={nnz} values={with_values} "
                f"{dtype}: {bad} elements beyond {tol} * cumsum|x|, max err "
                f"{float(err.max()):.3e}")
        errs[name] = float(err.max())
    print(f"scan nnz={nnz} values={with_values} {dtype}: max abs err kernel "
          f"{errs['kernel']:.3e} plain {errs['plain']:.3e} "
          f"(tol {tol} * cumsum|x| per tile); two runs bit-identical")
    return errs["kernel"]


def time_scan(nnz: int, gen, dev, peaks, with_values: bool = False,
              dtype=torch.float32):
    """Kernel, plain and torch.cumsum times at a path's shape (inputs of
    ``dtype``; implicit ones unless ``with_values``), and the bound for the
    same work."""
    from photon_ml_tpu_torch.ops.kernels import (
        TILE, multiply_prefix_sum, multiply_prefix_sum_plain,
    )

    d = torch.randn(nnz, generator=gen, device=dev, dtype=dtype)
    values = (torch.randn(nnz, generator=gen, device=dev, dtype=dtype)
              if with_values else None)
    n_tiles = max(-(-nnz // TILE), 1)
    padded = torch.zeros(n_tiles * TILE, device=dev, dtype=dtype)
    padded[:nnz] = d if values is None else values * d
    view = padded.view(n_tiles, TILE)
    reps = 20
    kernel_ms = cuda_ms(lambda: multiply_prefix_sum(values, d), reps)
    plain_ms = cuda_ms(lambda: multiply_prefix_sum_plain(values, d, TILE),
                       reps)
    library_ms = cuda_ms(
        lambda: torch.cumsum(view, dim=1, dtype=torch.float64), reps)
    # read d_sorted (and values) once, write the float64 local and totals
    # once; one add (and one multiply) per element
    itemsize = d.element_size()
    nbytes = ((2 if with_values else 1) * itemsize * nnz
              + 8 * (n_tiles * TILE + n_tiles))
    bw, f32_rate, f64_rate = peaks
    flops = f32_rate if dtype == torch.float32 else f64_rate
    ops = (2 if with_values else 1) * nnz
    bytes_ms, ops_ms = nbytes / bw * 1e3, ops / flops * 1e3
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


def column_reference(csc, d):
    """The float64 column sums ``ref`` of the exact products and of their
    absolute values (the error scale ``sum_j |x|``)."""
    x = d.double()[csc.rows]
    if csc.values is not None:
        x = x * csc.values.double()
    lengths = torch.diff(csc.col_starts.long())
    return tuple(torch.segment_reduce(v, "sum", lengths=lengths, unsafe=True)
                 for v in (x, x.abs()))


def column_tolerance(ref, scale, dtype):
    """The per-column gate: ``TOL_COLUMN * sum_j |x|``, plus one float32
    ulp of ``|ref|`` for float32 outputs (the one rounding)."""
    tol = TOL_COLUMN * scale
    if dtype == torch.float32:
        _, e = torch.frexp(ref.abs())
        tol = tol + torch.where(ref == 0, 0.0,
                                torch.ldexp(torch.ones_like(ref), e - 24))
    return tol


def check_column_sums(label, csc, d):
    """csc_column_sums and its plain version against the float64 column
    sums at the per-column gate; two kernel runs bit-identical and equal
    to the plain version run on the CPU (the same order of sums) bit for
    bit; empty columns exactly 0. Returns the kernel's max abs error."""
    from photon_ml_tpu_torch.ops.kernels import (
        csc_column_sums, csc_column_sums_plain,
    )
    from photon_ml_tpu_torch.types import CSCTranspose

    got = csc_column_sums(csc, d)
    again = csc_column_sums(csc, d)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise RuntimeError(f"csc_column_sums {label}: two runs differ")
    host = csc_column_sums_plain(CSCTranspose(
        None if csc.values is None else csc.values.cpu(), csc.rows.cpu(),
        csc.col_starts.cpu()), d.cpu())
    if not torch.equal(got.cpu(), host):
        raise RuntimeError(f"csc_column_sums {label}: not the CPU plain "
                           "version's bits")
    ref, scale = column_reference(csc, d)
    tol = column_tolerance(ref, scale, d.dtype)
    errs = {}
    for name, out in (("kernel", got), ("plain", csc_column_sums_plain(csc,
                                                                       d))):
        err = (out.double() - ref).abs()
        bad = int((err > tol).sum())
        if bad or out.shape != ref.shape or out.dtype != d.dtype:
            raise RuntimeError(
                f"csc_column_sums {label} {name}: {bad} columns beyond the "
                f"gate, max err {float(err.max()):.3e}, shape "
                f"{tuple(out.shape)} {out.dtype}")
        errs[name] = float(err.max()) if err.numel() else 0.0
    empty = torch.diff(csc.col_starts.long()) == 0
    if not bool((got[empty] == 0).all()):
        raise RuntimeError(f"csc_column_sums {label}: an empty column is "
                           "not 0")
    print(f"csc_column_sums {label} (nnz={csc.rows.shape[0]}, "
          f"dim={ref.shape[0]}, {d.dtype}, "
          f"{'values' if csc.values is not None else 'implicit ones'}): max "
          f"abs err kernel {errs['kernel']:.3e}, plain {errs['plain']:.3e} "
          f"(gate {TOL_COLUMN} * sum_j|x|"
          f"{' + one f32 ulp' if d.dtype == torch.float32 else ''}); two "
          "runs bit-identical and equal to the CPU plain version; empty "
          "columns 0")
    return errs["kernel"]


def _ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def device_ms(fn, reps: int):
    """Mean device milliseconds per ``fn()`` call with no wait for the
    host in between: the card sleeps (``torch.cuda._sleep``) while the
    host queues ``reps`` calls, and CUDA events time them once the sleep
    ends. None (not measured) if the host took longer to queue them than
    the card slept."""
    fn()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    marks[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued_ms = (time.perf_counter() - t0) * 1e3
    marks[2].record()
    torch.cuda.synchronize()
    if queued_ms >= marks[0].elapsed_time(marks[1]):
        return None
    return marks[1].elapsed_time(marks[2]) / reps


def time_column_sums(label, csc, d, peaks, smi):
    """csc_column_sums at a path's shape beside its plain version, the
    previous route in turns (the torch gather, multiply_prefix_sum and
    blocked_boundary_combine, also each alone), cuSPARSE's SpMV (a
    yardstick: the port never calls it) and the bound for the same
    work."""
    from photon_ml_tpu_torch.ops.kernels import (
        TILE, csc_column_sums, csc_column_sums_plain, multiply_prefix_sum,
    )
    from photon_ml_tpu_torch.types import blocked_boundary_combine

    def previous():
        local, totals, _ = multiply_prefix_sum(csc.values, d[csc.rows])
        return blocked_boundary_combine(local, totals, csc.col_starts,
                                        TILE).to(d.dtype)

    nnz, dim, n = csc.rows.shape[0], csc.col_starts.shape[0] - 1, d.shape[0]
    ones = (csc.values if csc.values is not None
            else torch.ones(nnz, dtype=d.dtype, device=d.device))
    spm = torch.sparse_csr_tensor(csc.col_starts, csc.rows, ones,
                                  size=(dim, n), check_invariants=False)
    before = multiply_prefix_sum.launches
    d_sorted = d[csc.rows]
    local, totals, _ = multiply_prefix_sum(csc.values, d_sorted)
    reps = 20
    kernel = [cuda_ms(lambda: csc_column_sums(csc, d), reps)]
    prev = [cuda_ms(previous, reps)]
    library_ms = cuda_ms(lambda: spm @ d, reps)
    plain_ms = cuda_ms(lambda: csc_column_sums_plain(csc, d), reps)
    prev.append(cuda_ms(previous, reps))
    kernel.append(cuda_ms(lambda: csc_column_sums(csc, d), reps))
    gather_ms = cuda_ms(lambda: d[csc.rows], reps)
    mps_ms = cuda_ms(lambda: multiply_prefix_sum(csc.values, d_sorted), reps)
    combine_ms = cuda_ms(lambda: blocked_boundary_combine(
        local, totals, csc.col_starts, TILE), reps)
    # the same three on the device's own clock
    dev_ms = {name: device_ms(fn, reps) for name, fn in (
        ("kernel", lambda: csc_column_sums(csc, d)),
        ("previous", previous), ("library", lambda: spm @ d))}
    EXPLICIT_MPS[0] += multiply_prefix_sum.launches - before
    # each input read once, each output written once; one add (and one
    # multiply) per nonzero in float64
    nbytes = (4 * nnz + d.element_size() * (n + dim) + 4 * (dim + 1)
              + (0 if csc.values is None else d.element_size() * nnz))
    ops = (1 if csc.values is None else 2) * nnz
    bw, _, f64_rate = peaks
    bytes_ms, ops_ms = nbytes / bw * 1e3, ops / f64_rate * 1e3
    t = {"nnz": nnz, "dim": dim, "bytes": nbytes,
         "kernel_ms": sum(kernel) / 2, "kernel_ms_runs": kernel,
         "plain_ms": plain_ms, "previous_ms": sum(prev) / 2,
         "previous_ms_runs": prev, "gather_ms": gather_ms, "mps_ms": mps_ms,
         "combine_ms": combine_ms, "library_ms": library_ms,
         "device_ms": dev_ms["kernel"],
         "previous_device_ms": dev_ms["previous"],
         "library_device_ms": dev_ms["library"],
         "bound_ms": max(bytes_ms, ops_ms),
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    print(f"csc_column_sums {label} (nnz={nnz}, {d.dtype}, "
          f"{'values' if csc.values is not None else 'implicit ones'}): "
          f"kernel {kernel[0]:.4f} / {kernel[1]:.4f} ms, previous route "
          f"{prev[0]:.4f} / {prev[1]:.4f} ms (gather {gather_ms:.4f}, "
          f"multiply_prefix_sum {mps_ms:.4f}, combine {combine_ms:.4f}), "
          f"plain {plain_ms:.4f} ms, cuSPARSE SpMV {library_ms:.4f} ms; "
          f"device time per call: kernel {_ms(dev_ms['kernel'])}, "
          f"previous route {_ms(dev_ms['previous'])}, cuSPARSE "
          f"{_ms(dev_ms['library'])}; bound {t['bound_ms']:.5f} ms "
          f"({nbytes / 1e6:.2f} MB by {t['bound_by']}) on {smi}")
    return t


def column_sums_at(label, csc, n_rows, gen, dev, peaks, smi,
                   dtype=torch.float32):
    """check_column_sums then time_column_sums on a random ``d`` of
    ``n_rows``; returns the timing with the kernel's max error."""
    d = torch.randn(n_rows, generator=gen, device=dev, dtype=dtype)
    err = check_column_sums(label, csc, d)
    return dict(time_column_sums(label, csc, d, peaks, smi),
                max_abs_err=err)


def check_column_extras(csc, gen, dev, smi):
    """Phase 3's further checks of csc_column_sums: one main-path call adds
    at most COLUMN_MEM_GATE bytes above its inputs (the previous route's
    growth is printed beside it); a column that spans thousands of ranges;
    a refused launch raises the AcceleratorError form of torch's own CUDA
    checks and is not a device loss."""
    from photon_ml_tpu_torch.ops import kernel_build, kernels
    from photon_ml_tpu_torch.ops.kernels import (
        TILE, csc_column_sums, multiply_prefix_sum,
    )
    from photon_ml_tpu_torch.types import (
        CSCTranspose, blocked_boundary_combine,
    )
    from photon_ml_tpu_torch.utils import is_device_loss

    d = torch.randn(N_ROWS, generator=gen, device=dev)
    grown = {}
    for name, fn in (
            ("csc_column_sums", lambda: csc_column_sums(csc, d)),
            ("previous route", lambda: blocked_boundary_combine(
                *multiply_prefix_sum(None, d[csc.rows])[:2],
                csc.col_starts, TILE).to(d.dtype))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        grown[name] = torch.cuda.max_memory_allocated() - base
        del out
    print(f"device memory added by one main-path call: csc_column_sums "
          f"{grown['csc_column_sums'] / 1e6:.3f} MB (gate "
          f"{COLUMN_MEM_GATE / 1e6:.1f} MB), the previous route "
          f"{grown['previous route'] / 1e6:.1f} MB")
    if grown["csc_column_sums"] > COLUMN_MEM_GATE:
        raise RuntimeError("csc_column_sums allocated "
                           f"{grown['csc_column_sums']} bytes")

    # one heavy column: HEAVY_NNZ nonzeros in column 7, the rest spread
    lengths = torch.bincount(torch.randint(
        0, HEAVY_DIM, (HEAVY_NNZ,), generator=gen, device=dev),
        minlength=HEAVY_DIM)
    lengths[7] += HEAVY_NNZ
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(lengths, 0)]).to(torch.int32)
    heavy = CSCTranspose(None, torch.randint(
        0, N_ROWS, (int(starts[-1]),), generator=gen, device=dev,
        dtype=torch.int32), starts)
    err = check_column_sums("one heavy column", heavy, torch.randn(
        N_ROWS, generator=gen, device=dev))
    ms = cuda_ms(lambda: csc_column_sums(heavy, d), 10)
    print(f"  one heavy column: {int(lengths[7])} nonzeros in one column "
          f"({int(lengths[7]) // 2048} ranges), kernel {ms:.4f} ms on {smi}")

    lib = kernel_build.load_library()
    out = torch.empty(DIM, device=dev)
    scratch = torch.empty(3, device=dev, dtype=torch.float64)
    launches = csc_column_sums.launches
    err_code = lib.photon_csc_column_sums_f32(
        None, csc.rows.data_ptr(), csc.col_starts.data_ptr(), d.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), scratch.data_ptr(),
        scratch.data_ptr(), csc.rows.shape[0], DIM, 0,
        torch.cuda.current_stream().cuda_stream)
    refused = kernels.launch_error(lib, err_code, "csc_column_sums on an "
                                                  "empty grid")
    works = float(torch.ones(4, device=dev).sum()) == 4.0
    print(f"  a refused launch (empty grid): code {err_code}, "
          f"{type(refused).__name__}: {str(refused).splitlines()[0]}; "
          f"device loss {is_device_loss(refused)}; the card works after: "
          f"{works}")
    if not (err_code != 0
            and isinstance(refused, getattr(torch, "AcceleratorError",
                                            RuntimeError))
            and not is_device_loss(refused) and works
            and csc_column_sums.launches == launches):
        raise RuntimeError("csc_column_sums' refused launch was not reported")
    return err


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
    from photon_ml_tpu_torch.ops.kernels import csc_column_sums

    torch.cuda.synchronize()
    csc_column_sums.launches = 0
    t0 = time.perf_counter()
    res = fn()
    float(res.value)  # scalar fetch: the fit has run
    return res, time.perf_counter() - t0, csc_column_sums.launches


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


def tron_accepted(res, n_rows: int) -> int:
    """TRON's accepted steps, read from its loss history: a rejected step
    leaves the loss as it was, bit for bit (``optimize/tron.py`` records
    ``where(accept, f_try, f)``), and an accepted one lowers it. The loss
    before the first step, at w0 = 0, is ``n_rows * log 2`` up to the
    float32 sum's rounding."""
    lh = res.loss_history[:res.iterations].double().cpu()
    f0 = n_rows * math.log(2.0)
    first = int(abs(float(lh[0]) - f0) > 1e-5 * f0)
    return first + int((lh[1:] != lh[:-1]).sum())


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
    return launches, res


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


def fnv1a_64_rows(keys) -> "np.ndarray":
    """FNV-1a 64 of equal-length byte strings, vectorized over the rows
    (``io.hashing.fnv1a_64`` one key at a time is too slow for a vocabulary
    of hundreds of thousands of terms)."""
    raw = np.frombuffer(b"".join(keys), np.uint8).reshape(len(keys), -1)
    h = np.full(len(keys), 0xCBF29CE484222325, np.uint64)
    for col in raw.T:
        h = (h ^ col.astype(np.uint64)) * np.uint64(0x100000001B3)
    return h


def make_driver_terms(n_rows, seed):
    """Criteo-shaped categorical rows: per feature ``c{j}`` a cardinality
    between 10 and 10^5 (log-uniform) and skewed term draws; labels from a
    planted logistic model over the hashed slots. Returns (term ids
    [n_rows, 39] int32, labels)."""
    from photon_ml_tpu_torch.io.hashing import fnv1a_64
    from photon_ml_tpu_torch.io.schemas import feature_key

    rng = np.random.default_rng(seed)
    sizes = np.round(10.0 ** rng.uniform(1, 5, DRIVER_FEATURES)).astype(int)
    ids = np.empty((n_rows, DRIVER_FEATURES), np.int32)
    slots = np.empty((n_rows, DRIVER_FEATURES), np.int64)
    for j, size in enumerate(sizes):
        ids[:, j] = np.floor(size * rng.random(n_rows) ** 3)
        keys = [feature_key(f"c{j}", f"{t:05x}").encode()
                for t in range(size)]
        vocab = fnv1a_64_rows(keys) % np.uint64(DRIVER_HASH_DIM)
        if int(vocab[-1]) != fnv1a_64(keys[-1]) % DRIVER_HASH_DIM:
            raise RuntimeError("vectorized FNV-1a disagrees with io.hashing")
        slots[:, j] = vocab[ids[:, j]].astype(np.int64)
    w_true = rng.normal(0.0, 0.3, DRIVER_HASH_DIM)
    logits = w_true[slots].sum(axis=1) - 0.5
    labels = (rng.random(n_rows) < 1.0 / (1.0 + np.exp(-logits))).astype(float)
    return ids, labels


def write_driver_part(task):
    """Worker: one Avro file of TrainingExampleAvro records (value 1.0 per
    categorical term) through the port's writer."""
    path, ids, labels = task
    from photon_ml_tpu_torch.io.data_reader import write_training_examples

    rows = ([(f"c{j}", f"{t:05x}", 1.0) for j, t in enumerate(row)]
            for row in ids.tolist())
    write_training_examples(path, rows, labels)
    return path


def write_driver_fixture(root, file_rows, n_files, n_val_files):
    """The training files under ``root/train`` and the validation files
    under ``root/validation``, written by ``n_files + n_val_files`` worker
    processes."""
    import multiprocessing
    import os

    n_parts = n_files + n_val_files
    ids, labels = make_driver_terms(n_parts * file_rows, SEED)
    tasks = []
    for part in range(n_parts):
        sub = "train" if part < n_files else "validation"
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        rows = slice(part * file_rows, (part + 1) * file_rows)
        tasks.append((os.path.join(root, sub, f"part-{part:02d}.avro"),
                      ids[rows], labels[rows]))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(n_parts, os.cpu_count() or 1)) as pool:
        pool.map(write_driver_part, tasks)
    return os.path.join(root, "train"), os.path.join(root, "validation")


# phase 9's driver run, for phase 19's traced run on the same files
DRIVER_RUN = {}


class _RecordingEvaluator:
    """Stands in for an evaluator inside the driver and keeps each score
    vector it is handed."""

    def __init__(self, inner, scored):
        self.inner, self.scored = inner, scored

    def evaluate(self, scores, labels, weights=None, group_ids=None):
        self.scored.append(np.array(scores))
        return self.inner.evaluate(scores, labels, weights, group_ids)

    def better(self, a, b):
        return self.inner.better(a, b)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def phase_driver(dev, smi, peaks, gen, file_rows=DRIVER_FILE_ROWS,
                 n_files=DRIVER_FILES, n_val_files=DRIVER_VAL_FILES,
                 then=None):
    """The GLM driver end to end on a written Avro dataset (phase 9), then
    ``then(root, train_dir, val_dir)`` (phase 15) on the same files
    before they are removed. Returns (kernel launches in the driver's run,
    the kernel's with-values timings at this path's shape and at an
    out-of-core chunk's, what ``then`` returned)."""
    import os
    import tempfile

    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.io.hashing import HashingIndexMap
    from photon_ml_tpu_torch.io.model_io import load_game_model
    from photon_ml_tpu_torch.ops.kernels import csc_column_sums
    from photon_ml_tpu_torch.types import build_csc_transpose, margins

    n_train, n_val = n_files * file_rows, n_val_files * file_rows
    with tempfile.TemporaryDirectory(prefix="chip_smoke_glm_") as root:
        t0 = time.perf_counter()
        train_dir, val_dir = write_driver_fixture(root, file_rows, n_files,
                                                  n_val_files)
        print(f"driver fixture: {n_train} training rows in {n_files} files "
              f"and {n_val} validation rows, {DRIVER_FEATURES} categorical "
              f"features hashed into {DRIVER_HASH_DIM} slots plus the "
              f"intercept, written in {time.perf_counter() - t0:.2f} s by "
              f"{n_files + n_val_files} processes (depth cut from the main "
              f"path's {N_ROWS} rows)")
        out = os.path.join(root, "out")
        argv = ["--train-data", train_dir, "--validation-data", val_dir,
                "--input-format", "avro", "--hash-dim", str(DRIVER_HASH_DIM),
                "--reg-weights", *DRIVER_GRID, "--optimizer", "lbfgs",
                "--max-iters", str(ITERS), "--tolerance", "0",
                "--evaluators", "auc", "--device", str(dev),
                "--output-dir", out]
        fits, scored = [], []
        real_fit, real_get = glm_driver.fit_shard, glm_driver.get_evaluator

        def counted_fit(objective, batch, w0, **kw):
            torch.cuda.synchronize()
            before = csc_column_sums.launches
            from_zero = bool((w0 == 0).all())
            t_fit = time.perf_counter()
            res = real_fit(objective, batch, w0, **kw)
            float(res.value)  # scalar fetch: the fit has run
            fits.append({"objective": objective, "batch": batch, "kw": kw,
                         "res": res, "from_zero": from_zero,
                         "seconds": time.perf_counter() - t_fit,
                         "launches": csc_column_sums.launches - before})
            return res

        glm_driver.fit_shard = counted_fit
        glm_driver.get_evaluator = \
            lambda name: _RecordingEvaluator(real_get(name), scored)
        try:
            torch.cuda.synchronize()
            csc_column_sums.launches = 0
            t0 = time.perf_counter()
            rc = glm_driver.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = csc_column_sums.launches
        finally:
            glm_driver.fit_shard = real_fit
            glm_driver.get_evaluator = real_get
        if rc != 0:
            raise RuntimeError(f"glm_driver exited with {rc}")
        DRIVER_RUN.update(argv=argv, out=out, seconds=seconds,
                          launches=launches)
        with open(os.path.join(out, "photon.log.jsonl")) as f:
            log = [json.loads(line) for line in f]
        read = next(e for e in log if e["event"] == "data_read")
        print(f"glm_driver: {seconds:.3f} s in all, {launches} kernel "
              f"launches, Avro decoder: {read['decoder']}, "
              f"{read['num_train']} + {read['num_validation']} rows, "
              f"{read['num_features']} features, on {smi}")
        for e in log:
            if e["event"] == "stage_timing":
                print(f"  stage {e['stage']}: {e['seconds']:.4f} s")
        trained = [e for e in log if e["event"] == "lambda_trained"]
        if len(trained) != len(DRIVER_GRID) or len(fits) != len(DRIVER_GRID):
            raise RuntimeError(f"{len(trained)} lambdas logged, {len(fits)} "
                               f"fits for a grid of {len(DRIVER_GRID)}")
        for e, fit in zip(trained, fits):
            print(f"  lambda {e['reg_weight']:g}: {e['iterations']} "
                  f"iterations, fit {fit['seconds']:.4f} s, "
                  f"{fit['launches']} kernel launches, loss "
                  f"{e['loss']:.4f}, auc {e['metrics']['auc']:.6f}")
            if fit["launches"] < 1:
                raise RuntimeError(f"lambda {e['reg_weight']}: the kernel "
                                   "did not launch")
        done = log[-1]
        best = done["best_reg_weight"]
        best_auc = done["best_metrics"]["auc"]
        print(f"  best lambda {best:g}, validation auc {best_auc:.6f} "
              f"(gate > {DRIVER_MIN_AUC})")
        if not best_auc > DRIVER_MIN_AUC:
            raise RuntimeError(f"validation auc {best_auc} <= {DRIVER_MIN_AUC}")

        # the first lambda, from zeros, against the plain "csc" fit
        first = fits[0]
        if not first["from_zero"]:
            raise RuntimeError("the first lambda did not start from zeros")
        batch = first["batch"]
        w0 = torch.zeros(batch.dim, dtype=first["res"].w.dtype, device=dev)
        kw = dict(first["kw"], sparse_grad="csc")
        plain = real_fit(first["objective"], batch, w0, **kw)
        check_plain(f"glm_driver lambda {DRIVER_GRID[0]}", first["res"], plain)

        # best/ reloaded scores the validation rows as the run did
        best_i = [float(g) for g in DRIVER_GRID].index(best)
        model = load_game_model(os.path.join(out, "best"), device=dev)
        w_best = model["global"].model.coefficients.means.to(batch.labels.dtype)
        vhost, _, voffsets, _, _, _, _ = glm_driver._read(
            [val_dir], "avro",
            HashingIndexMap(DRIVER_HASH_DIM, add_intercept=True), True)
        vfeats = glm_driver._device_batch(vhost, np.zeros(n_val), voffsets,
                                          np.ones(n_val), batch.labels.dtype,
                                          dev).features
        rescored = (margins(vfeats, w_best)
                    + torch.as_tensor(voffsets, dtype=w_best.dtype,
                                      device=dev)).cpu().numpy()
        if not np.array_equal(rescored, scored[best_i]):
            raise RuntimeError(
                "best/ reloaded scores the validation rows differently: max "
                f"|diff| {np.abs(rescored - scored[best_i]).max():.3e}")
        print(f"  best/ reloaded with load_game_model: its {n_val} validation "
              "scores equal the run's bit for bit")
        after = None
        if then is not None:
            after = then(root, train_dir, val_dir)
    # the kernel at this path's shape, and at an out-of-core chunk's (phase
    # 15's chunks of OOC_CHUNK_ROWS rows of the same files)
    feats = batch.features
    timing = column_sums_at(
        "glm driver", build_csc_transpose(feats.indices, feats.values,
                                          feats.dim, with_cols=False),
        batch.num_examples, gen, dev, peaks, smi)
    chunk = feats.slice_rows(0, OOC_CHUNK_ROWS)
    ooc_timing = column_sums_at(
        "out-of-core driver chunk", build_csc_transpose(
            chunk.indices, chunk.values, chunk.dim, with_cols=False),
        OOC_CHUNK_ROWS, gen, dev, peaks, smi)
    return launches, timing, ooc_timing, after


def path_walks(obj, reg, batch, csc, config, lambdas=PATH_LAMBDAS):
    """Walk the first ``lambdas`` of the grid of 20 lambdas from
    ``lambda_max()`` down to 1e-2 of it with ``screen="strong"`` and with
    ``screen="off"``; each walk's kernel count is set to 0 just before it
    and read just after.
    Returns (grid, {rule: (solver, [(result, stats)], seconds,
    launches)})."""
    from photon_ml_tpu_torch.ops.kernels import csc_column_sums
    from photon_ml_tpu_torch.optimize import PathConfig
    from photon_ml_tpu_torch.optimize.path import PathSolver

    walks = {}
    for rule in ("strong", "off"):
        solver = PathSolver(obj, reg, batch=batch, config=config,
                            path_config=PathConfig(screen=rule),
                            precomputed_csc=csc)
        if rule == "strong":
            lmax = solver.lambda_max()
            grid = np.geomspace(lmax, PATH_SPAN * lmax,
                                PATH_LAMBDAS)[:lambdas]
        torch.cuda.synchronize()
        csc_column_sums.launches = 0
        t0 = time.perf_counter()
        out = [solver.solve(float(lam)) for lam in grid]
        torch.cuda.synchronize()
        walks[rule] = (solver, out, time.perf_counter() - t0,
                       csc_column_sums.launches)
        if walks[rule][3] < 1:
            raise RuntimeError(f"the path walk screen={rule} did not launch "
                               "the kernel")
    return grid, walks


def print_walks(label, grid, walks, smi):
    """Per lambda: candidates, restricted width, KKT rounds, iterations and
    solve seconds of both walks, and how far their solutions differ. Gates:
    every lambda certified, finite ``w`` of full width."""
    (_, scr, t_s, n_s), (_, off, t_o, n_o) = walks["strong"], walks["off"]
    print(f"path {label} (elastic net alpha {PATH_ALPHA}, {len(grid)} "
          f"lambdas from lambda_max {grid[0]:.4f} down to {grid[-1]:.4f}, "
          f"n={N_ROWS}, d={DIM}): screen=strong {t_s:.3f} s, {n_s} kernel "
          f"launches; screen=off {t_o:.3f} s, {n_o} kernel launches, on "
          f"{smi}")
    for lam, (rs, ss), (ro, so) in zip(grid, scr, off):
        diff = int(((rs.w != 0) != (ro.w != 0)).sum())
        print(f"  lambda {lam:.5f}: candidates {ss.candidate_size}, "
              f"screened_dim {ss.screened_dim}, kkt_rounds {ss.kkt_rounds}, "
              f"violations {ss.kkt_violations}, iterations "
              f"{ss.solver_iterations} vs {so.solver_iterations}, solve "
              f"{ss.solve_seconds:.4f} s vs {so.solve_seconds:.4f} s, "
              f"nonzeros {int((rs.w != 0).sum())} vs {int((ro.w != 0).sum())}"
              f", support differs at {diff}, rel L2 {rel_l2(rs.w, ro.w):.3e}")
        if not (ss.certified and so.certified):
            raise RuntimeError(f"path {label} lambda {lam}: not certified")
        if not (torch.isfinite(rs.w).all() and torch.isfinite(ro.w).all()
                and rs.w.shape == ro.w.shape == (DIM,)):
            raise RuntimeError(f"path {label} lambda {lam}: w not finite or "
                               "of the wrong shape")


def check_path_kkt(label, reg, grid, walks):
    """The certification of every screened-walk lambda whose solve was
    restricted: at the coordinates the strong rule froze at zero (those
    whose previous data gradient fell below the threshold), a fresh full
    data gradient meets the KKT condition within the slack
    (``kkt_residuals``). The largest residual at any zero coordinate is
    printed beside it: a member left at zero by a float32 solve that
    stopped at its tolerance may exceed the slack without any screening
    fault."""
    from photon_ml_tpu_torch.ops.objective import kkt_residuals
    from photon_ml_tpu_torch.ops.regularization import (
        kkt_slack, screening_threshold,
    )
    from photon_ml_tpu_torch.optimize import PathConfig

    solver, scr = walks["strong"][:2]
    pc = PathConfig(screen="strong")
    w0, g0, lam1_max = solver._probe()
    frozen_ratio, zero_ratio = [], []
    for i, (lam, (res, st)) in enumerate(zip(grid, scr)):
        l1 = reg.l1_weight(float(lam))
        # the screening source of lambda i: the solved lambda above it
        if i == 0:
            w_prev, g_prev, l1_prev = w0, g0, max(lam1_max, l1)
        else:
            prev = solver._states[i - 1]
            w_prev, g_prev, l1_prev = prev.w, prev.g, prev.lam_l1
        thr = screening_threshold(pc.screen, l1, max(l1_prev, l1),
                                  pc.screen_slack)
        frozen = (torch.abs(g_prev) < thr) & (w_prev == 0) & (res.w == 0)
        r = kkt_residuals(res.w, solver._full_grad(res.w), l1)
        slack = kkt_slack(l1, pc.kkt_tol)
        at_zero = res.w == 0
        zero_ratio.append(float(r[at_zero].max()) / slack
                          if bool(at_zero.any()) else 0.0)
        if st.screened_dim < DIM:
            top = float(r[frozen].max()) if bool(frozen.any()) else 0.0
            frozen_ratio.append(f"{top / slack:.3g} ({int(frozen.sum())})")
            if not top <= slack:
                raise RuntimeError(
                    f"path {label} lambda {lam}: a frozen coordinate breaks "
                    f"the KKT condition by {top:.3e} > slack {slack:.3e}")
    print(f"  {label} KKT residual over the slack at the frozen coordinates "
          f"(their count), per restricted lambda, gated <= 1: "
          f"{', '.join(frozen_ratio)}; at any zero coordinate, per lambda: "
          f"{', '.join(f'{x:.3g}' for x in zero_ratio)}")


def check_path_grads(label, obj, reg, batch, csc, grid, walks):
    """The path's two kernel calls against the plain ``"csc"`` path on the
    same inputs, at the screened walk's last restricted solution: the full
    data gradient (implicit ones; the certification passes) and the
    restricted batch's gradient (explicit values; the restricted
    solves)."""
    from photon_ml_tpu_torch.optimize import PathConfig
    from photon_ml_tpu_torch.optimize.path import PathSolver, pad_to_bucket
    from photon_ml_tpu_torch.parallel.data_parallel import (
        build_csc, make_csc_path,
    )

    solver, scr = walks["strong"][:2]
    tol = TOL_GRAD[batch.labels.dtype]
    i = max(j for j, (_, st) in enumerate(scr) if st.screened_dim < DIM)
    w = scr[i][0].w
    plain = PathSolver(obj, reg, batch=batch, sparse_grad="csc",
                       precomputed_csc=csc)
    rel_full = rel_l2(solver._full_grad(w), plain._full_grad(w))
    member = w != 0
    bucket = pad_to_bucket(int(member.sum()), PathConfig().min_bucket)
    cols, lut = solver._selection(member)
    rbatch = solver._restrict_batch(member, cols, lut, bucket)
    rcsc = build_csc(rbatch)
    w_r = torch.zeros(bucket, dtype=w.dtype, device=w.device)
    w_r[: cols.shape[0]] = w[cols]
    grads = [make_csc_path(solver._robj, use_kernel=k)[1](
        w_r, rbatch, rcsc, 0.0)[1] for k in (True, False)]
    rel_r = rel_l2(*grads)
    print(f"  {label} gradients at lambda {grid[i]:.5f}, kernel vs plain "
          f"csc: full (implicit ones) rel L2 {rel_full:.3e}; restricted to "
          f"{bucket} columns (explicit values) rel L2 {rel_r:.3e} (tol "
          f"{tol})")
    if not (rel_full <= tol and rel_r <= tol):
        raise RuntimeError(f"path {label}: a gradient through the kernel "
                           f"differs from the plain one: {rel_full:.3e}, "
                           f"{rel_r:.3e}")


def phase_path(obj, batch, csc, smi, gen, dev, peaks):
    """Phase 10: the screened regularization path at the main path's width,
    against the unscreened walk of the same grid, in float32 and in
    float64. Returns (launches per walk, the float64 with-values kernel's
    timing and max error)."""
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optimize import OptimizerConfig
    from photon_ml_tpu_torch.types import LabeledBatch, SparseFeatures

    reg = RegularizationContext("elastic_net", alpha=PATH_ALPHA)
    launches = {}
    # float32, the driver's dtype and its default solver settings: every
    # lambda certified, the restricted solves within the KKT slack, the
    # kernel's gradients equal to the plain ones. The two walks' supports
    # are printed, not gated: in float32 the summed loss (about 1.45e6 at
    # n = 2^21) resolves a coefficient only to about sqrt(2 eps32 F / H) ~
    # 5e-2 (H ~ 78, the curvature of one feature's ~312 rows), so two
    # solves that stop at different points of that floor cannot be held to
    # one support.
    grid, walks = path_walks(obj, reg, batch, csc, OptimizerConfig(
        max_iters=PATH_F32_ITERS, tolerance=PATH_F32_TOL))
    launches["path_f32_strong"] = walks["strong"][3]
    launches["path_f32_off"] = walks["off"][3]
    print_walks("float32", grid, walks, smi)
    check_path_kkt("float32", reg, grid, walks)
    check_path_grads("float32", obj, reg, batch, csc, grid, walks)

    # float64, where that floor is ~1e-6: the screened support identical to
    # the unscreened one and w within 1e-3. Tolerance 0 runs each solve
    # until OWL-QN's line search stalls at that floor (or PATH_ITERS): a
    # coordinate whose KKT margin is tiny is zero in one walk and tiny in
    # the other unless both solves get that close. The restricted solves
    # run the kernel's float64 with-values variant: it is held to the plain
    # version first, at the path's shape (the main view with float64
    # values).
    view64 = dataclasses.replace(csc, values=torch.randn(
        csc.rows.shape[0], generator=gen, device=dev, dtype=torch.float64))
    timing64 = column_sums_at("path float64", view64, N_ROWS, gen, dev,
                              peaks, smi, dtype=torch.float64)
    del view64
    batch64 = LabeledBatch(
        SparseFeatures(batch.features.indices, None, batch.features.dim),
        batch.labels.double(), batch.offsets.double(),
        batch.weights.double())
    grid, walks = path_walks(obj, reg, batch64, csc, OptimizerConfig(
        max_iters=PATH_ITERS, tolerance=0.0), lambdas=PATH_F64_LAMBDAS)
    launches["path_f64_strong"] = walks["strong"][3]
    launches["path_f64_off"] = walks["off"][3]
    print_walks("float64", grid, walks, smi)
    check_path_kkt("float64", reg, grid, walks)
    check_path_grads("float64", obj, reg, batch64, csc, grid, walks)
    for lam, (rs, _), (ro, _) in zip(grid, walks["strong"][1],
                                     walks["off"][1]):
        if not torch.equal(rs.w != 0, ro.w != 0):
            diff = (rs.w != 0) != (ro.w != 0)
            largest = float(torch.maximum(rs.w.abs(), ro.w.abs())[diff].max())
            raise RuntimeError(
                f"path float64 lambda {lam}: the screened support differs "
                f"from the unscreened one at {int(diff.sum())} coordinates "
                f"(largest |w| there {largest:.3e})")
        rel = rel_l2(rs.w, ro.w)
        if not rel <= TOL_FIT:
            raise RuntimeError(f"path float64 lambda {lam}: rel L2 "
                               f"{rel:.3e} > {TOL_FIT}")
    return launches, timing64


def re_bucket(E, N, D, kk, gen, dev, dtype=torch.float32):
    """One random-effect bucket drawn on ``dev``: E entities x N rows of kk
    nonzeros in a D-dim local space, labels Bernoulli(0.5)."""
    from photon_ml_tpu_torch.game.data import REBucket

    idx = torch.randint(0, D, (E, N, kk), generator=gen, device=dev,
                        dtype=torch.int32)
    val = torch.randn((E, N, kk), generator=gen, device=dev, dtype=dtype)
    lab = (torch.rand((E, N), generator=gen, device=dev) < 0.5).to(dtype)
    return REBucket(
        entity_ids=np.arange(E), indices=idx, values=val, labels=lab,
        weights=torch.ones((E, N), dtype=dtype, device=dev),
        sample_idx=torch.arange(E * N, dtype=torch.int32,
                                device=dev).view(E, N),
        projection=torch.arange(D, dtype=torch.int32,
                                device=dev).expand(E, D),
        local_maps=[])


def phase_re_solve(dev, gen, smi):
    """Phase 11: the random-effect bucket solve at scripts/bench_game.py's
    chip shape with the Newton, L-BFGS and TRON solvers; the first RE_CHECK
    entities re-solved on the CPU in float64 by the same solver."""
    import dataclasses

    from photon_ml_tpu_torch.game.data import RandomEffectTrainData
    from photon_ml_tpu_torch.game.random_effect import (
        resolve_re_optimizer, train_random_effect,
    )
    from photon_ml_tpu_torch.optimize import OptimizerConfig

    E, N, D, kk = RE_ENTITIES, RE_ROWS, RE_DIM, RE_NNZ
    bucket = re_bucket(E, N, D, kk, gen, dev)
    data = RandomEffectTrainData("random", [bucket], E * N, {})
    offsets = torch.zeros(E * N, device=dev)
    cfg = OptimizerConfig(max_iters=10, tolerance=0.0)
    rows = slice(0, RE_CHECK)
    cpu_bucket = dataclasses.replace(
        bucket, entity_ids=np.arange(RE_CHECK),
        **{f: getattr(bucket, f)[rows].cpu().double()
           if getattr(bucket, f).is_floating_point()
           else getattr(bucket, f)[rows].cpu()
           for f in ("indices", "values", "labels", "weights",
                     "sample_idx", "projection")})
    cpu_data = RandomEffectTrainData("random", [cpu_bucket], E * N, {})
    rates = {}
    for opt in ("newton", "lbfgs", "tron"):
        train_random_effect(data, offsets, l2=RE_L2, optimizer=opt,
                            config=cfg, device=dev)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = train_random_effect(data, offsets, l2=RE_L2, optimizer=opt,
                                  config=cfg, device=dev)
        sec = time.perf_counter() - t0
        rates[opt] = E / sec
        ref = train_random_effect(cpu_data, np.zeros(E * N), l2=RE_L2,
                                  optimizer=opt, config=cfg,
                                  dtype=torch.float64, device="cpu")
        W, Wc = fit.coefficients[0][rows].astype(np.float64), \
            ref.coefficients[0]
        rel = (np.linalg.norm(W - Wc, axis=1)
               / np.maximum(np.linalg.norm(Wc, axis=1), 1e-30))
        print(f"re solve {opt} (E={E}, rows {N}, local dim {D}, {kk} "
              f"nonzeros per row, f32, 10 iterations, tolerance 0, l2 "
              f"{RE_L2}): {sec:.4f} s, {rates[opt]:.1f} entities/s, mean "
              f"iterations {fit.mean_iterations:.2f}; first {RE_CHECK} "
              f"entities vs the CPU float64 solve: max rel L2 "
              f"{rel.max():.3e} (tol {TOL_FIT}) on {smi}")
        if not (np.isfinite(fit.coefficients[0]).all()
                and rel.max() <= TOL_FIT):
            raise RuntimeError(f"re solve {opt}: card vs CPU rel L2 "
                               f"{rel.max():.3e}")
    from photon_ml_tpu_torch.game import random_effect as re_mod

    print(f"re solve: newton/lbfgs = {rates['newton'] / rates['lbfgs']:.2f}, "
          f"tron/lbfgs = {rates['tron'] / rates['lbfgs']:.2f}; "
          f"optimizer='auto' resolves to {resolve_re_optimizer('auto')!r}; "
          f"card memory {torch.cuda.get_device_properties(dev).total_memory} "
          f"B, block budget {re_mod._block_budget(dev)} B")
    return rates


def game_arrays(total, seed):
    """(feature ids [total, K] int32, user ids, item ids, labels) of
    ``make_game_data``: ids uniform over GAME_DIM, GAME_USERS, GAME_ITEMS,
    labels Bernoulli(sigmoid(x . w_true)) with w_true ~ N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, GAME_DIM, (total, K)).astype(np.int32)
    users = rng.integers(0, GAME_USERS, total)
    items = rng.integers(0, GAME_ITEMS, total)
    w_true = rng.normal(0.0, 0.5, GAME_DIM)
    logits = w_true[idx].sum(axis=1)
    y = (rng.random(total) < 1.0 / (1.0 + np.exp(-logits))).astype(float)
    return idx, users, items, y


def make_game_data(n, n_val, gen_seed):
    """The CD shape of scripts/bench_game.py: Criteo-shaped implicit-ones
    rows (d = GAME_DIM, k = K), user ids uniform over GAME_USERS and item
    ids over GAME_ITEMS, labels from a planted logistic model."""
    from photon_ml_tpu_torch.game.data import HostSparse
    from photon_ml_tpu_torch.game.descent import make_game_dataset

    idx, users, items, y = game_arrays(n + n_val, gen_seed)

    def part(rows):
        return make_game_dataset(
            {"global": HostSparse(idx[rows], None, GAME_DIM)}, y[rows],
            entity_ids={"user": users[rows], "item": items[rows]})

    return part(slice(0, n)), part(slice(n, n + n_val))


def game_configs(fixed_grad="auto"):
    from photon_ml_tpu_torch.game.descent import CoordinateConfig

    return [
        CoordinateConfig("fixed", reg_type="l2", reg_weight=1.0,
                         max_iters=10, tolerance=0.0, sparse_grad=fixed_grad),
        CoordinateConfig("per_user", coordinate_type="random",
                         entity_column="user", max_iters=5, num_buckets=2,
                         reg_type="l2", reg_weight=1.0),
        CoordinateConfig("per_item", coordinate_type="random",
                         entity_column="item", max_iters=5, num_buckets=2,
                         reg_type="l2", reg_weight=1.0),
    ]


def phase_game(dev, smi, n=GAME_ROWS, n_val=GAME_VAL_ROWS):
    """Phase 12: GAME coordinate descent through GameEstimator.fit at
    scripts/bench_game.py's CD shape, with validation AUC; the fixed
    coordinate's first fit against the plain "csc" path and
    GameTransformer against CD's own validation scores (phase 13 saves and
    reloads the model through the drivers). Returns (kernel launches, what
    phase 16 reuses: the data, the bucket cache and the first sweep's
    AUC)."""
    from photon_ml_tpu_torch.estimators import GameEstimator, GameTransformer
    from photon_ml_tpu_torch.game import descent
    from photon_ml_tpu_torch.ops.kernels import csc_column_sums

    t0 = time.perf_counter()
    train, val = make_game_data(n, n_val, SEED)
    t_data = time.perf_counter() - t0
    configs = game_configs()
    cache = {}
    t0 = time.perf_counter()
    descent.CoordinateDescent(configs, device=dev, dataset_cache=cache) \
        ._build_random_states(train, val, {}, {})
    t_re_data = time.perf_counter() - t0
    buckets = {name: [(b.num_entities, b.indices.shape[1], b.local_dim)
                      for b in entry[1].buckets]
               for key, entry in cache.items() if key[0] == "re_data"
               for name in [key[2]]}
    print(f"game data: n={n} (+{n_val} validation), d={GAME_DIM}, k={K}, "
          f"{GAME_USERS} user ids, {GAME_ITEMS} item ids; drawn in "
          f"{t_data:.2f} s, random-effect buckets and score views built in "
          f"{t_re_data:.2f} s on the host; buckets (entities, rows, local "
          f"dim): {buckets}")

    fixed_fits, scored = [], []
    real_fit = descent._FixedState.fit
    real_get = descent.get_evaluator

    def counted_fit(self, offsets_full, opt_config=None):
        torch.cuda.synchronize()
        before = csc_column_sums.launches
        t_fit = time.perf_counter()
        res = real_fit(self, offsets_full, opt_config)
        float(res.value)
        fixed_fits.append((time.perf_counter() - t_fit,
                           csc_column_sums.launches - before,
                           res.iterations))
        return res

    snaps = {}
    descent._FixedState.fit = counted_fit
    descent.get_evaluator = \
        lambda name: _RecordingEvaluator(real_get(name), scored)
    try:
        est = GameEstimator(task="logistic", n_iterations=GAME_SWEEPS,
                            evaluators=["auc"], device=dev)
        torch.cuda.synchronize()
        csc_column_sums.launches = 0
        t0 = time.perf_counter()
        result = est.fit(
            train, val, [configs], dataset_cache=cache,
            checkpoint_callback=lambda gi, it, model: snaps.setdefault(
                it, model["fixed"].model.coefficients.means.clone()))[0]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = csc_column_sums.launches
    finally:
        descent._FixedState.fit = real_fit
        descent.get_evaluator = real_get
    print(f"game fit: {GAME_SWEEPS} sweeps in {seconds:.3f} s, {launches} "
          f"kernel launches, final validation auc "
          f"{result.evaluation.primary_value:.6f}, on {smi}")
    for rec in result.history:
        extra = ""
        if "entities_solved" in rec:
            extra = (f", {rec['entities_solved']} entities solved, mean "
                     f"iterations {rec['mean_optimizer_iterations']:.2f}, "
                     f"converged {rec['converged_fraction']:.3f}")
        print(f"  sweep {rec['iteration']} {rec['coordinate']}: "
              f"{rec['seconds']:.4f} s (solve {rec['solve_seconds']:.4f}, "
              f"eval {rec['eval_seconds']:.4f}){extra}, auc "
              f"{rec['auc']:.6f}")
    for i, (sec, n_launch, iters) in enumerate(fixed_fits):
        print(f"  fixed fit {i}: {iters} iterations, {n_launch} kernel "
              f"launches, {sec:.4f} s")
        if n_launch < 1:
            raise RuntimeError("a fixed-coordinate fit did not launch the "
                               "kernel")

    # the first sweep's fixed fit starts from zero offsets in both runs
    plain = GameEstimator(task="logistic", n_iterations=1,
                          device=dev).fit(train, None,
                                          [game_configs("csc")])[0]
    rel = rel_l2(snaps[0], plain.model["fixed"].model.coefficients.means)
    print(f"  fixed coordinate after sweep 0: |w_kernel - w_csc| / |w_csc| "
          f"= {rel:.3e} (tol {TOL_FIT})")
    if not rel <= TOL_FIT:
        raise RuntimeError(f"game fixed coordinate: kernel fit differs from "
                           f"the plain fit: {rel:.3e}")

    transformer = GameTransformer(result.model, device=dev)
    scores = transformer.transform(val).cpu().numpy()
    cd_scores = scored[-1]
    diff = float(np.abs(scores - cd_scores).max())
    print(f"  GameTransformer vs CD's final validation scores: max |diff| "
          f"{diff:.3e} (tol {TOL_SCORE})")
    if not (np.isfinite(scores).all() and scores.shape == (n_val,)
            and diff <= TOL_SCORE):
        raise RuntimeError(f"GameTransformer scores differ: {diff:.3e}")
    auc0 = [rec["auc"] for rec in result.history if rec["iteration"] == 0][-1]
    return launches, dict(train=train, val=val, cache=cache, auc0=auc0,
                          result=result, launches=launches, seconds=seconds)


def phase_game_stream(ctx, dev, smi):
    """Phase 16: phase 12's data and coordinates with the fixed coordinate
    streamed (chunks of GAME_STREAM_CHUNK_ROWS rows), one sweep, sharing
    phase 12's random-effect buckets. Returns the kernel launches."""
    import dataclasses

    from photon_ml_tpu_torch.estimators import GameEstimator
    from photon_ml_tpu_torch.ops.kernels import csc_column_sums

    configs = game_configs()
    configs[0] = dataclasses.replace(configs[0], streaming=True,
                                     chunk_rows=GAME_STREAM_CHUNK_ROWS)
    est = GameEstimator(task="logistic", n_iterations=1, evaluators=["auc"],
                        device=dev)
    torch.cuda.synchronize()
    csc_column_sums.launches = 0
    t0 = time.perf_counter()
    result = est.fit(ctx["train"], ctx["val"], [configs],
                     dataset_cache=ctx["cache"])[0]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = csc_column_sums.launches
    auc = result.history[-1]["auc"]
    fixed = next(r for r in result.history if r["coordinate"] == "fixed")
    st = fixed["stream"]
    n_chunks = -(-ctx["train"].num_samples // GAME_STREAM_CHUNK_ROWS)
    print(f"game fit, streamed fixed coordinate: 1 sweep in {seconds:.3f} "
          f"s, {launches} launches ({st['kernel_passes']} kernel passes of "
          f"{n_chunks} chunks), fixed {fixed['seconds']:.4f} s (decode_s "
          f"{st['decode_s']:.4f}, transfer_s {st['transfer_s']:.4f}, "
          f"stall_s {st['stall_s']:.4f}); auc {auc:.6f} vs phase 12's first "
          f"sweep {ctx['auc0']:.6f} (tol {TOL_GAME_STREAM_AUC}), on {smi}")
    if launches != n_chunks * st["kernel_passes"] or launches < 1:
        raise RuntimeError(f"streamed fixed coordinate: {launches} launches "
                           f"for {st['kernel_passes']} passes of {n_chunks} "
                           "chunks")
    if not abs(auc - ctx["auc0"]) <= TOL_GAME_STREAM_AUC:
        raise RuntimeError(f"streamed GAME auc {auc} vs {ctx['auc0']}")
    return launches


def write_game_part(task):
    """Worker: one Avro file of TrainingExampleAvro records (value 1.0 per
    feature ``f{j}``, ``user`` and ``item`` in ``metadataMap``) through the
    port's writer."""
    path, idx, labels, users, items = task
    from photon_ml_tpu_torch.io.data_reader import write_training_examples

    rows = ([(f"f{j}", "", 1.0) for j in row] for row in idx.tolist())
    write_training_examples(path, rows, labels,
                            entity_ids={"user": users, "item": items})
    return path


def write_game_fixture(root, n, n_val, file_rows):
    """``game_arrays``' rows as Avro files, ``n`` training rows under
    ``root/train`` and ``n_val`` validation rows under
    ``root/validation``, one spawn worker per file."""
    import multiprocessing
    import os

    idx, users, items, y = game_arrays(n + n_val, SEED)
    tasks = []
    for sub, lo, hi in (("train", 0, n), ("validation", n, n + n_val)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for part, start in enumerate(range(lo, hi, file_rows)):
            rows = slice(start, min(start + file_rows, hi))
            tasks.append((os.path.join(root, sub, f"part-{part:02d}.avro"),
                          idx[rows], y[rows], users[rows], items[rows]))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(len(tasks), os.cpu_count() or 1)) as pool:
        pool.map(write_game_part, tasks)
    return os.path.join(root, "train"), os.path.join(root, "validation"), \
        len(tasks)


def refit_plain(first):
    """The training driver's first fixed-coordinate fit (from zeros, on the
    offsets and settings it was given) again on the same device state,
    with its gradients through the plain "csc" path instead of the
    kernel."""
    from photon_ml_tpu_torch.game import descent
    from photon_ml_tpu_torch.parallel.data_parallel import make_csc_path

    state = first["state"]
    if not (first["from_zero"] and state.sparse_grad == "csc_kernel"):
        raise RuntimeError(f"the driver's first fixed fit ran "
                           f"sparse_grad={state.sparse_grad!r}, from zeros: "
                           f"{first['from_zero']}")
    kept = state.csc, state._fg_csc, state._hvp_csc, state.w
    build, state._fg_csc, state._hvp_csc = make_csc_path(state.obj)
    state.csc = build(state._batch(torch.zeros_like(state.labels)))
    state.w = None
    try:
        return descent._FixedState.fit(state, first["offsets"],
                                       first["opt_config"])
    finally:
        state.csc, state._fg_csc, state._hvp_csc, state.w = kept


def game_driver_coordinates():
    """``game_configs()`` as the training driver's coordinate JSON, with
    the item coordinate solved by the batched TRON."""
    keys = ("name", "coordinate_type", "entity_column", "max_iters",
            "tolerance", "num_buckets", "reg_type", "reg_weight")
    coords = []
    for cfg in game_configs():
        c = {k: getattr(cfg, k) for k in keys}
        if cfg.name == "per_item":
            c["optimizer"] = "tron"
        coords.append(c)
    return json.dumps(coords)


def phase_game_driver(dev, smi, n=GAME_ROWS, n_val=GAME_VAL_ROWS,
                      file_rows=GAME_FILE_ROWS, then=None):
    """Phase 13: the GAME command-line path at phase 12's shape, written
    as Avro: the feature indexing driver, the training driver (3 sweeps, 2
    Bayesian tuning rounds of the fixed coordinate's reg weight) and the
    scoring driver on the saved ``best`` model; then ``then(best,
    scores)`` (phases 19 (b) and 20) on the saved model and the scoring
    driver's scores of the validation rows, before they are removed. Returns (the kernel's
    launches in the training driver's run, what ``then`` returned)."""
    import os
    import tempfile

    from photon_ml_tpu_torch.cli import (
        feature_indexing_driver, game_scoring_driver, game_training_driver,
    )
    from photon_ml_tpu_torch.game import descent
    from photon_ml_tpu_torch.io.avro import iter_avro_records
    from photon_ml_tpu_torch.ops.kernels import csc_column_sums

    def read_log(out):
        with open(os.path.join(out, "photon.log.jsonl")) as f:
            return [json.loads(line) for line in f]

    def stages(log):
        return {e["stage"]: e["seconds"] for e in log
                if e["event"] == "stage_timing"}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_game_driver_") as root:
        t0 = time.perf_counter()
        train_dir, val_dir, n_files = write_game_fixture(root, n, n_val,
                                                         file_rows)
        print(f"game driver fixture: {n} training and {n_val} validation "
              f"rows, {K} features f0..f{GAME_DIM - 1} of value 1 per row, "
              f"user and item ids in metadataMap; written in "
              f"{time.perf_counter() - t0:.2f} s by {n_files} processes")
        imap_path = os.path.join(root, "index-map.json")
        t0 = time.perf_counter()
        if feature_indexing_driver.main(["--data", train_dir,
                                         "--output", imap_path]) != 0:
            raise RuntimeError("feature_indexing_driver failed")
        print(f"  feature_indexing_driver: {time.perf_counter() - t0:.2f} s")

        out = os.path.join(root, "out")
        argv = ["--train-data", train_dir, "--validation-data", val_dir,
                "--coordinates", game_driver_coordinates(),
                "--index-map", imap_path, "--n-iterations", str(GAME_SWEEPS),
                "--evaluators", "auc", "--tuning-mode", "bayesian",
                "--tuning-iters", str(GAME_TUNING_ROUNDS),
                "--tuning-coordinates", "fixed", "--device", str(dev),
                "--output-dir", out,
                "--publish-to", registry_paths(root)["registry"]]
        fixed_fits, builds, scored, finals = [], [], [], []
        real_fit, real_get = descent._FixedState.fit, descent.get_evaluator
        real_build = descent.CoordinateDescent._build_random_states
        real_estimator = game_training_driver.GameEstimator

        first = {}

        def counted_fit(self, offsets_full, opt_config=None):
            torch.cuda.synchronize()
            before = csc_column_sums.launches
            if not first:
                first.update(state=self, offsets=offsets_full.clone(),
                             opt_config=opt_config, from_zero=self.w is None)
            t_fit = time.perf_counter()
            res = real_fit(self, offsets_full, opt_config)
            float(res.value)
            fixed_fits.append((time.perf_counter() - t_fit,
                               csc_column_sums.launches - before,
                               res.iterations))
            first.setdefault("res", res)
            return res

        def timed_build(self, *a):
            t_build = time.perf_counter()
            real_build(self, *a)
            builds.append(time.perf_counter() - t_build)

        class RecordingEstimator(real_estimator):
            """Keeps each fit's final validation scores beside its
            configuration."""

            def fit(self, *a, **kw):
                results = super().fit(*a, **kw)
                for r in results:
                    finals.append(({c.name: c.reg_weight for c in r.configs},
                                   scored[-1]))
                return results

        descent._FixedState.fit = counted_fit
        descent.CoordinateDescent._build_random_states = timed_build
        descent.get_evaluator = \
            lambda name: _RecordingEvaluator(real_get(name), scored)
        game_training_driver.GameEstimator = RecordingEstimator
        try:
            torch.cuda.synchronize()
            csc_column_sums.launches = 0
            t0 = time.perf_counter()
            rc = game_training_driver.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = csc_column_sums.launches
        finally:
            descent._FixedState.fit = real_fit
            descent.CoordinateDescent._build_random_states = real_build
            descent.get_evaluator = real_get
            game_training_driver.GameEstimator = real_estimator
        if rc != 0:
            raise RuntimeError(f"game_training_driver exited with {rc}")
        check_bootstrap_publish(root)
        log = read_log(out)
        read = next(e for e in log if e["event"] == "data_read")
        print(f"game_training_driver: {seconds:.3f} s in all, {launches} "
              f"kernel launches, {read['num_train']} + "
              f"{read['num_validation']} rows, {read['num_features']} "
              f"features, on {smi}")
        for stage, sec in stages(log).items():
            print(f"  stage {stage}: {sec:.4f} s")
        print(f"  random-effect bucket builds (host): "
              f"{', '.join(f'{b:.2f} s' for b in builds)}")
        for e in log:
            if e["event"] == "cd_iteration":
                extra = ""
                if "entities_solved" in e:
                    extra = (f", {e['entities_solved']} entities solved, "
                             f"mean iterations "
                             f"{e['mean_optimizer_iterations']:.2f}")
                print(f"  config {e['config']} sweep {e['iteration']} "
                      f"{e['coordinate']}: {e['seconds']:.4f} s (solve "
                      f"{e['solve_seconds']:.4f}){extra}, auc "
                      f"{e['auc']:.6f}")
        rounds = [e for e in log if e["event"] == "tuning_round"]
        for e in rounds:
            print(f"  tuning round {e['round']}: reg weights "
                  f"{e['reg_weights']}, auc {e['metrics']['auc']:.6f}")
        if len(rounds) != GAME_TUNING_ROUNDS:
            raise RuntimeError(f"{len(rounds)} tuning rounds logged, not "
                               f"{GAME_TUNING_ROUNDS}")
        n_fits = (1 + GAME_TUNING_ROUNDS) * GAME_SWEEPS
        if len(fixed_fits) != n_fits:
            raise RuntimeError(f"{len(fixed_fits)} fixed-coordinate fits, "
                               f"not {n_fits}")
        for i, (sec, n_launch, iters) in enumerate(fixed_fits):
            print(f"  fixed fit {i}: {iters} iterations, {n_launch} kernel "
                  f"launches, {sec:.4f} s")
            if n_launch < 1:
                raise RuntimeError("a fixed-coordinate fit did not launch the "
                                   "kernel")
        check_plain("game_driver fixed fit 0", first["res"],
                    refit_plain(first))
        done = log[-1]
        best_weights = {c["name"]: c["reg_weight"]
                        for c in done["best_config"]}
        best_auc = done["best_metrics"]["auc"]
        want = [sc for weights, sc in finals if weights == best_weights]
        if len(finals) != 1 + GAME_TUNING_ROUNDS or not want:
            raise RuntimeError(f"no recorded fit of the selected "
                               f"configuration {best_weights}")

        sout = os.path.join(root, "scores")
        t0 = time.perf_counter()
        rc = game_scoring_driver.main(
            ["--data", val_dir, "--model-dir", os.path.join(out, "best"),
             "--output-dir", sout, "--evaluators", "auc",
             "--device", str(dev)])
        t_score = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"game_scoring_driver exited with {rc}")
        slog = read_log(sout)
        scores = np.array([r["predictionScore"] for r in iter_avro_records(
            os.path.join(sout, "scores.avro"))])
        auc = next(e for e in slog if e["event"] == "evaluation")["auc"]
        after = (None if then is None
                 else then(os.path.join(out, "best"), scores))
    print(f"game_scoring_driver: {t_score:.3f} s on {smi}; "
          + ", ".join(f"stage {k} {v:.4f} s" for k, v in stages(slog).items()))
    diff = float(np.abs(scores - want[-1]).max()) if scores.shape == \
        want[-1].shape else float("inf")
    print(f"  best configuration {best_weights}: the reloaded best/ model's "
          f"{scores.shape[0]} validation scores against the training run's "
          f"final ones: max |diff| {diff:.3e} (tol {TOL_SCORE}); auc "
          f"{auc:.9f} against driver_done's {best_auc:.9f} (tol "
          f"{TOL_DRIVER_AUC})")
    if not (np.isfinite(scores).all() and scores.shape == (n_val,)
            and diff <= TOL_SCORE):
        raise RuntimeError(f"the scoring driver's scores differ: {diff:.3e}")
    if not abs(auc - best_auc) <= TOL_DRIVER_AUC:
        raise RuntimeError(f"the scoring driver's auc {auc} differs from "
                           f"the training run's {best_auc}")
    return launches, after


def phase_stream(obj, indices, labels, batch, csc, w5, smi, gen, dev, peaks):
    """Phase 14: the streamed main path at full width. Returns (kernel
    launches by fit, the per-chunk timing entry)."""
    from photon_ml_tpu_torch.game.data import HostSparse
    from photon_ml_tpu_torch.ops.kernels import csc_column_sums
    from photon_ml_tpu_torch.optimize.common import OptimizerConfig
    from photon_ml_tpu_torch.parallel.data_parallel import (
        fit_distributed, make_csc_path,
    )
    from photon_ml_tpu_torch.parallel.streaming import (
        StreamStats, fit_streaming, make_host_chunks,
        streaming_value_and_grad,
    )
    from photon_ml_tpu_torch.types import (
        SparseFeatures, build_csc_transpose, make_batch,
    )

    t0 = time.perf_counter()
    chunks, _ = make_host_chunks(
        HostSparse(indices.cpu().numpy(), None, DIM), labels.cpu().numpy(),
        chunk_rows=STREAM_CHUNK_ROWS)
    nnz = STREAM_CHUNK_ROWS * K
    print(f"stream chunks: {len(chunks)} of {STREAM_CHUNK_ROWS} rows "
          f"({chunks[0].indices.nbytes / 1e6:.2f} MB of indices each, "
          f"{nnz} implicit-ones nonzeros), made on the host in "
          f"{time.perf_counter() - t0:.2f} s; prefetch depth {STREAM_DEPTH}")

    # (a) one streamed gradient pass against the in-memory kernel pass
    _, fg_mem, _ = make_csc_path(obj, use_kernel=True)
    fg = streaming_value_and_grad(obj, chunks, DIM,
                                  prefetch_depth=STREAM_DEPTH,
                                  stats=StreamStats(), device=dev)
    g0_norm = None
    for label, w in (("w = 0", torch.zeros(DIM, device=dev)),
                     ("phase 5's w", w5)):
        torch.cuda.synchronize()
        csc_column_sums.launches = 0
        t0 = time.perf_counter()
        f_s, g_s = fg(w, 1.0)
        f_s = float(f_s)
        sec = time.perf_counter() - t0
        launches = csc_column_sums.launches
        f_m, g_m = fg_mem(w, batch, csc, 1.0)
        if g0_norm is None:
            g0_norm = float(g_m.norm())
        rel_f = abs(f_s - float(f_m)) / abs(float(f_m))
        g_err = float((g_s - g_m).norm()) / g0_norm
        print(f"  streamed fg at {label}: {sec:.4f} s, {launches} launches; "
              f"|f - f_mem| / |f_mem| = {rel_f:.3e} (tol {TOL_STREAM_F}), "
              f"|g - g_mem| / |g_mem(0)| = {g_err:.3e} (tol {TOL_STREAM_G})")
        if not (rel_f <= TOL_STREAM_F and g_err <= TOL_STREAM_G):
            raise RuntimeError(f"streamed fg at {label} disagrees with the "
                               "in-memory pass")
        if launches != len(chunks):
            raise RuntimeError(f"streamed fg launched {launches} times for "
                               f"{len(chunks)} chunks")

    fits = {
        "stream_lbfgs_margin": dict(optimizer="lbfgs", config=OptimizerConfig(
            max_iters=ITERS, tolerance=0.0)),
        "stream_tron": dict(optimizer="tron", config=OptimizerConfig(
            max_iters=TRON_ITERS, tolerance=0.0)),
        "stream_owlqn": dict(optimizer="owlqn", l1=L1, config=OptimizerConfig(
            max_iters=ITERS, tolerance=0.0)),
    }
    f0 = N_ROWS * math.log(2.0)
    launches_by_fit, runs = {}, {}
    for name, kw in fits.items():
        def run(mode, depth=STREAM_DEPTH, kw=kw):
            return fit_streaming(obj, chunks, DIM,
                                 torch.zeros(DIM, device=dev), l2=1.0,
                                 prefetch_depth=depth, sparse_grad=mode,
                                 device=dev, **kw)

        res, sec, launches = run_counted(lambda: run("csc_kernel"))
        st = res.stream_stats
        print(f"fit {name} (streamed, csc_kernel): {res.iterations} "
              f"iterations, {st['kernel_passes']} kernel passes of "
              f"{st['passes']} passes, {launches} launches, {sec:.3f} s "
              f"({sec / st['passes'] * 1e3:.2f} ms per pass), objective "
              f"{float(res.value):.4f}, on {smi}")
        print(f"  StreamStats: decode_s {st['decode_s']:.4f}, transfer_s "
              f"{st['transfer_s']:.4f}, stall_s {st['stall_s']:.4f}; "
              f"{st['h2d_bytes'] / 1e9:.3f} GB to the card, "
              f"{st['h2d_bytes'] / 1e9 / max(st['transfer_s'], 1e-9):.2f} "
              f"GB/s over the transfer thread's seconds, "
              f"{st['h2d_bytes'] / 1e9 / sec:.2f} GB/s over the fit; "
              f"{st['host_reads'] / st['passes']:.2f} host reads per pass")
        check_descent(name, res, DIM, f0)
        # (d) one launch per chunk of every gradient, HVP and diagonal pass
        if launches != len(chunks) * st["kernel_passes"]:
            raise RuntimeError(f"{name}: {launches} launches, not "
                               f"{len(chunks)} x {st['kernel_passes']}")
        # (b) the kernel fit against the plain "csc" fit, as phases 5-7
        # hold the in-memory fits: the kernel sums each column in float64,
        # "csc" differences float64 tile prefixes, so a column sum can
        # round to another float32
        t0 = time.perf_counter()
        plain = run("csc")
        float(plain.value)
        print(f"  plain csc streamed fit: {time.perf_counter() - t0:.3f} s, "
              f"bit-identical: {torch.equal(res.w, plain.w)}")
        check_plain(name, res, plain)
        launches_by_fit[name] = launches
        runs[name] = (res, run)

    # (c) prefetch depth 0 against depth 2, bit for bit
    res2, run = runs["stream_lbfgs_margin"]
    t0 = time.perf_counter()
    res0 = run("csc_kernel", depth=0)
    float(res0.value)
    st0 = res0.stream_stats
    print(f"  lbfgs at prefetch depth 0: {time.perf_counter() - t0:.3f} s "
          f"(stall_s {st0['stall_s']:.4f}, transfer_s "
          f"{st0['transfer_s']:.4f}); equal to depth {STREAM_DEPTH}: "
          f"{torch.equal(res0.w, res2.w)}")
    if not torch.equal(res0.w, res2.w):
        raise RuntimeError("streamed lbfgs depends on the prefetch depth: "
                           f"{rel_l2(res0.w, res2.w):.3e}")

    # (e) at the CPU-check shape, streamed and in-memory L-BFGS both run
    # to convergence in float32: tolerance 0 and enough iterations to
    # reach the float32 floor (a relative-loss stop leaves w 1e-3 apart)
    idx_s, y_s = make_data(N_SMALL, DIM_SMALL, K, gen, dev)
    small = make_batch(SparseFeatures(idx_s, None, DIM_SMALL), y_s,
                       device=dev)
    cfg = OptimizerConfig(max_iters=STREAM_CONV_ITERS, tolerance=0.0)
    w0 = torch.zeros(DIM_SMALL, device=dev)
    mem = fit_distributed(obj, small, w0, l2=1.0, config=cfg)
    small_chunks, _ = make_host_chunks(
        HostSparse(idx_s.cpu().numpy(), None, DIM_SMALL), y_s.cpu().numpy(),
        chunk_rows=N_SMALL // 8)
    st_small = fit_streaming(obj, small_chunks, DIM_SMALL, w0, l2=1.0,
                             config=cfg, device=dev)
    rel = rel_l2(st_small.w, mem.w)
    g_norms = [float(r.grad_norm) for r in (st_small, mem)]
    print(f"  n={N_SMALL}, d={DIM_SMALL} to convergence in float32: "
          f"streamed {st_small.iterations} iterations (|g| {g_norms[0]:.3e}), "
          f"in-memory {mem.iterations} (|g| {g_norms[1]:.3e}); rel L2 of w "
          f"{rel:.3e} (tol {TOL_FIT})")
    if not rel <= TOL_FIT:
        raise RuntimeError(f"streamed and in-memory fits disagree: {rel:.3e}")

    # per chunk: the kernel (and the previous route), the CSC sort and the
    # pinned copy
    idx_c = torch.as_tensor(chunks[0].indices, device=dev)
    sort_ms = cuda_ms(
        lambda: build_csc_transpose(idx_c, None, DIM, with_cols=False), 20)
    timing = column_sums_at(
        "streamed chunk", build_csc_transpose(idx_c, None, DIM,
                                              with_cols=False),
        STREAM_CHUNK_ROWS, gen, dev, peaks, smi)
    pinned = torch.empty(chunks[0].indices.shape, dtype=torch.int32,
                         pin_memory=True)
    h2d_ms = cuda_ms(lambda: pinned.to(dev, non_blocking=True), 20)
    print(f"per chunk (nnz={nnz}): CSC sort {sort_ms:.4f} ms, pinned "
          f"indices copy {h2d_ms:.4f} ms "
          f"({pinned.nbytes / 1e6 / h2d_ms:.2f} GB/s); on {smi}")
    return launches_by_fit, dict(timing, sort_ms=sort_ms, h2d_ms=h2d_ms,
                                 lbfgs_res=res2)


class _RssPeak:
    """Samples this process's resident set every 5 ms on a thread;
    ``peak`` is the largest sample, ``base`` the first."""

    def __init__(self):
        import os
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        self.base = self.peak = self._rss()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="rss-sampler")

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _run(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=5)


def phase_glm_ooc(root, train_dir, val_dir, dev, smi):
    """Phase 15: the GLM driver in memory, with --streaming, then with
    --out-of-core through a chunk cache (cold, then warm), on phase 9's
    files. Returns the cold out-of-core run's kernel launches (phase 9
    times the kernel at a chunk's shape)."""
    import filecmp
    import os

    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.io.model_io import load_game_model
    from photon_ml_tpu_torch.ops.kernels import csc_column_sums

    cache = os.path.join(root, "chunk_cache")
    base = ["--train-data", train_dir, "--validation-data", val_dir,
            "--input-format", "avro", "--hash-dim", str(DRIVER_HASH_DIM),
            "--reg-weights", "1.0", "--optimizer", "lbfgs",
            "--max-iters", str(OOC_ITERS), "--tolerance", str(OOC_TOL),
            "--evaluators", "auc", "--device", str(dev),
            "--chunk-rows", str(OOC_CHUNK_ROWS)]
    runs = {"in_memory": [],
            "streaming": ["--streaming"],
            "ooc_cold": ["--out-of-core", "--chunk-cache-dir", cache],
            "ooc_warm": ["--out-of-core", "--chunk-cache-dir", cache]}
    chunk_mb = OOC_CHUNK_ROWS * (8 * (DRIVER_FEATURES + 1) + 12) / 1e6
    out, launches_by_run, aucs = {}, {}, {}
    for name, flags in runs.items():
        out[name] = os.path.join(root, f"out_{name}")
        torch.cuda.synchronize()
        csc_column_sums.launches = 0
        t0 = time.perf_counter()
        with _RssPeak() as rss:
            rc = glm_driver.main(base + flags + ["--output-dir", out[name]])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = csc_column_sums.launches
        if rc != 0:
            raise RuntimeError(f"glm_driver {name} exited with {rc}")
        with open(os.path.join(out[name], "photon.log.jsonl")) as f:
            log = [json.loads(line) for line in f]
        print(f"glm_driver {name}: {seconds:.3f} s, {launches} launches, "
              f"peak RSS +{(rss.peak - rss.base) / 1e6:.1f} MB (the ring's "
              f"bound: {STREAM_DEPTH + 2} chunks of {chunk_mb:.2f} MB); on "
              f"{smi}")
        trained = next(e for e in log if e["event"] == "lambda_trained")
        aucs[name] = auc = trained["metrics"]["auc"]
        st = trained.get("stream")
        print(f"  {trained['iterations']} iterations (converged "
              f"{trained['converged']}), loss {trained['loss']:.4f}, auc "
              f"{auc:.6f}" + ("" if st is None else
                              f"; {st['kernel_passes']} kernel passes of "
                              f"{st['passes']}, {st['chunks']} chunks, "
                              f"decode_s {st['decode_s']:.3f}, transfer_s "
                              f"{st['transfer_s']:.3f}, stall_s "
                              f"{st['stall_s']:.3f}"))
        for e in log:
            if e["event"] == "stage_timing":
                print(f"  stage {e['stage']}: {e['seconds']:.4f} s")
        if launches < 1:
            raise RuntimeError(f"glm_driver {name}: the kernel did not "
                               "launch")
        if not abs(auc - aucs["in_memory"]) <= TOL_OOC_AUC:
            raise RuntimeError(f"glm_driver {name}: auc {auc} vs the "
                               f"in-memory run's {aucs['in_memory']}")
        launches_by_run[name] = launches

    sub = os.path.join("best", "fixed-effect", "global")
    cold, warm = (os.path.join(out[n], sub) for n in ("ooc_cold", "ooc_warm"))
    names = sorted(os.listdir(cold))
    match, mismatch, errors = filecmp.cmpfiles(cold, warm, names,
                                               shallow=False)
    if mismatch or errors or not match:
        raise RuntimeError(f"warm and cold models differ: {mismatch} "
                           f"{errors}")
    w = {n: load_game_model(os.path.join(out[n], "best"), device=dev)[
        "global"].model.coefficients.means for n in ("streaming", "ooc_cold")}
    rel = rel_l2(w["ooc_cold"], w["streaming"])
    print(f"  warm model files equal the cold run's byte for byte "
          f"({', '.join(match)}); out-of-core vs --streaming w rel L2 "
          f"{rel:.3e} (tol {TOL_OOC_W}); every auc within {TOL_OOC_AUC} of "
          f"the in-memory run's ({aucs['in_memory']:.6f})")
    if not rel <= TOL_OOC_W:
        raise RuntimeError(f"out-of-core model differs: {rel:.3e}")
    return launches_by_run["ooc_cold"]


# -- phase 17: multi-process ---------------------------------------------
MP_WORLD = 2  # leg (b): two ranks on the one card, over gloo
MP_TIMEOUT_S = 600  # leg (b)'s ranks, from spawn to exit
TOL_MP_RE = 1e-5  # leg (c): random-effect coefficients, max |diff|
TOL_MP_AUC = 1e-6  # leg (c): the sweep's auc


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class _CollectiveClock:
    """Times every ``torch.distributed`` collective the port calls between
    two device synchronizations (so a collective's seconds exclude the
    compute queued before it); installed for a repeat of a fit whose own
    seconds are taken without it."""

    NAMES = ("all_reduce", "all_gather", "broadcast")

    def __init__(self):
        self.seconds, self.calls = 0.0, 0

    def __enter__(self):
        import torch.distributed as dist

        self._real = {n: getattr(dist, n) for n in self.NAMES}

        def timed(fn):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                return out
            return call

        for n, fn in self._real.items():
            setattr(dist, n, timed(fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self._real.items():
            setattr(dist, n, fn)


def phase_mp_world1(obj, batch, csc, w5, smi):
    """Phase 17 (a): a one-rank NCCL group in this process
    (``initialize_multihost``: backend ``cpu:gloo,cuda:nccl``) and phase
    5's fit through ``fit_distributed(..., mesh=make_mesh({"data": 1}))``:
    ITERS + 1 launches and ``w`` within TOL_FIT of phase 5's (0 expected).
    Returns the launches."""
    import torch.distributed as dist

    from photon_ml_tpu_torch.optimize.common import OptimizerConfig
    from photon_ml_tpu_torch.parallel.data_parallel import fit_distributed
    from photon_ml_tpu_torch.parallel.mesh import make_mesh
    from photon_ml_tpu_torch.parallel.multihost import initialize_multihost

    t0 = time.perf_counter()
    initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0, timeout_s=120)
    try:
        mesh = make_mesh({"data": 1})
        print(f"phase 17 (a): world 1 over {dist.get_backend()}, mesh "
              f"{mesh.mesh_dim_names} {tuple(mesh.shape)}, rendezvous "
              f"{time.perf_counter() - t0:.3f} s")

        def fit(iters):
            return fit_distributed(
                obj, batch, torch.zeros(DIM, device=batch.device), l2=1.0,
                config=OptimizerConfig(max_iters=iters, tolerance=0.0),
                sparse_grad="csc_kernel", precomputed_csc=csc, mesh=mesh)

        fit(2)  # warm-up
        res, sec, launches = run_counted(lambda: fit(ITERS))
        with _CollectiveClock() as clock:
            fit(ITERS)
    finally:
        dist.destroy_process_group()
    rel = rel_l2(res.w, w5)
    print(f"  fit lbfgs csc_kernel, mesh data=1: {res.iterations} "
          f"iterations, {launches} launches, {res.host_syncs} host reads, "
          f"{sec:.4f} s ({clock.calls} collectives, {clock.seconds:.4f} s in "
          f"them in a timed repeat); |w - w_phase5| / |w_phase5| = "
          f"{rel:.3e} (tol {TOL_FIT}) on {smi}")
    if launches != ITERS + 1 or res.iterations != ITERS:
        raise RuntimeError(f"world 1: {launches} launches in "
                           f"{res.iterations} iterations")
    if not rel <= TOL_FIT:
        raise RuntimeError(f"world 1: w differs from phase 5's: {rel:.3e}")
    return launches


def phase_mp_driver(train_dir, val_dir, root, dev, smi):
    """Phase 17, the driver leg (on phase 9's files, one lambda): the GLM
    driver with ``--num-processes 1 --process-id 0 --coordinator-address``
    writes a model byte-identical to the same run without the flags.
    Returns the flagged run's launches."""
    import filecmp
    import os

    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.ops.kernels import csc_column_sums

    base = ["--train-data", train_dir, "--validation-data", val_dir,
            "--input-format", "avro", "--hash-dim", str(DRIVER_HASH_DIM),
            "--reg-weights", "1", "--optimizer", "lbfgs", "--max-iters",
            str(ITERS), "--tolerance", "0", "--evaluators", "auc",
            "--device", str(dev)]
    runs = {"one_process": [],
            "num_processes_1": ["--num-processes", "1", "--process-id", "0",
                                "--coordinator-address",
                                f"127.0.0.1:{_free_port()}"]}
    out, launches = {}, {}
    for name, flags in runs.items():
        out[name] = os.path.join(root, f"out_mp_{name}")
        torch.cuda.synchronize()
        csc_column_sums.launches = 0
        t0 = time.perf_counter()
        rc = glm_driver.main(base + flags + ["--output-dir", out[name]])
        torch.cuda.synchronize()
        launches[name] = csc_column_sums.launches
        if rc != 0:
            raise RuntimeError(f"glm_driver {name} exited with {rc}")
        with open(os.path.join(out[name], "photon.log.jsonl")) as f:
            start = json.loads(f.readline())
        print(f"phase 17 driver leg, glm_driver {name}: "
              f"{time.perf_counter() - t0:.3f} s, {launches[name]} launches, "
              f"distributed={start['distributed']}, on {smi}")
    sub = os.path.join("best", "fixed-effect", "global")
    a, b = (os.path.join(out[n], sub) for n in runs)
    names = sorted(os.listdir(a))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    print(f"  model files with --num-processes 1 equal the run without the "
          f"flags byte for byte: {match} (differ: {mismatch + errors})")
    if mismatch or errors or not match:
        raise RuntimeError(f"--num-processes 1 model differs: {mismatch} "
                           f"{errors}")
    if launches["num_processes_1"] != launches["one_process"]:
        raise RuntimeError(f"driver launches differ: {launches}")
    return launches["num_processes_1"]


def mp_check_gloo_cuda(dev):
    """gloo's all_reduce (sum, min, max) and all_gather on CUDA float32
    and float64 tensors, every rank holding rank + 1."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    for dtype in (torch.float32, torch.float64):
        for op, want in ((dist.ReduceOp.SUM, world * (world + 1) / 2),
                         (dist.ReduceOp.MIN, 1.0),
                         (dist.ReduceOp.MAX, float(world))):
            x = torch.full((5,), rank + 1.0, dtype=dtype, device=dev)
            dist.all_reduce(x, op=op)
            if not bool((x == want).all()):
                raise RuntimeError(f"gloo all_reduce {op} {dtype}: {x}")
        parts = [torch.empty(3, dtype=dtype, device=dev)
                 for _ in range(world)]
        dist.all_gather(parts, torch.full((3,), rank + 1.0, dtype=dtype,
                                          device=dev))
        if [float(p[0]) for p in parts] != [r + 1.0 for r in range(world)]:
            raise RuntimeError(f"gloo all_gather {dtype}: {parts}")


def mp_rank(rank: int, root: str) -> int:
    """Phase 17 (b) and (c), one rank of MP_WORLD on the one card: a gloo
    group (NCCL refuses two ranks on one device) through a FileStore in
    ``root``, the collectives on CUDA tensors. Writes ``rank{r}.json``
    (the printed lines and the counts) and ``rank{r}.npz`` (every fit's
    ``w``, the GAME sweep's coefficients and auc)."""
    import datetime
    import os

    import torch.distributed as dist

    from photon_ml_tpu_torch.estimators import GameEstimator
    from photon_ml_tpu_torch.game.data import HostSparse
    from photon_ml_tpu_torch.ops import kernel_build
    from photon_ml_tpu_torch.ops.kernels import (
        csc_column_sums, multiply_prefix_sum,
    )
    from photon_ml_tpu_torch.ops.objective import make_objective
    from photon_ml_tpu_torch.optimize.common import OptimizerConfig
    from photon_ml_tpu_torch.parallel.data_parallel import (
        build_csc, fit_shard,
    )
    from photon_ml_tpu_torch.parallel.mesh import (
        make_mesh, mesh_device, shard_batch,
    )
    from photon_ml_tpu_torch.parallel.multihost import process_span
    from photon_ml_tpu_torch.parallel.streaming import (
        fit_streaming, make_host_chunks,
    )
    from photon_ml_tpu_torch.types import LabeledBatch, SparseFeatures

    t_start = time.perf_counter()
    kernel_build.load_library()
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"), MP_WORLD),
        rank=rank, world_size=MP_WORLD,
        timeout=datetime.timedelta(seconds=MP_TIMEOUT_S))
    lines, counts, arrays = [], {}, {}

    def say(msg):
        lines.append(f"  rank {rank}: {msg}")

    mesh = make_mesh({"data": MP_WORLD})
    dev = mesh_device(mesh)
    mp_check_gloo_cuda(dev)
    say(f"gloo group up {time.perf_counter() - t_start:.2f} s after start; "
        f"all_reduce (sum/min/max) and all_gather on CUDA float32 and "
        f"float64 tensors checked; device {dev}")

    # (b) phase 5's rows, written by the parent; this rank keeps its block
    idx = np.load(os.path.join(root, "indices.npy"), mmap_mode="c")
    y = np.load(os.path.join(root, "labels.npy"))
    n = y.shape[0]
    batch = LabeledBatch(SparseFeatures(torch.from_numpy(idx), None, DIM),
                         torch.from_numpy(y), torch.zeros(n),
                         torch.ones(n))
    obj = make_objective("logistic")
    # shard once and fit the block, as the GLM driver and the path solver
    # do: the timed fits move no rows from the host
    t0 = time.perf_counter()
    block = shard_batch(batch, mesh)
    csc = build_csc(block)
    torch.cuda.synchronize()
    say(f"row block of {block.num_examples} rows to the card and its CSC "
        f"view in {time.perf_counter() - t0:.3f} s")
    del batch

    def fit(optimizer, iters):
        return fit_shard(
            obj, block, torch.zeros(DIM, device=dev), l2=1.0,
            optimizer=optimizer,
            config=OptimizerConfig(max_iters=iters, tolerance=0.0),
            sparse_grad="csc_kernel", precomputed_csc=csc, mesh=mesh)

    for name, optimizer, iters in (("lbfgs_margin", "lbfgs", ITERS),
                                   ("tron", "tron", TRON_ITERS)):
        fit(optimizer, 1)  # warm-up
        res, sec, launches = run_counted(lambda: fit(optimizer, iters))
        with _CollectiveClock() as clock:
            fit(optimizer, iters)
        say(f"fit {name} csc_kernel, mesh data={MP_WORLD}: {res.iterations} "
            f"iterations, {launches} launches, {res.host_syncs} host reads, "
            f"{sec:.4f} s; {clock.calls} collectives, {clock.seconds:.4f} s "
            f"in them (timed repeat)")
        counts[name] = dict(launches=launches, iterations=res.iterations,
                            host_reads=res.host_syncs, seconds=sec,
                            collective_s=clock.seconds,
                            collectives=clock.calls)
        if optimizer == "tron":
            counts[name]["accepted"] = tron_accepted(res, N_ROWS)
        arrays[f"{name}_w"] = res.w.cpu().numpy()
    del block, csc

    s0, s1 = process_span(n)
    chunks, _ = make_host_chunks(HostSparse(idx[s0:s1], None, DIM), y[s0:s1],
                                 chunk_rows=STREAM_CHUNK_ROWS)
    res, sec, launches = run_counted(lambda: fit_streaming(
        obj, chunks, DIM, torch.zeros(DIM, device=dev), l2=1.0,
        config=OptimizerConfig(max_iters=ITERS, tolerance=0.0),
        prefetch_depth=STREAM_DEPTH, sparse_grad="csc_kernel", device=dev))
    st = res.stream_stats
    say(f"fit stream_lbfgs_margin over rows [{s0}, {s1}) in {len(chunks)} "
        f"chunks: {res.iterations} iterations, {st['kernel_passes']} kernel "
        f"passes, {launches} launches, {st['host_reads']} host reads, "
        f"{sec:.3f} s, comm_s {st['comm_s']:.4f} (transfer_s "
        f"{st['transfer_s']:.4f}, stall_s {st['stall_s']:.4f})")
    if launches != len(chunks) * st["kernel_passes"]:
        raise RuntimeError(f"rank {rank} streamed: {launches} launches for "
                           f"{st['kernel_passes']} passes of {len(chunks)} "
                           "chunks")
    counts["stream_lbfgs_margin"] = dict(
        launches=launches, iterations=res.iterations, chunks=len(chunks),
        kernel_passes=st["kernel_passes"], host_reads=st["host_reads"],
        seconds=sec, collective_s=st["comm_s"])
    arrays["stream_lbfgs_margin_w"] = res.w.cpu().numpy()
    del chunks, idx

    # (c) phase 12's data and coordinates, the random coordinates sharded
    t0 = time.perf_counter()
    train, val = make_game_data(GAME_ROWS, GAME_VAL_ROWS, SEED)
    emesh = make_mesh({"data": 1, "entity": MP_WORLD})
    est = GameEstimator(task="logistic", n_iterations=1, evaluators=["auc"],
                        mesh=emesh)
    torch.cuda.synchronize()
    csc_column_sums.launches = 0
    result = est.fit(train, val, [game_configs()])[0]
    torch.cuda.synchronize()
    launches = csc_column_sums.launches
    auc = result.history[-1]["auc"]
    steps = ", ".join(f"{r['coordinate']} {r['seconds']:.3f} s"
                      for r in result.history)
    say(f"GAME sweep, mesh data=1 entity={MP_WORLD}: "
        f"{time.perf_counter() - t0:.2f} s with the bucket build ({steps}), "
        f"{launches} launches, auc {auc:.6f}")
    counts["game_cd_entity"] = dict(launches=launches, auc=auc)
    arrays["game_auc"] = np.asarray(auc)
    for name in ("per_user", "per_item"):
        for b, bucket in enumerate(result.model[name].buckets):
            arrays[f"re_{name}_{b}"] = np.asarray(bucket.coefficients)
    if multiply_prefix_sum.launches:
        raise RuntimeError(f"rank {rank}: multiply_prefix_sum launched "
                           f"{multiply_prefix_sum.launches} times on a path")
    dist.destroy_process_group()
    np.savez(os.path.join(root, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump({"lines": lines, "counts": counts}, f)
    return 0


def phase_mp_world2(indices, labels, refs, game_ctx, dev, smi):
    """Phase 17 (b) and (c): MP_WORLD ranks of this script on the one card
    (``mp_rank``), then the gates: every rank's ``w`` equal bit for bit,
    each fit within TOL_FIT of its single-device counterpart in ``refs``
    (phases 5, 7 and 14), the launch counts; the GAME sweep's coefficients
    within TOL_MP_RE and its auc within TOL_MP_AUC of a one-rank sweep.
    Returns the launches by leg and rank."""
    import os
    import tempfile

    from photon_ml_tpu_torch.estimators import GameEstimator

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as root:
        t0 = time.perf_counter()
        np.save(os.path.join(root, "indices.npy"), indices.cpu().numpy())
        np.save(os.path.join(root, "labels.npy"), labels.cpu().numpy())
        procs = []
        for r in range(MP_WORLD):
            with open(os.path.join(root, f"rank{r}.log"), "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, "--mp-rank", str(r), root],
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + MP_TIMEOUT_S
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if time.monotonic() > deadline:
                failed = "timeout"
            time.sleep(0.2)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode),
                          None)
        if failed is not None:
            for r in range(MP_WORLD):
                with open(os.path.join(root, f"rank{r}.log")) as f:
                    print(f"rank {r} output:\n{f.read()[-4000:]}")
            raise RuntimeError(f"phase 17: rank {failed} failed, exit codes "
                               f"{[p.returncode for p in procs]}")
        print(f"phase 17 (b, c): {MP_WORLD} ranks on one card over gloo, "
              f"{time.perf_counter() - t0:.2f} s from spawn to exit")
        out = []
        for r in range(MP_WORLD):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                out.append(json.load(f))
            for line in out[r]["lines"]:
                print(line)
        arrays = [dict(np.load(os.path.join(root, f"rank{r}.npz")))
                  for r in range(MP_WORLD)]

    for key in arrays[0]:
        if not all(np.array_equal(a[key], arrays[0][key])
                   for a in arrays[1:]):
            raise RuntimeError(f"phase 17: ranks differ in {key}")
    print(f"  every rank's {len(arrays[0])} arrays equal bit for bit "
          f"({', '.join(k for k in arrays[0] if k.endswith('_w'))}, the "
          f"GAME coefficients and auc)")
    counts = [o["counts"] for o in out]
    for name in ("lbfgs_margin", "tron", "stream_lbfgs_margin"):
        rel = rel_l2(torch.from_numpy(arrays[0][f"{name}_w"]),
                     refs[name]["w"].cpu())
        print(f"  {name}: |w - w_single| / |w_single| = {rel:.3e} (tol "
              f"{TOL_FIT}); single device {refs[name]['launches']} launches")
        if not rel <= TOL_FIT:
            raise RuntimeError(f"phase 17 {name}: {rel:.3e} from the "
                               "single-device fit")
    for c in counts:
        if c["lbfgs_margin"]["launches"] != ITERS + 1:
            raise RuntimeError(f"phase 17 lbfgs launches: {c}")
        # TRON's cost model on one device: one launch per gradient (the
        # first and one per iteration), CG step (one host read each, with
        # one more read per iteration) and preconditioner pass (the first
        # and one per accepted step), so launches = 2 + host reads +
        # accepted steps, with the accepted steps read from each fit's loss
        # history; a step at actred ~ eta0 * prered may be accepted on one
        # device and rejected on two (their float32 sums round apart), so
        # each side is held to the model exactly, not to phase 7's count
        t, t1 = c["tron"], refs["tron"]
        implied = t["launches"] - t["host_reads"] - 2
        implied1 = t1["launches"] - t1["host_reads"] - 2
        print(f"  tron: {t['launches']} launches = 2 + {t['host_reads']} host "
              f"reads + {implied} steps, {t['accepted']} accepted of "
              f"{t['iterations']} iterations (single device: "
              f"{t1['launches']} = 2 + {t1['host_reads']} + {implied1}, "
              f"{t1['accepted']} accepted of {t1['iterations']})")
        if not (implied == t["accepted"] and implied1 == t1["accepted"]):
            raise RuntimeError(f"phase 17 tron launches: {t} vs {t1}")
        stream = c["stream_lbfgs_margin"]
        if stream["chunks"] * MP_WORLD != N_ROWS // STREAM_CHUNK_ROWS:
            raise RuntimeError(f"phase 17 stream chunks: {stream}")

    # (c) against one sweep on one rank over the same data and buckets
    ref = GameEstimator(task="logistic", n_iterations=1, evaluators=["auc"],
                        device=dev).fit(game_ctx["train"], game_ctx["val"],
                                        [game_configs()],
                                        dataset_cache=game_ctx["cache"])[0]
    worst = 0.0
    for name in ("per_user", "per_item"):
        for b, bucket in enumerate(ref.model[name].buckets):
            got = arrays[0][f"re_{name}_{b}"]
            worst = max(worst, float(np.abs(
                got - np.asarray(bucket.coefficients)).max(initial=0.0)))
    auc_ref = ref.history[-1]["auc"]
    auc = float(arrays[0]["game_auc"])
    print(f"  GAME, entities sharded over {MP_WORLD} ranks vs one rank: max "
          f"|coefficient diff| {worst:.3e} (tol {TOL_MP_RE}); auc {auc:.6f} "
          f"vs {auc_ref:.6f} (tol {TOL_MP_AUC}), on {smi}")
    if not (worst <= TOL_MP_RE and abs(auc - auc_ref) <= TOL_MP_AUC):
        raise RuntimeError("phase 17: the entity-sharded sweep differs from "
                           "the one-rank sweep")
    return {f"rank{r}": {k: v["launches"] for k, v in c.items()}
            for r, c in enumerate(counts)}


# -- phase 18: recovery ----------------------------------------------------
RECOVERY_SWEEPS = 3
RECOVERY_FAULT_AT = 4  # cd.step occurrence: sweep 1's per_user step
WATCHDOG_T = 10.0  # leg (c)'s barrier timeout, seconds
WATCHDOG_SLACK_S = 5.0  # rank 0 must detect the stall within T + this
RECOVERY_TIMEOUT_S = 300  # the ranks, from spawn to leg (c)
RECOVERY_GRID = ("1", "0.1")  # leg (b)'s lambdas
RANK_DEVICE = "cuda"  # the ranks' device ("cpu" in a CPU rehearsal)


def entity_table(model, name):
    """(entity ids sorted, projections, coefficients) of a random
    coordinate, one row per entity, padded to the widest bucket: the same
    table whatever the bucket layout (one rank's, or a shard's)."""
    buckets = model[name].buckets
    width = max(int(np.asarray(b.projection).shape[1]) for b in buckets)
    ids, proj, coef = [], [], []
    for b in buckets:
        p = np.asarray(b.projection)
        c = np.asarray(b.coefficients)
        pad = width - p.shape[1]
        ids.append(np.asarray(b.entity_ids))
        proj.append(np.pad(p, ((0, 0), (0, pad)), constant_values=-1))
        coef.append(np.pad(c, ((0, 0), (0, pad))))
    ids = np.concatenate(ids)
    order = np.argsort(ids, kind="stable")
    return ids[order], np.concatenate(proj)[order], \
        np.concatenate(coef)[order]


def recovery_rank(rank: int, root: str) -> int:
    """Phase 18 (a) and (c), one rank of MP_WORLD on the one card: a gloo
    group through a FileStore in ``root``; this rank's half of phase 12's
    random-effect buckets built once, then the uninterrupted run and the
    rolled-back one (``recovery{r}.json``, ``recovery{r}.npz``), then the
    watchdog leg (``watchdog{r}.json``), after which the group is unusable
    and the process exits without a teardown."""
    import datetime
    import os

    import torch.distributed as dist

    from photon_ml_tpu_torch.estimators import GameEstimator
    from photon_ml_tpu_torch.game import descent
    from photon_ml_tpu_torch.ops import kernel_build
    from photon_ml_tpu_torch.ops.kernels import (
        csc_column_sums, multiply_prefix_sum,
    )
    from photon_ml_tpu_torch.parallel import fault_injection
    from photon_ml_tpu_torch.parallel.entity_shard import EntityShardSpec
    from photon_ml_tpu_torch.parallel.recovery import (
        RecoveryManager, classify_failure, recovery_supported,
    )
    from photon_ml_tpu_torch.parallel.resilience import (
        PeerFailure, TorchTransport,
    )

    t_start = time.perf_counter()
    kernel_build.load_library()
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"), MP_WORLD),
        rank=rank, world_size=MP_WORLD,
        timeout=datetime.timedelta(seconds=RECOVERY_TIMEOUT_S))
    dev = torch.device(RANK_DEVICE)
    lines = []

    def say(msg):
        lines.append(f"  rank {rank}: {msg}")

    def dump(name, obj):
        tmp = os.path.join(root, f".{name}")
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, os.path.join(root, name))

    t0 = time.perf_counter()
    train, val = make_game_data(GAME_ROWS, GAME_VAL_ROWS, SEED)
    spec = EntityShardSpec(MP_WORLD, rank)
    cache = {}
    descent.CoordinateDescent(game_configs(), device=dev, dataset_cache=cache,
                              entity_shard=spec)._build_random_states(
        train, val, {}, {})
    owned = {key[2]: entry[1].num_entities for key, entry in cache.items()
             if key[0] == "re_data"}
    say(f"gloo group up, data drawn and this rank's buckets built "
        f"{time.perf_counter() - t_start:.2f} s after start (buckets "
        f"{time.perf_counter() - t0:.2f} s; entities owned {owned})")

    fixed_launches, published = [], []
    real_fit, real_changed = descent._FixedState.fit, descent._changed_rows

    def counted_fit(self, offsets_full, opt_config=None):
        before = csc_column_sums.launches
        res = real_fit(self, offsets_full, opt_config)
        fixed_launches.append(csc_column_sums.launches - before)
        return res

    def counted_changed(new_np, old_np):
        rows, vals = real_changed(new_np, old_np)
        published.append(len(rows))
        return rows, vals

    descent._FixedState.fit = counted_fit
    descent._changed_rows = counted_changed

    def run(recovery):
        est = GameEstimator(task="logistic", n_iterations=RECOVERY_SWEEPS,
                            evaluators=["auc"], device=dev,
                            entity_shard=spec, recovery=recovery)
        fixed_launches.clear()
        published.clear()
        torch.cuda.synchronize()
        csc_column_sums.launches = 0
        t_run = time.perf_counter()
        result = est.fit(train, val, [game_configs()],
                         dataset_cache=cache)[0]
        torch.cuda.synchronize()
        return dict(result=result, seconds=time.perf_counter() - t_run,
                    launches=csc_column_sums.launches,
                    fixed_launches=list(fixed_launches),
                    published=list(published))

    runs, arrays = {}, {}
    runs["uninterrupted"] = run(None)
    fault_injection.install([fault_injection.Fault(
        site="cd.step", kind="raise", process=1, at=RECOVERY_FAULT_AT)])
    rec = RecoveryManager(os.path.join(root, "recovery"),
                          max_rank_failures=0, backoff_s=0.05, jitter=0.0)
    runs["rollback"] = run(rec)
    fault_injection.clear()
    out = {"lines": lines, "stats": rec.as_dict()}
    for name, r in runs.items():
        hist = r["result"].history
        comm = {}
        for h in hist:
            comm.setdefault(h["iteration"], 0)
            comm[h["iteration"]] += int(h.get("comm_bytes", 0))
        # two exchanges a random step (train and validation rows), two
        # random coordinates a sweep; a rolled-back run also counts the
        # exchanges of the sweep it threw away
        rows = [sum(r["published"][i:i + 4])
                for i in range(0, len(r["published"]), 4)]
        out[name] = dict(seconds=r["seconds"], launches=r["launches"],
                         fixed_launches=r["fixed_launches"],
                         auc=[h["auc"] for h in hist],
                         rows_published=rows,
                         bytes_gathered_by_sweep=[comm[i]
                                                  for i in sorted(comm)])
        say(f"{name}: {RECOVERY_SWEEPS} sweeps {r['seconds']:.3f} s, "
            f"{r['launches']} launches (fixed fits {r['fixed_launches']}), "
            f"rows published by this rank per 4 exchanges {rows}, bytes "
            f"gathered per kept sweep "
            f"{out[name]['bytes_gathered_by_sweep']}, final auc "
            f"{hist[-1]['auc']:.6f}")
        model = r["result"].model
        arrays[f"{name}_fixed"] = model["fixed"].model.coefficients \
            .means.cpu().numpy()
        for coord in ("per_user", "per_item"):
            ids, proj, coef = entity_table(model, coord)
            arrays[f"{name}_{coord}_ids"] = ids
            arrays[f"{name}_{coord}_proj"] = proj
            arrays[f"{name}_{coord}_coef"] = coef
    st = out["stats"]
    say(f"rollback run: {st['rollbacks']} rollback(s), {st['recoveries']} "
        f"recovery(ies), {st['snapshots']} snapshots in "
        f"{st['snapshot_seconds']:.3f} s, recovery {st['recovery_seconds']:.3f}"
        f" s")
    if multiply_prefix_sum.launches:
        raise RuntimeError(f"rank {rank}: multiply_prefix_sum launched "
                           f"{multiply_prefix_sum.launches} times on a path")
    np.savez(os.path.join(root, f"recovery{rank}.npz"), **arrays)
    dump(f"recovery{rank}.json", out)

    # (c) last: a watchdog abandons a collective, and the group with it
    os.environ["PHOTON_ML_TPU_BARRIER_TIMEOUT_S"] = str(WATCHDOG_T)
    fault_injection.install([fault_injection.Fault(
        site="cd.step", kind="delay", process=1, at=1,
        delay_s=WATCHDOG_T + 30)])
    entered = {}
    real_status = TorchTransport.allgather_status

    def timed_status(self, code, timeout):
        entered["t"] = time.monotonic()
        return real_status(self, code, timeout)

    TorchTransport.allgather_status = timed_status
    rec_c = RecoveryManager(os.path.join(root, "recovery_c"),
                            max_rank_failures=1, backoff_s=0.05)
    leg = {"lines": []}
    lines.clear()
    try:
        run(rec_c)
        leg["outcome"] = "returned"
    except PeerFailure as e:
        leg.update(outcome=type(e).__name__,
                   detect_s=time.monotonic() - entered["t"],
                   failure_class=classify_failure(e),
                   recovery_supported=recovery_supported(),
                   failed=sorted(e.failed))
        say(f"watchdog leg: {type(e).__name__} {leg['detect_s']:.3f} s "
            f"after entering the barrier (T = {WATCHDOG_T:g} s), class "
            f"{leg['failure_class']}, escalated (recovery_supported "
            f"{leg['recovery_supported']})")
    leg["lines"] = lines
    dump(f"watchdog{rank}.json", leg)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def sticky_error_probe() -> int:
    """Phase 18 (d), in a process of its own: a non-sticky CUDA error (the
    kernel launched on an empty grid) leaves the card usable and is not a
    device loss; a device-side assert, provoked inside the GLM driver as
    its second lambda starts, is one: the driver exits 75 with the first
    lambda in its marker, a later CUDA call fails too, and the error
    matches the injected ``device_loss`` in type and message form. Prints
    one JSON line."""
    import os
    import re
    import shutil
    import tempfile

    from photon_ml_tpu_torch.ops import kernel_build, kernels
    from photon_ml_tpu_torch.parallel import fault_injection
    from photon_ml_tpu_torch.utils import is_device_loss

    form = re.compile(r"CUDA error: [^\n]+\nSearch for `cudaError\w+'")
    out = {}
    lib = kernel_build.load_library()
    d = torch.zeros(kernels.TILE, device="cuda")
    local = torch.empty(kernels.TILE, dtype=torch.float64, device="cuda")
    totals = torch.empty(1, dtype=torch.float64, device="cuda")
    err = lib.photon_mps_f32(None, d.data_ptr(), local.data_ptr(),
                             totals.data_ptr(), kernels.TILE, 0,
                             torch.cuda.current_stream().cuda_stream)
    soft = kernels.launch_error(lib, err, "multiply_prefix_sum on an empty "
                                          "grid")
    out["non_sticky"] = dict(code=int(err), type=type(soft).__name__,
                             message=str(soft).split("\n")[0],
                             device_loss=is_device_loss(soft))
    out["non_sticky"]["card_works_after"] = float(
        torch.ones(4, device="cuda").sum()) == 4.0

    fault_injection.install([fault_injection.Fault(site="probe",
                                                   kind="device_loss")])
    try:
        fault_injection.check("probe")
    except Exception as e:
        injected = e
    fault_injection.clear()

    # the real assert fires inside the GLM driver as its second lambda
    # starts, so the driver must write its marker without reading the card
    from photon_ml_tpu_torch.cli import glm_driver

    root = tempfile.mkdtemp(prefix="chip_smoke_sticky_")
    rng = np.random.default_rng(SEED)
    X = (rng.random((512, 16)) < 0.5) * rng.normal(size=(512, 16))
    y = rng.random(512) < 1 / (1 + np.exp(-X.sum(axis=1)))
    with open(os.path.join(root, "train.svm"), "w") as f:
        for xi, yi in zip(X, y):
            f.write(" ".join([str(2 * int(yi) - 1)] + [
                f"{j + 1}:{xi[j]:.6f}" for j in np.nonzero(xi)[0]]) + "\n")
    real_check, sites, caught = fault_injection.check, [], {}

    def sticky_check(site):
        if site == "glm.lambda":
            sites.append(site)
            if len(sites) == 2:
                try:
                    x = torch.zeros(16, device="cuda")
                    x[torch.tensor([1 << 20], device="cuda")].sum()
                    torch.cuda.synchronize()
                except Exception as e:
                    caught["real"] = e
                    raise
        real_check(site)

    fault_injection.check = sticky_check
    out_dir = os.path.join(root, "out")
    try:
        rc = glm_driver.main([
            "--train-data", os.path.join(root, "train.svm"),
            "--input-format", "libsvm", "--reg-weights", *RECOVERY_GRID,
            "--max-iters", "5", "--compute-variances",
            "--output-dir", out_dir])
    except Exception as e:
        rc = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    fault_injection.check = real_check
    marker = os.path.join(out_dir, "RESUME_GLM.npz")
    out["driver"] = dict(
        exit=rc, marker=os.path.exists(marker),
        marker_lambdas=(
            [float(e["lam"]) for e in np.load(marker, allow_pickle=True)[
                "payload"].item()["entries"]]
            if os.path.exists(marker) else None))
    shutil.rmtree(root, ignore_errors=True)
    real = caught.get("real")
    later = None
    try:
        torch.ones(4, device="cuda").sum().item()
        torch.cuda.synchronize()
    except Exception as e:
        later = e
    out["sticky"] = dict(
        type=type(real).__name__,
        message=str(real).split("\n")[0],
        device_loss=real is not None and is_device_loss(real),
        later_call_failed=later is not None,
        later_device_loss=later is not None and is_device_loss(later),
        injected_type=type(injected).__name__,
        same_type=type(real) is type(injected),
        same_form=bool(real is not None and form.match(str(real))
                       and form.match(str(injected))))
    print(json.dumps(out))
    sys.stdout.flush()
    os._exit(0)


def phase_recovery(game_ctx, dev, smi):
    """Phase 18 (a), (c) and (d): the ranks of ``recovery_rank`` and the
    ``sticky_error_probe`` process, started together; the gates of the
    module docstring. Returns the launches by leg and rank."""
    import os
    import tempfile

    from photon_ml_tpu_torch.parallel.recovery import RANK_LOSS

    with tempfile.TemporaryDirectory(prefix="chip_smoke_recovery_") as root:
        t0 = time.perf_counter()
        logs = [os.path.join(root, f"rank{r}.log") for r in range(MP_WORLD)]
        procs = []
        for r in range(MP_WORLD):
            with open(logs[r], "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, "--recovery-rank", str(r),
                     root], stdout=log, stderr=subprocess.STDOUT))
        probe = subprocess.Popen([sys.executable, __file__, "--sticky-error"],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
        # rank 0 ends after leg (c); rank 1 is still in its stall then
        deadline = time.monotonic() + RECOVERY_TIMEOUT_S + 60
        failed = None
        while procs[0].poll() is None and failed is None:
            if procs[1].poll() not in (None, 0):
                failed = 1
            if time.monotonic() > deadline:
                failed = "timeout"
            time.sleep(0.2)
        t_exit = time.perf_counter() - t0
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if failed is None and procs[0].returncode != 0:
            failed = 0
        try:
            probe_out, probe_err = probe.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            probe.kill()
            probe_out, probe_err = probe.communicate()
        missing = [name for name in (
            [f"recovery{r}.json" for r in range(MP_WORLD)]
            + [f"recovery{r}.npz" for r in range(MP_WORLD)]
            + ["watchdog0.json"])
            if not os.path.exists(os.path.join(root, name))]
        if failed is not None or missing:
            for r in range(MP_WORLD):
                with open(logs[r]) as f:
                    print(f"rank {r} output:\n{f.read()[-4000:]}")
            raise RuntimeError(f"phase 18: rank {failed} failed or results "
                               f"missing {missing}; exit codes "
                               f"{[p.returncode for p in procs]}")
        print(f"phase 18 (a, c): {MP_WORLD} ranks on one card over gloo, "
              f"{t_exit:.2f} s from spawn to rank 0's exit (rank 1 reaped "
              f"in its stall, exit code {procs[1].returncode})")
        res = []
        for r in range(MP_WORLD):
            with open(os.path.join(root, f"recovery{r}.json")) as f:
                res.append(json.load(f))
            for line in res[r]["lines"]:
                print(line)
        arrays = [dict(np.load(os.path.join(root, f"recovery{r}.npz")))
                  for r in range(MP_WORLD)]
        with open(os.path.join(root, "watchdog0.json")) as f:
            watchdog = json.load(f)
        for line in watchdog["lines"]:
            print(line)

    # (a) the rolled-back run against the uninterrupted one, on each rank
    for r, (out, arr) in enumerate(zip(res, arrays)):
        st, clean, rolled = out["stats"], out["uninterrupted"], \
            out["rollback"]
        if (st["rollbacks"], st["recoveries"]) != (1, 1):
            raise RuntimeError(f"phase 18 rank {r}: {st}")
        unequal = [k for k in arr if k.startswith("uninterrupted_")
                   and not np.array_equal(
                       arr[k], arr[k.replace("uninterrupted_", "rollback_")])]
        if unequal or rolled["auc"] != clean["auc"]:
            raise RuntimeError(f"phase 18 rank {r}: the rolled-back run "
                               f"differs from the uninterrupted one in "
                               f"{unequal or 'its auc history'}")
        fits = clean["fixed_launches"]
        extra = rolled["launches"] - clean["launches"]
        if (min(fits) < 1 or clean["launches"] < 1
                or extra != fits[1]
                or rolled["fixed_launches"] != fits[:2] + fits[1:]):
            raise RuntimeError(
                f"phase 18 rank {r}: launches {clean['launches']} "
                f"({fits}) uninterrupted, {rolled['launches']} "
                f"({rolled['fixed_launches']}) rolled back")
    for key in arrays[0]:
        if not np.array_equal(arrays[0][key], arrays[1][key]):
            raise RuntimeError(f"phase 18: the ranks differ in {key}")
    print(f"  rolled back and uninterrupted runs equal bit for bit on each "
          f"rank (coefficients of all three coordinates and the auc "
          f"history), the ranks equal; the rollback cost "
          f"{res[0]['rollback']['launches'] - res[0]['uninterrupted']['launches']}"
          f" launches, sweep 1's fixed fit")
    # the uninterrupted sharded run against phase 12's one-rank run: each
    # rank buckets only its own entities, so a bucket's padded widths, and
    # with them the float32 reduction lengths of its solves, differ from
    # the one-rank layout's (ROADMAP Queue 3)
    ref = game_ctx["result"]
    got_all = [arrays[0]["uninterrupted_fixed"]]
    want_all = [ref.model["fixed"].model.coefficients.means.cpu().numpy()]
    for coord in ("per_user", "per_item"):
        ids, proj, coef = entity_table(ref.model, coord)
        mine = [arrays[0][f"uninterrupted_{coord}_{k}"]
                for k in ("ids", "proj", "coef")]
        width = max(proj.shape[1], mine[1].shape[1])
        if not (np.array_equal(ids, mine[0]) and np.array_equal(
                np.pad(proj, ((0, 0), (0, width - proj.shape[1])),
                       constant_values=-1),
                np.pad(mine[1], ((0, 0), (0, width - mine[1].shape[1])),
                       constant_values=-1))):
            raise RuntimeError(f"phase 18: {coord}'s entities or supports "
                               "differ from phase 12's")
        want_all.append(np.pad(coef, ((0, 0), (0, width - coef.shape[1]))))
        got_all.append(np.pad(mine[2],
                              ((0, 0), (0, width - mine[2].shape[1]))))
    got_all = np.concatenate([a.ravel() for a in got_all]).astype(np.float64)
    want_all = np.concatenate([a.ravel() for a in want_all]).astype(
        np.float64)
    worst = float(np.abs(got_all - want_all).max())
    rel = float(np.linalg.norm(got_all - want_all) / np.linalg.norm(want_all))
    auc, auc_ref = res[0]["uninterrupted"]["auc"][-1], \
        ref.history[-1]["auc"]
    print(f"  uninterrupted sharded run vs phase 12's one-rank run: "
          f"coefficients rel L2 {rel:.3e} (tol {TOL_FIT}), max |diff| "
          f"{worst:.3e}; final device auc {auc:.6f} vs {auc_ref:.6f} (tol "
          f"{TOL_GAME_STREAM_AUC}), on {smi}")
    if not (rel <= TOL_FIT and abs(auc - auc_ref) <= TOL_GAME_STREAM_AUC):
        raise RuntimeError("phase 18: the entity-sharded run differs from "
                           "the one-rank run")

    # (c) the watchdog
    if not (watchdog.get("outcome") == "WatchdogTimeout"
            and watchdog["failure_class"] == RANK_LOSS
            and watchdog["recovery_supported"] is False
            and watchdog["detect_s"] <= WATCHDOG_T + WATCHDOG_SLACK_S):
        raise RuntimeError(f"phase 18 watchdog leg: {watchdog}")
    print(f"  (c) rank 0: WatchdogTimeout {watchdog['detect_s']:.3f} s after "
          f"entering its barrier (T = {WATCHDOG_T:g} s, gate T + "
          f"{WATCHDOG_SLACK_S:g} s), rank_loss, escalated on {smi}")

    # (d) the sticky error
    try:
        probe_res = json.loads(probe_out.decode().strip().splitlines()[-1])
    except (IndexError, ValueError):
        raise RuntimeError(f"phase 18 (d): no result, exit code "
                           f"{probe.returncode}:\n"
                           f"{probe_err.decode()[-3000:]}") from None
    soft, hard, drv = probe_res["non_sticky"], probe_res["sticky"], \
        probe_res["driver"]
    print(f"  (d) non-sticky: {soft['type']} '{soft['message']}' (code "
          f"{soft['code']}): is_device_loss {soft['device_loss']}, the card "
          f"works after it {soft['card_works_after']}; sticky: "
          f"{hard['type']} '{hard['message']}': is_device_loss "
          f"{hard['device_loss']}, a later CUDA call fails "
          f"{hard['later_call_failed']} (a device loss too: "
          f"{hard['later_device_loss']}), injected {hard['injected_type']} of"
          f" the same type {hard['same_type']} and form {hard['same_form']};"
          f" the GLM driver, asserted at its second lambda: exit "
          f"{drv['exit']}, marker {drv['marker']} holding lambdas "
          f"{drv['marker_lambdas']}")
    if not (soft["code"] != 0 and soft["type"] == "AcceleratorError"
            and not soft["device_loss"] and soft["card_works_after"]
            and hard["device_loss"] and hard["later_call_failed"]
            and hard["same_type"] and hard["same_form"]
            and drv["exit"] == 75 and drv["marker"]
            and drv["marker_lambdas"] == [float(RECOVERY_GRID[0])]):
        raise RuntimeError(f"phase 18 (d): {probe_res}")
    return {f"rank{r}": {k: out[k]["launches"]
                         for k in ("uninterrupted", "rollback")}
            for r, out in enumerate(res)}


def phase_recovery_driver(train_dir, val_dir, root, dev, smi):
    """Phase 18 (b), inside phase 9's directory: the GLM driver at
    ``--num-processes 1`` over RECOVERY_GRID, uninterrupted; killed in a
    child process at its second lambda by ``PHOTON_ML_TPU_FAULTS`` (exit
    75, the marker left); resumed with ``--auto-resume`` (exit 0, the
    marker consumed, ITERS + 1 launches); the resumed models
    byte-identical to the uninterrupted run's. Returns the launches."""
    import filecmp
    import os

    import photon_ml_tpu_torch
    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.ops.kernels import csc_column_sums

    def argv(out):
        return ["--train-data", train_dir, "--validation-data", val_dir,
                "--input-format", "avro", "--hash-dim", str(DRIVER_HASH_DIM),
                "--reg-weights", *RECOVERY_GRID, "--optimizer", "lbfgs",
                "--max-iters", str(ITERS), "--tolerance", "0",
                "--evaluators", "auc", "--device", str(dev),
                "--num-processes", "1", "--process-id", "0",
                "--coordinator-address", f"127.0.0.1:{_free_port()}",
                "--output-dir", out]

    def counted(args):
        torch.cuda.synchronize()
        csc_column_sums.launches = 0
        t0 = time.perf_counter()
        rc = glm_driver.main(args)
        torch.cuda.synchronize()
        return rc, csc_column_sums.launches, time.perf_counter() - t0

    clean, killed = (os.path.join(root, f"out_recovery_{n}")
                     for n in ("clean", "killed"))
    repo = os.path.dirname(os.path.dirname(
        os.path.abspath(photon_ml_tpu_torch.__file__)))
    env = dict(os.environ, PHOTON_ML_TPU_FAULTS=json.dumps(
        [{"site": "glm.lambda", "kind": "device_loss", "at": 1}]),
        PYTHONPATH=os.pathsep.join(
            [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    # the child to be killed starts first and runs beside the
    # uninterrupted run (its own process, its own output directory)
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.glm_driver",
         *argv(killed)], env=env, cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    rc, launches_clean, t_clean = counted(argv(clean))
    try:
        _, child_err = child.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        child.kill()
        _, child_err = child.communicate()
    t_killed = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"phase 18 (b): the uninterrupted run exited {rc}")
    marker = os.path.join(killed, "RESUME_GLM.npz")
    left = os.path.exists(marker)
    rc, launches_resumed, t_resumed = counted(argv(killed) + ["--auto-resume"])
    consumed = not os.path.exists(marker)
    sub = os.path.join("fixed-effect", "global")
    same = []
    for model in ("best", *(os.path.join("all", f"lambda-{float(g):g}")
                           for g in RECOVERY_GRID)):
        a, b = (os.path.join(d, model, sub) for d in (clean, killed))
        names = sorted(os.listdir(a))
        match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
        same.append(match == names and not mismatch and not errors)
    print(f"phase 18 (b): glm_driver --num-processes 1 over lambdas "
          f"{list(RECOVERY_GRID)}: uninterrupted {t_clean:.3f} s, "
          f"{launches_clean} launches; killed child beside it "
          f"(PHOTON_ML_TPU_FAULTS, device loss at the second lambda) exit "
          f"{child.returncode} after {t_killed:.3f} s, marker left {left}; --auto-resume exit {rc} "
          f"in {t_resumed:.3f} s, {launches_resumed} launches, marker "
          f"consumed {consumed}; the models equal byte for byte: {same}, "
          f"on {smi}")
    if not (child.returncode == 75 and left and rc == 0 and consumed
            and all(same) and launches_clean == 2 * (ITERS + 1)
            and launches_resumed == ITERS + 1):
        raise RuntimeError(f"phase 18 (b) failed; the child's stderr:\n"
                           f"{child_err[-3000:]}")
    return {"uninterrupted": launches_clean, "resumed": launches_resumed}


PAGED_PAGES, PAGED_PAGE_ROWS = 16, 256  # 4,096 resident entities
PAGED_BATCHES = (32, 4096)
TOL_PAGED_SCORE = 1e-5  # max |paged - score_random_effect| per row
PAGED_EPS_GATE = 4  # |kernel - plain| <= 4 eps sum_j |terms_j| per row
MAX_WAVES = 8  # a batch's rounds of install and score (phase 19 (b))
SYNC_WARNING = "synchronizing CUDA operation"  # torch's sync debug text


def _spans(trace_dir):
    """The complete spans of ``trace_dir``'s rank-0 trace file, which must
    pass the port's ``trace_cli validate``."""
    import os

    from photon_ml_tpu_torch.obs import trace_cli

    path = os.path.join(trace_dir, "trace-rank0.json")
    if trace_cli.main(["validate", path]) != 0:
        raise RuntimeError(f"{path} does not validate")
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]


def _metric_delta(before, after, name):
    return {k: v - before.get(name, {}).get(k, 0.0)
            for k, v in after.get(name, {}).items()}


def counted_syncs(fn):
    """Runs ``fn()`` under torch's sync debug mode "warn", in which every
    call that makes the host wait for the card (a device-to-host read, a
    blocking copy, a stream synchronize) warns once, and returns (what
    ``fn`` returned, the number of those calls). The optimizers' own
    ``host_syncs`` counters cannot see a read that a span might add; this
    count can."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(SYNC_WARNING in str(w.message) for w in caught)


def _lambda_costs(out):
    """Each lambda's (kernel launches, host reads) from the driver's log."""
    import os

    with open(os.path.join(out, "photon.log.jsonl")) as f:
        return [(e["kernel_launches"], e["host_reads"])
                for e in map(json.loads, f) if e["event"] == "lambda_trained"]


def _same_model_files(a_root, b_root, subs, what):
    import filecmp
    import os

    for sub in subs:
        a, b = (os.path.join(d, sub, "fixed-effect", "global")
                for d in (a_root, b_root))
        names = sorted(os.listdir(a))
        _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
        if mismatch or errors:
            raise RuntimeError(f"the traced run's {sub} differs from "
                               f"{what}: {mismatch + errors}")


def phase_trace_driver(root, train_dir, val_dir, dev, smi):
    """Phase 19 (a), inside phase 9's directory: phase 9's GLM driver run
    twice more with ``--path-screen strong`` (an L2 grid: every lambda a
    warm-started full-width solve through ``PathSolver``) and
    ``--profile-dir``, first untraced, then with ``--trace-dir``: the two
    runs differ in the span tracer alone. Gates: the trace file
    validates; one ``glm.path_lambda`` span per lambda, as many as the
    training metrics' lambdas; the profile names the ``csc_column_sums``
    kernel; the traced run's launches, each lambda's launches and host
    reads as the driver logs them (``PathSolver.kernel_launches`` and
    ``host_reads``), and its synchronizing CUDA calls (``counted_syncs``)
    equal the untraced run's; the launches equal phase 9's; the model
    files equal both runs' byte for byte. Returns (launches, seconds)."""
    import os

    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.obs.metrics import training_metrics
    from photon_ml_tpu_torch.ops.kernels import csc_column_sums

    runs = {}
    for traced in (False, True):
        tag = "traced" if traced else "untraced"
        argv = list(DRIVER_RUN["argv"])
        at = argv.index("--output-dir")
        out, pdir = (os.path.join(root, f"{name}_{tag}")
                     for name in ("out", "profile"))
        argv[at + 1] = out
        argv += ["--path-screen", "strong", "--profile-dir", pdir]
        if traced:
            argv += ["--trace-dir", os.path.join(root, "trace")]
        before = training_metrics().snapshot()

        def run(argv=argv):
            torch.cuda.synchronize()
            csc_column_sums.launches = 0
            t0 = time.perf_counter()
            rc = glm_driver.main(argv)
            torch.cuda.synchronize()
            return rc, time.perf_counter() - t0, csc_column_sums.launches

        (rc, seconds, launches), syncs = counted_syncs(run)
        if rc != 0:
            raise RuntimeError(f"{tag} glm_driver exited with {rc}")
        (prof,) = [os.path.join(pdir, f) for f in os.listdir(pdir)]
        with open(prof) as f:
            kernels_seen = sorted({e.get("name", "") for e in json.load(f)[
                "traceEvents"] if e.get("cat") == "kernel"})
        runs[tag] = dict(
            out=out, seconds=seconds, launches=launches, syncs=syncs,
            costs=_lambda_costs(out), profile_bytes=os.path.getsize(prof),
            named=[k for k in kernels_seen if "column_sums_kernel" in k],
            lambdas=_metric_delta(
                before, training_metrics().snapshot(),
                "photon_train_path_lambdas_total").get("", 0.0))
    off, on = runs["untraced"], runs["traced"]
    spans = _spans(os.path.join(root, "trace"))
    path_spans = [e for e in spans if e["name"] == "glm.path_lambda"]
    for tag, r in runs.items():
        print(f"phase 19 (a) glm_driver --path-screen strong --profile-dir, "
              f"{tag}: {r['seconds']:.3f} s, {r['launches']} launches, "
              f"{r['syncs']} synchronizing CUDA calls, per lambda (launches, "
              f"host reads) {r['costs']}; training metrics {r['lambdas']:g} "
              f"lambdas; profile {r['profile_bytes']} bytes, the "
              f"transpose's kernel: {r['named']}; on {smi}")
    print(f"  phase 9's run (unscreened, untraced, unprofiled): "
          f"{DRIVER_RUN['seconds']:.3f} s, {DRIVER_RUN['launches']} "
          f"launches; the traced run's {len(spans)} spans, "
          f"{len(path_spans)} glm.path_lambda")
    if len(path_spans) != len(DRIVER_GRID) or on["lambdas"] != len(
            path_spans) or off["lambdas"] != len(path_spans):
        raise RuntimeError(f"{len(path_spans)} glm.path_lambda spans, "
                           f"{on['lambdas']} lambdas in the metrics, for a "
                           f"grid of {len(DRIVER_GRID)}")
    if [e["args"]["lam"] for e in path_spans] != \
            [float(g) for g in DRIVER_GRID]:
        raise RuntimeError("the spans' lambdas are not the grid's")
    if not (off["named"] and on["named"]):
        raise RuntimeError("a profile names no csc_column_sums kernel")
    if not (on["launches"] == off["launches"] == DRIVER_RUN["launches"]
            and on["costs"] == off["costs"] and on["syncs"] == off["syncs"]
            and on["syncs"] > 0):
        raise RuntimeError("tracing changed the launches, the host reads "
                           "or the synchronizing calls")
    subs = ["best"] + [os.path.join("all", f"lambda-{float(g):g}")
                       for g in DRIVER_GRID]
    _same_model_files(off["out"], on["out"], subs, "the untraced run's")
    _same_model_files(DRIVER_RUN["out"], on["out"], subs, "phase 9's")
    print(f"  model files ({', '.join(subs)}) equal the untraced run's and "
          "phase 9's byte for byte")
    return on["launches"], on["seconds"]


def phase_trace_game(ctx, dev, smi):
    """Phase 19 (a): phase 12's GAME fit twice more (its data,
    coordinates, bucket cache and sweeps), untraced and under the span
    tracer. Gates: the trace file validates; one ``cd.coordinate`` span
    per coordinate per sweep, as many as the training metrics' steps; the
    traced fit's launches, random-effect host reads
    (``re_solver_host_reads``) and synchronizing CUDA calls
    (``counted_syncs``) equal the untraced fit's; the launches equal phase
    12's; every coefficient and the validation AUCs equal both fits' bit
    for bit. Returns the launches."""
    import os
    import tempfile

    from photon_ml_tpu_torch.estimators import GameEstimator
    from photon_ml_tpu_torch.game.random_effect import re_solver_host_reads
    from photon_ml_tpu_torch.obs import trace
    from photon_ml_tpu_torch.obs.metrics import training_metrics
    from photon_ml_tpu_torch.ops.kernels import csc_column_sums

    configs = game_configs()

    def fit():
        torch.cuda.synchronize()
        csc_column_sums.launches = 0
        re_reads = re_solver_host_reads()
        t0 = time.perf_counter()
        result = GameEstimator(
            task="logistic", n_iterations=GAME_SWEEPS, evaluators=["auc"],
            device=dev).fit(ctx["train"], ctx["val"], [configs],
                            dataset_cache=ctx["cache"])[0]
        torch.cuda.synchronize()
        return dict(result=result, seconds=time.perf_counter() - t0,
                    launches=csc_column_sums.launches,
                    re_reads=re_solver_host_reads() - re_reads)

    off, syncs = counted_syncs(fit)
    off["syncs"] = syncs
    before = training_metrics().snapshot()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tdir:
        trace.start(tdir)
        try:
            on, syncs = counted_syncs(fit)
            on["syncs"] = syncs
        finally:
            trace.stop()
        spans = _spans(tdir)
    steps = _metric_delta(before, training_metrics().snapshot(),
                          "photon_train_sweep_steps_total")
    cd = [(e["args"]["iteration"], e["args"]["coordinate"])
          for e in spans if e["name"] == "cd.coordinate"]
    want = [(it, c.name) for it in range(GAME_SWEEPS) for c in configs]
    for tag, r in (("untraced", off), ("traced", on)):
        print(f"phase 19 (a) GAME fit, {tag}: {r['seconds']:.3f} s, "
              f"{r['launches']} launches, random-effect host reads "
              f"{r['re_reads']}, {r['syncs']} synchronizing CUDA calls; on "
              f"{smi}")
    print(f"  phase 12's fit {ctx['seconds']:.3f} s, {ctx['launches']} "
          f"launches; the traced fit's {len(spans)} spans, {len(cd)} "
          f"cd.coordinate, training metrics steps {steps}")
    if cd != want or sum(steps.values()) != len(cd):
        raise RuntimeError(f"cd.coordinate spans {cd}, metrics {steps}")
    if not (on["launches"] == off["launches"] == ctx["launches"]
            and on["re_reads"] == off["re_reads"]
            and on["syncs"] == off["syncs"] and on["syncs"] > 0):
        raise RuntimeError("tracing changed the launches, the host reads "
                           "or the synchronizing calls")
    for ref in (off["result"], ctx["result"]):
        result = on["result"]
        if [r["auc"] for r in result.history] != \
                [r["auc"] for r in ref.history]:
            raise RuntimeError("the traced fit's validation AUCs differ")
        if not torch.equal(result.model["fixed"].model.coefficients.means,
                           ref.model["fixed"].model.coefficients.means):
            raise RuntimeError("the traced fit's fixed coefficients differ")
        for name in ("per_user", "per_item"):
            for a, b in zip(result.model[name].buckets,
                            ref.model[name].buckets):
                if not np.array_equal(np.asarray(a.coefficients),
                                      np.asarray(b.coefficients)):
                    raise RuntimeError(f"the traced fit's {name} differs")
    print("  every coefficient and AUC equal the untraced fit's and phase "
          "12's bit for bit")
    return on["launches"]


def new_paged_stats():
    return {"waves": 0, "install_s": {False: [], True: []}}


def paged_scores(table, lru, ids, idx, val, stats):
    """Score one batch through the paged table as the serving tier does:
    look its entities up, fault the missing through the LRU, install them,
    and launch ``paged_gather_score`` on the snapshot. Rows whose entity
    this install evicted again go round once more. Adds the rounds and
    each install's seconds (split by whether it copied the table) to
    ``stats``; returns the scores."""
    from photon_ml_tpu_torch.ops.kernels import paged_gather_score

    out = torch.empty(len(ids), dtype=table.dtype, device=table.device)
    rows = np.arange(len(ids))
    for wave in range(MAX_WAVES):
        sub = [ids[i] for i in rows]
        _, _, missing = table.lookup(sub)
        if missing:
            t0 = time.perf_counter()
            copies = table.snapshot_copies
            table.install(lru.get_many(missing))
            torch.cuda.synchronize()
            stats["install_s"][table.snapshot_copies > copies].append(
                time.perf_counter() - t0)
        buf, slots, missing = table.lookup(sub)
        gone = set(missing)  # entities this install evicted again
        done = np.array([e not in gone for e in sub])
        sel = torch.from_numpy(rows[done]).to(table.device)
        out[sel] = paged_gather_score(
            buf, torch.from_numpy(slots[done]).to(table.device),
            idx.index_select(0, sel), val.index_select(0, sel))
        stats["waves"] += 1
        rows = rows[~done]
        if rows.size == 0:
            return out
    raise RuntimeError(f"a batch of {len(ids)} rows did not become "
                       f"resident in {MAX_WAVES} rounds")


def phase_paged(best, dev, smi, peaks):
    """Phase 19 (b) and (c), inside phase 13's directory: the per-user
    random coordinate of the saved ``best`` model through
    ``ModelDirCoefficientStore`` -> ``EntityCoefficientLRU`` (one pass for
    the validation users, which learns the store's ids) -> a
    ``PagedCoefficientTable`` of 16 pages of 256 rows on the card; phase
    12's validation rows (phase 13's validation files) scored in batches of
    32 and of 4,096. Gates: the scores within 1e-5 of
    ``score_random_effect`` on the same coefficients and rows; unknown
    users exactly 0; a snapshot taken before an evicting install scores
    bit-equal after it; one kernel launch per round of every batch. Then
    (c): the kernel bit for bit its ordered plain twin and within the gate
    of its plain version, at these shapes, the served rung (pointer entry)
    and all validation rows at once, in float32 and float64, timed beside
    its previous design, embedding_bag and an empty kernel (time_paged).
    Returns the kernel's line of the JSON summary."""
    from photon_ml_tpu_torch.game.scoring import score_game_model
    from photon_ml_tpu_torch.io.model_io import load_model_index_map
    from photon_ml_tpu_torch.models import (
        GameModel, RandomEffectBucket, RandomEffectModel,
    )
    from photon_ml_tpu_torch.ops.kernels import paged_gather_score
    from photon_ml_tpu_torch.serve import (
        EntityCoefficientLRU, ModelDirCoefficientStore,
        PagedCoefficientTable, ServingMetrics,
    )
    from photon_ml_tpu_torch.types import SparseFeatures

    t_phase = time.perf_counter()
    imap = load_model_index_map(best, "global")
    remap = np.array([imap.index_of(f"f{j}") for j in range(GAME_DIM)])
    if (remap < 0).any() or imap.intercept_index < 0:
        raise RuntimeError("the saved index map lacks features")
    idx_raw, users, _, _ = game_arrays(GAME_ROWS + GAME_VAL_ROWS, SEED)
    idx_np = np.concatenate(
        [remap[idx_raw[GAME_ROWS:]],
         np.full((GAME_VAL_ROWS, 1), imap.intercept_index)],
        axis=1).astype(np.int32)
    ids = [str(u) for u in users[GAME_ROWS:]]
    n, k = idx_np.shape
    store = ModelDirCoefficientStore(best, "per_user", imap)
    wanted = sorted(set(ids))
    lru = EntityCoefficientLRU(store.load, len(wanted),
                               metrics=ServingMetrics(),
                               batch_loader=store.load_many)
    t0 = time.perf_counter()
    entries = lru.warm_entries(wanted)
    t_load = time.perf_counter() - t0
    known = store.known_ids()  # learnt in that pass
    unknown = np.array([e not in known for e in ids])
    print(f"phase 19 (b): per_user of {best}: {len(wanted)} validation "
          f"users faulted into the LRU in one load_many pass, which also "
          f"learnt the store's {len(known)} ids ({t_load:.2f} s); {n} rows "
          f"of {k} features (39 and the intercept) over dim {imap.size}; "
          f"{unknown.mean():.4f} of the rows' users unknown to the model")

    # the reference: the same coefficients as a RandomEffectModel, scored
    # by game/scoring -> game/random_effect.score_random_effect
    present = [e for e in wanted if entries[e] is not None]
    width = max(entries[e].local_dim for e in present)
    coef = np.zeros((len(present), width), np.float32)
    proj = np.full((len(present), width), -1, np.int32)
    for r, e in enumerate(present):
        for g, s_ in entries[e].local_map.items():
            coef[r, s_] = entries[e].coefficients[s_]
            proj[r, s_] = g
    ref_model = GameModel({"per_user": RandomEffectModel(
        "per_user", [RandomEffectBucket(present, coef, proj)], "logistic",
        entity_column="user")}, task="logistic")
    t0 = time.perf_counter()
    ref = score_game_model(
        ref_model, {"global": SparseFeatures(torch.from_numpy(idx_np), None,
                                             imap.size)},
        {"user": np.array(ids)}, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    print(f"  score_random_effect reference: {time.perf_counter() - t0:.2f} "
          f"s")

    idx = torch.from_numpy(idx_np).to(dev)
    val = torch.ones(n, k, dtype=torch.float32, device=dev)
    by_batch = {}
    for b in PAGED_BATCHES:
        table = PagedCoefficientTable(
            imap.size, pages=PAGED_PAGES, page_rows=PAGED_PAGE_ROWS,
            dtype=torch.float32, name="per_user", metrics=ServingMetrics(),
            device=dev)
        table.warm_device_path()  # the build and a first launch
        stats = new_paged_stats()
        torch.cuda.synchronize()
        paged_gather_score.launches = 0
        t0 = time.perf_counter()
        got = torch.cat([paged_scores(table, lru, ids[s:s + b],
                                      idx[s:s + b], val[s:s + b], stats)
                         for s in range(0, n, b)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = paged_gather_score.launches
        diff = float((got - ref).abs().max())
        zeros = bool((got[torch.from_numpy(unknown).to(dev)] == 0).all())
        st = table.stats()
        ins = {c: (len(v), float(np.median(v)) * 1e3 if v else None)
               for c, v in stats["install_s"].items()}
        print(f"  B={b}: {-(-n // b)} batches, {launches} launches "
              f"({stats['waves']} rounds), {seconds:.3f} s, "
              f"{n / seconds:.1f} rows/s; max |paged - reference| "
              f"{diff:.3e} (tol {TOL_PAGED_SCORE}), unknown users 0: "
              f"{zeros}; table {st}, snapshot copies "
              f"{table.snapshot_copies}; installs without / with a copy: "
              f"{ins[False][0]} / {ins[True][0]}, median "
              f"{_ms(ins[False][1])} / {_ms(ins[True][1])} each "
              f"(synchronised); on {smi}")
        if launches != stats["waves"] or launches < -(-n // b):
            raise RuntimeError(f"{launches} launches for {stats['waves']} "
                               "rounds")
        if not (diff <= TOL_PAGED_SCORE and zeros and st["page_evictions"]):
            raise RuntimeError(f"paged scores at B={b}: max diff {diff}, "
                               f"unknown zero {zeros}, evictions "
                               f"{st['page_evictions']}")
        by_batch[b] = dict(launches=launches, rounds=stats["waves"],
                           seconds=seconds, max_abs_diff=diff,
                           page_evictions=st["page_evictions"],
                           snapshot_copies=table.snapshot_copies,
                           installs=st["installs"],
                           install_ms_median={str(c): m for c, (_, m)
                                              in ins.items()})

    # a snapshot taken before an evicting install scores bit-equal after
    snap_ids = ids[:PAGED_BATCHES[0]]
    paged_scores(table, lru, snap_ids, idx[:len(snap_ids)],
                 val[:len(snap_ids)], new_paged_stats())
    buf, slots, _ = table.lookup(snap_ids)
    slots_t = torch.from_numpy(slots).to(dev)
    sidx, sval = idx[:len(snap_ids)], val[:len(snap_ids)]
    before = paged_gather_score(buf, slots_t, sidx, sval)
    evictions = table.page_evictions
    fresh = [e for e in wanted if e not in set(table.resident_ids())
             and entries[e] is not None][:PAGED_PAGE_ROWS * 2]
    table.install({e: entries[e] for e in fresh})
    after = paged_gather_score(buf, slots_t, sidx, sval)
    if table.page_evictions == evictions or table.device_buffer is buf \
            or not torch.equal(before, after):
        raise RuntimeError("a snapshot changed under an evicting install")
    print(f"  a snapshot's {len(snap_ids)} scores equal bit for bit after an "
          f"install of {len(fresh)} entities that evicted "
          f"{table.page_evictions - evictions} pages")
    refresh_ms = cuda_ms(lambda: table.device_buffer.clone(), 5)
    print(f"  one copy of the table ({table.device_buffer.numel() * 4 / 1e9:.3f}"
          f" GB) on the device: {refresh_ms:.4f} ms; phase 19 (b) "
          f"{time.perf_counter() - t_phase:.1f} s so far")

    # (c) the kernel against its plain version, its ordered twin and its
    # previous design: at (b)'s batches, each batch's users made resident
    # first, as a scored batch finds them; at the served rung (the first 64
    # rows padded to 64 entries with index 0 and value 0, as the session
    # pads them) through the pointer entry; and at every validation row
    # with slots drawn uniformly over the table's rows (all resident)
    cases = []
    for b in PAGED_BATCHES:
        paged_scores(table, lru, ids[:b], idx[:b], val[:b],
                     new_paged_stats())
        buf, sl, _ = table.lookup(ids[:b])
        cases.append((f"b{b}", buf, torch.from_numpy(sl).to(dev), idx[:b],
                      val[:b], False))
    b = SERVE_MAX_BATCH
    paged_scores(table, lru, ids[:b], idx[:b], val[:b], new_paged_stats())
    buf, sl, _ = table.lookup(ids[:b])
    pad = SERVE_PAD_NNZ - k
    cases.append((f"at_b{b}_k{SERVE_PAD_NNZ}", buf,
                  torch.from_numpy(sl).to(dev),
                  torch.nn.functional.pad(idx[:b], (0, pad)),
                  torch.nn.functional.pad(val[:b], (0, pad)), True))
    rows = table.device_buffer.shape[0]
    every = np.random.default_rng(SEED).integers(0, rows, n)
    cases.append((f"b{n}", table.device_buffer,
                  torch.from_numpy(every.astype(np.int32)).to(dev), idx, val,
                  False))
    shapes, err = {}, 0.0
    for name, buf, sl, bi, bv, at in cases:
        for dtype in (torch.float32, torch.float64):
            t = time_paged(buf.to(dtype), sl, bi, bv.to(dtype), peaks, smi,
                           at=at)
            err = max(err, t["max_abs_err"])
            shapes[f"{str(dtype).split('.')[1]}_{name}"] = t
    main = shapes[f"float32_b{PAGED_BATCHES[-1]}"]
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s in phases 19 "
          "(b) and (c)")
    return {
        "name": "paged_gather_score",
        "route": "cuda",
        "source": "photon_ml_tpu_torch/ops/csrc/paged_gather_score.cu",
        "replaces": "photon_ml_tpu/ops/pallas_kernels.py:142",
        "launches": sum(v["launches"] for v in by_batch.values()),
        "launches_by_path": {f"paged_scoring_b{b}": v["launches"]
                             for b, v in by_batch.items()},
        "max_abs_err": err,
        "tol": f"{PAGED_EPS_GATE} eps * sum_j |table[slot, idx_j] * val_j| "
               "per row; bit-equal to paged_gather_score_ordered_plain",
        "ms": main["kernel_ms"],
        "device_ms": main["device_ms"],
        "previous_device_ms": main["previous_device_ms"],
        "floor_device_ms": main["floor_device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library": "torch.nn.functional.embedding_bag(slot * D + idx, "
                   "table.view(-1, 1), per_sample_weights=val, mode='sum')",
        "shapes": shapes,
        "paged_scoring": by_batch,
        "table_copy_ms": refresh_ms,
    }


def time_paged(table, slots, idx, val, peaks, smi, at=False):
    """paged_gather_score (its pointer entry if ``at``) on one batch, with
    its values and with random ones (a kernel that misread val would pass
    on ones alone): bit for bit its ordered plain twin, the other entry's
    bits, within PAGED_EPS_GATE eps of the row's sum of |terms| of its
    plain version and of its previous design, unknown rows 0, two calls
    bit-identical. Then, per call and on the device's own clock, the
    previous design's and its times in turns (previous, kernel, kernel,
    previous), the plain version's, embedding_bag's and an empty kernel's
    on the kernel's grid (the floor no launch beats), beside the bound for
    the same work."""
    from photon_ml_tpu_torch.ops.kernel_build import load_library
    from photon_ml_tpu_torch.ops.kernels import (
        launch_error, paged_gather_score, paged_gather_score_at,
        paged_gather_score_ordered_plain, paged_gather_score_plain,
        paged_gather_score_previous,
    )

    b, k = idx.shape
    launches = paged_gather_score.launches
    table_at = torch.tensor([table.data_ptr()], dtype=torch.int64,
                            device=table.device)

    def kernel(v=val):
        if at:
            return paged_gather_score_at(table_at, table, slots, idx, v)
        return paged_gather_score(table, slots, idx, v)

    def other(v):
        if at:
            return paged_gather_score(table, slots, idx, v)
        return paged_gather_score_at(table_at, table, slots, idx, v)

    def previous(v=val):
        return paged_gather_score_previous(table, slots, idx, v,
                                           table_at=table_at if at else None)

    lib = load_library()

    def empty():
        err = lib.photon_paged_empty(
            b, k, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise launch_error(lib, err, "empty kernel launch")

    flat = (slots.clamp(min=0).to(torch.int64)[:, None] * table.shape[1]
            + idx.to(torch.int64))
    column = table.view(-1, 1)
    gen = torch.Generator(device=table.device).manual_seed(SEED)
    err = 0.0
    for vals in (val, torch.randn(val.shape, generator=gen, dtype=val.dtype,
                                  device=val.device)):
        got = kernel(vals)
        torch.cuda.synchronize()
        twin = paged_gather_score_ordered_plain(table, slots, idx, vals)
        if not torch.equal(got, twin):
            raise RuntimeError(
                f"paged_gather_score{'_at' if at else ''} differs from its "
                f"ordered plain twin in {int((got != twin).sum())} of {b} "
                f"rows at B={b}, k={k}, {table.dtype}")
        want = paged_gather_score_plain(table, slots, idx, vals)
        terms = (column.view(-1)[flat].abs() * vals.abs()).sum(dim=1)
        gate = PAGED_EPS_GATE * torch.finfo(table.dtype).eps * terms
        diff = float((got - want).abs().max())
        err = max(err, diff)
        prev = previous(vals)
        if not (bool(((got - want).abs() <= gate).all())
                and bool(((prev - got).abs() <= gate).all())
                and bool((got[slots < 0] == 0).all())
                and torch.equal(got, kernel(vals))
                and torch.equal(got, other(vals))):
            raise RuntimeError(f"paged_gather_score differs from its plain "
                               f"version, its previous design or its other "
                               f"entry at B={b}, {table.dtype}: {diff:.3e}")

    def library():
        return torch.nn.functional.embedding_bag(
            flat, column, per_sample_weights=val, mode="sum")

    reps = 50
    turns = {"kernel": [], "previous": []}
    dev_turns = {"kernel": [], "previous": []}
    for name in ("previous", "kernel", "kernel", "previous"):
        fn = kernel if name == "kernel" else previous
        turns[name].append(cuda_ms(fn, reps))
        dev_turns[name].append(device_ms(fn, reps))
    plain_ms = cuda_ms(lambda: paged_gather_score_plain(table, slots, idx,
                                                        val), reps)
    library_ms = cuda_ms(library, reps)
    floor_ms = cuda_ms(empty, reps)
    dev_ms = {name: device_ms(fn, reps) for name, fn in (
        ("library", library), ("floor", empty))}
    # by name: comparisons, not a path
    checked = paged_gather_score.launches - launches
    paged_gather_score.launches = launches

    def mean(xs):
        return None if None in xs else sum(xs) / len(xs)

    # each input read once, each output written once: the slots, indices
    # and values, the table elements the resident rows gather (and the
    # pointer entry's address), the scores; beside it the same with each
    # gathered element a 32-byte sector of its own, what device memory
    # moves for a random column (repeated columns, such as the
    # intercept's, hit the L2 instead)
    elem = table.element_size()
    resident = int((slots >= 0).sum())
    stream_bytes = 4 * b + (4 + elem) * b * k + elem * b + (8 if at else 0)
    nbytes = stream_bytes + elem * resident * k
    sector_bytes = stream_bytes + 32 * resident * k
    ops = 2 * resident * k
    bw, f32_rate, f64_rate = peaks
    rate = f32_rate if table.dtype == torch.float32 else f64_rate
    bytes_ms, ops_ms = nbytes / bw * 1e3, ops / rate * 1e3
    bound = max(bytes_ms, ops_ms)
    floor_dev = dev_ms["floor"]
    t = {"b": b, "k": k, "dtype": str(table.dtype),
         "entry": "pointer" if at else "direct", "resident_rows": resident,
         "bytes": nbytes, "kernel_ms": mean(turns["kernel"]),
         "kernel_ms_runs": turns["kernel"],
         "previous_ms": mean(turns["previous"]),
         "previous_ms_runs": turns["previous"], "plain_ms": plain_ms,
         "library_ms": library_ms, "floor_ms": floor_ms,
         "device_ms": mean(dev_turns["kernel"]),
         "device_ms_runs": dev_turns["kernel"],
         "previous_device_ms": mean(dev_turns["previous"]),
         "previous_device_ms_runs": dev_turns["previous"],
         "library_device_ms": dev_ms["library"],
         "floor_device_ms": floor_dev,
         "bound_ms": bound,
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
         "sector_bytes": sector_bytes,
         "sector_bound_ms": sector_bytes / bw * 1e3,
         "limited_by": (None if floor_dev is None
                        else "floor" if floor_dev >= bound else "bound"),
         "max_abs_err": err, "checked_launches": checked}
    print(f"paged_gather_score{'_at' if at else ''} B={b} k={k} "
          f"{table.dtype} ({resident} rows resident): bit-equal to its "
          f"ordered plain twin and its other entry; max |kernel - plain| "
          f"{err:.3e} (gate {PAGED_EPS_GATE} eps sum |terms|); per call: "
          f"previous {turns['previous'][0]:.4f} / kernel "
          f"{turns['kernel'][0]:.4f} / kernel {turns['kernel'][1]:.4f} / "
          f"previous {turns['previous'][1]:.4f} ms, plain {plain_ms:.4f} "
          f"ms, embedding_bag {library_ms:.4f} ms, empty kernel "
          f"{floor_ms:.4f} ms; device time per call: previous "
          f"{_ms(dev_turns['previous'][0])} / kernel "
          f"{_ms(dev_turns['kernel'][0])} / kernel "
          f"{_ms(dev_turns['kernel'][1])} / previous "
          f"{_ms(dev_turns['previous'][1])}, embedding_bag "
          f"{_ms(dev_ms['library'])}, empty kernel {_ms(floor_dev)}; bound "
          f"{bound:.6f} ms ({nbytes / 1e6:.3f} MB by {t['bound_by']}; "
          f"{t['sector_bound_ms']:.6f} ms at a sector per gather), limited "
          f"by the {t['limited_by']} on {smi}")
    return t


# -- phase 20: the serving driver ------------------------------------------
SERVE_DRIVER = [sys.executable, "-m", "photon_ml_tpu_torch.cli.serving_driver"]
SERVE_MAX_BATCH, SERVE_CLIENTS = 64, 4
SERVE_PAD_NNZ = 64  # the session's padded entries per row (its pad_nnz)
SERVE_PAGES, SERVE_PAGE_ROWS = 16, 256  # per random coordinate, as phase 19
SERVE_LRU = 1 << 16  # LRU entries: every validation user and item stays
SERVE_PROBES = 32  # requests sent one at a time before and after the reload
SERVE_WAIT_S = 300  # start-up, the prefetch and the reload, each at most
TOL_SERVE = 1e-5  # |served - score_game_model| per row


def _metrics(base):
    """``GET /metrics`` as a dict of series -> value."""
    import urllib.request

    with urllib.request.urlopen(f"{base}/metrics", timeout=60) as resp:
        text = resp.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def _post(base, path, body, timeout=120):
    import urllib.request

    req = urllib.request.Request(
        f"{base}{path}", data=body if isinstance(body, bytes)
        else json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        status, data = resp.status, resp.read()
    return status, json.loads(data), time.perf_counter() - t0


def serve_requests(idx_np, users, items, seed):
    """Phase 12's validation rows as ``POST /score`` bodies of 1 to
    SERVE_MAX_BATCH rows (sizes drawn from ``seed``), each row's features
    by name (``f{j}``, value 1) with its user and item, per-coordinate
    scores asked for. Returns [(first row, rows, body bytes)]."""
    rng = np.random.default_rng(seed)
    out, lo, n = [], 0, idx_np.shape[0]
    while lo < n:
        size = min(int(rng.integers(1, SERVE_MAX_BATCH + 1)), n - lo)
        rows = [{"features": [{"name": f"f{j}", "value": 1.0}
                              for j in idx_np[i].tolist()],
                 "entityIds": {"user": str(users[i]), "item": str(items[i])}}
                for i in range(lo, lo + size)]
        out.append((lo, size, json.dumps(
            {"rows": rows, "perCoordinate": True}).encode()))
        lo += size
    return out


def phase_serve(best, ref, dev, smi, peaks):
    """Phase 20, inside phase 13's directory: the serving driver as a
    subprocess on the saved ``best`` model (d = 2^16 and the intercept,
    100,000 users, 10,000 items), both random coordinates on paged tables
    of SERVE_PAGES x SERVE_PAGE_ROWS, ``--max-batch`` 64, traced. One
    ``POST /admin/membership`` with ``prefetchEntityIds`` warms the
    validation users and items (one store pass per coordinate); phase
    12's 2^15 validation rows then go as ``POST /score`` requests of 1-64
    rows from SERVE_CLIENTS client threads. Gates: every request 200 and
    every score within TOL_SERVE of ``score_game_model`` (``ref``, the
    scoring driver's scores of the same rows); users the model does not
    know get the fixed-only margin (their per_user part exactly 0);
    ``/metrics`` shows one capture per rung after warmup and none after;
    no batch or row leaves the fused rungs (the session's eager, fallback
    and host-math overflow counters stay 0), so every batch is served by
    one or more replays, each launching the kernel once per random
    coordinate; an identical ``/admin/reload`` captures nothing and
    SERVE_PROBES requests sent one at a time score bit for bit as before
    it; SIGTERM drains and the driver exits 0. Then the pointer entry
    ``paged_gather_score_at`` against its plain version at the served
    shape (B = 64, k = 64), and the host math a row would get if it left
    the rungs, bit for bit against the kernel (the reason a batch whose
    install evicts its own entities is replayed again). Returns the
    phase's numbers."""
    import os
    import queue
    import re
    import signal
    import threading

    from photon_ml_tpu_torch.ops.kernels import (
        paged_gather_score, paged_gather_score_at,
        paged_gather_score_ordered_plain, paged_gather_score_plain,
    )
    from photon_ml_tpu_torch.serve.session import bucket_ladder, bucketize

    t_phase = time.perf_counter()
    root = os.path.dirname(best)
    idx_raw, users, items, _ = game_arrays(GAME_ROWS + GAME_VAL_ROWS, SEED)
    known = set(users[:GAME_ROWS].tolist())
    idx_np, users, items = (idx_raw[GAME_ROWS:], users[GAME_ROWS:],
                            items[GAME_ROWS:])
    n = idx_np.shape[0]
    unknown = np.array([u not in known for u in users.tolist()])
    ladder = bucket_ladder(SERVE_MAX_BATCH)
    log_dir, trace_dir = (os.path.join(root, "serve_log"),
                          os.path.join(root, "serve_trace"))
    cmd = SERVE_DRIVER + [
        "--model-dir", best, "--port", "0", "--device", str(dev),
        "--max-batch", str(SERVE_MAX_BATCH),
        "--re-dense-dim-max", str(GAME_DIM + 1),
        "--re-pages", str(SERVE_PAGES), "--re-page-rows",
        str(SERVE_PAGE_ROWS), "--coeff-cache-entries", str(SERVE_LRU),
        "--log-dir", log_dir, "--trace-dir", trace_dir]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    lines: "queue.Queue[str]" = queue.Queue()
    output = []

    def pump():
        for line in proc.stdout:
            output.append(line)
            lines.put(line)

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        port, deadline = None, time.monotonic() + SERVE_WAIT_S
        while port is None:
            if proc.poll() is not None and lines.empty():
                raise RuntimeError(f"the serving driver exited "
                                   f"{proc.returncode}:\n{''.join(output)}")
            try:
                line = lines.get(timeout=max(0.1, deadline -
                                             time.monotonic()))
            except queue.Empty:
                raise RuntimeError("the serving driver did not get ready "
                                   f"in {SERVE_WAIT_S} s") from None
            m = re.search(r"^serving .* on http://[\d.]+:(\d+) ", line)
            port = int(m.group(1)) if m else None
        t_ready = time.perf_counter() - t0
        base = f"http://127.0.0.1:{port}"
        bodies = serve_requests(idx_np, users, items, SEED)
        warm = _metrics(base)
        miss, hit = ("photon_serve_compile_cache_misses_total",
                     "photon_serve_compile_cache_hits_total")
        launches_key = ('photon_serve_kernel_launches_total'
                        '{kernel="paged_gather_score"}')
        # batches and rows that left the fused rungs: all must stay 0
        off_rungs = ("photon_serve_fixed_eager_batches_total",
                     "photon_serve_fused_fallback_batches_total",
                     "photon_serve_overflow_rows_total")
        print(f"phase 20: serving_driver ready in {t_ready:.2f} s "
              f"(model load and {int(warm[miss])} captures, one per rung of "
              f"{ladder}); {len(bodies)} requests of 1-{SERVE_MAX_BATCH} "
              f"rows built; on {smi}")
        if warm[miss] != len(ladder):
            raise RuntimeError(f"{warm[miss]} captures after warmup, not "
                               f"{len(ladder)}")
        ids = sorted(set(users.astype(str).tolist())
                     | set(items.astype(str).tolist()))
        status, body, t_pref = _post(base, "/admin/membership", {
            "epoch": 1, "numShards": 1, "shardIndex": 0,
            "prefetchEntityIds": ids}, timeout=SERVE_WAIT_S)
        print(f"  /admin/membership prefetch of {len(ids)} ids (validation "
              f"users and items): {t_pref:.2f} s, {body.get('prefetched')} "
              f"entities, {body.get('prefetchBytes', 0) / 1e6:.1f} MB")
        if status != 200 or not body["applied"] or not body.get("prefetched"):
            raise RuntimeError(f"membership prefetch: {status} {body}")

        # the scoring window: SERVE_CLIENTS threads over the requests
        work: "queue.Queue" = queue.Queue()
        for item in bodies:
            work.put(item)
        got = np.full(n, np.nan)
        user_part = np.full(n, np.nan)
        latencies, errors = [], []

        def client():
            while True:
                try:
                    lo, size, data = work.get_nowait()
                except queue.Empty:
                    return
                try:
                    status, out, sec = _post(base, "/score", data)
                except Exception as e:  # reported below, fails the phase
                    errors.append(repr(e))
                    continue
                if status != 200 or len(out["scores"]) != size:
                    errors.append(f"{status} {str(out)[:200]}")
                    continue
                got[lo:lo + size] = out["scores"]
                user_part[lo:lo + size] = out["scoreComponents"]["per_user"]
                latencies.append(sec)

        before = _metrics(base)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client)
                   for _ in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SERVE_WAIT_S)
        seconds = time.perf_counter() - t0
        after = _metrics(base)
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"{len(errors)} requests failed: {errors[:3]}")
        diff = float(np.abs(got - ref).max())
        zeros = bool((user_part[unknown] == 0).all())
        replays = after[hit] - before[hit]
        batches = (after["photon_serve_batches_total"]
                   - before["photon_serve_batches_total"])
        launches = after[launches_key] - before[launches_key]
        lat = np.array(latencies) * 1e3
        rows_s = n / seconds
        print(f"  {n} rows in {len(bodies)} requests from {SERVE_CLIENTS} "
              f"clients: {seconds:.3f} s, {rows_s:.1f} rows/s; request "
              f"latency p50 {np.percentile(lat, 50):.3f} ms, p99 "
              f"{np.percentile(lat, 99):.3f} ms; {int(batches)} batches, "
              f"{int(replays)} replays ({int(replays - batches)} of them "
              f"rounds after a batch's first), {int(launches)} "
              f"paged_gather_score launches "
              f"({launches / max(batches, 1):.3f} per batch); "
              + ", ".join(f"{k[len('photon_serve_'):]} {int(after[k])}"
                          for k in off_rungs) + "; max "
              f"|served - score_game_model| {diff:.3e} (tol {TOL_SERVE}); "
              f"{unknown.mean():.4f} of the rows' users unknown, their "
              f"per_user part 0: {zeros}; on {smi}")
        if not (np.isfinite(got).all() and diff <= TOL_SERVE and zeros):
            raise RuntimeError(f"served scores: max diff {diff}, unknown "
                               f"users' part 0: {zeros}")
        if after[miss] != len(ladder):
            raise RuntimeError(f"{after[miss] - len(ladder)} captures after "
                               "warmup")
        # with nothing off the rungs, every hit is a fused replay and
        # every row a replay's output; a replay's launches are those its
        # capture recorded (the card tests hold them to the profiler's)
        if any(after[k] for k in off_rungs) or not (
                launches == 2 * replays and replays >= batches > 0):
            raise RuntimeError(
                f"{launches} launches for {replays} replays of {batches} "
                f"batches; off the rungs: {[after[k] for k in off_rungs]}")

        # an identical reload: nothing captured, probes bit-equal
        probes = bodies[:SERVE_PROBES]

        def probe():
            return [_post(base, "/score", data)[1]["scores"]
                    for _, _, data in probes]

        first = probe()
        status, body, t_reload = _post(base, "/admin/reload", {
            "modelDir": best, "force": True}, timeout=SERVE_WAIT_S)
        if status != 200 or not body["swapped"]:
            raise RuntimeError(f"reload: {status} {body}")
        again = probe()
        final = _metrics(base)
        print(f"  identical /admin/reload: {t_reload:.2f} s; {SERVE_PROBES} "
              f"requests one at a time before and after it equal bit for "
              f"bit: {again == first}; captures "
              f"{int(final[miss])}, swaps {int(final['photon_serve_swaps_total'])}")
        if (again != first or final[miss] != len(ladder)
                or any(final[k] for k in off_rungs)):
            raise RuntimeError("the identical reload changed a score, "
                               "captured a rung or left the rungs")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=SERVE_WAIT_S)
        if rc != 0:
            raise RuntimeError(f"the serving driver exited {rc} after "
                               f"SIGTERM:\n{''.join(output[-20:])}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        reader.join(60)
    with open(os.path.join(log_dir, "photon.log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    done = log[-1]
    if done["event"] != "driver_done" or "draining" not in \
            [e["event"] for e in log]:
        raise RuntimeError(f"the driver's log ends with {done['event']}")

    # per-batch time at the rungs served: the session's copy, replay and
    # read-back (``session.device_compute``) and the whole batch
    # (``batch.execute``), from the driver's trace
    per_rung, per_batch = {}, {}
    for e in _spans(trace_dir):
        if e["name"] == "session.device_compute":
            per_rung.setdefault(e["args"]["bucket"], []).append(e["dur"])
        elif e["name"] == "batch.execute":
            per_batch.setdefault(bucketize(e["args"]["rows"], ladder),
                                 []).append(e["dur"])
    rungs = {b: {"replays": len(v), "p50_ms": float(np.median(v)) / 1e3,
                 "p99_ms": float(np.percentile(v, 99)) / 1e3,
                 "batches": len(per_batch.get(b, ())),
                 "batch_p50_ms": float(np.median(per_batch[b])) / 1e3
                 if b in per_batch else None}
             for b, v in sorted(per_rung.items())}
    for b, r in rungs.items():
        print(f"  rung B={b}: {r['replays']} replays, copy + replay + "
              f"read-back p50 {r['p50_ms']:.4f} ms, p99 {r['p99_ms']:.4f} "
              f"ms; {r['batches']} whole batches (resolve, faults, "
              f"installs, replays) p50 {_ms(r['batch_p50_ms'])}")

    # the pointer entry against its plain version at the served shape
    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.randn(SERVE_PAGES * SERVE_PAGE_ROWS, GAME_DIM + 1,
                        generator=gen, device=dev)
    b, k = SERVE_MAX_BATCH, SERVE_MAX_BATCH
    slots = torch.randint(-1, table.shape[0], (b,), generator=gen,
                          device=dev, dtype=torch.int32)
    idx = torch.randint(0, table.shape[1], (b, k), generator=gen,
                        device=dev, dtype=torch.int32)
    val = torch.randn(b, k, generator=gen, device=dev)
    table_at = torch.tensor([table.data_ptr()], dtype=torch.int64,
                            device=dev)
    count = paged_gather_score.launches
    at = paged_gather_score_at(table_at, table, slots, idx, val)
    want = paged_gather_score_plain(table, slots, idx, val)
    terms = paged_gather_score_plain(table.abs(), slots, idx, val.abs())
    gate = PAGED_EPS_GATE * torch.finfo(table.dtype).eps * terms
    err = float((at - want).abs().max())
    if not (bool(((at - want).abs() <= gate).all())
            and torch.equal(at, paged_gather_score(table, slots, idx, val))
            and torch.equal(at, paged_gather_score_ordered_plain(
                table, slots, idx, val))):
        raise RuntimeError(f"paged_gather_score_at differs: {err:.3e}")
    reps = 50
    at_ms = cuda_ms(lambda: paged_gather_score_at(table_at, table, slots,
                                                  idx, val), reps)
    plain_ms = cuda_ms(lambda: paged_gather_score_plain(table, slots, idx,
                                                        val), reps)
    flat = (slots.clamp(min=0).to(torch.int64)[:, None] * table.shape[1]
            + idx.to(torch.int64))
    library_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        flat, table.view(-1, 1), per_sample_weights=val, mode="sum"), reps)
    paged_gather_score.launches = count  # by name: a comparison
    # the session's host math for a row (its entity's table row gathered
    # at the row's indices, then one numpy dot) against the kernel's bits
    t_np, s_np, i_np, v_np, at_np = (x.cpu().numpy() for x in
                                     (table, slots, idx, val, at))
    live = np.flatnonzero(s_np >= 0)
    host = np.array([np.dot(t_np[s_np[i], i_np[i]], v_np[i]) for i in live],
                    np.float32)
    host_bits_differ = int((host != at_np[live]).sum())
    resident = int((slots >= 0).sum())
    nbytes = 4 * b + 8 * b * k + 4 * resident * k + 4 * b + 8
    bytes_ms = nbytes / peaks[0] * 1e3
    ops_ms = 2 * resident * k / peaks[1] * 1e3
    print(f"  paged_gather_score_at B={b} k={k} float32: max |kernel - "
          f"plain| {err:.3e}, bit-equal to the direct entry and the ordered "
          f"plain twin; kernel "
          f"{at_ms:.4f} ms per call, plain {plain_ms:.4f} ms, embedding_bag "
          f"{library_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms; host "
          f"math differs from the kernel in {host_bits_differ} of "
          f"{live.size} resident rows' bits; phase "
          f"20 {time.perf_counter() - t_phase:.1f} s; on {smi}")
    return {"launches": int(launches), "replays": int(replays),
            "batches": int(batches), "rows_per_s": rows_s,
            "seconds": seconds, "ready_s": t_ready, "prefetch_s": t_pref,
            "reload_s": t_reload,
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p99_ms": float(np.percentile(lat, 99)),
            "captures": int(final[miss]), "rungs": rungs,
            "max_abs_diff": diff,
            "extra_rounds": int(replays - batches),
            "host_bits_differ": [host_bits_differ, int(live.size)],
            "at_b64_k64": {"kernel_ms": at_ms, "plain_ms": plain_ms,
                           "library_ms": library_ms, "max_abs_err": err,
                           "bound_ms": max(bytes_ms, ops_ms),
                           "bound_by": ("bytes" if bytes_ms >= ops_ms
                                        else "operations")},
            "driver_done_launches": done["kernel_launches"]}


# -- phase 21: the registry, the front door and two replicas --------------
REGISTRY_REPLICAS = 2
REGISTRY_ROWS = 1 << 13  # the first validation rows, served through the door
REGISTRY_PROBES = 128  # requests sent one at a time before and after the swap
DELTA_USERS, DELTA_SCALE = 1024, 0.5  # per-user records scaled in the delta
SWAP_LIMIT_S = 60.0  # promotion -> every replica serving the delta
REGISTRY_WAIT_S = 900  # the worker's and the driver's longest wait
REGISTRY_DEVICE = "cuda"  # where the worker's gates score
GATE_TOLERANCE = 0.01  # AUC a candidate may lose and still be promoted


def registry_paths(root):
    import os

    return {"best": os.path.join(root, "out", "best"),
            "val": os.path.join(root, "validation"),
            "registry": os.path.join(root, "registry"),
            "work": os.path.join(root, "registry_work")}


def _tree_sha256(model_dir):
    import hashlib
    import os

    out = {}
    for dirpath, _dirs, files in os.walk(model_dir):
        for name in sorted(files):
            full = os.path.join(dirpath, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, model_dir)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def check_bootstrap_publish(root):
    """Phase 21 (a), right after the training driver ran with
    ``--publish-to``: the registry holds one version, LATEST, whose
    artifacts' fingerprints equal those of the saved ``best/``."""
    from photon_ml_tpu_torch.registry import ModelRegistry
    from photon_ml_tpu_torch.registry.store import artifact_fingerprints

    paths = registry_paths(root)
    registry = ModelRegistry(paths["registry"])
    latest = registry.read_latest()
    fingerprints = artifact_fingerprints(registry.version_dir("v000001"))
    registry.verify("v000001")
    same = fingerprints == _tree_sha256(paths["best"])
    print(f"phase 21 (a): bootstrap publish: versions "
          f"{registry.list_versions()}, LATEST {latest}, "
          f"{len(fingerprints)} artifact fingerprints equal best/'s: {same}")
    if not (latest == "v000001" and registry.list_versions() == [latest]
            and same):
        raise RuntimeError("the training driver's bootstrap publish is not "
                           "best/ as LATEST v000001")


def registry_worker(kind: str, root: str) -> int:
    """``chip_smoke.py --registry-worker KIND ROOT``: phase 21's model
    lifecycle in processes of their own, beside the serving driver.
    ``refused``: a candidate with the fixed effect negated through
    ``model_publish_driver`` with the validation files as gate data (AUC
    on the card, GATE_TOLERANCE): exit 3. ``delta``: the delta candidate
    (``best/`` with DELTA_USERS seeded served users' per-user records
    scaled by DELTA_SCALE, through ``model_io``'s reader and the model
    schema), published with ``--delta`` once the refused candidate is in
    the registry, materialized, then gated with ``--candidate``: the gate
    scores it and, when ``go`` appears in the work directory (the door's
    traffic under v000001 is done), promotes it. Each writes
    ``<kind>.json``; the delta worker also ``users.json`` when its
    candidate is built, ``waiting`` when its gate is ready to promote, and
    the gate's ``score_game_model`` outputs (candidate, then live) to
    ``gate_scores.npz``."""
    import contextlib
    import io
    import os
    import shutil

    from photon_ml_tpu_torch.cli import model_publish_driver
    from photon_ml_tpu_torch.game import scoring
    from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
    from photon_ml_tpu_torch.io.model_io import (
        load_model_metadata, read_random_effect_records,
    )
    from photon_ml_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL_SCHEMA
    from photon_ml_tpu_torch.registry import ModelRegistry, materialize

    paths = registry_paths(root)
    work, best = paths["work"], paths["best"]
    registry = ModelRegistry(paths["registry"])
    out = {}

    def publish(*argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = model_publish_driver.main(
                ["--registry", paths["registry"], *argv])
        lines = [json.loads(line) for line in buf.getvalue().splitlines()
                 if line.startswith("{")]
        return {"rc": rc, "lines": lines,
                "seconds": time.perf_counter() - t0,
                "latest": registry.read_latest()}

    def wait_for(what, cond):
        deadline = time.monotonic() + REGISTRY_WAIT_S
        while not cond():
            if time.monotonic() > deadline:
                raise RuntimeError(f"phase 21's {kind} worker: no {what}")
            time.sleep(0.05)

    gate = ["--gate-data", paths["val"], "--evaluators", "auc",
            "--tolerance", str(GATE_TOLERANCE), "--device", REGISTRY_DEVICE]
    t0 = time.perf_counter()
    if kind == "refused":
        fixed = next(c["name"] for c in
                     load_model_metadata(best)["coordinates"]
                     if c["type"] == "fixed")
        negated = os.path.join(work, "negated")
        shutil.copytree(best, negated)
        fe = os.path.join(negated, "fixed-effect", fixed,
                          "coefficients.avro")
        records, _ = read_avro_file(fe)
        for rec in records:
            for coef in rec["means"]:
                coef["value"] = -coef["value"]
        write_avro_file(fe, records, BAYESIAN_LINEAR_MODEL_SCHEMA)
        out["build_s"] = time.perf_counter() - t0
        out["publish"] = publish("--model-dir", negated, *gate)
    else:
        records = read_random_effect_records(best, "per_user")
        _, users, _, _ = game_arrays(GAME_ROWS + GAME_VAL_ROWS, SEED)
        served = {str(u)
                  for u in users[GAME_ROWS:GAME_ROWS + REGISTRY_ROWS]}
        known = sorted(str(r["modelId"]) for r in records
                       if str(r["modelId"]) in served)
        chosen = set(np.random.default_rng(SEED).choice(
            known, DELTA_USERS, replace=False).tolist())
        for rec in records:
            if str(rec["modelId"]) in chosen:
                for coef in rec["means"]:
                    coef["value"] *= DELTA_SCALE
        delta = os.path.join(work, "delta")
        shutil.copytree(best, delta)
        write_avro_file(os.path.join(delta, "random-effect", "per_user",
                                     "coefficients.avro"), records,
                        BAYESIAN_LINEAR_MODEL_SCHEMA)
        del records
        with open(os.path.join(work, "users.json"), "w") as f:
            json.dump(sorted(chosen), f)
        out["build_s"] = time.perf_counter() - t0
        # the refused candidate takes v000002, this one v000003
        wait_for("refused candidate",
                 lambda: len(registry.list_versions()) >= 2)
        out["publish"] = publish("--model-dir", delta, "--delta")
        candidate = next(line["published"]
                         for line in out["publish"]["lines"]
                         if "published" in line)
        t0 = time.perf_counter()
        materialize(registry, candidate)
        out["materialize_s"] = time.perf_counter() - t0

        scored = []
        real_score = scoring.score_game_model
        real_set = ModelRegistry.set_latest

        def spy_score(*a, **kw):
            scores = real_score(*a, **kw)
            scored.append(scores.detach().cpu().numpy())
            return scores

        def held_set(self, version):
            # the gate has decided: promote once the door is done
            with open(os.path.join(work, "waiting"), "w"):
                pass
            wait_for("go", lambda: os.path.exists(os.path.join(work, "go")))
            real_set(self, version)
            out["promoted_at"] = time.time()

        scoring.score_game_model, ModelRegistry.set_latest = (spy_score,
                                                              held_set)
        try:
            out["gate"] = publish("--candidate", candidate, *gate)
        finally:
            scoring.score_game_model, ModelRegistry.set_latest = (
                real_score, real_set)
        out["version"] = candidate
        np.savez(os.path.join(work, "gate_scores.npz"),
                 candidate=scored[0], live=scored[1])
    with open(os.path.join(work, f"{kind}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _fd_series(base):
    """``GET /fd/metrics`` as {replica address: {series: value}} (the
    door's own ``photon_fd_*`` series under the key None)."""
    import re
    import urllib.request

    with urllib.request.urlopen(f"{base}/fd/metrics", timeout=60) as resp:
        text = resp.read().decode()
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        m = re.search(r'replica="([^"]+)"', key)
        name = re.sub(r'replica="[^"]+"', "", key).replace(
            "{,", "{").replace(",}", "}").replace("{}", "")
        out.setdefault(m.group(1) if m else None, {})[name] = float(value)
    return out


def _get_json(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def _window(base, bodies, n):
    """The requests from SERVE_CLIENTS threads: (scores, per_user parts,
    latencies in s, seconds, errors)."""
    import queue
    import threading

    work: "queue.Queue" = queue.Queue()
    for item in bodies:
        work.put(item)
    got, user_part = np.full(n, np.nan), np.full(n, np.nan)
    latencies, errors = [], []

    def client():
        while True:
            try:
                lo, size, data = work.get_nowait()
            except queue.Empty:
                return
            try:
                status, out, sec = _post(base, "/score", data)
            except Exception as e:  # reported by the caller
                errors.append(repr(e))
                continue
            if status != 200 or len(out["scores"]) != size:
                errors.append(f"{status} {str(out)[:200]}")
                continue
            got[lo:lo + size] = out["scores"]
            user_part[lo:lo + size] = out["scoreComponents"]["per_user"]
            latencies.append(sec)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVE_WAIT_S)
    seconds = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        errors.append("a client thread did not finish")
    return got, user_part, np.array(latencies), seconds, errors


def _probes(base, bodies):
    """Requests one at a time: [(scores, per_user parts)]."""
    out = []
    for _lo, _size, data in bodies:
        status, body, _ = _post(base, "/score", data)
        if status != 200:
            raise RuntimeError(f"probe: {status} {body}")
        out.append((body["scores"], body["scoreComponents"]["per_user"]))
    return out


def start_registry_workers(best):
    """Phase 21's two lifecycle workers (``registry_worker``), started
    before phase 20 so that their model reads and writes overlap it.
    Returns {kind: process}."""
    import os

    root = os.path.dirname(os.path.dirname(best))
    work = registry_paths(root)["work"]
    os.makedirs(work, exist_ok=True)
    workers = {}
    for kind in ("refused", "delta"):
        with open(os.path.join(work, f"{kind}.out"), "wb") as f:
            workers[kind] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--registry-worker", kind, root], stdout=f,
                stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__)))
    return workers


def phase_serving(best, scores, dev, smi, peaks):
    """Phases 19 (b)-(c), 20 and 21 inside phase 13's directory, phase
    21's workers started after 19 (c) and stopped in any case. Returns
    their results."""
    paged = phase_paged(best, dev, smi, peaks)
    workers = start_registry_workers(best)
    try:
        return (paged, phase_serve(best, scores, dev, smi, peaks),
                phase_registry(best, scores, dev, smi, workers))
    finally:
        for p in workers.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)


def phase_registry(best, ref, dev, smi, workers):
    """Phase 21, inside phase 13's directory, after phase 20, with the
    ``workers`` of ``start_registry_workers`` (the docstring at the top of
    the file lists its steps and gates). Returns the phase's numbers."""
    import os
    import queue
    import re
    import signal
    import threading

    from photon_ml_tpu_torch.registry import ModelRegistry
    from photon_ml_tpu_torch.serve.session import bucket_ladder

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.dirname(best))
    paths = registry_paths(root)
    here = os.path.dirname(os.path.abspath(__file__))
    idx_raw, users, items, _ = game_arrays(GAME_ROWS + GAME_VAL_ROWS, SEED)
    n = REGISTRY_ROWS
    rows = slice(GAME_ROWS, GAME_ROWS + n)
    idx_np, users, items = idx_raw[rows], users[rows], items[rows]
    ref = ref[:n]
    ladder = bucket_ladder(SERVE_MAX_BATCH)
    log_dir = os.path.join(root, "registry_serve_log")
    cmd = SERVE_DRIVER + [
        "--registry", paths["registry"], "--replicas",
        str(REGISTRY_REPLICAS), "--server", "async", "--hedge",
        "--watch-interval-s", "1", "--port", "0", "--device", str(dev),
        "--max-batch", str(SERVE_MAX_BATCH),
        "--re-dense-dim-max", str(GAME_DIM + 1),
        "--re-pages", str(SERVE_PAGES), "--re-page-rows",
        str(SERVE_PAGE_ROWS), "--coeff-cache-entries", str(SERVE_LRU),
        "--log-dir", log_dir]
    t0 = time.perf_counter()
    # a session of its own: a failed phase stops the replicas with it
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=here,
                            start_new_session=True)
    lines: "queue.Queue[str]" = queue.Queue()
    output = []

    def pump():
        for line in proc.stdout:
            output.append(line)
            lines.put(line)

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        m, deadline = None, time.monotonic() + SERVE_WAIT_S
        while m is None:
            try:
                line = lines.get(timeout=0.5)
            except queue.Empty:
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"the serving driver exited {proc.returncode}:\n"
                        f"{''.join(output)}") from None
                if time.monotonic() > deadline:
                    raise RuntimeError("the front door did not get ready "
                                       f"in {SERVE_WAIT_S} s") from None
                continue
            m = re.search(r"^front door on http://[\d.]+:(\d+) -> \d+ "
                          r"replicas on \[([\d, ]+)\]", line)
        t_ready = time.perf_counter() - t0
        base = f"http://127.0.0.1:{int(m.group(1))}"
        replicas = [f"127.0.0.1:{p.strip()}" for p in m.group(2).split(",")]
        miss, hit = ("photon_serve_compile_cache_misses_total",
                     "photon_serve_compile_cache_hits_total")
        launches_key = ('photon_serve_kernel_launches_total'
                        '{kernel="paged_gather_score"}')
        off_rungs = ("photon_serve_fixed_eager_batches_total",
                     "photon_serve_fused_fallback_batches_total",
                     "photon_serve_overflow_rows_total")
        warm = _fd_series(base)
        print(f"phase 21 (b): serving_driver --registry --replicas "
              f"{REGISTRY_REPLICAS} --server async --hedge: the front door "
              f"and {len(replicas)} replicas ready in {t_ready:.2f} s "
              f"(captures per replica "
              f"{[int(warm[r][miss]) for r in replicas]}, one per rung of "
              f"{ladder}); on {smi}")
        if len(replicas) != REGISTRY_REPLICAS or any(
                warm[r][miss] != len(ladder) for r in replicas):
            raise RuntimeError(f"captures after warmup: {warm}")

        # prefetch on both replicas at once: their store passes overlap
        ids = sorted(set(users.astype(str).tolist())
                     | set(items.astype(str).tolist()))
        prefetched = {}

        def prefetch(address):
            prefetched[address] = _post(f"http://{address}",
                                        "/admin/membership", {
                                            "epoch": 1, "numShards": 1,
                                            "shardIndex": 0,
                                            "prefetchEntityIds": ids},
                                        timeout=SERVE_WAIT_S)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=prefetch, args=(r,))
                   for r in replicas]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SERVE_WAIT_S)
        t_pref = time.perf_counter() - t0
        print(f"  /admin/membership prefetch of {len(ids)} ids on each "
              f"replica at once: {t_pref:.2f} s; "
              + ", ".join(f"{r} {body.get('prefetched')} entities in "
                          f"{sec:.2f} s" for r, (_s, body, sec)
                          in sorted(prefetched.items())))
        if len(prefetched) != len(replicas) or any(
                s != 200 or not b.get("prefetched")
                for s, b, _ in prefetched.values()):
            raise RuntimeError(f"membership prefetch: {prefetched}")

        # the scoring window under v1, then the probes one at a time
        bodies = serve_requests(idx_np, users, items, SEED)
        before = _fd_series(base)
        got, part1, lat, seconds, errors = _window(base, bodies, n)
        probes1 = _probes(base, bodies[:REGISTRY_PROBES])
        diff = float(np.abs(got - ref).max())
        rows_s = n / seconds
        print(f"  v000001: {n} rows in {len(bodies)} requests from "
              f"{SERVE_CLIENTS} clients through the door: {seconds:.3f} s, "
              f"{rows_s:.1f} rows/s; latency p50 "
              f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
              f"{np.percentile(lat, 99) * 1e3:.3f} ms; max |served - "
              f"score_game_model| {diff:.3e} (tol {TOL_SERVE}); "
              f"{len(errors)} errors; on {smi}")
        if errors or not (np.isfinite(got).all() and diff <= TOL_SERVE):
            raise RuntimeError(f"v000001 through the door: {errors[:3]}, "
                               f"max diff {diff}")

        # the refused candidate's worker ends; the delta's gate waits to
        # promote until the door's traffic under v000001 is done
        work = paths["work"]
        t_wait = time.perf_counter()
        while not (workers["refused"].poll() is not None
                   and os.path.exists(os.path.join(work, "waiting"))):
            if (workers["delta"].poll() is not None
                    or time.perf_counter() - t_wait > REGISTRY_WAIT_S):
                raise RuntimeError(
                    "phase 21's delta worker stopped before its gate "
                    f"promoted ({workers['delta'].poll()})")
            time.sleep(0.1)
        t_waited = time.perf_counter() - t_wait
        with open(os.path.join(work, "refused.json")) as f:
            refused = json.load(f)
        latest_before = ModelRegistry(paths["registry"]).read_latest()
        with open(os.path.join(work, "go"), "w"):
            pass
        if workers["delta"].wait(timeout=REGISTRY_WAIT_S) != 0:
            raise RuntimeError("phase 21's delta worker failed")
        with open(os.path.join(work, "delta.json")) as f:
            res = json.load(f)
        with open(os.path.join(work, "users.json")) as f:
            chosen = json.load(f)
        published, gated, v3 = res["publish"], res["gate"], res["version"]
        gate_scores = np.load(os.path.join(work, "gate_scores.npz"))
        live_diff = float(np.abs(gate_scores["live"][:n] - ref).max())

        def verdict(r):
            return next((line for line in r["lines"]
                         if "gate_passed" in line), {})

        print(f"  workers: the negated candidate built in "
              f"{refused['build_s']:.2f} s, published and gated in "
              f"{refused['publish']['seconds']:.2f} s: exit "
              f"{refused['publish']['rc']}, auc "
              f"{verdict(refused['publish']).get('candidate_metrics')} "
              f"against {verdict(refused['publish']).get('live_metrics')}, "
              f"LATEST {latest_before}; the delta candidate built in "
              f"{res['build_s']:.2f} s, published in "
              f"{published['seconds']:.2f} s as {v3} "
              f"({published['lines'][0].get('delta_summary')}), "
              f"materialized in {res['materialize_s']:.2f} s, gated in "
              f"{gated['seconds']:.2f} s (with the wait to promote): exit "
              f"{gated['rc']}, auc {verdict(gated).get('candidate_metrics')}"
              f" against {verdict(gated).get('live_metrics')}, LATEST "
              f"{gated['latest']}; the door waited {t_waited:.2f} s for "
              f"them; the gate's float64 v000001 scores against the "
              f"scoring driver's: {live_diff:.3e}")
        if not (refused["publish"]["rc"] == 3
                and refused["publish"]["latest"] == "v000001"
                and latest_before == "v000001" and published["rc"] == 0
                and published["latest"] == "v000001" and gated["rc"] == 0
                and gated["latest"] == v3 and live_diff <= TOL_SERVE):
            raise RuntimeError(f"phase 21's gates: {refused} {res}")
        summary = published["lines"][0]["delta_summary"]
        if (summary["changed_fixed"] or summary["changed_entities"]
                != {"per_user": DELTA_USERS, "per_item": 0}):
            raise RuntimeError(f"the delta holds more than the scaled "
                               f"users: {summary}")

        # every replica's watcher swaps to the promoted delta
        deadline = res["promoted_at"] + SWAP_LIMIT_S
        seen = {}
        while len(seen) < len(replicas):
            for r in replicas:
                if r not in seen and _get_json(
                        f"http://{r}/healthz")["active_version"] == v3:
                    seen[r] = time.time() - res["promoted_at"]
            if time.time() > deadline:
                raise RuntimeError(f"replicas on {v3} within "
                                   f"{SWAP_LIMIT_S} s: {seen}")
            time.sleep(0.1)
        print(f"  every replica's watcher swapped to {v3}: "
              + ", ".join(f"{r} {s:.2f} s" for r, s in sorted(seen.items()))
              + " after the promotion")

        want = gate_scores["candidate"][:n]
        got2, part2, lat2, seconds2, errors2 = _window(base, bodies, n)
        probes2 = _probes(base, bodies[:REGISTRY_PROBES])
        after = _fd_series(base)
        diff2 = float(np.abs(got2 - want).max())
        moved = np.isin(users.astype(str), chosen)
        print(f"  {v3}: {n} rows: {seconds2:.3f} s, {n / seconds2:.1f} "
              f"rows/s; latency p50 {np.percentile(lat2, 50) * 1e3:.3f} ms, "
              f"p99 {np.percentile(lat2, 99) * 1e3:.3f} ms; max |served - "
              f"score_game_model({v3} materialized)| {diff2:.3e} (tol "
              f"{TOL_SERVE}); {int(moved.sum())} rows of the "
              f"{DELTA_USERS} scaled users")
        if errors2 or not (np.isfinite(got2).all() and diff2 <= TOL_SERVE):
            raise RuntimeError(f"{v3} through the door: {errors2[:3]}, "
                               f"max diff {diff2}")
        # the probes: a scaled user's part exactly halved, any other
        # row's part as before, bit for bit
        flat = lambda probes, k: np.concatenate([np.asarray(p[k])
                                                 for p in probes])
        pm = np.concatenate([moved[lo:lo + size]
                             for lo, size, _ in bodies[:REGISTRY_PROBES]])
        u1, u2 = flat(probes1, 1), flat(probes2, 1)
        halved = bool(np.array_equal(u2[pm], DELTA_SCALE * u1[pm]))
        kept = bool(np.array_equal(u2[~pm], u1[~pm]))
        changed = int((flat(probes2, 0)[pm] != flat(probes1, 0)[pm]).sum())
        print(f"  {REGISTRY_PROBES} probe requests one at a time "
              f"({pm.size} rows, {int(pm.sum())} of scaled users): their "
              f"per_user parts halved exactly {halved}, every other part "
              f"bit-equal {kept}; {changed} scores changed")
        if not (pm.any() and halved and kept and changed):
            raise RuntimeError("the delta's probes")

        # captures, off-rung batches and launches, per replica
        per = {}
        for r in replicas:
            replays = after[r][hit] - before[r][hit]
            launches = after[r][launches_key] - before[r][launches_key]
            per[r] = {"captures": int(after[r][miss]),
                      "replays": int(replays), "launches": int(launches),
                      "batches": int(after[r]["photon_serve_batches_total"]
                                     - before[r]["photon_serve_batches_total"]),
                      "off_rungs": [int(after[r][k]) for k in off_rungs],
                      "swaps": int(after[r]["photon_serve_swaps_total"])}
        print("  per replica: " + "; ".join(
            f"{r}: captures {p['captures']}, {p['batches']} batches, "
            f"{p['replays']} replays, {p['launches']} paged_gather_score "
            f"launches, off the rungs {p['off_rungs']}, swaps {p['swaps']}"
            for r, p in sorted(per.items())))
        if any(p["captures"] != len(ladder) or any(p["off_rungs"])
               or p["launches"] != 2 * p["replays"] or p["replays"] < 1
               for p in per.values()):
            raise RuntimeError(f"phase 21 per replica: {per}")

        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=SERVE_WAIT_S)
        if rc != 0:
            raise RuntimeError(f"the serving driver exited {rc} after "
                               f"SIGTERM:\n{''.join(output[-20:])}")
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass  # the driver and its replicas have all exited
        proc.wait(timeout=60)
        reader.join(60)
    with open(os.path.join(log_dir, "photon.log.jsonl")) as f:
        done = [json.loads(line) for line in f][-1]
    door = done.get("front_door", {})
    print(f"  SIGTERM: exit 0, replicas exited {done.get('replica_exit_codes')}"
          f"; hedges fired {door.get('hedged')}, won {door.get('hedgeWins')}"
          f"; proxied {door.get('proxied')}, retried {door.get('retried')}; "
          f"the parent created a CUDA context: "
          f"{done.get('cuda_initialized')}; phase 21 "
          f"{time.perf_counter() - t_phase:.1f} s; on {smi}")
    if (done["event"] != "driver_done"
            or done.get("replica_exit_codes") != [0] * REGISTRY_REPLICAS
            or done.get("cuda_initialized")):
        raise RuntimeError(f"the driver's log ends with {done}")
    return {"launches": sum(p["launches"] for p in per.values()),
            "per_replica": per, "ready_s": t_ready, "prefetch_s": t_pref,
            "rows_per_s": [rows_s, n / seconds2],
            "latency_p50_ms": [float(np.percentile(lat, 50)) * 1e3,
                               float(np.percentile(lat2, 50)) * 1e3],
            "latency_p99_ms": [float(np.percentile(lat, 99)) * 1e3,
                               float(np.percentile(lat2, 99)) * 1e3],
            "swap_s": seen, "refused_s": refused["publish"]["seconds"],
            "delta_build_s": res["build_s"],
            "delta_publish_s": published["seconds"],
            "materialize_s": res["materialize_s"],
            "delta_gate_s": gated["seconds"], "waited_for_workers_s": t_waited,
            "hedged": door.get("hedged"), "hedge_wins": door.get("hedgeWins"),
            "max_abs_diff": [diff, diff2],
            "seconds": time.perf_counter() - t_phase}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from photon_ml_tpu_torch.ops import kernel_build
    from photon_ml_tpu_torch.ops.kernels import (
        TILE, csc_column_sums, multiply_prefix_sum,
    )
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
    max_err = max(max_err, check_scan(3 * TILE + 17, True, gen, dev,
                                      torch.float64))
    col_timing = column_sums_at("main path", csc, N_ROWS, gen, dev, peaks,
                                smi)
    col_err = max(col_timing["max_abs_err"],
                  check_column_extras(csc, gen, dev, smi))
    # from here on, multiply_prefix_sum runs only where a check or a
    # timing calls it by name (EXPLICIT_MPS); no path may launch it
    mps_start, EXPLICIT_MPS[0] = multiply_prefix_sum.launches, 0

    w0 = torch.zeros(DIM, device=dev)
    cfg = OptimizerConfig(max_iters=ITERS, tolerance=0.0)

    def fit(mode, config=cfg, **kw):
        return fit_distributed(obj, batch, w0, l2=1.0, config=config,
                               sparse_grad=mode, precomputed_csc=csc, **kw)

    fit("csc_kernel", OptimizerConfig(max_iters=2, tolerance=0.0))  # warm-up
    torch.cuda.synchronize()
    csc_column_sums.launches = 0
    mps_before = multiply_prefix_sum.launches
    t0 = time.perf_counter()
    res = fit("csc_kernel")
    value = float(res.value)  # scalar fetch: the fit has run
    elapsed = time.perf_counter() - t0
    launches = csc_column_sums.launches
    mps_launches = multiply_prefix_sum.launches - mps_before
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

    owlqn_launches = phase_owlqn(fit, f0, smi)
    tron_launches, tron_res = phase_tron(fit, f0, smi)
    launches_by_path = {
        "lbfgs_margin": launches,
        "owlqn": owlqn_launches,
        "tron": tron_launches,
        f"lbfgs_full_n{N_SMALL}_d{DIM_SMALL}": phase_full_line_search(
            gen, dev, smi),
    }
    phase_auc(res.w, batch, smi)
    phase_stream_launches, stream_timing = phase_stream(
        obj, indices, labels, batch, csc, res.w, smi, gen, dev, peaks)
    launches_by_path.update(phase_stream_launches)
    launches_by_path["glm_driver"], driver_timing, ooc_timing, (
        launches_by_path["glm_driver_ooc"], mp_driver_launches,
        recovery_driver_launches, (traced_driver_launches, _)) = \
        phase_driver(
            dev, smi, peaks, gen,
            then=lambda root, train_dir, val_dir: (
                phase_glm_ooc(root, train_dir, val_dir, dev, smi),
                phase_mp_driver(train_dir, val_dir, root, dev, smi),
                phase_recovery_driver(train_dir, val_dir, root, dev, smi),
                phase_trace_driver(root, train_dir, val_dir, dev, smi)))
    path_launches, path_timing = phase_path(obj, batch, csc, smi, gen, dev,
                                            peaks)
    launches_by_path.update(path_launches)
    col_err = max(col_err, path_timing["max_abs_err"],
                  driver_timing["max_abs_err"], ooc_timing["max_abs_err"],
                  stream_timing["max_abs_err"])
    phase_re_solve(dev, gen, smi)
    launches_by_path["game_cd"], game_ctx = phase_game(dev, smi)
    launches_by_path["game_driver"], (paged_kernel, serve, registry) = \
        phase_game_driver(dev, smi, then=lambda best, scores: phase_serving(
            best, scores, dev, smi, peaks))
    paged_kernel["launches_by_path"]["serving_driver"] = serve["launches"]
    paged_kernel["launches_by_path"]["registry_front_door_replicas"] = \
        registry["launches"]
    paged_kernel["launches"] += serve["launches"] + registry["launches"]
    paged_kernel["registry_front_door"] = registry
    paged_kernel["shapes"]["random_table_at_float32_b64_k64"] = serve.pop(
        "at_b64_k64")
    paged_kernel["serving_driver"] = serve
    launches_by_path["game_cd_streaming"] = phase_game_stream(game_ctx, dev,
                                                              smi)
    # phase 17: multi-process
    t_mp = time.perf_counter()
    refs = {"lbfgs_margin": dict(w=res.w, launches=launches),
            "tron": dict(w=tron_res.w, launches=tron_launches,
                         iterations=tron_res.iterations,
                         host_reads=tron_res.host_syncs,
                         accepted=tron_accepted(tron_res, N_ROWS)),
            "stream_lbfgs_margin": dict(
                w=stream_timing["lbfgs_res"].w,
                launches=launches_by_path["stream_lbfgs_margin"])}
    launches_by_path["multi_process"] = {
        "world1_nccl": {"rank0": {"lbfgs_margin": phase_mp_world1(
            obj, batch, csc, res.w, smi)}},
        "glm_driver_world1": {"rank0": mp_driver_launches},
        "world2_gloo": phase_mp_world2(indices, labels, refs, game_ctx, dev,
                                       smi),
    }
    print(f"phase 17: {time.perf_counter() - t_mp:.2f} s (the driver leg "
          "ran inside phase 9's directory)")
    # phase 18: recovery
    t_rec = time.perf_counter()
    launches_by_path["recovery"] = {
        "entity_sharded_cd_world2_gloo": phase_recovery(game_ctx, dev, smi),
        "glm_driver_world1_device_loss_resume": recovery_driver_launches,
    }
    print(f"phase 18: {time.perf_counter() - t_rec:.2f} s (leg (b) ran "
          "inside phase 9's directory)")
    # phase 19: tracing on the training paths (the driver leg ran inside
    # phase 9's directory) and the paged table (inside phase 13's)
    t_obs = time.perf_counter()
    launches_by_path["traced"] = {
        "glm_driver_path_screen_strong": traced_driver_launches,
        "game_cd": phase_trace_game(game_ctx, dev, smi)}
    print(f"phase 19: {time.perf_counter() - t_obs:.2f} s (the driver leg "
          "ran inside phase 9's directory, legs (b) and (c) inside phase "
          "13's)")

    # phases 5-18 ran no multiply_prefix_sum but the named ones
    mps_on_paths = multiply_prefix_sum.launches - mps_start - EXPLICIT_MPS[0]
    print(f"multiply_prefix_sum launches after phase 3: {EXPLICIT_MPS[0]} "
          f"by name (timings), {mps_on_paths} on the paths (must be 0)")
    if mps_on_paths or mps_launches:
        raise RuntimeError(f"multiply_prefix_sum ran on a path "
                           f"({mps_on_paths} launches)")

    def shape(t):
        return {k: v for k, v in t.items() if k not in ("lbfgs_res",)}

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "csc_column_sums",
        "route": "cuda",
        "source": "photon_ml_tpu_torch/ops/csrc/csc_column_sums.cu",
        "replaces": "photon_ml_tpu/ops/pallas_kernels.py:168",
        "launches": launches,
        "launches_by_path": launches_by_path,
        "max_abs_err": col_err,
        "tol": f"{TOL_COLUMN} * sum_j |x| (+ one float32 ulp of |ref_j|)",
        "ms": col_timing["kernel_ms"],
        "device_ms": col_timing["device_ms"],
        "plain_ms": col_timing["plain_ms"],
        "bound_ms": col_timing["bound_ms"],
        "bound_by": col_timing["bound_by"],
        "library_ms": col_timing["library_ms"],
        "library": "cuSPARSE SpMV: torch.sparse_csr_tensor(col_starts, "
                   "rows, values or ones) @ d",
        "previous_route_ms": col_timing["previous_ms"],
        "shapes": {
            "main": shape(col_timing),
            "glm_driver_with_values": shape(driver_timing),
            "path_float64_with_values": shape(path_timing),
            "stream_chunk": shape(stream_timing),
            "glm_driver_ooc_chunk_with_values": shape(ooc_timing)},
    }, {
        "name": "multiply_prefix_sum",
        "route": "cuda",
        "source": "photon_ml_tpu_torch/ops/csrc/multiply_prefix_sum.cu",
        "replaces": "photon_ml_tpu/ops/pallas_kernels.py:34",
        "launches": mps_launches,
        "launches_by_name_after_phase_3": EXPLICIT_MPS[0],
        "max_abs_err": max_err,
        "tol": f"{TOL_SCAN} * cumsum(|x|) per tile",
        "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "library": "torch.cumsum in float64",
    }, paged_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--mp-rank":
        sys.exit(mp_rank(int(sys.argv[2]), sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "--recovery-rank":
        sys.exit(recovery_rank(int(sys.argv[2]), sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "--registry-worker":
        sys.exit(registry_worker(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 2 and sys.argv[1] == "--sticky-error":
        sys.exit(sticky_error_probe())
    sys.exit(main())
