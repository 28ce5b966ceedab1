"""Unified metrics core: counters, gauges, histograms, text exposition
(counterpart of ``photon_ml_tpu/obs/metrics.py``; stdlib-only, the same
code and the same exposition).

Generalized out of ``serve/metrics.py`` (which re-exports from here,
unchanged API, byte-identical ``/metrics`` render) so training records
through the same primitives: per-sweep solve/eval/comm time, chunk-cache
hits/misses, prefetch stalls, and cross-shard exchange bytes all land in
one registry with the serving series' exposition format.

Stdlib-only. The exposition format is the Prometheus text format's
subset that covers counters, gauges, and cumulative histograms; the
histogram contract (``le`` buckets cumulative, ``+Inf`` == ``_count``)
is held against the JAX package's in ``tests/test_torch_obs.py``.

Thread-safety: one lock per :class:`ServingMetrics` /
:class:`MetricsRegistry` instance — every recording site is a handful
of float ops, and the handler threads + batcher worker all write here.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Histogram", "ServingMetrics", "MetricsRegistry", "TrainingMetrics",
    "DEFAULT_LATENCY_BUCKETS_MS", "DEFAULT_SECONDS_BUCKETS",
    "escape_label_value", "training_metrics",
]

# Default latency buckets (milliseconds): log-ish spacing from sub-ms to
# the watchdog regime. Cumulative counts, prometheus ``le`` semantics.
DEFAULT_LATENCY_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0,
)

# Second-scale buckets for training-side phase timings (a CD coordinate
# solve spans ~ms on toy data to minutes on streamed passes).
DEFAULT_SECONDS_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
    300.0, 600.0,
)


def escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline (in that order — backslash first so the escapes
    themselves survive)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class Histogram:
    """Fixed-bucket cumulative histogram (prometheus semantics): bucket
    ``le=b`` counts observations ``<= b``, plus ``+Inf``/count/sum."""

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_MS):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf overflow
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        i = len(self.bounds)
        for j, b in enumerate(self.bounds):
            if value <= b:
                i = j
                break
        self.counts[i] += 1
        self.total += 1
        self.sum += value

    def quantile(self, q: float) -> float:
        """Approximate quantile: linear interpolation within the bucket
        the rank lands in (prometheus ``histogram_quantile`` semantics —
        the old upper-bound answer overstated by up to a full bucket
        ratio, which made any policy keyed on an observed quantile, e.g.
        the front door's hedge trigger, fire a bucket late). The +Inf
        overflow bucket still reports the last finite bound."""
        if self.total == 0:
            return 0.0
        rank = q * self.total
        seen = 0
        lo = 0.0
        for j, b in enumerate(self.bounds):
            if self.counts[j] and seen + self.counts[j] >= rank:
                frac = (rank - seen) / self.counts[j]
                return lo + frac * (b - lo)
            seen += self.counts[j]
            lo = b
        return self.bounds[-1] if self.bounds else float("inf")

    def render(self, name: str, out: List[str],
               labels: str = "") -> None:
        """Emit the cumulative bucket series. ``labels`` is a pre-
        rendered ``k="v",…`` fragment (empty for the unlabeled form —
        which keeps the serving render byte-identical)."""
        if not labels:
            out.append(f"# TYPE {name} histogram")
        cum = 0
        sep = "," if labels else ""
        for j, b in enumerate(self.bounds):
            cum += self.counts[j]
            out.append(
                f'{name}_bucket{{{labels}{sep}le="{_fmt(b)}"}} {cum}')
        out.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} {self.total}')
        if labels:
            out.append(f"{name}_sum{{{labels}}} {_fmt(self.sum)}")
            out.append(f"{name}_count{{{labels}}} {self.total}")
        else:
            out.append(f"{name}_sum {_fmt(self.sum)}")
            out.append(f"{name}_count {self.total}")


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    return ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels)


class _Series:
    """One named metric family in a :class:`MetricsRegistry`: a value (or
    histogram) per label set, rendered in first-seen label order."""

    def __init__(self, name: str, kind: str, help: str = "",
                 bounds: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self.help = help
        self.bounds = bounds
        # label tuple (sorted (k, v) pairs) -> float | Histogram
        self.values: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def _key(self, labels: Dict[str, str]
             ) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def inc(self, n: float = 1, **labels) -> None:
        key = self._key(labels)
        self.values[key] = float(self.values.get(key, 0.0)) + n

    def set(self, v: float, **labels) -> None:
        self.values[self._key(labels)] = float(v)

    def observe(self, v: float, **labels) -> None:
        key = self._key(labels)
        h = self.values.get(key)
        if h is None:
            h = self.values[key] = Histogram(
                self.bounds or DEFAULT_LATENCY_BUCKETS_MS)
        h.observe(v)

    def get(self, **labels):
        """Current value (0 / empty histogram semantics for unseen)."""
        return self.values.get(self._key(labels), 0.0)

    def render(self, out: List[str]) -> None:
        if self.help:
            out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        for key, val in self.values.items():
            labels = _label_str(key)
            if self.kind == "histogram":
                val.render(self.name, out, labels)
            elif labels:
                out.append(f"{self.name}{{{labels}}} {_fmt(val)}")
            else:
                out.append(f"{self.name} {_fmt(val)}")


class MetricsRegistry:
    """Get-or-create named counters/gauges/histograms with optional
    labels, rendered in registration order. The shared substrate for
    non-serving metrics (training, front door); ``ServingMetrics`` keeps
    its hand-rolled render for byte-compatibility."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series: Dict[str, _Series] = {}  # insertion-ordered

    def _get(self, name: str, kind: str, help: str,
             bounds: Optional[Tuple[float, ...]] = None) -> _Series:
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = _Series(name, kind, help, bounds)
            elif s.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {s.kind}")
            return s

    def counter(self, name: str, help: str = "") -> _Series:
        return self._get(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> _Series:
        return self._get(name, "gauge", help)

    def histogram(self, name: str, help: str = "",
                  bounds: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_MS
                  ) -> _Series:
        return self._get(name, "histogram", help, bounds)

    def inc(self, name: str, n: float = 1, **labels) -> None:
        with self._lock:
            self._series[name].inc(n, **labels)

    def render(self) -> str:
        with self._lock:
            out: List[str] = []
            for s in self._series.values():
                s.render(out)
            return "\n".join(out) + "\n" if out else ""

    def snapshot(self) -> Dict[str, dict]:
        """Flat {name: {label_str_or_'': value}} view for tests/bench
        (histograms report their count/sum)."""
        with self._lock:
            snap: Dict[str, dict] = {}
            for s in self._series.values():
                vals = {}
                for key, val in s.values.items():
                    k = _label_str(key)
                    if isinstance(val, Histogram):
                        vals[k] = {"count": val.total, "sum": val.sum}
                    else:
                        vals[k] = val
                snap[s.name] = vals
            return snap


class TrainingMetrics:
    """The training-side series (``photon_train_`` prefix), recorded by
    descent / streaming / entity_shard / chunk_cache through one
    process-wide instance (:func:`training_metrics`):

      sweep_steps_total{coordinate} — CD coordinate steps;
      solve_seconds / eval_seconds / comm_seconds{coordinate} —
        histograms, the per-step phase split the CD history carries;
      chunk_cache_{warm,cold,fallthrough}_passes_total — decode-once
        cache effectiveness (warm == hit);
      prefetch_{stall,decode,transfer}_seconds_total — the streamed-pass
        pipeline accounting (``StreamStats``) as counters;
      exchange_{bytes_sent,bytes_gathered,rounds}_total /
        exchange_seconds_total — cross-shard score-delta traffic.
    """

    def __init__(self):
        self.registry = MetricsRegistry()
        r = self.registry
        self._steps = r.counter("photon_train_sweep_steps_total",
                                "CD coordinate steps completed")
        self._solve = r.histogram("photon_train_solve_seconds",
                                  bounds=DEFAULT_SECONDS_BUCKETS)
        self._eval = r.histogram("photon_train_eval_seconds",
                                 bounds=DEFAULT_SECONDS_BUCKETS)
        self._comm = r.histogram("photon_train_comm_seconds",
                                 bounds=DEFAULT_SECONDS_BUCKETS)
        self._cache = {
            "warm": r.counter("photon_train_chunk_cache_warm_passes_total"),
            "cold": r.counter("photon_train_chunk_cache_cold_passes_total"),
            "fallthrough": r.counter(
                "photon_train_chunk_cache_fallthrough_passes_total"),
        }
        self._stall = r.counter("photon_train_prefetch_stall_seconds_total")
        self._decode = r.counter(
            "photon_train_prefetch_decode_seconds_total")
        self._transfer = r.counter(
            "photon_train_prefetch_transfer_seconds_total")
        self._bytes_sent = r.counter("photon_train_exchange_bytes_sent_total")
        self._bytes_gathered = r.counter(
            "photon_train_exchange_bytes_gathered_total")
        self._rounds = r.counter("photon_train_exchange_rounds_total")
        self._exch_s = r.counter("photon_train_exchange_seconds_total")
        # pathwise fixed-effect screening (optimize/path.py): one
        # lambdas_total tick per solved lambda; frozen/rounds/violations
        # accumulate the screen's work split so a dashboard can tell an
        # effective screen (high frozen, rounds ~= lambdas, violations
        # ~= 0) from a thrashing one (violations and fallbacks climbing)
        self._path_lambdas = r.counter(
            "photon_train_path_lambdas_total",
            "lambdas solved by the pathwise screened solver")
        self._path_frozen = r.counter(
            "photon_train_path_features_frozen_total",
            "features frozen at zero, summed over solved lambdas")
        self._path_rounds = r.counter(
            "photon_train_path_kkt_rounds_total",
            "screen->solve->certify rounds (1 per lambda when the "
            "screen holds first try)")
        self._path_violations = r.counter(
            "photon_train_path_kkt_violations_total",
            "screened coordinates re-admitted by the KKT check")
        self._path_passes = r.counter(
            "photon_train_path_full_grad_passes_total",
            "full data-gradient passes paid for screening + certification")
        self._path_fallback = r.counter(
            "photon_train_path_fallback_total",
            "lambdas that exhausted the KKT repair budget and fell back "
            "to a full-width solve")

    def record_step(self, coordinate: str, solve_s: float, eval_s: float,
                    comm_s: float) -> None:
        self._steps.inc(1, coordinate=coordinate)
        self._solve.observe(solve_s, coordinate=coordinate)
        self._eval.observe(eval_s, coordinate=coordinate)
        self._comm.observe(comm_s, coordinate=coordinate)

    def record_chunk_cache_pass(self, kind: str) -> None:
        c = self._cache.get(kind)
        if c is not None:
            c.inc(1)

    def record_prefetch(self, stall_s: float = 0.0, decode_s: float = 0.0,
                        transfer_s: float = 0.0) -> None:
        self._stall.inc(stall_s)
        self._decode.inc(decode_s)
        self._transfer.inc(transfer_s)

    def record_path_lambda(self, frozen: int, rounds: int, violations: int,
                           full_grad_passes: int, fallback: bool) -> None:
        self._path_lambdas.inc(1)
        self._path_frozen.inc(frozen)
        self._path_rounds.inc(rounds)
        self._path_violations.inc(violations)
        self._path_passes.inc(full_grad_passes)
        if fallback:
            self._path_fallback.inc(1)

    def record_exchange(self, bytes_sent: int, bytes_gathered: int,
                        seconds: float) -> None:
        self._bytes_sent.inc(bytes_sent)
        self._bytes_gathered.inc(bytes_gathered)
        self._rounds.inc(1)
        self._exch_s.inc(seconds)

    def render(self) -> str:
        return self.registry.render()

    def snapshot(self) -> Dict[str, dict]:
        return self.registry.snapshot()


_TRAINING: Optional[TrainingMetrics] = None
_TRAINING_LOCK = threading.Lock()


def training_metrics() -> TrainingMetrics:
    """The process-wide training metrics instance (lazily created; the
    simulated harness's ranks are threads, so they share it — label
    cardinality stays per-coordinate, not per-rank)."""
    global _TRAINING
    if _TRAINING is None:
        with _TRAINING_LOCK:
            if _TRAINING is None:
                _TRAINING = TrainingMetrics()
    return _TRAINING


class ServingMetrics:
    """All serving-side instrumentation in one place.

    Exported series (``photon_serve_`` prefix):
      requests_total / rows_total / shed_total / errors_total — counters;
      shed_queue_full_total / shed_deadline_total — the load-shedding
        split by cause: admission-queue-at-capacity rejections vs
        requests whose deadline expired while still queued (shed_total
        stays the sum, for dashboards that predate the split);
      request_latency_ms / batch_latency_ms — histograms (request latency
        is admission -> response; batch latency is one scoring execution);
      queue_wait_ms / compute_ms — the request-latency split: time a
        request sat in the admission queue waiting for a batch slot vs
        the scoring execution's wall time attributed to the request, so
        the bench's stall accounting and /metrics agree on where time
        goes (queue_wait + compute ~= request_latency per request);
      queue_depth — gauge, current admission-queue occupancy;
      batch_fill_ratio — gauge, rolling mean of rows/max_batch per batch;
      compile_cache_{hits,misses}_total, coeff_cache_{hits,misses,
        evictions}_total — cache counters (hit rates derive from these;
        in the JAX package the compile counters count XLA executable
        cache hits and misses, which eager torch has none of: the port's
        scoring session feeds them its CUDA-graph captures, a miss per
        capture of a new batch shape and a hit per replay);
      swaps_total / swap_latency_ms / active_version_info — the model-
        lifecycle series: hot-swap count, build-to-install latency, and
        a version-labeled info gauge (value constant 1; the label
        carries the active version, the standard prometheus idiom for
        string-valued state);
      gate_{pass,fail}_total — promotion-gate verdicts observed by this
        process (the gate tool and the reload path record here);
      degraded_total{level} — requests served below full fidelity by the
        brownout ladder (level 1 = resident-coefficients-only, level 2 =
        fixed-effect-only margin); zero whenever faults/overload are off;
      deadline_drop_total{stage} — requests dropped because their budget
        expired, labelled by the CHEAPEST stage that caught it
        (admission / queue / pre_compute — never after device compute);
      brownout_level — gauge, the controller's current DEFAULT ladder
        level (0 healthy; raised under sustained queue-wait overload);
      model_staleness_seconds — gauge, how long the live model has been
        serving without a confirmed-fresh registry poll (rises while the
        watcher pins the old version through registry failures);
      membership_epoch — gauge, the entity-affinity membership epoch the
        replica currently serves under (0 = no membership applied);
      membership_{prefetch_entities,prefetch_bytes}_total — the
        rebalance handoff: entities/bytes prefetched into this replica's
        caches+pages when an ownership delta moved them here;
      membership_non_owned_skips_total — paged installs skipped because
        the faulting entity belongs to another replica (it still scores
        correctly through the host LRU path);
      membership_evictions_total — resident paged rows dropped by a
        re-own compaction (``retain_only``) when ownership shrank.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.rows_total = 0
        self.shed_total = 0
        self.shed_queue_full_total = 0
        self.shed_deadline_total = 0
        self.errors_total = 0
        self.batches_total = 0
        self.batch_rows_sum = 0
        self.batch_fill_sum = 0.0
        self.queue_depth = 0
        self.request_latency_ms = Histogram()
        self.batch_latency_ms = Histogram()
        self.queue_wait_ms = Histogram()
        self.compute_ms = Histogram()
        # cache counters are owned here but incremented through the cache
        # objects' stat hooks so the caches stay usable standalone
        self.compile_cache_hits = 0
        self.compile_cache_misses = 0
        self.coeff_cache_hits = 0
        self.coeff_cache_misses = 0
        self.coeff_cache_evictions = 0
        # device-resident paged coefficient table (serve/paged_table.py)
        self.paged_installs = 0
        self.paged_page_evictions = 0
        self.paged_faults = 0
        # model lifecycle (registry/ + ScoringSession.swap)
        self.swaps_total = 0
        self.swap_latency_ms = Histogram()
        self.active_version = ""
        self.gate_pass_total = 0
        self.gate_fail_total = 0
        # brownout ladder + deadline budget accounting (serve/brownout.py,
        # batcher deadline propagation, watcher staleness pinning)
        self.degraded_total: Dict[int, int] = {1: 0, 2: 0}
        self.deadline_drops: Dict[str, int] = {
            "admission": 0, "queue": 0, "pre_compute": 0}
        self.brownout_level = 0
        self.model_staleness_s = 0.0
        # entity-affinity membership (serve/membership.py): the applied
        # epoch plus the rebalance-handoff accounting — prefetched
        # entities/bytes moved per re-own, installs skipped because the
        # entity belongs to another replica, and rows dropped by a
        # paged table's retain_only compaction
        self.membership_epoch = 0
        self.membership_prefetch_entities = 0
        self.membership_prefetch_bytes = 0
        self.membership_non_owned_skips = 0
        self.membership_evictions = 0

    # -- recording sites ---------------------------------------------------
    def record_request(self, rows: int, latency_ms: float,
                       queue_wait_ms: Optional[float] = None,
                       compute_ms: Optional[float] = None) -> None:
        with self._lock:
            self.requests_total += 1
            self.rows_total += rows
            self.request_latency_ms.observe(latency_ms)
            if queue_wait_ms is not None:
                self.queue_wait_ms.observe(queue_wait_ms)
            if compute_ms is not None:
                self.compute_ms.observe(compute_ms)

    def record_shed(self, cause: str = "queue_full") -> None:
        with self._lock:
            self.shed_total += 1
            if cause == "deadline":
                self.shed_deadline_total += 1
            else:
                self.shed_queue_full_total += 1

    def record_error(self) -> None:
        with self._lock:
            self.errors_total += 1

    def record_batch(self, rows: int, max_batch: int,
                     latency_ms: float) -> None:
        with self._lock:
            self.batches_total += 1
            self.batch_rows_sum += rows
            self.batch_fill_sum += rows / max(max_batch, 1)
            self.batch_latency_ms.observe(latency_ms)

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = depth

    def record_compile(self, hit: bool) -> None:
        """A batch shape's executable was reused (``hit``) or built. In
        the port that is a CUDA-graph replay or capture of the scoring
        session; nothing in the training path records here."""
        with self._lock:
            if hit:
                self.compile_cache_hits += 1
            else:
                self.compile_cache_misses += 1

    def record_coeff(self, hits: int = 0, misses: int = 0,
                     evictions: int = 0) -> None:
        with self._lock:
            self.coeff_cache_hits += hits
            self.coeff_cache_misses += misses
            self.coeff_cache_evictions += evictions

    def record_paged(self, installs: int = 0, page_evictions: int = 0,
                     faults: int = 0) -> None:
        with self._lock:
            self.paged_installs += installs
            self.paged_page_evictions += page_evictions
            self.paged_faults += faults

    def set_active_version(self, version: str) -> None:
        with self._lock:
            self.active_version = str(version)

    def record_swap(self, version: str, latency_ms: float) -> None:
        with self._lock:
            self.swaps_total += 1
            self.active_version = str(version)
            self.swap_latency_ms.observe(latency_ms)

    def record_gate(self, passed: bool) -> None:
        with self._lock:
            if passed:
                self.gate_pass_total += 1
            else:
                self.gate_fail_total += 1

    def record_degraded(self, level: int, n: int = 1) -> None:
        """A request was served below full fidelity at ladder ``level``
        (1 = resident-only, 2 = fixed-effect-only). Level 0 is a no-op so
        callers can record unconditionally."""
        if level <= 0:
            return
        with self._lock:
            self.degraded_total[int(level)] = (
                self.degraded_total.get(int(level), 0) + int(n))

    def record_deadline_drop(self, stage: str) -> None:
        """A request's deadline budget expired and it was dropped at
        ``stage`` (admission / queue / pre_compute) — always BEFORE any
        device compute was spent on it."""
        with self._lock:
            self.deadline_drops[stage] = (
                self.deadline_drops.get(stage, 0) + 1)

    def set_brownout_level(self, level: int) -> None:
        with self._lock:
            self.brownout_level = int(level)

    def set_model_staleness(self, seconds: float) -> None:
        with self._lock:
            self.model_staleness_s = float(seconds)

    def set_membership_epoch(self, epoch: int) -> None:
        with self._lock:
            self.membership_epoch = int(epoch)

    def record_membership(self, prefetch_entities: int = 0,
                          prefetch_bytes: int = 0,
                          non_owned_skips: int = 0,
                          evictions: int = 0) -> None:
        """Membership/affinity accounting: a rebalance prefetch landed
        ``prefetch_entities`` rows (``prefetch_bytes`` moved), a paged
        install was skipped for ``non_owned_skips`` entities another
        replica owns, and ``evictions`` resident rows were dropped by a
        re-own compaction."""
        with self._lock:
            self.membership_prefetch_entities += int(prefetch_entities)
            self.membership_prefetch_bytes += int(prefetch_bytes)
            self.membership_non_owned_skips += int(non_owned_skips)
            self.membership_evictions += int(evictions)

    # -- views -------------------------------------------------------------
    @staticmethod
    def _rate(hits: int, misses: int) -> float:
        total = hits + misses
        return hits / total if total else 0.0

    def snapshot(self) -> Dict[str, float]:
        """Flat dict view (tests, bench, logs)."""
        with self._lock:
            return {
                "requests_total": self.requests_total,
                "rows_total": self.rows_total,
                "shed_total": self.shed_total,
                "shed_queue_full_total": self.shed_queue_full_total,
                "shed_deadline_total": self.shed_deadline_total,
                "errors_total": self.errors_total,
                "batches_total": self.batches_total,
                "queue_depth": self.queue_depth,
                "batch_fill_ratio": (self.batch_fill_sum
                                     / max(self.batches_total, 1)),
                "request_latency_p50_ms":
                    self.request_latency_ms.quantile(0.5),
                "request_latency_p99_ms":
                    self.request_latency_ms.quantile(0.99),
                "queue_wait_p50_ms": self.queue_wait_ms.quantile(0.5),
                "queue_wait_p99_ms": self.queue_wait_ms.quantile(0.99),
                "compute_p50_ms": self.compute_ms.quantile(0.5),
                "compute_p99_ms": self.compute_ms.quantile(0.99),
                "compile_cache_hits": self.compile_cache_hits,
                "compile_cache_misses": self.compile_cache_misses,
                "compile_cache_hit_rate": self._rate(
                    self.compile_cache_hits, self.compile_cache_misses),
                "coeff_cache_hits": self.coeff_cache_hits,
                "coeff_cache_misses": self.coeff_cache_misses,
                "coeff_cache_evictions": self.coeff_cache_evictions,
                "paged_installs": self.paged_installs,
                "paged_page_evictions": self.paged_page_evictions,
                "paged_faults": self.paged_faults,
                "coeff_cache_hit_rate": self._rate(
                    self.coeff_cache_hits, self.coeff_cache_misses),
                "swaps_total": self.swaps_total,
                "swap_latency_p50_ms": self.swap_latency_ms.quantile(0.5),
                "active_version": self.active_version,
                "gate_pass_total": self.gate_pass_total,
                "gate_fail_total": self.gate_fail_total,
                "degraded_total": sum(self.degraded_total.values()),
                "degraded_level1_total": self.degraded_total.get(1, 0),
                "degraded_level2_total": self.degraded_total.get(2, 0),
                "deadline_drops_total": sum(self.deadline_drops.values()),
                "deadline_drops_admission":
                    self.deadline_drops.get("admission", 0),
                "deadline_drops_queue": self.deadline_drops.get("queue", 0),
                "deadline_drops_pre_compute":
                    self.deadline_drops.get("pre_compute", 0),
                "brownout_level": self.brownout_level,
                "model_staleness_s": self.model_staleness_s,
                "membership_epoch": self.membership_epoch,
                "membership_prefetch_entities":
                    self.membership_prefetch_entities,
                "membership_prefetch_bytes":
                    self.membership_prefetch_bytes,
                "membership_non_owned_skips":
                    self.membership_non_owned_skips,
                "membership_evictions": self.membership_evictions,
            }

    def render(self) -> str:
        """Prometheus text exposition of every series."""
        with self._lock:
            out: List[str] = []

            def counter(name, v):
                out.append(f"# TYPE {name} counter")
                out.append(f"{name} {_fmt(v)}")

            def gauge(name, v):
                out.append(f"# TYPE {name} gauge")
                out.append(f"{name} {_fmt(v)}")

            counter("photon_serve_requests_total", self.requests_total)
            counter("photon_serve_rows_total", self.rows_total)
            counter("photon_serve_shed_total", self.shed_total)
            counter("photon_serve_shed_queue_full_total",
                    self.shed_queue_full_total)
            counter("photon_serve_shed_deadline_total",
                    self.shed_deadline_total)
            counter("photon_serve_errors_total", self.errors_total)
            counter("photon_serve_batches_total", self.batches_total)
            gauge("photon_serve_queue_depth", self.queue_depth)
            gauge("photon_serve_batch_fill_ratio",
                  self.batch_fill_sum / max(self.batches_total, 1))
            self.request_latency_ms.render(
                "photon_serve_request_latency_ms", out)
            self.batch_latency_ms.render(
                "photon_serve_batch_latency_ms", out)
            self.queue_wait_ms.render("photon_serve_queue_wait_ms", out)
            self.compute_ms.render("photon_serve_compute_ms", out)
            counter("photon_serve_compile_cache_hits_total",
                    self.compile_cache_hits)
            counter("photon_serve_compile_cache_misses_total",
                    self.compile_cache_misses)
            gauge("photon_serve_compile_cache_hit_rate", self._rate(
                self.compile_cache_hits, self.compile_cache_misses))
            counter("photon_serve_coeff_cache_hits_total",
                    self.coeff_cache_hits)
            counter("photon_serve_coeff_cache_misses_total",
                    self.coeff_cache_misses)
            counter("photon_serve_coeff_cache_evictions_total",
                    self.coeff_cache_evictions)
            counter("photon_serve_paged_installs_total",
                    self.paged_installs)
            counter("photon_serve_paged_page_evictions_total",
                    self.paged_page_evictions)
            counter("photon_serve_paged_faults_total", self.paged_faults)
            gauge("photon_serve_coeff_cache_hit_rate", self._rate(
                self.coeff_cache_hits, self.coeff_cache_misses))
            counter("photon_serve_swaps_total", self.swaps_total)
            self.swap_latency_ms.render("photon_serve_swap_latency_ms", out)
            out.append("# TYPE photon_serve_active_version_info gauge")
            label = escape_label_value(self.active_version)
            out.append(
                f'photon_serve_active_version_info{{version="{label}"}} 1')
            counter("photon_serve_gate_pass_total", self.gate_pass_total)
            counter("photon_serve_gate_fail_total", self.gate_fail_total)
            # brownout ladder + deadline budget series: fixed label sets
            # (levels 1..2, the three pre-compute stages) so the golden-
            # fixture byte comparison stays deterministic as counts move
            out.append("# TYPE photon_serve_degraded_total counter")
            for level in sorted(set(self.degraded_total) | {1, 2}):
                out.append(
                    f'photon_serve_degraded_total{{level="{level}"}} '
                    f"{_fmt(self.degraded_total.get(level, 0))}")
            out.append("# TYPE photon_serve_deadline_drop_total counter")
            for stage in ("admission", "queue", "pre_compute"):
                out.append(
                    f'photon_serve_deadline_drop_total{{stage="{stage}"}} '
                    f"{_fmt(self.deadline_drops.get(stage, 0))}")
            for stage in sorted(set(self.deadline_drops)
                                - {"admission", "queue", "pre_compute"}):
                out.append(
                    f'photon_serve_deadline_drop_total{{stage="{stage}"}} '
                    f"{_fmt(self.deadline_drops[stage])}")
            gauge("photon_serve_brownout_level", self.brownout_level)
            gauge("photon_serve_model_staleness_seconds",
                  self.model_staleness_s)
            gauge("photon_serve_membership_epoch", self.membership_epoch)
            counter("photon_serve_membership_prefetch_entities_total",
                    self.membership_prefetch_entities)
            counter("photon_serve_membership_prefetch_bytes_total",
                    self.membership_prefetch_bytes)
            counter("photon_serve_membership_non_owned_skips_total",
                    self.membership_non_owned_skips)
            counter("photon_serve_membership_evictions_total",
                    self.membership_evictions)
            return "\n".join(out) + "\n"
