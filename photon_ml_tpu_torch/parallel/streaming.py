"""Streamed (larger-than-device-memory) fixed-effect training (counterpart
of ``photon_ml_tpu/parallel/streaming.py``), one device per process.

The dataset lives in host RAM (or on disk, ``io/stream_source.py``) as
fixed-shape :class:`HostChunk` s. Each optimizer pass streams the chunks
through the device and accumulates (loss, gradient) partials there; only
the outer loop's decisions run on the host.

Host to device, through a pinned prefetch ring (:func:`iter_device_chunks`):
a transfer thread fills one of ``depth + 2`` pinned host buffers per field
with the next chunk, issues its copies on a dedicated copy stream and
records one CUDA event; the consumer makes its compute stream wait on that
event before it touches the chunk and marks the chunk's tensors as used by
the compute stream (``record_stream``), so the caching allocator cannot
hand their memory to a later chunk while a kernel still reads it. A pinned
buffer is refilled only after its last copy has completed. On CPU tensors
the same ring runs with no streams or events.

Each chunk's gradient, Hessian-vector product and Hessian diagonal go
through the column-sorted path of ``parallel/data_parallel.py``: the
chunk's CSC view is built on the device right after it lands (a stable
sort, so it is the same in every pass and every run), and ``X^T d`` goes
through ``sparse_grad``'s apply. ``"auto"`` is ``"csc_kernel"``, the
hand-written ``csc_column_sums``, once per chunk; it sums without
atomics, so a streamed fit does not depend on the prefetch depth or on a
chunk cache. The JAX package differentiates a scatter here instead.

The per-pass partials are Kahan-compensated on the device with eager ops
(the cancellation must not be reassociated). Within a gradient,
Hessian-vector or diagonal pass the host reads nothing; the loop reads the
pass's result once it is complete.

Cost model: the default margin-space L-BFGS pays two sparse passes per
iteration (direction margins, accepted-point gradient); its line-search
trials stream only cached per-row margins (16 B per row for a ladder of 8
step sizes). ``lbfgs_blackbox``, TRON and OWL-QN pay one full pass per
evaluation, as the reference's model does.

Multi-process: when the default process group holds more than one
process, each process streams only its own rows (its ``process_span`` of
an in-RAM dataset, or its ``AvroChunkSource(process_part=)`` share of a
disk-backed one), and each pass's partials, the Kahan pairs included, are
all-gathered over the world and summed in rank order
(:func:`_cross_process_sum`), so that a fit does not depend on the
backend's reduction algorithm and every process ends with the same ``w``.
The JAX package's ``_shard_map_chunk`` has no counterpart: it wrapped the
per-chunk program so that a mesh of several local devices put no
collective into it, and with one process per device each process's chunk
program has no collective to begin with.

Each pass's local work runs inside a ``resilience.CollectiveGuard``
(``stream.fg``, ``stream.hvp``, ``stream.diag``, ``stream.margins``,
``stream.ladder``, as in the reference) that ends before the pass's
cross-process sum: a process whose pass fails reports it at the guard's
health barrier, and every process raises ``PeerFailure`` there instead of
waiting in the sum. One process pays nothing.

The transfer thread adopts the consumer's trace context
(``obs.trace.use_context``), so its ``stream.upload`` spans carry the
fit's trace id, and every fit adds its decode, transfer and stall
seconds to the training metrics' prefetch counters.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from photon_ml_tpu_torch.obs import metrics as obs_metrics
from photon_ml_tpu_torch.obs import trace as obs_trace
from photon_ml_tpu_torch.ops.losses import apply_weights, mask_margins
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optimize.common import (
    OptimizationResult, OptimizerConfig,
)
from photon_ml_tpu_torch.optimize.lbfgs import two_loop_direction
from photon_ml_tpu_torch.optimize.owlqn import pseudo_gradient
from photon_ml_tpu_torch.parallel.data_parallel import (
    _CSC_APPLY, make_csc_diagonal_hessian, make_csc_path, resolve_sparse_grad,
)
from photon_ml_tpu_torch.parallel.multihost import process_count
from photon_ml_tpu_torch.parallel import fault_injection
from photon_ml_tpu_torch.parallel.resilience import (
    CollectiveGuard, current_process_index,
)
from photon_ml_tpu_torch.types import (
    LabeledBatch, SparseFeatures, resolve_device,
)
from photon_ml_tpu_torch.utils import transfer_budget

_log = logging.getLogger("photon_ml_tpu_torch")

# How many chunks the transfer thread may stage ahead of the chunk the
# consumer is computing on. 0 is a synchronous single-thread loop.
DEFAULT_PREFETCH_DEPTH = 2


def resolve_prefetch_depth(depth: Optional[int] = None) -> int:
    """Explicit depth, else ``PHOTON_PREFETCH_DEPTH``, else the default."""
    if depth is None:
        env = os.environ.get("PHOTON_PREFETCH_DEPTH", "")
        depth = int(env) if env else DEFAULT_PREFETCH_DEPTH
    return max(int(depth), 0)


@dataclasses.dataclass
class StreamStats:
    """Host-side pipeline accounting for streamed passes, summed over every
    pass of a fit.

    ``decode_s``: transfer-thread seconds waiting on the chunk source;
    ``transfer_s``: seconds filling pinned buffers and issuing copies;
    ``stall_s``: consumer seconds blocked on an empty ring; ``comm_s``: the
    cross-process reduction of each pass's partials (0 in a single
    process), on CUDA timed by events around the collective on the pass's
    stream, which add no host synchronization and are read once the fit
    has ended (``as_dict``); ``chunks``/``passes``:
    chunks landed and passes streamed (gradient, Hessian-vector, diagonal,
    margin and line-search passes alike); ``kernel_passes``: the passes
    whose every chunk takes ``X^T d`` (gradient, Hessian-vector and
    diagonal passes); ``h2d_bytes``: bytes copied to the device;
    ``host_reads``: blocking device-to-host reads made by the streamed
    loops (pass results, loop decisions, per-chunk margin fetches)."""

    decode_s: float = 0.0
    transfer_s: float = 0.0
    stall_s: float = 0.0
    comm_s: float = 0.0
    chunks: int = 0
    passes: int = 0
    kernel_passes: int = 0
    h2d_bytes: int = 0
    host_reads: int = 0
    comm_events: list = dataclasses.field(default_factory=list, repr=False)

    def as_dict(self) -> dict:
        for start, end in self.comm_events:
            end.synchronize()  # already complete: the fit's last read
            self.comm_s += start.elapsed_time(end) / 1e3
        self.comm_events.clear()
        return {"decode_s": round(self.decode_s, 6),
                "transfer_s": round(self.transfer_s, 6),
                "stall_s": round(self.stall_s, 6),
                "comm_s": round(self.comm_s, 6),
                "chunks": self.chunks, "passes": self.passes,
                "kernel_passes": self.kernel_passes,
                "h2d_bytes": self.h2d_bytes,
                "host_reads": self.host_reads}


# consumer-side ring poll (seconds): each expiry rechecks transfer-thread
# liveness, so a producer that dies without relaying its sentinel fails
# the pass instead of hanging the consumer
_RING_POLL_S = 0.5


def _ring_put(q: queue.Queue, stop: threading.Event, item) -> bool:
    """Stop-aware bounded put (chunks, sentinel and errors alike), so an
    abandoned consumer can never wedge the transfer thread."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


class _Staged:
    """Tensors copied to the device on the ring's copy stream, not yet
    safe to read on the compute stream."""

    __slots__ = ("tensors", "event", "nbytes")

    def __init__(self, tensors: Dict[str, torch.Tensor], event, nbytes: int):
        self.tensors, self.event, self.nbytes = tensors, event, nbytes

    def land(self) -> Dict[str, torch.Tensor]:
        """Order the compute stream after the copies and tie the tensors'
        memory to it; returns the tensors."""
        if self.event is not None:
            dev = next(iter(self.tensors.values())).device
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(stream)
        return self.tensors


class PinnedRing:
    """Host->device staging: ``n_slots`` sets of host buffers (pinned on
    CUDA), filled in rotation. :meth:`put` copies a set of host arrays into
    the next slot, cast to each field's dtype, charges the bytes to the
    transfer budget and starts the copies on the ring's copy stream; a slot
    is refilled only after its previous copies completed (its event)."""

    def __init__(self, device, n_slots: int):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._slots: List[Dict[str, torch.Tensor]] = [
            {} for _ in range(max(int(n_slots), 1))]
        self._events = [None] * len(self._slots)
        self._next = 0
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def put(self, fields: Dict[str, tuple], what: str) -> _Staged:
        """``fields``: name -> (host array, torch dtype)."""
        slot = self._next
        self._next = (slot + 1) % len(self._slots)
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        bufs = self._slots[slot]
        nbytes = 0
        for name, (a, dtype) in fields.items():
            a = np.asarray(a)
            buf = bufs.get(name)
            if buf is None or tuple(buf.shape) != a.shape \
                    or buf.dtype != dtype:
                buf = torch.empty(a.shape, dtype=dtype, pin_memory=self.cuda)
                bufs[name] = buf
            np.copyto(buf.numpy(), a, casting="unsafe")
            nbytes += buf.numel() * buf.element_size()
        transfer_budget.charge(nbytes, what)
        if not self.cuda:
            return _Staged({n: bufs[n].clone() for n in fields}, None, nbytes)
        with torch.cuda.stream(self.stream):
            out = {n: bufs[n].to(self.device, non_blocking=True)
                   for n in fields}
            event = torch.cuda.Event()
            event.record(self.stream)
        self._events[slot] = event
        return _Staged(out, event, nbytes)


def iter_device_chunks(chunks, to_device: Callable,
                       depth: Optional[int] = None,
                       stats: Optional[StreamStats] = None):
    """Yield ``(host_chunk, device_value)`` with the uploads staged ``depth``
    chunks ahead by a dedicated transfer thread.

    ``to_device(chunk)`` runs in the transfer thread (in this thread at
    depth 0); when it returns a :class:`_Staged`, the copies are landed on
    the compute stream here, in the consumer, before the chunk is yielded.
    An exception from the source or the upload is re-raised in the
    consumer; a transfer thread that dies without its end-of-pass sentinel
    fails the pass within the ring's poll interval. The transfer thread
    iterates the source on behalf of the consuming process, so it carries
    that process's index for per-process fault plans."""
    depth = resolve_prefetch_depth(depth)
    if stats is not None:
        stats.passes += 1

    def landed(dev):
        if isinstance(dev, _Staged):
            if stats is not None:
                stats.h2d_bytes += dev.nbytes
            return dev.land()
        return dev

    if depth == 0:
        t_wait = time.perf_counter()
        for chunk in chunks:
            now = time.perf_counter()
            dev = to_device(chunk)
            if stats is not None:
                stats.decode_s += now - t_wait
                stats.transfer_s += time.perf_counter() - now
                stats.chunks += 1
            yield chunk, landed(dev)
            t_wait = time.perf_counter()
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    cuda_dev = None
    if torch.cuda.is_available():
        cuda_dev = torch.cuda.current_device()
    fault_proc = current_process_index()
    tctx = obs_trace.current_context()  # handed off to the ring thread

    def produce():
        with fault_injection.process_context(fault_proc), \
                obs_trace.use_context(tctx):
            produce_chunks()

    def produce_chunks():
        it = iter(chunks)
        try:
            if cuda_dev is not None:
                torch.cuda.set_device(cuda_dev)
            t_wait = time.perf_counter()
            while True:
                try:
                    chunk = next(it)
                except StopIteration:
                    break
                now = time.perf_counter()
                if stop.is_set():
                    return
                with obs_trace.span("stream.upload", cat="stream"):
                    dev = to_device(chunk)
                if stats is not None:
                    stats.decode_s += now - t_wait
                    stats.transfer_s += time.perf_counter() - now
                if not _ring_put(q, stop, (chunk, dev)):
                    return
                t_wait = time.perf_counter()
            _ring_put(q, stop, None)  # end-of-pass sentinel
        except BaseException as e:  # surfaced in the consumer
            _ring_put(q, stop, e)
        finally:
            # close a generator-backed source deterministically, so ITS
            # producer thread winds down with this pass
            close = getattr(it, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=produce, daemon=True, name="stream-transfer")
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            try:
                item = q.get(timeout=_RING_POLL_S)
            except queue.Empty:
                if t.is_alive():
                    if stats is not None:
                        stats.stall_s += time.perf_counter() - t0
                    continue
                try:
                    # the thread may have parked its last item between our
                    # timeout and its exit
                    item = q.get_nowait()
                except queue.Empty:
                    raise RuntimeError(
                        "stream-transfer thread died without delivering "
                        "its end-of-pass sentinel") from None
            if stats is not None:
                stats.stall_s += time.perf_counter() - t0
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            if stats is not None:
                stats.chunks += 1
            chunk, dev = item
            yield chunk, landed(dev)
    finally:
        stop.set()
        t.join(timeout=30)
        if t.is_alive():
            _log.warning(
                "transfer thread %s still alive 30s after the pass ended "
                "(wedged source or upload); leaking it as a daemon", t.name)


@dataclasses.dataclass(frozen=True)
class HostChunk:
    """One fixed-shape chunk resident in host RAM (numpy)."""

    indices: np.ndarray  # [rows, k] int32
    values: Optional[np.ndarray]  # [rows, k]; None = implicit-ones layout
    labels: np.ndarray  # [rows]
    offsets: np.ndarray  # [rows]
    weights: np.ndarray  # [rows]; padding rows have weight 0


def make_host_chunks(
    features,
    labels,
    offsets=None,
    weights=None,
    chunk_rows: int = 1 << 16,
    pad_nnz: Optional[int] = None,
) -> tuple[List[HostChunk], int]:
    """Slice a host dataset into uniform chunks (the last chunk padded with
    zero-weight rows, so every chunk has the same shapes).

    ``features``: HostSparse-like (``indices``/``values``/``dim``) or dense
    [n, d] numpy. Returns (chunks, dim)."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    if offsets is None:
        offsets = np.zeros(n)
    if weights is None:
        weights = np.ones(n)
    offsets = np.asarray(offsets)
    weights = np.asarray(weights)

    if hasattr(features, "indices"):
        indices = np.asarray(features.indices)
        # the implicit-ones layout stays value-free all the way to the
        # device: half the chunk transfer
        values = (None if features.values is None
                  else np.asarray(features.values))
        dim = features.dim
    else:
        dense = np.asarray(features)
        dim = dense.shape[1]
        indices = np.broadcast_to(np.arange(dim, dtype=np.int32),
                                  dense.shape).copy()
        values = dense
    k = indices.shape[1]
    if pad_nnz is not None:
        if pad_nnz < k:
            raise ValueError(f"pad_nnz={pad_nnz} < chunk nnz width {k}")
        if values is None and pad_nnz > k:
            raise ValueError(
                "pad_nnz slot padding is invalid for the implicit-ones "
                "layout (every slot is a real 1.0 feature)")
        pad = pad_nnz - k
        indices = np.pad(indices, ((0, 0), (0, pad)))
        if values is not None:
            values = np.pad(values, ((0, 0), (0, pad)))
        k = pad_nnz

    chunks: List[HostChunk] = []
    for start in range(0, max(n, 1), chunk_rows):
        stop = min(start + chunk_rows, n)
        rows = stop - start
        pad = chunk_rows - rows
        chunks.append(HostChunk(
            indices=np.pad(indices[start:stop], ((0, pad), (0, 0))),
            values=(None if values is None
                    else np.pad(values[start:stop], ((0, pad), (0, 0)))),
            labels=np.pad(labels[start:stop], (0, pad)),
            offsets=np.pad(offsets[start:stop], (0, pad)),
            weights=np.pad(weights[start:stop], (0, pad)),  # pad weight = 0
        ))
    return chunks, dim


def _chunk_to_device(chunk: HostChunk, dtype, ring: PinnedRing) -> _Staged:
    """Stage a chunk's fields through the ring (indices int32, the rest in
    ``dtype``); every streamed upload is budget-accounted after the cast."""
    fields = {"indices": (chunk.indices, torch.int32)}
    if chunk.values is not None:
        fields["values"] = (chunk.values, dtype)
    fields["labels"] = (chunk.labels, dtype)
    fields["offsets"] = (chunk.offsets, dtype)
    fields["weights"] = (chunk.weights, dtype)
    return ring.put(fields, "stream chunk")


def _as_batch(t: Dict[str, torch.Tensor], dim: int) -> LabeledBatch:
    return LabeledBatch(SparseFeatures(t["indices"], t.get("values"), dim),
                        t["labels"], t["offsets"], t["weights"])


def _host_tol(tolerance, dtype) -> float:
    """The streamed host loops' tolerance: an explicit tol <= 0 disables the
    convergence tests (exact iteration counts), a positive tol is clamped to
    a few ulps of the working dtype (``optimize.common.converged_check``)."""
    t = float(np.asarray(tolerance))
    if t <= 0:
        return 0.0
    return max(t, 4 * float(torch.finfo(dtype).eps))


def _kahan_add(acc, comp, x):
    """One compensated (Kahan) accumulation step: returns (acc', comp')
    with acc' - comp' == (acc - comp) + x to within the working precision
    (``comp`` holds the running EXCESS of ``acc`` over the true sum, so
    fold with ``acc - comp``). Eager ops, in this order: the cancellation
    must not be reassociated."""
    y = x - comp
    t = acc + y
    comp = (t - acc) - y
    return t, comp


def _cross_process_sum(pairs, stats: Optional[StreamStats] = None):
    """Fold a pass's Kahan pairs ``[(acc, comp), ...]`` into totals, summed
    across processes.

    Single process: ``acc - comp`` for each pair. Multi-process: every
    process streamed its own rows; the pairs are packed into one buffer,
    all-gathered over the world (``all_gather`` into a list, which NCCL
    and gloo both run on device tensors), and each process's folded part
    is added in rank order with compensation, so every process computes
    the same totals from the same operands. The collective's seconds go
    to ``stats`` (``StreamStats.comm_s``)."""
    if process_count() == 1:
        return [acc - comp for acc, comp in pairs]
    flat = torch.cat([t.reshape(-1) for pair in pairs for t in pair])
    parts = [torch.empty_like(flat) for _ in range(process_count())]
    if flat.is_cuda:
        stream = torch.cuda.current_stream(flat.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        dist.all_gather(parts, flat)
        end.record(stream)
        if stats is not None:
            stats.comm_events.append((start, end))
    else:
        t0 = time.perf_counter()
        dist.all_gather(parts, flat)
        if stats is not None:
            stats.comm_s += time.perf_counter() - t0
    out, at = [], 0
    for acc, _comp in pairs:
        n = acc.numel()
        tot, c = torch.zeros_like(acc), torch.zeros_like(acc)
        for p in parts:
            a = p[at:at + n].reshape(acc.shape)
            ca = p[at + n:at + 2 * n].reshape(acc.shape)
            tot, c = _kahan_add(tot, c, a - ca)
        out.append(tot - c)
        at += 2 * n
    return out


class _Reads:
    """Counts the streamed loops' blocking device-to-host reads."""

    def __init__(self, stats: StreamStats):
        self.stats = stats

    def __call__(self, *xs):
        """One host read of any number of device scalars -> floats."""
        self.stats.host_reads += 1
        if len(xs) == 1:
            return float(xs[0])
        return torch.stack([torch.as_tensor(x, dtype=torch.float64)
                            .to(xs[0].device) for x in xs]).tolist()


class _ChunkOps:
    """Per-chunk device work of one streamed fit: the ring, the chunk's
    CSC view and the ``X^T d`` apply of the resolved ``sparse_grad``."""

    def __init__(self, objective: GLMObjective, dim: int, dtype, device,
                 sparse_grad: str, depth: Optional[int],
                 stats: Optional[StreamStats]):
        self.objective, self.dim, self.dtype = objective, dim, dtype
        self.device = resolve_device(device)
        self.depth = resolve_prefetch_depth(depth)
        self.stats = stats if stats is not None else StreamStats()
        self.mode = resolve_sparse_grad(sparse_grad)
        self.ring = PinnedRing(self.device, self.depth + 2)
        if self.mode in _CSC_APPLY:
            self.build, self.fg, self.hvp = make_csc_path(
                objective, use_kernel=self.mode == "csc_kernel",
                precise=self.mode == "csc_precise",
                segment=self.mode == "csc_segment")
            self.squares, self.diag = make_csc_diagonal_hessian(
                objective, self.mode)
        else:  # "scatter": the objective's own index_add_ products
            self.build = None

    def chunks(self, chunks):
        """One streamed pass: yields (host chunk, device batch, CSC view)."""
        for hc, t in iter_device_chunks(
                chunks, lambda c: _chunk_to_device(c, self.dtype, self.ring),
                self.depth, self.stats):
            batch = _as_batch(t, self.dim)
            yield hc, batch, (None if self.build is None
                              else self.build(batch))

    def chunk_fg(self, w, batch, csc):
        if csc is None:
            return self.objective.value_and_grad(w, batch, 0.0)
        return self.fg(w, batch, csc, 0.0)

    def chunk_hvp(self, w, v, batch, csc):
        if csc is None:
            return self.objective.hvp(w, v, batch, 0.0)
        return self.hvp(w, v, batch, csc, 0.0)

    def chunk_diag(self, w, batch, csc):
        if csc is None:
            return self.objective.diagonal_hessian(w, batch, 0.0)
        return self.diag(w, batch, csc, self.squares(csc), 0.0)

    def zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)


def streaming_value_and_grad(
    objective: GLMObjective,
    chunks: Sequence[HostChunk],
    dim: int,
    dtype=torch.float32,
    prefetch_depth: Optional[int] = None,
    stats: Optional[StreamStats] = None,
    sparse_grad: str = "auto",
    device=None,
    _ops: Optional[_ChunkOps] = None,
) -> Callable:
    """Returns ``fg(w, l2) -> (value, grad)`` computed in ONE streamed pass
    over the chunks: per-chunk partials accumulate on the device (Kahan),
    the transfer thread stages the next ``prefetch_depth`` chunks while the
    current one computes. L2 is added once at the end."""
    ops = _ops or _ChunkOps(objective, dim, dtype, device, sparse_grad,
                            prefetch_depth, stats)

    def fg(w, l2=0.0):
        w = torch.as_tensor(w, dtype=dtype, device=ops.device)
        f_acc, f_comp = ops.zeros(), ops.zeros()
        g_acc, g_comp = ops.zeros(dim), ops.zeros(dim)
        with CollectiveGuard("stream.fg"):
            for _hc, batch, csc in ops.chunks(chunks):
                f, g = ops.chunk_fg(w, batch, csc)
                f_acc, f_comp = _kahan_add(f_acc, f_comp, f)
                g_acc, g_comp = _kahan_add(g_acc, g_comp, g)
        ops.stats.kernel_passes += 1
        f_data, g_data = _cross_process_sum(
            [(f_acc, f_comp), (g_acc, g_comp)], ops.stats)
        wr = objective.reg_mask(w)
        return (f_data + 0.5 * l2 * torch.sum(wr * wr),
                g_data + l2 * wr)

    return fg


def streaming_hvp(
    objective: GLMObjective,
    chunks: Sequence[HostChunk],
    dim: int,
    dtype=torch.float32,
    prefetch_depth: Optional[int] = None,
    stats: Optional[StreamStats] = None,
    sparse_grad: str = "auto",
    device=None,
    _ops: Optional[_ChunkOps] = None,
) -> Callable:
    """Returns ``hvp(w, v, l2)`` computed in one streamed pass (one pass per
    CG step, the reference's cost model)."""
    ops = _ops or _ChunkOps(objective, dim, dtype, device, sparse_grad,
                            prefetch_depth, stats)

    def hvp(w, v, l2=0.0):
        w = torch.as_tensor(w, dtype=dtype, device=ops.device)
        v = torch.as_tensor(v, dtype=dtype, device=ops.device)
        acc, comp = ops.zeros(dim), ops.zeros(dim)
        with CollectiveGuard("stream.hvp"):
            for _hc, batch, csc in ops.chunks(chunks):
                acc, comp = _kahan_add(acc, comp,
                                       ops.chunk_hvp(w, v, batch, csc))
        ops.stats.kernel_passes += 1
        (total,) = _cross_process_sum([(acc, comp)], ops.stats)
        return total + l2 * objective.reg_mask(v)

    return hvp


def streaming_hessian_diagonal(
    objective: GLMObjective,
    chunks: Sequence[HostChunk],
    dim: int,
    w,
    l2=0.0,
    dtype=torch.float32,
    prefetch_depth: Optional[int] = None,
    stats: Optional[StreamStats] = None,
    sparse_grad: str = "auto",
    device=None,
    _ops: Optional[_ChunkOps] = None,
) -> torch.Tensor:
    """Exact Hessian diagonal over one streamed (Kahan-compensated) pass,
    shared by coefficient variances and TRON's Jacobi preconditioner; the
    regularization diagonal is added once at the end."""
    ops = _ops or _ChunkOps(objective, dim, dtype, device, sparse_grad,
                            prefetch_depth, stats)
    w = torch.as_tensor(w, dtype=dtype, device=ops.device)
    acc, comp = ops.zeros(dim), ops.zeros(dim)
    with CollectiveGuard("stream.diag"):
        for _hc, batch, csc in ops.chunks(chunks):
            acc, comp = _kahan_add(acc, comp, ops.chunk_diag(w, batch, csc))
    ops.stats.kernel_passes += 1
    (total,) = _cross_process_sum([(acc, comp)], ops.stats)
    return total + objective.reg_diagonal(total, l2)


def streaming_coefficient_variances(
    objective: GLMObjective,
    chunks: Sequence[HostChunk],
    dim: int,
    w,
    l2=0.0,
    dtype=torch.float32,
    prefetch_depth: Optional[int] = None,
    stats: Optional[StreamStats] = None,
    sparse_grad: str = "auto",
    device=None,
) -> torch.Tensor:
    """Diagonal-inverse-Hessian coefficient variances over a streamed pass
    (the in-memory ``GLMObjective.coefficient_variances``, chunked)."""
    diag = streaming_hessian_diagonal(objective, chunks, dim, w, l2, dtype,
                                      prefetch_depth, stats, sparse_grad,
                                      device)
    return 1.0 / torch.clamp(diag, min=torch.finfo(dtype).tiny)


def fit_streaming(
    objective: GLMObjective,
    chunks: Sequence[HostChunk],
    dim: int,
    w0=None,
    l2=0.0,
    config: OptimizerConfig = OptimizerConfig(),
    dtype=torch.float32,
    optimizer: str = "lbfgs",
    l1=0.0,
    progress_callback: Optional[Callable] = None,
    prefetch_depth: Optional[int] = None,
    sparse_grad: str = "auto",
    device=None,
) -> OptimizationResult:
    """Streamed full-batch fit on ``device`` (default: ``w0``'s device if
    ``w0`` is a tensor, else ``cuda``).

    ``optimizer``: "lbfgs" (default: margin-space line search, see
    :func:`_fit_streaming_lbfgs_margin`), "lbfgs_blackbox" (one full
    streamed pass per Armijo trial), "tron" (one streamed Hessian-vector
    pass per CG step) or "owlqn" (chosen whenever ``l1`` > 0).
    ``progress_callback(iteration, w)`` fires on every iteration that
    accepted a step (every outer iteration for TRON). ``sparse_grad``
    selects each chunk's ``X^T d`` as in ``fit_distributed``: "auto" is
    the kernel's column-sorted path."""
    if optimizer == "auto":
        optimizer = "lbfgs"
    if float(np.asarray(l1)) > 0 and optimizer != "owlqn":
        optimizer = "owlqn"
    if optimizer not in ("lbfgs", "lbfgs_blackbox", "tron", "owlqn"):
        raise ValueError(f"unknown streaming optimizer '{optimizer}'")
    if device is None and isinstance(w0, torch.Tensor):
        device = w0.device
    stats = StreamStats()
    ops = _ChunkOps(objective, dim, dtype, device, sparse_grad,
                    prefetch_depth, stats)
    w = (ops.zeros(dim) if w0 is None
         else torch.as_tensor(w0, dtype=dtype, device=ops.device))
    fit = {"lbfgs": _fit_streaming_lbfgs_margin,
           "lbfgs_blackbox": _fit_streaming_lbfgs_blackbox,
           "tron": _fit_streaming_tron,
           "owlqn": _fit_streaming_owlqn}[optimizer]
    kw = {"l1": l1} if optimizer == "owlqn" else {}
    res = fit(objective, chunks, ops, w, l2, config, progress_callback, **kw)
    return _finish_stream_result(res, stats, optimizer)


def _finish_stream_result(res: OptimizationResult, stats: StreamStats,
                          optimizer: str) -> OptimizationResult:
    """Attach the fit-wide pipeline accounting to the result and log the
    one-line breakdown."""
    _log.info(
        "streamed %s fit: %d passes / %d chunk transfers; decode-wait "
        "%.3fs, transfer %.3fs, compute-stall %.3fs",
        optimizer, stats.passes, stats.chunks, stats.decode_s,
        stats.transfer_s, stats.stall_s)
    # one StreamStats per fit, so the totals are this fit's
    obs_metrics.training_metrics().record_prefetch(
        stall_s=stats.stall_s, decode_s=stats.decode_s,
        transfer_s=stats.transfer_s)
    return res._replace(stream_stats=stats.as_dict(),
                        host_syncs=stats.host_reads)


def _result(w, f, g_norm, it, converged, loss_hist, gnorm_hist, dtype):
    return OptimizationResult(
        w=w, value=torch.as_tensor(f, dtype=dtype, device=w.device),
        grad_norm=g_norm, iterations=int(it), converged=bool(converged),
        loss_history=torch.from_numpy(loss_hist),
        grad_norm_history=torch.from_numpy(gnorm_hist), host_syncs=0)


def _store_pair(s_hist, y_hist, rho, k, m, step, yv, sy):
    slot = k % m
    s_hist[slot] = step
    y_hist[slot] = yv
    rho[slot] = 1.0 / sy


def _fit_streaming_lbfgs_blackbox(objective, chunks, ops, w, l2, config,
                                  progress_callback=None
                                  ) -> OptimizationResult:
    """Streamed L-BFGS with backtracking Armijo, one full streamed pass per
    trial; (s, y) pairs are stored under a curvature guard."""
    m, dim, dtype = config.history, ops.dim, ops.dtype
    read = _Reads(ops.stats)
    fg = streaming_value_and_grad(objective, chunks, dim, dtype, _ops=ops)
    f, g = fg(w, l2)
    g0_norm = read(torch.linalg.norm(g))
    s_hist, y_hist, rho = ops.zeros(m, dim), ops.zeros(m, dim), ops.zeros(m)
    k = 0
    eps = float(torch.finfo(dtype).eps)
    tol = _host_tol(config.tolerance, dtype)
    loss_hist = np.full((config.max_iters,), np.nan)
    gnorm_hist = np.full((config.max_iters,), np.nan)

    it = 0
    converged = False
    for it in range(config.max_iters):
        p = two_loop_direction(g, s_hist, y_hist, rho, k, m)
        dg = read(torch.sum(p * g))
        if dg >= 0:  # degraded metric: steepest descent restart
            p = -g
            dg = -read(torch.sum(g * g))
        alpha = 1.0 if k > 0 else 1.0 / max(g0_norm, 1.0)
        f_cur = read(f)
        accepted = False
        for _ in range(config.max_line_search_steps):
            w_try = w + alpha * p
            f_try, g_try = fg(w_try, l2)
            ft = read(f_try)
            if ft <= f_cur + 1e-4 * alpha * dg and np.isfinite(ft):
                accepted = True
                break
            alpha *= 0.5
        if not accepted:
            # failing AT the optimum is convergence, not a stall; otherwise
            # reset the history and retry once from steepest descent
            gnorm = read(torch.linalg.norm(g))
            loss_hist[it] = f_cur
            gnorm_hist[it] = gnorm
            if tol > 0 and gnorm <= tol * max(g0_norm, 1.0):
                converged = True
                it += 1
                break
            if k > 0:
                s_hist, y_hist = ops.zeros(m, dim), ops.zeros(m, dim)
                rho = ops.zeros(m)
                k = 0
                continue
            it += 1  # the attempted iteration counts
            break

        step = w_try - w
        yv = g_try - g
        sy, n_step, n_y = read(torch.sum(step * yv), torch.linalg.norm(step),
                               torch.linalg.norm(yv))
        if sy > 1e-10 * max(n_step * n_y, eps):
            _store_pair(s_hist, y_hist, rho, k, m, step, yv, sy)
            k += 1
        w, f, g = w_try, f_try, g_try
        fv, gnorm = read(f, torch.linalg.norm(g))
        loss_hist[it] = fv
        gnorm_hist[it] = gnorm
        if progress_callback is not None:
            progress_callback(it, w)
        rel = abs(f_cur - fv) / max(abs(f_cur), 1.0)
        if tol > 0 and (rel <= tol or gnorm <= tol * max(g0_norm, 1.0)):
            converged = True
            it += 1
            break
    else:
        it = config.max_iters

    return _result(w, f, torch.linalg.norm(g), it, converged, loss_hist,
                   gnorm_hist, dtype)


def _fit_streaming_lbfgs_margin(objective, chunks, ops, w, l2, config,
                                progress_callback=None
                                ) -> OptimizationResult:
    """Streamed L-BFGS with a margin-space line search (the default).

    GLM margins are affine in w, so the loop caches each chunk's margin
    vector ``mw`` in HOST RAM and evaluates the backtracking ladder in
    groups of 8 step sizes per stream of (mw, mp, labels, weights), 16
    bytes per row per group, through the same pinned ring. A typical
    iteration is one gather pass (the direction's margins), one
    margin-only ladder stream, and one gather+transpose pass for the
    accepted point's gradient. The L2 term is closed-form along the ray.

    Drift consistency: ``mw`` is updated incrementally on the host and
    drifts slowly from the exact margins of ``w``, so Armijo compares the
    trial against the same cached frame (the per-row loss DIFFERENCES
    ``l(mw + a mp) - l(mw)``), never against the exact ``f`` of the
    gradient pass; exact (f, g) drive the convergence tests and the
    returned histories. Device memory stays bounded by the ring at any
    dataset size: the caches (12 B of scalars and 8 B of margins per row
    in float32) stay on the host."""
    m, dim, dtype, dev = config.history, ops.dim, ops.dtype, ops.device
    read = _Reads(ops.stats)
    fg = streaming_value_and_grad(objective, chunks, dim, dtype, _ops=ops)
    loss = objective.loss
    # ladder group width: this many step sizes per margin-only stream;
    # worst case ceil(max_line_search_steps / L) streams per iteration
    L = min(max(int(config.max_line_search_steps), 1), 8)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    # the host scalar cache, captured during the first streamed pass: for
    # in-RAM chunk lists these are references; for a disk-backed source it
    # makes every ladder stream decode-free
    n_chunks = len(chunks)
    labels_h = [None] * n_chunks
    weights_h = [None] * n_chunks
    offsets_h = [None] * n_chunks
    fetch = [torch.empty(0, dtype=dtype, pin_memory=ops.ring.cuda)
             for _ in range(2)]

    def margins_of(vec, out):
        """One streamed gather pass: per-chunk margins of ``vec`` (offsets
        included) into host numpy ``out``. Chunk i's device->host copy is
        waited for only after chunk i+1 has been dispatched. Guarded
        though the pass has no collective of its own: the peers run the
        same pass, and a process failing here would otherwise leave them
        waiting at the next phase's barrier until the watchdog."""
        with CollectiveGuard("stream.margins"):
            return _margins_pass(vec, out)

    def _margins_pass(vec, out):
        pending = None

        def finish(p):
            i, buf, event = p
            if event is not None:
                event.synchronize()
            ops.stats.host_reads += 1
            out[i] = buf.numpy().copy()

        for i, (chunk, t) in enumerate(iter_device_chunks(
                chunks, lambda c: _chunk_to_device(c, dtype, ops.ring),
                ops.depth, ops.stats)):
            if labels_h[i] is None:
                labels_h[i] = chunk.labels
                weights_h[i] = chunk.weights
                offsets_h[i] = chunk.offsets
            res = objective.margins(vec, _as_batch(t, dim))
            if ops.ring.cuda:
                # chunk i-2's buffer: finished when chunk i-1 was issued
                buf = fetch[i % 2]
                if buf.shape != res.shape:
                    buf = fetch[i % 2] = torch.empty(
                        res.shape, dtype=dtype, pin_memory=True)
                buf.copy_(res, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
            else:
                buf, event = res, None
            if pending is not None:
                finish(pending)
            pending = (i, buf, event)
        if pending is not None:
            finish(pending)
        return out

    def ladder_item(i):
        return {"mw": (mw_h[i], dtype), "mp": (mp_h[i], dtype),
                "labels": (labels_h[i], dtype),
                "weights": (weights_h[i], dtype)}

    def phi_delta_ladder(alphas):
        """[L] data-term deltas f(w + a p) - f(w) for the whole ladder, in
        ONE margin-only streamed pass over the host caches."""
        a = torch.as_tensor(alphas, dtype=dtype, device=dev)[:, None]
        acc, comp = ops.zeros(L), ops.zeros(L)
        with CollectiveGuard("stream.ladder"):
            for _i, t in iter_device_chunks(
                    range(n_chunks),
                    lambda i: ops.ring.put(ladder_item(i),
                                           "margin trial chunk"),
                    ops.depth, ops.stats):
                wts, lab = t["weights"], t["labels"]
                l0 = apply_weights(wts, loss.loss(
                    mask_margins(wts, t["mw"]), lab))
                m1 = mask_margins(wts, t["mw"] + a * t["mp"])
                d = torch.sum(apply_weights(wts, loss.loss(m1, lab)) - l0,
                              dim=1)
                acc, comp = _kahan_add(acc, comp, d)
        (total,) = _cross_process_sum([(acc, comp)], ops.stats)
        ops.stats.host_reads += 1
        return total.cpu().numpy().astype(np.float64)

    f, g = fg(w, l2)
    g0_norm = read(torch.linalg.norm(g))
    mw_h = margins_of(w, [None] * n_chunks)
    mp_h = [None] * n_chunks
    s_hist, y_hist, rho = ops.zeros(m, dim), ops.zeros(m, dim), ops.zeros(m)
    k = 0
    eps = float(torch.finfo(dtype).eps)
    tol = _host_tol(config.tolerance, dtype)
    loss_hist = np.full((config.max_iters,), np.nan)
    gnorm_hist = np.full((config.max_iters,), np.nan)
    l2f = float(np.asarray(l2))

    it = 0
    converged = False
    for it in range(config.max_iters):
        p = two_loop_direction(g, s_hist, y_hist, rho, k, m)
        dg = read(torch.sum(p * g))
        if dg >= 0:  # degraded metric: steepest descent restart
            p = -g
            dg = -read(torch.sum(g * g))
        # ONE gather pass: the direction's margins (offsets subtracted:
        # margins() adds them and they are the affine constant)
        mp_h = margins_of(p, mp_h)
        for i in range(n_chunks):
            mp_h[i] = mp_h[i] - np.asarray(offsets_h[i], np_dtype)
        # L2 delta along the ray: l2 * (a c1 + a^2/2 c2)
        wr = objective.reg_mask(w).to(torch.float64)
        pr = objective.reg_mask(p).to(torch.float64)
        c1, c2, f_cur = read(wr @ pr, pr @ pr, f)

        alpha0 = 1.0 if k > 0 else 1.0 / max(g0_norm, 1.0)
        # delta-space Armijo over ladder groups, one streamed pass each;
        # the first (largest) passing alpha is what sequential
        # backtracking would have taken
        full = alpha0 * 0.5 ** np.arange(config.max_line_search_steps)
        accepted = False
        alpha = 0.0
        for g0 in range(0, len(full), L):
            grp = full[g0:g0 + L]
            if len(grp) < L:  # pad: duplicates of the last alpha are inert
                grp = np.concatenate([grp, np.full(L - len(grp), grp[-1])])
            deltas = (phi_delta_ladder(grp)
                      + l2f * (grp * c1 + 0.5 * grp * grp * c2))
            armijo = (deltas <= 1e-4 * grp * dg) & np.isfinite(deltas)
            if armijo.any():
                accepted = True
                alpha = float(grp[int(np.argmax(armijo))])
                break
        if not accepted:
            gnorm = read(torch.linalg.norm(g))
            loss_hist[it] = f_cur
            gnorm_hist[it] = gnorm
            if tol > 0 and gnorm <= tol * max(g0_norm, 1.0):
                converged = True
                it += 1
                break
            if k > 0:
                s_hist, y_hist = ops.zeros(m, dim), ops.zeros(m, dim)
                rho = ops.zeros(m)
                k = 0
                continue
            it += 1  # the attempted iteration counts
            break

        w_try = w + torch.as_tensor(alpha, dtype=dtype, device=dev) * p
        # accepted point: ONE gather+transpose pass for the exact (f, g)
        f_try, g_try = fg(w_try, l2)
        for i in range(n_chunks):
            mw_h[i] = mw_h[i] + mw_h[i].dtype.type(alpha) * mp_h[i]
        step = w_try - w
        yv = g_try - g
        sy, n_step, n_y = read(torch.sum(step * yv), torch.linalg.norm(step),
                               torch.linalg.norm(yv))
        if sy > 1e-10 * max(n_step * n_y, eps):
            _store_pair(s_hist, y_hist, rho, k, m, step, yv, sy)
            k += 1
        w, f, g = w_try, f_try, g_try
        fv, gnorm = read(f, torch.linalg.norm(g))
        loss_hist[it] = fv
        gnorm_hist[it] = gnorm
        if progress_callback is not None:
            progress_callback(it, w)
        rel = abs(f_cur - fv) / max(abs(f_cur), 1.0)
        if tol > 0 and (rel <= tol or gnorm <= tol * max(g0_norm, 1.0)):
            converged = True
            it += 1
            break
    else:
        it = config.max_iters

    return _result(w, f, torch.linalg.norm(g), it, converged, loss_hist,
                   gnorm_hist, dtype)


# Lin-Moré / LIBLINEAR constants (same as optimize/tron.py)
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0


def _fit_streaming_tron(objective, chunks, ops, w, l2, config,
                        progress_callback=None) -> OptimizationResult:
    """Host-loop TRON mirroring ``optimize.tron``: Jacobi-preconditioned
    Steihaug CG where every Hessian-vector product is one streamed pass,
    and the preconditioner one streamed diagonal pass per accepted step."""
    dim, dtype = ops.dim, ops.dtype
    read = _Reads(ops.stats)
    fg = streaming_value_and_grad(objective, chunks, dim, dtype, _ops=ops)
    hvp = streaming_hvp(objective, chunks, dim, dtype, _ops=ops)
    max_cg = max(dim, 20)
    eps = float(torch.finfo(dtype).eps)

    def cg(wc, g, delta, cg_tol, m_diag):
        """Steihaug CG in the M-norm of the diagonal preconditioner."""
        minv = 1.0 / m_diag

        def mdot(a, b):
            return torch.sum(a * m_diag * b)

        s = torch.zeros_like(g)
        r = -g
        d = minv * r
        rz = read(torch.sum(r * d))
        for _ in range(max_cg):
            Hd = hvp(wc, d, l2)
            dHd = read(torch.sum(d * Hd))
            neg_curv = dHd <= 0
            alpha = rz / (1.0 if neg_curv else dHd)
            sa = s + alpha * d
            outside = np.sqrt(read(mdot(sa, sa))) >= delta
            if neg_curv or outside:
                sd, dd, ss = read(mdot(s, d), mdot(d, d), mdot(s, s))
                disc = np.sqrt(max(sd * sd + dd * (delta * delta - ss), 0.0))
                tau = (-sd + disc) / max(dd, eps)
                s = s + tau * d
                r = r - tau * Hd
                break
            s = sa
            r = r - alpha * Hd
            if read(torch.linalg.norm(r)) <= cg_tol:
                break
            z = minv * r
            rz_new = read(torch.sum(r * z))
            d = z + (rz_new / max(rz, eps)) * d
            rz = rz_new
        return s, r

    f, g = fg(w, l2)
    f, g0_norm = read(f, torch.linalg.norm(g))
    delta = g0_norm
    tol = _host_tol(config.tolerance, dtype)
    loss_hist = np.full((config.max_iters,), np.nan)
    gnorm_hist = np.full((config.max_iters,), np.nan)
    it = 0
    converged = False
    m_diag = None
    gnorm = g0_norm
    for it in range(config.max_iters):
        if m_diag is None:  # recomputed only after an ACCEPTED step
            md = streaming_hessian_diagonal(objective, chunks, dim, w, l2,
                                            dtype, _ops=ops)
            # same relative positivity floor as optimize.tron
            m_diag = torch.clamp(md, min=eps * max(read(torch.max(md)), 1.0))
        step, r = cg(w, g, delta, 0.1 * gnorm, m_diag)
        w_try = w + step
        f_try_t, g_try = fg(w_try, l2)
        f_try, gs, sr, snorm2 = read(f_try_t, torch.sum(g * step),
                                     torch.sum(step * r),
                                     torch.sum(step * m_diag * step))
        prered = 0.5 * (sr - gs)
        actred = f - f_try
        # radius lives in the CG's M-norm
        snorm = float(np.sqrt(snorm2))

        denom = f_try - f - gs
        alpha = _SIGMA3 if denom <= 0 else max(_SIGMA1, -0.5 * (gs / denom))
        if actred < _ETA0 * prered:
            delta = min(max(alpha, _SIGMA1) * snorm, _SIGMA2 * delta)
        elif actred < _ETA1 * prered:
            delta = max(_SIGMA1 * delta, min(alpha * snorm, _SIGMA2 * delta))
        elif actred < _ETA2 * prered:
            delta = max(_SIGMA1 * delta, min(alpha * snorm, _SIGMA3 * delta))
        else:
            delta = max(delta, min(alpha * snorm, _SIGMA3 * delta))

        if actred > _ETA0 * prered:  # accept
            m_diag = None  # w moved: the cached diagonal is stale
            prev_f = f
            w, f, g = w_try, f_try, g_try
            gnorm = read(torch.linalg.norm(g))
            rel = abs(prev_f - f) / max(abs(prev_f), 1.0)
            if tol > 0 and (rel <= tol or gnorm <= tol * max(g0_norm, 1.0)):
                converged = True
        loss_hist[it] = f
        gnorm_hist[it] = gnorm
        if progress_callback is not None:
            # every outer iteration, accepted or not: a rejected step still
            # paid a full CG sequence of streamed passes
            progress_callback(it, w)
        if prered <= eps * max(abs(f), 1.0):  # model predicts no gain left
            converged = True
        if converged or delta < eps * max(read(torch.linalg.norm(w)), 1.0):
            it += 1
            break
    else:
        it = config.max_iters

    return _result(w, f, torch.linalg.norm(g), it, converged, loss_hist,
                   gnorm_hist, dtype)


def _fit_streaming_owlqn(objective, chunks, ops, w, l2, config,
                         progress_callback=None, l1=0.0
                         ) -> OptimizationResult:
    """Host-loop OWL-QN mirroring ``optimize.owlqn`` (Andrew & Gao 2007):
    pseudo-gradient from the streamed smooth gradient, L-BFGS direction,
    orthant projection of direction and iterates; every line-search trial
    is one streamed pass."""
    m, dim, dtype = config.history, ops.dim, ops.dtype
    read = _Reads(ops.stats)
    fg = streaming_value_and_grad(objective, chunks, dim, dtype, _ops=ops)
    mask = ops.zeros(dim) + 1.0
    if objective.intercept_index >= 0 and not objective.regularize_intercept:
        mask[objective.intercept_index] = 0.0
    lam = float(np.asarray(l1)) * mask

    def project_direction(p, pg):
        p = torch.where(p * (-pg) > 0, p, torch.zeros_like(p))
        return torch.where(torch.sum(p * pg) < 0, p, -pg)

    def full_F(f_smooth, w_at, *more):
        """One host read: F = f + |lam w|_1, summed on the host as the
        reference does, plus any further scalars."""
        fs, l1_term, *rest = read(f_smooth,
                                  torch.sum(lam * torch.abs(w_at)), *more)
        return (fs + l1_term, *rest)

    f, g = fg(w, l2)
    (F,) = full_F(f, w)
    pg0_norm = read(torch.linalg.norm(pseudo_gradient(w, g, lam)))
    eps = float(torch.finfo(dtype).eps)
    tol = _host_tol(config.tolerance, dtype)
    s_hist, y_hist, rho = ops.zeros(m, dim), ops.zeros(m, dim), ops.zeros(m)
    k = 0
    loss_hist = np.full((config.max_iters,), np.nan)
    gnorm_hist = np.full((config.max_iters,), np.nan)
    it = 0
    converged = False
    for it in range(config.max_iters):
        pg = pseudo_gradient(w, g, lam)
        p = two_loop_direction(pg, s_hist, y_hist, rho, k, m)
        p = project_direction(p, pg)
        xi = torch.where(w != 0, torch.sign(w), torch.sign(-pg))
        alpha = (1.0 if k > 0
                 else 1.0 / max(read(torch.linalg.norm(pg)), 1.0))
        accepted = False
        for _ in range(config.max_line_search_steps):
            w_try = w + alpha * p
            w_try = torch.where(w_try * xi > 0, w_try,
                                torch.zeros_like(w_try))
            f_try, g_try = fg(w_try, l2)
            F_try, dgtest = full_F(f_try, w_try,
                                   torch.sum(pg * (w_try - w)))
            if F_try <= F + 1e-4 * dgtest and np.isfinite(F_try):
                accepted = True
                break
            alpha *= 0.5
        if not accepted:
            break
        step = w_try - w
        yv = g_try - g
        sy, n_step, n_y = read(torch.sum(step * yv), torch.linalg.norm(step),
                               torch.linalg.norm(yv))
        if sy > 1e-10 * max(n_step * n_y, eps):
            _store_pair(s_hist, y_hist, rho, k, m, step, yv, sy)
            k += 1
        F_prev = F
        w, g, F = w_try, g_try, F_try
        pg_norm = read(torch.linalg.norm(pseudo_gradient(w, g, lam)))
        loss_hist[it] = F
        gnorm_hist[it] = pg_norm
        if progress_callback is not None:
            progress_callback(it, w)
        rel = abs(F_prev - F) / max(abs(F_prev), 1.0)
        if tol > 0 and (rel <= tol or pg_norm <= tol * max(pg0_norm, 1.0)):
            converged = True
            it += 1
            break
    else:
        it = config.max_iters

    return _result(w, F, torch.linalg.norm(pseudo_gradient(w, g, lam)), it,
                   converged, loss_hist, gnorm_hist, dtype)
