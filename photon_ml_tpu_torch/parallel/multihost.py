"""Multi-process runtime (counterpart of
``photon_ml_tpu/parallel/multihost.py``).

The JAX package rendezvouses every host into one runtime with
``jax.distributed.initialize``. The port starts one process per device,
and each calls :func:`initialize_multihost`, which joins the default
``torch.distributed`` process group over a TCP rendezvous at the
coordinator's address. On CUDA the group's backend is
``"cpu:gloo,cuda:nccl"``: tensors on the card reduce over NCCL, host
tensors (row-span gathers, summary moments) over gloo. On the CPU it is
``"gloo"``.

Drivers expose it as ``--coordinator-address``, ``--num-processes`` and
``--process-id``. Input splits compose with it: each process reads its
own row range (:func:`process_span`) or block share
(``io.stream_source.AvroChunkSource(process_part=)``), and host vectors
are reassembled in global row order with :func:`allgather_varspans`.
Host arrays cross processes as tensors of their own dtype, so float64
survives every gather bit for bit.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    max_attempts: Optional[int] = None,
    backoff_s: float = 1.0,
    device: Optional[str] = None,
    timeout_s: float = 600.0,
) -> bool:
    """Join this process into the world's default process group. Returns
    False for the single-process no-op (no coordinator and no process
    count given), True once the group is up.

    The rendezvous (the ``multihost.init`` fault site) retries transient
    failures through ``resilience.retry_transient`` with exponential
    backoff, at most ``max_attempts`` times (default 3, or
    ``PHOTON_ML_TPU_INIT_ATTEMPTS``), then raises the last error.
    ``device`` (default ``cuda``) picks the backend and, on CUDA, sets
    this process's current device to ``cuda:{local_rank % device_count}``.
    Either backend carries gloo for host tensors, which the resilience
    transport's status rounds and the entity-shard exchange use.
    ``timeout_s`` bounds the rendezvous and every later collective."""
    from photon_ml_tpu_torch.parallel import fault_injection, resilience
    from photon_ml_tpu_torch.types import resolve_device

    if coordinator_address is None and num_processes is None:
        return False
    if (num_processes is None) != (process_id is None):
        raise ValueError("--num-processes and --process-id go together")
    if coordinator_address is None or num_processes is None:
        raise ValueError("--coordinator-address, --num-processes and "
                         "--process-id go together: nothing here infers "
                         "them from a cluster")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"--process-id {process_id} out of range for "
                         f"--num-processes {num_processes}")
    if max_attempts is None:
        max_attempts = int(os.environ.get("PHOTON_ML_TPU_INIT_ATTEMPTS", 3))
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
        backend = "cpu:gloo,cuda:nccl"
    else:
        backend = "gloo"

    def _rendezvous():
        fault_injection.check("multihost.init")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=timeout_s))

    resilience.retry_transient(_rendezvous,
                               attempts=max(int(max_attempts), 1),
                               backoff_s=backoff_s)
    return True


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _up() else 0


def process_count() -> int:
    """The world size (1 without a process group)."""
    return dist.get_world_size() if _up() else 1


def is_lead() -> bool:
    """True on the process that writes outputs (rank 0)."""
    return process_index() == 0


def _up() -> bool:
    return dist.is_available() and dist.is_initialized()


def span_of(total_rows: int, index: int, count: int) -> Tuple[int, int]:
    """Process ``index``'s [start, stop) slice of a globally ordered
    dataset under near-equal contiguous assignment."""
    base, extra = divmod(total_rows, count)
    start = index * base + min(index, extra)
    return start, start + base + (1 if index < extra else 0)


def process_span(total_rows: int) -> Tuple[int, int]:
    """This process's [start, stop) slice of a globally ordered
    dataset."""
    return span_of(total_rows, process_index(), process_count())


def allgather_host(a, group=None) -> list:
    """Every process's equal-shaped host array (of ``group``, default the
    world), in rank order, gathered as CPU tensors of the array's own
    dtype: bit-preserving."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return [p.numpy() for p in parts]


def allgather_varspans(local, spans: Sequence[Tuple[int, int]]
                       ) -> np.ndarray:
    """Reassemble a globally ordered vector from per-process contiguous
    row spans of any sizes (``spans``: one (start, stop) per process, the
    same on every process), e.g. block-aligned out-of-core parts."""
    local = np.asarray(local)
    p = process_count()
    if p == 1:
        return local
    if len(spans) != p:
        raise ValueError(f"{len(spans)} spans for {p} processes")
    max_len = max(stop - start for start, stop in spans)
    padded = np.zeros((max_len,) + local.shape[1:], local.dtype)
    padded[: len(local)] = local
    gathered = allgather_host(padded)
    return np.concatenate([gathered[i][: stop - start]
                           for i, (start, stop) in enumerate(spans)])


def allgather_spans(local, total_rows: int) -> np.ndarray:
    """Reassemble a globally ordered [total_rows] vector from per-process
    :func:`process_span` slices (each process passes its own slice)."""
    p = process_count()
    return allgather_varspans(local,
                              [span_of(total_rows, i, p) for i in range(p)])


def allreduce_summary_moments(s1, s2, nnz, mx, mn):
    """Reduce the raw per-feature moments of a streamed feature summary
    across processes: sums for the power sums and nonzero counts, max and
    min for the extrema, in rank order. Passed as ``part_reduce`` to
    ``ops.statistics.summarize_features_streamed`` so that every process
    finalizes the same global summary."""
    if process_count() == 1:
        return s1, s2, nnz, mx, mn
    stacked = np.stack([np.asarray(a, np.float64)
                        for a in (s1, s2, nnz, mx, mn)])
    parts = allgather_host(stacked)
    tot = parts[0].copy()
    for p in parts[1:]:
        tot[:3] += p[:3]
        tot[3] = np.maximum(tot[3], p[3])
        tot[4] = np.minimum(tot[4], p[4])
    return tot[0], tot[1], tot[2], tot[3], tot[4]


def runtime_info() -> dict:
    """Process and device topology for logs."""
    cuda = torch.cuda.is_available()
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": torch.cuda.device_count() if cuda else 1,
        "global_devices": process_count(),
        "platform": "cuda" if cuda else "cpu",
        "backend": str(dist.get_backend()) if _up() else None,
    }
