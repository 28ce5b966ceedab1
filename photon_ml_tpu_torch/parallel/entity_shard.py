"""Entity-sharded random-effect tables: owner map + delta-only exchange
(counterpart of ``photon_ml_tpu/parallel/entity_shard.py``; the owner map
is bit-equal to the reference's, so both packages put an entity on the
same shard).

Single-controller GAME training replicates every random-effect
coordinate's full entity table on every process, so entity count — the
dimension the paper's mixed-effect models exist to scale — is bounded by
one host's RAM. This module makes the table a *partitioned* structure:

* **Owner map** (:class:`EntityShardSpec`): every entity id hashes to
  exactly one shard through a process-stable hash (splitmix64 for integer
  ids, FNV-1a 64 over the utf-8 string form otherwise — the same
  stability rationale as ``io.hashing``: Python's ``hash`` is
  per-process randomized and unusable for a cross-process partition).
  Process ``i`` of an ``N``-process job owns shard ``i``: it builds only
  its owned entities' buckets (``game/data.build_random_effect_data``)
  and solves them purely locally (the PR-5 active-set path).

* **Delta-only exchange** (:func:`exchange_score_updates`): the ONLY
  thing the shared fixed-effect residual needs from a random-effect
  coordinate is its per-row score vector, and each row belongs to
  exactly one entity, hence exactly one shard. After a local solve each
  shard publishes just the rows whose score *bitwise changed* since its
  last publish; the allgathered union scatter-overwrites every process's
  copy of the coordinate's global score vector. Coefficients and entity
  tables never cross the wire during training — this is the
  communication-efficient structure of distributed block CD
  (arXiv:1611.02101) with the changed-row set bounding the payload the
  way one-shot/surrogate aggregation bounds it (arXiv:2001.06194). The
  one full-table gather happens at *save points* only
  (:func:`allgather_objects`, used by ``descent._build_model``) so
  checkpoints and the saved model keep the single-file ``io/model_io``
  layout and serving/registry are unchanged.

* **Failure semantics**: every exchange is a collective boundary, so it
  follows the PR-1 contract — a health barrier runs *before* the payload
  gather (a peer that failed since the last barrier surfaces as
  ``PeerFailure`` instead of wedging the gather), the
  ``entity_shard.exchange`` fault-injection site makes the path
  exercisable in tier-1, and the surrounding ``CollectiveGuard`` in
  ``game/descent.py`` coordinates aborts at the sweep boundary.

* **Transport**: the simulated multi-process harness
  (``testing.run_simulated_processes``) exchanges payload objects
  directly through its rendezvous; a real ``torch.distributed`` world
  allgathers the pickled payload as CPU uint8 tensors over gloo
  (bit-preserving), lengths first, then the payload in bounded chunks so
  one giant message can never monopolize the interconnect.

Every exchange records the reference's ``exchange.barrier`` and
``exchange.allgather`` spans (``cat="collective"``, the ``site`` label
``obs.trace_cli merge`` aligns ranks on) and the training metrics'
exchange counters. The reference's determinism-replay hooks
(``analysis.sanitizers.deterministic_replay``) are ROADMAP item 20b.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import struct
import time
from typing import List, Optional, Sequence

import numpy as np

import torch

from photon_ml_tpu_torch.obs import metrics as obs_metrics
from photon_ml_tpu_torch.obs import trace as obs_trace
from photon_ml_tpu_torch.parallel import fault_injection
from photon_ml_tpu_torch.parallel.resilience import (
    _gather_host,
    collective_site,
    current_transport,
    default_timeout,
    health_barrier,
)

__all__ = [
    "EntityShardSpec", "EntityTableBudgetError", "ShardCommStats",
    "stable_entity_hash", "serving_owner_of", "check_table_budget",
    "exchange_score_updates", "allgather_objects", "allgather_blobs",
]

_U64 = (1 << 64) - 1

# One payload-allgather message is at most this many bytes on the real
# multi-controller transport; longer payloads gather in multiple rounds
# (every process computes the same round count from the gathered lengths,
# so the rounds stay SPMD-aligned). Env-overridable for tuning.
_EXCHANGE_CHUNK_BYTES = int(os.environ.get(
    "PHOTON_SHARD_EXCHANGE_CHUNK_BYTES", 4 << 20))


def stable_entity_hash(entity_ids) -> np.ndarray:
    """uint64 hash per entity id, identical on every process.

    Integer ids mix through a vectorized splitmix64 finalizer (the same
    family as ``game.data.SketchProjection``); any other dtype hashes
    FNV-1a 64 over the utf-8 of ``str(id)`` (``io.hashing.fnv1a_64``).
    The owner map is defined over the *training data's* id dtype — a
    dataset must present each entity column with one consistent dtype
    across processes (it does: every process reads the same files)."""
    ids = np.asarray(entity_ids)
    if ids.dtype.kind in "iu":
        x = ids.astype(np.uint64)
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(_U64)
        x = ((x ^ (x >> np.uint64(30)))
             * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(_U64)
        x = ((x ^ (x >> np.uint64(27)))
             * np.uint64(0x94D049BB133111EB)) & np.uint64(_U64)
        return x ^ (x >> np.uint64(31))
    from photon_ml_tpu_torch.io.hashing import fnv1a_64

    return np.fromiter(
        (fnv1a_64(str(e).encode("utf-8")) for e in ids.ravel()),
        np.uint64, ids.size).reshape(ids.shape)


def _int_like(entity_id) -> bool:
    """True when a SERVING-side id (JSON string or number) would have
    presented as an integer dtype to the training reader: a python int
    (bools excluded — they are a different training dtype story and a
    malformed id anyway) or a base-10 integer string, within int64 range
    (a wider value cannot live in an int64 training column, so the
    training side would have carried it as a string and hashed FNV)."""
    if isinstance(entity_id, bool):
        return False
    if isinstance(entity_id, (int, np.integer)):
        return -(1 << 63) <= int(entity_id) < (1 << 63)
    if isinstance(entity_id, str):
        s = entity_id
        if s.startswith("-"):
            s = s[1:]
        if not s or not s.isdigit() or len(s) > 19:
            return False
        return -(1 << 63) <= int(entity_id) < (1 << 63)
    return False


def serving_owner_of(entity_ids, num_shards: int,
                     id_kind: str = "auto") -> np.ndarray:
    """int64 owning-shard index per SERVING-side entity id — the same
    map :meth:`EntityShardSpec.owner_of` computes over the training
    data's arrays, re-derived from the wire form (JSON strings/numbers)
    a scoring request carries.

    The dtype edge this guards: :func:`stable_entity_hash` mixes integer
    dtypes through splitmix64 and everything else through FNV-1a 64 over
    ``str(id)``, so ``123`` and ``"123"`` hash DIFFERENTLY. ``id_kind``
    says which dtype the training data presented:

    * ``"int"`` — the id column trained as an integer dtype; string ids
      parse base-10 (a non-numeric id raises, surfacing the config
      error instead of silently forking the owner map);
    * ``"str"`` — the column trained as strings, so ``"123"`` hashes
      FNV even though it looks numeric;
    * ``"auto"`` — decide PER ID: integer-looking ids (see
      :func:`_int_like`) hash as int64, the rest as strings. Per-id,
      not per-batch, so one odd id in a request cannot move every other
      row's owner.
    """
    if id_kind not in ("auto", "int", "str"):
        raise ValueError(f"unknown id_kind {id_kind!r} "
                         "(expected auto|int|str)")
    ids = list(entity_ids)
    n = np.uint64(num_shards)
    out = np.empty(len(ids), np.int64)
    if not ids:
        return out
    if id_kind == "int":
        arr = np.asarray([int(e) for e in ids], np.int64)
        return (stable_entity_hash(arr) % n).astype(np.int64)
    if id_kind == "str":
        arr = np.asarray([str(e) for e in ids])
        return (stable_entity_hash(arr) % n).astype(np.int64)
    mask = np.asarray([_int_like(e) for e in ids], bool)
    if mask.any():
        arr = np.asarray([int(e) for e, m in zip(ids, mask) if m],
                         np.int64)
        out[mask] = (stable_entity_hash(arr) % n).astype(np.int64)
    if not mask.all():
        arr = np.asarray([str(e) for e, m in zip(ids, mask) if not m])
        out[~mask] = (stable_entity_hash(arr) % n).astype(np.int64)
    return out


@dataclasses.dataclass(frozen=True)
class EntityShardSpec:
    """This process's slice of the entity partition: shard
    ``shard_index`` of ``num_shards``. ``num_shards == 1`` is the
    degenerate single-owner map (no exchange runs)."""

    num_shards: int
    shard_index: int

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got "
                             f"{self.num_shards}")
        if not 0 <= self.shard_index < self.num_shards:
            raise ValueError(
                f"shard_index must be in [0, {self.num_shards}), got "
                f"{self.shard_index}")

    @property
    def active(self) -> bool:
        return self.num_shards > 1

    def owner_of(self, entity_ids) -> np.ndarray:
        """int64 owning-shard index per entity id."""
        return (stable_entity_hash(entity_ids)
                % np.uint64(self.num_shards)).astype(np.int64)

    def owned_mask(self, entity_ids) -> np.ndarray:
        """Boolean mask of the entities THIS shard owns. The masks across
        all ``num_shards`` shard indices partition any id set exactly."""
        return self.owner_of(entity_ids) == self.shard_index


class EntityTableBudgetError(RuntimeError):
    """A random-effect coordinate's local entity table exceeds the
    configured per-process memory budget."""


def check_table_budget(table_bytes: int, budget_bytes: Optional[int], *,
                       coordinate: str, num_shards: int = 1) -> None:
    """Fail fast (before any sweep runs) when a coordinate's local entity
    table is over the per-process budget, pointing at the fix: shard the
    entities across more processes instead of silently exhausting RAM."""
    if budget_bytes is None or table_bytes <= budget_bytes:
        return
    raise EntityTableBudgetError(
        f"random-effect coordinate '{coordinate}': local entity table is "
        f"{table_bytes} bytes, over the {budget_bytes}-byte per-process "
        f"budget (currently {num_shards} entity shard"
        f"{'s' if num_shards != 1 else ''}); raise --entity-shards / run "
        "more controller processes so each owns a smaller slice")


@dataclasses.dataclass
class ShardCommStats:
    """Cross-shard communication accounting for one training run.

    ``bytes_sent`` is this process's published payload bytes;
    ``bytes_gathered`` sums every shard's payloads per exchange (what
    actually crossed the wire, fleet-wide); ``seconds`` is wall time in
    the exchange (barrier + gather + scatter) — surfaced per sweep as
    ``comm_seconds``/``comm_bytes`` in the CD history, next to the PR-4
    ``solve_seconds``/``eval_seconds`` split."""

    bytes_sent: int = 0
    bytes_gathered: int = 0
    exchanges: int = 0
    seconds: float = 0.0

    def as_dict(self) -> dict:
        return {"bytes_sent": self.bytes_sent,
                "bytes_gathered": self.bytes_gathered,
                "exchanges": self.exchanges,
                "seconds": round(self.seconds, 6)}


# -- transport: bounded blob allgather --------------------------------------
def allgather_blobs(blob: bytes, *, timeout: Optional[float] = None
                    ) -> List[bytes]:
    """Allgather one bytes payload per process, in rank order.

    Single-process: identity. Simulated transport (a thread endpoint with
    ``allgather_payload``): direct object rendezvous. A real
    ``torch.distributed`` world: CPU ``all_gather`` rounds over gloo —
    lengths first (int64), then the zero-padded uint8 payload in
    ``_EXCHANGE_CHUNK_BYTES`` batches, cut back to each length, so the
    bytes come back exactly as they went in."""
    tp = current_transport()
    p = tp.process_count()
    if p == 1:
        return [bytes(blob)]
    timeout = timeout if timeout is not None else default_timeout()
    gather = getattr(tp, "allgather_payload", None)
    if gather is not None:
        return [bytes(b) for b in gather(bytes(blob), timeout)]
    local = torch.from_numpy(np.frombuffer(bytes(blob), np.uint8).copy())
    lens = _gather_host(torch.tensor([local.numel()], dtype=torch.int64))
    lens = [int(x) for x in lens]
    max_len = max(lens)
    parts: List[List[torch.Tensor]] = [[] for _ in range(p)]
    for start in range(0, max_len, _EXCHANGE_CHUNK_BYTES):
        stop = min(start + _EXCHANGE_CHUNK_BYTES, max_len)
        seg = torch.zeros(stop - start, dtype=torch.uint8)
        have = local[start:stop]
        seg[: have.numel()] = have
        got = _gather_host(seg).reshape(p, stop - start)
        for i in range(p):
            parts[i].append(got[i])
    return [
        (torch.cat(parts[i])[: lens[i]].numpy().tobytes()
         if parts[i] else b"")
        for i in range(p)
    ]


def _pack_arrays(arrays: Sequence[np.ndarray]) -> bytes:
    """Length-prefixed header (dtypes + shapes) followed by the raw
    buffers — a fixed, version-free wire form for the score exchange."""
    head = []
    bufs = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        head.append((a.dtype.str, a.shape))
        bufs.append(a.tobytes())
    hdr = pickle.dumps(head, protocol=pickle.HIGHEST_PROTOCOL)
    return struct.pack("<I", len(hdr)) + hdr + b"".join(bufs)


def _unpack_arrays(blob: bytes) -> List[np.ndarray]:
    (hlen,) = struct.unpack_from("<I", blob, 0)
    head = pickle.loads(blob[4:4 + hlen])
    out = []
    off = 4 + hlen
    for dtype_str, shape in head:
        dt = np.dtype(dtype_str)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        out.append(np.frombuffer(blob, dt, count=n, offset=off)
                   .reshape(shape))
        off += n * dt.itemsize
    return out


def _guarded_gather(blob: bytes, *, tag: str,
                    stats: Optional[ShardCommStats],
                    timeout: Optional[float]) -> List[bytes]:
    """The shared collective body: fault site, pre-gather health barrier
    (a peer that failed before this boundary aborts everyone instead of
    wedging the payload gather), then the blob allgather — with the
    bytes/seconds accounting."""
    t0 = time.perf_counter()
    fault_injection.check("entity_shard.exchange")
    tp = current_transport()
    if tp.process_count() > 1:
        with obs_trace.span("exchange.barrier", cat="collective",
                            site=f"barrier:{tag}"):
            health_barrier(f"entity_shard.exchange:{tag}", timeout=timeout)
    with obs_trace.span("exchange.allgather", cat="collective",
                        site=tag, bytes_sent=len(blob)):
        with collective_site(tag):
            blobs = allgather_blobs(blob, timeout=timeout)
    if stats is not None:
        stats.exchanges += 1
        stats.bytes_sent += len(blob)
        stats.bytes_gathered += sum(len(b) for b in blobs)
        stats.seconds += time.perf_counter() - t0
        obs_metrics.training_metrics().record_exchange(
            len(blob), sum(len(b) for b in blobs),
            time.perf_counter() - t0)
    return blobs


def exchange_score_updates(arrays: Sequence[np.ndarray], *, tag: str,
                           stats: Optional[ShardCommStats] = None,
                           timeout: Optional[float] = None
                           ) -> List[List[np.ndarray]]:
    """Allgather one batch of changed-row score updates (any fixed tuple
    of numpy arrays — the CD loop sends ``(rows, vals, val_rows,
    val_vals)``). Returns every shard's arrays, rank-ordered. Row sets
    are disjoint across shards (one owner per entity), so callers can
    scatter them in any order and land on the bit-identical global
    vector the single-host loop would have computed."""
    blobs = _guarded_gather(_pack_arrays(arrays), tag=tag, stats=stats,
                            timeout=timeout)
    return [_unpack_arrays(b) for b in blobs]


def allgather_objects(obj, *, tag: str,
                      stats: Optional[ShardCommStats] = None,
                      timeout: Optional[float] = None) -> list:
    """Allgather one picklable object per process, rank-ordered — the
    save-point full-table gather (``descent._build_model`` merges every
    shard's buckets through this so the saved model keeps the
    single-file layout). This is deliberately NOT used per sweep; the
    whole point of the delta exchange is that coefficients cross the
    wire only here."""
    blobs = _guarded_gather(
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL),
        tag=tag, stats=stats, timeout=timeout)
    return [pickle.loads(b) for b in blobs]
