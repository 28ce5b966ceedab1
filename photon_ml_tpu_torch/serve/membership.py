"""Entity-affinity membership for the serving tier (counterpart of
``photon_ml_tpu/serve/membership.py``; host-only, the same code over the
port's ``parallel.entity_shard``).

Training partitions entities with a stable-hash owner map
(``parallel/entity_shard.py``: splitmix64 for integer id dtypes, FNV-1a
64 otherwise), and recovery can re-own a lost rank's entities over the
survivors. This module is the serving twin: the SAME owner map,
computed over a replica set instead of a process grid, so that

* the front door routes a request's rows to the replica that OWNS their
  entities (each replica's paged table and LRU then hold only its slice
  — aggregate resident entities scale linearly with replicas instead of
  every replica paging the whole universe), and
* a membership change (replica join/leave/crash, breaker open) re-owns
  entities exactly the way training rank loss does: recompute the map
  over the survivors, hand the *moved* slice to its new owners, carry
  on.

Three pieces, one per side of the wire:

* :class:`MembershipEpoch` — the immutable versioned value both sides
  agree on: ``(epoch, replicas, id_kind)``. The replica tuple is sorted,
  and a replica's position IS its shard index, so
  ``EntityShardSpec(num_shards=len(replicas), shard_index=i)`` on the
  training side and ``epoch.owner_of`` here land every entity id on the
  same index (the train/serve parity test pins this for int and string
  id dtypes — the FNV-vs-splitmix edge lives in
  :func:`~photon_ml_tpu_torch.parallel.entity_shard.serving_owner_of`).
* :class:`MembershipManager` — the front door's side: holds the current
  committed epoch, tracks the recently-routed hot entity ids (bounded),
  proposes a successor epoch when the live replica set changes, and
  computes which hot ids MOVE under the successor — the bounded handoff
  the rebalance prefetch walks into the new owners' paged tables before
  the epoch commits.
* :class:`MembershipView` — the replica's side: the latest epoch applied
  through ``POST /admin/membership`` (monotonic; stale epochs are
  refused), answering the one question the session asks per cold fault:
  "do I own this entity?".

The transport (epoch broadcast, prefetch push, failover routing) is the
async front door's (``serve/aserver.py``); everything here is pure state +
arithmetic so it is testable without sockets (plain mutexes, no lock
nesting, no threads).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.parallel.entity_shard import serving_owner_of

__all__ = ["MembershipEpoch", "MembershipManager", "MembershipView"]

_ID_KINDS = ("auto", "int", "str")


@dataclasses.dataclass(frozen=True)
class MembershipEpoch:
    """One versioned (replica set + owner map) value.

    ``replicas`` is the sorted tuple of replica addresses; a replica's
    position in it is its shard index, so the owner map is fully
    determined by the tuple — no separate assignment table to drift out
    of sync. ``epoch`` is monotonically increasing across proposals;
    replicas refuse to apply a stale one.
    """

    epoch: int
    replicas: Tuple[str, ...]
    id_kind: str = "auto"

    def __post_init__(self):
        if self.epoch < 1:
            raise ValueError(f"epoch must be >= 1, got {self.epoch}")
        if not self.replicas:
            raise ValueError("an epoch needs at least one replica")
        if tuple(sorted(set(self.replicas))) != self.replicas:
            raise ValueError(
                f"replicas must be sorted and unique, got "
                f"{self.replicas!r}")
        if self.id_kind not in _ID_KINDS:
            raise ValueError(f"unknown id_kind {self.id_kind!r}")

    @property
    def num_shards(self) -> int:
        return len(self.replicas)

    def owner_of(self, entity_ids) -> np.ndarray:
        """int64 owning-replica index per entity id (the training-side
        ``EntityShardSpec.owner_of`` map over this replica set)."""
        return serving_owner_of(entity_ids, self.num_shards, self.id_kind)

    def owner_index(self, entity_id) -> int:
        return int(self.owner_of([entity_id])[0])

    def owner_address(self, entity_id) -> str:
        return self.replicas[self.owner_index(entity_id)]

    def payload(self, self_index: int,
                prefetch_entity_ids: Optional[Sequence[str]] = None
                ) -> dict:
        """The ``POST /admin/membership`` body for replica
        ``self_index``, optionally carrying the moved entity ids that
        replica must prefetch before the epoch commits."""
        body = {"epoch": self.epoch, "replicas": list(self.replicas),
                "selfIndex": int(self_index), "idKind": self.id_kind}
        if prefetch_entity_ids:
            body["prefetchEntityIds"] = list(prefetch_entity_ids)
        return body

    @classmethod
    def from_payload(cls, payload: dict) -> "MembershipEpoch":
        return cls(epoch=int(payload["epoch"]),
                   replicas=tuple(sorted(set(
                       str(r) for r in payload["replicas"]))),
                   id_kind=str(payload.get("idKind", "auto")))


class MembershipManager:
    """The front door's membership state: current committed epoch, the
    hot-id tracker, and the propose/moved/commit arithmetic. Transport-
    free by design (the front door owns the sockets)."""

    def __init__(self, replicas: Sequence[str], id_kind: str = "auto",
                 hot_track: int = 4096):
        if hot_track < 1:
            raise ValueError(f"hot_track must be >= 1, got {hot_track}")
        self._lock = threading.Lock()
        self._current = MembershipEpoch(
            1, tuple(sorted(set(str(r) for r in replicas))), id_kind)
        self._next_epoch = 2
        # recently-routed entity ids, insertion-ordered and bounded: the
        # candidate set for the rebalance prefetch. Bounded because the
        # handoff must be bounded — a join/leave moves at most this many
        # ids eagerly; colder entities fault through the LRU as always.
        self._hot: "OrderedDict[str, None]" = OrderedDict()
        self.hot_track = int(hot_track)

    @property
    def epoch(self) -> MembershipEpoch:
        with self._lock:
            return self._current

    def note_routed(self, entity_id: str) -> None:
        """Record a routed entity id into the bounded hot tracker."""
        key = str(entity_id)
        with self._lock:
            self._hot[key] = None
            self._hot.move_to_end(key)
            while len(self._hot) > self.hot_track:
                self._hot.popitem(last=False)

    def hot_ids(self) -> List[str]:
        with self._lock:
            return list(self._hot)

    def propose(self, replicas: Sequence[str]
                ) -> Optional[MembershipEpoch]:
        """The successor epoch over ``replicas``, or None when the set
        is unchanged from the committed epoch. Proposing does NOT
        commit — the caller pushes the epoch (and the moved-id
        prefetch) to every member first, then :meth:`commit`\\s."""
        members = tuple(sorted(set(str(r) for r in replicas)))
        with self._lock:
            if members == self._current.replicas:
                return None
            return MembershipEpoch(self._next_epoch, members,
                                   self._current.id_kind)

    def moved_ids(self, new: MembershipEpoch) -> Dict[int, List[str]]:
        """Hot entity ids whose owner CHANGES from the committed epoch
        to ``new``, grouped by their NEW owner's shard index — the
        bounded handoff set the rebalance prefetch walks. Ids whose
        owner is unchanged are never touched (their pages stay warm
        where they are)."""
        with self._lock:
            cur = self._current
            ids = list(self._hot)
        if not ids:
            return {}
        old_addr = [cur.replicas[i] for i in cur.owner_of(ids)]
        new_owner = new.owner_of(ids)
        moved: Dict[int, List[str]] = {}
        for eid, old_a, new_i in zip(ids, old_addr, new_owner):
            if new.replicas[int(new_i)] != old_a:
                moved.setdefault(int(new_i), []).append(eid)
        return moved

    def commit(self, new: MembershipEpoch) -> bool:
        """Install a proposed epoch (monotonic: a concurrent commit of
        a NEWER epoch wins and this one is dropped). Returns whether
        the epoch was installed."""
        with self._lock:
            if new.epoch <= self._current.epoch:
                return False
            self._current = new
            self._next_epoch = new.epoch + 1
            return True


class _Applied(object):
    """Immutable replica-side membership snapshot (swapped atomically)."""

    __slots__ = ("epoch", "num_shards", "shard_index", "id_kind")

    def __init__(self, epoch: int, num_shards: int, shard_index: int,
                 id_kind: str):
        self.epoch = int(epoch)
        self.num_shards = int(num_shards)
        self.shard_index = int(shard_index)
        self.id_kind = str(id_kind)


_NO_MEMBERSHIP = _Applied(0, 1, 0, "auto")


class MembershipView:
    """The membership a replica currently serves under. Starts inactive
    (epoch 0: the replica owns everything, pre-membership behavior is
    byte-identical to a non-affinity deployment); ``apply`` installs a
    newer epoch and refuses stale ones."""

    def __init__(self):
        self._lock = threading.Lock()
        self._applied = _NO_MEMBERSHIP

    def apply(self, epoch: int, num_shards: int, shard_index: int,
              id_kind: str = "auto") -> bool:
        """Install an epoch. Returns False (and changes nothing) when
        ``epoch`` is not newer than the applied one — the front door's
        broadcasts are monotonic, so a stale apply means a delayed or
        replayed message, never a legitimate rollback."""
        if num_shards < 1 or not 0 <= shard_index < num_shards:
            raise ValueError(
                f"shard_index must be in [0, {num_shards}), got "
                f"{shard_index}")
        if id_kind not in _ID_KINDS:
            raise ValueError(f"unknown id_kind {id_kind!r}")
        with self._lock:
            if int(epoch) <= self._applied.epoch:
                return False
            self._applied = _Applied(epoch, num_shards, shard_index,
                                     id_kind)
            return True

    @property
    def epoch(self) -> int:
        return self._applied.epoch

    @property
    def num_shards(self) -> int:
        return self._applied.num_shards

    @property
    def shard_index(self) -> int:
        return self._applied.shard_index

    @property
    def id_kind(self) -> str:
        return self._applied.id_kind

    @property
    def active(self) -> bool:
        """True when a real partition applies (an applied epoch with
        more than one shard) — with one shard (or pre-membership) the
        replica owns every entity and nothing is gated."""
        a = self._applied
        return a.epoch > 0 and a.num_shards > 1

    def owned_many(self, entity_ids) -> List[bool]:
        """Per-id ownership under the applied epoch (all-True when
        inactive)."""
        ids = list(entity_ids)
        a = self._applied
        if a.epoch <= 0 or a.num_shards <= 1 or not ids:
            return [True] * len(ids)
        owners = serving_owner_of(ids, a.num_shards, a.id_kind)
        return [int(o) == a.shard_index for o in owners]

    def owned(self, entity_id) -> bool:
        return self.owned_many([entity_id])[0]

    def describe(self) -> dict:
        a = self._applied
        return {"epoch": a.epoch, "numShards": a.num_shards,
                "shardIndex": a.shard_index, "idKind": a.id_kind}
