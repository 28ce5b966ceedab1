"""GAME random-effect data layer: entity grouping, active/passive split,
per-entity feature-subspace projection, and size-bucketing into padded
arrays (a copy of ``photon_ml_tpu/game/data.py``, which is numpy-only; the
one difference is that :func:`host_sparse_from_features` takes the port's
torch ``SparseFeatures`` and tensors on any device).

Equivalent of the reference's ``data.{RandomEffectDataset, LocalDataset,
RandomEffectDatasetPartitioner}`` + ``projector.LinearSubspaceProjector``
(SURVEY.md §3.2; reference mount empty). The reference groups samples by
entity id into an RDD of per-entity local datasets; each entity's features
are projected onto the subspace it has actually seen. Rebuilt here as:

* entities are *bucketed by size* and padded to per-bucket shapes
  ``[E, N, k]`` so the per-entity solves run batched per bucket with
  static shapes (SURVEY.md §7 "ragged entity data" hard part);
* **active** data (up to ``active_cap`` rows per entity, seeded random
  subset) trains the entity model; **passive** rows only receive scores —
  via a *score view* built over any dataset with the training-time
  projections (``build_score_view``);
* projections are built from active data, so features first seen in passive
  or validation rows contribute zero score, matching the projector
  semantics.

This is host-side preprocessing (the reference does it as a Spark shuffle
stage); it runs in vectorized numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.types import SparseFeatures


@dataclasses.dataclass(frozen=True)
class HostSparse:
    """Host-side padded sparse matrix (numpy twin of SparseFeatures)."""

    indices: np.ndarray  # [n, k] int32
    values: Optional[np.ndarray]  # [n, k]; None = implicit-ones layout
    dim: int

    @property
    def num_rows(self) -> int:
        return self.indices.shape[0]


def host_sparse_from_dense(X: np.ndarray) -> HostSparse:
    n, d = X.shape
    k = max(int((X != 0).sum(axis=1).max()) if n else 0, 1)
    indices = np.zeros((n, k), np.int32)
    values = np.zeros((n, k))
    for i in range(n):
        nz = np.nonzero(X[i])[0]
        indices[i, : len(nz)] = nz
        values[i, : len(nz)] = X[i, nz]
    return HostSparse(indices, values, d)


def materialize_ones(sp: HostSparse) -> HostSparse:
    """Give an implicit-ones HostSparse explicit 1.0 values. Per-entity
    subspace remapping carries explicit values through the local views, so
    the random-effect data layer materializes here (same footprint the
    caller would have paid with an explicit-values layout); fixed-effect
    paths stay value-free end to end."""
    if sp.values is None:
        return HostSparse(sp.indices, np.ones(sp.indices.shape), sp.dim)
    return sp


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def host_sparse_from_features(features) -> HostSparse:
    """Accept SparseFeatures / HostSparse / a dense numpy array or tensor."""
    if isinstance(features, HostSparse):
        return features
    if isinstance(features, SparseFeatures):
        return HostSparse(
            _host(features.indices),
            None if features.values is None else _host(features.values),
            features.dim,
        )
    return host_sparse_from_dense(_host(features))


@dataclasses.dataclass(frozen=True)
class REBucket:
    """One size bucket of entities, padded to common shapes.

    Training arrays (active data):
      indices/values: [E, N, k] local-subspace sparse rows (pad value 0).
      labels/weights: [E, N] (pad weight 0).
      sample_idx: int32 [E, N] row index into the source dataset, -1 pad.
    Projection:
      projection: int32 [E, D] global feature id per local slot, -1 pad.
      local_maps: per-entity dict global id -> local slot (host side, reused
        to build score views for other datasets).
    """

    entity_ids: Sequence
    indices: np.ndarray
    values: np.ndarray
    labels: np.ndarray
    weights: np.ndarray
    sample_idx: np.ndarray
    projection: np.ndarray
    local_maps: List[Dict[int, int]]

    @property
    def num_entities(self) -> int:
        return len(self.entity_ids)

    @property
    def local_dim(self) -> int:
        return self.projection.shape[1]


_U64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SketchProjection:
    """Count-sketch random projection: global feature id → (slot, ±1).

    The reference's older random-projection projector (SURVEY.md §3.2
    ``projector`` row, marked ``(?)``) for random effects whose entity
    feature spaces are too wide for exact subspace maps: every entity of the
    effect shares one signed hash into a fixed ``dim``-wide space, so entity
    problems have constant shape regardless of support size. Mixing is a
    splitmix64-style finalizer — stable across processes (the same reason
    ``io.hashing`` avoids Python's ``hash``)."""

    dim: int
    seed: int = 0

    def slots_signs(self, gids: np.ndarray):
        x = np.asarray(gids, np.uint64) + np.uint64(
            (self.seed * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) & _U64
        )
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9) & _U64
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB) & _U64
        x = x ^ (x >> np.uint64(31))
        slots = (x % np.uint64(self.dim)).astype(np.int64)
        signs = 1.0 - 2.0 * ((x >> np.uint64(32)) & np.uint64(1)).astype(np.float64)
        return slots, signs


def _local_map_arrays(lm: Dict[int, int]):
    """Sorted global ids + their local slots, for vectorized remapping."""
    if not lm:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    gids = np.fromiter(lm.keys(), np.int64, len(lm))
    slots = np.fromiter(lm.values(), np.int64, len(lm))
    order = np.argsort(gids)
    return gids[order], slots[order]


def _remap_to_local(row_idx: np.ndarray, row_val: np.ndarray, lm):
    """Map global feature ids to entity-local slots in one vectorized pass
    (np.searchsorted); entries outside the local map are zeroed (projector
    semantics: their coefficient is structurally 0). ``lm`` is either a
    global-id→slot dict (subspace projector) or a SketchProjection."""
    if isinstance(lm, SketchProjection):
        slots, signs = lm.slots_signs(row_idx)
        present = row_val != 0
        loc = np.where(present, slots, 0).astype(row_idx.dtype)
        val = np.where(present, row_val * signs, 0.0)
        return loc, val
    gids, slots = _local_map_arrays(lm)
    if len(gids) == 0:
        return np.zeros_like(row_idx), np.zeros_like(row_val)
    pos = np.searchsorted(gids, row_idx)
    pos = np.minimum(pos, len(gids) - 1)
    known = (gids[pos] == row_idx) & (row_val != 0)
    loc = np.where(known, slots[pos], 0).astype(row_idx.dtype)
    val = np.where(known, row_val, 0.0)
    return loc, val


@dataclasses.dataclass(frozen=True)
class REScoreBucket:
    """Score view of one bucket over some dataset: every row of every entity
    (active + passive), features projected to the entity's local subspace."""

    indices: np.ndarray  # [E, M, k] local
    values: np.ndarray  # [E, M, k]
    sample_idx: np.ndarray  # [E, M], -1 pad


@dataclasses.dataclass(frozen=True)
class RandomEffectTrainData:
    effect_name: str
    buckets: List[REBucket]
    num_samples: int  # rows in the source dataset
    # entity id -> (bucket, row) for score-view building
    entity_to_slot: Dict

    @property
    def num_entities(self) -> int:
        return sum(b.num_entities for b in self.buckets)

    def table_bytes(self) -> int:
        """Host bytes of the padded per-entity training arrays — the
        memory the entity sharding bounds per process (score views and
        coefficients scale with the same entity slice)."""
        total = 0
        for b in self.buckets:
            for a in (b.indices, b.values, b.labels, b.weights,
                      b.sample_idx, b.projection):
                total += np.asarray(a).nbytes
        return total


def build_random_effect_data(
    features,
    labels: np.ndarray,
    weights: np.ndarray,
    entity_ids: Sequence,
    effect_name: str = "random",
    num_buckets: int = 4,
    active_cap: Optional[int] = None,
    seed: int = 0,
    projection: str = "subspace",
    projection_dim: Optional[int] = None,
    projection_seed: int = 0,
    entity_shard=None,
) -> RandomEffectTrainData:
    """Group rows by entity, split active/passive, project, bucket, pad.

    ``projection``: "subspace" builds exact per-entity feature maps (the
    LinearSubspaceProjector role); "random" uses a shared count-sketch of
    width ``projection_dim`` (the RandomProjection role — constant-shape
    entity problems, non-invertible).

    ``entity_shard`` (a ``parallel.entity_shard.EntityShardSpec``):
    entity-sharded multi-controller training — this process grooms and
    buckets ONLY the entities its shard owns (stable-hash owner map);
    rows of unowned entities never enter a bucket or score view, so the
    per-process entity-table footprint is the owned slice. Note that
    ``active_cap`` sampling draws from one sequential rng stream, so a
    sharded run's sampled subsets differ from the single-host run's
    (full-data training — no cap — is bit-compatible across shard
    counts)."""
    sp = materialize_ones(host_sparse_from_features(features))
    labels = np.asarray(labels, np.float64)
    weights = np.asarray(weights, np.float64)
    n = sp.num_rows
    ent = np.asarray(entity_ids)
    uniq, codes = np.unique(ent, return_inverse=True)
    rng = np.random.default_rng(seed)

    # rows per entity (stable order)
    order = np.argsort(codes, kind="mergesort")
    sorted_codes = codes[order]
    boundaries = np.searchsorted(sorted_codes, np.arange(len(uniq) + 1))

    if entity_shard is not None and entity_shard.num_shards > 1:
        keep = np.flatnonzero(entity_shard.owned_mask(uniq))
    else:
        keep = np.arange(len(uniq))

    active_rows: List[np.ndarray] = []
    for e in keep:
        rows = order[boundaries[e] : boundaries[e + 1]]
        if active_cap is not None and len(rows) > active_cap:
            rows = rng.choice(rows, size=active_cap, replace=False)
            rows.sort()
        active_rows.append(rows)
    uniq = uniq[keep]

    # per-entity local feature maps from active data
    if projection == "random":
        if not projection_dim or projection_dim <= 0:
            raise ValueError("projection='random' needs a positive "
                             "projection_dim")
        sketch = SketchProjection(projection_dim, projection_seed)
        local_maps = [sketch] * len(uniq)
    elif projection == "subspace":
        local_maps = []
        for e in range(len(uniq)):
            rows = active_rows[e]
            feats = sp.indices[rows][sp.values[rows] != 0]
            ids = np.unique(feats)
            local_maps.append({int(g): i for i, g in enumerate(ids)})
    else:
        raise ValueError(f"unknown projection '{projection}' "
                         "(subspace|random)")

    # bucket entities by active-row count
    counts = np.array([len(r) for r in active_rows])
    ent_order = np.argsort(counts, kind="mergesort")
    num_buckets = max(1, min(num_buckets, len(uniq)))
    splits = np.array_split(ent_order, num_buckets)
    splits = [s for s in splits if len(s)]

    buckets: List[REBucket] = []
    entity_to_slot: Dict = {}
    for b, members in enumerate(splits):
        E = len(members)
        N = max(int(counts[members].max()), 1)
        if projection == "random":
            D = projection_dim
        else:
            D = max(max(len(local_maps[e]) for e in members), 1)
        k = sp.indices.shape[1]
        indices = np.zeros((E, N, k), np.int32)
        values = np.zeros((E, N, k))
        lab = np.zeros((E, N))
        wts = np.zeros((E, N))
        sidx = np.full((E, N), -1, np.int32)
        proj = np.full((E, D), -1, np.int32)
        eids = []
        for r, e in enumerate(members):
            rows = active_rows[e]
            m = len(rows)
            lm = local_maps[e]
            loc, row_val = _remap_to_local(sp.indices[rows], sp.values[rows], lm)
            indices[r, :m] = loc
            values[r, :m] = row_val
            lab[r, :m] = labels[rows]
            wts[r, :m] = weights[rows]
            sidx[r, :m] = rows
            if not isinstance(lm, SketchProjection):
                for gid, slot in lm.items():
                    proj[r, slot] = gid
            eids.append(uniq[e])
            entity_to_slot[uniq[e]] = (b, r)
        buckets.append(
            REBucket(eids, indices, values, lab, wts, sidx, proj,
                     [local_maps[e] for e in members])
        )
    return RandomEffectTrainData(effect_name, buckets, n, entity_to_slot)


def group_rows_by_slot(entity_ids, entity_to_slot, num_entities_per_bucket):
    """Group dataset row indices by (bucket, entity-row). Rows of unknown
    entities are dropped (they get no random-effect score)."""
    per_bucket_rows: List[List[List[int]]] = [
        [[] for _ in range(e)] for e in num_entities_per_bucket
    ]
    for i, eid in enumerate(np.asarray(entity_ids)):
        slot = entity_to_slot.get(eid)
        if slot is None:
            slot = entity_to_slot.get(str(eid))
        if slot is None:
            continue
        b, r = slot
        per_bucket_rows[b][r].append(i)
    return per_bucket_rows


def build_score_buckets(
    sp: HostSparse,
    per_bucket_rows: List[List[List[int]]],
    local_maps_per_bucket: List[List[Dict[int, int]]],
) -> List[REScoreBucket]:
    """Shared score-view construction: project rows onto each entity's local
    subspace (single code path for train-data views and model-based views)."""
    sp = materialize_ones(sp)
    out: List[REScoreBucket] = []
    for rows_per_entity, local_maps in zip(per_bucket_rows, local_maps_per_bucket):
        E = len(rows_per_entity)
        M = max(max((len(r) for r in rows_per_entity), default=0), 1)
        k = sp.indices.shape[1]
        indices = np.zeros((E, M, k), np.int32)
        values = np.zeros((E, M, k))
        sidx = np.full((E, M), -1, np.int32)
        for r in range(E):
            rows = rows_per_entity[r]
            if not rows:
                continue
            loc, rval = _remap_to_local(sp.indices[rows], sp.values[rows],
                                        local_maps[r])
            indices[r, : len(rows)] = loc
            values[r, : len(rows)] = rval
            sidx[r, : len(rows)] = rows
        out.append(REScoreBucket(indices, values, sidx))
    return out


def build_score_view(
    train_data: RandomEffectTrainData, features, entity_ids: Sequence
) -> List[REScoreBucket]:
    """Project any dataset onto the training-time entity subspaces for
    device-side scoring. Rows of entities unseen in training contribute no
    score; features outside an entity's subspace are dropped (their
    coefficient is structurally zero — projector semantics)."""
    sp = host_sparse_from_features(features)
    per_bucket_rows = group_rows_by_slot(
        entity_ids, train_data.entity_to_slot,
        [b.num_entities for b in train_data.buckets],
    )
    return build_score_buckets(
        sp, per_bucket_rows, [b.local_maps for b in train_data.buckets]
    )
