"""Device mesh and row sharding over ``torch.distributed`` (counterpart of
``photon_ml_tpu/parallel/mesh.py``).

The JAX package runs one controller over a ``jax.sharding.Mesh`` of local
devices and joins per-shard partial sums with ``lax.psum``. The port runs
PyTorch's multi-controller idiom instead: one process per device, every
process running the same program. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the initialized world
with named axes:

* ``data``: examples (fixed-effect data parallelism);
* ``entity``: random-effect entities.

Each process keeps its own contiguous row block (:func:`shard_batch`) on
its own device (:func:`mesh_device`), and a reduction over an axis is an
``all_reduce`` on that axis's process group (``mesh.get_group(axis)``).
The mesh must cover every process of the world: each process is one
device of it.
"""

from __future__ import annotations

import math
import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from photon_ml_tpu_torch.types import LabeledBatch, SparseFeatures


def make_mesh(axis_sizes: Optional[Mapping[str, int]] = None,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the initialized world, e.g.
    ``make_mesh({"data": 4})`` or ``make_mesh({"data": 2, "entity": 2})``;
    with no sizes, every rank on one ``data`` axis. ``device_type`` is
    ``"cuda"`` unless the caller names ``"cpu"``. Raises when no process
    group is initialized or when the axes do not multiply to the world
    size."""
    from torch.distributed.device_mesh import init_device_mesh

    from photon_ml_tpu_torch.types import resolve_device

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "parallel.multihost.initialize_multihost (or "
            "torch.distributed.init_process_group) first")
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"data": world}
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    for name, size in zip(names, sizes):
        if size < 1:
            raise ValueError(f"mesh axis '{name}' must be >= 1, got {size}")
    total = math.prod(sizes)
    if total > world:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} need {total} ranks, the "
            f"world has {world}: shrink an axis or start more processes")
    if total < world:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} cover {total} of the "
            f"world's {world} ranks: one process per device, so every rank "
            "is a device of the mesh")
    dev_type = resolve_device(device_type).type
    return init_device_mesh(dev_type, sizes, mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    """Number of ranks along ``axis`` (1 when the mesh has no such
    axis)."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return 1
    return int(mesh.size(names.index(axis)))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 when the mesh has no such
    axis)."""
    if axis not in (mesh.mesh_dim_names or ()):
        return 0
    return int(mesh.get_local_rank(axis))


def mesh_device(mesh) -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}`` on a CUDA
    mesh (so several ranks may share one card), else the CPU."""
    if mesh.device_type != "cuda":
        return torch.device(mesh.device_type)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def all_reduce_sum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum ``t`` over ``axis`` in place (every rank ends with the same
    values) and return it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return t


def pad_rows(batch: LabeledBatch, rows: int) -> LabeledBatch:
    """Pad to ``rows`` rows with weight-0 rows of label 1.0 (finite
    logistic and Poisson losses at any margin); implicit-ones features
    stay value-free, their padding slots neutralized by the zero
    weights."""
    pad = rows - batch.num_examples
    if pad == 0:
        return batch

    def pad0(a, fill=0.0):
        tail = torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                          device=a.device)
        return torch.cat([a, tail])

    feats = batch.features
    if isinstance(feats, SparseFeatures):
        feats = SparseFeatures(
            pad0(feats.indices),
            None if feats.values is None else pad0(feats.values),
            feats.dim)
    else:
        feats = pad0(feats)
    return LabeledBatch(feats, pad0(batch.labels, 1.0), pad0(batch.offsets),
                        pad0(batch.weights))


def pad_batch(batch: LabeledBatch, multiple: int) -> LabeledBatch:
    """Pad rows to a multiple of ``multiple`` with weight-0 rows, which are
    exact no-ops under the sum-semantics objective."""
    n = batch.num_examples
    return pad_rows(batch, -(-n // multiple) * multiple)


def shard_rows(n: int, mesh, axis: str = "data"):
    """``(start, rows)`` of this rank's block when ``n`` rows are padded to
    a multiple of the axis size and cut into equal contiguous blocks."""
    size = axis_size(mesh, axis)
    rows = -(-n // size)
    return axis_index(mesh, axis) * rows, rows


def shard_batch(batch: LabeledBatch, mesh,
                axis: str = "data") -> LabeledBatch:
    """This rank's block of a batch that every rank holds whole: the rows
    padded to a multiple of the axis size (:func:`pad_batch`), cut into
    equal contiguous blocks, this rank's block placed on this rank's
    device. Only the block is copied and padded."""
    start, rows = shard_rows(batch.num_examples, mesh, axis)
    stop = min(start + rows, batch.num_examples)
    block = batch.slice_rows(start, max(stop - start, 0))
    block = _to(block, mesh_device(mesh))
    return pad_rows(block, rows)


def _to(batch: LabeledBatch, dev: torch.device) -> LabeledBatch:
    feats = batch.features
    if isinstance(feats, SparseFeatures):
        feats = SparseFeatures(
            feats.indices.to(dev),
            None if feats.values is None else feats.values.to(dev),
            feats.dim)
    else:
        feats = feats.to(dev)
    return LabeledBatch(feats, batch.labels.to(dev), batch.offsets.to(dev),
                        batch.weights.to(dev))


def replicate(x: torch.Tensor, mesh) -> torch.Tensor:
    """A copy of ``x`` on this rank's device holding rank 0's values
    (broadcast over the mesh's world)."""
    out = x.detach().to(mesh_device(mesh), copy=True)
    dist.broadcast(out, src=0)
    return out
