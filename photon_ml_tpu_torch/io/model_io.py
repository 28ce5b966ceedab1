"""GAME model save/load as Avro (the model persistence contract; counterpart
of ``photon_ml_tpu/io/model_io.py`` with the same on-disk layout, so a model
saved by either package loads and scores the same in the other).

Equivalent of the reference's ``data.avro.ModelProcessingUtils``
(SURVEY.md §3.3/§4.1; reference mount empty): a GAME model is saved as one
``BayesianLinearModelAvro`` per fixed effect plus one per entity in each
random effect, with coefficients as name/term/value records resolved through
the feature index maps; loading reverses the mapping. Layout:

    <dir>/metadata.json                    (task, coordinate order/types)
    <dir>/fixed-effect/<name>/coefficients.avro
    <dir>/random-effect/<name>/coefficients.avro

Coefficient name/term resolution uses the shard's index map; saving also
persists the index maps so a model directory is self-contained. Saving
takes the port's model containers (torch tensors on any device, or numpy
arrays) and writes numpy values; loading gives fixed-effect coefficients as
float64 tensors on ``device`` (default ``cuda``) and random-effect buckets
as host numpy arrays, as the JAX loader keeps them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu_torch.io.index_map import IndexMap
from photon_ml_tpu_torch.io.schemas import (
    BAYESIAN_LINEAR_MODEL_SCHEMA,
    split_feature_key,
)
from photon_ml_tpu_torch.models import (
    Coefficients,
    FixedEffectModel,
    GameModel,
    GeneralizedLinearModel,
    RandomEffectBucket,
    RandomEffectModel,
)
from photon_ml_tpu_torch.parallel import fault_injection
from photon_ml_tpu_torch.types import resolve_device


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _sketch_records(w: np.ndarray):
    w = np.asarray(w)
    return [{"name": f"(SKETCH {j})", "term": "", "value": float(w[j])}
            for j in np.nonzero(w)[0]]


def _model_index_of(imap, name: str, term: str):
    """Model-load index resolution: lets backends recognize synthetic
    coefficient names they wrote (e.g. HashingIndexMap's ``(HASH n)``)
    without exposing that aliasing to data ingestion."""
    fn = getattr(imap, "model_index_of", None)
    return fn(name, term) if fn is not None else imap.index_of(name, term)


def _coef_records(w: np.ndarray, inverse: Dict[int, str]):
    idx = np.nonzero(w)[0]
    return _sparse_coef_records(idx, w[idx], inverse)


def _sparse_coef_records(idx: np.ndarray, vals: np.ndarray,
                         inverse: Dict[int, str]):
    """Records of the nonzero ``vals`` at feature ids ``idx`` (ascending),
    as :func:`_coef_records` gives for the dense vector."""
    keep = vals != 0
    return [{"name": name, "term": term, "value": float(v)}
            for (name, term), v in zip(
                (split_feature_key(inverse[int(i)]) for i in idx[keep]),
                vals[keep])]


def _entity_records(proj_row: np.ndarray, values_row: np.ndarray,
                    inverse: Dict[int, str]):
    """One entity's coefficient records over its subspace: the valid slots
    in ascending feature id, as the dense vector's nonzeros would come."""
    valid = proj_row >= 0
    gids = proj_row[valid]
    order = np.argsort(gids, kind="stable")
    return _sparse_coef_records(gids[order], values_row[valid][order],
                                inverse)


def save_game_model(
    model: GameModel,
    directory: str,
    index_maps: IndexMap | Dict[str, IndexMap],
) -> None:
    """Atomic for fresh paths: the tree is written into a sibling tmp dir
    and renamed into place, so a crash mid-save (device loss during the
    d2h reads, SIGKILL) can never leave a half-written model where
    resume/scoring would find it. Overwrites swap via two renames; a
    crash in that window leaves the previous COMPLETE tree at
    '{path}.old-{pid}', which checkpoint discovery counts as its base
    name (game_training_driver._latest_checkpoint).

    Entity-sharded training (docs/sharding.md) keeps this single-file
    layout unchanged: ``descent._build_model`` gathers every shard's
    random-effect buckets into the full table at each save point, so the
    ``model`` every process hands here is already complete — only the
    lead process should actually call this (shared output path), which
    the drivers enforce."""
    import shutil

    tmp = f"{directory}.tmp-{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    try:
        _save_game_model_tree(model, tmp, index_maps)
    except BaseException:
        # an interrupted save must leave NOTHING a loader, the registry,
        # or checkpoint discovery could ingest — not even the tmp tree
        # (a crash that skips this unwind leaves only a '.tmp-' name,
        # which every consumer already ignores)
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.isdir(directory):  # overwrite: swap out the old tree
        old = f"{directory}.old-{os.getpid()}"
        os.rename(directory, old)
        os.rename(tmp, directory)
        shutil.rmtree(old)
    else:
        os.rename(tmp, directory)


def _save_game_model_tree(
    model: GameModel,
    directory: str,
    index_maps: IndexMap | Dict[str, IndexMap],
) -> None:
    if not isinstance(index_maps, dict):  # any IndexMap-like backend
        index_maps = {"global": index_maps}
    os.makedirs(directory, exist_ok=True)
    meta = {"task": model.task, "coordinates": []}
    for name, coord in model.coordinates.items():
        # injection site: a crash mid-save (device loss during the
        # device-to-host reads, SIGKILL); no half-written tree is ever
        # visible at the final path
        fault_injection.check("model_io.save_coordinate")
        imap = index_maps[coord.feature_shard]
        inverse = imap.inverse()
        if isinstance(coord, FixedEffectModel):
            sub = os.path.join(directory, "fixed-effect", name)
            os.makedirs(sub, exist_ok=True)
            w = _host(coord.model.coefficients.means)
            var = coord.model.coefficients.variances
            rec = {
                "modelId": name,
                "modelClass": "FixedEffectModel",
                "means": _coef_records(w, inverse),
                "variances": None if var is None else _coef_records(
                    _host(var), inverse
                ),
                "lossFunction": model.task,
            }
            write_avro_file(os.path.join(sub, "coefficients.avro"), [rec],
                            BAYESIAN_LINEAR_MODEL_SCHEMA)
            meta["coordinates"].append(
                {"name": name, "type": "fixed", "feature_shard": coord.feature_shard}
            )
        else:
            sub = os.path.join(directory, "random-effect", name)
            os.makedirs(sub, exist_ok=True)

            def records():
                for bucket in coord.buckets:
                    proj = _host(bucket.projection)
                    coefs = _host(bucket.coefficients)
                    variances = (
                        None if bucket.variances is None else _host(bucket.variances)
                    )
                    for r, eid in enumerate(bucket.entity_ids):
                        if bucket.sketch is not None:
                            # sketched space is non-invertible: save per-slot
                            # coefficients under synthetic (SKETCH j) names
                            rec = {
                                "modelId": str(eid),
                                "modelClass": "RandomEffectModel",
                                "means": _sketch_records(coefs[r]),
                                "variances": None if variances is None
                                else _sketch_records(variances[r]),
                                "lossFunction": model.task,
                            }
                            yield rec
                            continue
                        yield {
                            "modelId": str(eid),
                            "modelClass": "RandomEffectModel",
                            "means": _entity_records(proj[r], coefs[r],
                                                     inverse),
                            "variances": (
                                None if variances is None else
                                _entity_records(proj[r], variances[r],
                                                inverse)),
                            "lossFunction": model.task,
                        }

            write_avro_file(os.path.join(sub, "coefficients.avro"), records(),
                            BAYESIAN_LINEAR_MODEL_SCHEMA)
            entry = {"name": name, "type": "random",
                     "feature_shard": coord.feature_shard,
                     "entity_column": coord.entity_column}
            sketches = [b.sketch for b in coord.buckets if b.sketch is not None]
            if sketches:
                entry["projection"] = {"type": "random",
                                       "dim": sketches[0].dim,
                                       "seed": sketches[0].seed}
            meta["coordinates"].append(entry)
        # persist the shard's index map alongside the model
        imap.save(os.path.join(directory, f"index-map.{coord.feature_shard}.json"))
    # last write wins: metadata.json is the completeness marker loaders
    # look for, so it lands only after every coefficient file
    fault_injection.check("model_io.save_metadata")
    with open(os.path.join(directory, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_model_metadata(directory: str) -> dict:
    """The model directory's ``metadata.json`` payload (task + coordinate
    order/types) — shared by :func:`load_game_model` and the serving
    session, which loads coordinates selectively."""
    with open(os.path.join(directory, "metadata.json")) as f:
        return json.load(f)


def load_model_index_map(directory: str, shard: str):
    """Open one shard's persisted index map (either backend — JSON or the
    native paldb-style store) from a saved model directory."""
    from photon_ml_tpu_torch.io.paldb import load_index_map

    return load_index_map(os.path.join(directory, f"index-map.{shard}.json"))


def read_random_effect_records(directory: str, name: str):
    """All BayesianLinearModelAvro records of one random-effect coordinate
    (one record per entity). The serving coefficient cache reads through
    this so its decode can never diverge from :func:`load_game_model`."""
    path = os.path.join(directory, "random-effect", name,
                        "coefficients.avro")
    records, _ = read_avro_file(path)
    return records


def entity_support_from_record(rec, imap: IndexMap):
    """Parse ONE RandomEffectModel record into its (sorted global feature
    ids, matching coefficient values) support — the per-entity payload the
    bulk rebuild and the serving entity-coefficient cache share. Sorting
    ascending fixes the local-slot order, so a cache entry's slot map is
    identical to the loaded model's projection row."""
    ids, vals = [], []
    for coef in rec["means"]:
        idx = _model_index_of(imap, coef["name"], coef.get("term", ""))
        if idx is not None:
            ids.append(idx)
            vals.append(coef["value"])
    order = np.argsort(ids)
    return (np.asarray(ids, np.int64)[order],
            np.asarray(vals, np.float64)[order])


def sketch_coefficients_from_record(rec, dim: int) -> np.ndarray:
    """Dense sketched-space coefficient vector of one RandomEffectModel
    record saved under synthetic ``(SKETCH j)`` slot names."""
    w = np.zeros(dim)
    for coef in rec["means"]:
        nm = coef["name"]
        if nm.startswith("(SKETCH ") and nm.endswith(")"):
            w[int(nm[len("(SKETCH "):-1])] = coef["value"]
    return w


def load_fixed_effect_coordinate(directory: str, name: str, imap: IndexMap,
                                 task: str, shard: str,
                                 device=None) -> FixedEffectModel:
    """Rebuild one fixed-effect coordinate from its saved record (shared
    by the bulk load and the serving session, which loads fixed effects
    eagerly but random effects through its coefficient cache). The
    coefficients are float64 tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    path = os.path.join(directory, "fixed-effect", name, "coefficients.avro")
    records, _ = read_avro_file(path)
    rec = records[0]
    w = np.zeros(imap.size)
    for coef in rec["means"]:
        idx = _model_index_of(imap, coef["name"], coef.get("term", ""))
        if idx is not None:
            w[idx] = coef["value"]
    var = None
    if rec.get("variances"):
        var = np.zeros(imap.size)
        for coef in rec["variances"]:
            idx = _model_index_of(imap, coef["name"], coef.get("term", ""))
            if idx is not None:
                var[idx] = coef["value"]
    return FixedEffectModel(
        GeneralizedLinearModel(
            Coefficients(torch.from_numpy(w).to(dev),
                         None if var is None
                         else torch.from_numpy(var).to(dev)),
            task,
        ),
        shard,
    )


def load_game_model(directory: str, device=None) -> GameModel:
    """Load a saved model directory; fixed-effect coefficients land on
    ``device`` (default ``cuda``)."""
    meta = load_model_metadata(directory)
    index_maps: Dict[str, IndexMap] = {}
    coords = {}
    for c in meta["coordinates"]:
        shard = c["feature_shard"]
        if shard not in index_maps:
            index_maps[shard] = load_model_index_map(directory, shard)
        imap = index_maps[shard]
        if c["type"] == "fixed":
            coords[c["name"]] = load_fixed_effect_coordinate(
                directory, c["name"], imap, meta["task"], shard, device)
        else:
            records = read_random_effect_records(directory, c["name"])
            coords[c["name"]] = _rebuild_random_effect(
                c["name"], records, imap, meta["task"], shard,
                c.get("entity_column", ""), c.get("projection"),
            )
    return GameModel(coords, meta["task"])


def _rebuild_random_effect(name, records, imap: IndexMap, task, shard,
                           entity_column="", projection_meta=None) -> RandomEffectModel:
    """Rebuild bucketed per-entity coefficients from per-entity records,
    grouping entities with equal support size into buckets."""
    if projection_meta and projection_meta.get("type") == "random":
        return _rebuild_sketched_random_effect(
            name, records, task, shard, entity_column, projection_meta
        )
    entities: List[tuple] = []
    for rec in records:
        ids, vals = entity_support_from_record(rec, imap)
        variances = {}
        if rec.get("variances"):
            for coef in rec["variances"]:
                idx = _model_index_of(imap, coef["name"], coef.get("term", ""))
                if idx is not None:
                    variances[idx] = coef["value"]
        entities.append((rec["modelId"], ids, vals, variances))
    # bucket by support size
    by_size: Dict[int, List[tuple]] = {}
    for ent in entities:
        by_size.setdefault(len(ent[1]), []).append(ent)
    buckets = []
    for size, members in sorted(by_size.items()):
        E, D = len(members), max(size, 1)
        proj = np.full((E, D), -1, np.int32)
        coefs = np.zeros((E, D))
        eids = [m[0] for m in members]
        if size:
            # every member of a bucket has exactly `size` support ids, so
            # the fill is two stacks, not a per-entity Python loop
            # (model load at 100k+ entities)
            proj[:, :size] = np.stack([m[1] for m in members])
            coefs[:, :size] = np.stack([m[2] for m in members])
        has_var = any(m[3] for m in members)
        variances = None
        if has_var:
            variances = np.zeros((E, D))
            if size:
                variances[:, :size] = np.stack([
                    [m[3].get(int(g), 0.0) for g in m[1]] for m in members
                ])
        buckets.append(RandomEffectBucket(eids, coefs, proj, variances))
    return RandomEffectModel(name, buckets, task, shard, entity_column=entity_column)


def _rebuild_sketched_random_effect(name, records, task, shard, entity_column,
                                    projection_meta) -> RandomEffectModel:
    """Rebuild a random-projection effect: coefficients live in the sketched
    space, addressed by (SKETCH j) slot names; one bucket, constant width."""
    from photon_ml_tpu_torch.game.data import SketchProjection

    dim = int(projection_meta["dim"])
    sketch = SketchProjection(dim, int(projection_meta.get("seed", 0)))
    eids, coefs_list, var_list = [], [], []
    has_var = False
    for rec in records:
        w = sketch_coefficients_from_record(rec, dim)
        v = np.zeros(dim)
        if rec.get("variances"):
            has_var = True
            for coef in rec["variances"]:
                nm = coef["name"]
                if nm.startswith("(SKETCH ") and nm.endswith(")"):
                    v[int(nm[len("(SKETCH "):-1])] = coef["value"]
        eids.append(rec["modelId"])
        coefs_list.append(w)
        var_list.append(v)
    E = len(eids)
    bucket = RandomEffectBucket(
        eids,
        np.stack(coefs_list) if E else np.zeros((0, dim)),
        np.full((E, dim), -1, np.int32),
        np.stack(var_list) if has_var else None,
        sketch=sketch,
    )
    return RandomEffectModel(name, [bucket], task, shard,
                             entity_column=entity_column)
