"""Incremental (delta) publish and parent-chain resolution (a copy of
``photon_ml_tpu/registry/delta.py``; host only).

A full version's ``model/`` dir is a complete ``io/model_io`` tree. A
DELTA version's ``model/`` dir is the same layout, but its random-effect
``coefficients.avro`` files hold ONLY the entities whose records changed
against the parent (and its ``fixed-effect/`` subtree holds only
replaced coordinates). ``metadata.json`` and the index maps are always
copied in full (they are tiny and make every version self-describing);
a delta REFUSES to publish when the index maps differ from the parent's
— a changed feature space silently remapping the parent's untouched
coefficients is exactly the corruption a delta must never introduce.

Resolution is layered, topmost first: the serving coefficient cache
checks the delta layer before falling back down the chain
(``serve/coeff_cache.LayeredCoefficientStore``), so a hot-swap to a
delta touches only the changed bytes; batch consumers (the gate, the
scoring driver) call :func:`materialize` to merge the chain into one
complete, loadable model dir (cached under ``<root>/.resolved/<v>``,
built atomically)."""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Dict, List, Optional

from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu_torch.io.model_io import load_model_metadata
from photon_ml_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL_SCHEMA
from photon_ml_tpu_torch.registry.store import ModelRegistry, RegistryError

__all__ = ["DeltaSpec", "compute_delta", "publish_delta", "materialize"]

_RE_FILE = os.path.join("random-effect", "{name}", "coefficients.avro")
_FE_FILE = os.path.join("fixed-effect", "{name}", "coefficients.avro")


@dataclasses.dataclass
class DeltaSpec:
    """What changed between a new model dir and its parent."""

    changed_fixed: List[str]
    # coordinate -> changed/added RandomEffectModel records (parent order
    # is irrelevant: records are keyed by modelId at every consumer)
    random_effect_updates: Dict[str, List[dict]]
    unchanged_entities: Dict[str, int]

    @property
    def empty(self) -> bool:
        return not self.changed_fixed and not any(
            self.random_effect_updates.values())


def _file_bytes_equal(a: str, b: str) -> bool:
    try:
        if os.path.getsize(a) != os.path.getsize(b):
            return False
        with open(a, "rb") as fa, open(b, "rb") as fb:
            while True:
                ba, bb = fa.read(1 << 20), fb.read(1 << 20)
                if ba != bb:
                    return False
                if not ba:
                    return True
    except OSError:
        return False


def _records_by_id(path: str) -> Dict[str, dict]:
    if not os.path.exists(path):
        return {}
    records, _ = read_avro_file(path)
    return {str(r["modelId"]): r for r in records}


def compute_delta(new_model_dir: str, parent_model_dir: str) -> DeltaSpec:
    """Diff two COMPLETE model dirs (the parent side is the materialized
    parent). Coordinate structure and index maps must match — anything
    else needs a full publish."""
    meta_new = load_model_metadata(new_model_dir)
    meta_par = load_model_metadata(parent_model_dir)
    key = lambda m: [(c["name"], c["type"], c["feature_shard"])
                     for c in m["coordinates"]]
    if meta_new["task"] != meta_par["task"] or key(meta_new) != key(meta_par):
        raise ValueError(
            "delta publish needs an identical coordinate structure "
            f"(new={key(meta_new)} task={meta_new['task']!r}, "
            f"parent={key(meta_par)} task={meta_par['task']!r}); "
            "publish a full version instead")
    shards = {c["feature_shard"] for c in meta_new["coordinates"]}
    for shard in shards:
        name = f"index-map.{shard}.json"
        if not _file_bytes_equal(os.path.join(new_model_dir, name),
                                 os.path.join(parent_model_dir, name)):
            raise ValueError(
                f"index map for shard {shard!r} differs from the "
                "parent's — a delta cannot remap the parent's feature "
                "space; publish a full version instead")
    changed_fixed, re_updates, unchanged = [], {}, {}
    for c in meta_new["coordinates"]:
        if c["type"] == "fixed":
            rel = _FE_FILE.format(name=c["name"])
            if not _file_bytes_equal(os.path.join(new_model_dir, rel),
                                     os.path.join(parent_model_dir, rel)):
                changed_fixed.append(c["name"])
        else:
            rel = _RE_FILE.format(name=c["name"])
            new = _records_by_id(os.path.join(new_model_dir, rel))
            par = _records_by_id(os.path.join(parent_model_dir, rel))
            removed = sorted(set(par) - set(new))
            if removed:
                raise ValueError(
                    f"random effect {c['name']!r} dropped entities "
                    f"{removed[:5]}{'...' if len(removed) > 5 else ''} — "
                    "deltas are additive (layered lookup cannot express "
                    "a removal); publish a full version instead")
            changed = [rec for eid, rec in new.items()
                       if par.get(eid) != rec]
            re_updates[c["name"]] = changed
            unchanged[c["name"]] = len(new) - len(changed)
    return DeltaSpec(changed_fixed, re_updates, unchanged)


def _write_delta_tree(dst: str, new_model_dir: str, meta: dict,
                      spec: DeltaSpec) -> None:
    shutil.copy2(os.path.join(new_model_dir, "metadata.json"),
                 os.path.join(dst, "metadata.json"))
    for shard in sorted({c["feature_shard"] for c in meta["coordinates"]}):
        name = f"index-map.{shard}.json"
        shutil.copy2(os.path.join(new_model_dir, name),
                     os.path.join(dst, name))
    for name in spec.changed_fixed:
        rel = _FE_FILE.format(name=name)
        os.makedirs(os.path.dirname(os.path.join(dst, rel)), exist_ok=True)
        shutil.copy2(os.path.join(new_model_dir, rel),
                     os.path.join(dst, rel))
    for name, records in spec.random_effect_updates.items():
        if not records:
            continue  # untouched coordinate: resolved from the parent
        rel = _RE_FILE.format(name=name)
        os.makedirs(os.path.dirname(os.path.join(dst, rel)), exist_ok=True)
        write_avro_file(os.path.join(dst, rel),
                        sorted(records, key=lambda r: str(r["modelId"])),
                        BAYESIAN_LINEAR_MODEL_SCHEMA)


def publish_delta(registry: ModelRegistry, new_model_dir: str, *,
                  parent: Optional[str] = None,
                  metrics: Optional[dict] = None,
                  set_latest: bool = False) -> str:
    """Publish ``new_model_dir`` as a delta against ``parent`` (default:
    the live version). The delta is computed against the parent's
    MATERIALIZED view, so chaining deltas on deltas stays correct.
    Returns the new version name."""
    parent = parent or registry.read_latest()
    if parent is None:
        raise RegistryError(
            "delta publish needs a parent version and the registry has "
            "no LATEST; publish a full version first")
    parent_dir = materialize(registry, parent)
    spec = compute_delta(new_model_dir, parent_dir)
    meta = load_model_metadata(new_model_dir)
    version = registry.publish(
        writer=lambda dst: _write_delta_tree(dst, new_model_dir, meta, spec),
        metrics=metrics, parent=parent, delta=True,
        extra={"delta_summary": {
            "changed_fixed": spec.changed_fixed,
            "changed_entities": {k: len(v) for k, v
                                 in spec.random_effect_updates.items()},
            "unchanged_entities": spec.unchanged_entities,
        }},
        set_latest=set_latest)
    return version


def materialize(registry: ModelRegistry, version: str,
                dest: Optional[str] = None) -> str:
    """A COMPLETE model dir for ``version``: the version's own payload
    when it is a full publish, else the parent chain merged (topmost
    record wins) into ``dest`` (default ``<root>/.resolved/<version>``,
    built in a temp dir and renamed atomically; an existing resolved
    cache is reused — versions are immutable, so it can never be
    stale)."""
    chain = registry.parent_chain(version)
    if len(chain) == 1 and not registry.manifest(version).get("delta"):
        return registry.model_dir(version)
    dirs = [registry.model_dir(v) for v in chain]  # topmost first
    dest = dest or os.path.join(registry.resolved_root, version)
    if os.path.exists(os.path.join(dest, "metadata.json")):
        return dest
    tmp = f"{dest}.tmp-{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        meta = load_model_metadata(dirs[0])
        shutil.copy2(os.path.join(dirs[0], "metadata.json"),
                     os.path.join(tmp, "metadata.json"))
        for shard in sorted({c["feature_shard"] for c in meta["coordinates"]}):
            name = f"index-map.{shard}.json"
            shutil.copy2(_topmost(dirs, name), os.path.join(tmp, name))
        for c in meta["coordinates"]:
            rel = (_FE_FILE if c["type"] == "fixed" else _RE_FILE).format(
                name=c["name"])
            os.makedirs(os.path.dirname(os.path.join(tmp, rel)),
                        exist_ok=True)
            if c["type"] == "fixed":
                shutil.copy2(_topmost(dirs, rel), os.path.join(tmp, rel))
                continue
            merged: Dict[str, dict] = {}
            for layer in reversed(dirs):  # oldest first: topmost wins
                merged.update(_records_by_id(os.path.join(layer, rel)))
            write_avro_file(
                os.path.join(tmp, rel),
                [merged[k] for k in sorted(merged)],
                BAYESIAN_LINEAR_MODEL_SCHEMA)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        try:
            os.rename(tmp, dest)
        except OSError:
            # a concurrent materialize won the rename; its result is
            # byte-identical (deterministic writer over immutable inputs)
            shutil.rmtree(tmp, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return dest


def _topmost(dirs: List[str], rel: str) -> str:
    for d in dirs:
        path = os.path.join(d, rel)
        if os.path.exists(path):
            return path
    raise RegistryError(f"artifact {rel!r} missing from every layer of "
                        f"the chain ({dirs})")
