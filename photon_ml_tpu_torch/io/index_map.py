"""Feature index maps: name/term string -> dense column index (a copy of
``photon_ml_tpu/io/index_map.py``).

Equivalent of the reference's ``index.{IndexMap, DefaultIndexMap,
PalDBIndexMap, PalDBIndexMapBuilder}`` (SURVEY.md §3.3; reference mount
empty). The reference offers an in-memory map or an off-heap PalDB store
built by a dedicated Spark job (``FeatureIndexingDriver``); here a plain
dict plus a compact binary file replaces PalDB (SURVEY.md §3.7: no native
store needed), and ``build_index_map`` plays the indexing-driver role.
Supports one map per feature shard.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, Optional

from photon_ml_tpu_torch.io.schemas import INTERCEPT_KEY, feature_key


@dataclasses.dataclass
class IndexMap:
    forward: Dict[str, int]  # feature key -> index
    add_intercept: bool = False

    def __post_init__(self):
        if self.add_intercept and INTERCEPT_KEY not in self.forward:
            self.forward[INTERCEPT_KEY] = len(self.forward)

    @property
    def size(self) -> int:
        return len(self.forward)

    @property
    def intercept_index(self) -> int:
        return self.forward.get(INTERCEPT_KEY, -1)

    def index_of(self, name: str, term: str = "") -> Optional[int]:
        return self.forward.get(feature_key(name, term))

    def inverse(self) -> Dict[int, str]:
        return {v: k for k, v in self.forward.items()}

    def digest(self) -> str:
        """Content fingerprint of the feature space (key -> index mapping
        and intercept placement). Cache layers key decoded artifacts on
        this: two maps with the same digest resolve every feature
        identically, so a cached decode is reusable; any remap must miss."""
        import hashlib

        h = hashlib.sha256()
        for key, idx in sorted(self.forward.items()):
            h.update(f"{key}\x00{idx}\x01".encode())
        return h.hexdigest()

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"features": self.forward}, f)

    @classmethod
    def load(cls, path: str) -> "IndexMap":
        with open(path) as f:
            payload = json.load(f)
        return cls(payload["features"])


def build_index_map(
    records: Iterable,
    add_intercept: bool = True,
    min_count: int = 1,
    features_field: str = "features",
) -> IndexMap:
    """Scan training example records (dicts with a ``features`` list of
    name/term/value) and assign dense indices — the FeatureIndexingDriver
    role. ``min_count`` drops rare features."""
    counts: Dict[str, int] = {}
    for rec in records:
        for feat in rec[features_field]:
            key = feature_key(feat["name"], feat.get("term", ""))
            counts[key] = counts.get(key, 0) + 1
    keys = sorted(k for k, c in counts.items() if c >= min_count)
    forward = {k: i for i, k in enumerate(keys)}
    return IndexMap(forward, add_intercept=add_intercept)


def filter_index_map(
    imap: IndexMap, prefixes: Iterable[str], add_intercept: bool = True
) -> IndexMap:
    """Restrict an index map to feature names starting with any prefix and
    re-densify indices — per-shard feature selection (the reference's
    feature bags / shard configs, SURVEY.md §4.1). Empty prefix matches all."""
    prefixes = list(prefixes)
    keys = sorted(
        k for k in imap.forward
        if k != INTERCEPT_KEY and any(k.startswith(p) for p in prefixes)
    )
    forward = {k: i for i, k in enumerate(keys)}
    return IndexMap(forward, add_intercept=add_intercept)
