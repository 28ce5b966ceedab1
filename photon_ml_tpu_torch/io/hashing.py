"""Feature hashing (the hashing trick) as an index-map backend (a copy of
``photon_ml_tpu/io/hashing.py``).

The reference materializes name/term→index maps (in-memory or PalDB) built
by a dedicated indexing job (SURVEY.md §3.3). At Criteo-TB scale a
materialized map is itself a bottleneck; the standard alternative is a
stable hash of the feature key into a fixed-width space — no build pass, no
storage, identical across processes/hosts. This backend duck-types
``IndexMap`` so every driver accepts ``--hash-dim`` in place of a built map.

Collisions are the accepted trade (two features sharing an index add their
contributions); width should be chosen ~4x the live feature count. Hashing
is FNV-1a 64 over the utf-8 feature key — the same function the native
store uses, and stable by construction (Python's ``hash`` is per-process
randomized and unusable here).

Saved models name hashed coefficients ``(HASH <index>)``; the model-load
path calls ``model_index_of`` which recognizes that form, so model
save/load round-trips without the original feature names (which a hashing
map never sees). Plain ``index_of`` always hashes — a real data feature
that happens to be literally named ``(HASH n)`` is treated like any other
feature, never routed directly to slot ``n``.
"""

from __future__ import annotations

from typing import Dict, Optional

from photon_ml_tpu_torch.io.schemas import INTERCEPT_KEY, feature_key

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1
_HASH_NAME_PREFIX = "(HASH "


def fnv1a_64(data: bytes) -> int:
    h = _FNV_OFFSET
    for byte in data:
        h = ((h ^ byte) * _FNV_PRIME) & _MASK64
    return h


class HashingIndexMap:
    """Fixed-width hashed feature space; duck-types ``IndexMap``."""

    def __init__(self, dim: int, add_intercept: bool = True):
        if dim <= 0:
            raise ValueError(f"hash dim must be positive, got {dim}")
        # the intercept gets a reserved slot past the hashed range so no
        # feature can collide with it
        self._hash_dim = dim
        self._intercept = dim if add_intercept else -1

    @property
    def size(self) -> int:
        return self._hash_dim + (1 if self._intercept >= 0 else 0)

    @property
    def intercept_index(self) -> int:
        return self._intercept

    def index_of(self, name: str, term: str = "") -> Optional[int]:
        if name == INTERCEPT_KEY:
            return self._intercept if self._intercept >= 0 else None
        key = feature_key(name, term)
        return fnv1a_64(key.encode("utf-8")) % self._hash_dim

    def model_index_of(self, name: str, term: str = "") -> Optional[int]:
        """``index_of`` plus recognition of the synthetic ``(HASH n)`` names
        this map writes into saved models. Only the model-load path calls
        this, so user data named ``(HASH n)`` cannot alias slot ``n``."""
        if name.startswith(_HASH_NAME_PREFIX) and name.endswith(")") and not term:
            try:
                idx = int(name[len(_HASH_NAME_PREFIX):-1])
            except ValueError:
                idx = -1
            if 0 <= idx < self.size:
                return idx
        return self.index_of(name, term)

    def inverse(self) -> Dict[int, str]:
        """Synthetic names — hashing is not invertible."""
        out = {i: f"{_HASH_NAME_PREFIX}{i})" for i in range(self._hash_dim)}
        if self._intercept >= 0:
            out[self._intercept] = INTERCEPT_KEY
        return out

    def digest(self) -> str:
        """Feature-space fingerprint (chunk-cache invalidation key). The
        hash function is fixed, so (dim, intercept slot) determines every
        resolution."""
        return f"fnv1a64:{self._hash_dim}:{self._intercept}"

    def save(self, path: str) -> None:
        import json

        with open(path, "w") as f:
            json.dump({"hashing": {"dim": self._hash_dim,
                                   "add_intercept": self._intercept >= 0}}, f)

    @classmethod
    def load(cls, path: str) -> "HashingIndexMap":
        import json

        with open(path) as f:
            cfg = json.load(f)["hashing"]
        return cls(cfg["dim"], add_intercept=cfg["add_intercept"])
