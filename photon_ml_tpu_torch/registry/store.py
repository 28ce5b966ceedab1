"""Append-only versioned model registry rooted at a directory (a copy of
``photon_ml_tpu/registry/store.py``; host only).

Layout::

    <root>/
      LATEST                      # JSON {"version": "v000003"}; atomic
      versions/
        v000001/
          MANIFEST.json           # payload + per-artifact fingerprints
          model/...               # io/model_io layout (full or delta)
        .tmp-<pid>-<n>/           # in-flight publish (ignored by readers)
      .resolved/
        v000003/                  # materialized delta cache (delta.py)

Invariants the serving/GC sides program against:

* a ``versions/<v>`` directory is COMPLETE the instant it exists — the
  whole tree (payload + manifest) is staged in a sibling ``.tmp-`` dir
  and renamed into place in one ``os.rename``;
* ``LATEST`` is written last (after the version rename) via temp file +
  ``os.replace``, so a reader can never see a pointer to a version that
  is not fully on disk;
* readers tolerate a concurrent publish: ``.tmp-`` dirs are ignored
  everywhere, and a ``LATEST`` read retries briefly on ENOENT (a
  registry being bootstrapped) before reporting "no live version";
* GC never collects the live version or ANY ancestor in its delta
  chain — collecting a delta's parent would orphan the live model.

Manifests are written through :class:`parallel.resilience.ResumeManager`
so the per-artifact content fingerprints ride the SAME embedded-
fingerprint + verify contract as the training resume markers: tampered
or truncated artifacts surface as a ``ResumeMismatch`` naming the exact
file, not as silently wrong scores.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import Dict, List, Optional

from photon_ml_tpu_torch.io.durable import durable_dir_rename, durable_replace
from photon_ml_tpu_torch.parallel import fault_injection
from photon_ml_tpu_torch.parallel.resilience import ResumeManager

__all__ = ["ModelRegistry", "RegistryError", "ResolvedVersion",
           "SCHEMA_VERSION"]

SCHEMA_VERSION = 1
_VERSION_RE = re.compile(r"^v(\d{6})$")
_MANIFEST = "MANIFEST.json"
_MODEL = "model"


class RegistryError(RuntimeError):
    """A registry operation failed (missing version, corrupt pointer,
    exhausted publish retries)."""


class ResolvedVersion:
    """A version resolved to its model-directory chain, topmost first
    (``chain[0]`` is the version's own payload, later entries its delta
    ancestry ending at a full publish). ``ScoringSession`` and the
    materializer consume this; a plain full version has a 1-dir chain."""

    __slots__ = ("version", "chain")

    def __init__(self, version: str, chain: List[str]):
        self.version = version
        self.chain = list(chain)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"ResolvedVersion({self.version!r}, {len(self.chain)} layers)"


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def artifact_fingerprints(version_dir: str) -> Dict[str, str]:
    """relpath -> sha256 for every file under ``<version_dir>/model`` —
    the manifest's embedded fingerprint dict."""
    root = os.path.join(version_dir, _MODEL)
    out: Dict[str, str] = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in sorted(files):
            full = os.path.join(dirpath, name)
            out[os.path.relpath(full, root)] = _sha256_file(full)
    return out


class ModelRegistry:
    """One registry root. Construction is cheap and touches nothing;
    directories are created lazily on first publish."""

    def __init__(self, root: str):
        self.root = str(root)
        self.versions_root = os.path.join(self.root, "versions")
        self.latest_path = os.path.join(self.root, "LATEST")
        self.resolved_root = os.path.join(self.root, ".resolved")
        self._tmp_seq = 0

    # -- read side ---------------------------------------------------------
    def list_versions(self) -> List[str]:
        """Complete versions, oldest first. ``.tmp-`` staging dirs from
        in-flight (or crashed) publishes are ignored — a version exists
        only once its atomic rename landed."""
        if not os.path.isdir(self.versions_root):
            return []
        return sorted(d for d in os.listdir(self.versions_root)
                      if _VERSION_RE.match(d)
                      and os.path.isdir(os.path.join(self.versions_root, d)))

    def version_dir(self, version: str) -> str:
        return os.path.join(self.versions_root, version)

    def model_dir(self, version: str) -> str:
        """The version's own payload dir (a delta version's payload is
        PARTIAL — use :meth:`open_version` / ``delta.materialize`` for a
        loadable view)."""
        return os.path.join(self.version_dir(version), _MODEL)

    def manifest_path(self, version: str) -> str:
        return os.path.join(self.version_dir(version), _MANIFEST)

    def manifest(self, version: str) -> dict:
        path = self.manifest_path(version)
        if not os.path.exists(path):
            raise RegistryError(f"no version {version!r} in {self.root} "
                                f"(known: {self.list_versions()})")
        return ResumeManager(path).load(verify=False)

    def read_latest(self, retries: int = 3, delay_s: float = 0.02
                    ) -> Optional[str]:
        """The live version name, or None when nothing was promoted yet.

        ``LATEST`` is replaced atomically, so a missing file normally
        means "never promoted" — but a reader racing the very first
        promotion (or a registry on a filesystem replaying a rename) can
        transiently see ENOENT, so the read retries briefly before
        concluding the registry has no live version. Persistent garbage
        (a hand-edited pointer) raises instead of silently serving
        nothing."""
        err: Optional[Exception] = None
        for attempt in range(max(1, int(retries))):
            if attempt:
                time.sleep(delay_s)
            try:
                with open(self.latest_path) as f:
                    record = json.load(f)
                version = record["version"]
            except FileNotFoundError:
                err = None
                continue
            except (json.JSONDecodeError, KeyError, TypeError) as e:
                err = e  # partial/hand-mangled pointer: retry then raise
                continue
            if not self._exists(version):
                # pointer ahead of a publish we cannot see yet (or to a
                # GC'd version — operator error): retry, then raise
                err = RegistryError(
                    f"LATEST points at missing version {version!r}")
                continue
            return version
        if err is not None:
            raise RegistryError(f"unreadable LATEST pointer at "
                                f"{self.latest_path}: {err}")
        return None

    def _exists(self, version: str) -> bool:
        return os.path.exists(self.manifest_path(version))

    def parent_chain(self, version: str) -> List[str]:
        """``[version, parent, grandparent, ...]`` ending at the full
        publish a delta chain resolves against."""
        chain, seen = [], set()
        v: Optional[str] = version
        while v is not None:
            if v in seen:
                raise RegistryError(f"parent cycle at {v!r}")
            seen.add(v)
            chain.append(v)
            v = self.manifest(v).get("parent")
        return chain

    def open_version(self, version: str) -> ResolvedVersion:
        """Resolve a version to its model-dir chain (topmost first) —
        the object ``ScoringSession`` loads and swaps to."""
        return ResolvedVersion(
            version, [self.model_dir(v) for v in self.parent_chain(version)])

    def verify(self, version: str) -> dict:
        """Recompute every artifact fingerprint and check it against the
        manifest (the ResumeManager embedded-fingerprint contract);
        raises ``ResumeMismatch`` naming the diverging file(s)."""
        path = self.manifest_path(version)
        current = artifact_fingerprints(self.version_dir(version))
        return ResumeManager(path, fingerprint=current).load()

    # -- write side --------------------------------------------------------
    def _staging_dir(self) -> str:
        self._tmp_seq += 1
        return os.path.join(self.versions_root,
                            f".tmp-{os.getpid()}-{self._tmp_seq}")

    def _next_version(self) -> str:
        versions = self.list_versions()
        n = int(_VERSION_RE.match(versions[-1]).group(1)) if versions else 0
        return f"v{n + 1:06d}"

    def publish(self, source_model_dir: Optional[str] = None, *,
                writer=None, metrics: Optional[dict] = None,
                parent: Optional[str] = None, delta: bool = False,
                extra: Optional[dict] = None,
                set_latest: bool = False) -> str:
        """Publish one immutable version; returns its name.

        The payload comes from copying ``source_model_dir`` or from
        ``writer(dst_dir)`` (the delta publisher). The whole version —
        payload plus fingerprinted manifest — is staged under a
        ``.tmp-`` sibling and renamed into ``versions/<v>`` in one
        ``os.rename``; a concurrent publisher losing the race for ``<v>``
        simply retries under the next number. ``LATEST`` moves only when
        ``set_latest`` (normally the gate's job)."""
        if (source_model_dir is None) == (writer is None):
            raise ValueError("publish needs exactly one of "
                             "source_model_dir or writer")
        if parent is not None and not self._exists(parent):
            raise RegistryError(f"parent version {parent!r} not in registry")
        os.makedirs(self.versions_root, exist_ok=True)
        staging = self._staging_dir()
        try:
            if source_model_dir is not None:
                if not os.path.exists(
                        os.path.join(source_model_dir, "metadata.json")):
                    raise RegistryError(
                        f"{source_model_dir} is not a saved model dir "
                        "(no metadata.json)")
                shutil.copytree(source_model_dir,
                                os.path.join(staging, _MODEL))
            else:
                os.makedirs(os.path.join(staging, _MODEL))
                writer(os.path.join(staging, _MODEL))
            fingerprints = artifact_fingerprints(staging)
            # crash window A: payload staged, nothing renamed — readers
            # and GC must ignore the leftover .tmp- dir
            fault_injection.check("registry.publish_prepared")
            version = None
            for _ in range(100):
                candidate = self._next_version()
                payload = {
                    "schema_version": SCHEMA_VERSION,
                    "version": candidate,
                    "parent": parent,
                    "delta": bool(delta),
                    "created_at": time.time(),
                    "metrics": dict(metrics or {}),
                    "gate": None,
                }
                payload.update(extra or {})
                ResumeManager(os.path.join(staging, _MANIFEST),
                              fingerprint=fingerprints).save(payload)
                try:
                    # durable: fsync staging + parent around the rename so
                    # a power loss can't surface a "complete" version dir
                    # whose entries never reached disk (io/durable.py)
                    durable_dir_rename(staging, self.version_dir(candidate))
                except OSError:
                    continue  # lost the number to a concurrent publish
                version = candidate
                break
            if version is None:
                raise RegistryError(
                    "publish retries exhausted (100 concurrent-publish "
                    f"collisions under {self.versions_root})")
        except BaseException:
            # an EXCEPTION unwinds the staging dir; a crash (SIGKILL,
            # injected at the sites above) leaves it for readers to
            # ignore and a later `gc(clean_staging=True)` to sweep
            if os.path.isdir(staging):
                shutil.rmtree(staging, ignore_errors=True)
            raise
        # crash window B: version landed but LATEST not moved — the
        # version is visible/garbage-collectable, pointer still old
        fault_injection.check("registry.published")
        if set_latest:
            self.set_latest(version)
        return version

    def set_latest(self, version: str) -> None:
        """Atomically AND durably repoint ``LATEST`` (temp file + fsync +
        ``os.replace`` + parent-dir fsync, same discipline as every
        marker in this repo — io/durable.py). Also the rollback
        primitive: point it back at any retained version."""
        if not self._exists(version):
            raise RegistryError(f"cannot promote missing version "
                                f"{version!r} (known: {self.list_versions()})")
        os.makedirs(self.root, exist_ok=True)
        tmp = f"{self.latest_path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"version": version, "promoted_at": time.time()}, f)
        durable_replace(tmp, self.latest_path)

    def update_manifest(self, version: str, **fields) -> dict:
        """Rewrite a version's manifest payload with ``fields`` merged in
        (atomic; artifact fingerprints preserved). Used by the gate to
        record its verdict — the ONLY sanctioned post-publish mutation."""
        path = self.manifest_path(version)
        mgr = ResumeManager(path)
        payload = mgr.load(verify=False)
        if payload is None:
            raise RegistryError(f"no version {version!r} in {self.root}")
        stored_fp = payload.pop(ResumeManager._FP_KEY, None)
        payload.update(fields)
        ResumeManager(path, fingerprint=stored_fp).save(payload)
        return payload

    # -- retention ---------------------------------------------------------
    def protected_versions(self) -> List[str]:
        """The live version plus its whole delta ancestry — the set GC
        must never touch (collecting a delta's parent orphans the live
        model)."""
        live = self.read_latest(retries=1)
        if live is None:
            return []
        return self.parent_chain(live)

    def gc(self, keep: int = 2, clean_staging: bool = False,
           staging_grace_s: float = 3600.0) -> List[str]:
        """Collect old versions, keeping the newest ``keep`` plus the
        live version's full parent chain. Returns the removed names.

        Concurrent-publish tolerance: ``.tmp-`` staging dirs are never
        counted as versions and are left alone unless ``clean_staging``
        — and even then only when older than ``staging_grace_s``, so a
        publish in flight on another process is never swept out from
        under its rename."""
        versions = self.list_versions()
        protected = set(self.protected_versions())
        protected.update(versions[-max(0, int(keep)):] if keep else [])
        removed = []
        for v in versions:
            if v in protected:
                continue
            shutil.rmtree(self.version_dir(v), ignore_errors=True)
            shutil.rmtree(os.path.join(self.resolved_root, v),
                          ignore_errors=True)
            removed.append(v)
        if clean_staging and os.path.isdir(self.versions_root):
            now = time.time()
            for d in sorted(os.listdir(self.versions_root)):
                if not d.startswith(".tmp-"):
                    continue
                full = os.path.join(self.versions_root, d)
                try:
                    if now - os.path.getmtime(full) > staging_grace_s:
                        shutil.rmtree(full, ignore_errors=True)
                except OSError:  # pragma: no cover - raced the publisher
                    pass
        return removed
