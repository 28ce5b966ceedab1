"""Durable atomic-rename commits: fsync the file AND its directory (a copy
of ``photon_ml_tpu/io/durable.py``, with its ``durable.commit``
fault-injection site).

Every commit point in the tree (resume markers, registry ``LATEST``,
trace files, scoring outputs) uses the temp-file + ``os.replace`` idiom,
which is atomic against CONCURRENT readers but not durable against power
loss: POSIX only guarantees the rename reaches disk after the parent
directory is fsynced, and the renamed file's CONTENT only after the file
itself is fsynced. A rename-only commit can therefore surface after a
crash as a present-but-empty (or half-written) "committed" file — the
exact state the atomic idiom exists to rule out.

:func:`durable_replace` closes the hole: fsync the temp file, then
``os.replace``, then fsync the destination's parent directory.

Directory fsync is best-effort on platforms that refuse it (Windows has
no ``O_DIRECTORY``; some filesystems return EINVAL): the rename itself
already happened, so degrading to the pre-fix guarantee there is strictly
no worse than before.
"""

from __future__ import annotations

import os

from photon_ml_tpu_torch.parallel import fault_injection

__all__ = ["durable_replace", "fsync_file", "fsync_dir",
           "durable_dir_rename"]


def fsync_file(path: str) -> None:
    """fsync one file's content (open read-only, fsync, close)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a DIRECTORY so a rename inside it is durable.
    Platforms/filesystems that cannot fsync directories degrade to a
    no-op (the rename still happened; durability falls back to the
    filesystem's own ordering)."""
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0)
    try:
        fd = os.open(path, flags)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def durable_replace(tmp: str, dst: str) -> None:
    """Atomically AND durably commit ``tmp`` over ``dst``: fsync the temp
    file's content, rename, fsync the destination's parent directory.

    The ``durable.commit`` fault site fires inside the crash window
    (content synced, rename not yet issued) so tests can prove a
    mid-commit crash leaves ``dst`` untouched."""
    fsync_file(tmp)
    fault_injection.check("durable.commit")
    os.replace(tmp, dst)
    fsync_dir(os.path.dirname(os.path.abspath(dst)))


def durable_dir_rename(src_dir: str, dst_dir: str) -> None:
    """Durably commit a staged DIRECTORY (the registry's version-publish
    rename): fsync the staging directory itself (its entries' names),
    rename, fsync the destination's parent. Callers are responsible for
    having fsynced the individual files inside (the registry's manifest
    goes through :class:`~photon_ml_tpu_torch.parallel.resilience
    .ResumeManager`, which commits via :func:`durable_replace`)."""
    fsync_dir(src_dir)
    os.rename(src_dir, dst_dir)
    fsync_dir(os.path.dirname(os.path.abspath(dst_dir)))
