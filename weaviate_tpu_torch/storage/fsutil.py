"""fsutil: the one durable-write discipline for persistent state.

Every persistence path in this codebase (LSM segments, WAL create/delete
ordering, raft meta/log/snapshot, the HNSW snapshot) funnels its
rename-into-place through :func:`atomic_replace` and its covering-file
deletes through :func:`remove_durable`, so the fsync ordering rules live
in exactly one place (graftlint G7 gates stray ``os.replace`` /
``open(..., "wb")`` in storage/cluster/engine back into here):

1. **fsync the file before the rename.** ``os.replace`` is atomic in
   the namespace but says nothing about the bytes — a crash after the
   rename but before writeback leaves a correctly-named file of
   garbage, which is strictly worse than the old name (recovery can't
   even tell something is missing).
2. **fsync the parent directory after the rename/unlink.** The rename
   itself lives in the directory inode; without the dir fsync a crash
   can roll the NAME back while keeping (or losing) the bytes. The
   classic torn pair this kills: segment rename durable, covering WAL
   delete not — replay then double-applies, which is only safe because
   LSM replay is idempotent; the reverse pair (WAL gone, segment name
   rolled back) loses acked writes and is exactly what rule 2 + delete
   ordering prevent.
3. **Delete covering state only after the covered state is durable.**
   ``remove_durable`` exists so WAL deletes fsync the directory too —
   a deleted-but-not-durably-deleted WAL reappearing after a crash is
   harmless (idempotent replay); the helper keeps the ordering visible.

Crashpoints: the write paths call ``faultline.fire`` at every byte
boundary worth killing a process at; :func:`guarded_write` is the
faultline-armed file wrapper that can tear an in-flight write at byte
granularity (write N bytes of the payload, flush to the kernel, then
``os._exit``) so the crash harness (tools/crashtest) can produce
genuinely-partial frames, not just post-hoc truncations.
"""

from __future__ import annotations

import os

from weaviate_tpu_torch.runtime import faultline


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so renames/unlinks inside it survive a crash.

    No-ops where directories can't be opened for fsync (some
    filesystems / platforms); durability on those is best-effort by
    construction, not silently assumed elsewhere.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def fsync_file(path: str) -> None:
    """fsync an existing file by path (used when the writer has already
    closed its handle)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_replace(tmp: str, final: str, *, fsync_file_first: bool = True,
                   crashpoint: str | None = None) -> None:
    """Durable rename-into-place: fsync ``tmp`` -> ``os.replace`` ->
    fsync the parent directory.

    ``fsync_file_first=False`` is for callers that already fsynced the
    open handle (segment writer) — the rename + dir-fsync ordering still
    applies. ``crashpoint`` names a faultline point fired between the
    file fsync and the rename (the "bytes durable, name not" window).
    """
    if fsync_file_first:
        fsync_file(tmp)
    if crashpoint is not None:
        faultline.fire(crashpoint, tmp=tmp, final=final)
    os.replace(tmp, final)
    fsync_dir(os.path.dirname(final) or ".")


def remove_durable(path: str, *, crashpoint: str | None = None) -> None:
    """Unlink + parent-dir fsync; missing files are fine (idempotent
    recovery paths re-delete). ``crashpoint`` fires BEFORE the unlink —
    the "covered state durable, covering WAL still present" window the
    crash harness kills in to prove replay is idempotent."""
    if crashpoint is not None:
        faultline.fire(crashpoint, path=path)
    try:
        os.remove(path)
    except OSError:
        return
    fsync_dir(os.path.dirname(path) or ".")


def guarded_write(f, data: bytes, point: str, **attrs) -> None:
    """The faultline-armed file wrapper: write ``data`` to open file
    ``f``, honoring an armed torn-write schedule at ``point``.

    Disarmed this is ``f.write(data)`` plus one module-global read. A
    ``torn`` schedule writes only the first ``torn_bytes`` bytes,
    flushes them to the kernel (they WILL survive the process dying —
    that's the point: a partial frame on disk), then exits with the
    schedule's exit code, simulating process death mid-``write(2)``. A
    ``crash`` schedule exits before writing anything.
    """
    directive = faultline.fire(point, size=len(data), **attrs)
    if isinstance(directive, faultline.Schedule) and \
            directive.action == "torn":
        f.write(data[:max(0, directive.torn_bytes)])
        f.flush()
        os._exit(directive.exit_code)
    f.write(data)
