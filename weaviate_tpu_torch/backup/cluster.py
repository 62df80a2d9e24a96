"""Cluster-wide backup: per-node shard transfer handlers + helpers (port of
``weaviate_tpu/backup/cluster.py``).

Reference: usecases/backup/coordinator.go (:133 Backup, :199 Restore) runs
a two-phase protocol over clusterapi (/backups/can-commit, /backups/commit,
serve.go:45-48); each participant's backupper pauses compaction, lists its
local shard files, and streams them to the shared module backend.

Here the coordinator (backup/__init__.py BackupManager) asks every owning
node to move ITS shards' files to/from the backend over the internal
transport; the descriptor records which node produced which files so
restore routes them back to the right owners. The FROZEN tenant tier
(``Collection._freeze_tenant`` / ``_unfreeze_tenant``) ships a tenant's
files through the same gzip'd chunk helpers.
"""

from __future__ import annotations

import gzip
import os
import shutil
import tempfile

from weaviate_tpu_torch.modules.backup_backends import walk_files


def compression_level() -> int:
    """BACKUP_COMPRESSION_LEVEL: 0 = store raw, 1-9 = gzip level
    (reference: usecases/backup/zip.go compresses shard files in
    streaming fashion; default there is best-speed)."""
    raw = os.environ.get("BACKUP_COMPRESSION_LEVEL", "1")
    try:
        return max(0, min(9, int(raw)))
    except ValueError:
        return 1


def put_file_compressed(backend, backup_id: str, key: str,
                        src_path: str) -> str:
    """Stream the file into the backend, gzip'd chunk by chunk — a
    multi-GB segment never materializes in RAM. Returns the STORED key
    (``key + '.gz'`` when compressed) for the descriptor."""
    level = compression_level()
    if level == 0:
        backend.put_file(backup_id, key, src_path)
        return key
    fd, tmp_path = tempfile.mkstemp(suffix=".gz")
    os.close(fd)
    try:
        with open(src_path, "rb") as src, \
                gzip.open(tmp_path, "wb", compresslevel=level) as gz:
            shutil.copyfileobj(src, gz, 1 << 20)
        backend.put_file(backup_id, key + ".gz", tmp_path)
    finally:
        try:
            os.remove(tmp_path)
        except OSError:
            pass
    return key + ".gz"


def get_file_decompressed(backend, backup_id: str, key: str,
                          dst_path: str) -> None:
    """Fetch a stored key; '.gz' keys gunzip in streaming fashion.
    Raw keys (old backups, compression off) pass straight through."""
    if not key.endswith(".gz"):
        backend.get_file(backup_id, key, dst_path)
        return
    fd, tmp_path = tempfile.mkstemp(suffix=".gz")
    os.close(fd)
    try:
        backend.get_file(backup_id, key, tmp_path)
        os.makedirs(os.path.dirname(dst_path) or ".", exist_ok=True)
        with gzip.open(tmp_path, "rb") as gz, open(dst_path, "wb") as out:
            shutil.copyfileobj(gz, out, 1 << 20)
    finally:
        try:
            os.remove(tmp_path)
        except OSError:
            pass


def logical_name(stored_key: str) -> str:
    """Stored key -> on-disk relative path (strips the '.gz')."""
    return stored_key[:-3] if stored_key.endswith(".gz") else stored_key


def backup_local_shards(db, modules, backend_name: str, backup_id: str,
                        class_shards: dict[str, list[str]]) -> dict:
    """Stream the given local shards' files to the backend. Returns
    {cls: [relative paths from the class dir]} — the descriptor fragment
    this node contributes."""
    backend = modules.backup_backend(backend_name)
    out: dict[str, list[str]] = {}
    with db.cycles.pause():
        # flushes every LOADED shard; COLD tenant shards were flushed at
        # offload and are backed up straight from their files — loading
        # them here would defeat the offload and leave them resident
        db.flush()
        for cls, shards in class_shards.items():
            files: list[str] = []
            for shard_name in shards:
                sh_dir = os.path.join(db.data_dir, cls, shard_name)
                if not os.path.isdir(sh_dir):
                    continue  # shard never wrote anything
                for rel in walk_files(sh_dir):
                    rel_cls = os.path.join(shard_name, rel)
                    stored = put_file_compressed(
                        backend, backup_id, f"{cls}/{rel_cls}",
                        os.path.join(sh_dir, rel))
                    files.append(stored[len(cls) + 1:])
            out[cls] = files
    return out


def restore_local_files(db, modules, backend_name: str, backup_id: str,
                        class_files: dict[str, list[str]]) -> None:
    """Pull the given files from the backend into this node's data dir
    (descriptor content is UNTRUSTED: paths must stay inside the class
    directory)."""
    backend = modules.backup_backend(backend_name)
    data_root = os.path.abspath(db.data_dir)
    for cls, files in class_files.items():
        # a lagging delete_class Raft entry would rmtree the class dir
        # AFTER these files land — silent shard loss. Refuse and let the
        # coordinator retry once the delete has applied here. The check
        # MUST hold the schema lock: delete_collection holds it through
        # its rmtree, so a lock-free check can pass mid-wipe and have
        # the just-restored files deleted underneath it.
        with db._lock:
            exists = cls in db.collections
        if exists:
            raise ValueError(
                f"class {cls!r} still exists on this node (schema delete "
                "not yet applied) — retry restore shortly")
        root = os.path.abspath(os.path.join(db.data_dir, cls))
        if os.path.dirname(root) != data_root:
            raise ValueError(f"class name {cls!r} escapes the data dir")
        for rel in files:
            dst = os.path.abspath(os.path.join(root, logical_name(rel)))
            if not dst.startswith(root + os.sep):
                raise ValueError(f"file path {rel!r} escapes the class dir")
            get_file_decompressed(backend, backup_id, f"{cls}/{rel}", dst)


def register_backup_handlers(server, db, get_modules) -> None:
    """Mount the participant side on a node's internal transport
    (reference: clusterapi /backups/* routes, serve.go:45-48)."""

    def do_backup(payload: dict) -> dict:
        return {"files": backup_local_shards(
            db, get_modules(), payload["backend"], payload["id"],
            payload["class_shards"]), "node": db.local_node}

    def do_restore(payload: dict) -> dict:
        restore_local_files(db, get_modules(), payload["backend"],
                            payload["id"], payload["class_files"])
        return {"ok": True, "node": db.local_node}

    server.route("/backups/shards:backup", do_backup)
    server.route("/backups/shards:restore", do_restore)
