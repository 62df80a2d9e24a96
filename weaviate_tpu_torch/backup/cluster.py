"""Backup and offload file helpers (port of the helpers in
``weaviate_tpu/backup/cluster.py``).

Shard files stream to and from a backup backend gzip'd chunk by chunk:
the FROZEN tenant tier (``Collection._freeze_tenant`` /
``_unfreeze_tenant``) ships a tenant's files through these. The cluster
fan-out of the JAX module (per-node shard transfer over the internal
transport) is ROADMAP Queue 1 item 7b.
"""

from __future__ import annotations

import gzip
import os
import shutil
import tempfile


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
