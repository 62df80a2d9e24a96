"""Backup / restore subsystem.

Reference: usecases/backup — Handler validates and spawns async work,
the coordinator runs a 2-phase protocol over participating nodes
(coordinator.go:133 Backup, :199 Restore), each node's backupper pauses
compaction, lists shard files, and streams them to a module backend
(S3/GCS/Azure/filesystem); progress is polled via /v1/backups/.../status.

Single-node manager here (the multi-node path rides the cluster layer's
remote API the same way queries do): snapshot = flush + copy the
collection's on-disk tree through a ``BackupBackend`` module, plus a
``backup_config.json`` descriptor carrying schema + sharding so restore
can rebuild the collection without pre-existing schema.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

from weaviate_tpu_torch.modules.base import BackupBackend, ModuleError
from weaviate_tpu_torch.schema.config import CollectionConfig

_ID_RE = re.compile(r"^[a-z0-9][a-z0-9_-]*$")

# reference: entities/backup/status.go
STARTED = "STARTED"
TRANSFERRING = "TRANSFERRING"
TRANSFERRED = "TRANSFERRED"
SUCCESS = "SUCCESS"
FAILED = "FAILED"

DESCRIPTOR = "backup_config.json"


class BackupError(Exception):
    pass


from weaviate_tpu_torch.modules.backup_backends import walk_files as _walk_files

_ACTIVE = (STARTED, TRANSFERRING, TRANSFERRED)


class BackupManager:
    """``modules``: module Provider — backends resolve via
    ``backup_backend(name)`` (reference: module registry lookup,
    usecases/backup/handler.go). ``schema_target``: where restored
    classes are created — the Database itself (single node) or the
    ClusterNode (Raft path), same seam the REST schema routes use."""

    def __init__(self, db, modules, node_name: str = "node-0",
                 schema_target=None, node=None):
        self.db = db
        self.modules = modules
        self.node_name = node_name
        self.schema_target = schema_target or db
        # ClusterNode handle: when present and shards live on other nodes,
        # the coordinator fans the transfer out over the internal
        # transport (reference: backup coordinator over clusterapi)
        self.node = node
        self._lock = threading.Lock()
        self._backups: dict[tuple[str, str], dict] = {}
        self._restores: dict[tuple[str, str], dict] = {}

    # -- cluster fan-out helpers --------------------------------------------

    def _owner_map(self, classes: list[str]) -> dict[str, dict[str, list[str]]]:
        """node -> {class: [its shards]} (primary replica owns the copy)."""
        owners: dict[str, dict[str, list[str]]] = {}
        for cls in classes:
            col = self.db.get_collection(cls)
            for shard in col.sharding.shard_names:
                primary = col.sharding.nodes_for(shard)[0]
                owners.setdefault(primary, {}).setdefault(cls, []).append(
                    shard)
        return owners

    def _rpc(self, node: str, path: str, payload: dict) -> dict:
        # reached only with a ClusterNode (``node``), which the port does
        # not build: the cluster fan-out (backup/cluster.py over the
        # internal transport) is ROADMAP Queue 1 item 7
        raise NotImplementedError("cluster backup: ROADMAP Queue 1 item 7")

    # -- backup --------------------------------------------------------------

    def start_backup(self, backend_name: str, backup_id: str,
                     include: list[str] | None = None,
                     exclude: list[str] | None = None,
                     wait: bool = False) -> dict:
        backend = self._backend(backend_name)
        self._check_id(backup_id)
        if include and exclude:
            raise BackupError("include and exclude are mutually exclusive")
        all_classes = self.db.list_collections()
        classes = list(include) if include else \
            [c for c in all_classes if c not in set(exclude or [])]
        for c in classes:
            if c not in all_classes:
                raise BackupError(f"class {c!r} does not exist")
        if not classes:
            raise BackupError("no classes to back up")
        if self._descriptor_exists(backend, backend_name, backup_id):
            raise BackupError(
                f"backup {backup_id!r} already exists on {backend_name!r}")
        key = (backend_name, backup_id)
        status = {"id": backup_id, "backend": backend_name,
                  "status": STARTED, "error": None, "classes": classes,
                  "path": self._home(backend, backup_id)}
        with self._lock:
            if key in self._backups and \
                    self._backups[key]["status"] in _ACTIVE:
                raise BackupError(f"backup {backup_id!r} already running")
            self._backups[key] = status

        def work():
            try:
                status["status"] = TRANSFERRING
                backend.initialize(backup_id)
                descriptor = {
                    "id": backup_id,
                    "node": self.node_name,
                    "startedAt": time.time(),
                    "version": "1",
                    "classes": [],
                }
                owners = self._owner_map(classes)
                cluster = self.node is not None and (
                    set(owners) - {self.node_name})
                if cluster:
                    # fan the transfer out: every owning node streams ITS
                    # shards to the shared backend (reference: coordinator
                    # over clusterapi, coordinator.go:133)
                    from concurrent.futures import ThreadPoolExecutor

                    from weaviate_tpu_torch.backup.cluster import (
                        backup_local_shards,
                    )

                    def one_owner(item):
                        owner, class_shards = item
                        if owner == self.node_name:
                            return owner, backup_local_shards(
                                self.db, self.modules, backend_name,
                                backup_id, class_shards)
                        reply = self._rpc(
                            owner, "/backups/shards:backup",
                            {"backend": backend_name, "id": backup_id,
                             "class_shards": class_shards})
                        return owner, reply["files"]

                    # owners transfer concurrently — wall clock is the
                    # slowest node, not the sum (reference coordinator
                    # runs participants in parallel)
                    with ThreadPoolExecutor(len(owners)) as pool:
                        files_by_node = dict(
                            pool.map(one_owner, owners.items()))
                    for cls in classes:
                        col = self.db.get_collection(cls)
                        per_node = {n: fl.get(cls, [])
                                    for n, fl in files_by_node.items()
                                    if fl.get(cls)}
                        descriptor["classes"].append({
                            "name": cls,
                            "config": col.config.to_dict(),
                            "sharding": col.sharding.to_dict(),
                            "files": [f for fl in per_node.values()
                                      for f in fl],
                            "files_by_node": per_node,
                        })
                else:
                    # single node: pause background compaction/flush cycles
                    # for a consistent file set (reference: BeginBackup
                    # pauses compaction + commit-log switching)
                    with self.db.cycles.pause():
                        self.db.flush()
                        from weaviate_tpu_torch.backup.cluster import (
                            put_file_compressed,
                        )

                        for cls in classes:
                            col = self.db.get_collection(cls)
                            root = os.path.join(self.db.data_dir, cls)
                            files = []
                            for rel in (_walk_files(root)
                                        if os.path.isdir(root) else []):
                                # streamed + gzip'd chunk by chunk:
                                # multi-GB segment files never
                                # materialize in memory (reference:
                                # usecases/backup/zip.go)
                                stored = put_file_compressed(
                                    backend, backup_id, f"{cls}/{rel}",
                                    os.path.join(root, rel))
                                files.append(stored[len(cls) + 1:])
                            descriptor["classes"].append({
                                "name": cls,
                                "config": col.config.to_dict(),
                                "sharding": col.sharding.to_dict(),
                                "files": files,
                            })
                status["status"] = TRANSFERRED
                descriptor["completedAt"] = time.time()
                backend.put(backup_id, DESCRIPTOR,
                            json.dumps(descriptor).encode())
                status["status"] = SUCCESS
            except Exception as e:  # surfaced via status polling
                status["status"] = FAILED
                status["error"] = str(e)

        t = threading.Thread(target=work, daemon=True,
                             name=f"backup-{backup_id}")
        t.start()
        if wait:
            t.join()
        return dict(status)

    # -- restore -------------------------------------------------------------

    def start_restore(self, backend_name: str, backup_id: str,
                      include: list[str] | None = None,
                      exclude: list[str] | None = None,
                      wait: bool = False) -> dict:
        backend = self._backend(backend_name)
        self._check_id(backup_id)
        try:
            descriptor = json.loads(backend.get(backup_id, DESCRIPTOR))
        except Exception:
            raise BackupError(
                f"backup {backup_id!r} not found on {backend_name!r}")
        if include and exclude:
            raise BackupError("include and exclude are mutually exclusive")
        try:
            by_name = {c["name"]: c for c in descriptor["classes"]}
            for c in by_name.values():
                c["files"], c["config"], c["sharding"]
        except (KeyError, TypeError) as e:
            raise BackupError(
                f"backup {backup_id!r} has a malformed descriptor: {e}")
        classes = list(include) if include else \
            [n for n in by_name if n not in set(exclude or [])]
        for c in classes:
            if c not in by_name:
                raise BackupError(f"class {c!r} not in backup {backup_id!r}")
            if c in self.db.list_collections():
                raise BackupError(
                    f"class {c!r} already exists; delete it before restore "
                    "(reference behavior: restore never overwrites)")
        key = (backend_name, backup_id)
        status = {"id": backup_id, "backend": backend_name,
                  "status": STARTED, "error": None, "classes": classes,
                  "path": self._home(backend, backup_id)}
        with self._lock:
            if key in self._restores and \
                    self._restores[key]["status"] in _ACTIVE:
                raise BackupError(f"restore {backup_id!r} already running")
            self._restores[key] = status

        def work():
            try:
                status["status"] = TRANSFERRING
                from weaviate_tpu_torch.db.sharding import ShardingState

                data_root = os.path.abspath(self.db.data_dir)
                for cls in classes:
                    entry = by_name[cls]
                    root = os.path.abspath(
                        os.path.join(self.db.data_dir, cls))
                    # the descriptor is UNTRUSTED backend content: class
                    # names and file paths must stay inside data_dir
                    if os.path.dirname(root) != data_root:
                        raise BackupError(
                            f"descriptor class name {cls!r} escapes the "
                            "data directory")
                    from weaviate_tpu_torch.backup.cluster import (
                        restore_local_files,
                    )

                    by_node = entry.get("files_by_node")
                    if by_node and self.node is not None:
                        # cluster restore: each original owner pulls ITS
                        # shard files back before the class exists, so
                        # the Raft add_class below loads them in place
                        alive = set(
                            self.node.membership.alive_nodes())
                        missing = set(by_node) - alive
                        if missing:
                            raise BackupError(
                                f"restore of {cls!r} needs nodes "
                                f"{sorted(missing)} which are not in the "
                                "cluster (reference: topology must cover "
                                "the backup's owners)")

                        def one_owner(item):
                            owner, files = item
                            # a follower may lag on the delete_class
                            # entry: its handler refuses while the class
                            # still exists locally — retry briefly
                            last = None
                            for _ in range(60):  # 15s: schema deletes
                                # can lag under load
                                try:
                                    if owner == self.node_name:
                                        restore_local_files(
                                            self.db, self.modules,
                                            backend_name, backup_id,
                                            {cls: files})
                                    else:
                                        self._rpc(
                                            owner,
                                            "/backups/shards:restore",
                                            {"backend": backend_name,
                                             "id": backup_id,
                                             "class_files": {cls: files}})
                                    return
                                except Exception as e:
                                    last = e
                                    if "still exists" not in str(e):
                                        raise
                                    time.sleep(0.25)
                            raise BackupError(
                                f"restore on {owner!r} kept failing: "
                                f"{last}")

                        from concurrent.futures import ThreadPoolExecutor

                        with ThreadPoolExecutor(len(by_node)) as pool:
                            list(pool.map(one_owner, by_node.items()))
                    else:
                        try:
                            restore_local_files(
                                self.db, self.modules, backend_name,
                                backup_id, {cls: entry["files"]})
                        except ValueError as e:
                            raise BackupError(str(e))
                    cfg = CollectionConfig.from_dict(entry["config"])
                    state = ShardingState.from_dict(entry["sharding"])
                    # through the schema seam so cluster nodes take the
                    # Raft path and peers learn the restored class
                    self.schema_target.create_collection(
                        cfg, sharding_state=state)
                status["status"] = SUCCESS
            except Exception as e:
                status["status"] = FAILED
                status["error"] = str(e)

        t = threading.Thread(target=work, daemon=True,
                             name=f"restore-{backup_id}")
        t.start()
        if wait:
            t.join()
        return dict(status)

    # -- status --------------------------------------------------------------

    @staticmethod
    def _check_id(backup_id: str) -> None:
        if not _ID_RE.match(backup_id or ""):
            raise BackupError(f"invalid backup id {backup_id!r} (lowercase "
                              "letters, numbers, '_', '-' only)")

    @staticmethod
    def _descriptor_exists(backend, backend_name, backup_id) -> bool:
        try:
            return bool(backend.get(backup_id, DESCRIPTOR))
        except (KeyError, FileNotFoundError):
            return False
        except ModuleError as e:
            raise BackupError(str(e))
        except Exception as e:  # unreachable endpoint etc. → clean 422
            raise BackupError(
                f"backend {backend_name!r} probe failed: {e}")

    def backup_status(self, backend_name: str, backup_id: str) -> dict:
        return self._status(self._backups, backend_name, backup_id, "backup")

    def restore_status(self, backend_name: str, backup_id: str) -> dict:
        return self._status(self._restores, backend_name, backup_id,
                            "restore")

    def _status(self, table, backend_name, backup_id, kind) -> dict:
        with self._lock:
            st = table.get((backend_name, backup_id))
        if st is None:
            raise BackupError(f"no {kind} {backup_id!r} on {backend_name!r}")
        return dict(st)

    # -- helpers -------------------------------------------------------------

    def _backend(self, name: str) -> BackupBackend:
        if self.modules is None:
            raise BackupError("backups require a module provider")
        try:
            return self.modules.backup_backend(name)
        except ModuleError as e:
            raise BackupError(str(e))

    @staticmethod
    def _home(backend, backup_id) -> str:
        try:
            return backend.home_dir(backup_id)
        except Exception:
            return ""
