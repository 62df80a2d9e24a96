"""Collection: shard routing + scatter-gather queries (port of
``weaviate_tpu/db/collection.py``).

Reference: adapters/repos/db/index.go — putObject routes by sharding
state, objectVectorSearch scatter-gathers across shards and merges by
distance; keyword (bm25) and hybrid search scatter-gather the same way,
and a hybrid query on one shard runs as one fused device program. Under
a shard's memory quota the coldest sealed epoch of an epoch-backed index
migrates to a sibling shard on this node behind durable routing markers
(``migrate_epoch``), or to a sibling on a lighter node over the shard
RPC when no local one has room. Multi-tenant collections address one
shard per tenant; a COLD tenant's shard is closed (its device memory
released, its files kept) and a FROZEN tenant's files ship to an offload
backend. In a cluster a shard placed on another node is reached through
``remote`` (``cluster/remote.RemoteShardClient``): writes, reads, counts,
aggregations and the nearVector / BM25 scatter legs go to the owning
node, which searches its shard on its own card and batcher; a shard
whose node is unreachable answers nothing and the query carries a
``missing_shard`` marker. A shard with several replicas (replication
factor above 1) is written through the 2PC coordinator
(``replication.Replicator``) at the write's consistency level and read at
a level through ``replication.Finder`` (digest comparison, read repair);
a query searches the local replica when this node holds one.
"""

from __future__ import annotations

import functools
import logging
import os
import threading
import time
import uuid as uuid_mod
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from weaviate_tpu_torch import native
from weaviate_tpu_torch.db.shard import Shard
from weaviate_tpu_torch.db.sharding import ShardingState
from weaviate_tpu_torch.runtime import degrade
from weaviate_tpu_torch.runtime import metrics as monitoring
from weaviate_tpu_torch.runtime import tracing
from weaviate_tpu_torch.schema.config import CollectionConfig
from weaviate_tpu_torch.storage.objects import StorageObject

logger = logging.getLogger(__name__)


class SearchResult:
    __slots__ = ("uuid", "distance", "score", "object", "shard",
                 "rerank_score")

    def __init__(self, uuid, distance=None, score=None, object=None, shard=None):
        self.uuid = uuid
        self.distance = distance
        self.score = score
        self.object = object
        self.shard = shard
        self.rerank_score = None  # set by the reranker module path

    def __repr__(self):
        return f"SearchResult({self.uuid}, dist={self.distance}, score={self.score})"


def _remote_result(item: dict, shard_name: str) -> "SearchResult":
    raw = item.get("object")
    return SearchResult(
        uuid=item["uuid"], distance=item.get("distance"),
        score=item.get("score"), shard=shard_name,
        object=StorageObject.from_bytes(raw) if raw else None)


def _timed(query_type: str):
    """Record query latency per collection and log queries slower than
    the configured threshold (QUERY_SLOW_LOG_*)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            t0 = time.perf_counter()
            with monitoring.query_duration.labels(self.config.name,
                                                  query_type).time(), \
                    tracing.span(f"query.{query_type}",
                                 collection=self.config.name):
                out = fn(self, *args, **kwargs)
            threshold = tracing.get_slow_threshold()
            if threshold > 0 and not tracing.is_active():
                took = time.perf_counter() - t0
                if took >= threshold:
                    logging.getLogger("weaviate_tpu_torch.slow_query").warning(
                        "slow %s query on %s: %.3fs (threshold %.3fs)",
                        query_type, self.config.name, took, threshold)
            return out

        return wrapper

    return deco


def local_hbm_bytes(provider=None) -> int:
    """This node's device-memory ledger bytes: ``provider()``, or the
    process's ledger when none is given."""
    if provider is not None:
        return int(provider())
    from weaviate_tpu_torch.runtime.hbm_ledger import ledger

    return ledger.total_bytes()


def rank_by_ledger(nodes, reported: dict, local_node: str,
                   local_provider=None) -> list[str]:
    """Placement candidates, lightest device-memory ledger first (a
    stable sort keeps ``nodes``' order among equals). ``reported`` holds
    the peers' gossiped readings; the local node reads its own. Ranking
    engages only once a PEER has reported: comparing the live local
    ledger with unreported peers taken as zero would demote this node on
    every start."""
    nodes = list(nodes)
    if not any(n != local_node for n in reported):
        return nodes
    hbm = dict(reported)
    hbm[local_node] = local_hbm_bytes(local_provider)
    return sorted(nodes, key=lambda n: hbm.get(n, 0))


class Collection:
    def __init__(self, data_dir: str, config: CollectionConfig,
                 sharding_state: ShardingState | None = None, mesh=None,
                 local_node: str = "node-0", on_sharding_change=None,
                 sync_wal: bool | None = None, memwatch=None,
                 remote=None, nodes_provider=None, node_hbm_provider=None,
                 local_hbm_provider=None,
                 async_indexing: bool | None = None, device=None):
        config.validate()
        self.config = config
        self.data_dir = data_dir
        # row-sharded vector stores over a device mesh (parallel/mesh.py):
        # every shard's flat/quantized/epoch index is built on it
        self.mesh = mesh
        self.device = device
        self.memwatch = memwatch
        self.async_indexing = async_indexing  # None = env decides per shard
        self.local_node = local_node
        self.sync_wal = sync_wal  # None = shard reads PERSISTENCE_WAL_SYNC
        # cross-node data plane: shards placed on other nodes are reached
        # through it (None on a single node)
        self.remote = remote
        self._nodes_provider = nodes_provider or (lambda: [local_node])
        # node -> device-memory ledger bytes (gossiped meta in a cluster):
        # feeds placement and the cross-node epoch migration's target
        # choice. None = only the local ledger is known.
        self._node_hbm_provider = node_hbm_provider
        # this node's own reading (None = the process's device-memory
        # ledger, which is this node's when it runs alone in its process)
        self._local_hbm_provider = local_hbm_provider
        self._lock = threading.RLock()
        # reentrancy guard of the epoch memory-pressure rescue (a
        # migration's target-side ingest runs admission too)
        self._rescue_tls = threading.local()
        # at most ONE epoch migration in flight per collection: the mover
        # holds the SOURCE shard's lock across ingest + cutover, and
        # serializing migrations means one thread at most ever nests two
        # shard locks (no ABBA). RLock: a rescue fired from a migration's
        # own target-side admission re-enters.
        self._migrate_lock = threading.RLock()
        # striped read-modify-write locks (PATCH, reference adds)
        self._uuid_locks = [threading.RLock() for _ in range(64)]
        # cluster hook fn(collection_name, [tenant]) routing auto tenant
        # creation through Raft; None = apply locally
        self._auto_tenant_hook = None
        # FROZEN-tier offload target (a backup backend); set by Database
        self.offload_backend = None
        if sharding_state is None:
            if config.multi_tenancy.enabled:
                sharding_state = ShardingState.create_partitioned()
            else:
                # placement by device-memory headroom: the round-robin
                # starts at the lightest node
                sharding_state = ShardingState.create(
                    config.sharding.desired_count,
                    nodes=self._placement_nodes(),
                    replication_factor=config.replication.factor)
        self.sharding = sharding_state
        # persistence hook: auto-created tenants must reach the schema
        # store or they vanish from the sharding state on restart
        self._on_sharding_change = on_sharding_change or (lambda col: None)
        self.shards: dict[str, Shard] = {}
        for name in self.sharding.shard_names:
            if self.local_node in self.sharding.nodes_for(name) and \
                    self.sharding.status_of(name) not in ("COLD", "FROZEN"):
                self._load_shard(name)  # COLD/FROZEN tenants stay unloaded
        self._pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix=f"{config.name}-search")
        # hot/cold tenant tracking (reference: entities/tenantactivity +
        # rest/tenantactivity/handler.go): tenant -> last access stamps
        self.tenant_activity: dict[str, dict] = {}

    def uuid_lock(self, uuid: str) -> threading.RLock:
        """Lock guarding read-modify-write of one object (sharded by uuid
        hash; collisions just serialize two unrelated RMWs, never deadlock
        since callers take at most one)."""
        return self._uuid_locks[hash(uuid) % len(self._uuid_locks)]

    def _is_local(self, shard_name: str) -> bool:
        return self.local_node in self.sharding.nodes_for(shard_name)

    def _record_tenant(self, tenant: str | None, kind: str) -> None:
        if not tenant or not self.config.multi_tenancy.enabled:
            return
        now = time.time()
        with self._lock:  # REST reads snapshot under the same lock
            entry = self.tenant_activity.setdefault(
                tenant, {"reads": 0, "writes": 0, "lastRead": None,
                         "lastWrite": None})
            if kind == "read":
                entry["reads"] += 1
                entry["lastRead"] = now
            else:
                entry["writes"] += 1
                entry["lastWrite"] = now

    def tenant_activity_snapshot(self) -> dict:
        with self._lock:
            return {t: dict(v) for t, v in self.tenant_activity.items()}

    def apply_runtime_config(self) -> None:
        """Propagate runtime-mutable config (reference: UpdateUserConfig ->
        hnsw/config_update.go) into LIVE shard objects, which copied config
        values at construction: BM25 k1/b, the per-index search knobs
        (ef / rescore / nprobe / upgrade threshold, set where the live
        index has the attribute) and runtime compression."""
        with self._lock:
            shards = list(self.shards.values())
        for shard in shards:
            inv = shard._inverted
            inv.k1 = self.config.inverted.bm25_k1
            inv.b = self.config.inverted.bm25_b
            for vec_name, idx in shard.vector_indexes.items():
                vc = self.config.vector_config(vec_name)
                if idx is None or vc is None:
                    continue
                for attr, value in (
                    ("ef", vc.index.ef),
                    ("rescore_limit", vc.index.rescore_limit),
                    ("nprobe", vc.index.ivf_nprobe),
                    ("threshold", vc.index.flat_to_ann_threshold),
                ):
                    # 0 is meaningful (= auto); only skip absent values
                    if hasattr(idx, attr) and value is not None:
                        setattr(idx, attr, value)
                if vc.index.quantization and not idx.compressed and \
                        hasattr(idx, "compress"):
                    # runtime compression (compress.go:38): train on the
                    # live contents and swap to the compressed path. Too
                    # little data to train is not an error: the config
                    # sticks and a later update or restart retries
                    try:
                        idx.compress(
                            quantization=vc.index.quantization,
                            pq_segments=vc.index.pq_segments,
                            pq_centroids=vc.index.pq_centroids,
                        )
                    except (RuntimeError, ValueError) as e:
                        logger.warning(
                            "collection %s/%s: deferring runtime "
                            "compression: %s", self.config.name, vec_name, e)

    # -- shard management ----------------------------------------------------

    def _load_shard(self, name: str) -> Shard:
        # check-then-insert under the lock: two writers must not build two
        # Shard objects (two WALs, two doc counters) for one shard
        with self._lock:
            if name not in self.shards:
                shard = Shard(
                    self.data_dir, self.config, name, sync_wal=self.sync_wal,
                    memwatch=self.memwatch,
                    async_indexing=self.async_indexing, device=self.device,
                    mesh=self.mesh)
                # admission rescue: compact tombstone-heavy epochs, then
                # migrate the coldest sealed epoch to a sibling with
                # headroom, BEFORE a 507 latches
                shard.memory_rescue = (
                    lambda s=shard: self._rescue_shard(s))
                self.shards[name] = shard
            return self.shards[name]

    def _require_active(self, tenant: str) -> None:
        """COLD/FROZEN tenants reject access unless auto-activation is on
        (reference: tenant activityStatus + autoTenantActivation)."""
        status = self.sharding.status_of(tenant)
        if status in ("COLD", "FROZEN"):
            if self.config.multi_tenancy.auto_tenant_activation:
                self.set_tenant_status(tenant, "HOT")
            else:
                raise ValueError(
                    f"tenant {tenant!r} is not active (activityStatus "
                    f"{status}); activate it or enable "
                    "autoTenantActivation")

    def _check_tenant(self, tenant: str | None, kind: str = "read") -> None:
        if self.config.multi_tenancy.enabled:
            if not tenant:
                raise ValueError("multi-tenant collection requires a tenant")
            if tenant not in self.sharding.shard_names:
                raise KeyError(f"tenant {tenant!r} does not exist")
            self._require_active(tenant)
            self._record_tenant(tenant, kind)

    def _ensure_tenant_shard(self, tenant: str | None) -> None:
        """A write's tenant: an existing one must be active; a missing one
        is created when ``autoTenantCreation`` is on, locally on one node
        and through the cluster's hook (Raft) on a cluster."""
        if not self.config.multi_tenancy.enabled:
            return
        with self._lock:
            if tenant in self.sharding.shard_names:
                self._require_active(tenant)
                self._record_tenant(tenant, "write")
                return
            if not self.config.multi_tenancy.auto_tenant_creation:
                raise KeyError(f"tenant {tenant!r} does not exist")
            hook = self._auto_tenant_hook
            if hook is None:
                self.sharding.add_tenant(
                    tenant, nodes=self._nodes_provider(),
                    replication_factor=self.config.replication.factor)
                self._on_sharding_change(self)
                self._record_tenant(tenant, "write")
                return
        # cluster: the tenant goes through Raft so every node applies the
        # same placement. Called OUTSIDE the collection lock: the FSM apply
        # (another thread on followers) needs that lock to add the tenant.
        hook(self.config.name, [tenant])
        if tenant not in self.sharding.shard_names:
            raise RuntimeError(f"auto tenant creation for {tenant!r} did "
                               "not converge")
        self._record_tenant(tenant, "write")

    def _reported_hbm(self) -> dict:
        """The device-memory provider's reading (gossiped ``hbmBytes`` meta
        in a cluster), {} when none is wired or it fails: stale gossip
        must never fail a collection's creation or a migration."""
        if self._node_hbm_provider is None:
            return {}
        try:
            return {str(k): int(v) for k, v in
                    dict(self._node_hbm_provider()).items()}
        except Exception:  # noqa: BLE001
            return {}

    def _node_hbm_bytes(self, reported: dict | None = None) -> dict:
        """node -> known device-memory ledger bytes. The local node reads
        its own ledger; other nodes come from the provider (``reported``
        reuses a reading already fetched)."""
        out = dict(reported) if reported is not None \
            else self._reported_hbm()
        out[self.local_node] = local_hbm_bytes(self._local_hbm_provider)
        return out

    def _placement_nodes(self) -> list[str]:
        return rank_by_ledger(self._nodes_provider(), self._reported_hbm(),
                              self.local_node, self._local_hbm_provider)

    def _require_remote(self, shard_name: str):
        if self.remote is None:
            raise RuntimeError(
                f"shard {shard_name!r} is placed on "
                f"{self.sharding.nodes_for(shard_name)} but node "
                f"{self.local_node!r} has no remote client configured")
        return self.remote

    def _read_node(self, shard_name: str) -> str:
        """The node a read goes to: this one if it owns the shard, else
        the placed node."""
        if self._is_local(shard_name):
            return self.local_node
        return self.sharding.nodes_for(shard_name)[0]

    def _remote_search_degraded(self, shard_name: str, **kwargs):
        """A remote shard's scatter leg: the placed node answers, or, when
        it is unreachable (the per-peer circuit breaker makes a known-dead
        node cost ~0 of the deadline), the leg returns ``None``, the query
        still answers without that shard, and a ``missing_shard`` marker
        rides the response."""
        from weaviate_tpu_torch.cluster.transport import RpcError

        remote = self._require_remote(shard_name)
        nodes = [n for n in self.sharding.nodes_for(shard_name)
                 if n != self.local_node]
        last: Exception | None = None
        for node in nodes:
            try:
                return remote.search_shard(node, self.config.name,
                                           shard_name, **kwargs)
            except RpcError as e:
                last = e
                logger.warning("node %s failed for %s/%s: %s",
                               node, self.config.name, shard_name, e)
        degrade.report("missing_shard", collection=self.config.name,
                       shard=shard_name,
                       detail=str(last) if last is not None
                       else "no reachable replica")
        return None

    def _target_shard_names(self, tenant: str | None,
                            kind: str = "read") -> list[str]:
        if self.config.multi_tenancy.enabled:
            if not tenant:
                raise ValueError("multi-tenant collection requires a tenant")
            if tenant not in self.sharding.shard_names:
                raise KeyError(f"tenant {tenant!r} does not exist")
            self._require_active(tenant)
            self._record_tenant(tenant, kind)
            return [tenant]
        return list(self.sharding.shard_names)

    def _target_shards(self, tenant: str | None = None) -> list[Shard]:
        """The LOCAL shards a query addresses (all of them on one node; the
        subset placed here in a cluster)."""
        return [self._load_shard(n) for n in self._target_shard_names(tenant)
                if self._is_local(n)]

    # -- tenants -------------------------------------------------------------

    def add_tenant(self, tenant: str, nodes: list[str] | None = None):
        with self._lock:
            self.sharding.add_tenant(
                tenant, nodes=nodes or self._nodes_provider(),
                replication_factor=self.config.replication.factor)
            if self._is_local(tenant):
                self._load_shard(tenant)
            self._on_sharding_change(self)

    def remove_tenant(self, tenant: str):
        with self._lock:
            shard = self.shards.pop(tenant, None)
            if shard is not None:
                shard.close()
            self.sharding.remove_tenant(tenant)

    def tenants(self) -> list[str]:
        return list(self.sharding.shard_names) \
            if self.config.multi_tenancy.enabled else []

    def set_tenant_status(self, tenant: str, status: str) -> None:
        """HOT/COLD/FROZEN tenant offload (reference: PUT tenants with
        activityStatus). COLD closes the shard, which releases its device
        memory; its files stay on disk. FROZEN ships the files to the
        offload backend and removes them locally. HOT loads it back."""
        status = status.upper()
        if status not in ("HOT", "COLD", "FROZEN"):
            raise ValueError(
                "tenant activityStatus must be HOT, COLD or FROZEN")
        if tenant not in self.sharding.shard_names:
            raise KeyError(f"tenant {tenant!r} does not exist")
        with self._lock:
            prev = self.sharding.status_of(tenant)
            if status == prev:
                return
            # the side effect runs BEFORE the status commits: a failed
            # freeze/thaw (no offload backend, backend error) leaves the
            # tenant in its previous, working state instead of wedged
            if prev == "FROZEN" and status in ("HOT", "COLD"):
                self._unfreeze_tenant(tenant)
            if status == "FROZEN":
                self._freeze_tenant(tenant)
            elif status == "COLD":
                shard = self.shards.pop(tenant, None)
                if shard is not None:
                    shard.close()
            elif self._is_local(tenant):
                self._load_shard(tenant)
            self.sharding.tenant_status[tenant] = status
            self._on_sharding_change(self)

    def _offload_backend(self):
        backend = self.offload_backend
        if backend is None:
            raise RuntimeError(
                "FROZEN tenants need an offload backend: configure a "
                "backup module and OFFLOAD_BACKEND (reference: offload-s3 "
                "module + tenant activityStatus FROZEN)")
        return backend

    def _offload_id(self, tenant: str) -> str:
        return f"tenant-offload--{self.config.name}--{tenant}"

    def _freeze_tenant(self, tenant: str) -> None:
        """Stream the tenant's shard files to the offload backend, then
        delete them locally (reference: FROZEN tier — local resources are
        released entirely; files live in cloud storage)."""
        import json as _json
        import shutil as _shutil

        from weaviate_tpu_torch.backup.cluster import put_file_compressed
        from weaviate_tpu_torch.modules.backup_backends import walk_files

        backend = self._offload_backend()
        shard = self.shards.pop(tenant, None)
        if shard is not None:
            shard.flush()
            shard.close()
        sh_dir = os.path.join(self.data_dir, self.config.name, tenant)
        oid = self._offload_id(tenant)
        backend.initialize(oid)
        # an empty tenant still gets a manifest — thawing must always find
        # one (a manifest-less freeze would wedge the tenant FROZEN)
        stored = [put_file_compressed(backend, oid, rel,
                                      os.path.join(sh_dir, rel))
                  for rel in (walk_files(sh_dir)
                              if os.path.isdir(sh_dir) else [])]
        backend.put(oid, "manifest.json",
                    _json.dumps({"files": stored}).encode())
        _shutil.rmtree(sh_dir, ignore_errors=True)

    def _unfreeze_tenant(self, tenant: str) -> None:
        import json as _json

        from weaviate_tpu_torch.backup.cluster import (get_file_decompressed,
                                                       logical_name)

        backend = self._offload_backend()
        oid = self._offload_id(tenant)
        try:
            manifest = _json.loads(backend.get(oid, "manifest.json"))
        except KeyError:
            # tenant frozen by a pre-manifest version or never offloaded
            # data — nothing to pull back
            manifest = {"files": []}
        sh_dir = os.path.abspath(
            os.path.join(self.data_dir, self.config.name, tenant))
        for stored in manifest.get("files", []):
            dst = os.path.abspath(
                os.path.join(sh_dir, logical_name(stored)))
            if not dst.startswith(sh_dir + os.sep):
                raise ValueError(
                    f"offload manifest path {stored!r} escapes the shard")
            get_file_decompressed(backend, oid, stored, dst)

    # -- object CRUD ---------------------------------------------------------

    def put_object(self, properties: dict, vector=None, vectors: dict | None = None,
                   uuid: str | None = None, creation_time_ms: int = 0,
                   tenant: str | None = None,
                   consistency: str = "QUORUM") -> str:
        """``creation_time_ms``: carried through on updates so a re-put
        keeps the original creation stamp."""
        uuid = uuid or str(uuid_mod.uuid4())
        obj = StorageObject(uuid=uuid, properties=properties,
                            creation_time_ms=creation_time_ms)
        if creation_time_ms:
            obj.last_update_time_ms = int(time.time() * 1000)
        if vector is not None:
            obj.vector = np.asarray(vector, dtype=np.float32)
        for name, vec in (vectors or {}).items():
            obj.vectors[name] = np.asarray(vec, dtype=np.float32)
        if self.config.multi_tenancy.enabled:
            self._ensure_tenant_shard(tenant)
        self._write_to_shard(self.sharding.shard_for(uuid, tenant), [obj],
                             consistency)
        monitoring.objects_total.labels(self.config.name, "put").inc()
        return uuid

    def _write_to_shard(self, shard_name: str, objs: list[StorageObject],
                        consistency: str = "QUORUM") -> None:
        """Write a batch to the shard's replicas. A replicated shard takes
        the 2PC coordinator (reference: replica.Replicator,
        replicator.go:57); a single-replica shard is written here, or on
        its node over the shard RPC (the objects cross as their stored
        bytes)."""
        nodes = self.sharding.nodes_for(shard_name)
        if len(nodes) > 1:
            from weaviate_tpu_torch.replication import Replicator

            Replicator(self).put_objects(shard_name, objs, consistency)
            return
        node = nodes[0]
        if node != self.local_node:
            self._require_remote(shard_name).put_objects(
                node, self.config.name, shard_name,
                [o.to_bytes() for o in objs])
            return
        shard = self._load_shard(shard_name)
        shard.put_object_batch(objs)
        # clean any migrated sibling copy AFTER the fresh write landed: a
        # 507 or crash before the write must leave the old copy intact
        # (present twice is deduped; lost is lost)
        self._unmigrate(shard, objs)

    def batch_put(self, objects: list[dict], tenant: str | None = None,
                  consistency: str = "QUORUM") -> list[dict]:
        """Batch import; per-object error reporting, not transactional
        (reference: usecases/objects/batch_add.go)."""
        results = []
        by_shard: dict[str, list[StorageObject]] = {}
        metas: dict[str, list[int]] = {}
        for i, spec in enumerate(objects):
            try:
                uid = spec.get("uuid") or str(uuid_mod.uuid4())
                obj = StorageObject(uuid=uid,
                                    properties=spec.get("properties", {}))
                if spec.get("vector") is not None:
                    obj.vector = np.asarray(spec["vector"], dtype=np.float32)
                for name, vec in (spec.get("vectors") or {}).items():
                    obj.vectors[name] = np.asarray(vec, dtype=np.float32)
                shard_name = self.sharding.shard_for(uid, tenant)
                by_shard.setdefault(shard_name, []).append(obj)
                metas.setdefault(shard_name, []).append(i)
                results.append({"uuid": uid, "status": "SUCCESS"})
            except Exception as e:  # per-object failure, keep going
                results.append({"uuid": spec.get("uuid"), "status": "FAILED",
                                "error": str(e)})
        for shard_name, objs in by_shard.items():
            try:
                if self.config.multi_tenancy.enabled:
                    self._ensure_tenant_shard(shard_name)
                self._write_to_shard(shard_name, objs, consistency)
                monitoring.objects_total.labels(self.config.name, "put"
                                                ).inc(len(objs))
            except MemoryError:
                # device memory exhaustion must surface, not dissolve into
                # per-object FAILED entries
                raise
            except Exception as e:
                for i in metas[shard_name]:
                    results[i] = {"uuid": results[i]["uuid"], "status": "FAILED",
                                  "error": str(e)}
        return results

    def get_object(self, uuid: str, tenant: str | None = None,
                   consistency: str | None = None) -> StorageObject | None:
        """``consistency``: None = direct read from the preferred replica;
        a level (ONE/QUORUM/ALL) = digest-compared read with read repair
        (reference: Finder.Pull, coordinator.go:178)."""
        self._check_tenant(tenant)
        name = self.sharding.shard_for(uuid, tenant)
        if consistency is not None and len(self.sharding.nodes_for(name)) > 1:
            from weaviate_tpu_torch.replication import Finder

            return Finder(self).get_object(uuid, name, consistency)
        if not self._is_local(name):
            raw = self._require_remote(name).get_object(
                self._read_node(name), self.config.name, name, uuid)
            return None if raw is None else StorageObject.from_bytes(raw)
        shard = self._load_shard(name)
        obj = shard.get_object(uuid)
        if obj is None:
            # epoch migration moved this object to a sibling (on this node
            # or another): the durable marker keeps the routing right
            dst = shard.migrated_to(uuid)
            if dst and dst != name:
                if self._is_local(dst):
                    return self._load_shard(dst).get_object(uuid)
                if self.remote is not None:
                    raw = self.remote.get_object(
                        self._read_node(dst), self.config.name, dst, uuid)
                    if raw is not None:
                        return StorageObject.from_bytes(raw)
        return obj

    def delete_object(self, uuid: str, tenant: str | None = None,
                      consistency: str = "QUORUM") -> bool:
        self._check_tenant(tenant, kind="write")  # deletes are writes
        name = self.sharding.shard_for(uuid, tenant)
        nodes = self.sharding.nodes_for(name)
        if len(nodes) > 1:
            from weaviate_tpu_torch.replication import Replicator

            ok = Replicator(self).delete(name, uuid, consistency)
        elif nodes[0] != self.local_node:
            ok = self._require_remote(name).delete_object(
                nodes[0], self.config.name, name, uuid)
        else:
            shard = self._load_shard(name)
            ok = shard.delete_object(uuid)
            # a migrated copy (or the crash window's second copy) lives at
            # the marker's destination: delete it too so no copy remains,
            # and drop the marker (a cross-node move deletes over the RPC)
            dst = shard.migrated_to(uuid)
            if dst and dst != name:
                if self._is_local(dst):
                    ok = self._load_shard(dst).delete_object(uuid) or ok
                elif self.remote is not None:
                    ok = self.remote.delete_object(
                        self._read_node(dst), self.config.name, dst,
                        uuid) or ok
            if dst:
                shard.clear_migrated(uuid)
        if ok:
            monitoring.objects_total.labels(self.config.name, "delete").inc()
        return ok

    def object_count(self, tenant: str | None = None) -> int:
        """One replica per shard counts (replicas would double-count)."""
        if self.config.multi_tenancy.enabled and not tenant:
            return 0
        total = 0
        for name in self._target_shard_names(tenant):
            if self._is_local(name):
                total += self._load_shard(name).object_count()
            elif self.remote is not None:
                total += self.remote.overview(
                    self._read_node(name), self.config.name,
                    name)["object_count"]
        return total

    def batch_delete(self, where, tenant: str | None = None,
                     dry_run: bool = False, verbose: bool = False,
                     consistency: str = "QUORUM",
                     max_matches: int = 10_000) -> dict:
        """Delete all objects matching a filter (reference: batch_delete —
        REST DELETE /v1/batch/objects and gRPC BatchDelete; match set capped
        at QUERY_MAXIMUM_RESULTS like the reference's dryRun/match cap).
        Returns {"matches", "successful", "failed", "objects": [...]}, where
        ``objects`` is populated per-uuid only when ``verbose``."""
        names = self._target_shard_names(tenant, kind="write")
        uuids: list[str] = []
        for name in names:
            if len(uuids) >= max_matches:
                break
            if not self._is_local(name):
                raws = self._require_remote(name).list_objects(
                    self._read_node(name), self.config.name, name,
                    limit=max_matches - len(uuids),
                    where=where.to_dict() if where is not None else None)
                uuids.extend(StorageObject.from_bytes(r).uuid for r in raws)
                continue
            shard = self._load_shard(name)
            mask = shard.allow_mask(where) if where is not None else None
            with shard._lock:
                items = list(shard._doc_to_uuid.items())
            for doc_id, uid in items:
                if mask is not None and (doc_id >= len(mask)
                                         or not mask[doc_id]):
                    continue
                uuids.append(uid)
                if len(uuids) >= max_matches:
                    break
        result = {"matches": len(uuids), "successful": 0, "failed": 0,
                  "objects": []}
        for uid in uuids:
            if dry_run:
                ok, err = True, None
            else:
                try:
                    ok = self.delete_object(uid, tenant, consistency)
                    err = None if ok else "not found"
                except Exception as e:  # per-object errors, not transactional
                    ok, err = False, str(e)
            result["successful" if ok else "failed"] += 1
            if verbose:
                entry = {"id": uid, "successful": ok}
                if err:
                    entry["error"] = err
                result["objects"].append(entry)
        return result

    def iter_objects(self, tenant: str | None = None):
        for shard in self._target_shards(tenant):
            for key, raw in shard.objects.iter_items():
                yield StorageObject.from_bytes(raw)

    def fetch_objects(self, limit: int = 25, offset: int = 0,
                      sort: list[dict] | None = None, where=None,
                      tenant: str | None = None,
                      after: str | None = None) -> list[StorageObject]:
        """List objects with optional filter/sort/cursor (reference:
        /v1/objects listing; sorter/objects_sorter.go; cursor via ?after=
        which requires uuid order — sort and after are mutually exclusive,
        as in the reference API)."""
        from weaviate_tpu_torch.query.sorter import sort_objects

        if after is not None and sort:
            raise ValueError("'after' cursor cannot be combined with sort")
        names = self._target_shard_names(tenant)
        where_dict = where.to_dict() if where is not None else None
        if sort:
            # property sort needs the values: materialize candidates
            objs: list[StorageObject] = []
            for name in names:
                if not self._is_local(name):
                    raws = self._require_remote(name).list_objects(
                        self._read_node(name), self.config.name, name,
                        where=where_dict)
                    objs.extend(StorageObject.from_bytes(r) for r in raws)
                    continue
                shard = self._load_shard(name)
                mask = shard.allow_mask(where) if where is not None else None
                for _key, raw in shard.objects.iter_items():
                    obj = StorageObject.from_bytes(raw)
                    if mask is not None and (obj.doc_id >= len(mask)
                                             or not mask[obj.doc_id]):
                        continue
                    objs.append(obj)
            return sort_objects(objs, sort)[offset: offset + limit]
        # uuid-ordered page: select uuids from the in-RAM docid map (or a
        # remote page), only deserialize what is actually returned
        candidates: list[tuple[str, object]] = []  # (uuid, shard name | obj)
        for name in names:
            if not self._is_local(name):
                # each remote shard over-fetches its own first
                # offset+limit matches; the merge below trims to the page
                raws = self._require_remote(name).list_objects(
                    self._read_node(name), self.config.name, name,
                    limit=offset + limit, after=after, where=where_dict)
                for raw in raws:
                    obj = StorageObject.from_bytes(raw)
                    candidates.append((obj.uuid, obj))
                continue
            shard = self._load_shard(name)
            mask = shard.allow_mask(where) if where is not None else None
            with shard._lock:  # snapshot: writers mutate _doc_to_uuid
                items = list(shard._doc_to_uuid.items())
            for doc_id, uid in items:
                if mask is not None and (doc_id >= len(mask)
                                         or not mask[doc_id]):
                    continue
                if after is not None and uid <= after:
                    continue
                candidates.append((uid, name))
        candidates.sort(key=lambda t: t[0])
        page = candidates[offset: offset + limit]
        out = []
        for uid, src in page:
            obj = src if isinstance(src, StorageObject) else \
                self._load_shard(src).get_object(uid)
            if obj is not None:
                out.append(obj)
        return out

    # -- aggregation ---------------------------------------------------------

    @_timed("aggregate")
    def aggregate(self, properties: list[str] | None = None,
                  group_by: str | None = None, where=None,
                  tenant: str | None = None,
                  requested: dict[str, list[str]] | None = None,
                  near_vector=None, near_vec_name: str = "",
                  near_max_distance: float | None = None,
                  object_limit: int | None = None,
                  top_occurrences_limit: int = 5) -> dict:
        """Scatter-gather aggregation (reference: aggregator/aggregator.go →
        per-shard fold, shard_combiner.go merge). With ``near_vector`` +
        ``object_limit``, aggregates over the top-k of a vector search
        instead of the whole (filtered) corpus (aggregator/hybrid.go)."""
        from weaviate_tpu_torch.query.aggregator import (
            aggregate_objects,
            combine_partials,
            finalize_aggregation,
        )

        if near_vector is not None:
            k = object_limit or 100
            hits = self.near_vector(near_vector, k=k, tenant=tenant,
                                    vec_name=near_vec_name,
                                    include_objects=True, where=where,
                                    max_distance=near_max_distance)
            partials = [aggregate_objects((r.object for r in hits if r.object),
                                          properties, group_by)]
        else:
            def one(name: str):
                if not self._is_local(name):
                    return self._require_remote(name).aggregate(
                        self._read_node(name), self.config.name, name,
                        properties, group_by,
                        where.to_dict() if where is not None else None)
                shard = self._load_shard(name)
                mask = shard.allow_mask(where) if where is not None else None

                def objs():
                    for _key, raw in shard.objects.iter_items():
                        obj = StorageObject.from_bytes(raw)
                        if mask is not None and (obj.doc_id >= len(mask)
                                                 or not mask[obj.doc_id]):
                            continue
                        yield obj

                return aggregate_objects(objs(), properties, group_by)

            names = self._target_shard_names(tenant)
            partials = [one(names[0])] if len(names) == 1 else \
                list(self._pool.map(tracing.propagate(one), names))
        return finalize_aggregation(combine_partials(partials), requested,
                                    top_occurrences_limit)

    # -- search --------------------------------------------------------------

    def _attach_objects(self, results: list[SearchResult]) -> None:
        """Fill in .object for results that don't carry one yet: a local
        lookup, or ONE batched remote get per remote shard."""
        missing: dict[str, list[SearchResult]] = {}
        for r in results:
            if r.object is None:
                missing.setdefault(r.shard, []).append(r)
        if not missing:
            return
        from weaviate_tpu_torch.cluster.transport import RpcError

        with tracing.span("objects.fetch",
                          n=sum(len(rs) for rs in missing.values()),
                          shards=len(missing)):
            for name, rs in missing.items():
                if self._is_local(name):
                    shard = self._load_shard(name)
                    for r in rs:
                        r.object = shard.get_object(r.uuid)
                    continue
                try:
                    raws = self._require_remote(name).get_objects(
                        self._read_node(name), self.config.name, name,
                        [r.uuid for r in rs])
                except RpcError as e:
                    # the node died between the search and the fetch: serve
                    # the ids and distances with a degraded marker
                    degrade.report("objects_unavailable",
                                   collection=self.config.name,
                                   shard=name, detail=str(e))
                    continue
                for r, raw in zip(rs, raws):
                    r.object = StorageObject.from_bytes(raw) if raw else None

    @staticmethod
    def _merge_by_distance(gathered: list[list], k: int) -> list:
        """Cross-shard reduce: each shard's list is already ascending;
        a stable merge keeps the first shard's entry on ties. An epoch
        migration's crash window can leave an object on two shards for a
        while: it is never served twice (dedup by uuid, the best distance
        first, over a merge of 2k so the k contract holds)."""
        lists = [g for g in gathered if g]
        if not lists:
            return []
        if len(lists) == 1:
            return lists[0][:k]
        width = max(len(g) for g in lists)
        d = np.full((len(lists), width), np.float32(3.0e38), dtype=np.float32)
        idx = np.full((len(lists), width), -1, dtype=np.int64)
        flat: list = []
        for li, g in enumerate(lists):
            for pos, r in enumerate(g):
                d[li, pos] = r.distance
                idx[li, pos] = len(flat)
                flat.append(r)
        _, out_i = native.merge_topk_host(d, idx, k=min(2 * k, len(flat)))
        out, seen = [], set()
        for i in out_i.tolist():
            if i < 0:
                continue
            r = flat[i]
            if r.uuid in seen:
                continue
            seen.add(r.uuid)
            out.append(r)
            if len(out) == k:
                break
        return out

    @staticmethod
    def _and_masks(a, b) -> np.ndarray:
        """Intersect two allow lists (bool mask or doc-id array forms)."""
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != np.bool_ and b.dtype != np.bool_:
            # both doc-id arrays: sorted-set intersect (the roaring AND of
            # the reference)
            return native.intersect_sorted(
                np.unique(a), np.unique(b)).astype(np.int64)

        def to_mask(x, size):
            if x.dtype == np.bool_:
                m = np.zeros(size, dtype=bool)
                m[: len(x)] = x
                return m
            m = np.zeros(size, dtype=bool)
            m[x[x < size]] = True
            return m

        size = max(len(a) if a.dtype == np.bool_ else (int(a.max()) + 1 if len(a) else 0),
                   len(b) if b.dtype == np.bool_ else (int(b.max()) + 1 if len(b) else 0))
        return to_mask(a, size) & to_mask(b, size)

    def _shard_allow(self, shard: Shard, name: str, allow_list_by_shard, where):
        """The allow list a shard's leg runs under: the caller's per-shard
        list ANDed with the shard's evaluation of ``where``."""
        allow = None if allow_list_by_shard is None else \
            allow_list_by_shard.get(name)
        if where is not None:
            fmask = shard.allow_mask(where)
            allow = fmask if allow is None else self._and_masks(allow, fmask)
        return allow

    @_timed("vector")
    def near_vector(self, query, k: int = 10, vec_name: str = "",
                    include_objects: bool = True,
                    where=None, allow_list_by_shard: dict | None = None,
                    max_distance: float | None = None,
                    autocut: int = 0,
                    tenant: str | None = None) -> list[SearchResult]:
        """Scatter-gather nearVector: per-shard search (the ``where``
        filter evaluated per shard to an AllowList mask applied inside the
        device scan, ANDed with ``allow_list_by_shard``'s list), merged by
        distance and truncated to k."""
        query = np.asarray(query, dtype=np.float32)
        names = self._target_shard_names(tenant)

        def one(name: str) -> list[SearchResult]:
            if not self._is_local(name):
                # the owning node evaluates the filter and resolves the
                # objects; an unreachable node degrades to missing_shard
                items = self._remote_search_degraded(
                    name, vector=query, k=k, vec_name=vec_name,
                    where=where.to_dict() if where is not None else None,
                    include_objects=include_objects)
                return [] if items is None else \
                    [_remote_result(i, name) for i in items]
            shard = self._load_shard(name)
            allow = self._shard_allow(shard, name, allow_list_by_shard, where)
            ids, dists = shard.vector_search(query, k, vec_name, allow)
            out = []
            for doc_id, dist in zip(ids.tolist(), dists.tolist()):
                uuid = shard._doc_to_uuid.get(doc_id)
                if uuid is not None:
                    out.append(SearchResult(uuid=uuid, distance=dist, shard=name))
            return out

        gathered = [one(names[0])] if len(names) == 1 else \
            list(self._pool.map(tracing.propagate(one), names))
        merged = self._merge_by_distance(gathered, k)
        if max_distance is not None:
            merged = [r for r in merged if r.distance <= max_distance]
        if autocut > 0 and merged:
            from weaviate_tpu_torch.query.autocut import autocut as _autocut

            merged = merged[: _autocut([r.distance for r in merged], autocut)]
        if include_objects:
            self._attach_objects(merged)
        return merged

    @_timed("bm25")
    def bm25(self, query: str, k: int = 10, properties: list[str] | None = None,
             include_objects: bool = True,
             allow_list_by_shard: dict | None = None,
             where=None, autocut: int = 0,
             tenant: str | None = None) -> list[SearchResult]:
        """Scatter-gather keyword search; merge by score descending
        (reference: Index.objectSearch -> per-shard BM25 -> merge)."""
        names = self._target_shard_names(tenant)

        def one(name: str) -> list[SearchResult]:
            if not self._is_local(name):
                items = self._remote_search_degraded(
                    name, query=query, k=k, properties=properties,
                    where=where.to_dict() if where is not None else None,
                    include_objects=include_objects)
                return [] if items is None else \
                    [_remote_result(i, name) for i in items]
            shard = self._load_shard(name)
            allow = self._shard_allow(shard, name, allow_list_by_shard, where)
            ids, scores = shard.bm25_search(query, k, properties, allow)
            return self._results(shard, name, ids, scores)

        gathered = [one(names[0])] if len(names) == 1 else \
            list(self._pool.map(tracing.propagate(one), names))

        merged = [r for results in gathered for r in results]
        merged.sort(key=lambda r: -r.score)
        merged = merged[:k]
        if autocut > 0 and merged:
            from weaviate_tpu_torch.query.autocut import autocut as _autocut

            merged = merged[: _autocut([-r.score for r in merged], autocut)]
        if include_objects:
            self._attach_objects(merged)
        return merged

    @staticmethod
    def _results(shard: Shard, name: str, ids, scores) -> list[SearchResult]:
        """Score-ranked shard rows -> SearchResults (rows whose doc id no
        longer maps to a uuid are dropped)."""
        out = []
        for doc_id, score in zip(ids.tolist(), scores.tolist()):
            uuid = shard._doc_to_uuid.get(doc_id)
            if uuid is not None:
                out.append(SearchResult(uuid=uuid, score=score, shard=name))
        return out

    @_timed("hybrid")
    def hybrid(self, query: str, vector=None, alpha: float = 0.75, k: int = 10,
               properties: list[str] | None = None, vec_name: str = "",
               fusion: str = "relativeScore", where=None,
               include_objects: bool = True,
               autocut: int = 0,
               tenant: str | None = None) -> list[SearchResult]:
        """Hybrid sparse+dense search (reference: hybrid/searcher.go:74 runs
        both legs in parallel, then fuses). ``alpha`` weighs the dense leg
        (0 = pure BM25, 1 = pure vector). ``vector=None`` degrades to
        sparse-only, as the reference does without a vectorizer.

        Single-shard queries with a query vector take the fused DEVICE
        path first: one batched device program runs the dense scan,
        scores the packed BM25 candidates, and fuses — the host
        two-thread reference below stays the fallback (and the parity
        oracle) for everything the device path declines."""
        from weaviate_tpu_torch.text.hybrid import (fusion_ranked,
                                                    fusion_relative_score)

        if vector is None:
            alpha = 0.0  # degrade to sparse-only (reference does the same
            # when no vectorizer can produce a query vector)
        # evaluate the filter once per shard and let both legs reuse the
        # masks when every target shard is local; with remote shards the
        # filter tree travels down instead
        names = self._target_shard_names(tenant)
        allow_by_shard = None
        where_down = where
        if where is not None and all(self._is_local(n) for n in names):
            allow_by_shard = {n: self._load_shard(n).allow_mask(where)
                              for n in names}
            where_down = None

        if (vector is not None and len(names) == 1
                and self._is_local(names[0]) and where_down is None):
            dev = self._hybrid_device(
                names[0], query, vector, alpha, k, properties, vec_name,
                fusion, None if allow_by_shard is None
                else allow_by_shard.get(names[0]))
            if dev is not None:
                return self._finish_hybrid(dev, autocut, include_objects)

        # over-fetch each leg so fusion has overlap to work with; legs run
        # on ephemeral threads, NOT self._pool — a leg parked in a pool
        # worker while its inner scatter-gather waits for that same pool
        # can deadlock
        fetch = max(k * 10, 100)
        legs, weights = [], []
        results: dict[str, list] = {}
        errors: dict[str, BaseException] = {}

        def run(name, fn, *a, **kw):
            try:
                results[name] = fn(*a, **kw)
            except BaseException as e:  # re-raised on the caller thread
                errors[name] = e

        # legs skip object fetch; only the fused top-k pays for it below
        # (tracing.propagate: Thread targets don't inherit contextvars)
        threads = []
        if alpha < 1.0:
            threads.append(threading.Thread(
                target=tracing.propagate(run),
                args=("sparse", self.bm25, query, fetch, properties),
                kwargs=dict(include_objects=False,
                            allow_list_by_shard=allow_by_shard,
                            where=where_down, tenant=tenant)))
        if vector is not None and alpha > 0.0:
            threads.append(threading.Thread(
                target=tracing.propagate(run),
                args=("dense", self.near_vector, vector, fetch, vec_name),
                kwargs=dict(include_objects=False,
                            allow_list_by_shard=allow_by_shard,
                            where=where_down, tenant=tenant)))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise next(iter(errors.values()))
        if "sparse" in results:
            legs.append(results["sparse"])
            weights.append(1.0 - alpha)
        if "dense" in results:
            dense = results["dense"]
            # similarity score for fusion: any monotone-decreasing map of
            # distance works (min-max normalization is affine-invariant)
            for r in dense:
                r.score = -r.distance
            legs.append(dense)
            weights.append(alpha)
        if not legs:
            return []
        fuse = fusion_relative_score if fusion == "relativeScore" else fusion_ranked
        # fusion returns (fused_score, result) pairs WITHOUT mutating the
        # leg results; materialize fresh results so concurrent queries
        # sharing leg objects never race on .score
        fused = [SearchResult(uuid=r.uuid, distance=r.distance, score=s,
                              object=r.object, shard=r.shard)
                 for s, r in fuse(legs, weights, k)]
        return self._finish_hybrid(fused, autocut, include_objects)

    def _finish_hybrid(self, results: list[SearchResult], autocut: int,
                       include_objects: bool) -> list[SearchResult]:
        if autocut > 0 and results:
            from weaviate_tpu_torch.query.autocut import autocut_results

            results = autocut_results(results, autocut, by="score")
        if include_objects:
            self._attach_objects(results)
        return results

    def _hybrid_device(self, name: str, query: str, vector, alpha: float,
                       k: int, properties, vec_name: str, fusion: str,
                       allow_mask) -> list[SearchResult] | None:
        """Fused device hybrid for one shard. None = the shard declined
        (unsupported index, candidate budget, kill switch) and the caller
        runs the host reference path."""
        shard = self._load_shard(name)
        res = shard.hybrid_search(
            query, np.asarray(vector, np.float32), k, alpha=alpha,
            fusion=fusion, properties=properties, vec_name=vec_name,
            allow_mask=allow_mask)
        if res is None:
            return None
        return self._results(shard, name, *res)

    def hybrid_async(self, query: str, vector=None, alpha: float = 0.75,
                     k: int = 10, properties: list[str] | None = None,
                     vec_name: str = "", fusion: str = "relativeScore",
                     where=None, include_objects: bool = True,
                     autocut: int = 0, tenant: str | None = None):
        """Dispatch-only twin of ``hybrid``: returns a
        ``DeviceResultHandle`` resolving to the same ``list[SearchResult]``.
        On the device path the copy to the host waits for ``.result()``;
        when the device path declines, the host reference runs inline and
        the handle is pre-resolved (``DeviceResultHandle.ready``)."""
        from weaviate_tpu_torch.runtime.transfer import DeviceResultHandle

        names = self._target_shard_names(tenant)
        if (vector is not None and len(names) == 1
                and self._is_local(names[0]) and where is None):
            shard = self._load_shard(names[0])
            h = shard.hybrid_search_async(
                query, np.asarray(vector, np.float32), k, alpha=alpha,
                fusion=fusion, properties=properties, vec_name=vec_name)
            if h is not None:
                return h.map(lambda res, _s=shard, _n=names[0]:
                             self._finish_hybrid(self._results(_s, _n, *res),
                                                 autocut, include_objects))
        return DeviceResultHandle.ready(self.hybrid(
            query, vector, alpha, k, properties, vec_name, fusion, where,
            include_objects, autocut, tenant))

    # -- epoch migration -----------------------------------------------------

    def _unmigrate(self, shard: Shard, objs) -> None:
        """A re-put at an object's ring home supersedes its migrated copy:
        delete the sibling's copy and drop the routing marker, AFTER the
        fresh write landed (a failed re-put must never have destroyed the
        only copy first). Free when the shard never migrated anything."""
        if shard._migrated_count <= 0:
            return
        for obj in objs:
            dst = shard.migrated_to(obj.uuid)
            if dst and dst != shard.name:
                if self._is_local(dst):
                    self._load_shard(dst).delete_object(obj.uuid)
                elif self.remote is not None:
                    self.remote.delete_object(
                        self._read_node(dst), self.config.name, dst,
                        obj.uuid)
            if dst:
                shard.clear_migrated(obj.uuid)

    def _sibling_with_headroom(self, src_name: str) -> str | None:
        """The local sibling shard with the most memory headroom (the
        smallest ledger footprint): the migration target. None when this
        collection has no other local shard with room."""
        from weaviate_tpu_torch.runtime.hbm_ledger import ledger

        def over_quota(name: str) -> bool:
            # from shards already loaded only: a cold shard holds no device
            # tensors, and building shards mid-rescue is exactly wrong
            # under memory pressure
            sh = self.shards.get(name)
            return sh is not None and sh.over_shard_limit()

        best, best_bytes = None, None
        for name in self.sharding.shard_names:
            if name == src_name or not self._is_local(name):
                continue
            if over_quota(name):
                continue  # no headroom there either
            b = ledger.shard_bytes(self.config.name, name)
            if best_bytes is None or b < best_bytes:
                best, best_bytes = name, b
        if best is None:
            return None
        if over_quota(src_name):
            # quota pressure: any sibling under its quota IS headroom
            return best
        # otherwise only a meaningfully lighter sibling: moving between
        # two equally full shards would bounce the epoch back next cycle
        src_bytes = ledger.shard_bytes(self.config.name, src_name)
        return best if best_bytes < src_bytes else None

    def _remote_sibling_with_headroom(self, src_name: str) -> str | None:
        """The cross-NODE half of epoch migration: a sibling shard placed
        on another node, chosen by that node's gossiped device-memory
        ledger bytes. Only nodes whose reported footprint is BELOW this
        node's qualify (a local move cannot relieve device-global
        pressure, since the shards of one node share its card; shipping
        to a lighter node does). A node with no reading is skipped: an
        epoch is never shipped blind."""
        if self.remote is None:
            return None
        hbm = self._node_hbm_bytes()
        local_bytes = hbm.get(self.local_node, 0)
        best, best_bytes = None, None
        for name in self.sharding.shard_names:
            if name == src_name or self._is_local(name):
                continue
            node = self.sharding.nodes_for(name)[0]
            b = hbm.get(node)
            if b is None or b >= local_bytes:
                continue
            if best_bytes is None or b < best_bytes:
                best, best_bytes = name, b
        return best

    def migrate_epoch(self, src_name: str, vec_name: str = "",
                      dst_name: str | None = None) -> int:
        """Migrate the coldest sealed epoch of ``src_name``'s epoch-backed
        index to a sibling shard with headroom: the epoch's objects read
        from the source's LSM store, a durable ingest at the target
        (``Shard.put_object_batch``: the vectors land in the target's own
        epochs), then the source cutover (``Shard.migrate_out``) and the
        epoch's memory released (``drop_epoch``). Every object is served
        EXACTLY once whatever the crash point: the routing markers go
        first, the ring copy answers until the cutover, the marker after
        it, and the window where both copies exist is deduped by uuid in
        the merge. Returns the objects moved (0 = nothing to do).
        The target may be on another node (``_migrate_one_remote``).
        Single-replica collections without tenants only."""
        if (self.config.replication.factor > 1
                or self.config.multi_tenancy.enabled
                or not self._is_local(src_name)):
            return 0
        src = self._load_shard(src_name)
        moved_total = 0
        with self._migrate_lock:
            for name, idx in list(src.vector_indexes.items()):
                if vec_name and name != vec_name:
                    continue
                es = getattr(idx, "epoch_store", None)
                if es is None:
                    continue
                eid = es.coldest_sealed()
                if eid is None:
                    continue
                dst = dst_name or self._sibling_with_headroom(src_name)
                if dst is None and dst_name is None:
                    dst = self._remote_sibling_with_headroom(src_name)
                if dst is None or dst == src_name:
                    return moved_total
                if self._is_local(dst):
                    moved_total += self._migrate_one(src, idx, es, eid, dst)
                else:
                    moved_total += self._migrate_one_remote(
                        src, idx, es, eid, dst)
        return moved_total

    def _migrate_one(self, src: Shard, idx, es, eid: int, dst: str) -> int:
        """Move one epoch. Caller holds ``_migrate_lock``. The SOURCE
        shard's lock spans serialize -> target ingest -> cutover, so a
        concurrent put or delete of a moving uuid cannot land in the
        unsynchronized window (the cutover would erase it, or the target's
        old copy resurrect it); writers to the source queue behind the
        move, for one epoch's ingest at most."""
        from weaviate_tpu_torch.runtime import faultline

        src_name = src.name
        with src._lock:
            doc_ids = idx.epoch_doc_ids(eid)
            if not len(doc_ids):
                es.drop_epoch(eid)
                return 0
            objs = [o for o in src.objects_by_doc_ids(doc_ids)
                    if o is not None]
            if not objs:
                return 0
            # 1) the durable routing markers FIRST: from here on deletes
            #    and re-puts of a moving uuid reach BOTH sides wherever a
            #    kill lands
            src.mark_migrating([o.uuid for o in objs], dst)
            faultline.fire("epoch.migrate.pre_ingest", shard=src_name,
                           epoch=eid, docs=len(doc_ids))
            try:
                # 2) durable ingest at the target (fresh doc ids there)
                self._load_shard(dst).put_object_batch(objs)
            except MemoryError:
                # the sibling hit ITS watermark: nothing was cut over and
                # nothing landed there, so the markers come back off
                for o in objs:
                    src.clear_migrated(o.uuid)
                logger.warning(
                    "epoch migration %s/%s e%d -> %s aborted: target at "
                    "watermark", self.config.name, src_name, eid, dst)
                return 0
            faultline.fire("epoch.migrate.post_ingest", shard=src_name,
                           epoch=eid)
            # 3) the source cutover (markers already durable)
            src.migrate_out([o.uuid for o in objs], dst)
            faultline.fire("epoch.migrate.post_cutover", shard=src_name,
                           epoch=eid)
            # 4) the now all-tombstone epoch's memory goes with its
            #    ledger finalizers
            es.drop_epoch(eid)
            es.migrations_total += 1
        monitoring.epoch_migrations.labels(self.config.name, src_name).inc()
        logger.info("epoch migration: %s/%s e%d -> %s (%d objects)",
                    self.config.name, src_name, eid, dst, len(objs))
        return len(objs)

    def _migrate_one_remote(self, src: Shard, idx, es, eid: int,
                            dst: str) -> int:
        """Cross-node twin of ``_migrate_one``: the same marker-first
        cutover, with the target's durable ingest riding the remote shard
        client (``put_objects`` -> the owning node's
        ``Shard.put_object_batch``: the vectors land in ITS card's epochs
        under ITS admission control). An ingest RPC failure aborts with
        nothing cut over and the markers LEFT in place: a timeout is
        ambiguous (the put may have landed), and dropping the markers
        would orphan such a copy where no delete reaches it. Kept markers
        keep every copy reachable: deletes and re-puts clean both sides,
        search dedups by uuid, and a retry re-marks and re-ingests
        (idempotent by uuid). The source shard's lock spans the RPC, as
        the local twin's spans its ingest; the RPC's per-attempt deadline
        and the per-peer circuit breaker bound it. The same
        ``epoch.migrate.*`` fault points fire."""
        from weaviate_tpu_torch.cluster.transport import RpcError
        from weaviate_tpu_torch.runtime import faultline

        src_name = src.name
        dst_node = self.sharding.nodes_for(dst)[0]
        with src._lock:
            doc_ids = idx.epoch_doc_ids(eid)
            if not len(doc_ids):
                es.drop_epoch(eid)
                return 0
            objs = [o for o in src.objects_by_doc_ids(doc_ids)
                    if o is not None]
            if not objs:
                return 0
            src.mark_migrating([o.uuid for o in objs], dst)
            faultline.fire("epoch.migrate.pre_ingest", shard=src_name,
                           epoch=eid, docs=len(doc_ids))
            try:
                self._require_remote(dst).put_objects(
                    dst_node, self.config.name, dst,
                    [o.to_bytes() for o in objs])
            except RpcError as e:
                logger.warning(
                    "cross-node epoch migration %s/%s e%d -> %s@%s "
                    "aborted (markers kept, nothing cut over): %s",
                    self.config.name, src_name, eid, dst, dst_node, e)
                return 0
            faultline.fire("epoch.migrate.post_ingest", shard=src_name,
                           epoch=eid)
            src.migrate_out([o.uuid for o in objs], dst)
            faultline.fire("epoch.migrate.post_cutover", shard=src_name,
                           epoch=eid)
            es.drop_epoch(eid)
            es.migrations_total += 1
        monitoring.epoch_migrations.labels(self.config.name, src_name).inc()
        logger.info("cross-node epoch migration: %s/%s e%d -> %s@%s "
                    "(%d objects)", self.config.name, src_name, eid, dst,
                    dst_node, len(objs))
        return len(objs)

    def epoch_maintenance(self) -> bool:
        """One background policy cycle (the database's
        ``epoch-maintenance`` cycle, which alone runs epoch upkeep):
        per-shard seal / drop / compact — deletes give memory back here,
        which relieves the device-global watermark — then migrate the
        coldest sealed epoch off any shard over its per-shard quota to a
        sibling with headroom instead of letting the quota 507 writes (a
        local move cannot lower device-global use: the shards share the
        card)."""
        did = False
        with self._lock:
            shards = list(self.shards.values())
        for shard in shards:
            did = shard.epoch_maintenance() or did
        for shard in shards:
            if shard.over_shard_limit():
                did = self.migrate_epoch(shard.name) > 0 or did
        return did

    def _rescue_shard(self, shard: Shard) -> bool:
        """Synchronous memory-pressure rescue (``shard.memory_rescue``):
        compact first — tombstone-heavy epochs give bytes back without
        moving anything — then migrate the coldest sealed epoch to a
        sibling with headroom. Runs once on the importing thread before
        admission re-checks; the thread-local guard stops a migration's
        own target-side ingest (which runs admission too) from cascading
        rescues across the shards."""
        if getattr(self._rescue_tls, "active", False):
            return False
        self._rescue_tls.active = True
        try:
            did = shard.epoch_maintenance()
            if shard.over_shard_limit():
                did = self.migrate_epoch(shard.name) > 0 or did
            return did
        finally:
            self._rescue_tls.active = False

    # -- maintenance ---------------------------------------------------------

    def flush(self):
        for s in self.shards.values():
            s.flush()

    def close(self):
        self._pool.shutdown(wait=False)
        for s in self.shards.values():
            s.close()
