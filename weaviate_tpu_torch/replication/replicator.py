"""2PC write replication with consistency levels (port of
``weaviate_tpu/replication/replicator.py``).

Reference: usecases/replica/replicator.go:57 + coordinator.go — the
coordinator broadcasts "prepare" to every replica (coordinator.go:69
broadcast), counts acks against the consistency level (config.go
ONE/QUORUM/ALL), then commits (commitAll :132, Push :158); failed
prepares trigger aborts. The intra-cluster endpoints live beside the
shard data plane (clusterapi /replicas/...).
"""

from __future__ import annotations

import logging
import threading
import uuid as uuid_mod

from weaviate_tpu_torch.cluster.transport import RpcError, rpc
from weaviate_tpu_torch.runtime import faultline, tracing
from weaviate_tpu_torch.storage.objects import StorageObject

logger = logging.getLogger(__name__)

LEVELS = ("ONE", "QUORUM", "ALL")


class ConsistencyError(RuntimeError):
    pass


def required_acks(level: str, n_replicas: int) -> int:
    if level == "ONE":
        return 1
    if level == "QUORUM":
        return n_replicas // 2 + 1
    if level == "ALL":
        return n_replicas
    raise ValueError(f"unknown consistency level {level!r}; "
                     f"expected one of {LEVELS}")


class Replicator:
    """Write coordinator for one collection (reference Replicator)."""

    def __init__(self, collection):
        self.col = collection

    # -- replica RPC primitives (local replicas short-circuit HTTP) ---------

    def _shard_local(self, shard_name: str):
        return self.col._load_shard(shard_name)

    def _prepare(self, node: str, shard_name: str, rid: str, task: tuple) -> None:
        # faultline: fires for LOCAL replicas too — a coordinator whose
        # own replica faults mid-prepare must abort like any other
        faultline.fire("replication.prepare", node=node, shard=shard_name)
        if node == self.col.local_node:
            self._shard_local(shard_name).stage(rid, task)
            return
        kind = task[0]
        payload = {"request_id": rid, "kind": kind}
        if kind == "put":
            payload["objects"] = [o.to_bytes() for o in task[1]]
        else:
            payload["uuid"], payload["tombstone_ms"] = task[1], task[2]
        self._rpc(node, shard_name, "prepare", payload)

    def _commit(self, node: str, shard_name: str, rid: str):
        faultline.fire("replication.commit", node=node, shard=shard_name)
        if node == self.col.local_node:
            return self._shard_local(shard_name).commit_staged(rid)
        # unwrap so local and remote commits return the same shape
        return self._rpc(node, shard_name, "commit",
                         {"request_id": rid}).get("result")

    def _abort(self, node: str, shard_name: str, rid: str) -> None:
        try:
            if node == self.col.local_node:
                self._shard_local(shard_name).abort_staged(rid)
            else:
                self._rpc(node, shard_name, "abort", {"request_id": rid})
        except Exception:
            logger.warning("abort failed on %s/%s", node, shard_name)

    def _rpc(self, node: str, shard_name: str, op: str, payload: dict):
        remote = self.col._require_remote(shard_name)
        return rpc(remote.resolver(node),
                   f"/replicas/{self.col.config.name}/{shard_name}/{op}",
                   payload, timeout=remote.timeout)

    # -- coordinator (reference coordinator.go Push) --------------------------

    def _two_phase(self, shard_name: str, task: tuple, level: str) -> list:
        """Returns the per-replica commit results (callers aggregate).

        Catches ALL exceptions per replica — a commit-time validation or
        memory error on one replica must still commit/abort the others,
        or their staged entries leak and the set diverges silently."""
        from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

        nodes = self.col.sharding.nodes_for(shard_name)
        need = required_acks(level, len(nodes))
        rid = str(uuid_mod.uuid4())

        # Both phases broadcast CONCURRENTLY and return as soon as `need`
        # acks land (reference coordinator.broadcast + level counting,
        # coordinator.go:96-130): one partitioned replica hanging until its
        # RPC timeout must not add that timeout to a write that already has
        # quorum. Stragglers finish on pool threads after we return —
        # successes are committed so they converge, failures are aborted
        # (and any leaked staged entry falls to the gc_staged TTL +
        # anti-entropy).
        pool = ThreadPoolExecutor(max_workers=max(1, 2 * len(nodes)))

        def safe_abort(node):
            try:
                self._abort(node, shard_name, rid)
            except Exception:
                pass  # unreachable abort → staged-entry TTL cleans up

        def commit_straggler(fut, node):
            if fut.exception() is None:
                try:
                    self._commit(node, shard_name, rid)
                except Exception:
                    safe_abort(node)

        try:
            # tracing.propagate: the broadcast runs on pool threads, and
            # each replica RPC must carry this request's traceparent so
            # the write yields one stitched trace
            with tracing.span("replication.prepare", shard=shard_name,
                              replicas=len(nodes), need=need):
                prep_futs = {pool.submit(tracing.propagate(self._prepare),
                                         node, shard_name, rid,
                                         task): node for node in nodes}
                prepared: list[str] = []
                errors: list[str] = []
                pending = set(prep_futs)
                while pending and len(prepared) < need \
                        and len(errors) <= len(nodes) - need:
                    done, pending = wait(pending,
                                         return_when=FIRST_COMPLETED)
                    for f in done:
                        node = prep_futs[f]
                        if f.exception() is None:
                            prepared.append(node)
                        else:
                            errors.append(f"{node}: {f.exception()}")
            from weaviate_tpu_torch.runtime.metrics import replication_phase_total

            replication_phase_total.labels(
                "prepare", "ok" if len(prepared) >= need else "failed").inc()
            if len(prepared) < need:
                # quorum impossible: abort what prepared; late preparers
                # abort themselves via callback
                for f in pending:
                    node = prep_futs[f]
                    f.add_done_callback(
                        lambda fut, n=node: fut.exception() is None
                        and safe_abort(n))
                for node in prepared:
                    pool.submit(safe_abort, node)
                raise ConsistencyError(
                    f"prepare acked by {len(prepared)}/{len(nodes)} replicas, "
                    f"need {need} for {level}: {'; '.join(errors)}")
            # quorum prepared; late preparers get committed as they arrive
            for f in pending:
                f.add_done_callback(
                    lambda fut, n=prep_futs[f]: commit_straggler(fut, n))
            # commit phase over the quorum set

            with tracing.span("replication.commit", shard=shard_name,
                              replicas=len(prepared), need=need):
                commit_futs = {pool.submit(tracing.propagate(self._commit),
                                           node, shard_name, rid):
                               node for node in prepared}
                results: list = []
                commit_errors: list[str] = []
                pending = set(commit_futs)
                while pending and len(results) < need:
                    done, pending = wait(pending,
                                         return_when=FIRST_COMPLETED)
                    for f in done:
                        node = commit_futs[f]
                        if f.exception() is None:
                            results.append(f.result())
                        else:
                            commit_errors.append(
                                f"{node}: {f.exception()}")
                            # release any still-staged entry (idempotent
                            # if the commit half-landed or the node is
                            # unreachable)
                            pool.submit(safe_abort, node)
            for f in pending:  # commit stragglers: abort on failure
                node = commit_futs[f]
                f.add_done_callback(
                    lambda fut, n=node: fut.exception() is not None
                    and safe_abort(n))
            replication_phase_total.labels(
                "commit", "ok" if len(results) >= need else "failed").inc()
            if len(results) < need:
                raise ConsistencyError(
                    f"commit acked by {len(results)}/{len(prepared)} prepared "
                    f"replicas, need {need}: {'; '.join(commit_errors)}")
            return results
        finally:
            pool.shutdown(wait=False)

    def put_objects(self, shard_name: str, objs: list[StorageObject],
                    level: str = "QUORUM"):
        results = self._two_phase(shard_name, ("put", objs), level)
        return results[0] if results else None

    def delete(self, shard_name: str, uuid: str, level: str = "QUORUM",
               tombstone_ms: int | None = None) -> bool:
        import time as _time

        ts = tombstone_ms or int(_time.time() * 1000)
        results = self._two_phase(shard_name, ("delete", uuid, ts), level)
        # deleted anywhere = deleted (a replica that missed the put and
        # reports False is simply stale, not authoritative)
        return any(bool(r) for r in results)


def register_replication(server, db) -> None:
    """Mount /replicas/{collection}/{shard}/{op} (reference: clusterapi
    serve.go routes /replicas/indices/ to the replica store)."""

    def handler(subpath: str, payload: dict):
        parts = subpath.split("/")
        if len(parts) != 3:
            raise KeyError(subpath)
        collection_name, shard_name, op = parts
        col = db.get_collection(collection_name)
        if db.local_node not in col.sharding.nodes_for(shard_name):
            raise ValueError(
                f"node {db.local_node} is not a replica of {shard_name!r}")
        shard = col._load_shard(shard_name)

        if op == "prepare":
            if payload["kind"] == "put":
                objs = [StorageObject.from_bytes(raw)
                        for raw in payload["objects"]]
                shard.stage(payload["request_id"], ("put", objs))
            else:
                shard.stage(payload["request_id"],
                            ("delete", payload["uuid"],
                             payload["tombstone_ms"]))
            return {"ok": True}
        if op == "commit":
            return {"result": shard.commit_staged(payload["request_id"])}
        if op == "abort":
            shard.abort_staged(payload["request_id"])
            return {"ok": True}
        if op == "staged:status":
            # chaos-checker probe: an orphaned prepare must neither leak
            # (staged > 0 past the TTL) nor commit (expired_total is the
            # proof the TTL path fired)
            return shard.staged_status()
        if op == "digest":
            d = shard.object_digest(payload["uuid"])
            return {"digest": d}
        if op == "digests:bucket":
            return {"digests": shard.bucket_digests(payload["depth"],
                                                    payload["buckets"])}
        if op == "hashtree:level":
            tree, token = _tree_for_walk(shard, payload["depth"],
                                         payload.get("token"))
            return {"hashes": tree.level_hashes(payload["level"],
                                                payload["positions"]),
                    "token": token}
        if op == "sync:apply":
            n = shard.apply_sync(payload.get("objects", []),
                                 payload.get("deletes", []))
            return {"applied": n}
        if op == "objects:fetch":
            return {"objects": [shard.objects.get(u.encode())
                                for u in payload["uuids"]]}
        raise KeyError(op)

    server.route("/replicas/", handler)


# hashtree walks issue several level RPCs per beat; rebuilding the tree
# for each would turn O(diff*depth) exchanges into O(n*depth) hashing.
# Each walk gets a TOKEN naming its snapshot so concurrent walks from
# different peers never see a tree swapped mid-walk; a few snapshots are
# kept per shard (on the shard itself, so they die with it).
_tree_lock = threading.Lock()
_MAX_WALKS = 4


def _tree_for_walk(shard, depth: int, token: str | None):
    from collections import OrderedDict

    with _tree_lock:
        walks = getattr(shard, "_hashtree_walks", None)
        if walks is None:
            walks = shard._hashtree_walks = OrderedDict()
        if token is not None:
            cached = walks.get(token)
            if cached is not None and cached[0] == depth:
                return cached[1], token
            # token evicted/unknown: fall through to a fresh snapshot —
            # the walk continues on newer data, worst case a wasted round
        token = str(uuid_mod.uuid4())
        walks[token] = (depth, shard.build_hashtree(depth))
        while len(walks) > _MAX_WALKS:
            walks.popitem(last=False)
        return walks[token][1], token
