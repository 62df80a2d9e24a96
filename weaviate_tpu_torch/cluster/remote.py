"""Remote shard client + incoming handlers: the intra-cluster data plane
(port of ``weaviate_tpu/cluster/remote.py``).

Reference: adapters/clients/remote_index.go (client), routed server side
by clusterapi/indices.go:184-260 into Index.Incoming* methods
(index.go:1665 IncomingSearch etc.). Payloads here are JSON with
base64-wrapped binary objects (the reference uses custom binary
payloads, clusterapi/indices_payloads.go — same boundary, simpler
encoding).

Paths: POST /indices/{collection}/{shard}/{op}
ops: search | objects (batch put) | object:get | object:delete |
     object:exists | aggregate | overview | objects:copy

``objects:copy`` is the port's one op beyond the JAX package's wire: the
scaler's copy onto a node that joins a shard's placement only after every
copy has landed, so the node does not own the shard yet (the JAX
package's scaler sends it as ``objects``, which that ownership check
refuses).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from weaviate_tpu_torch.cluster.transport import RpcError, rpc
from weaviate_tpu_torch.runtime import faultline, tracing
from weaviate_tpu_torch.runtime.retry import RetryPolicy
from weaviate_tpu_torch.storage.objects import StorageObject

logger = logging.getLogger(__name__)

def default_timeout_s() -> float:
    """Fallback per-attempt timeout for remote shard ops — used to be a
    hard-coded 30.0 in the constructor. Server-managed clients receive
    ``ServerConfig.remote_rpc_timeout_s`` explicitly (the CONFIG_FILE
    overlay applies there); this env read is the fallback for directly
    constructed clients, evaluated lazily so it is not frozen at import
    time. Like every transport call, the ceiling is additionally capped
    by the request's remaining deadline budget inside ``rpc``."""
    return float(os.environ.get("REMOTE_RPC_TIMEOUT_S", "30"))

#: ops safe to retry: reads and existence probes. Writes stay
#: single-shot — the replication layer owns write-failure semantics
#: (2PC abort + anti-entropy), and a blind transport retry of a put
#: could double-apply side effects the coordinator already accounted
_IDEMPOTENT_OPS = frozenset({
    "search", "object:get", "objects:get", "objects:list",
    "object:exists", "aggregate", "overview",
})


class RemoteShardClient:
    """Client side: every method targets one shard on one node
    (reference: sharding.RemoteIndexClient)."""

    def __init__(self, resolver, timeout: float | None = None):
        self.resolver = resolver  # node name -> "host:port"
        self.timeout = default_timeout_s() if timeout is None else timeout
        self.retry = RetryPolicy(op="remote.shard_op")

    def _call(self, node: str, collection: str, shard: str, op: str,
              payload: dict) -> dict:
        with tracing.span("remote.shard_op", op=op, node=node,
                          shard=shard):
            def attempt():
                # fault point INSIDE the attempt and mapped to RpcError:
                # an injected fault takes the exact path a real one
                # would — through the retry policy, replica failover,
                # and degraded-read handling (retries count as separate
                # schedule calls, like every transport-level point)
                try:
                    faultline.fire("remote.shard_op", op=op, node=node,
                                   shard=shard)
                except faultline.FaultInjected as e:
                    raise RpcError(
                        f"remote {op} on {node}/{shard} failed: {e}") from e
                return rpc(self.resolver(node),
                           f"/indices/{collection}/{shard}/{op}", payload,
                           timeout=self.timeout)

            if op in _IDEMPOTENT_OPS:
                return self.retry.call(attempt)
            return attempt()

    def search_shard(self, node: str, collection: str, shard: str, *,
                     vector=None, k: int = 10, vec_name: str = "",
                     query: str | None = None,
                     properties: list[str] | None = None,
                     where: dict | None = None,
                     include_objects: bool = True) -> list[dict]:
        payload = {
            "k": k, "vec_name": vec_name, "query": query,
            "properties": properties, "where": where,
            "include_objects": include_objects,
        }
        if vector is not None:
            payload["vector"] = np.asarray(vector, dtype=np.float32)
        return self._call(node, collection, shard, "search", payload)["results"]

    def put_objects(self, node: str, collection: str, shard: str,
                    raw_objects: list[bytes]) -> None:
        self._call(node, collection, shard, "objects",
                   {"objects": raw_objects})

    def copy_objects(self, node: str, collection: str, shard: str,
                     raw_objects: list[bytes]) -> None:
        """A scaler's copy: ``node`` takes the objects into its copy of
        ``shard`` before the placement names it a replica."""
        self._call(node, collection, shard, "objects:copy",
                   {"objects": raw_objects})

    def get_object(self, node: str, collection: str, shard: str,
                   uuid: str) -> bytes | None:
        reply = self._call(node, collection, shard, "object:get",
                           {"uuid": uuid})
        return reply.get("object")

    def get_objects(self, node: str, collection: str, shard: str,
                    uuids: list[str]) -> list[bytes | None]:
        """Batched multi-get (one RPC per shard, not per object)."""
        reply = self._call(node, collection, shard, "objects:get",
                           {"uuids": uuids})
        return reply["objects"]

    def list_objects(self, node: str, collection: str, shard: str,
                     limit: int | None = None, after: str | None = None,
                     where: dict | None = None) -> list[bytes]:
        """uuid-ordered page of raw objects (cursor listing across nodes)."""
        reply = self._call(node, collection, shard, "objects:list",
                           {"limit": limit, "after": after, "where": where})
        return reply["objects"]

    def delete_object(self, node: str, collection: str, shard: str,
                      uuid: str) -> bool:
        return self._call(node, collection, shard, "object:delete",
                          {"uuid": uuid})["deleted"]

    def exists(self, node: str, collection: str, shard: str, uuid: str) -> bool:
        return self._call(node, collection, shard, "object:exists",
                          {"uuid": uuid})["exists"]

    def aggregate(self, node: str, collection: str, shard: str,
                  properties: list[str] | None = None,
                  group_by: str | None = None,
                  where: dict | None = None) -> dict:
        return self._call(node, collection, shard, "aggregate",
                          {"properties": properties, "group_by": group_by,
                           "where": where})["partial"]

    def overview(self, node: str, collection: str, shard: str) -> dict:
        return self._call(node, collection, shard, "overview", {})


def register_incoming(server, db) -> None:
    """Mount the incoming shard-op handlers for a node's local Database
    (reference: clusterapi indices.go router → Index.Incoming*)."""

    def handler(subpath: str, payload: dict):
        parts = subpath.split("/")
        if len(parts) != 3:
            raise KeyError(subpath)
        collection_name, shard_name, op = parts
        col = db.get_collection(collection_name)
        if op == "objects:copy":
            # the scaler's copy lands BEFORE the placement (committed
            # through Raft once every copy is in) names this node a
            # replica: the only write taken for a shard not owned yet
            col._load_shard(shard_name).put_object_batch(
                [StorageObject.from_bytes(raw) for raw in payload["objects"]])
            return {"ok": True}
        if db.local_node not in col.sharding.nodes_for(shard_name):
            raise ValueError(
                f"node {db.local_node} does not own shard {shard_name!r}")
        shard = col._load_shard(shard_name)

        if op == "search":
            return _incoming_search(shard, payload)
        if op == "objects":
            objs = [StorageObject.from_bytes(raw) for raw in payload["objects"]]
            shard.put_object_batch(objs)
            return {"ok": True}
        if op == "object:get":
            raw = shard.objects.get(payload["uuid"].encode())
            return {"object": raw}
        if op == "objects:get":
            return {"objects": [shard.objects.get(u.encode())
                                for u in payload["uuids"]]}
        if op == "objects:list":
            return {"objects": _incoming_list(shard, payload)}
        if op == "object:delete":
            return {"deleted": shard.delete_object(payload["uuid"])}
        if op == "object:exists":
            return {"exists": shard.exists(payload["uuid"])}
        if op == "aggregate":
            return {"partial": _incoming_aggregate(shard, payload)}
        if op == "overview":
            return {"object_count": shard.object_count(),
                    "doc_id_space": shard.doc_id_space}
        raise KeyError(op)

    server.route("/indices/", handler)


def _where_from(payload: dict):
    if payload.get("where") is None:
        return None
    from weaviate_tpu_torch.filters.filters import Filter

    return Filter.from_dict(payload["where"])


def _incoming_search(shard, payload: dict) -> dict:
    where = _where_from(payload)
    allow = shard.allow_mask(where) if where is not None else None
    include = payload.get("include_objects", True)
    k = payload.get("k", 10)
    results = []
    if payload.get("vector") is not None:
        ids, dists = shard.vector_search(
            np.asarray(payload["vector"], dtype=np.float32), k,
            payload.get("vec_name", ""), allow)
        for doc_id, dist in zip(ids.tolist(), dists.tolist()):
            uuid = shard._doc_to_uuid.get(doc_id)
            if uuid is None:
                continue
            item = {"uuid": uuid, "distance": float(dist)}
            if include:
                item["object"] = shard.objects.get(uuid.encode())
            results.append(item)
    else:
        ids, scores = shard.bm25_search(payload["query"], k,
                                        payload.get("properties"), allow)
        for doc_id, score in zip(ids.tolist(), scores.tolist()):
            uuid = shard._doc_to_uuid.get(doc_id)
            if uuid is None:
                continue
            item = {"uuid": uuid, "score": float(score)}
            if include:
                item["object"] = shard.objects.get(uuid.encode())
            results.append(item)
    return {"results": results}


def _incoming_list(shard, payload: dict) -> list[bytes]:
    where = _where_from(payload)
    mask = shard.allow_mask(where) if where is not None else None
    after = payload.get("after")
    limit = payload.get("limit")
    with shard._lock:
        items = sorted(shard._doc_to_uuid.items(), key=lambda t: t[1])
    out: list[bytes] = []
    for doc_id, uuid in items:
        if after is not None and uuid <= after:
            continue
        if mask is not None and (doc_id >= len(mask) or not mask[doc_id]):
            continue
        raw = shard.objects.get(uuid.encode())
        if raw is not None:
            out.append(raw)
            if limit is not None and len(out) >= limit:
                break
    return out


def _incoming_aggregate(shard, payload: dict) -> dict:
    from weaviate_tpu_torch.query.aggregator import aggregate_objects

    where = _where_from(payload)
    mask = shard.allow_mask(where) if where is not None else None

    def objs():
        for _key, raw in shard.objects.iter_items():
            obj = StorageObject.from_bytes(raw)
            if mask is not None and (obj.doc_id >= len(mask)
                                     or not mask[obj.doc_id]):
                continue
            yield obj

    return aggregate_objects(objs(), payload.get("properties"),
                             payload.get("group_by"))
