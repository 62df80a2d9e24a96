"""Consistent reads with digest comparison + read repair (port of
``weaviate_tpu/replication/finder.py``).

Reference: usecases/replica coordinator.go:178 (Finder.Pull): fetch the
full object from one replica and digests from the others, compare, and
if replicas disagree return the newest version and push it to the stale
replicas (repairer.go).
"""

from __future__ import annotations

import logging

from weaviate_tpu_torch.cluster.transport import RpcError, rpc
from weaviate_tpu_torch.replication.replicator import ConsistencyError, required_acks
from weaviate_tpu_torch.runtime import degrade, tracing
from weaviate_tpu_torch.storage.objects import StorageObject

logger = logging.getLogger(__name__)


class Finder:
    def __init__(self, collection):
        self.col = collection

    def _digest(self, node: str, shard_name: str, uuid: str) -> dict | None:
        if node == self.col.local_node:
            return self.col._load_shard(shard_name).object_digest(uuid)
        remote = self.col._require_remote(shard_name)
        return rpc(remote.resolver(node),
                   f"/replicas/{self.col.config.name}/{shard_name}/digest",
                   {"uuid": uuid}, timeout=remote.timeout).get("digest")

    def _fetch(self, node: str, shard_name: str, uuid: str) -> bytes | None:
        if node == self.col.local_node:
            return self.col._load_shard(shard_name).objects.get(uuid.encode())
        remote = self.col._require_remote(shard_name)
        return rpc(remote.resolver(node),
                   f"/replicas/{self.col.config.name}/{shard_name}/objects:fetch",
                   {"uuids": [uuid]}, timeout=remote.timeout)["objects"][0]

    def _repair(self, node: str, shard_name: str, raw: bytes | None,
                delete: dict | None) -> None:
        try:
            if node == self.col.local_node:
                self.col._load_shard(shard_name).apply_sync(
                    [raw] if raw else [], [delete] if delete else [])
                return
            remote = self.col._require_remote(shard_name)
            rpc(remote.resolver(node),
                f"/replicas/{self.col.config.name}/{shard_name}/sync:apply",
                {"objects": [raw] if raw else [],
                 "deletes": [delete] if delete else []},
                timeout=remote.timeout)
        except Exception:
            # best-effort side effect: a failed repair (unreachable peer,
            # local validation error) must not fail the read itself
            logger.warning("read repair push to %s/%s failed", node,
                           shard_name, exc_info=True)

    def get_object(self, uuid: str, shard_name: str,
                   level: str = "QUORUM") -> StorageObject | None:
        """Read at a consistency level; repairs stale replicas as a side
        effect (reference: Finder.Pull + repairer)."""
        with tracing.span("replication.read", shard=shard_name,
                          level=level):
            return self._get_object(uuid, shard_name, level)

    def _get_object(self, uuid: str, shard_name: str,
                    level: str) -> StorageObject | None:
        nodes = self.col.sharding.nodes_for(shard_name)
        need = required_acks(level, len(nodes))
        digests: dict[str, dict | None] = {}
        errors = []
        for node in nodes:
            if len(digests) >= need and level != "ALL":
                # enough replicas answered for the level — but keep going
                # only if we still need votes
                break
            try:
                digests[node] = self._digest(node, shard_name, uuid)
            except (RpcError, KeyError) as e:
                errors.append(f"{node}: {e}")
        if len(digests) < need:
            # degraded read (ONE/QUORUM): the level is unreachable but
            # SOME replica answered — serve its best-known value with an
            # explicit downgraded-consistency marker rather than failing
            # the whole read. ALL stays strict: the caller demanded
            # every replica by name and gets the typed error.
            if digests and level != "ALL":
                degrade.report(
                    "consistency_downgraded",
                    collection=self.col.config.name, shard=shard_name,
                    detail=f"{len(digests)}/{len(nodes)} replicas "
                           f"answered, need {need} for {level}: "
                           f"{'; '.join(errors)}")
            else:
                raise ConsistencyError(
                    f"{len(digests)}/{len(nodes)} replicas answered, need "
                    f"{need} for {level}: {'; '.join(errors)}")

        # winner by digest_rank: newest mtime, tombstone beats object at
        # a tie, content hash as the deterministic tie-break
        from weaviate_tpu_torch.replication.hashtree import digest_rank

        seen = {n: d for n, d in digests.items() if d is not None}
        if not seen:
            return None
        winner_node, winner = max(seen.items(),
                                  key=lambda kv: digest_rank(kv[1]))

        stale = [n for n, d in digests.items()
                 if d is None or digest_rank(d) < digest_rank(winner)]
        if stale:
            # read-path divergence signal: a consistency-level read just
            # caught replicas disagreeing between anti-entropy beats —
            # feeds /v1/debug/replication alongside the beat stats
            from weaviate_tpu_torch.replication.hashbeater import (
                replication_status)

            replication_status.record_read_divergence(
                self.col.config.name, shard_name, len(stale))

        if winner["deleted"]:
            for node in stale:
                self._repair(node, shard_name, None,
                             {"uuid": uuid, "mtime": winner["mtime"]})
            return None
        raw = None
        # the winner can die between digest and fetch: fail over to the
        # remaining answering replicas (rank order) with a staleness
        # marker instead of failing the read
        candidates = sorted(seen, key=lambda n: digest_rank(seen[n]),
                            reverse=True)
        for i, node in enumerate(candidates):
            try:
                raw = self._fetch(node, shard_name, uuid)
            except RpcError as e:
                if i == len(candidates) - 1:
                    # EVERY answering replica failed the fetch: this is
                    # unavailability, not nonexistence — the digests just
                    # proved the object exists. A degraded read may
                    # downgrade consistency; it must never invent a 404
                    # (a caller doing read-then-recreate would clobber
                    # the surviving copies).
                    raise ConsistencyError(
                        f"object fetch failed on every answering replica "
                        f"({', '.join(candidates)}) for {uuid}: {e}") from e
                degrade.report("missing_replica",
                               collection=self.col.config.name,
                               shard=shard_name, node=node,
                               detail=f"fetch failed: {e}")
                continue
            if node != winner_node:
                stale = [n for n in stale if n != node]
            break
        if raw is None:
            return None
        if stale:
            logger.info("read repair: %s stale for %s", stale, uuid)
            for node in stale:
                self._repair(node, shard_name, raw, None)
        return StorageObject.from_bytes(raw)
