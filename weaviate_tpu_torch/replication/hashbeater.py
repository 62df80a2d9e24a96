"""Anti-entropy: background Merkle diff + object propagation (port of
``weaviate_tpu/replication/hashbeater.py``).

Reference: adapters/repos/db/shard_hashbeater.go:32,216 — each shard
periodically compares its hashtree with every peer replica
(CollectShardDifferences), fetches digests for the differing ranges,
and propagates whichever side is newer. Runs on the cycle manager.

Convergence is OBSERVABLE (the clusterchaos tentpole): every round
feeds the module-level :data:`replication_status` registry —
per-shard last-beat age, rounds, entries reconciled, last diff size and
a divergence estimate — which `GET /v1/debug/replication` serves and
the ``weaviate_tpu_hashbeat_rounds_total`` /
``weaviate_tpu_replica_divergent_entries`` metrics mirror, so "did the
replicas actually converge after that partition healed" is a question
with a queryable answer instead of a shrug.
"""

from __future__ import annotations

import logging
import threading
import time

from weaviate_tpu_torch.cluster.transport import RpcError, rpc
from weaviate_tpu_torch.replication.hashtree import MerkleTree, digest_rank

logger = logging.getLogger(__name__)


class ReplicationStatus:
    """Per-shard anti-entropy bookkeeping (process-wide singleton
    :data:`replication_status`). Beats and consistent reads report in;
    the debug endpoint and metrics read out. All methods are cheap and
    never raise into the caller's repair path."""

    def __init__(self):
        self._lock = threading.Lock()
        self._shards: dict[tuple[str, str], dict] = {}

    def _rec(self, collection: str, shard: str) -> dict:
        """Caller holds ``_lock``."""
        return self._shards.setdefault((collection, shard), {
            "rounds": 0, "reconciled_total": 0, "last_beat_t": 0.0,
            "read_divergence_total": 0, "divergent_known": 0,
            "known_remaining": {}, "peers": {}})

    def record_round(self, collection: str, shard: str,
                     peer_stats: dict[str, dict]) -> None:
        """One completed beat round (one Merkle walk against every peer)
        for one locally-owned shard. ``peer_stats[peer]``:
        {"reconciled", "divergent" (None when the peer was unreachable),
        "diff_buckets", "error"}."""
        now = time.time()
        reconciled = sum(s.get("reconciled") or 0
                         for s in peer_stats.values())
        with self._lock:
            rec = self._rec(collection, shard)
            rec["rounds"] += 1
            rec["reconciled_total"] += reconciled
            rec["last_beat_t"] = now
            for peer, s in peer_stats.items():
                rec["peers"][peer] = dict(s, t=now)
                if s.get("remaining") is not None:
                    rec["known_remaining"][peer] = s["remaining"]
            # PER-PEER last-known merge: an unreachable peer keeps its
            # most recent known reading — unknown is not zero, and a
            # round where only the in-sync peer answered must not reset
            # the gauge to 0 while the partitioned peer's divergence
            # grows behind the cut
            rec["divergent_known"] = sum(rec["known_remaining"].values())
            divergent_known = rec["divergent_known"]
        try:
            from weaviate_tpu_torch.runtime.metrics import (
                hashbeat_rounds, replica_divergent_entries)

            hashbeat_rounds.labels(collection, shard).inc()
            # the gauge reports what the rounds LEFT divergent (observed
            # minus repaired, per-peer last-known): 0 once the replicas
            # converged; an unreachable peer contributes its most recent
            # known reading rather than a misleading 0 (the endpoint's
            # state field says "degraded" for the same round, and its
            # divergentEntries mirrors this exact value).
            replica_divergent_entries.labels(collection, shard).set(
                divergent_known)
        except Exception:  # pragma: no cover — registry unavailable
            pass

    def record_read_divergence(self, collection: str, shard: str,
                               stale: int) -> None:
        """A consistency-level read (finder) caught replicas disagreeing
        between beats — the read-path divergence signal."""
        if stale <= 0:
            return
        with self._lock:
            rec = self._rec(collection, shard)
            rec["read_divergence_total"] += stale

    @staticmethod
    def _state(rec: dict) -> str:
        if rec["rounds"] == 0:
            return "unknown"
        peers = rec["peers"].values()
        if any(s.get("error") for s in peers):
            return "degraded"  # at least one peer unreachable last round
        if all((s.get("remaining") or 0) == 0 for s in peers):
            return "converged"
        return "diverging"

    def snapshot(self) -> dict:
        now = time.time()
        shards = []
        with self._lock:
            items = sorted(self._shards.items())
            for (col, shard), rec in items:
                shards.append({
                    "collection": col,
                    "shard": shard,
                    "rounds": rec["rounds"],
                    "reconciledTotal": rec["reconciled_total"],
                    "lastBeatAgeSeconds": (
                        round(now - rec["last_beat_t"], 3)
                        if rec["last_beat_t"] else None),
                    # last KNOWN remaining divergence — all-unreachable
                    # rounds do not reset this to a misleading 0 (the
                    # state field reads "degraded" then); mirrors the
                    # weaviate_tpu_replica_divergent_entries gauge
                    "divergentEntries": rec["divergent_known"],
                    "lastDiffBuckets": sum(
                        s.get("diff_buckets") or 0
                        for s in rec["peers"].values()),
                    "readDivergenceTotal": rec["read_divergence_total"],
                    "state": self._state(rec),
                    "peers": {p: {k: v for k, v in s.items() if k != "t"}
                              for p, s in rec["peers"].items()},
                })
        return {
            "shards": shards,
            "totals": {
                "rounds": sum(s["rounds"] for s in shards),
                "reconciled": sum(s["reconciledTotal"] for s in shards),
                "converged": all(s["state"] == "converged"
                                 for s in shards) if shards else None,
            },
        }

    def reset(self) -> None:
        """Test hook (autouse fixture): metrics series are dropped too
        so a prior test's divergence gauge can't leak into the next."""
        with self._lock:
            keys = list(self._shards)
            self._shards.clear()
        try:
            from weaviate_tpu_torch.runtime.metrics import (
                replica_divergent_entries)

            for col, shard in keys:
                replica_divergent_entries.remove(col, shard)
        except Exception:  # pragma: no cover
            pass


replication_status = ReplicationStatus()


class HashBeater:
    def __init__(self, collection, depth: int = 8):
        self.col = collection
        self.depth = depth

    def _peer_rpc(self, node: str, shard_name: str, op: str, payload: dict):
        # per-attempt ceiling = the shared remote-client config
        # (REMOTE_RPC_TIMEOUT_S, no longer a hard-coded 30s); rpc()
        # additionally caps it by any ambient deadline budget
        remote = self.col._require_remote(shard_name)
        return rpc(remote.resolver(node),
                   f"/replicas/{self.col.config.name}/{shard_name}/{op}",
                   payload, timeout=remote.timeout)

    def beat_shard(self, shard_name: str) -> int:
        """One anti-entropy round for one locally-owned shard against all
        peer replicas. Returns number of entries reconciled."""
        shard = self.col._load_shard(shard_name)
        peers = [n for n in self.col.sharding.nodes_for(shard_name)
                 if n != self.col.local_node]
        if not peers:
            return 0
        total = 0
        tree = shard.build_hashtree(self.depth)
        peer_stats: dict[str, dict] = {}
        for peer in peers:
            try:
                n, stats = self._beat_peer(shard, tree, shard_name, peer)
                total += n
                peer_stats[peer] = {"reconciled": n, "error": None, **stats}
            except (RpcError, KeyError) as e:
                # an unreachable peer leaves its divergence UNKNOWN, not
                # zero — the status registry reports the round degraded
                peer_stats[peer] = {"reconciled": 0, "divergent": None,
                                    "remaining": None,
                                    "diff_buckets": None, "error": str(e)}
                logger.debug("hashbeat %s/%s vs %s skipped: %s",
                             self.col.config.name, shard_name, peer, e)
        replication_status.record_round(self.col.config.name, shard_name,
                                        peer_stats)
        return total

    def _beat_peer(self, shard, tree: MerkleTree, shard_name: str,
                   peer: str) -> tuple[int, dict]:
        walk: dict = {}  # token pins the peer's snapshot across levels

        def peer_level(level: int, positions: list[int]):
            reply = self._peer_rpc(peer, shard_name, "hashtree:level",
                                   {"depth": self.depth, "level": level,
                                    "positions": positions,
                                    "token": walk.get("token")})
            walk["token"] = reply.get("token")
            return reply["hashes"]

        buckets = tree.diff_buckets(peer_level)
        if not buckets:
            return 0, {"divergent": 0, "remaining": 0, "diff_buckets": 0}
        theirs = {d["uuid"]: d for d in
                  self._peer_rpc(peer, shard_name, "digests:bucket",
                                 {"depth": self.depth,
                                  "buckets": buckets})["digests"]}
        mine = {d["uuid"]: d for d in shard.bucket_digests(self.depth, buckets)}

        push_objs: list[str] = []
        push_dels: list[dict] = []
        pull_uuids: list[str] = []
        pull_dels: list[dict] = []
        for uuid in set(mine) | set(theirs):
            m, t = mine.get(uuid), theirs.get(uuid)
            if t is None or (m is not None and digest_rank(m) > digest_rank(t)):
                if m["deleted"]:
                    push_dels.append({"uuid": uuid, "mtime": m["mtime"]})
                else:
                    push_objs.append(uuid)
            elif m is None or digest_rank(t) > digest_rank(m):
                if t["deleted"]:
                    pull_dels.append({"uuid": uuid, "mtime": t["mtime"]})
                else:
                    pull_uuids.append(uuid)

        divergent = (len(push_objs) + len(push_dels)
                     + len(pull_uuids) + len(pull_dels))
        n = 0
        if push_objs or push_dels:
            raws = [shard.objects.get(u.encode()) for u in push_objs]
            n += self._peer_rpc(peer, shard_name, "sync:apply",
                                {"objects": [r for r in raws if r],
                                 "deletes": push_dels})["applied"]
        if pull_uuids or pull_dels:
            raws = self._peer_rpc(peer, shard_name, "objects:fetch",
                                  {"uuids": pull_uuids})["objects"] \
                if pull_uuids else []
            applied = shard.apply_sync([r for r in raws if r], pull_dels)
            if applied:
                from weaviate_tpu_torch.runtime.metrics import (
                    hashbeat_repairs_total)

                hashbeat_repairs_total.labels("pulled").inc(applied)
            n += applied
        if n:
            logger.info("hashbeat %s/%s vs %s reconciled %d entries",
                        self.col.config.name, shard_name, peer, n)
        # remaining = entries the walk saw diverged that this round did
        # NOT repair (rank ties both sides refuse, marker-skipped
        # pushes, fetch misses) — the convergence gauge reads this
        return n, {"divergent": divergent,
                   "remaining": max(0, divergent - n),
                   "diff_buckets": len(buckets)}

    def beat(self) -> bool:
        """Cycle callback: beat every locally-owned shard of the
        collection. True when anything was reconciled."""
        if self.col.config.replication.factor < 2:
            return False
        did = 0
        for name in list(self.col.sharding.shard_names):
            if self.col._is_local(name):
                try:
                    did += self.beat_shard(name)
                except Exception:
                    logger.exception("hashbeat failed for %s", name)
        return did > 0

    def roots_equal(self, shard_name: str) -> bool:
        """Do all replicas of ``shard_name`` report the same hashtree
        root right now? The convergence predicate the chaos checker and
        the antientropy bench poll between beat rounds."""
        shard = self.col._load_shard(shard_name)
        root = shard.build_hashtree(self.depth).root
        for peer in self.col.sharding.nodes_for(shard_name):
            if peer == self.col.local_node:
                continue
            reply = self._peer_rpc(peer, shard_name, "hashtree:level",
                                   {"depth": self.depth, "level": 0,
                                    "positions": [0], "token": None})
            if reply["hashes"][0] != root:
                return False
        return True
