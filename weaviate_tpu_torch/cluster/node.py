"""ClusterNode: one process-worth of the distributed database (port of
``weaviate_tpu/cluster/node.py``).

Composes (reference: configure_api.go MakeAppState wiring order):
internal HTTP server (clusterapi), gossip membership (usecases/cluster),
Raft schema store (cluster/), remote shard client (adapters/clients),
and the node-local Database, whose shards live on ``device``: the CUDA
card by default; without CUDA the node raises unless the caller names
``device="cpu"``. Schema writes go through Raft; object reads and writes
go point to point over the data plane, and a shard's search runs on a
node that holds a replica, on its card through that node's batcher. The
replica handlers (``/replicas/...``: 2PC, digests, hashtree walks, sync)
serve the node's shards, and a ``hashbeat`` cycle runs anti-entropy over
every replicated collection.
"""

from __future__ import annotations

import dataclasses
import logging

from weaviate_tpu_torch.cluster.fsm import SchemaFSM
from weaviate_tpu_torch.cluster.membership import Membership
from weaviate_tpu_torch.cluster.raft import RaftNode
from weaviate_tpu_torch.cluster.remote import RemoteShardClient, register_incoming
from weaviate_tpu_torch.cluster.transport import InternalServer
from weaviate_tpu_torch.db.database import Database
from weaviate_tpu_torch.db.sharding import ShardingState
from weaviate_tpu_torch.parallel.mesh import placement
from weaviate_tpu_torch.schema.config import CollectionConfig, Property

logger = logging.getLogger(__name__)

class ClusterNode:
    def __init__(self, name: str, data_dir: str, raft_peers: list[str],
                 host: str = "127.0.0.1", port: int = 0, mesh=None,
                 gossip_interval: float = 0.3,
                 election_timeout: tuple[float, float] = (0.3, 0.6),
                 advertise: str | None = None,
                 remote_timeout: float | None = None,
                 sync_wal: bool | None = None, device=None):
        """``raft_peers``: the static bootstrap member set (node names,
        incl. this one) — reference: RAFT_JOIN env (cluster/bootstrap).
        ``advertise``: host:port other nodes reach this one at (container
        deployments bind 0.0.0.0 and advertise their service name).
        ``remote_timeout``: per-attempt ceiling for remote shard ops
        (None = REMOTE_RPC_TIMEOUT_S / 30s; always deadline-capped).
        ``sync_wal``: fsync acked data-plane writes (None =
        PERSISTENCE_WAL_SYNC; the raft bucket is pinned sync below
        either way). ``device``: where this node's shards live (None =
        the CUDA card, which must exist)."""
        # resolved first: without CUDA and without device= this raises
        # before a socket is bound or the data directory is touched
        self.device = placement(mesh, device)
        self.name = name
        self.server = InternalServer(host, port, advertise=advertise)
        # handlers that fan out (raft forwarding, 2PC, read repair) and
        # the faultline partition topology need to know which node a
        # thread acts as
        self.server.node_name = name
        self.membership = Membership(name, self.server,
                                     interval=gossip_interval)
        self.remote = RemoteShardClient(self.membership.resolve,
                                        timeout=remote_timeout)
        self.db = Database(data_dir, mesh=mesh, local_node=name,
                           remote=self.remote,
                           nodes_provider=self.membership.alive_nodes,
                           sync_wal=sync_wal, device=self.device)
        register_incoming(self.server, self.db)
        from weaviate_tpu_torch.replication import register_replication

        register_replication(self.server, self.db)
        self.fsm = SchemaFSM(self.db)
        # pinned sync regardless of PERSISTENCE_WAL_SYNC: raft answers
        # votes/appends only after (term, votedFor, log) are durable —
        # an unsynced ack can double-vote or lose committed entries
        # across a crash (see raft.py persistence notes)
        raft_bucket = self.db._schema_store.bucket("raft", "replace",
                                                   sync_wal=True)
        self.raft = RaftNode(name, raft_peers, self.membership.resolve,
                             self.server, self.fsm.apply,
                             store_bucket=raft_bucket,
                             election_timeout=election_timeout,
                             snapshot_fn=self.fsm.snapshot,
                             restore_fn=self.fsm.restore)
        # auto tenant creation must take the Raft path in a cluster
        self.db.set_auto_tenant_hook(self.add_tenants)
        # ledger-driven placement: every node gossips its device-memory
        # ledger total; placement + cross-node epoch migration read the
        # peers' readings from membership meta
        self.db.node_hbm_provider = self._gossiped_hbm
        self.server.start()
        self.rest = None

    @property
    def address(self) -> str:
        return self.server.address

    def start(self, seed_addrs: list[str] | None = None,
              join: str | None = None) -> None:
        """``join``: internal address of any existing cluster member —
        this node gossips in AND submits a Raft conf change to become a
        voter (reference: cluster/bootstrap/bootstrap.go:33 joiner)."""
        if seed_addrs:
            self.membership.join(seed_addrs)
        self.membership.start()
        self.raft.start()
        if join:
            self.raft.request_join(join)
        # anti-entropy beat over all replicated collections
        # (reference: shard_hashbeater launched per shard at shard load)
        self.db.cycles.register("hashbeat", self._hashbeat_cycle,
                                interval=5.0, max_interval=60.0)
        # broadcast this node's device-memory ledger total (reference:
        # delegate.go piggybacks disk space on gossip the same way)
        self._publish_hbm()
        self.db.cycles.register("hbm-gossip", self._publish_hbm,
                                interval=2.0, max_interval=30.0)
        self.db.cycles.start()

    def _publish_hbm(self) -> bool:
        """Refresh the gossiped ``hbmBytes`` meta from the local ledger of
        device bytes (the card's, on a CUDA node). Returns True ("did
        work") every time: a False return is the cyclemanager's
        IDLE/backoff signal and would decay this heartbeat from its 2s
        cadence toward max_interval — placement would then rank nodes on
        up-to-30s-stale readings."""
        self.membership.set_meta(hbmBytes=self.db._local_hbm())
        return True

    def _hashbeat_cycle(self) -> bool:
        from weaviate_tpu_torch.replication import HashBeater
        from weaviate_tpu_torch.runtime import faultline

        did = False
        # the cycle thread beats AS this node (partition topology src)
        with faultline.node_scope(self.name):
            for col in list(self.db.collections.values()):
                if col.config.replication.factor > 1:
                    did = HashBeater(col).beat() or did
        return did

    def _gossiped_hbm(self) -> dict:
        """node -> last gossiped HBM ledger bytes (nodes that never
        reported are absent — placement treats them as unknown)."""
        out = {}
        for name, info in self.membership.nodes().items():
            v = (info.meta or {}).get("hbmBytes")
            if isinstance(v, (int, float)):
                out[name] = int(v)
        return out

    def serve_rest(self, host: str = "127.0.0.1", port: int = 0,
                   modules=None, auth=None,
                   query_deadline_s: float | None = None):
        """Start the public /v1 REST API for this node (schema writes
        take the Raft path; reads/writes hit the local Database which
        scatter-gathers as needed). ``modules``/``auth`` pass through to
        the server so cluster nodes get the same vectorizer/backup/auth
        surface as standalone ones."""
        from weaviate_tpu_torch.api.rest import RestServer

        if modules is not None:
            # participant side of cluster-wide backups (reference:
            # clusterapi /backups/* routes on the internal port)
            from weaviate_tpu_torch.backup.cluster import register_backup_handlers

            register_backup_handlers(self.server, self.db, lambda: modules)
        self.rest = RestServer(self.db, host=host, port=port,
                               schema_target=self, node=self,
                               modules=modules, auth=auth,
                               query_deadline_s=query_deadline_s)
        self.rest.start()
        return self.rest

    def close(self) -> None:
        if self.rest is not None:
            self.rest.stop()
        self.raft.stop()
        self.membership.stop()
        self.server.stop()
        self.db.close()

    # -- schema API (through Raft; reference raft_apply_endpoints.go) --------

    def create_collection(self, config: CollectionConfig,
                          sharding_state=None):
        """``sharding_state``: a pre-computed placement (backup restore
        replays the descriptor's original placement so restored files
        match their shards)."""
        config.validate()
        # placement computed ONCE here, applied identically everywhere.
        # Ledger-driven: candidates rank by gossiped HBM headroom
        # (lightest first, stable for un-reported nodes), so new
        # collections land on the nodes with room.
        if sharding_state is not None:
            state = sharding_state
        elif config.multi_tenancy.enabled:
            state = ShardingState.create_partitioned()
        else:
            state = ShardingState.create(
                config.sharding.desired_count,
                nodes=self.db.placement_nodes(),
                replication_factor=config.replication.factor)
        self.raft.propose({"type": "add_class", "config": config.to_dict(),
                           "sharding": state.to_dict()})
        return self.db.get_collection(config.name)

    def delete_collection(self, name: str) -> None:
        self.raft.propose({"type": "delete_class", "name": name})

    def update_collection(self, new_cfg: CollectionConfig) -> None:
        # validate WITHOUT mutating, then replicate — the FSM applies the
        # update on every node including this one; mutating before a
        # successful propose would diverge this node from its peers
        self.db.validate_collection_update(new_cfg)
        cur = self.db.get_collection(new_cfg.name).config
        if new_cfg.replication.factor != cur.replication.factor:
            # factor changes ship shard data first (usecases/scaler) and
            # raft-commit placement+factor via "update_sharding"; by the
            # time update_class applies, the factor already matches, so
            # no node re-runs the scaler during FSM apply
            from weaviate_tpu_torch.cluster.scaler import Scaler

            Scaler(self.db, propose=self.raft.propose).scale(
                new_cfg.name, new_cfg.replication.factor)
        self.raft.propose({"type": "update_class",
                           "config": new_cfg.to_dict()})

    def add_property(self, collection: str, prop: Property) -> None:
        self.raft.propose({"type": "add_property", "class": collection,
                           "prop": dataclasses.asdict(prop)})

    def update_tenant_status(self, collection: str,
                             tenants: list[dict]) -> None:
        # validate BEFORE proposing: a garbage op would commit to the
        # replicated log, fail on every node's apply, and re-fail on
        # every replay — while the client saw a 200
        col = self.db.get_collection(collection)
        for t in tenants:
            if t.get("name") not in col.sharding.shard_names:
                raise KeyError(f"tenant {t.get('name')!r} does not exist")
            if t.get("activityStatus", "HOT").upper() not in ("HOT",
                                                              "COLD"):
                raise ValueError("tenant activityStatus must be HOT or "
                                 "COLD")
        self.raft.propose({"type": "set_tenant_status",
                           "class": collection, "tenants": tenants})

    def add_tenants(self, collection: str, tenants: list[str]) -> None:
        col = self.db.get_collection(collection)
        nodes = self.membership.alive_nodes()
        placed = []
        for t in tenants:
            # placement decided at propose time, like shards
            probe = ShardingState.create_partitioned()
            probe.add_tenant(t, nodes=nodes,
                             replication_factor=col.config.replication.factor)
            placed.append({"name": t, "nodes": probe.placement[t]})
        self.raft.propose({"type": "add_tenants", "class": collection,
                           "tenants": placed})

    def remove_tenants(self, collection: str, tenants: list[str]) -> None:
        self.raft.propose({"type": "remove_tenants", "class": collection,
                           "tenants": tenants})

    # -- convenience ---------------------------------------------------------

    def get_collection(self, name: str):
        return self.db.get_collection(name)
