"""Schema FSM: committed Raft ops applied to the node-local Database
(port of ``weaviate_tpu/cluster/fsm.py``).

Reference: cluster/store_apply.go:71,133-160 — the op set
(ADD_CLASS, UPDATE_CLASS, DELETE_CLASS, ADD_PROPERTY, ADD_TENANT,
DELETE_TENANT, ...) applied on EVERY node; the executor then creates the
local shards (usecases/schema/executor.go). Ops are idempotent so log
replay after restart converges.
"""

from __future__ import annotations

import logging

from weaviate_tpu_torch.db.sharding import ShardingState
from weaviate_tpu_torch.schema.config import CollectionConfig, Property

logger = logging.getLogger(__name__)


class SchemaFSM:
    def __init__(self, db):
        self.db = db

    def apply(self, op: dict) -> None:
        t = op["type"]
        if t == "add_class":
            cfg = CollectionConfig.from_dict(op["config"])
            state = ShardingState.from_dict(op["sharding"])
            if cfg.name in self.db.collections:
                return  # replay idempotence
            self.db.create_collection(cfg, sharding_state=state)
        elif t == "delete_class":
            self.db.delete_collection(op["name"])
        elif t == "add_property":
            p = dict(op["prop"])
            nested = p.get("nested")
            p["nested"] = [Property(**n) for n in nested] if nested else None
            try:
                self.db.add_property(op["class"], Property(**p))
            except ValueError:
                pass  # duplicate on replay
        elif t == "update_class":
            cfg = CollectionConfig.from_dict(op["config"])
            try:
                # merge only the mutable surface + push runtime knobs into
                # live objects (NOT a wholesale overwrite: the proposed
                # config may carry defaults for fields the proposer's
                # client omitted)
                # allow_scale=False: a stale factor in a concurrent
                # update_class must not trigger per-node scaler runs inside
                # FSM apply — factor only changes via "update_sharding"
                self.db.update_collection(cfg, allow_scale=False)
            except (KeyError, ValueError) as e:
                # replay tolerance: class deleted later in the log etc.
                logger.warning("update_class %s skipped: %s", cfg.name, e)
        elif t == "add_tenants":
            col = self.db.get_collection(op["class"])
            for tenant in op["tenants"]:
                if tenant["name"] not in col.sharding.shard_names:
                    col.add_tenant(tenant["name"], nodes=tenant.get("nodes"))
            self.db._persist(col)
        elif t == "remove_tenants":
            col = self.db.get_collection(op["class"])
            for name in op["tenants"]:
                col.remove_tenant(name)
            self.db._persist(col)
        elif t == "set_tenant_status":
            try:
                self.db.update_tenant_status(op["class"], op["tenants"])
            except (KeyError, ValueError) as e:
                # replay tolerance (tenant removed later in the log)
                logger.warning("set_tenant_status skipped: %s", e)
        elif t == "update_sharding":
            # replica scale-out/in (usecases/scaler): every node applies
            # the same placement + factor; nodes that just became owners
            # load their (already-copied) shards
            col = self.db.get_collection(op["class"])
            col.sharding.placement = {k: list(v)
                                      for k, v in op["placement"].items()}
            col.config.replication.factor = op["factor"]
            for shard in col.sharding.shard_names:
                if self.db.local_node in col.sharding.nodes_for(shard) \
                        and shard not in col.shards:
                    col._load_shard(shard)
            self.db._persist(col)
        else:
            logger.warning("unknown FSM op type %r", t)

    # -- snapshot / restore (reference: cluster/store_snapshot.go -----------
    # Persist()/Restore() marshal the schema FSM state; ours is the full
    # class set + sharding placements + tenant statuses)

    def snapshot(self) -> dict:
        classes = []
        for name, col in self.db.collections.items():
            classes.append({
                "config": col.config.to_dict(),
                "sharding": col.sharding.to_dict(),
            })
        return {"classes": classes}

    def restore(self, state: dict) -> None:
        """Make the local DB MATCH the snapshot's schema: create missing
        classes, drop classes the snapshot no longer has (their delete op
        was compacted away), and overwrite config/placement of existing
        ones. Log entries after the snapshot index replay on top, so
        converging to the snapshot state exactly is what keeps a
        caught-up-via-InstallSnapshot follower consistent."""
        entries = {CollectionConfig.from_dict(e["config"]).name: e
                   for e in state.get("classes", [])}
        for name in list(self.db.collections):
            if name not in entries:
                try:
                    self.db.delete_collection(name)
                except KeyError:
                    pass
        for name, entry in entries.items():
            cfg = CollectionConfig.from_dict(entry["config"])
            sharding = ShardingState.from_dict(entry["sharding"])
            if name not in self.db.collections:
                self.db.create_collection(cfg, sharding_state=sharding)
                continue
            col = self.db.collections[name]
            try:
                self.db.update_collection(cfg, allow_scale=False)
            except (KeyError, ValueError) as e:
                logger.warning("snapshot restore: update of %s skipped: %s",
                               name, e)
            # placement + tenant statuses follow the snapshot (the same
            # surface update_sharding owns)
            col.sharding.placement = dict(sharding.placement)
            col.sharding.tenant_status = dict(sharding.tenant_status)
            for shard in col.sharding.shard_names:
                if self.db.local_node in col.sharding.nodes_for(shard) \
                        and shard not in col.shards \
                        and col.sharding.status_of(shard) not in (
                            "COLD", "FROZEN"):
                    col._load_shard(shard)
            self.db._persist(col)
