"""Replica scale-out/in (port of ``weaviate_tpu/cluster/scaler.py``).

Reference: usecases/scaler/scaler.go:38 — raising a class's replication
factor ships existing shard data to the new replica nodes
(ShardsBackup → CreateShard/ReInitShard over clusterapi); lowering just
trims placement. Resharding (changing shard count) is NOT supported, same
as the reference.
"""

from __future__ import annotations

from weaviate_tpu_torch.storage.objects import StorageObject


class ScaleError(ValueError):
    """ValueError so the REST layer maps it to 422, not 500."""


class Scaler:
    """``db``: node-local Database (its ``nodes_provider``/``local_node``/
    ``remote`` wire the cluster view, the same plumbing queries use).
    ``propose``: optional Raft-propose callable (ClusterNode passes
    ``raft.propose``) so the new placement reaches EVERY node's schema —
    without it (single node) the placement applies locally."""

    def __init__(self, db, propose=None):
        self.db = db
        self.propose = propose

    def scale(self, collection_name: str, new_factor: int,
              batch: int = 500) -> dict:
        col = self.db.get_collection(collection_name)
        old_factor = col.config.replication.factor
        if new_factor < 1:
            raise ScaleError("replication factor must be >= 1")
        nodes = list(self.db.nodes_provider())
        if new_factor > len(nodes):
            raise ScaleError(
                f"replication factor {new_factor} exceeds cluster size "
                f"{len(nodes)}")
        # plan first, mutate nothing: a failed copy must leave the live
        # sharding state untouched
        new_placement: dict[str, list[str]] = {}
        to_copy: list[tuple[str, list[str], list[str]]] = []
        for shard in list(col.sharding.shard_names):
            current = list(col.sharding.nodes_for(shard))
            if len(current) >= new_factor:
                # scale-in: trim placement (reference only ever trims;
                # data on removed replicas is orphaned until cleanup)
                new_placement[shard] = current[:new_factor]
                continue
            additions = [n for n in nodes if n not in current]
            new_nodes = additions[: new_factor - len(current)]
            if len(current) + len(new_nodes) < new_factor:
                raise ScaleError(
                    f"not enough distinct nodes for shard {shard!r}")
            new_placement[shard] = current + new_nodes
            to_copy.append((shard, current, new_nodes))
        copied: dict[str, list[str]] = {}
        for shard, current, new_nodes in to_copy:
            for node in new_nodes:
                self._copy_shard(col, shard, current, node, batch)
            copied[shard] = new_nodes
        # all copies landed: commit placement + factor — through Raft on
        # a cluster so every node converges, locally otherwise
        if self.propose is not None:
            self.propose({"type": "update_sharding",
                          "class": collection_name,
                          "placement": new_placement,
                          "factor": new_factor})
        else:
            col.sharding.placement = new_placement
            col.config.replication.factor = new_factor
            self.db._persist(col)
        return {"collection": collection_name, "from": old_factor,
                "to": new_factor, "copied": copied}

    # -- data movement -------------------------------------------------------

    def _copy_shard(self, col, shard: str, sources: list[str],
                    target: str, batch: int) -> None:
        """Stream one shard's objects to ``target`` (reference:
        ShardsBackup + CreateShard file shipping; here the object stream
        rides the same remote-shard API replication writes use)."""
        local = self.db.local_node
        raws = self._read_raw(col, shard, sources)
        if target == local:
            dst = col._load_shard(shard)
            for i in range(0, len(raws), batch):
                dst.put_object_batch(
                    [StorageObject.from_bytes(r)
                     for r in raws[i:i + batch]])
            return
        if self.db.remote is None:
            raise ScaleError(
                f"no remote client to reach node {target!r}")
        for i in range(0, len(raws), batch):
            # the target joins the placement only after this copy, so it
            # takes the objects through the copy op, not as an owner's
            # write (which its ownership check would refuse)
            self.db.remote.copy_objects(target, col.config.name, shard,
                                        raws[i:i + batch])

    def _read_raw(self, col, shard: str, sources: list[str]) -> list[bytes]:
        local = self.db.local_node
        if local in sources:
            src = col._load_shard(shard)
            return [raw for _k, raw in src.objects.iter_items()]
        if self.db.remote is None:
            raise ScaleError(f"shard {shard!r} has no local replica and no "
                             "remote client")
        errors = []
        for node in sources:
            try:
                return self.db.remote.list_objects(node, col.config.name,
                                                   shard)
            except Exception as e:  # try the next replica
                errors.append(f"{node}: {e}")
        raise ScaleError(f"could not read shard {shard!r} from any "
                         f"replica: {'; '.join(errors)}")
