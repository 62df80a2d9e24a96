"""The port's cluster without real machines (a copy of
tests/test_cluster.py, every node and database on the CPU).

Reference pattern: adapters/repos/db/clusterintegrationtest/ spins 10
in-process nodes wired to real HTTP handlers on localhost ports; here we
spin 3 port ClusterNodes the same way (real sockets, real gossip, real
Raft), each holding its shards in CPU tensors.
"""

import functools
import time
import uuid as uuid_mod

import numpy as np
import pytest

from weaviate_tpu_torch.cluster import ClusterNode as _ClusterNode
from weaviate_tpu_torch.cluster import InternalServer, Membership
from weaviate_tpu_torch.schema.config import (
    CollectionConfig,
    MultiTenancyConfig,
    Property,
    ShardingConfig,
)


#: every node of these tests keeps its shards on the CPU
ClusterNode = functools.partial(_ClusterNode, device="cpu")


def _wait(cond, timeout=10.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _create_with_retry(node, cfg, attempts=4):
    """Bounded-retry create_collection: under full-suite CPU load the
    0.2-0.4 s election timeout makes leadership churn mid-propose, so a
    single propose can time out even though the cluster is healthy
    (tier-1 baseline: this was the known raft-snapshot flake). A propose
    that timed out AFTER committing shows up as the collection existing
    locally — that's success, not a retry."""
    for attempt in range(attempts):
        try:
            node.create_collection(cfg)
            return
        except Exception:
            if cfg.name in node.db.collections:
                return
            if attempt == attempts - 1:
                raise
            node.raft.wait_for_leader(timeout=10.0)


# -- membership ----------------------------------------------------------------


def test_gossip_join_and_failure_detection():
    servers = [InternalServer() for _ in range(3)]
    members = [
        Membership(f"n{i}", servers[i], interval=0.1, suspect_after=0.6,
                   dead_after=1.5)
        for i in range(3)
    ]
    for s in servers:
        s.start()
    try:
        members[1].join([servers[0].address])
        members[2].join([servers[0].address])
        for m in members:
            m.start()
        _wait(lambda: all(len(m.alive_nodes()) == 3 for m in members),
              msg="all nodes alive everywhere")
        # metadata propagates (reference: delegate broadcasts disk space)
        members[0].set_meta(disk_free=123)
        _wait(lambda: members[2].nodes()["n0"].meta.get("disk_free") == 123,
              msg="metadata propagation")
        # kill n1's server: the rest must mark it dead
        members[1].stop()
        servers[1].stop()
        _wait(lambda: "n1" not in members[0].alive_nodes()
              and "n1" not in members[2].alive_nodes(),
              msg="failure detection")
    finally:
        for m in members:
            m.stop()
        for i, s in enumerate(servers):
            if i != 1:
                s.stop()


# -- full cluster fixture ------------------------------------------------------


@pytest.fixture
def cluster(tmp_path):
    names = ["n0", "n1", "n2"]
    nodes = [
        ClusterNode(name, str(tmp_path / name), raft_peers=names,
                    gossip_interval=0.1, election_timeout=(0.2, 0.4))
        for name in names
    ]
    seed = nodes[0].address
    for n in nodes[1:]:
        n.membership.join([seed])
    # everyone must know everyone BEFORE raft starts resolving peers
    for n in nodes:
        n.membership.join([p.address for p in nodes])
    for n in nodes:
        n.start()
    for n in nodes:
        n.raft.wait_for_leader(timeout=10.0)
    yield nodes
    for n in nodes:
        try:
            n.close()
        except Exception:
            pass


def test_raft_schema_replication(cluster):
    n0, n1, n2 = cluster
    follower = next(n for n in cluster if not n.raft.is_leader)
    # schema write via a FOLLOWER must forward to the leader and apply
    # everywhere (reference: raft.go leader forwarding)
    follower.create_collection(CollectionConfig(
        name="Repl", properties=[Property("body", "text")],
        sharding=ShardingConfig(desired_count=6)))
    _wait(lambda: all("Repl" in n.db.collections for n in cluster),
          msg="schema on all nodes")
    # placement spreads shards across the 3 nodes
    state = n0.db.get_collection("Repl").sharding
    placed_nodes = {nn for nodes in state.placement.values() for nn in nodes}
    assert placed_nodes == {"n0", "n1", "n2"}
    # add_property via raft
    follower.add_property("Repl", Property("extra", "int"))
    _wait(lambda: all(
        n.db.get_collection("Repl").config.property("extra") is not None
        for n in cluster), msg="property on all nodes")


def test_distributed_write_and_scatter_gather_search(cluster):
    n0, n1, n2 = cluster
    n0.create_collection(CollectionConfig(
        name="Dist", properties=[Property("body", "text")],
        sharding=ShardingConfig(desired_count=6)))
    _wait(lambda: all("Dist" in n.db.collections for n in cluster),
          msg="schema everywhere")
    rng = np.random.default_rng(5)
    col0 = n0.get_collection("Dist")
    vecs = rng.standard_normal((40, 16)).astype(np.float32)
    uuids = [str(uuid_mod.uuid4()) for _ in range(40)]
    res = col0.batch_put([
        {"uuid": uuids[i], "properties": {"body": f"document number {i}"},
         "vector": vecs[i]}
        for i in range(40)
    ])
    assert all(r["status"] == "SUCCESS" for r in res)
    # objects actually landed on multiple nodes
    local_counts = [
        sum(s.object_count() for s in n.db.get_collection("Dist").shards.values())
        for n in cluster
    ]
    assert sum(local_counts) == 40
    assert sum(1 for c in local_counts if c > 0) >= 2, local_counts
    # global count + search from ANY node sees everything
    for n in cluster:
        col = n.get_collection("Dist")
        assert col.object_count() == 40
        hits = col.near_vector(vecs[7], k=5)
        assert hits[0].uuid == uuids[7]
        assert hits[0].object is not None
        assert hits[0].object.properties["body"] == "document number 7"
    # bm25 across nodes
    hits = n2.get_collection("Dist").bm25("document 13", k=3)
    assert any(r.uuid == uuids[13] for r in hits)
    # get/delete via a non-owning node
    assert n1.get_collection("Dist").get_object(uuids[3]) is not None
    assert n1.get_collection("Dist").delete_object(uuids[3])
    _wait(lambda: n0.get_collection("Dist").object_count() == 39,
          msg="delete visible")


def test_distributed_aggregate(cluster):
    n0 = cluster[0]
    n0.create_collection(CollectionConfig(
        name="Ag", properties=[Property("price", "number")],
        sharding=ShardingConfig(desired_count=3)))
    _wait(lambda: all("Ag" in n.db.collections for n in cluster),
          msg="schema everywhere")
    col = n0.get_collection("Ag")
    for i in range(30):
        col.put_object({"price": float(i)}, vector=[float(i), 1.0],
                       uuid=str(uuid_mod.uuid4()))
    res = cluster[2].get_collection("Ag").aggregate(properties=["price"])
    assert res["meta"]["count"] == 30
    assert res["properties"]["price"]["minimum"] == 0.0
    assert res["properties"]["price"]["maximum"] == 29.0


def test_leader_failover(cluster):
    leader = next(n for n in cluster if n.raft.is_leader)
    survivors = [n for n in cluster if n is not leader]
    leader.raft.stop()
    leader.server.stop()
    _wait(lambda: any(n.raft.is_leader for n in survivors), timeout=15.0,
          msg="new leader")
    new_leader = next(n for n in survivors if n.raft.is_leader)
    assert new_leader.raft.current_term > 0
    # schema writes still work with 2/3
    new_leader.create_collection(CollectionConfig(name="AfterFail"))
    _wait(lambda: all("AfterFail" in n.db.collections for n in survivors),
          msg="post-failover schema")


def test_cluster_fetch_objects_and_unknown_tenant(cluster):
    n0, n1, n2 = cluster
    n0.create_collection(CollectionConfig(
        name="List", sharding=ShardingConfig(desired_count=6)))
    _wait(lambda: all("List" in n.db.collections for n in cluster),
          msg="schema everywhere")
    col = n0.get_collection("List")
    uuids = sorted(str(uuid_mod.uuid4()) for _ in range(20))
    for u in uuids:
        col.put_object({"x": 1}, vector=[1.0, 2.0], uuid=u)
    # listing from ANY node sees all objects, in uuid order, paged
    lst = n2.get_collection("List")
    page1 = lst.fetch_objects(limit=8)
    page2 = lst.fetch_objects(limit=20, after=page1[-1].uuid)
    got = [o.uuid for o in page1] + [o.uuid for o in page2]
    assert got == uuids
    # unknown tenant must raise, not create phantom shards
    n0.create_collection(CollectionConfig(
        name="MTG", multi_tenancy=MultiTenancyConfig(enabled=True)))
    _wait(lambda: all("MTG" in n.db.collections for n in cluster),
          msg="schema everywhere")
    mt = n0.get_collection("MTG")
    with pytest.raises(KeyError):
        mt.get_object(str(uuid_mod.uuid4()), tenant="ghost")
    with pytest.raises(KeyError):
        mt.delete_object(str(uuid_mod.uuid4()), tenant="ghost")


def test_auto_tenant_creation_goes_through_raft(cluster):
    n0, n1, n2 = cluster
    n0.create_collection(CollectionConfig(
        name="Auto",
        multi_tenancy=MultiTenancyConfig(enabled=True,
                                         auto_tenant_creation=True)))
    _wait(lambda: all("Auto" in n.db.collections for n in cluster),
          msg="schema everywhere")
    # write with a brand-new tenant via a FOLLOWER: placement must
    # converge on every node, and the write must land
    follower = next(n for n in cluster if not n.raft.is_leader)
    col = follower.get_collection("Auto")
    u = col.put_object({"a": 1}, vector=[3.0, 4.0], tenant="fresh")
    _wait(lambda: all(
        "fresh" in n.db.get_collection("Auto").sharding.shard_names
        for n in cluster), msg="tenant everywhere")
    placements = {tuple(n.db.get_collection("Auto").sharding.placement["fresh"])
                  for n in cluster}
    assert len(placements) == 1, placements  # identical everywhere
    for n in cluster:
        assert n.get_collection("Auto").get_object(u, tenant="fresh") is not None


def test_multi_tenant_cluster(cluster):
    n0, n1, n2 = cluster
    n0.create_collection(CollectionConfig(
        name="MT", properties=[Property("body", "text")],
        multi_tenancy=MultiTenancyConfig(enabled=True)))
    _wait(lambda: all("MT" in n.db.collections for n in cluster),
          msg="schema everywhere")
    n1.add_tenants("MT", ["acme", "globex"])
    _wait(lambda: all(
        set(n.db.get_collection("MT").sharding.shard_names) == {"acme", "globex"}
        for n in cluster), msg="tenants everywhere")
    col = n2.get_collection("MT")
    u = col.put_object({"body": "tenant data"}, vector=[1.0, 2.0],
                       tenant="acme")
    # visible via every node, invisible to the other tenant
    for n in cluster:
        c = n.get_collection("MT")
        assert c.object_count(tenant="acme") == 1
        assert c.object_count(tenant="globex") == 0
        assert c.get_object(u, tenant="acme") is not None


# -- raft snapshots + dynamic membership ---------------------------------------


def test_raft_snapshot_restart_restores_without_replay(tmp_path):
    """Restart restores from the FSM snapshot and does NOT replay the
    compacted log prefix (reference: cluster/store_snapshot.go)."""
    names = ["s0", "s1", "s2"]
    nodes = [ClusterNode(n, str(tmp_path / n), raft_peers=names,
                         gossip_interval=0.1, election_timeout=(0.2, 0.4))
             for n in names]
    for n in nodes:
        n.membership.join([p.address for p in nodes])
    for n in nodes:
        n.start()
    try:
        for n in nodes:
            n.raft.wait_for_leader(timeout=10.0)
        for i in range(6):
            _create_with_retry(nodes[0], CollectionConfig(
                name=f"Snap{i}",
                properties=[Property(name="p", data_type="text")]))
        _wait(lambda: all(len(n.db.collections) == 6 for n in nodes),
              timeout=20.0, msg="schema everywhere")
        # snapshot covers [0, last_applied]; wait until every node has
        # applied its full log or the compaction asserts below race the
        # apply loop
        _wait(lambda: all(n.raft.last_applied ==
                          n.raft.log_start + len(n.raft.log) - 1
                          for n in nodes),
              msg="all nodes applied their full log")
        # force a snapshot on every node; logs compact
        for n in nodes:
            covered = n.raft.take_snapshot()
            assert covered >= 0
            assert n.raft.log_start == covered + 1
            assert len(n.raft.log) == 0
        node0_dir = str(tmp_path / "s0")
    finally:
        for n in nodes:
            n.close()

    # restart s0 alone: schema must come back via DB persistence +
    # snapshot, with the raft log EMPTY (no replay of compacted entries)
    applied = []
    n0 = ClusterNode("s0", node0_dir, raft_peers=names,
                     gossip_interval=0.1, election_timeout=(0.2, 0.4))
    try:
        orig_apply = n0.fsm.apply
        assert len(n0.db.collections) == 6
        assert len(n0.raft.log) == 0  # compacted away, not replayed
        assert n0.raft.last_applied == n0.raft.log_start - 1
    finally:
        n0.close()


def test_raft_dynamic_node_join(tmp_path):
    """A 4th node joins a RUNNING 3-node cluster through the conf-change
    log path and receives the schema (reference: bootstrap.go:33)."""
    names = ["j0", "j1", "j2"]
    nodes = [ClusterNode(n, str(tmp_path / n), raft_peers=names,
                         gossip_interval=0.1, election_timeout=(0.2, 0.4))
             for n in names]
    for n in nodes:
        n.membership.join([p.address for p in nodes])
    for n in nodes:
        n.start()
    joiner = None
    try:
        for n in nodes:
            n.raft.wait_for_leader(timeout=10.0)
        nodes[0].create_collection(CollectionConfig(
            name="JC", properties=[Property(name="p", data_type="text")]))
        _wait(lambda: all("JC" in n.db.collections for n in nodes),
              msg="schema on 3 nodes")

        # boot the 4th node knowing only itself; it joins via any member
        joiner = ClusterNode("j3", str(tmp_path / "j3"), raft_peers=["j3"],
                             gossip_interval=0.1,
                             election_timeout=(0.2, 0.4))
        joiner.membership.join([n.address for n in nodes])
        for n in nodes:
            n.membership.join([joiner.address])
        joiner.start(join=nodes[0].address)
        # joiner becomes a voter and catches up the schema through the log
        _wait(lambda: "j3" in joiner.raft.peers and
              sorted(joiner.raft.peers) == sorted(names + ["j3"]),
              msg="joiner in peer set")
        _wait(lambda: "JC" in joiner.db.collections,
              msg="schema caught up on joiner")
        # the existing members see the expanded peer set too
        _wait(lambda: all(sorted(n.raft.peers) == sorted(names + ["j3"])
                          for n in nodes), msg="peers updated everywhere")
        # schema changes proposed AFTER the join reach the new node
        nodes[1].create_collection(CollectionConfig(
            name="JC2", properties=[Property(name="q", data_type="int")]))
        _wait(lambda: "JC2" in joiner.db.collections,
              msg="post-join schema reaches joiner")
    finally:
        for n in nodes:
            n.close()
        if joiner is not None:
            joiner.close()


def test_raft_join_catches_up_via_snapshot(tmp_path):
    """If the leader compacted its log before the join, the new node is
    caught up via InstallSnapshot instead of entry replay (Raft §7)."""
    names = ["k0", "k1", "k2"]
    nodes = [ClusterNode(n, str(tmp_path / n), raft_peers=names,
                         gossip_interval=0.1, election_timeout=(0.2, 0.4))
             for n in names]
    for n in nodes:
        n.membership.join([p.address for p in nodes])
    for n in nodes:
        n.start()
    joiner = None
    try:
        for n in nodes:
            n.raft.wait_for_leader(timeout=10.0)
        for i in range(4):
            _create_with_retry(nodes[0], CollectionConfig(
                name=f"KS{i}", properties=[Property(name="p",
                                                    data_type="text")]))
        _wait(lambda: all(len(n.db.collections) == 4 for n in nodes),
              timeout=20.0, msg="schema everywhere")
        # every member compacts (not only today's leader): a leadership
        # change under load before the join must still meet a compacted log
        _wait(lambda: all(n.raft.last_applied ==
                          n.raft.log_start + len(n.raft.log) - 1
                          for n in nodes),
              msg="all nodes applied their full log")
        for n in nodes:
            n.raft.take_snapshot()
            assert len(n.raft.log) == 0
        leader = next(n for n in nodes if n.raft.is_leader)

        joiner = ClusterNode("k3", str(tmp_path / "k3"), raft_peers=["k3"],
                             gossip_interval=0.1,
                             election_timeout=(0.2, 0.4))
        joiner.membership.join([n.address for n in nodes])
        for n in nodes:
            n.membership.join([joiner.address])
        joiner.start(join=leader.address)
        _wait(lambda: len(joiner.db.collections) == 4,
              msg="snapshot-installed schema on joiner")
        assert joiner.raft.log_start > 0  # came via InstallSnapshot
    finally:
        for n in nodes:
            n.close()
        if joiner is not None:
            joiner.close()


def test_snapshot_restore_undoes_compacted_deletes(tmp_path):
    """A follower caught up via InstallSnapshot must DROP classes whose
    delete op was compacted into the snapshot — restore makes local
    schema match the snapshot, not a superset of it."""
    from weaviate_tpu_torch.cluster.fsm import SchemaFSM
    from weaviate_tpu_torch.db.database import Database

    db = Database(str(tmp_path / "db"), device="cpu")
    fsm = SchemaFSM(db)
    for name in ("Keep", "Drop"):
        fsm.apply({"type": "add_class",
                   "config": CollectionConfig(
                       name=name,
                       properties=[Property(name="p", data_type="text")]
                   ).to_dict(),
                   "sharding": db.collections.get("x", None) or
                   __import__("weaviate_tpu_torch.db.sharding",
                              fromlist=["ShardingState"]).ShardingState
                   .create(1, nodes=["node-0"]).to_dict()})
    assert set(db.collections) == {"Keep", "Drop"}

    # snapshot from a peer where "Drop" was deleted (and compacted away)
    db2 = Database(str(tmp_path / "db2"), device="cpu")
    fsm2 = SchemaFSM(db2)
    from weaviate_tpu_torch.db.sharding import ShardingState

    fsm2.apply({"type": "add_class",
                "config": CollectionConfig(
                    name="Keep",
                    properties=[Property(name="p", data_type="text")]
                ).to_dict(),
                "sharding": ShardingState.create(
                    1, nodes=["node-0"]).to_dict()})
    snap = fsm2.snapshot()

    fsm.restore(snap)
    assert set(db.collections) == {"Keep"}
    db.close()
    db2.close()


# -- the server's cluster branch -----------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_with_raft_join_serves_a_cluster_node(tmp_path):
    """``RAFT_JOIN`` with two members boots a ClusterNode in the port's
    Server (it used to raise): a class created through one server's REST
    reaches the other through Raft, an object written through one reads
    back through the other, and /v1/nodes lists both."""
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.config import ServerConfig
    from weaviate_tpu_torch.server import Server

    ports = [_free_port(), _free_port()]
    names = ["srv0", "srv1"]
    servers = []
    try:
        for i, name in enumerate(names):
            cfg = ServerConfig(
                data_path=str(tmp_path / name), host="127.0.0.1",
                rest_port=0, grpc_port=0, disable_telemetry=True,
                cluster_hostname=name, raft_join=names,
                cluster_data_port=ports[i],
                cluster_join=[f"127.0.0.1:{ports[1 - i]}"])
            servers.append(Server(cfg, device="cpu").assemble())
        for srv in servers:
            assert srv.node is not None and srv.db is srv.node.db
            srv.node.raft.wait_for_leader(timeout=15.0)
        c0, c1 = (Client(s.rest.address) for s in servers)
        c0.create_class({"class": "Srv", "shardingConfig": {"desiredCount": 2},
                         "properties": [{"name": "n", "dataType": ["int"]}]})
        _wait(lambda: all("Srv" in s.db.collections for s in servers),
              msg="the class on both servers")
        ids = [c0.create_object("Srv", {"n": i}, vector=[float(i), 1.0])["id"]
               for i in range(6)]
        for u in ids:
            assert c1.get_object("Srv", u)["properties"]["n"] in range(6)
        _wait(lambda: {n["name"] for n in c1.nodes()} == set(names),
              msg="both nodes listed")
    finally:
        for srv in servers:
            srv.stop()
