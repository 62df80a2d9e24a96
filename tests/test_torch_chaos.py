"""The port's cluster under chaos (a copy of the cluster tests of
tests/test_chaos.py, nodes on the CPU): a Raft leader isolated again and
again, a dead node's shard degrading a scatter-gather read to a
``missing_shard`` marker, the two asymmetric leaders, 2PC writes under
dropped replica replies, and a replicated read downgraded to the one
replica left.
"""

import time

import numpy as np
import pytest

from weaviate_tpu_torch.cluster import transport
from weaviate_tpu_torch.cluster.node import ClusterNode as _ClusterNode
from weaviate_tpu_torch.runtime import degrade, faultline
from weaviate_tpu_torch.schema.config import (CollectionConfig, Property,
                                              ReplicationConfig,
                                              ShardingConfig)


@pytest.fixture(autouse=True)
def _port_cluster_isolation():
    yield
    faultline.disarm()
    faultline.heal()
    degrade.reset()
    transport.reset_breakers()
    from weaviate_tpu_torch.replication.hashbeater import replication_status

    replication_status.reset()


def test_raft_partition_flap(tmp_path):
    """Repeatedly isolate the current leader; the surviving majority must
    keep committing schema entries and the rejoining node must converge
    with nothing lost (reference: hashicorp/raft partition semantics).
    Partitions are injected at the resolver seam: cut links resolve to a
    dead address, so RPCs fail exactly like a dropped network."""
    import time

    from weaviate_tpu_torch.cluster.node import ClusterNode

    names = ["p0", "p1", "p2"]
    nodes = {n: ClusterNode(n, str(tmp_path / n), raft_peers=names,
                            gossip_interval=0.1,
                            election_timeout=(0.2, 0.4), device="cpu")
             for n in names}
    for n in nodes.values():
        n.membership.join([p.address for p in nodes.values()])
    for n in nodes.values():
        n.start()

    cut: set[frozenset] = set()

    def patch_resolver(node):
        orig = node.raft.resolver

        def resolve(peer):
            if frozenset((node.name, peer)) in cut:
                return "127.0.0.1:1"  # dead port: fails like a drop
            return orig(peer)

        node.raft.resolver = resolve

    for n in nodes.values():
        patch_resolver(n)

    def wait_leader(exclude=(), timeout=15.0):
        t0 = time.time()
        while time.time() - t0 < timeout:
            for nid, n in nodes.items():
                if nid not in exclude and n.raft.is_leader:
                    return nid
            time.sleep(0.02)
        raise AssertionError("no leader elected")

    def propose_schema(nid, cname, timeout=20.0):
        t0 = time.time()
        while True:
            try:
                nodes[nid].create_collection(CollectionConfig(
                    name=cname,
                    properties=[Property(name="p", data_type="text")]))
                return
            except Exception:  # noqa: BLE001 - leadership churn mid-flap
                if time.time() - t0 > timeout:
                    raise
                time.sleep(0.1)

    committed = []
    try:
        for flap in range(2):
            leader = wait_leader()
            propose_schema(leader, f"Flap{flap}")
            committed.append(f"Flap{flap}")
            # isolate the leader
            cut.clear()
            cut.update(frozenset((leader, o)) for o in names if o != leader)
            new_leader = wait_leader(exclude=(leader,))
            assert new_leader != leader
            # the majority keeps committing while the old leader is dark
            propose_schema(new_leader, f"Dark{flap}")
            committed.append(f"Dark{flap}")
            # heal: old leader must step down and converge
            cut.clear()
            time.sleep(1.0)
        final = wait_leader()
        propose_schema(final, "Final")
        committed.append("Final")
        deadline = time.time() + 15.0
        while time.time() < deadline:
            if all(set(committed) <= set(n.db.collections)
                   for n in nodes.values()):
                break
            time.sleep(0.1)
        for nid, n in nodes.items():
            missing = set(committed) - set(n.db.collections)
            assert not missing, (nid, missing)
    finally:
        for n in nodes.values():
            n.close()



@pytest.fixture
def chaos_cluster(tmp_path):
    names = ["c0", "c1", "c2"]
    nodes = [_ClusterNode(name, str(tmp_path / name), raft_peers=names,
                          gossip_interval=0.1,
                          election_timeout=(0.2, 0.4), device="cpu")
             for name in names]
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
        except Exception:  # noqa: BLE001
            pass


def _wait_for(cond, timeout=10.0, msg="condition"):
    end = time.time() + timeout
    while time.time() < end:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _create_replicated(nodes, name, shards):
    nodes[0].create_collection(CollectionConfig(
        name=name, properties=[Property(name="body", data_type="text")],
        sharding=ShardingConfig(desired_count=shards),
        replication=ReplicationConfig(factor=3)))
    _wait_for(lambda: all(name in n.db.collections for n in nodes),
              msg="schema everywhere")
    return [n.db.get_collection(name) for n in nodes]


def test_2pc_commits_despite_injected_replica_rpc_drops(chaos_cluster):
    """Seeded reply-drop schedule on the replica data plane during 2PC:
    QUORUM writes must keep committing (a lost ack is not a lost
    write), nothing may hang, and the fault counter must account for
    every scheduled drop."""
    from weaviate_tpu_torch.replication.replicator import ConsistencyError
    from weaviate_tpu_torch.runtime.metrics import fault_injected_total

    nodes = chaos_cluster
    cols = _create_replicated(nodes, "Drop", 2)
    before = fault_injected_total.labels("transport.rpc.send",
                                         "drop").value
    uuids = [f"00000000-0000-0000-0000-{i:012d}" for i in range(8)]
    with faultline.injected(
            "transport.rpc.send", action="drop", every=3,
            match=lambda a: str(a.get("path", "")).startswith("/replicas/"),
    ) as sched:
        for i, u in enumerate(uuids):
            end = time.time() + 20.0
            while True:
                try:
                    cols[0].put_object({"body": f"doc {i}"},
                                       vector=[float(i), 1.0], uuid=u,
                                       consistency="QUORUM")
                    break
                except ConsistencyError:
                    # a drop pattern can align with BOTH remote replicas
                    # of one write; the coordinator aborts and the
                    # client retries — never hangs
                    assert time.time() < end
        injected = sched.injected
    assert injected >= 1  # the schedule really fired mid-2PC
    assert fault_injected_total.labels(
        "transport.rpc.send", "drop").value == before + injected
    # every write is durably readable at QUORUM via another coordinator
    for i, u in enumerate(uuids):
        got = cols[1].get_object(u, consistency="QUORUM")
        assert got is not None and got.properties["body"] == f"doc {i}"


def test_replicated_read_downgrades_consistency_with_marker(chaos_cluster):
    """With replicas dead, a QUORUM read serves the best-known value
    tagged consistency_downgraded instead of raising; an ALL read stays
    strict."""
    from weaviate_tpu_torch.replication.replicator import ConsistencyError

    nodes = chaos_cluster
    cols = _create_replicated(nodes, "DownG", 1)
    u = "10000000-0000-0000-0000-000000000001"
    cols[0].put_object({"body": "survives"}, vector=[1.0, 0.0], uuid=u,
                       consistency="ALL")
    # kill both peers: only the local replica can answer
    for n in nodes[1:]:
        n.server.stop()
    with degrade.collecting():
        got = cols[0].get_object(u, consistency="QUORUM")
        markers = degrade.snapshot()
    assert got is not None and got.properties["body"] == "survives"
    assert any(m["kind"] == "consistency_downgraded" for m in markers), \
        markers
    # ALL stays strict: the caller named every replica
    with pytest.raises(ConsistencyError):
        cols[0].get_object(u, consistency="ALL")


def test_replica_loss_degrades_scatter_gather_reads(chaos_cluster):
    """Kill one node mid-run: scatter-gather reads return PARTIAL
    results with an explicit missing_shard marker instead of erroring,
    the degraded counter accounts for them, and the dead peer's circuit
    breaker opens so later queries stop paying for it."""
    nodes = chaos_cluster
    nodes[0].create_collection(CollectionConfig(
        name="Deg", properties=[Property(name="body", data_type="text")],
        sharding=ShardingConfig(desired_count=3),
        replication=ReplicationConfig(factor=1)))
    _wait_for(lambda: all("Deg" in n.db.collections for n in nodes),
              msg="schema everywhere")
    cols = [n.db.get_collection("Deg") for n in nodes]
    rng = np.random.default_rng(0)
    n_total = 45
    for i in range(n_total):
        cols[0].put_object({"body": f"doc {i}"},
                           vector=rng.standard_normal(4).astype(np.float32),
                           uuid=f"00000000-0000-0000-0000-{i:012d}")

    # find a shard NOT owned by c0 and kill its owner's data plane
    victim_name = None
    victim_shard = None
    for shard in cols[0].sharding.shard_names:
        owner = cols[0].sharding.nodes_for(shard)[0]
        if owner != "c0":
            victim_name, victim_shard = owner, shard
            break
    assert victim_name is not None
    victim = next(n for n in nodes if n.name == victim_name)
    victim_addr = victim.server.address
    baseline = cols[0].near_vector(np.zeros(4, np.float32), k=n_total,
                                   include_objects=False)
    assert len(baseline) == n_total
    victim.server.stop()

    with degrade.collecting():
        res = cols[0].near_vector(np.zeros(4, np.float32), k=n_total,
                                  include_objects=False)
        markers = degrade.snapshot()
    # partial, not empty, not an error — and explicitly marked
    assert 0 < len(res) < n_total
    assert any(m["kind"] == "missing_shard"
               and m["shard"] == victim_shard for m in markers), markers
    assert all(r.shard != victim_shard for r in res)

    # repeated queries trip the victim's breaker: fail-fast, no budget
    for _ in range(transport.CB_THRESHOLD + 1):
        cols[0].near_vector(np.zeros(4, np.float32), k=5,
                            include_objects=False)
    assert transport.breaker_for(victim_addr).state == "open"
    t0 = time.perf_counter()
    out = cols[0].near_vector(np.zeros(4, np.float32), k=5,
                              include_objects=False)
    assert time.perf_counter() - t0 < 2.0 and out  # open breaker = cheap


def _current_leader(nodes, timeout=15.0):
    end = time.time() + timeout
    while time.time() < end:
        for n in nodes:
            if n.raft.is_leader:
                return n
        time.sleep(0.02)
    raise AssertionError("no leader")


def _propose_retry(node, cname, timeout=20.0):
    t0 = time.time()
    while True:
        try:
            node.create_collection(CollectionConfig(
                name=cname,
                properties=[Property(name="p", data_type="text")]))
            return
        except Exception:  # noqa: BLE001 — leadership churn mid-flap
            if time.time() - t0 > timeout:
                raise
            time.sleep(0.1)


def test_asymmetric_raft_leader_cannot_receive(chaos_cluster):
    """A leader that can SEND but not RECEIVE (its
    inbound links cut — heartbeats arrive at followers, every ack
    vanishes). Without the quorum-contact lease this wedges forever:
    followers never time out, the leader never commits. The leader
    must step down, the reachable majority must elect + commit, and
    the heal must converge with no committed entry lost."""
    from weaviate_tpu_torch.schema.config import CollectionConfig, Property  # noqa: F401

    nodes = chaos_cluster
    leader = _current_leader(nodes)
    others = [n for n in nodes if n is not leader]
    _propose_retry(leader, "PreCut")
    # inbound cut: x -> leader lost for every x; leader -> x intact
    faultline.partition("*", leader.name, name="inbound")
    try:
        # the lease expires: the unhearing leader abdicates
        end = time.time() + 10.0
        while time.time() < end and leader.raft.is_leader:
            time.sleep(0.05)
        assert not leader.raft.is_leader, \
            "leader kept leading with every ack cut (no step-down)"
        # the majority elects among themselves and keeps committing
        new_leader = _current_leader(others)
        assert new_leader is not leader
        _propose_retry(new_leader, "DarkCommit")
        # no split-brain: the old leader cannot commit anything
        from weaviate_tpu_torch.cluster.raft import NotLeaderError

        with pytest.raises((NotLeaderError, TimeoutError)):
            leader.raft.propose_local({"type": "noop"}, timeout=0.5)
    finally:
        faultline.heal("inbound")
    # heal: everyone converges on every committed entry
    deadline = time.time() + 20.0
    want = {"PreCut", "DarkCommit"}
    while time.time() < deadline:
        if all(want <= set(n.db.collections) for n in nodes):
            break
        time.sleep(0.1)
    for n in nodes:
        assert want <= set(n.db.collections), (n.name, n.db.collections)


def test_asymmetric_raft_leader_cannot_send(chaos_cluster):
    """The reverse asymmetry: the leader's OUTBOUND links die (it can
    receive but not send). Followers stop hearing heartbeats, elect a
    new leader, and the new leader's appends — which still REACH the
    old one — depose it. No split-brain, nothing lost."""
    nodes = chaos_cluster
    leader = _current_leader(nodes)
    others = [n for n in nodes if n is not leader]
    _propose_retry(leader, "PreOut")
    faultline.partition(leader.name, "*", name="outbound")
    try:
        new_leader = _current_leader(others)
        assert new_leader is not leader
        _propose_retry(new_leader, "OutDark")
        # the new leader's appends reach the old leader: it must have
        # stepped down to follower (higher term arrived inbound)
        end = time.time() + 10.0
        while time.time() < end and leader.raft.is_leader:
            time.sleep(0.05)
        assert not leader.raft.is_leader
    finally:
        faultline.heal("outbound")
    deadline = time.time() + 20.0
    want = {"PreOut", "OutDark"}
    while time.time() < deadline:
        if all(want <= set(n.db.collections) for n in nodes):
            break
        time.sleep(0.1)
    for n in nodes:
        assert want <= set(n.db.collections), (n.name, n.db.collections)
