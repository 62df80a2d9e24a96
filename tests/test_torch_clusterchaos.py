"""The port's cluster under partition topology faults and circuit
breakers, the staged-2PC TTL hardening and the convergence plane (a copy
of the topology, breaker, staged-2PC and /v1/debug/replication tests of
tests/test_clusterchaos.py; the cluster is tools/clusterchaos_torch's
ChaosCluster, three port ClusterNodes on the CPU). The scenario matrix, its sabotage checks and the sweep replay run
on tools/clusterchaos_torch in tests/test_torch_clusterchaos_matrix.py.
"""

import json
import time

import pytest

from weaviate_tpu_torch.cluster import transport
from weaviate_tpu_torch.cluster.transport import RpcError, rpc
from weaviate_tpu_torch.db.shard import StagedExpiredError
from weaviate_tpu_torch.replication.hashbeater import replication_status
from weaviate_tpu_torch.runtime import faultline
from weaviate_tpu_torch.storage.objects import StorageObject

from tools.clusterchaos_torch import checker
from tools.clusterchaos_torch.workload import COLLECTION, ChaosCluster



@pytest.fixture(autouse=True)
def _port_cluster_isolation():
    yield
    from weaviate_tpu_torch.runtime import degrade

    faultline.disarm()
    faultline.heal()
    degrade.reset()
    transport.reset_breakers()
    replication_status.reset()


# -- 1. unit: topology layer ---------------------------------------------------


def _reg(name, port):
    faultline.register_node(name, f"127.0.0.1:{port}")
    return f"127.0.0.1:{port}"


def test_topology_directed_cut_and_reply_drop():
    a, b = _reg("ta", 34501), _reg("tb", 34502)
    faultline.partition("ta", "tb", name="one")
    faultline.bind_node("ta")
    try:
        # request direction cut: unreachable
        assert faultline.check_link(b) == "unreachable"
        # reverse call: tb -> ta request is fine, but its REPLY crosses
        # the cut ta<-... no — the cut edge is ta->tb, which is the
        # reply direction of a tb->ta call
        faultline.bind_node("tb")
        assert faultline.check_link(a) == "drop"
    finally:
        faultline.bind_node(None)
        faultline.heal()


def test_topology_flap_window_and_duration():
    b = _reg("tb", 34502)
    _reg("ta", 34501)
    faultline.bind_node("ta")
    try:
        rule, = faultline.partition("ta", "tb", period=4, duty=2)
        got = [faultline.check_link(b) for _ in range(8)]
        assert got == ["unreachable", "unreachable", None, None] * 2
        assert rule.consults == 8 and rule.cuts == 4
        faultline.heal()
        faultline.partition("ta", "tb", after=2, duration=3)
        got = [faultline.check_link(b) for _ in range(7)]
        assert got == [None, None, "unreachable", "unreachable",
                       "unreachable", None, None]
    finally:
        faultline.bind_node(None)
        faultline.heal()


def test_topology_env_arming_and_self_link():
    env = {"WEAVIATE_TPU_FAULTLINE": json.dumps([
        {"topology": {"kind": "isolate", "node": "tb", "name": "envcut"}},
    ])}
    rules = faultline.arm_from_env(env=env)
    try:
        assert len(rules) == 2 and all(r.name == "envcut" for r in rules)
        assert faultline.topology_armed()
        b = _reg("tb", 34502)
        faultline.bind_node("tb")
        # a node always reaches itself, even inside its own isolation
        assert faultline.check_link(b) is None
        faultline.bind_node("ta")
        assert faultline.check_link(b) == "unreachable"
    finally:
        faultline.bind_node(None)
        faultline.heal()
    assert not faultline.topology_armed()


def test_topology_wildcard_rule_consults_once_per_rpc():
    """A rule whose patterns cover BOTH directions of a call (full
    wildcards) must bump its counter exactly once per RPC — a double
    bump would halve and phase-shift the deterministic after/duration
    windows the replay contract documents."""
    b = _reg("tb", 34502)
    _reg("ta", 34501)
    faultline.bind_node("ta")
    try:
        rule, = faultline.partition("*", "*", after=4, duration=2)
        got = [faultline.check_link(b) for _ in range(8)]
        assert got == [None] * 4 + ["unreachable"] * 2 + [None] * 2
        assert rule.consults == 8 and rule.cuts == 2
    finally:
        faultline.bind_node(None)
        faultline.heal()


def test_topology_seeded_bernoulli_replays():
    b = _reg("tb", 34502)
    _reg("ta", 34501)
    faultline.bind_node("ta")
    try:
        def draw():
            faultline.heal()
            faultline.partition("ta", "tb", p=0.5, seed=99)
            return [faultline.check_link(b) is None for _ in range(32)]

        assert draw() == draw()  # pure function of (seed, index)
    finally:
        faultline.bind_node(None)
        faultline.heal()


# -- 1. unit: breaker heal path (satellite) ------------------------------------


def test_breaker_releases_probe_on_membership_alive():
    addr = "127.0.0.1:34599"
    br = transport.breaker_for(addr)
    br.threshold, br.cooldown_s = 2, 60.0
    br.record_failure()
    br.record_failure()
    assert br.state == "open" and not br.allow()
    # without the membership signal this peer would fail-fast for 60s;
    # the gossip-alive release collapses the cooldown to ONE probe
    transport.on_peer_alive(addr)
    assert br.state == "half-open"
    assert br.allow()  # the immediate half-open probe slot
    br.record_success()
    assert br.state == "closed"


def test_heal_recovery_is_probe_bound_not_cooldown_bound(tmp_path):
    """End-to-end satellite acceptance: open a breaker against a
    partitioned peer with a LONG cooldown, heal the partition, and the
    next data-plane call must go through within gossip-probe time —
    not after the cooldown."""
    cluster = ChaosCluster(str(tmp_path), device="cpu")
    try:
        cluster.wait_members()
        addr = cluster.addr_of("n2")
        br = transport.breaker_for(addr)
        br.cooldown_s = 60.0
        faultline.isolate("n2", name="breakercut")
        with faultline.node_scope("n0"):
            for _ in range(br.threshold):
                with pytest.raises(RpcError):
                    rpc(addr, "/indices/None/none/overview", {},
                        timeout=1.0)
        assert br.state == "open"
        faultline.heal("breakercut")
        t0 = time.perf_counter()
        deadline = time.time() + 10.0
        ok = False
        while time.time() < deadline:
            try:
                with faultline.node_scope("n0"):
                    rpc(addr, "/indices/None/none/overview", {},
                        timeout=1.0)
                ok = True
                break
            except transport.CircuitOpenError:
                time.sleep(0.05)  # waiting on the gossip-alive release
            except RpcError:
                ok = True  # an HTTP error IS a living peer
                break
        recovery = time.perf_counter() - t0
        assert ok, "breaker never released after heal"
        assert recovery < 10.0 < br.cooldown_s, \
            f"recovery took {recovery:.1f}s — cooldown-bound, not " \
            "probe-bound"
        assert br.state in ("closed", "half-open")
    finally:
        cluster.close()


# -- 1. unit: staged-2PC TTL hardening -----------------------------------------


def _solo_shard(tmp_path, monkeypatch, ttl="0.2"):
    monkeypatch.setenv("WEAVIATE_TPU_STAGED_TTL_S", ttl)
    from weaviate_tpu_torch.db.database import Database
    from weaviate_tpu_torch.schema.config import CollectionConfig, Property

    db = Database(str(tmp_path / "solo"), device="cpu")
    col = db.create_collection(CollectionConfig(name="Stage", properties=[
        Property(name="t", data_type="text")]))
    shard = col._load_shard(next(iter(col.sharding.shard_names)))
    return db, shard


def test_staged_commit_refused_past_ttl(tmp_path, monkeypatch):
    """An orphaned prepare neither leaks nor commits: past the
    (configurable) TTL the commit is REFUSED with a typed error, the
    entry is gone, and the expiry counter moved."""
    from weaviate_tpu_torch.runtime.metrics import replication_staged_expired

    db, shard = _solo_shard(tmp_path, monkeypatch)
    try:
        before = replication_staged_expired.labels(
            shard.collection_name, shard.name).value
        obj = StorageObject(uuid="00000000-0000-0000-0000-000000000077",
                            properties={"t": "late"})
        shard.stage("rid-late", ("put", [obj]))
        time.sleep(0.35)
        with pytest.raises(StagedExpiredError):
            shard.commit_staged("rid-late")
        st = shard.staged_status()
        assert st == {"staged": 0, "expired_total": 1}
        assert replication_staged_expired.labels(
            shard.collection_name, shard.name).value == before + 1
        # the refused write truly never applied
        assert shard.objects.get(obj.uuid.encode()) is None
        # a FRESH entry still commits normally
        shard.stage("rid-fresh", ("put", [obj]))
        shard.commit_staged("rid-fresh")
        assert shard.objects.get(obj.uuid.encode()) is not None
    finally:
        db.close()


def test_staged_gc_counts_and_duplicate_commit_rejected(tmp_path,
                                                        monkeypatch):
    db, shard = _solo_shard(tmp_path, monkeypatch)
    try:
        obj = StorageObject(uuid="00000000-0000-0000-0000-000000000078",
                            properties={"t": "x"})
        shard.stage("rid-gc", ("put", [obj]))
        time.sleep(0.35)
        assert shard.gc_staged() == 1  # TTL gc dropped the orphan
        assert shard.staged_status()["expired_total"] == 1
        # straggler double-commit: the second attempt must find nothing
        shard.stage("rid-dup", ("put", [obj]))
        shard.commit_staged("rid-dup")
        with pytest.raises(KeyError):
            shard.commit_staged("rid-dup")
        # the maintenance cycle runs the same gc
        shard.stage("rid-cycle", ("put", [obj]))
        time.sleep(0.35)
        assert shard.maintenance() is True
        assert shard.staged_status() == {"staged": 0, "expired_total": 2}
    finally:
        db.close()


def test_apply_sync_respects_migration_marker(tmp_path, monkeypatch):
    """Hashbeat racing an epoch migration: a pushed copy of a
    cut-over (marker-durable, locally removed) uuid must be skipped,
    not resurrected at its old ring home."""
    db, shard = _solo_shard(tmp_path, monkeypatch, ttl="120")
    try:
        u = "00000000-0000-0000-0000-000000000079"
        obj = StorageObject(uuid=u, properties={"t": "mover"})
        shard.put_object_batch([obj])
        shard.mark_migrating([u], "elsewhere")
        shard.migrate_out([u], "elsewhere")
        assert shard.objects.get(u.encode()) is None
        # the peer's anti-entropy push: must be refused by the marker
        assert shard.apply_sync([obj.to_bytes()], []) == 0
        assert shard.objects.get(u.encode()) is None
        assert shard.migrated_to(u) == "elsewhere"
        # an UNMARKED uuid still applies (the skip is surgical)
        other = StorageObject(uuid="00000000-0000-0000-0000-00000000007a",
                              properties={"t": "stays"})
        assert shard.apply_sync([other.to_bytes()], []) == 1
    finally:
        db.close()


# -- 4. convergence observability ----------------------------------------------



def test_debug_replication_and_metrics_watch_heal(tmp_path):
    """/v1/debug/replication + the hashbeat/divergence metrics report
    convergence end to end: diverge replicas under a partition, heal,
    and watch the registry go rounds>0 / divergent=0 / state=converged."""
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.runtime.metrics import (
        hashbeat_rounds,
        replica_divergent_entries,
    )

    cluster = ChaosCluster(str(tmp_path), device="cpu")
    try:
        cluster.wait_members()
        for n in cluster.nodes.values():  # the test drives the beats
            n.db.cycles.unregister("hashbeat")
        cluster.create_collection()
        shard = cluster.shard_name()
        col = cluster.col("n0")
        rest = cluster.nodes["n0"].serve_rest()
        client = Client(rest.address)
        # diverge: cut n0 off and write at ONE — the local replica acks
        # alone, n1/n2 never see the objects
        faultline.isolate("n0", name="diverge")
        uuids = [f"dd000000-0000-0000-0000-{i:012d}" for i in range(8)]
        with faultline.node_scope("n0"):
            for i, u in enumerate(uuids):
                col.put_object({"client": 0, "seq": i, "rev": 900 + i},
                               vector=[1.0, 0.0], uuid=u,
                               consistency="ONE")
        faultline.heal("diverge")
        # every replica answering again, THEN a consistency-level read
        # catches the divergence between beats
        checker.wait_replicas_serving(cluster, shard)
        with faultline.node_scope("n0"):
            got = col.get_object(uuids[0], consistency="QUORUM")
        assert got is not None and got.properties["rev"] == 900
        conv = checker.drive_convergence(cluster, shard, max_rounds=6)
        assert conv["converged"], conv
        assert conv["reconciled"] >= 2 * len(uuids) - 2  # pushed to 2 peers
        snap = client.request("GET", "/v1/debug/replication")
        sh = next(s for s in snap["shards"]
                  if s["collection"] == COLLECTION and s["shard"] == shard)
        assert sh["rounds"] >= 1
        assert sh["reconciledTotal"] >= 2 * len(uuids) - 2
        assert sh["divergentEntries"] == 0
        assert sh["state"] == "converged"
        assert sh["lastBeatAgeSeconds"] is not None
        assert sh["readDivergenceTotal"] >= 1  # the QUORUM read saw it
        assert snap["totals"]["converged"] is True
        assert snap["staged"] == {}
        # the same registry feeds the gauges/counters
        assert hashbeat_rounds.labels(COLLECTION, shard).value >= 1
        assert replica_divergent_entries.labels(
            COLLECTION, shard).value == 0
        # every replica now holds the objects written at ONE
        for n in cluster.nodes.values():
            s = n.db.get_collection(COLLECTION)._load_shard(shard)
            assert all(s.get_object(u) is not None for u in uuids)
    finally:
        cluster.close()
