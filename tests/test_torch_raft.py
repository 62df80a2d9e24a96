"""The port's Raft log and schema FSM: restart safety (a copy of the Raft
section of tests/test_crash_recovery.py, nodes on the CPU), a proposal
whose entry a new leader replaced (the port raises and proposes again;
the JAX Raft reports it applied), the FSM held to the JAX package's after
the same proposals, and the port's rules (a node without ``device=``
needs CUDA; the cluster imports without JAX).
"""

import subprocess
import sys
import time

import pytest

from weaviate_tpu_torch.storage.kv import KVStore


# -- raft restart safety ---------------------------------------------------------


class _StubServer:
    def route(self, path, fn):
        pass


def _solo_raft(store, **kw):
    from weaviate_tpu_torch.cluster.raft import RaftNode

    bucket = store.bucket("raft", "replace", sync_wal=True)
    return RaftNode("me", ["me", "a", "b"], lambda n: None, _StubServer(),
                    apply_fn=lambda op: None, store_bucket=bucket, **kw)


def test_raft_no_double_vote_across_restart(tmp_path):
    """votedFor must hit disk before the vote RPC is answered: a node
    that votes, crashes, and restarts must refuse a DIFFERENT candidate
    in the same term (two grants = two leaders)."""
    d = str(tmp_path)
    store = KVStore(d)
    node = _solo_raft(store)
    reply = node._handle_vote({"term": 5, "candidate": "a",
                               "last_log_index": -1, "last_log_term": 0})
    assert reply["granted"]
    # crash-sim: NO close/stop — reopen the bucket from disk
    store2 = KVStore(d)
    node2 = _solo_raft(store2)
    assert node2.current_term == 5
    assert node2.voted_for == "a"
    denied = node2._handle_vote({"term": 5, "candidate": "b",
                                 "last_log_index": 99,
                                 "last_log_term": 5})
    assert not denied["granted"], "double vote after restart"
    # re-granting the SAME candidate is raft-legal (idempotent)
    again = node2._handle_vote({"term": 5, "candidate": "a",
                                "last_log_index": -1,
                                "last_log_term": 0})
    assert again["granted"]
    store2.close()


def test_raft_restore_ignores_stale_span_tail_term(tmp_path):
    """Crash window of the PRE-batching persist format: a snapshot
    frame landed but the process died before the matching log_span
    frame. The stale span's snap_last_term describes an OLDER boundary
    — adopting it would make _last_log() under-report this node's last
    term and let it grant votes to candidates with older logs (Raft
    §5.4.1). The snapshot's own last_term must stand. (New snapshots
    batch snapshot+span+meta into ONE synced frame so this state can
    no longer be produced — this guards restores of old on-disk
    states, and the invariant itself.)"""
    d = str(tmp_path)
    store = KVStore(d)
    b = store.bucket("raft", "replace", sync_wal=True)
    # old-format crash artifact: span at the OLD boundary (start 0,
    # tail term 0), snapshot already advanced to last_index=3 term=2
    b.put(b"log_span", {"start": 0, "len": 4, "snap_last_term": 0})
    for i in range(4):
        b.put(f"log-{i:012d}".encode(),
              {"term": 1 if i < 2 else 2, "op": {"type": "noop"}})
    b.put(b"snapshot", {"state": {}, "last_index": 3, "last_term": 2,
                        "peers": ["me", "a", "b"]})
    b.put(b"meta", {"term": 2, "voted_for": None})
    store.close()

    store2 = KVStore(d)
    node = _solo_raft(store2)
    assert node._last_log() == (3, 2), node._last_log()
    # and it refuses a vote for a candidate whose log is OLDER
    denied = node._handle_vote({"term": 3, "candidate": "a",
                                "last_log_index": 3,
                                "last_log_term": 1})
    assert not denied["granted"]
    store2.close()


def test_raft_snapshot_and_span_share_one_frame(tmp_path):
    """take_snapshot persists snapshot+span+meta in ONE WAL frame — a
    crash at any byte boundary leaves either the old state or the new,
    never a snapshot whose span disagrees with it."""
    d = str(tmp_path)
    store = KVStore(d)
    node = _solo_raft(store, snapshot_fn=lambda: {"x": 1},
                      restore_fn=lambda s: None)
    node.role = "leader"
    node.leader_id = "me"
    node.peers = ["me"]
    node._next_index = {}
    node._match_index = {}
    for i in range(3):
        node.propose_local({"type": "noop2", "i": i}, timeout=5.0)
    wal_frames_before = node._bucket._recovery  # noqa: F841 (open state)
    node.take_snapshot()
    store.close()
    # restore must see a CONSISTENT (snapshot, span) pair
    store2 = KVStore(d)
    node2 = _solo_raft(store2, snapshot_fn=lambda: {"x": 1},
                       restore_fn=lambda s: None)
    assert node2.log_start == node.log_start
    assert node2.snap_last_term == node.snap_last_term
    assert node2._last_log() == node._last_log()
    store2.close()


def test_raft_acked_append_survives_restart(tmp_path):
    """Entries a follower acked must be in its log after a crash — the
    leader counted this ack toward commit."""
    d = str(tmp_path)
    store = KVStore(d)
    node = _solo_raft(store)
    entries = [{"term": 1, "op": {"type": "add_class", "i": i}}
               for i in range(3)]
    reply = node._handle_append({"term": 1, "leader": "a",
                                 "prev_index": -1, "prev_term": 0,
                                 "entries": entries, "leader_commit": -1})
    assert reply["success"]
    store2 = KVStore(d)
    node2 = _solo_raft(store2)
    assert [e["op"].get("i") for e in node2.log] == [0, 1, 2]
    assert node2.current_term == 1
    store2.close()


def _overwritten_proposal(node) -> dict:
    """A leader at term 2 proposes an op its followers never receive; a
    leader of term 3 that never saw it puts its no-op barrier at the same
    index and commits it. Returns what the proposal returned or raised."""
    import threading

    node.role = "leader"
    node.leader_id = "me"
    node.current_term = 2
    node._next_index = {"a": 0, "b": 0}
    node._match_index = {"a": -1, "b": -1}
    node._replicate_all = lambda: None  # the entry reaches no follower
    out: dict = {}

    def propose():
        try:
            out["index"] = node.propose_local(
                {"type": "update_sharding", "class": "C", "placement": {},
                 "factor": 3}, timeout=10.0)
        except Exception as e:  # noqa: BLE001 — the outcome under test
            out["error"] = e

    t = threading.Thread(target=propose)
    t.start()
    deadline = time.time() + 10.0
    while node._abs_last() < 0 and time.time() < deadline:
        time.sleep(0.01)
    reply = node._handle_append({"term": 3, "leader": "a", "prev_index": -1,
                                 "prev_term": 0,
                                 "entries": [{"term": 3,
                                              "op": {"type": "noop"}}],
                                 "leader_commit": 0})
    t.join(10.0)
    assert reply["success"] and not t.is_alive()
    assert node.log == [{"term": 3, "op": {"type": "noop"}}]
    return out


def test_an_overwritten_proposal_is_not_reported_applied(tmp_path):
    """The index a proposal waited on applied another leader's entry: the
    proposal raises, so the caller proposes again (a scaler's placement
    reported committed here would never reach any node's schema)."""
    from weaviate_tpu_torch.cluster.raft import LostEntryError

    store = KVStore(str(tmp_path))
    out = _overwritten_proposal(_solo_raft(store))
    store.close()
    assert "index" not in out
    assert isinstance(out.get("error"), LostEntryError), out


def test_the_jax_raft_reports_an_overwritten_proposal_applied(tmp_path):
    """The JAX package's Raft returns the overwritten proposal's index as
    if its op had committed: the port's raising is a deliberate
    difference."""
    from weaviate_tpu.cluster.raft import RaftNode
    from weaviate_tpu.storage.kv import KVStore as JaxKVStore

    store = JaxKVStore(str(tmp_path))
    bucket = store.bucket("raft", "replace", sync_wal=True)
    node = RaftNode("me", ["me", "a", "b"], lambda n: None, _StubServer(),
                    apply_fn=lambda op: None, store_bucket=bucket)
    out = _overwritten_proposal(node)
    store.close()
    assert out == {"index": 0}


def test_propose_retries_a_lost_entry_until_it_commits(tmp_path):
    """``propose`` on a leader whose first entry was replaced proposes the
    op again and returns the index where it did commit."""
    from weaviate_tpu_torch.cluster.raft import LostEntryError, RaftNode

    store = KVStore(str(tmp_path))
    node = _solo_raft(store)
    node.role = "leader"
    node.leader_id = "me"
    calls = []

    def flaky(op, timeout=10.0):
        calls.append(op)
        if len(calls) == 1:
            raise LostEntryError("replaced")
        return 7

    node.propose_local = flaky
    assert RaftNode.propose(node, {"type": "noop2"}, timeout=5.0) == 7
    assert len(calls) == 2
    store.close()


@pytest.fixture
def crash_cluster(tmp_path):
    """3-node cluster + a crash/restart helper that abandons a node
    WITHOUT flushing (kill -9 semantics for everything the process
    didn't fsync; the raft bucket is pinned sync so raft state is
    exactly what reached disk)."""
    import time

    from weaviate_tpu_torch.cluster import ClusterNode

    names = ["c0", "c1", "c2"]
    nodes = {}

    def make(name):
        return ClusterNode(name, str(tmp_path / name), raft_peers=names,
                           gossip_interval=0.1,
                           election_timeout=(0.2, 0.4), sync_wal=True,
                           device="cpu")

    for n in names:
        nodes[n] = make(n)
    addrs = [nodes[n].address for n in names]
    for n in names:
        nodes[n].membership.join(addrs)
    for n in names:
        nodes[n].start()
    for n in names:
        nodes[n].raft.wait_for_leader(timeout=10.0)

    def crash(name):
        node = nodes[name]
        node.raft._stop.set()
        node.membership.stop()
        node.server.stop()
        node.db.cycles.stop()
        # NOTE: no db.close()/flush — in-RAM state is abandoned

    def restart(name):
        node = make(name)
        node.membership.join([nodes[n].address for n in names
                              if n != name] + [node.address])
        node.start()
        nodes[name] = node
        return node

    yield nodes, crash, restart
    for node in nodes.values():
        try:
            node.close()
        except Exception:
            pass


def _wait(cond, timeout=15.0, msg="condition"):
    import time

    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _create_with_retry(nodes, cfg, attempts=4):
    """Bounded-retry schema create against whichever node currently
    leads (same rationale as test_cluster's helper: under full-suite
    load the 0.2-0.4s election timeout churns leadership mid-propose,
    and a propose that timed out AFTER committing shows up as the
    collection existing — success, not a retry)."""
    last = None
    for _ in range(attempts):
        node = next((n for n in nodes if n.raft.is_leader), nodes[0])
        try:
            node.create_collection(cfg)
            return
        except Exception as e:  # churn: retry against the new leader
            last = e
            if any(cfg.name in n.db.collections for n in nodes):
                return
            try:
                node.raft.wait_for_leader(timeout=10.0)
            except Exception:
                pass
    raise last


def test_quorum_acked_schema_survives_leader_crash(crash_cluster):
    """The acceptance invariant: a schema op the cluster QUORUM-acked
    (raft propose returned) must exist on every node after the LEADER
    is killed and restarted, and the restarted node's raft must
    re-converge with commitIndex >= the pre-crash commit."""
    from weaviate_tpu_torch.schema.config import CollectionConfig, Property

    nodes, crash, restart = crash_cluster
    leader_name = next(n for n, node in nodes.items()
                       if node.raft.is_leader)
    leader = nodes[leader_name]
    _create_with_retry(list(nodes.values()), CollectionConfig(
        name="Durable", properties=[Property("t", "text")]))
    _wait(lambda: all("Durable" in node.db.collections
                      for node in nodes.values()),
          msg="schema on all nodes pre-crash")
    # re-resolve: the retry may have landed on a NEW leader
    leader_name = next((n for n, node in nodes.items()
                        if node.raft.is_leader), leader_name)
    leader = nodes[leader_name]
    pre_commit = leader.raft.commit_index

    crash(leader_name)
    survivors = [node for n, node in nodes.items() if n != leader_name]
    _wait(lambda: any(node.raft.is_leader for node in survivors),
          msg="survivors elect a new leader")

    restarted = restart(leader_name)
    _wait(lambda: "Durable" in restarted.db.collections,
          msg="QUORUM-acked schema op on the restarted node")
    _wait(lambda: restarted.raft.commit_index >= pre_commit,
          msg="commitIndex re-converges past the pre-crash commit")
    # term never regressed
    assert restarted.raft.current_term >= 1
    # and the cluster still accepts writes end to end
    _create_with_retry(list(nodes.values()), CollectionConfig(
        name="PostCrash", properties=[Property("t", "text")]))
    _wait(lambda: all("PostCrash" in node.db.collections
                      for node in nodes.values()),
          msg="cluster functional after crash-restart", timeout=20.0)


def test_follower_crash_catches_up_with_synced_log(crash_cluster):
    """Kill a FOLLOWER mid-life; ops committed by the remaining quorum
    while it is down must apply on it after restart (from its synced
    log + the leader's appends)."""
    from weaviate_tpu_torch.schema.config import CollectionConfig, Property

    nodes, crash, restart = crash_cluster
    follower_name = next(n for n, node in nodes.items()
                         if not node.raft.is_leader)
    crash(follower_name)
    live = [node for n, node in nodes.items() if n != follower_name]
    _wait(lambda: any(node.raft.is_leader for node in live),
          msg="leader present after follower crash")
    _create_with_retry(live, CollectionConfig(
        name="WhileDown", properties=[Property("t", "text")]))
    _wait(lambda: all("WhileDown" in node.db.collections
                      for node in live),
          msg="quorum commit while follower is down")
    restarted = restart(follower_name)
    _wait(lambda: "WhileDown" in restarted.db.collections,
          msg="restarted follower catches up")


# -- the schema FSM against the JAX package's ----------------------------------


def _fsm_ops():
    """One sequence of committed schema ops, with every placement given
    explicitly so both clusters apply the same state."""
    from weaviate_tpu_torch.db.sharding import ShardingState
    from weaviate_tpu_torch.schema.config import (CollectionConfig,
                                                  MultiTenancyConfig,
                                                  Property, ShardingConfig)

    names = ["f0", "f1", "f2"]
    plain = CollectionConfig(name="Plain",
                             properties=[Property("body", "text")],
                             sharding=ShardingConfig(desired_count=3))
    gone = CollectionConfig(name="Gone", properties=[Property("x", "int")])
    mt = CollectionConfig(name="Mt", properties=[Property("t", "text")],
                          multi_tenancy=MultiTenancyConfig(enabled=True))
    return [
        {"type": "add_class", "config": plain.to_dict(),
         "sharding": ShardingState.create(3, nodes=names).to_dict()},
        {"type": "add_class", "config": gone.to_dict(),
         "sharding": ShardingState.create(1, nodes=names[1:]).to_dict()},
        {"type": "add_class", "config": mt.to_dict(),
         "sharding": ShardingState.create_partitioned().to_dict()},
        {"type": "add_property", "class": "Plain",
         "prop": {"name": "extra", "data_type": "int"}},
        {"type": "add_tenants", "class": "Mt",
         "tenants": [{"name": "t1", "nodes": ["f0"]},
                     {"name": "t2", "nodes": ["f1"]},
                     {"name": "t3", "nodes": ["f2"]}]},
        {"type": "set_tenant_status", "class": "Mt",
         "tenants": [{"name": "t2", "activityStatus": "COLD"}]},
        {"type": "remove_tenants", "class": "Mt", "tenants": ["t3"]},
        {"type": "delete_class", "name": "Gone"},
    ]


def _run_fsm_cluster(node_cls, tmp, **kw) -> list[dict]:
    names = ["f0", "f1", "f2"]
    nodes = [node_cls(n, str(tmp / n), raft_peers=names,
                      gossip_interval=0.1, election_timeout=(0.2, 0.4), **kw)
             for n in names]
    try:
        for n in nodes:
            n.membership.join([p.address for p in nodes])
        for n in nodes:
            n.start()
        for n in nodes:
            n.raft.wait_for_leader(timeout=10.0)
        for op in _fsm_ops():
            for attempt in range(4):
                leader = next((n for n in nodes if n.raft.is_leader), None)
                if leader is None:
                    nodes[0].raft.wait_for_leader(timeout=10.0)
                    continue
                try:
                    leader.raft.propose(op)
                    break
                except Exception:
                    if attempt == 3:
                        raise
        _wait(lambda: len({n.raft.last_applied for n in nodes}) == 1
              and nodes[0].raft.last_applied
              == nodes[0].raft.log_start + len(nodes[0].raft.log) - 1,
              msg="every node applied the whole log")
        return [n.fsm.snapshot() for n in nodes]
    finally:
        for n in nodes:
            n.close()


def test_fsm_snapshot_equals_jax_after_the_same_proposals(tmp_path):
    """(b) The same proposals through a three-node JAX cluster and a
    three-node port cluster leave equal FSM snapshots on every node."""
    from weaviate_tpu.cluster import ClusterNode as JNode

    from weaviate_tpu_torch.cluster import ClusterNode as TNode

    jax_snaps = _run_fsm_cluster(JNode, tmp_path / "jax")
    port_snaps = _run_fsm_cluster(TNode, tmp_path / "port", device="cpu")
    assert all(s == jax_snaps[0] for s in jax_snaps)
    assert all(s == port_snaps[0] for s in port_snaps)
    assert port_snaps[0] == jax_snaps[0]
    names = [c["config"]["name"] for c in port_snaps[0]["classes"]]
    assert names == ["Plain", "Mt"]


# -- the slice's rules -----------------------------------------------------------


@pytest.fixture
def solo_node(tmp_path):
    from weaviate_tpu_torch.cluster import ClusterNode

    node = ClusterNode("solo", str(tmp_path / "solo"), raft_peers=["solo"],
                       gossip_interval=0.1, election_timeout=(0.2, 0.4),
                       device="cpu")
    try:
        node.start()
        node.raft.wait_for_leader(timeout=10.0)
        yield node
    finally:
        node.close()


def _log_len(node) -> int:
    return node.raft.log_start + len(node.raft.log)


def test_node_without_device_needs_cuda(tmp_path):
    import torch

    from weaviate_tpu_torch.cluster import ClusterNode

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterNode("n", str(tmp_path / "n"), raft_peers=["n"])
    assert not (tmp_path / "n").exists()


def test_cluster_imports_and_serves_without_jax(tmp_path):
    """With ``jax`` blocked the cluster package imports and a node runs."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from weaviate_tpu_torch.cluster import ClusterNode\n"
        f"n = ClusterNode('x', {str(tmp_path / 'x')!r}, raft_peers=['x'],"
        " device='cpu')\n"
        "n.start(); n.raft.wait_for_leader(timeout=10.0); n.close()\n"
        "assert not any(k == 'weaviate_tpu' or k.startswith('weaviate_tpu.')"
        " for k in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(__file__)
                                 .resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
