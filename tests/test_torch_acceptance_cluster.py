"""Black-box multi-node acceptance against the port: three port cluster
nodes (shards on the CPU) each serving the public REST API; schema via
Raft from one node, writes through another, reads through a third, and a
replicated class surviving a node's death at QUORUM (a copy of the tests
of tests/test_acceptance_cluster.py).

Reference pattern: test/acceptance/multi_node + replication flows against
real N-node clusters (docker compose); here the nodes are in-process but
every client interaction crosses a real HTTP socket.
"""

import time

import numpy as np
import pytest

from weaviate_tpu_torch.api.client import Client
from weaviate_tpu_torch.cluster.node import ClusterNode


def _boot_cluster(tmp, names, **node_kwargs):
    """Start N in-process nodes and wait for gossip + a Raft leader;
    raises on non-convergence instead of proceeding silently."""
    nodes = [ClusterNode(n, str(tmp / n), raft_peers=names, device="cpu",
                         **node_kwargs)
             for n in names]
    for node in nodes:
        node.start(seed_addrs=None if node is nodes[0]
                   else [nodes[0].address])
    deadline = time.time() + 20
    while time.time() < deadline:
        if all(len(n.membership.alive_nodes()) == len(names)
               for n in nodes) and \
                any(n.raft.role == "leader" for n in nodes):
            return nodes
        time.sleep(0.05)
    for n in nodes:
        n.close()
    raise AssertionError("cluster did not converge (gossip/leader)")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("acceptance")
    nodes = _boot_cluster(tmp, ["n0", "n1", "n2"])
    clients = [Client(n.serve_rest().address) for n in nodes]
    yield nodes, clients
    for n in nodes:
        n.close()


def _wait(fn, timeout=10.0, interval=0.05):
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        try:
            out = fn()
            if out:
                return out
            last = out
        except Exception as e:  # noqa: BLE001 — retried until deadline
            last = e
        time.sleep(interval)
    raise AssertionError(f"condition not met within {timeout}s: {last!r}")


def test_schema_propagates_and_data_flows_cross_node(cluster):
    nodes, clients = cluster
    c0, c1, c2 = clients
    # create through node 0 (raft leader-forwarded if needed)
    c0.create_class({
        "class": "Doc",
        "shardingConfig": {"desiredCount": 3},
        "properties": [{"name": "n", "dataType": ["int"]},
                       {"name": "tag", "dataType": ["text"]}]})
    # every node's REST sees the class
    for c in clients:
        _wait(lambda: c.get_class("Doc"))

    # import through node 1; shards are spread over all three nodes
    rng = np.random.default_rng(0)
    objs = [{"class": "Doc",
             "properties": {"n": i, "tag": "even" if i % 2 == 0 else "odd"},
             "vector": rng.standard_normal(16).tolist()}
            for i in range(60)]
    results = c1.batch_objects(objs)
    assert all(r["result"]["status"] == "SUCCESS" for r in results)

    # count through node 2 (scatter-gather across remote shards)
    out = _wait(lambda: c2.graphql(
        "{ Aggregate { Doc { meta { count } } } }"))
    assert out["data"]["Aggregate"]["Doc"][0]["meta"]["count"] == 60

    # vector search through every node returns the same global top-1
    q = objs[7]["vector"]
    tops = []
    for c in clients:
        res = c.graphql("""
        query Q($v: [Float]) { Get { Doc(limit: 1, nearVector: {vector: $v}) {
            n _additional { id } } } }""", {"v": q})
        assert "errors" not in res, res
        tops.append(res["data"]["Get"]["Doc"][0]["n"])
    assert tops == [7, 7, 7]

    # filtered bm25 through a non-importing node
    res = c0.graphql("""
    { Get { Doc(limit: 50, bm25: {query: "even"}) { tag } } }""")
    assert "errors" not in res
    assert all(r["tag"] == "even" for r in res["data"]["Get"]["Doc"])


def test_nodes_and_statistics_endpoints(cluster):
    nodes, clients = cluster
    payload = clients[0].nodes()
    assert len(payload) == 3
    assert all(n["status"] == "HEALTHY" for n in payload)
    # raft settles asynchronously; under full-suite load the leader's
    # heartbeat round can lag the HTTP probe, so poll instead of
    # asserting the first snapshot
    stats = _wait(lambda: (lambda s: s if s.get("synchronized") else None)(
        clients[1].request("GET", "/v1/cluster/statistics")))
    assert stats["synchronized"] is True
    assert stats["statistics"][0]["raft"]["term"] >= 1


def test_delete_propagates(cluster):
    nodes, clients = cluster
    c0, c1, _ = clients
    uid = c0.create_object("Doc", {"n": 999, "tag": "del"},
                           vector=[0.0] * 16)["id"]
    _wait(lambda: c1.get_object("Doc", uid))
    c1.delete_object("Doc", uid)

    def gone():
        try:
            c0.get_object("Doc", uid)
            return False
        except Exception:
            return True

    _wait(gone)


def test_cluster_wide_backup_restore(cluster, tmp_path_factory):
    """Backup coordinates across owners: every node streams its shards to
    the shared backend; restore routes files back and re-creates the
    class through Raft (reference: backup coordinator 2-phase flow)."""
    nodes, clients = cluster
    backups = tmp_path_factory.mktemp("shared-backups")

    # give every node a provider with the SHARED filesystem backend and
    # re-serve REST with modules enabled (registers the transfer handlers)
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.modules import Provider
    from weaviate_tpu_torch.modules.backup_backends import FilesystemBackend

    mclients = []
    for n in nodes:
        p = Provider(n.db)
        p.register(FilesystemBackend(), {"path": str(backups)})
        n.rest.stop()
        mclients.append(Client(n.serve_rest(modules=p).address))
    c0, c1, c2 = mclients

    c0.create_class({"class": "BK", "shardingConfig": {"desiredCount": 3},
                     "properties": [{"name": "n", "dataType": ["int"]}]})
    # the writer (c1) AND the reader (c2) must both see the class — Raft
    # apply is eventually consistent per node
    _wait(lambda: c1.get_class("BK"))
    _wait(lambda: c2.get_class("BK"))
    import numpy as np

    rng = np.random.default_rng(4)
    results = c1.batch_objects([{"class": "BK", "properties": {"n": i},
                                 "vector": rng.standard_normal(8).tolist()}
                                for i in range(45)])
    errs = [r for r in results
            if (r.get("result") or {}).get("status") not in (None, "SUCCESS")]
    assert not errs, f"batch errors: {errs[:3]}"
    before = c2.graphql("{ Aggregate { BK { meta { count } } } }")
    assert before["data"]["Aggregate"]["BK"][0]["meta"]["count"] == 45

    # backup via node 0 (it fans out to the shard owners)
    c0.request("POST", "/v1/backups/filesystem",
               body={"id": "cb1", "include": ["BK"]})
    st = _wait(lambda: (
        lambda s: s if s["status"] in ("SUCCESS", "FAILED") else None
    )(c0.request("GET", "/v1/backups/filesystem/cb1")), timeout=60)
    assert st["status"] == "SUCCESS", st

    c0.delete_class("BK")
    _wait(lambda: "BK" not in [cl["class"] for cl in
                               c1.get_schema()["classes"]])

    c0.request("POST", "/v1/backups/filesystem/cb1/restore",
               body={"include": ["BK"]})
    st = _wait(lambda: (
        lambda s: s if s["status"] in ("SUCCESS", "FAILED") else None
    )(c0.request("GET", "/v1/backups/filesystem/cb1/restore")), timeout=60)
    assert st["status"] == "SUCCESS", st

    def count():
        out = c2.graphql("{ Aggregate { BK { meta { count } } } }")
        if "errors" in out:
            return None
        n = out["data"]["Aggregate"]["BK"][0]["meta"]["count"]
        return n if n == 45 else None

    assert _wait(count, timeout=40) == 45


def test_node_failure_detection_and_quorum(tmp_path_factory):
    """Kill one node of three: gossip marks it dead, the survivors keep
    serving, QUORUM writes to a replicated class still succeed, and
    Raft re-elects so schema writes keep working (reference: memberlist
    NotifyLeave + consistency levels + leader re-election)."""
    tmp = tmp_path_factory.mktemp("failure")
    nodes = _boot_cluster(tmp, ["f0", "f1", "f2"], gossip_interval=0.15)
    victim_name = None
    try:
        clients = [Client(n.serve_rest().address) for n in nodes]
        c0, c1, c2 = clients
        c0.create_class({"class": "HA",
                         "shardingConfig": {"desiredCount": 2},
                         "replicationConfig": {"factor": 3},
                         "properties": [{"name": "n",
                                         "dataType": ["int"]}]})
        _wait(lambda: c2.get_class("HA"))
        rng = np.random.default_rng(0)
        res = c0.batch_objects([
            {"class": "HA", "properties": {"n": i},
             "vector": rng.standard_normal(8).tolist()}
            for i in range(20)])
        assert all(r["result"]["status"] == "SUCCESS" for r in res)

        # kill a NON-leader, NON-coordinator node
        leader = next(n for n in nodes if n.raft.role == "leader")
        victim = next(n for n in nodes
                      if n is not leader and n is not nodes[0])
        victim_name = victim.name
        victim.close()

        # survivors notice the death
        survivors = [n for n in nodes if n.name != victim_name]
        _wait(lambda: all(victim_name not in s.membership.alive_nodes()
                          for s in survivors), timeout=20)
        _wait(lambda: any(
            n["name"] == victim_name and n["status"] != "HEALTHY"
            for n in clients[0].nodes()), timeout=20)

        # QUORUM writes (2 of 3) still succeed with one replica down
        res = c0.batch_objects([
            {"class": "HA", "properties": {"n": 100 + i},
             "vector": rng.standard_normal(8).tolist()}
            for i in range(10)])
        assert all(r["result"]["status"] == "SUCCESS" for r in res), res

        # reads through a survivor see all live data
        def full_count():
            o = c0.graphql("{ Aggregate { HA { meta { count } } } }")
            if "errors" in o:
                return None
            n = o["data"]["Aggregate"]["HA"][0]["meta"]["count"]
            return o if n == 30 else None

        _wait(full_count, timeout=20)

        # schema writes still work (raft majority of 2 holds; leader
        # re-election covered when the victim WAS about to lead)
        c0.create_class({"class": "PostFailure", "properties": [
            {"name": "x", "dataType": ["text"]}]})
        _wait(lambda: "PostFailure" in [
            c["class"] for c in c0.get_schema()["classes"]])
    finally:
        for n in nodes:
            if n.name != victim_name:
                try:
                    n.close()
                except Exception:
                    pass
