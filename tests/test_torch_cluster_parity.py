"""Answers of the port's cluster held to one node and to the JAX cluster.

Three port ClusterNodes (shards on the CPU) hold a collection between
them; a one-node port ``Database`` with the same shard names takes the
same rows in the same batches, so every uuid routes to the same shard and
gets the same doc id. nearVector with and without a filter, BM25, an
aggregation, the object count and the fetches must then be equal bit for
bit: the remote legs carry distances as JSON floats, which round-trip
exactly. A JAX three-node cluster fed the same rows agrees within rtol
2e-4 / atol 2e-3 with equal ids.
"""

import time

import numpy as np
import pytest

from weaviate_tpu_torch.cluster import ClusterNode as TNode
from weaviate_tpu_torch.cluster import transport
from weaviate_tpu_torch.db.database import Database as TDatabase
from weaviate_tpu_torch.filters.filters import Filter as TFilter
from weaviate_tpu_torch.filters.filters import Operator as TOp
from weaviate_tpu_torch.runtime import degrade, faultline
from weaviate_tpu_torch.schema.config import CollectionConfig as TConfig
from weaviate_tpu_torch.schema.config import Property as TProperty
from weaviate_tpu_torch.schema.config import ShardingConfig as TSharding

DIM, ROWS, SHARDS, K = 32, 90, 3, 12
NAMES = ["p0", "p1", "p2"]


@pytest.fixture(autouse=True)
def _port_cluster_isolation():
    yield
    faultline.disarm()
    faultline.heal()
    degrade.reset()
    transport.reset_breakers()


def _wait(cond, timeout=15.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _create_with_retry(nodes, cfg, attempts=4):
    """Bounded-retry create against whichever node leads (leadership can
    churn mid-propose under full-suite load; a propose that timed out
    after committing shows up as the collection existing)."""
    for attempt in range(attempts):
        node = next((n for n in nodes if n.raft.is_leader), nodes[0])
        try:
            node.create_collection(cfg)
            return
        except Exception:
            if any(cfg.name in n.db.collections for n in nodes):
                return
            if attempt == attempts - 1:
                raise
            node.raft.wait_for_leader(timeout=10.0)


def _rows(seed=3):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    words = ["alpha", "beta", "gamma", "delta", "omega", "sigma", "kappa"]
    objs = []
    for i in range(ROWS):
        # tie-free BM25: every document has its own length and counts
        text = " ".join([words[i % 7]] * (1 + i % 5)
                        + [f"tok{j}" for j in range(i % 11 + 1)])
        objs.append({"uuid": f"00000000-0000-4000-8000-{i:012d}",
                     "properties": {"body": text, "cat": i % 10,
                                    "price": float(i) * 0.5},
                     "vector": vecs[i]})
    queries = rng.standard_normal((6, DIM)).astype(np.float32)
    return objs, queries


def _config(cls_config, cls_prop, cls_sharding, name):
    return cls_config(name=name,
                      properties=[cls_prop("body", "text"),
                                  cls_prop("cat", "int"),
                                  cls_prop("price", "number")],
                      sharding=cls_sharding(desired_count=SHARDS))


def _boot(node_cls, tmp, **kw):
    nodes = [node_cls(n, str(tmp / n), raft_peers=NAMES,
                      gossip_interval=0.1, election_timeout=(0.2, 0.4), **kw)
             for n in NAMES]
    for n in nodes:
        n.membership.join([p.address for p in nodes])
    for n in nodes:
        n.start()
    for n in nodes:
        n.raft.wait_for_leader(timeout=10.0)
    return nodes


def _close(nodes):
    for n in nodes:
        try:
            n.close()
        except Exception:  # noqa: BLE001
            pass


def _import(col, objs, batch=30):
    for s in range(0, len(objs), batch):
        res = col.batch_put(objs[s:s + batch])
        assert all(r["status"] == "SUCCESS" for r in res), res


def _hits(results):
    return [(r.uuid, r.distance) for r in results]


@pytest.fixture(scope="module")
def port_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port-cluster")
    objs, queries = _rows()
    nodes = _boot(TNode, tmp, device="cpu")
    ref = TDatabase(str(tmp / "ref"), device="cpu")
    try:
        cfg = _config(TConfig, TProperty, TSharding, "Par")
        _create_with_retry(nodes, cfg)
        _wait(lambda: all("Par" in n.db.collections for n in nodes),
              msg="schema everywhere")
        ref.create_collection(_config(TConfig, TProperty, TSharding, "Par"))
        _import(nodes[0].get_collection("Par"), objs)
        _import(ref.get_collection("Par"), objs)
        yield nodes, ref, objs, queries
    finally:
        _close(nodes)
        ref.close()


def test_cluster_spreads_shards_over_every_node(port_pair):
    nodes, ref, objs, _ = port_pair
    state = nodes[0].get_collection("Par").sharding
    assert state.shard_names == ref.get_collection("Par").sharding.shard_names
    assert {state.nodes_for(s)[0] for s in state.shard_names} == set(NAMES)
    local = [sum(s.object_count()
                 for s in n.get_collection("Par").shards.values())
             for n in nodes]
    assert sum(local) == len(objs) and all(c > 0 for c in local), local


@pytest.mark.parametrize("via", [0, 1, 2])
@pytest.mark.parametrize("filtered", [False, True])
def test_near_vector_bit_for_bit_with_one_node(port_pair, via, filtered):
    """(c) Through any node, with and without a filter (the filter tree
    travels to the owning node), ids and distances equal the one-node
    answer bit for bit; the objects ride the search replies."""
    nodes, ref, _, queries = port_pair
    where = TFilter.where("cat", TOp.EQUAL, 3) if filtered else None
    col = nodes[via].get_collection("Par")
    rcol = ref.get_collection("Par")
    for q in queries:
        got = col.near_vector(q, k=K, where=where)
        want = rcol.near_vector(q, k=K, where=where)
        assert _hits(got) == _hits(want)
        assert [r.object.properties for r in got] == \
            [r.object.properties for r in want]
        if filtered:
            assert got and all(r.object.properties["cat"] == 3 for r in got)


def test_bm25_aggregate_count_and_fetches_bit_for_bit(port_pair):
    nodes, ref, objs, queries = port_pair
    col, rcol = nodes[2].get_collection("Par"), ref.get_collection("Par")
    for text in ("alpha", "gamma tok3", "omega sigma tok7"):
        got = col.bm25(text, k=K)
        want = rcol.bm25(text, k=K)
        assert [(r.uuid, r.score) for r in got] == \
            [(r.uuid, r.score) for r in want]
    where = TFilter.where("cat", TOp.LESS_THAN, 4)
    got = col.bm25("beta tok2", k=K, where=where)
    want = rcol.bm25("beta tok2", k=K, where=where)
    assert [(r.uuid, r.score) for r in got] == \
        [(r.uuid, r.score) for r in want]
    assert col.object_count() == rcol.object_count() == len(objs)
    for w in (None, where):
        assert col.aggregate(properties=["price", "cat"], where=w) == \
            rcol.aggregate(properties=["price", "cat"], where=w)
    # the uuid-ordered listing pages across the nodes
    page = col.fetch_objects(limit=25, offset=10)
    rpage = rcol.fetch_objects(limit=25, offset=10)
    assert [(o.uuid, o.properties) for o in page] == \
        [(o.uuid, o.properties) for o in rpage]
    # the batched fetch: one objects:get per remote shard
    hits = col.near_vector(queries[0], k=K, include_objects=False)
    assert all(r.object is None for r in hits)
    col._attach_objects(hits)
    want = rcol.near_vector(queries[0], k=K)
    assert [(r.uuid, r.object.properties) for r in hits] == \
        [(r.uuid, r.object.properties) for r in want]
    # point reads and a delete through a node that owns nothing of it
    u = objs[17]["uuid"]
    assert col.get_object(u).properties == rcol.get_object(u).properties


def test_hybrid_over_the_cluster_equals_one_node(port_pair):
    nodes, ref, _, queries = port_pair
    col, rcol = nodes[1].get_collection("Par"), ref.get_collection("Par")
    got = col.hybrid("alpha tok1", vector=queries[1], alpha=0.5, k=K)
    want = rcol.hybrid("alpha tok1", vector=queries[1], alpha=0.5, k=K)
    assert [(r.uuid, r.score) for r in got] == \
        [(r.uuid, r.score) for r in want]


def test_port_cluster_agrees_with_the_jax_cluster(port_pair, tmp_path):
    """(c) The same rows on a JAX three-node cluster: ids equal, distances
    within rtol 2e-4 / atol 2e-3, BM25 scores within the same."""
    from weaviate_tpu.cluster import ClusterNode as JNode
    from weaviate_tpu.filters.filters import Filter as JFilter
    from weaviate_tpu.filters.filters import Operator as JOp
    from weaviate_tpu.schema.config import CollectionConfig as JConfig
    from weaviate_tpu.schema.config import Property as JProperty
    from weaviate_tpu.schema.config import ShardingConfig as JSharding

    nodes, _, objs, queries = port_pair
    jnodes = _boot(JNode, tmp_path)
    try:
        _create_with_retry(jnodes, _config(JConfig, JProperty, JSharding,
                                           "Par"))
        _wait(lambda: all("Par" in n.db.collections for n in jnodes),
              msg="schema on the JAX cluster")
        _import(jnodes[0].get_collection("Par"), objs)
        jcol, tcol = jnodes[1].get_collection("Par"), \
            nodes[1].get_collection("Par")
        for q in queries:
            for tw, jw in ((None, None),
                           (TFilter.where("cat", TOp.EQUAL, 5),
                            JFilter.where("cat", JOp.EQUAL, 5))):
                t = tcol.near_vector(q, k=K, where=tw, include_objects=False)
                j = jcol.near_vector(q, k=K, where=jw, include_objects=False)
                assert [r.uuid for r in t] == [r.uuid for r in j]
                np.testing.assert_allclose([r.distance for r in t],
                                           [r.distance for r in j],
                                           rtol=2e-4, atol=2e-3)
        t = tcol.bm25("gamma tok3", k=K)
        j = jcol.bm25("gamma tok3", k=K)
        assert [r.uuid for r in t] == [r.uuid for r in j]
        np.testing.assert_allclose([r.score for r in t],
                                   [r.score for r in j], rtol=2e-4,
                                   atol=2e-3)
        assert tcol.object_count() == jcol.object_count() == len(objs)
    finally:
        _close(jnodes)
