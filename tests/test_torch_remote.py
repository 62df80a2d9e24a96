"""The port's internal transport and remote shard data plane against the
JAX package's, and the cross-node epoch migration over a real socket.

- (a) Wire: for the same payloads (arrays of each dtype, nested dicts,
  bytes, span headers) the port's JSON bodies and b64npy envelopes are
  byte-equal to the JAX package's, and each side decodes the other's.
- (a) Clients: the port's ``RemoteShardClient`` queries a JAX node's
  ``/indices/`` handlers and the JAX client queries the port's; one shard
  each, no Raft. The answers equal each side's local answer.
- Tracing: the W3C traceparent round trip and the remote segment stitched
  into the caller's trace (a copy of tests/test_tracing.py's transport
  cases), also across the two packages.
- Migration: a node whose shard is over its quota ships its coldest sealed
  epoch to the sibling shard on another node through the transport; every
  acknowledged write is read back exactly once and the answers before and
  after are equal.
"""

import numpy as np
import pytest

from weaviate_tpu_torch.cluster import transport as tt
from weaviate_tpu_torch.cluster.remote import RemoteShardClient as TClient
from weaviate_tpu_torch.cluster.remote import register_incoming as t_register
from weaviate_tpu_torch.db.database import Database as TDatabase
from weaviate_tpu_torch.db.sharding import ShardingState as TState
from weaviate_tpu_torch.filters.filters import Filter as TFilter
from weaviate_tpu_torch.filters.filters import Operator as TOp
from weaviate_tpu_torch.runtime import degrade, faultline, tracing
from weaviate_tpu_torch.schema.config import (CollectionConfig, Property,
                                              ShardingConfig, VectorConfig,
                                              VectorIndexConfig)


@pytest.fixture(autouse=True)
def _port_cluster_isolation():
    yield
    faultline.disarm()
    faultline.heal()
    degrade.reset()
    tt.reset_breakers()


# -- (a) wire bytes --------------------------------------------------------------

DTYPES = ["float32", "float64", "float16", "int8", "int16", "int32", "int64",
          "uint8", "uint16", "uint32", "uint64", "bool"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_envelopes_byte_equal_to_jax(dtype):
    from weaviate_tpu.cluster import transport as jt

    rng = np.random.default_rng(len(dtype))
    a = (rng.standard_normal((3, 5)) * 50).astype(dtype)
    for arr in (a, a[:, 1], a.T, a[:0], np.asarray(a[0, 0])):
        assert tt.encode_array(arr) == jt.encode_array(arr)
        body = tt.dumps({"v": arr})
        assert body == jt.dumps({"v": arr})
        # both packages send np.ascontiguousarray(arr): a 0-d array
        # crosses as shape (1,)
        want = np.ascontiguousarray(arr)
        for back in (tt.loads(body)["v"], jt.loads(body)["v"]):
            assert back.dtype == want.dtype and back.shape == want.shape
            np.testing.assert_array_equal(back, want)


def test_nested_bodies_and_span_headers_byte_equal_to_jax():
    from weaviate_tpu.cluster import transport as jt

    payload = {
        "k": np.int64(7), "f": np.float32(0.25), "raw": b"\x00\xffobj",
        "nested": {"vecs": [np.arange(4, dtype=np.float32), None],
                   "where": {"operator": "Equal", "path": ["cat"],
                             "valueInt": 3}},
        "objects": [b"a", b"bc"], "s": "text", "n": None,
    }
    body = tt.dumps(payload)
    assert body == jt.dumps(payload)
    assert tt.loads(body)["raw"] == jt.loads(body)["raw"] == b"\x00\xffobj"
    spans = [{"name": "rpc.server", "span_id": "ab" * 8, "parent_id": None,
              "start_ms": 0.5, "duration_ms": 1.25, "attrs": {"n": 3}}]
    header = tt._encode_spans(spans)
    assert header == jt._encode_spans(spans)
    assert tt._decode_spans(header) == jt._decode_spans(header) == spans
    assert tt._decode_spans("%%corrupt") is None
    assert tt.SOURCE_NODE_HEADER == jt.SOURCE_NODE_HEADER
    assert tt.TOPOLOGY_CHECKED_HEADER == jt.TOPOLOGY_CHECKED_HEADER
    assert tt.TRACE_SPANS_HEADER == jt.TRACE_SPANS_HEADER


def test_a_tensor_never_reaches_the_encoder():
    import torch

    with pytest.raises(TypeError, match="torch.Tensor"):
        tt.dumps({"v": torch.zeros(3)})
    # one numpy array on the host is what a reply carries
    assert tt.dumps({"v": torch.arange(3).numpy()}) == \
        tt.dumps({"v": np.arange(3)})


# -- (a) clients across the packages ---------------------------------------------


def _wire_rows(n=40, dim=16, seed=11):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    objs = [{"uuid": f"00000000-0000-4000-8000-{i:012d}",
             "properties": {"body": f"word{i % 5} filler{i} " * (1 + i % 3),
                            "cat": i % 4},
             "vector": vecs[i]} for i in range(n)]
    return objs, rng.standard_normal((3, dim)).astype(np.float32)


def _wire_config(pkg):
    from importlib import import_module

    cfg = import_module(f"{pkg}.schema.config")
    return cfg.CollectionConfig(
        name="Wire", properties=[cfg.Property("body", "text"),
                                 cfg.Property("cat", "int")],
        sharding=cfg.ShardingConfig(desired_count=1))


def _serve(pkg, tmp):
    """A one-shard database of ``pkg`` behind its own transport."""
    from importlib import import_module

    db_mod = import_module(f"{pkg}.db.database")
    transport = import_module(f"{pkg}.cluster.transport")
    remote = import_module(f"{pkg}.cluster.remote")
    kw = {"device": "cpu"} if pkg == "weaviate_tpu_torch" else {}
    db = db_mod.Database(str(tmp / pkg), **kw)
    db.create_collection(_wire_config(pkg))
    srv = transport.InternalServer()
    remote.register_incoming(srv, db)
    srv.start()
    return db, srv


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("weaviate_tpu", "weaviate_tpu_torch"),
                          ("weaviate_tpu_torch", "weaviate_tpu")])
def test_remote_client_against_the_other_package(tmp_path, server_pkg,
                                                 client_pkg):
    from importlib import import_module

    objs, queries = _wire_rows()
    db, srv = _serve(server_pkg, tmp_path)
    client = import_module(f"{client_pkg}.cluster.remote").RemoteShardClient(
        lambda node: srv.address, timeout=10.0)
    filters = import_module(f"{server_pkg}.filters.filters")
    objects = import_module(f"{server_pkg}.storage.objects")
    try:
        col = db.get_collection("Wire")
        node = col.sharding.nodes_for("shard-0")[0]
        # writes through the other package's client land durably
        raws = []
        for o in objs:
            so = objects.StorageObject(uuid=o["uuid"],
                                       properties=o["properties"])
            so.vector = o["vector"]
            raws.append(so.to_bytes())
        client.put_objects(node, "Wire", "shard-0", raws[:30])
        col.batch_put(objs[30:])
        assert client.overview(node, "Wire", "shard-0")["object_count"] == \
            col.object_count() == len(objs)
        where = filters.Filter.where("cat", filters.Operator.EQUAL, 2)
        for q in queries:
            for w in (None, where):
                items = client.search_shard(
                    node, "Wire", "shard-0", vector=q, k=7,
                    where=None if w is None else w.to_dict())
                local = col.near_vector(q, k=7, where=w)
                assert [(i["uuid"], i["distance"]) for i in items] == \
                    [(r.uuid, r.distance) for r in local]
                assert [objects.StorageObject.from_bytes(i["object"])
                        .properties for i in items] == \
                    [r.object.properties for r in local]
        items = client.search_shard(node, "Wire", "shard-0", query="word3",
                                    k=6, include_objects=False)
        local = col.bm25("word3", k=6, include_objects=False)
        assert [(i["uuid"], i["score"]) for i in items] == \
            [(r.uuid, r.score) for r in local]
        u = objs[5]["uuid"]
        got = objects.StorageObject.from_bytes(
            client.get_object(node, "Wire", "shard-0", u))
        assert got.properties == col.get_object(u).properties
        many = client.get_objects(node, "Wire", "shard-0",
                                  [objs[1]["uuid"], "missing", u])
        assert many[1] is None and many[0] is not None
        page = client.list_objects(node, "Wire", "shard-0", limit=10,
                                   after=objs[3]["uuid"])
        assert [objects.StorageObject.from_bytes(r).uuid for r in page] == \
            [o.uuid for o in col.fetch_objects(limit=10,
                                               after=objs[3]["uuid"])]
        assert client.aggregate(node, "Wire", "shard-0", ["cat"]) is not None
        assert client.exists(node, "Wire", "shard-0", u)
        assert client.delete_object(node, "Wire", "shard-0", u)
        assert col.get_object(u) is None
    finally:
        srv.stop()
        db.close()


# -- tracing over the transport (tests/test_tracing.py) ---------------------------


def test_traceparent_round_trip():
    header = tracing.current_traceparent()
    assert header is None
    with tracing.trace("root", force=True):
        header = tracing.current_traceparent()
    tid, parent, sampled = tracing.parse_traceparent(header)
    assert sampled and len(tid) == 32 and len(parent) == 16
    assert tracing.parse_traceparent("garbage") is None
    assert tracing.parse_traceparent(None) is None


@pytest.mark.parametrize("server_pkg", ["weaviate_tpu_torch", "weaviate_tpu"])
def test_remote_segment_stitches_over_transport(server_pkg):
    """The serving node's spans come back in the reply and join the
    caller's trace, chained to its rpc.client span; a JAX node's spans
    stitch into a port trace the same way."""
    from importlib import import_module

    server_tracing = import_module(f"{server_pkg}.runtime.tracing")
    srv = import_module(f"{server_pkg}.cluster.transport").InternalServer()

    def handler(payload):
        with server_tracing.span("remote.work"):
            pass
        return {"ok": True}

    srv.route("/t", handler)
    srv.start()
    try:
        with tracing.trace("root", force=True):
            assert tt.rpc(srv.address, "/t", {}, timeout=10.0)["ok"]
            tid = tracing.current_trace_id()
        tr = tracing.recent_traces(1)[0]
        assert tr["trace_id"] == tid
        remote = [s for s in tr["spans"] if s["attrs"].get("remote")]
        assert {"rpc.server", "remote.work"} <= {s["name"] for s in remote}
        by_id = {s["span_id"]: s for s in tr["spans"]}
        server_span = [s for s in remote if s["name"] == "rpc.server"][0]
        assert by_id[server_span["parent_id"]]["name"] == "rpc.client"
    finally:
        srv.stop()


def test_remote_segment_without_header_is_plain_span():
    srv = tt.InternalServer()
    srv.route("/t", lambda payload: {"ok": True})
    srv.start()
    try:
        before = len(tracing.recent_traces())
        assert tt.rpc(srv.address, "/t", {}, timeout=10.0)["ok"]
        assert len(tracing.recent_traces()) == before
    finally:
        srv.stop()


# -- cross-node epoch migration over the socket ----------------------------------


def _epoch_config():
    return CollectionConfig(
        name="XMig", properties=[Property("j", "int")],
        vectors=[VectorConfig(name="", dim=16, index=VectorIndexConfig(
            index_type="flat", epoch_rows=16))],
        sharding=ShardingConfig(desired_count=2))


def test_cross_node_migration_over_the_transport(tmp_path):
    """node-a's shard passes its quota; its only sibling lives on node-b,
    which reports a lighter ledger. The rescue ships the coldest sealed
    epoch over the shard RPC into node-b's own epochs: every acknowledged
    write reads back exactly once, before and after answers are equal."""
    state = TState(shard_names=["shard-0", "shard-1"],
                   placement={"shard-0": ["node-a"], "shard-1": ["node-b"]})
    db_b = TDatabase(str(tmp_path / "b"), local_node="node-b", device="cpu")
    srv = tt.InternalServer()
    t_register(srv, db_b)
    srv.start()
    db_a = TDatabase(str(tmp_path / "a"), local_node="node-a",
                     remote=TClient(lambda node: srv.address, timeout=10.0),
                     device="cpu")
    try:
        db_b.create_collection(_epoch_config(),
                               sharding_state=TState.from_dict(
                                   state.to_dict()))
        col = db_a.create_collection(_epoch_config(), sharding_state=state)
        db_a.node_hbm_provider = lambda: {"node-b": 0}
        rng = np.random.default_rng(4)
        vecs = rng.standard_normal((80, 16)).astype(np.float32)
        acked = []
        for i in range(80):
            acked.append(col.put_object({"j": i}, vector=vecs[i]))
        shard = col.shards["shard-0"]
        local_before = shard.object_count()
        assert 0 < local_before < 80
        shard.vector_indexes[""].epoch_store.seal_active()
        qs = rng.standard_normal((4, 16)).astype(np.float32)
        before = [[(r.uuid, r.distance) for r in col.near_vector(q, k=80)]
                  for q in qs]
        shard.shard_hbm_limit = 1  # over its watermark from here on
        assert db_a.cycles.run_now("epoch-maintenance")
        moved = shard.vector_indexes[""].epoch_store.migrations_total
        assert moved >= 1
        assert shard.object_count() < local_before
        assert col.object_count() == 80
        assert db_b.get_collection("XMig").shards["shard-1"].object_count() \
            == 80 - shard.object_count()
        for u in acked:  # every acknowledged write, exactly once
            assert col.get_object(u) is not None
        after = [[(r.uuid, r.distance) for r in col.near_vector(q, k=80)]
                 for q in qs]
        for b, a in zip(before, after):
            assert sorted(u for u, _ in a) == sorted(acked)
            assert len({u for u, _ in a}) == 80
            assert a == b
        # a filtered read through the migrated rows
        where = TFilter.where("j", TOp.LESS_THAN, 10)
        got = col.near_vector(qs[0], k=80, where=where)
        assert sorted(r.object.properties["j"] for r in got) == list(range(10))
    finally:
        db_a.close()
        srv.stop()
        db_b.close()
