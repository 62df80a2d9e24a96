"""The port's native gRPC data plane (``weaviate_tpu_torch/dataplane.py``
over its own ``csrc/host/dataplane.cpp``, and
``api/grpc/native_plane.py``) over the port's ``Database(device="cpu")``.

The first five cases are tests/test_dataplane.py's: the plane's own seams
(fast-path eligibility, the fallback of every other request, the
max_dim boundary, NOT_FOUND, the native load generator, stats). Then two
transports: the same Search, filtered Search, BatchObjects and
BatchDelete requests through the port's Python ``GrpcServer`` and through
its plane answer with the same replies (``took`` aside), and a fast-path
Search through the JAX package's plane on the same seeded data returns
the same ids, with distances within rtol 2e-4 / atol 2e-3 (the
reference's kernel tolerance, tests/test_pallas_kernels.py:32).

The module skips only when libnghttp2.so.14 cannot be loaded, as the JAX
file does; with it, a plane that fails to build is a failure.
"""

from __future__ import annotations

import ctypes
import uuid as uuid_mod

import grpc
import numpy as np
import pytest

try:
    ctypes.CDLL("libnghttp2.so.14")
except OSError:
    pytest.skip("libnghttp2.so.14 cannot be loaded", allow_module_level=True)

from weaviate_tpu_torch import dataplane as dpn  # noqa: E402
from weaviate_tpu_torch.api.grpc import v1_pb2 as pb  # noqa: E402
from weaviate_tpu_torch.api.grpc.native_plane import NativeDataPlane  # noqa: E402
from weaviate_tpu_torch.api.grpc.server import GrpcServer  # noqa: E402
from weaviate_tpu_torch.db.database import Database  # noqa: E402
from weaviate_tpu_torch.schema.config import CollectionConfig, Property  # noqa: E402

RTOL, ATOL = 2e-4, 2e-3


def test_plane_builds_where_libnghttp2_loads():
    assert dpn.available(), "libnghttp2.so.14 loads but the plane did not build"


@pytest.fixture
def db(tmp_path):
    d = Database(str(tmp_path), device="cpu")
    yield d
    d.close()


@pytest.fixture
def plane(db):
    p = NativeDataPlane(db, GrpcServer(db)).start()
    yield p
    p.stop()


def _rpc(port, name="Search", req=pb.SearchRequest, reply=pb.SearchReply):
    chan = grpc.insecure_channel(f"127.0.0.1:{port}")
    return chan, chan.unary_unary(
        f"/weaviate.v1.Weaviate/{name}",
        request_serializer=req.SerializeToString,
        response_deserializer=reply.FromString)


def _fill(db, name="DP", dim=8, n=300, seed=0):
    col = db.create_collection(CollectionConfig(
        name=name, properties=[Property(name="seq", data_type="int")]))
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    col.batch_put([{"properties": {"seq": i}, "vector": vecs[i],
                    "uuid": str(uuid_mod.UUID(int=seed * 100_000 + i))}
                   for i in range(n)])
    return col, vecs


def _req(name, vec, k=5, metadata=True, uses_123=True, certainty=False):
    r = pb.SearchRequest(collection=name, limit=k, uses_123_api=uses_123)
    r.near_vector.vector_bytes = np.asarray(vec, np.float32).tobytes()
    if metadata:
        r.metadata.uuid = True
        r.metadata.distance = True
    if certainty:
        r.metadata.certainty = True
    return r


def _registered(plane, name):
    assert plane.wait_registered(name, 5.0)
    plane.warm_collection(name)


# -- tests/test_dataplane.py's five -------------------------------------------

def test_fast_path_engages_and_counts(db, plane):
    _col, vecs = _fill(db)
    chan, rpc = _rpc(plane.port)
    r1 = rpc(_req("DP", vecs[3]), timeout=10)  # registers through the fallback
    _registered(plane, "DP")
    f0, b0 = plane.dp.stats()
    r2 = rpc(_req("DP", vecs[3]), timeout=10)
    f1, b1 = plane.dp.stats()
    assert f1 == f0 + 1 and b1 == b0
    assert [x.metadata.id for x in r2.results] == [x.metadata.id for x in r1.results]
    chan.close()


def test_feature_requests_fall_back(db, plane):
    """Anything past the plain shape takes the fallback and still answers:
    certainty metadata, the legacy API flag, filters."""
    _col, vecs = _fill(db)
    chan, rpc = _rpc(plane.port)
    rpc(_req("DP", vecs[0]), timeout=10)
    _registered(plane, "DP")
    f0, b0 = plane.dp.stats()
    r = rpc(_req("DP", vecs[5], certainty=True), timeout=10)
    assert r.results[0].metadata.certainty_present
    rpc(_req("DP", vecs[5], uses_123=False), timeout=10)
    req = _req("DP", vecs[5])
    req.filters.on.append("seq")
    req.filters.operator = pb.Filters.OPERATOR_GREATER_THAN_EQUAL
    req.filters.value_int = 100
    assert len(rpc(req, timeout=10).results) > 0
    f1, b1 = plane.dp.stats()
    assert f1 == f0
    assert b1 >= b0 + 2
    chan.close()


def test_big_dim_collections_stay_on_fallback(db, plane):
    """dim > DataPlane.max_dim never registers (the dp_wait buffer is sized
    max_batch * max_dim)."""
    dim = plane.dp.max_dim + 123
    col = db.create_collection(CollectionConfig(
        name="Big", properties=[Property(name="seq", data_type="int")]))
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((20, dim)).astype(np.float32)
    col.batch_put([{"properties": {"seq": i}, "vector": vecs[i]} for i in range(20)])
    chan, rpc = _rpc(plane.port)
    r1 = rpc(_req("Big", vecs[7]), timeout=15)
    r2 = rpc(_req("Big", vecs[7]), timeout=15)
    assert r1.results[0].metadata.id == r2.results[0].metadata.id
    assert plane.dp.stats()[0] == 0  # never fast
    chan.close()


def test_unknown_collection_not_found(db, plane):
    chan, rpc = _rpc(plane.port)
    with pytest.raises(grpc.RpcError) as e:
        rpc(_req("Nope", np.zeros(8, np.float32)), timeout=10)
    assert e.value.code() == grpc.StatusCode.NOT_FOUND
    chan.close()


def test_native_load_generator_round_trip(db, plane):
    _col, vecs = _fill(db, n=500)
    chan, rpc = _rpc(plane.port)
    rpc(_req("DP", vecs[0]), timeout=10)
    _registered(plane, "DP")
    head = pb.SearchRequest(collection="DP", limit=5, uses_123_api=True)
    head.metadata.uuid = True
    head.metadata.distance = True
    st = dpn.bench(plane.port, conns=2, streams=4, duration_ms=800, dim=8,
                   request_head=head.SerializeToString())
    assert st["errors"] == 0 and st["done"] > 50, st
    # every request of the round went through the C++ fast path
    assert plane.dp.stats()[0] >= st["done"]
    chan.close()


# -- two transports, one answer ---------------------------------------------------

def _plain(reply):
    """The reply's bytes with the timing field cleared."""
    out = type(reply)()
    out.CopyFrom(reply)
    if hasattr(out, "took"):
        out.took = 0.0
    return out.SerializeToString(deterministic=True)


def _objects(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        bo = pb.BatchObject(collection="DP", uuid=str(uuid_mod.UUID(int=900_000 + i)))
        bo.vector_bytes = rng.standard_normal(8).astype("<f4").tobytes()
        bo.properties.non_ref_properties.update({"seq": 1000 + i})
        out.append(bo)
    return out


def test_python_server_and_plane_answer_alike(tmp_path):
    """The same Search (fast path once registered and warm, and before),
    filtered Search, BatchObjects and BatchDelete requests through the
    port's Python GrpcServer and through its plane, over two Databases
    holding the same seeded data: the same replies."""
    dbs = [Database(str(tmp_path / w), device="cpu") for w in ("py", "plane")]
    servers = [GrpcServer(dbs[0]).start(),
               NativeDataPlane(dbs[1], GrpcServer(dbs[1])).start()]
    try:
        vecs = [_fill(d, seed=4)[1] for d in dbs][0]
        replies = []
        for srv in servers:
            chan, search = _rpc(srv.port)
            _c2, batch = _rpc(srv.port, "BatchObjects", pb.BatchObjectsRequest,
                              pb.BatchObjectsReply)
            _c3, delete = _rpc(srv.port, "BatchDelete", pb.BatchDeleteRequest,
                               pb.BatchDeleteReply)
            got = [search(_req("DP", vecs[i], k=7), timeout=10) for i in (3, 9)]
            if isinstance(srv, NativeDataPlane):
                _registered(srv, "DP")
                f0 = srv.dp.stats()[0]
            got += [search(_req("DP", vecs[i], k=7), timeout=10) for i in (3, 9, 40)]
            if isinstance(srv, NativeDataPlane):
                assert srv.dp.stats()[0] == f0 + 3  # served by the C++ fast path
            freq = _req("DP", vecs[11], k=6)
            freq.filters.operator = pb.Filters.OPERATOR_LESS_THAN
            freq.filters.target.property = "seq"
            freq.filters.value_int = 150
            got.append(search(freq, timeout=10))
            got.append(batch(pb.BatchObjectsRequest(objects=_objects(12, 5)), timeout=10))
            dreq = pb.BatchDeleteRequest(collection="DP", verbose=True)
            dreq.filters.operator = pb.Filters.OPERATOR_GREATER_THAN_EQUAL
            dreq.filters.target.property = "seq"
            dreq.filters.value_int = 1006
            got.append(delete(dreq, timeout=10))
            # after the writes: the new rows are found, the deleted are not
            got.append(search(_req("DP", vecs[3], k=320), timeout=10))
            replies.append([_plain(r) for r in got])
            for c in (chan, _c2, _c3):
                c.close()
        assert replies[1] == replies[0]
        assert len(pb.SearchReply.FromString(replies[0][-1]).results) == 306
    finally:
        for srv in servers:
            srv.stop()
        for d in dbs:
            d.close()


def test_fast_path_matches_the_jax_plane(tmp_path):
    """A fast-path Search through the JAX package's plane and through the
    port's, on the same seeded data: the same ids, distances within the
    reference's tolerance."""
    from weaviate_tpu.api.grpc import v1_pb2 as jpb
    from weaviate_tpu.api.grpc.native_plane import NativeDataPlane as JPlane
    from weaviate_tpu.api.grpc.server import GrpcServer as JGrpcServer
    from weaviate_tpu.db.database import Database as JDatabase
    from weaviate_tpu.native import dataplane as jdpn
    from weaviate_tpu.schema.config import CollectionConfig as JConfig
    from weaviate_tpu.schema.config import Property as JProperty

    if not jdpn.available():
        pytest.skip("the JAX package's plane did not build")
    jdb = JDatabase(str(tmp_path / "jax"))
    tdb = Database(str(tmp_path / "port"), device="cpu")
    rng = np.random.default_rng(6)
    vecs = rng.standard_normal((400, 16)).astype(np.float32)
    specs = [{"properties": {"seq": i}, "vector": vecs[i],
              "uuid": str(uuid_mod.UUID(int=i + 1))} for i in range(400)]
    jdb.create_collection(JConfig(name="DP", properties=[
        JProperty(name="seq", data_type="int")])).batch_put(specs)
    tdb.create_collection(CollectionConfig(name="DP", properties=[
        Property(name="seq", data_type="int")])).batch_put(specs)
    jp = JPlane(jdb, JGrpcServer(jdb)).start()
    tp = NativeDataPlane(tdb, GrpcServer(tdb)).start()
    queries = rng.standard_normal((12, 16)).astype(np.float32)
    try:
        answers = []
        for plane, mod in ((jp, jpb), (tp, pb)):
            chan = grpc.insecure_channel(f"127.0.0.1:{plane.port}")
            search = chan.unary_unary(
                "/weaviate.v1.Weaviate/Search",
                request_serializer=mod.SearchRequest.SerializeToString,
                response_deserializer=mod.SearchReply.FromString)

            def req(v, _mod=mod):
                r = _mod.SearchRequest(collection="DP", limit=10, uses_123_api=True)
                r.near_vector.vector_bytes = v.tobytes()
                r.metadata.uuid = True
                r.metadata.distance = True
                return r

            search(req(queries[0]), timeout=10)
            assert plane.wait_registered("DP", 5.0)
            plane.warm_collection("DP")
            f0 = plane.dp.stats()[0]
            out = [search(req(q), timeout=10) for q in queries]
            assert plane.dp.stats()[0] == f0 + len(queries)
            answers.append(([[r.metadata.id for r in o.results] for o in out],
                            np.array([[r.metadata.distance for r in o.results]
                                      for o in out], np.float32)))
            chan.close()
        assert answers[1][0] == answers[0][0]
        np.testing.assert_allclose(answers[1][1], answers[0][1], rtol=RTOL, atol=ATOL)
    finally:
        jp.stop()
        tp.stop()
        jdb.close()
        tdb.close()


def test_server_serves_the_plane_under_the_env(tmp_path, monkeypatch):
    """``WEAVIATE_TPU_NATIVE_DATAPLANE=1`` with no auth: the port's Server
    serves gRPC through the plane, whose fallback runs the Python server's
    handlers; with auth configured it keeps the Python server."""
    from weaviate_tpu_torch.config import ServerConfig
    from weaviate_tpu_torch.server import Server

    monkeypatch.setenv("WEAVIATE_TPU_NATIVE_DATAPLANE", "1")
    srv = Server(ServerConfig(data_path=str(tmp_path / "a"), rest_port=0, grpc_port=0,
                              disable_telemetry=True), device="cpu").start()
    try:
        assert isinstance(srv.grpc, NativeDataPlane)
        _col, vecs = _fill(srv.db)
        chan, rpc = _rpc(srv.grpc.port)
        assert len(rpc(_req("DP", vecs[1]), timeout=10).results) == 5
        chan.close()
    finally:
        srv.stop()
    monkeypatch.setenv("AUTHENTICATION_APIKEY_ENABLED", "true")
    monkeypatch.setenv("AUTHENTICATION_APIKEY_ALLOWED_KEYS", "k1")
    monkeypatch.setenv("AUTHENTICATION_APIKEY_USERS", "u1")
    srv = Server(ServerConfig(data_path=str(tmp_path / "b"), rest_port=0, grpc_port=0,
                              disable_telemetry=True), device="cpu").start()
    try:
        assert isinstance(srv.grpc, GrpcServer)
    finally:
        srv.stop()
