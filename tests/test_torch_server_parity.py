"""The port's server against the JAX package's server, over real sockets.

The same seeded numpy data goes into a JAX ``Server`` and a port
``Server`` (``device="cpu"``), both through REST; the same GraphQL and
gRPC request bodies then go to both. On tie-free data the ids are equal,
distances agree within rtol 2e-4 / atol 2e-3 (the reference's own kernel
tolerance, tests/test_pallas_kernels.py:32), BM25 scores are bit-equal
and ``Aggregate`` answers are equal. Also here: a data directory the JAX
server wrote, served by the port's server; the modes the port refuses
(no device on a CPU-only machine, multi-device, cluster) and the debug
routes whose planes are not ported, each naming its ROADMAP item.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import grpc
import numpy as np
import pytest
import torch

from weaviate_tpu.api.grpc import v1_pb2 as jpb
from weaviate_tpu.config import ServerConfig as JConfig
from weaviate_tpu.server import Server as JServer
from weaviate_tpu_torch.api.grpc import v1_pb2 as tpb
from weaviate_tpu_torch.config import ServerConfig as TConfig
from weaviate_tpu_torch.server import Server as TServer

RTOL, ATOL = 2e-4, 2e-3
DIM = 16
N = 240
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _objects(rng):
    """Doc i has a doc-unique ``alpha`` frequency and length, so BM25
    scores (and the fused hybrid scores) are gapped: no ties."""
    vecs = rng.standard_normal((N, DIM)).astype(np.float32)
    out = []
    for i in range(N):
        words = ["alpha"] * (i % 40 + 1)
        if i % 3:
            words += ["bravo"] * (i % 7 + 1)
        words += ["pad"] * (1 + (7 * i) % 17) + [f"w{i}"]
        out.append({"class": "Doc",
                    "id": f"00000000-0000-4000-8000-{i:012d}",
                    "properties": {"body": " ".join(words), "n": i,
                                   "tag": f"t{i % 5}"},
                    "vector": vecs[i].tolist()})
    return out


def _schema(metric):
    return {"class": "Doc", "vectorizer": "none",
            "vectorIndexType": "flat",
            "vectorIndexConfig": {"distance": metric},
            "properties": [{"name": "body", "dataType": ["text"]},
                           {"name": "n", "dataType": ["int"]},
                           {"name": "tag", "dataType": ["text"]}]}


def _request(addr, method, path, body=None):
    r = urllib.request.Request(
        f"http://{addr}/v1{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _config(cls, path):
    return cls(data_path=str(path), rest_port=0, grpc_port=0,
               disable_telemetry=True)


def _search(port, pb, req):
    with grpc.insecure_channel(f"127.0.0.1:{port}") as chan:
        call = chan.unary_unary(
            "/weaviate.v1.Weaviate/Search",
            request_serializer=pb.SearchRequest.SerializeToString,
            response_deserializer=pb.SearchReply.FromString)
        return call(req)


@pytest.fixture(scope="module", params=["l2-squared", "dot", "cosine"])
def servers(request, tmp_path_factory):
    metric = request.param
    root = tmp_path_factory.mktemp(f"parity-{metric}")
    jsrv = JServer(_config(JConfig, root / "j")).start()
    tsrv = TServer(_config(TConfig, root / "t"), device="cpu").start()
    try:
        rng = np.random.default_rng(41)
        objs = _objects(rng)
        for srv in (jsrv, tsrv):
            assert _request(srv.rest.address, "POST", "/schema",
                            _schema(metric))[0] == 200
            status, out = _request(srv.rest.address, "POST",
                                   "/batch/objects", {"objects": objs})
            assert status == 200
            assert all(o["result"]["status"] == "SUCCESS" for o in out)
        queries = rng.standard_normal((6, DIM)).astype(np.float32)
        yield metric, jsrv, tsrv, queries
    finally:
        tsrv.stop()
        jsrv.stop()


WHERE = '{path: ["n"], operator: GreaterThanEqual, valueInt: 100}'


def _gql(srv, query, variables=None):
    status, out = _request(srv.rest.address, "POST", "/graphql",
                           {"query": query, "variables": variables or {}})
    assert status == 200 and "errors" not in out, out
    return out["data"]


def _hits(data, key):
    rows = data["Get"]["Doc"]
    return ([r["_additional"]["id"] for r in rows],
            [r["_additional"][key] for r in rows])


@pytest.mark.parametrize("where", [None, WHERE], ids=["plain", "where"])
def test_graphql_near_vector(servers, where):
    _metric, jsrv, tsrv, queries = servers
    filt = f", where: {where}" if where else ""
    q = ("query Q($v: [Float]) { Get { Doc(limit: 10, nearVector: "
         f"{{vector: $v}}{filt}) {{ n _additional {{ id distance }} }} }} }}")
    for v in queries:
        jid, jd = _hits(_gql(jsrv, q, {"v": v.tolist()}), "distance")
        tid, td = _hits(_gql(tsrv, q, {"v": v.tolist()}), "distance")
        assert tid == jid and len(tid) == 10
        np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
        if where:
            assert all(int(u[-12:]) >= 100 for u in tid)


@pytest.mark.parametrize("where", [None, WHERE], ids=["plain", "where"])
def test_graphql_bm25_scores_bit_equal(servers, where):
    _metric, jsrv, tsrv, _queries = servers
    filt = f", where: {where}" if where else ""
    q = ('{ Get { Doc(limit: 15, bm25: {query: "alpha bravo"}'
         f"{filt}) {{ n _additional {{ id score }} }} }} }}")
    jid, js = _hits(_gql(jsrv, q), "score")
    tid, ts = _hits(_gql(tsrv, q), "score")
    assert tid == jid and len(tid) == 15
    assert ts == js  # BM25F is bit-exact in both packages


@pytest.mark.parametrize("fusion", ["relativeScoreFusion", "rankedFusion"])
def test_graphql_hybrid(servers, fusion):
    _metric, jsrv, tsrv, queries = servers
    q = ("query Q($v: [Float]) { Get { Doc(limit: 10, hybrid: {query: "
         f'"alpha bravo", alpha: 0.5, vector: $v, fusionType: {fusion}}})'
         " { n _additional { id score } } } }")
    for v in queries[:3]:
        jid, js = _hits(_gql(jsrv, q, {"v": v.tolist()}), "score")
        tid, ts = _hits(_gql(tsrv, q, {"v": v.tolist()}), "score")
        assert tid == jid and len(tid) == 10
        np.testing.assert_allclose(np.asarray(ts, float),
                                   np.asarray(js, float),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("where", [None, WHERE], ids=["plain", "where"])
def test_graphql_aggregate_equal(servers, where):
    _metric, jsrv, tsrv, _queries = servers
    filt = f"(where: {where})" if where else ""
    q = (f"{{ Aggregate {{ Doc{filt} {{ meta {{ count }} "
         "n { count mean maximum minimum sum median mode } "
         "tag { count topOccurrences { value occurs } } } } }")
    assert _gql(tsrv, q) == _gql(jsrv, q)
    grouped = ('{ Aggregate { Doc(groupBy: ["tag"]) { groupedBy { value } '
               "meta { count } n { sum } } } }")
    assert _gql(tsrv, grouped) == _gql(jsrv, grouped)


def _grpc_request(pb, vec=None, where=False, bm25=None):
    req = pb.SearchRequest(collection="Doc", limit=10)
    if vec is not None:
        req.near_vector.vector_bytes = vec.tobytes()
    if bm25 is not None:
        req.bm25_search.query = bm25
    if where:
        req.filters.operator = pb.Filters.OPERATOR_GREATER_THAN_EQUAL
        req.filters.target.property = "n"
        req.filters.value_int = 100
    req.metadata.uuid = True
    req.metadata.distance = True
    req.metadata.score = True
    return req


@pytest.mark.parametrize("where", [False, True], ids=["plain", "where"])
def test_grpc_search(servers, where):
    _metric, jsrv, tsrv, queries = servers
    for v in queries:
        jr = _search(jsrv.grpc.port, jpb, _grpc_request(jpb, v, where))
        tr = _search(tsrv.grpc.port, tpb, _grpc_request(tpb, v, where))
        assert [r.metadata.id for r in tr.results] == \
            [r.metadata.id for r in jr.results]
        assert len(tr.results) == 10
        np.testing.assert_allclose(
            [r.metadata.distance for r in tr.results],
            [r.metadata.distance for r in jr.results], rtol=RTOL, atol=ATOL)
    jr = _search(jsrv.grpc.port, jpb,
                 _grpc_request(jpb, where=where, bm25="alpha bravo"))
    tr = _search(tsrv.grpc.port, tpb,
                 _grpc_request(tpb, where=where, bm25="alpha bravo"))
    assert [(r.metadata.id, r.metadata.score) for r in tr.results] == \
        [(r.metadata.id, r.metadata.score) for r in jr.results]


def test_port_serves_a_jax_data_directory(tmp_path):
    """Schema, objects and vectors written by the JAX server open in the
    port's server, which answers the same queries."""
    rng = np.random.default_rng(43)
    objs = _objects(rng)
    queries = rng.standard_normal((4, DIM)).astype(np.float32)
    q = ("query Q($v: [Float]) { Get { Doc(limit: 8, nearVector: "
         f"{{vector: $v}}, where: {WHERE}) {{ n _additional {{ id distance }}"
         " } } }")
    agg = "{ Aggregate { Doc { meta { count } n { sum mean } } } }"
    jsrv = JServer(_config(JConfig, tmp_path)).start()
    try:
        addr = jsrv.rest.address
        assert _request(addr, "POST", "/schema", _schema("cosine"))[0] == 200
        assert _request(addr, "POST", "/batch/objects",
                        {"objects": objs})[0] == 200
        assert _request(addr, "DELETE",
                        f"/objects/Doc/{objs[150]['id']}")[0] == 204
        want = [_hits(_gql(jsrv, q, {"v": v.tolist()}), "distance")
                for v in queries]
        want_agg = _gql(jsrv, agg)
        want_obj = _request(addr, "GET", f"/objects/Doc/{objs[7]['id']}"
                            "?include=vector")[1]
    finally:
        jsrv.stop()
    tsrv = TServer(_config(TConfig, tmp_path), device="cpu").start()
    try:
        assert _gql(tsrv, agg) == want_agg
        for v, (jid, jd) in zip(queries, want):
            tid, td = _hits(_gql(tsrv, q, {"v": v.tolist()}), "distance")
            assert tid == jid
            np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
        got = _request(tsrv.rest.address, "GET",
                       f"/objects/Doc/{objs[7]['id']}?include=vector")[1]
        assert got["properties"] == want_obj["properties"]
        assert got["vector"] == want_obj["vector"]
        assert _request(tsrv.rest.address, "GET",
                        f"/objects/Doc/{objs[150]['id']}")[0] == 404
    finally:
        tsrv.stop()


# -- what the port refuses ------------------------------------------------


def test_server_without_device_raises_on_cpu_only_box(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        TServer(_config(TConfig, tmp_path / "d"))
    assert not (tmp_path / "d").exists()


def test_module_entry_point_raises_on_cpu_only_box(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    env = dict(os.environ, PERSISTENCE_DATA_PATH=str(tmp_path / "d"),
               PORT="0", GRPC_PORT="0", DISABLE_TELEMETRY="true")
    out = subprocess.run([sys.executable, "-m", "weaviate_tpu_torch"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not (tmp_path / "d").exists()


@pytest.mark.parametrize("mode", ["coordinator", "virtual_hosts"])
def test_unported_modes_raise(tmp_path, monkeypatch, mode):
    """The JAX server's mesh modes are ported. With
    WEAVIATE_TPU_VIRTUAL_HOSTS=2 the server starts and serves; on one
    device it keeps one buffer (``default_mesh()`` is None, as the JAX
    server on one chip) and the memory rollup splits over the two hosts.
    A ``DCN_COORDINATOR_ADDRESS`` nobody listens on fails the join with
    an error naming the address, before any listener starts (in a child
    process: a joined process group outlives the call)."""
    if mode == "coordinator":
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
        s.close()
        code = (
            "import weaviate_tpu_torch.parallel.mesh as m\n"
            "from weaviate_tpu_torch.config import ServerConfig\n"
            "from weaviate_tpu_torch.server import Server\n"
            "m.JOIN_TIMEOUT_S = 2\n"
            f"srv = Server(ServerConfig(data_path={str(tmp_path)!r}, "
            "rest_port=0, grpc_port=0, disable_telemetry=True), device='cpu')\n"
            "try:\n"
            "    srv.start()\n"
            "finally:\n"
            "    print('rest', srv.rest, flush=True)\n")
        env = dict(os.environ, DCN_COORDINATOR_ADDRESS=addr,
                   DCN_NUM_PROCESSES="2", DCN_PROCESS_ID="1")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert f"{addr}: could not join the process group" in out.stderr
        assert "rest None" in out.stdout
        return
    monkeypatch.setenv("WEAVIATE_TPU_VIRTUAL_HOSTS", "2")
    srv = TServer(TConfig.from_env(env={
        "PERSISTENCE_DATA_PATH": str(tmp_path), "PORT": "0",
        "GRPC_PORT": "0", "DISABLE_TELEMETRY": "true",
        "WEAVIATE_TPU_VIRTUAL_HOSTS": "2"}), device="cpu").start()
    try:
        assert srv.db.mesh is None
        addr = srv.rest.address
        assert _request(addr, "POST", "/schema", _schema("l2-squared"))[0] == 200
        objs = _objects(np.random.default_rng(2))[:20]
        assert _request(addr, "POST", "/batch/objects",
                        {"objects": objs})[0] == 200
        status, nodes = _request(addr, "GET", "/nodes")
        assert status == 200
        stats = nodes["nodes"][0]["stats"]
        assert sorted(stats["hbmHostBytes"]) == ["host-0", "host-1"]
        assert sum(stats["hbmHostBytes"].values()) == stats["hbmLedgerBytes"]
        status, got = _request(addr, "GET", f"/objects/Doc/{objs[3]['id']}")
        assert status == 200 and got["properties"]["n"] == 3
    finally:
        srv.stop()


def test_profiler_port_and_native_plane_degrade_as_the_jax_server(
        tmp_path, monkeypatch, caplog):
    import logging

    monkeypatch.setenv("WEAVIATE_TPU_NATIVE_DATAPLANE", "1")
    cfg = _config(TConfig, tmp_path)
    cfg.profiling_port = 6060
    with caplog.at_level(logging.INFO, "weaviate_tpu_torch.server"):
        srv = TServer(cfg, device="cpu").start()
    try:
        assert srv._start_profiler(6060) is False
        # the native plane serves where its library builds (the JAX
        # server's rule); without libnghttp2.so.14 the Python gRPC server
        from weaviate_tpu_torch import dataplane

        if dataplane.available():
            assert type(srv.grpc).__name__ == "NativeDataPlane"
            assert "native gRPC data plane enabled" in caplog.text
        else:
            assert type(srv.grpc).__name__ == "GrpcServer"
        assert ("kernel captures are served at /v1/debug/profile"
                in caplog.text)
    finally:
        srv.stop()


@pytest.mark.parametrize("route,item", [
    ("/debug/replication", "item 7"),
    ("/debug/profile", "item 8"),
    ("/debug/profile?ms=10", "item 8"),
    ("/debug/profile?id=x", "item 8"),
    ("/debug/kernelscope", "item 8"),
    ("/debug/drift", "item 8"),
])
def test_unported_debug_routes_answer_500(tmp_path, route, item):
    """The routes of the planes that ROADMAP Queue 1 items 7 and 8 listed
    are ported: replication answers with the JAX package's keys, the
    device-time routes (kernelscope, profile, drift) with the port's
    snapshots, and an unknown capture id is a 404."""
    srv = TServer(_config(TConfig, tmp_path), device="cpu").start()
    try:
        status, out = _request(srv.rest.address, "GET", route)
        if item == "item 7":
            from weaviate_tpu.api.rest import RestServer as JRest
            from weaviate_tpu.db.database import Database as JDatabase

            jdb = JDatabase(str(tmp_path / "jax"))
            try:
                want = JRest(jdb)._debug_replication()
            finally:
                jdb.close()
            assert status == 200
            assert set(out) == set(want) == {"shards", "totals", "staged"}
            assert set(out["totals"]) == set(want["totals"])
            assert out["staged"] == want["staged"] == {}
        elif route.endswith("?id=x"):
            assert status == 404
        else:
            assert status == 200
            if route == "/debug/kernelscope":
                assert {"variants", "memcpy", "meters",
                        "total_device_seconds"} <= set(out)
            elif route == "/debug/drift":
                assert out["enabled"] in (True, False) and "gateOk" in out
            elif route == "/debug/profile?ms=10":
                assert out["ms"] == 10 and "kernels" in out
            else:
                assert "captures" in out
        # the ported debug planes still answer
        for ok in ("/debug/traces", "/debug/memory", "/debug/slo",
                   "/debug/flight", "/debug/perf"):
            assert _request(srv.rest.address, "GET", ok)[0] == 200, ok
    finally:
        srv.stop()


def test_server_serves_an_open_database(tmp_path):
    """``Server(db=...)`` serves a Database the process already holds:
    socket answers equal the in-process ones, and stopping the server
    leaves the database open."""
    from weaviate_tpu_torch.db import Database as TDatabase
    from weaviate_tpu_torch.schema import config as tschema

    db = TDatabase(str(tmp_path), device="cpu")
    try:
        col = db.create_collection(tschema.CollectionConfig(
            name="Doc", properties=[tschema.Property(name="n", data_type="int")],
            vectors=[tschema.VectorConfig(index=tschema.VectorIndexConfig(
                index_type="flat", metric="cosine"))]))
        rng = np.random.default_rng(47)
        vecs = rng.standard_normal((200, DIM)).astype(np.float32)
        col.batch_put([{"uuid": f"00000000-0000-4000-8000-{i:012d}",
                        "properties": {"n": i}, "vector": vecs[i]}
                       for i in range(200)])
        srv = TServer(_config(TConfig, tmp_path / "unused"), device="cpu",
                      db=db).start()
        try:
            assert srv.db is db and srv.grpc is not None
            q = ("query Q($v: [Float]) { Get { Doc(limit: 7, nearVector: "
                 "{vector: $v}) { _additional { id distance } } } }")
            for v in rng.standard_normal((3, DIM)).astype(np.float32):
                want = col.near_vector(v, k=7)
                tid, td = _hits(_gql(srv, q, {"v": v.tolist()}), "distance")
                assert tid == [r.uuid for r in want]
                assert td == [r.distance for r in want]
        finally:
            srv.stop()
        assert not (tmp_path / "unused").exists()
        assert col.object_count() == 200  # still open
    finally:
        db.close()


def test_server_with_async_indexing_is_read_your_writes(tmp_path,
                                                        monkeypatch):
    """ASYNC_INDEXING=true: imports are queued and drained by a worker;
    a query right after the import already sees every object, and the
    answers equal the JAX server's, which runs the same queue."""
    monkeypatch.setenv("ASYNC_INDEXING", "true")
    rng = np.random.default_rng(53)
    objs = _objects(rng)
    queries = rng.standard_normal((4, DIM)).astype(np.float32)
    q = ("query Q($v: [Float]) { Get { Doc(limit: 10, nearVector: "
         "{vector: $v}) { _additional { id distance } } } }")
    jcfg, tcfg = _config(JConfig, tmp_path / "j"), _config(TConfig, tmp_path / "t")
    jcfg.async_indexing = tcfg.async_indexing = True
    jsrv = JServer(jcfg).start()
    tsrv = TServer(tcfg, device="cpu").start()
    try:
        for srv in (jsrv, tsrv):
            assert _request(srv.rest.address, "POST", "/schema",
                            _schema("cosine"))[0] == 200
            assert _request(srv.rest.address, "POST", "/batch/objects",
                            {"objects": objs})[0] == 200
        shard = next(iter(tsrv.db.get_collection("Doc").shards.values()))
        assert shard.async_indexing and "" in shard._index_queues
        for v in queries:
            jid, jd = _hits(_gql(jsrv, q, {"v": v.tolist()}), "distance")
            tid, td = _hits(_gql(tsrv, q, {"v": v.tolist()}), "distance")
            assert tid == jid and len(tid) == 10
            np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
        assert shard._index_queues[""].wait_idle(timeout=30.0)
    finally:
        tsrv.stop()
        jsrv.stop()
