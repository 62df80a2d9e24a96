"""The ANN index types behind the port's Shard, Database and server
(``vectorIndexType`` "ivf", "dynamic" and "hnsw"), against the JAX package.

The same objects go into a JAX ``Database`` and a port
``Database(device="cpu")``; a client must see the same answers: uuids
equal on tie-free data and distances within rtol 2e-4 / atol 2e-3 (the
reference's own kernel tolerance), before and after a restart (both
replay the objects bucket into a fresh index), and after
``update_collection`` moves the live search knobs. IVF training inside
the code under test takes the JAX package's k-means through a
monkeypatched ``kmeans_fit`` (the seam is this test's only; each
package's k-means lands on other centroids). A class created over REST
with the reference's JSON (``vectorIndexType: "hnsw"``) answers a
GraphQL ``nearVector`` as the JAX server does.
"""

import json
import os
import re
import threading
import urllib.request

import jax
import numpy as np
import pytest

from weaviate_tpu.db.database import Database as JDatabase
from weaviate_tpu.filters.filters import Filter as JFilter
from weaviate_tpu.ops import kmeans as jkm
from weaviate_tpu.schema import config as jconf
from weaviate_tpu_torch.db.database import Database as TDatabase
from weaviate_tpu_torch.engine import ivf as tivf_mod
from weaviate_tpu_torch.engine.dynamic import DynamicIndex
from weaviate_tpu_torch.engine.hnsw import HNSWIndex
from weaviate_tpu_torch.engine.ivf import IVFIndex
from weaviate_tpu_torch.filters.filters import Filter as TFilter
from weaviate_tpu_torch.schema import config as tconf

RTOL, ATOL = 2e-4, 2e-3
DIM = 16
PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "weaviate_tpu_torch")


@pytest.fixture(autouse=True)
def jax_ivf_shim(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)
    monkeypatch.setattr(
        tivf_mod, "kmeans_fit",
        lambda vectors, k, iters=10, device=None, **kw:
        jkm.kmeans_fit(vectors, k, iters=iters, **kw))


def _config(conf, index_type, metric="l2-squared", **index_kw):
    return conf.CollectionConfig(
        name="Ann",
        properties=[conf.Property(name="n", data_type=conf.DataType.INT)],
        vectors=[conf.VectorConfig(name="", dim=DIM, index=conf.VectorIndexConfig(
            index_type=index_type, metric=metric, **index_kw))])


def _objects(rng, n, start=0):
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    return [{"uuid": f"00000000-0000-4000-8000-{start + i:012d}",
             "properties": {"n": start + i}, "vector": vecs[i]}
            for i in range(n)]


def _hits(col, q, k=10, where=None):
    res = col.near_vector(q, k=k, where=where)
    return [r.uuid for r in res], np.asarray([r.distance for r in res])


def _same_hits(tcol, jcol, queries, where=(None, None), k=10):
    for q in queries:
        tu, td = _hits(tcol, q, k, where[1])
        ju, jd = _hits(jcol, q, k, where[0])
        assert tu == ju
        np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)


def test_no_refusal_is_left_for_the_ann_types(tmp_path):
    """The three types build through ``Database(device="cpu")``, and no
    message in the port names ROADMAP Queue 1 items 4 or 5 any more."""
    db = TDatabase(str(tmp_path), device="cpu")
    try:
        for index_type, cls in (("ivf", IVFIndex), ("dynamic", DynamicIndex),
                                ("hnsw", HNSWIndex)):
            cfg = _config(tconf, index_type)
            cfg.name = f"Ann{index_type}"
            col = db.create_collection(cfg)
            col.batch_put(_objects(np.random.default_rng(0), 20))
            idx = next(iter(col.shards.values())).vector_indexes[""]
            assert isinstance(idx, cls)
            assert _hits(col, np.zeros(DIM, np.float32), k=3)[0]
    finally:
        db.close()
    pat = re.compile(r"item [45]\b")
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert not pat.search(text), os.path.join(root, f)


# index type, config, rows: ivf stays in its exact delta below 16,384 rows
# (the shard does not set a train threshold); "ivf-trained" crosses it
CASES = {
    "hnsw": ("hnsw", dict(max_connections=8, ef_construction=32, ef=48), 1200),
    "ivf": ("ivf", dict(), 1200),
    "ivf-trained": ("ivf", dict(ivf_nprobe=6), 16_500),
    "dynamic": ("dynamic", dict(flat_to_ann_threshold=800, ivf_nlist=16,
                                ivf_nprobe=4), 1200),
}


@pytest.mark.parametrize("case", list(CASES))
def test_collections_answer_as_jax_and_replay_on_restart(tmp_path, case):
    index_type, kw, n = CASES[case]
    rng = np.random.default_rng(7)
    objs = _objects(rng, n)
    queries = rng.standard_normal((5, DIM)).astype(np.float32)
    jdb = JDatabase(str(tmp_path / "j"))
    tdb = TDatabase(str(tmp_path / "t"), device="cpu")
    try:
        for db, conf in ((jdb, jconf), (tdb, tconf)):
            col = db.create_collection(_config(conf, index_type, **kw))
            for s in range(0, n, 400):
                col.batch_put(objs[s:s + 400])
        jcol, tcol = jdb.get_collection("Ann"), tdb.get_collection("Ann")
        tidx = next(iter(tcol.shards.values())).vector_indexes[""]
        jidx = next(iter(jcol.shards.values())).vector_indexes[""]
        if case == "dynamic":
            assert tidx.upgraded and jidx.upgraded
        if case == "ivf-trained":
            assert tidx.trained and jidx.trained
        where = (JFilter.where("n", "GreaterThanEqual", n // 2),
                 TFilter.where("n", "GreaterThanEqual", n // 2))
        _same_hits(tcol, jcol, queries)
        _same_hits(tcol, jcol, queries, where)
        for col in (jcol, tcol):
            col.delete_object(objs[3]["uuid"])
            col.put_object({"n": 4}, vector=objs[9]["vector"] + 0.01,
                           uuid=objs[4]["uuid"])
        _same_hits(tcol, jcol, [objs[3]["vector"], objs[9]["vector"]])
        assert objs[3]["uuid"] not in _hits(tcol, objs[3]["vector"])[0]
        jdb.cycles.run_now("epoch-maintenance")
        tdb.cycles.run_now("epoch-maintenance")
        _same_hits(tcol, jcol, queries)
    finally:
        jdb.close()
        tdb.close()
    # a restart replays the objects bucket into a fresh index
    jdb = JDatabase(str(tmp_path / "j"))
    tdb = TDatabase(str(tmp_path / "t"), device="cpu")
    try:
        jcol, tcol = jdb.get_collection("Ann"), tdb.get_collection("Ann")
        tidx = next(iter(tcol.shards.values())).vector_indexes[""]
        assert tidx.index_type == index_type and len(tidx) == n - 1
        if case == "dynamic":
            assert tidx.upgraded
        _same_hits(tcol, jcol, queries)
        _same_hits(tcol, jcol, queries, where)
    finally:
        jdb.close()
        tdb.close()


def test_update_collection_moves_the_live_knobs(tmp_path):
    """``ef`` (hnsw) and the upgrade threshold (dynamic) move on the live
    index. ``nprobe`` is set where the live index has the attribute, as
    in the JAX package: an IVF index keeps its probe count in its store,
    so neither package moves it before a restart (ROADMAP Queue 3)."""
    out = {}
    for name, db_cls, conf, kw in (("jax", JDatabase, jconf, {}),
                                   ("torch", TDatabase, tconf,
                                    {"device": "cpu"})):
        db = db_cls(str(tmp_path / name), **kw)
        try:
            got = {}
            for index_type, extra in (("hnsw", {}), ("ivf", {}),
                                      ("dynamic", {"flat_to_ann_threshold": 5000})):
                cfg = _config(conf, index_type, **extra)
                cfg.name = f"U{index_type}"
                col = db.create_collection(cfg)
                col.batch_put(_objects(np.random.default_rng(1), 30))
                new = _config(conf, index_type, **extra)
                new.name = cfg.name
                new.vectors[0].index.ef = 77
                new.vectors[0].index.ivf_nprobe = 5
                new.vectors[0].index.flat_to_ann_threshold = 25
                db.update_collection(new)
                idx = next(iter(col.shards.values())).vector_indexes[""]
                got[index_type] = (getattr(idx, "ef", None),
                                   getattr(getattr(idx, "store", None), "nprobe", None),
                                   getattr(idx, "threshold", None))
                if index_type == "dynamic":
                    col.batch_put(_objects(np.random.default_rng(2), 5, start=30))
                    got["upgraded"] = idx.upgraded
            out[name] = got
        finally:
            db.close()
    assert out["torch"] == out["jax"]
    assert out["torch"]["hnsw"][0] == 77
    assert out["torch"]["dynamic"][2] == 25 and out["torch"]["upgraded"]


def test_batcher_paths_per_index_type(tmp_path):
    """Filtered IVF queries coalesce (never solo: the IVF store has no
    gathered cutover); HNSW has no async twin and no pow2 padding; a
    dynamic collection's batcher serves the IVF impl after the upgrade
    swapped it under the live batcher."""
    db = TDatabase(str(tmp_path), device="cpu")
    try:
        rng = np.random.default_rng(3)
        cols = {}
        for index_type, kw in (("ivf", {}), ("hnsw", {"max_connections": 8}),
                               ("dynamic", {"flat_to_ann_threshold": 300})):
            cfg = _config(tconf, index_type, **kw)
            cfg.name = f"B{index_type}"
            cols[index_type] = db.create_collection(cfg)
            cols[index_type].batch_put(_objects(rng, 200))
        shard = next(iter(cols["ivf"].shards.values()))
        where = TFilter.where("n", "LessThan", 100)
        qs = rng.standard_normal((8, DIM)).astype(np.float32)
        res = [None] * len(qs)

        def run(r):
            res[r] = cols["ivf"].near_vector(qs[r], k=5, where=where)

        threads = [threading.Thread(target=run, args=(r,)) for r in range(len(qs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        b = shard._query_batcher("", shard.vector_indexes[""])
        assert b.filtered_batched == len(qs)
        assert all(r and all(h.object.properties["n"] < 100 for h in r) for r in res)
        hs = next(iter(cols["hnsw"].shards.values()))
        assert hs.vector_search_batch_async(qs, 5) is None
        ids, _d, counts = hs.vector_search_batch(qs, 5)
        assert (counts == 5).all()
        hb = hs._query_batcher("", hs.vector_indexes[""])
        assert hb.pad_pow2 is False
        assert cols["hnsw"].near_vector(qs[0], k=3)
        ds = next(iter(cols["dynamic"].shards.values()))
        dyn = ds.vector_indexes[""]
        assert not dyn.upgraded and cols["dynamic"].near_vector(qs[0], k=3)
        extra = _objects(rng, 200, start=200)
        cols["dynamic"].batch_put(extra)
        assert dyn.upgraded
        hit = cols["dynamic"].near_vector(extra[17]["vector"], k=1)
        assert hit[0].uuid == extra[17]["uuid"]
        h = ds.vector_search_batch_async(np.stack([extra[5]["vector"]]), 1)
        assert h is not None and h.result()[0][0][0] >= 0
        # the batcher's sync entry (its retry path) serves the new impl too
        b = ds._query_batcher("", dyn)
        q = np.stack([extra[17]["vector"]])
        got, _ = b._batch_fn(q, 1)
        want, _ = dyn.search_by_vector_batch(q, 1)
        assert got[0][0] == want[0][0] >= 200
    finally:
        db.close()


def _request(addr, method, path, body=None):
    r = urllib.request.Request(
        f"http://{addr}/v1{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=60) as resp:
        return resp.status, json.loads(resp.read() or b"null")


def test_rest_hnsw_class_answers_graphql_near_vector(tmp_path):
    """The reference's class JSON with ``vectorIndexType: "hnsw"`` over
    REST, objects over REST, then GraphQL nearVector: the port's server
    answers as the JAX server does."""
    from weaviate_tpu.config import ServerConfig as JConfig
    from weaviate_tpu.server import Server as JServer
    from weaviate_tpu_torch.config import ServerConfig as TConfig
    from weaviate_tpu_torch.server import Server as TServer

    schema = {"class": "Doc", "vectorizer": "none", "vectorIndexType": "hnsw",
              "vectorIndexConfig": {"distance": "l2-squared",
                                    "maxConnections": 32, "efConstruction": 128},
              "properties": [{"name": "n", "dataType": ["int"]}]}
    rng = np.random.default_rng(5)
    objs = [{"class": "Doc", "id": o["uuid"], "properties": o["properties"],
             "vector": o["vector"].tolist()} for o in _objects(rng, 300)]
    queries = rng.standard_normal((4, DIM)).astype(np.float32)

    def cfg(cls, path):
        return cls(data_path=str(path), rest_port=0, grpc_port=0,
                   disable_telemetry=True)

    jsrv = JServer(cfg(JConfig, tmp_path / "j")).start()
    tsrv = TServer(cfg(TConfig, tmp_path / "t"), device="cpu").start()
    try:
        answers = []
        for srv in (jsrv, tsrv):
            assert _request(srv.rest.address, "POST", "/schema", schema)[0] == 200
            status, out = _request(srv.rest.address, "POST", "/batch/objects",
                                   {"objects": objs})
            assert status == 200 and all(
                o["result"]["status"] == "SUCCESS" for o in out)
            got = []
            for q in queries:
                body = {"query": "{ Get { Doc(nearVector: {vector: %s}, limit: 5)"
                                 " { n _additional { id distance } } } }"
                                 % json.dumps(q.tolist())}
                status, out = _request(srv.rest.address, "POST", "/graphql", body)
                assert status == 200 and "errors" not in out, out
                rows = out["data"]["Get"]["Doc"]
                got.append(([r["_additional"]["id"] for r in rows],
                            [r["_additional"]["distance"] for r in rows]))
            answers.append(got)
        idx = next(iter(tsrv.db.get_collection("Doc").shards.values())).vector_indexes[""]
        assert isinstance(idx, HNSWIndex) and idx.m == 32 and idx.ef_construction == 128
        for (ju, jd), (tu, td) in zip(*answers):
            assert tu == ju and len(tu) == 5
            np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
    finally:
        tsrv.stop()
        jsrv.stop()
