"""The port's Database / Collection / Shard / Server row-sharded over a
mesh, held to the JAX package's on its 8 virtual CPU devices and to a
one-buffer port database on the same objects.

The port's mesh repeats the CPU: eight row shards, each with its own
tensors and its own scan, merged in one step (1-D) or two levels (the
2 x 4 ``('host', 'ici')`` mesh). Ids must be equal, distances and fused
scores within rtol 2e-4 / atol 2e-3. Ported from
tests/test_filtered_batch.py::test_sharded_store_batched_mask and
tests/test_epochs.py's mesh case, plus the database, snapshot and server
layers above the stores.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.db import Database as JDatabase
from weaviate_tpu.filters import Filter as JFilter
from weaviate_tpu.parallel import mesh as jmesh
from weaviate_tpu.schema import config as jschema
from weaviate_tpu_torch import convert
from weaviate_tpu_torch.db import Database as TDatabase
from weaviate_tpu_torch.filters import Filter as TFilter
from weaviate_tpu_torch.parallel import mesh as tmesh
from weaviate_tpu_torch.schema import config as tschema

RTOL, ATOL = 2e-4, 2e-3
DIM = 16
CPU8 = [torch.device("cpu")] * 8

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def jax_ivf_shim(monkeypatch):
    # the JAX IVF module calls jax.core.trace_state_clean (gone in jax 0.9)
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _hier():
    return tmesh.make_hierarchical_mesh(n_hosts=2, devices=CPU8)


def masked_ref(q, corpus, allow, k):
    d = ((corpus - q[None]) ** 2).sum(-1)
    idx = np.flatnonzero(allow)
    order = idx[np.argsort(d[idx], kind="stable")][:k]
    return order, d[order]


def test_sharded_store_batched_mask(rng):
    """Per-query masks shard column-wise, row-aligned with the corpus;
    each shard packs its slice; the merge is unchanged."""
    from weaviate_tpu_torch.engine.store import DeviceVectorStore

    b, n, d, k = 4, 600, 16, 5
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    for mesh in (tmesh.make_mesh(devices=CPU8), _hier()):
        st = DeviceVectorStore(dim=d, capacity=1024, chunk_size=64, mesh=mesh,
                               selection="fused")
        st.add(corpus)
        allow = rng.random((b, n)) < 0.25
        allow[0, :] = False
        full = np.zeros((b, st.capacity), dtype=bool)
        full[:, :n] = allow
        dists, slots = st.search(q, k, allow_mask=full)
        for r in range(b):
            ri, rd = masked_ref(q[r], corpus, allow[r], k)
            live = slots[r] >= 0
            assert live.sum() == len(ri), r
            assert np.array_equal(slots[r][live], ri), r
            np.testing.assert_allclose(dists[r][live], rd, rtol=RTOL, atol=ATOL)


def _config(schema, index="flat", **index_kw):
    return schema.CollectionConfig(
        name="Doc",
        properties=[schema.Property(name="body", data_type="text"),
                    schema.Property(name="n", data_type="int")],
        vectors=[schema.VectorConfig(index=schema.VectorIndexConfig(
            index_type=index, **index_kw))])


def _objects(rng, n=96):
    """Doc-unique ``alpha`` frequencies and lengths: BM25 (and fused
    hybrid) scores stay gapped, no ties."""
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    objs = []
    for i in range(n):
        words = ["alpha"] * (i + 1) + ["pad"] * (1 + (7 * i) % 17)
        if i % 3:
            words += ["bravo"] * (i % 11 + 1)
        objs.append({"uuid": f"00000000-0000-4000-8000-{i:012d}",
                     "properties": {"body": " ".join(words), "n": i},
                     "vector": vecs[i]})
    return objs


def _same(a, b, score=False):
    assert [r.uuid for r in a] == [r.uuid for r in b]
    key = (lambda r: r.score) if score else (lambda r: r.distance)
    np.testing.assert_allclose([key(r) for r in a], [key(r) for r in b],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("index_kw", [
    {}, {"quantization": "bq"}, {"epoch_rows": 40}],
    ids=["flat", "bq", "epochs"])
def test_mesh_database_parity(tmp_path, index_kw):
    """A collection on the 2 x 4 mesh: put, delete, nearVector with and
    without a filter, one hybrid query — equal to the JAX database on its
    2 x 4 mesh and to a one-buffer port database."""
    rng = np.random.default_rng(5)
    objs = _objects(rng)
    queries = rng.standard_normal((4, DIM)).astype(np.float32)
    jdb = JDatabase(str(tmp_path / "j"),
                    mesh=jmesh.make_hierarchical_mesh(n_hosts=2))
    tdb = TDatabase(str(tmp_path / "t"), mesh=_hier())
    odb = TDatabase(str(tmp_path / "o"), device="cpu")
    try:
        cols = [db.create_collection(_config(schema, **index_kw))
                for db, schema in ((jdb, jschema), (tdb, tschema),
                                   (odb, tschema))]
        for col in cols:
            col.batch_put(objs)
            for i in (4, 50, 93):
                col.delete_object(objs[i]["uuid"])
        jc, tc, oc = cols
        shard = next(iter(tc.shards.values()))
        store = shard.vector_indexes[""].store
        assert shard.mesh is tdb.mesh and store.mesh is tdb.mesh
        assert (store.epochs[0].store if index_kw.get("epoch_rows")
                else store).n_shards == 8
        jw = JFilter.where("n", "GreaterThanEqual", 30)
        tw = TFilter.where("n", "GreaterThanEqual", 30)
        for q in queries:
            want = jc.near_vector(q, k=8, include_objects=False)
            got = tc.near_vector(q, k=8, include_objects=False)
            _same(got, want)
            _same(got, oc.near_vector(q, k=8, include_objects=False))
            got = tc.near_vector(q, k=8, where=tw, include_objects=False)
            _same(got, jc.near_vector(q, k=8, where=jw, include_objects=False))
            assert all(int(r.uuid[-12:]) >= 30 for r in got)
        args = dict(vector=queries[0], alpha=0.5, k=10)
        _same(tc.hybrid("alpha bravo", **args),
              jc.hybrid("alpha bravo", **args), score=True)
        from weaviate_tpu_torch.runtime.hbm_ledger import ledger

        roll = ledger.host_rollup(tmesh.host_count(tdb.mesh))
        assert sorted(roll) == ["host-0", "host-1"]
        assert sum(roll.values()) == ledger.total_bytes()
    finally:
        for db in (jdb, tdb, odb):
            db.close()


@pytest.mark.parametrize("kind", ["flat", "bq", "epochs"])
def test_jax_snapshot_restored_on_mesh(rng, kind):
    """A JAX mesh index's snapshot lands row-sharded in the port through
    ``convert.flat_from_jax_snapshot(..., mesh=)`` and answers as the JAX
    index does."""
    from weaviate_tpu.engine.flat import FlatIndex as JFlat

    kw = {"flat": {}, "bq": dict(quantization="bq", rescore="device"),
          "epochs": dict(epoch_rows=48)}[kind]
    j = JFlat(dim=DIM, capacity=64, chunk_size=16,
              mesh=jmesh.make_hierarchical_mesh(n_hosts=2), **kw)
    vecs = rng.standard_normal((150, DIM)).astype(np.float32)
    j.add_batch(np.arange(150) + 7, vecs)
    j.delete(9, 60)
    mesh = _hier()
    t = convert.flat_from_jax_snapshot(j.snapshot(), mesh=mesh)
    assert t.store.mesh is mesh
    q = rng.standard_normal((5, DIM)).astype(np.float32)
    (tid, td), (jid, jd) = (t.search_by_vector_batch(q, 6),
                            j.search_by_vector_batch(q, 6))
    np.testing.assert_array_equal(np.asarray(tid), np.asarray(jid))
    np.testing.assert_allclose(np.asarray(td), np.asarray(jd),
                               rtol=RTOL, atol=ATOL)


def _request(addr, method, path, body=None):
    r = urllib.request.Request(
        f"http://{addr}/v1{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=60) as resp:
        return resp.status, json.loads(resp.read() or b"null")


def test_server_over_a_mesh_database(tmp_path, monkeypatch):
    """``Server(db=...)`` serves a 2 x 4 mesh database under
    WEAVIATE_TPU_VIRTUAL_HOSTS=2: GraphQL nearVector answers equal the
    in-process ones, and the per-host memory rollup sums to the total."""
    from weaviate_tpu_torch.config import ServerConfig
    from weaviate_tpu_torch.server import Server

    monkeypatch.setenv(tmesh.VIRTUAL_HOSTS_ENV, "2")
    rng = np.random.default_rng(8)
    objs = _objects(rng, 64)
    db = TDatabase(str(tmp_path / "db"), mesh=_hier())
    col = db.create_collection(_config(tschema))
    col.batch_put(objs)
    srv = Server(ServerConfig(data_path=str(tmp_path / "db"), rest_port=0,
                              grpc_port=0, disable_telemetry=True),
                 device="cpu", db=db).assemble()
    try:
        gql = ("query Q($v: [Float]) { Get { Doc(limit: 7, nearVector: "
               "{vector: $v}) { n _additional { id distance } } } }")
        for v in rng.standard_normal((3, DIM)).astype(np.float32):
            status, out = _request(srv.rest.address, "POST", "/graphql",
                                   {"query": gql, "variables": {"v": v.tolist()}})
            assert status == 200 and "errors" not in out, out
            rows = out["data"]["Get"]["Doc"]
            want = col.near_vector(v, k=7, include_objects=False)
            assert [r["_additional"]["id"] for r in rows] == [r.uuid for r in want]
            np.testing.assert_allclose([r["_additional"]["distance"] for r in rows],
                                       [r.distance for r in want], rtol=1e-6)
        status, mem = _request(srv.rest.address, "GET", "/debug/memory")
        assert status == 200
        hosts = mem["ledger"]["hbmHostBytes"]
        assert sorted(hosts) == ["host-0", "host-1"]
        assert sum(hosts.values()) == mem["ledger"]["totalBytes"]
    finally:
        srv.stop()
        db.close()
