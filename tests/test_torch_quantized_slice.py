"""The port's quantized flat slice against the JAX package:
``QuantizedVectorStore`` (BQ and 4-bit PQ, every rescore mode, the sign
prefix, filters, deletes, compaction, snapshots), ``FlatIndex.compress``,
and ``Database``/``Collection`` with quantization from the schema or
switched on by ``update_collection``.

Both packages take the scan-reduce path (``store.use_pallas = True``):
the JAX package runs its Pallas kernels in interpret mode, the port its
plain versions. A PQ store's codebook is carried from the JAX store into
the port by ``convert.quantized_store_from_jax_snapshot``, because each
package's own ``pq_fit`` may land on another codebook (its Lloyd sums run
in another order). Tolerances: uuids / ids tie-aware on tie-free data,
distances rtol 2e-4 / atol 2e-3 (the reference's kernel tolerance); the
host rescore is the same numpy code in both, so those distances are
equal.
"""

import copy
import threading

import numpy as np
import pytest

from weaviate_tpu.db import Database as JDatabase
from weaviate_tpu.engine.flat import FlatIndex as JFlatIndex
from weaviate_tpu.engine.quantized import QuantizedVectorStore as JStore
from weaviate_tpu.filters import Filter as JFilter
from weaviate_tpu.filters import Operator as JOperator
from weaviate_tpu.schema import config as jschema
from weaviate_tpu_torch import convert
from weaviate_tpu_torch.db import Database as TDatabase
from weaviate_tpu_torch.engine.flat import FlatIndex as TFlatIndex
from weaviate_tpu_torch.engine.quantized import QuantizedVectorStore as TStore
from weaviate_tpu_torch.filters import Filter as TFilter
from weaviate_tpu_torch.filters import Operator as TOperator
from weaviate_tpu_torch.ops import kernels as K
from weaviate_tpu_torch.runtime.query_batcher import QueryBatcher, _Pending
from weaviate_tpu_torch.schema import config as tschema

RTOL, ATOL = 2e-4, 2e-3
TIE_TOL = 1e-5


def _data(seed, n=1500, d=64, nq=6):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((40, d)).astype(np.float32)
    v = (cent[rng.integers(0, 40, n)] + 0.5 * rng.standard_normal((n, d))).astype(np.float32)
    q = (v[rng.integers(0, n, nq)] + 0.1 * rng.standard_normal((nq, d))).astype(np.float32)
    return rng, v, q


def _same(got, want, rtol=RTOL, atol=ATOL):
    gd, gi = (np.atleast_2d(np.asarray(a)) for a in got)
    wd, wi = (np.atleast_2d(np.asarray(a)) for a in want)
    assert gi.shape == wi.shape
    np.testing.assert_allclose(gd, wd, rtol=rtol, atol=atol)
    for r, p in zip(*np.nonzero(gi != wi)):
        tied = np.abs(wd[r] - wd[r, p]) <= TIE_TOL
        assert gi[r, p] in wi[r][tied] or abs(wd[r, p] - wd[r, -1]) <= TIE_TOL, (r, p)


def _twins(quantization, rescore, v, metric="l2-squared", **kw):
    """A JAX store on the scan-reduce path (interpret mode) and the port's
    store carried from its snapshot (codebook and all), both loaded."""
    js = JStore(dim=v.shape[1], metric=metric, quantization=quantization,
                rescore=rescore, capacity=1024, **kw)
    js.use_pallas = True
    if quantization == "pq":
        js.train(v[:800])
    js.add(v)
    ts = convert.quantized_store_from_jax_snapshot(js.snapshot(), device="cpu")
    ts.use_pallas = True
    return js, ts


@pytest.mark.parametrize("quantization,rescore,prefix_bits,selection,metric", [
    ("bq", "host", None, "approx", "l2-squared"),
    ("bq", "device", None, "fused", "cosine"),
    ("bq", "host", 128, "approx", "dot"),
    ("pq", "host", None, "approx", "l2-squared"),
    ("pq", "device", None, "fused", "cosine"),
    ("pq", "none", None, "approx", "l2-squared"),
    ("pq", "host", 128, "fused", "l2-squared"),
])
def test_quantized_store_matches_jax(quantization, rescore, prefix_bits, selection, metric):
    # a 128-bit prefix needs more than 128 dims (narrower codes skip it)
    rng, v, q = _data(3, d=160 if prefix_bits else 64)
    kw = dict(selection=selection, prefix_bits=prefix_bits)
    if quantization == "pq":
        kw["pq_segments"] = 16
    js, ts = _twins(quantization, rescore, v, metric=metric, **kw)
    assert ts.codes.shape == tuple(np.asarray(js.codes).shape)
    if prefix_bits:
        assert ts.prefix_words == js.prefix_words == 4
        np.testing.assert_array_equal(ts.prefix_t.numpy().view(np.uint32),
                                      np.asarray(js.prefix_t))
    allow_shared = rng.random(ts.capacity) < 0.5
    allow_rows = rng.random((len(q), ts.capacity)) < 0.4
    for allow in (None, allow_shared, allow_rows):
        want = js.search(q, 10, allow_mask=allow)
        got = ts.search(q, 10, allow_mask=allow)
        _same(got, want)
        # the async twin gives the same answer
        again = ts.search_async(q, 10, allow_mask=allow).result()
        np.testing.assert_array_equal(again[1], got[1])
        np.testing.assert_array_equal(again[0], got[0])
    gone = rng.choice(len(v), 300, replace=False)
    js.delete(gone)
    ts.delete(gone)
    want, got = js.search(q, 10), ts.search(q, 10)
    _same(got, want)
    assert not set(np.asarray(got[1]).ravel().tolist()) & set(gone.tolist())
    assert ts.live_count() == js.live_count() == len(v) - 300


def test_quantized_store_compact_snapshot_restore():
    rng, v, q = _data(5)
    for quantization in ("bq", "pq"):
        js, ts = _twins(quantization, "host", v,
                        **({"pq_segments": 16} if quantization == "pq" else {}))
        gone = rng.choice(len(v), 400, replace=False)
        js.delete(gone)
        ts.delete(gone)
        jm, tm = js.compact(), ts.compact()
        np.testing.assert_array_equal(tm, jm)
        assert ts.capacity == js.capacity and ts.count == js.count
        _same(ts.search(q, 8), js.search(q, 8))
        snap = ts.snapshot()
        back = TStore.restore(snap, device="cpu")
        back.use_pallas = True
        assert back.quantization == quantization and back.selection == ts.selection
        np.testing.assert_array_equal(back.search(q, 8)[1], ts.search(q, 8)[1])
        # the port's snapshot is the JAX store's dict: the JAX package
        # restores it too
        jback = JStore.restore(snap)
        jback.use_pallas = True
        _same(ts.search(q, 8), jback.search(q, 8))


def test_codes_only_snapshot_carries_codes_and_prefix():
    _, v, q = _data(7, d=160)
    js, ts = _twins("pq", "none", v, pq_segments=16, prefix_bits=128)
    assert "codes" in js.snapshot() and "prefix_t" in js.snapshot()
    np.testing.assert_array_equal(ts.codes.numpy(), np.asarray(js.codes))
    np.testing.assert_array_equal(ts.prefix_t.numpy().view(np.uint32),
                                  np.asarray(js.prefix_t))
    np.testing.assert_array_equal(ts.codebook.centroids.numpy(),
                                  np.asarray(js.codebook.centroids))
    _same(ts.search(q, 10), js.search(q, 10))


def test_untrained_pq_store_raises():
    st = TStore(dim=16, quantization="pq", capacity=64, device="cpu")
    st.add(np.ones((4, 16), np.float32))
    with pytest.raises(RuntimeError, match="not trained"):
        st.search(np.ones(16, np.float32), 2)
    # a mesh is ported: anything but a Mesh is a TypeError
    with pytest.raises(TypeError, match="Mesh"):
        TStore(dim=16, quantization="bq", mesh=object(), device="cpu")


def test_flat_index_compress_at_runtime():
    rng, v, q = _data(11, n=1200)
    exact = ((q[:, None, :] - v[None]) ** 2).sum(-1)
    for quantization in ("pq", "bq"):
        ti = TFlatIndex(dim=v.shape[1], capacity=512, device="cpu")
        ji = JFlatIndex(dim=v.shape[1], capacity=512)
        ids = np.arange(100, 100 + len(v))
        ti.add_batch(ids, v)
        ji.add_batch(ids, v)
        ti.delete(*ids[:50].tolist())
        ji.delete(*ids[:50].tolist())
        assert not ti.compressed
        ti.compress(quantization, pq_segments=16)
        ji.compress(quantization, pq_segments=16)
        assert ti.compressed and ti.store.quantization == quantization
        with pytest.raises(RuntimeError, match="already compressed"):
            ti.compress(quantization)
        got_i, got_d = ti.search_by_vector_batch(q, 10)
        want_i, want_d = ji.search_by_vector_batch(q, 10)
        # both rescore exactly: every returned id carries its true distance,
        # and the two packages agree on the top-k (their codebooks differ,
        # the rescored candidates coincide at this size)
        np.testing.assert_allclose(got_d, exact[np.arange(len(q))[:, None], got_i - 100],
                                   rtol=RTOL, atol=ATOL)
        assert not np.isin(got_i, ids[:50]).any()
        _same((got_d, got_i), (want_d, want_i))


def _config(schema, quantization=None, prefix_bits=None, metric="cosine"):
    return schema.CollectionConfig(
        name="Article",
        properties=[schema.Property(name="category", data_type="text"),
                    schema.Property(name="views", data_type="int")],
        vectors=[schema.VectorConfig(index=schema.VectorIndexConfig(
            index_type="flat", metric=metric, quantization=quantization,
            prefix_bits=prefix_bits))])


def _objects(rng, n, d):
    cent = rng.standard_normal((30, d)).astype(np.float32)
    vecs = (cent[rng.integers(0, 30, n)] + 0.6 * rng.standard_normal((n, d))).astype(np.float32)
    return [{"uuid": f"00000000-0000-4000-8000-{i:012d}",
             "properties": {"category": f"c{i % 7}", "views": int(i)},
             "vector": vecs[i]} for i in range(n)]


def _same_results(a, b):
    assert [r.uuid for r in b] == [r.uuid for r in a]
    np.testing.assert_allclose([r.distance for r in b], [r.distance for r in a],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("prefix_bits", [None, 128])
def test_bq_collection_parity_with_jax(tmp_path, prefix_bits):
    rng = np.random.default_rng(19)
    d = 256
    objs = _objects(rng, 600, d)
    jdb = JDatabase(str(tmp_path / "j"))
    tdb = TDatabase(str(tmp_path / "t"), device="cpu")
    try:
        jc = jdb.create_collection(_config(jschema, "bq", prefix_bits))
        tc = tdb.create_collection(_config(tschema, "bq", prefix_bits))
        jc.batch_put(objs)
        tc.batch_put(objs)
        tidx = next(iter(tc.shards.values())).vector_indexes[""]
        assert tidx.compressed and tidx.store.quantization == "bq"
        assert tidx.store.prefix_words == (4 if prefix_bits else 0)
        qs = rng.standard_normal((5, d)).astype(np.float32)
        for q in qs:
            _same_results(jc.near_vector(q, k=10), tc.near_vector(q, k=10))
            _same_results(
                jc.near_vector(q, k=10, where=JFilter.where(
                    "views", JOperator.GREATER_THAN_EQUAL, 300)),
                tc.near_vector(q, k=10, where=TFilter.where(
                    "views", TOperator.GREATER_THAN_EQUAL, 300)))
            _same_results(
                jc.near_vector(q, k=5, where=JFilter.where(
                    "category", JOperator.EQUAL, "c2")),
                tc.near_vector(q, k=5, where=TFilter.where(
                    "category", TOperator.EQUAL, "c2")))
        for o in objs[:90:3]:
            assert jc.delete_object(o["uuid"]) == tc.delete_object(o["uuid"])
        for q in qs:
            _same_results(jc.near_vector(q, k=10), tc.near_vector(q, k=10))
    finally:
        jdb.close()
        tdb.close()


def test_update_collection_compresses_live_class(tmp_path):
    """The reference lifecycle (tests/test_runtime_compress.py): PQ turned
    on for a live flat class trains and swaps in place; the JAX package on
    the same objects gives the same answers; disabling is refused."""
    rng = np.random.default_rng(31)
    n, d = 600, 16
    objs = _objects(rng, n, d)
    jdb = JDatabase(str(tmp_path / "j"))
    tdb = TDatabase(str(tmp_path / "t"), device="cpu")
    try:
        jc = jdb.create_collection(_config(jschema, metric="l2-squared"))
        tc = tdb.create_collection(_config(tschema, metric="l2-squared"))
        jc.batch_put(objs)
        tc.batch_put(objs)
        q = objs[50]["vector"]
        before = {r.uuid for r in tc.near_vector(q, k=10)}
        for db, col in ((jdb, jc), (tdb, tc)):
            cfg = copy.deepcopy(col.config)
            cfg.vectors[0].index.quantization = "pq"
            db.update_collection(cfg)
        idx = next(iter(tc.shards.values())).vector_indexes[""]
        assert idx.compressed and idx.store.quantization == "pq"
        assert idx.store.codebook.centroids.shape == (4, 16, 4)
        assert tc.config.vectors[0].index.quantization == "pq"
        after = tc.near_vector(q, k=10)
        assert after[0].uuid == objs[50]["uuid"]
        assert len(before & {r.uuid for r in after}) >= 8
        # rescored exactly: the distances are the true ones
        vec = {o["uuid"]: o["vector"] for o in objs}
        np.testing.assert_allclose(
            [r.distance for r in after],
            [float(((vec[r.uuid] - q) ** 2).sum()) for r in after], rtol=RTOL, atol=ATOL)
        want = jc.near_vector(q, k=10)
        assert [r.uuid for r in after][:5] == [r.uuid for r in want][:5]
        # the one-way door
        cfg2 = copy.deepcopy(tc.config)
        cfg2.vectors[0].index.quantization = None
        with pytest.raises(ValueError, match="cannot be disabled"):
            tdb.update_collection(cfg2)
        cfg3 = copy.deepcopy(tc.config)
        cfg3.vectors[0].index.quantization = "bq"
        with pytest.raises(ValueError, match="cannot be disabled or changed"):
            tdb.update_collection(cfg3)
        cfg4 = copy.deepcopy(tc.config)
        cfg4.replication.factor = 2
        # the scaler refuses a factor above the node count, as the JAX one
        from weaviate_tpu_torch.cluster.scaler import ScaleError

        with pytest.raises(ScaleError, match="exceeds cluster size"):
            tdb.update_collection(cfg4)
        assert tc.config.replication.factor == 1
    finally:
        jdb.close()
        tdb.close()


def test_update_collection_defers_compression_below_training_floor(tmp_path):
    tdb = TDatabase(str(tmp_path / "t"), device="cpu")
    try:
        tc = tdb.create_collection(_config(tschema, metric="l2-squared"))
        tc.batch_put(_objects(np.random.default_rng(2), 8, 16))
        cfg = copy.deepcopy(tc.config)
        cfg.vectors[0].index.quantization = "pq"
        tdb.update_collection(cfg)  # 8 rows < 16 centroids: deferred, not an error
        idx = next(iter(tc.shards.values())).vector_indexes[""]
        assert not idx.compressed
        tc.batch_put(_objects(np.random.default_rng(3), 40, 16)[8:])
        assert idx.compressed  # the write path retries once there is enough
    finally:
        tdb.close()


def _drain_through(qb, reqs):
    items = [_Pending(np.asarray(q, np.float32), k, allow) for q, k, allow in reqs]
    qb._dispatch(items)
    for it in items:
        assert it.event.wait(timeout=10.0)
        assert it.error is None, it.error
    return [(np.asarray(it.ids), np.asarray(it.dists)) for it in items]


def test_bq_batcher_async_bit_exact_vs_sync():
    """tests/test_query_batcher.py's mixed drain on a BQ index."""
    rng = np.random.default_rng(0)
    idx = TFlatIndex(dim=16, capacity=512, quantization="bq", device="cpu")
    idx.store.use_pallas = True
    idx.add_batch(np.arange(512), rng.standard_normal((512, 16)).astype(np.float32))
    qs = rng.standard_normal((8, 16)).astype(np.float32)
    reqs = [(qs[0], 5, None), (qs[1], 5, np.arange(0, 400, 3, dtype=np.int64)),
            (qs[2], 3, None), (qs[3], 7, np.arange(100, 140, dtype=np.int64)),
            (qs[4], 5, np.array([7, 9, 11, 13, 400], dtype=np.int64)), (qs[5], 5, None)]
    qb_sync = QueryBatcher(idx.search_by_vector_batch, supports_filter_batching=True)
    qb_async = QueryBatcher(idx.search_by_vector_batch, supports_filter_batching=True,
                            async_batch_fn=idx.search_by_vector_batch_async)
    try:
        a = _drain_through(qb_sync, reqs)
        b = _drain_through(qb_async, reqs)
        for (ia, da), (ib, db) in zip(a, b):
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(da, db)
        assert qb_async.async_dispatches == 1 and qb_sync.async_dispatches == 0
    finally:
        qb_sync.stop()
        qb_async.stop()


def test_bq_collection_concurrent_clients_match_serial(tmp_path):
    rng = np.random.default_rng(37)
    objs = _objects(rng, 500, 32)
    tdb = TDatabase(str(tmp_path / "t"), device="cpu")
    try:
        tc = tdb.create_collection(_config(tschema, "bq"))
        tc.batch_put(objs)
        shard = next(iter(tc.shards.values()))
        shard.vector_indexes[""].store.use_pallas = True
        qs = rng.standard_normal((24, 32)).astype(np.float32)
        where = TFilter.where("views", TOperator.GREATER_THAN_EQUAL, 100)
        # the batcher pads k to a power of two (10 -> 16) and a quantized
        # store oversamples rescore_limit * k candidates, so the serial path
        # that gives the same answers is the one asked for k = 16
        shard.dynamic_batching = False
        serial = [tc.near_vector(q, k=16, where=where if i % 2 else None)[:10]
                  for i, q in enumerate(qs)]
        shard.dynamic_batching = True
        out = [None] * len(qs)
        errors = []

        def client(c):
            try:
                for i in range(c, len(qs), 8):
                    out[i] = tc.near_vector(qs[i], k=10, where=where if i % 2 else None)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and not any(t.is_alive() for t in threads)
        for a, b in zip(serial, out):
            assert [r.uuid for r in a] == [r.uuid for r in b]
        assert shard._query_batchers[""].async_dispatches > 0
    finally:
        tdb.close()


def test_cpu_quantized_path_counts_no_launch():
    before = dict(K.launch_counts)
    _, v, q = _data(13, n=300)
    st = TStore(dim=v.shape[1], quantization="bq", capacity=512, device="cpu")
    st.use_pallas = True
    st.add(v)
    st.search(q, 5)
    assert K.launch_counts == before
