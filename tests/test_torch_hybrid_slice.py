"""The port's hybrid slice end to end against the JAX package:
``Database`` -> ``Collection.hybrid / hybrid_async / bm25`` on the same
objects, on the device path (BM25F + fusion in one batched program, the
``bm25_block`` kernel's plain version on the CPU) and on the host
reference path (``shard.device_hybrid = False``), plus the serving pins of
the shard's query batcher.

Uuid lists must match exactly on the tie-free corpus. Keyword scores are
the host scorer's f32 on both sides and must be equal. Fused scores are
held to rtol 1e-6: the host path fuses in Python floats and the device
path in f32, and the dense distances of torch and XLA may differ in their
last bit (the reference holds its own device and host paths to the same
1e-6).
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from weaviate_tpu.db import Database as JDatabase
from weaviate_tpu.filters import Filter as JFilter
from weaviate_tpu.schema import config as jschema
from weaviate_tpu_torch.db import Database as TDatabase
from weaviate_tpu_torch.filters import Filter as TFilter
from weaviate_tpu_torch.runtime.query_batcher import (DeviceHybridUnavailable,
                                                      QueryBatcher, _Pending)
from weaviate_tpu_torch.schema import config as tschema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-6, 1e-7
DIM = 8


def _config(schema):
    return schema.CollectionConfig(
        name="Doc",
        properties=[schema.Property(name="body", data_type="text"),
                    schema.Property(name="title", data_type="text"),
                    schema.Property(name="n", data_type="int")],
        vectors=[schema.VectorConfig()])


def _tiefree_objects(rng, n=48):
    """Doc i carries a doc-unique alpha frequency (i+1), bravo skips every
    third doc with its own unique frequency, pad varies the length: BM25
    scores stay gapped (the reference's hybrid test corpus, with titles and
    an int property for filters)."""
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    objs = []
    for i in range(n):
        words = ["alpha"] * (i + 1)
        if i % 3:
            words += ["bravo"] * (i + 2)
        words += ["pad"] * (1 + (7 * i) % 17)
        title = " ".join(["alpha"] * (1 + i % 5) + [f"t{i}"]) if i % 4 else "charlie"
        objs.append({"uuid": f"00000000-0000-4000-8000-{i:012d}",
                     "properties": {"body": " ".join(words), "title": title, "n": i},
                     "vector": vecs[i]})
    return objs


@pytest.fixture(scope="module")
def cols(tmp_path_factory):
    rng = np.random.default_rng(9)
    objs = _tiefree_objects(rng)
    root = tmp_path_factory.mktemp("hybrid")
    jdb = JDatabase(str(root / "j"))
    tdb = TDatabase(str(root / "t"), device="cpu")
    try:
        jc = jdb.create_collection(_config(jschema))
        tc = tdb.create_collection(_config(tschema))
        jc.batch_put(objs)
        tc.batch_put(objs)
        queries = rng.standard_normal((16, DIM)).astype(np.float32)
        yield jc, tc, queries
    finally:
        jdb.close()
        tdb.close()


def _shard(col):
    return next(iter(col.shards.values()))


def _same(a, b, exact=False):
    assert [r.uuid for r in a] == [r.uuid for r in b]
    if exact:
        np.testing.assert_array_equal(np.float32([r.score for r in a]),
                                      np.float32([r.score for r in b]))
    else:
        np.testing.assert_allclose([r.score for r in a], [r.score for r in b],
                                   rtol=RTOL, atol=ATOL)


def _batched(tc) -> int:
    shard = _shard(tc)
    return shard._query_batcher("", shard.vector_indexes[""]).hybrid_batched


@pytest.mark.parametrize("fusion", ["rankedFusion", "relativeScore"])
@pytest.mark.parametrize("filtered", [False, True])
def test_hybrid_parity_device_and_host_paths(cols, fusion, filtered):
    jc, tc, qs = cols
    jw = JFilter.where("n", "GreaterThanEqual", 12) if filtered else None
    tw = TFilter.where("n", "GreaterThanEqual", 12) if filtered else None
    js, ts = _shard(jc), _shard(tc)
    i = 0
    for alpha in (0.0, 0.3, 0.75, 1.0):
        for k in (3, 10):
            q, i = qs[i % len(qs)], i + 1
            args = dict(vector=q, alpha=alpha, k=k, fusion=fusion,
                        properties=["body", "title^2"])
            want = jc.hybrid("alpha bravo", where=jw, **args)
            before = _batched(tc)
            got = tc.hybrid("alpha bravo", where=tw, **args)
            assert _batched(tc) == before + 1  # the device path served it
            _same(got, want)
            assert len(got) == k
            js.device_hybrid = ts.device_hybrid = False
            try:
                j_host = jc.hybrid("alpha bravo", where=jw, **args)
                t_host = tc.hybrid("alpha bravo", where=tw, **args)
            finally:
                js.device_hybrid = ts.device_hybrid = True
            _same(t_host, j_host)
            _same(got, t_host)
            if filtered:
                assert all(int(r.uuid[-12:]) >= 12 for r in got)


@pytest.mark.parametrize("fusion", ["rankedFusion", "relativeScore"])
def test_hybrid_parity_under_fused_selection(cols, fusion):
    """The dense leg through the store's "fused" selection (the scan +
    top-k kernels' plain versions here) gives the JAX package's answer."""
    jc, tc, qs = cols
    store = _shard(tc).vector_indexes[""].store
    store.selection = "fused"
    try:
        for i, alpha in enumerate((0.3, 0.75, 1.0)):
            args = dict(vector=qs[8 + i], alpha=alpha, k=10, fusion=fusion)
            before = _batched(tc)
            got = tc.hybrid("alpha bravo", **args)
            assert _batched(tc) == before + 1
            _same(got, jc.hybrid("alpha bravo", **args))
    finally:
        store.selection = "approx"


def test_hybrid_async_and_bm25_parity(cols):
    jc, tc, qs = cols
    for j, (fusion, alpha) in enumerate([("relativeScore", 0.75), ("rankedFusion", 0.3),
                                         ("rankedFusion", 0.75)]):
        args = dict(vector=qs[j], alpha=alpha, k=6, fusion=fusion)
        h = tc.hybrid_async("alpha bravo", **args)
        _same(h.result(), jc.hybrid_async("alpha bravo", **args).result())
        _same(h.result(), tc.hybrid("alpha bravo", **args))
    # a filtered async query runs the host path inline, pre-resolved
    tw = TFilter.where("n", "GreaterThanEqual", 30)
    jw = JFilter.where("n", "GreaterThanEqual", 30)
    _same(tc.hybrid_async("bravo", vector=qs[0], k=5, where=tw).result(),
          jc.hybrid_async("bravo", vector=qs[0], k=5, where=jw).result())
    # keyword search: the same host scorer on both sides, scores equal
    for q, props in (("alpha", None), ("alpha bravo", ["body", "title^2"]),
                     ("the charlie of", None)):
        for k in (3, 10):
            _same(tc.bm25(q, k=k, properties=props), jc.bm25(q, k=k, properties=props),
                  exact=True)
    _same(tc.bm25("bravo", k=10, where=tw), jc.bm25("bravo", k=10, where=jw), exact=True)
    # no query vector: sparse-only on the host path
    _same(tc.hybrid("alpha", vector=None, k=5), jc.hybrid("alpha", vector=None, k=5))


@pytest.mark.parametrize("cut", [1, 2, 3])
def test_autocut_and_max_distance_parity(cols, cut):
    """``near_vector(max_distance=, autocut=)`` and ``autocut=`` on bm25,
    hybrid (device and host paths) and hybrid_async against the JAX
    package's answers on the same objects."""
    jc, tc, qs = cols
    js, ts = _shard(jc), _shard(tc)
    shortened = {"near_vector": 0, "bm25": 0, "hybrid": 0}
    for q in qs[:4]:
        full = jc.near_vector(q, k=20, include_objects=False)
        # a bound halfway between two results, clear of either's last bit
        md = (full[9].distance + full[10].distance) / 2
        for kw in (dict(autocut=cut), dict(max_distance=md),
                   dict(max_distance=md, autocut=cut)):
            want = jc.near_vector(q, k=20, include_objects=False, **kw)
            got = tc.near_vector(q, k=20, include_objects=False, **kw)
            assert [r.uuid for r in got] == [r.uuid for r in want]
            np.testing.assert_allclose([r.distance for r in got],
                                       [r.distance for r in want], rtol=RTOL, atol=ATOL)
            shortened["near_vector"] += len(got) < len(full)
        assert len(tc.near_vector(q, k=20, max_distance=md, include_objects=False)) == 10
    for text, props in (("alpha", None), ("alpha bravo", ["body", "title^2"])):
        got = tc.bm25(text, k=20, properties=props, autocut=cut)
        _same(got, jc.bm25(text, k=20, properties=props, autocut=cut), exact=True)
        shortened["bm25"] += len(got) < 20
    for i, (fusion, alpha) in enumerate([("relativeScore", 0.75), ("rankedFusion", 0.3),
                                         ("relativeScore", 0.25)]):
        args = dict(vector=qs[5 + i], alpha=alpha, k=20, fusion=fusion, autocut=cut)
        want = jc.hybrid("alpha bravo", **args)
        before = _batched(tc)
        got = tc.hybrid("alpha bravo", **args)
        assert _batched(tc) == before + 1  # the device path served it
        _same(got, want)
        _same(tc.hybrid_async("alpha bravo", **args).result(),
              jc.hybrid_async("alpha bravo", **args).result())
        shortened["hybrid"] += len(got) < 20
        js.device_hybrid = ts.device_hybrid = False
        try:
            _same(tc.hybrid("alpha bravo", **args), jc.hybrid("alpha bravo", **args))
        finally:
            js.device_hybrid = ts.device_hybrid = True
    # each cut is exercised, not only passed through
    assert all(shortened.values()), shortened


def test_hybrid_sync_async_batched_solo_identical(cols):
    _jc, tc, qs = cols
    shard = _shard(tc)
    args = dict(k=8, alpha=0.5, fusion="rankedFusion")
    batched = shard.hybrid_search("alpha bravo", qs[1], **args)
    shard.dynamic_batching = False
    try:
        solo = shard.hybrid_search("alpha bravo", qs[1], **args)
    finally:
        shard.dynamic_batching = True
    h = shard.hybrid_search_async("alpha bravo", qs[1], **args)
    assert h is not None
    for ids, scores in (solo, h.result()):
        np.testing.assert_array_equal(batched[0], ids)
        np.testing.assert_array_equal(batched[1], scores)


def test_concurrent_mixed_clients_coalesce_and_match_serial(cols):
    _jc, tc, qs = cols
    shard = _shard(tc)
    n = 32

    def ask(i):
        if i % 3 == 2:  # plain nearVector rides the same batcher
            return tc.near_vector(qs[i % len(qs)], k=5, include_objects=False)
        return tc.hybrid("alpha bravo" if i % 2 else "bravo pad", vector=qs[i % len(qs)],
                         alpha=0.25 + 0.25 * (i % 3), k=5,
                         fusion="rankedFusion" if i % 2 else "relativeScore",
                         include_objects=False)

    serial = [ask(i) for i in range(n)]
    qb = shard._query_batchers[""]
    d0, h0 = qb.dispatches, qb.hybrid_batched
    out = [None] * n
    barrier = threading.Barrier(8)

    def client(c):
        barrier.wait()
        for i in range(c, n, 8):
            out[i] = ask(i)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    n_hybrid = sum(1 for i in range(n) if i % 3 != 2)
    assert qb.hybrid_batched - h0 == n_hybrid  # every hybrid query on the card path
    assert qb.dispatches - d0 < n
    # CPU matrix products are not batch-invariant in their last bit, so a
    # coalesced answer's numbers are held to rtol 1e-6, its uuids exactly
    for a, b in zip(serial, out):
        assert [r.uuid for r in a] == [r.uuid for r in b]
        np.testing.assert_allclose([r.score if r.score is not None else r.distance
                                    for r in a],
                                   [r.score if r.score is not None else r.distance
                                    for r in b], rtol=RTOL, atol=ATOL)


def test_candidate_budget_and_kill_switch_take_host_path(cols):
    jc, tc, qs = cols
    shard = _shard(tc)
    args = dict(vector=qs[2], alpha=0.6, k=7)
    want = jc.hybrid("alpha bravo", **args)
    union = len(shard._inverted.bm25_pack("alpha bravo")["doc_ids"])
    shard.hybrid_max_candidates = union - 1
    try:
        assert shard.hybrid_search("alpha bravo", qs[2], 7) is None
        before = _batched(tc)
        got = tc.hybrid("alpha bravo", **args)
        assert _batched(tc) == before
    finally:
        shard.hybrid_max_candidates = 4096
    _same(got, want)
    shard.device_hybrid = False
    try:
        assert shard.hybrid_search("alpha", qs[2], 5) is None
        _same(tc.hybrid("alpha bravo", **args), want)
    finally:
        shard.device_hybrid = True
    assert shard.hybrid_search("alpha", None, 5) is None


def test_many_term_query_rides_device_path(tmp_path):
    """A query of 321 live terms (T pads to 512, past one of the CUDA
    kernel's 64-term tiles many times over) is scored on the device path
    and equals the JAX package's answer on both of its paths."""
    rng = np.random.default_rng(21)
    n = 80
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    objs = [{"uuid": f"00000000-0000-4000-8000-{i:012d}",
             "properties": {"body": " ".join(["alpha"] * (i + 1)
                                             + [f"u{i}v{j}" for j in range(4)]),
                            "title": f"u{i}v0", "n": i},
             "vector": vecs[i]} for i in range(n)]
    query = " ".join(["alpha"] + [f"u{i}v{j}" for i in range(n) for j in range(4)])
    jdb = JDatabase(str(tmp_path / "j"))
    tdb = TDatabase(str(tmp_path / "t"), device="cpu")
    try:
        jc = jdb.create_collection(_config(jschema))
        tc = tdb.create_collection(_config(tschema))
        jc.batch_put(objs)
        tc.batch_put(objs)
        shard = _shard(tc)
        pack = shard._inverted.bm25_pack(query)
        assert len(pack["idf"]) == 321 and len(pack["seg_term"]) > 321
        for fusion, alpha in (("rankedFusion", 0.5), ("relativeScore", 0.75)):
            args = dict(vector=vecs[3] + 0.1, alpha=alpha, k=10, fusion=fusion)
            before = _batched(tc)
            got = tc.hybrid(query, **args)
            assert _batched(tc) == before + 1  # the device path served it
            _same(got, jc.hybrid(query, **args))
            _shard(jc).device_hybrid = shard.device_hybrid = False
            try:
                _same(got, tc.hybrid(query, **args))
                _same(got, jc.hybrid(query, **args))
            finally:
                _shard(jc).device_hybrid = shard.device_hybrid = True
    finally:
        jdb.close()
        tdb.close()


def test_batcher_without_fused_program_raises_typed(cols):
    jc, tc, qs = cols
    shard = _shard(tc)
    idx = shard.vector_indexes[""]
    qb = QueryBatcher(idx.search_by_vector_batch)  # no hybrid_batch_fn
    try:
        op = shard._hybrid_operand(idx, "alpha", 5, 0.5, "rankedFusion", None, None)
        items = [_Pending(qs[0], 5, None, op), _Pending(qs[1], 5, None)]
        qb._dispatch(items)
        for it in items:
            assert it.event.wait(timeout=10.0)
        assert isinstance(items[0].error, DeviceHybridUnavailable)
        # the pure row was re-dispatched through the normal path
        assert items[1].error is None
        ids, _ = idx.search_by_vector(qs[1], 5)
        got = np.asarray(items[1].ids)
        np.testing.assert_array_equal(got[got >= 0], ids)
        # the shard turns the typed error into the host path
        saved = shard._query_batchers[""]
        shard._query_batchers[""] = qb
        try:
            assert shard.hybrid_search("alpha", qs[3], 5) is None
            got = tc.hybrid("alpha", vector=qs[3], k=5, alpha=0.5)
        finally:
            shard._query_batchers[""] = saved
        _same(got, jc.hybrid("alpha", vector=qs[3], k=5, alpha=0.5))
    finally:
        qb.stop()


def test_mixed_drain_is_one_dispatch(cols):
    _jc, tc, qs = cols
    shard = _shard(tc)
    idx = shard.vector_indexes[""]
    qb = shard._query_batcher("", idx)
    op = shard._hybrid_operand(idx, "alpha bravo", 5, 0.5, "rankedFusion", None, None)
    items = [_Pending(qs[0], 5, None), _Pending(qs[1], 5, None, op),
             _Pending(qs[2], 5, None)]
    d0, h0 = qb.dispatches, qb.hybrid_batched
    qb._dispatch(items)
    for it in items:
        assert it.event.wait(timeout=10.0)
        assert it.error is None, it.error
    assert qb.dispatches == d0 + 1
    assert qb.hybrid_batched == h0 + 1
    solo_ids, _ = shard.hybrid_search("alpha bravo", qs[1], 5, alpha=0.5,
                                      fusion="rankedFusion")
    hyb = np.asarray(items[1].ids)
    np.testing.assert_array_equal(hyb[hyb >= 0], solo_ids)
    for row in (0, 2):
        ids, _ = idx.search_by_vector(qs[row], 5)
        got = np.asarray(items[row].ids)
        np.testing.assert_array_equal(got[got >= 0], ids)


def test_quantized_index_declines_device_hybrid(tmp_path):
    tdb = TDatabase(str(tmp_path / "t"), device="cpu")
    try:
        cfg = _config(tschema)
        cfg.vectors[0].index.quantization = "bq"
        col = tdb.create_collection(cfg)
        col.batch_put(_tiefree_objects(np.random.default_rng(2))[:20])
        shard = _shard(col)
        assert not shard.vector_indexes[""].supports_device_hybrid
        q = np.ones(DIM, np.float32)
        assert shard.hybrid_search("alpha", q, 5) is None
        assert len(col.hybrid("alpha", vector=q, k=5)) == 5
    finally:
        tdb.close()


def test_hybrid_slice_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import weaviate_tpu_torch.ops.bm25, weaviate_tpu_torch.db.collection\n"
            "import weaviate_tpu_torch.query.autocut, weaviate_tpu_torch.text.hybrid\n"
            "assert not any(k == 'weaviate_tpu' or k.startswith('weaviate_tpu.')"
            " for k in sys.modules)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
