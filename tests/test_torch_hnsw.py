"""The port's HNSW index and its bulk build (``weaviate_tpu_torch/engine/
hnsw.py``, ``engine/hnsw_build.py``) against the JAX package, on the CPU.

The graph is host numpy plus the C++ walker in both packages, so on the
same inputs the port must build the same graph link for link:
incremental inserts, the CPU bulk build (the host path), deletes,
tombstone cleanup, WAL replay and condense. The card's link pipeline
(``_device_knn`` / ``_self_drop`` / ``_device_select`` /
``_device_symmetrize``, torch ops around the ``fused_topk_scan`` kernel)
runs here on CPU tensors and must return the same integers as the JAX
package's jitted stages on the CPU, fed the same candidate tensors. Its
inputs are small-integer vectors, so every distance is exact in f32 and
the comparisons cannot round apart (their ties resolve by position in
both). PQ training lands on other codebooks in each package: compression
cases carry the JAX codebook across through a monkeypatched ``pq_fit``
(this test's seam only).
"""

import numpy as np
import pytest
import torch

from weaviate_tpu.engine import hnsw_build as jhb
from weaviate_tpu.engine.hnsw import HNSWIndex as JHNSW
from weaviate_tpu_torch import convert, native
from weaviate_tpu_torch.engine import hnsw_build as thb
from weaviate_tpu_torch.engine.hnsw import HNSWIndex as THNSW

CPU = dict(device="cpu")
RTOL, ATOL = 2e-4, 2e-3


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(42)
    return rng.standard_normal((2000, 32)).astype(np.float32)


@pytest.fixture
def jax_pq(monkeypatch):
    from weaviate_tpu.ops import pq as jpq
    from weaviate_tpu_torch.ops import pq as tpq

    def pq_fit(vectors, m, k=256, iters=8, device=None, **kw):
        cb = jpq.pq_fit(vectors, m=m, k=k, iters=iters, **kw)
        return convert.pq_codebook(np.asarray(cb.centroids), device=device)

    monkeypatch.setattr(tpq, "pq_fit", pq_fit)


def _graph(idx):
    n = idx._count
    return (idx._levels[:n].tolist(), idx._doc_ids[:n].tolist(),
            idx._tombstone[:n].tolist(), idx._ep, idx._max_level,
            [[lk.tolist() for lk in idx._links[s]] for s in range(n)])


def _same_graph(t, j):
    gt, gj = _graph(t), _graph(j)
    assert gt[:5] == gj[:5]
    assert gt[5] == gj[5]


def _same_answers(t, j, qs, k=10, allow=None):
    for q in qs:
        ti, td = t.search_by_vector(q, k, allow)
        ji, jd = j.search_by_vector(q, k, allow)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)


def _int_vectors(rng, n, d):
    """Small-integer rows: every product and sum is exact in f32."""
    return rng.integers(-4, 5, size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("metric", ["l2-squared", "cosine", "dot"])
def test_incremental_graph_parity(corpus, metric):
    """Incremental inserts give the same levels and links as the JAX
    package (native walker in both), then the same answers."""
    t = THNSW(dim=32, metric=metric, max_connections=8, ef_construction=48,
              seed=3, **CPU)
    j = JHNSW(dim=32, metric=metric, max_connections=8, ef_construction=48,
              seed=3)
    for s in range(0, 600, 150):
        t.add_batch(np.arange(s, s + 150), corpus[s:s + 150])
        j.add_batch(np.arange(s, s + 150), corpus[s:s + 150])
    _same_graph(t, j)
    _same_answers(t, j, corpus[1000:1010] + 0.01)


def test_python_walker_parity(corpus):
    """Without the native library both packages run the Python walker
    (inserts and searches) and build the same graph; the native answers
    and the Python walker's agree as closely as in the JAX package."""
    t = THNSW(dim=32, max_connections=8, ef_construction=48, ef=64, **CPU)
    j = JHNSW(dim=32, max_connections=8, ef_construction=48, ef=64)
    t._native = j._native = None
    t.add_batch(np.arange(400), corpus[:400])
    j.add_batch(np.arange(400), corpus[:400])
    _same_graph(t, j)
    qs = corpus[1500:1520]
    _same_answers(t, j, qs)
    if not native.available():
        return
    nat = THNSW(dim=32, max_connections=8, ef_construction=48, ef=64, **CPU)
    assert nat._native is not None
    nat.add_batch(np.arange(400), corpus[:400])
    _same_graph(nat, t)  # the C++ ef-search picks the same links here
    overlap = []
    for q in qs:
        ids_n, _ = nat.search_by_vector(q, 10)
        ids_p, _ = t.search_by_vector(q, 10)
        overlap.append(len(set(ids_n.tolist()) & set(ids_p.tolist())) / 10)
    assert np.mean(overlap) >= 0.97


def test_native_walker_parity_and_recall(corpus):
    if not native.available():
        pytest.skip("native library unavailable")
    t = THNSW(dim=32, max_connections=16, ef_construction=64, ef=64, **CPU)
    j = JHNSW(dim=32, max_connections=16, ef_construction=64, ef=64)
    t.add_batch(np.arange(len(corpus)), corpus)
    j.add_batch(np.arange(len(corpus)), corpus)
    assert t._native is not None and not t._native_dirty
    _same_graph(t, j)
    rng = np.random.default_rng(3)
    qs = rng.standard_normal((20, 32)).astype(np.float32)
    _same_answers(t, j, qs)
    hits = 0
    for q in qs:
        ids, _ = t.search_by_vector(q, 10)
        gt = np.argsort(((corpus - q) ** 2).sum(1), kind="stable")[:10]
        hits += len(set(ids.tolist()) & set(gt.tolist()))
    assert hits / 200 >= 0.95


def test_filters_deletes_updates_cleanup(corpus):
    """Tombstones, the flat cutoff and the graph filter path, updates,
    tombstone cleanup (entrypoint re-election included): the same graph
    and answers as the JAX package at every step."""
    kw = dict(dim=32, max_connections=16, ef_construction=64, ef=64,
              flat_cutoff=0)
    t, j = THNSW(**kw, **CPU), JHNSW(**kw)
    for idx in (t, j):
        idx.add_batch(np.arange(500), corpus[:500])
    q = corpus[7]
    allow = np.arange(100, 200)
    for idx in (t, j):
        idx.delete(7, idx._doc_ids[idx._ep])
        idx.add(9, q)
    _same_answers(t, j, [q, corpus[300]])
    _same_answers(t, j, [q], allow=allow)
    ids, _ = t.search_by_vector(q, 5)
    assert ids[0] == 9 and 7 not in ids.tolist()
    assert t.cleanup_tombstones() == j.cleanup_tombstones() > 0
    _same_graph(t, j)
    _same_answers(t, j, [q, corpus[300], corpus[12]])
    t.flat_cutoff = j.flat_cutoff = 40_000  # small filters brute-force
    _same_answers(t, j, [q], allow=allow)
    d1 = t.search_by_vector_distance(q, 40.0)
    d2 = j.search_by_vector_distance(q, 40.0)
    np.testing.assert_array_equal(d1[0], d2[0])
    ids_b, dist_b = t.search_by_vector_batch(corpus[:4], 5,
                                             [None, allow, None, allow])
    for r, al in enumerate([None, allow, None, allow]):
        ids_s, _ = t.search_by_vector(corpus[r], 5, al)
        np.testing.assert_array_equal(ids_b[r][: len(ids_s)], ids_s)


def test_host_bulk_build_parity():
    """On the CPU the bulk build takes the JAX package's host path
    (host knn, host select, symmetrize): the same graph link for link."""
    rng = np.random.default_rng(7)
    n, d = 3000, 24
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    t = THNSW(dim=d, capacity=n, flat_cutoff=0, ef=96, **CPU)
    j = JHNSW(dim=d, capacity=n, flat_cutoff=0, ef=96)
    t.BULK_BUILD_MIN = j.BULK_BUILD_MIN = 1024
    t.add_batch(np.arange(n), vecs)
    j.add_batch(np.arange(n), vecs)
    _same_graph(t, j)
    assert "knn" not in thb.BUILD_STAGE_SECONDS  # no card stage ran
    q = rng.standard_normal((20, d)).astype(np.float32)
    _same_answers(t, j, q)
    # lifecycle on the bulk graph: delete, incremental insert
    for idx in (t, j):
        idx.delete(17)
        idx.add(999_999, vecs[33] + 1e-3)
    _same_graph(t, j)
    ids, _ = t.search_by_vector(vecs[33] + 1e-3, 3)
    assert 999_999 in ids.tolist() and 17 not in ids.tolist()


def test_bulk_build_cosine_and_persistence(tmp_path):
    rng = np.random.default_rng(9)
    n, d = 2000, 24
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    t = THNSW(dim=d, metric="cosine", capacity=n, flat_cutoff=0,
              commit_log_dir=str(tmp_path / "t"), **CPU)
    j = JHNSW(dim=d, metric="cosine", capacity=n, flat_cutoff=0,
              commit_log_dir=str(tmp_path / "j"))
    t.BULK_BUILD_MIN = j.BULK_BUILD_MIN = 1024
    t.add_batch(np.arange(n), vecs)
    j.add_batch(np.arange(n), vecs)
    _same_graph(t, j)
    ids, dists = t.search_by_vector(vecs[7] * 3.0, k=3)
    assert ids[0] == 7 and dists[0] < 1e-5
    t.close()
    back = THNSW(dim=d, metric="cosine", commit_log_dir=str(tmp_path / "t"), **CPU)
    _same_graph(back, j)


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
def test_device_stages_match_jax(metric):
    """The card's link stages, run on CPU tensors, return the JAX jitted
    stages' integers on the same candidate tensors: knn, self-drop,
    select (forward and over the symmetrized union) and symmetrize."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    n, d, k_eff, budget = 2048, 16, 25, 16
    sub = _int_vectors(rng, n, d)
    if metric == "cosine":
        sub = sub / np.maximum(np.linalg.norm(sub, axis=1, keepdims=True), 1e-30)
        sub = np.round(sub * 4) / 4  # back onto exact quarters
    jk = jhb._device_knn(sub, k_eff, metric)
    tk = thb._device_knn(sub, k_eff, metric, "cpu")
    np.testing.assert_array_equal(tk, jk)
    # the same candidate tensor into both packages' stages
    kd = jnp.asarray(jk.astype(np.int32))
    j_drop = np.asarray(jhb._self_drop_jit(kd, k_eff - 1))
    t_drop = thb._self_drop(torch.from_numpy(jk.astype(np.int32)), k_eff - 1)
    np.testing.assert_array_equal(t_drop.numpy(), j_drop)
    xd = torch.from_numpy(sub)
    j_fwd = np.asarray(jhb._device_select(jnp.asarray(sub), jnp.asarray(j_drop),
                                          budget, metric, qb=256))
    t_fwd = thb._device_select(xd, torch.from_numpy(j_drop), budget, metric,
                               qb=512)
    np.testing.assert_array_equal(t_fwd.numpy(), j_fwd)
    j_union = np.asarray(jhb._device_symmetrize(jnp.asarray(j_fwd)))
    t_union = thb._device_symmetrize(torch.from_numpy(j_fwd))
    np.testing.assert_array_equal(t_union.numpy(), j_union)
    j_fin = np.asarray(jhb._device_select(jnp.asarray(sub), jnp.asarray(j_union),
                                          budget, metric, qb=256))
    t_fin = thb._device_select(xd, torch.from_numpy(j_union), budget, metric,
                               qb=2048)
    np.testing.assert_array_equal(t_fin.numpy(), j_fin)
    # the whole pipeline as the card runs it, here on CPU tensors
    members = np.arange(n)
    t_all = thb._device_link_layer(sub, members, k_eff - 1, budget, metric, "cpu")
    np.testing.assert_array_equal(t_all, j_fin)


def test_select_pads_past_candidates_and_dead_rows():
    """budget > C pads with -1; rows whose candidates are all dead select
    nothing; the JAX stage agrees."""
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    sub = _int_vectors(rng, 256, 8)
    cand = rng.integers(0, 256, size=(256, 6)).astype(np.int32)
    cand[::3, 2:] = -1
    cand[5] = -1
    j = np.asarray(jhb._device_select(jnp.asarray(sub), jnp.asarray(cand), 10,
                                      "l2-squared", qb=128))
    t = thb._device_select(torch.from_numpy(sub), torch.from_numpy(cand), 10,
                           "l2-squared", qb=100)
    np.testing.assert_array_equal(t.numpy(), j)
    assert (t[5] == -1).all() and t.shape == (256, 10)


def test_knn_graph_switches_to_the_scan_past_the_host_ceiling(monkeypatch):
    """Past ``_CPU_HOST_KNN_MAX`` rows a CPU layer's knn runs the chunked
    scan, as the JAX package's does; the graph is the same either way."""
    rng = np.random.default_rng(13)
    vecs = _int_vectors(rng, 1500, 8)
    members = np.arange(0, 1500, 2)
    host = thb._knn_graph(vecs, members, 12, "l2-squared", "cpu")
    monkeypatch.setattr(thb, "_CPU_HOST_KNN_MAX", 100)
    scan = thb._knn_graph(vecs, members, 12, "l2-squared", "cpu")
    monkeypatch.setattr(jhb, "_CPU_HOST_KNN_MAX", 100)
    np.testing.assert_array_equal(scan, jhb._knn_graph(vecs, members, 12,
                                                       "l2-squared"))
    # the host knn breaks distance ties by partition order, the scan by
    # row: compare the neighbor distances, which are exact integers here
    sub = vecs[members]
    dist = lambda nb: ((sub[:, None, :] - sub[nb]) ** 2).sum(-1)  # noqa: E731
    np.testing.assert_array_equal(dist(host), dist(scan))


def test_compress_delete_cleanup_condense(tmp_path, corpus, jax_pq):
    """Runtime PQ compression (the JAX codebook carried across), then
    inserts, deletes, cleanup, WAL replay and condense: the same codes,
    graph and answers as the JAX package."""
    t = THNSW(dim=32, max_connections=8, ef_construction=48, ef=32,
              commit_log_dir=str(tmp_path / "t"), **CPU)
    j = JHNSW(dim=32, max_connections=8, ef_construction=48, ef=32,
              commit_log_dir=str(tmp_path / "j"))
    for idx in (t, j):
        idx.add_batch(np.arange(600), corpus[:600])
        idx.compress("pq", pq_segments=8, pq_centroids=16)
    assert t.compressed
    np.testing.assert_array_equal(t._codes[:600], j._codes[:600])
    qs = corpus[1000:1008]
    _same_answers(t, j, qs)
    for idx in (t, j):
        idx.add_batch(np.arange(600, 700), corpus[600:700])
        idx.delete(*range(0, 700, 9))
    np.testing.assert_array_equal(t._codes[:t._count], j._codes[:j._count])
    _same_graph(t, j)
    _same_answers(t, j, qs)
    assert t.cleanup_tombstones() == j.cleanup_tombstones()
    _same_graph(t, j)
    for idx in (t, j):
        idx._log.close()  # a crash: replay the snapshot + the raw WAL
    tb = THNSW(dim=32, commit_log_dir=str(tmp_path / "t"), **CPU)
    jb = JHNSW(dim=32, commit_log_dir=str(tmp_path / "j"))
    _same_graph(tb, jb)
    assert tb.compressed and len(tb) == len(t)
    _same_answers(tb, jb, qs)
    tb.condense()
    assert tb._log.size() == 0
    tb.close()
    again = THNSW(dim=32, commit_log_dir=str(tmp_path / "t"), **CPU)
    _same_graph(again, jb)


def test_snapshots_cross_both_ways(corpus, jax_pq):
    for compress in (False, True):
        t = THNSW(dim=32, max_connections=8, **CPU)
        t.add_batch(np.arange(300), corpus[:300])
        t.delete(7)
        if compress:
            t.compress("pq", pq_segments=8, pq_centroids=16)
        snap = t.snapshot()
        j = JHNSW.restore(snap)
        _same_graph(j, t)
        _same_answers(t, j, corpus[1200:1205])
        back = convert.hnsw_from_jax_snapshot(j.snapshot(), **CPU)
        _same_graph(back, t)
        assert back.compressed == compress and len(back) == 299
        _same_answers(back, j, corpus[1200:1205])


def test_update_and_dim_checks(corpus):
    t = THNSW(dim=8, **CPU)
    with pytest.raises(ValueError):
        t.add(0, np.zeros(16, dtype=np.float32))
    with pytest.raises(ValueError):
        THNSW(dim=8, metric="nope", **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            THNSW(dim=8)
    u = THNSW(dim=32, **CPU)
    u.add_batch(np.arange(50), corpus[:50])
    u.add(3, corpus[40] + 0.5)
    assert len(u) == 50
    with pytest.raises(ValueError):
        u.compress("bq")


def test_build_trace_env_prints_stages(capsys, monkeypatch):
    monkeypatch.setenv("WEAVIATE_TPU_BUILD_TRACE", "1")
    rng = np.random.default_rng(14)
    sub = _int_vectors(rng, 600, 8)
    thb._device_link_layer(sub, np.arange(600), 8, 8, "l2-squared", "cpu")
    out = capsys.readouterr().out
    for stage in ("knn", "self_drop", "select1", "symmetrize", "select2"):
        assert stage in out and thb.BUILD_STAGE_SECONDS[stage] >= 0
