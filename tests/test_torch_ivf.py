"""The port's coarse k-means, IVF index and dynamic flat->IVF index
(``weaviate_tpu_torch/ops/kmeans.py``, ``engine/ivf.py``,
``engine/dynamic.py``) against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX function and through its
port with ``device="cpu"``. Each package's k-means and PQ training land
on other centroids (different float sums), so:

- ``kmeans_fit`` itself is held to the JAX one step by step: the same
  sample and initial centroids, the same assignments on tie-free data,
  sums within rtol 1e-5, the same reseeded points;
- IVF indexes are restored in the port from a JAX snapshot (centroids and
  codebook carried across by ``convert.ivf_from_jax_snapshot``), or, where
  an index trains inside the code under test, the port's ``kmeans_fit`` /
  ``pq_fit`` are monkeypatched to return the JAX result for the same rows
  (``jax_training``). That seam lives in these tests only.

Ids must be equal and distances within rtol 2e-4 / atol 2e-3 (the
reference's own kernel tolerance). The JAX IVF module calls
``jax.core.trace_state_clean``, which jax 0.9 no longer exports; the
``jax_ivf_shim`` fixture puts it back for the test, without editing the
JAX package.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.engine.dynamic import DynamicIndex as JDynamic
from weaviate_tpu.engine.ivf import IVFIndex as JIVF
from weaviate_tpu.ops import kmeans as jkm
from weaviate_tpu_torch import convert
from weaviate_tpu_torch.engine import ivf as tivf_mod
from weaviate_tpu_torch.engine.dynamic import DynamicIndex as TDynamic
from weaviate_tpu_torch.engine.flat import FlatIndex as TFlat
from weaviate_tpu_torch.engine.ivf import IVFIndex as TIVF
from weaviate_tpu_torch.ops import kmeans as tkm

RTOL, ATOL = 2e-4, 2e-3
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def jax_ivf_shim(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


@pytest.fixture
def jax_training(monkeypatch):
    """The port's IVF trains with the JAX package's k-means and PQ fit
    (same rows in, the JAX centroids / codebook out)."""
    from weaviate_tpu.ops import pq as jpq
    from weaviate_tpu_torch.ops import pq as tpq

    def kmeans_fit(vectors, k, iters=10, device=None, **kw):
        return jkm.kmeans_fit(vectors, k, iters=iters, **kw)

    def pq_fit(vectors, m, k=256, iters=8, device=None, **kw):
        cb = jpq.pq_fit(vectors, m=m, k=k, iters=iters, **kw)
        return convert.pq_codebook(np.asarray(cb.centroids), device=device)

    monkeypatch.setattr(tivf_mod, "kmeans_fit", kmeans_fit)
    monkeypatch.setattr(tpq, "pq_fit", pq_fit)


def _clustered(rng, n, dim, n_clusters=32):
    centers = rng.standard_normal((n_clusters, dim)) * 5.0
    assign = rng.integers(0, n_clusters, n)
    return (centers[assign] + rng.standard_normal((n, dim))).astype(np.float32)


def _same(got, want, rtol=RTOL, atol=ATOL):
    """(ids, dists) pairs from search_by_vector[_batch]: ids equal,
    distances close (MASKED / inf paddings compared as equal ids)."""
    gi, gd = (np.atleast_2d(np.asarray(a)) for a in got)
    wi, wd = (np.atleast_2d(np.asarray(a)) for a in want)
    np.testing.assert_array_equal(gi, wi)
    live = wi >= 0
    np.testing.assert_allclose(gd[live], wd[live], rtol=rtol, atol=atol)


def _recall(ann_ids, exact_ids):
    hits = sum(len(set(a.tolist()) & set(e.tolist())) for a, e in
               zip(ann_ids, exact_ids))
    return hits / exact_ids.size


def _gt10(vecs, q, k=10):
    sq = np.einsum("nd,nd->n", vecs, vecs)
    d = sq[None, :] - 2.0 * (q @ vecs.T)
    part = np.argpartition(d, k, 1)[:, :k]
    pd = np.take_along_axis(d, part, 1)
    return np.take_along_axis(part, np.argsort(pd, 1), 1)


# -- k-means -------------------------------------------------------------------

def test_kmeans_assign_accumulate_parity():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3000, 24)).astype(np.float32)
    cents = rng.standard_normal((40, 24)).astype(np.float32)
    cn = (cents * cents).sum(1)
    ja, jd, js, jc = (np.asarray(a) for a in jkm._assign_accumulate(
        jnp.asarray(x), jnp.asarray(cents), jnp.asarray(cn), 40))
    ta, td, ts, tc = (a.numpy() for a in tkm._assign_accumulate(
        torch.from_numpy(x), torch.from_numpy(cents), torch.from_numpy(cn), 40))
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tkm.kmeans_assign(x, cents, batch=700, **CPU),
                                  np.asarray(jkm.kmeans_assign(x, cents, batch=700)))


@pytest.mark.parametrize("iters,sample", [(0, 262_144), (1, 262_144),
                                          (4, 262_144), (3, 1500)])
def test_kmeans_fit_step_by_step(iters, sample):
    """The same sample and initial centroids from one seed (iters 0 returns
    them untouched, bit for bit), then Lloyd steps within rtol 1e-5."""
    rng = np.random.default_rng(1)
    x = _clustered(rng, 2500, 16, n_clusters=12)
    j = jkm.kmeans_fit(x, 12, iters=iters, sample=sample, batch=512, seed=3)
    t = tkm.kmeans_fit(x, 12, iters=iters, sample=sample, batch=512, seed=3,
                       **CPU)
    if iters == 0:
        np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_kmeans_reseed_empty_parity():
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((256, 8)).astype(np.float32)
    cents = vecs[:5].copy()
    cents[2] = 1e4  # parked far away: nothing assigns to it
    cents[4] = -1e4
    counts = np.bincount(jkm.kmeans_assign(vecs, cents),
                         minlength=5).astype(np.float32)
    assert counts[2] == 0 and counts[4] == 0
    j = np.asarray(jkm._reseed_empty(vecs, jnp.asarray(cents), counts, 64))
    t = tkm._reseed_empty(vecs, torch.from_numpy(vecs), torch.from_numpy(cents),
                          counts, 64).numpy()
    np.testing.assert_array_equal(t, j)


def test_kmeans_reseeds_empty_clusters():
    """The JAX package's case, held to its result: the reseed is
    deterministic, picks real points, revives the cluster, and a fit over
    duplicate-heavy data keeps every centroid live (the same centroids
    as the JAX fit within rtol 1e-5)."""
    rng = np.random.default_rng(42)
    vecs = rng.standard_normal((256, 8)).astype(np.float32)
    cents = vecs[:4].copy()
    cents[2] = 1e4
    counts = np.bincount(tkm.kmeans_assign(vecs, cents, **CPU),
                         minlength=4).astype(np.float32)
    assert counts[2] == 0
    out = tkm._reseed_empty(vecs, torch.from_numpy(vecs),
                            torch.from_numpy(cents), counts, 4096).numpy()
    assert (out[2][None] == vecs).all(axis=1).any()
    assert (np.bincount(tkm.kmeans_assign(vecs, out, **CPU), minlength=4) > 0).all()
    blob = np.repeat(rng.standard_normal((6, 8)).astype(np.float32), 50, 0)
    blob += 0.01 * rng.standard_normal(blob.shape).astype(np.float32)
    t = tkm.kmeans_fit(blob, k=8, iters=6, seed=0, **CPU)
    j = jkm.kmeans_fit(blob, k=8, iters=6, seed=0)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    assert (np.bincount(tkm.kmeans_assign(blob, t, **CPU), minlength=8) > 0).all()


def test_kmeans_needs_k_rows_and_a_device():
    with pytest.raises(ValueError):
        tkm.kmeans_fit(np.zeros((3, 4), np.float32), 4, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tkm.kmeans_fit(np.zeros((8, 4), np.float32), 4)


# -- IVF: restored from a JAX snapshot, then the same operations ---------------

def _filters(rng, n, b):
    shared = np.arange(0, n, 3)
    per_q = [None if r % 2 else np.flatnonzero(rng.random(n) < 0.3).astype(np.int64)
             for r in range(b)]
    return {"none": None, "shared": shared, "per_query": per_q}


@pytest.mark.parametrize("quant", [None, "pq"])
@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
def test_ivf_parity_from_snapshot(quant, metric):
    """Restored from a JAX snapshot, the port answers as the restored JAX
    index: unfiltered, shared and per-query filters; then with a live
    delta leg, after deletes, updates, compact and maintain."""
    rng = np.random.default_rng(3)
    n, d, k = 3000, 32, 10
    x = _clustered(rng, n + 300, d)
    q = _clustered(rng, 12, d)
    src = JIVF(dim=d, metric=metric, train_threshold=2000, delta_threshold=512,
               nprobe=4, quantization=quant)
    src.add_batch(np.arange(n), x[:n])
    snap = src.snapshot()
    j = JIVF.restore(snap)
    t = convert.ivf_from_jax_snapshot(snap, **CPU)
    assert t.trained and t.compressed == bool(quant)
    assert t.store.nlist == j.store.nlist and t.store.list_cap == j.store.list_cap
    filters = _filters(rng, n + 300, len(q))

    def check(stage):
        for name, allow in filters.items():
            _same(t.search_by_vector_batch(q, k, allow),
                  j.search_by_vector_batch(q, k, allow))
            _same(t.search_by_vector(q[0], k, None if name == "per_query" else allow),
                  j.search_by_vector(q[0], k, None if name == "per_query" else allow))

    check("restored")
    for idx in (j, t):  # a live delta leg (stays below the flush)
        idx.add_batch(np.arange(n, n + 300), x[n:])
    assert t.store.delta.live_count() == j.store.delta.live_count() > 0
    check("delta")
    for idx in (j, t):
        idx.delete(*range(0, n + 300, 7))
        idx.add_batch([5, n + 5], x[[11, 12]] + 0.01)  # list + delta updates
    check("delete_update")
    for idx in (j, t):
        idx.compact()
    assert t.store.rebuild_count == j.store.rebuild_count
    assert t.store.delta.live_count() == j.store.delta.live_count() == 0
    check("compact")
    for idx in (j, t):
        idx.add_batch(np.arange(n + 300, n + 340), x[:40] + 0.02)
        idx.maintain()
    assert t.store.retrain_count == j.store.retrain_count
    check("maintain")
    assert len(t) == len(j)


def test_ivf_full_probe_is_exact():
    """nprobe == nlist degenerates to the exact scan, in both packages."""
    rng = np.random.default_rng(4)
    x, q = _clustered(rng, 4000, 32), _clustered(rng, 16, 32)
    src = JIVF(dim=32, train_threshold=2000, nlist=16, nprobe=16,
               delta_threshold=512)
    src.add_batch(np.arange(4000), x)
    t = convert.ivf_from_jax_snapshot(src.snapshot(), **CPU)
    flat = TFlat(dim=32, **CPU)
    flat.add_batch(np.arange(4000), x)
    exact = flat.search_by_vector_batch(q, 5)
    ann = t.search_by_vector_batch(q, 5)
    assert _recall(ann[0], exact[0]) == 1.0
    _same(ann, exact, rtol=1e-5, atol=1e-4)
    _same(ann, src.search_by_vector_batch(q, 5))


def test_ivf_async_bitexact_vs_sync(jax_training):
    """search == search_async(...).result() bit for bit, plain and
    residual PQ, with BOTH legs live; and the answers equal the JAX ones."""
    rng = np.random.default_rng(5)
    n, d, k = 4000, 32, 10
    vecs = rng.standard_normal((n + 100, d)).astype(np.float32)
    q = rng.standard_normal((8, d)).astype(np.float32)
    for quant in (None, "pq"):
        got = []
        for cls, kw in ((TIVF, CPU), (JIVF, {})):
            ivf = cls(dim=d, train_threshold=2000, delta_threshold=512,
                      quantization=quant, **kw)
            ivf.add_batch(np.arange(n), vecs[:n])
            ivf.store.flush_delta()
            ivf.add_batch(np.arange(n, n + 100), vecs[n:])  # stays in delta
            sd, si = ivf.store.search(q, k)
            ad, ai = ivf.store.search_async(q, k).result()
            assert np.array_equal(si, ai) and np.array_equal(sd, ad), quant
            ids_a, d_a = ivf.search_by_vector_batch_async(q, k).result()
            ids_s, d_s = ivf.search_by_vector_batch(q, k)
            assert np.array_equal(ids_a, ids_s) and np.array_equal(d_a, d_s)
            got.append((ids_s, d_s))
        _same(got[0], got[1])


# -- the JAX package's IVF cases, held to the JAX result -----------------------

@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(3)
    return _clustered(rng, 6000, 32), _clustered(rng, 16, 32)


def _pair(jax_training, **kw):
    return TIVF(**kw, **CPU), JIVF(**kw)


def test_ivf_trains_at_threshold(corpus, jax_training):
    x, q = corpus
    t, j = _pair(jax_training, dim=32, train_threshold=2000, delta_threshold=512)
    for idx in (t, j):
        idx.add_batch(np.arange(1000), x[:1000])
    assert not t.trained and not j.trained
    _same(t.search_by_vector_batch(q, 10), j.search_by_vector_batch(q, 10))
    for idx in (t, j):
        idx.add_batch(np.arange(1000, 4000), x[1000:4000])
    assert t.trained and j.trained and len(t) == len(j) == 4000
    _same(t.search_by_vector_batch(q, 10), j.search_by_vector_batch(q, 10))


def test_ivf_recall_vs_exact(corpus, jax_training):
    x, q = corpus
    t, j = _pair(jax_training, dim=32, train_threshold=2000,
                 delta_threshold=512, nprobe=8)
    for idx in (t, j):
        idx.add_batch(np.arange(len(x)), x)
    flat = TFlat(dim=32, **CPU)
    flat.add_batch(np.arange(len(x)), x)
    exact_ids, _ = flat.search_by_vector_batch(q, 10)
    got = t.search_by_vector_batch(q, 10)
    assert _recall(got[0], exact_ids) >= 0.9
    _same(got, j.search_by_vector_batch(q, 10))


def test_ivf_delta_is_searchable_before_flush(corpus, jax_training):
    x, _ = corpus
    t, j = _pair(jax_training, dim=32, train_threshold=2000,
                 delta_threshold=100_000)
    for idx in (t, j):
        idx.add_batch(np.arange(3000), x[:3000])
        idx.add(99_999, x[3000])
    probe = x[3000] + 0.001
    _same(t.search_by_vector(probe, 3), j.search_by_vector(probe, 3))
    assert t.search_by_vector(probe, 1)[0][0] == 99_999


def test_ivf_delete_and_update(corpus, jax_training):
    x, _ = corpus
    t, j = _pair(jax_training, dim=32, train_threshold=1000, delta_threshold=256)
    far = (x[7] + 100.0).astype(np.float32)
    for idx in (t, j):
        idx.add_batch(np.arange(3000), x[:3000])
        idx.store.flush_delta()
        idx.delete(5)
        idx.add(7, far)
    assert 5 not in t.search_by_vector(x[5], 3)[0].tolist()
    _same(t.search_by_vector(x[5], 3), j.search_by_vector(x[5], 3))
    # the updated row lies ~100 out: both packages score it through the
    # expansion ||q||^2 - 2 q.x + ||x||^2, whose rounding is relative to
    # ||q||^2 (~3.2e5), not to the distance
    got, want = t.search_by_vector(far + 0.001, 1), j.search_by_vector(far + 0.001, 1)
    assert got[0][0] == want[0][0] == 7
    np.testing.assert_allclose(got[1], want[1], rtol=0,
                               atol=1e-6 * float(far @ far))
    assert len(t) == len(j) == 2999


def test_ivf_allow_list_and_cosine(corpus, jax_training):
    x, q = corpus
    allowed = np.arange(0, 3000, 7)
    for metric in ("l2-squared", "cosine"):
        t, j = _pair(jax_training, dim=32, metric=metric, train_threshold=1000,
                     delta_threshold=256, nprobe=16)
        for idx in (t, j):
            idx.add_batch(np.arange(3000), x[:3000])
        ids, _ = t.search_by_vector(q[0], 10, allow_list=allowed)
        assert len(ids) and all(i % 7 == 0 for i in ids.tolist())
        _same(t.search_by_vector(q[0], 10, allow_list=allowed),
              j.search_by_vector(q[0], 10, allow_list=allowed))
        _same(t.search_by_vector_batch(q, 10), j.search_by_vector_batch(q, 10))


def test_ivf_snapshots_cross_both_ways(corpus, jax_training):
    """A port snapshot restores in the JAX package and the other way
    round, answering as the index it came from."""
    x, q = corpus
    for quant in (None, "pq"):
        t = TIVF(dim=32, train_threshold=1000, delta_threshold=256,
                 quantization=quant, **CPU)
        t.add_batch(np.arange(3000), x[:3000])
        t.delete(17)
        t.add_batch(np.arange(3000, 3050), x[3000:3050])  # delta rows
        snap = t.snapshot()
        back_j = JIVF.restore(snap)
        back_t = TIVF.restore(snap, **CPU)
        assert back_j.trained and back_j.compressed == bool(quant)
        assert len(back_j) == len(back_t) == 3049
        _same(back_t.search_by_vector_batch(q, 10),
              back_j.search_by_vector_batch(q, 10))
        again = convert.ivf_from_jax_snapshot(back_j.snapshot(), **CPU)
        _same(again.search_by_vector_batch(q, 10),
              back_j.search_by_vector_batch(q, 10))


def test_ivf_pq_recall_parity(jax_training):
    rng = np.random.default_rng(42)
    n, d = 6000, 32
    centers = rng.standard_normal((64, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, 64, n)]
            + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    q = (vecs[rng.integers(0, n, 50)]
         + 0.05 * rng.standard_normal((50, d))).astype(np.float32)
    gt = _gt10(vecs, q)
    out = {}
    for quant in (None, "pq"):
        t, j = _pair(jax_training, dim=d, train_threshold=4000,
                     delta_threshold=1000, quantization=quant)
        for idx in (t, j):
            idx.add_batch(np.arange(n), vecs)
        assert t.trained and t.compressed == bool(quant)
        got = t.search_by_vector_batch(q, 10)
        _same(got, j.search_by_vector_batch(q, 10))
        out[quant] = _recall(got[0], gt)
    assert out["pq"] >= out[None] - 0.05 and out["pq"] >= 0.85, out


def test_ivf_pq_lifecycle_and_dead_candidates(jax_training):
    rng = np.random.default_rng(42)
    n, d = 5000, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    t, j = _pair(jax_training, dim=d, train_threshold=3000, delta_threshold=500,
                 quantization="pq")
    for idx in (t, j):
        idx.add_batch(np.arange(n), vecs)
    ids, dists = t.search_by_vector(vecs[123], k=3)
    assert ids[0] == 123 and dists[0] < 1e-3  # exact after rescore
    for idx in (t, j):
        idx.delete(123, 10)
        idx.add_batch([55], vecs[200][None] + 0.001)
    for probe in (123, 10, 200):
        got = t.search_by_vector(vecs[probe], k=10)
        assert probe not in (123, 10) or probe not in got[0].tolist()
        _same(got, j.search_by_vector(vecs[probe], k=10))
    allow = np.asarray([3, 4, 5], dtype=np.int64)
    got = t.search_by_vector(vecs[3], k=10, allow_list=allow)
    assert set(got[0].tolist()) <= {3, 4, 5}
    _same(got, j.search_by_vector(vecs[3], k=10, allow_list=allow))


def test_ivf_runtime_compress(jax_training):
    rng = np.random.default_rng(42)
    n, d = 5000, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    t, j = _pair(jax_training, dim=d, train_threshold=3000, delta_threshold=500)
    for idx in (t, j):
        idx.add_batch(np.arange(n), vecs)
    before = t.search_by_vector(vecs[42], k=10)[0]
    for idx in (t, j):
        idx.compress("pq")
    assert t.compressed
    got = t.search_by_vector(vecs[42], k=10)
    assert got[0][0] == 42 and got[1][0] < 1e-3
    assert len(set(before.tolist()) & set(got[0].tolist())) >= 7
    _same(got, j.search_by_vector(vecs[42], k=10))
    with pytest.raises(RuntimeError):
        t.compress("pq")


def test_ivf_recall_gate_few_lists(jax_training):
    rng = np.random.default_rng(42)
    n, d, k = 8000, 32, 10
    centers = rng.standard_normal((64, d)).astype(np.float32) * 4.0
    vecs = (centers[rng.integers(0, 64, n)]
            + 0.4 * rng.standard_normal((n, d))).astype(np.float32)
    q = (vecs[rng.integers(0, n, 64)]
         + 0.05 * rng.standard_normal((64, d))).astype(np.float32)
    t, j = _pair(jax_training, dim=d, train_threshold=4000,
                 delta_threshold=1000, nlist=64, nprobe=3)
    for idx in (t, j):
        idx.add_batch(np.arange(n), vecs)
        idx.store.flush_delta()
    h = t.store.search_async(q, k)
    assert h.attrs["lists_frac"] <= 0.05
    h.result()
    got = t.search_by_vector_batch(q, k)
    assert _recall(got[0], _gt10(vecs, q, k)) >= 0.95
    _same(got, j.search_by_vector_batch(q, k))


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
def test_ivf_filter_parity_across_metrics(metric, jax_training):
    """Full probe == exact flat for every metric x {none, shared,
    per-query} filters, before and after compaction (no rebuild), and
    equal to the JAX answers."""
    rng = np.random.default_rng(42)
    n, d, k = 2500, 24, 8
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((6, d)).astype(np.float32)
    t, j = _pair(jax_training, dim=d, metric=metric, train_threshold=1000,
                 delta_threshold=256, nlist=16, nprobe=16)
    flat = TFlat(dim=d, metric=metric, **CPU)
    for idx in (t, j, flat):
        idx.add_batch(np.arange(n), vecs)
    t.store.flush_delta()
    j.store.flush_delta()
    filters = _filters(rng, n, len(q))

    def check():
        for allow in filters.values():
            ei, _ = flat.search_by_vector_batch(q, k, allow)
            got = t.search_by_vector_batch(q, k, allow)
            for r in range(len(q)):
                assert set(got[0][r][got[0][r] >= 0].tolist()) == \
                    set(ei[r][ei[r] >= 0].tolist())
            _same(got, j.search_by_vector_batch(q, k, allow))

    check()
    for idx in (t, j, flat):
        idx.delete(*range(0, n, 5))
    rebuilds = t.store.rebuild_count
    for idx in (t, j, flat):
        idx.compact()
    assert t.store.rebuild_count == rebuilds == j.store.rebuild_count
    check()


def test_ivf_compact_no_rebuild_and_hole_reuse(jax_training):
    rng = np.random.default_rng(42)
    n, d = 3000, 16
    vecs = rng.standard_normal((n + 300, d)).astype(np.float32)
    t, j = _pair(jax_training, dim=d, train_threshold=1000, delta_threshold=256)
    for idx in (t, j):
        idx.add_batch(np.arange(n), vecs[:n])
        idx.store.flush_delta()
    built = t.store.rebuild_count
    for idx in (t, j):
        idx.delete(*range(600))
        idx.compact()
    assert t.store.rebuild_count == built == j.store.rebuild_count
    assert len(t) == n - 600
    assert t.store._holes == j.store._holes
    _same(t.search_by_vector(vecs[700], 1), j.search_by_vector(vecs[700], 1))
    for idx in (t, j):
        idx.add_batch(np.arange(n, n + 300), vecs[n:])
        idx.store.flush_delta()
    assert t.store.rebuild_count == built
    assert t.store._slot_loc == j.store._slot_loc
    assert t.search_by_vector(vecs[n + 7], 1)[0][0] == n + 7


def test_ivf_maintain_retrains_on_drift(jax_training):
    rng = np.random.default_rng(42)
    n0, d = 1200, 16
    vecs = rng.standard_normal((5 * n0, d)).astype(np.float32)
    t, j = _pair(jax_training, dim=d, train_threshold=1000, delta_threshold=256)
    for idx in (t, j):
        idx.add_batch(np.arange(n0), vecs[:n0])
    t0 = t.store.retrain_count
    for idx in (t, j):
        idx.maintain()
    assert t.store.retrain_count == t0 == j.store.retrain_count
    for idx in (t, j):
        idx.add_batch(np.arange(n0, 5 * n0), vecs[n0:])
        idx.maintain()
    assert t.store.retrain_count == t0 + 1 == j.store.retrain_count
    _same(t.search_by_vector(vecs[3], 5), j.search_by_vector(vecs[3], 5))


def test_ivf_filtered_requests_coalesce():
    """Filtered IVF searches ride ONE bitmask-batched dispatch through the
    port's QueryBatcher, with the answers of the solo path."""
    from weaviate_tpu_torch.runtime.query_batcher import QueryBatcher

    rng = np.random.default_rng(42)
    n, d, k = 1500, 16, 5
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    idx = TIVF(dim=d, train_threshold=800, delta_threshold=256, nlist=16,
               nprobe=16, **CPU)
    idx.add_batch(np.arange(n), vecs)
    idx.store.flush_delta()
    calls = []
    real = idx.search_by_vector_batch

    def counting(qs, kk, allow=None):
        calls.append({"rows": len(qs),
                      "per_query": isinstance(allow, (list, tuple))})
        return real(qs, kk, allow)

    qb = QueryBatcher(counting,
                      supports_filter_batching=lambda: idx.supports_batched_filters)
    nreq = 9
    queries = rng.standard_normal((nreq, d)).astype(np.float32)
    allows = [np.flatnonzero(rng.random(n) < 0.4).astype(np.int64)
              for _ in range(nreq)]
    gate, first = threading.Event(), threading.Event()
    inner = qb._batch_fn

    def slow_first(qs, kk, allow=None):
        if not first.is_set():
            first.set()
            gate.wait(5.0)
        return inner(qs, kk, allow)

    qb._batch_fn = slow_first
    results = [None] * nreq

    def worker(r):
        results[r] = qb.search(queries[r], k, allows[r])

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(nreq)]
    threads[0].start()
    time.sleep(0.1)
    for th in threads[1:]:
        th.start()
    time.sleep(0.3)
    gate.set()
    for th in threads:
        th.join()
    qb.stop()
    assert qb.filtered_batched >= nreq - 1, qb.filtered_batched
    coalesced = [c for c in calls if c["rows"] > 1]
    assert len(coalesced) == 1 and coalesced[0]["per_query"], calls
    for r in range(nreq):
        ids, _ = results[r]
        ref_i, _ = idx.search_by_vector_batch(queries[r][None, :], k, [allows[r]])
        got = np.asarray(ids)
        assert np.array_equal(got[got >= 0], ref_i[0][ref_i[0] >= 0]), r


def test_ivf_host_mirror_ledger_lifecycle():
    import gc

    from weaviate_tpu_torch.runtime import hbm_ledger

    rng = np.random.default_rng(42)
    n, d = 3000, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    col = "IvfMirrorTestTorch"
    with hbm_ledger.owner(collection=col, shard="s0"):
        idx = TIVF(dim=d, train_threshold=1000, delta_threshold=256,
                   quantization="pq", **CPU)
        idx.add_batch(np.arange(n), vecs)
    bd = hbm_ledger.ledger.breakdown()[col]
    assert bd["components"].get("host_mirror", 0) >= n * d * 4
    assert bd["components"].get("lists", 0) > 0
    mirror = [e for e in hbm_ledger.ledger.top(200)
              if e["collection"] == col and e["component"] == "host_mirror"]
    assert mirror and all(e["placement"] == "host" for e in mirror)
    del idx
    gc.collect()
    bd = hbm_ledger.ledger.breakdown().get(col)
    assert bd is None or bd["components"].get("host_mirror", 0) == 0


def test_ivf_refuses_what_the_jax_index_refuses():
    with pytest.raises(ValueError):
        TIVF(dim=8, metric="manhattan", **CPU)
    with pytest.raises(ValueError):
        TIVF(dim=8, quantization="bq", **CPU)
    with pytest.raises(NotImplementedError):
        TIVF(dim=8, mesh=object(), **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TIVF(dim=8)
    idx = TIVF(dim=8, **CPU)
    with pytest.raises(ValueError):
        idx.compress("bq")


# -- dynamic -------------------------------------------------------------------

def test_dynamic_answers_as_flat_below_threshold(corpus):
    x, q = corpus
    t = TDynamic(dim=32, threshold=2000, **CPU)
    j = JDynamic(dim=32, threshold=2000)
    flat = TFlat(dim=32, **CPU)
    for idx in (t, j, flat):
        idx.add_batch(np.arange(1500), x[:1500])
    assert not t.upgraded and not j.upgraded and t.index_type == "dynamic"
    got = t.search_by_vector_batch(q, 10)
    _same(got, flat.search_by_vector_batch(q, 10), rtol=0, atol=0)
    _same(got, j.search_by_vector_batch(q, 10))
    assert t.search_by_vector(x[3], 1)[0][0] == 3


@pytest.mark.parametrize("quant", [None, "pq"])
def test_dynamic_upgrade_parity(quant, jax_training):
    """The upgrade fires at the same insert as in the JAX package, and
    afterwards the answers equal the JAX ones; a restore lands in the same
    regime, in both directions."""
    rng = np.random.default_rng(42)
    n, d, k = 2600, 24, 5
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    q = np.concatenate([(vecs[7] + 0.0001)[None, :],
                        rng.standard_normal((5, d))]).astype(np.float32)
    t = TDynamic(dim=d, threshold=2000, nlist=16, nprobe=16,
                 upgrade_quantization=quant, **CPU)
    j = JDynamic(dim=d, threshold=2000, nlist=16, nprobe=16,
                 upgrade_quantization=quant)
    snaps = {}
    for s in range(0, n, 200):
        for idx in (t, j):
            idx.add_batch(np.arange(s, min(s + 200, n)), vecs[s:s + 200])
        assert t.upgraded == j.upgraded, s
        _same(t.search_by_vector_batch(q, k), j.search_by_vector_batch(q, k))
        snaps.setdefault(t.upgraded, (t.snapshot(), j.snapshot()))
    assert t.upgraded and t.compressed == bool(quant)
    assert t.supports_batched_filters
    assert t.search_by_vector_batch(q, k)[0][0][0] == 7
    for idx in (t, j):
        idx.maintain()
    _same(t.search_by_vector_batch(q, k), j.search_by_vector_batch(q, k))
    for upgraded, (ts, js) in snaps.items():
        back_t = convert.dynamic_from_jax_snapshot(js, **CPU)
        back_j = JDynamic.restore(ts)
        assert back_t.upgraded == back_j.upgraded == upgraded
        _same(back_t.search_by_vector_batch(q, k),
              JDynamic.restore(js).search_by_vector_batch(q, k))
        _same(TDynamic.restore(ts, **CPU).search_by_vector_batch(q, k),
              back_j.search_by_vector_batch(q, k))


def test_dynamic_quantized_flat_never_upgrades(corpus):
    x, _ = corpus
    t = TDynamic(dim=32, threshold=500, quantization="bq", **CPU)
    t.add_batch(np.arange(1000), x[:1000])
    assert not t.upgraded and t.compressed
    assert t.search_by_vector(x[3], 1)[0][0] == 3
