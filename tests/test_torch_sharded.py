"""Row-sharded search in the port (weaviate_tpu_torch/parallel) held to the
JAX package's on its 8 virtual CPU devices.

The port's mesh repeats one device: eight row shards on ``cpu``, each
with its own tensors and its own scan, then the real merge. The same
numpy inputs from a seed go through both packages' 1-D ``('shard',)``
and 2 x 4 ``('host', 'ici')`` meshes. Ids must be equal, distances within
rtol 2e-4 / atol 2e-3 (the reference's own kernel tolerance), and the
port's 1-D and two-level answers equal bit for bit. Ported from
tests/test_sharded_search.py, test_hierarchical.py,
test_sharded_quantized.py and the mesh and rule cases of
test_partition.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.parallel import mesh as jmesh
from weaviate_tpu.parallel import sharded_search as jss
from weaviate_tpu_torch.engine.flat import FlatIndex as TFlat
from weaviate_tpu_torch.engine.quantized import QuantizedVectorStore as TQStore
from weaviate_tpu_torch.engine.store import DeviceVectorStore as TStore
from weaviate_tpu_torch.ops import bq as tbq
from weaviate_tpu_torch.ops.topk import chunked_topk
from weaviate_tpu_torch.parallel import mesh as tmesh
from weaviate_tpu_torch.parallel import partition
from weaviate_tpu_torch.parallel import sharded_search as tss

RTOL, ATOL = 2e-4, 2e-3
CPU8 = [torch.device("cpu")] * 8

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def jax_ivf_shim(monkeypatch):
    # the JAX IVF module calls jax.core.trace_state_clean (gone in jax 0.9)
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _tmeshes():
    return (tmesh.make_mesh(devices=CPU8),
            tmesh.make_hierarchical_mesh(n_hosts=2, devices=CPU8))


def _jmeshes():
    return jmesh.make_mesh(8), jmesh.make_hierarchical_mesh(n_hosts=2)


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _bit_identical(a, b, what=""):
    np.testing.assert_array_equal(_np(a[0]), _np(b[0]),
                                  err_msg=f"{what}: distances diverge")
    np.testing.assert_array_equal(_np(a[1]), _np(b[1]),
                                  err_msg=f"{what}: ids diverge")


def _parity(port, ref, what=""):
    """Port answer vs the JAX package's: ids equal, live distances close."""
    pi, ri = _np(port[1]), _np(ref[1])
    np.testing.assert_array_equal(pi, ri, err_msg=f"{what}: ids")
    live = ri >= 0
    np.testing.assert_allclose(_np(port[0])[live], _np(ref[0])[live],
                               rtol=RTOL, atol=ATOL, err_msg=f"{what}: dists")


def _flat_case(rng, n, d, b, filtered, dead_every=5):
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    if filtered == "shared":
        valid[::dead_every] = False
    allow = (rng.random((b, n)) > 0.4) if filtered == "per_query" else None
    return x, q, valid, allow


def _port_flat(mesh, x, q, valid, allow, **kw):
    return tss.sharded_topk(
        torch.from_numpy(q), tss.shard_array(x, mesh),
        tss.shard_array(valid, mesh), None, mesh=mesh,
        allow_rows=None if allow is None else tss.shard_array(allow, mesh, dim=1),
        **kw)


def _jax_flat(mesh, x, q, valid, allow, **kw):
    return jss.sharded_topk(
        jss.replicate_array(jnp.asarray(q), mesh),
        jss.shard_array(jnp.asarray(x), mesh),
        jss.shard_array(jnp.asarray(valid), mesh), None, mesh=mesh,
        allow_rows=(None if allow is None
                    else jss.shard_array(jnp.asarray(allow), mesh, dim=1)),
        **kw)


# -- flat (test_sharded_search.py, test_hierarchical.py) ----------------------


@pytest.mark.parametrize("selection", ["approx", "exact", "fused"])
@pytest.mark.parametrize("filtered", ["none", "shared", "per_query"])
def test_flat_sharded_parity(rng, selection, filtered):
    """flat on both mesh shapes: the port's 1-D and two-level answers are
    bit for bit each other's and the JAX package's on its virtual mesh."""
    x, q, valid, allow = _flat_case(rng, 1024, 32, 4, filtered)
    kw = dict(k=10, chunk_size=128, metric="l2-squared", selection=selection)
    ports = [_port_flat(m, x, q, valid, allow, **kw) for m in _tmeshes()]
    _bit_identical(ports[0], ports[1], f"flat/{selection}/{filtered}")
    refs = [_jax_flat(m, x, q, valid, allow, **kw) for m in _jmeshes()]
    for port, ref in zip(ports, refs):
        _parity(port, ref, f"flat/{selection}/{filtered}")


def test_sharded_topk_matches_single_device(rng):
    x, q, valid, _ = _flat_case(rng, 1024, 32, 4, "shared")
    mesh = tmesh.make_mesh(8, devices=CPU8)
    d_sh, i_sh = _port_flat(mesh, x, q, valid, None, k=10, chunk_size=128,
                            metric="l2-squared")
    d_ref, i_ref = chunked_topk(torch.from_numpy(q), torch.from_numpy(x),
                                k=10, chunk_size=128,
                                valid=torch.from_numpy(valid))
    np.testing.assert_allclose(d_sh, d_ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(i_sh, i_ref)


def test_sharded_fused_selection_matches_exact(rng):
    x, q, valid, _ = _flat_case(rng, 2048, 32, 4, "shared", dead_every=7)
    mesh = tmesh.make_mesh(8, devices=CPU8)
    d_sh, i_sh = _port_flat(mesh, x, q, valid, None, k=10, chunk_size=128,
                            metric="l2-squared", selection="fused")
    d_ref, i_ref = chunked_topk(torch.from_numpy(q), torch.from_numpy(x),
                                k=10, chunk_size=128,
                                valid=torch.from_numpy(valid),
                                selection="exact")
    np.testing.assert_allclose(d_sh, d_ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(i_sh, i_ref)
    store = TStore(dim=16, capacity=256, chunk_size=32, mesh=mesh,
                   selection="fused")
    vecs = rng.standard_normal((100, 16)).astype(np.float32)
    store.add(vecs)
    dd, ii = store.search(vecs[42], k=5)
    assert ii[0] == 42 and dd[0] < 1e-3


def test_flat_two_level_parity_k_exceeds_live(rng):
    """k wider than the live pool: the +inf padding of the cross-host
    block never displaces a real or masked candidate, and dead entries
    keep id -1 (the offset touches live entries only)."""
    n, d, b, k = 256, 16, 2, 64
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = np.zeros(n, dtype=bool)
    valid[:40] = True
    kw = dict(k=k, chunk_size=32, metric="l2-squared")
    ports = [_port_flat(m, x, q, valid, None, **kw) for m in _tmeshes()]
    _bit_identical(ports[0], ports[1], "flat/k>live")
    assert (_np(ports[0][1]) >= 0).sum(axis=1).tolist() == [40, 40]
    refs = [_jax_flat(m, x, q, valid, None, **kw) for m in _jmeshes()]
    for port, ref in zip(ports, refs):
        _parity(port, ref, "flat/k>live")


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_sharded_store_metrics_parity(rng, metric):
    """DeviceVectorStore on both port meshes against the JAX store on
    its mesh: same slots, same shard boundaries, same answers."""
    from weaviate_tpu.engine.store import DeviceVectorStore as JStore

    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    qs = rng.standard_normal((5, 16)).astype(np.float32)
    allow = rng.random((5, 1024)) > 0.5
    res = []
    for tm, jm in zip(_tmeshes(), _jmeshes()):
        t = TStore(dim=16, metric=metric, capacity=64, chunk_size=32, mesh=tm)
        j = JStore(dim=16, metric=metric, capacity=64, chunk_size=32, mesh=jm)
        for s in (t, j):
            s.add(vecs)
            s.delete([3, 77, 250])
        assert t.capacity == j.capacity and t.n_shards == j.n_shards == 8
        for mask in (None, allow[:, :t.capacity]):
            _parity(t.search(qs, 7, mask), j.search(qs, 7, mask),
                    f"store/{metric}")
        res.append(t.search(qs, 7))
    _bit_identical(res[0], res[1], f"store/{metric}")


def test_sharded_store_end_to_end(rng):
    mesh = tmesh.make_mesh(8, devices=CPU8)
    store = TStore(dim=16, capacity=256, chunk_size=32, mesh=mesh)
    vecs = rng.standard_normal((100, 16)).astype(np.float32)
    store.add(vecs)
    d, i = store.search(vecs[42], k=5)
    assert i[0] == 42 and d[0] < 1e-3
    store.delete([42])
    d, i = store.search(vecs[42], k=5)
    assert i[0] != 42


def test_sharded_flat_index(rng):
    mesh = tmesh.make_mesh(8, devices=CPU8)
    idx = TFlat(dim=16, capacity=256, chunk_size=32, mesh=mesh)
    vecs = rng.standard_normal((64, 16)).astype(np.float32)
    idx.add_batch(np.arange(64) + 500, vecs)
    ids, _ = idx.search_by_vector(vecs[10], k=3)
    assert ids[0] == 510
    idx1 = TFlat(dim=16, capacity=256, chunk_size=256, device="cpu")
    idx1.add_batch(np.arange(64) + 500, vecs)
    q = rng.standard_normal(16).astype(np.float32)
    ids_a, d_a = idx.search_by_vector(q, k=8)
    ids_b, d_b = idx1.search_by_vector(q, k=8)
    assert list(ids_a) == list(ids_b)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-4, atol=1e-4)


def test_sharded_growth(rng):
    """Growth keeps the global slot order: rows that change shard move."""
    mesh = tmesh.make_mesh(8, devices=CPU8)
    store = TStore(dim=8, capacity=16, chunk_size=8, mesh=mesh)
    vecs = rng.standard_normal((200, 8)).astype(np.float32)
    store.add(vecs[:20])
    store.search(vecs[0], k=1)  # flush: the first rows reach their shards
    store.add(vecs[20:])
    d, i = store.search(vecs[150], k=1)
    assert i[0] == 150
    np.testing.assert_array_equal(store.snapshot()["vectors"][:200], vecs)


def test_device_store_on_hierarchical_mesh(rng):
    """The store serves the same answers on both meshes, and the
    ledger's host rollup sees the sharded tensors split across hosts."""
    from weaviate_tpu_torch.runtime.hbm_ledger import ledger

    vecs = rng.standard_normal((200, 16)).astype(np.float32)
    qs = vecs[[3, 77]]
    res = []
    for mesh in _tmeshes():
        store = TStore(dim=16, capacity=512, chunk_size=32, mesh=mesh)
        assert store.n_shards == 8
        store.add(vecs)
        res.append(store.search(qs, k=5))
        del store
    _bit_identical(res[0], res[1], "store e2e")
    roll = ledger.host_rollup(2)
    assert sum(roll.values()) == ledger.total_bytes()


# -- quantized (test_hierarchical.py, test_sharded_quantized.py) ---------------


def _port_q(mesh, qv, qw, codes, valid, rescore, cent, allow=None, **kw):
    return tss.sharded_quantized_topk(
        torch.from_numpy(qv), None if qw is None else torch.from_numpy(qw),
        tss.shard_array(codes, mesh), tss.shard_array(valid, mesh),
        None if rescore is None else tss.shard_array(rescore, mesh),
        None if cent is None else torch.from_numpy(cent), mesh=mesh,
        allow_rows=None if allow is None else tss.shard_array(allow, mesh, dim=1),
        **kw)


def _jax_q(mesh, qv, qw, codes, valid, rescore, cent, allow=None, **kw):
    rep = jss.replicate_array
    return jss.sharded_quantized_topk(
        rep(jnp.asarray(qv), mesh),
        None if qw is None else rep(jnp.asarray(qw), mesh),
        jss.shard_array(jnp.asarray(codes), mesh),
        jss.shard_array(jnp.asarray(valid), mesh),
        None if rescore is None else jss.shard_array(jnp.asarray(rescore), mesh),
        None if cent is None else rep(jnp.asarray(cent), mesh), mesh=mesh,
        allow_rows=(None if allow is None
                    else jss.shard_array(jnp.asarray(allow), mesh, dim=1)),
        **kw)


def _bq_codes(x):
    return tbq.bq_encode(torch.from_numpy(x)).numpy()  # int32 words


@pytest.mark.parametrize("filtered", ["none", "per_query"])
@pytest.mark.parametrize("rescore", [False, True])
def test_bq_sharded_parity(rng, filtered, rescore):
    n, dim, b, k = 1024, 128, 4, 16
    xb = rng.standard_normal((n, dim)).astype(np.float32)
    qv = rng.standard_normal((b, dim)).astype(np.float32)
    codes, qw = _bq_codes(xb), _bq_codes(qv)
    valid = np.ones(n, dtype=bool)
    valid[::9] = False
    allow = (rng.random((b, n)) > 0.3) if filtered == "per_query" else None
    resc = xb if rescore else None
    kw = dict(k=32 if rescore else k, k_out=k, chunk_size=128,
              quantization="bq", metric="l2-squared")
    ports = [_port_q(m, qv, qw, codes, valid, resc, None, allow, **kw)
             for m in _tmeshes()]
    _bit_identical(ports[0], ports[1], f"bq/{filtered}/{rescore}")
    refs = [_jax_q(m, qv, qw.view(np.uint32), codes.view(np.uint32), valid,
                   resc, None, allow, **kw) for m in _jmeshes()]
    for port, ref in zip(ports, refs):
        _parity(port, ref, f"bq/{filtered}/{rescore}")


@pytest.mark.parametrize("filtered", ["none", "per_query"])
@pytest.mark.parametrize("rescore", [False, True])
def test_pq4_sharded_parity(rng, filtered, rescore):
    from weaviate_tpu.ops import pq as jpq

    n, dim, b, k = 512, 32, 4, 12
    xb = rng.standard_normal((n, dim)).astype(np.float32)
    qv = rng.standard_normal((b, dim)).astype(np.float32)
    codebook = jpq.pq_fit(xb, m=8, k=16)  # 16 centroids = the pq4 regime
    codes = np.asarray(jpq.pq_encode(codebook, xb))
    cent = np.asarray(codebook.centroids)
    valid = np.ones(n, dtype=bool)
    allow = (rng.random((b, n)) > 0.3) if filtered == "per_query" else None
    resc = xb if rescore else None
    kw = dict(k=48 if rescore else k, k_out=k, chunk_size=128,
              quantization="pq4", metric="l2-squared")
    ports = [_port_q(m, qv, None, codes, valid, resc, cent, allow, **kw)
             for m in _tmeshes()]
    _bit_identical(ports[0], ports[1], f"pq4/{filtered}/{rescore}")
    refs = [_jax_q(m, qv, None, codes, valid, resc, cent, allow, **kw)
            for m in _jmeshes()]
    for port, ref in zip(ports, refs):
        _parity(port, ref, f"pq4/{filtered}/{rescore}")


def test_bq_compact_dcn_block_ids_match(rng):
    """The bf16 cross-host block: hamming counts at dim <= 256 are
    bf16-exact, so the compacted hop stays bit for bit."""
    flat, hier = _tmeshes()
    n, dim, b, k = 1024, 128, 4, 16
    xb = rng.standard_normal((n, dim)).astype(np.float32)
    qv = rng.standard_normal((b, dim)).astype(np.float32)
    codes, qw = _bq_codes(xb), _bq_codes(qv)
    valid = np.ones(n, dtype=bool)
    kw = dict(k=k, k_out=k, chunk_size=128, quantization="bq",
              metric="l2-squared")
    _bit_identical(
        _port_q(flat, qv, qw, codes, valid, None, None, dcn_compact=False, **kw),
        _port_q(hier, qv, qw, codes, valid, None, None, dcn_compact=True, **kw),
        "bq/compact")


def test_ivf_pq_sharded_parity(rng):
    nlist, cap, m, d, b, k = 32, 16, 8, 32, 4, 10
    cent = rng.standard_normal((nlist, d)).astype(np.float32)
    codes = rng.integers(0, 255, (nlist, cap, m)).astype(np.uint8)
    valid = rng.random((nlist, cap)) > 0.2
    slots = np.arange(nlist * cap, dtype=np.int32).reshape(nlist, cap)
    tvals = rng.standard_normal((nlist, cap)).astype(np.float32)
    pqc = rng.standard_normal((m, 256, d // m)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    ports = []
    for mesh in _tmeshes():
        sh = lambda a: tss.shard_array(a, mesh)  # noqa: E731
        ports.append(tss.sharded_ivf_pq_topk(
            torch.from_numpy(q), sh(cent), sh(codes), sh(valid), sh(slots),
            sh(tvals), torch.from_numpy(pqc), k=k, nprobe=4,
            metric="l2-squared", mesh=mesh))
    _bit_identical(ports[0], ports[1], "ivf")
    for port, mesh in zip(ports, _jmeshes()):
        sh = lambda a: jss.shard_array(jnp.asarray(a), mesh)  # noqa: E731
        ref = jss.sharded_ivf_pq_topk(
            jss.replicate_array(jnp.asarray(q), mesh), sh(cent), sh(codes),
            sh(valid), sh(slots), sh(tvals),
            jss.replicate_array(jnp.asarray(pqc), mesh), k=k, nprobe=4,
            metric="l2-squared", mesh=mesh)
        _parity(port, ref, "ivf")


def test_dcn_candidate_bytes_scale_with_hosts_not_devices():
    hier = tmesh.make_hierarchical_mesh(n_hosts=2, devices=CPU8)
    k = 32
    flat_bytes = tss.merge_dcn_candidate_bytes(hier, k, level="flat")
    two_bytes = tss.merge_dcn_candidate_bytes(hier, k, level="two_level")
    assert flat_bytes == 4 * k * 8
    assert two_bytes == k * 8
    assert tss.merge_dcn_candidate_bytes(hier, k, level="two_level",
                                         compact=True) == k * 6
    assert tss.merge_dcn_candidate_bytes(tmesh.make_mesh(devices=CPU8), k) == 0
    jhier = jmesh.make_hierarchical_mesh(n_hosts=2)
    for level in ("flat", "two_level"):
        for kk in (None, 3, 40):
            assert tss.merge_dcn_candidate_bytes(hier, k, kk, level=level) == \
                jss.merge_dcn_candidate_bytes(jhier, k, kk, level=level)


def _quantized_pair(quantization, rescore, tm, jm, **kw):
    from weaviate_tpu.engine.quantized import QuantizedVectorStore as JQStore

    t = TQStore(quantization=quantization, mesh=tm, rescore=rescore, **kw)
    j = JQStore(quantization=quantization, mesh=jm, rescore=rescore, **kw)
    return t, j


@pytest.mark.parametrize("quantization", ["bq", "pq"])
@pytest.mark.parametrize("rescore", ["host", "device"])
def test_sharded_quantized_recall_vs_exact(rng, quantization, rescore):
    """Sharded compressed scan + exact rescore against f32 brute force,
    and against the JAX mesh store on the same codebook."""
    from weaviate_tpu_torch.convert import pq_codebook

    n, d, k = 512, 64, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    q = (vecs[rng.integers(0, n, 8)]
         + 0.1 * rng.standard_normal((8, d))).astype(np.float32)
    gt = np.argsort(((q[:, None] - vecs[None]) ** 2).sum(-1), axis=1)[:, :k]
    tm, jm = tmesh.make_mesh(devices=CPU8), jmesh.make_mesh(8)
    t, j = _quantized_pair(quantization, rescore, tm, jm, dim=d, capacity=n,
                           chunk_size=32)
    if quantization == "pq":
        j.train(vecs)
        t.codebook = pq_codebook(np.asarray(j.codebook.centroids), device="cpu")
    t.add(vecs)
    j.add(vecs)
    d_t, i_t = t.search(q, k)
    _parity((d_t, i_t), j.search(q, k), f"{quantization}/{rescore}")
    rec = np.mean([len(set(i_t[r]) & set(gt[r])) / k for r in range(len(q))])
    assert rec >= 0.5, (quantization, rescore, rec)
    assert np.array_equal(i_t[:, 0], gt[:, 0])
    assert np.all(np.diff(d_t, axis=1) >= -1e-4)
    assert t.rescore_mode() == ("inline" if rescore == "device" else "post")


def test_sharded_quantized_delete_and_update(rng):
    mesh = tmesh.make_mesh(8, devices=CPU8)
    n, d = 256, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    store = TQStore(dim=d, quantization="bq", capacity=n, chunk_size=16,
                    mesh=mesh, rescore="device")
    store.add(vecs)
    _, i0 = store.search(vecs[7], k=3)
    assert i0[0] == 7
    store.delete([7])
    _, i1 = store.search(vecs[7], k=3)
    assert 7 not in i1
    store.set_at([9], vecs[7][None, :])
    d2, i2 = store.search(vecs[7], k=1)
    assert i2[0] == 9 and d2[0] < 1e-2


def test_sharded_quantized_allow_mask(rng):
    mesh = tmesh.make_mesh(8, devices=CPU8)
    n, d = 256, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    store = TQStore(dim=d, quantization="bq", capacity=n, chunk_size=16,
                    mesh=mesh, rescore="device")
    store.add(vecs)
    allow = np.zeros(n, dtype=bool)
    allow[100:120] = True
    _, ids = store.search(vecs[3], k=5, allow_mask=allow)
    assert all(100 <= i < 120 for i in ids if i >= 0)


def test_sharded_flat_index_quantized(rng):
    mesh = tmesh.make_mesh(8, devices=CPU8)
    n, d = 320, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    idx = TFlat(dim=d, mesh=mesh, quantization="bq", capacity=n,
                chunk_size=16, rescore="device")
    idx.add_batch(np.arange(n) + 1000, vecs)
    ids, _ = idx.search_by_vector(vecs[50], k=5)
    assert ids[0] == 1050
    idx.delete(1050)
    ids, _ = idx.search_by_vector(vecs[50], k=5)
    assert 1050 not in ids


def test_sharded_runtime_compress(rng):
    mesh = tmesh.make_mesh(8, devices=CPU8)
    n, d = 320, 16
    centers = rng.standard_normal((64, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, 64, n)]
            + 0.25 * rng.standard_normal((n, d))).astype(np.float32)
    idx = TFlat(dim=d, mesh=mesh, capacity=n, chunk_size=16)
    idx.add_batch(np.arange(n), vecs)
    ids_before, _ = idx.search_by_vector(vecs[33], k=10)
    idx.compress(quantization="pq", rescore="device")
    assert idx.compressed and idx.store.mesh is mesh
    ids_after, _ = idx.search_by_vector(vecs[33], k=10)
    assert ids_after[0] == 33
    assert len(set(ids_before) & set(ids_after)) >= 8


def test_sharded_quantized_codes_only(rng):
    """Codes-only residency on a mesh (rescore='none'): code-distance
    order, as the JAX store without a fetch function gives it."""
    from weaviate_tpu.engine.quantized import QuantizedVectorStore as JQStore

    n, d = 256, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    t = TQStore(dim=d, quantization="bq", capacity=n, chunk_size=16,
                mesh=tmesh.make_mesh(devices=CPU8), rescore="none")
    j = JQStore(dim=d, quantization="bq", capacity=n, chunk_size=16,
                mesh=jmesh.make_mesh(8), rescore="none")
    t.add(vecs)
    j.add(vecs)
    assert t._host_vectors is None and t.rescore_rows is None
    _parity(t.search(vecs[:4], 5), j.search(vecs[:4], 5), "codes-only")


def test_sharded_quantized_snapshot_restore(rng):
    mesh = tmesh.make_mesh(8, devices=CPU8)
    n, d = 256, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    store = TQStore(dim=d, quantization="bq", capacity=n, chunk_size=16,
                    mesh=mesh, rescore="device")
    store.add(vecs)
    store.delete([5])
    back = TQStore.restore(store.snapshot(), mesh=mesh)
    _, i0 = back.search(vecs[99], k=1)
    assert i0[0] == 99
    _, i1 = back.search(vecs[5], k=3)
    assert 5 not in i1


# -- mesh topology and rules (test_partition.py) -------------------------------


class _Arr:
    def __init__(self, shape):
        self.shape = shape


def test_hierarchical_mesh_shape_and_device_order():
    devs = [torch.device("cpu", i) for i in range(8)]
    mesh = tmesh.make_hierarchical_mesh(n_hosts=2, devices=devs)
    assert tmesh.is_hierarchical(mesh)
    assert mesh.shape == {tmesh.HOST_AXIS: 2, tmesh.ICI_AXIS: 4}
    assert tmesh.n_row_shards(mesh) == 8
    assert tmesh.host_count(mesh) == 2
    assert tmesh.host_labels(mesh) == ["host-0", "host-1"]
    assert list(mesh.devices) == devs  # rows of the mesh are hosts
    assert mesh.processes == (0,) * 8


def test_hierarchical_mesh_degenerates_single_host():
    mesh = tmesh.make_hierarchical_mesh(n_hosts=1, devices=CPU8)
    assert not tmesh.is_hierarchical(mesh)
    assert mesh.axis_names == (tmesh.SHARD_AXIS,)
    assert tmesh.n_row_shards(mesh) == 8
    assert tmesh.row_axes(mesh) == tmesh.SHARD_AXIS


def test_hierarchical_mesh_rejects_uneven_split():
    with pytest.raises(ValueError, match="split evenly"):
        tmesh.make_hierarchical_mesh(n_hosts=3, devices=CPU8)


def test_virtual_hosts_env_drives_default(monkeypatch):
    monkeypatch.setenv(tmesh.VIRTUAL_HOSTS_ENV, "2")
    mesh = tmesh.make_hierarchical_mesh(devices=CPU8)
    assert mesh.shape == {"host": 2, "ici": 4}
    assert tmesh.host_count(None) == 2  # attribution counts virtual hosts
    # one device (the CPU, or one card) keeps one buffer, as the JAX
    # server does on one chip
    assert tmesh.default_mesh("cpu") is None
    monkeypatch.setenv(tmesh.VIRTUAL_HOSTS_ENV, "1")
    assert not tmesh.is_hierarchical(tmesh.make_hierarchical_mesh(devices=CPU8))


def test_make_mesh_devices_and_count():
    mesh = tmesh.make_mesh(4, devices=CPU8)
    assert mesh.shape == {"shard": 4} and tmesh.n_row_shards(mesh) == 4
    assert tmesh.merge_device(mesh) == torch.device("cpu")
    assert tmesh.local_shards(mesh) == [0, 1, 2, 3]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh()


def test_non_mesh_raises_type_error():
    with pytest.raises(TypeError, match="Mesh"):
        TStore(dim=4, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        TQStore(dim=4, quantization="bq", mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        TFlat(dim=4, epoch_rows=64, mesh=object(), device="cpu")


def test_row_axes_resolution():
    flat = tmesh.make_mesh(devices=CPU8)
    hier = tmesh.make_hierarchical_mesh(n_hosts=2, devices=CPU8)
    assert tmesh.row_axes(flat) == "shard"
    assert tmesh.row_axes(hier) == ("host", "ici")
    assert tmesh.row_axes(None) == "shard"
    custom = tmesh.make_mesh(devices=CPU8, axis_name="rows")
    assert tmesh.row_axes(custom) == "rows"


def test_match_rules_flat_and_hierarchical_mesh():
    arrays = {"q": _Arr((4, 16)), "x": _Arr((64, 16)), "valid": _Arr((64,)),
              "x_sq_norms": _Arr((64,)), "allow_rows": _Arr((4, 64))}
    flat = tmesh.make_mesh(devices=CPU8)
    hier = tmesh.make_hierarchical_mesh(n_hosts=2, devices=CPU8)
    specs = partition.match_partition_rules(partition.SEARCH_RULES, arrays, flat)
    assert specs == {"q": (), "x": ("shard",), "valid": ("shard",),
                     "x_sq_norms": ("shard",), "allow_rows": (None, "shard")}
    specs = partition.match_partition_rules(partition.SEARCH_RULES, arrays, hier)
    assert specs["x"] == (("host", "ici"),)
    assert specs["allow_rows"] == (None, ("host", "ici"))


def test_match_rules_precedence_first_wins():
    rules = ((r"^x", partition.REPLICATED), (r"^x$", partition.ROW_SHARDED))
    out = partition.match_partition_rules(
        rules, {"x": _Arr((8, 2))}, tmesh.make_mesh(devices=CPU8))
    assert out["x"] == ()


def test_match_rules_scalar_and_none_passthrough():
    out = partition.match_partition_rules(
        partition.SEARCH_RULES, {"x_sq_norms": None, "zz": _Arr(()),
                                 "yy": _Arr((1,))},
        tmesh.make_mesh(devices=CPU8))
    assert out == {"x_sq_norms": (), "zz": (), "yy": ()}


def test_match_rules_no_rule_found_raises():
    with pytest.raises(ValueError, match="no partition rule"):
        partition.match_partition_rules(
            partition.SEARCH_RULES, {"mystery": _Arr((64, 4))},
            tmesh.make_mesh(devices=CPU8))


def test_quantized_and_ivf_tables_disagree_on_centroids():
    mesh = tmesh.make_mesh(devices=CPU8)
    c = {"centroids": _Arr((32, 16))}
    assert partition.match_partition_rules(
        partition.QUANTIZED_RULES, c, mesh)["centroids"] == ()
    assert partition.match_partition_rules(
        partition.IVF_RULES, c, mesh)["centroids"] == ("shard",)


def test_row_spec_dim_placement():
    hier = tmesh.make_hierarchical_mesh(n_hosts=2, devices=CPU8)
    assert partition.row_spec(hier, 0) == (("host", "ici"),)
    assert partition.row_spec(hier, 1) == (None, ("host", "ici"))
    assert partition.sharded_dim(partition.row_spec(hier, 1)) == 1
    assert partition.sharded_dim(()) is None


def test_placed_operand_must_match_its_rule():
    mesh = tmesh.make_mesh(devices=CPU8)
    x = np.zeros((64, 4), np.float32)
    with pytest.raises(ValueError, match="row-sharded on dim 0"):
        tss.sharded_topk(torch.zeros((1, 4)), x, None, None, k=1,
                         chunk_size=8, metric="l2-squared", mesh=mesh)


def test_plan_corpus_placement_matches_jax():
    from weaviate_tpu.parallel import partition as jpart

    for n_rows, quant, mesh_pair in (
            (1_000_000_000, "bq", (tmesh.make_hierarchical_mesh(n_hosts=2, devices=CPU8),
                                   jmesh.make_hierarchical_mesh(n_hosts=2))),
            (1000, "none", (None, None))):
        t = partition.plan_corpus_placement(n_rows, 768, mesh_pair[0],
                                            quantization=quant)
        j = jpart.plan_corpus_placement(n_rows, 768, mesh_pair[1],
                                        quantization=quant)
        assert t == j
        assert sum(t["perHostBytes"].values()) == t["totalBytes"]


def test_ledger_host_rollup_sums_to_total():
    from weaviate_tpu_torch.runtime.hbm_ledger import ledger

    mesh = tmesh.make_hierarchical_mesh(n_hosts=2, devices=CPU8)
    keep = tss.tracked_shard_array(np.ones((16, 64), bool), mesh, dim=1,
                                   component="allow_mask")
    roll = ledger.host_rollup(2)
    assert sum(roll.values()) == ledger.total_bytes()
    assert keep.nbytes == 16 * 64
