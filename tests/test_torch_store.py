"""Parity of the port's DeviceVectorStore / FlatIndex with the JAX
package's over the same add / delete / grow / compact sequences, and the
snapshot conversion (weaviate_tpu_torch/convert.py).

Both run on the CPU (the port with device="cpu"); ids exact on tie-free
random data, distances within rtol 2e-4 / atol 2e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.engine.flat import FlatIndex as JFlat
from weaviate_tpu.engine.store import DeviceVectorStore as JStore
from weaviate_tpu_torch.convert import flat_from_jax_snapshot, store_from_jax_snapshot
from weaviate_tpu_torch.engine.flat import FlatIndex as TFlat
from weaviate_tpu_torch.engine.store import DeviceVectorStore as TStore

RTOL, ATOL = 2e-4, 2e-3


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def _same(a, b):
    (ad, ai), (bd, bi) = a, b
    np.testing.assert_array_equal(np.asarray(bi), np.asarray(ai))
    live = np.asarray(ai) >= 0
    np.testing.assert_allclose(np.asarray(bd)[live], np.asarray(ad)[live],
                               rtol=RTOL, atol=ATOL)


def _pair(metric, selection="approx", dtype="float32", capacity=256, chunk=128):
    j = JStore(dim=16, metric=metric, capacity=capacity, chunk_size=chunk,
               selection=selection,
               dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t = TStore(dim=16, metric=metric, capacity=capacity, chunk_size=chunk,
               selection=selection, dtype=dtype, device="cpu")
    return j, t


@pytest.mark.parametrize("metric,selection,dtype", [
    ("l2-squared", "approx", "float32"),
    ("cosine", "approx", "float32"),
    ("dot", "exact", "bfloat16"),
    ("cosine", "fused", "float32"),
])
def test_store_sequence_parity(rng, metric, selection, dtype):
    j, t = _pair(metric, selection, dtype)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    for step in range(3):  # grows past the initial capacity
        v = rng.standard_normal((150, 16)).astype(np.float32)
        assert np.array_equal(j.add(v), t.add(v))
        dead = rng.choice(j.count, 20, replace=False)
        j.delete(dead)
        t.delete(dead)
        assert j.capacity == t.capacity
        assert j.live_count() == t.live_count()
        _same(j.search(q, 7), t.search(q, 7))
    upd = rng.standard_normal((4, 16)).astype(np.float32)
    j.set_at(np.array([1, 5, 9, 300]), upd)
    t.set_at(np.array([1, 5, 9, 300]), upd)
    _same(j.search(q, 7), t.search(q, 7))
    # shared filter (full masked scan) and per-query [B, C] masks
    shared = rng.random(j.capacity) < 0.5
    _same(j.search(q, 6, shared), t.search(q, 6, shared))
    per_q = rng.random((5, j.capacity)) < 0.3
    _same(j.search(q, 6, per_q), t.search(q, 6, per_q))
    assert np.array_equal(j.compact(), t.compact())
    assert j.capacity == t.capacity and j.count == t.count
    _same(j.search(q, 7), t.search(q, 7))


def test_gathered_path_parity(rng):
    j, t = _pair("l2-squared", capacity=2048, chunk=1024)
    v = rng.standard_normal((2000, 16)).astype(np.float32)
    j.add(v)
    t.add(v)
    allow = np.zeros(2048, dtype=bool)
    allow[rng.choice(2000, 60, replace=False)] = True  # <= capacity // 8
    q = rng.standard_normal((3, 16)).astype(np.float32)
    h = t.search_async(q, 10, allow)
    assert h.attrs["path"] == "gathered"
    _same(j.search(q, 10, allow), h.result())
    # k beyond the allowed rows: -1 / inf padding past the bucket
    _same(j.search(q, 200, allow), t.search(q, 200, allow))


def test_staged_rows_deleted_before_flush(rng):
    j, t = _pair("l2-squared")
    v = rng.standard_normal((10, 16)).astype(np.float32)
    j.add(v)
    t.add(v)
    j.delete([2, 3])
    t.delete([2, 3])
    assert t._staged_rows == 8
    q = rng.standard_normal((2, 16)).astype(np.float32)
    _same(j.search(q, 10), t.search(q, 10))
    assert not t._valid_np[[2, 3]].any()


def test_store_snapshot_converts(rng):
    for metric, dtype in (("cosine", "float32"), ("l2-squared", "bfloat16")):
        j, _ = _pair(metric, dtype=dtype)
        j.add(rng.standard_normal((300, 16)).astype(np.float32))
        j.delete(np.arange(0, 300, 7))
        snap = j.snapshot()
        t = store_from_jax_snapshot(snap, device="cpu")
        assert t.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        assert (t.count, t.capacity, t.live_count()) == (j.count, j.capacity, j.live_count())
        q = rng.standard_normal((4, 16)).astype(np.float32)
        _same(j.search(q, 9), t.search(q, 9))
        back = t.snapshot()
        assert np.array_equal(back["valid"], snap["valid"])
        np.testing.assert_array_equal(back["vectors"], snap["vectors"])


def test_flat_index_parity_and_conversion(rng):
    kw = dict(dim=16, metric="cosine", capacity=128, chunk_size=128)
    j, t = JFlat(**kw), TFlat(device="cpu", **kw)
    ids = rng.permutation(10_000)[:400]
    v = rng.standard_normal((400, 16)).astype(np.float32)
    j.add_batch(ids, v)
    t.add_batch(ids, v)
    j.delete(*ids[:40].tolist())
    t.delete(*ids[:40].tolist())
    q = rng.standard_normal((4, 16)).astype(np.float32)
    for allow in (None, ids[100:300], [ids[50:60], None, ids[:200], ids[300:]]):
        a = j.search_by_vector_batch(q, 8, allow)
        b = t.search_by_vector_batch(q, 8, allow)
        c = t.search_by_vector_batch_async(q, 8, allow).result()
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(c[0], a[0])
        np.testing.assert_allclose(b[1], a[1], rtol=RTOL, atol=ATOL)
    a = j.search_by_vector(q[0], 5, allow_list=ids[200:260])
    b = t.search_by_vector(q[0], 5, allow_list=ids[200:260])
    np.testing.assert_array_equal(b[0], a[0])
    j.compact()
    t.compact()
    np.testing.assert_array_equal(t._slot_to_id, j._slot_to_id)
    c = flat_from_jax_snapshot(j.snapshot(), device="cpu")
    assert len(c) == len(j)
    np.testing.assert_array_equal(c.search_by_vector_batch(q, 8)[0],
                                  j.search_by_vector_batch(q, 8)[0])


def test_store_raises_without_cuda_when_device_unset():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        TStore(dim=4)


def test_unported_options_raise():
    # quantization is ported; epochs (item 3) and the mesh (item 6) are
    # not, with or without it
    with pytest.raises(NotImplementedError, match="item 3"):
        TFlat(dim=4, epoch_rows=64, device="cpu")
    with pytest.raises(NotImplementedError, match="item 3"):
        TFlat(dim=4, quantization="pq", epoch_rows=64, device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        TStore(dim=4, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        TFlat(dim=4, quantization="bq", mesh=object(), device="cpu")
    # device hybrid (item 10) is ported: the async handle resolves to the
    # sync answer, and a pure-vector row of the drain to the plain search
    from weaviate_tpu_torch.ops.bm25 import FUSION_RANKED, SparseOperand

    idx = TFlat(dim=4, device="cpu")
    rng = np.random.default_rng(3)
    idx.add_batch(np.arange(6), rng.standard_normal((6, 4)).astype(np.float32))
    q = rng.standard_normal((2, 4)).astype(np.float32)
    op = SparseOperand(
        np.array([1, 4]), idx.slots_for_doc_ids([1, 4]),
        np.array([[1.0, 2.0]], np.float32), np.array([[3.0, 4.0]], np.float32),
        np.array([0], np.int32), np.array([1.0], np.float32),
        np.array([3.5], np.float32), np.array([0.7], np.float32),
        1.2, 0.75, float(np.float32(0.25)), 0.5, FUSION_RANKED, 100)
    ids, d = idx.hybrid_batch_async(q, 3, sparse_ops=[op, None]).result()
    want_ids, want_d = idx.hybrid_batch(q, 3, sparse_ops=[op, None])
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(d, want_d)
    assert set(ids[0].tolist()) >= {1, 4}
    np.testing.assert_array_equal(ids[1], idx.search_by_vector_batch(q[1:], 3)[0][0])
