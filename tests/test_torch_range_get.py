"""Row fetch and range search of the port's flat path held to the JAX
package: ``DeviceVectorStore.get`` (directly and through
``EpochStore.get`` on flat epochs), ``DeviceVectorStore.search_by_distance``,
``FlatIndex.search_by_vector_distance`` (one buffer and epochs, with and
without an allow list) and ``ops.single_distance``.

Both packages run on the CPU (the port with device="cpu"); ids exact,
distances within rtol 2e-4 / atol 2e-3 (tests/test_pallas_kernels.py's
tolerance). Range thresholds sit in the middle of a wide gap between two
exact distances, so no row lies within rounding of the threshold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.engine.epochs import EpochStore as JEpochs
from weaviate_tpu.engine.flat import FlatIndex as JFlat
from weaviate_tpu.engine.store import DeviceVectorStore as JStore
from weaviate_tpu.ops import single_distance as j_single_distance
from weaviate_tpu_torch.engine.epochs import EpochStore as TEpochs
from weaviate_tpu_torch.engine.flat import FlatIndex as TFlat
from weaviate_tpu_torch.engine.store import DeviceVectorStore as TStore
from weaviate_tpu_torch.ops import single_distance
from weaviate_tpu_torch.parallel.mesh import make_mesh

RTOL, ATOL = 2e-4, 2e-3
DIM = 16


@pytest.fixture
def rng():
    return np.random.default_rng(19)


def _exact(metric, q, rows):
    q = q.astype(np.float64)
    x = rows.astype(np.float64)
    if metric == "l2-squared":
        return ((x - q) ** 2).sum(-1)
    if metric == "dot":
        return -(x @ q)
    qn = q / np.linalg.norm(q)
    xn = x / np.linalg.norm(x, axis=-1, keepdims=True)
    return 1.0 - xn @ qn


def _threshold(dists, want: int) -> float:
    """A threshold near the ``want``-th smallest distance, in the middle
    of the widest gap around it."""
    s = np.sort(dists)
    lo, hi = max(want - 8, 1), min(want + 8, len(s) - 1)
    gaps = s[lo:hi] - s[lo - 1:hi - 1]
    at = lo + int(np.argmax(gaps))
    assert s[at] - s[at - 1] > 1e-3, "no gap wide enough for a tie-free threshold"
    return float((s[at] + s[at - 1]) / 2)


def _same_range(a, b):
    (ad, ai), (bd, bi) = a, b
    np.testing.assert_array_equal(np.asarray(bi), np.asarray(ai))
    np.testing.assert_allclose(np.asarray(bd), np.asarray(ad), rtol=RTOL, atol=ATOL)


def test_epoch_store_get_on_flat_epochs():
    """The fault this slice repairs: EpochStore.get on flat epochs called
    a DeviceVectorStore.get the port did not have (AttributeError)."""
    rows = np.random.default_rng(0).standard_normal((100, 8)).astype(np.float32)
    t = TEpochs(8, epoch_rows=64, device="cpu")
    j = JEpochs(8, epoch_rows=64)
    t.add(rows)
    j.add(rows)
    got = t.get([0, 1, 70])
    assert got.dtype == np.float32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, j.get([0, 1, 70]))
    np.testing.assert_array_equal(got, rows[[0, 1, 70]])


@pytest.mark.parametrize("metric", ["l2-squared", "cosine"])
def test_epoch_store_get_after_deletes_and_compaction(rng, metric):
    rows = rng.standard_normal((300, DIM)).astype(np.float32)
    t = TEpochs(DIM, metric=metric, epoch_rows=64, device="cpu")
    j = JEpochs(DIM, metric=metric, epoch_rows=64)
    t.add(rows)
    j.add(rows)
    dead = rng.choice(192, 40, replace=False)
    t.delete(dead)
    j.delete(dead)
    t.compact()
    j.compact()
    live = np.setdiff1d(np.arange(300), dead)
    pick = rng.choice(live, 25, replace=False)
    np.testing.assert_allclose(t.get(pick), j.get(pick), rtol=1e-6, atol=1e-7)
    if metric == "l2-squared":
        np.testing.assert_array_equal(t.get(pick), rows[pick])


@pytest.mark.parametrize("metric,dtype", [
    ("l2-squared", "float32"),
    ("cosine", "float32"),
    ("dot", "bfloat16"),
])
def test_store_get_parity(rng, metric, dtype):
    """Rows read back as stored (normalized for cosine, bf16-rounded),
    including rows still host-staged when get() is called."""
    j = JStore(dim=DIM, metric=metric, capacity=128, chunk_size=64,
               dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t = TStore(dim=DIM, metric=metric, capacity=128, chunk_size=64,
               dtype=dtype, device="cpu")
    v = rng.standard_normal((200, DIM)).astype(np.float32)
    j.add(v)
    t.add(v)
    assert t._staged_rows > 0  # the read must flush them first
    slots = np.array([0, 3, 127, 128, 199])
    got = t.get(slots)
    assert got.dtype == np.float32 and got.shape == (5, DIM)
    np.testing.assert_allclose(got, j.get(slots), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(t.get(7), t.get([7]))  # a scalar slot is one row
    upd = rng.standard_normal((2, DIM)).astype(np.float32)
    j.set_at(np.array([3, 199]), upd)
    t.set_at(np.array([3, 199]), upd)
    np.testing.assert_allclose(t.get(slots), j.get(slots), rtol=1e-6, atol=1e-7)


def test_store_get_on_a_mesh(rng):
    """On a row-sharded store each row comes from the shard that owns it."""
    mesh = make_mesh(devices=[torch.device("cpu")] * 4)
    t = TStore(dim=DIM, capacity=256, chunk_size=32, mesh=mesh)
    one = TStore(dim=DIM, capacity=256, chunk_size=32, device="cpu")
    v = rng.standard_normal((250, DIM)).astype(np.float32)
    t.add(v)
    one.add(v)
    slots = np.array([249, 0, 64, 65, 130, 200])
    np.testing.assert_array_equal(t.get(slots), one.get(slots))
    np.testing.assert_array_equal(t.get(slots), v[slots])


@pytest.mark.parametrize("metric,selection,want,filtered", [
    ("l2-squared", "approx", 5, False),
    ("l2-squared", "approx", 150, False),    # widens 64 -> 256
    ("cosine", "fused", 40, False),
    ("cosine", "approx", 300, True),         # widens to capacity, filtered
    ("dot", "exact", 90, True),
])
def test_store_search_by_distance_parity(rng, metric, selection, want, filtered):
    j = JStore(dim=DIM, metric=metric, capacity=512, chunk_size=128,
               selection=selection)
    t = TStore(dim=DIM, metric=metric, capacity=512, chunk_size=128,
               selection=selection, device="cpu")
    v = rng.standard_normal((480, DIM)).astype(np.float32)
    j.add(v)
    t.add(v)
    dead = rng.choice(480, 30, replace=False)
    j.delete(dead)
    t.delete(dead)
    q = rng.standard_normal(DIM).astype(np.float32)
    allow = None
    live = np.ones(480, bool)
    live[dead] = False
    if filtered:
        allow = np.zeros(j.capacity, bool)
        allow[:480] = rng.random(480) < 0.8
        live &= allow[:480]
    exact = _exact(metric, q, v)
    thr = _threshold(exact[live], want)
    got = t.search_by_distance(q, thr, allow)
    _same_range(j.search_by_distance(q, thr, allow), got)
    d, i = got
    assert set(i.tolist()) == set(np.nonzero(live & (exact <= thr))[0].tolist())
    assert np.all(np.diff(d) >= 0)


def test_store_search_by_distance_beyond_everything(rng):
    """A threshold past every row returns every live row (the loop stops
    at the live count, not at capacity)."""
    t = TStore(dim=4, capacity=32, chunk_size=32, device="cpu")
    base = np.zeros((1, 4), dtype=np.float32)
    near = np.full((3, 4), 0.1, dtype=np.float32)
    far = np.full((3, 4), 10.0, dtype=np.float32)
    t.add(np.concatenate([base, near, far]))
    d, i = t.search_by_distance(np.zeros(4, dtype=np.float32), max_distance=1.0)
    assert set(i.tolist()) == {0, 1, 2, 3}
    d, i = t.search_by_distance(np.zeros(4, dtype=np.float32), max_distance=1e9)
    assert sorted(i.tolist()) == list(range(7))


@pytest.mark.parametrize("epoch_rows", [0, 64])
@pytest.mark.parametrize("allow", [None, "ids", "mask"])
def test_flat_search_by_vector_distance_parity(rng, epoch_rows, allow):
    j = JFlat(dim=DIM, metric="cosine", capacity=128, chunk_size=64,
              epoch_rows=epoch_rows)
    t = TFlat(dim=DIM, metric="cosine", capacity=128, chunk_size=64,
              epoch_rows=epoch_rows, device="cpu")
    v = rng.standard_normal((300, DIM)).astype(np.float32)
    ids = np.arange(300) * 3 + 7  # sparse external ids
    j.add_batch(ids, v)
    t.add_batch(ids, v)
    gone = ids[rng.choice(300, 25, replace=False)]
    j.delete(*gone)
    t.delete(*gone)
    q = rng.standard_normal(DIM).astype(np.float32)
    keep = ~np.isin(ids, gone)
    allow_list = None
    if allow == "ids":
        allow_list = ids[rng.random(300) < 0.6]
        keep &= np.isin(ids, allow_list)
    elif allow == "mask":
        allow_list = np.zeros(ids.max() + 1, bool)
        allow_list[ids[rng.random(300) < 0.6]] = True
        keep &= allow_list[ids]
    exact = _exact("cosine", q, v)
    thr = _threshold(exact[keep], 120)
    got = t.search_by_vector_distance(q, thr, allow_list)
    want = j.search_by_vector_distance(q, thr, allow_list)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    assert set(got[0].tolist()) == set(ids[keep & (exact <= thr)].tolist())


def test_flat_range_search():
    """tests/test_flat_index.py's range case on the port."""
    idx = TFlat(dim=4, capacity=32, chunk_size=32, device="cpu")
    idx.add_batch([1, 2, 3], np.asarray(
        [[0, 0, 0, 0], [0.1, 0, 0, 0], [5, 5, 5, 5]], dtype=np.float32))
    ids, dists = idx.search_by_vector_distance(np.zeros(4, np.float32), 1.0)
    assert set(ids.tolist()) == {1, 2}


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine", "hamming", "manhattan"])
def test_single_distance_parity(rng, metric):
    a = rng.standard_normal(DIM).astype(np.float32)
    b = rng.standard_normal(DIM).astype(np.float32)
    if metric == "hamming":
        b[:5] = a[:5]
    if metric == "cosine":
        # the JAX function takes rows normalized at insert for cosine
        a /= np.linalg.norm(a)
        b /= np.linalg.norm(b)
    got = single_distance(torch.from_numpy(a), torch.from_numpy(b), metric=metric)
    assert got.shape == () and got.dtype == torch.float32
    want = float(j_single_distance(jnp.asarray(a), jnp.asarray(b), metric=metric))
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)
    # numpy operands too, as the JAX function takes them
    np.testing.assert_allclose(float(single_distance(a, b, metric)), want,
                               rtol=RTOL, atol=ATOL)
