"""The port's epoch store (``weaviate_tpu_torch/engine/epochs.py``) and the
paths above it, against the JAX package.

Every case runs the same seeded numpy inputs through the JAX
``EpochStore`` / ``FlatIndex`` / ``Database`` and through the port's on
the CPU (``device="cpu"``: the kernel wrappers take their plain versions).
Two holds:

- the port's epoch answer against the port's own single buffer: ids
  equal, distances within rtol 1e-6 (on the CPU the BLAS blocking can
  move the last bit between shapes; on the card ``chip_smoke.py`` phase 10
  holds them bit for bit);
- the port against the JAX package: ids equal on tie-free data, distances
  within rtol 2e-4 / atol 2e-3 (the reference's own kernel tolerance,
  ``tests/test_pallas_kernels.py:32``).

Collection-level cases (migration, crash points, the quota rescue) run one
scenario through each package's ``Database`` and compare what a client
sees; the cross-node half of migration runs the JAX package's cases
through the port with a remote shard client double.
"""

import os
import tempfile
import threading
import time
import uuid as uuid_mod

import numpy as np
import pytest

from weaviate_tpu.engine.epochs import EpochStore as JEpochStore
from weaviate_tpu.engine.flat import FlatIndex as JFlatIndex
from weaviate_tpu.engine.quantized import QuantizedVectorStore as JQStore
from weaviate_tpu.engine.store import DeviceVectorStore as JStore
from weaviate_tpu_torch import convert
from weaviate_tpu_torch.engine.epochs import EpochStore as TEpochStore
from weaviate_tpu_torch.engine.flat import FlatIndex as TFlatIndex
from weaviate_tpu_torch.engine.quantized import QuantizedVectorStore as TQStore
from weaviate_tpu_torch.engine.store import DeviceVectorStore as TStore

RTOL, ATOL = 2e-4, 2e-3   # port vs JAX
SELF_RTOL = 1e-6          # port epochs vs the port's own single buffer
CPU = dict(device="cpu")


def _same(got, want, rtol=RTOL, atol=ATOL):
    gd, gi = (np.atleast_2d(np.asarray(a)) for a in got)
    wd, wi = (np.atleast_2d(np.asarray(a)) for a in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=rtol, atol=atol)


def _self_same(got, want):
    _same(got, want, rtol=SELF_RTOL, atol=0)


def _uuids_for_shard(sharding, name, n, seed=0):
    """Deterministic uuids that all ring-route to ``name``."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        u = str(uuid_mod.UUID(int=int(rng.integers(0, 2 ** 63))))
        if sharding.shard_for(u) == name:
            out.append(u)
    return out


# -- the store satellites: a delete of a host-staged row ---------------------

def test_delete_staged_row_tombstones_without_flush(rng):
    """delete() of a row still host-staged scrubs it from the staging
    buffer (no device flush), in both packages alike."""
    vecs = rng.standard_normal((30, 8)).astype(np.float32)
    out = []
    for store in (JStore(dim=8), TStore(dim=8, **CPU)):
        slots = store.add(vecs)
        assert store._staged_rows == 30
        store.delete(slots[:10])
        assert store._staged_rows == 20
        assert store.live_count() == 20
        d, i = store.search(vecs[3], k=1)
        assert i[0] != slots[3]
        d, i = store.search(vecs[15], k=1)
        assert i[0] == slots[15]
        out.append(store.search(vecs, k=3))
    _same(out[1], out[0])


def test_interleaved_add_delete_flush_agree(rng):
    """Deletes before, between and after flushes: live_count and answers
    agree with a host model and with the JAX store."""
    vecs = rng.standard_normal((60, 8)).astype(np.float32)
    answers = []
    for store in (JStore(dim=8), TStore(dim=8, **CPU)):
        live = set()
        s1 = store.add(vecs[:20])
        live |= set(s1.tolist())
        store.delete(s1[:5])
        live -= set(s1[:5].tolist())
        store.flush_staged()
        s2 = store.add(vecs[20:40])
        live |= set(s2.tolist())
        store.delete([s1[7], s2[3]])
        live -= {int(s1[7]), int(s2[3])}
        s3 = store.add(vecs[40:])
        live |= set(s3.tolist())
        store.delete(s3[-2:])
        live -= set(s3[-2:].tolist())
        assert store.live_count() == len(live)
        d, i = store.search(vecs, k=1)
        for row, slot in enumerate(i[:, 0].tolist()):
            if row in live:
                assert slot == row and d[row, 0] < 1e-3
            else:
                assert slot != row
        os.environ["WEAVIATE_TPU_DEBUG_COUNTS"] = "1"
        try:
            assert store.live_count() == len(live)
        finally:
            os.environ.pop("WEAVIATE_TPU_DEBUG_COUNTS")
        answers.append((d, i))
    _same(answers[1], answers[0])


# -- epoch-stack parity --------------------------------------------------------

def _flat_mask(kind):
    if kind == "shared":
        allow = np.zeros(64, dtype=bool)
        allow[[1, 2, 14, 18, 30, 33, 45, 48]] = True
        return allow
    if kind == "per_query":
        allow = np.zeros((4, 64), dtype=bool)
        allow[0, [1, 2, 20]] = True
        allow[1, :] = True
        allow[2, [33, 34, 48]] = True
        allow[3, [5, 6, 40, 41]] = True
        return allow
    return None


@pytest.mark.parametrize("selection", ["exact", "approx", "fused"])
@pytest.mark.parametrize("mask_kind", [None, "shared", "per_query"])
def test_epoch_parity_flat(rng, selection, mask_kind):
    """The same corpus split across >= 3 epochs with tombstones between
    them answers as one buffer, and as the JAX epoch store."""
    dim = 16
    te = TEpochStore(dim=dim, epoch_rows=16, capacity=16, chunk_size=16,
                     selection=selection, **CPU)
    tb = TStore(dim=dim, capacity=64, chunk_size=64, selection=selection, **CPU)
    je = JEpochStore(dim=dim, epoch_rows=16, capacity=16, chunk_size=16,
                     selection=selection)
    vecs = rng.standard_normal((50, dim)).astype(np.float32)
    for lo in range(0, 50, 10):
        slots = [s.add(vecs[lo:lo + 10]) for s in (te, tb, je)]
        assert (slots[0] == slots[1]).all() and (slots[0] == slots[2]).all()
        if lo:
            for s in (te, tb, je):
                s.delete([lo - 3])
    assert te.epoch_count >= 3 and te.epoch_count == je.epoch_count
    q = rng.standard_normal((4, dim)).astype(np.float32)
    allow = _flat_mask(mask_kind)
    got = te.search(q, k=6, allow_mask=allow)
    _self_same(got, tb.search(q, k=6, allow_mask=allow))
    _same(got, je.search(q, k=6, allow_mask=allow))


@pytest.mark.parametrize("mask_kind", [None, "per_query"])
@pytest.mark.parametrize("quant", ["bq", "pq4"])
def test_epoch_parity_quantized(rng, quant, mask_kind):
    """Quantized twins: a 3-epoch stack against the single store, one
    codebook (the JAX store's, carried by convert.pq_codebook), one host
    rescore after the merge on the device."""
    dim = 32
    vecs = rng.standard_normal((60, dim)).astype(np.float32)
    if quant == "bq":
        jb = JQStore(dim=dim, quantization="bq", capacity=64, chunk_size=64)
        je = JEpochStore(dim=dim, epoch_rows=16, capacity=16, chunk_size=16,
                         quantization="bq")
        tb = TQStore(dim=dim, quantization="bq", capacity=64, chunk_size=64,
                     **CPU)
        te = TEpochStore(dim=dim, epoch_rows=16, capacity=16, chunk_size=16,
                         quantization="bq", **CPU)
        jb.add(vecs)
        tb.add(vecs)
    else:
        jb = JQStore(dim=dim, quantization="pq", pq_centroids=16, capacity=64,
                     chunk_size=64)
        jb.add(vecs)
        jb.train(vecs)
        cb = convert.pq_codebook(np.asarray(jb.codebook.centroids), "cpu")
        je = JEpochStore(dim=dim, epoch_rows=16, capacity=16, chunk_size=16,
                         quantization="pq",
                         quant_kwargs=dict(pq_centroids=16, codebook=jb.codebook))
        tb = TQStore(dim=dim, quantization="pq", pq_centroids=16, capacity=64,
                     chunk_size=64, codebook=cb, **CPU)
        te = TEpochStore(dim=dim, epoch_rows=16, capacity=16, chunk_size=16,
                         quantization="pq",
                         quant_kwargs=dict(pq_centroids=16, codebook=cb), **CPU)
        tb.add(vecs)
    je.add(vecs)
    te.add(vecs)
    for s in (je, jb, te, tb):
        s.delete([4, 17, 33, 50])
    assert te.epoch_count >= 3
    q = rng.standard_normal((3, dim)).astype(np.float32)
    allow = None
    if mask_kind == "per_query":
        allow = np.zeros((3, 64), dtype=bool)
        allow[0, [1, 2, 18, 19, 40]] = True
        allow[1, :] = True
        allow[2, [33, 34, 48, 55]] = True
    got = te.search(q, k=5, allow_mask=allow)
    _self_same(got, tb.search(q, k=5, allow_mask=allow))
    _same(got, je.search(q, k=5, allow_mask=allow))
    _same(got, jb.search(q, k=5, allow_mask=allow))


@pytest.mark.parametrize("quant", ["bq", "pq4"])
def test_quantized_epochs_take_the_stacks_reduce_factor(quant):
    """On the scan-reduce path (the card's; here its plain versions) a
    store keeps one winner per reduce_l rows, a factor taken from its
    capacity. The port's epochs all take the WHOLE stack's factor, so the
    stack answers exactly as one buffer of the same rows (a deliberate
    difference: the JAX package's epochs take their own, ROADMAP Queue 3).
    The stack also restores from the JAX epoch store's snapshot."""
    from weaviate_tpu_torch.ops.bq import _auto_reduce_l

    rng = np.random.default_rng(21)
    dim, n, er = 32, 65536, 16384
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    assert _auto_reduce_l(er) < _auto_reduce_l(n)
    kw = dict(quantization="bq") if quant == "bq" else dict(quantization="pq")
    cb = None
    if quant == "pq4":
        jb = JQStore(dim=dim, quantization="pq", pq_centroids=16, capacity=4096)
        jb.train(vecs[:4096])
        cb = convert.pq_codebook(np.asarray(jb.codebook.centroids), "cpu")
    tb = TQStore(dim=dim, capacity=n, chunk_size=er, codebook=cb, **kw, **CPU)
    te = TEpochStore(dim=dim, epoch_rows=er, capacity=er, chunk_size=er,
                     quant_kwargs=dict(codebook=cb) if cb else None, **kw, **CPU)
    je = JEpochStore(dim=dim, epoch_rows=er, capacity=er, chunk_size=er,
                     quant_kwargs=dict(codebook=jb.codebook) if cb else None, **kw)
    for s in (tb, te, je):
        s.add(vecs)
        s.delete(np.arange(0, n, 7))
    stores = [tb] + [ep.store for ep in te.epochs]
    tj = convert.epoch_store_from_jax_snapshot(je.snapshot(), device="cpu")
    stores += [ep.store for ep in tj.epochs]
    for st in stores:
        st.use_pallas = True
    q = rng.standard_normal((6, dim)).astype(np.float32)
    want = tb.search(q, k=10)
    got = te.search(q, k=10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    restored = tj.search(q, k=10)
    np.testing.assert_array_equal(restored[1], want[1])
    np.testing.assert_array_equal(restored[0], want[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compaction_keeps_cosine_rows_bit_for_bit(rng, dtype):
    """A compaction writes the live rows back as they are: a compacted
    epoch answers bit for bit as before (the card's phase 10 holds that
    at 1M rows). The JAX store normalizes its rows again there, which can
    move a cosine row's last bit — a deliberate difference (ROADMAP
    Queue 3); the rows stay within the reference's tolerance of it."""
    v = rng.standard_normal((4000, 64)).astype(np.float32)
    rows = {}
    for name, s in (("torch", TStore(dim=64, metric="cosine", capacity=4096,
                                     chunk_size=4096, dtype=dtype, **CPU)),
                    ("jax", JStore(dim=64, metric="cosine", capacity=4096,
                                   chunk_size=4096, dtype=dtype))):
        s.add(v)
        s.flush_staged()
        before = np.asarray(s.vectors.float() if name == "torch" else s.vectors,
                            np.float32)[1:4000:2].copy()
        s.delete(np.arange(0, 4000, 2))
        mapping = s.compact()
        assert (mapping[1:4000:2] == np.arange(2000)).all()
        after = np.asarray(s.vectors.float() if name == "torch" else s.vectors,
                           np.float32)[:2000]
        rows[name] = (before, after)
    np.testing.assert_array_equal(rows["torch"][1], rows["torch"][0])
    np.testing.assert_allclose(rows["torch"][1], rows["jax"][1], rtol=RTOL, atol=ATOL)


def test_epoch_parity_survives_compaction(rng):
    """Compacting tombstone-heavy epochs repacks their rows, but the
    global slot ids, and so the answers, stay."""
    dim = 16
    te = TEpochStore(dim=dim, epoch_rows=16, capacity=16, chunk_size=16, **CPU)
    tb = TStore(dim=dim, capacity=64, chunk_size=64, **CPU)
    je = JEpochStore(dim=dim, epoch_rows=16, capacity=16, chunk_size=16)
    vecs = rng.standard_normal((48, dim)).astype(np.float32)
    dead = [1, 3, 5, 7, 9, 20, 22, 24]
    for s in (te, tb, je):
        s.add(vecs)
        s.delete(dead)
    assert te.maintain() and je.maintain()
    assert te.compactions_total == je.compactions_total >= 1
    assert [s["capacity"] for s in te.epoch_stats()] == \
        [s["capacity"] for s in je.epoch_stats()]
    q = rng.standard_normal((3, dim)).astype(np.float32)
    got = te.search(q, k=8)
    _self_same(got, tb.search(q, k=8))
    _same(got, je.search(q, k=8))
    # filters on the compacted epochs: per-query rows and one shared mask
    per_query = np.random.default_rng(4).random((3, 64)) < 0.5
    for allow in (per_query, per_query[0]):
        got = te.search(q, k=5, allow_mask=allow)
        _self_same(got, tb.search(q, k=5, allow_mask=allow))
        _same(got, je.search(q, k=5, allow_mask=allow))
    # slot 2 lives in the COMPACTED epoch 0: its local row moved, its
    # global slot did not
    for s in (te, tb, je):
        s.set_at([2], vecs[:1])
    got = te.search(vecs[0], k=2)
    _self_same(got, tb.search(vecs[0], k=2))
    _same(got, je.search(vecs[0], k=2))


def test_flat_index_epoch_backed(rng):
    """FlatIndex(epoch_rows=...) keeps the VectorIndex contract: doc-id
    mapping, updates, deletes, filters, the async batch, compaction and
    snapshot/restore — with the JAX index's answers."""
    ids = np.arange(100, 140, dtype=np.int64)
    vecs = rng.standard_normal((40, 8)).astype(np.float32)
    nv = rng.standard_normal(8).astype(np.float32)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    allow = [np.array([101, 102]), None, np.array([120, 121]), None]
    seen = []
    for idx in (JFlatIndex(dim=8, epoch_rows=16, capacity=16, chunk_size=16),
                TFlatIndex(dim=8, epoch_rows=16, capacity=16, chunk_size=16,
                           **CPU)):
        idx.add_batch(ids, vecs)
        assert idx.epoch_store is not None
        assert idx.epoch_store.epoch_count >= 2
        got, d = idx.search_by_vector(vecs[7], k=1)
        assert got[0] == 107
        idx.delete(107)
        got, d = idx.search_by_vector(vecs[7], k=1)
        assert got[0] != 107
        idx.add_batch([105], nv[None, :])  # an id in a sealed epoch
        got, d = idx.search_by_vector(nv, k=1)
        assert got[0] == 105 and d[0] < 1e-3
        sync_ids, sync_d = idx.search_by_vector_batch(q, 3, allow)
        h = idx.search_by_vector_batch_async(q, 3, allow)
        assert h.attrs.get("epochs", 0) >= 2
        async_ids, async_d = h.result()
        np.testing.assert_array_equal(sync_ids, async_ids)
        np.testing.assert_allclose(sync_d, async_d, rtol=1e-5)
        idx.compact()
        got, d = idx.search_by_vector(nv, k=1)
        assert got[0] == 105
        r = type(idx).restore(idx.snapshot(), **({} if idx.__module__.startswith(
            "weaviate_tpu.") else CPU))
        got, d = r.search_by_vector(nv, k=1)
        assert got[0] == 105
        seen.append((sync_d, sync_ids))
    _same(seen[1], seen[0])


def test_compact_rides_sanctioned_d2h_span(rng):
    """An epoch compaction runs under ``store.compact_epoch`` and
    ``store.compact`` spans whose device->host copy goes through the
    sanctioned ``transfer.d2h`` span, as in the JAX package."""
    from weaviate_tpu_torch.runtime import tracing

    tracing.clear_traces()
    es = TEpochStore(dim=8, epoch_rows=16, capacity=16, chunk_size=16, **CPU)
    es.add(rng.standard_normal((40, 8)).astype(np.float32))
    es.delete(list(range(10)))
    with tracing.trace("maintenance", force=True):
        assert es.maintain()
    (t,) = tracing.recent_traces(1)
    names = [s["name"] for s in t["spans"]]
    for name in ("store.compact_epoch", "store.compact", "transfer.d2h"):
        assert name in names
    tracing.clear_traces()


# -- compaction gives memory back ------------------------------------------------

def test_epoch_compaction_reclaims_ledger_bytes(rng):
    from weaviate_tpu.runtime import hbm_ledger as jledger_mod
    from weaviate_tpu_torch.runtime import hbm_ledger as tledger_mod

    vecs = rng.standard_normal((256, 32)).astype(np.float32)
    keep = np.arange(0, 256, 4)
    fell = []
    for mod, make in ((jledger_mod, lambda: JEpochStore(
            dim=32, epoch_rows=64, capacity=64, chunk_size=64)),
            (tledger_mod, lambda: TEpochStore(
                dim=32, epoch_rows=64, capacity=64, chunk_size=64, **CPU))):
        with mod.owner("TEpochLedger", "s0"):
            es = make()
        es.add(vecs)
        es.seal_active()
        before = mod.ledger.shard_bytes("TEpochLedger", "s0")
        comps = mod.ledger.shard_component_bytes("TEpochLedger", "s0")
        assert any("@e" in c for c in comps)
        es.delete(np.arange(256, dtype=np.int64)[np.arange(256) % 4 != 0])
        assert es.maintain()
        after = mod.ledger.shard_bytes("TEpochLedger", "s0")
        assert after < before, (before, after)
        d, i = es.search(vecs[keep[3]], k=1)
        assert i[0] == keep[3]
        assert all(s["tombstones"] == 0 for s in es.epoch_stats() if s["sealed"])
        fell.append((sorted(mod.ledger.shard_component_bytes(
            "TEpochLedger", "s0")), before - after))
        del es
    # the same component labels, and the same bytes given back (the JAX
    # store's sq_norms / valid are the port's too)
    assert fell[0][0] == fell[1][0]
    assert fell[0][1] == fell[1][1]


def test_epoch_gauges_exposed(rng):
    from weaviate_tpu_torch.runtime.metrics import registry

    es = TEpochStore(dim=8, epoch_rows=8, capacity=8, chunk_size=8, **CPU)
    es.add(rng.standard_normal((20, 8)).astype(np.float32))
    es.maintain()
    text = registry.expose()
    for name in ("weaviate_tpu_epoch_count", "weaviate_tpu_epoch_live_rows",
                 "weaviate_tpu_epoch_tombstone_rows"):
        assert name in text


# -- collection level: both packages' Databases ---------------------------------

class _Pkg:
    """One package's collection-level surface, so a scenario runs the same
    calls through either."""

    def __init__(self, which: str):
        self.which = which
        if which == "jax":
            from weaviate_tpu.db.database import Database
            from weaviate_tpu.runtime import faultline
            from weaviate_tpu.runtime.hbm_ledger import ledger
            from weaviate_tpu.runtime.memwatch import InsufficientMemoryError
            from weaviate_tpu.runtime.metrics import epoch_migrations
            from weaviate_tpu.schema import config
            self.open = lambda d: Database(data_dir=d)
        else:
            from weaviate_tpu_torch.db.database import Database
            from weaviate_tpu_torch.runtime import faultline
            from weaviate_tpu_torch.runtime.hbm_ledger import ledger
            from weaviate_tpu_torch.runtime.memwatch import InsufficientMemoryError
            from weaviate_tpu_torch.runtime.metrics import epoch_migrations
            from weaviate_tpu_torch.schema import config
            self.open = lambda d: Database(data_dir=d, device="cpu")
        self.faultline = faultline
        self.ledger = ledger
        self.oom = InsufficientMemoryError
        self.migrations = epoch_migrations
        self.config = config

    def collection(self, tmpdir, shards=2, epoch_rows=32, dim=16):
        c = self.config
        db = self.open(tmpdir)
        db.create_collection(c.CollectionConfig(
            name="EpochCol",
            vectors=[c.VectorConfig(name="", dim=dim, index=c.VectorIndexConfig(
                index_type="flat", epoch_rows=epoch_rows))],
            sharding=c.ShardingConfig(desired_count=shards)))
        return db, db.get_collection("EpochCol")


PKGS = ("jax", "torch")


def _both(scenario):
    """Run ``scenario(pkg, tmpdir)`` through each package; returns the two
    results (JAX first)."""
    out = []
    for which in PKGS:
        with tempfile.TemporaryDirectory() as d:
            out.append(scenario(_Pkg(which), d))
    return out


def test_mixed_read_write_reclaims_and_stays_correct():
    """Interleaved puts, deletes and queries stay correct, and the
    ``epoch-maintenance`` cycle makes the ledger FALL after deletes; the
    port's answers are the JAX package's."""
    def scenario(pkg, d):
        rng = np.random.default_rng(11)
        db, col = pkg.collection(d, shards=1, epoch_rows=32)
        answers = []
        try:
            alive = {}
            n = 0
            for _round in range(6):
                for _ in range(40):
                    v = rng.standard_normal(16).astype(np.float32)
                    u = str(uuid_mod.UUID(int=int(rng.integers(0, 2 ** 63))))
                    col.put_object({"n": n}, vector=v, uuid=u)
                    alive[u] = v
                    n += 1
                for u in list(alive)[::3][:20]:
                    col.delete_object(u)
                    del alive[u]
                probe = list(alive)[-1]
                res = col.near_vector(alive[probe], k=3)
                assert res and res[0].uuid == probe
                assert len({r.uuid for r in res}) == len(res)
                answers.append([(r.uuid, r.distance) for r in res])
            peak = pkg.ledger.collection_bytes("EpochCol")
            for u in list(alive)[::2]:
                col.delete_object(u)
                del alive[u]
            assert db.cycles.run_now("epoch-maintenance")
            assert pkg.ledger.collection_bytes("EpochCol") < peak
            probe = list(alive)[0]
            res = col.near_vector(alive[probe], k=3)
            assert res and res[0].uuid == probe
            answers.append([(r.uuid, r.distance) for r in res])
            stats = col.shards["shard-0"].vector_indexes[""].epoch_store.epoch_stats()
            return answers, [(s["epoch"], s["rows"], s["live"]) for s in stats]
        finally:
            db.close()

    (ja, js), (ta, ts) = _both(scenario)
    assert ts == js
    for jrow, trow in zip(ja, ta):
        assert [u for u, _ in trow] == [u for u, _ in jrow]
        np.testing.assert_allclose([x for _, x in trow], [x for _, x in jrow],
                                   rtol=RTOL, atol=ATOL)


def test_shard_quota_migration_averts_507():
    """A shard at its quota watermark migrates its coldest sealed epoch to
    the sibling with headroom and the write SUCCEEDS; with no headroom
    anywhere the typed 507 surfaces. Both packages alike."""
    def scenario(pkg, d):
        rng = np.random.default_rng(12)
        db, col = pkg.collection(d, shards=2, epoch_rows=32)
        try:
            fat = "shard-0"
            uuids = _uuids_for_shard(col.sharding, fat, 100)
            for j, u in enumerate(uuids):
                col.put_object({"j": j}, uuid=u,
                               vector=rng.standard_normal(16).astype(np.float32))
            shard = col.shards[fat]
            shard.vector_indexes[""].epoch_store.seal_active()
            used = pkg.ledger.shard_bytes("EpochCol", fat)
            shard.shard_hbm_limit = used
            assert shard.over_shard_limit()
            before = pkg.migrations.labels("EpochCol", fat).value
            u_new = _uuids_for_shard(col.sharding, fat, 1, seed=7)[0]
            col.put_object({"fresh": True}, uuid=u_new,
                           vector=rng.standard_normal(16).astype(np.float32))
            assert pkg.migrations.labels("EpochCol", fat).value > before
            assert pkg.ledger.shard_bytes("EpochCol", fat) < used
            for u in uuids[:10] + [u_new]:
                assert col.get_object(u) is not None
            res = col.near_vector(np.zeros(16, np.float32), k=101)
            assert len(res) == len({r.uuid for r in res})
            moved = sorted(u for u in uuids if shard.migrated_to(u))
            col.shards["shard-1"].shard_hbm_limit = 1  # hopeless quota
            shard.shard_hbm_limit = max(
                pkg.ledger.shard_bytes("EpochCol", fat) // 2, 1)
            with pytest.raises(pkg.oom):
                col.put_object(
                    {"overflow": True},
                    uuid=_uuids_for_shard(col.sharding, fat, 1, seed=9)[0],
                    vector=rng.standard_normal(16).astype(np.float32))
            return moved, sorted(r.uuid for r in res)
        finally:
            db.close()

    (jm, jr), (tm, tr) = _both(scenario)
    assert tm == jm and len(tm) > 0
    assert tr == jr


@pytest.mark.parametrize("crash_at", ["epoch.migrate.pre_ingest",
                                      "epoch.migrate.post_ingest",
                                      "epoch.migrate.post_cutover"])
def test_migration_kill_no_loss_no_double_serve(crash_at):
    """A fault at each of the migration's crash points, in the order
    write at the destination -> routing marker -> delete at the source:
    every doc is served EXACTLY once, before and after a restart, and the
    re-run migration completes. Both packages end in the same state."""
    def scenario(pkg, d):
        rng = np.random.default_rng(13)
        db, col = pkg.collection(d, shards=2, epoch_rows=16)
        uuids = _uuids_for_shard(col.sharding, "shard-0", 40)
        for j, u in enumerate(uuids):
            col.put_object({"j": j}, uuid=u,
                           vector=rng.standard_normal(16).astype(np.float32))

        def exactly_once(c):
            for u in uuids:
                assert c.get_object(u) is not None, f"lost {u}"
            res = c.near_vector(np.zeros(16, np.float32), k=200)
            served = [r.uuid for r in res if r.uuid in set(uuids)]
            assert len(served) == len(set(served)), "double-served"
            assert len(set(served)) == len(uuids), "search lost docs"
            return sorted(served)

        col.shards["shard-0"].vector_indexes[""].epoch_store.seal_active()
        with pkg.faultline.injected(crash_at, "error"):
            with pytest.raises(pkg.faultline.FaultInjected):
                col.migrate_epoch("shard-0", dst_name="shard-1")
        first = exactly_once(col)
        counts = [col.shards[n].object_count() for n in ("shard-0", "shard-1")]
        db.close()
        db2 = pkg.open(d)
        col2 = db2.get_collection("EpochCol")
        try:
            assert exactly_once(col2) == first
            col2.shards["shard-0"].vector_indexes[""].epoch_store.seal_active()
            col2.migrate_epoch("shard-0", dst_name="shard-1")
            exactly_once(col2)
            gone = uuids[5]
            assert col2.delete_object(gone)
            assert col2.get_object(gone) is None
            res = col2.near_vector(np.zeros(16, np.float32), k=200)
            assert gone not in {r.uuid for r in res}
            return first, counts, [col2.shards[n].object_count()
                                   for n in ("shard-0", "shard-1")]
        finally:
            db2.close()

    jax_out, torch_out = _both(scenario)
    assert torch_out == jax_out


def test_epoch_parity_mesh():
    """Mesh-sharded epochs (per-epoch sharded scans, epoch-sliced
    column-sharded allow masks, the slot-map merge on the merge device):
    the same ids as the single row-sharded buffer and as the JAX
    package's epochs on its 8 virtual devices; a restore lands on a mesh;
    anything but a Mesh is a TypeError."""
    import jax
    import torch

    from weaviate_tpu.parallel import make_mesh as jmake_mesh
    from weaviate_tpu_torch.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(devices=[torch.device("cpu")] * 8)
    rng = np.random.default_rng(42)
    vecs = rng.standard_normal((120, 32)).astype(np.float32)
    es = TEpochStore(dim=32, epoch_rows=48, capacity=32, chunk_size=4,
                     mesh=mesh)
    bs = TStore(dim=32, capacity=128, chunk_size=16, mesh=mesh)
    je = JEpochStore(dim=32, epoch_rows=48, capacity=32, chunk_size=4,
                     mesh=jmake_mesh(8))
    s1, s2 = es.add(vecs), bs.add(vecs)
    assert (s1 == s2).all() and (s1 == je.add(vecs)).all()
    for s in (es, bs, je):
        s.delete([3, 50, 100])
    q = rng.standard_normal((3, 32)).astype(np.float32)
    d1, i1 = es.search(q, k=6)
    d2, i2 = bs.search(q, k=6)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)
    dj, ij = je.search(q, k=6)
    np.testing.assert_array_equal(i1, ij)
    np.testing.assert_allclose(d1, dj, rtol=RTOL, atol=ATOL)
    pm = np.zeros((3, 160), dtype=bool)
    pm[0, [1, 2, 60]] = True
    pm[1, :] = True
    pm[2, [100, 101]] = True
    d1, i1 = es.search(q, k=3, allow_mask=pm)
    d2, i2 = bs.search(q, k=3, allow_mask=pm[:, :128])
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(i1, je.search(q, k=3, allow_mask=pm)[1])
    back = TEpochStore.restore(je.snapshot(), mesh=mesh)
    assert back.mesh is mesh and back.epochs[0].store.n_shards == 8
    np.testing.assert_array_equal(back.search(q, k=6)[1], ij)
    with pytest.raises(TypeError, match="Mesh"):
        TEpochStore(dim=32, epoch_rows=48, mesh=object(), **CPU)
    with pytest.raises(TypeError, match="Mesh"):
        TFlatIndex(dim=32, epoch_rows=48, mesh=object(), **CPU)


def test_migration_blocks_concurrent_write_no_loss():
    """A delete of a migrating uuid queues behind the move (the source lock
    spans ingest + cutover) instead of landing where the cutover would
    erase it or the target's copy resurrect it."""
    def scenario(pkg, d):
        rng = np.random.default_rng(14)
        db, col = pkg.collection(d, shards=2, epoch_rows=16)
        try:
            uuids = _uuids_for_shard(col.sharding, "shard-0", 20)
            for j, u in enumerate(uuids):
                col.put_object({"j": j}, uuid=u,
                               vector=rng.standard_normal(16).astype(np.float32))
            col.shards["shard-0"].vector_indexes[""].epoch_store.seal_active()
            victim = uuids[0]
            with pkg.faultline.injected("epoch.migrate.post_ingest", "latency",
                                        latency_s=0.4):
                t = threading.Thread(target=col.migrate_epoch, args=("shard-0",),
                                     kwargs={"dst_name": "shard-1"})
                t.start()
                time.sleep(0.1)  # the migration is inside the window now
                assert col.delete_object(victim)
                t.join(10)
            assert col.get_object(victim) is None
            res = col.near_vector(np.zeros(16, np.float32), k=50)
            assert victim not in {r.uuid for r in res}
            others = uuids[1:]
            assert all(col.get_object(u) is not None for u in others)
            assert len({r.uuid for r in res} & set(others)) == len(others)
            return sorted(r.uuid for r in res)
        finally:
            db.close()

    jr, tr = _both(scenario)
    assert tr == jr


def test_epoch_snapshot_restore_after_early_seal(rng):
    """An early seal leaves the active epoch's range mostly unused, so the
    slot->id table is wider than a re-split restore's capacity: restore
    keeps every entry — the port's own snapshot and the JAX index's."""
    ids = np.arange(10, dtype=np.int64)
    vecs = rng.standard_normal((10, 8)).astype(np.float32)
    more = rng.standard_normal((5, 8)).astype(np.float32)
    jx = JFlatIndex(dim=8, epoch_rows=64, capacity=64, chunk_size=64)
    tx = TFlatIndex(dim=8, epoch_rows=64, capacity=64, chunk_size=64, **CPU)
    for idx in (jx, tx):
        idx.add_batch(ids, vecs)
        idx.epoch_store.seal_active()
        idx.add_batch(np.arange(10, 15, dtype=np.int64), more)
    for r in (TFlatIndex.restore(tx.snapshot(), **CPU),
              convert.flat_from_jax_snapshot(jx.snapshot(), device="cpu")):
        assert len(r) == 15
        got, d = r.search_by_vector(vecs[4], k=1)
        assert got[0] == 4 and d[0] < 1e-3
        _same(r.search_by_vector_batch(vecs, 3)[::-1],
              jx.search_by_vector_batch(vecs, 3)[::-1])


def test_epoch_compress_keeps_results(rng):
    """Runtime compression of an epoch-backed index keeps the slot layout
    and serves the same neighbors (rescored exactly), as the JAX index."""
    ids = np.arange(50, dtype=np.int64)
    vecs = rng.standard_normal((50, 16)).astype(np.float32)
    answers = []
    for idx in (JFlatIndex(dim=16, epoch_rows=16, capacity=16, chunk_size=16),
                TFlatIndex(dim=16, epoch_rows=16, capacity=16, chunk_size=16,
                           **CPU)):
        idx.add_batch(ids, vecs)
        idx.delete(7, 30)
        idx.compress(quantization="bq")
        assert idx.compressed
        assert idx.epoch_store is not None and idx.epoch_store.quantization == "bq"
        with pytest.raises(RuntimeError, match="already compressed"):
            idx.compress(quantization="bq")
        got, d = idx.search_by_vector(vecs[12], k=1)
        assert got[0] == 12 and d[0] < 1e-3
        got, _ = idx.search_by_vector(vecs[7], k=50)
        assert 7 not in got.tolist()
        answers.append(idx.search_by_vector_batch(vecs[:6], 5)[::-1])
    _same(answers[1], answers[0])


# -- the cross-node half -------------------------------------------------------


class _FakeRemote:
    """Remote shard client double (the JAX test's): captures cross-node
    ingests and serves GET / DELETE from the captured store."""

    def __init__(self, fail=False):
        self.fail = fail
        self.calls = []
        self.objects = {}  # (node, shard) -> {uuid: raw}

    def put_objects(self, node, collection, shard, raw_objects):
        from weaviate_tpu_torch.cluster.transport import RpcError
        from weaviate_tpu_torch.storage.objects import StorageObject

        if self.fail:
            raise RpcError("target at watermark", status=507)
        self.calls.append(("put", node, collection, shard, len(raw_objects)))
        bucket = self.objects.setdefault((node, shard), {})
        for raw in raw_objects:
            bucket[StorageObject.from_bytes(raw).uuid] = raw

    def get_object(self, node, collection, shard, uuid):
        return self.objects.get((node, shard), {}).get(uuid)

    def delete_object(self, node, collection, shard, uuid):
        return self.objects.get((node, shard), {}).pop(uuid, None) \
            is not None


def _two_node_collection(tmpdir, remote=None, peer_bytes=0, local_bytes=None):
    """A port collection whose sibling shard is placed on another node,
    which gossips ``peer_bytes`` of device-memory ledger (lighter than this
    one's by default). ``local_bytes``: this node's own reading (None =
    the process's ledger)."""
    from weaviate_tpu_torch.db.collection import Collection
    from weaviate_tpu_torch.db.sharding import ShardingState
    from weaviate_tpu_torch.schema.config import (CollectionConfig,
                                                  ShardingConfig, VectorConfig,
                                                  VectorIndexConfig)

    state = ShardingState(
        shard_names=["shard-0", "shard-1"],
        placement={"shard-0": ["node-a"], "shard-1": ["node-b"]})
    cfg = CollectionConfig(
        name="XNode",
        vectors=[VectorConfig(name="", dim=16, index=VectorIndexConfig(
            index_type="flat", epoch_rows=16))],
        sharding=ShardingConfig(desired_count=2))
    return Collection(tmpdir, cfg, sharding_state=state, local_node="node-a",
                      remote=remote,
                      nodes_provider=lambda: ["node-a", "node-b"],
                      node_hbm_provider=lambda: {"node-b": peer_bytes},
                      local_hbm_provider=(None if local_bytes is None
                                          else lambda: local_bytes),
                      device="cpu")


def _fill_local(col, n, seed):
    rng = np.random.default_rng(seed)
    uuids = _uuids_for_shard(col.sharding, "shard-0", n)
    shard = col._load_shard("shard-0")
    for j, u in enumerate(uuids):
        col.put_object({"j": j}, uuid=u,
                       vector=rng.standard_normal(16).astype(np.float32))
    shard.vector_indexes[""].epoch_store.seal_active()
    return shard, uuids


def test_cross_node_epoch_migration_durable_cutover():
    """No LOCAL sibling has headroom (the only sibling lives on node-b):
    migrate_epoch ships the coldest sealed epoch over the shard RPC behind
    the same durable-marker cutover. Reads follow the marker to the remote
    copy, deletes clean both sides, and the epoch's device memory is
    released locally (the JAX package's test, through the port)."""
    from weaviate_tpu_torch.runtime.hbm_ledger import ledger

    with tempfile.TemporaryDirectory() as d:
        remote = _FakeRemote()
        col = _two_node_collection(d, remote)
        try:
            shard, uuids = _fill_local(col, 24, 1)
            before = ledger.shard_bytes("XNode", "shard-0")
            moved = col.migrate_epoch("shard-0")
            assert moved > 0
            assert remote.calls and remote.calls[0][:4] == (
                "put", "node-b", "XNode", "shard-1")
            assert ledger.shard_bytes("XNode", "shard-0") < before
            migrated = [u for u in uuids if shard.migrated_to(u) == "shard-1"]
            assert len(migrated) == moved
            for u in migrated[:5]:
                obj = col.get_object(u)
                assert obj is not None and obj.uuid == u
            victim = migrated[0]
            assert col.delete_object(victim)
            assert shard.migrated_to(victim) is None
            assert remote.get_object("node-b", "XNode", "shard-1",
                                     victim) is None
        finally:
            col.close()


def test_cross_node_migration_rpc_failure_aborts_markers_kept():
    """An ingest RPC failure is ambiguous (the put may have landed before
    the reply was lost), so the abort keeps the routing markers, cuts
    nothing over, and the source still serves every object; a later retry
    re-marks and completes (the JAX package's test, through the port)."""
    with tempfile.TemporaryDirectory() as d:
        remote = _FakeRemote(fail=True)
        col = _two_node_collection(d, remote)
        try:
            shard, uuids = _fill_local(col, 12, 2)
            assert col.migrate_epoch("shard-0") == 0
            marked = [u for u in uuids if shard.migrated_to(u) == "shard-1"]
            assert marked  # kept, not rolled back
            for u in uuids:  # the ring copy still answers
                assert col.get_object(u) is not None
            remote.fail = False
            assert col.migrate_epoch("shard-0") > 0
            for u in uuids:
                assert col.get_object(u) is not None
        finally:
            col.close()


def test_cross_node_migration_without_a_remote_client_stays_local():
    """A collection with no remote client (one node's view of a placement
    that names another node) finds no remote sibling: nothing moves, no
    marker is written, every object stays served from its shard."""
    with tempfile.TemporaryDirectory() as d:
        col = _two_node_collection(d)
        try:
            shard, uuids = _fill_local(col, 12, 3)
            assert col.migrate_epoch("shard-0") == 0
            assert shard._migrated_count == 0
            assert all(shard.get_object(u) is not None for u in uuids)
        finally:
            col.close()


@pytest.mark.parametrize("peer_bytes,moves", [(1 << 20, True), (3 << 20, False)])
def test_cross_node_migration_reads_this_nodes_own_ledger(peer_bytes, moves):
    """The remote sibling is chosen against THIS node's own reading, not
    the process's ledger (which holds every node's shards when several
    share a process): a peer lighter than this node's 2 MiB takes the
    epoch; a heavier one is skipped and nothing moves, no marker written."""
    with tempfile.TemporaryDirectory() as d:
        remote = _FakeRemote()
        col = _two_node_collection(d, remote, peer_bytes=peer_bytes,
                                   local_bytes=2 << 20)
        try:
            shard, uuids = _fill_local(col, 24, 4)
            moved = col.migrate_epoch("shard-0")
            if moves:
                assert moved > 0 and remote.calls
                assert remote.calls[0][:4] == ("put", "node-b", "XNode", "shard-1")
            else:
                assert moved == 0 and not remote.calls
                assert shard._migrated_count == 0
                assert all(shard.get_object(u) is not None for u in uuids)
        finally:
            col.close()


# -- the port's own seams ---------------------------------------------------------

def test_epoch_token_and_cycle_registration(rng):
    """The shard's epoch token (what a canary's ground truth keys on)
    changes with a compaction; the Database registers the
    ``epoch-maintenance`` cycle beside ``lsm-maintenance``."""
    with tempfile.TemporaryDirectory() as d:
        db, col = _Pkg("torch").collection(d, shards=1, epoch_rows=16)
        try:
            assert "epoch-maintenance" in db.cycles._callbacks
            vecs = rng.standard_normal((40, 16)).astype(np.float32)
            uuids = [col.put_object({"n": i}, vector=v) for i, v in enumerate(vecs)]
            shard = col.shards["shard-0"]
            t0 = shard.epoch_token("")
            assert len(t0[0]) >= 2
            for u in uuids[:12]:
                col.delete_object(u)
            assert db.cycles.run_now("epoch-maintenance")
            assert shard.epoch_token("") != t0
            assert shard.epoch_token("nope") is None
        finally:
            db.close()


def test_epoch_rows_through_the_rest_schema():
    """``vectorIndexConfig: {"epoch_rows": ...}`` over REST builds an epoch
    index in the port, as in the JAX server."""
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.config import ServerConfig
    from weaviate_tpu_torch.server import Server

    with tempfile.TemporaryDirectory() as d:
        srv = Server(ServerConfig(data_path=d, rest_port=0, grpc_port=0,
                                  disable_telemetry=True), device="cpu").assemble()
        try:
            c = Client(srv.rest.address)
            c.create_class({"class": "E", "vectorizer": "none",
                            "vectorIndexType": "flat",
                            "vectorIndexConfig": {"epoch_rows": 16},
                            "properties": [{"name": "n", "dataType": ["int"]}]})
            rng = np.random.default_rng(3)
            vecs = rng.standard_normal((40, 8)).astype(np.float32)
            c.batch_objects([{"class": "E", "properties": {"n": i},
                              "vector": v.tolist()} for i, v in enumerate(vecs)])
            shard = next(iter(srv.db.get_collection("E").shards.values()))
            assert shard.vector_indexes[""].epoch_store.epoch_count >= 3
            mem = c.request("GET", "/v1/debug/memory")
            comps = mem["ledger"]["collections"]["E"]["components"]
            assert any(k.startswith("corpus@e") for k in comps)
        finally:
            srv.stop()
