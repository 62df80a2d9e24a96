"""The port's serving runtime (weaviate_tpu_torch/runtime/): the query
batcher's coalescing and zero-sync pipeline, its fault retry, the D2H
transfer handles and tracing's d2h — driven on the CPU with the port's
FlatIndex (device="cpu") or stub batch functions."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from weaviate_tpu_torch.engine.flat import FlatIndex
from weaviate_tpu_torch.runtime import faultline, tracing
from weaviate_tpu_torch.runtime.query_batcher import QueryBatcher
from weaviate_tpu_torch.runtime.transfer import DeviceResultHandle, TransferPipeline


def _index(n=400, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    idx = FlatIndex(dim=dim, capacity=512, chunk_size=256, device="cpu")
    idx.add_batch(np.arange(n), rng.standard_normal((n, dim)).astype(np.float32))
    return idx, rng


def test_async_batches_equal_sync_path_for_mixed_drains():
    idx, rng = _index()
    qs = rng.standard_normal((6, 16)).astype(np.float32)
    allows = [np.arange(0, 400, 3), None, np.arange(100, 180), None, None,
              np.arange(390, 400)]
    want = idx.search_by_vector_batch(qs, 8, allows)
    got = idx.search_by_vector_batch_async(qs, 8, allows).result()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_batcher_coalesces_and_matches_direct_search():
    idx, rng = _index()
    qb = QueryBatcher(idx.search_by_vector_batch,
                      supports_filter_batching=True,
                      capacity_fn=lambda: idx.store.capacity,
                      async_batch_fn=idx.search_by_vector_batch_async)
    qs = rng.standard_normal((24, 16)).astype(np.float32)
    allow = np.arange(0, 400, 2)
    out, errors = [None] * len(qs), []

    def client(c):
        try:
            for i in range(c, len(qs), 6):
                out[i] = qb.search(qs[i], 5, allow if i % 3 == 0 else None)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors and not any(t.is_alive() for t in threads)
        for i, (ids, d) in enumerate(out):
            want = idx.search_by_vector(qs[i], 5, allow if i % 3 == 0 else None)
            np.testing.assert_array_equal(ids, want[0])
            np.testing.assert_allclose(d, want[1], rtol=1e-6, atol=1e-6)
        assert qb.batched_queries == len(qs)
        assert qb.async_dispatches == qb.dispatches > 0
    finally:
        qb.stop()


def test_selective_filter_goes_solo_to_the_gathered_path():
    idx, rng = _index()
    calls = []

    def batch_fn(queries, k, allow):
        calls.append(allow)
        return idx.search_by_vector_batch(queries, k, allow)

    qb = QueryBatcher(batch_fn, supports_filter_batching=True,
                      capacity_fn=lambda: idx.store.capacity)
    try:
        tiny = np.array([3, 7, 11])  # <= capacity // 64
        ids, _ = qb.search(rng.standard_normal(16).astype(np.float32), 2, tiny)
        assert set(ids.tolist()) <= {3, 7, 11}
        assert calls and calls[0] is tiny  # the shared (solo) form
        assert qb.dispatches == 0
    finally:
        qb.stop()


def test_faulted_dispatch_retries_once_then_serves():
    idx, rng = _index()
    qb = QueryBatcher(idx.search_by_vector_batch,
                      async_batch_fn=idx.search_by_vector_batch_async)
    q = rng.standard_normal(16).astype(np.float32)
    try:
        with faultline.injected("batcher.dispatch", nth=0):
            ids, _ = qb.search(q, 4)
        np.testing.assert_array_equal(ids, idx.search_by_vector(q, 4)[0])
    finally:
        faultline.disarm()
        qb.stop()


def test_stop_fails_queued_work_and_rejects_new_transfers():
    qb = QueryBatcher(lambda q, k, a: (np.zeros((len(q), k), np.int64),
                                       np.zeros((len(q), k), np.float32)))
    qb.stop()
    with pytest.raises(RuntimeError):
        qb._ensure_transfer()
    tp = TransferPipeline()
    tp.stop()
    with pytest.raises(RuntimeError):
        tp.submit(DeviceResultHandle.ready(1), lambda *a: None)


def test_handle_result_is_idempotent_and_caches_errors():
    t = torch.arange(6, dtype=torch.int32)
    h = DeviceResultHandle((t,), finish=lambda a: a.sum())
    assert h.result() == 15 and h.result() == 15 and h.done
    mapped = DeviceResultHandle((t,)).map(lambda res: res[0][-1])
    assert mapped.result() == 5

    def boom(_a):
        raise ValueError("finish failed")

    bad = DeviceResultHandle((t,), finish=boom)
    for _ in range(2):
        with pytest.raises(ValueError):
            bad.result()


def test_d2h_records_a_span_inside_a_trace():
    with tracing.trace("test.root", force=True) as root:
        (host,) = tracing.d2h(torch.ones(3))
        tracing.annotate(checked=True)
    assert isinstance(host, np.ndarray) and host.tolist() == [1.0, 1.0, 1.0]
    assert root.attrs["checked"] is True
    assert tracing.d2h(None, torch.zeros(2))[0] is None


def test_transfer_pipeline_bounds_inflight_window():
    tp = TransferPipeline(depth=2)
    release = threading.Event()
    done = []

    def slow_finish(*_a):
        release.wait(timeout=10)
        return 1

    try:
        for _ in range(2):
            tp.submit(DeviceResultHandle((), finish=slow_finish),
                      lambda v, e, t0, t1: done.append((v, e)))
        blocked = threading.Thread(
            target=tp.submit, args=(DeviceResultHandle.ready(2),
                                    lambda v, e, t0, t1: done.append((v, e))))
        blocked.start()
        time.sleep(0.2)
        assert blocked.is_alive()  # the window of 2 is full
        release.set()
        blocked.join(timeout=10)
        assert not blocked.is_alive()
        deadline = time.time() + 10
        while len(done) < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert sorted(v for v, _e in done) == [1, 1, 2]
    finally:
        release.set()
        tp.stop()
