"""The port's copy of tests/test_async_runtime.py (CPU ``Database``):
async index queue, telemetry, and tenant-activity tests.

Reference pattern: index_queue tests (adapters/repos/db/index_queue_test),
usecases/telemetry tests, tenantactivity handler tests.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from weaviate_tpu_torch.api.rest import config_from_json
from weaviate_tpu_torch.db.database import Database


# -- index queue -------------------------------------------------------------


class _FakeIndex:
    def __init__(self):
        self.ids = []
        self.lock = threading.Lock()

    def add_batch(self, ids, vecs):
        with self.lock:
            self.ids.extend(np.asarray(ids).tolist())


def test_index_queue_drains_and_tombstones():
    from weaviate_tpu_torch.runtime.index_queue import IndexQueue

    idx = _FakeIndex()
    q = IndexQueue(idx, batch_size=4, start_worker=False)
    q.push([1, 2, 3], np.ones((3, 4), dtype=np.float32))
    q.push([4, 5], np.ones((2, 4), dtype=np.float32))
    q.delete(3)  # queued insert must be dropped
    assert q.size() == 5
    assert q.drain()
    assert sorted(idx.ids) == [1, 2, 4, 5]
    assert q.size() == 0
    assert not q.drain()


def test_index_queue_worker_thread():
    from weaviate_tpu_torch.runtime.index_queue import IndexQueue

    idx = _FakeIndex()
    q = IndexQueue(idx, batch_size=8)
    q.push(list(range(100)), np.ones((100, 4), dtype=np.float32))
    assert q.wait_idle(timeout=10.0)
    assert sorted(idx.ids) == list(range(100))
    q.stop()


def test_shard_async_indexing(tmp_path):
    """ASYNC_INDEXING shard: imports return before vectors are indexed;
    flush() waits for the queue; deletes never resurrect."""
    db = Database(str(tmp_path), device="cpu")
    try:
        db.create_collection(config_from_json({
            "class": "Doc",
            "properties": [{"name": "n", "dataType": ["int"]}]}))
        col = db.get_collection("Doc")
        shard = col._load_shard("shard-0")
        shard.async_indexing = True
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((50, 8)).astype(np.float32)
        uids = [col.put_object({"n": i}, vector=vecs[i]) for i in range(50)]
        col.flush()  # waits for queue idle
        q = vecs[7]
        res = col.near_vector(q, k=1)
        assert res[0].uuid == uids[7]
        col.delete_object(uids[7])
        col.flush()
        res2 = col.near_vector(q, k=1)
        assert res2[0].uuid != uids[7]
    finally:
        db.close()


# -- telemetry ---------------------------------------------------------------


def test_telemetry_payload_and_push(tmp_path):
    from weaviate_tpu_torch.runtime import telemetry

    received = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            received.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    db = Database(str(tmp_path), device="cpu")
    try:
        db.create_collection(config_from_json({
            "class": "C", "properties": [{"name": "p", "dataType": ["text"]}]}))
        db.get_collection("C").put_object({"p": "x"}, vector=[1.0, 2.0])
        tel = telemetry.Telemeter(
            db, version="test",
            endpoint=f"http://127.0.0.1:{httpd.server_address[1]}/t",
            interval=3600)
        payload = tel.build_payload(telemetry.INIT)
        assert payload["numberObjects"] == 1
        assert payload["type"] == "INIT"
        assert tel._push(telemetry.INIT)
        assert received[0]["machineId"] == tel.machine_id
        # unreachable endpoint fails soft
        tel2 = telemetry.Telemeter(db, endpoint="http://127.0.0.1:9/x")
        assert not tel2._push(telemetry.UPDATE)
    finally:
        db.close()
        httpd.shutdown()


def test_telemetry_disabled_env(monkeypatch):
    from weaviate_tpu_torch.runtime import telemetry

    monkeypatch.setenv("DISABLE_TELEMETRY", "true")
    assert telemetry.disabled()


# -- tenant activity (multi-tenancy is ROADMAP Queue 1 item 7) ---------------


def test_tenant_activity_needs_tenants(tmp_path):
    """Tenant activity tracks tenants; a multi-tenant class is refused
    with the item that ports it, and the activity route lists none."""
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.api.rest import RestServer

    db = Database(str(tmp_path), device="cpu")
    srv = RestServer(db)
    srv.start()
    try:
        with pytest.raises(NotImplementedError, match="item 7"):
            db.create_collection(config_from_json({
                "class": "MT",
                "multiTenancyConfig": {"enabled": True},
                "properties": [{"name": "p", "dataType": ["text"]}]}))
        c = Client(srv.address)
        c.create_class({"class": "Plain",
                        "properties": [{"name": "p", "dataType": ["text"]}]})
        c.create_object("Plain", {"p": "x"}, vector=[1.0])
        assert c.request("GET", "/v1/tenant-activity") == {}
    finally:
        srv.stop()
        db.close()


def test_async_search_is_read_your_writes(tmp_path):
    """With async indexing on, a search must see queued (not-yet-indexed)
    vectors (reference: the index queue's brute-force search over the
    unindexed tail). The worker is DISABLED so the merge path is pinned —
    with it running, a fast drain would hide a broken merge."""
    from weaviate_tpu_torch.runtime.index_queue import IndexQueue

    db = Database(str(tmp_path), device="cpu")
    try:
        db.create_collection(config_from_json({
            "class": "RW", "properties": [{"name": "n", "dataType": ["int"]}]}))
        col = db.get_collection("RW")
        shard = col._load_shard("shard-0")
        shard.async_indexing = True
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((30, 8)).astype(np.float32)
        uids = [col.put_object({"n": 0}, vector=vecs[0])]
        # replace the auto-started queue with a worker-less one and
        # re-push: everything stays queued until we say so
        idx = shard.vector_indexes[""]
        pinned = IndexQueue(idx, start_worker=False)
        shard._index_queues[""].stop()
        shard._index_queues[""] = pinned
        for i in range(1, 30):
            uids.append(col.put_object({"n": i}, vector=vecs[i]))
        assert pinned.size() > 0  # genuinely unindexed
        res = col.near_vector(vecs[11], k=1)
        assert res[0].uuid == uids[11]
        # delete before drain: must not surface
        col.delete_object(uids[11])
        res2 = col.near_vector(vecs[11], k=1)
        assert res2[0].uuid != uids[11]
        # drain and verify again through the index path
        pinned.drain()
        res3 = col.near_vector(vecs[12], k=1)
        assert res3[0].uuid == uids[12]
    finally:
        db.close()


def test_shard_batch_async_merges_queued_tail(tmp_path):
    """ASYNC_INDEXING queued vectors must merge into pipelined batch
    results exactly like the sync path (snapshot-before-dispatch; the
    port's copy of tests/test_query_batcher.py's case, with the worker
    pinned so the tail is really queued)."""
    from weaviate_tpu_torch.runtime.index_queue import IndexQueue
    from weaviate_tpu_torch.schema.config import CollectionConfig

    db = Database(str(tmp_path), async_indexing=True, device="cpu")
    try:
        col = db.create_collection(CollectionConfig(name="QBA"))
        rng = np.random.default_rng(1)
        vecs = rng.standard_normal((60, 8)).astype(np.float32)
        col.put_object({"i": 0}, vector=vecs[0])
        shard = next(iter(col.shards.values()))
        assert shard.async_indexing
        shard._index_queues[""].stop()
        shard._index_queues[""] = IndexQueue(shard.vector_indexes[""],
                                             start_worker=False)
        for i in range(1, 60):
            col.put_object({"i": i}, vector=vecs[i])
        assert shard._index_queues[""].size() == 59
        qs = vecs[:5]
        ids_a, dists_a, counts_a = shard.vector_search_batch_async(qs, 4).result()
        ids_s, dists_s, counts_s = shard.vector_search_batch(qs, 4)
        np.testing.assert_array_equal(ids_a, ids_s)
        np.testing.assert_array_equal(dists_a, dists_s)
        np.testing.assert_array_equal(counts_a, counts_s)
        # self-hit first, from the index (row 0) and from the queued tail
        assert [int(ids_a[r, 0]) for r in range(5)] == list(range(5))
        # the device hybrid path declines while the tail is queued
        assert shard.hybrid_search("x", vecs[3], k=3) is None
        shard._index_queues[""].drain()
        ids_d, _d, _c = shard.vector_search_batch(qs, 4)
        np.testing.assert_array_equal(ids_d, ids_s)
    finally:
        db.close()
