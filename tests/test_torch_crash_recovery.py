"""Crash recovery of the port's storage: the WAL's torn tail against
mid-file corruption, fsync ordering, the recovery report surfaces, and
the crashpoint matrix of tools/crashtest_torch (a subprocess worker over
the port's KVStore, Raft and HNSW index, killed with ``os._exit(137)``
or a torn write at every named crashpoint, then reopened and checked
against its acked-write journal), every worker on the CPU.

A copy of tests/test_crash_recovery.py's storage and matrix sections
with the port's modules (``device="cpu"`` where a port entry point needs
one). Its Raft and cluster crash tests are in tests/test_torch_raft.py.
The matrix runs unmarked, as the JAX file's does; the randomized seeded
sweep is ``slow`` there and here.
"""

import json
import os
import struct

import numpy as np
import pytest

from weaviate_tpu_torch.runtime import faultline
from weaviate_tpu_torch.storage import fsutil, recovery
from weaviate_tpu_torch.storage.kv import KVStore
from weaviate_tpu_torch.storage.wal import ReplayReport, WriteAheadLog


@pytest.fixture(autouse=True)
def _port_isolation():
    """The conftest resets the JAX package's faultline and recovery
    registry; the port keeps its own."""
    faultline.disarm()
    recovery.reset()
    yield
    faultline.disarm()
    recovery.reset()


# -- WAL: torn tail vs mid-file corruption ------------------------------------


def _frames(path):
    rep = ReplayReport()
    out = list(WriteAheadLog.replay(path, rep))
    return out, rep


def _write_wal(path, payloads, sync=False):
    w = WriteAheadLog(path, sync=sync)
    for p in payloads:
        w.append(p)
    w.close()


def test_wal_torn_tail_truncates(tmp_path):
    path = str(tmp_path / "w.bin")
    _write_wal(path, [b"one", b"two"])
    with open(path, "ab") as f:
        f.write(b"\x99\x88\x77")  # partial header — crash mid-append
    out, rep = _frames(path)
    assert out == [b"one", b"two"]
    assert rep.bytes_truncated == 3 and not rep.quarantined
    # the truncate is durable in the file: a second replay is clean
    out2, rep2 = _frames(path)
    assert out2 == [b"one", b"two"] and rep2.bytes_truncated == 0


def test_wal_corrupt_final_frame_is_torn_tail(tmp_path):
    """A bad CRC on the LAST frame is indistinguishable from a torn
    write — truncate, don't quarantine."""
    path = str(tmp_path / "w.bin")
    _write_wal(path, [b"good", b"bad-frame"])
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF  # damage the final payload byte
    open(path, "wb").write(bytes(data))
    out, rep = _frames(path)
    assert out == [b"good"]
    assert rep.bytes_truncated > 0 and not rep.quarantined
    assert not os.path.exists(path + ".corrupt")


def test_wal_mid_file_corruption_quarantines(tmp_path):
    """A bad CRC with intact frames AFTER it is body corruption:
    earlier frames replay, the file moves to .corrupt, later frames are
    NOT silently discarded with a truncate."""
    path = str(tmp_path / "w.bin")
    _write_wal(path, [b"first", b"middle", b"last"])
    data = bytearray(open(path, "rb").read())
    # corrupt the SECOND frame's payload (frames: 8-byte header + body)
    off = (8 + 5) + 8  # into "middle"
    data[off] ^= 0xFF
    open(path, "wb").write(bytes(data))
    out, rep = _frames(path)
    assert out == [b"first"]  # frames before the damage survive
    assert rep.quarantined
    assert os.path.exists(path + ".corrupt")
    assert not os.path.exists(path)


def test_bucket_keeps_replaying_later_wals_after_quarantine(tmp_path):
    """Reference behavior: one corrupt WAL must not throw away the
    bucket's LATER WALs (bucket_recover_from_wal.go analog)."""
    d = str(tmp_path)
    bdir = os.path.join(d, "objects")
    os.makedirs(bdir)
    pack = lambda k, v: __import__("msgpack").packb(  # noqa: E731
        {"k": k, "v": __import__("msgpack").packb({"v": v},
                                                  use_bin_type=True)},
        use_bin_type=True)
    _write_wal(os.path.join(bdir, "wal-000000.bin"),
               [pack(b"a", 1), pack(b"poison", 0), pack(b"b", 2)])
    _write_wal(os.path.join(bdir, "wal-000001.bin"), [pack(b"c", 3)])
    # corrupt wal-000000's SECOND frame mid-file
    p0 = os.path.join(bdir, "wal-000000.bin")
    raw = bytearray(open(p0, "rb").read())
    first_len = 8 + struct.unpack_from("<II", raw, 0)[1]
    raw[first_len + 8] ^= 0xFF
    open(p0, "wb").write(bytes(raw))

    store = KVStore(d)
    b = store.bucket("objects")
    assert b.get(b"a") == 1          # before the damage
    assert b.get(b"c") == 3          # LATER WAL still replayed
    assert b.get(b"b") is None       # after the damage in the bad WAL: lost
    rep = b._recovery
    assert rep.wals_quarantined == 1
    assert rep.frames_replayed == 2  # a + c
    assert "wal-000000.bin" in rep.quarantined_files
    assert os.path.exists(p0 + ".corrupt")  # evidence kept
    store.close()


def test_wal_crc_catches_single_bit_flip(tmp_path):
    path = str(tmp_path / "w.bin")
    _write_wal(path, [b"payload-bytes"])
    data = bytearray(open(path, "rb").read())
    data[10] ^= 0x01
    open(path, "wb").write(bytes(data))
    out, rep = _frames(path)
    assert out == []
    assert rep.bytes_truncated > 0 or rep.quarantined


# -- fsutil --------------------------------------------------------------------


def test_atomic_replace_moves_and_survives(tmp_path):
    tmp = str(tmp_path / "x.tmp")
    final = str(tmp_path / "x.db")
    open(tmp, "wb").write(b"abc")
    fsutil.atomic_replace(tmp, final)
    assert open(final, "rb").read() == b"abc"
    assert not os.path.exists(tmp)


def test_remove_durable_idempotent(tmp_path):
    p = str(tmp_path / "f")
    open(p, "w").write("x")
    fsutil.remove_durable(p)
    assert not os.path.exists(p)
    fsutil.remove_durable(p)  # second delete is a no-op, not an error


def test_guarded_write_disarmed_is_plain_write(tmp_path):
    p = str(tmp_path / "f")
    with open(p, "wb") as f:
        fsutil.guarded_write(f, b"hello", "wal.append.pre_fsync")
    assert open(p, "rb").read() == b"hello"


# -- recovery report surfaces ---------------------------------------------------


def test_recovery_report_and_counters(tmp_path):
    from weaviate_tpu_torch.runtime import metrics as m

    d = str(tmp_path)
    store = KVStore(d, sync_wal=True)
    b = store.bucket("objects")
    for i in range(10):
        b.put(f"k{i}".encode(), i)
    # crash-sim: reopen WITHOUT close — the WAL replays
    recovery.reset()
    store2 = KVStore(d)
    b2 = store2.bucket("objects")
    assert b2.get(b"k9") == 9
    snap = recovery.snapshot()
    assert snap["totals"]["frames_replayed"] == 10
    assert snap["totals"]["segments_recovered"] == 1
    assert snap["totals"]["buckets_recovered"] == 1
    [rep] = [r for r in snap["buckets"] if r["bucket"].endswith("objects")]
    assert not rep["clean"] and rep["wal_files_replayed"] == 1
    # counters exported with the bucket label
    text = m.registry.expose()
    assert "weaviate_tpu_recovery_frames_replayed_total" in text
    assert "weaviate_tpu_recovery_segments_recovered_total" in text
    store2.close()


def test_bucket_sync_wal_override_conflict_raises(tmp_path):
    """The raft pin must never silently degrade: asking for an explicit
    sync_wal that contradicts an already-open bucket is an error, not a
    quiet return of the unsynced instance."""
    store = KVStore(str(tmp_path), sync_wal=False)
    b = store.bucket("raft")  # store default: unsynced
    assert b.sync_wal is False
    with pytest.raises(ValueError, match="sync_wal"):
        store.bucket("raft", sync_wal=True)
    # idempotent re-request with the MATCHING value is fine
    assert store.bucket("raft", sync_wal=False) is b
    store.close()


def test_debug_storage_endpoint(tmp_path):
    import urllib.request

    from weaviate_tpu_torch.api.rest import RestServer
    from weaviate_tpu_torch.db.database import Database
    from weaviate_tpu_torch.schema.config import CollectionConfig, Property

    d = str(tmp_path / "data")
    db = Database(d, sync_wal=True, device="cpu")
    db.create_collection(CollectionConfig(
        name="Crash", properties=[Property("t", "text")]))
    col = db.get_collection("Crash")
    col.batch_put([{"properties": {"t": f"doc {i}"},
                    "vector": np.ones(4, np.float32) * i}
                   for i in range(5)])
    # crash-sim: abandon without close, reopen from disk
    recovery.reset()
    db2 = Database(d, sync_wal=True, device="cpu")
    srv = RestServer(db2)
    srv.start()
    try:
        with urllib.request.urlopen(
                f"http://{srv.address}/v1/debug/storage", timeout=10) as r:
            out = json.loads(r.read())
        assert out["config"]["syncWal"] is True
        assert out["totals"]["frames_replayed"] > 0
        assert out["totals"]["buckets"] > 0
        recovered = [b for b in out["buckets"] if not b["clean"]]
        assert recovered, out["buckets"]
        assert "Crash" in db2.collections  # schema survived the crash
    finally:
        srv.stop()
        db2.close()


# -- the deterministic crashpoint matrix (tier-1 acceptance gate) ---------------

from tools.crashtest_torch.harness import POINT_PLANS, run_one, run_sweep  # noqa: E402

_MATRIX = [(p, v, s) for p in faultline.CRASHPOINTS
           for v, s in POINT_PLANS[p]]


def test_every_crashpoint_has_a_matrix_plan():
    """The matrix sweeps faultline.CRASHPOINTS exactly — adding a
    crashpoint without a kill plan must fail loudly here."""
    assert set(POINT_PLANS) == set(faultline.CRASHPOINTS)


@pytest.mark.parametrize("point,variant,sched", _MATRIX,
                         ids=[f"{p}.{v}" for p, v, _ in _MATRIX])
def test_crashpoint_matrix(point, variant, sched, tmp_path):
    """Kill a subprocess write-workload at this persistence boundary,
    restart, verify: zero acked-write loss (sync_wal=True), clean
    bucket opens, raft persistence intact, non-empty recovery report."""
    res = run_one(point, variant, sched, str(tmp_path), n_ops=400, seed=0,
                  device="cpu")
    assert res.fired, (
        f"crash schedule at {point} never fired (worker rc="
        f"{res.worker_rc}) — the workload no longer reaches this "
        "boundary; fix POINT_PLANS or the workload")
    assert res.ok, (res.lost, res.phantom)
    assert res.lost == [] and res.phantom == []
    assert res.recovery_nonempty


@pytest.mark.slow
def test_randomized_crash_sweep():
    """Seeded randomized kill rounds over ONE store, the workload
    resuming from its journal each restart — replays bit-for-bit from
    the seed on failure."""
    results = run_sweep(rounds=10, n_ops=400, seed=20260803, device="cpu")
    assert results
    for r in results:
        assert r.ok, (r.point, r.variant, r.lost, r.phantom)


def test_crashtest_needs_cuda_unless_cpu_is_named(tmp_path, monkeypatch):
    """Like every port entry point, the harness raises without CUDA and
    without an explicit ``device="cpu"`` (it spawns no worker first)."""
    import subprocess
    import sys

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_one("wal.create", "kill", POINT_PLANS["wal.create"][0][1],
                str(tmp_path))
    assert not os.listdir(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card in the child
    for args in (["tools.crashtest_torch"],
                 ["tools.crashtest_torch.workload", "run", str(tmp_path)]):
        proc = subprocess.run([sys.executable, "-m", *args], cwd=root, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr, proc.stderr[-2000:]
    assert not os.listdir(tmp_path)
