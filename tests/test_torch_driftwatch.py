"""Driftwatch in the port, held to the JAX package's tests/test_driftwatch.py.

The band-classification units run through both packages' modules (the
same ``tools.benchkeeper.core.compare`` underneath) and must agree. The
canary lifecycle runs against the port's ``Database`` on the CPU and is
compared with the JAX package's on the same seeded corpus: the same
probe doc ids, recall 1.0 in both. The live-telemetry incident is made
deterministic: instead of a faultline sleep measured on the host clock
(the JAX test's timing flake), the batcher's residency comes from a
stand-in for the card's CUDA-event pair whose elapsed time the test sets:
1 ms a dispatch while the baseline seals, 100 ms during the incident
(far outside the 75% band), 1 ms again to heal.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from weaviate_tpu.runtime import driftwatch as jdw
from weaviate_tpu_torch.runtime import (degrade, driftwatch, kernelscope,
                                        tailboard)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolation():
    driftwatch.reset_for_tests()
    kernelscope.reset_for_tests()
    degrade.reset()
    yield
    driftwatch.reset_for_tests()
    kernelscope.reset_for_tests()
    tailboard.reset_for_tests()
    degrade.reset()
    from weaviate_tpu_torch.runtime import faultline

    faultline.disarm()


@pytest.fixture(params=["jax", "torch"])
def dw(request):
    return jdw if request.param == "jax" else driftwatch


# -- leg 2 units: parity with the benchkeeper CLI ---------------------------------


def _section(ewma_ms: float) -> dict:
    return {"residency": {"flat/b8/k16": {"ewma_ms": ewma_ms,
                                          "last_ms": ewma_ms,
                                          "n": 5, "source": "drain"}},
            "counters": {"compile_miss_per_cycle_p1": 1.0,
                         "overlap_per_cycle_p1": 1.0}}


def test_live_classification_is_benchkeeper_band_math(dw):
    from tools.benchkeeper import core as bk

    fp = {"platform": "gpu"}
    baseline = dw.seal_live_baseline(_section(2.0), fp)
    bk.validate_baseline(baseline, "<test>")
    for value, want in ((2.5, "pass"), (20.0, "regression"), (0.2, "stale")):
        verdict = dw.classify_live(_section(value), baseline, fp)
        direct = bk.compare({"env_fingerprint": fp,
                             "sections": {"live": _section(value)}}, baseline)
        by_id = {r["id"]: r["status"] for r in verdict["entries"]}
        assert by_id["live.residency.flat/b8/k16"] == want
        assert [(r["id"], r["status"], r["delta_frac"])
                for r in verdict["entries"]] == \
            [(r["id"], r["status"], r["delta_frac"])
             for r in direct["entries"]]


@pytest.mark.parametrize("sealed_on", ["tpu", "cpu"])
def test_refused_fingerprint_matches_cli_and_does_not_flip_health(sealed_on):
    """A baseline sealed on a TPU (the JAX package's) or on the CPU
    refuses the comparison with the card's live fingerprint, in both
    packages' classifiers, and refusal flips no health."""
    card = {"torch": "2.11.0+cu128", "platform": "gpu",
            "device_name": "NVIDIA H100 80GB HBM3", "device_count": 1}
    other = {"tpu": {"jax": "0.9.0", "platform": "tpu", "device_count": 1},
             "cpu": dict(card, platform="cpu", device_name="x86_64")}[sealed_on]
    seal = driftwatch if sealed_on == "cpu" else jdw
    baseline = seal.seal_live_baseline(_section(2.0), other)
    for mod in (jdw, driftwatch):
        verdict = mod.classify_live(_section(50.0), baseline, card)
        assert verdict["refused"] and not verdict["ok"]
        assert verdict["entries"] == []
        findings = mod._live_findings(verdict)
        assert [f["kind"] for f in findings] == ["refused"]
        assert not findings[0]["flips_health"]


def test_stale_is_visible_but_not_an_incident(dw):
    baseline = dw.seal_live_baseline(_section(2.0), {"platform": "gpu"})
    verdict = dw.classify_live(_section(0.2), baseline, {"platform": "gpu"})
    assert {f["kind"]: f["flips_health"]
            for f in dw._live_findings(verdict)} == {"stale": False}


def test_cold_compile_poisoned_ewma_is_not_sealed(dw):
    sec = _section(2.0)
    sec["residency"]["flat/b8/k16"].update(ewma_ms=50.0, last_ms=0.5)
    assert dw.seal_live_baseline(sec, {"platform": "gpu"}) is None
    sec["residency"]["flat/b1/k16"] = {"ewma_ms": 0.6, "last_ms": 0.5,
                                       "n": 9, "source": "drain"}
    sealed = {e["id"] for e in dw.seal_live_baseline(
        sec, {"platform": "gpu"})["entries"]}
    assert "live.residency.flat/b1/k16" in sealed
    assert "live.residency.flat/b8/k16" not in sealed


def test_live_fingerprint_names_torch_platform_and_device():
    import torch

    fp = driftwatch.live_fingerprint()
    assert fp["torch"] == torch.__version__
    assert fp["platform"] == ("gpu" if torch.cuda.is_available() else "cpu")
    assert fp["device_count"] >= 1 and fp["device_name"]
    driftwatch.set_device("cpu")
    assert driftwatch.live_fingerprint()["platform"] == "cpu"
    sealed = driftwatch.seal_live_baseline(_section(2.0),
                                           driftwatch.live_fingerprint())
    assert set(sealed["fingerprint"]) == {"platform", "torch", "device_name"}


# -- canary lifecycle against a real Database --------------------------------------


def _mk_db(path, n=32, dim=8, seed=7, pkg="torch"):
    if pkg == "jax":
        from weaviate_tpu.db.database import Database
        from weaviate_tpu.schema.config import CollectionConfig
        db = Database(str(path))
    else:
        from weaviate_tpu_torch.db.database import Database
        from weaviate_tpu_torch.schema.config import CollectionConfig
        db = Database(str(path), device="cpu")
    db.create_collection(CollectionConfig(name="Drift"))
    col = db.get_collection("Drift")
    rng = np.random.default_rng(seed)
    for _ in range(n):
        col.put_object({}, vector=rng.standard_normal(dim).astype(np.float32))
    return db, col


def _only_canary(snap):
    assert len(snap["canaries"]) == 1, snap["canaries"]
    return next(iter(snap["canaries"].values()))


def test_canary_determinism_across_restart(tmp_path):
    """Same seed + same corpus => the JAX package's probe set, recall 1.0,
    across a close/reopen (close unregisters the canary)."""
    jdb, _ = _mk_db(tmp_path / "jax", pkg="jax")
    try:
        jdb.cycles.run_now("driftwatch")
        want = _only_canary(jdw.snapshot())
    finally:
        jdb.close()
        jdw.reset_for_tests()
    db, _ = _mk_db(tmp_path / "t")
    assert db.cycles.run_now("driftwatch")
    first = _only_canary(driftwatch.snapshot())
    assert first["last"]["recall"] == 1.0 and first["last"]["probes"] == 8
    assert first["probe_doc_ids"] == want["probe_doc_ids"]
    db.close()
    assert driftwatch.snapshot()["canaries"] == {}
    from weaviate_tpu_torch.db.database import Database

    db2 = Database(str(tmp_path / "t"), device="cpu")
    try:
        db2.cycles.run_now("driftwatch")
        again = _only_canary(driftwatch.snapshot())
        assert again["probe_doc_ids"] == first["probe_doc_ids"]
        assert again["last"]["recall"] == 1.0
    finally:
        db2.close()


def test_epoch_change_reseals_ground_truth(tmp_path):
    db, col = _mk_db(tmp_path)
    try:
        db.cycles.run_now("driftwatch")
        before = _only_canary(driftwatch.snapshot())
        rng = np.random.default_rng(99)
        for _ in range(32):
            col.put_object({}, vector=rng.standard_normal(8).astype(np.float32))
        db.cycles.run_now("driftwatch")
        after = _only_canary(driftwatch.snapshot())
        assert after["epoch_token"] != before["epoch_token"]
        assert after["probe_doc_ids"] != before["probe_doc_ids"]
        assert after["last"]["recall"] == 1.0
    finally:
        db.close()


def test_oversized_corpus_is_skipped_with_reason(tmp_path, monkeypatch):
    monkeypatch.setenv("WEAVIATE_TPU_DRIFT_CANARY_MAX_ROWS", "4")
    db, _ = _mk_db(tmp_path)
    try:
        db.cycles.run_now("driftwatch")
        c = _only_canary(driftwatch.snapshot())
        assert "over WEAVIATE_TPU_DRIFT_CANARY_MAX_ROWS" in c["skipped"]
        assert driftwatch.snapshot()["gateOk"]
    finally:
        db.close()


# -- the incidents ------------------------------------------------------------------


def _shard(col):
    (shard,) = col.shards.values()
    return shard


def _searches(shard, n, dim=8, seed=3):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        shard.vector_search(rng.standard_normal(dim).astype(np.float32), 10)


class _DeviceClock:
    """A stand-in for the card's pooled CUDA-event pair: every dispatch
    'spends' ``ms`` of device time, set by the test."""

    def __init__(self, ms):
        self.ms = ms

    def start_timer(self, device):
        clock = self

        class _Pair:
            def stop(self):
                pass

            def elapsed_s(self):
                return clock.ms / 1000.0

            def release(self):
                pass

        return _Pair()


def test_injected_dispatch_latency_trips_live_finding(tmp_path, monkeypatch):
    """The incident chain, deterministic: residency 100x the sealed level
    => typed ``live`` regression => ``drift:live`` unhealthy =>
    flight-recorder snapshot on disk => clean traffic clears it all."""
    clock = _DeviceClock(1.0)
    monkeypatch.setattr(kernelscope, "start_timer", clock.start_timer)
    db, col = _mk_db(tmp_path)
    try:
        shard = _shard(col)
        assert shard.async_pipeline
        _searches(shard, 40)
        db.cycles.run_now("driftwatch")
        snap = driftwatch.snapshot()
        assert snap["gateOk"] and snap["live"]["baselineSource"]
        clock.ms = 100.0  # far outside the 75% band
        _searches(shard, 8)
        db.cycles.run_now("driftwatch")
        snap = driftwatch.snapshot()
        assert not snap["gateOk"]
        live = [f for f in snap["findings"]
                if f["leg"] == "live" and f["kind"] == "regression"]
        assert live and live[0]["flips_health"]
        assert live[0]["delta_frac"] > 10
        assert "drift:live" in degrade.health()["unhealthy"]
        assert glob.glob(str(tmp_path / "flightrecorder" / "flight-*"))
        clock.ms = 1.0
        _searches(shard, 40)
        db.cycles.run_now("driftwatch")
        snap = driftwatch.snapshot()
        assert snap["gateOk"], snap["findings"]
        assert degrade.health()["healthy"]
    finally:
        db.close()


def test_sabotaged_id_mapping_trips_canary_recall_finding(tmp_path, monkeypatch):
    """A permuted slot -> doc-id map trips the canary's recall finding on
    the next cycle and health flips; undone, the gate clears. The
    stand-in device clock keeps the live leg out of it."""
    monkeypatch.setattr(kernelscope, "start_timer", _DeviceClock(1.0).start_timer)
    db, col = _mk_db(tmp_path)
    try:
        db.cycles.run_now("driftwatch")
        assert _only_canary(driftwatch.snapshot())["last"]["recall"] == 1.0
        idx = _shard(col).vector_indexes[""]
        live = int(len(idx))
        idx._slot_to_id[:live] = np.roll(idx._slot_to_id[:live], 1)
        db.cycles.run_now("driftwatch")
        snap = driftwatch.snapshot()
        assert not snap["gateOk"]
        recall = [f for f in snap["findings"]
                  if f["leg"] == "canary" and f["kind"] == "recall"]
        assert recall and recall[0]["flips_health"]
        assert _only_canary(snap)["last"]["recall"] < 0.5
        assert "drift:canary" in degrade.health()["unhealthy"]
        assert glob.glob(str(tmp_path / "flightrecorder" / "flight-*"))
        idx._slot_to_id[:live] = np.roll(idx._slot_to_id[:live], -1)
        db.cycles.run_now("driftwatch")
        assert driftwatch.snapshot()["gateOk"]
        assert degrade.health()["healthy"]
    finally:
        db.close()


# -- history ring, offline replay, debug route, scrape --------------------------------


def test_history_ring_and_offline_replay(tmp_path, monkeypatch):
    """The port's history replays with ``python -m tools.driftwatch``
    (0 clean, 1 regressed) against the baseline it sealed. The residency
    comes from the stand-in device clock, so host load cannot open a
    live finding between the two cycles."""
    monkeypatch.setattr(kernelscope, "start_timer", _DeviceClock(1.0).start_timer)
    db, col = _mk_db(tmp_path)
    try:
        _searches(_shard(col), 6)
        db.cycles.run_now("driftwatch")
        db.cycles.run_now("driftwatch")
    finally:
        db.close()
    hist = tmp_path / "driftwatch" / "history.jsonl"
    records = [json.loads(line) for line in hist.read_text().splitlines()]
    assert len(records) == 2 and all(r["gate_ok"] for r in records)
    assert records[0]["canaries"][0]["recall"] == 1.0
    assert records[0]["fingerprint"]["platform"] == "cpu"
    assert (tmp_path / "driftwatch" / "live_baseline.json").exists()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    clean = subprocess.run([sys.executable, "-m", "tools.driftwatch",
                            str(tmp_path)], capture_output=True, text=True,
                           env=env, cwd=REPO_ROOT)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "GATE PASS" in clean.stdout
    doctored = json.loads(json.dumps(records[-1]))
    for v in doctored["live"]["metrics"]["residency"].values():
        v["ewma_ms"] = (v["ewma_ms"] or 0.0) * 10 + 100.0
    with open(hist, "a") as f:
        f.write(json.dumps(doctored) + "\n")
    bad = subprocess.run([sys.executable, "-m", "tools.driftwatch",
                          str(tmp_path), "--json"], capture_output=True,
                         text=True, env=env, cwd=REPO_ROOT)
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert [json.loads(x) for x in bad.stdout.splitlines()][-1][
        "regressions"] >= 1


def test_drift_debug_endpoint_serves_snapshot(tmp_path):
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.api.rest import DEBUG_ENDPOINTS, RestServer

    assert "drift" in DEBUG_ENDPOINTS
    db, _ = _mk_db(tmp_path)
    srv = RestServer(db)
    srv.start()
    try:
        db.cycles.run_now("driftwatch")
        out = Client(srv.address).request("GET", "/v1/debug/drift")
        assert out["gateOk"] is True and out["cycle"] == 1
        assert _only_canary(out)["last"]["recall"] == 1.0
    finally:
        srv.stop()
        db.close()


def test_gate_gauge_defaults_healthy_on_scrape():
    from weaviate_tpu_torch.runtime import metrics

    body, _ = metrics.scrape()
    assert b"weaviate_tpu_drift_gate_ok 1.0" in body


def test_compile_cache_events_feed_the_live_section(monkeypatch):
    """The kernel build's hit / miss events reach ``compile_cache_events``
    (and ``jit_compile_duration`` for nvcc), which driftwatch's live
    section reads; a loaded library adds one flat ledger estimate."""
    from weaviate_tpu_torch.ops import _build
    from weaviate_tpu_torch.runtime import compile_cache, metrics
    from weaviate_tpu_torch.runtime.hbm_ledger import ledger

    monkeypatch.setattr(compile_cache, "_metrics_installed", False)
    monkeypatch.setattr(compile_cache, "_done", False)
    hits0 = metrics.compile_cache_events.labels("hit").value
    _build._emit("hit", "bm25_block")  # before install: not counted
    assert metrics.compile_cache_events.labels("hit").value == hits0
    compile_cache.ensure_compile_cache()
    miss0 = driftwatch.live_section()["counters"]["compile_miss_total"]
    est0 = compile_cache._exec_count
    _build._emit("miss", "distance_block", 12.5)
    _build._emit("hit", "bm25_block")
    _build._emit("loaded", "distance_block")
    assert metrics.compile_cache_events.labels("hit").value == hits0 + 1
    sec = driftwatch.live_section()["counters"]
    assert sec["compile_miss_total"] == miss0 + 1
    assert compile_cache._exec_count == est0 + 1
    assert ledger.shard_component_bytes("_runtime", "-")["executables"] == \
        (4 << 20) * compile_cache._exec_count
