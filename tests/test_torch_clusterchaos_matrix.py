"""The clusterchaos scenario matrix over the port (tools/clusterchaos_torch:
three port ClusterNodes on the CPU, one of them a subprocess in the crash
scenarios): every scenario's verdict ok with every event fired, the two
sabotage checks, and a sweep round replayed from its seed.

A copy of sections 2-4 of tests/test_clusterchaos.py (the matrix, the
sabotage validation, the sweep), with the port's modules. A sabotage
check reverts exactly one hardening of the port's ``Shard`` and keeps the
rest of its bookkeeping (the digest version its writes bump), so the
scenario fails for the named invariant and no other reason. The
randomized sweep is ``slow`` here as in the JAX file.
"""

import json

import pytest

from weaviate_tpu_torch.cluster import transport
from weaviate_tpu_torch.db.shard import Shard
from weaviate_tpu_torch.replication.hashbeater import replication_status
from weaviate_tpu_torch.runtime import faultline
from weaviate_tpu_torch.storage.objects import StorageObject

from tools.clusterchaos_torch.harness import (
    SCENARIOS,
    run_scenario,
    run_sweep,
    sweep_spec,
)

DEVICE = "cpu"


@pytest.fixture(autouse=True)
def _port_cluster_isolation():
    """The conftest resets the JAX package's planes; the port keeps its
    own faultline, degrade, breakers and replication registry."""
    yield
    from weaviate_tpu_torch.runtime import degrade

    faultline.disarm()
    faultline.heal()
    degrade.reset()
    transport.reset_breakers()
    replication_status.reset()


def _failures(verdict: dict) -> str:
    return json.dumps([i for i in verdict["invariants"] if not i["ok"]],
                      indent=2)


# -- the deterministic scenario matrix ------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_matrix_scenario(name):
    verdict = run_scenario(SCENARIOS[name], device=DEVICE)
    assert verdict["ok"], (
        f"scenario {name} (seed {verdict['seed']}) violated: "
        f"{_failures(verdict)}")
    # the schedule really happened: scenarios with events must have
    # fired them all (a schedule that never fired is no coverage)
    expected = len(SCENARIOS[name].get("events", []))
    assert len(verdict["events_fired"]) == expected


# -- sabotage validation ----------------------------------------------------------


def test_sabotage_staged_ttl_revert_fails_named_scenario(monkeypatch):
    """Revert the staged-2PC TTL hardening (commit-time refusal +
    configurable gc) back to the pre-fix behavior: the
    reply_loss_staged_ttl scenario must FAIL with the no_late_commit
    invariant attributed. The legacy commit applies through the port's
    own put_object_batch / delete_object, which keep the digest
    version current."""

    def legacy_commit_staged(self, request_id):
        with self._lock:
            entry = self._staged.pop(request_id, None)
        if entry is None:
            raise KeyError(f"unknown replication request {request_id!r}")
        _t, task = entry
        kind = task[0]
        if kind == "put":
            return self.put_object_batch(task[1])
        if kind == "delete":
            return self.delete_object(task[1], tombstone_ms=task[2])
        raise ValueError(kind)

    def legacy_gc_staged(self):
        import time as _time

        cutoff = _time.monotonic() - 120.0  # the old hard-coded TTL
        with self._lock:
            stale = [rid for rid, (t, _task) in self._staged.items()
                     if t < cutoff]
            for rid in stale:
                del self._staged[rid]
        return len(stale)

    monkeypatch.setattr(Shard, "commit_staged", legacy_commit_staged)
    monkeypatch.setattr(Shard, "gc_staged", legacy_gc_staged)
    verdict = run_scenario(SCENARIOS["reply_loss_staged_ttl"], device=DEVICE)
    assert not verdict["ok"], \
        "sabotaged staged-TTL path passed — the checker cannot see it"
    bad = {i["name"] for i in verdict["invariants"] if not i["ok"]}
    assert "no_late_commit" in bad, bad


def test_sabotage_migration_marker_revert_fails_named_scenario(monkeypatch):
    """Revert apply_sync's durable-marker check: hashbeat_vs_migration
    must FAIL with migration_marker_respected attributed. The legacy
    version is the port's apply_sync (one batched put, digest version
    bumped on every tombstone) without the marker check."""
    from weaviate_tpu_torch.replication.hashtree import digest_rank

    def legacy_apply_sync(self, raw_objects, deletes):
        applied = 0
        with self._lock:
            wins = {}
            for raw in raw_objects:
                obj = StorageObject.from_bytes(raw)
                mine = wins.get(obj.uuid, (None, None))[1] \
                    or self.object_digest(obj.uuid)
                incoming = {"mtime": obj.last_update_time_ms,
                            "deleted": False, "hash": obj.content_hash()}
                if mine is not None and \
                        digest_rank(mine) >= digest_rank(incoming):
                    continue
                obj.doc_id = 0
                wins[obj.uuid] = (obj, incoming)
            if wins:
                self.put_object_batch([o for o, _d in wins.values()])
                applied += len(wins)
            for d in deletes:
                mine = self.object_digest(d["uuid"])
                incoming = {"mtime": d["mtime"], "deleted": True,
                            "hash": b""}
                if mine is None:
                    self.tombstones.put(d["uuid"].encode(), d["mtime"])
                    self._digest_version += 1
                    applied += 1
                    continue
                if digest_rank(mine) >= digest_rank(incoming):
                    continue
                if mine["deleted"]:
                    self.tombstones.put(d["uuid"].encode(), d["mtime"])
                    self._digest_version += 1
                else:
                    self.delete_object(d["uuid"], tombstone_ms=d["mtime"])
                applied += 1
        return applied

    monkeypatch.setattr(Shard, "apply_sync", legacy_apply_sync)
    verdict = run_scenario(SCENARIOS["hashbeat_vs_migration"], device=DEVICE)
    assert not verdict["ok"], \
        "sabotaged marker check passed — the checker cannot see it"
    bad = {i["name"] for i in verdict["invariants"] if not i["ok"]}
    assert "migration_marker_respected" in bad, bad


# -- sweep replayability ------------------------------------------------------------


def test_sweep_round_replays_from_seed():
    """A randomized sweep round is fully replayable from its printed
    seed: identical generated schedule, same verdict."""
    assert sweep_spec(5, 2) == sweep_spec(5, 2)
    spec = sweep_spec(5, 2)
    v1 = run_scenario(spec, device=DEVICE)
    v2 = run_scenario(spec, device=DEVICE)
    assert v1["ok"] and v2["ok"], (_failures(v1), _failures(v2))
    assert [e["do"] for e in v1["events_fired"]] \
        == [e["do"] for e in v2["events_fired"]]
    assert v1["scenario"] == v2["scenario"] == spec["name"]


@pytest.mark.slow
def test_randomized_sweep():
    verdicts = run_sweep(rounds=6, seed=1234, device=DEVICE)
    bad = [v for v in verdicts if not v["ok"]]
    assert not bad, "\n".join(
        f"{v['scenario']}: replay with {v['sweep']['replay']}\n"
        f"{_failures(v)}" for v in bad)


def test_clusterchaos_needs_cuda_unless_cpu_is_named(monkeypatch, tmp_path):
    """Without CUDA and without ``device="cpu"`` a scenario raises before
    a node starts; so do the CLI and the subprocess node."""
    import os
    import subprocess
    import sys

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_scenario(SCENARIOS["baseline_no_faults"], base_dir=str(tmp_path))
    assert not os.listdir(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card in the child
    for args in (["tools.clusterchaos_torch", "--scenario", "baseline_no_faults"],
                 ["tools.clusterchaos_torch.nodeproc", "n2", str(tmp_path / "n2"),
                  "--port", "1", "--peers", "n0,n1,n2"]):
        proc = subprocess.run([sys.executable, "-m", *args], cwd=root, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr, proc.stderr[-2000:]
    assert not os.path.exists(tmp_path / "n2")
