"""The port's harnesses held to the JAX package's: tools/clusterchaos_torch
and tools/crashtest_torch against tools/clusterchaos and tools/crashtest.

The scenario matrix, the sweep's generated specs, the crash plans, the
op sequence and its oracle are the JAX tools' values. Then a directory
crashed by the JAX worker (``python -m tools.crashtest.workload run``)
at three plans whose files both packages write alike is verified by the
JAX verifier and by the port's (on the CPU), each on its own copy: the
two reports are equal (verdict, journal, lost and phantom writes, the
Raft meta check and the recovery counters).
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

import tools.clusterchaos.harness as j_chaos
import tools.clusterchaos_torch.harness as t_chaos
import tools.crashtest.harness as j_crash
import tools.crashtest.workload as j_work
import tools.crashtest_torch.harness as t_crash
import tools.crashtest_torch.workload as t_work
from tools.clusterchaos import checker as j_checker
from tools.clusterchaos_torch import checker as t_checker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_scenarios_equal_the_jax_tools():
    assert list(t_chaos.SCENARIOS) == list(j_chaos.SCENARIOS)
    assert t_chaos.SCENARIOS == j_chaos.SCENARIOS
    assert len(t_chaos.SCENARIOS) == 13
    assert set(t_checker.PROBES) == set(j_checker.PROBES)


@pytest.mark.parametrize("seed", [0, 5, 1234, 20260803])
def test_sweep_specs_equal_the_jax_tools(seed):
    for rnd in range(6):
        assert t_chaos.sweep_spec(seed, rnd) == j_chaos.sweep_spec(seed, rnd)


def test_crash_plans_equal_the_jax_tools():
    from weaviate_tpu.runtime import faultline as j_faultline
    from weaviate_tpu_torch.runtime import faultline as t_faultline

    assert t_crash.POINT_PLANS == j_crash.POINT_PLANS
    assert tuple(t_faultline.CRASHPOINTS) == tuple(j_faultline.CRASHPOINTS)
    assert set(t_crash.POINT_PLANS) == set(t_faultline.CRASHPOINTS)


@pytest.mark.parametrize("n_ops,seed", [(400, 0), (400, 7), (1000, 20260803)])
def test_op_sequence_and_oracle_equal_the_jax_tools(n_ops, seed):
    ops = t_work.op_sequence(n_ops, seed)
    assert ops == j_work.op_sequence(n_ops, seed)
    for upto in (0, 1, 61, 97, 250, n_ops):
        assert t_work.simulate(ops, upto) == j_work.simulate(ops, upto)
    assert [t_work.touched_key(op) for op in ops] \
        == [j_work.touched_key(op) for op in ops]
    assert t_work.HNSW_DIM == j_work.HNSW_DIM
    for doc in (0, 7, 399):
        assert (t_work.hnsw_vector(doc) == j_work.hnsw_vector(doc)).all()


def _crash_with_the_jax_worker(base: str, point: str, sched: dict) -> int:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               WEAVIATE_TPU_FAULTLINE=json.dumps([dict(sched, point=point,
                                                       times=1)]))
    proc = subprocess.run(
        [sys.executable, "-m", "tools.crashtest.workload", "run", base,
         "--ops", "400", "--seed", "0"],
        env=env, cwd=ROOT, timeout=300)
    return proc.returncode


def _report_view(report: dict) -> dict:
    return {
        "ok": report["ok"],
        "journaled_ops": report["journaled_ops"],
        "total_ops": report["total_ops"],
        "lost": report["lost_acked_writes"],
        "phantom": report["phantom_or_mismatched"],
        "raft_meta_ok": report["raft_meta_ok"],
        "totals": report["recovery"]["totals"],
    }


@pytest.mark.parametrize("point,variant", [
    ("wal.append.pre_fsync", "torn5"),
    ("segment.write.mid", "torn3"),
    ("raft.persist.log", "kill"),
])
def test_jax_crashed_directory_verifies_equally(tmp_path, point, variant):
    sched = dict(j_crash.POINT_PLANS[point])[variant]
    crashed = str(tmp_path / "crashed")
    os.makedirs(crashed)
    rc = _crash_with_the_jax_worker(crashed, point, sched)
    assert rc == sched.get("exit_code", 137), f"the JAX worker did not crash at {point}"
    # each verifier reopens (and so repairs) its own copy
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(crashed, j_dir)
    shutil.copytree(crashed, t_dir)
    j_rep = j_crash.verify_dir(j_dir, n_ops=400, seed=0)
    t_rep = t_crash.verify_dir(t_dir, n_ops=400, seed=0, device="cpu")
    assert _report_view(t_rep) == _report_view(j_rep)
    assert t_rep["ok"] and t_rep["journaled_ops"] > 0
    assert t_rep["recovery"]["totals"]["buckets"] > 0
