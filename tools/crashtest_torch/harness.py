"""Crash matrix harness: spawn worker, kill at a crashpoint, verify.

Every entry takes ``device`` (default ``"cuda"``), passed to the worker
as ``--device`` and used by the in-process verifier: on the card the
HNSW index reopens there; without CUDA only ``"cpu"`` runs.

The worker runs in a SUBPROCESS because a crashpoint is a real
``os._exit(137)`` — in-process simulation would keep Python state alive
and prove nothing about what reached the kernel. Verification runs
in-process by default (same machine, same page cache — what the dead
process ``write()``d is visible; what a ``torn`` schedule withheld is
genuinely absent, which is how the byte-boundary cases bite).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import tempfile
from dataclasses import asdict, dataclass, field

from weaviate_tpu_torch.device import resolve
from weaviate_tpu_torch.runtime import faultline

#: per-point schedule plans: which call index to kill at, tuned so every
#: point fires inside the default 400-op workload (the matrix FAILS a
#: point whose schedule never fired — silent no-coverage is a result,
#: not a skip). Entries are (suffix, schedule-kwargs) so one point can
#: run several byte-boundary variants (clean kill + torn writes).
POINT_PLANS: dict[str, list[tuple[str, dict]]] = {
    "wal.append.pre_fsync": [
        ("kill", {"action": "crash", "nth": 40}),
        ("torn5", {"action": "torn", "nth": 40, "torn_bytes": 5}),
        ("torn13", {"action": "torn", "nth": 40, "torn_bytes": 13}),
    ],
    "wal.append.post_fsync": [("kill", {"action": "crash", "nth": 40})],
    "wal.create": [("kill", {"action": "crash", "nth": 6})],
    "segment.write.mid": [
        ("kill", {"action": "crash", "nth": 9}),
        ("torn3", {"action": "torn", "nth": 9, "torn_bytes": 3}),
    ],
    "segment.write.pre_rename": [("kill", {"action": "crash", "nth": 1})],
    "segment.post_rename": [("kill", {"action": "crash", "nth": 1})],
    "raft.persist.meta": [("kill", {"action": "crash", "nth": 0})],
    "raft.persist.log": [("kill", {"action": "crash", "nth": 6})],
    "raft.persist.snapshot": [("kill", {"action": "crash", "nth": 0})],
    "hnsw.snap.pre_replace": [("kill", {"action": "crash", "nth": 0})],
    "hnsw.snap.post_replace": [("kill", {"action": "crash", "nth": 0})],
}


@dataclass
class CrashResult:
    point: str
    variant: str
    worker_rc: int
    fired: bool             # worker died at the scheduled point
    ok: bool                # invariants held after restart
    journaled_ops: int = 0
    lost: list[str] = field(default_factory=list)
    phantom: list[str] = field(default_factory=list)
    recovery_nonempty: bool = False
    hnsw_device: str = ""   # where the verifier reopened the HNSW index

    def to_dict(self) -> dict:
        return asdict(self)


def _spawn_worker(base: str, spec: list[dict], n_ops: int, seed: int,
                  start: int = 0, timeout: float = 120.0,
                  device: str = "cuda") -> int:
    env = dict(os.environ)
    env["WEAVIATE_TPU_FAULTLINE"] = json.dumps(spec)
    proc = subprocess.run(
        [sys.executable, "-m", "tools.crashtest_torch.workload", "run", base,
         "--ops", str(n_ops), "--seed", str(seed), "--start", str(start),
         "--device", device],
        env=env, timeout=timeout,
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
    return proc.returncode


def _verify_inproc(base: str, n_ops: int, seed: int,
                   device: str = "cuda") -> dict:
    from weaviate_tpu_torch.storage import recovery

    recovery.reset()  # scope the report to THIS restart
    from tools.crashtest_torch.workload import verify

    return verify(base, n_ops, seed, device=device)


def verify_dir(base: str, n_ops: int = 400, seed: int = 0,
               device: str = "cuda") -> dict:
    """Public in-process verification entry (tests use this)."""
    return _verify_inproc(base, n_ops, seed, device)


def run_one(point: str, variant: str, sched: dict, base: str,
            n_ops: int = 400, seed: int = 0,
            device: str = "cuda") -> CrashResult:
    """One kill-restart-verify cycle at ``point`` in a fresh ``base``."""
    return run_side_by_side([(point, variant, sched, base)], n_ops, seed,
                            device)[0]


def run_side_by_side(cases, n_ops: int = 400, seed: int = 0,
                     device: str = "cuda") -> list[CrashResult]:
    """``run_one`` over ``cases`` of (point, variant, sched, base): the
    workers run side by side, each in its own ``base``, then each store
    is verified in turn (the recovery report is the process's own)."""
    from concurrent.futures import ThreadPoolExecutor

    resolve(device)  # no CUDA and no "cpu": raise before any worker

    def spawn(case):
        point, _variant, sched, base = case
        return _spawn_worker(base, [dict(sched, point=point, times=1)],
                             n_ops, seed, device=device)

    with ThreadPoolExecutor(max(1, len(cases))) as pool:
        rcs = list(pool.map(spawn, cases))
    return [_verified(case, rc, n_ops, seed, device)
            for case, rc in zip(cases, rcs)]


def _verified(case, rc: int, n_ops: int, seed: int,
              device: str) -> CrashResult:
    point, variant, sched, base = case
    fired = rc == sched.get("exit_code", 137)
    if not fired:
        # the schedule never fired (rc 0) or the worker failed some
        # other way — either is a matrix failure, not a pass
        return CrashResult(point, variant, rc, fired=False, ok=False)
    report = _verify_inproc(base, n_ops, seed, device)
    totals = report["recovery"]["totals"]
    return CrashResult(
        point, variant, rc, fired=True, ok=report["ok"],
        journaled_ops=report["journaled_ops"],
        lost=report["lost_acked_writes"],
        phantom=report["phantom_or_mismatched"],
        hnsw_device=report["hnsw_device"],
        recovery_nonempty=bool(totals["buckets"]) and (
            totals["frames_replayed"] > 0 or totals["bytes_truncated"] > 0
            or totals["wals_quarantined"] > 0
            or totals["wal_files_replayed"] > 0))


def run_matrix(base_dir: str | None = None, points=None, n_ops: int = 400,
               seed: int = 0, device: str = "cuda") -> list[CrashResult]:
    """The deterministic sweep: every named crashpoint (plus torn-write
    variants), each in its own directory."""
    own = base_dir is None
    base_dir = base_dir or tempfile.mkdtemp(prefix="crashtest-")
    points = list(points or faultline.CRASHPOINTS)
    results = []
    for point in points:
        for variant, sched in POINT_PLANS.get(
                point, [("kill", {"action": "crash", "nth": 0})]):
            base = os.path.join(base_dir, f"{point}.{variant}")
            os.makedirs(base, exist_ok=True)
            results.append(run_one(point, variant, sched, base,
                                   n_ops=n_ops, seed=seed, device=device))
    if own:
        import shutil

        shutil.rmtree(base_dir, ignore_errors=True)
    return results


def run_sweep(rounds: int = 8, n_ops: int = 400, seed: int = 0,
              base: str | None = None,
              device: str = "cuda") -> list[CrashResult]:
    """Randomized kill-restart-verify: ONE store, the workload resuming
    from its journal after every crash, the (point, action, nth) drawn
    from a seeded stream — a failing round replays bit-for-bit."""
    resolve(device)
    rng = random.Random(seed)
    own = base is None
    base = base or tempfile.mkdtemp(prefix="crashsweep-")
    results = []
    candidates = [(p, v, s) for p, plans in POINT_PLANS.items()
                  for v, s in plans]
    for rnd in range(rounds):
        point, variant, sched = candidates[rng.randrange(len(candidates))]
        sched = dict(sched, nth=rng.randrange(0, 30))
        start = _journal_ops(base)
        spec = [dict(sched, point=point, times=1)]
        rc = _spawn_worker(base, spec, n_ops, seed, start=start,
                           device=device)
        crashed = rc == sched.get("exit_code", 137)
        if not crashed and rc != 0:
            results.append(CrashResult(point, f"sweep{rnd}.{variant}", rc,
                                       fired=False, ok=False))
            continue
        report = _verify_inproc(base, n_ops, seed, device)
        # a draw whose nth lands past the remaining workload completes
        # cleanly (rc 0) — the verify still ran, so the round counts as
        # ok (randomized sweeps legitimately include non-firing draws),
        # but ``fired`` reports what actually happened: a sweep whose
        # draws STOP firing must be visible, not report crash coverage
        # it no longer has
        results.append(CrashResult(
            point, f"sweep{rnd}.{variant}", rc, fired=crashed,
            ok=report["ok"], journaled_ops=report["journaled_ops"],
            lost=report["lost_acked_writes"],
            phantom=report["phantom_or_mismatched"],
            recovery_nonempty=True))
        if report["journaled_ops"] >= n_ops:
            break  # workload complete — nothing left to crash
    if own:
        import shutil

        shutil.rmtree(base, ignore_errors=True)
    return results


def _journal_ops(base: str) -> int:
    from tools.crashtest_torch.workload import _journal_count

    return _journal_count(base)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="crashtest",
        description="kill-restart-verify crash harness "
                    "(deterministic matrix over faultline.CRASHPOINTS)")
    ap.add_argument("--ops", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", type=int, default=0,
                    help="run N randomized kill rounds instead of the "
                         "deterministic matrix")
    ap.add_argument("--keep", default="",
                    help="run in this directory and keep the state")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the workers and the verifier open the HNSW "
                         "index (default cuda; raises without CUDA unless "
                         "cpu is named)")
    args = ap.parse_args(argv)
    resolve(args.device)
    if args.sweep:
        results = run_sweep(rounds=args.sweep, n_ops=args.ops,
                            seed=args.seed, base=args.keep or None,
                            device=args.device)
    else:
        results = run_matrix(base_dir=args.keep or None, n_ops=args.ops,
                             seed=args.seed, device=args.device)
    # run_one already folds not-fired into ok=False for the matrix;
    # sweep rounds that completed cleanly are ok with fired=False
    ok = all(r.ok for r in results)
    if args.json:
        print(json.dumps({"ok": ok,
                          "results": [r.to_dict() for r in results]},
                         indent=2))
    else:
        for r in results:
            status = "PASS" if r.ok else \
                ("NOT-FIRED" if not r.fired else "FAIL")
            print(f"{status:9s} {r.point:28s} {r.variant:10s} "
                  f"rc={r.worker_rc} journaled={r.journaled_ops} "
                  f"lost={len(r.lost)} phantom={len(r.phantom)}")
            for msg in (r.lost + r.phantom)[:5]:
                print(f"          {msg}")
        print(("crash matrix: all invariants held"
               if ok else "crash matrix: FAILURES above"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
