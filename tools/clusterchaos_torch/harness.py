"""Scenario matrix + seeded randomized sweep for clusterchaos.

Every scenario is a declarative spec: a seeded workload shape plus a
partition/crash event schedule keyed to global op counts. The matrix is
DETERMINISTIC — same spec, same seed, same schedule — and covers the
composition grid of partitions and crashes: symmetric/asymmetric partitions,
flapping links, crash-during-2PC (a subprocess replica dying mid-commit
under a real SIGKILL / os._exit), raft leadership churn under
partition, the staged-2PC TTL heal path, and hashbeat racing an epoch
migration's durable-marker cutover.

``run_sweep`` draws random specs from a seeded stream; any round
replays bit-for-bit via ``sweep_spec(seed, round)`` —
``python -m tools.clusterchaos_torch --sweep-round K --seed S`` is the replay
entry.
"""

from __future__ import annotations

import logging
import os
import random
import shutil
import tempfile
import time

from weaviate_tpu_torch.cluster import transport
from weaviate_tpu_torch.cluster.transport import RpcError
from weaviate_tpu_torch.device import resolve
from weaviate_tpu_torch.runtime import faultline

from tools.clusterchaos_torch import checker
from tools.clusterchaos_torch.checker import PROBES, check_run
from tools.clusterchaos_torch.workload import ChaosCluster, Journal, Workload

logger = logging.getLogger(__name__)


def _spec(name: str, **kw) -> dict:
    base = {
        "name": name,
        "seed": 0,
        "clients": 3,
        "ops_per_client": 14,
        "uuids_per_client": 3,
        "levels": ["QUORUM"],
        "read_levels": ["QUORUM"],
        "mix": {"put": 0.6, "delete": 0.15, "read": 0.25},
        "events": [],
        "max_beat_rounds": 8,
    }
    base.update(kw)
    return base


#: the deterministic matrix (13 scenarios)
SCENARIOS: dict[str, dict] = {s["name"]: s for s in [
    # 1 — checker plumbing sanity: no faults, everything must converge
    _spec("baseline_no_faults", ops_per_client=10),
    # 2 — symmetric minority partition: QUORUM keeps acking via the
    # majority; the minority converges after the heal
    _spec("minority_partition_quorum", events=[
        {"at": 8, "do": "isolate", "node": "n2"},
        {"at": 32, "do": "heal"},
    ]),
    # 3 — ALL during the same partition: strict failures (ambiguous),
    # pre-partition acked writes must still read back at ALL post-heal
    _spec("minority_partition_all", levels=["ALL"], events=[
        {"at": 8, "do": "isolate", "node": "n2"},
        {"at": 32, "do": "heal"},
    ]),
    # 4 — asymmetric one-way loss n0->n2 (n0's requests die; n2 still
    # reaches n0): mixed QUORUM/ALL through both sides of the asymmetry
    _spec("asymmetric_oneway", levels=["QUORUM", "ALL"], events=[
        {"at": 6, "do": "oneway", "src": "n0", "dst": "n2"},
        {"at": 34, "do": "heal"},
    ]),
    # 5 — n2 can receive but not send: prepares LAND on n2 and their
    # acks vanish (the orphaned-staged-entry factory) — the staged TTL
    # must expire them, never commit them late
    _spec("reply_loss_staged_ttl", staged_ttl_s=1.0,
          probes=["staged_ttl"], events=[
              {"at": 6, "do": "oneway", "src": "n2", "dst": "*"},
              {"at": 28, "do": "heal"},
          ]),
    # 6 — flapping link n1<->n2 for most of the run
    _spec("flapping_link", events=[
        {"at": 4, "do": "flap", "src": "n1", "dst": "n2",
         "period": 6, "duty": 3},
        {"at": 38, "do": "heal"},
    ]),
    # 7 — delete-heavy traffic across a partition: acked deletes must
    # not resurrect through hashbeat after the heal
    _spec("partition_during_delete",
          mix={"put": 0.45, "delete": 0.35, "read": 0.2}, events=[
              {"at": 10, "do": "isolate", "node": "n2"},
              {"at": 34, "do": "heal"},
          ]),
    # 8 — raft leadership churn: isolate the leader mid-run, require a
    # new leader, commit schema through it, heal, commit again — every
    # committed schema must exist everywhere (split-brain would lose one)
    _spec("leader_churn", ops_per_client=18, events=[
        {"at": 8, "do": "partition_leader"},
        {"at": 9, "do": "wait_new_leader", "timeout_s": 12.0},
        {"at": 18, "do": "schema", "name": "ChurnDark"},
        {"at": 30, "do": "heal"},
        {"at": 40, "do": "schema", "name": "ChurnHealed"},
    ]),
    # 9 — hashbeat vs epoch migration: a peer pushing a copy of a uuid
    # whose durable marker says "migrated away" must be refused — the
    # anti-entropy side of the durable-marker cutover
    _spec("hashbeat_vs_migration", probes=["migration_markers"],
          ops_per_client=10),
    # 10 — subprocess replica SIGKILLed mid-run and restarted: QUORUM
    # acks survive one node kill and read back at ALL post-restart
    _spec("crash_subprocess_quorum", subprocess_node="n2",
          expect_sub_exit=[-9], events=[
              {"at": 12, "do": "kill"},
              {"at": 28, "do": "restart"},
          ]),
    # 11 — crash DURING 2PC: the subprocess replica os._exit(137)s at a
    # WAL-append crashpoint while applying replicated commits, restarts,
    # recovers, converges. Put-heavy so the append counter reaches nth
    # mid-workload; the await event holds one client until the crash
    # actually landed (the others keep writing to drive it there)
    _spec("crash_during_2pc", subprocess_node="n2",
          expect_sub_exit=[137], ops_per_client=16,
          mix={"put": 0.8, "delete": 0.1, "read": 0.1},
          remote_timeout_s=5.0,  # a CPU-starved replica must still get
          # its prepares/commits — timeouts would starve the crashpoint
          env_faults=[{"point": "wal.append.post_fsync",
                       "action": "crash", "nth": 60}],
          events=[{"at": 22, "do": "await_sub_exit", "timeout_s": 45.0},
                  {"at": 23, "do": "restart"}]),
    # 12 — minority partition PLUS node kill (the acceptance
    # composition): n2 partitioned, then killed, then restarted into
    # the still-partitioned network, then healed
    _spec("partition_plus_crash", subprocess_node="n2",
          levels=["QUORUM", "ALL"], expect_sub_exit=[-9], events=[
              {"at": 8, "do": "isolate", "node": "n2"},
              {"at": 14, "do": "kill"},
              {"at": 26, "do": "restart"},
              {"at": 32, "do": "heal"},
          ]),
    # 13 — one-way loss in the OTHER direction (n2's inbound dies, its
    # outbound lives): replica reads/pulls keep flowing outward while
    # every write to n2 fails — converges post-heal
    _spec("asymmetric_inbound", events=[
        {"at": 6, "do": "oneway", "src": "*", "dst": "n2"},
        {"at": 32, "do": "heal"},
    ]),
]}


def run_scenario(spec: dict, base_dir: str | None = None,
                 device: str = "cuda") -> dict:
    """One scenario end-to-end: cluster up, workload + faults, heal,
    check. Returns the invariant-attributed verdict. ``device``: where
    every node (the subprocess node too) holds its stores."""
    resolve(device)  # no CUDA and no "cpu": raise before any node
    name = spec["name"]
    own = base_dir is None
    base_dir = base_dir or tempfile.mkdtemp(prefix=f"clusterchaos-{name}-")
    saved_ttl = os.environ.get("WEAVIATE_TPU_STAGED_TTL_S")
    if spec.get("staged_ttl_s") is not None:
        os.environ["WEAVIATE_TPU_STAGED_TTL_S"] = str(spec["staged_ttl_s"])
    faultline.heal()
    transport.reset_breakers()
    cluster = None
    t0 = time.time()
    try:
        cluster = ChaosCluster(
            base_dir,
            subprocess_node=spec.get("subprocess_node"),
            env_faults=spec.get("env_faults"),
            remote_timeout=spec.get("remote_timeout_s", 1.5),
            device=device)
        cluster.wait_members()
        cluster.create_collection()
        journal = Journal(os.path.join(base_dir, "history.jsonl"))
        wl = Workload(cluster, spec, journal)
        records = wl.run()
        journal.close()
        heal_time = time.time()
        cluster.wait_members(timeout=20.0)
        verdict = check_run(records, cluster, spec,
                            schemas=wl.controller.schemas,
                            heal_time=heal_time)
        if any(e.get("do") == "schema" for e in spec.get("events", [])):
            # no silent coverage loss: a schema event that never
            # committed must FAIL the scenario, not quietly skip the
            # schema_agreement invariant it exists to feed
            verdict["invariants"].append(checker._invariant(
                "schema_committed", list(wl.controller.schema_failures)))
        for probe in spec.get("probes", []):
            verdict["invariants"].append(PROBES[probe](cluster, spec))
        if spec.get("expect_sub_exit"):
            rcs = wl.controller.sub_exit_rcs
            hit = any(rc in spec["expect_sub_exit"] for rc in rcs)
            diag = getattr(wl.controller, "await_diag", None)
            verdict["invariants"].append(checker._invariant(
                "crash_fired",
                [] if hit else [
                    f"subprocess exit codes {rcs}, expected one of "
                    f"{spec['expect_sub_exit']} — the scheduled crash "
                    f"never fired (no coverage, not a pass); "
                    f"await diagnostics: {diag}"]))
        verdict["ok"] = all(i["ok"] for i in verdict["invariants"])
        if cluster.sub_name is not None:
            # where the subprocess node holds its stores (its --device)
            try:
                verdict["sub_device"] = cluster.sub_status()["device"]
            except RpcError:
                verdict["sub_device"] = None
        verdict["scenario"] = name
        verdict["seed"] = spec.get("seed", 0)
        verdict["events_fired"] = wl.controller.fired
        verdict["wall_s"] = round(time.time() - t0, 2)
        return verdict
    finally:
        if cluster is not None:
            cluster.close()
        faultline.heal()
        faultline.disarm()
        transport.reset_breakers()
        if saved_ttl is None:
            os.environ.pop("WEAVIATE_TPU_STAGED_TTL_S", None)
        else:
            os.environ["WEAVIATE_TPU_STAGED_TTL_S"] = saved_ttl
        if own:
            shutil.rmtree(base_dir, ignore_errors=True)


def run_matrix(names=None, device: str = "cuda") -> list[dict]:
    out = []
    for name in (names or list(SCENARIOS)):
        out.append(run_scenario(SCENARIOS[name], device=device))
    return out


# -- randomized seeded sweep ---------------------------------------------------


def sweep_spec(seed: int, rnd: int) -> dict:
    """Pure function (seed, round) -> scenario spec. THIS is what makes
    a sweep round replayable: the printed (seed, round) regenerate the
    identical schedule, workload shape, and consistency mix."""
    rng = random.Random((seed + 1) * 7919 + rnd)
    nodes = ["n0", "n1", "n2"]
    kind = rng.choice(["isolate", "oneway", "flap", "split"])
    victim = rng.choice(nodes)
    at = rng.randrange(4, 12)
    heal_at = at + rng.randrange(12, 24)
    if kind == "isolate":
        fault = {"at": at, "do": "isolate", "node": victim}
    elif kind == "oneway":
        other = rng.choice([n for n in nodes if n != victim])
        fault = {"at": at, "do": "oneway", "src": victim, "dst": other}
    elif kind == "flap":
        other = rng.choice([n for n in nodes if n != victim])
        period = rng.randrange(4, 9)
        fault = {"at": at, "do": "flap", "src": victim, "dst": other,
                 "period": period, "duty": rng.randrange(1, period)}
    else:
        fault = {"at": at, "do": "split", "a": [victim],
                 "b": [n for n in nodes if n != victim]}
    levels = rng.choice([["QUORUM"], ["QUORUM", "ALL"],
                         ["ONE", "QUORUM"]])
    put = rng.uniform(0.45, 0.7)
    delete = rng.uniform(0.1, 0.3)
    return _spec(
        f"sweep-{seed}-{rnd}",
        seed=seed * 100 + rnd,
        ops_per_client=rng.randrange(10, 16),
        uuids_per_client=rng.randrange(2, 5),
        levels=levels,
        mix={"put": put, "delete": delete,
             "read": max(0.05, 1.0 - put - delete)},
        events=[fault, {"at": heal_at, "do": "heal"}],
    )


def run_sweep(rounds: int = 4, seed: int = 0,
              device: str = "cuda") -> list[dict]:
    out = []
    for rnd in range(rounds):
        spec = sweep_spec(seed, rnd)
        logger.info("sweep round %d (seed %d): %s", rnd, seed,
                    spec["events"])
        verdict = run_scenario(spec, device=device)
        verdict["sweep"] = {"seed": seed, "round": rnd,
                            "replay": f"python -m tools.clusterchaos_torch "
                                      f"--sweep-round {rnd} --seed {seed} "
                                      f"--device {device}"}
        out.append(verdict)
    return out
