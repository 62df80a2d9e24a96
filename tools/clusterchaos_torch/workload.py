"""The clusterchaos cluster + seeded workload runner.

The port's copy of ``tools/clusterchaos/workload.py``: the nodes are
``weaviate_tpu_torch`` ``ClusterNode``s on ``device`` (the subprocess
node gets ``--device`` too).

One module owns cluster assembly (three replicated nodes — in-process
by default, any one of them optionally a SUBPROCESS so a kill is a real
``SIGKILL`` against a separate address space, riding the crashtest
worker pattern), the seeded multi-client workload, and the fsynced
per-client history journal the checker replays.

The journal is the clients' own ledger, exactly like crashtest's
acked-write journal: one JSONL line per invocation, appended + fsynced
AFTER the response (or failure) is known, so the harness's view of "what
was acked" survives anything short of the harness itself dying — and the
checker never has to trust the cluster about what the cluster promised.

Each uuid is owned by exactly ONE client, so the per-uuid op history is
sequential and the checker's allowed-final-states set is well defined:
everything at-or-after the last ACKED op (the acked op itself, plus any
later AMBIGUOUS op that may or may not have landed).
"""

from __future__ import annotations

import json
import logging
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time

from weaviate_tpu_torch.cluster.node import ClusterNode
from weaviate_tpu_torch.cluster.transport import RpcError, rpc
from weaviate_tpu_torch.runtime import faultline
from weaviate_tpu_torch.schema.config import (
    CollectionConfig,
    Property,
    ReplicationConfig,
    ShardingConfig,
)

logger = logging.getLogger(__name__)

NAMES = ("n0", "n1", "n2")
COLLECTION = "Chaos"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def client_uuid(client: int, slot: int) -> str:
    """Deterministic uuid owned by one client (canonical 36-char form)."""
    return f"{0xCC000000 + client:08x}-0000-0000-0000-{slot:012d}"


# -- history journal -----------------------------------------------------------


class Journal:
    """fsynced per-client invocation/response ledger (JSONL)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a")

    def append(self, rec: dict) -> None:
        line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            self._f.close()

    @staticmethod
    def load(path: str) -> list[dict]:
        out = []
        with open(path) as f:
            for line in f:
                if line.endswith("\n"):  # a torn final line was never acked
                    out.append(json.loads(line))
        return out


# -- cluster assembly ----------------------------------------------------------


class ChaosCluster:
    """Three replicated cluster nodes. ``subprocess_node`` names one to
    run as a real subprocess (tools/clusterchaos_torch/nodeproc) so a kill is
    a genuine SIGKILL; its faults/partitions arm through
    WEAVIATE_TPU_FAULTLINE in its environment, while the harness's own
    topology rules govern it at the surviving nodes' server side."""

    def __init__(self, base_dir: str, *, subprocess_node: str | None = None,
                 env_faults: list | None = None,
                 remote_timeout: float = 1.5,
                 gossip_interval: float = 0.1,
                 election_timeout: tuple = (0.2, 0.4),
                 dead_after: float = 1.5, device: str = "cuda"):
        self.base = base_dir
        self.device = device
        self.names = list(NAMES)
        self.sub_name = subprocess_node
        self.sub_proc: subprocess.Popen | None = None
        self.sub_port = _free_port() if subprocess_node else None
        self.sub_env_faults = env_faults
        self._sub_args = (gossip_interval, election_timeout, dead_after,
                          remote_timeout)
        self.nodes: dict[str, ClusterNode] = {}
        for name in self.names:
            if name == subprocess_node:
                continue
            n = ClusterNode(name, os.path.join(base_dir, name),
                            raft_peers=self.names,
                            gossip_interval=gossip_interval,
                            election_timeout=election_timeout,
                            remote_timeout=remote_timeout, device=device)
            # partitions in these scenarios outlive the default
            # dead_after, which is exactly the membership heal path
            # (DEAD-peer probing) this harness exists to exercise
            n.membership.dead_after = dead_after
            n.membership.suspect_after = dead_after * 0.6
            self.nodes[name] = n
        seeds = [n.address for n in self.nodes.values()]
        for n in self.nodes.values():
            n.membership.join(seeds)
        for n in self.nodes.values():
            n.start()
        if subprocess_node:
            self.spawn_sub()
        next(iter(self.nodes.values())).raft.wait_for_leader(timeout=20.0)

    # -- subprocess lifecycle ------------------------------------------------

    @property
    def sub_addr(self) -> str | None:
        return f"127.0.0.1:{self.sub_port}" if self.sub_port else None

    def spawn_sub(self) -> None:
        gossip, elect, dead_after, remote_timeout = self._sub_args
        env = dict(os.environ)
        if self.sub_env_faults:
            env["WEAVIATE_TPU_FAULTLINE"] = json.dumps(self.sub_env_faults)
        else:
            env.pop("WEAVIATE_TPU_FAULTLINE", None)
        seeds = ",".join(n.address for n in self.nodes.values())
        # diagnosis breadcrumb for crash_fired failures: exactly what
        # fault env this spawn carried
        self.spawn_env_faults = env.get("WEAVIATE_TPU_FAULTLINE")
        self.sub_proc = subprocess.Popen(
            [sys.executable, "-m", "tools.clusterchaos_torch.nodeproc",
             self.sub_name, os.path.join(self.base, self.sub_name),
             "--port", str(self.sub_port),
             "--peers", ",".join(self.names),
             "--seeds", seeds,
             "--gossip", str(gossip),
             "--elect", f"{elect[0]},{elect[1]}",
             "--dead-after", str(dead_after),
             "--remote-timeout", str(remote_timeout),
             "--device", str(self.device)],
            env=env, cwd=_REPO_ROOT)
        self.wait_sub_ready()

    def wait_sub_ready(self, timeout: float = 90.0) -> dict:
        deadline = time.time() + timeout
        last = None
        while time.time() < deadline:
            if self.sub_proc is not None and self.sub_proc.poll() is not None:
                raise RuntimeError(
                    f"subprocess node {self.sub_name} exited rc="
                    f"{self.sub_proc.returncode} during startup")
            try:
                # observer identity: a readiness poll is the harness's
                # out-of-band channel — a node may legitimately restart
                # INTO a still-armed partition, and the harness must be
                # able to see it boot anyway
                with faultline.node_scope(faultline.OBSERVER):
                    status = rpc(self.sub_addr, "/chaos/status", {},
                                 timeout=1.0)
                if status.get("ok"):
                    return status
            except RpcError as e:
                last = e
            time.sleep(0.2)
        raise TimeoutError(
            f"subprocess node {self.sub_name} not ready: {last}")

    def kill_sub(self) -> None:
        """A real SIGKILL: no flush, no close, no goodbye."""
        if self.sub_proc is not None and self.sub_proc.poll() is None:
            self.sub_proc.send_signal(signal.SIGKILL)
            self.sub_proc.wait(timeout=30)

    def restart_sub(self) -> None:
        self.kill_sub()
        # a restarted node must not re-arm one-shot crash schedules —
        # the crash already happened; recovery is what we're testing
        self.sub_env_faults = None
        self.spawn_sub()

    # -- views ---------------------------------------------------------------

    def addr_of(self, name: str) -> str:
        if name == self.sub_name:
            return self.sub_addr
        return self.nodes[name].address

    def col(self, name: str):
        return self.nodes[name].db.get_collection(COLLECTION)

    def inproc_names(self) -> list[str]:
        return sorted(self.nodes)

    def sub_status(self) -> dict | None:
        if self.sub_name is None:
            return None
        with faultline.node_scope(faultline.OBSERVER):
            return rpc(self.sub_addr, "/chaos/status", {}, timeout=2.0)

    # -- setup ---------------------------------------------------------------

    def wait_members(self, timeout: float = 30.0) -> None:
        """All three nodes alive in every in-process view (placement
        needs the full node set before the collection is created)."""
        deadline = time.time() + timeout
        want = set(self.names)
        while time.time() < deadline:
            if all(want <= set(n.membership.alive_nodes())
                   for n in self.nodes.values()):
                return
            time.sleep(0.1)
        raise TimeoutError("cluster members never all alive")

    def create_collection(self, extra_name: str | None = None,
                          timeout: float = 30.0,
                          majority_only: bool = False) -> None:
        """``majority_only``: a schema committed DURING a partition can
        only be visible on the raft majority until the heal — chaos
        schema events wait for majority visibility and leave the
        everyone-has-it check to the post-heal ``schema_agreement``
        invariant. Setup-time creation keeps the strict all-nodes wait."""
        name = extra_name or COLLECTION
        cfg = CollectionConfig(
            name=name,
            properties=[Property(name="client", data_type="int"),
                        Property(name="seq", data_type="int"),
                        Property(name="rev", data_type="int")],
            sharding=ShardingConfig(desired_count=1),
            replication=ReplicationConfig(factor=3))
        deadline = time.time() + timeout
        last: Exception | None = None
        for node in self._round_robin(deadline):
            try:
                with faultline.node_scope(node.name):
                    node.create_collection(cfg)
                break
            except Exception as e:  # leadership churn mid-create
                last = e
        else:
            raise TimeoutError(f"create_collection({name}) failed: {last}")
        need = (len(self.names) // 2 + 1) if majority_only \
            else len(self.names)
        while time.time() < deadline:
            visible = sum(1 for n in self.nodes.values()
                          if name in n.db.collections)
            if self.sub_name is not None:
                try:
                    if name in (self.sub_status() or {}).get(
                            "collections", []):
                        visible += 1
                except RpcError:
                    pass  # unreachable counts as not-visible
            if visible >= need:
                return
            time.sleep(0.1)
        raise TimeoutError(f"collection {name} visible on fewer than "
                           f"{need} nodes after {timeout}s")

    def _round_robin(self, deadline: float):
        names = self.inproc_names()
        i = 0
        while time.time() < deadline:
            yield self.nodes[names[i % len(names)]]
            i += 1
            time.sleep(0.3)

    def shard_name(self) -> str:
        col = next(iter(self.nodes.values())).db.get_collection(COLLECTION)
        return next(iter(col.sharding.shard_names))

    def close(self) -> None:
        self.kill_sub()
        for n in self.nodes.values():
            try:
                n.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass


# -- event controller ----------------------------------------------------------


class EventController:
    """Applies the scenario's partition/crash schedule at global
    op-count thresholds, exactly once each, from whichever client
    thread crosses the threshold. Deterministic given the op total —
    the seeded workload decides WHEN, the controller decides WHAT."""

    def __init__(self, cluster: ChaosCluster, events: list[dict],
                 total_fn=None):
        self.cluster = cluster
        self.events = sorted(events, key=lambda e: e["at"])
        self._lock = threading.Lock()
        #: serializes event EXECUTION, not just the index claim: without
        #: it, a client crossing threshold N+1 fired its event while
        #: another client was still INSIDE event N — a "restart" racing
        #: a long "await_sub_exit" killed the armed subprocess early and
        #: respawned it faultless, silently destroying crash coverage
        self._fire_lock = threading.Lock()
        self._next = 0
        self.total_fn = total_fn or (lambda: 0)
        self.fired: list[dict] = []
        self.schemas: list[str] = []
        self.schema_failures: list[str] = []
        #: subprocess exit codes observed at kill/restart events —
        #: -9 for a harness SIGKILL, 137 for an env-armed crashpoint's
        #: os._exit, None when the node was still alive at restart time
        #: (an expected crash that never fired = NO coverage, and the
        #: harness fails the scenario rather than silently passing)
        self.sub_exit_rcs: list[int | None] = []

    def advance(self, total_ops: int) -> None:
        if not self._fire_lock.acquire(blocking=False):
            # another client is mid-event; it re-reads the live op
            # counter after each event and will drain anything that
            # became due meanwhile — strictly in schedule order
            return
        try:
            while True:
                total = max(total_ops, self.total_fn())
                with self._lock:
                    if self._next >= len(self.events) \
                            or self.events[self._next]["at"] > total:
                        return
                    ev = self.events[self._next]
                    self._next += 1
                self._fire(ev)
                with self._lock:
                    self.fired.append(dict(ev, at_ops=total))
        finally:
            self._fire_lock.release()

    def _fire(self, ev: dict) -> None:
        do = ev["do"]
        logger.info("clusterchaos event: %s", ev)
        if do == "isolate":
            faultline.isolate(ev["node"], name=ev.get("name", "isolate"))
        elif do == "split":
            faultline.split(ev["a"], ev["b"], name=ev.get("name", "split"))
        elif do == "oneway":
            faultline.partition(ev["src"], ev["dst"],
                                name=ev.get("name", "oneway"))
        elif do == "flap":
            faultline.partition(ev["src"], ev["dst"],
                                symmetric=ev.get("symmetric", True),
                                period=ev["period"], duty=ev["duty"],
                                name=ev.get("name", "flap"))
        elif do == "heal":
            faultline.heal(ev.get("name"))
        elif do == "kill":
            self.cluster.kill_sub()
            if self.cluster.sub_proc is not None:
                self.sub_exit_rcs.append(self.cluster.sub_proc.returncode)
        elif do == "await_sub_exit":
            # block THIS client until the env-armed crashpoint killed
            # the subprocess, DRIVING filler QUORUM writes the whole
            # time: an append-count crash schedule only advances when
            # replicated commits actually reach the replica, and under
            # full-suite CPU contention the main clients' acks can slow
            # to a trickle (slow replica -> prepare timeouts -> no
            # commits -> no appends -> the crash never fires). A timeout
            # records the truth — rc None — and the crash_fired
            # invariant fails loudly instead of silently losing coverage
            deadline = time.time() + ev.get("timeout_s", 30.0)
            coord = self.cluster.inproc_names()[0]
            col = self.cluster.col(coord)
            diag = self.await_diag = {
                "filler_ok": 0, "filler_err": 0, "last_err": None,
                "sub_faults": None,
                "spawn_env": getattr(self.cluster, "spawn_env_faults",
                                     "never-spawned"),
                "sub_pid": getattr(self.cluster.sub_proc, "pid", None),
                "spec_env_faults": self.cluster.sub_env_faults}
            filler = 0
            while time.time() < deadline:
                if self.cluster.sub_proc is None \
                        or self.cluster.sub_proc.poll() is not None:
                    break
                try:
                    with faultline.node_scope(coord):
                        col.put_object(
                            {"client": -9, "seq": filler, "rev": -9},
                            vector=[0.0, 1.0],
                            uuid=f"f1000000-0000-0000-0000-{filler:012d}",
                            consistency="ALL")
                    diag["filler_ok"] += 1
                except Exception as e:  # noqa: BLE001 — dying replica
                    diag["filler_err"] += 1
                    diag["last_err"] = f"{type(e).__name__}: {e}"
                    time.sleep(0.05)
                filler += 1
            # best-effort post-mortem: how far did the armed schedule
            # get? (answers "was the crash point even being driven")
            try:
                diag["sub_faults"] = self.cluster.sub_status().get("faults")
            except Exception as e:  # noqa: BLE001 — it crashed (good)
                diag["sub_faults"] = f"status unreadable: {e}"
        elif do == "restart":
            if self.cluster.sub_proc is not None:
                self.sub_exit_rcs.append(self.cluster.sub_proc.poll())
            self.cluster.restart_sub()
        elif do == "partition_leader":
            leader = None
            for n in self.cluster.nodes.values():
                leader = leader or n.raft.leader_id
            if leader is None:
                leader = self.cluster.inproc_names()[0]
            self.fired_leader = leader
            faultline.isolate(leader, name="leader")
        elif do == "wait_new_leader":
            old = getattr(self, "fired_leader", None)
            deadline = time.time() + ev.get("timeout_s", 10.0)
            while time.time() < deadline:
                for n in self.cluster.nodes.values():
                    lid = n.raft.leader_id
                    if n.name != old and lid is not None and lid != old:
                        return
                time.sleep(0.05)
        elif do == "sleep":
            time.sleep(ev["s"])
        elif do == "schema":
            try:
                self.cluster.create_collection(ev["name"],
                                               timeout=ev.get("timeout_s",
                                                              20.0),
                                               majority_only=True)
                self.schemas.append(ev["name"])
            except Exception as e:  # noqa: BLE001 — recorded, not lost
                # same no-silent-coverage rule as crash_fired: a schema
                # event that never committed means the churn scenario's
                # schema_agreement invariant would be vacuously skipped —
                # the harness turns this into a named FAILURE instead
                self.schema_failures.append(
                    f"schema event {ev['name']!r} never committed: "
                    f"{type(e).__name__}: {e}")
                logger.exception("schema event %s failed", ev["name"])
        else:
            raise ValueError(f"unknown chaos event {do!r}")

    def finalize(self) -> None:
        """End of workload: heal every partition, resurrect the
        subprocess if an event killed it — the checker examines the
        HEALED cluster."""
        faultline.heal()
        if self.cluster.sub_name is not None:
            if self.cluster.sub_proc is None \
                    or self.cluster.sub_proc.poll() is not None:
                self.cluster.restart_sub()


# -- workload ------------------------------------------------------------------


class Workload:
    """Seeded multi-client runner: mixed put/delete/read at mixed
    consistency levels, journaled per client, concurrent with the
    controller's partition/crash schedule."""

    def __init__(self, cluster: ChaosCluster, spec: dict,
                 journal: Journal):
        self.cluster = cluster
        self.spec = spec
        self.journal = journal
        self._total = 0
        self._total_lock = threading.Lock()
        self.controller = EventController(cluster, spec.get("events", []),
                                          total_fn=lambda: self._total)

    def _bump(self) -> int:
        with self._total_lock:
            self._total += 1
            return self._total

    def run(self) -> list[dict]:
        spec = self.spec
        threads = [threading.Thread(target=self._client, args=(c,),
                                    name=f"chaos-client-{c}")
                   for c in range(spec.get("clients", 3))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=spec.get("client_timeout_s", 180.0))
        if any(t.is_alive() for t in threads):
            raise TimeoutError("a chaos workload client hung — that is "
                               "itself an invariant violation")
        self.controller.finalize()
        return Journal.load(self.journal.path)

    def _client(self, c: int) -> None:
        spec = self.spec
        rng = random.Random(spec.get("seed", 0) * 1009 + c)
        n_uuids = spec.get("uuids_per_client", 4)
        uuids = [client_uuid(c, j) for j in range(n_uuids)]
        mix = spec.get("mix", {"put": 0.6, "delete": 0.15, "read": 0.25})
        kinds = list(mix)
        weights = [mix[k] for k in kinds]
        levels = spec.get("levels", ["QUORUM"])
        read_levels = spec.get("read_levels", ["QUORUM"])
        coords = self.cluster.inproc_names()
        for seq in range(spec.get("ops_per_client", 16)):
            kind = rng.choices(kinds, weights)[0]
            u = rng.choice(uuids)
            coord = rng.choice(coords)
            level = rng.choice(read_levels if kind == "read"
                               else levels)
            rev = None
            if kind == "put":
                rev = c * 1_000_000 + seq  # globally unique op identity
            rec = {"client": c, "seq": seq, "kind": kind, "uuid": u,
                   "rev": rev, "level": level, "coord": coord,
                   "t0": time.time()}
            status, err = self._execute(kind, u, rev, c, seq, coord, level)
            rec["status"] = status
            rec["error"] = err
            rec["t1"] = time.time()
            self.journal.append(rec)
            self.controller.advance(self._bump())
            # ops on one uuid must not share a millisecond: digest_rank
            # orders by server-stamped mtime, and the checker's
            # "later op wins" reading of the per-uuid history needs
            # strictly advancing stamps
            time.sleep(0.002)

    def _execute(self, kind: str, u: str, rev, c: int, seq: int,
                 coord: str, level: str) -> tuple[str, str | None]:
        col = self.cluster.col(coord)
        try:
            with faultline.node_scope(coord):
                if kind == "put":
                    col.put_object({"client": c, "seq": seq, "rev": rev},
                                   vector=[float(rev % 97), 1.0], uuid=u,
                                   consistency=level)
                elif kind == "delete":
                    col.delete_object(u, consistency=level)
                else:
                    col.get_object(u, consistency=level)
            return "ok", None
        except Exception as e:  # noqa: BLE001 — ANY failure is ambiguous
            # a failed write may still have landed on a subset of
            # replicas (commit-phase errors, dropped acks); the checker
            # allows it either way but identically everywhere
            return "ambiguous", f"{type(e).__name__}: {e}"
