"""The clusterchaos consistency checker: history in, verdict out.

Runs POST-HEAL against the journal the workload recorded and the live
(healed) cluster, and attributes every failure to a named invariant —
the verdict a sabotaged hardening fix must visibly flip to FAIL:

``convergence``        all replica hashtrees reach root equality within
                       a bounded number of hashbeat rounds
``replica_agreement``  per uuid, every replica reports the same digest
                       (ambiguous ops may land either way — but
                       identically on every replica)
``acked_durability``   the converged value per uuid is an ALLOWED one:
                       the last acked (digest_rank-winning) op, or an
                       ambiguous op issued after it — never a lost
                       acked write, never a value nobody wrote
``no_resurrection``    an acked delete with no later ambiguous put
                       stays deleted on EVERY replica — hashbeat must
                       not resurrect it
``read_at_all``        every uuid with an acked write reads back at
                       consistency ALL after the heal
``staged_no_leak``     orphaned 2PC prepares (unreachable abort)
                       expired via the TTL path — nothing staged leaks
``no_late_commit``     (probe) a commit arriving after the staged TTL
                       is refused, not applied
``schema_agreement``   schema ops committed during leadership churn are
                       present on every node
"""

from __future__ import annotations

import logging
import time

from weaviate_tpu_torch.cluster.transport import RpcError, rpc
from weaviate_tpu_torch.replication.hashbeater import HashBeater
from weaviate_tpu_torch.runtime import faultline
from weaviate_tpu_torch.storage.objects import StorageObject

from tools.clusterchaos_torch.workload import COLLECTION, ChaosCluster

logger = logging.getLogger(__name__)


def _invariant(name: str, violations: list[str]) -> dict:
    return {"name": name, "ok": not violations, "violations": violations}


def _digest(cluster: ChaosCluster, node: str, shard: str, uuid: str):
    reply = rpc(cluster.addr_of(node),
                f"/replicas/{COLLECTION}/{shard}/digest",
                {"uuid": uuid}, timeout=5.0)
    return reply.get("digest")


def _digest_key(d) -> tuple | None:
    """Comparable digest identity; None = never seen / tombstone-free
    absence. A tombstone is its own identity (deleted, mtime)."""
    if d is None:
        return None
    if d["deleted"]:
        return ("deleted", d["mtime"])
    return ("live", d["mtime"], bytes(d["hash"]))


def _fetch_rev(cluster: ChaosCluster, node: str, shard: str,
               uuid: str) -> int | None:
    raw = rpc(cluster.addr_of(node),
              f"/replicas/{COLLECTION}/{shard}/objects:fetch",
              {"uuids": [uuid]}, timeout=5.0)["objects"][0]
    if raw is None:
        return None
    return StorageObject.from_bytes(raw).properties.get("rev")


def wait_replicas_serving(cluster: ChaosCluster, shard: str,
                          timeout: float = 20.0) -> None:
    """Post-heal readiness barrier: every replica (including a just-
    restarted subprocess node mid-WAL-replay) answers a hashtree probe
    before convergence rounds start counting — the bounded-rounds
    invariant measures anti-entropy, not boot latency."""
    deadline = time.time() + timeout
    pending = set(cluster.names)
    last: Exception | None = None
    while pending and time.time() < deadline:
        for node in sorted(pending):
            try:
                rpc(cluster.addr_of(node),
                    f"/replicas/{COLLECTION}/{shard}/hashtree:level",
                    {"depth": 8, "level": 0, "positions": [0],
                     "token": None}, timeout=2.0)
                pending.discard(node)
            except RpcError as e:
                last = e
        if pending:
            time.sleep(0.2)
    if pending:
        raise TimeoutError(f"replicas {sorted(pending)} never served "
                           f"post-heal: {last}")


def drive_convergence(cluster: ChaosCluster, shard: str,
                      max_rounds: int = 8) -> dict:
    """Run hashbeat rounds from every in-process node until all replica
    hashtree roots agree (the subprocess node converges by being pushed
    to / pulled from as a peer). Returns rounds used + reconciled count;
    ``converged`` False when ``max_rounds`` was not enough."""
    wait_replicas_serving(cluster, shard)
    beaters = {name: HashBeater(cluster.nodes[name].db.get_collection(
        COLLECTION)) for name in cluster.inproc_names()}
    probe = beaters[cluster.inproc_names()[0]]
    rounds = reconciled = 0
    converged = False
    for _ in range(max_rounds):
        try:
            with faultline.node_scope(cluster.inproc_names()[0]):
                if probe.roots_equal(shard):
                    converged = True
                    break
        except (RpcError, KeyError) as e:
            logger.debug("root probe failed (still healing): %s", e)
        rounds += 1
        for name, beater in beaters.items():
            try:
                with faultline.node_scope(name):
                    reconciled += beater.beat_shard(shard)
            except Exception as e:  # noqa: BLE001 — a peer mid-heal
                logger.debug("beat from %s failed: %s", name, e)
        # breakers opened during the partition release on the next
        # direct gossip contact (membership-alive signal); give the
        # heal path a beat to do exactly that
        time.sleep(0.25)
    else:
        try:
            with faultline.node_scope(cluster.inproc_names()[0]):
                converged = probe.roots_equal(shard)
        except (RpcError, KeyError):
            converged = False
    return {"converged": converged, "rounds": rounds,
            "reconciled": reconciled}


def check_run(journal: list[dict], cluster: ChaosCluster, spec: dict,
              *, schemas: list[str] | None = None,
              heal_time: float | None = None) -> dict:
    """The verdict. ``journal``: the workload's history records.
    ``schemas``: collections committed by schema events. ``heal_time``:
    when the last partition healed (bounds the staged-TTL wait)."""
    shard = cluster.shard_name()
    max_rounds = spec.get("max_beat_rounds", 8)
    invariants: list[dict] = []

    # 1. convergence: bounded hashbeat rounds to root equality
    conv = drive_convergence(cluster, shard, max_rounds=max_rounds)
    invariants.append(_invariant("convergence", [] if conv["converged"]
                                 else [f"hashtree roots still differ "
                                       f"after {max_rounds} beat rounds"]))

    writes = [r for r in journal if r["kind"] in ("put", "delete")]
    by_uuid: dict[str, list[dict]] = {}
    for r in writes:
        by_uuid.setdefault(r["uuid"], []).append(r)
    for ops in by_uuid.values():
        ops.sort(key=lambda r: r["seq"])  # one owner client per uuid

    # 2. replica agreement per uuid (ambiguous ops: either way, but
    # identically everywhere)
    agreement: list[str] = []
    digests: dict[str, dict] = {}  # uuid -> {node: digest}
    for u in sorted(by_uuid):
        per_node = {}
        for node in cluster.names:
            try:
                per_node[node] = _digest(cluster, node, shard, u)
            except RpcError as e:
                agreement.append(f"{u}: digest read from {node} failed: {e}")
        digests[u] = per_node
        keys = {n: _digest_key(d) for n, d in per_node.items()}
        if len(set(keys.values())) > 1:
            agreement.append(f"{u}: replicas disagree after convergence: "
                             f"{keys}")
    invariants.append(_invariant("replica_agreement", agreement))

    # 3/4. durability + no-resurrection against the allowed-states set
    durability: list[str] = []
    resurrection: list[str] = []
    read_at_all: list[str] = []
    col0 = cluster.col(cluster.inproc_names()[0])
    for u, ops in sorted(by_uuid.items()):
        acked = [o for o in ops if o["status"] == "ok"]
        if not acked:
            continue  # nothing was promised for this uuid
        last = acked[-1]
        tail = [o for o in ops if o["seq"] > last["seq"]]
        allowed = [last] + tail  # tail is all-ambiguous by construction
        allowed_revs = {o["rev"] for o in allowed if o["kind"] == "put"}
        allows_delete = any(o["kind"] == "delete" for o in allowed)
        allows_put = bool(allowed_revs)

        # judge the converged value from a replica that actually
        # ANSWERED the digest read, and fetch the rev from that SAME
        # node — a failed digest on names[0] already shows up under
        # replica_agreement and must not corrupt/abort this invariant
        answered = [(n, d) for n, d in digests[u].items()]
        if not answered:
            continue  # every digest read failed: attributed above
        d0_node, d0 = answered[0]
        exists = d0 is not None and not d0["deleted"]
        if exists:
            try:
                rev = _fetch_rev(cluster, d0_node, shard, u)
            except RpcError as e:
                durability.append(
                    f"{u}: rev readback from {d0_node} failed "
                    f"post-heal: {e}")
                rev = None
            else:
                if rev not in allowed_revs:
                    durability.append(
                        f"{u}: converged to rev {rev}, allowed "
                        f"{sorted(allowed_revs)} (last acked "
                        f"{last['kind']}@seq{last['seq']})")
            if not allows_put and allows_delete:
                resurrection.append(
                    f"{u}: acked delete@seq{last['seq']} resurrected as "
                    f"rev {rev}")
        else:
            if not allows_delete:
                durability.append(
                    f"{u}: acked put rev {last['rev']} lost (object "
                    f"absent; allowed {sorted(allowed_revs)})")

        # read back at consistency ALL through the healed cluster
        try:
            with faultline.node_scope(cluster.inproc_names()[0]):
                obj = col0.get_object(u, consistency="ALL")
        except Exception as e:  # noqa: BLE001 — typed errors included
            read_at_all.append(f"{u}: ALL read failed post-heal: {e}")
            continue
        if obj is None and allows_put and not allows_delete:
            read_at_all.append(
                f"{u}: ALL read returned nothing for an acked put "
                f"(rev {last['rev']})")
        if obj is not None and allows_delete and not allows_put:
            read_at_all.append(
                f"{u}: ALL read returned rev "
                f"{obj.properties.get('rev')} past an acked delete")
    invariants.append(_invariant("acked_durability", durability))
    invariants.append(_invariant("no_resurrection", resurrection))
    invariants.append(_invariant("read_at_all", read_at_all))

    # 5. staged-entry leak: orphaned prepares must have expired. Only
    # meaningful when the scenario pinned a short TTL — with the 120s
    # default, recent in-flight stragglers may legitimately linger.
    if spec.get("staged_ttl_s") is not None:
        ttl = float(spec["staged_ttl_s"])
        if heal_time is not None:
            time.sleep(max(0.0, ttl + 0.3 - (time.time() - heal_time)))
        leaks: list[str] = []
        for node in cluster.names:
            try:
                st = rpc(cluster.addr_of(node),
                         f"/replicas/{COLLECTION}/{shard}/staged:status",
                         {}, timeout=5.0)
            except RpcError as e:
                leaks.append(f"{node}: staged:status failed: {e}")
                continue
            if st["staged"]:
                leaks.append(f"{node}: {st['staged']} staged 2PC entries "
                             f"leaked past the {ttl}s TTL")
        invariants.append(_invariant("staged_no_leak", leaks))

    # 6. schema agreement (leadership-churn scenarios)
    if schemas:
        missing: list[str] = []
        for name in schemas:
            for nname, node in cluster.nodes.items():
                if name not in node.db.collections:
                    missing.append(f"{nname}: committed schema {name!r} "
                                   "missing")
            if cluster.sub_name is not None:
                try:
                    sub = cluster.sub_status() or {}
                    if name not in sub.get("collections", []):
                        missing.append(f"{cluster.sub_name}: committed "
                                       f"schema {name!r} missing")
                except RpcError as e:
                    missing.append(f"{cluster.sub_name}: unreachable for "
                                   f"schema check: {e}")
        invariants.append(_invariant("schema_agreement", missing))

    acked = sum(1 for r in writes if r["status"] == "ok")
    return {
        "ok": all(i["ok"] for i in invariants),
        "invariants": invariants,
        "stats": {
            "ops": len(journal),
            "writes": len(writes),
            "acked_writes": acked,
            "ambiguous_writes": len(writes) - acked,
            "uuids": len(by_uuid),
            "beat_rounds": conv["rounds"],
            "reconciled": conv["reconciled"],
        },
    }


# -- scenario probes -----------------------------------------------------------


def probe_staged_ttl(cluster: ChaosCluster, spec: dict) -> dict:
    """The late-commit probe (sabotage target): stage a prepare
    directly on a replica, let it outlive the TTL, then try to commit
    it — the commit must be REFUSED and the entry must be gone. This is
    the exact shape of a straggler commit racing a partition heal; if
    someone reverts the expiry-at-commit hardening, ``no_late_commit``
    is the invariant that fails."""
    ttl = float(spec.get("staged_ttl_s", 1.0))
    shard = cluster.shard_name()
    victim = cluster.inproc_names()[-1]
    addr = cluster.addr_of(victim)
    rid = f"probe-{spec.get('seed', 0)}"
    uuid = client_probe_uuid(spec.get("seed", 0))
    obj = StorageObject(uuid=uuid, properties={"rev": -1, "probe": True})
    violations: list[str] = []
    rpc(addr, f"/replicas/{COLLECTION}/{shard}/prepare",
        {"request_id": rid, "kind": "put", "objects": [obj.to_bytes()]},
        timeout=5.0)
    time.sleep(ttl + 0.3)
    try:
        rpc(addr, f"/replicas/{COLLECTION}/{shard}/commit",
            {"request_id": rid}, timeout=5.0)
        violations.append(
            f"commit of {rid} applied {ttl + 0.3:.1f}s after prepare — "
            "a straggler commit landed past the staged TTL")
    except RpcError as e:
        if "TTL" not in str(e) and "expired" not in str(e).lower() \
                and "unknown replication request" not in str(e):
            violations.append(f"commit refused with the wrong error: {e}")
    st = rpc(addr, f"/replicas/{COLLECTION}/{shard}/staged:status", {},
             timeout=5.0)
    if st["staged"]:
        violations.append(f"{st['staged']} staged entries leaked after "
                          "the refused late commit")
    if not violations and not st["expired_total"]:
        violations.append("expired_total counter never moved — the TTL "
                          "path did not actually fire")
    # the probe's object must not be readable anywhere
    try:
        if _fetch_rev(cluster, victim, shard, uuid) is not None:
            violations.append(f"probe object {uuid} is readable — the "
                              "late commit was applied")
    except RpcError as e:
        violations.append(f"probe readback failed: {e}")
    return _invariant("no_late_commit", violations)


def client_probe_uuid(seed: int) -> str:
    return f"{0xDD000000 + (seed % 0xFFFF):08x}-0000-0000-0000-000000000099"


def probe_migration_markers(cluster: ChaosCluster, spec: dict) -> dict:
    """Hashbeat racing an epoch migration's durable-marker cutover: a
    peer replica still holding a copy of a uuid whose ring-home shard
    cut it over ("migrated: <dst>" marker durable, local copy removed)
    pushes that copy back via anti-entropy — ``apply_sync`` must refuse
    it, or the migration's exactly-once guarantee dies the moment any
    replica beats. Sabotage target: revert the marker check in
    ``Shard.apply_sync`` and this invariant fails."""
    shard_name = cluster.shard_name()
    names = cluster.inproc_names()
    src, marked = names[0], names[1]
    u = f"{0xEE000000:08x}-0000-0000-0000-000000000001"
    violations: list[str] = []
    with faultline.node_scope(src):
        cluster.col(src).put_object({"rev": -2, "client": -1, "seq": -1},
                                    vector=[1.0, 0.0], uuid=u,
                                    consistency="ALL")
    shard = cluster.nodes[marked].db.get_collection(
        COLLECTION)._load_shard(shard_name)
    # the durable cutover, as db/collection.py's epoch migration runs
    # it: markers first, then the source-side removal
    shard.mark_migrating([u], "chaos-elsewhere")
    shard.migrate_out([u], "chaos-elsewhere")
    beater = HashBeater(cluster.nodes[src].db.get_collection(COLLECTION))
    for _ in range(2):
        with faultline.node_scope(src):
            beater.beat_shard(shard_name)
        time.sleep(0.1)
    if shard.objects.get(u.encode()) is not None:
        violations.append(
            f"{u}: hashbeat resurrected a migrated-away object at its "
            "old ring home despite the durable cutover marker")
    if not shard.migrated_to(u):
        violations.append(f"{u}: durable migration marker vanished")
    return _invariant("migration_marker_respected", violations)


PROBES = {"staged_ttl": probe_staged_ttl,
          "migration_markers": probe_migration_markers}
