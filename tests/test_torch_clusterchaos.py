"""The port's cluster under partition topology faults and circuit
breakers (a copy of the topology and breaker tests of
tests/test_clusterchaos.py; the cluster is three port ClusterNodes on the
CPU). The staged-2PC and hashbeat scenarios wait for the replication
slice.
"""

import json
import os
import time

import pytest

from weaviate_tpu_torch.cluster import transport
from weaviate_tpu_torch.cluster.node import ClusterNode
from weaviate_tpu_torch.cluster.transport import RpcError, rpc
from weaviate_tpu_torch.runtime import faultline

NAMES = ["n0", "n1", "n2"]


@pytest.fixture(autouse=True)
def _port_cluster_isolation():
    yield
    from weaviate_tpu_torch.runtime import degrade

    faultline.disarm()
    faultline.heal()
    degrade.reset()
    transport.reset_breakers()


class _PortCluster:
    """Three port nodes wired as tools/clusterchaos's ChaosCluster wires
    its in-process ones (short remote timeout, membership dead_after
    1.5 s so a partition outlives it)."""

    def __init__(self, base_dir: str, dead_after: float = 1.5):
        self.nodes = {}
        for name in NAMES:
            n = ClusterNode(name, os.path.join(base_dir, name),
                            raft_peers=NAMES, gossip_interval=0.1,
                            election_timeout=(0.2, 0.4),
                            remote_timeout=1.5, device="cpu")
            n.membership.dead_after = dead_after
            n.membership.suspect_after = dead_after * 0.6
            self.nodes[name] = n
        seeds = [n.address for n in self.nodes.values()]
        for n in self.nodes.values():
            n.membership.join(seeds)
        for n in self.nodes.values():
            n.start()
        self.nodes["n0"].raft.wait_for_leader(timeout=20.0)

    def addr_of(self, name: str) -> str:
        return self.nodes[name].address

    def wait_members(self, timeout: float = 20.0) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if all(len(n.membership.alive_nodes()) == len(NAMES)
                   for n in self.nodes.values()):
                return
            time.sleep(0.05)
        raise AssertionError("gossip did not converge")

    def close(self) -> None:
        for n in self.nodes.values():
            try:
                n.close()
            except Exception:  # noqa: BLE001
                pass


# -- 1. unit: topology layer ---------------------------------------------------


def _reg(name, port):
    faultline.register_node(name, f"127.0.0.1:{port}")
    return f"127.0.0.1:{port}"


def test_topology_directed_cut_and_reply_drop():
    a, b = _reg("ta", 34501), _reg("tb", 34502)
    faultline.partition("ta", "tb", name="one")
    faultline.bind_node("ta")
    try:
        # request direction cut: unreachable
        assert faultline.check_link(b) == "unreachable"
        # reverse call: tb -> ta request is fine, but its REPLY crosses
        # the cut ta<-... no — the cut edge is ta->tb, which is the
        # reply direction of a tb->ta call
        faultline.bind_node("tb")
        assert faultline.check_link(a) == "drop"
    finally:
        faultline.bind_node(None)
        faultline.heal()


def test_topology_flap_window_and_duration():
    b = _reg("tb", 34502)
    _reg("ta", 34501)
    faultline.bind_node("ta")
    try:
        rule, = faultline.partition("ta", "tb", period=4, duty=2)
        got = [faultline.check_link(b) for _ in range(8)]
        assert got == ["unreachable", "unreachable", None, None] * 2
        assert rule.consults == 8 and rule.cuts == 4
        faultline.heal()
        faultline.partition("ta", "tb", after=2, duration=3)
        got = [faultline.check_link(b) for _ in range(7)]
        assert got == [None, None, "unreachable", "unreachable",
                       "unreachable", None, None]
    finally:
        faultline.bind_node(None)
        faultline.heal()


def test_topology_env_arming_and_self_link():
    env = {"WEAVIATE_TPU_FAULTLINE": json.dumps([
        {"topology": {"kind": "isolate", "node": "tb", "name": "envcut"}},
    ])}
    rules = faultline.arm_from_env(env=env)
    try:
        assert len(rules) == 2 and all(r.name == "envcut" for r in rules)
        assert faultline.topology_armed()
        b = _reg("tb", 34502)
        faultline.bind_node("tb")
        # a node always reaches itself, even inside its own isolation
        assert faultline.check_link(b) is None
        faultline.bind_node("ta")
        assert faultline.check_link(b) == "unreachable"
    finally:
        faultline.bind_node(None)
        faultline.heal()
    assert not faultline.topology_armed()


def test_topology_wildcard_rule_consults_once_per_rpc():
    """A rule whose patterns cover BOTH directions of a call (full
    wildcards) must bump its counter exactly once per RPC — a double
    bump would halve and phase-shift the deterministic after/duration
    windows the replay contract documents."""
    b = _reg("tb", 34502)
    _reg("ta", 34501)
    faultline.bind_node("ta")
    try:
        rule, = faultline.partition("*", "*", after=4, duration=2)
        got = [faultline.check_link(b) for _ in range(8)]
        assert got == [None] * 4 + ["unreachable"] * 2 + [None] * 2
        assert rule.consults == 8 and rule.cuts == 2
    finally:
        faultline.bind_node(None)
        faultline.heal()


def test_topology_seeded_bernoulli_replays():
    b = _reg("tb", 34502)
    _reg("ta", 34501)
    faultline.bind_node("ta")
    try:
        def draw():
            faultline.heal()
            faultline.partition("ta", "tb", p=0.5, seed=99)
            return [faultline.check_link(b) is None for _ in range(32)]

        assert draw() == draw()  # pure function of (seed, index)
    finally:
        faultline.bind_node(None)
        faultline.heal()


# -- 1. unit: breaker heal path (satellite) ------------------------------------


def test_breaker_releases_probe_on_membership_alive():
    addr = "127.0.0.1:34599"
    br = transport.breaker_for(addr)
    br.threshold, br.cooldown_s = 2, 60.0
    br.record_failure()
    br.record_failure()
    assert br.state == "open" and not br.allow()
    # without the membership signal this peer would fail-fast for 60s;
    # the gossip-alive release collapses the cooldown to ONE probe
    transport.on_peer_alive(addr)
    assert br.state == "half-open"
    assert br.allow()  # the immediate half-open probe slot
    br.record_success()
    assert br.state == "closed"


def test_heal_recovery_is_probe_bound_not_cooldown_bound(tmp_path):
    """End-to-end satellite acceptance: open a breaker against a
    partitioned peer with a LONG cooldown, heal the partition, and the
    next data-plane call must go through within gossip-probe time —
    not after the cooldown."""
    cluster = _PortCluster(str(tmp_path))
    try:
        cluster.wait_members()
        addr = cluster.addr_of("n2")
        br = transport.breaker_for(addr)
        br.cooldown_s = 60.0
        faultline.isolate("n2", name="breakercut")
        with faultline.node_scope("n0"):
            for _ in range(br.threshold):
                with pytest.raises(RpcError):
                    rpc(addr, "/indices/None/none/overview", {},
                        timeout=1.0)
        assert br.state == "open"
        faultline.heal("breakercut")
        t0 = time.perf_counter()
        deadline = time.time() + 10.0
        ok = False
        while time.time() < deadline:
            try:
                with faultline.node_scope("n0"):
                    rpc(addr, "/indices/None/none/overview", {},
                        timeout=1.0)
                ok = True
                break
            except transport.CircuitOpenError:
                time.sleep(0.05)  # waiting on the gossip-alive release
            except RpcError:
                ok = True  # an HTTP error IS a living peer
                break
        recovery = time.perf_counter() - t0
        assert ok, "breaker never released after heal"
        assert recovery < 10.0 < br.cooldown_s, \
            f"recovery took {recovery:.1f}s — cooldown-bound, not " \
            "probe-bound"
        assert br.state in ("closed", "half-open")
    finally:
        cluster.close()
