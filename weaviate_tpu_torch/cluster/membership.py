"""Gossip membership: node discovery, metadata, failure detection (port
of ``weaviate_tpu/cluster/membership.py``; ``hbmBytes`` meta carries the
node's device-memory ledger, the card's bytes on a CUDA node).

Reference: usecases/cluster/state.go (Init joins a memberlist cluster),
delegate.go (per-node metadata broadcast — disk space — and
NotifyJoin/NotifyLeave events :283-305). hashicorp/memberlist does
SWIM-style UDP gossip; here nodes push their full membership view to a
few random peers per interval over the internal HTTP port and merge
views by (incarnation, last_seen) — same eventual outcome (every node
learns every node + liveness) with much simpler machinery.
"""

from __future__ import annotations

import logging
import random
import threading
import time

from weaviate_tpu_torch.cluster.transport import RpcError, on_peer_alive, rpc
from weaviate_tpu_torch.runtime import faultline

logger = logging.getLogger(__name__)

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"

#: every Nth gossip tick also probes one DEAD peer. Without this a
#: partition that outlives ``dead_after`` never heals at the membership
#: layer: both sides mark each other DEAD, DEAD peers are excluded from
#: gossip targets, and with nobody left to talk to the views stay split
#: forever even though the network recovered (hashicorp/memberlist
#: solves the same problem with its dead-node gossip probability).
DEAD_PROBE_EVERY = 4


class NodeInfo:
    __slots__ = ("name", "addr", "status", "incarnation", "last_seen", "meta")

    def __init__(self, name: str, addr: str, status: str = ALIVE,
                 incarnation: int = 0, last_seen: float = 0.0,
                 meta: dict | None = None):
        self.name = name
        self.addr = addr
        self.status = status
        self.incarnation = incarnation
        self.last_seen = last_seen or time.time()
        self.meta = meta or {}

    def to_dict(self) -> dict:
        return {"name": self.name, "addr": self.addr, "status": self.status,
                "incarnation": self.incarnation, "last_seen": self.last_seen,
                "meta": self.meta}

    @classmethod
    def from_dict(cls, d: dict) -> "NodeInfo":
        return cls(d["name"], d["addr"], d.get("status", ALIVE),
                   d.get("incarnation", 0), d.get("last_seen", 0.0),
                   d.get("meta", {}))


class Membership:
    """One node's view of the cluster.

    ``server`` is an InternalServer to mount /cluster/gossip on; gossip
    rounds are driven by ``tick()`` (callers register it on a
    CycleManager) or the built-in thread via start().
    """

    def __init__(self, name: str, server, fanout: int = 3,
                 interval: float = 0.5, suspect_after: float = 2.0,
                 dead_after: float = 5.0, on_change=None):
        self.name = name
        self.server = server
        self.fanout = fanout
        self.interval = interval
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        self.on_change = on_change  # fn(node_name, old_status, new_status)
        self._lock = threading.RLock()
        self_info = NodeInfo(name, server.address)
        self._nodes: dict[str, NodeInfo] = {name: self_info}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._tick_count = 0
        faultline.register_node(name, server.address)
        server.route("/cluster/gossip", self._handle_gossip)

    # -- views ---------------------------------------------------------------

    def nodes(self) -> dict[str, NodeInfo]:
        with self._lock:
            return dict(self._nodes)

    def alive_nodes(self) -> list[str]:
        with self._lock:
            return sorted(n.name for n in self._nodes.values()
                          if n.status == ALIVE)

    def all_names(self) -> list[str]:
        with self._lock:
            return sorted(self._nodes)

    def addr_of(self, name: str) -> str | None:
        with self._lock:
            info = self._nodes.get(name)
            return info.addr if info is not None else None

    def resolve(self, name: str) -> str:
        addr = self.addr_of(name)
        if addr is None:
            raise KeyError(f"unknown node {name!r}")
        return addr

    def set_meta(self, **meta) -> None:
        """Update this node's broadcast metadata (reference: delegate.go
        NodeMeta carries disk usage)."""
        with self._lock:
            me = self._nodes[self.name]
            me.meta.update(meta)
            me.incarnation += 1

    # -- lifecycle -----------------------------------------------------------

    def join(self, seed_addrs: list[str]) -> int:
        """Push our view to seeds and adopt theirs (state.go:61 Init)."""
        joined = 0
        with faultline.node_scope(self.name):
            for addr in seed_addrs:
                if addr == self.server.address:
                    continue
                try:
                    view = rpc(addr, "/cluster/gossip",
                               {"nodes": self._view()})
                    self._merge(view.get("nodes", []))
                    joined += 1
                except RpcError as e:
                    logger.warning("join via %s failed: %s", addr, e)
        return joined

    def start(self) -> None:
        # under _lock: two concurrent start()s would otherwise both see
        # _thread is None and run two gossip loops for one node
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name=f"gossip-{self.name}")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # read the handle under _lock, join OUTSIDE it — the gossip loop
        # takes _lock on every tick and could never exit otherwise. Keep
        # the handle if the join times out, so a later start() cannot
        # clear _stop under a still-live loop and double it.
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(2.0)
            if not t.is_alive():
                with self._lock:
                    if self._thread is t:
                        self._thread = None

    def _loop(self) -> None:
        faultline.bind_node(self.name)  # this thread gossips AS us
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:
                logger.exception("gossip tick failed")

    # -- gossip mechanics ----------------------------------------------------

    def _view(self) -> list[dict]:
        with self._lock:
            me = self._nodes[self.name]
            me.last_seen = time.time()
            me.status = ALIVE
            return [n.to_dict() for n in self._nodes.values()]

    def tick(self) -> bool:
        """One gossip round: push view to ``fanout`` random peers, merge
        what they answer; then sweep liveness. Every
        ``DEAD_PROBE_EVERY``-th round additionally probes one DEAD peer
        (round-robin) — the heal path for partitions that outlived
        ``dead_after``, after which both sides would otherwise have
        nobody left willing to gossip to the other."""
        with self._lock:
            peers = [n for n in self._nodes.values()
                     if n.name != self.name and n.status != DEAD]
            dead = sorted((n for n in self._nodes.values()
                           if n.name != self.name and n.status == DEAD),
                          key=lambda n: n.name)
            self._tick_count += 1
            tick = self._tick_count
        targets = [(p, 2.0) for p in
                   random.sample(peers, min(self.fanout, len(peers)))]
        if dead and tick % DEAD_PROBE_EVERY == 0:
            # short timeout: a black-holed dead peer must not stall the
            # single gossip thread (and the liveness sweep behind it)
            # for the full 2s ceiling every probe round — the probe only
            # needs to catch a peer that is actually back
            targets.append(
                (dead[(tick // DEAD_PROBE_EVERY) % len(dead)],
                 min(2.0, max(0.25, self.interval * 2))))
        with faultline.node_scope(self.name):
            for peer, timeout in targets:
                try:
                    reply = rpc(peer.addr, "/cluster/gossip",
                                {"nodes": self._view()}, timeout=timeout)
                    self._merge(reply.get("nodes", []))
                    self._touch(peer.name)
                except RpcError:
                    pass  # liveness sweep handles persistent failures
        self._sweep()
        return True

    def _handle_gossip(self, payload: dict) -> dict:
        self._merge(payload.get("nodes", []))
        return {"nodes": self._view()}

    def _touch(self, name: str) -> None:
        addr = None
        with self._lock:
            info = self._nodes.get(name)
            if info is not None:
                info.last_seen = time.time()
                self._set_status(info, ALIVE)
                addr = info.addr
        # DIRECT round-trip proof the peer (and therefore its shared
        # data-plane port) is reachable from HERE: release any open
        # circuit breaker for an immediate half-open probe. Only _touch
        # gets this — a relayed third-party view in _merge proves
        # nothing about OUR link under an asymmetric partition.
        if addr is not None:
            on_peer_alive(addr)

    def _merge(self, remote_nodes: list[dict]) -> None:
        for d in remote_nodes:
            info = NodeInfo.from_dict(d)
            if info.name == self.name:
                continue
            faultline.register_node(info.name, info.addr)
            with self._lock:
                mine = self._nodes.get(info.name)
                if mine is None:
                    self._nodes[info.name] = info
                    self._notify(info.name, None, info.status)
                elif (info.incarnation, info.last_seen) > (mine.incarnation,
                                                           mine.last_seen):
                    mine.addr = info.addr
                    mine.incarnation = info.incarnation
                    mine.last_seen = info.last_seen
                    mine.meta = info.meta
                    self._set_status(mine, info.status)

    def _sweep(self) -> None:
        now = time.time()
        with self._lock:
            for info in self._nodes.values():
                if info.name == self.name:
                    continue
                age = now - info.last_seen
                if age > self.dead_after:
                    self._set_status(info, DEAD)
                elif age > self.suspect_after and info.status == ALIVE:
                    self._set_status(info, SUSPECT)

    def _set_status(self, info: NodeInfo, status: str) -> None:
        if info.status != status:
            old = info.status
            info.status = status
            self._notify(info.name, old, status)

    def _notify(self, name: str, old, new) -> None:
        logger.info("membership %s: %s %s -> %s", self.name, name, old, new)
        if self.on_change is not None:
            try:
                self.on_change(name, old, new)
            except Exception:
                logger.exception("membership on_change callback failed")
