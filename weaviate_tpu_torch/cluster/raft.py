"""Raft consensus for cluster metadata (schema, tenants); port of
``weaviate_tpu/cluster/raft.py``.

Reference: cluster/store.go (hashicorp/raft + boltdb log store),
store_apply.go (FSM ops ADD_CLASS...DELETE_TENANT), raft.go:26 (leader
forwarding from followers), store_snapshot.go (FSM snapshot persist/
restore), cluster/bootstrap/bootstrap.go:33 (joining an existing
cluster). Scope parity: only schema/tenant METADATA goes through Raft —
object data takes the replication data plane.

This is a compact Raft: leader election with randomized timeouts,
AppendEntries log replication with the log-matching backtrack, majority
commit, persisted (term, votedFor, log). Three §7/§6 features beyond the
round-1 core:

- **Snapshots + log compaction**: once the applied log grows past
  ``snapshot_threshold`` entries, the FSM state (``snapshot_fn``) is
  persisted and the covered log prefix dropped — restart restores from
  the snapshot instead of replaying every schema op ever
  (reference store_snapshot.go). Log indices are ABSOLUTE; the in-RAM
  list holds [log_start, ...).
- **InstallSnapshot RPC**: a follower whose next entry was compacted
  away receives the snapshot + trailing log instead of an append.
- **Dynamic membership**: ``raft_conf`` add/remove entries flow through
  the log itself; each node recomputes its peer set from
  (snapshot peers + conf entries in the log) so the set is consistent
  with whatever log prefix a node has (single-server changes, Raft §6).
  A new node calls ``request_join`` against any member (reference
  bootstrap joiner) and suppresses elections until a leader contacts it.
"""

from __future__ import annotations

import logging
import random
import threading
import time

from weaviate_tpu_torch.cluster.transport import RpcError, rpc
from weaviate_tpu_torch.runtime import faultline

logger = logging.getLogger(__name__)

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"


class NotLeaderError(RuntimeError):
    def __init__(self, leader: str | None):
        super().__init__(f"not the leader (leader={leader})")
        self.leader = leader


class LostEntryError(RuntimeError):
    """A proposal's entry was replaced before it committed: a new leader
    that never received it wrote its own entry at the same index (Raft
    §5.3), and the op that index applied is another one."""


class RaftNode:
    def __init__(self, name: str, peers: list[str], resolver, server,
                 apply_fn, store_bucket=None,
                 election_timeout: tuple[float, float] = (0.3, 0.6),
                 heartbeat_interval: float = 0.08,
                 snapshot_fn=None, restore_fn=None,
                 snapshot_threshold: int = 256,
                 step_down_timeout: float | None = None):
        """``peers``: bootstrap member names incl. self (later changed via
        conf entries). ``resolver(name) -> addr``. ``apply_fn(op)``
        applies a committed entry to the FSM. ``snapshot_fn() -> dict`` /
        ``restore_fn(state)`` serialize/install FSM state for compaction
        and joiner catch-up. ``store_bucket``: KV bucket for persistence.
        ``step_down_timeout``: a leader that has heard no reply from a
        majority for this long abdicates (default 4x the upper election
        timeout) — without it, a one-way-partitioned leader that can
        SEND but not RECEIVE keeps heartbeating followers forever, no
        election ever fires, and the cluster wedges unavailable."""
        self.name = name
        self.bootstrap_peers = sorted(set(peers) | {name})
        self.peers = list(self.bootstrap_peers)
        self.resolver = resolver
        self.apply_fn = apply_fn
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.snapshot_threshold = snapshot_threshold
        self._bucket = store_bucket
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval
        self.step_down_timeout = (4 * election_timeout[1]
                                  if step_down_timeout is None
                                  else step_down_timeout)

        self._lock = threading.RLock()
        self._applied_cv = threading.Condition(self._lock)
        self.role = FOLLOWER
        self.current_term = 0
        self.voted_for: str | None = None
        self.log: list[dict] = []  # {"term": int, "op": dict}; log[0] is
        self.log_start = 0  # ...absolute index ``log_start``
        self.snap_last_term = 0  # term of entry log_start-1 (snapshot tail)
        self.commit_index = -1
        self.last_applied = -1
        self.leader_id: str | None = None
        self._next_index: dict[str, int] = {}
        self._match_index: dict[str, int] = {}
        # index -> term of the entry applied there, for the indexes a
        # local proposal waits on (None until applied)
        self._proposed: dict[int, int | None] = {}
        # last reply (ANY reply — an unsuccessful append still proves
        # connectivity) received from each peer while leading, and the
        # last time a leader's RPC reached US while following — the
        # inputs to step-down and vote stickiness respectively
        self._peer_contact: dict[str, float] = {}
        self._last_leader_contact = 0.0
        self._deadline = self._new_deadline()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

        self._restore()
        server.route("/raft/vote", self._handle_vote)
        server.route("/raft/append", self._handle_append)
        server.route("/raft/propose", self._handle_propose)
        server.route("/raft/snapshot", self._handle_install_snapshot)
        server.route("/raft/join", self._handle_join)
        server.route("/raft/leave", self._handle_leave)

    # -- absolute-index helpers ----------------------------------------------

    def _abs_last(self) -> int:
        return self.log_start + len(self.log) - 1

    def _entry(self, i: int) -> dict:
        return self.log[i - self.log_start]

    def _term_at(self, i: int) -> int:
        """Term of absolute index i; the snapshot remembers its tail term."""
        if i < self.log_start - 1:
            return -1  # compacted away (only valid to ask about the tail)
        if i == self.log_start - 1:
            return self.snap_last_term
        return self._entry(i)["term"]

    # -- persistence ---------------------------------------------------------
    #
    # Raft's safety argument requires (term, votedFor, log) to hit DISK
    # before the RPC that exposed them is answered — a node that votes,
    # crashes, and forgets it voted can grant a second vote in the same
    # term (two leaders); a follower that acks an append and loses the
    # entries lets the leader count a majority that doesn't exist. The
    # raft bucket is therefore pinned ``sync_wal=True`` at construction
    # (cluster/node.py) regardless of PERSISTENCE_WAL_SYNC, and every
    # persist below batches its records into ONE WAL frame — one fsync
    # per RPC response, not one per record (the hashicorp/raft+boltdb
    # reference gets the same through one bolt transaction per persist).

    def _meta_pair(self) -> tuple[bytes, dict]:
        return (b"meta", {"term": self.current_term,
                          "voted_for": self.voted_for})

    def _span_pair(self) -> tuple[bytes, dict]:
        return (b"log_span", {"start": self.log_start,
                              "len": len(self.log),
                              "snap_last_term": self.snap_last_term})

    def _persist_meta(self) -> None:
        if self._bucket is not None:
            faultline.fire("raft.persist.meta", term=self.current_term)
            self._bucket.put(*self._meta_pair())

    def _persist_log(self, start_abs: int | None = None,
                     extra_pairs=None) -> None:
        """Persist entries >= start_abs, the span, AND the meta in one
        synced frame — callers answer their RPC right after, so this is
        the per-response fsync. ``extra_pairs`` ride the SAME frame: the
        snapshot-taking paths pass the snapshot record here so a crash
        can never land between the snapshot and the span that must
        agree with it."""
        if self._bucket is None:
            return
        start_abs = self.log_start if start_abs is None else start_abs
        faultline.fire("raft.persist.log", start=start_abs)
        pairs: list[tuple[bytes, object]] = list(extra_pairs or [])
        pairs.extend(
            (f"log-{i:012d}".encode(), self._entry(i))
            for i in range(max(start_abs, self.log_start),
                           self.log_start + len(self.log)))
        pairs.append(self._span_pair())
        pairs.append(self._meta_pair())
        self._bucket.put_many(pairs)

    def _snapshot_pair(self, state: dict, last_index: int,
                       last_term: int, peers: list[str]
                       ) -> tuple[bytes, dict]:
        faultline.fire("raft.persist.snapshot", last_index=last_index)
        return (b"snapshot", {"state": state,
                              "last_index": last_index,
                              "last_term": last_term,
                              "peers": peers})

    def _truncate_log_from(self, abs_i: int, persist: bool = True) -> None:
        """Drop entries >= abs_i (conflict truncation).

        ``persist=False`` is for the append-conflict path whose very
        next statement is a full ``_persist_log`` — the span in that
        batched frame supersedes this one, so writing it here too
        would pay a second fsync per conflicting AppendEntries."""
        del self.log[abs_i - self.log_start:]
        if persist and self._bucket is not None:
            faultline.fire("raft.persist.log", start=abs_i)
            self._bucket.put(*self._span_pair())
        self._recompute_peers()

    def _restore(self) -> None:
        if self._bucket is None:
            return
        meta = self._bucket.get(b"meta")
        if meta:
            self.current_term = meta["term"]
            self.voted_for = meta.get("voted_for")
        snap = self._bucket.get(b"snapshot")
        snap_peers = None
        if snap:
            self.log_start = snap["last_index"] + 1
            self.snap_last_term = snap["last_term"]
            self.commit_index = snap["last_index"]
            self.last_applied = snap["last_index"]
            snap_peers = list(snap.get("peers") or [])
            if self.restore_fn is not None:
                try:
                    self.restore_fn(snap["state"])
                except Exception:
                    logger.exception("raft %s: snapshot restore failed",
                                     self.name)
        span = self._bucket.get(b"log_span")
        if span:
            snap_start = self.log_start  # boundary the snapshot set
            start, n = span["start"], span["len"]
            # tolerate a snapshot taken after the last log persist
            start = max(start, snap_start)
            self.log = [self._bucket.get(f"log-{i:012d}".encode())
                        for i in range(start, span["start"] + n)]
            self.log_start = start
            if span["start"] >= snap_start:
                self.snap_last_term = span.get("snap_last_term",
                                               self.snap_last_term)
            # else: the span predates the snapshot (a crash between the
            # two persist frames of the pre-batching format) — its tail
            # term describes an OLDER boundary; adopting it would make
            # _last_log() under-report this node's last term and let it
            # grant votes to candidates with older logs (Raft §5.4.1).
            # The snapshot's own last_term stands.
        else:
            n = self._bucket.get(b"log_len") or 0  # round-1 format
            self.log = [self._bucket.get(f"log-{i:012d}".encode())
                        for i in range(n)]
            self.log_start = 0
        if snap_peers is not None:
            self.bootstrap_peers = sorted(set(snap_peers) | {self.name})
        self._recompute_peers()

    # -- membership ----------------------------------------------------------

    def _recompute_peers(self) -> None:
        """Peer set = snapshot/bootstrap peers + conf entries in the log.
        Deterministic in the log prefix, so truncation reverts cleanly and
        conf changes take effect at APPEND time (Raft §6). Caller holds
        ``_lock`` (or runs during single-threaded restore)."""
        peers = set(self.bootstrap_peers)
        for e in self.log:
            op = e.get("op") or {}
            if op.get("type") == "raft_conf":
                if op.get("add"):
                    peers.add(op["add"])
                if op.get("remove"):
                    peers.discard(op["remove"])
        self.peers = sorted(peers | {self.name})
        self._next_index = {p: self._next_index.get(p, self._abs_last() + 1)
                            for p in self.peers if p != self.name}
        self._match_index = {p: self._match_index.get(p, -1)
                             for p in self.peers if p != self.name}

    def request_join(self, member_addr: str, timeout: float = 15.0) -> None:
        """Join a running cluster through any member (reference
        cluster/bootstrap/bootstrap.go:33). Blocks until the conf entry
        commits and this node has been contacted by the leader."""
        with self._lock:
            # don't elect ourselves while joining a real cluster
            self._deadline = time.monotonic() + timeout
        deadline = time.time() + timeout
        last: Exception | None = None
        while time.time() < deadline:
            try:
                with faultline.node_scope(self.name):
                    reply = rpc(member_addr, "/raft/join",
                                {"name": self.name},
                                timeout=min(5.0, deadline - time.time()))
                with self._lock:
                    # learn the existing membership from the reply — the
                    # original members predate any conf entry in the log
                    self.bootstrap_peers = sorted(
                        set(reply.get("peers") or []) | {self.name})
                    self._recompute_peers()
                    self._deadline = time.monotonic() + 5.0
                # wait until the leader's appends reach us
                while time.time() < deadline:
                    with self._lock:
                        if self.leader_id is not None and \
                                self.name in self.peers:
                            return
                    time.sleep(0.05)
            except (RpcError, KeyError) as e:
                last = e
                time.sleep(0.2)
        raise TimeoutError(f"raft join via {member_addr} timed out: {last}")

    def _handle_join(self, payload: dict) -> dict:
        """Any member accepts a join request; non-leaders forward."""
        name = payload["name"]
        with self._lock:
            role, leader = self.role, self.leader_id
            already = name in self.peers
            peers = list(self.peers)
        if already:
            return {"ok": True, "peers": peers}
        if role != LEADER:
            if leader is None or leader == self.name:
                raise NotLeaderError(leader)
            return rpc(self.resolver(leader), "/raft/join", payload,
                       timeout=5.0)
        self.propose_local({"type": "raft_conf", "add": name})
        with self._lock:
            peers = list(self.peers)
        return {"ok": True, "peers": peers}

    def _handle_leave(self, payload: dict) -> dict:
        name = payload["name"]
        with self._lock:
            role, leader = self.role, self.leader_id
            present = name in self.peers
        if not present:
            return {"ok": True}
        if role != LEADER:
            if leader is None or leader == self.name:
                raise NotLeaderError(leader)
            return rpc(self.resolver(leader), "/raft/leave", payload,
                       timeout=5.0)
        self.propose_local({"type": "raft_conf", "remove": name})
        return {"ok": True}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        # under _lock: two concurrent start()s would otherwise both see
        # _thread is None and spawn two raft loops against one log
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name=f"raft-{self.name}")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # read the handle under _lock but join OUTSIDE it — the loop
        # thread takes _lock every tick and could never exit otherwise.
        # On a timed-out join KEEP the handle: dropping it would let a
        # later start() clear _stop (un-stopping the live loop) and
        # spawn a second one against the same log.
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(2.0)
            if not t.is_alive():
                with self._lock:
                    if self._thread is t:
                        self._thread = None

    def _new_deadline(self) -> float:
        return time.monotonic() + random.uniform(*self.election_timeout)

    def _loop(self) -> None:
        faultline.bind_node(self.name)  # this thread campaigns AS us
        while not self._stop.wait(0.01):
            try:
                with self._lock:
                    role = self.role
                if role == LEADER:
                    self._replicate_all()
                    time.sleep(self.heartbeat_interval)
                elif time.monotonic() >= self._deadline:
                    self._run_election()
            except Exception:
                logger.exception("raft %s loop error", self.name)

    # -- election ------------------------------------------------------------

    def _last_log(self) -> tuple[int, int]:
        last = self._abs_last()
        return (last, self._term_at(last) if last >= 0 else 0)

    def _run_election(self) -> None:
        with self._lock:
            self.role = CANDIDATE
            self.current_term += 1
            self.voted_for = self.name
            self.leader_id = None
            term = self.current_term
            last_index, last_term = self._last_log()
            peers = list(self.peers)
            self._persist_meta()
            self._deadline = self._new_deadline()
        votes = 1
        for peer in peers:
            if peer == self.name:
                continue
            try:
                with faultline.node_scope(self.name):
                    reply = rpc(self.resolver(peer), "/raft/vote",
                                {"term": term, "candidate": self.name,
                                 "last_log_index": last_index,
                                 "last_log_term": last_term}, timeout=1.0)
            except (RpcError, KeyError):
                continue
            with self._lock:
                if reply["term"] > self.current_term:
                    self._become_follower(reply["term"])
                    return
                if reply.get("granted") and self.role == CANDIDATE \
                        and self.current_term == term:
                    votes += 1
        with self._lock:
            if self.role == CANDIDATE and self.current_term == term \
                    and votes > len(peers) // 2:
                self._become_leader()

    def _become_leader(self) -> None:
        """Caller holds ``_lock`` (vote-count section of the election)."""
        logger.info("raft %s: leader for term %d", self.name, self.current_term)
        self.role = LEADER
        self.leader_id = self.name
        n = self._abs_last() + 1
        now = time.monotonic()
        self._next_index = {p: n for p in self.peers if p != self.name}
        self._match_index = {p: -1 for p in self.peers if p != self.name}
        # fresh lease: every peer counts as heard-from at election time
        # (they just voted) so the quorum-contact check gets a full
        # step_down_timeout grace window before it can fire
        self._peer_contact = {p: now for p in self.peers if p != self.name}
        self._reanchor_warned: set[str] = set()
        # no-op barrier entry so the new leader can commit prior-term
        # entries (Raft §5.4.2)
        self.log.append({"term": self.current_term, "op": {"type": "noop"}})
        self._persist_log(n)

    def _become_follower(self, term: int) -> None:
        """Caller holds ``_lock`` (every RPC reply / handler section)."""
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self._persist_meta()
        self.role = FOLLOWER
        self._deadline = self._new_deadline()

    # -- replication (leader side) -------------------------------------------

    def _replicate_all(self) -> None:
        with self._lock:
            peers = list(self.peers)
        with faultline.node_scope(self.name):
            for peer in peers:
                if peer != self.name:
                    self._replicate_one(peer)
        self._check_quorum_contact()
        self._advance_commit()
        self._maybe_snapshot()

    def _recent_quorum_contact(self, window: float) -> bool:
        """Did a majority (incl. self) answer within ``window``?
        Caller holds ``_lock``."""
        now = time.monotonic()
        heard = 1 + sum(
            1 for p in self.peers if p != self.name
            and now - self._peer_contact.get(p, 0.0) <= window)
        return heard > len(self.peers) // 2

    def _check_quorum_contact(self) -> None:
        """Leader lease check: step down when no majority has answered
        within ``step_down_timeout``. The one-way partition this exists
        for: a leader that can SEND but not RECEIVE keeps resetting its
        followers' election deadlines with heartbeats whose acks all
        vanish — nobody ever campaigns, nothing ever commits. Abdicating
        stops the heartbeats so the reachable majority elects a leader
        that can actually hear acks. Same term kept: this is a lease
        expiry, not a new election."""
        with self._lock:
            if self.role != LEADER or len(self.peers) <= 1:
                return
            if self._recent_quorum_contact(self.step_down_timeout):
                return
            logger.warning(
                "raft %s: no majority contact in the last %.1fs — "
                "stepping down (term %d kept)", self.name,
                self.step_down_timeout, self.current_term)
            self.role = FOLLOWER
            self.leader_id = None
            self._deadline = self._new_deadline()

    def _replicate_one(self, peer: str) -> None:
        with self._lock:
            if self.role != LEADER:
                return
            term = self.current_term
            next_i = self._next_index.get(peer, self._abs_last() + 1)
            if next_i < self.log_start:
                # the entries this follower needs were compacted away —
                # ship the snapshot instead (InstallSnapshot, Raft §7)
                snap = (self._bucket.get(b"snapshot")
                        if self._bucket is not None else None)
                if snap is None and self.snapshot_fn is not None:
                    snap = {"state": self.snapshot_fn(),
                            "last_index": self.log_start - 1,
                            "last_term": self.snap_last_term,
                            "peers": list(self.peers)}
                if snap is None:
                    # No persisted snapshot and no snapshot_fn: an incomplete
                    # payload would KeyError on the follower and retry
                    # forever. Re-anchor the peer at log_start and serve what
                    # log remains; warn once per peer — a follower that truly
                    # needs the compacted prefix cannot catch up in this
                    # state and an operator has to intervene.
                    if peer not in self._reanchor_warned:
                        self._reanchor_warned.add(peer)
                        logger.warning(
                            "raft %s: follower %s needs compacted entries "
                            "(< %d) but no snapshot source exists; "
                            "re-anchoring at log_start — it may never "
                            "catch up", self.name, peer, self.log_start)
                    self._next_index[peer] = self.log_start
                    return
                payload = dict(snap, term=term, leader=self.name)
            else:
                payload = None
                prev_i = next_i - 1
                prev_t = self._term_at(prev_i) if prev_i >= 0 else 0
                entries = self.log[next_i - self.log_start:]
                commit = self.commit_index
        try:
            if payload is not None:
                reply = rpc(self.resolver(peer), "/raft/snapshot", payload,
                            timeout=5.0)
                with self._lock:
                    self._peer_contact[peer] = time.monotonic()
                    if reply["term"] > self.current_term:
                        self._become_follower(reply["term"])
                        return
                    self._match_index[peer] = payload["last_index"]
                    self._next_index[peer] = payload["last_index"] + 1
                return
            reply = rpc(self.resolver(peer), "/raft/append",
                        {"term": term, "leader": self.name,
                         "prev_index": prev_i, "prev_term": prev_t,
                         "entries": entries, "leader_commit": commit},
                        timeout=1.0)
        except (RpcError, KeyError):
            return
        with self._lock:
            self._peer_contact[peer] = time.monotonic()
            if reply["term"] > self.current_term:
                self._become_follower(reply["term"])
                return
            if self.role != LEADER or self.current_term != term:
                return
            if reply.get("success"):
                self._match_index[peer] = prev_i + len(entries)
                self._next_index[peer] = self._match_index[peer] + 1
            else:
                # log-matching backtrack
                self._next_index[peer] = max(self.log_start - 1, next_i - 1)

    def _advance_commit(self) -> None:
        with self._lock:
            if self.role != LEADER:
                return
            for n in range(self._abs_last(), self.commit_index, -1):
                if self._term_at(n) != self.current_term:
                    break  # only current-term entries commit by counting
                replicas = 1 + sum(1 for m in self._match_index.values()
                                   if m >= n)
                if replicas > len(self.peers) // 2:
                    self.commit_index = n
                    break
            self._apply_committed()

    def _apply_committed(self) -> None:
        # caller holds the lock
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            entry = self._entry(self.last_applied)
            if self.last_applied in self._proposed:
                self._proposed[self.last_applied] = entry["term"]
            op_type = entry["op"].get("type")
            if op_type in ("noop", "raft_conf"):
                continue  # conf changes applied at append time
            try:
                self.apply_fn(entry["op"])
            except Exception:
                logger.exception("raft %s: FSM apply failed at %d",
                                 self.name, self.last_applied)
        self._applied_cv.notify_all()

    # -- snapshot / compaction -----------------------------------------------

    def _maybe_snapshot(self) -> None:
        """Compact the applied log prefix into an FSM snapshot
        (reference: store_snapshot.go + raft's SnapshotThreshold)."""
        if self.snapshot_fn is None:
            return
        with self._lock:
            applied_in_log = self.last_applied - self.log_start + 1
            if applied_in_log < self.snapshot_threshold:
                return
            self.take_snapshot()

    def take_snapshot(self) -> int:
        """Snapshot now; returns the covered last index."""
        with self._lock:
            if self.last_applied < self.log_start:
                return self.log_start - 1
            state = self.snapshot_fn() if self.snapshot_fn else {}
            last = self.last_applied
            last_term = self._term_at(last)
            snap_pair = self._snapshot_pair(state, last, last_term,
                                            list(self.peers))
            # bootstrap_peers absorbs conf entries covered by the snapshot
            # so _recompute_peers stays correct over the shorter log
            self.bootstrap_peers = list(self.peers)
            drop = last - self.log_start + 1
            del self.log[:drop]
            self.log_start = last + 1
            self.snap_last_term = last_term
            # snapshot + span + meta land in ONE synced frame — a crash
            # can never leave a snapshot whose span disagrees with it
            self._persist_log(extra_pairs=[snap_pair])
            if self._bucket is not None:
                # drop compacted entry records — one batched tombstone
                # frame, after the snapshot + span are durable (a crash
                # in between replays consistently: span bounds the read)
                self._bucket.delete_many(
                    f"log-{i:012d}".encode()
                    for i in range(self.log_start - drop, self.log_start))
            logger.info("raft %s: snapshot through index %d (log now %d "
                        "entries)", self.name, last, len(self.log))
            return last

    def _handle_install_snapshot(self, payload: dict) -> dict:
        with self._lock:
            term = payload["term"]
            if term < self.current_term:
                return {"term": self.current_term}
            if term > self.current_term or self.role != FOLLOWER:
                self._become_follower(term)
            self.leader_id = payload["leader"]
            self._last_leader_contact = time.monotonic()
            self._deadline = self._new_deadline()
            last = payload["last_index"]
            if last <= self.last_applied:
                return {"term": self.current_term}
            if self.restore_fn is not None:
                try:
                    self.restore_fn(payload["state"])
                except Exception:
                    logger.exception("raft %s: snapshot install failed",
                                     self.name)
            self.log = []
            self.log_start = last + 1
            self.snap_last_term = payload["last_term"]
            self.commit_index = last
            self.last_applied = last
            self.bootstrap_peers = sorted(
                set(payload.get("peers") or []) | {self.name})
            self._persist_log(extra_pairs=[self._snapshot_pair(
                payload["state"], last, payload["last_term"],
                list(payload.get("peers") or []))])
            self._recompute_peers()
            self._applied_cv.notify_all()
            return {"term": self.current_term}

    # -- RPC handlers (follower side) -----------------------------------------

    def _handle_vote(self, payload: dict) -> dict:
        with self._lock:
            term = payload["term"]
            # leader stickiness (Raft §4.2.3): refuse higher-term vote
            # requests WITHOUT adopting the term while the cluster
            # demonstrably has a live leader. The one-way-partitioned
            # old leader ("can send but not receive") times out and
            # campaigns at ever-growing terms; honoring those requests
            # would bump the healthy majority's term every cycle and
            # keep deposing the leader it just elected. Two cases:
            # a FOLLOWER is sticky while heartbeats keep arriving; the
            # ACTIVE LEADER is sticky while its own quorum lease is
            # fresh (it never receives heartbeats, so the follower
            # clock alone would leave it permanently deposable).
            if term > self.current_term \
                    and self.leader_id != payload["candidate"]:
                sticky = (
                    self._recent_quorum_contact(self.election_timeout[0])
                    if self.role == LEADER and len(self.peers) > 1
                    else self.leader_id is not None
                    and time.monotonic() - self._last_leader_contact
                    < self.election_timeout[0])
                if sticky:
                    return {"term": self.current_term, "granted": False}
            if term > self.current_term:
                self._become_follower(term)
            granted = False
            if term == self.current_term and \
                    self.voted_for in (None, payload["candidate"]):
                my_index, my_term = self._last_log()
                up_to_date = (payload["last_log_term"], payload["last_log_index"]) \
                    >= (my_term, my_index)
                if up_to_date:
                    granted = True
                    self.voted_for = payload["candidate"]
                    self._persist_meta()
                    self._deadline = self._new_deadline()
            return {"term": self.current_term, "granted": granted}

    def _handle_append(self, payload: dict) -> dict:
        with self._lock:
            term = payload["term"]
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            if term > self.current_term or self.role != FOLLOWER:
                self._become_follower(term)
            self.leader_id = payload["leader"]
            self._last_leader_contact = time.monotonic()
            self._deadline = self._new_deadline()

            prev_i = payload["prev_index"]
            if prev_i >= self.log_start - 1:
                if prev_i > self._abs_last() or \
                        (prev_i >= self.log_start - 1 and prev_i >= 0
                         and self._term_at(prev_i) != payload["prev_term"]):
                    return {"term": self.current_term, "success": False}
            # prev_i < log_start-1: covered by our snapshot — entries
            # overlapping the snapshot are already applied; skip them below
            entries = payload["entries"]
            insert = prev_i + 1
            appended = False
            for k, e in enumerate(entries):
                i = insert + k
                if i < self.log_start:
                    continue  # snapshot already covers it
                if i <= self._abs_last():
                    if self._term_at(i) != e["term"]:
                        self._truncate_log_from(i, persist=False)
                        self.log.extend(entries[k:])
                        self._persist_log(i)
                        appended = True
                        break
                else:
                    self.log.extend(entries[k:])
                    self._persist_log(i)
                    appended = True
                    break
            if appended:
                self._recompute_peers()
            if payload["leader_commit"] > self.commit_index:
                self.commit_index = min(payload["leader_commit"],
                                        self._abs_last())
                self._apply_committed()
            return {"term": self.current_term, "success": True}

    def _handle_propose(self, payload: dict) -> dict:
        """Leader-forwarded proposal endpoint (reference raft.go:26-38:
        followers forward schema writes to the leader over gRPC)."""
        index = self.propose_local(payload["op"], timeout=payload.get("timeout", 10.0))
        return {"index": index}

    # -- public API ----------------------------------------------------------

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self.role == LEADER

    def propose(self, op: dict, timeout: float = 10.0) -> int:
        """Submit an FSM op; blocks until applied locally. Followers
        forward to the leader."""
        deadline = time.time() + timeout
        last_err: Exception | None = None
        while time.time() < deadline:
            with self._lock:
                role, leader = self.role, self.leader_id
            if role == LEADER:
                try:
                    return self.propose_local(
                        op, timeout=deadline - time.time())
                except (NotLeaderError, LostEntryError) as e:
                    # deposed before the entry committed: propose again
                    # through whoever leads now
                    logger.info("raft %s: %s; proposing again", self.name, e)
                    last_err = e
                    time.sleep(0.05)
                    continue
            if leader is not None:
                try:
                    with faultline.node_scope(self.name):
                        reply = rpc(
                            self.resolver(leader), "/raft/propose",
                            {"op": op,
                             "timeout": max(0.1, deadline - time.time())},
                            timeout=max(0.1, deadline - time.time()))
                    index = reply["index"]
                    # wait until OUR node applies it too (read-your-writes
                    # for schema; the reference schema manager reads its
                    # local FSM after Raft apply)
                    with self._applied_cv:
                        while self.last_applied < index:
                            if time.time() >= deadline:
                                raise TimeoutError(
                                    f"raft entry {index} committed on the "
                                    "leader but not yet applied locally")
                            self._applied_cv.wait(
                                max(0.05, deadline - time.time()))
                    return index
                except (RpcError, KeyError) as e:
                    last_err = e
            time.sleep(0.05)
        raise TimeoutError(f"raft propose timed out: {last_err}")

    def propose_local(self, op: dict, timeout: float = 10.0) -> int:
        with self._lock:
            if self.role != LEADER:
                raise NotLeaderError(self.leader_id)
            index = self._abs_last() + 1
            term = self.current_term
            self.log.append({"term": term, "op": op})
            self._proposed[index] = None
            self._persist_log(index)
            if op.get("type") == "raft_conf":
                self._recompute_peers()  # conf effective at append (§6)
        # replicate eagerly rather than waiting a heartbeat
        self._replicate_all()
        deadline = time.time() + timeout
        with self._applied_cv:
            try:
                while self.last_applied < index:
                    if time.time() >= deadline:
                        raise TimeoutError("raft commit timed out")
                    self._applied_cv.wait(max(0.05, deadline - time.time()))
                applied_term = self._proposed.get(index)
            finally:
                self._proposed.pop(index, None)
        # an index reached through an installed snapshot has no applied
        # term on record: the snapshot holds the op's effect or not, and
        # the index stands as before
        if applied_term is not None and applied_term != term:
            raise LostEntryError(
                f"raft entry {index} of term {term} was replaced by an "
                f"entry of term {applied_term} before it committed")
        return index

    def wait_for_leader(self, timeout: float = 10.0) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if self.leader_id is not None:
                    return self.leader_id
            time.sleep(0.05)
        raise TimeoutError("no raft leader elected")
