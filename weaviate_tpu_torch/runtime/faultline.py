"""faultline: deterministic fault injection at named boundaries.

Every cross-node and cross-device boundary in this codebase has a
failure story only if it can be MADE to fail on demand. This registry
names those boundaries as fault points; production code calls
``fire("point", ...)`` at each one. Disarmed (the default, and the only
state outside tests/the chaos harness) that call is a read of one module
global and an immediate return — nothing allocates, nothing locks, no
schedule lookup happens, so the serving hot path pays a single
predictable branch (the ``served_pipeline`` bench band is the proof).

Armed, a fault point executes a DETERMINISTIC schedule — "fail the 3rd
call", "every 4th call", "calls 2 and 5", or a seeded Bernoulli draw —
so a chaos test that fails replays bit-for-bit from its seed. Supported
actions:

- ``error``    raise (default ``FaultInjected``; sites map it to their
               domain error exactly like a real failure)
- ``latency``  sleep ``latency_s`` then continue
- ``drop``     returned as a directive: the site completes the send but
               discards the reply (the 2PC "prepare landed, ack lost"
               scenario a timeout alone cannot produce)
- ``corrupt``  returned as a directive: the site damages the payload
               (transport garbles the response body; kv flips bytes)
- ``crash``    ``os._exit(exit_code)`` (default 137, the SIGKILL status)
               right at the fault point — the crashpoint primitive the
               kill-restart-verify harness (tools/crashtest) schedules
               at every persistence boundary
- ``torn``     returned as the Schedule itself: the site (fsutil's
               ``guarded_write`` file wrapper) writes the first
               ``torn_bytes`` bytes of its payload, flushes, then
               ``os._exit`` — a genuinely partial frame on disk,
               simulating process death mid-``write(2)``

Every injection bumps ``weaviate_tpu_fault_injected_total{point,action}``
and annotates the active trace span, so a chaos run can assert that the
metrics/span plumbing accounts for every fault it scheduled (``crash``/
``torn`` injections die before any assert — their ledger is the on-disk
state the harness verifies after restart).

Known fault points (grep for ``faultline.fire`` to verify):

==========================  ==================================================
point                       boundary
==========================  ==================================================
``transport.rpc.send``      every intra-cluster HTTP RPC (cluster/transport)
``remote.shard_op``         RemoteShardClient data-plane ops (cluster/remote)
``replication.prepare``     2PC prepare, per replica (incl. local short-circuit)
``replication.commit``      2PC commit, per replica (incl. local short-circuit)
``kv.get_many``             batched LSM point lookups (storage/kv)
``transfer.d2h``            the sanctioned device->host fetch (runtime/transfer)
``batcher.dispatch``        one coalesced device dispatch (runtime/query_batcher)
``wal.append.pre_fsync``    WAL frame written (tear-able), before fsync
``wal.append.post_fsync``   WAL frame durable, before the ack returns
``wal.create``              new WAL file minted, before its dir entry is synced
``segment.write.mid``       per record inside a segment write (tear-able)
``segment.write.pre_rename``segment bytes fsynced, before os.replace
``segment.post_rename``     segment renamed+dir-synced, before WAL delete
``raft.persist.meta``       before (term, votedFor) hits the raft bucket
``raft.persist.log``        before a log batch hits the raft bucket
``raft.persist.snapshot``   before the FSM snapshot hits the raft bucket
``hnsw.snap.pre_replace``   HNSW snapshot fsynced, before os.replace
``hnsw.snap.post_replace``  snapshot durable, before the op-log reset
==========================  ==================================================

Beyond per-call fault points, the TOPOLOGY layer (bottom of this module)
models cluster-scale network partitions as a set of DIRECTED link rules
over (src, dst) node pairs, consulted by ``cluster/transport.rpc`` on
every intra-cluster call. A cut request direction fails like an
unreachable peer; a cut *reply* direction lets the server execute the
handler and loses the ack — which is how a one-way partition actually
behaves over an HTTP transport, and what the asymmetric raft scenarios
("leader can send but not receive") need. Rules are scheduled
deterministically in consult counts (``after``/``duration`` windows,
``period``/``duty`` flapping, seeded Bernoulli) and are armable through
``WEAVIATE_TPU_FAULTLINE`` in subprocess nodes like every other
schedule.
"""

from __future__ import annotations

import contextvars
import os
import random
import threading
import time
from contextlib import contextmanager

#: the disarmed fast path: ``fire`` checks this plain module global
#: before touching anything else. Only arm/disarm mutate it (under
#: ``_lock``); readers tolerate the benign race — a site racing a
#: concurrent arm() simply misses the very first scheduled call.
_ARMED = False

_lock = threading.Lock()
_schedules: dict[str, list["Schedule"]] = {}

#: the persistence crashpoints, in deterministic sweep order — the
#: crashtest harness iterates exactly this tuple, and KNOWN_POINTS is
#: derived from it below, so there is ONE list to maintain
CRASHPOINTS = (
    "wal.append.pre_fsync",
    "wal.append.post_fsync",
    "wal.create",
    "segment.write.mid",
    "segment.write.pre_rename",
    "segment.post_rename",
    "raft.persist.meta",
    "raft.persist.log",
    "raft.persist.snapshot",
    "hnsw.snap.pre_replace",
    "hnsw.snap.post_replace",
)

KNOWN_POINTS = frozenset({
    "transport.rpc.send",
    "remote.shard_op",
    "replication.prepare",
    "replication.commit",
    "kv.get_many",
    "transfer.d2h",
    "batcher.dispatch",
    # epoch migration (db/collection.py migrate_epoch): the three crash
    # windows the no-loss/no-double-serve invariant is tested across —
    # after target ingest, after the durable cutover markers, and after
    # the source delete
    "epoch.migrate.pre_ingest",
    "epoch.migrate.post_ingest",
    "epoch.migrate.post_cutover",
}) | frozenset(CRASHPOINTS)

_ACTIONS = ("error", "latency", "drop", "corrupt", "crash", "torn")


class FaultInjected(RuntimeError):
    """The default injected failure. Sites catch it alongside their real
    transport/IO errors so an injected fault takes the exact code path a
    real one would."""

    def __init__(self, point: str, message: str = ""):
        super().__init__(message or f"faultline: injected fault at {point}")
        self.point = point


class Schedule:
    """One armed fault: which calls at a point fire, and what happens.

    Deterministic by construction — matching depends only on the call
    index (``nth``/``every``/explicit sets) or on a ``random.Random(seed)``
    stream, never on wall time or thread identity."""

    __slots__ = ("point", "action", "nth", "every", "p", "latency_s",
                 "times", "error", "match", "calls", "injected", "_rng",
                 "exit_code", "torn_bytes")

    def __init__(self, point: str, action: str = "error", *,
                 nth: int | tuple | list | set | None = None,
                 every: int | None = None, p: float | None = None,
                 seed: int = 0, latency_s: float = 0.0,
                 times: int | None = None, error=None, match=None,
                 exit_code: int = 137, torn_bytes: int = 0):
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r}; "
                             f"expected one of {_ACTIONS}")
        self.point = point
        self.action = action
        self.nth = ({nth} if isinstance(nth, int) else
                    None if nth is None else set(nth))
        self.every = every
        self.p = p
        self.latency_s = latency_s
        self.times = times
        self.error = error
        self.match = match
        self.exit_code = exit_code   # crash/torn: os._exit status
        self.torn_bytes = torn_bytes  # torn: payload bytes that land
        self.calls = 0     # calls SEEN (armed window only)
        self.injected = 0  # calls actually faulted
        self._rng = random.Random(seed)

    def _selects(self, idx: int) -> bool:
        """Does call ``idx`` (0-based since arming) fire? The Bernoulli
        stream advances on EVERY call so selection is a pure function of
        (seed, idx) regardless of hits."""
        draw = self._rng.random() if self.p is not None else None
        if self.times is not None and self.injected >= self.times:
            return False
        if self.nth is not None:
            return idx in self.nth
        if self.every is not None:
            return (idx + 1) % self.every == 0
        if self.p is not None:
            return draw < self.p
        return True  # no selector = every call (bounded by ``times``)


def arm(point: str, action: str = "error", **kw) -> Schedule:
    """Arm a schedule at a fault point; returns it (``.injected`` is the
    test's ledger). Unknown points raise — a typo'd point would arm a
    fault nothing ever fires."""
    if point not in KNOWN_POINTS:
        raise KeyError(f"unknown fault point {point!r}; known: "
                       f"{sorted(KNOWN_POINTS)}")
    sched = Schedule(point, action, **kw)
    global _ARMED
    with _lock:
        _schedules.setdefault(point, []).append(sched)
        _ARMED = True
    return sched


def disarm(point: str | None = None) -> None:
    """Remove every schedule at ``point`` (all points when None)."""
    global _ARMED
    with _lock:
        if point is None:
            _schedules.clear()
        else:
            _schedules.pop(point, None)
        _ARMED = bool(_schedules)


def armed(point: str | None = None) -> bool:
    if not _ARMED:
        return False
    with _lock:
        return bool(_schedules) if point is None else point in _schedules


@contextmanager
def injected(point: str, action: str = "error", **kw):
    """``with faultline.injected("kv.get_many", nth=0) as sched:`` —
    arm for the block, disarm THIS schedule on exit (other concurrent
    schedules at the same point survive)."""
    sched = arm(point, action, **kw)
    try:
        yield sched
    finally:
        global _ARMED
        with _lock:
            lst = _schedules.get(point)
            if lst is not None:
                try:
                    lst.remove(sched)
                except ValueError:
                    pass
                if not lst:
                    _schedules.pop(point, None)
            _ARMED = bool(_schedules)


def fire(point: str, **attrs) -> str | Schedule | None:
    """The production-side hook. Returns ``None`` (proceed normally), a
    directive string (``"drop"``/``"corrupt"``) the site interprets, or
    the matched :class:`Schedule` for ``action="torn"`` (the site needs
    its ``torn_bytes``/``exit_code``); raises the scheduled error for
    ``action="error"``; ``action="crash"`` never returns — the process
    exits right here, at the boundary the point names. Disarmed this is
    one global read and a return."""
    if not _ARMED:
        return None
    with _lock:
        scheds = list(_schedules.get(point, ()))
    directive: str | Schedule | None = None
    for sched in scheds:
        if sched.match is not None and not sched.match(attrs):
            continue
        with _lock:
            idx = sched.calls
            sched.calls += 1
            hit = sched._selects(idx)
            if hit:
                sched.injected += 1
        if not hit:
            continue
        if sched.action == "crash":
            # no metrics/span recording — the process is gone before any
            # scrape; the on-disk state IS the ledger the harness reads
            os._exit(sched.exit_code)
        _record(point, sched.action, attrs)
        if sched.action == "latency":
            time.sleep(sched.latency_s)
        elif sched.action == "error":
            err = sched.error() if callable(sched.error) else sched.error
            raise err if err is not None else FaultInjected(point)
        elif sched.action == "torn":
            directive = sched
        else:
            directive = sched.action
    return directive


def arm_from_env(var: str = "WEAVIATE_TPU_FAULTLINE",
                 env=None) -> list[Schedule]:
    """Arm schedules described by a JSON env var — the bridge that lets
    the crashtest harness schedule faults in a SUBPROCESS worker it is
    about to kill. Value: a JSON list of Schedule kwargs, e.g.
    ``[{"point": "wal.append.pre_fsync", "action": "crash", "nth": 3}]``.
    Empty/absent arms nothing."""
    import json

    env = os.environ if env is None else env
    raw = env.get(var, "")
    if not raw:
        return []
    specs = json.loads(raw)
    out = []
    for spec in specs:
        spec = dict(spec)
        if "topology" in spec:
            # a partition rule, not a per-point schedule — the bridge
            # that lets a SUBPROCESS cluster node arm its own side of a
            # partition before it even finishes booting
            topo = dict(spec["topology"])
            kind = topo.pop("kind", "partition")
            if kind == "isolate":
                out.extend(isolate(topo.pop("node"), **topo))
            elif kind == "split":
                out.extend(split(topo.pop("a"), topo.pop("b"), **topo))
            else:
                out.extend(partition(**topo))
            continue
        point = spec.pop("point")
        action = spec.pop("action", "error")
        if "nth" in spec and isinstance(spec["nth"], list):
            spec["nth"] = set(spec["nth"])
        out.append(arm(point, action, **spec))
    return out


def _record(point: str, action: str, attrs: dict) -> None:
    """Metric + span annotation for one injection. Import cycles: metrics
    and tracing both sit beside this module, so import lazily and never
    let observability failure mask the injection itself."""
    try:
        from weaviate_tpu_torch.runtime.metrics import fault_injected_total

        fault_injected_total.labels(point, action).inc()
    except Exception:  # pragma: no cover — registry unavailable
        pass
    try:
        from weaviate_tpu_torch.runtime import tracing

        # partition/fault context rides the active span (scalar attrs
        # only — span exports cross node boundaries as JSON)
        extra = {k: v for k, v in attrs.items()
                 if isinstance(v, (str, int, float, bool))}
        tracing.annotate(fault_point=point, fault_action=action, **extra)
    except Exception:  # pragma: no cover
        pass


# -- topology faults: partitions over (src, dst) node pairs --------------------
#
# A partition is a set of DIRECTED link rules: ``LinkRule(src, dst)``
# means packets from ``src`` to ``dst`` are lost while the rule is
# active. ``cluster/transport.rpc`` consults BOTH directions of every
# call: a cut request direction (caller -> callee) makes the call fail
# before anything is sent (an unreachable peer); a cut reply direction
# (callee -> caller) completes the send, lets the remote handler run,
# and loses the ack — the faultline ``drop`` directive, which is how a
# one-way partition really behaves over a request/response transport
# and what "prepare landed, ack lost" / "leader can send but not
# receive" scenarios require.
#
# The caller's identity comes from a contextvar bound by every
# RPC-originating thread (server handler dispatch, raft/gossip loops,
# cycle callbacks, the REST edge; ``tracing.propagate`` carries it onto
# pool threads). Destination names resolve through the addr->name
# registry that gossip membership keeps current. Disarmed (no rules),
# the transport-side check is one module-global read.

#: the disarmed fast path for the topology check — same discipline as
#: ``_ARMED``: plain global, mutated only under ``_topo_lock``
_TOPO_ARMED = False

_topo_lock = threading.Lock()
_links: list["LinkRule"] = []
_addr_names: dict[str, str] = {}  # "host:port" -> node name

_local_node: contextvars.ContextVar = contextvars.ContextVar(
    "weaviate_tpu_faultline_node", default=None)

#: bind this as the node identity for out-of-band harness traffic (the
#: chaos driver's readiness polls, post-mortem probes): topology rules
#: never cut the observer — it is the experimenter's side channel, not
#: part of the cluster under test
OBSERVER = "__observer__"

#: identifies THIS process's topology registry on the wire. The
#: transport's "already checked" header carries it so a server skips
#: its own evaluation only when the client consulted the SAME registry
#: (same process — avoiding double-counted rule consults); when both
#: sides of a cross-process link arm their own rules, each side
#: enforces its own (compositional partition semantics).
PROCESS_TOKEN = f"{os.getpid():x}-{random.getrandbits(32):08x}"


def register_node(name: str, addr: str) -> None:
    """Record a node's advertised transport address so link rules can be
    written over NODE NAMES. Membership calls this for itself and every
    peer it learns; re-registration (an address change) just overwrites."""
    with _topo_lock:
        # drop a stale reverse mapping when a node moves address
        for a, n in list(_addr_names.items()):
            if n == name and a != addr:
                del _addr_names[a]
        _addr_names[addr] = name


def node_for_addr(addr: str) -> str | None:
    with _topo_lock:
        return _addr_names.get(addr)


def bind_node(name: str | None) -> None:
    """Bind the calling context's node identity (which cluster node this
    thread issues RPCs on behalf of). Loop threads bind once at start;
    request-scoped work uses :func:`node_scope`."""
    _local_node.set(name)


def current_node() -> str | None:
    return _local_node.get()


@contextmanager
def node_scope(name: str | None):
    """Bind the node identity for a block (no-op scope when ``name`` is
    None so call sites need no conditional)."""
    if name is None:
        yield
        return
    token = _local_node.set(name)
    try:
        yield
    finally:
        _local_node.reset(token)


class LinkDown(FaultInjected):
    """Injected 'destination unreachable': the request direction of a
    partitioned link. Subclasses FaultInjected so the transport maps it
    to RpcError and feeds the circuit breaker exactly like a real
    connection failure."""

    def __init__(self, src, dst, rule: str):
        super().__init__("topology.link",
                         f"faultline: link {src}->{dst} cut by partition "
                         f"rule {rule!r}")
        self.src, self.dst, self.rule = src, dst, rule


def _match_side(pattern, node) -> bool:
    """``pattern``: "*" (matches anything, incl. an unbound/unknown
    side), a node name, or a list/set/tuple of names."""
    if pattern == "*":
        return True
    if node is None:
        return False
    if isinstance(pattern, (set, frozenset, list, tuple)):
        return node in pattern
    return node == pattern


class LinkRule:
    """One directed link fault: traffic ``src -> dst`` is lost while the
    rule is active. Activity is a deterministic function of the rule's
    own consult counter (every consult of this directed edge bumps it):

    - ``after``:    rule activates at consult index ``after`` (default 0)
    - ``duration``: stays active for this many consults, then is spent
                    (None = until healed)
    - ``period``/``duty``: flapping — within each window of ``period``
                    consults (counted from ``after``) the link is down
                    for the first ``duty`` consults and up for the rest
    - ``p``/``seed``: seeded Bernoulli per consult (composable with the
                    window above; the stream advances every consult so
                    selection is a pure function of (seed, index))
    """

    __slots__ = ("name", "src", "dst", "after", "duration", "period",
                 "duty", "p", "_rng", "consults", "cuts")

    def __init__(self, src, dst, *, name: str = "partition",
                 after: int = 0, duration: int | None = None,
                 period: int | None = None, duty: int | None = None,
                 p: float | None = None, seed: int = 0):
        if period is not None and (duty is None or not 0 < duty <= period):
            raise ValueError("flapping rules need 0 < duty <= period")
        self.name = name
        self.src = tuple(src) if isinstance(src, (list, set)) else src
        self.dst = tuple(dst) if isinstance(dst, (list, set)) else dst
        self.after = after
        self.duration = duration
        self.period = period
        self.duty = duty
        self.p = p
        self._rng = random.Random(seed)
        self.consults = 0  # directed-edge consults seen while armed
        self.cuts = 0      # consults that came back "link down"

    def covers(self, src, dst) -> bool:
        return _match_side(self.src, src) and _match_side(self.dst, dst)

    def _fires(self) -> bool:
        """Caller holds ``_topo_lock``. One consult of this directed
        edge: advance the counter (and the Bernoulli stream), report
        whether the link is down at this index."""
        idx = self.consults
        self.consults += 1
        draw = self._rng.random() if self.p is not None else None
        if idx < self.after:
            return False
        if self.duration is not None and idx >= self.after + self.duration:
            return False
        if self.period is not None \
                and (idx - self.after) % self.period >= self.duty:
            return False
        if self.p is not None and draw >= self.p:
            return False
        self.cuts += 1
        return True

    def snapshot(self) -> dict:
        return {"name": self.name, "src": self.src, "dst": self.dst,
                "after": self.after, "duration": self.duration,
                "period": self.period, "duty": self.duty, "p": self.p,
                "consults": self.consults, "cuts": self.cuts}


def partition(src="*", dst="*", *, symmetric: bool = False,
              **kw) -> list[LinkRule]:
    """Arm a directed link fault (both directions when ``symmetric``).
    Returns the armed rules — their ``cuts`` counters are the test's
    ledger, like ``Schedule.injected``."""
    global _TOPO_ARMED
    rules = [LinkRule(src, dst, **kw)]
    if symmetric:
        rules.append(LinkRule(dst, src, **kw))
    with _topo_lock:
        _links.extend(rules)
        _TOPO_ARMED = True
    return rules


def isolate(node, **kw) -> list[LinkRule]:
    """Symmetric full cut around ``node`` (or a group): nothing in,
    nothing out — the minority-partition primitive."""
    return partition(node, "*", symmetric=True, **kw)


def split(group_a, group_b, **kw) -> list[LinkRule]:
    """Symmetric partition between two groups: every link crossing the
    boundary is cut in both directions; links inside a group stay up."""
    return partition(list(group_a), list(group_b), symmetric=True, **kw)


def heal(name: str | None = None) -> None:
    """Remove partition rules by name (all rules when None). The
    autouse test fixture heals everything between tests, like disarm."""
    global _TOPO_ARMED
    with _topo_lock:
        if name is None:
            _links.clear()
        else:
            _links[:] = [r for r in _links if r.name != name]
        _TOPO_ARMED = bool(_links)


def topology_armed() -> bool:
    return _TOPO_ARMED


def topology_snapshot() -> list[dict]:
    with _topo_lock:
        return [r.snapshot() for r in _links]


def _check_pair(src: str | None, dst: str | None) -> str | None:
    """Verdict for one RPC from ``src`` to ``dst``: consult the request
    direction (src->dst) and the reply direction (dst->src) of every
    rule. Caller already handled the disarmed fast path."""
    if src == OBSERVER:
        return None  # the harness's side channel is never partitioned
    if src is not None and src == dst:
        return None  # a node always reaches itself
    cut_req = cut_reply = False
    names: list[str] = []
    with _topo_lock:
        for rule in _links:
            req = rule.covers(src, dst)
            rep = rule.covers(dst, src)
            if not req and not rep:
                continue
            # exactly ONE consult per rule per RPC — a rule whose
            # patterns cover both directions of this call (wildcards)
            # must not double-bump its counter, or the documented
            # after/duration/period windows halve and the two direction
            # checks draw alternating indices from one stream, breaking
            # seeded replay math. Request direction takes priority when
            # both are covered ("unreachable" wins over "drop" anyway).
            if rule._fires():
                if req:
                    cut_req = True
                else:
                    cut_reply = True
                names.append(rule.name)
    if not cut_req and not cut_reply:
        return None
    verdict = "unreachable" if cut_req else "drop"
    _record("topology.link", verdict,
            {"fault_link": f"{src}->{dst}",
             "fault_partition": ",".join(dict.fromkeys(names))})
    return verdict


def check_link(dst_addr: str, *, src: str | None = None,
               path: str = "") -> str | None:
    """The client-side transport hook: verdict for one RPC about to go
    to ``dst_addr``. Returns None (link up), ``"unreachable"`` (request
    direction cut — fail before sending), or ``"drop"`` (reply
    direction cut — send, let the handler run, lose the ack).
    Disarmed this is one global read and a return."""
    if not _TOPO_ARMED:
        return None
    if src is None:
        src = _local_node.get()
    return _check_pair(src, node_for_addr(dst_addr))


def check_link_incoming(src: str | None, dst: str | None) -> str | None:
    """The SERVER-side hook, for requests whose sender did not consult
    this registry (a subprocess cluster node: its faultline lives in its
    own process). A cut request direction means this request "never
    arrived" — the server closes the connection without dispatching; a
    cut reply direction dispatches the handler and closes without
    answering (the work happened, the ack is lost). Together with the
    client-side check this lets ONE process's partition rules govern a
    mixed in-process + subprocess cluster."""
    if not _TOPO_ARMED:
        return None
    return _check_pair(src, dst)
