"""Internal cluster transport: JSON-over-HTTP on a dedicated port (port of
``weaviate_tpu/cluster/transport.py``).

Reference: adapters/handlers/rest/clusterapi/serve.go — a separate HTTP
mux on CLUSTER_DATA_BIND_PORT carries all intra-cluster traffic (shard
ops, backups, Raft and gossip); adapters/clients/* are the matching
clients.

Numpy arrays cross the wire base64-encoded inside JSON ("b64npy"
envelopes). The wire is byte-compatible with the JAX package's: the same
paths, JSON bodies, envelopes and headers, so a port node and a JAX node
answer each other. No ``torch.Tensor`` is ever encoded: a shard answers
in numpy (one ``.cpu()`` per reply, on the card's side of the boundary),
and the encoder refuses a tensor instead of walking it element by
element.
"""

from __future__ import annotations

import base64
import http.client
import io
import json
import logging
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from weaviate_tpu_torch.runtime import faultline, retry, tracing

logger = logging.getLogger(__name__)

# response header carrying the serving node's finished spans back to the
# caller (base64 json) so a distributed query stitches into ONE trace
TRACE_SPANS_HEADER = "X-Trace-Spans"

# request headers for the faultline partition topology: which cluster
# node issued this RPC, and whether the sender's process already
# consulted its topology registry (so an in-process server does not
# double-count the same rule the client side just evaluated)
SOURCE_NODE_HEADER = "X-Weaviate-Node"
TOPOLOGY_CHECKED_HEADER = "X-Topology-Checked"


def _encode_spans(spans: list[dict] | None) -> str | None:
    if not spans:
        return None
    try:
        return base64.b64encode(
            json.dumps(spans, separators=(",", ":")).encode()).decode()
    except (TypeError, ValueError):
        return None


def _decode_spans(header: str | None) -> list[dict] | None:
    if not header:
        return None
    try:
        out = json.loads(base64.b64decode(header))
        return out if isinstance(out, list) else None
    except (ValueError, TypeError):
        return None  # a corrupt trace header must never fail the RPC


# -- numpy-aware JSON encoding -------------------------------------------------


def encode_array(a: np.ndarray) -> dict:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(a), allow_pickle=False)
    return {"__b64npy__": base64.b64encode(buf.getvalue()).decode("ascii")}


def _decode_hook(d: dict):
    if "__b64npy__" in d:
        return np.load(io.BytesIO(base64.b64decode(d["__b64npy__"])),
                       allow_pickle=False)
    if "__b64__" in d:
        return base64.b64decode(d["__b64__"])
    return d


def _is_tensor(o) -> bool:
    # no torch import here: the transport stays importable (and cheap)
    # without it; a tensor's class lives in the torch module
    return type(o).__module__.startswith("torch") and hasattr(o, "device")


class _Encoder(json.JSONEncoder):
    def default(self, o):
        if _is_tensor(o):
            raise TypeError(
                "a torch.Tensor reached the internal RPC encoder: convert "
                "it to one numpy array on the host (.cpu().numpy()) before "
                "it enters a payload")
        if isinstance(o, np.ndarray):
            return encode_array(o)
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, bytes):
            return {"__b64__": base64.b64encode(o).decode("ascii")}
        return super().default(o)


def dumps(payload) -> bytes:
    return json.dumps(payload, cls=_Encoder).encode()


def loads(raw: bytes):
    return json.loads(raw.decode(), object_hook=_decode_hook)


# -- server --------------------------------------------------------------------


class InternalServer:
    """Route table + ThreadingHTTPServer. Handlers: fn(payload) -> payload.

    Routes are exact paths ("/raft/vote") or prefixes ending in "/"
    ("/indices/" receives (subpath, payload))."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 advertise: str | None = None):
        """``advertise``: the host:port OTHER nodes reach this one at —
        required when binding 0.0.0.0 in containers (reference:
        CLUSTER_ADVERTISE_ADDR/PORT in usecases/cluster config)."""
        self._advertise = advertise
        self.routes: dict[str, object] = {}
        #: owning cluster node's name (set by ClusterNode) — handlers
        #: that fan out further RPCs (raft forwarding, replication,
        #: read repair) issue them AS this node, which is what the
        #: faultline topology layer partitions on
        self.node_name: str | None = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                # server-side partition topology: requests from callers
                # that did NOT consult this process's registry (a
                # subprocess cluster node) are checked here. "never
                # arrived" = close without dispatching; "ack lost" =
                # dispatch, then close without answering. Either way the
                # caller sees a dead connection, never an HTTP status —
                # a partitioned peer must not look alive.
                link = None
                if outer.node_name is not None and \
                        self.headers.get(TOPOLOGY_CHECKED_HEADER) \
                        != faultline.PROCESS_TOKEN:
                    link = faultline.check_link_incoming(
                        self.headers.get(SOURCE_NODE_HEADER),
                        outer.node_name)
                    if link == "unreachable":
                        self.close_connection = True
                        return
                # adopt an incoming traceparent: spans recorded while
                # handling chain to the caller's span and are exported
                # back in the response for cross-node stitching
                seg = None
                try:
                    payload = loads(raw) if raw else {}
                    with faultline.node_scope(outer.node_name), \
                            tracing.remote_segment(
                            self.headers.get("traceparent"),
                            name="rpc.server", path=self.path) as seg:
                        result = outer.dispatch(self.path, payload)
                    body = dumps(result)
                    code = 200
                except KeyError as e:
                    body = dumps({"error": f"not found: {e}"})
                    code = 404
                except Exception as e:
                    logger.exception("internal handler %s failed", self.path)
                    body = dumps({"error": str(e)})
                    code = 500
                if link == "drop":
                    # the handler ran; its ack dies on the cut reply
                    # direction — close the connection unanswered
                    self.close_connection = True
                    return
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                exported = _encode_spans(
                    seg.export() if seg is not None else None)
                if exported is not None:
                    self.send_header(TRACE_SPANS_HEADER, exported)
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> str:
        if self._advertise:
            return self._advertise
        return f"{self.host}:{self.port}"

    def route(self, path: str, handler) -> None:
        self.routes[path] = handler

    def dispatch(self, path: str, payload):
        handler = self.routes.get(path)
        if handler is not None:
            return handler(payload)
        # longest-prefix match for "/prefix/" routes
        best = None
        for p in self.routes:
            if p.endswith("/") and path.startswith(p):
                if best is None or len(p) > len(best):
                    best = p
        if best is None:
            raise KeyError(path)
        return self.routes[best](path[len(best):], payload)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name=f"internal-{self.port}")
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread = None


# -- client --------------------------------------------------------------------


class RpcError(RuntimeError):
    #: True when the failure was a per-attempt timeout: the call already
    #: burned its full time ceiling, so the retry policy treats it as
    #: terminal (failover handles it) instead of burning another ceiling
    timed_out = False

    def __init__(self, message: str, status: int = 0):
        super().__init__(message)
        self.status = status


class CircuitOpenError(RpcError):
    """Fail-fast refusal: the peer's breaker is open. Subclasses
    RpcError so every existing per-replica failure handler treats it
    like the dead peer it represents — without paying the dead peer's
    timeout. Carries the breaker's retry hint."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message, status=503)
        self.retry_after_s = retry_after_s


# -- per-peer circuit breakers -------------------------------------------------

#: consecutive transport-level failures before a peer's circuit opens
CB_THRESHOLD = int(os.environ.get("WEAVIATE_TPU_CB_THRESHOLD", "5"))
#: seconds an open circuit refuses calls before allowing ONE half-open
#: probe through
CB_COOLDOWN_S = float(os.environ.get("WEAVIATE_TPU_CB_COOLDOWN_S", "2.0"))

CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"
_STATE_VALUE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitBreaker:
    """closed -> (N consecutive transport failures) -> open ->
    (cooldown) -> half-open: one probe call goes through; success closes
    the circuit, failure re-opens it for another cooldown. Only
    TRANSPORT-level failures count — an HTTP error status proves the
    peer is alive and must reset the streak."""

    def __init__(self, peer: str, threshold: int | None = None,
                 cooldown_s: float | None = None):
        self.peer = peer
        self.threshold = CB_THRESHOLD if threshold is None else threshold
        self.cooldown_s = CB_COOLDOWN_S if cooldown_s is None else cooldown_s
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a call proceed right now? In OPEN past the cooldown,
        exactly one caller wins the half-open probe; everyone else keeps
        failing fast until the probe reports."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN \
                    and time.monotonic() - self._opened_at >= self.cooldown_s:
                self._transition(HALF_OPEN)
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def retry_after_s(self) -> float:
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0,
                       self.cooldown_s - (time.monotonic() - self._opened_at))

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN:
                self._probing = False
                self._transition(OPEN)
            elif self._state == CLOSED and self._failures >= self.threshold:
                self._transition(OPEN)

    def release_probe(self) -> None:
        """Give back a half-open probe slot WITHOUT recording an
        outcome — for exceptions that escape ``rpc`` between ``allow``
        and the record calls (not transport evidence either way). A
        leaked slot would otherwise wedge the peer in fail-fast
        forever."""
        with self._lock:
            self._probing = False

    def notify_alive(self) -> None:
        """Membership proved DIRECT contact with this peer (a gossip
        round-trip on the same host:port the data plane uses): collapse
        whatever cooldown remains so the very next call runs the
        half-open probe. Recovery latency after a partition heals is
        then probe-bound, not cooldown-bound — without this, a breaker
        opened moments before the heal kept fail-fasting a provably
        alive peer for the full CB_COOLDOWN_S."""
        with self._lock:
            if self._state == OPEN:
                self._transition(HALF_OPEN)

    def _transition(self, to: str) -> None:
        """Caller holds ``_lock``."""
        self._state = to
        if to == OPEN:
            self._opened_at = time.monotonic()
        try:
            from weaviate_tpu_torch.runtime.metrics import (circuit_state,
                                                      circuit_transitions_total)

            circuit_state.labels(self.peer).set(_STATE_VALUE[to])
            circuit_transitions_total.labels(self.peer, to).inc()
        except Exception:  # pragma: no cover
            pass


_breaker_lock = threading.Lock()
_breakers: dict[str, CircuitBreaker] = {}


def breaker_for(addr: str) -> CircuitBreaker:
    # lock-free fast path (benign race, same pattern as
    # degrade.is_unhealthy): every data-plane rpc() calls this, and a
    # process-wide mutex just to read an existing dict entry would be
    # avoidable fan-out contention. The lock only guards first-insert.
    br = _breakers.get(addr)
    if br is not None:
        return br
    with _breaker_lock:
        br = _breakers.get(addr)
        if br is None:
            br = _breakers[addr] = CircuitBreaker(addr)
        return br


def on_peer_alive(addr: str) -> None:
    """Gossip's membership-alive signal for ``addr`` (direct contact
    only — relayed third-party views don't prove OUR link works). A
    breaker that never opened is a cheap no-op."""
    br = _breakers.get(addr)
    if br is not None:
        br.notify_alive()


def reset_breakers() -> None:
    """Test hook: forget every peer's breaker state (OS-assigned ports
    get reused across in-process test clusters; a previous cluster's
    open circuit must not poison the next one's fresh node)."""
    with _breaker_lock:
        for addr in list(_breakers):
            try:
                from weaviate_tpu_torch.runtime.metrics import circuit_state

                circuit_state.remove(addr)
            except Exception:  # pragma: no cover
                pass
            del _breakers[addr]


#: control-plane prefixes exempt from the circuit breaker: raft and
#: gossip ARE the cluster's failure detectors — their probes must keep
#: flowing to notice recovery (a raft heartbeat doubles as the
#: half-open probe), and the connection storm against a peer that has
#: not bound its port yet during cluster boot must not open the
#: breaker that then fail-fasts DATA-plane calls to the same address
BREAKER_EXEMPT_PREFIXES = ("/raft/", "/cluster/")

#: default per-attempt timeout when a call site passes none explicitly
#: (graftlint G6 keeps serving-path call sites explicit)
RPC_DEFAULT_TIMEOUT_S = float(os.environ.get("RPC_DEFAULT_TIMEOUT_S", "10"))


def rpc(addr: str, path: str, payload=None, timeout: float | None = None):
    """POST ``payload`` to http://addr/path; raises RpcError on transport
    or handler failure. Inside a trace the call carries a ``traceparent``
    header and absorbs the remote node's exported spans on return.

    Failure policy (the faultline tentpole): the per-attempt ``timeout``
    is capped by the request's remaining deadline budget (an RPC never
    gets more time than its request has left; an exhausted budget raises
    the TYPED ``retry.DeadlineExceeded``); every transport-level failure
    — connection, socket timeout, malformed/incomplete HTTP, corrupt
    payload — maps to ``RpcError`` and feeds ``addr``'s circuit breaker;
    an open breaker fails fast with ``CircuitOpenError`` so a dead peer
    stops eating the deadline budget of every request that fans out to
    it."""
    if timeout is None:
        timeout = RPC_DEFAULT_TIMEOUT_S
    timeout = retry.budget_timeout(timeout, layer="transport.rpc")
    host, _, port = addr.partition(":")
    # serialize BEFORE the breaker check: a caller-side encoding bug
    # must not consume (and then leak) a half-open probe slot
    body = dumps(payload or {})
    headers = {"Content-Type": "application/json"}
    src_node = faultline.current_node()
    if src_node is not None:
        headers[SOURCE_NODE_HEADER] = src_node
    if faultline.topology_armed():
        # this process's registry is consulted below — tell a server in
        # the SAME process (token match) not to evaluate the same rules
        # again; a server in another process with its OWN armed rules
        # still enforces them
        headers[TOPOLOGY_CHECKED_HEADER] = faultline.PROCESS_TOKEN
    breaker = None if path.startswith(BREAKER_EXEMPT_PREFIXES) \
        else breaker_for(addr)
    if breaker is not None and not breaker.allow():
        raise CircuitOpenError(
            f"rpc to {addr}{path} refused: circuit open "
            f"({breaker._failures} consecutive failures)",
            retry_after_s=breaker.retry_after_s())
    recorded = False
    try:
        with tracing.span("rpc.client", addr=addr, path=path) as sp:
            tp = tracing.current_traceparent()
            if tp is not None:
                headers["traceparent"] = tp
            try:
                directive = faultline.fire("transport.rpc.send", addr=addr,
                                           path=path)
                # topology layer: a cut REQUEST direction fails like an
                # unreachable peer (raised here, mapped to RpcError +
                # breaker below); a cut REPLY direction completes the
                # send — the handler runs — and loses the ack via the
                # same drop directive a scheduled reply-loss uses
                link = faultline.check_link(addr, path=path)
                if link == "unreachable":
                    raise faultline.LinkDown(
                        faultline.current_node(), addr, "topology")
                if link == "drop" and directive is None:
                    directive = "drop"
                conn = http.client.HTTPConnection(host, int(port),
                                                  timeout=timeout)
                try:
                    conn.request("POST", path, body=body, headers=headers)
                    resp = conn.getresponse()
                    raw = resp.read()
                    remote_spans = _decode_spans(
                        resp.getheader(TRACE_SPANS_HEADER))
                finally:
                    conn.close()
                if directive == "drop":
                    # the request REACHED the peer (its handler ran); the
                    # reply is lost on the way back — the 2PC "prepare
                    # landed, ack lost" scenario a refused connection
                    # can't produce
                    raise FaultDropped(
                        f"rpc reply from {addr}{path} dropped")
                if directive == "corrupt":
                    raw = b"\x00corrupt\xff" + raw[:8]
            except (ConnectionError, socket.timeout, OSError,
                    http.client.HTTPException, FaultDropped,
                    faultline.FaultInjected) as e:
                # http.client.HTTPException covers the half-dead-peer
                # modes (IncompleteRead, BadStatusLine, ...) that used
                # to escape as raw exceptions instead of RpcError
                if breaker is not None:
                    breaker.record_failure()
                    recorded = True
                err = RpcError(f"rpc to {addr}{path} failed: {e}")
                err.timed_out = isinstance(e, (socket.timeout,
                                               TimeoutError))
                raise err from e
            try:
                result = loads(raw)
            except (ValueError, UnicodeDecodeError) as e:
                # a garbled/truncated body is a wire-level failure too:
                # it feeds the breaker like the half-dead-peer modes
                if breaker is not None:
                    breaker.record_failure()
                    recorded = True
                raise RpcError(f"rpc to {addr}{path} returned a corrupt "
                               f"payload: {e}") from e
            if breaker is not None:
                breaker.record_success()
                recorded = True
            if remote_spans:
                tracing.absorb(remote_spans,
                               base_ms=getattr(sp, "start_ms", 0.0))
            if resp.status != 200:
                raise RpcError(
                    result.get("error", f"status {resp.status}")
                    if isinstance(result, dict) else f"status {resp.status}",
                    status=resp.status)
            return result
    finally:
        # an exception that escaped between allow() and the record calls
        # (a custom faultline error=, a tracing bug) is not transport
        # evidence either way — but the probe slot it may hold must be
        # returned or the peer wedges in fail-fast forever
        if breaker is not None and not recorded:
            breaker.release_probe()


class FaultDropped(Exception):
    """Internal marker for faultline's ``drop`` directive (never escapes
    ``rpc`` — mapped to RpcError like the timeout it simulates)."""
