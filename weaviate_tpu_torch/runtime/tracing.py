"""Request-scoped tracing with device-time attribution (port of the part
of ``weaviate_tpu/runtime/tracing.py`` the flat query path calls).

- ``trace(name)`` opens a request root; ``span(name, **attrs)`` nests
  under whatever is current via a contextvar. Outside a trace ``span`` is
  a no-op yielding a shared null span.
- Host-clock spans are always recorded inside a trace. Device timing is
  the expensive part: ``device_sync`` and ``d2h`` wait for the card only
  when the trace is *sampled* (1-in-N from TRACE_SAMPLE_RATE, or forced
  per request). The wait is a CUDA event recorded on the current stream
  and synchronized — the torch form of ``jax.block_until_ready``.
- ``d2h`` is the one sanctioned device->host copy (``.cpu()``), under a
  ``transfer.d2h`` span.
- ``propagate`` / ``capture`` / ``run_in`` carry the request context onto
  worker threads (contextvars do not flow into them).
- Finished traces land in a ring (``recent_traces``, GET
  /v1/debug/traces), feed the tailboard's keep-at-completion decision and
  the structured slow-query log. The W3C traceparent helpers and remote
  segments of the JAX module ride the cluster transport (ROADMAP Queue 1
  item 7).

Every finished span also feeds the ``weaviate_tpu_span_duration_seconds``
histogram (runtime/metrics.py).
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import random
import threading
import time
from collections import deque

slow_logger = logging.getLogger("weaviate_tpu_torch.slow_query")

# active (trace, span) for this context; None outside a request
_current: contextvars.ContextVar = contextvars.ContextVar(
    "weaviate_tpu_torch_trace", default=None)

# ids need uniqueness, not cryptography: a PRNG seeded once from urandom
_rng = random.Random(int.from_bytes(os.urandom(16), "big"))


def _new_id(nbytes: int) -> str:
    return format(_rng.getrandbits(nbytes * 8), f"0{nbytes * 2}x")


class Span:
    """One timed operation, serialized into its trace when it finishes."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attrs",
                 "start_ms", "duration_ms", "_t0")

    def __init__(self, trace_id: str, parent_id: str | None, name: str,
                 attrs: dict, start_ms: float):
        self.trace_id = trace_id
        self.span_id = _new_id(8)
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs
        self.start_ms = start_ms
        self.duration_ms = 0.0
        self._t0 = time.perf_counter()

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ms": round(self.start_ms, 3),
            "duration_ms": round(self.duration_ms, 3),
            "attrs": {k: _jsonable(v) for k, v in self.attrs.items()},
        }


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class _NullSpan:
    """Shared no-op span yielded outside any trace."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class Trace:
    """Collects finished spans for one request. Appends are thread safe."""

    MAX_SPANS = 512  # bound memory when an instrumented loop runs hot

    __slots__ = ("trace_id", "sampled", "spans", "dropped", "started_at",
                 "_t0", "_lock")

    def __init__(self, trace_id: str, sampled: bool):
        self.trace_id = trace_id
        self.sampled = sampled
        self.spans: list[dict] = []
        self.dropped = 0
        self.started_at = time.time()
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    def now_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0

    def add(self, span_dict: dict) -> None:
        with self._lock:
            if len(self.spans) >= self.MAX_SPANS:
                self.dropped += 1
                return
            self.spans.append(span_dict)

    def to_dict(self) -> dict:
        with self._lock:
            spans = sorted(self.spans, key=lambda s: s["start_ms"])
            dropped = self.dropped
        out = {"trace_id": self.trace_id, "sampled": self.sampled,
               "started_at": self.started_at, "spans": spans}
        if dropped:
            out["dropped_spans"] = dropped
        return out


# -- sampling policy ----------------------------------------------------------

_sample_lock = threading.Lock()
_sample_counter = 0
_sample_every: int | None = None  # None = not yet read from the env


def _compute_sample_every() -> int:
    """0 = never, 1 = always, N = every Nth request."""
    try:
        rate = float(os.environ.get("TRACE_SAMPLE_RATE", "0").strip())
    except ValueError:
        return 0
    if rate <= 0.0:
        return 0
    if rate >= 1.0:
        return 1
    return max(1, round(1.0 / rate))


def should_sample() -> bool:
    """Per-process deterministic 1-in-N sampler."""
    global _sample_counter, _sample_every
    if _sample_every is None:
        _sample_every = _compute_sample_every()
    if _sample_every == 0:
        return False
    with _sample_lock:
        _sample_counter += 1
        return _sample_counter % _sample_every == 0


_slow_threshold: float | None = None  # seconds; 0 = disabled; None = unread


def _compute_slow_threshold() -> float:
    from weaviate_tpu_torch.config import _flag

    if not _flag(os.environ, "QUERY_SLOW_LOG_ENABLED"):
        return 0.0
    raw = os.environ.get("QUERY_SLOW_LOG_THRESHOLD", "2s").strip()
    try:
        if raw.endswith("ms"):
            return float(raw[:-2]) / 1000.0
        if raw.endswith("s"):
            return float(raw[:-1])
        return float(raw)
    except ValueError:
        return 2.0


def get_slow_threshold() -> float:
    """QUERY_SLOW_LOG_ENABLED / QUERY_SLOW_LOG_THRESHOLD, read once
    (seconds; 0 = disabled)."""
    global _slow_threshold
    if _slow_threshold is None:
        _slow_threshold = _compute_slow_threshold()
    return _slow_threshold


def reset_policy_for_tests() -> None:
    """Re-read TRACE_SAMPLE_RATE / slow-log env on next use."""
    global _sample_every, _slow_threshold, _sample_counter
    _sample_every = None
    _slow_threshold = None
    _sample_counter = 0


# -- finished-trace ring buffer -----------------------------------------------

_RING_SIZE = 256
_ring: deque = deque(maxlen=_RING_SIZE)
_ring_lock = threading.Lock()


def recent_traces(limit: int = 50) -> list[dict]:
    """Newest-first finished traces for GET /v1/debug/traces."""
    with _ring_lock:
        items = list(_ring)
    return items[::-1][: max(0, limit)]


def clear_traces() -> None:
    with _ring_lock:
        _ring.clear()


# -- span plumbing ------------------------------------------------------------

def _observe_metric(name: str, duration_s: float) -> None:
    try:
        from weaviate_tpu_torch.runtime.metrics import span_duration

        span_duration.labels(name).observe(duration_s)
    except Exception:  # metrics must never fail a request
        pass


def _finish(tr: Trace, sp: Span) -> None:
    sp.duration_ms = (time.perf_counter() - sp._t0) * 1000.0
    tr.add(sp.to_dict())
    _observe_metric(sp.name, sp.duration_ms / 1000.0)


@contextlib.contextmanager
def trace(name: str, force: bool = False, **attrs):
    """Open a request root trace. Nested calls degrade to plain spans."""
    if _current.get() is not None:
        with span(name, **attrs) as sp:
            yield sp
        return
    tr = Trace(_new_id(16), sampled=force or should_sample())
    root = Span(tr.trace_id, None, name, dict(attrs), 0.0)
    token = _current.set((tr, root))
    try:
        yield root
    finally:
        _finish(tr, root)
        _current.reset(token)
        _finalize(tr, root)


def _finalize(tr: Trace, root: Span) -> None:
    d = tr.to_dict()
    with _ring_lock:
        _ring.append(d)
    # tail-based retention: the keep/drop decision happens at COMPLETION
    # — inside an edge timeline the tailboard attaches this trace and
    # decides when the timeline closes (status known); outside one it
    # makes a standalone slow/fault decision
    try:
        from weaviate_tpu_torch.runtime import tailboard

        tailboard.on_trace_complete(d, root.name, root.duration_ms)
    except Exception:  # observability must never fail the request
        pass
    threshold = get_slow_threshold()
    took = root.duration_ms / 1000.0
    if threshold > 0 and took >= threshold:
        # structured slowlog: one machine-parseable line AND an entry in
        # the flight recorder's slowlog ring (/v1/debug/flight)
        record = {
            "trace_id": tr.trace_id,
            "root": root.name,
            "duration_ms": round(root.duration_ms, 3),
            "threshold_ms": round(threshold * 1000.0, 3),
            "spans": [
                {"name": s["name"],
                 "duration_ms": round(s["duration_ms"], 3)}
                for s in sorted(tr.spans,
                                key=lambda s: -s["duration_ms"])[:8]],
        }
        import json as _json

        slow_logger.warning("slow_query %s", _json.dumps(record))
        try:
            from weaviate_tpu_torch.runtime import tailboard

            tailboard.slow_root(record)
        except Exception:
            pass


class _SpanCM:
    """Class-based context manager: cheaper than @contextmanager on the
    no-op path, and span() sits on query hot paths."""

    __slots__ = ("name", "attrs", "_pair", "_token")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        cur = _current.get()
        if cur is None:
            self._pair = None
            return NULL_SPAN
        tr, parent = cur
        sp = Span(tr.trace_id, parent.span_id, self.name, self.attrs,
                  tr.now_ms())
        self._pair = (tr, sp)
        self._token = _current.set((tr, sp))
        return sp

    def __exit__(self, *exc):
        if self._pair is None:
            return False
        tr, sp = self._pair
        _finish(tr, sp)
        _current.reset(self._token)
        return False


def span(name: str, **attrs) -> _SpanCM:
    """Nested span under the current trace; no-op outside one."""
    return _SpanCM(name, attrs)


def record_span(name: str, start_s: float, end_s: float, **attrs) -> None:
    """Record an externally-timed span (perf_counter stamps) under the
    current span — how the query batcher's worker-side timings land in
    each waiter's trace."""
    cur = _current.get()
    if cur is None:
        return
    tr, parent = cur
    tr.add({
        "name": name,
        "span_id": _new_id(8),
        "parent_id": parent.span_id,
        "start_ms": round((start_s - tr._t0) * 1000.0, 3),
        "duration_ms": round((end_s - start_s) * 1000.0, 3),
        "attrs": {k: _jsonable(v) for k, v in attrs.items()},
    })
    _observe_metric(name, max(0.0, end_s - start_s))


def is_active() -> bool:
    return _current.get() is not None


def is_sampled() -> bool:
    cur = _current.get()
    return cur is not None and cur[0].sampled


def current_timing() -> list[dict]:
    """Spans recorded so far in the live trace (for per-query
    ``_debug.timing`` response breakdowns; the root is still open)."""
    cur = _current.get()
    if cur is None:
        return []
    tr, _ = cur
    with tr._lock:
        return sorted(list(tr.spans), key=lambda s: s["start_ms"])


def current_trace_id() -> str | None:
    cur = _current.get()
    return None if cur is None else cur[0].trace_id


# -- device-time attribution --------------------------------------------------

def _wait_device(values) -> bool:
    """Block until the work producing ``values`` (tensors) is done: a
    CUDA event on the current stream, synchronized. False when none of
    them lives on a card."""
    import torch

    devs = {v.device for v in values
            if isinstance(v, torch.Tensor) and v.device.type == "cuda"}
    for dev in devs:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
    return bool(devs)


def device_sync(sp, *values) -> None:
    """Attribute device time to ``sp`` by waiting for ``values`` — ONLY
    on sampled traces, so unsampled requests add no synchronization."""
    cur = _current.get()
    if cur is None or not cur[0].sampled:
        return
    t0 = time.perf_counter()
    if _wait_device([v for v in values if v is not None]):
        sp.set(device_ms=round((time.perf_counter() - t0) * 1000.0, 3))


# -- device->host boundary ----------------------------------------------------

def d2h(*values):
    """THE sanctioned device->host transfer at the API boundary.

    Fetches ``values`` (tensors; ``None`` entries pass through) to numpy
    under a ``transfer.d2h`` span. On sampled traces the device wait is
    timed first (``device_ms``), so the span splits card time from copy
    time; other callers pay only the copy."""
    n_arrays = sum(1 for v in values if v is not None)
    with span("transfer.d2h", arrays=n_arrays) as sp:
        cur = _current.get()
        if cur is not None and cur[0].sampled and n_arrays:
            t0 = time.perf_counter()
            if _wait_device([v for v in values if v is not None]):
                sp.set(device_ms=round((time.perf_counter() - t0) * 1000.0, 3))
        return tuple(None if v is None else v.cpu().numpy() for v in values)


# -- cross-thread propagation -------------------------------------------------

def capture():
    """Opaque context handle for run_in (None outside a trace)."""
    return _current.get()


def run_in(ctx, fn, *args, **kwargs):
    """Run ``fn`` under a captured (trace, span) context."""
    if ctx is None:
        return fn(*args, **kwargs)
    token = _current.set(ctx)
    try:
        return fn(*args, **kwargs)
    finally:
        _current.reset(token)


def annotate(**attrs) -> None:
    """Attach attrs to the CURRENT span (no-op outside a trace)."""
    cur = _current.get()
    if cur is not None:
        cur[1].set(**attrs)


def propagate(fn):
    """Wrap ``fn`` to carry the CURRENT request context into worker
    threads: trace span, deadline budget, the degraded-marker sink and the
    faultline node identity."""
    from weaviate_tpu_torch.runtime import degrade, faultline, retry

    ctx = _current.get()
    dl = retry.current_deadline()
    markers = degrade.current_markers()
    node = faultline.current_node()
    if ctx is None and dl is None and markers is None and node is None:
        return fn

    def wrapper(*args, **kwargs):
        tokens = (retry.set_deadline(dl), degrade.set_markers(markers))
        try:
            with faultline.node_scope(node):
                return run_in(ctx, fn, *args, **kwargs)
        finally:
            retry.reset_deadline(tokens[0])
            degrade.reset_markers(tokens[1])

    return wrapper
