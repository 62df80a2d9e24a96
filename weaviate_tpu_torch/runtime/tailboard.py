"""Tailboard: the always-on latency-attribution plane (ISSUE 15).

PR 2's tracing answers "where did THIS request spend its time" — but only
for the 1-in-N requests the sampler picked, and the requests an operator
actually needs (the slow ones, the errored ones, the degraded ones) are
exactly the ones most likely to miss the ring. Aggregate histograms
(`weaviate_tpu_query_duration_seconds`) answer "how slow overall" but not
"which phase". This module closes both gaps with four pieces that share
one design rule: NOTHING here may add a device synchronization to an
unsampled request (graftlint G1 stays empty for engine/) and nothing may
cost more than a contextvar read plus a few ``perf_counter`` stamps on
the hot path.

1. **Timeline** — a per-request phase accumulator opened at the REST and
   gRPC edges on EVERY data-path request. Layers that already hold
   monotonic stamps (the query batcher's enqueue/dispatch/transfer
   stamps) fold them in via :func:`phase`; the edge closes the timeline
   and the phases land in
   ``weaviate_tpu_request_phase_seconds{operation,phase,collection,
   tenant}`` with ``phase`` one of ``queue_wait | device | transfer |
   host``. "device" here is the dispatch→drain-start WALL window of the
   batch the request rode in — attribution without ``block_until_ready``
   (real ``device_ms`` stays sampled-only, in tracing). Tenant and
   collection labels pass a top-K guard (:class:`LabelGuard`) so an
   adversarial tenant stream cannot grow the exposition unboundedly.

2. **Tail-based retention** — the keep/drop decision for a finished
   trace moves to request COMPLETION: slow (per-operation threshold),
   errored (5xx), deadline-exceeded, degraded, and fault-injected
   requests are ALWAYS kept in a separate tail ring, regardless of
   ``TRACE_SAMPLE_RATE``, served at ``GET /v1/debug/traces?tail=true``.
   Phase-histogram buckets carry OpenMetrics exemplars naming a retained
   trace id, so a dashboard bucket links to an actual trace.

3. **SLO engine** — declarative per-operation availability + latency
   objectives (``WEAVIATE_TPU_SLO`` JSON, or defaults), sliding-window
   good/bad counters, multi-window burn-rate gauges
   (``weaviate_tpu_slo_burn_rate{slo,window}``), ``GET /v1/debug/slo``.
   A fast-window burn past threshold flips the PR 8 component-health
   registry (``slo:<name>`` component) and snapshots the flight
   recorder to disk.

4. **Flight recorder** — a lock-free ring of recent dispatch records
   (query batcher + native plane: batch size, k bucket, queue depth,
   wait, epoch fanout, transfer-window occupancy) plus the structured
   slow-query log (the PR 2 free-text slow-root log, made retrievable),
   served at ``GET /v1/debug/flight`` and written to
   ``<data_dir>/flightrecorder/`` on incident — so an r05-style
   post-hoc investigation has the dispatch history that produced the
   regression. "Lock-free" is literal: writers claim a slot with
   ``next(itertools.count())`` (one atomic C call under the GIL) and
   write it; a torn read under wrap-around drops one record instead of
   ever blocking a dispatch loop.

Env surface (all lazy-read, re-read after :func:`reset_for_tests`):

- ``WEAVIATE_TPU_TAILBOARD``        1 (default) / 0 — timeline on/off
- ``WEAVIATE_TPU_TAIL_SLOW_MS``     per-op slow threshold: a number, or
  JSON ``{"op-glob": ms, "*": ms}`` (default ``{"*": 250}``)
- ``WEAVIATE_TPU_TAIL_RING``        tail ring size (default 128)
- ``WEAVIATE_TPU_SLO``              JSON list of objectives
- ``WEAVIATE_TPU_SLO_WINDOWS``      csv seconds (default 60,300,3600)
- ``WEAVIATE_TPU_SLO_BURN_THRESHOLD`` incident burn rate (default 14.4,
  the classic fast-burn page threshold) evaluated on the shortest window
- ``WEAVIATE_TPU_FLIGHT_RING``      dispatch-record ring (default 256)
- ``WEAVIATE_TPU_TAILBOARD_MAX_TENANTS`` / ``_MAX_COLLECTIONS``
  top-K label guard (defaults 32 / 64)
"""

from __future__ import annotations

import contextvars
import fnmatch
import itertools
import json
import logging
import os
import threading
import time
from collections import deque

logger = logging.getLogger(__name__)

PHASES = ("queue_wait", "device", "transfer", "host")

#: tail-retention reasons, in decision priority order
TAIL_REASONS = ("deadline", "error", "degraded", "fault", "slow")


def _mono() -> float:
    return time.monotonic()


_faultline_mod = None


def _faultline():
    """Cached faultline module ref — the per-request finalize consults
    ``armed()`` and a repeated ``from ... import`` is measurable there."""
    global _faultline_mod
    if _faultline_mod is None:
        from weaviate_tpu_torch.runtime import faultline

        _faultline_mod = faultline
    return _faultline_mod


# -- env policy (lazy, cached) ------------------------------------------------

_policy_lock = threading.Lock()
_enabled_cached: bool | None = None
_forced: bool | None = None  # force_enabled() override (bench/tests)
_slow_map: dict[str, float] | None = None  # op-glob -> seconds
_data_dir: str | None = None


def _env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "on", "enabled")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def enabled() -> bool:
    """Is the always-on timeline armed? (``WEAVIATE_TPU_TAILBOARD``,
    overridable by :func:`force_enabled` for the overhead bench)."""
    global _enabled_cached
    if _forced is not None:
        return _forced
    if _enabled_cached is None:
        _enabled_cached = _env_flag("WEAVIATE_TPU_TAILBOARD", True)
    return _enabled_cached


def force_enabled(value: bool | None) -> None:
    """Bench/test hook: pin the timeline on/off (None = back to env)."""
    global _forced
    _forced = value


def _slow_thresholds() -> dict[str, float]:
    """op-glob -> seconds; ``"*"`` is the fallback."""
    global _slow_map
    if _slow_map is None:
        raw = os.environ.get("WEAVIATE_TPU_TAIL_SLOW_MS", "").strip()
        out: dict[str, float] = {}
        if raw:
            try:
                parsed = json.loads(raw)
                if isinstance(parsed, dict):
                    out = {str(k): float(v) / 1000.0
                           for k, v in parsed.items()}
                else:
                    out = {"*": float(parsed) / 1000.0}
            except (ValueError, TypeError):
                logger.warning("WEAVIATE_TPU_TAIL_SLOW_MS=%r unparseable; "
                               "using the 250ms default", raw)
        out.setdefault("*", 0.25)
        _slow_map = out
    return _slow_map


_slow_cache: dict[str, float] = {}


def slow_threshold_s(operation: str) -> float:
    """Per-operation tail slow threshold in seconds (0 disables).
    Resolved once per operation (bounded set: route classes + rpc
    names) — this sits on the per-request finalize path."""
    hit = _slow_cache.get(operation)
    if hit is not None:
        return hit
    table = _slow_thresholds()
    if operation in table:
        out = table[operation]
    else:
        out = table["*"]
        for pat, v in table.items():
            if pat != "*" and fnmatch.fnmatchcase(operation, pat):
                out = v
                break
    if len(_slow_cache) < 1024:
        _slow_cache[operation] = out
    return out


def set_data_dir(path: str | None) -> None:
    """Where incident flight-recorder snapshots land
    (``<path>/flightrecorder/``). Wired by Database/Server construction."""
    global _data_dir
    _data_dir = path


def configure(data_dir: str | None = None, enabled: bool | None = None,
              slos_json: str | None = None) -> None:
    """Server-start wiring: one call applies the ServerConfig surface.
    A malformed SLO config logs and falls back to the defaults — same
    lenient contract as the lazy env read; observability config must
    never stop the server from booting."""
    if data_dir is not None:
        set_data_dir(data_dir)
    if enabled is not None:
        # explicit config wins over env in BOTH directions, like every
        # other ServerConfig field (from_env feeds the env value here
        # anyway, so env-driven deployments are unchanged)
        force_enabled(bool(enabled))
    if slos_json:
        try:
            slo_engine().configure_json(slos_json)
        except (ValueError, TypeError, KeyError) as e:
            logger.warning("WEAVIATE_TPU_SLO is unusable (%s); keeping "
                           "the default objectives", e)


# -- label-cardinality guard --------------------------------------------------


class LabelGuard:
    """Top-K distinct values for one label dimension; later arrivals
    collapse to the reserved ``other`` value so one adversarial stream
    of tenant/collection names cannot grow the exposition unboundedly.
    First-come-first-kept is deliberate: a steady production tenant set
    claims its slots at startup and keeps them."""

    __slots__ = ("cap", "_seen", "_lock")

    def __init__(self, cap: int):
        self.cap = max(1, int(cap))
        self._seen: set[str] = set()
        self._lock = threading.Lock()

    def clamp(self, value: str | None) -> str:
        if not value:
            return "-"
        value = str(value)
        if value in self._seen:  # benign race: set lookups are GIL-atomic
            return value
        with self._lock:
            if value in self._seen:
                return value
            if len(self._seen) < self.cap:
                self._seen.add(value)
                return value
        return "other"


_tenant_guard: LabelGuard | None = None
_collection_guard: LabelGuard | None = None

# (operation, phase, collection, tenant) -> histogram child. labels()
# takes the metric lock and rebuilds the key tuple on every call; this
# cache turns the per-request finalize into plain dict hits. Bounded:
# keys only form from guard-clamped values x the closed phase set.
_phase_child_cache: dict[tuple, object] = {}


def _phase_child(operation: str, phase_name: str, collection: str,
                 tenant: str):
    key = (operation, phase_name, collection, tenant)
    child = _phase_child_cache.get(key)
    if child is None:
        from weaviate_tpu_torch.runtime.metrics import request_phase_seconds

        child = request_phase_seconds.labels(*key)
        if len(_phase_child_cache) < 8192:
            _phase_child_cache[key] = child
    return child


def _guards() -> tuple[LabelGuard, LabelGuard]:
    global _tenant_guard, _collection_guard
    if _tenant_guard is None:
        _tenant_guard = LabelGuard(
            _env_int("WEAVIATE_TPU_TAILBOARD_MAX_TENANTS", 32))
        _collection_guard = LabelGuard(
            _env_int("WEAVIATE_TPU_TAILBOARD_MAX_COLLECTIONS", 64))
    return _tenant_guard, _collection_guard


# -- the per-request timeline -------------------------------------------------


class Timeline:
    """Phase accumulator for one request. Mutated from the request
    thread only (the batcher folds its worker-side stamps in AFTER its
    waiter wakes, on the request thread), so no lock."""

    __slots__ = ("operation", "method", "collection", "tenant", "status",
                 "degraded", "fault", "phases", "trace", "_t0")

    def __init__(self, operation: str, method: str = ""):
        self.operation = operation
        self.method = method
        self.collection: str | None = None
        self.tenant: str | None = None
        self.status: int | None = None
        self.degraded = False
        self.fault = False
        self.phases: dict[str, float] = {}
        self.trace: dict | None = None  # attached by on_trace_complete
        self._t0 = time.perf_counter()

    def add_phase(self, name: str, seconds: float) -> None:
        if seconds > 0.0:
            self.phases[name] = self.phases.get(name, 0.0) + seconds


_timeline: contextvars.ContextVar[Timeline | None] = contextvars.ContextVar(
    "weaviate_tpu_timeline", default=None)


class _NullTimelineCM:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_TIMELINE_CM = _NullTimelineCM()


class _TimelineCM:
    __slots__ = ("_tl", "_token")

    def __init__(self, operation: str, method: str):
        self._tl = Timeline(operation, method)

    def __enter__(self):
        self._token = _timeline.set(self._tl)
        return self._tl

    def __exit__(self, exc_type, exc, tb):
        _timeline.reset(self._token)
        try:
            _finish_timeline(self._tl, exc)
        except Exception:  # observability must never fail a request
            logger.exception("tailboard timeline finalize failed")
        return False


def request(operation: str, method: str = ""):
    """Edge entry point: open the always-on timeline for one request.
    Cheap no-op when the tailboard is disabled."""
    if not enabled():
        return _NULL_TIMELINE_CM
    return _TimelineCM(operation, method)


def current() -> Timeline | None:
    return _timeline.get()


def phase(name: str, seconds: float) -> None:
    """Fold an externally-timed phase into the live timeline (no-op
    outside one). Called from layers that already hold the stamps —
    never adds a sync of its own."""
    tl = _timeline.get()
    if tl is not None:
        tl.add_phase(name, seconds)


def annotate(collection: str | None = None, tenant: str | None = None) -> None:
    """Attach collection/tenant identity to the live timeline (no-op
    outside one)."""
    tl = _timeline.get()
    if tl is None:
        return
    if collection:
        tl.collection = str(collection)
    if tenant:
        tl.tenant = str(tenant)


def complete(status: int, degraded: bool = False) -> None:
    """Edge exit point: record the response status before the timeline
    closes (the tail keep/drop decision and the SLO verdict need it)."""
    tl = _timeline.get()
    if tl is not None:
        tl.status = int(status)
        if degraded:
            tl.degraded = True


def note_fault() -> None:
    """Mark the live timeline fault-injected (called by faultline on the
    request thread; worker-thread injections are found by the armed-scan
    in the keep decision instead)."""
    tl = _timeline.get()
    if tl is not None:
        tl.fault = True


# -- tail ring ----------------------------------------------------------------

_tail_lock = threading.Lock()
_tail_ring: deque | None = None


def _tail() -> deque:
    global _tail_ring
    if _tail_ring is None:
        _tail_ring = deque(maxlen=_env_int("WEAVIATE_TPU_TAIL_RING", 128))
    return _tail_ring


def tail_traces(limit: int = 50) -> list[dict]:
    """Newest-first tail-retained entries for
    ``GET /v1/debug/traces?tail=true``."""
    with _tail_lock:
        items = list(_tail())
    return items[::-1][: max(0, limit)]


def clear_tail() -> None:
    """Drop the tail ring (tests; the tracing.clear_traces analog)."""
    with _tail_lock:
        _tail().clear()


def _keep_tail(entry: dict) -> None:
    with _tail_lock:
        _tail().append(entry)
    try:
        from weaviate_tpu_torch.runtime.metrics import tail_retained_total

        tail_retained_total.labels(entry["reason"]).inc()
    except Exception:  # pragma: no cover
        pass


def _trace_has_fault(trace_dict: dict | None) -> bool:
    """Scan a finished trace for faultline annotations. Only called when
    a schedule is armed (chaos runs), never on the clean hot path."""
    if not trace_dict:
        return False
    for sp in trace_dict.get("spans", ()):
        if "fault_point" in (sp.get("attrs") or ()):
            return True
    return False


def _tail_reason(tl: Timeline, duration_s: float,
                 exc: BaseException | None) -> str | None:
    status = tl.status
    # fast path: a clean, fast 2xx/3xx/4xx with nothing flagged — the
    # overwhelming majority of requests — answers with two compares and
    # one cached threshold lookup
    if (exc is None and status is not None and status != 504
            and status < 500 and not tl.degraded and not tl.fault
            and duration_s < slow_threshold_s(tl.operation)
            and not _faultline().armed()):
        return None
    if status == 504:
        return "deadline"
    # a SET status wins over a propagating exception: the gRPC edge
    # calls complete(4xx) and then context.abort(), whose control-flow
    # exception unwinds through the timeline CM — a handled client
    # error must not count as a server error
    if (status >= 500) if status is not None else (exc is not None):
        return "error"
    if tl.degraded:
        return "degraded"
    if tl.fault:
        return "fault"
    threshold = slow_threshold_s(tl.operation)
    if 0 < threshold <= duration_s:
        return "slow"
    try:  # armed-only span scan (worker-thread injections)
        fl = _faultline()
        if fl.armed() and _trace_has_fault(tl.trace):
            return "fault"
    except Exception:  # pragma: no cover
        pass
    return None


# -- deferred fold ------------------------------------------------------------
#
# The request thread must pay for STAMPS, not aggregation: finishing a
# timeline pushes one small record into a lock-free ring and returns.
# Folding those records into the phase histograms and the SLO windows
# happens amortized (every _FOLD_EVERY-th request folds the backlog
# inline, ~30us per 512 requests) and at every read point (metrics
# scrape, /v1/debug/slo, /v1/debug/flight call flush()), so readers
# always see current state. Each record carries its own SLO bucket
# stamp — deferral shifts WHEN the math runs, never which window an
# observation lands in.

_FOLD_EVERY = 512
_PENDING_SIZE = 4096

_fold_lock = threading.Lock()
_pending_buf: list = [None] * _PENDING_SIZE
_pending_seq = itertools.count(1)
_pending_folded = 0  # last folded seq (guarded by _fold_lock)


def _finish_timeline(tl: Timeline, exc: BaseException | None) -> None:
    duration = time.perf_counter() - tl._t0
    reason = _tail_reason(tl, duration, exc)
    trace_id = (tl.trace or {}).get("trace_id")
    if reason is not None:  # rare path: keep the full trace NOW
        attributed = sum(tl.phases.values())
        phases_ms = {p: round(v * 1000.0, 3)
                     for p, v in tl.phases.items()}
        phases_ms["host"] = round(
            max(duration - attributed, 0.0) * 1000.0, 3)
        _keep_tail({
            "reason": reason,
            "operation": tl.operation,
            "method": tl.method,
            "status": tl.status,
            "collection": tl.collection,
            "tenant": tl.tenant,
            "duration_ms": round(duration * 1000.0, 3),
            "phases_ms": phases_ms,
            "kept_at": time.time(),
            "trace": tl.trace,
        })
    # record tuple: (seq, operation, phases, duration_s, errored,
    # collection, tenant, trace_id, bucket) — a tuple, not a dict: this
    # build runs on every request's thread
    # same status-wins rule as _tail_reason (abort control flow is not
    # an availability failure when the edge already mapped a 4xx)
    errored = ((tl.status >= 500) if tl.status is not None
               else (exc is not None))
    seq = next(_pending_seq)
    _pending_buf[seq % _PENDING_SIZE] = (
        seq, tl.operation, tl.phases, duration, errored,
        tl.collection, tl.tenant,
        trace_id if reason is not None else None,
        int(_mono() // _BUCKET_S),
    )
    if seq % _FOLD_EVERY == 0:
        flush()


def flush() -> None:
    """Fold every pending completion record into the phase histograms
    and the SLO windows. Called by read points and the amortized inline
    trigger; idempotent and cheap when there is no backlog. SLO window
    increments batch per (objective, bucket) so a 512-record fold takes
    a handful of lock acquisitions, not thousands.

    Lock-free loss bound: a writer preempted between claiming its seq
    and storing the record can have that ONE record skipped (a fold
    that ran in between advances past its seq) — the same
    drop-one-rather-than-block tradeoff as :class:`FlightRing`, and it
    costs one phase/SLO observation, never a tail-ring entry (those are
    kept synchronously at completion)."""
    global _pending_folded
    with _fold_lock:
        found = [r for r in list(_pending_buf)
                 if r is not None and r[0] > _pending_folded]
        if not found:
            return
        found.sort()
        _pending_folded = found[-1][0]
        eng = slo_engine()
        horizon = eng.horizon_buckets()
        tenant_guard, coll_guard = _guards()
        slo_acc: dict[tuple, list[float]] = {}  # (obj, bucket) -> [g, b]
        for (_seq, operation, phases, duration_s, errored, collection,
             tenant, trace_id, bucket) in found:
            host = duration_s - sum(phases.values())
            collection = coll_guard.clamp(collection)
            tenant = tenant_guard.clamp(tenant)
            # exemplars only for tail-retained traces, so a bucket's
            # exemplar always RESOLVES through /v1/debug/traces?tail=true
            exemplar = {"trace_id": trace_id} if trace_id else None
            try:
                for p, v in phases.items():
                    _phase_child(operation, p, collection,
                                 tenant).observe(v, exemplar=exemplar)
                _phase_child(operation, "host", collection,
                             tenant).observe(max(host, 0.0),
                                             exemplar=exemplar)
            except Exception:  # pragma: no cover — never fail a reader
                pass
            for o in eng.objectives_for(operation):
                verdict = o.verdict(500 if errored else 200,
                                    duration_s, None)
                if verdict is not None:
                    cell = slo_acc.setdefault((o, bucket), [0.0, 0.0])
                    cell[0 if verdict else 1] += 1.0
        for (o, bucket), (good, bad) in slo_acc.items():
            o.record_bulk(bucket, good, bad, horizon)
    eng.maybe_sweep()


def on_trace_complete(trace_dict: dict, root_name: str,
                      duration_ms: float) -> None:
    """tracing._finalize hook, called for EVERY finished root trace.

    Inside a timeline (edge requests): just attach the trace — the
    timeline exit, which also knows the response status, makes the
    keep/drop decision. Outside one (direct ``tracing.trace`` users,
    worker roots): a standalone slow/fault decision so those traces can
    still be tail-kept."""
    tl = _timeline.get()
    if tl is not None:
        tl.trace = trace_dict
        return
    if not enabled():
        return
    reason = None
    duration_s = duration_ms / 1000.0
    threshold = slow_threshold_s(root_name)
    if 0 < threshold <= duration_s:
        reason = "slow"
    else:
        try:
            if _faultline().armed() and _trace_has_fault(trace_dict):
                reason = "fault"
        except Exception:  # pragma: no cover
            pass
    if reason is not None:
        _keep_tail({
            "reason": reason, "operation": root_name, "method": "",
            "status": None, "collection": None, "tenant": None,
            "duration_ms": round(duration_ms, 3),
            "phases_ms": {}, "kept_at": time.time(),
            "trace": trace_dict,
        })


# -- SLO engine ---------------------------------------------------------------

_BUCKET_S = 5.0  # sliding-window granularity

_DEFAULT_SLOS = (
    {"slo": "availability", "operation": "*", "kind": "availability",
     "objective": 0.999},
    {"slo": "latency", "operation": "*", "kind": "latency",
     "objective": 0.99, "threshold_ms": 500.0},
)


class _Objective:
    __slots__ = ("name", "operation", "kind", "objective", "threshold_s",
                 "counts", "lock")

    def __init__(self, spec: dict):
        self.name = str(spec["slo"])
        self.operation = str(spec.get("operation", "*"))
        self.kind = str(spec.get("kind", "availability"))
        if self.kind not in ("availability", "latency"):
            raise ValueError(f"SLO {self.name!r}: unknown kind "
                             f"{self.kind!r}")
        self.objective = float(spec.get("objective", 0.999))
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"SLO {self.name!r}: objective must be in "
                             f"(0, 1), got {self.objective}")
        self.threshold_s = float(spec.get("threshold_ms", 500.0)) / 1000.0
        # bucket index -> [good, bad]; pruned past the longest window
        self.counts: dict[int, list[float]] = {}
        self.lock = threading.Lock()

    def matches(self, operation: str) -> bool:
        return fnmatch.fnmatchcase(operation, self.operation)

    def verdict(self, status: int | None, duration_s: float,
                exc: BaseException | None) -> bool | None:
        """True = good, False = bad, None = excluded from this SLO."""
        errored = exc is not None or (status is not None and status >= 500)
        if self.kind == "availability":
            return not errored
        if errored:  # latency SLOs judge only requests that succeeded
            return None
        return duration_s <= self.threshold_s

    def record(self, bucket: int, good: bool, horizon: int) -> None:
        self.record_bulk(bucket, 1.0 if good else 0.0,
                         0.0 if good else 1.0, horizon)

    def record_bulk(self, bucket: int, good: float, bad: float,
                    horizon: int) -> None:
        with self.lock:
            cell = self.counts.get(bucket)
            if cell is None:
                cell = self.counts[bucket] = [0.0, 0.0]
                # prune on new-bucket creation: O(1) amortized
                dead = [b for b in self.counts if b < bucket - horizon]
                for b in dead:
                    del self.counts[b]
            cell[0] += good
            cell[1] += bad

    def window_counts(self, now_bucket: int, window_s: float) -> tuple:
        lo = now_bucket - int(window_s // _BUCKET_S)
        good = bad = 0.0
        with self.lock:
            for b, (g, x) in self.counts.items():
                if lo < b <= now_bucket:
                    good += g
                    bad += x
        return good, bad

    def burn_rate(self, now_bucket: int, window_s: float) -> float:
        """bad-fraction over the window divided by the error budget
        (1 - objective): 1.0 = burning exactly the budget, >>1 = paging
        territory. 0 when the window saw no traffic."""
        good, bad = self.window_counts(now_bucket, window_s)
        total = good + bad
        if total <= 0:
            return 0.0
        return (bad / total) / (1.0 - self.objective)


class SloEngine:
    """All objectives + the incident loop. One process-wide instance."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objectives: list[_Objective] | None = None
        self._windows: tuple[float, ...] | None = None
        self._match_cache: dict[str, tuple[_Objective, ...]] = {}
        self._last_check = 0.0
        self._burning: set[str] = set()

    # -- configuration --------------------------------------------------------

    def _load(self) -> list[_Objective]:
        with self._lock:
            if self._objectives is None:
                raw = os.environ.get("WEAVIATE_TPU_SLO", "").strip()
                specs = _DEFAULT_SLOS
                if raw:
                    try:
                        parsed = json.loads(raw)
                        if isinstance(parsed, list) and parsed:
                            specs = parsed
                        else:
                            logger.warning("WEAVIATE_TPU_SLO must be a "
                                           "non-empty JSON list; using "
                                           "defaults")
                    except ValueError:
                        logger.warning("WEAVIATE_TPU_SLO is not valid "
                                       "JSON; using defaults")
                self._objectives = [_Objective(dict(s)) for s in specs]
                self._match_cache.clear()
            return self._objectives

    def configure_json(self, raw: str) -> None:
        """Explicit (re)configuration — ServerConfig wiring and tests."""
        specs = json.loads(raw)
        with self._lock:
            self._objectives = [_Objective(dict(s)) for s in specs]
            self._match_cache.clear()
            self._burning.clear()

    def windows(self) -> tuple[float, ...]:
        with self._lock:
            if self._windows is None:
                raw = os.environ.get("WEAVIATE_TPU_SLO_WINDOWS",
                                     "60,300,3600")
                try:
                    ws = tuple(sorted(float(w) for w in raw.split(",")
                                      if w.strip()))
                except ValueError:
                    ws = (60.0, 300.0, 3600.0)
                self._windows = ws or (60.0, 300.0, 3600.0)
            return self._windows

    def burn_threshold(self) -> float:
        return _env_float("WEAVIATE_TPU_SLO_BURN_THRESHOLD", 14.4)

    def horizon_buckets(self) -> int:
        return int(max(self.windows()) // _BUCKET_S) + 1

    def objectives_for(self, operation: str) -> tuple[_Objective, ...]:
        hit = self._match_cache.get(operation)
        if hit is None:
            objs = self._load()
            hit = tuple(o for o in objs if o.matches(operation))
            # the op set is bounded (route classes + rpc names), so the
            # cache is too
            if len(self._match_cache) < 256:
                self._match_cache[operation] = hit
        return hit

    def maybe_sweep(self) -> None:
        """Rate-limited incident sweep — at most once a second, however
        often the fold runs."""
        now = _mono()
        with self._lock:
            due = now - self._last_check >= 1.0
            if due:
                self._last_check = now
        if due:
            try:
                self.check_incidents(now=now)
            except Exception:  # pragma: no cover
                logger.exception("SLO incident sweep failed")

    # -- evaluation -----------------------------------------------------------

    def check_incidents(self, now: float | None = None) -> None:
        """Fast-window burn over threshold => flip the component-health
        registry (``slo:<name>``) and snapshot the flight recorder;
        recovery flips it back."""
        from weaviate_tpu_torch.runtime import degrade

        now = _mono() if now is None else now
        bucket = int(now // _BUCKET_S)
        fast = self.windows()[0]
        threshold = self.burn_threshold()
        for o in self._load():
            burn = o.burn_rate(bucket, fast)
            component = f"slo:{o.name}"
            if burn >= threshold:
                if o.name not in self._burning:
                    self._burning.add(o.name)
                    reason = (f"burn rate {burn:.1f}x over the "
                              f"{int(fast)}s window (threshold "
                              f"{threshold:.1f}x, objective "
                              f"{o.objective})")
                    degrade.mark_unhealthy(component, reason)
                    snapshot_to_disk(f"slo:{o.name}")
            elif o.name in self._burning:
                self._burning.discard(o.name)
                degrade.mark_healthy(component)

    def refresh(self, now: float | None = None) -> None:
        """Republish the burn-rate gauges + run the incident sweep —
        called at scrape time and from /v1/debug/slo, like
        perfgate.refresh."""
        now = _mono() if now is None else now
        bucket = int(now // _BUCKET_S)
        try:
            from weaviate_tpu_torch.runtime.metrics import slo_burn_rate

            for o in self._load():
                for w in self.windows():
                    slo_burn_rate.labels(o.name, f"{int(w)}s").set(
                        o.burn_rate(bucket, w))
        except Exception:  # pragma: no cover
            pass
        self.check_incidents(now=now)

    def snapshot(self, now: float | None = None) -> dict:
        """The /v1/debug/slo payload."""
        now = _mono() if now is None else now
        bucket = int(now // _BUCKET_S)
        out = []
        for o in self._load():
            windows = {}
            for w in self.windows():
                good, bad = o.window_counts(bucket, w)
                windows[f"{int(w)}s"] = {
                    "good": good, "bad": bad,
                    "burnRate": round(o.burn_rate(bucket, w), 4),
                }
            spec = {
                "slo": o.name, "operation": o.operation, "kind": o.kind,
                "objective": o.objective, "windows": windows,
                "burning": o.name in self._burning,
            }
            if o.kind == "latency":
                spec["thresholdMs"] = round(o.threshold_s * 1000.0, 3)
            out.append(spec)
        return {"slos": out,
                "burnThreshold": self.burn_threshold(),
                "fastWindowSeconds": self.windows()[0]}


_slo_engine: SloEngine | None = None
_slo_lock = threading.Lock()


def slo_engine() -> SloEngine:
    global _slo_engine
    if _slo_engine is None:
        with _slo_lock:
            if _slo_engine is None:
                _slo_engine = SloEngine()
    return _slo_engine


# -- flight recorder ----------------------------------------------------------


class FlightRing:
    """Fixed-size lock-free ring. Writers claim a slot via
    ``next(itertools.count())`` (atomic under the GIL) and store; readers
    copy the buffer. Under wrap-around a reader can see a record from
    either generation for a given slot — acceptable for a flight
    recorder, and the price of never blocking a dispatch loop."""

    __slots__ = ("_size", "_buf", "_seq")

    def __init__(self, size: int):
        self._size = max(8, int(size))
        self._buf: list[dict | None] = [None] * self._size
        self._seq = itertools.count()

    def append(self, record: dict) -> None:
        i = next(self._seq)
        record["seq"] = i
        self._buf[i % self._size] = record

    def snapshot(self) -> list[dict]:
        """Oldest-first records (sorted by claim sequence)."""
        items = [r for r in list(self._buf) if r is not None]
        items.sort(key=lambda r: r.get("seq", 0))
        return items


_flight_ring: FlightRing | None = None
_slowlog_ring: FlightRing | None = None


def _flight() -> FlightRing:
    global _flight_ring
    if _flight_ring is None:
        _flight_ring = FlightRing(_env_int("WEAVIATE_TPU_FLIGHT_RING", 256))
    return _flight_ring


def _slowlog() -> FlightRing:
    global _slowlog_ring
    if _slowlog_ring is None:
        _slowlog_ring = FlightRing(64)
    return _slowlog_ring


def record_dispatch(plane: str, **fields) -> dict:
    """One dispatch record from the query batcher or the native plane.
    Lock-free, allocation-light — safe on the dispatch hot loop. Returns
    the live record so a caller may patch in late-arriving fields (the
    batcher learns its epoch fanout only after the async launch)."""
    rec = {"plane": plane, "t": time.time()}
    rec.update(fields)
    _flight().append(rec)
    return rec


def slow_root(record: dict) -> None:
    """Structured slow-query entry (tracing's slow-root path lands here
    instead of free-text-only logging)."""
    _slowlog().append(dict(record))


def debug_flight() -> dict:
    """The /v1/debug/flight payload."""
    flush()
    return {
        "dispatches": _flight().snapshot(),
        "slowlog": _slowlog().snapshot(),
        "snapshots": _snapshot_files(),
    }


# -- incident snapshots -------------------------------------------------------

_SNAPSHOT_KEEP = 8
_snapshot_lock = threading.Lock()
_last_snapshot: float | None = None


def _snapshot_dir() -> str | None:
    return os.path.join(_data_dir, "flightrecorder") if _data_dir else None


def _snapshot_files() -> list[str]:
    d = _snapshot_dir()
    if not d or not os.path.isdir(d):
        return []
    try:
        return sorted(f for f in os.listdir(d) if f.endswith(".json"))
    except OSError:
        return []


def snapshot_cooldown_s() -> float:
    return _env_float("WEAVIATE_TPU_FLIGHT_SNAPSHOT_COOLDOWN_S", 30.0)


def snapshot_to_disk(reason: str, force: bool = False) -> str | None:
    """Persist the flight recorder + SLO state on incident (SLO burn,
    component-health flip). Cooldown-limited so a flapping incident
    cannot spam the data dir; keeps the newest ``_SNAPSHOT_KEEP`` files.
    Returns the written path, or None (no data dir / cooldown)."""
    global _last_snapshot
    d = _snapshot_dir()
    if d is None:
        return None
    now = _mono()
    with _snapshot_lock:
        if (not force and _last_snapshot is not None
                and now - _last_snapshot < snapshot_cooldown_s()):
            return None
        _last_snapshot = now
    try:
        from weaviate_tpu_torch.runtime import degrade

        payload = {
            "written_at": time.time(),
            "reason": reason,
            "dispatches": _flight().snapshot(),
            "slowlog": _slowlog().snapshot(),
            "slo": slo_engine().snapshot(),
            "componentHealth": degrade.health(),
            "tail": tail_traces(16),
        }
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"flight-{int(time.time() * 1000)}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        files = _snapshot_files()
        for stale in files[:-_SNAPSHOT_KEEP]:
            try:
                os.unlink(os.path.join(d, stale))
            except OSError:
                pass
        try:
            from weaviate_tpu_torch.runtime.metrics import flight_snapshots_total

            flight_snapshots_total.labels(reason).inc()
        except Exception:  # pragma: no cover
            pass
        logger.warning("flight-recorder snapshot written: %s (%s)",
                       path, reason)
        return path
    except Exception:  # incident capture must never crash serving
        logger.exception("flight-recorder snapshot failed")
        return None


def on_component_unhealthy(component: str, reason: str) -> None:
    """degrade.mark_unhealthy hook: a component flipping unhealthy is an
    incident — capture the dispatch history that led to it. SLO flips
    come through here too (mark_unhealthy call order), deduped by the
    snapshot cooldown."""
    if component.startswith("slo:"):
        return  # check_incidents already snapshotted with the burn reason
    snapshot_to_disk(f"component:{component}")


# -- debug payloads -----------------------------------------------------------


def debug_slo() -> dict:
    flush()
    eng = slo_engine()
    eng.refresh()
    return eng.snapshot()


def scrape_refresh() -> None:
    """Read-point hook for the /v1/metrics scrape paths: fold the
    pending completion records, then republish the burn gauges (and run
    the incident sweep)."""
    flush()
    slo_engine().refresh()


# -- test isolation -----------------------------------------------------------


def reset_for_tests() -> None:
    """Drop every cached policy/registry so the next use re-reads env —
    the conftest autouse fixture calls this between tests."""
    global _enabled_cached, _forced, _slow_map, _data_dir
    global _tail_ring, _flight_ring, _slowlog_ring, _slo_engine
    global _tenant_guard, _collection_guard, _last_snapshot
    global _pending_seq, _pending_folded
    _enabled_cached = None
    _forced = None
    _slow_map = None
    _slow_cache.clear()
    _data_dir = None
    _tail_ring = None
    _flight_ring = None
    _slowlog_ring = None
    _slo_engine = None
    _tenant_guard = None
    _collection_guard = None
    _phase_child_cache.clear()
    with _fold_lock:
        for i in range(len(_pending_buf)):
            _pending_buf[i] = None
        _pending_seq = itertools.count(1)
        _pending_folded = 0
    with _snapshot_lock:
        _last_snapshot = None
