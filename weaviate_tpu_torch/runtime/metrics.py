"""Prometheus-style metrics registry with text exposition.

Reference: usecases/monitoring/prometheus.go:28 (~70 metric vecs: LSM,
vector index, backup, queries) served on PROMETHEUS_MONITORING_PORT.
Hand-rolled (no prometheus_client in the image): Counter/Gauge/Histogram
with label vectors and the /metrics text format.
"""

from __future__ import annotations

import os
import threading
import time
from bisect import bisect_left

# -- registry-level label-cardinality guard -----------------------------------
#
# An adversarial (or just unbounded) tenant/collection stream must not be
# able to grow the exposition without bound: past the per-metric series
# cap, NEW label tuples collapse into one reserved all-``other`` series
# and the redirect is counted in
# ``weaviate_tpu_metric_series_dropped_total{metric}``. Existing series
# keep updating — the cap bounds growth, it never forgets live series.

_SERIES_CAP: int | None = None  # lazy env read (None = unread)


def _series_cap() -> int:
    global _SERIES_CAP
    if _SERIES_CAP is None:
        try:
            _SERIES_CAP = int(os.environ.get(
                "WEAVIATE_TPU_METRIC_MAX_SERIES", "2000"))
        except ValueError:
            _SERIES_CAP = 2000
    return _SERIES_CAP


def reset_series_cap_for_tests() -> None:
    """Re-read WEAVIATE_TPU_METRIC_MAX_SERIES on next use."""
    global _SERIES_CAP
    _SERIES_CAP = None


def _count_series_dropped(metric_name: str) -> None:
    try:
        metric_series_dropped.labels(metric_name).inc()
    except Exception:  # registration order — must never fail callers
        pass


def escape_label_value(v) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote and newline must be escaped or a value like ``a"b`` corrupts
    the whole scrape (text format spec, "Escaping")."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(s: str) -> str:
    """HELP lines escape backslash and newline (not quotes)."""
    return str(s).replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str = "", label_names: tuple = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}
        # reserved overflow series for the cardinality guard (the guard
        # itself is exempt — its one label is metric names, bounded)
        self._overflow = tuple("other" for _ in self.label_names)
        self._guarded = bool(self.label_names) and \
            name != "weaviate_tpu_metric_series_dropped_total"
        # per-metric cap override (None = the registry-wide env cap):
        # a metric whose label budget is deliberately larger than the
        # generic default (the tailboard phase histogram) sets this
        self.max_series: int | None = None

    def labels(self, *values, **kw):
        if kw:
            values = tuple(kw.get(n, "") for n in self.label_names)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected labels {self.label_names}")
        dropped = False
        with self._lock:
            child = self._children.get(values)
            if child is None:
                cap = (self.max_series if self.max_series is not None
                       else _series_cap())
                if (self._guarded and values != self._overflow
                        and len(self._children) >= cap):
                    # cardinality guard: redirect the NEW tuple into the
                    # reserved all-"other" series instead of growing
                    dropped = True
                    values = self._overflow
                    child = self._children.get(values)
                if child is None:
                    child = self._new_child()
                    self._children[values] = child
        if dropped:
            _count_series_dropped(self.name)
        return child

    def _default(self):
        if self.label_names:
            raise ValueError(f"{self.name} has labels; use .labels(...)")
        return self.labels()

    def remove(self, *values) -> None:
        """Drop one label child (a deleted collection/shard must not keep
        exporting a stale 0-valued series forever)."""
        values = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(values, None)

    def _label_str(self, values: tuple) -> str:
        if not values:
            return ""
        pairs = ",".join(f'{n}="{escape_label_value(v)}"'
                         for n, v in zip(self.label_names, values))
        return "{" + pairs + "}"


class _CounterChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0):
        with self._lock:
            self.value += amount


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    def expose(self, openmetrics: bool = False) -> list[str]:
        # OpenMetrics names the FAMILY without the reserved _total
        # suffix while samples keep it — a strict OM parser (real
        # Prometheus negotiating openmetrics-text) rejects a family
        # ending in _total; 0.0.4 text keeps the historical full name
        family = self.name
        if openmetrics and family.endswith("_total"):
            family = family[: -len("_total")]
        out = [f"# HELP {family} {_escape_help(self.help)}",
               f"# TYPE {family} counter"]
        with self._lock:  # labels() inserts race the scrape iteration
            children = sorted(self._children.items())
        for lv, child in children:
            out.append(f"{self.name}{self._label_str(lv)} {child.value}")
        return out


class _GaugeChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self.value = v

    def inc(self, amount: float = 1.0):
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float):
        self._default().set(v)

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    def dec(self, amount: float = 1.0):
        self._default().dec(amount)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} gauge"]
        with self._lock:
            children = sorted(self._children.items())
        for lv, child in children:
            out.append(f"{self.name}{self._label_str(lv)} {child.value}")
        return out


DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


class _HistogramChild:
    """Observations land in ONE slot (their lowest bucket, found by
    bisect) and cumulate lazily at expose time — O(log buckets) on the
    hot path instead of a linear walk under the lock. The always-on
    request-phase histograms (tailboard) observe on every served
    request, so this is serving-path code, not just scrape plumbing."""

    __slots__ = ("buckets", "slot_counts", "total", "count", "exemplars",
                 "_lock")

    def __init__(self, buckets):
        self.buckets = buckets
        # slot_counts[i]: observations whose LOWEST bucket is i;
        # index len(buckets) = fell past every bound (+Inf only)
        self.slot_counts = [0] * (len(buckets) + 1)
        self.total = 0.0
        self.count = 0
        # per-bucket last exemplar (index len(buckets) = +Inf), lazily
        # allocated — most histograms never carry one
        self.exemplars: list | None = None
        self._lock = threading.Lock()

    def observe(self, v: float, exemplar: dict | None = None):
        """``exemplar``: OpenMetrics exemplar labels (e.g.
        ``{"trace_id": ...}``) attached to the lowest bucket ``v`` falls
        in (and +Inf) — how a phase-histogram bucket links to a
        tail-retained trace."""
        # v <= buckets[idx] for the first idx with buckets[idx] >= v
        idx = bisect_left(self.buckets, v)
        with self._lock:
            self.total += v
            self.count += 1
            self.slot_counts[idx] += 1
            if exemplar is not None:
                if self.exemplars is None:
                    self.exemplars = [None] * (len(self.buckets) + 1)
                ex = (dict(exemplar), float(v), time.time())
                self.exemplars[min(idx, len(self.buckets))] = ex
                self.exemplars[len(self.buckets)] = ex

    def cumulative_counts(self) -> list[int]:
        """Per-``le`` cumulative counts (the exposition's bucket lines).
        Caller need not hold the lock; a racing observe skews one scrape
        by one observation at worst."""
        out = []
        running = 0
        for c in self.slot_counts[:-1]:
            running += c
            out.append(running)
        return out

    def time(self):
        return _Timer(self)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text="", label_names=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_text, label_names)
        self.buckets = tuple(buckets)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float, exemplar: dict | None = None):
        self._default().observe(v, exemplar=exemplar)

    def time(self):
        """Context manager observing elapsed seconds."""
        return _Timer(self._default())

    @staticmethod
    def _exemplar_str(ex) -> str:
        """OpenMetrics exemplar rendering: `` # {labels} value ts`` —
        label values pass the same escaping as ordinary labels (a
        trace id is opaque input; an embedded quote must not corrupt
        the scrape)."""
        labels, value, ts = ex
        pairs = ",".join(f'{k}="{escape_label_value(v)}"'
                         for k, v in labels.items())
        return f" # {{{pairs}}} {value} {round(ts, 3)}"

    def expose(self, openmetrics: bool = False) -> list[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            children = sorted(self._children.items())
        for lv, child in children:
            base = self._label_str(lv)[1:-1] if lv else ""
            exemplars = child.exemplars if openmetrics else None
            for i, (b, c) in enumerate(zip(self.buckets,
                                           child.cumulative_counts())):
                lbl = f'{{{base}{"," if base else ""}le="{b}"}}'
                line = f"{self.name}_bucket{lbl} {c}"
                if exemplars is not None and exemplars[i] is not None:
                    line += self._exemplar_str(exemplars[i])
                out.append(line)
            lbl_inf = f'{{{base}{"," if base else ""}le="+Inf"}}'
            line = f"{self.name}_bucket{lbl_inf} {child.count}"
            if exemplars is not None and exemplars[-1] is not None:
                line += self._exemplar_str(exemplars[-1])
            out.append(line)
            suffix = "{" + base + "}" if base else ""
            out.append(f"{self.name}_sum{suffix} {child.total}")
            out.append(f"{self.name}_count{suffix} {child.count}")
        return out


class _Timer:
    def __init__(self, child):
        self._child = child

    def __enter__(self):
        import time

        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        self._child.observe(time.perf_counter() - self._t0)
        return False


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _register(self, cls, name, help_text, label_names, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(f"metric {name} already registered as "
                                     f"{existing.kind}")
                return existing
            m = cls(name, help_text, label_names, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help_text="", label_names=()) -> Counter:
        return self._register(Counter, name, help_text, label_names)

    def gauge(self, name, help_text="", label_names=()) -> Gauge:
        return self._register(Gauge, name, help_text, label_names)

    def histogram(self, name, help_text="", label_names=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help_text, label_names,
                              buckets=buckets)

    def expose(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition format. ``openmetrics=True`` emits
        the OpenMetrics flavor: histogram buckets carry their exemplars
        and the stream ends with ``# EOF`` — what a client negotiating
        ``Accept: application/openmetrics-text`` receives."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, (Histogram, Counter)):
                lines.extend(m.expose(openmetrics=openmetrics))
            else:
                lines.extend(m.expose())
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


#: process-wide default registry (reference: one prometheus registry per node)
registry = MetricsRegistry()

# -- the standard metric set (subset of prometheus.go's ~70 vecs) -------------

query_duration = registry.histogram(
    "weaviate_tpu_query_duration_seconds",
    "Query latency by collection and query type",
    ("collection", "query_type"))
objects_total = registry.counter(
    "weaviate_tpu_objects_total",
    "Object mutations by collection and operation",
    ("collection", "operation"))
vector_index_size = registry.gauge(
    "weaviate_tpu_vector_index_size",
    "Live vectors per collection/shard", ("collection", "shard"))
vector_index_operations = registry.counter(
    "weaviate_tpu_vector_index_operations_total",
    "Vector index ops", ("collection", "operation"))
lsm_segment_count = registry.gauge(
    "weaviate_tpu_lsm_segment_count",
    "Segments per bucket", ("bucket",))

# -- LSM internals (reference: lsmkv/metrics.go) ------------------------------

lsm_wal_bytes = registry.counter(
    "weaviate_tpu_lsm_wal_bytes_total",
    "WAL bytes appended per bucket", ("bucket",))
lsm_memtable_bytes = registry.gauge(
    "weaviate_tpu_lsm_memtable_bytes",
    "Active memtable size estimate per bucket", ("bucket",))
lsm_flush_duration = registry.histogram(
    "weaviate_tpu_lsm_flush_duration_seconds",
    "Sealed-memtable to segment flush latency", ("bucket",))
lsm_compaction_duration = registry.histogram(
    "weaviate_tpu_lsm_compaction_duration_seconds",
    "Segment compaction latency", ("bucket",))

# -- crash recovery (storage/recovery.py records these at every bucket
#    open; /v1/debug/storage serves the same registry as JSON) ----------------

recovery_frames_replayed = registry.counter(
    "weaviate_tpu_recovery_frames_replayed_total",
    "Intact WAL frames re-applied into the memtable at bucket open",
    ("bucket",))
recovery_bytes_truncated = registry.counter(
    "weaviate_tpu_recovery_bytes_truncated_total",
    "Torn-tail WAL bytes dropped at bucket open (crash mid-append)",
    ("bucket",))
recovery_wals_quarantined = registry.counter(
    "weaviate_tpu_recovery_wals_quarantined_total",
    "WAL files renamed .corrupt at open: a frame failed its CRC with "
    "intact bytes after it (mid-file corruption, not a torn tail)",
    ("bucket",))
recovery_segments_quarantined = registry.counter(
    "weaviate_tpu_recovery_segments_quarantined_total",
    "Segment files renamed .corrupt at open (unparseable header/"
    "footer/index)", ("bucket",))
recovery_segments_recovered = registry.counter(
    "weaviate_tpu_recovery_segments_recovered_total",
    "Segments written from replayed WAL state at bucket open",
    ("bucket",))

# -- vector index internals (reference: hnsw/metrics.go) ----------------------

vector_index_tombstones = registry.gauge(
    "weaviate_tpu_vector_index_tombstones",
    "Tombstoned (deleted, unreclaimed) vectors",
    ("collection", "shard", "vector"))
vector_index_hbm_bytes = registry.gauge(
    "weaviate_tpu_vector_index_hbm_bytes",
    "Device memory held by the index's arrays",
    ("collection", "shard", "vector"))
vector_index_compressed = registry.gauge(
    "weaviate_tpu_vector_index_compressed",
    "1 when the index serves from quantized codes",
    ("collection", "shard", "vector"))

# -- replication (reference: replication metrics in monitoring/) --------------

replication_phase_total = registry.counter(
    "weaviate_tpu_replication_phase_total",
    "2PC phases by outcome", ("phase", "status"))
hashbeat_repairs_total = registry.counter(
    "weaviate_tpu_hashbeat_objects_repaired_total",
    "Objects propagated by Merkle anti-entropy", ("direction",))
replication_staged_expired = registry.counter(
    "weaviate_tpu_replication_staged_expired_total",
    "Staged 2PC entries dropped or refused past the staged-entry TTL "
    "(orphaned prepares whose coordinator never came back, and late "
    "commits racing a partition heal)", ("collection", "shard"))
hashbeat_rounds = registry.counter(
    "weaviate_tpu_hashbeat_rounds_total",
    "Anti-entropy rounds run per locally-owned shard (one round = one "
    "Merkle walk against every peer replica)", ("collection", "shard"))
replica_divergent_entries = registry.gauge(
    "weaviate_tpu_replica_divergent_entries",
    "Divergence estimate from the last anti-entropy round: entries "
    "whose digests disagreed with at least one peer replica (0 once "
    "the replicas converged)", ("collection", "shard"))

# -- dynamic query batching ---------------------------------------------------

batcher_batch_size = registry.histogram(
    "weaviate_tpu_query_batcher_batch_size",
    "Queries coalesced per device dispatch", (),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
batcher_wait_duration = registry.histogram(
    "weaviate_tpu_query_batcher_wait_seconds",
    "Time a query waits in the batcher queue before its dispatch starts")
batcher_execute_duration = registry.histogram(
    "weaviate_tpu_query_batcher_execute_seconds",
    "Device dispatch+materialize time of the coalesced batch a query "
    "rode in")
batcher_filtered_batched = registry.counter(
    "weaviate_tpu_query_batcher_filtered_batched_total",
    "Filtered requests served inside a coalesced bitmask-batched "
    "dispatch (instead of a solo device program)")
batcher_compile_bucket = registry.counter(
    "weaviate_tpu_query_batcher_compile_bucket_total",
    "Coalesced dispatches by padded pow2 (batch, k) bucket — the bucket "
    "set bounds the number of compiled program variants", ("b", "k"))
batcher_async_dispatched = registry.counter(
    "weaviate_tpu_query_batcher_async_dispatched_total",
    "Coalesced drains dispatched through the zero-sync pipeline: "
    "results stay device-resident and drain D2H on the transfer thread")
batcher_overlapped = registry.counter(
    "weaviate_tpu_query_batcher_overlapped_total",
    "Dispatches launched while a previous batch was still draining "
    "D2H — the overlap the double-buffered pipeline exists for")
batcher_transfer_duration = registry.histogram(
    "weaviate_tpu_query_batcher_transfer_seconds",
    "D2H drain time (transfer.d2h window) of the coalesced batch a "
    "query rode in, overlapped with the next dispatch")
batcher_hybrid_batched = registry.counter(
    "weaviate_tpu_query_batcher_hybrid_batched_total",
    "Hybrid (sparse+dense) requests served inside a coalesced device "
    "dispatch — sparse operands rode the drain the way allow_bits do")

# -- inverted index (text/inverted.py) ----------------------------------------

postings_cache_hits = registry.counter(
    "weaviate_tpu_postings_cache_hits_total",
    "Posting-list reads served from the per-shard LRU postings cache")
postings_cache_misses = registry.counter(
    "weaviate_tpu_postings_cache_misses_total",
    "Posting-list reads that went to the LSM searchable bucket — the "
    "host-side cost floor of BM25 planning and the hybridplane's "
    "posting pack")

# -- epoch store (engine/epochs.py publishes on seal/compact/drop;
#    db/collection.py bumps the migration counter) ----------------------------

epoch_count = registry.gauge(
    "weaviate_tpu_epoch_count",
    "Device epochs in the stack (sealed + active) per epoch-backed "
    "vector store", ("collection", "shard"))
epoch_live_rows = registry.gauge(
    "weaviate_tpu_epoch_live_rows",
    "Live (non-tombstoned) rows per device epoch; series are removed "
    "when their epoch compacts away or migrates",
    ("collection", "shard", "epoch"))
epoch_tombstone_rows = registry.gauge(
    "weaviate_tpu_epoch_tombstone_rows",
    "Tombstoned rows per device epoch — what the background compaction "
    "policy folds out to reclaim HBM",
    ("collection", "shard", "epoch"))
epoch_compactions = registry.counter(
    "weaviate_tpu_epoch_compactions_total",
    "Sealed epochs folded on device (live rows repacked, tombstoned "
    "HBM released through the ledger finalizers)",
    ("collection", "shard"))
epoch_migrations = registry.counter(
    "weaviate_tpu_epoch_migrations_total",
    "Sealed epochs migrated to a sibling shard with headroom instead "
    "of latching 507 rejections at the HBM watermark",
    ("collection", "shard"))

# -- GPU memory ledger (runtime/hbm_ledger.py keeps these current on every
#    register/update/release; memwatch sets the budget + pressure) ------------

hbm_bytes = registry.gauge(
    "weaviate_tpu_hbm_bytes",
    "Live GPU memory bytes registered in the device-memory ledger",
    ("collection", "shard", "component"))
hbm_peak_bytes = registry.gauge(
    "weaviate_tpu_hbm_peak_bytes",
    "High-water mark of ledger-registered GPU memory bytes since "
    "process start")
hbm_host_bytes = registry.gauge(
    "weaviate_tpu_hbm_host_bytes",
    "Ledger GPU memory bytes attributed per host; host values sum "
    "exactly to the ledger's live device total",
    ("host",))
hbm_budget_bytes = registry.gauge(
    "weaviate_tpu_hbm_budget_bytes",
    "Per-device GPU memory budget admission control gates against "
    "(0 = no budget known)")
memory_pressure_total = registry.counter(
    "weaviate_tpu_memory_pressure_total",
    "Admission-control memory-pressure events",
    ("resource", "action"))

# -- faultline / unified failure policy (runtime/faultline.py,
#    runtime/retry.py, runtime/degrade.py, cluster/transport.py) --------------

fault_injected_total = registry.counter(
    "weaviate_tpu_fault_injected_total",
    "Faults executed by an armed faultline schedule, by fault point "
    "and action — a chaos run asserts this accounts for every "
    "scheduled injection", ("point", "action"))
retries_total = registry.counter(
    "weaviate_tpu_retries_total",
    "RetryPolicy attempt outcomes by operation: retried (backoff "
    "taken), recovered (a retry succeeded), exhausted (attempts used "
    "up), deadline (budget could not absorb another attempt)",
    ("op", "outcome"))
deadline_exceeded_total = registry.counter(
    "weaviate_tpu_deadline_exceeded_total",
    "Requests that ran out of their propagated time budget, by the "
    "layer that noticed", ("layer",))
circuit_state = registry.gauge(
    "weaviate_tpu_circuit_state",
    "Per-peer transport circuit breaker state: 0=closed, 1=half-open, "
    "2=open", ("peer",))
circuit_transitions_total = registry.counter(
    "weaviate_tpu_circuit_transitions_total",
    "Circuit breaker state transitions by peer and target state",
    ("peer", "to"))
degraded_results_total = registry.counter(
    "weaviate_tpu_degraded_results_total",
    "Requests answered with explicitly-marked PARTIAL results instead "
    "of an error (dead replica skipped, consistency level downgraded)",
    ("kind", "collection"))
component_unhealthy = registry.gauge(
    "weaviate_tpu_component_unhealthy",
    "1 while a serving component (query batcher, native data plane) is "
    "flagged unhealthy after a dispatch failure; cleared on recovery",
    ("component",))
batcher_dispatch_retries = registry.counter(
    "weaviate_tpu_query_batcher_dispatch_retries_total",
    "Coalesced device dispatches retried once after a failure before "
    "erroring their own waiters")
native_dispatch_retries = registry.counter(
    "weaviate_tpu_native_plane_dispatch_retries_total",
    "Native data-plane pipelined batches retried once through the sync "
    "path after a device/transfer fault")

# -- tracing (runtime/tracing.py feeds this on every finished span) -----------

span_duration = registry.histogram(
    "weaviate_tpu_span_duration_seconds",
    "Trace span durations by span name", ("span",))

# -- tailboard: always-on latency attribution (runtime/tailboard.py) ----------

request_phase_seconds = registry.histogram(
    "weaviate_tpu_request_phase_seconds",
    "Always-on per-request latency attribution from monotonic edge/"
    "batcher/transfer stamps (no device sync on unsampled paths): phase "
    "is queue_wait (batcher queue), device (kernelscope-attributed chip "
    "residency: drain window minus the memcpy EWMA, source=drain; wall "
    "window on sync paths), transfer (memcpy share of the D2H drain) or "
    "host (everything else); tenant and "
    "collection pass the top-K cardinality guard (overflow: other). "
    "Buckets carry OpenMetrics exemplars naming tail-retained trace ids",
    ("operation", "phase", "collection", "tenant"),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5, 5.0, 10.0))
# the phase histogram's own series budget must dominate the generic
# per-metric cap: its label space is operations x 4 phases x the
# tailboard top-K guards (64 collections, 32 tenants) — a modest
# multi-tenant deployment legitimately exceeds the 2000 default, and
# collapsing the headline attribution labels to "other" would defeat
# the metric's purpose while the guards already bound it
try:
    request_phase_seconds.max_series = int(os.environ.get(
        "WEAVIATE_TPU_PHASE_MAX_SERIES", "16000") or 16000)
except ValueError:
    request_phase_seconds.max_series = 16000
tail_retained_total = registry.counter(
    "weaviate_tpu_tail_retained_total",
    "Traces kept by the tail-based retention decision at request "
    "completion (always kept regardless of TRACE_SAMPLE_RATE), by "
    "reason: slow, error, deadline, degraded, fault",
    ("reason",))
slo_burn_rate = registry.gauge(
    "weaviate_tpu_slo_burn_rate",
    "Error-budget burn rate per SLO objective and sliding window "
    "(bad-fraction / (1 - objective)): 1.0 burns exactly the budget, "
    "14.4x on the fast window is the classic page threshold; refreshed "
    "at scrape and by /v1/debug/slo",
    ("slo", "window"))
metric_series_dropped = registry.counter(
    "weaviate_tpu_metric_series_dropped_total",
    "Label-set lookups redirected into the reserved 'other' overflow "
    "series by the per-metric cardinality cap "
    "(WEAVIATE_TPU_METRIC_MAX_SERIES) — nonzero means some stream of "
    "label values (tenants, collections) outgrew the exposition budget",
    ("metric",))
flight_snapshots_total = registry.counter(
    "weaviate_tpu_flight_snapshots_total",
    "Flight-recorder snapshots written to the data dir on incident "
    "(SLO burn threshold crossed, component flipped unhealthy), by "
    "incident reason", ("reason",))

# -- kernelscope: device-time truth (runtime/kernelscope.py) ------------------

dispatch_device_seconds = registry.histogram(
    "weaviate_tpu_dispatch_device_seconds",
    "Attributed device residency per coalesced dispatch, by compiled "
    "variant (index kind, padded batch bucket, k bucket) and attribution "
    "source: 'drain' = drain-thread stamps minus the sampled memcpy "
    "EWMA (zero-sync), 'wall' = dispatch wall window (sync engines and "
    "null-device bench stubs)",
    ("kind", "b", "k", "source"),
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5))
device_seconds_total = registry.counter(
    "weaviate_tpu_device_seconds_total",
    "Cumulative attributed device seconds apportioned per tenant "
    "(dispatch residency split across the requests it coalesced, "
    "weighted by rows scanned) — the interference signal for per-tenant "
    "QoS; sums to within the metering tolerance of total pipeline "
    "device residency",
    ("collection", "tenant"))

# -- perf gate (runtime/perfgate.py republishes these from the last
#    persisted benchkeeper verdict; see tools/benchkeeper) --------------------

bench_gate_ok = registry.gauge(
    "weaviate_tpu_bench_gate_ok",
    "1 when the last benchkeeper perf-gate verdict passed, 0 when it "
    "failed (regression, stale baseline, or missing metric)")
bench_gate_regressions = registry.gauge(
    "weaviate_tpu_bench_gate_regressions",
    "Out-of-band regressions in the last benchkeeper verdict")
bench_gate_stale = registry.gauge(
    "weaviate_tpu_bench_gate_stale_entries",
    "Baseline entries flagged stale (unexplained improvement beyond "
    "band) in the last benchkeeper verdict")
bench_metric_value = registry.gauge(
    "weaviate_tpu_bench_metric_value",
    "Last benchkeeper-checked value per baseline entry; the unit label "
    "carries the entry's unit (ms for device-attributed timings, qps, "
    "...)", ("entry", "unit"))
bench_delta_frac = registry.gauge(
    "weaviate_tpu_bench_delta_frac",
    "Fractional delta vs the baseline reference per entry, normalized "
    "so positive = regressing direction (slower scan / lower qps)",
    ("entry",))

# -- driftwatch (runtime/driftwatch.py: online recall/perf drift plane) -------

drift_gate_ok = registry.gauge(
    "weaviate_tpu_drift_gate_ok",
    "1 when no open driftwatch finding flips health (canary recall "
    "holds, live telemetry inside its benchkeeper bands), 0 during a "
    "drift incident")
drift_findings_total = registry.counter(
    "weaviate_tpu_drift_findings_total",
    "Driftwatch findings opened, by leg (canary = serving-path probe "
    "set, live = telemetry vs benchkeeper bands) and kind (recall, "
    "residency, regression, stale, refused)", ("leg", "kind"))
canary_recall = registry.gauge(
    "weaviate_tpu_canary_recall",
    "Worst canary recall@10 across a shard's vector spaces in the last "
    "driftwatch cycle, measured through the real query batcher against "
    "host-exact ground truth", ("collection", "shard"))

# -- jit compilation (runtime/compile_cache.py installs the listeners) --------

compile_cache_events = registry.counter(
    "weaviate_tpu_compile_cache_events_total",
    "Persistent compilation-cache lookups by outcome", ("event",))
jit_compile_duration = registry.histogram(
    "weaviate_tpu_jit_compile_seconds",
    "Backend compile time per jit signature (jax monitoring event key)",
    ("signature",),
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0, 120.0))


TEXT_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


def scrape(openmetrics: bool = False) -> tuple[bytes, str]:
    """One metrics scrape, shared by the REST /v1/metrics route and the
    monitoring port: run the read-point refreshes (benchkeeper verdict
    pickup, per-host GPU memory attribution, tailboard fold + SLO burn
    gauges, the driftwatch gate), then render the negotiated exposition.
    Returns ``(body, content_type)``; every refresh is best-effort — a
    broken helper must never fail a scrape."""
    try:
        from weaviate_tpu_torch.runtime import perfgate

        perfgate.refresh()
    except Exception:
        pass
    try:
        from weaviate_tpu_torch.runtime.hbm_ledger import ledger

        ledger.refresh_host_gauge()
    except Exception:
        pass
    try:
        from weaviate_tpu_torch.runtime import tailboard

        tailboard.scrape_refresh()
    except Exception:
        pass
    try:
        from weaviate_tpu_torch.runtime import driftwatch

        driftwatch.scrape_refresh()
    except Exception:
        pass
    body = registry.expose(openmetrics=openmetrics).encode()
    return body, (OPENMETRICS_CONTENT_TYPE if openmetrics
                  else TEXT_CONTENT_TYPE)


def serve_metrics(host: str = "127.0.0.1", port: int = 2112):
    """Start the Prometheus /metrics listener (reference: a dedicated
    monitoring port, configure_api.go:148-153). Returns the HTTP server;
    .shutdown() stops it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    import threading as _threading

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            accept = self.headers.get("Accept", "")
            body, ctype = scrape(
                openmetrics="application/openmetrics-text" in accept)
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    t = _threading.Thread(target=httpd.serve_forever, daemon=True,
                          name="metrics")
    t.start()
    return httpd
