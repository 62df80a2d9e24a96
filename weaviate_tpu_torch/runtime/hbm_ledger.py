"""GPU memory ledger: host-side accounting of labeled device allocations.

In this package every byte the ledger counts is GPU device memory (the
CUDA card's HBM); the module keeps the ``hbm_ledger`` name and the
``hbm_*`` metric names of the JAX package so the two read alike.

The allocator's own stats (``torch.cuda.memory_allocated()``) answer
"how full is the device" but cannot answer "WHICH collection/
shard/tenant owns my GPU memory". The reference's memwatch (usecases/memwatch/
monitor.go CheckAlloc) refuses imports *before* allocating; Milvus-style
quota/segment accounting keeps a host-side ledger per segment. This
module is both: every device-resident allocation registers a labeled
entry ``(collection, shard, tenant, component, dtype, nbytes,
sharding)`` and the running totals drive

- Prometheus gauges (``hbm_bytes{collection,shard,component}``,
  ``hbm_peak_bytes``, ``hbm_budget_bytes`` — runtime/metrics.py),
- ``GET /v1/debug/memory`` (api/rest.py breakdown endpoint), and
- capacity-aware admission: ``MemoryMonitor.check_device_alloc`` falls
  back to ledger-projected totals when allocator stats are unavailable
  (runtime/memwatch.py watermark gating).

Ownership labels travel via a contextvar (``owner()``): the shard layer
sets the (collection, shard, tenant) scope around index construction and
the engine-level stores capture it once — deep allocation code never
needs label plumbing through its signatures. Long-lived buffers hold a
key and ``update()`` it across grows; transient buffers either
``release()`` explicitly or ride ``track()``, which ties the entry's
lifetime to the device array itself via weakref.

The ledger tracks LOGICAL bytes (``arr.nbytes``): on a row-sharded mesh
that is the global footprint summed over devices, the number a capacity
planner wants. Replicated operands count once per logical array, so the
allocator-vs-ledger delta (surfaced by /v1/debug/memory when allocator
stats exist) includes replication overhead, executables beyond the
estimate, and XLA scratch.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import weakref
from dataclasses import dataclass

_UNOWNED = {"collection": "_unowned", "shard": "-", "tenant": ""}

_owner_ctx: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "hbm_owner", default=None)


@contextlib.contextmanager
def owner(collection: str, shard: str = "-", tenant: str = ""):
    """Scope: allocations registered inside run under these labels."""
    token = _owner_ctx.set({"collection": str(collection),
                            "shard": str(shard), "tenant": str(tenant)})
    try:
        yield
    finally:
        _owner_ctx.reset(token)


def current_owner() -> dict:
    """The ambient (collection, shard, tenant) labels, or the _unowned
    placeholder for allocations made outside any shard scope (tests,
    benches, module-level singletons)."""
    return dict(_owner_ctx.get() or _UNOWNED)


@dataclass
class Entry:
    key: int
    collection: str
    shard: str
    tenant: str
    component: str
    dtype: str
    nbytes: int
    sharding: str  # "single" | "sharded" | "replicated" | "estimate"
    placement: str  # "device" | "host"


class HBMLedger:
    """Thread-safe allocation registry with running totals + peaks."""

    def __init__(self):
        # RLock: weakref.finalize callbacks (track()) release entries and
        # can fire from cyclic GC triggered by an allocation INSIDE a
        # locked section on the same thread — a plain Lock would
        # self-deadlock there
        self._lock = threading.RLock()
        self._entries: dict[int, Entry] = {}
        self._next_key = 1
        self._device_total = 0
        self._device_peak = 0
        # incremental rollups so the admission path never iterates entries
        self._by_collection: dict[str, int] = {}
        self._by_shard: dict[tuple[str, str], int] = {}
        self._by_gauge: dict[tuple[str, str, str], int] = {}
        # mesh host count hint (set once at startup when the mesh is
        # known) so scrape-time host-gauge refreshes need no mesh access
        self._host_count_hint = 1

    # -- registration ---------------------------------------------------------

    def register(self, component: str, nbytes: int, *,
                 collection: str | None = None, shard: str | None = None,
                 tenant: str | None = None, dtype=None,
                 sharding: str = "single",
                 placement: str = "device") -> int:
        """Record an allocation; returns a key for update()/release().
        Labels default from the ambient ``owner()`` scope."""
        own = current_owner()
        e = Entry(
            key=0,
            collection=str(collection if collection is not None
                           else own["collection"]),
            shard=str(shard if shard is not None else own["shard"]),
            tenant=str(tenant if tenant is not None else own["tenant"]),
            component=str(component),
            dtype="" if dtype is None else str(dtype),
            nbytes=max(0, int(nbytes)),
            sharding=sharding,
            placement=placement,
        )
        with self._lock:
            e.key = self._next_key
            self._next_key += 1
            self._entries[e.key] = e
            self._apply_delta(e, e.nbytes)
        return e.key

    def update(self, key: int, nbytes: int) -> None:
        """Resize an existing entry (capacity grow / shrink-on-compact)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return
            delta = max(0, int(nbytes)) - e.nbytes
            e.nbytes += delta
            self._apply_delta(e, delta)

    def release(self, key: int) -> None:
        with self._lock:
            e = self._entries.pop(key, None)
            if e is None:
                return
            self._apply_delta(e, -e.nbytes)

    def release_many(self, keys) -> None:
        """Finalizer-friendly bulk release (missing keys are fine). Takes
        the live list object so keys added after finalize() registration
        are still honored."""
        for k in list(keys):
            self.release(k)

    def set_keyed(self, keys: dict, component: str, nbytes: int, *,
                  owner: dict | None = None, dtype=None,
                  sharding: str = "single",
                  placement: str = "device") -> None:
        """Upsert helper for stores that re-publish a component's size
        across grows: ``keys`` maps component -> ledger key and is owned
        by the caller (pass the same dict to a weakref finalizer via
        ``release_many(keys.values())`` for cleanup-on-drop)."""
        key = keys.get(component)
        if key is None:
            if nbytes <= 0:
                return
            keys[component] = self.register(
                component, nbytes, dtype=dtype, sharding=sharding,
                placement=placement, **(owner or {}))
        else:
            self.update(key, max(0, int(nbytes)))

    def track(self, component: str, array, **labels) -> int | None:
        """Register ``array.nbytes`` and auto-release when the array is
        garbage-collected (weakref.finalize) — the right lifetime for
        transient device buffers like packed allow bitmasks. Returns the
        key, or None when the object cannot carry a weakref (the entry
        is then not recorded rather than leaked)."""
        nbytes = int(getattr(array, "nbytes", 0))
        if nbytes <= 0:
            return None
        key = self.register(component, nbytes,
                            dtype=getattr(array, "dtype", None), **labels)
        try:
            weakref.finalize(array, self.release, key)
        except TypeError:
            self.release(key)
            return None
        return key

    # -- internals ------------------------------------------------------------

    def _apply_delta(self, e: Entry, delta: int) -> None:
        """Caller holds ``_lock``. Gauges are updated outside-in: the
        metric child has its own lock, and we never call back into the
        ledger from there."""
        if delta == 0:
            return
        if e.placement != "device":
            # host-tier entries (e.g. the HNSW graph) show in the
            # breakdown endpoint only — the hbm_* gauges and the
            # admission totals are DEVICE bytes by contract
            return
        self._device_total += delta
        if self._device_total > self._device_peak:
            self._device_peak = self._device_total
        self._by_collection[e.collection] = \
            self._by_collection.get(e.collection, 0) + delta
        if self._by_collection[e.collection] <= 0:
            del self._by_collection[e.collection]
        sk = (e.collection, e.shard)
        self._by_shard[sk] = self._by_shard.get(sk, 0) + delta
        if self._by_shard[sk] <= 0:
            del self._by_shard[sk]
        gk = (e.collection, e.shard, e.component)
        self._by_gauge[gk] = self._by_gauge.get(gk, 0) + delta
        gauge_val = self._by_gauge[gk]
        if gauge_val <= 0:
            del self._by_gauge[gk]
        self._export_gauges(gk, gauge_val)

    def _export_gauges(self, gk: tuple, gauge_val: int) -> None:
        try:
            from weaviate_tpu_torch.runtime.metrics import (hbm_bytes,
                                                      hbm_peak_bytes)

            if gauge_val <= 0:
                hbm_bytes.remove(*gk)
            else:
                hbm_bytes.labels(*gk).set(float(gauge_val))
            hbm_peak_bytes.set(float(self._device_peak))
        except Exception:  # noqa: BLE001 — accounting must never fail allocs
            pass

    # -- queries --------------------------------------------------------------

    def total_bytes(self) -> int:
        """Live device bytes across every registration (the projection
        ``check_device_alloc`` uses when allocator stats are absent)."""
        with self._lock:
            return self._device_total

    def peak_bytes(self) -> int:
        with self._lock:
            return self._device_peak

    def collection_bytes(self, collection: str) -> int:
        with self._lock:
            return self._by_collection.get(str(collection), 0)

    def shard_bytes(self, collection: str, shard: str) -> int:
        with self._lock:
            return self._by_shard.get((str(collection), str(shard)), 0)

    def shard_component_bytes(self, collection: str, shard: str) -> dict:
        """Component -> device bytes for one shard. Epoch stores label
        per epoch (``corpus@e3``, ``codes@e3``), so this is how the
        epoch policy (and its tests) see exactly which epoch owns which
        bytes — and that compaction/migration actually released them."""
        collection, shard = str(collection), str(shard)
        with self._lock:
            return {comp: b for (c, s, comp), b in self._by_gauge.items()
                    if c == collection and s == shard}

    def set_host_count(self, n_hosts: int) -> None:
        """Record the mesh's host count (server startup / Database
        init) so ``refresh_host_gauge`` can run from scrape handlers
        without reaching back to the mesh."""
        with self._lock:
            self._host_count_hint = max(1, int(n_hosts))

    def refresh_host_gauge(self) -> dict:
        """Scrape-time refresh of ``weaviate_tpu_hbm_host_bytes`` (the
        perfgate.refresh pattern): the split depends on LIVE totals, so
        recomputing at exposition keeps the gauge summing exactly to
        the live device total instead of whatever the last REST read
        left behind."""
        return self.host_rollup(self._host_count_hint)

    def host_rollup(self, n_hosts: int) -> dict:
        """Per-HOST device bytes for a multi-host layout:
        ``{"host-0": bytes, ...}`` that SUMS EXACTLY to
        ``total_bytes()`` — the attribution /v1/nodes and the
        ``weaviate_tpu_hbm_host_bytes`` gauge report, and what the
        placement hook ranks hosts by.

        Attribution follows each entry's LOGICAL-bytes contract:
        row-"sharded" and "replicated" entries split evenly across
        hosts (row-sharding is equal by construction —
        ``shardable_capacity`` — and a replicated array's logical bytes
        are counted once, so an even split keeps the sum invariant;
        the per-device replication overhead already shows up only in
        the allocator-vs-ledger delta); "single"-device entries and
        compile estimates land on host-0, where device 0 lives.
        Integer remainders go to host-0 so the sum is exact."""
        n_hosts = max(1, int(n_hosts))
        out = {f"host-{i}": 0 for i in range(n_hosts)}
        with self._lock:
            entries = [(e.sharding, e.nbytes) for e in
                       self._entries.values() if e.placement == "device"]
        for sharding, nbytes in entries:
            if n_hosts > 1 and sharding in ("sharded", "replicated"):
                share = nbytes // n_hosts
                for i in range(n_hosts):
                    out[f"host-{i}"] += share
                out["host-0"] += nbytes - share * n_hosts
            else:
                out["host-0"] += nbytes
        try:
            from weaviate_tpu_torch.runtime.metrics import hbm_host_bytes

            for host, b in out.items():
                hbm_host_bytes.labels(host).set(float(b))
        except Exception:  # noqa: BLE001 — accounting must never fail reads
            pass
        return out

    def breakdown(self) -> dict:
        """Per-collection rollup: bytes by collection, with nested shard
        and component splits. Device placement only (host-tier entries —
        e.g. HNSW graph arrays — roll up under ``hostBytes``)."""
        with self._lock:
            entries = list(self._entries.values())
        out: dict[str, dict] = {}
        for e in entries:
            col = out.setdefault(e.collection, {
                "bytes": 0, "hostBytes": 0, "shards": {}, "components": {}})
            if e.placement == "device":
                col["bytes"] += e.nbytes
                col["shards"][e.shard] = \
                    col["shards"].get(e.shard, 0) + e.nbytes
            else:
                col["hostBytes"] += e.nbytes
            col["components"][e.component] = \
                col["components"].get(e.component, 0) + e.nbytes
        return out

    def top(self, n: int = 20) -> list[dict]:
        """Largest live allocations, for the debug endpoint."""
        with self._lock:
            entries = sorted(self._entries.values(),
                             key=lambda e: e.nbytes, reverse=True)[:n]
        return [{
            "collection": e.collection, "shard": e.shard,
            "tenant": e.tenant, "component": e.component,
            "dtype": e.dtype, "nbytes": e.nbytes,
            "sharding": e.sharding, "placement": e.placement,
        } for e in entries]

    def snapshot(self) -> dict:
        """Full debug-endpoint payload body (totals + rollup + top)."""
        return {
            "totalBytes": self.total_bytes(),
            "peakBytes": self.peak_bytes(),
            "collections": self.breakdown(),
            "top": self.top(),
        }

    def reset(self) -> None:
        """Drop every entry (tests)."""
        with self._lock:
            entries = list(self._entries)
        for k in entries:
            self.release(k)
        with self._lock:
            self._device_peak = self._device_total


#: process-wide default ledger (one per node, like the metrics registry)
ledger = HBMLedger()
