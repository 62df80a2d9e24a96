"""Memory watchdog: gate allocations against host and device budgets.

Reference: usecases/memwatch/monitor.go:49 — CheckAlloc(:99) compares the
projected live heap against GOMEMLIMIT and rejects imports/cache growth
when it would overshoot. The port adds the device budget: device
tensors (vector stores, posting lists) are tracked against each CUDA
card's memory, read from ``torch.cuda.mem_get_info`` and the caching
allocator's ``torch.cuda.memory_stats`` — and, where there is no card
(the CPU), against the HBM ledger's projection of registered device bytes
(runtime/hbm_ledger.py), so admission control keeps working exactly
where the allocator goes blind.

Watermark semantics (config: HBM_HIGH_WATERMARK / HBM_LOW_WATERMARK,
defaults 0.9 / 0.8): an import that would push projected usage past
``budget * high`` is refused with a typed 507-style error BEFORE the
transfer is dispatched (no mid-import OOM). Once tripped, the monitor
stays in pressure mode — still refusing — until usage falls back under
``budget * low`` (hysteresis: a budget hovering at the high mark must
not flap accept/reject per request). Every transition and rejection
emits a ``memory.pressure`` trace span and bumps
``weaviate_tpu_memory_pressure_total`` so degradation is visible.
"""

from __future__ import annotations

import os
import threading
import time

#: seconds before an "allocator stats unavailable" verdict is re-probed.
#: One transient failure (backend still initializing) must not disable
#: device stats forever; re-probing every request would re-pay backend
#: init on platforms that genuinely lack stats.
STATS_RETRY_S = 60.0


class InsufficientMemoryError(MemoryError):
    """Typed admission rejection (HTTP maps it to 507 Insufficient
    Storage). ``projected``/``budget``/``source`` describe the refusal."""

    status = 507

    def __init__(self, message: str, *, projected: int = 0,
                 budget: int = 0, source: str = ""):
        super().__init__(message)
        self.projected = projected
        self.budget = budget
        self.source = source  # "allocator" | "ledger" | "tracked"


def _env_fraction(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        v = float(raw)
    except ValueError:
        return default
    return v if 0.0 < v <= 1.0 else default


class MemoryMonitor:
    def __init__(self, host_limit_bytes: int | None = None,
                 device_limit_bytes: int | None = None,
                 max_utilization: float = 0.9,
                 ledger=None,
                 high_watermark: float | None = None,
                 low_watermark: float | None = None):
        self.host_limit = host_limit_bytes
        self.device_limit = device_limit_bytes
        self.max_utilization = max_utilization
        # watermark precedence: explicit arg > env > max_utilization/0.8
        self.high_watermark = (
            high_watermark if high_watermark is not None
            else _env_fraction("HBM_HIGH_WATERMARK", max_utilization))
        self.low_watermark = (
            low_watermark if low_watermark is not None
            else _env_fraction("HBM_LOW_WATERMARK", 0.8))
        self.low_watermark = min(self.low_watermark, self.high_watermark)
        if ledger is None:
            from weaviate_tpu_torch.runtime.hbm_ledger import ledger as _default

            ledger = _default
        self.ledger = ledger
        self._lock = threading.Lock()
        self._pressure = False  # hysteresis latch (high trips, low clears)
        self._last_source = "ledger"  # which tier answered device_in_use
        # host-side tracked allocations (we can't read the Python live
        # heap cheaply; callers register their big buffers)
        self._tracked_host = 0

    # -- device -----------------------------------------------------------

    def device_budget(self, stats: dict | None = None) -> int | None:
        """HBM budget in bytes; explicit limit wins, else read from the
        backend (the CUDA allocator's stats), else the
        HBM_DEVICE_LIMIT_BYTES env override (the only option on backends
        with no allocator stats)."""
        budget = self._device_budget_raw(stats)
        try:
            from weaviate_tpu_torch.runtime.metrics import hbm_budget_bytes

            hbm_budget_bytes.set(float(budget or 0))
        except Exception:  # noqa: BLE001 — metrics are best-effort
            pass
        return budget

    def _device_budget_raw(self, stats: dict | None = None) -> int | None:
        if self.device_limit is not None:
            return self.device_limit
        stats = device_memory_stats() if stats is None else stats
        for dev in stats.values():
            if dev.get("bytesLimit"):
                return int(dev["bytesLimit"])
        raw = os.environ.get("HBM_DEVICE_LIMIT_BYTES")
        if raw:
            try:
                return int(raw)
            except ValueError:
                pass
        return None

    def device_in_use(self, stats: dict | None = None) -> int:
        """Current device usage: allocator stats when the backend has
        them, else the ledger's registered device bytes. The ledger
        projection is the LOGICAL global footprint (on a mesh, summed
        over shards) — conservative against a per-device allocator
        budget, exact against an operator-granted
        HBM_DEVICE_LIMIT_BYTES. Records which source answered in
        ``_last_source`` (on a remote-tunnel backend every stats probe
        is an RPC, so the admission path probes ONCE and threads the
        dict through)."""
        stats = device_memory_stats() if stats is None else stats
        in_use = [d["bytesInUse"] for d in stats.values()
                  if d.get("bytesInUse") is not None]
        # _last_source is read by the rejection path on other threads —
        # publish it under the monitor lock (callers never hold it here)
        if in_use:
            with self._lock:
                self._last_source = "allocator"
            return max(in_use)
        with self._lock:
            self._last_source = "ledger"
        return self.ledger.total_bytes()

    def check_device_alloc(self, nbytes: int, what: str = "") -> None:
        """Raise InsufficientMemoryError if landing ``nbytes`` more on the
        device would cross the high watermark (reference CheckAlloc
        semantics: refuse BEFORE allocating, don't OOM mid-import).
        Hysteresis: once tripped, keeps refusing until usage falls under
        the low watermark."""
        # one stats probe serves budget + usage (RPC-priced on tunnels);
        # the explicit-limit fast path skips it entirely
        stats = None if self.device_limit is not None \
            else device_memory_stats()
        budget = self.device_budget(stats)
        if budget is None:
            return
        in_use = self.device_in_use() if stats is None \
            else self.device_in_use(stats)
        source = getattr(self, "_last_source", "ledger")
        projected = in_use + int(nbytes)
        high = budget * self.high_watermark
        low = budget * self.low_watermark
        with self._lock:
            if self._pressure and in_use <= low:
                self._pressure = False
                self._pressure_event("cleared", projected, budget, source)
            reject = projected > high or (self._pressure and projected > low)
            if reject and not self._pressure:
                self._pressure = True
                self._pressure_event("entered", projected, budget, source)
        if reject:
            self._pressure_event("rejected", projected, budget, source,
                                 what=what)
            raise InsufficientMemoryError(
                f"device allocation of {nbytes} bytes"
                f"{f' ({what})' if what else ''} would exceed "
                f"{self.high_watermark:.0%} of HBM budget {budget} "
                f"({source} usage {in_use})",
                projected=projected, budget=budget, source=source)

    @staticmethod
    def _pressure_event(action: str, projected: int, budget: int,
                        source: str, what: str = "") -> None:
        try:
            from weaviate_tpu_torch.runtime import tracing
            from weaviate_tpu_torch.runtime.metrics import memory_pressure_total

            memory_pressure_total.labels("device", action).inc()
            now = time.perf_counter()
            tracing.record_span("memory.pressure", now, now,
                                action=action, projected=projected,
                                budget=budget, source=source,
                                **({"what": what} if what else {}))
        except Exception:  # noqa: BLE001 — observability must not gate
            pass

    @property
    def under_pressure(self) -> bool:
        with self._lock:
            return self._pressure

    # -- host -------------------------------------------------------------

    def track_host(self, nbytes: int) -> None:
        with self._lock:
            self._tracked_host += nbytes

    def release_host(self, nbytes: int) -> None:
        with self._lock:
            self._tracked_host = max(0, self._tracked_host - nbytes)

    def check_host_alloc(self, nbytes: int) -> None:
        if self.host_limit is None:
            return
        with self._lock:
            projected = self._tracked_host + nbytes
        if projected > self.host_limit * self.max_utilization:
            raise InsufficientMemoryError(
                f"host allocation of {nbytes} bytes would exceed "
                f"{self.max_utilization:.0%} of limit {self.host_limit}",
                projected=projected, budget=self.host_limit,
                source="tracked")

    @property
    def tracked_host(self) -> int:
        return self._tracked_host


# "unavailable" verdict with an expiry: a transient probe failure (e.g.
# backend still initializing) re-probes after STATS_RETRY_S instead of
# disabling device stats for the life of the process; a succeeding probe
# clears it. The positive path is NOT cached — allocator stats are a
# cheap attribute read once the backend is up.
_stats_lock = threading.Lock()
_stats_failed_at: float | None = None


def _probe_device_stats() -> dict:
    """One raw probe (module-level so tests can monkeypatch failures):
    the caching allocator's live and peak bytes and the card's total
    memory, per CUDA device under ``cuda:<i>``. No CUDA -> {}."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _free, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytesInUse": stats.get("allocated_bytes.all.current", 0),
            "bytesLimit": total,
            "peakBytesInUse": stats.get("allocated_bytes.all.peak", 0),
        }
    return out


def device_memory_stats() -> dict:
    """Per-device HBM usage (the GOMEMLIMIT analog for device memory).

    Returns {} when the backend does not expose allocator stats (e.g.
    CPU mesh, or a remote-tunnel device). Unavailability is cached with
    a TTL (STATS_RETRY_S) so a polled status endpoint doesn't re-pay
    backend init every few seconds, yet one transient failure can't
    permanently blind the monitor."""
    global _stats_failed_at
    with _stats_lock:
        if (_stats_failed_at is not None
                and time.monotonic() - _stats_failed_at < STATS_RETRY_S):
            return {}
    try:
        out = _probe_device_stats()
    except Exception:
        out = {}
    with _stats_lock:
        _stats_failed_at = None if out else time.monotonic()
    return out
