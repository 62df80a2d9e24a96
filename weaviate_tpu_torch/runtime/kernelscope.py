"""Kernelscope — the device-time plane (port of
``weaviate_tpu/runtime/kernelscope.py``). Four faces:

1. **Per-dispatch device time without a host sync.** The transfer
   pipeline's drain thread blocks on each handle's copy to the host
   anyway; the batcher stamps dispatch-submit before the device call and
   the drain thread stamps transfer-complete after ``handle.result()``.
   On the card the residency is the elapsed time of a pair of CUDA
   events the batcher's worker records around its launches, on the
   stream that runs them, taken from a small pool (:func:`start_timer`);
   the drain reads it after the wait it already made, so no new sync
   exists. The pair spans the stream from the dispatch's first launch to
   its last, so it also counts the host's gaps between launches and other
   threads' kernels interleaved on the shared stream: an upper bound of
   the dispatch's kernel time, as the JAX package's window is. On the
   CPU the residency is the JAX package's: the window
   minus the memcpy EWMA (fed by the sampled ``transfer.d2h`` split).
   Both are labelled ``source="drain"``; ``source="wall"`` is a sync
   path with no drain (the dispatch wall window). Residency feeds an
   EWMA + histogram per (index-kind, batch-bucket, k-bucket) variant and
   tailboard's per-request ``device`` phase.

2. **Per-query EXPLAIN.** ``?explain=true`` (REST) / ``x-explain``
   (gRPC metadata) installs a request-level sink; the batcher installs a
   dispatch-level sink around the engine call on its worker thread;
   engine layers call :func:`explain_note` with cheap host-side ints
   only. Explain never changes what is dispatched.

3. **Per-tenant device metering.** Each dispatch's residency is
   apportioned across the requests it coalesced into
   ``weaviate_tpu_device_seconds_total{collection, tenant}``.

4. **On-demand kernel profiles.** :func:`capture_profile` runs a
   ``torch.profiler`` capture (CUDA activity on the card), exports the
   chrome trace, ranks its device events by :data:`KERNEL_REGISTRY` and
   persists the last K captures under the data dir (``GET
   /v1/debug/profile?ms=N``).
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import functools
import glob
import json
import os
import tempfile
import threading
import time

from weaviate_tpu_torch.runtime.metrics import (
    device_seconds_total,
    dispatch_device_seconds,
)

# -- face 1: drain-stamp device timing ----------------------------------------

#: EWMA weight for both the memcpy estimator and the per-variant
#: residency — heavy enough to track a recompile, light enough that one
#: preempted drain doesn't whipsaw the estimate.
_ALPHA = 0.2

_lock = threading.Lock()
# memcpy seconds per pow2-bytes bucket (bucket = nbytes.bit_length()),
# plus a global fallback for result shapes never seen on a sampled trace
_memcpy_ewma: dict[int, float] = {}
_memcpy_global: float | None = None
_memcpy_samples = 0
# (kind, b_bucket, k_bucket) -> {"ewma_ms", "last_ms", "n", "source"}
_variants: dict[tuple[str, int, int], dict] = {}
_meters: dict[tuple[str, str], float] = {}
_total_device_s = 0.0
_dispatches = {"drain": 0, "wall": 0}


def _bytes_bucket(nbytes: int) -> int:
    return int(nbytes).bit_length()


def observe_memcpy(seconds: float, nbytes: int) -> None:
    """Feed the memcpy estimator from a sampled ``transfer.d2h`` where
    device wait (``block_until_ready``) and the host copy were timed
    separately — the only place the split is directly measurable."""
    if seconds < 0 or nbytes < 0:
        return
    global _memcpy_global, _memcpy_samples
    bucket = _bytes_bucket(nbytes)
    with _lock:
        prev = _memcpy_ewma.get(bucket)
        _memcpy_ewma[bucket] = (seconds if prev is None
                                else _ALPHA * seconds + (1 - _ALPHA) * prev)
        _memcpy_global = (seconds if _memcpy_global is None
                          else _ALPHA * seconds
                          + (1 - _ALPHA) * _memcpy_global)
        _memcpy_samples += 1


def memcpy_estimate(nbytes: int) -> float:
    """Best-available memcpy seconds for a result of ``nbytes``: the
    pow2-bucket EWMA, else the global EWMA, else 0.0 (no sampled trace
    has run yet — the full drain window attributes to device, which is
    the pre-kernelscope behavior, never worse)."""
    with _lock:
        est = _memcpy_ewma.get(_bytes_bucket(nbytes))
        if est is None:
            est = _memcpy_global
    return 0.0 if est is None else est


def attribute(window_s: float, nbytes: int) -> tuple[float, float]:
    """Split a drain window (dispatch-submit .. transfer-complete) into
    ``(device_s, memcpy_s)``. The memcpy estimate is clamped into the
    window so both parts stay non-negative and sum to the window."""
    window_s = max(0.0, window_s)
    memcpy_s = min(max(0.0, memcpy_estimate(nbytes)), window_s)
    return window_s - memcpy_s, memcpy_s


def result_nbytes(value) -> int:
    """Total bytes of the numpy arrays in a transferred result pytree
    (tuple/list nesting); non-arrays contribute 0."""
    if value is None:
        return 0
    if isinstance(value, (tuple, list)):
        return sum(result_nbytes(v) for v in value)
    return int(getattr(value, "nbytes", 0) or 0)


class _EventTimer:
    """One pooled pair of timing CUDA events around a dispatch's
    launches. ``stop`` records the end on the same stream; ``elapsed_s``
    reads the pair once the caller has waited past the end event (the
    drain's copy did), and raises if it has not: no host sync is added
    here, and a failed read is an error, never a fallback."""

    __slots__ = ("_pool", "_key", "start", "end", "_stream")

    def __init__(self, pool, key, start, end, stream):
        self._pool, self._key = pool, key
        self.start, self.end, self._stream = start, end, stream

    def stop(self) -> None:
        self.end.record(self._stream)

    def elapsed_s(self) -> float:
        return self.start.elapsed_time(self.end) / 1000.0

    def release(self) -> None:
        self._pool._put(self._key, self.start, self.end)


class _EventPool:
    """Pairs of ``enable_timing`` CUDA events reused across dispatches,
    per card. Pairs in use at once are bounded by the dispatches in
    flight (the transfer window), so the pool stays small."""

    def __init__(self):
        self._free: dict[int, list] = {}
        self._plock = threading.Lock()
        self.created = 0

    def _put(self, key: int, start, end) -> None:
        with self._plock:
            self._free.setdefault(key, []).append((start, end))

    def acquire(self, device) -> _EventTimer:
        import torch

        key = device.index if device.index is not None \
            else torch.cuda.current_device()
        with self._plock:
            free = self._free.setdefault(key, [])
            pair = free.pop() if free else None
            if pair is None:
                self.created += 1
        if pair is None:
            with torch.cuda.device(key):
                pair = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        stream = torch.cuda.current_stream(key)
        return _EventTimer(self, key, pair[0], pair[1], stream)


_event_pool = _EventPool()


def start_timer(device) -> _EventTimer | None:
    """Record the start of a dispatch's device residency on the calling
    thread's current stream of ``device``; None off the card (the CPU
    path attributes the drain window instead)."""
    if device is None or getattr(device, "type", "cpu") != "cuda":
        return None
    t = _event_pool.acquire(device)
    t.start.record(t._stream)
    return t


def record_dispatch(kind: str, b_bucket: int, k_bucket: int,
                    device_s: float, source: str = "drain") -> None:
    """One dispatch's attributed device residency for the (index-kind,
    batch-bucket, k-bucket) variant. ``source`` is ``drain`` (CUDA-event
    time on the card; drain-thread stamps minus memcpy EWMA on the CPU)
    or ``wall`` (a sync path with no drain: dispatch wall window)."""
    global _total_device_s
    device_s = max(0.0, device_s)
    key = (str(kind), int(b_bucket), int(k_bucket))
    with _lock:
        v = _variants.get(key)
        ms = device_s * 1000.0
        if v is None:
            _variants[key] = {"ewma_ms": ms, "last_ms": ms, "n": 1,
                              "source": source}
        else:
            v["ewma_ms"] = _ALPHA * ms + (1 - _ALPHA) * v["ewma_ms"]
            v["last_ms"] = ms
            v["n"] += 1
            v["source"] = source
        _total_device_s += device_s
        _dispatches[source] = _dispatches.get(source, 0) + 1
    try:
        dispatch_device_seconds.labels(
            key[0], str(key[1]), str(key[2]), source).observe(device_s)
    except Exception:
        pass


def apportion(device_s: float, weights: list[float]) -> list[float]:
    """Split one dispatch's residency across its coalesced requests,
    weighted (by rows scanned); degenerate weights split evenly. Shares
    sum exactly to ``device_s``."""
    n = len(weights)
    if n == 0:
        return []
    total = sum(w for w in weights if w > 0)
    if total <= 0:
        return [device_s / n] * n
    return [device_s * (max(w, 0.0) / total) for w in weights]


def meter(collection: str, tenant: str, device_s: float) -> None:
    """Accumulate attributed device seconds against a tenant — both the
    exported counter and an internal meter the accuracy check (sum of
    meters ~= total residency) reads back."""
    if device_s <= 0:
        return
    key = (str(collection or "-"), str(tenant or "-"))
    with _lock:
        _meters[key] = _meters.get(key, 0.0) + device_s
    try:
        device_seconds_total.labels(key[0], key[1]).inc(device_s)
    except Exception:
        pass


def total_device_seconds() -> float:
    with _lock:
        return _total_device_s


def meters_snapshot() -> dict[tuple[str, str], float]:
    with _lock:
        return dict(_meters)


# -- face 2: per-query EXPLAIN ------------------------------------------------

_explain_sink: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "kernelscope_explain_sink", default=None)


def explain_begin():
    """Install a fresh request-level explain sink on this thread;
    returns the reset token for :func:`explain_end`."""
    return _explain_sink.set({})


def explain_end(token) -> dict:
    plan = _explain_sink.get() or {}
    _explain_sink.reset(token)
    return plan


def explain_enabled() -> bool:
    return _explain_sink.get() is not None


@contextlib.contextmanager
def explain_scope(sink: dict):
    """Install ``sink`` as the ambient explain sink for the duration —
    how the batcher's worker thread captures engine notes for one
    dispatch without touching the request thread's sink."""
    token = _explain_sink.set(sink)
    try:
        yield sink
    finally:
        _explain_sink.reset(token)


def explain_note(section: str, **fields) -> None:
    """Record host-side plan facts under ``section`` in the ambient
    sink; a no-op (one contextvar read) when nobody asked to explain.
    Emission sites in ``engine/`` must pass plain host ints/strings —
    graftlint G5 pins that no device function feeds an argument."""
    sink = _explain_sink.get()
    if sink is None:
        return
    sec = sink.get(section)
    if sec is None:
        sink[section] = dict(fields)
    else:
        sec.update(fields)


def merge_plan(into: dict, plan: dict | None) -> None:
    """Fold a dispatch-level plan into a request-level sink, section by
    section (a multi-shard request keeps the last shard's engine
    sections; the batcher section is per-dispatch by construction)."""
    if not plan:
        return
    for section, fields in plan.items():
        if isinstance(fields, dict):
            cur = into.get(section)
            if isinstance(cur, dict):
                cur.update(fields)
            else:
                into[section] = dict(fields)
        else:
            into[section] = fields


def merge_into_request(plan: dict | None) -> None:
    sink = _explain_sink.get()
    if sink is None or not plan:
        return
    merge_plan(sink, plan)


# -- face 4: on-demand kernel profiles ----------------------------------------

#: friendly kernel name -> substrings matched (case-insensitive) against
#: trace event names, in order: the first match wins. The JAX package's
#: seven names, matched against the port's kernel symbols
#: (``csrc/*.cu``: ``<name>_kernel``, ``bq_scan_tc_kernel``,
#: ``bq_tc_kernel``, ``pq4_recon_tc_kernel`` / ``_ffma_kernel``) and
#: torch's library kernels (cuBLAS ``gemm`` / ``gemv`` for a matmul scan,
#: ``sbtopk`` / ``mbtopk`` for ``torch.topk``), plus ``bm25_block``.
#: ``fused_topk_pairs`` comes before ``fused_topk``: it is the survivor
#: merge, not the scan.
KERNEL_REGISTRY: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("merge_epoch_topk", ("fused_topk_pairs",)),
    ("fused_topk_scan", ("fused_topk",)),
    ("bq_scan_reduce", ("bq_scan", "bq_mxu", "bq_hamming", "bq_tc_kernel")),
    ("pq4_scan_reduce", ("pq4_scan", "pq4_lut", "pq4_recon")),
    ("bm25_block", ("bm25",)),
    ("ivf_probe", ("ivf_probe", "ivf_", "centroid")),
    ("gather_rescore_topk", ("gather_rescore", "shared_candidates",
                             "rescore")),
    ("merge_epoch_topk", ("merge_epoch", "merge_topk", "top_k", "topk",
                          "kthvalue")),
    ("distance_block", ("distance_block", "pairwise", "epoch_scan", "gemm",
                        "gemv")),
)

#: each launch counter of ``ops/kernels.py`` -> the friendly name its
#: kernels classify to
KERNEL_FRIENDLY = {
    "distance_block": "distance_block",
    "fused_topk_scan": "fused_topk_scan",
    "fused_topk_pairs": "merge_epoch_topk",
    "bq_scan_reduce": "bq_scan_reduce",
    "bq_mxu_block": "bq_scan_reduce",
    "bq_hamming_block": "bq_scan_reduce",
    "pq4_scan_reduce": "pq4_scan_reduce",
    "pq4_lut_block": "pq4_scan_reduce",
    "pq4_recon_block": "pq4_scan_reduce",
    "bm25_block": "bm25_block",
}

#: chrome-trace categories of device activity in a torch.profiler export
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: True while a capture runs: the port's kernel wrappers then open a
#: ``record_function`` range named after their kernel (``kernel_span``),
#: so the torch operators a wrapper launches around its kernel (query
#: preparation, the running top-k's glue) count under that kernel's name,
#: as an XLA trace names the fused ops of a jitted function after it
_spans_on = False


def kernel_span(name: str):
    """Decorator for a port function whose device work should count under
    ``name`` in a capture. Outside a capture: one module flag read."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _spans_on:
                return fn(*args, **kwargs)
            import torch

            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def attribute_to_spans(events) -> list:
    """Name each unclassified event of a torch.profiler export after the
    innermost ``kernel_span`` range it was launched from: a device event
    through its launch (``correlation`` -> the ``cuda_runtime`` call, or
    ``External id`` -> the operator), a CPU operator through its own
    thread and start. A classified event (a port kernel, a cuBLAS gemm)
    keeps its name. Returns new event dicts; the input is not changed."""
    spans: dict = {}
    launches: dict = {}
    ops: dict = {}
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        ts = float(e.get("ts", 0) or 0)
        if cat == "user_annotation":
            spans.setdefault(e.get("tid"), []).append(
                (ts, ts + float(e.get("dur", 0) or 0), str(e.get("name", ""))))
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), ts)
        if cat in ("cpu_op", "user_annotation") and "External id" in args:
            ops.setdefault(args["External id"], (e.get("tid"), ts))
    for v in spans.values():
        v.sort()
    starts = {tid: [s[0] for s in v] for tid, v in spans.items()}

    def innermost(tid, ts):
        v = spans.get(tid)
        if not v:
            return None
        i = bisect.bisect_right(starts[tid], ts)
        for j in range(i - 1, max(-1, i - 65), -1):
            if v[j][1] >= ts:  # the latest-starting range still open
                return v[j][2]
        return None

    out = []
    for e in events:
        if not isinstance(e, dict):
            continue
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and e.get("cat") != "user_annotation" \
                and classify_kernel(name) == "other":
            args = e.get("args") or {}
            if e.get("cat") in DEVICE_CATEGORIES:
                anchor = launches.get(args.get("correlation")) or \
                    ops.get(args.get("External id"))
            else:
                anchor = (e.get("tid"), float(e.get("ts", 0) or 0))
            span = innermost(*anchor) if anchor else None
            if span is not None:
                e = dict(e, name=f"{span}: {name}")
        out.append(e)
    return out

_data_dir: str | None = None
_keep = 8
_capturer = None  # injectable trace capturer for tests (ms -> events)
_capture_seq = 0
_device = None  # the device captures trace; None = the card
# one torch.profiler session per process: a second capture while one
# runs raises, as a second jax.profiler.start_trace does
_capture_busy = threading.Lock()


def configure(data_dir: str | None = None, keep: int | None = None,
              capturer=None, device=None) -> None:
    """Server wiring: where captures persist (``<data_dir>/kernelscope``),
    how many to keep, and the device they trace (the server's).
    ``capturer`` overrides the torch.profiler capture (tests inject
    synthetic trace events)."""
    global _data_dir, _keep, _capturer, _device
    if data_dir is not None:
        _data_dir = str(data_dir)
    if keep is not None:
        _keep = max(1, int(keep))
    if capturer is not None:
        _capturer = capturer
    if device is not None:
        _device = device


def classify_kernel(event_name: str) -> str:
    low = str(event_name).lower()
    for friendly, pats in KERNEL_REGISTRY:
        if any(p in low for p in pats):
            return friendly
    return "other"


def summarize_trace_events(events) -> dict:
    """Aggregate chrome-trace complete events (``ph == "X"``, ``dur`` in
    microseconds) into per-kernel device-ms ranked descending, with the
    top raw event names kept per kernel for drill-down."""
    by_kernel: dict[str, dict] = {}
    for ev in events or ():
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        name = str(ev.get("name", ""))
        dur_ms = float(ev.get("dur", 0) or 0) / 1000.0
        if dur_ms <= 0:
            continue
        k = classify_kernel(name)
        agg = by_kernel.setdefault(
            k, {"kernel": k, "device_ms": 0.0, "events": 0, "names": {}})
        agg["device_ms"] += dur_ms
        agg["events"] += 1
        agg["names"][name] = agg["names"].get(name, 0.0) + dur_ms
    kernels = []
    for agg in by_kernel.values():
        top = sorted(agg.pop("names").items(), key=lambda kv: -kv[1])[:5]
        agg["device_ms"] = round(agg["device_ms"], 3)
        agg["top_events"] = [{"name": n, "device_ms": round(ms, 3)}
                             for n, ms in top]
        kernels.append(agg)
    kernels.sort(key=lambda a: -a["device_ms"])
    return {"kernels": kernels,
            "total_device_ms": round(sum(a["device_ms"] for a in kernels),
                                     3)}


def _torch_capture(ms: int):
    """Programmatic torch.profiler capture of ``ms``: the chrome-trace
    events of the device activity (on the card: kernels, copies, sets,
    from every thread of the process — CUDA activity is traced
    process-wide) or, on the CPU, the operators of every thread, each
    named after the ``kernel_span`` it ran in (``attribute_to_spans``).
    A second capture while one runs raises. On the card a capture that
    cannot trace CUDA raises instead of answering with host events."""
    global _spans_on
    import torch
    from torch.profiler import ProfilerActivity, profile

    from weaviate_tpu_torch.device import resolve

    dev = resolve(_device)
    on_card = dev.type == "cuda"
    if on_card and not torch.profiler.kineto_available():
        raise RuntimeError("torch.profiler has no kineto: no CUDA trace")
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    kwargs = {}
    try:
        from torch._C._profiler import _ExperimentalConfig

        # the batcher's worker, not the asking thread, runs the operators
        kwargs["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    if not _capture_busy.acquire(blocking=False):
        raise RuntimeError("a profile capture is already running")
    try:
        with tempfile.TemporaryDirectory(prefix="kernelscope-") as td:
            with profile(activities=activities, **kwargs) as prof:
                _spans_on = True
                try:
                    time.sleep(max(0, int(ms)) / 1000.0)
                finally:
                    _spans_on = False
            path = os.path.join(td, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
    finally:
        _capture_busy.release()
    evs = doc.get("traceEvents") if isinstance(doc, dict) else doc
    evs = attribute_to_spans([e for e in (evs or ()) if isinstance(e, dict)])
    if on_card:
        return [e for e in evs if e.get("cat") in DEVICE_CATEGORIES]
    return [e for e in evs if e.get("cat") == "cpu_op"]


def _capture_dir() -> str | None:
    if not _data_dir:
        return None
    d = os.path.join(_data_dir, "kernelscope")
    os.makedirs(d, exist_ok=True)
    return d


def capture_profile(ms: int, capturer=None) -> dict:
    """One on-demand profile: capture ``ms`` of device activity, rank it
    by kernel, persist the capture (pruning past the configured K)."""
    global _capture_seq
    cap = capturer or _capturer or _torch_capture
    t_wall = time.time()
    events = cap(int(ms))
    summary = summarize_trace_events(events)
    with _lock:
        _capture_seq += 1
        seq = _capture_seq
    record = {"id": f"cap-{int(t_wall)}-{seq}", "ms": int(ms),
              "captured_at": round(t_wall, 3),
              "raw_events": len(events or ()), **summary}
    d = _capture_dir()
    if d is not None:
        try:
            path = os.path.join(d, record["id"] + ".json")
            with open(path, "w") as f:
                json.dump(record, f, indent=1, sort_keys=True)
            kept = sorted(glob.glob(os.path.join(d, "cap-*.json")),
                          key=os.path.getmtime)
            for stale in kept[:-_keep]:
                try:
                    os.remove(stale)
                except OSError:
                    pass
        except Exception:
            pass  # persistence is best-effort; the capture still returns
    return record


def list_captures() -> list[dict]:
    """Persisted captures, newest first (summary fields only — the
    paramless ``/v1/debug/profile`` response; never triggers a trace)."""
    d = _capture_dir()
    if d is None:
        return []
    out = []
    for path in sorted(glob.glob(os.path.join(d, "cap-*.json")),
                       key=os.path.getmtime, reverse=True):
        try:
            with open(path) as f:
                rec = json.load(f)
        except Exception:
            continue
        out.append({"id": rec.get("id"), "ms": rec.get("ms"),
                    "captured_at": rec.get("captured_at"),
                    "total_device_ms": rec.get("total_device_ms"),
                    "kernels": [k.get("kernel")
                                for k in rec.get("kernels", ())]})
    return out


def load_capture(capture_id: str) -> dict | None:
    d = _capture_dir()
    if d is None:
        return None
    path = os.path.join(d, os.path.basename(str(capture_id)))
    if not path.endswith(".json"):
        path += ".json"
    try:
        with open(path) as f:
            return json.load(f)
    except Exception:
        return None


# -- snapshot / reset ---------------------------------------------------------

def snapshot() -> dict:
    """Kernelscope state for ``/v1/debug/kernelscope``: per-variant
    residency EWMAs, the memcpy estimator, per-tenant meters, totals.
    The debug route's description also documents the ``?explain=true``
    flag this module serves."""
    with _lock:
        variants = {f"{k[0]}/b{k[1]}/k{k[2]}":
                    {kk: (round(vv, 4) if isinstance(vv, float) else vv)
                     for kk, vv in v.items()}
                    for k, v in sorted(_variants.items())}
        memcpy = {"samples": _memcpy_samples,
                  "global_us": (None if _memcpy_global is None
                                else round(_memcpy_global * 1e6, 2)),
                  "buckets": {str(b): round(s * 1e6, 2)
                              for b, s in sorted(_memcpy_ewma.items())}}
        meters = {f"{c}/{t}": round(s, 6)
                  for (c, t), s in sorted(_meters.items())}
        total = _total_device_s
        disp = dict(_dispatches)
    return {"variants": variants, "memcpy": memcpy, "meters": meters,
            "total_device_seconds": round(total, 6),
            "dispatches": disp, "cuda_event_pairs": _event_pool.created,
            "captures": len(list_captures())}


def reset_for_tests() -> None:
    """Drop all EWMA/meter/explain/capture state (conftest autouse —
    per-tenant meters leaking across tests would break the metering
    accuracy assertions)."""
    global _memcpy_global, _memcpy_samples, _total_device_s
    global _data_dir, _keep, _capturer, _capture_seq, _device
    with _lock:
        _memcpy_ewma.clear()
        _memcpy_global = None
        _memcpy_samples = 0
        _variants.clear()
        _meters.clear()
        _total_device_s = 0.0
        _dispatches.clear()
        _dispatches.update({"drain": 0, "wall": 0})
        _capture_seq = 0
    _data_dir = None
    _keep = 8
    _capturer = None
    _device = None
