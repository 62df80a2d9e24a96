"""Driftwatch: online recall & perf drift detection (port of
``weaviate_tpu/runtime/driftwatch.py``).

Tracing, tailboard and kernelscope attribute what happened; driftwatch
watches for change. Three legs, all driven from one cyclemanager
callback, none inline with a request (no host sync on a serving path):

Leg 1 — serving-path canaries. Per vector index the shard registers a
canary: a small deterministic probe set (fixed-seed sample of the
shard's own corpus; ``WEAVIATE_TPU_DRIFT_SEED``) whose host-exact
ground truth is recomputed ONLY when the corpus epoch token changes.
Each cycle the probes run *through the real query batcher* — the same
coalescing, dispatch, faultline point and kernelscope attribution as
user traffic — measuring recall@10 against the sealed ground truth,
attributed device-ms (kernelscope residency delta over the probe window)
and queue_wait (wall minus residency). A recall drop or residency
excursion past its band is a typed finding.

Leg 2 — live telemetry drift. Kernelscope's per-(kind, B-bucket,
k-bucket) residency EWMAs, the memcpy EWMA, batcher overlap counters and
compile-cache events (the kernel build directory's hits and misses,
``runtime/compile_cache.py``) are folded into a synthetic bench-shaped
run and compared against a fingerprint-scoped benchkeeper baseline with
``tools.benchkeeper.core.compare`` — the same band math, verdict
statuses and cross-fingerprint REFUSAL as the CLI. The baseline is
explicit (``WEAVIATE_TPU_DRIFT_BASELINE``) or self-sealed from warm
telemetry and persisted to ``<data_dir>/driftwatch/live_baseline.json``.
The fingerprint names the torch version, the platform (``gpu`` or
``cpu``), the device name and the device count, so a baseline sealed on
another platform refuses the comparison. Only ``regression`` findings
flip health.

Leg 3 — verdict plane + forensics. ``GET /v1/debug/drift`` serves the
verdicts, trend deltas and canary history; gauges
``weaviate_tpu_drift_gate_ok`` / ``weaviate_tpu_drift_findings_total
{leg,kind}`` / ``weaviate_tpu_canary_recall{collection,shard}`` ride the
normal scrape. A finding flipping open marks ``drift:<leg>`` unhealthy
in the component-health registry and clears it when it closes. Every
cycle appends one JSONL record to a size-ringed history under
``<data_dir>/driftwatch/``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from collections import deque

import numpy as np

logger = logging.getLogger(__name__)

_lock = threading.RLock()

#: canary recall depth — recall@10 is the repo-wide quality metric
#: (bench flat_headline / ivf_ann gate on it too)
CANARY_K = 10

#: a variant whose EWMA sits more than this factor above its latest
#: sample is still decaying from a cold-compile dispatch (compile rides
#: the first timed window: 100-500x a steady sample, vs 2-3x run-to-run
#: wall noise) — sealing then would freeze the inflated level as the
#: band and mask every regression below it
_SEAL_CONVERGED_RATIO = 8.0

# -- config (lazy env reads, cached; configure()/reset_for_tests drop) --------

_enabled_cached: bool | None = None
_forced: bool | None = None
_data_dir: str | None = None
_interval_forced: float | None = None
_device = None  # the serving device the live fingerprint names


def _env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.lower() in ("true", "1", "on", "enabled")


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
    global _enabled_cached
    if _forced is not None:
        return _forced
    if _enabled_cached is None:
        _enabled_cached = _env_flag("WEAVIATE_TPU_DRIFTWATCH", True)
    return _enabled_cached


def interval_s() -> float:
    if _interval_forced is not None:
        return _interval_forced
    return _env_float("WEAVIATE_TPU_DRIFT_INTERVAL_S", 30.0)


def set_data_dir(path: str | None) -> None:
    """Follow the most recently opened database's data dir (the
    tailboard discipline) so embedded/test use gets on-disk history
    without Server wiring."""
    global _data_dir
    _data_dir = path


def set_device(device) -> None:
    """Follow the most recently opened database's device (the live
    fingerprint's platform and device name)."""
    global _device
    _device = device


def configure(data_dir: str | None = None, enabled: bool | None = None,
              interval: float | None = None) -> None:
    """Server-start wiring: pin the data dir (history ring + sealed
    baseline live under ``<data_dir>/driftwatch``), force enable/disable
    past the env default, override the cycle interval."""
    global _forced, _interval_forced
    if data_dir is not None:
        set_data_dir(data_dir)
    if enabled is not None:
        _forced = bool(enabled)
    if interval is not None:
        _interval_forced = float(interval)


def _seed() -> int:
    return _env_int("WEAVIATE_TPU_DRIFT_SEED", 1069)


def _probe_count() -> int:
    return max(1, _env_int("WEAVIATE_TPU_DRIFT_PROBES", 8))


def _recall_band() -> float:
    """ABSOLUTE recall@10 drop vs the sealed reference that opens a
    canary finding (recall is bounded in [0,1]; a fractional band of a
    0.99 reference would be numerically the same thing)."""
    return _env_float("WEAVIATE_TPU_DRIFT_RECALL_BAND", 0.05)


def _residency_band() -> float:
    """Fractional canary device-ms excursion vs the sealed reference.
    Wide by default: the probe window's kernelscope residency delta is
    shared with concurrent traffic."""
    return _env_float("WEAVIATE_TPU_DRIFT_RESIDENCY_BAND", 3.0)


def _live_band() -> float:
    """Band written into self-sealed live-baseline entries (an explicit
    WEAVIATE_TPU_DRIFT_BASELINE carries its own per-entry bands)."""
    return _env_float("WEAVIATE_TPU_DRIFT_LIVE_BAND", 0.75)


def _min_samples() -> int:
    return max(1, _env_int("WEAVIATE_TPU_DRIFT_MIN_SAMPLES", 3))


def _max_corpus_rows() -> int:
    """Host-exact ground truth is O(rows x dim) host BLAS per probe
    reseal; past this row count the canary marks itself skipped instead
    of burning the maintenance thread."""
    return _env_int("WEAVIATE_TPU_DRIFT_CANARY_MAX_ROWS", 262_144)


def _history_cap_bytes() -> int:
    return _env_int("WEAVIATE_TPU_DRIFT_HISTORY_BYTES", 4 * 1024 * 1024)


# -- leg 1: serving-path canaries ---------------------------------------------


class _Canary:
    """One registered probe target (a shard's vector space).

    ``search_fn(queries[P,d], k) -> list[np.ndarray] | None`` must route
    through the REAL query batcher; ``corpus_fn() -> (doc_ids[N],
    vectors[N,d]) | None`` returns host-resident truth vectors;
    ``epoch_token_fn() -> hashable`` changes iff the corpus changed;
    ``pairwise_fn(qs, vecs) -> [B,N]`` is the index's own host-exact
    distance (metric-correct ground truth without driftwatch knowing
    metrics)."""

    __slots__ = ("key", "collection", "shard", "search_fn", "corpus_fn",
                 "epoch_token_fn", "pairwise_fn", "token", "probe_ids",
                 "probe_vecs", "gt", "ref_recall", "ref_device_ms",
                 "skipped", "last", "history")

    def __init__(self, key, collection, shard, search_fn, corpus_fn,
                 epoch_token_fn, pairwise_fn):
        self.key = key
        self.collection = collection
        self.shard = shard
        self.search_fn = search_fn
        self.corpus_fn = corpus_fn
        self.epoch_token_fn = epoch_token_fn
        self.pairwise_fn = pairwise_fn
        self.token = None
        self.probe_ids = None   # np.int64 [P] — WHICH corpus rows probe
        self.probe_vecs = None  # np.float32 [P, d]
        self.gt = None          # list of np.int64 arrays (<=CANARY_K each)
        self.ref_recall = None
        self.ref_device_ms = None
        self.skipped: str | None = None
        self.last: dict | None = None
        self.history: deque = deque(maxlen=64)


_canaries: dict[str, _Canary] = {}


def register_canary(key: str, *, collection: str = "", shard: str = "",
                    search_fn, corpus_fn, epoch_token_fn,
                    pairwise_fn) -> None:
    """Idempotent (re)registration — a shard re-opening its index under
    the same key replaces the target and its sealed state."""
    with _lock:
        _canaries[key] = _Canary(key, collection, shard, search_fn,
                                 corpus_fn, epoch_token_fn, pairwise_fn)


def unregister_canaries(prefix: str) -> None:
    """Drop every canary whose key starts with ``prefix`` (shard close:
    ``<collection>/<shard>/``)."""
    with _lock:
        for k in [k for k in _canaries if k.startswith(prefix)]:
            del _canaries[k]


def _probe_rng(key: str) -> np.random.Generator:
    """Deterministic per-target RNG: the fixed seed XOR a stable hash of
    the key (zlib.crc32, NOT hash() — PYTHONHASHSEED would break the
    same-probe-set-across-restarts guarantee)."""
    return np.random.default_rng(
        (_seed() ^ zlib.crc32(key.encode())) & 0xFFFFFFFF)


def _seal_canary(c: _Canary, token) -> None:
    """Recompute probe set + host-exact ground truth. Called ONLY on
    corpus-epoch change (and first sight) — this is the one place
    driftwatch does O(corpus) host work, off the serving path."""
    c.token = token
    c.skipped = None
    c.gt = None
    c.ref_recall = None
    c.ref_device_ms = None
    corpus = c.corpus_fn()
    if corpus is None:
        c.skipped = "no host corpus (index without doc map or empty)"
        return
    ids, vecs = corpus
    ids = np.asarray(ids, dtype=np.int64)
    vecs = np.asarray(vecs, dtype=np.float32)
    n = len(ids)
    if n == 0:
        c.skipped = "empty corpus"
        return
    if n > _max_corpus_rows():
        c.skipped = (f"corpus {n} rows over WEAVIATE_TPU_DRIFT_CANARY_"
                     f"MAX_ROWS={_max_corpus_rows()} — host-exact ground "
                     "truth skipped")
        return
    rng = _probe_rng(c.key)
    # sample over the SORTED id order so the probe set is a pure
    # function of (seed, key, corpus content) — never of insert order
    order = np.argsort(ids, kind="stable")
    sel = rng.choice(n, size=min(_probe_count(), n), replace=False)
    sel = np.sort(sel)
    rows = order[sel]
    c.probe_ids = ids[rows]
    c.probe_vecs = vecs[rows]
    k = min(CANARY_K, n)
    d = np.asarray(c.pairwise_fn(c.probe_vecs, vecs), dtype=np.float64)
    top = np.argsort(d, axis=1, kind="stable")[:, :k]
    c.gt = [ids[top[i]] for i in range(len(rows))]


def _run_canary(c: _Canary) -> tuple[dict, list[dict]]:
    """One canary cycle: reseal on epoch change, run probes through the
    serving batcher, classify. Returns (cycle record, findings)."""
    try:
        token = c.epoch_token_fn()
    except Exception as e:  # a closing shard must not kill the cycle
        return {"key": c.key, "skipped": f"epoch token failed: {e}"}, []
    if c.gt is None or token != c.token:
        try:
            _seal_canary(c, token)
        except Exception as e:
            c.skipped = f"ground-truth seal failed: {e}"
    rec = {"key": c.key, "collection": c.collection, "shard": c.shard}
    if c.skipped is not None:
        rec["skipped"] = c.skipped
        return rec, []

    from weaviate_tpu_torch.runtime import kernelscope

    dev0 = kernelscope.total_device_seconds()
    t0 = time.perf_counter()
    try:
        got = c.search_fn(c.probe_vecs, CANARY_K)
    except Exception as e:
        rec["skipped"] = f"probe search failed: {e}"
        return rec, []
    wall_ms = (time.perf_counter() - t0) * 1000.0
    device_ms = max(
        0.0, (kernelscope.total_device_seconds() - dev0) * 1000.0)
    if got is None:
        rec["skipped"] = "index has no batched serving path"
        return rec, []
    hits = 0
    denom = 0
    for want, have in zip(c.gt, got):
        want_set = set(np.asarray(want).tolist())
        have_ids = set(np.asarray(have)[:CANARY_K].tolist())
        hits += len(want_set & have_ids)
        denom += len(want_set)
    recall = (hits / denom) if denom else 0.0
    queue_wait_ms = max(0.0, wall_ms - device_ms)
    if c.ref_recall is None:
        # reference sealed at the first run after a ground-truth
        # (re)compute: the canary watches for CHANGE from here on
        c.ref_recall = recall
        c.ref_device_ms = device_ms
    rec.update(recall=round(recall, 4), ref_recall=round(c.ref_recall, 4),
               wall_ms=round(wall_ms, 3), device_ms=round(device_ms, 3),
               ref_device_ms=round(c.ref_device_ms, 3),
               queue_wait_ms=round(queue_wait_ms, 3),
               probes=len(c.gt))
    findings = []
    drop = c.ref_recall - recall
    if drop > _recall_band():
        findings.append({
            "key": f"canary:{c.key}:recall", "leg": "canary",
            "kind": "recall", "flips_health": True,
            "value": round(recall, 4), "baseline": round(c.ref_recall, 4),
            "delta_frac": round(drop, 4),
            "reason": (f"canary recall@{CANARY_K} dropped {drop:.3f} "
                       f"below the sealed reference {c.ref_recall:.3f} "
                       f"(band {_recall_band():.3f}) — answers degraded "
                       "on the live serving path"),
        })
    # same normalized-delta band math as benchkeeper (direction
    # "lower": positive delta = regressing)
    if c.ref_device_ms > 1e-6:
        delta = (device_ms - c.ref_device_ms) / c.ref_device_ms
        if delta > _residency_band():
            findings.append({
                "key": f"canary:{c.key}:residency", "leg": "canary",
                "kind": "residency", "flips_health": True,
                "value": round(device_ms, 3),
                "baseline": round(c.ref_device_ms, 3),
                "delta_frac": round(delta, 4),
                "reason": (f"canary probe residency {device_ms:.2f}ms "
                           f"regressed {delta * 100:.0f}% beyond the ±"
                           f"{_residency_band() * 100:.0f}% band vs the "
                           f"sealed {c.ref_device_ms:.2f}ms reference"),
            })
    c.last = rec
    c.history.append({"t": time.time(), "recall": rec["recall"],
                      "device_ms": rec["device_ms"],
                      "queue_wait_ms": rec["queue_wait_ms"]})
    return rec, findings


# -- leg 2: live telemetry vs benchkeeper bands -------------------------------

_live_baseline: dict | None = None
_live_baseline_source: str | None = None
_live_baseline_error: str | None = None
_prev_counters: dict[str, float] = {}
_last_verdict: dict | None = None


def live_fingerprint() -> dict:
    """The environment this node's live telemetry was measured in — the
    same keys benchkeeper baselines name, so a baseline sealed on a TPU
    or on the CPU REFUSES comparison on the card instead of gating
    noise: the torch version, the platform (``gpu`` when the serving
    device is a CUDA card, else ``cpu``), the device name and count."""
    try:
        import torch

        dev = _device
        if dev is None:
            dev = "cuda" if torch.cuda.is_available() else "cpu"
        dev = torch.device(dev)
        if dev.type == "cuda":
            return {"torch": torch.__version__, "platform": "gpu",
                    "device_name": torch.cuda.get_device_name(dev),
                    "device_count": torch.cuda.device_count()}
        import platform as _platform

        return {"torch": torch.__version__, "platform": "cpu",
                "device_name": _platform.machine() or "cpu",
                "device_count": 1}
    except Exception:
        return {"platform": "unknown"}


def _counter_value(child) -> float:
    try:
        return float(child.value)
    except Exception:
        return 0.0


def live_section() -> dict:
    """The synthetic bench section driftwatch classifies: kernelscope's
    per-variant residency EWMAs, the memcpy estimator, and per-cycle
    counter deltas (compile-cache misses, batcher overlap). Counter
    deltas are exported ``_p1`` (value + 1): benchkeeper refuses a
    zero reference value, and the quiet steady state IS zero."""
    from weaviate_tpu_torch.runtime import kernelscope
    from weaviate_tpu_torch.runtime.metrics import (batcher_overlapped,
                                              compile_cache_events)

    ks = kernelscope.snapshot()
    residency = {variant: {"ewma_ms": v.get("ewma_ms"),
                           "last_ms": v.get("last_ms"),
                           "n": v.get("n"), "source": v.get("source")}
                 for variant, v in ks["variants"].items()}
    sec: dict = {"residency": residency,
                 "dispatches": ks.get("dispatches", {})}
    g_us = ks["memcpy"].get("global_us")
    if g_us is not None:
        sec["memcpy"] = {"global_us": g_us,
                         "samples": ks["memcpy"].get("samples")}
    miss_total = _counter_value(compile_cache_events.labels("miss"))
    overlap_total = _counter_value(batcher_overlapped.labels())
    with _lock:
        miss_delta = miss_total - _prev_counters.get("compile_miss", 0.0)
        overlap_delta = overlap_total - _prev_counters.get("overlap", 0.0)
        _prev_counters["compile_miss"] = miss_total
        _prev_counters["overlap"] = overlap_total
    sec["counters"] = {
        "compile_miss_total": miss_total,
        "overlap_total": overlap_total,
        "compile_miss_per_cycle_p1": max(0.0, miss_delta) + 1.0,
        "overlap_per_cycle_p1": max(0.0, overlap_delta) + 1.0,
    }
    return sec


def seal_live_baseline(section: dict, fingerprint: dict) -> dict | None:
    """Self-seal a benchkeeper-shaped baseline from the current live
    telemetry: one ``kind: device`` entry per residency variant with
    enough samples, the memcpy level, and the compile-storm detector.
    Returns None when nothing is warm enough to seal yet."""
    entries = []
    for variant, v in sorted(section.get("residency", {}).items()):
        ewma = v.get("ewma_ms")
        if (v.get("n") or 0) < _min_samples() or not ewma \
                or ewma <= 1e-6:
            continue
        last = v.get("last_ms")
        if last and float(ewma) > float(last) * _SEAL_CONVERGED_RATIO:
            continue
        entries.append({
            "id": f"live.residency.{variant}",
            "section": "live",
            "metric": f"residency.{variant}.ewma_ms",
            "value": round(float(ewma), 4), "band": _live_band(),
            "direction": "lower", "kind": "device", "unit": "ms",
            "reason": (f"self-sealed residency EWMA for dispatch variant "
                       f"{variant} after {v.get('n')} dispatches — a "
                       "drift past the band is a kernel/runtime "
                       "regression on the live serving path"),
        })
    if not entries:
        return None
    g_us = (section.get("memcpy") or {}).get("global_us")
    if g_us:
        entries.append({
            "id": "live.memcpy.global_us",
            "section": "live", "metric": "memcpy.global_us",
            "value": round(float(g_us), 2), "band": _live_band(),
            "direction": "lower", "kind": "device", "unit": "us",
            "reason": "self-sealed sampled-memcpy EWMA — a drift means "
                      "device-to-host copy cost moved (a link change or "
                      "an attribution bug), which skews every CPU "
                      "drain-source residency number",
        })
    entries.append({
        "id": "live.compile_miss_per_cycle",
        "section": "live",
        "metric": "counters.compile_miss_per_cycle_p1",
        "value": 1.0, "band": 2.0,
        "direction": "lower", "kind": "wall", "unit": "events",
        "reason": "compile-storm detector: steady state builds "
                  "nothing per cycle (p1 metric = misses + 1, benchkeeper "
                  "refuses a zero reference). More than two kernel "
                  "build-cache misses in one cycle means the build "
                  "directory is gone or a source changed — each miss is "
                  "an nvcc build on the serving thread",
    })
    return {
        "notes": "self-sealed by runtime/driftwatch.py from live "
                 "telemetry — replayable offline via python -m "
                 "tools.driftwatch",
        "sealed_at": time.time(),
        "fingerprint": {k: fingerprint[k]
                        for k in ("platform", "torch", "device_name")
                        if k in fingerprint},
        "entries": entries,
    }


def _baseline_dir() -> str | None:
    return os.path.join(_data_dir, "driftwatch") if _data_dir else None


def _sealed_baseline_path() -> str | None:
    d = _baseline_dir()
    return os.path.join(d, "live_baseline.json") if d else None


def _ensure_live_baseline(section: dict, fingerprint: dict):
    """Resolve the live-leg baseline: explicit env path > previously
    sealed on-disk file > seal now from warm telemetry. Validation and
    persistence both reuse benchkeeper's code."""
    global _live_baseline, _live_baseline_source, _live_baseline_error
    with _lock:
        if _live_baseline is not None:
            return _live_baseline
    from tools.benchkeeper import core as bk

    env_path = os.environ.get("WEAVIATE_TPU_DRIFT_BASELINE", "")
    if env_path:
        try:
            base = bk.load_baseline(env_path)
            src, err = f"env:{env_path}", None
        except bk.BaselineError as e:
            base, src, err = None, None, str(e)
    else:
        base, src, err = None, None, None
        path = _sealed_baseline_path()
        if path and os.path.exists(path):
            try:
                base = bk.load_baseline(path)
                src = f"sealed:{path}"
            except bk.BaselineError as e:
                err = str(e)  # corrupt seal: reseal below
        if base is None:
            sealed = seal_live_baseline(section, fingerprint)
            if sealed is not None:
                try:
                    bk.validate_baseline(sealed, "<driftwatch-seal>")
                except bk.BaselineError as e:
                    sealed, err = None, str(e)
            if sealed is not None:
                base, src, err = sealed, "sealed:memory", None
                if path:
                    try:
                        bk._atomic_write_json(path, sealed)
                        src = f"sealed:{path}"
                    except OSError:
                        pass  # memory seal still classifies
    with _lock:
        _live_baseline = base
        _live_baseline_source = src
        _live_baseline_error = err
    return base


def classify_live(section: dict, baseline: dict,
                  fingerprint: dict | None = None) -> dict:
    """Classify one live-telemetry section against a benchkeeper
    baseline — literally ``tools.benchkeeper.core.compare`` on a
    synthetic one-section run, so verdict statuses and the
    cross-fingerprint refusal are benchkeeper's own (the parity the
    tests pin)."""
    from tools.benchkeeper import core as bk

    run = {"env_fingerprint": fingerprint or live_fingerprint(),
           "sections": {"live": section}}
    return bk.compare(run, baseline)


def _live_findings(verdict: dict) -> list[dict]:
    """Typed findings from a live verdict. Only ``regression`` flips
    health (see the module docstring for why stale/missing do not)."""
    out = []
    if verdict.get("refused"):
        out.append({
            "key": "live:fingerprint:refused", "leg": "live",
            "kind": "refused", "flips_health": False,
            "reason": ("live comparison refused — "
                       + verdict["refused"]["reason"] + ": "
                       + "; ".join(verdict["refused"]["mismatched"])),
        })
        return out
    for row in verdict.get("entries", ()):
        status = row.get("status")
        if status in ("regression", "stale"):
            out.append({
                "key": f"live:{row['id']}:{status}", "leg": "live",
                "kind": status, "flips_health": status == "regression",
                "value": row.get("value"), "baseline": row.get("baseline"),
                "delta_frac": row.get("delta_frac"),
                "reason": row.get("gate_reason") or row.get("reason"),
            })
    return out


# -- leg 3: verdict plane, health flips, history ring -------------------------

_findings: dict[str, dict] = {}     # open findings, keyed by finding key
_health_flipped: set[str] = set()   # drift:<leg> components WE marked
_cycle_seq = 0
_last_cycle_t: float | None = None


def history_path() -> str | None:
    d = _baseline_dir()
    return os.path.join(d, "history.jsonl") if d else None


def _append_history(record: dict) -> None:
    """One JSONL line per cycle, size-ringed: past the byte cap the file
    rotates to ``history.jsonl.1`` (one generation) so the ring is
    durable without growing without bound."""
    path = history_path()
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            if os.path.getsize(path) > _history_cap_bytes():
                os.replace(path, path + ".1")
        except OSError:
            pass
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")
    except OSError:
        pass  # forensics must never fail the cycle


def _publish_gauges(gate_ok: bool) -> None:
    try:
        from weaviate_tpu_torch.runtime.metrics import drift_gate_ok

        drift_gate_ok.set(1.0 if gate_ok else 0.0)
    except Exception:
        pass


def _publish_canary_recall(records: list[dict]) -> None:
    """weaviate_tpu_canary_recall{collection,shard}: the WORST recall
    across a shard's vector spaces this cycle (one series per shard)."""
    worst: dict[tuple[str, str], float] = {}
    for r in records:
        if "recall" not in r:
            continue
        key = (r.get("collection") or "-", r.get("shard") or "-")
        worst[key] = min(worst.get(key, 1.0), r["recall"])
    if not worst:
        return
    try:
        from weaviate_tpu_torch.runtime.metrics import canary_recall

        for (col, shard), rec in worst.items():
            canary_recall.labels(col, shard).set(rec)
    except Exception:
        pass


def _apply_findings(new: dict[str, dict]) -> bool:
    """Transition bookkeeping: count newly opened findings, flip/clear
    ``drift:<leg>`` component health (the flip triggers the tailboard
    flight-recorder snapshot through degrade's existing hook). Returns
    the gate verdict."""
    from weaviate_tpu_torch.runtime import degrade

    now = time.time()
    with _lock:
        opened = [f for k, f in new.items() if k not in _findings]
        for k, f in new.items():
            f["since"] = _findings[k]["since"] if k in _findings else now
        _findings.clear()
        _findings.update(new)
        flips = {}
        for f in new.values():
            if f.get("flips_health"):
                flips.setdefault(f["leg"], f["reason"])
        flipped = set(_health_flipped)
    if opened:
        try:
            from weaviate_tpu_torch.runtime.metrics import drift_findings_total

            for f in opened:
                drift_findings_total.labels(f["leg"], f["kind"]).inc()
        except Exception:
            pass
    for leg, reason in flips.items():
        degrade.mark_unhealthy(f"drift:{leg}", reason)
        with _lock:
            _health_flipped.add(f"drift:{leg}")
    for comp in flipped:
        if comp.removeprefix("drift:") not in flips:
            degrade.mark_healthy(comp)
            with _lock:
                _health_flipped.discard(comp)
    return not flips


def run_cycle() -> bool:
    """The cyclemanager callback (and the deterministic test entry):
    run every canary, classify live telemetry, apply findings, append
    the history record. Returns whether any leg produced work (False =
    disabled or nothing registered, letting the cycle back off)."""
    global _cycle_seq, _last_cycle_t, _last_verdict
    if not enabled():
        return False
    with _lock:
        targets = list(_canaries.values())
        _cycle_seq += 1
        seq = _cycle_seq
    canary_records: list[dict] = []
    new_findings: dict[str, dict] = {}
    for c in targets:
        rec, found = _run_canary(c)
        canary_records.append(rec)
        for f in found:
            new_findings[f["key"]] = f
    fp = live_fingerprint()
    section = live_section()
    verdict_summary = None
    classified = False
    try:
        baseline = _ensure_live_baseline(section, fp)
    except Exception as e:  # tools/ stripped from the install
        baseline = None
        with _lock:
            global _live_baseline_error
            _live_baseline_error = f"benchkeeper unavailable: {e}"
    if baseline is not None:
        verdict = classify_live(section, baseline, fp)
        classified = True
        with _lock:
            _last_verdict = verdict
        for f in _live_findings(verdict):
            new_findings[f["key"]] = f
        verdict_summary = {
            "ok": verdict["ok"],
            "refused": bool(verdict.get("refused")),
            "checked": verdict["checked"], "passed": verdict["passed"],
            "regressions": verdict["regressions"],
            "stale": verdict["stale"], "missing": verdict["missing"],
        }
    gate_ok = _apply_findings(new_findings)
    _publish_gauges(gate_ok)
    _publish_canary_recall(canary_records)
    with _lock:
        _last_cycle_t = time.time()
        findings_out = list(_findings.values())
    _append_history({
        "t": time.time(), "cycle": seq, "gate_ok": gate_ok,
        "fingerprint": fp,
        "canaries": canary_records,
        "live": {"metrics": section, "verdict": verdict_summary,
                 "baseline_source": _live_baseline_source},
        "findings": findings_out,
    })
    ran = bool(targets) or classified
    return ran


# -- debug / scrape surface ---------------------------------------------------


def snapshot() -> dict:
    """The ``GET /v1/debug/drift`` payload: gate verdict, open findings,
    per-entry trend deltas from the last live verdict, canary state +
    history, and where the forensics live."""
    with _lock:
        findings = [dict(f) for f in _findings.values()]
        verdict = _last_verdict
        canaries = {
            c.key: {
                "collection": c.collection, "shard": c.shard,
                "skipped": c.skipped,
                "probe_doc_ids": (None if c.probe_ids is None
                                  else c.probe_ids.tolist()),
                "epoch_token": (None if c.token is None
                                else str(c.token)),
                "ref_recall": c.ref_recall,
                "ref_device_ms": c.ref_device_ms,
                "last": c.last,
                "history": list(c.history),
            } for c in _canaries.values()}
        seq, last_t = _cycle_seq, _last_cycle_t
        src, err = _live_baseline_source, _live_baseline_error
    gate_ok = not any(f.get("flips_health") for f in findings)
    trends = []
    if verdict and not verdict.get("refused"):
        trends = [{"id": r["id"], "status": r.get("status"),
                   "value": r.get("value"), "baseline": r.get("baseline"),
                   "delta_frac": r.get("delta_frac"),
                   "band": r.get("band"), "unit": r.get("unit")}
                  for r in verdict.get("entries", ())]
    return {
        "enabled": enabled(),
        "cycle": seq,
        "lastCycleAt": last_t,
        "intervalS": interval_s(),
        "gateOk": gate_ok,
        "findings": findings,
        "canaries": canaries,
        "live": {
            "baselineSource": src,
            "baselineError": err,
            "refused": (verdict or {}).get("refused"),
            "trends": trends,
        },
        "historyPath": history_path(),
    }


def scrape_refresh() -> None:
    """Read-point hook for /v1/metrics: make the gate gauge truthful
    even before the first cycle (a node that never classified anything
    has no open findings — gate 1, not a default-0 false alarm)."""
    with _lock:
        findings = list(_findings.values())
    _publish_gauges(not any(f.get("flips_health") for f in findings))


# -- test isolation -----------------------------------------------------------


def reset_for_tests() -> None:
    """Drop every registration, sealed reference, finding and cached
    env read (conftest autouse — a sealed canary or an open drift
    finding leaking across tests would poison health assertions)."""
    global _enabled_cached, _forced, _data_dir, _interval_forced, _device
    global _live_baseline, _live_baseline_source, _live_baseline_error
    global _last_verdict, _cycle_seq, _last_cycle_t
    with _lock:
        _canaries.clear()
        _findings.clear()
        _health_flipped.clear()
        _prev_counters.clear()
        _enabled_cached = None
        _forced = None
        _data_dir = None
        _interval_forced = None
        _device = None
        _live_baseline = None
        _live_baseline_source = None
        _live_baseline_error = None
        _last_verdict = None
        _cycle_seq = 0
        _last_cycle_t = None
