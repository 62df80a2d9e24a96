"""Last benchkeeper gate verdict, surfaced from the serving process.

The perf gate (tools/benchkeeper) runs out-of-process — usually in CI
or on the bench rig — and persists its verdict JSON artifact
(``last_verdict.json`` next to the baseline, or wherever
``BENCHKEEPER_VERDICT_PATH`` points). This module is the in-process
read side: ``GET /v1/debug/perf`` serves the verdict plus per-entry
trend deltas, and every load republishes the ``weaviate_tpu_bench_*``
gauges so regressions are visible from the same Prometheus surface as
the HBM ledger — not only to whoever happens to read the bench log.

Nothing here imports jax or benchkeeper; a node with no verdict on
disk reports that plainly instead of failing.
"""

from __future__ import annotations

import json
import os
import threading

_lock = threading.Lock()
_published_entries: set[tuple[str, str]] = set()  # (entry, unit) gauge keys
_refreshed: dict = {"path": None, "mtime": None}  # last published artifact


def verdict_path() -> str:
    """BENCHKEEPER_VERDICT_PATH, else the artifact next to the checked-in
    baseline (tools/benchkeeper/last_verdict.json in this checkout)."""
    env = os.environ.get("BENCHKEEPER_VERDICT_PATH")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "tools", "benchkeeper", "last_verdict.json")


def load_verdict(path: str | None = None) -> dict | None:
    """The persisted verdict dict, or None when absent/corrupt (a bad
    artifact must not break the debug surface reporting on it)."""
    path = path or verdict_path()
    try:
        with open(path) as f:
            v = json.load(f)
    except (OSError, ValueError):
        return None
    return v if isinstance(v, dict) and "entries" in v else None


def publish_metrics(verdict: dict) -> None:
    """Republish the weaviate_tpu_bench_* gauges from a verdict. Series
    for entries that vanished from the verdict are removed, not left
    exporting stale values (same discipline as the HBM ledger gauges)."""
    from weaviate_tpu_torch.runtime.metrics import (bench_delta_frac,
                                              bench_gate_ok,
                                              bench_gate_regressions,
                                              bench_gate_stale,
                                              bench_metric_value)

    with _lock:
        bench_gate_ok.set(1.0 if verdict.get("ok") else 0.0)
        bench_gate_regressions.set(float(verdict.get("regressions", 0)))
        bench_gate_stale.set(float(verdict.get("stale", 0)))
        live: set[tuple[str, str]] = set()
        for row in verdict.get("entries", ()):
            eid = str(row.get("id", ""))
            unit = str(row.get("unit", ""))
            if row.get("value") is not None:
                bench_metric_value.labels(eid, unit).set(
                    float(row["value"]))
                live.add((eid, unit))
            if row.get("delta_frac") is not None:
                bench_delta_frac.labels(eid).set(float(row["delta_frac"]))
        live_ids = {eid for eid, _ in live}
        for eid, unit in _published_entries - live:
            bench_metric_value.remove(eid, unit)
            # an entry whose unit merely changed is still live — only a
            # fully vanished entry drops its delta series
            if eid not in live_ids:
                bench_delta_frac.remove(eid)
        _published_entries.clear()
        _published_entries.update(live)


def refresh(path: str | None = None) -> None:
    """Republish the gauges from the on-disk verdict iff it changed
    since the last publish (mtime-cached). The metrics exposition
    handlers call this on every scrape, so a scrape-only Prometheus
    setup sees the verdict without anyone ever reading
    ``/v1/debug/perf``."""
    path = path or verdict_path()
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return
    if _refreshed["path"] == path and _refreshed["mtime"] == mtime:
        return
    verdict = load_verdict(path)
    # cache the mtime even when the artifact is corrupt — a truncated
    # file must not be re-parsed on every scrape until it changes
    _refreshed.update(path=path, mtime=mtime)
    if verdict is None:
        return
    publish_metrics(verdict)


def snapshot(path: str | None = None) -> dict:
    """The /v1/debug/perf payload: gate summary + per-entry trend rows.
    Loading also (re)publishes the gauges, so a scrape after the first
    debug read sees the same numbers."""
    verdict = load_verdict(path)
    if verdict is None:
        return {
            "verdict": None,
            "note": "no benchkeeper verdict recorded — run "
                    "`python -m tools.benchkeeper <BENCH_rNN.json>` "
                    "(or --smoke) to produce one",
            "verdictPath": path or verdict_path(),
        }
    try:
        publish_metrics(verdict)
    except Exception:  # metrics must never fail the debug surface
        pass
    trends = [{
        "id": r.get("id"),
        "section": r.get("section"),
        "metric": r.get("metric"),
        "kind": r.get("kind"),
        "unit": r.get("unit"),
        "status": r.get("status"),
        "baseline": r.get("baseline"),
        "value": r.get("value"),
        "deltaFrac": r.get("delta_frac"),
        "band": r.get("band"),
        "noise": r.get("noise") or {},
    } for r in verdict.get("entries", ())]
    return {
        "gate": {
            "ok": verdict.get("ok"),
            "refused": verdict.get("refused"),
            "checked": verdict.get("checked"),
            "passed": verdict.get("passed"),
            "regressions": verdict.get("regressions"),
            "stale": verdict.get("stale"),
            "missing": verdict.get("missing"),
            "generatedAt": verdict.get("generated_at"),
            "fingerprint": verdict.get("fingerprint"),
            "baselinePath": verdict.get("baseline_path"),
            "runs": verdict.get("runs"),
        },
        "trends": trends,
        "verdictPath": path or verdict_path(),
    }
