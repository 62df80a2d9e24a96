"""Recovery observability: what every bucket open found and repaired.

A crash-recovery story is only trustworthy if recovery is VISIBLE: a
bucket that silently truncated a torn WAL tail looks identical to one
that opened clean, and a quarantined segment is data loss an operator
must hear about. Every ``Bucket.__init__`` files a
:class:`BucketRecovery` here; the registry feeds three surfaces:

- a log line at open (WARNING when anything was repaired/quarantined,
  DEBUG when clean),
- the ``weaviate_tpu_recovery_*`` counters (incremented by each open's
  findings, labeled by bucket),
- ``GET /v1/debug/storage`` (api/rest.py), which reports the registry
  snapshot plus rollup totals — the crashtest harness asserts its
  post-restart report is non-empty here.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import asdict, dataclass, field

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_reports: dict[str, "BucketRecovery"] = {}


@dataclass
class BucketRecovery:
    """One bucket open's recovery findings (all zero = opened clean)."""

    bucket: str                      # collection/shard/bucket label
    wal_files_replayed: int = 0      # WAL files found at open
    frames_replayed: int = 0         # intact frames re-applied
    bytes_truncated: int = 0         # torn-tail bytes dropped
    wals_quarantined: int = 0        # WALs renamed .corrupt (mid-file damage)
    segments_quarantined: int = 0    # segments renamed .corrupt at open
    segments_recovered: int = 0      # segments written from replayed WALs
    quarantined_files: list[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return (self.frames_replayed == 0 and self.bytes_truncated == 0
                and self.wals_quarantined == 0
                and self.segments_quarantined == 0)

    def to_dict(self) -> dict:
        d = asdict(self)
        d["clean"] = self.clean
        return d


def record(report: BucketRecovery) -> None:
    """File one bucket open's findings: registry + counters + log."""
    with _lock:
        _reports[report.bucket] = report
    try:
        from weaviate_tpu_torch.runtime import metrics as _m

        if report.frames_replayed:
            _m.recovery_frames_replayed.labels(report.bucket).inc(
                report.frames_replayed)
        if report.bytes_truncated:
            _m.recovery_bytes_truncated.labels(report.bucket).inc(
                report.bytes_truncated)
        if report.wals_quarantined:
            _m.recovery_wals_quarantined.labels(report.bucket).inc(
                report.wals_quarantined)
        if report.segments_quarantined:
            _m.recovery_segments_quarantined.labels(report.bucket).inc(
                report.segments_quarantined)
        if report.segments_recovered:
            _m.recovery_segments_recovered.labels(report.bucket).inc(
                report.segments_recovered)
    except Exception:  # pragma: no cover — registry unavailable
        pass
    if report.clean:
        logger.debug("bucket %s: opened clean", report.bucket)
    else:
        logger.warning(
            "bucket %s: recovery at open — %d frames replayed from %d "
            "WALs (%d segments written), %d torn-tail bytes truncated, "
            "%d WALs + %d segments quarantined%s",
            report.bucket, report.frames_replayed,
            report.wal_files_replayed, report.segments_recovered,
            report.bytes_truncated, report.wals_quarantined,
            report.segments_quarantined,
            f" ({', '.join(report.quarantined_files)})"
            if report.quarantined_files else "")


def snapshot() -> dict:
    """The /v1/debug/storage payload: per-bucket reports + totals."""
    with _lock:
        reports = [r.to_dict() for r in _reports.values()]
    reports.sort(key=lambda r: r["bucket"])
    totals = {
        k: sum(r[k] for r in reports)
        for k in ("wal_files_replayed", "frames_replayed",
                  "bytes_truncated", "wals_quarantined",
                  "segments_quarantined", "segments_recovered")
    }
    totals["buckets"] = len(reports)
    totals["buckets_recovered"] = sum(1 for r in reports if not r["clean"])
    return {"totals": totals, "buckets": reports}


def reset() -> None:
    """Test isolation: forget every filed report."""
    with _lock:
        _reports.clear()
