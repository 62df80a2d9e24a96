"""Write-ahead log: CRC-framed append-only records with replay.

Reference: adapters/repos/db/lsmkv/commitlogger.go (memtable WAL) and
bucket_recover_from_wal.go (replay on open). Frame layout:

    u32 crc32(payload)   u32 len(payload)   payload

Recovery distinguishes two damage shapes (reference:
corrupt_commit_logs_fixer.go tells tail damage from body damage):

- **torn tail** — the final frame is partial (header or payload cut at
  EOF) or fails its CRC with nothing after it: the classic crash
  mid-append. Truncated to the last good frame, silently correct — the
  writer died before the append was acked.
- **mid-file corruption** — a frame fails its CRC with MORE intact
  bytes after it (bit rot, a torn sector inside the file). Truncating
  would silently discard every later, perfectly good frame, so the file
  is quarantined as ``.corrupt`` instead, the frames before the damage
  are kept, and the bucket keeps replaying its LATER WALs. The
  quarantine is surfaced (recovery report + counters), never silent.

A corrupted length field that points past EOF is indistinguishable from
a torn tail without heuristic resync, so it truncates (the conservative
read of "the file just ends here").

Durability ordering (see storage/fsutil.py for the rules): in sync
mode, a freshly-minted WAL's directory entry is fsynced before any
append is acked, and every append fsyncs before returning — the
``wal.append.pre_fsync`` / ``post_fsync`` / ``wal.create`` crashpoints
let tools/crashtest kill the process at each of those byte boundaries.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Iterator

from weaviate_tpu_torch.runtime import faultline
from weaviate_tpu_torch.storage import fsutil

logger = logging.getLogger(__name__)

_FRAME = struct.Struct("<II")


@dataclass
class ReplayReport:
    """What one WAL replay found — rolled up per bucket into the
    recovery report (storage/recovery.py) and the
    ``weaviate_tpu_recovery_*`` counters."""

    frames: int = 0            # intact frames yielded
    bytes_truncated: int = 0   # torn-tail bytes dropped
    quarantined: bool = False  # file renamed .corrupt (mid-file damage)


class WriteAheadLog:
    def __init__(self, path: str, sync: bool = False):
        self.path = path
        self.sync = sync
        self._lock = threading.Lock()
        parent = os.path.dirname(path) or "."
        os.makedirs(parent, exist_ok=True)
        existed = os.path.exists(path)
        self._f = open(path, "ab")
        if not existed:
            faultline.fire("wal.create", path=path)
            if sync:
                # the file's NAME must be durable before any acked frame
                # references it — else a crash can lose the whole WAL
                # while its appends were acked (fsutil rule 2)
                fsutil.fsync_dir(parent)

    def append(self, payload: bytes) -> None:
        frame = _FRAME.pack(zlib.crc32(payload) & 0xFFFFFFFF,
                            len(payload)) + payload
        with self._lock:
            # crash here = frame absent; torn = partial frame on disk
            fsutil.guarded_write(self._f, frame, "wal.append.pre_fsync",
                                 path=self.path)
            self._f.flush()
            if self.sync:
                os.fsync(self._f.fileno())
            # crash here = frame durable but the ack never returned —
            # the write may legally reappear after restart (idempotent
            # replay), it must never be REQUIRED to
            faultline.fire("wal.append.post_fsync", path=self.path)

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def size(self) -> int:
        with self._lock:
            return self._f.tell() if not self._f.closed else os.path.getsize(self.path)

    def reset(self) -> None:
        """Truncate after a successful flush (reference: WAL switch on
        memtable flush)."""
        with self._lock:
            self._f.close()
            self._f = open(self.path, "wb")
            self._f.flush()
            if self.sync:
                os.fsync(self._f.fileno())

    @classmethod
    def replay(cls, path: str,
               report: ReplayReport | None = None) -> Iterator[bytes]:
        """Yield intact payloads. Torn tails truncate; mid-file
        corruption quarantines the file as ``.corrupt`` (frames before
        the damage are still yielded). ``report``, when given, is
        filled in as replay progresses."""
        report = ReplayReport() if report is None else report
        if not os.path.exists(path):
            return
        good_end = 0
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off + _FRAME.size <= len(data):
            crc, ln = _FRAME.unpack_from(data, off)
            start = off + _FRAME.size
            if start + ln > len(data):
                break  # torn tail (payload, or a corrupt length, cut at EOF)
            payload = data[start : start + ln]
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                if start + ln < len(data):
                    # intact bytes FOLLOW the bad frame: not a crash
                    # artifact but body corruption — quarantine so the
                    # later frames (and later WAL files) aren't silently
                    # thrown away with it
                    report.quarantined = True
                    logger.error(
                        "wal %s: frame at offset %d fails CRC with %d "
                        "bytes after it — quarantining as .corrupt "
                        "(%d frames before the damage were replayed)",
                        path, off, len(data) - (start + ln), report.frames)
                    try:
                        os.replace(path, path + ".corrupt")
                    except OSError:
                        pass
                    return
                break  # bad CRC on the final frame — torn write
            yield payload
            report.frames += 1
            off = start + ln
            good_end = off
        if good_end < len(data):
            report.bytes_truncated = len(data) - good_end
            with open(path, "r+b") as f:
                f.truncate(good_end)
