"""Usage telemetry (opt-out phone-home).

Reference: usecases/telemetry/telemetry.go:53 — INIT on startup, UPDATE
every 24h, TERMINATE on shutdown; payload is machine id + version +
object count + OS/arch; DISABLE_TELEMETRY opts out. This environment has
no egress, so pushes fail soft (logged once, never raised) — the
subsystem's value here is parity of surface and the local payload
builder, which the nodes/meta endpoints reuse.
"""

from __future__ import annotations

import json
import logging
import os
import platform
import threading
import time
import urllib.request
import uuid

logger = logging.getLogger(__name__)

DEFAULT_ENDPOINT = "https://telemetry.weaviate.io/weaviate-telemetry"

INIT = "INIT"
UPDATE = "UPDATE"
TERMINATE = "TERMINATE"


def disabled(env=os.environ) -> bool:
    return env.get("DISABLE_TELEMETRY", "").lower() in ("true", "1", "on")


class Telemeter:
    def __init__(self, db, version: str = "dev",
                 endpoint: str | None = None,
                 interval: float = 24 * 3600.0,
                 data_dir: str | None = None):
        self.db = db
        self.version = version
        self.endpoint = endpoint if endpoint is not None else \
            os.environ.get("TELEMETRY_ENDPOINT", DEFAULT_ENDPOINT)
        self.interval = interval
        # stable across restarts when a data dir is given (reference
        # persists the machine id; a fresh uuid per boot would make every
        # restart look like a new installation)
        self.machine_id = self._load_machine_id(data_dir)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._warned = False

    @staticmethod
    def _load_machine_id(data_dir: str | None) -> str:
        if not data_dir:
            return str(uuid.uuid4())
        path = os.path.join(data_dir, "machine_id")
        try:
            with open(path) as f:
                mid = f.read().strip()
            if mid:
                return mid
        except OSError:
            pass
        mid = str(uuid.uuid4())
        try:
            os.makedirs(data_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(mid + "\n")
            os.replace(tmp, path)  # atomic: concurrent boots agree
        except OSError as e:
            logger.info("machine id not persisted (%s); using an "
                        "ephemeral one", e)
        return mid

    def build_payload(self, payload_type: str) -> dict:
        """Reference payload shape (telemetry.go buildPayload)."""
        try:
            num_objects = sum(
                self.db.get_collection(c).object_count()
                for c in self.db.list_collections())
        except Exception:
            num_objects = 0
        return {
            "machineId": self.machine_id,
            "type": payload_type,
            "version": self.version,
            "numberObjects": num_objects,
            "os": platform.system().lower(),
            "arch": platform.machine(),
            "timestamp": time.time(),
        }

    def _push(self, payload_type: str) -> bool:
        payload = self.build_payload(payload_type)
        try:
            req = urllib.request.Request(
                self.endpoint, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10):
                return True
        except Exception as e:
            if not self._warned:
                logger.info("telemetry push failed (will not retry "
                            "loudly): %s", e)
                self._warned = True
            return False

    def start(self) -> None:
        if disabled() or self._thread is not None:
            return

        # INIT rides the background thread too: a hanging/unreachable
        # telemetry endpoint must never stall server startup
        def loop():
            self._push(INIT)
            while not self._stop.wait(self.interval):
                self._push(UPDATE)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="telemetry")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        # TERMINATE is fired from a daemon thread so shutdown never blocks
        # on a dead endpoint
        threading.Thread(target=self._push, args=(TERMINATE,),
                         daemon=True, name="telemetry-term").start()
        self._thread.join(1.0)
        self._thread = None
