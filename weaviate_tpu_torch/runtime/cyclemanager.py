"""Cycle manager: periodic maintenance callbacks on daemon threads.

Reference: entities/cyclemanager/cyclemanager.go:34 — callbacks registered
with a ticker; tickers may back off exponentially while the callback
reports "nothing to do" and snap back to the base interval on activity.
Every callback runs panic-recovered (entities/errors GoWrapper): one
failing compaction must not kill the scheduler.

Used for: LSM flush+compaction (store_cyclecallbacks.go analog), vector
index compaction/reorganize cycles, tombstone cleanup.
"""

from __future__ import annotations

import logging
import threading
import time

logger = logging.getLogger(__name__)


class CycleCallback:
    """One periodic job. ``fn() -> bool`` returns True when it did work
    (resets the interval) and False when idle (backs off up to
    ``max_interval``)."""

    def __init__(self, name: str, fn, interval: float,
                 max_interval: float | None = None, backoff: float = 2.0):
        self.name = name
        self.fn = fn
        self.base_interval = interval
        self.max_interval = max_interval or interval * 8
        self.backoff = backoff
        self.current_interval = interval
        self.next_due = time.monotonic() + interval
        self.runs = 0
        self.failures = 0
        self.active = True

    def run(self) -> None:
        self.runs += 1
        try:
            did_work = self.fn()
        except Exception:
            self.failures += 1
            logger.exception("cycle callback %s failed", self.name)
            did_work = False
        if did_work:
            self.current_interval = self.base_interval
        else:
            self.current_interval = min(self.current_interval * self.backoff,
                                        self.max_interval)
        self.next_due = time.monotonic() + self.current_interval


class CycleManager:
    """Runs registered callbacks on a single scheduler thread.

    A single thread (not one per callback) keeps the background footprint
    flat no matter how many shards register compaction cycles — the
    reference bounds this with routine budgets per callback group.
    """

    def __init__(self):
        self._callbacks: dict[str, CycleCallback] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._pause_lock = threading.Lock()
        self._thread: threading.Thread | None = None

    def register(self, name: str, fn, interval: float,
                 max_interval: float | None = None) -> CycleCallback:
        cb = CycleCallback(name, fn, interval, max_interval)
        with self._lock:
            self._callbacks[name] = cb
        self._wake.set()
        return cb

    def unregister(self, name: str) -> None:
        with self._lock:
            self._callbacks.pop(name, None)

    def start(self) -> None:
        # under _lock: two concurrent start()s would otherwise both see a
        # dead handle and run two schedulers against the same buckets
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="cyclemanager")
            self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        # read the handle under _lock, join OUTSIDE it — the loop takes
        # _lock around every callback scan and could never exit otherwise
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                # a long compaction is still draining; keep the handle so a
                # subsequent start() can't spawn a second scheduler against
                # the same buckets
                logger.warning("cyclemanager did not stop within %.1fs", timeout)
            else:
                with self._lock:
                    if self._thread is t:
                        self._thread = None

    def trigger(self, name: str) -> None:
        """Force a callback to run at the next tick (tests, shutdown flush)."""
        with self._lock:
            cb = self._callbacks.get(name)
            if cb is not None:
                cb.next_due = 0.0
        self._wake.set()

    def run_now(self, name: str) -> bool:
        """Run a callback synchronously on the CALLING thread
        (deterministic tests and operational drives — e.g. forcing an
        ``epoch-maintenance`` pass without waiting a tick): takes the
        pause lock so it never overlaps the scheduler running the same
        callback, and feeds the same backoff bookkeeping. Returns False
        for unknown names."""
        with self._lock:
            cb = self._callbacks.get(name)
        if cb is None:
            return False
        with self._pause_lock:
            cb.run()
        return True

    def _loop(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            with self._lock:
                due = [cb for cb in self._callbacks.values()
                       if cb.active and cb.next_due <= now]
            for cb in due:
                if self._stop.is_set():
                    return
                with self._pause_lock:
                    cb.run()
            with self._lock:
                pending = [cb.next_due for cb in self._callbacks.values() if cb.active]
            wait = min(pending) - time.monotonic() if pending else 1.0
            if wait > 0:
                self._wake.wait(min(wait, 1.0))
                self._wake.clear()

    def pause(self):
        """Context manager: block callback execution for the duration
        (reference: Shard.BeginBackup pauses compaction and commit-log
        switching while backup files are streamed, shard_backup.go).
        An in-flight callback finishes first; new ones wait."""
        import contextlib

        @contextlib.contextmanager
        def _paused():
            with self._pause_lock:
                yield

        return _paused()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stats(self) -> dict:
        with self._lock:
            return {name: {"runs": cb.runs, "failures": cb.failures,
                           "interval": cb.current_interval}
                    for name, cb in self._callbacks.items()}
