"""Async vector-index queue.

Reference: adapters/repos/db/index_queue.go:42 — with ASYNC_INDEXING on,
imports enqueue vectors instead of mutating the vector index inline; a
shared worker pool drains batches into ``VectorIndex.AddBatch``, and a
bolt-backed checkpoint (indexcheckpoint/) tracks progress. Search is
eventually consistent with the queue (the reference searches both the
index and the queue's brute-force buffer; here the flat store IS
brute-force, so the only effect is indexing latency).

Crash story: vector indexes rebuild from the object store at shard open
(shard._restore_vector_indexes), so a lost queue never loses data — the
checkpoint only reports lag, matching the reference's recovery-by-replay.

Deletes racing queued inserts: delete(doc_id) tombstones the id inside
the queue so a drain never resurrects a deleted document (the ghost-row
hazard the reference guards with its own tombstone checks).
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np


class IndexQueue:
    def __init__(self, index, batch_size: int = 512,
                 start_worker: bool = True):
        self.index = index
        self.batch_size = batch_size
        self._lock = threading.Lock()
        self._pending: deque = deque()  # (doc_id, vector) pairs
        self._deleted: set[int] = set()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = threading.Event()
        self._flushed = 0  # vectors actually handed to the index
        # COUNT of popped-but-unapplied drain batches: drain() can run on
        # the worker AND a flush/stop caller concurrently, so a boolean
        # would let one finishing drain clear tombstones out from under
        # the other's in-flight batch
        self._in_flight = 0
        # the actual items of in-flight batches, still searchable via
        # snapshot() until the index visibly holds them
        self._in_flight_items: list = []
        self._thread = None
        if start_worker:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="index-queue")
            self._thread.start()

    # -- producer side -------------------------------------------------------

    def push(self, doc_ids, vectors) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        with self._lock:
            for i, doc_id in enumerate(np.asarray(doc_ids).tolist()):
                self._pending.append((int(doc_id), vectors[i]))
            self._idle.clear()
        self._wake.set()

    def delete(self, doc_id: int) -> None:
        """Tombstone a doc id: a queued insert for it will be dropped at
        drain time (the index's own delete already ran). Recorded even
        while the queue LOOKS empty — a drain batch may be in flight, and
        the post-add re-check below needs the tombstone to undo a racing
        re-insert."""
        with self._lock:
            if self._pending or self._in_flight:
                self._deleted.add(int(doc_id))

    def size(self) -> int:
        with self._lock:
            return len(self._pending) + len(self._in_flight_items)

    def snapshot(self) -> list:
        """(doc_id, vector) pairs not yet visible in the index — pending
        plus the in-flight drain batch, minus tombstoned ids. Searches
        brute-force these so async indexing stays read-your-writes
        (reference: index queue search over unindexed vectors)."""
        with self._lock:
            dead = self._deleted
            return [(d, v) for d, v in
                    list(self._pending) + self._in_flight_items
                    if d not in dead]

    @property
    def flushed(self) -> int:
        return self._flushed

    # -- consumer side -------------------------------------------------------

    def drain(self) -> bool:
        """Drain everything queued right now (synchronous); True if any
        work was done. Also the cyclemanager-callback entry point."""
        did = False
        while self._drain_batch():
            did = True
        return did

    def _drain_batch(self) -> bool:
        with self._lock:
            if not self._pending:
                if not self._in_flight:
                    self._deleted.clear()
                    self._idle.set()
                return False
            batch = [self._pending.popleft()
                     for _ in range(min(self.batch_size,
                                        len(self._pending)))]
            dead = set(self._deleted)
            self._in_flight += 1
            self._in_flight_items.extend(batch)
        applied = False
        try:
            live = [(d, v) for d, v in batch if d not in dead]
            if live:
                ids = np.asarray([d for d, _ in live], dtype=np.int64)
                vecs = np.stack([v for _, v in live])
                self.index.add_batch(ids, vecs)
            applied = True
            with self._lock:
                self._flushed += len(live)
            # a delete may have raced the add_batch above: its idx.delete
            # found nothing (vector not added yet) and our `dead` snapshot
            # predates it — undo the resurrect now
            with self._lock:
                raced = [d for d, _ in live if d in self._deleted]
            for d in raced:
                self.index.delete(d)
        finally:
            with self._lock:
                self._in_flight -= 1
                batch_ids = {d for d, _ in batch}
                self._in_flight_items = [
                    (d, v) for d, v in self._in_flight_items
                    if d not in batch_ids]
                if not applied:
                    # add_batch failed (device OOM etc.): the batch was
                    # already popped — requeue it or the acknowledged
                    # vectors silently vanish from index AND snapshot
                    self._pending.extendleft(reversed(batch))
                    self._idle.clear()
                if not self._pending and not self._in_flight:
                    self._deleted.clear()
                    self._idle.set()
        # on add_batch failure the exception propagates (ending this drain
        # round — no hot retry loop); the worker's next wake tick retries
        # the requeued batch
        return True

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until the queue is fully drained (flush/close path)."""
        self._wake.set()
        return self._idle.wait(timeout)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(0.2)
            self._wake.clear()
            try:
                self.drain()
            except Exception:  # keep the worker alive; next push retries
                import logging

                logging.getLogger(__name__).exception(
                    "index queue drain failed")

    def stop(self, flush: bool = True, timeout: float = 10.0) -> None:
        if flush:
            self.drain()
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
