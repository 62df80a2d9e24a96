"""Device-resident result handles and the double-buffered D2H drain
(port of ``weaviate_tpu/runtime/transfer.py``; only its ``d2h`` differs).

- ``DeviceResultHandle`` — a future for one dispatched device program.
  The engine's ``search_async`` entry points return it; the result
  tensors stay on the card until ``.result()`` performs THE sanctioned
  device->host copy (``tracing.d2h``) and runs the host-side ``finish``
  post-step (slot -> doc-id resolution, gathered-path padding). Handles
  compose with ``map`` so each layer adds its host post-processing
  without forcing the copy early.

- ``TransferPipeline`` — a dedicated drain thread with a bounded
  in-flight window (double buffering). While batch N's results cross to
  the host here, the dispatch thread is already launching batch N+1's
  kernels, so the card never idles on a host sync. The window bound
  (default 2) is backpressure.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from weaviate_tpu_torch.runtime import faultline, tracing

_UNSET = object()


def d2h(*values):
    """THE sanctioned device->host fetch for maintenance paths (epoch
    compaction, store rebuilds, migration serialization): delegates to
    ``tracing.d2h`` so the copy lands in a ``transfer.d2h`` span with
    device-time attribution on sampled traces. Serving paths should ride
    ``DeviceResultHandle`` instead — this direct form is for host-side
    rebuild work where a future adds nothing."""
    return tracing.d2h(*values)


class DeviceResultHandle:
    """Future-like handle for one dispatched device program's results.

    ``arrays`` are the raw device tensors the program returns; they
    stay device-resident until ``result()`` runs. ``finish(*host)`` is
    the host-side post-step applied to the fetched numpy arrays; its
    return value is the handle's result. ``result()`` is idempotent and
    thread-safe (an error is cached and re-raised to every caller).
    """

    __slots__ = ("_arrays", "_finish", "_parent", "_value", "_error",
                 "_lock", "attrs")

    def __init__(self, arrays=(), finish=None, parent=None, attrs=None):
        self._arrays = tuple(arrays)
        self._finish = finish
        self._parent = parent
        self._value = _UNSET
        self._error: BaseException | None = None
        self._lock = threading.Lock()
        self.attrs = dict(attrs or {})

    @property
    def arrays(self) -> tuple:
        """The raw device arrays, still resident (empty once ``result()``
        has drained them, or for ``ready()``/``map()`` handles). Device
        COMPOSITION hook: the hybridplane feeds a dense scan's arrays
        into the fusion program without forcing the D2H early."""
        return self._arrays

    @classmethod
    def ready(cls, value) -> "DeviceResultHandle":
        """A handle over an already-host-resident result (sync fallbacks
        keep the async call signature without a fake transfer)."""
        h = cls()
        h._value = value
        return h

    def map(self, fn) -> "DeviceResultHandle":
        """Chain a host post-step: the new handle resolves to
        ``fn(self.result())``. The transfer still happens exactly once,
        at the outermost ``result()``."""
        return DeviceResultHandle(parent=self, finish=fn,
                                  attrs=dict(self.attrs))

    @property
    def done(self) -> bool:
        return self._value is not _UNSET or self._error is not None

    def result(self):
        """Fetch to host (``transfer.d2h``) and run the finish chain."""
        with self._lock:
            if self._error is not None:
                raise self._error
            if self._value is not _UNSET:
                return self._value
            try:
                if self._parent is not None:
                    host = self._parent.result()
                    self._value = (self._finish(host)
                                   if self._finish is not None else host)
                else:
                    # faultline point: the sanctioned D2H boundary — an
                    # injected error is cached like a real fetch failure
                    # and reaches every waiter of THIS handle only
                    faultline.fire("transfer.d2h", arrays=len(self._arrays))
                    host = tracing.d2h(*self._arrays)
                    self._value = (self._finish(*host)
                                   if self._finish is not None else host)
            except BaseException as e:  # cache: every waiter sees it
                self._error = e
                raise
            finally:
                self._arrays = ()  # release the device references
                self._parent = None
            return self._value


class TransferPipeline:
    """Dedicated D2H drain thread with a bounded in-flight window.

    ``submit(handle, callback, ctx)`` enqueues one transfer; it BLOCKS
    while ``depth`` transfers are already queued or running — that bound
    is the double-buffering contract (depth=2: batch N draining, batch
    N+1 dispatched, batch N+2's dispatcher waits). ``callback(value,
    error, t_fetch_start, t_fetch_end)`` runs on the drain thread;
    ``ctx`` (a ``tracing.capture()`` handle) scopes the fetch so the
    ``transfer.d2h`` span lands in a real request trace.

    ``stop()`` drains everything already submitted — in-flight waiters
    get their results (or the fetch error), never a hang — then joins
    the thread. Submitting after stop raises.
    """

    def __init__(self, depth: int = 2, name: str = "d2h-transfer"):
        self.depth = max(1, int(depth))
        self.name = name
        self._cv = threading.Condition()
        self._q: deque = deque()
        self._inflight = 0
        self._thread: threading.Thread | None = None
        self._stopped = False
        # observability (bench/tests assert overlap through these)
        self.transferred = 0
        self.errors = 0

    @property
    def inflight(self) -> int:
        """Transfers queued or currently draining."""
        with self._cv:
            return len(self._q) + self._inflight

    def wait_slot(self) -> None:
        """Block until the window has a free slot (or the pipeline is
        stopped). Dispatchers call this BEFORE draining their queue so
        requests keep coalescing while the window is full — racing ahead
        with tiny batches would trade the batching win for the overlap
        win instead of keeping both."""
        with self._cv:
            while (not self._stopped
                   and len(self._q) + self._inflight >= self.depth):
                self._cv.wait(timeout=1.0)

    def submit(self, handle: DeviceResultHandle, callback, ctx=None):
        # dispatch-submit stamp: paired with the drain thread's
        # post-``result()`` stamp (t_fetch_end in the callback) it bounds
        # the device+copy window of this handle without an added sync
        handle.attrs.setdefault("t_submit", time.perf_counter())
        with self._cv:
            while (not self._stopped
                   and len(self._q) + self._inflight >= self.depth):
                self._cv.wait(timeout=1.0)
            if self._stopped:
                raise RuntimeError(f"transfer pipeline {self.name} stopped")
            self._q.append((handle, callback, ctx))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name=self.name, daemon=True)
                self._thread.start()
            self._cv.notify_all()

    def stop(self, timeout: float = 10.0) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
            t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout)

    def _run(self):
        while True:
            with self._cv:
                while not self._q and not self._stopped:
                    self._cv.wait(timeout=1.0)
                if not self._q:  # stopped and drained
                    self._cv.notify_all()
                    return
                handle, callback, ctx = self._q.popleft()
                self._inflight += 1
            err = None
            value = None
            t0 = time.perf_counter()
            try:
                value = tracing.run_in(ctx, handle.result)
            except BaseException as e:  # noqa: BLE001 — deliver to waiters
                err = e
            t1 = time.perf_counter()
            try:
                callback(value, err, t0, t1)
            except Exception:  # noqa: BLE001 — a bad callback must not
                pass           # kill the drain thread for later batches
            with self._cv:
                self._inflight -= 1
                self.transferred += 1
                if err is not None:
                    self.errors += 1
                self._cv.notify_all()
