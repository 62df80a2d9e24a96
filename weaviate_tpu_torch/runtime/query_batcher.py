"""Server-side dynamic query batching (port of
``weaviate_tpu/runtime/query_batcher.py`` without the kernelscope /
tailboard hooks, which the port does not have yet).

Continuous batching, not a fixed window: a request that finds the device
idle dispatches IMMEDIATELY; requests that arrive while a dispatch is in
flight queue up, and the worker drains the whole queue into ONE batched
dispatch as soon as the device frees up.

Filtered requests coalesce too: when the index advertises
``supports_batched_filters`` the drain ships each request's allow list
alongside its query row and the engine packs them into per-query
bitmasks the scan kernels read — one device program serves a mixed
filtered/unfiltered drain. HIGHLY SELECTIVE filters go solo, to the
store's gathered cutover (a stricter capacity/64 cut than the store's
capacity/8, because a solo dispatch also forfeits batching).

Drained batches are padded to power-of-two B buckets and k is bucketed
the same way (mixed k's batch together at the k bucket and slice).

Hybrid requests ride the same drains: a request carrying a packed sparse
operand (``ops/bm25.SparseOperand``) coalesces with plain vector queries,
and the drain runs the fused sparse + dense program (``hybrid_batch_fn``)
instead of the dense one. There is no sync fallback for such a drain: when
the index cannot run the fused program, the hybrid waiters get a typed
``DeviceHybridUnavailable`` (the shard layer serves them on the host
path) and the vector rows re-dispatch on their own.

Zero-sync pipeline: with an ``async_batch_fn`` (an index
``search_by_vector_batch_async`` returning a ``DeviceResultHandle``) the
worker launches batch N's kernels and hands the handle to a dedicated
transfer thread (runtime/transfer.py, depth 2), then drains and
dispatches batch N+1 while N's results cross to the host. Results are
identical to the sync path — same program, same padding, same slicing.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from weaviate_tpu_torch.runtime import degrade, faultline, retry, tracing
from weaviate_tpu_torch.runtime.transfer import TransferPipeline

#: bounded intake: past this queue depth the batcher sheds load with a
#: typed retriable OverloadedError instead of accepting latency it can
#: never serve
DEFAULT_MAX_QUEUE = int(os.environ.get("WEAVIATE_TPU_BATCHER_MAX_QUEUE",
                                       "4096"))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class DeviceHybridUnavailable(RuntimeError):
    """The drain carried hybrid (sparse+dense) requests but the index
    could not run the fused device program for this dispatch shape —
    the shard layer catches this and serves the query through the host
    hybrid path instead."""


class _Pending:
    __slots__ = ("query", "k", "allow", "sparse", "event", "ids", "dists",
                 "error", "ctx", "t_enqueue", "t_exec_start", "t_exec_end",
                 "batch_size", "t_mask_start", "t_mask_end",
                 "t_fetch_start", "t_fetch_end")

    def __init__(self, query, k, allow, sparse=None):
        self.query = query
        self.k = k
        self.allow = allow
        # hybrid requests carry their packed sparse operand
        # (ops/bm25.SparseOperand) the way filtered ones carry ``allow``
        self.sparse = sparse
        self.event = threading.Event()
        self.t_enqueue = 0.0
        self.ids = None
        self.dists = None
        self.error: Exception | None = None
        # trace context of the submitting request: the worker dispatches
        # under ONE waiter's context and stamps exec timings every waiter
        # records into its own trace
        self.ctx = tracing.capture()
        self.t_exec_start: float | None = None
        self.t_exec_end: float | None = None
        self.t_mask_start: float | None = None
        self.t_mask_end: float | None = None
        self.t_fetch_start: float | None = None
        self.t_fetch_end: float | None = None
        self.batch_size = 1


class QueryBatcher:
    """Wraps one vector index's batched search entry point.

    ``batch_fn(queries [B,d], k, allow) -> (ids [B,k], dists [B,k])``
    where ``allow`` is None, one shared allow list, or — only when
    ``supports_filter_batching`` — a list of per-request allow lists
    (None entries = unfiltered). ``supports_filter_batching`` may be a
    bool or a zero-arg callable re-read at every dispatch.
    ``capacity_fn`` (optional, returns the backing store's row capacity)
    powers the selectivity heuristic that routes tiny filters solo — wire
    it only when the store has a gathered cutover.
    ``hybrid_batch_fn(queries, k, allows, sparses) -> DeviceResultHandle
    | None`` runs the fused sparse+dense program for drains carrying
    sparse operands (None = unavailable for this dispatch shape).
    """

    def __init__(self, batch_fn, max_batch: int = 256,
                 supports_filter_batching: bool = False,
                 capacity_fn=None,
                 owner: dict | None = None, async_batch_fn=None,
                 transfer_depth: int = 2,
                 max_queue: int | None = None, hybrid_batch_fn=None):
        from weaviate_tpu_torch.runtime import hbm_ledger

        self._batch_fn = batch_fn
        self._hybrid_fn = hybrid_batch_fn
        self._async_fn = async_batch_fn
        self._transfer: TransferPipeline | None = None
        self._transfer_depth = transfer_depth
        self.max_batch = max_batch
        self.max_queue = DEFAULT_MAX_QUEUE if max_queue is None \
            else max_queue
        self.filter_batching = supports_filter_batching  # bool | callable
        self._capacity_fn = capacity_fn
        # device-memory ledger labels for the padded dispatch buffer
        self._hbm_owner = owner or hbm_ledger.current_owner()
        # health key scoped to THIS batcher's owner: a healthy shard's
        # batch must not clear the flag a broken shard set
        scope = "/".join(str(v) for v in (
            self._hbm_owner.get("collection"), self._hbm_owner.get("shard"))
            if v and v not in ("-", "_unowned"))
        self._component = f"query_batcher:{scope}" if scope \
            else "query_batcher"
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: list[_Pending] = []
        self._worker: threading.Thread | None = None
        self._stopped = False
        # observability: tests and chip_smoke.py assert coalescing and
        # pipelining through these
        self.dispatches = 0
        self.batched_queries = 0
        self.filtered_batched = 0
        self.hybrid_batched = 0
        self.async_dispatches = 0
        # dispatches launched while a previous batch was still in the
        # transfer window — the overlap the double-buffering exists for
        self.overlapped_dispatches = 0

    def _ensure_worker(self):
        """Caller holds ``_cv``."""
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._run, name="query-batcher", daemon=True)
            self._worker.start()

    def stop(self):
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
            tp = self._transfer
        if tp is not None:
            # drains in-flight handles: every waiter gets its result (or
            # the fetch error), never a hang on shutdown
            tp.stop()

    def _ensure_transfer(self) -> TransferPipeline:
        with self._cv:
            if self._stopped:
                # creating a pipeline after stop() looked would leak a
                # never-stopped drain thread
                raise RuntimeError("query batcher stopped")
            if self._transfer is None:
                self._transfer = TransferPipeline(
                    depth=self._transfer_depth, name="qb-transfer")
            return self._transfer

    def search(self, query: np.ndarray, k: int,
               allow: np.ndarray | None = None, sparse=None):
        """Blocking per-request entry; coalesces under concurrency.

        ``sparse`` (a packed ``ops/bm25.SparseOperand``) marks a hybrid
        request: it rides the coalesced dispatch the way allow lists do
        and the drain runs the fused sparse+dense device program.

        Deadline-aware: a request whose budget is spent fails typed
        before enqueueing, and the wait is capped at the remaining
        budget. Overload-aware: a full queue sheds with a retriable
        OverloadedError."""
        retry.check("batcher")
        item = _Pending(np.asarray(query, dtype=np.float32), k, allow,
                        sparse)
        t_enqueue = item.t_enqueue = time.perf_counter()
        with self._cv:
            if len(self._queue) >= self.max_queue:
                raise retry.OverloadedError(
                    f"query batcher queue full "
                    f"({len(self._queue)}/{self.max_queue})",
                    retry_after_s=0.1)
            self._queue.append(item)
            self._ensure_worker()
            self._cv.notify()
        rem = retry.remaining()
        if rem is None:
            item.event.wait()
        elif not item.event.wait(timeout=min(rem, threading.TIMEOUT_MAX)):
            from weaviate_tpu_torch.runtime.metrics import \
                deadline_exceeded_total

            deadline_exceeded_total.labels("batcher").inc()
            raise retry.DeadlineExceeded("batcher")
        # wait-vs-execute split, recorded into THIS request's trace from
        # the worker's stamps
        if item.t_exec_start is not None:
            tracing.record_span("batcher.wait", t_enqueue,
                                item.t_exec_start)
            if item.t_mask_start is not None:
                tracing.record_span("batcher.mask_pack", item.t_mask_start,
                                    item.t_mask_end or item.t_mask_start)
            tracing.record_span("batcher.execute", item.t_exec_start,
                                item.t_exec_end or time.perf_counter(),
                                batch=item.batch_size)
            if item.t_fetch_start is not None:
                tracing.record_span("batcher.transfer", item.t_fetch_start,
                                    item.t_fetch_end or item.t_fetch_start)
            from weaviate_tpu_torch.runtime.metrics import (
                batcher_execute_duration, batcher_wait_duration)

            batcher_wait_duration.observe(item.t_exec_start - t_enqueue)
            if item.t_exec_end is not None:
                batcher_execute_duration.observe(
                    item.t_exec_end - item.t_exec_start)
            if item.t_fetch_start is not None \
                    and item.t_fetch_end is not None:
                from weaviate_tpu_torch.runtime.metrics import (
                    batcher_transfer_duration)

                batcher_transfer_duration.observe(
                    item.t_fetch_end - item.t_fetch_start)
        if item.error is not None:
            raise item.error
        return item.ids, item.dists

    # -- worker ---------------------------------------------------------------

    def _run(self):
        while True:
            # pipeline pacing: with the transfer window full, DON'T drain
            # yet — arriving requests keep coalescing into the next batch
            tp = self._transfer
            if tp is not None:
                tp.wait_slot()
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait(timeout=1.0)
                if self._stopped:
                    for it in self._queue:
                        it.error = RuntimeError("query batcher stopped")
                        it.event.set()
                    self._queue.clear()
                    return
                drained = self._queue[: self.max_batch]
                del self._queue[: len(drained)]
            try:
                from weaviate_tpu_torch.runtime.metrics import \
                    batcher_batch_size

                batcher_batch_size.observe(len(drained))
                self._dispatch(drained)
            except Exception as e:  # noqa: BLE001 — deliver to every waiter
                for it in drained:
                    if not it.event.is_set():
                        it.error = e
                        it.event.set()

    def _allowed_count(self, allow) -> int:
        """Selectivity of an allow list (bool mask over doc-id space or
        array of allowed ids)."""
        a = np.asarray(allow)
        return int(np.count_nonzero(a)) if a.dtype == np.bool_ else a.size

    def _prefer_solo(self, it: _Pending) -> bool:
        """A HIGHLY selective filter beats the batched masked scan by
        taking the store's gathered cutover, which only exists on the
        solo (shared-mask) path."""
        if self._capacity_fn is None:
            return False
        try:
            cap = int(self._capacity_fn())
        except Exception:  # noqa: BLE001 — heuristic only, never fail a query
            return False
        if cap <= 0:
            return False
        return self._allowed_count(it.allow) <= cap // 64

    def _dispatch(self, drained: list[_Pending]):
        solo, coal = [], []
        fb = self.filter_batching
        filter_batching = bool(fb() if callable(fb) else fb)
        for it in drained:
            # hybrid requests never go solo: their sparse operand only
            # dispatches through the fused batched program
            if it.sparse is None and it.allow is not None and (
                    not filter_batching or self._prefer_solo(it)):
                solo.append(it)
            else:
                coal.append(it)
        for it in solo:
            try:
                it.t_exec_start = time.perf_counter()
                ids, dists = tracing.run_in(
                    it.ctx, self._batch_fn, it.query[None, :], it.k,
                    it.allow)
                it.ids, it.dists = ids[0], dists[0]
            except Exception as e:  # noqa: BLE001
                it.error = e
            it.t_exec_end = time.perf_counter()
            it.event.set()
        if not coal:
            return
        b = len(coal)
        # pow2 B/k buckets; padded query rows are zero vectors whose
        # results are discarded
        b_pad = min(_next_pow2(b), max(self.max_batch, b))
        k_bucket = _next_pow2(max(it.k for it in coal))
        filtered = [it for it in coal if it.allow is not None]
        hybrid = [it for it in coal if it.sparse is not None]
        t_mask0 = time.perf_counter()
        allows = None
        if filtered:
            # per-request allow lists ride along row-aligned; unfiltered
            # and padded rows are None (all-ones downstream)
            allows = [it.allow for it in coal] + [None] * (b_pad - b)
        sparses = None
        if hybrid:
            # sparse operands ride row-aligned exactly like allow lists;
            # pure-vector and padded rows are None (dense-only downstream)
            sparses = [it.sparse for it in coal] + [None] * (b_pad - b)
        queries = np.zeros((b_pad,) + coal[0].query.shape, dtype=np.float32)
        for row, it in enumerate(coal):
            queries[row] = it.query
        t_mask1 = time.perf_counter()
        self.dispatches += 1
        self.batched_queries += b
        self.filtered_batched += len(filtered)
        from weaviate_tpu_torch.runtime.metrics import (
            batcher_compile_bucket, batcher_filtered_batched)

        batcher_compile_bucket.labels(b=str(b_pad), k=str(k_bucket)).inc()
        if filtered:
            batcher_filtered_batched.inc(len(filtered))
        # the shared dispatch runs under ONE waiter's trace context
        ctx = next((it.ctx for it in coal if it.ctx is not None), None)
        t0 = time.perf_counter()
        for it in coal:
            it.t_exec_start = t0
            it.batch_size = b
            if filtered:
                it.t_mask_start, it.t_mask_end = t_mask0, t_mask1
        # the padded query block becomes a device upload inside batch_fn —
        # ledger-registered until the results leave the device
        from weaviate_tpu_torch.runtime.hbm_ledger import ledger as _hbm

        pad_key = _hbm.register("dispatch_pad", queries.nbytes,
                                dtype="float32", **self._hbm_owner)

        def _fail(err: BaseException) -> None:
            """Single exit path for every failure: release the pad once
            and set EVERY not-yet-delivered waiter's event."""
            _hbm.release(pad_key)
            t1 = time.perf_counter()
            for it in coal:
                if not it.event.is_set():
                    it.t_exec_end = t1
                    it.error = err
                    it.event.set()

        def _sync_batch():
            faultline.fire("batcher.dispatch", batch=b, k=k_bucket)
            return tracing.run_in(ctx, self._batch_fn, queries, k_bucket,
                                  allows)

        def _retry_once(first_err: BaseException):
            """Faulted device batch: ONE sync retry. A second failure
            errors only THIS batch's waiters with the ORIGINAL error and
            flips the batcher's unhealthy flag."""
            from weaviate_tpu_torch.runtime.metrics import \
                batcher_dispatch_retries

            batcher_dispatch_retries.inc()
            try:
                res2 = _sync_batch()
                if not (isinstance(res2, tuple) and len(res2) == 2):
                    raise TypeError(
                        f"batch_fn returned {type(res2).__name__}, "
                        "expected (ids, dists)")
                return res2
            except Exception as e2:  # noqa: BLE001
                degrade.mark_unhealthy(
                    self._component,
                    f"dispatch failed twice: {first_err}; retry: {e2}")
                _fail(first_err)
                return None

        def _mark_served():
            if degrade.is_unhealthy(self._component):
                degrade.mark_healthy(self._component)

        handle = None
        ids = dists = None
        try:
            if hybrid:
                # fused sparse+dense program: there is NO sync fallback
                # for hybrid drains (batch_fn has no sparse-operand slot)
                # — unavailability is a typed error the shard layer
                # converts into the host hybrid path, and the pure-vector
                # remainder re-dispatches normally
                if self._hybrid_fn is not None:
                    faultline.fire("batcher.dispatch", batch=b, k=k_bucket)
                    handle = tracing.run_in(ctx, self._hybrid_fn, queries,
                                            k_bucket, allows, sparses)
                if handle is None:
                    _hbm.release(pad_key)
                    err = DeviceHybridUnavailable(
                        "index cannot run the fused hybrid program for "
                        "this dispatch")
                    t1 = time.perf_counter()
                    for it in hybrid:
                        it.t_exec_end = t1
                        it.error = err
                        it.event.set()
                    rest = [it for it in coal if it.sparse is None]
                    if rest:
                        self._dispatch(rest)
                    return
                self.hybrid_batched += len(hybrid)
                from weaviate_tpu_torch.runtime.metrics import \
                    batcher_hybrid_batched

                batcher_hybrid_batched.inc(len(hybrid))
            elif self._async_fn is not None:
                # dispatch-and-go: launch, hand the handle to the transfer
                # thread, return to drain the NEXT batch
                faultline.fire("batcher.dispatch", batch=b, k=k_bucket)
                handle = tracing.run_in(ctx, self._async_fn, queries,
                                        k_bucket, allows)
            if handle is None:
                ids, dists = _sync_batch()
        except Exception as e:  # noqa: BLE001
            if hybrid:
                # no sparse-aware sync retry exists — surface the fault
                _fail(e)
                return
            result = _retry_once(e)
            if result is None:
                return
            ids, dists = result
            handle = None
        if handle is None:
            _hbm.release(pad_key)
            self._deliver(coal, ids, dists, time.perf_counter())
            _mark_served()
            return
        self.async_dispatches += 1
        from weaviate_tpu_torch.runtime.metrics import (
            batcher_async_dispatched, batcher_overlapped)

        batcher_async_dispatched.inc()

        def _finish(res):
            try:
                self._deliver(coal, res[0], res[1], time.perf_counter())
                _hbm.release(pad_key)
                _mark_served()
            except Exception as e:  # noqa: BLE001 — out-of-contract shape
                _fail(e)

        def _complete(res, err, t_fetch0, t_fetch1):
            for it in coal:
                it.t_fetch_start, it.t_fetch_end = t_fetch0, t_fetch1
            if err is not None and hybrid:
                # the sync retry path can't re-run a hybrid program (no
                # sparse-operand slot) — deliver the fault
                _fail(err)
                return
            if err is None:
                _finish(res)
                return

            # the batch (or its copy) faulted on the transfer thread:
            # retry ONCE through the sync path on a short-lived thread,
            # so other in-flight batches keep draining
            def _retry_path():
                res2 = _retry_once(err)
                if res2 is not None:
                    _finish(res2)

            threading.Thread(target=_retry_path, daemon=True,
                             name="batcher-fault-retry").start()

        try:
            tp = self._ensure_transfer()
            if tp.inflight > 0:
                self.overlapped_dispatches += 1
                batcher_overlapped.inc()
            tp.submit(handle, _complete, ctx=ctx)
        except Exception as e:  # noqa: BLE001 — stopped mid-shutdown
            _fail(e)

    @staticmethod
    def _deliver(coal: list[_Pending], ids, dists, t1: float):
        """Route one batch's host results to their waiters (identical
        slicing for the sync and pipelined paths)."""
        for row, it in enumerate(coal):
            it.t_exec_end = t1
            kk = min(it.k, ids.shape[1])
            it.ids = ids[row, :kk]
            it.dists = dists[row, :kk]
            it.event.set()
