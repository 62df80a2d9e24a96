"""Native gRPC data plane: the Python side (port of
``weaviate_tpu/api/grpc/native_plane.py`` over the port's own C++ plane,
``weaviate_tpu_torch/dataplane.py``).

Pairs csrc/host/dataplane.cpp (epoll + libnghttp2 transport, the parse of
a plain Search request, batch coalescing, C++ reply building) with this
dispatcher:

- search batches -> ONE Shard device dispatch for the whole coalesced
  batch. The dispatch loop is PIPELINED: it launches batch N through
  ``Shard.vector_search_batch_async`` (a DeviceResultHandle left on the
  card) and hands the handle to a transfer thread, then waits for batch
  N+1 at once — while N's results cross to the host, N+1's kernels are
  already running. Results go back through dp_post_batch, which builds
  every reply in C++ from the docid -> (uuid, PropertiesResult bytes)
  cache. Cache misses come back here and are answered through ONE
  batched LSM read (``Shard.objects_by_doc_ids`` -> ``kv.get_many``) that
  also seeds the cache: the plane warms itself (doc ids are never reused,
  so an entry cannot go stale). The warm pass reads through the same
  batched feed.
- everything else (filters, hybrid, tenants, BatchObjects, ...) arrives
  as raw request bytes and is answered by the SAME servicer methods the
  Python gRPC server runs (``GrpcServer`` handlers), so the behavior is
  the same by construction.

Reference bar: Go handlers scaling with cores
(adapters/handlers/grpc/server.go:50, adapters/repos/db/index.go:1576).
Enable with WEAVIATE_TPU_NATIVE_DATAPLANE=1 (needs libnghttp2.so.14 and
no auth configured: fallback requests carry no per-request credentials).
"""

from __future__ import annotations

import logging
import threading
import time

import grpc
import numpy as np

from weaviate_tpu_torch import dataplane as dpn
from weaviate_tpu_torch.api.grpc import v1_pb2 as pb
from weaviate_tpu_torch.runtime import degrade, tailboard
from weaviate_tpu_torch.runtime.transfer import TransferPipeline

logger = logging.getLogger(__name__)

_REQ_TYPES = {
    "Search": pb.SearchRequest,
    "BatchObjects": pb.BatchObjectsRequest,
    "BatchDelete": pb.BatchDeleteRequest,
    "TenantsGet": pb.TenantsGetRequest,
}


class _Ctx:
    """Minimal grpc.ServicerContext stand-in for fallback dispatch."""

    class Abort(Exception):
        def __init__(self, code, message):
            self.code = code
            self.message = message

    def invocation_metadata(self):
        return []

    def abort(self, code, message):
        raise _Ctx.Abort(code, message)


class NativeDataPlane:
    """Drop-in for GrpcServer (same ``port``/``start``/``stop`` surface),
    serving the gRPC port through the C++ transport."""

    def __init__(self, db, grpc_server, host: str = "127.0.0.1",
                 port: int = 0, window_us: int = 0):
        self.db = db
        self.server = grpc_server  # handler logic donor (not started)
        self.dp = dpn.DataPlane(port=port, window_us=window_us)
        self.port = self.dp.port
        self.host = host
        self._coll_by_id: dict[int, str] = {}
        self._registered: set[str] = set()
        self._reg_lock = threading.Lock()  # dispatch vs warm threads
        self._warm_threads: dict[str, threading.Thread] = {}
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # double-buffered D2H drain for the pipelined dispatch loop:
        # depth 2 = batch N draining + batch N+1 dispatched; the
        # dispatcher blocks before launching N+2 (backpressure)
        self._transfer = TransferPipeline(depth=2, name="dp-transfer")

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        t = threading.Thread(target=self._dispatch_loop,
                             name="dp-dispatch", daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self, grace: float = 0.5):
        self._stop.set()
        # drain in-flight transfers FIRST so queued replies still post
        # through the live C++ plane, then stop it
        self._transfer.stop(timeout=grace + 1.0)
        self.dp.stop()
        for t in self._threads:
            t.join(timeout=grace + 1.0)

    # -- collection registry --------------------------------------------------

    def _eligible(self, col) -> bool:
        """Fast-path only for the plain shape: single shard, single
        tenant, unreplicated, default vector. Everything else still
        works — through the fallback."""
        cfg = col.config
        if cfg.multi_tenancy.enabled:
            return False
        if getattr(cfg.replication, "factor", 1) > 1:
            return False
        if len(col.shards) != 1:
            return False
        return True

    def _maybe_register(self, name: str, warm: bool = True):
        if name in self._registered:
            return
        try:
            col = self.db.get_collection(name)
        except Exception:
            return
        if not self._eligible(col):
            with self._reg_lock:
                self._registered.add(name)  # don't re-check every query
            return
        shard = next(iter(col.shards.values()))
        idx = shard.vector_indexes.get("")
        if idx is None or not hasattr(idx, "search_by_vector_batch"):
            return  # not ready yet (no vectors imported)
        cid = self.dp.register_collection(name, int(idx.dim))
        if cid >= 0:
            with self._reg_lock:
                self._coll_by_id[cid] = name
                self._registered.add(name)
            if warm:
                # bulk-warm the reply cache off the dispatch thread;
                # misses self-seed in the meantime. Started UNDER the
                # lock so warm_collection() can never observe (and
                # join) a published-but-unstarted thread; the warm
                # thread itself re-takes the lock only after start.
                t = threading.Thread(target=self._warm_once, args=(name,),
                                     name=f"dp-warm-{name}", daemon=True)
                with self._reg_lock:
                    self._warm_threads[name] = t
                    t.start()

    def wait_registered(self, name: str, timeout: float = 10.0) -> bool:
        """Block until `name` is fast-path registered (registration runs
        on the dispatcher thread after the first Search on it)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._reg_lock:
                if name in self._coll_by_id.values():
                    return True
            time.sleep(0.02)
        return False

    def warm_collection(self, name: str, chunk: int = 2048) -> bool:
        """Ensure the reply cache for `name` is fully warm. Joins an
        in-flight auto-warm instead of repeating the O(corpus) pass;
        returns False when the collection never registered."""
        with self._reg_lock:
            t = self._warm_threads.get(name)
        if t is not None:
            t.join()
            return True
        return self._warm_once(name, chunk)

    def _warm_once(self, name: str, chunk: int = 2048) -> bool:
        """One O(corpus) pass populating the C++ docid -> (uuid,
        PropertiesResult) reply cache; after it, plain nearVector
        queries never touch Python per-query. Objects come out of the
        LSM side in ``chunk``-sized ``kv.get_many`` batches (one layer
        snapshot per chunk) instead of a point lookup per doc."""
        cid = None
        with self._reg_lock:
            items = list(self._coll_by_id.items())
        for c, n in items:
            if n == name:
                cid = c
        if cid is None:
            return False
        col = self.db.get_collection(name)
        shard = next(iter(col.shards.values()))
        dtype_of = {p.name: p.data_type for p in col.config.properties}
        all_docs = list(shard._doc_to_uuid.keys())
        for s in range(0, len(all_docs), chunk):
            doc_chunk = all_docs[s:s + chunk]
            ids: list[int] = []
            uuids: list[str] = []
            props: list[bytes] = []
            for doc_id, obj in zip(doc_chunk,
                                   shard.objects_by_doc_ids(doc_chunk)):
                if obj is None:
                    continue
                out = pb.SearchResult()
                self.server._fill_result(col, out, obj, None, _FAST_META,
                                         None, dtype_of)
                ids.append(doc_id)
                uuids.append(obj.uuid)
                props.append(out.properties.SerializeToString())
            if ids:
                self.dp.cache_put(cid, ids, uuids, props)
        return True

    # -- dispatch -------------------------------------------------------------

    def _dispatch_loop(self):
        while not self._stop.is_set():
            try:
                item = self.dp.wait(200)
            except Exception:
                if self._stop.is_set():
                    return
                raise
            if item is None:
                continue
            if item == "stopped":
                return
            try:
                if isinstance(item, dpn.SearchBatch):
                    self._run_batch(item)
                else:
                    self._run_fallback(item)
            except Exception:  # noqa: BLE001 — keep serving
                logger.exception("data plane dispatch failed")
                # every stream in the failed item must get an error reply
                # or its client hangs until the deadline
                toks = (item.tokens.tolist()
                        if isinstance(item, dpn.SearchBatch)
                        else [item.token])
                for tok in toks:
                    try:
                        self.dp.post_raw(int(tok), b"", 13, "internal error")
                    except Exception:
                        pass

    def _run_batch(self, batch: dpn.SearchBatch):
        t0 = time.perf_counter()
        name = self._coll_by_id.get(batch.coll_id)
        col = self.db.get_collection(name)
        shard = next(iter(col.shards.values()))
        kmax = int(batch.ks.max())
        # pipelined path: dispatch-and-go — the handle drains on the
        # transfer thread while this loop returns to dp.wait() and
        # launches the NEXT batch's program
        handle = shard.vector_search_batch_async(batch.queries, kmax)
        if handle is None:
            ids, dists, counts = shard.vector_search_batch(
                batch.queries, kmax)
            self._finish_batch(batch, col, shard, ids, dists, counts,
                               time.perf_counter() - t0)
            return

        def _fail_batch(_batch):
            for tok in _batch.tokens.tolist():
                try:
                    self.dp.post_raw(int(tok), b"", 13, "internal error")
                except Exception:  # noqa: BLE001
                    pass

        def _serve(res, _batch, _col, _shard, _t0):
            ids, dists, counts = res
            try:
                self._finish_batch(_batch, _col, _shard, ids, dists,
                                   counts, time.perf_counter() - _t0)
                if degrade.is_unhealthy("native_plane"):
                    degrade.mark_healthy("native_plane")
            except Exception:  # noqa: BLE001 — clients must not hang
                logger.exception("pipelined reply build failed")
                _fail_batch(_batch)

        def _done(res, err, _t_fetch0, _t_fetch1, _batch=batch, _col=col,
                  _shard=shard, _t0=t0):
            if err is None:
                _serve(res, _batch, _col, _shard, _t0)
                return
            # faulted device batch: retry ONCE through the sync path
            # (queries are still host-resident), then error only THIS
            # batch's waiters and flip the plane's unhealthy flag —
            # visible in /v1/nodes until a batch serves again. The
            # retry is a full device dispatch, so it leaves the
            # transfer thread: blocking here would stall every other
            # in-flight batch's D2H behind one faulted batch.
            logger.warning("pipelined batch faulted; retrying once "
                           "synchronously: %s", err)
            from weaviate_tpu_torch.runtime.metrics import (
                native_dispatch_retries)

            native_dispatch_retries.inc()

            def _retry_path():
                try:
                    res2 = _shard.vector_search_batch(
                        _batch.queries, int(_batch.ks.max()))
                except Exception as e2:  # noqa: BLE001
                    logger.error("pipelined batch failed after retry",
                                 exc_info=e2)
                    degrade.mark_unhealthy(
                        "native_plane",
                        f"batch dispatch failed twice: {err}; "
                        f"retry: {e2}")
                    _fail_batch(_batch)
                    return
                _serve(res2, _batch, _col, _shard, _t0)

            threading.Thread(target=_retry_path, daemon=True,
                             name="native-plane-fault-retry").start()

        self._transfer.submit(handle, _done)

    def _finish_batch(self, batch: dpn.SearchBatch, col, shard, ids,
                      dists, counts, took: float):
        """Host half of a coalesced Search batch: post to the C++ reply
        builder; answer its cache misses from ONE batched LSM read
        (``objects_by_doc_ids`` -> ``kv.get_many``) and seed the cache
        so the next occurrence of those docs never leaves C++."""
        miss = self.dp.post_batch(batch, ids, dists, counts, took)
        # flight-recorder record for the native plane's dispatch loop —
        # the C++ fast path has no per-request Python, so per-BATCH
        # records are its only always-on attribution
        tailboard.record_dispatch(
            "native", batch=int(len(batch.tokens)),
            k=int(batch.ks.max()) if len(batch.ks) else 0,
            took_ms=round(took * 1000.0, 3), cache_misses=int(len(miss)),
            window_inflight=self._transfer.inflight)
        if len(miss) == 0:
            return
        tok_pos = {int(t): i for i, t in enumerate(batch.tokens)}
        # one get_many for every doc the missed replies need, deduped
        need: list[int] = []
        seen: set[int] = set()
        for t in miss:
            i = tok_pos[int(t)]
            n = int(min(counts[i], batch.ks[i]))
            for j in range(n):
                doc = int(ids[i, j])
                if doc >= 0 and doc not in seen:
                    seen.add(doc)
                    need.append(doc)
        objs = dict(zip(need, shard.objects_by_doc_ids(need)))
        seed_ids: list[int] = []
        seed_uuids: list[str] = []
        seed_props: list[bytes] = []
        dtype_of = {p.name: p.data_type for p in col.config.properties}
        for t in miss:
            i = tok_pos[int(t)]
            reply = pb.SearchReply(took=took)
            n = int(min(counts[i], batch.ks[i]))
            for j in range(n):
                doc = int(ids[i, j])
                obj = objs.get(doc)
                if obj is None:
                    continue
                out = reply.results.add()
                res = _Res(float(dists[i, j]))
                self.server._fill_result(col, out, obj, res,
                                         _FAST_META, None, dtype_of)
                seed_ids.append(doc)
                seed_uuids.append(obj.uuid)
                seed_props.append(out.properties.SerializeToString())
            self.dp.post_raw(int(t), reply.SerializeToString())
        if seed_ids:
            self.dp.cache_put(batch.coll_id, seed_ids, seed_uuids,
                              seed_props)

    def _run_fallback(self, item: dpn.FallbackRequest):
        method = item.method.rsplit("/", 1)[-1]
        handler = {
            "Search": self.server._search,
            "BatchObjects": self.server._batch_objects,
            "BatchDelete": self.server._batch_delete,
            "TenantsGet": self.server._tenants_get,
        }.get(method)
        if handler is None:
            self.dp.post_raw(item.token, b"", 12,
                             f"unknown method {item.method}")
            return
        from weaviate_tpu_torch.api.grpc.server import ApiError

        req_type = _REQ_TYPES[method]
        ctx = _Ctx()
        # fallback requests bypass GrpcServer._wrap, so they open their
        # own always-on timeline (the fast path is per-batch C++ and is
        # covered by the flight recorder instead)
        with tailboard.request(f"grpc.{method.lower()}"):
            try:
                req = req_type.FromString(item.payload)
                reply = handler(req, ctx)
                tailboard.complete(200)
                self.dp.post_raw(item.token, reply.SerializeToString())
                # a Search that fell back on an unregistered collection
                # registers it so the NEXT plain query takes the fast path
                if method == "Search" and req.collection:
                    self._maybe_register(req.collection)
            except (_Ctx.Abort, ApiError) as e:
                code = e.code.value[0] if hasattr(e.code, "value") \
                    else int(e.code)
                # same gRPC->HTTP-ish mapping as the wrapped edge, so
                # UNAVAILABLE/DEADLINE failures count against the SLO
                # here too instead of masquerading as client errors
                from weaviate_tpu_torch.api.grpc.server import GrpcServer

                tailboard.complete(GrpcServer._grpc_http_status(e.code))
                self.dp.post_raw(item.token, b"", code, str(e.message))
            except KeyError as e:
                tailboard.complete(404)
                self.dp.post_raw(item.token, b"",
                                 grpc.StatusCode.NOT_FOUND.value[0], str(e))
            except ValueError as e:
                tailboard.complete(422)
                self.dp.post_raw(
                    item.token, b"",
                    grpc.StatusCode.INVALID_ARGUMENT.value[0], str(e))
            except Exception as e:  # noqa: BLE001
                logger.exception("fallback handler failed")
                tailboard.complete(500)
                self.dp.post_raw(item.token, b"",
                                 grpc.StatusCode.INTERNAL.value[0], str(e))


class _Res:
    """SearchResult stand-in for _fill_result on the fast path."""

    __slots__ = ("distance", "score", "rerank_score")

    def __init__(self, distance: float):
        self.distance = distance
        self.score = None
        self.rerank_score = None


_FAST_META = pb.MetadataRequest(uuid=True, distance=True)
