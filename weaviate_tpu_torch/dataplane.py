"""ctypes bindings for the native gRPC data plane
(``csrc/host/dataplane.cpp``, the port's own copy of the JAX package's
C++ source).

The Python gRPC fabric spends host time under the GIL on every query; the
native plane moves the transport, the parse of a plain Search request, the
coalescing of requests into batches and the building of replies into C++
over the system libnghttp2, and hands Python one coalesced device dispatch
per batch plus the raw request bytes of everything else
(``api/grpc/native_plane.py``).

Loading: the first call builds ``csrc/host/dataplane.cpp`` with
``g++ -O3 -fPIC -shared -std=c++17 ... -l:libnghttp2.so.14 -lpthread``
into ``build/torch_native/`` beside the package, under a name that carries
a hash of the source and flags (``native.build_and_load``: per-process
temporary file, atomic rename). The source compiles against its own ABI
header (``nghttp2_abi.h``), so only the runtime library is needed.
``available()`` is False when the library (or libnghttp2.so.14) is
absent, or under ``WEAVIATE_TPU_NO_NATIVE=1``; the server then serves the
Python gRPC server, which stays the default unless
``WEAVIATE_TPU_NATIVE_DATAPLANE=1``. The JAX package's library is never
loaded.
"""

from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass

import numpy as np

from weaviate_tpu_torch import native

SRC = os.path.join(os.path.dirname(native.SRC), "dataplane.cpp")
LINK = ["-l:libnghttp2.so.14", "-lpthread"]

_lib = None
_tried = False
_lock = threading.Lock()
build_seconds: float | None = None  # the g++ run of this process, if it built


def library_path() -> str:
    """Where the plane's library for the current source and flags lives."""
    return native._hashed_path(SRC, "dataplane", native.CXX_FLAGS + LINK)


def _load():
    global _lib, _tried, build_seconds
    with _lock:
        if _tried:
            return _lib
        _tried = True
        lib, build_seconds = native.build_and_load(SRC, library_path(), LINK)
        if lib is None:
            return None
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        u64 = ctypes.c_uint64
        i64p = ctypes.POINTER(i64)
        u64p = ctypes.POINTER(u64)
        i32p = ctypes.POINTER(i32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        for name, args, res in [
            ("dp_start", [i32, i32, i32], i32),
            ("dp_stop", [], None),
            ("dp_register_collection", [ctypes.c_char_p, i32], i32),
            ("dp_cache_put", [i32, i64, i64p, u8p, u8p, i64p], None),
            ("dp_cache_clear", [i32], None),
            ("dp_wait",
             [i32, i32p, i64p, u64p, i32p, f32p, u64p, ctypes.c_char_p,
              i32, i64p], i32),
            ("dp_fallback_payload", [u64, u8p], None),
            ("dp_post_raw", [u64, u8p, i64, i32, ctypes.c_char_p], None),
            ("dp_post_batch",
             [i32, i64, u64p, i32p, i64, i64p, f32p, i64p, ctypes.c_float,
              u64p], i64),
            ("dp_stats", [u64p, u64p], None),
            ("dp_cache_stats", [i32, i64p, u64p, u64p], None),
            ("dp_bench",
             [i32, i32, i32, i32, i32, u8p, i64, ctypes.POINTER(
                 ctypes.c_double), f32p, f32p, f32p, i64p], i64),
        ]:
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


@dataclass
class SearchBatch:
    coll_id: int
    tokens: np.ndarray   # uint64 [n]
    ks: np.ndarray       # int32 [n]
    queries: np.ndarray  # float32 [n, dim]


@dataclass
class FallbackRequest:
    token: int
    method: str
    payload: bytes


class DataPlane:
    """One process-wide native data plane instance."""

    MAX_BATCH = 128

    def __init__(self, port: int = 0, max_batch: int = 0,
                 window_us: int = 0, max_dim: int = 4096):
        lib = _load()
        if lib is None:
            raise RuntimeError("native data plane unavailable")
        self._lib = lib
        self.max_batch = max_batch or self.MAX_BATCH
        self.max_dim = max_dim
        p = lib.dp_start(port, self.max_batch, window_us)
        if p < 0:
            raise OSError(-p, "dp_start failed")
        self.port = int(p)
        self._dims: dict[int, int] = {}
        # reusable dp_wait buffers (one waiter thread)
        self._tokens = np.empty(self.max_batch, np.uint64)
        self._ks = np.empty(self.max_batch, np.int32)
        self._qbuf = np.empty(self.max_batch * max_dim, np.float32)

    def stop(self):
        self._lib.dp_stop()

    def register_collection(self, name: str, dim: int) -> int:
        if dim <= 0 or dim > self.max_dim:
            # the dp_wait query buffer is sized max_batch * max_dim: wider
            # collections stay on the fallback path
            return -1
        cid = self._lib.dp_register_collection(name.encode(), int(dim))
        if cid >= 0:
            self._dims[cid] = int(dim)
        return cid

    def cache_put(self, coll_id: int, doc_ids, uuids: list[str],
                  props: list[bytes]):
        doc_ids = np.ascontiguousarray(doc_ids, dtype=np.int64)
        ub = "".join(uuids).encode("ascii")
        assert len(ub) == 36 * len(doc_ids)
        ua = np.frombuffer(ub, np.uint8)
        blob = b"".join(props)
        poffs = np.zeros(len(props) + 1, np.int64)
        np.cumsum([len(p) for p in props], out=poffs[1:])
        pa = np.frombuffer(blob, np.uint8) if blob else np.zeros(1, np.uint8)
        self._lib.dp_cache_put(coll_id, len(doc_ids),
                               _ptr(doc_ids, ctypes.c_int64),
                               _ptr(ua, ctypes.c_uint8),
                               _ptr(pa, ctypes.c_uint8),
                               _ptr(poffs, ctypes.c_int64))

    def wait(self, timeout_ms: int = 200):
        """None (timeout) | SearchBatch | FallbackRequest | 'stopped'."""
        coll = ctypes.c_int32(0)
        count = ctypes.c_int64(0)
        token = ctypes.c_uint64(0)
        plen = ctypes.c_int64(0)
        mbuf = ctypes.create_string_buffer(256)
        kind = self._lib.dp_wait(
            timeout_ms, ctypes.byref(coll), ctypes.byref(count),
            _ptr(self._tokens, ctypes.c_uint64),
            _ptr(self._ks, ctypes.c_int32),
            _ptr(self._qbuf, ctypes.c_float), ctypes.byref(token), mbuf,
            256, ctypes.byref(plen))
        if kind == 0:
            return None
        if kind == 3:
            return "stopped"
        if kind == 1:
            n = count.value
            dim = self._dims.get(coll.value, 0)
            return SearchBatch(
                coll_id=coll.value, tokens=self._tokens[:n].copy(),
                ks=self._ks[:n].copy(),
                queries=self._qbuf[:n * dim].reshape(n, dim).copy())
        payload = np.empty(max(plen.value, 1), np.uint8)
        self._lib.dp_fallback_payload(token.value,
                                      _ptr(payload, ctypes.c_uint8))
        return FallbackRequest(token=token.value,
                               method=mbuf.value.decode(),
                               payload=payload[:plen.value].tobytes())

    def post_raw(self, token: int, reply: bytes, status: int = 0,
                 message: str = ""):
        buf = np.frombuffer(reply, np.uint8) if reply else \
            np.zeros(1, np.uint8)
        self._lib.dp_post_raw(ctypes.c_uint64(token),
                              _ptr(buf, ctypes.c_uint8), len(reply),
                              status, message.encode() or None)

    def post_batch(self, batch: SearchBatch, ids: np.ndarray,
                   dists: np.ndarray, counts: np.ndarray,
                   took_s: float) -> np.ndarray:
        """Returns the tokens the C++ side could not serve (cache misses)."""
        n, kmax = ids.shape
        ids = np.ascontiguousarray(ids, np.int64)
        dists = np.ascontiguousarray(dists, np.float32)
        counts = np.ascontiguousarray(counts, np.int64)
        miss = np.empty(n, np.uint64)
        tokens = np.ascontiguousarray(batch.tokens, np.uint64)
        ks = np.ascontiguousarray(batch.ks, np.int32)
        nm = self._lib.dp_post_batch(
            batch.coll_id, n, _ptr(tokens, ctypes.c_uint64),
            _ptr(ks, ctypes.c_int32), kmax, _ptr(ids, ctypes.c_int64),
            _ptr(dists, ctypes.c_float), _ptr(counts, ctypes.c_int64),
            ctypes.c_float(took_s), _ptr(miss, ctypes.c_uint64))
        return miss[:nm].copy()

    def stats(self) -> tuple[int, int]:
        """(fast-path requests, fallback requests) since the plane started."""
        fast = ctypes.c_uint64(0)
        fb = ctypes.c_uint64(0)
        self._lib.dp_stats(ctypes.byref(fast), ctypes.byref(fb))
        return fast.value, fb.value

    def cache_stats(self, coll_id: int = -1) -> dict:
        """Reply-cache accounting: cached doc entries for ``coll_id`` (-1 =
        all collections) and the C++ reply builder's per-doc hit and miss
        counts — ``misses`` flat after a warm pass means the object fetch
        of the hot path never re-entered Python."""
        entries = ctypes.c_int64(0)
        hits = ctypes.c_uint64(0)
        misses = ctypes.c_uint64(0)
        self._lib.dp_cache_stats(coll_id, ctypes.byref(entries),
                                 ctypes.byref(hits), ctypes.byref(misses))
        return {"entries": entries.value, "hits": hits.value,
                "misses": misses.value}


def bench(port: int, conns: int, streams: int, duration_ms: int, dim: int,
          request_head: bytes) -> dict:
    """The native load generator against a Search endpoint (this plane or
    any gRPC server speaking the same proto). ``request_head``: a
    serialized SearchRequest WITHOUT near_vector (collection, limit,
    metadata, flags); the generator adds random query vectors."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native data plane unavailable")
    head = np.frombuffer(request_head, np.uint8)
    qps = ctypes.c_double(0)
    p50 = ctypes.c_float(0)
    p95 = ctypes.c_float(0)
    p99 = ctypes.c_float(0)
    errors = ctypes.c_int64(0)
    done = lib.dp_bench(port, conns, streams, duration_ms, dim,
                        _ptr(head, ctypes.c_uint8), len(request_head),
                        ctypes.byref(qps), ctypes.byref(p50),
                        ctypes.byref(p95), ctypes.byref(p99),
                        ctypes.byref(errors))
    return {"done": int(done), "qps": qps.value, "p50_ms": p50.value,
            "p95_ms": p95.value, "p99_ms": p99.value,
            "errors": int(errors.value)}
