"""Host-side codecs, set algebra, the postings memtable and the HNSW graph
walker: the port's own C++ library (``csrc/host/weaviate_native.cpp``)
over ctypes, with numpy versions as the fallback.

Loading strategy:

1. the first call builds ``csrc/host/weaviate_native.cpp`` with
   ``g++ -O3 -fPIC -shared -std=c++17`` into ``build/torch_native/``
   beside the package, under a file name that carries a hash of the
   source and the flags, so an edited source never loads a stale build;
   the build goes to a per-process temporary file that is renamed into
   place, so processes building at once never load a half-written
   library;
2. ``WEAVIATE_TPU_NO_NATIVE=1``, a missing ``g++`` or a failed build take
   the numpy versions below: the same answers and the same bytes on disk.
   These are host codecs, not kernels, so the fallback is kept.

``available()`` reports which path is active. The JAX package's library
(``weaviate_tpu/native``) is never loaded. The entry points that exist
only in the library (``PostingsTable``, ``HnswNative``) raise without
it, and ``analyze_batch`` / ``storobj_encode_batch`` return None: their
callers keep their Python paths then.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_PKG, "csrc", "host", "weaviate_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_native")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib = None
_tried = False
_lock = threading.Lock()
build_seconds: float | None = None  # the g++ run of this process, if it built


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"weaviate_native-{h.hexdigest()[:12]}.so")


def _build_and_load():
    """Build if needed, then dlopen. Returns the CDLL, or None: the numpy
    path is safer than a library that failed to build or load."""
    global build_seconds
    if os.environ.get("WEAVIATE_TPU_NO_NATIVE"):
        return None
    try:
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC], check=True,
                           capture_output=True, timeout=300, cwd=os.path.dirname(SRC))
            os.replace(tmp, so)  # atomic: no process loads a half-written file
            build_seconds = time.perf_counter() - t0
        return ctypes.CDLL(so)
    except (OSError, subprocess.SubprocessError):
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        lib = _build_and_load()
        if lib is None:
            return None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        vp = ctypes.c_void_p
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32
        for name, args, res in [
            ("wn_intersect_u64", [u64p, i64, u64p, i64, u64p], i64),
            ("wn_union_u64", [u64p, i64, u64p, i64, u64p], i64),
            ("wn_difference_u64", [u64p, i64, u64p, i64, u64p], i64),
            ("wn_membership_i64", [i64p, i64, u64p, i64, u8p], None),
            ("wn_varint_encode_u64", [u64p, i64, u8p], i64),
            ("wn_varint_decode_u64", [u8p, i64, u64p, i64], i64),
            ("wn_merge_topk", [f32p, i64p, i64, i64, i64, f32p, i64p], None),
            ("wn_analyze_batch", [u8p, i64p, i64, i32, i64p, i64p, i64p], i64),
            ("wn_analyze_fetch", [u8p, i64p, i64p, i64p, u32p, i64p], None),
            ("wn_varint_encode_many", [u64p, i64p, i64, u8p, i64p], i64),
            ("wn_storobj_encode_batch",
             [u8p, i64p, u8p, i64p, f32p, i32, i64p, i64p, i64p, i64, u8p, i64p], i64),
            ("wn_pt_new", [i32], vp),
            ("wn_pt_free", [vp], None),
            ("wn_pt_bytes", [vp], i64),
            ("wn_pt_count", [vp], i64),
            ("wn_pt_map_columns",
             [vp, u8p, i64, u8p, i64p, i64, i64p, i64p, u32p, u32p, i32], i64),
            ("wn_pt_map_delete", [vp, u8p, i64, u8p, i64p, i64, i64p, i64p], None),
            ("wn_pt_roar", [vp, u8p, i64, u8p, i64p, i64, i64p, u64p, i32, i32], i64),
            ("wn_pt_tomb", [vp, u8p, i64], None),
            ("wn_pt_items", [vp, u8p, i64, u8p, i64], i64),
            ("wn_pt_get", [vp, u8p, i64], i64),
            ("wn_pt_fetch", [u8p], None),
            ("wn_hnsw_new", [i32, i32], vp),
            ("wn_hnsw_free", [vp], None),
            ("wn_hnsw_reset", [vp, i64], None),
            ("wn_hnsw_set_vectors", [vp, i64, i64, f32p], None),
            ("wn_hnsw_set_links", [vp, i64, i32, i32, i32p], None),
            ("wn_hnsw_set_links_batch", [vp, i64, i64p, i32p, i32p, i32p], None),
            ("wn_hnsw_clear_links", [vp, i64], None),
            ("wn_hnsw_set_tombstones", [vp, i64p, i64, i32], None),
            ("wn_hnsw_search_layer", [vp, f32p, i64, i32, i64p, f32p, i64, i64p, f32p], i64),
            ("wn_hnsw_search", [vp, f32p, i64, i64, i64, i32, u8p, i64p, f32p], i64),
        ]:
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _u64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint64))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---- sorted uint64 set algebra -------------------------------------------


# The numpy versions merge by binary search or a run-merging sort instead
# of np.unique: the inputs are already sorted and unique, and numpy >= 2.3
# takes a hash path there that is several times slower on these postings.

def _in_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """For each a[i]: is it in the ascending array b?"""
    if len(b) == 0:
        return np.zeros(len(a), dtype=bool)
    pos = np.searchsorted(b, a)
    pos[pos == len(b)] = len(b) - 1
    return b[pos] == a


def intersect_sorted(a, b) -> np.ndarray:
    """Intersection of two ascending unique uint64 arrays."""
    a, b = _u64(a), _u64(b)
    lib = _load()
    if lib is None or min(len(a), len(b)) == 0:
        return a[_in_sorted(a, b)]
    out = np.empty(min(len(a), len(b)), dtype=np.uint64)
    n = lib.wn_intersect_u64(_ptr(a, ctypes.c_uint64), len(a), _ptr(b, ctypes.c_uint64),
                             len(b), _ptr(out, ctypes.c_uint64))
    return out[:n]


def union_sorted(a, b) -> np.ndarray:
    """Union of two ascending unique uint64 arrays, ascending."""
    a, b = _u64(a), _u64(b)
    lib = _load()
    if lib is None:
        c = np.concatenate([a, b])
        c.sort(kind="stable")  # two sorted runs: a linear merge
        if len(c) < 2:
            return c
        keep = np.empty(len(c), dtype=bool)
        keep[0] = True
        np.not_equal(c[1:], c[:-1], out=keep[1:])
        return c[keep]
    out = np.empty(len(a) + len(b), dtype=np.uint64)
    n = lib.wn_union_u64(_ptr(a, ctypes.c_uint64), len(a), _ptr(b, ctypes.c_uint64), len(b),
                         _ptr(out, ctypes.c_uint64))
    return out[:n]


def difference_sorted(a, b) -> np.ndarray:
    """a \\ b for ascending unique uint64 arrays."""
    a, b = _u64(a), _u64(b)
    lib = _load()
    if lib is None or len(a) == 0:
        return a[~_in_sorted(a, b)]
    out = np.empty(len(a), dtype=np.uint64)
    n = lib.wn_difference_u64(_ptr(a, ctypes.c_uint64), len(a), _ptr(b, ctypes.c_uint64),
                              len(b), _ptr(out, ctypes.c_uint64))
    return out[:n]


def membership(vals, allow_sorted) -> np.ndarray:
    """Bool mask: vals[i] >= 0 and vals[i] in allow_sorted (ascending u64).
    The doc-id allow-list test of filtered vector search
    (engine/flat.py ``_allow_mask``)."""
    vals = np.ascontiguousarray(np.asarray(vals, dtype=np.int64))
    allow = _u64(allow_sorted)
    lib = _load()
    if lib is None:
        return (vals >= 0) & np.isin(vals, allow.astype(np.int64))
    out = np.empty(len(vals), dtype=np.uint8)
    lib.wn_membership_i64(_ptr(vals, ctypes.c_int64), len(vals), _ptr(allow, ctypes.c_uint64),
                          len(allow), _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


# ---- varint delta codec ---------------------------------------------------


def _varint_encode_py(vals: np.ndarray) -> bytes:
    out = bytearray()
    prev = 0
    for v in vals.tolist():
        d = v - prev
        prev = v
        while d >= 0x80:
            out.append((d & 0x7F) | 0x80)
            d >>= 7
        out.append(d)
    return bytes(out)


def varint_encode(vals) -> bytes:
    """Ascending uint64 -> delta + LEB128 bytes (posting-block codec)."""
    vals = _u64(vals)
    if len(vals) <= 16:
        # a ctypes round trip costs more than encoding a tiny block in Python
        return _varint_encode_py(vals)
    lib = _load()
    if lib is None:
        return _varint_encode_py(vals)
    out = np.empty(len(vals) * 10 or 1, dtype=np.uint8)
    n = lib.wn_varint_encode_u64(_ptr(vals, ctypes.c_uint64), len(vals),
                                 _ptr(out, ctypes.c_uint8))
    return out[:n].tobytes()


def varint_decode(buf: bytes, count_hint: int | None = None) -> np.ndarray:
    """Decode a varint-delta block. ``count_hint`` is the declared element
    count from the surrounding record; a block holding another number of
    values raises (corrupt/truncated data) — the count field is untrusted
    on-disk input."""
    lib = None if len(buf) <= 32 else _load()  # a ctypes round trip > a tiny decode
    if lib is None:
        out, prev, d, shift = [], 0, 0, 0
        for byte in buf:
            if shift > 63:
                raise ValueError("corrupt varint block: over-long varint")
            d |= (byte & 0x7F) << shift
            if byte & 0x80:
                shift += 7
            else:
                prev += d
                out.append(prev)
                d, shift = 0, 0
        if count_hint is not None and len(out) != count_hint:
            raise ValueError(
                f"corrupt varint block: {len(out)} values, {count_hint} declared")
        return np.asarray(out, dtype=np.uint64)
    arr = np.ascontiguousarray(np.frombuffer(buf, dtype=np.uint8))
    # every value takes >= 1 byte, so len(buf) bounds the count — the
    # declared count is untrusted and never sizes an allocation alone
    cap = len(buf) if count_hint is None else min(count_hint, len(buf))
    out = np.empty(max(cap, 1), dtype=np.uint64)
    n = lib.wn_varint_decode_u64(_ptr(arr, ctypes.c_uint8), len(arr),
                                 _ptr(out, ctypes.c_uint64), cap)
    if n < 0:
        raise ValueError("corrupt varint block: over-long varint")
    if count_hint is not None and n != count_hint:
        raise ValueError(f"corrupt varint block: {n} values, {count_hint} declared")
    return out[:n]


def varint_encode_many(arrays: list[np.ndarray]) -> list[bytes]:
    """Encode many ascending-u64 blocks in one call; one bytes object per
    block."""
    lib = _load()
    if lib is None or not arrays:
        return [varint_encode(a) for a in arrays]
    concat = np.concatenate([_u64(a) for a in arrays])
    offs = np.zeros(len(arrays) + 1, dtype=np.int64)
    np.cumsum([len(a) for a in arrays], out=offs[1:])
    out = np.empty(max(int(offs[-1]) * 10, 1), dtype=np.uint8)
    lens = np.empty(len(arrays), dtype=np.int64)
    total = lib.wn_varint_encode_many(
        _ptr(concat if len(concat) else np.zeros(1, np.uint64), ctypes.c_uint64),
        _ptr(offs, ctypes.c_int64), len(arrays), _ptr(out, ctypes.c_uint8),
        _ptr(lens, ctypes.c_int64))
    blob = out[:total].tobytes()
    res = []
    pos = 0
    for n in lens.tolist():
        res.append(blob[pos:pos + n])
        pos += n
    return res


# ---- cross-shard top-k merge ----------------------------------------------


def merge_topk_host(dists: np.ndarray, ids: np.ndarray, k: int):
    """Merge [L, len] ascending per-shard candidates into global top-k.

    ids < 0 mark dead tail slots. Returns (dists [k] f32, ids [k] i64),
    padded with (3e38, -1); ties keep the earlier list's entry first."""
    dists = np.ascontiguousarray(np.asarray(dists, dtype=np.float32))
    ids = np.ascontiguousarray(np.asarray(ids, dtype=np.int64))
    if dists.ndim == 1:
        dists, ids = dists[None, :], ids[None, :]
    lib = _load()
    if lib is None:
        flat_d, flat_i = dists.ravel(), ids.ravel()
        live = flat_i >= 0
        flat_d, flat_i = flat_d[live], flat_i[live]
        order = np.argsort(flat_d, kind="stable")[:k]
        out_d = np.full(k, 3.0e38, dtype=np.float32)
        out_i = np.full(k, -1, dtype=np.int64)
        out_d[: len(order)] = flat_d[order]
        out_i[: len(order)] = flat_i[order]
        return out_d, out_i
    out_d = np.empty(k, dtype=np.float32)
    out_i = np.empty(k, dtype=np.int64)
    lib.wn_merge_topk(_ptr(dists, ctypes.c_float), _ptr(ids, ctypes.c_int64), dists.shape[0],
                      dists.shape[1], k, _ptr(out_d, ctypes.c_float), _ptr(out_i, ctypes.c_int64))
    return out_d, out_i


# ---- batch storobj frame encoder ------------------------------------------


def storobj_encode_batch(uuid_strs: list[bytes], props_blobs: list[bytes],
                         vectors: np.ndarray, doc_ids: np.ndarray,
                         created_ms: np.ndarray, updated_ms: np.ndarray):
    """Encode N storage-object value frames (a single unnamed vector each)
    in one native call; byte-identical to StorageObject.to_bytes.

    ``uuid_strs``: canonical-form uuid strings as bytes; ``props_blobs``:
    caller-msgpacked property dicts; ``vectors``: [n, dim] f32. Returns a
    list of ``bytes`` frames, or None when the library is unavailable or a
    uuid fails the fast parse (callers take the per-object encoder).
    """
    lib = _load()
    if lib is None:
        return None
    n, dim = vectors.shape
    uuids = b"".join(uuid_strs)
    uoffs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(u) for u in uuid_strs], out=uoffs[1:])
    props = b"".join(props_blobs)
    poffs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(b) for b in props_blobs], out=poffs[1:])
    # fixed part: 41 header + 4 n_vecs + 2 name_len + 4 dim + 4 props_len
    frame_offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.diff(poffs) + (55 + 4 * dim), out=frame_offs[1:])
    out = np.empty(int(frame_offs[-1]), dtype=np.uint8)
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    doc_ids = np.ascontiguousarray(doc_ids, dtype=np.int64)
    created_ms = np.ascontiguousarray(created_ms, dtype=np.int64)
    updated_ms = np.ascontiguousarray(updated_ms, dtype=np.int64)
    ub = np.frombuffer(uuids, dtype=np.uint8) if uuids else np.empty(0, np.uint8)
    pb = np.frombuffer(props, dtype=np.uint8) if props else np.empty(0, np.uint8)
    rc = lib.wn_storobj_encode_batch(
        _ptr(ub, ctypes.c_uint8), _ptr(uoffs, ctypes.c_int64),
        _ptr(pb, ctypes.c_uint8), _ptr(poffs, ctypes.c_int64),
        _ptr(vectors, ctypes.c_float), ctypes.c_int32(dim),
        _ptr(doc_ids, ctypes.c_int64), _ptr(created_ms, ctypes.c_int64),
        _ptr(updated_ms, ctypes.c_int64), ctypes.c_int64(n),
        _ptr(out, ctypes.c_uint8), _ptr(frame_offs, ctypes.c_int64))
    if rc != 0:
        return None
    # one copy per frame: each slice is a view, .tobytes() copies just it
    return [out[frame_offs[i]:frame_offs[i + 1]].tobytes() for i in range(n)]


# ---- batch text analyzer --------------------------------------------------

_MODE_BY_TOKENIZATION = {"word": 0, "lowercase": 1, "whitespace": 2, "field": 3}


def analyze_batch(values: list[str], tokenization: str):
    """Tokenize and accumulate a batch of ASCII text values in one native
    call (the import hot loop).

    Returns (terms [list of bytes, sorted], entry_offs [nterms+1],
    entry_rows [E], entry_tfs [E], row_tokens [nrows]): for each term, the
    rows / tfs slice [entry_offs[t]:entry_offs[t+1]] gives the value
    indices holding it and their term frequencies (rows ascending).
    Returns None when the library is unavailable (callers take the Python
    tokenizer).
    """
    lib = _load()
    if lib is None:
        return None
    mode = _MODE_BY_TOKENIZATION[tokenization]
    blob = "".join(values).encode("ascii")
    offs = np.zeros(len(values) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in values], out=offs[1:])
    nterms = ctypes.c_int64()
    nentries = ctypes.c_int64()
    termbytes = ctypes.c_int64()
    blob_arr = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, dtype=np.uint8)
    lib.wn_analyze_batch(
        _ptr(np.ascontiguousarray(blob_arr), ctypes.c_uint8), _ptr(offs, ctypes.c_int64),
        len(values), mode, ctypes.byref(nterms), ctypes.byref(nentries),
        ctypes.byref(termbytes))
    nt, ne, tb = nterms.value, nentries.value, termbytes.value
    terms_blob = np.empty(max(tb, 1), dtype=np.uint8)
    term_offs = np.empty(nt + 1, dtype=np.int64)
    entry_offs = np.empty(nt + 1, dtype=np.int64)
    entry_rows = np.empty(max(ne, 1), dtype=np.int64)
    entry_tfs = np.empty(max(ne, 1), dtype=np.uint32)
    row_tokens = np.empty(max(len(values), 1), dtype=np.int64)
    lib.wn_analyze_fetch(
        _ptr(terms_blob, ctypes.c_uint8), _ptr(term_offs, ctypes.c_int64),
        _ptr(entry_offs, ctypes.c_int64), _ptr(entry_rows, ctypes.c_int64),
        _ptr(entry_tfs, ctypes.c_uint32), _ptr(row_tokens, ctypes.c_int64))
    raw = terms_blob.tobytes()
    # terms stay bytes: every consumer (posting keys, cache keys) wants
    # prefix + term as bytes
    terms = [raw[term_offs[t]:term_offs[t + 1]] for t in range(nt)]
    return (terms, entry_offs, entry_rows[:ne], entry_tfs[:ne], row_tokens[:len(values)])


# ---- HNSW graph walker (wn_hnsw_*) ----------------------------------------

# HNSW metric names -> native metric ids (csrc hnsw_dist)
_HNSW_METRIC_IDS = {"l2-squared": 0, "dot": 1, "cosine": 2, "cosine-dot": 2,
                    "manhattan": 3, "hamming": 4}


def hnsw_supported(metric: str) -> bool:
    return available() and metric in _HNSW_METRIC_IDS


class HnswNative:
    """Native mirror of an HNSW graph: the graph-search hot loop in C++
    over a mirrored copy of a Python graph, which its owner keeps current
    incrementally (links, vector writes, tombstones) and re-uploads in one
    batched sync after bulk mutations. There is no numpy fallback: without
    the library the owner keeps its Python walker."""

    def __init__(self, dim: int, metric: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.dim = int(dim)
        self._h = ctypes.c_void_p(lib.wn_hnsw_new(self.dim, _HNSW_METRIC_IDS[metric]))

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.wn_hnsw_free(self._h)
                self._h = None
        except Exception:
            pass

    def reset(self, cap: int):
        self._lib.wn_hnsw_reset(self._h, int(cap))

    def set_vectors(self, slot0: int, vecs: np.ndarray):
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        self._lib.wn_hnsw_set_vectors(self._h, int(slot0), len(vecs),
                                      _ptr(vecs, ctypes.c_float))

    def set_links(self, slot: int, layer: int, neigh: np.ndarray):
        neigh = np.ascontiguousarray(neigh, dtype=np.int32)
        self._lib.wn_hnsw_set_links(self._h, int(slot), int(layer), len(neigh),
                                    _ptr(neigh, ctypes.c_int32))

    def set_links_batch(self, slots: np.ndarray, layers: np.ndarray,
                        counts: np.ndarray, neigh: np.ndarray):
        slots = np.ascontiguousarray(slots, dtype=np.int64)
        layers = np.ascontiguousarray(layers, dtype=np.int32)
        counts = np.ascontiguousarray(counts, dtype=np.int32)
        neigh = np.ascontiguousarray(neigh, dtype=np.int32)
        self._lib.wn_hnsw_set_links_batch(
            self._h, len(slots), _ptr(slots, ctypes.c_int64), _ptr(layers, ctypes.c_int32),
            _ptr(counts, ctypes.c_int32), _ptr(neigh, ctypes.c_int32))

    def clear_links(self, slot: int):
        self._lib.wn_hnsw_clear_links(self._h, int(slot))

    def set_tombstones(self, slots, val: bool = True):
        slots = np.ascontiguousarray(slots, dtype=np.int64)
        if len(slots) == 0:
            return
        self._lib.wn_hnsw_set_tombstones(self._h, _ptr(slots, ctypes.c_int64), len(slots),
                                         1 if val else 0)

    def search_layer(self, q: np.ndarray, ef: int, layer: int,
                     ep_slots: np.ndarray, ep_dists: np.ndarray):
        """One-layer ef-search (the insert path). Returns (dists, slots)
        ascending; tombstoned nodes included, as in the Python walker."""
        q = np.ascontiguousarray(q, dtype=np.float32)
        ep_slots = np.ascontiguousarray(ep_slots, dtype=np.int64)
        ep_dists = np.ascontiguousarray(ep_dists, dtype=np.float32)
        cap = int(ef) + len(ep_slots)
        out_s = np.empty(cap, dtype=np.int64)
        out_d = np.empty(cap, dtype=np.float32)
        n = self._lib.wn_hnsw_search_layer(
            self._h, _ptr(q, ctypes.c_float), int(ef), int(layer),
            _ptr(ep_slots, ctypes.c_int64), _ptr(ep_dists, ctypes.c_float), len(ep_slots),
            _ptr(out_s, ctypes.c_int64), _ptr(out_d, ctypes.c_float))
        return out_d[:n], out_s[:n]

    def search(self, q: np.ndarray, k: int, ef: int, ep: int,
               max_level: int, allow: np.ndarray | None = None):
        """Query search: greedy descent, the layer-0 ef-search and the
        live / allowed output filter. Returns (dists, slots) ascending."""
        q = np.ascontiguousarray(q, dtype=np.float32)
        out_s = np.empty(max(int(k), 1), dtype=np.int64)
        out_d = np.empty(max(int(k), 1), dtype=np.float32)
        ap = None
        if allow is not None:
            allow = np.ascontiguousarray(allow, dtype=np.uint8)
            ap = _ptr(allow, ctypes.c_uint8)
        n = self._lib.wn_hnsw_search(
            self._h, _ptr(q, ctypes.c_float), int(k), int(ef), int(ep), int(max_level), ap,
            _ptr(out_s, ctypes.c_int64), _ptr(out_d, ctypes.c_float))
        return out_d[:n], out_s[:n]


# ---- postings memtable (wn_pt_*) --------------------------------------------


def _keys_blob(keys: list[bytes]):
    blob = b"".join(keys)
    offs = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum([len(k) for k in keys], out=offs[1:])
    return (np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, np.uint8)), offs


_EMPTY_U8 = np.zeros(1, dtype=np.uint8)


class PostingsTable:
    """Native memtable for the "map" / "roaringset" LSM strategies.

    One instance backs one storage/kv.py ``_Memtable``; the Python dict
    memtable is the fallback (WEAVIATE_TPU_NO_NATIVE=1) and its oracle.
    Batched writes return the WAL frame payload produced in the same
    native call; reads come back as msgpack documents in the exact shapes
    kv.py ``_unpack_value`` produces.
    """

    def __init__(self, strategy: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.strategy = strategy
        self._h = ctypes.c_void_p(lib.wn_pt_new(0 if strategy == "map" else 1))

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.wn_pt_free(self._h)
                self._h = None
        except Exception:
            pass

    @property
    def bytes(self) -> int:
        return self._lib.wn_pt_bytes(self._h)

    def __len__(self) -> int:
        return self._lib.wn_pt_count(self._h)

    def _fetch(self, n: int) -> bytes:
        out = np.empty(max(n, 1), dtype=np.uint8)
        self._lib.wn_pt_fetch(_ptr(out, ctypes.c_uint8))
        return out[:n].tobytes()

    def map_columns(self, keys: list[bytes], entry_offs: np.ndarray,
                    docs: np.ndarray, tfs: np.ndarray, lens: np.ndarray,
                    prefix: bytes = b"", frame: bool = True) -> bytes | None:
        """Apply per-key postings columns; returns the "P" WAL frame."""
        kb, koffs = _keys_blob(keys)
        docs = np.ascontiguousarray(docs, dtype=np.int64)
        tfs = np.ascontiguousarray(tfs, dtype=np.uint32)
        lens = np.ascontiguousarray(lens, dtype=np.uint32)
        entry_offs = np.ascontiguousarray(entry_offs, dtype=np.int64)
        pfx = np.frombuffer(prefix, dtype=np.uint8) if prefix else _EMPTY_U8
        n = self._lib.wn_pt_map_columns(
            self._h, _ptr(pfx, ctypes.c_uint8), len(prefix),
            _ptr(kb, ctypes.c_uint8), _ptr(koffs, ctypes.c_int64), len(keys),
            _ptr(entry_offs, ctypes.c_int64),
            _ptr(docs if len(docs) else np.zeros(1, np.int64), ctypes.c_int64),
            _ptr(tfs if len(tfs) else np.zeros(1, np.uint32), ctypes.c_uint32),
            _ptr(lens if len(lens) else np.zeros(1, np.uint32), ctypes.c_uint32),
            1 if frame else 0)
        return self._fetch(n) if frame else None

    def map_delete(self, keys: list[bytes], entry_offs: np.ndarray, del_docs: np.ndarray):
        kb, koffs = _keys_blob(keys)
        del_docs = np.ascontiguousarray(del_docs, dtype=np.int64)
        entry_offs = np.ascontiguousarray(entry_offs, dtype=np.int64)
        self._lib.wn_pt_map_delete(
            self._h, _ptr(_EMPTY_U8, ctypes.c_uint8), 0,
            _ptr(kb, ctypes.c_uint8), _ptr(koffs, ctypes.c_int64), len(keys),
            _ptr(entry_offs, ctypes.c_int64),
            _ptr(del_docs if len(del_docs) else np.zeros(1, np.int64), ctypes.c_int64))

    def roar(self, keys: list[bytes], entry_offs: np.ndarray, ids: np.ndarray,
             is_del: bool = False, prefix: bytes = b"", frame: bool = True) -> bytes | None:
        """Apply per-key id blocks (unsorted ok); returns the "R" frame."""
        kb, koffs = _keys_blob(keys)
        ids = np.ascontiguousarray(ids, dtype=np.uint64)
        entry_offs = np.ascontiguousarray(entry_offs, dtype=np.int64)
        pfx = np.frombuffer(prefix, dtype=np.uint8) if prefix else _EMPTY_U8
        n = self._lib.wn_pt_roar(
            self._h, _ptr(pfx, ctypes.c_uint8), len(prefix),
            _ptr(kb, ctypes.c_uint8), _ptr(koffs, ctypes.c_int64), len(keys),
            _ptr(entry_offs, ctypes.c_int64),
            _ptr(ids if len(ids) else np.zeros(1, np.uint64), ctypes.c_uint64),
            1 if is_del else 0, 1 if frame else 0)
        return self._fetch(n) if frame else None

    def tomb(self, key: bytes):
        kb = np.frombuffer(key, dtype=np.uint8)
        self._lib.wn_pt_tomb(self._h, _ptr(kb, ctypes.c_uint8), len(key))

    def get_packed(self, key: bytes) -> bytes | None:
        """msgpack value for one key (kv.py _unpack_value shape), or None."""
        kb = np.frombuffer(key, dtype=np.uint8) if key else _EMPTY_U8
        n = self._lib.wn_pt_get(self._h, _ptr(kb, ctypes.c_uint8), len(key))
        if n < 0:
            return None
        return self._fetch(n)

    def packed_items(self, start: bytes | None = None, stop: bytes | None = None):
        """Ascending (key, msgpack-value) pairs in [start, stop)."""
        sb = np.frombuffer(start, dtype=np.uint8) if start else _EMPTY_U8
        tb = np.frombuffer(stop, dtype=np.uint8) if stop else _EMPTY_U8
        n = self._lib.wn_pt_items(
            self._h, _ptr(sb, ctypes.c_uint8), len(start) if start is not None else -1,
            _ptr(tb, ctypes.c_uint8), len(stop) if stop is not None else -1)
        blob = self._fetch(n)
        out = []
        pos = 0
        while pos < len(blob):
            kl = int.from_bytes(blob[pos:pos + 4], "little")
            pos += 4
            k = blob[pos:pos + kl]
            pos += kl
            vl = int.from_bytes(blob[pos:pos + 4], "little")
            pos += 4
            out.append((k, blob[pos:pos + vl]))
            pos += vl
        return out
