"""Per-shard inverted index: searchable postings, filterable values, BM25F.

Reference: adapters/repos/db/inverted/ — the analyzer feeds three LSM bucket
families (mapcollection postings with term frequencies for BM25,
roaringset bitmaps for filterable props, prop-length tracker for BM25
normalization). This implementation writes through the same three bucket
shapes at put time (reference: updateInvertedIndexLSM,
shard_write_put.go:454):

- ``inv_search``  (map)        key = prop\\x00term -> {doc: [tf, prop_len]}
                               (reference MapPair packs tf + propLength the
                               same way for BM25, inverted/bm25_searcher.go)
- ``inv_filter``  (roaringset) key = prop\\x00 + typed value key
- ``inv_numeric`` (roaringset) key = prop\\x00 + order-preserving f64 —
                               range filters are LSM range scans
- ``inv_geo``     (replace)    key = prop\\x00 + be64 doc -> (lat, lon)
- ``inv_null``    (roaringset) key = prop (reference IndexNullState)
- ``inv_meta``    (replace)    per-prop length aggregates + doc count

Opening a shard therefore does NOT replay objects into RAM: postings are
read (and LRU-cached) on demand at query time, merged across segments by
the LSM read path — reopen cost is O(segments), not O(objects).

Scoring is **MaxScore-pruned vectorized BM25F** (the vectorized analog of
the reference's WAND pivot pruning, bm25_searcher.go:100, block-max at
:551): terms sort by a cached per-posting score upper bound, the candidate
universe is the union of only the highest-impact ("essential") postings,
and the loop stops as soon as the summed upper bounds of the remaining
terms fall below the running k-th best score — provably identical top-k to
exhaustive scoring. High-df stop-like terms never expand the candidate
set; they are probed at candidate positions by binary search. Within the
candidate set, scoring stays whole-array vectorized (np.add.at
accumulation, closed-form BM25F) — pruning picks which docs to score, the
vector unit scores them in one pass.
"""

from __future__ import annotations

import math
import struct
import threading
from collections import OrderedDict
from datetime import datetime, timezone

import numpy as np

from weaviate_tpu_torch.schema.config import CollectionConfig, DataType, Property
from weaviate_tpu_torch.text.stopwords import StopwordDetector
from weaviate_tpu_torch.text.tokenizer import tokenize

B_SEARCH = "inv_search"
B_FILTER = "inv_filter"
B_NUMERIC = "inv_numeric"
B_GEO = "inv_geo"
B_NULL = "inv_null"
B_META = "inv_meta"

_ALL_DOCS = b"\x00__all__"
_SEP = b"\x00"


def parse_date(value) -> float:
    """ISO-8601 (or epoch number) → epoch seconds."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value)
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    dt = datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


def _enc_f64(x: float) -> bytes:
    """Order-preserving float64 encoding: byte order == numeric order."""
    x = float(x)
    if x == 0.0:
        x = 0.0  # -0.0 and +0.0 must share a key (dict semantics: -0.0 == 0.0)
    (u,) = struct.unpack(">Q", struct.pack(">d", x))
    if u & 0x8000000000000000:
        u = ~u & 0xFFFFFFFFFFFFFFFF
    else:
        u |= 0x8000000000000000
    return struct.pack(">Q", u)


def _dec_f64(b: bytes) -> float:
    (u,) = struct.unpack(">Q", b)
    if u & 0x8000000000000000:
        u &= 0x7FFFFFFFFFFFFFFF
    else:
        u = ~u & 0xFFFFFFFFFFFFFFFF
    return struct.unpack(">d", struct.pack(">Q", u))[0]


def _value_key(value) -> bytes | None:
    """Typed exact-match key for one filterable value (text tokens keyed
    as 't'+utf8 so LIKE can range-scan the text vocabulary)."""
    if isinstance(value, bool):
        return b"b\x01" if value else b"b\x00"
    if isinstance(value, (int, float)):
        return b"f" + _enc_f64(float(value))
    if isinstance(value, str):
        return b"t" + value.encode()
    return None


def _infer_type(value) -> str | None:
    """Auto-schema-lite: map a raw property value to a DataType (reference:
    usecases/objects/auto_schema.go infers types for unknown props)."""
    if isinstance(value, bool):
        return DataType.BOOL
    if isinstance(value, int):
        return DataType.INT
    if isinstance(value, float):
        return DataType.NUMBER
    if isinstance(value, str):
        return DataType.TEXT
    if isinstance(value, dict) and {"latitude", "longitude"} <= set(value):
        return DataType.GEO
    if isinstance(value, (list, tuple)) and value:
        inner = _infer_type(value[0])
        return f"{inner}[]" if inner in (DataType.TEXT, DataType.INT,
                                         DataType.NUMBER, DataType.BOOL) else None
    return None


_NUMERIC_TYPES = {DataType.INT, DataType.NUMBER, DataType.DATE,
                  DataType.INT_ARRAY, DataType.NUMBER_ARRAY, DataType.DATE_ARRAY}


class GeoGrid:
    """1-degree grid buckets over (lat, lon) rows, cell-sorted for
    range lookups by ``np.searchsorted``.

    Cells are keyed ``lat_cell * 360 + lon_cell``; the rows of one lat
    band are contiguous in the sorted arrays, so a query circle resolves
    to at most two searchsorted intervals per intersected lat band
    (longitude wrap splits one). Candidate rows then get the exact
    vectorized haversine — sublinear in the corpus for any selective
    radius, degrading gracefully to the full scan for planet-sized ones.
    """

    CELL_DEG = 1.0
    _LON_CELLS = 360

    def __init__(self, ids: np.ndarray, lats: np.ndarray, lons: np.ndarray):
        lat_c = np.clip(np.floor(lats + 90.0).astype(np.int64), 0, 179)
        lon_c = np.clip(np.floor(lons + 180.0).astype(np.int64), 0, 359)
        key = lat_c * self._LON_CELLS + lon_c
        order = np.argsort(key, kind="stable")
        self.ids = ids[order]
        self.lats = lats[order]
        self.lons = lons[order]
        self._keys = key[order]

    def __len__(self):
        return len(self.ids)

    def candidate_positions(self, lat: float, lon: float,
                            max_m: float) -> np.ndarray:
        """Positional indices (into the grid-sorted arrays) of every row
        whose cell intersects the query circle."""
        if not len(self.ids):
            return np.empty(0, np.int64)
        r_earth = 6_371_000.0
        ang = min(max_m / r_earth, math.pi)  # query radius, radians
        lat_span = math.degrees(ang)
        lat_lo = max(lat - lat_span, -90.0)
        lat_hi = min(lat + lat_span, 90.0)
        row_lo = int(np.clip(np.floor(lat_lo + 90.0), 0, 179))
        row_hi = int(np.clip(np.floor(lat_hi + 90.0), 0, 179))
        clat_r = math.radians(lat)
        cos_ang = math.cos(ang)

        def half_span_deg(phi_deg: float) -> float:
            """Longitude half-span of the circle at latitude phi (exact
            spherical law of cosines, solved for delta-lon)."""
            phi = math.radians(phi_deg)
            den = math.cos(clat_r) * math.cos(phi)
            num = cos_ang - math.sin(clat_r) * math.sin(phi)
            if den <= 1e-12:
                return 180.0 if num <= 0 else 0.0
            c = num / den
            if c <= -1.0:
                return 180.0
            if c >= 1.0:
                return 0.0
            return math.degrees(math.acos(c))

        # latitude maximizing the span (tangent point of the circle)
        sin_t = math.sin(clat_r) / max(cos_ang, 1e-12) if cos_ang > 0 else 2.0
        phi_star = math.degrees(math.asin(sin_t)) if abs(sin_t) <= 1 else None
        out = []
        for row in range(row_lo, row_hi + 1):
            lo_deg, hi_deg = row - 90.0, row - 89.0
            samples = [lo_deg, hi_deg]
            if phi_star is not None and lo_deg <= phi_star <= hi_deg:
                samples.append(phi_star)
            if lo_deg <= lat <= hi_deg:
                samples.append(lat)
            lon_span = max(half_span_deg(p) for p in samples)
            # cell granularity: pad by one cell to cover partial overlap
            lon_span = min(lon_span + self.CELL_DEG, 180.0)
            if lon_span >= 180.0 or row == 0 or row == 179:
                intervals = [(0, self._LON_CELLS - 1)]
            else:
                c_lo = math.floor(lon - lon_span + 180.0)
                c_hi = math.floor(lon + lon_span + 180.0)
                if c_lo < 0:
                    intervals = [(0, min(c_hi, 359)),
                                 (c_lo % 360, 359)]
                elif c_hi > 359:
                    intervals = [(c_lo, 359), (0, c_hi % 360)]
                else:
                    intervals = [(c_lo, c_hi)]
            base = row * self._LON_CELLS
            for a, b in intervals:
                lo = np.searchsorted(self._keys, base + a, side="left")
                hi = np.searchsorted(self._keys, base + b, side="right")
                if hi > lo:
                    out.append(np.arange(lo, hi, dtype=np.int64))
        if not out:
            return np.empty(0, np.int64)
        return np.concatenate(out)


class _LRU:
    """Tiny LRU for decoded posting/bitmap arrays (hot query terms)."""

    def __init__(self, cap: int = 65536):
        self.cap = cap
        self.d: OrderedDict = OrderedDict()

    def get(self, key):
        v = self.d.get(key)
        if v is not None:
            self.d.move_to_end(key)
        return v

    def put(self, key, value):
        self.d[key] = value
        self.d.move_to_end(key)
        if len(self.d) > self.cap:
            self.d.popitem(last=False)

    def pop(self, key):
        self.d.pop(key, None)

    def clear(self):
        self.d.clear()


class InvertedIndex:
    """All six bucket families for one shard, with RAM LRU caches in front.

    Thread-safety: a single RLock guards cache + meta mutations (writes
    come in under the shard lock anyway; queries take it to snapshot).
    """

    def __init__(self, config: CollectionConfig, store=None):
        self.config = config
        inv = config.inverted
        self.stopwords = StopwordDetector(inv.stopwords_preset,
                                          inv.stopwords_additions,
                                          inv.stopwords_removals)
        self.k1 = inv.bm25_k1
        self.b = inv.bm25_b
        self._lock = threading.RLock()
        if store is None:
            # tests construct an index without a shard store: back it with
            # an in-RAM KVStore in a temp dir? No — a throwaway tmpdir.
            import tempfile

            from weaviate_tpu_torch.storage.kv import KVStore

            self._own_dir = tempfile.TemporaryDirectory(prefix="inv-")
            store = KVStore(self._own_dir.name)
        self._store = store
        # postings_schema: the searchable map values are strictly
        # doc -> (tf, len), unlocking the native C++ memtable (kv.py)
        self.searchable_bucket = store.bucket(B_SEARCH, "map",
                                              postings_schema=True)
        self.filter_bucket = store.bucket(B_FILTER, "roaringset")
        self.numeric_bucket = store.bucket(B_NUMERIC, "roaringset")
        self.geo_bucket = store.bucket(B_GEO, "replace")
        self.null_bucket = store.bucket(B_NULL, "roaringset")
        self.meta_bucket = store.bucket(B_META, "replace")
        self._post_cache = _LRU()
        self._bitmap_cache = _LRU()
        self._geo_cache: dict[str, tuple] = {}
        # bumped under _lock on every mutation; readers capture it before
        # the (unlocked) bucket read and only cache if unchanged — a
        # concurrent write's invalidation can never be overwritten by a
        # stale fill
        self._version = 0
        self._meta = self.meta_bucket.get(b"__aggregates__") or {
            "doc_count": 0, "props": {}}
        # props that hold numeric/date ARRAYS: range semantics are
        # any-element, answered by the per-element numeric keys
        self.array_props: set[str] = set(self._meta.get("arrays", []))

    # -- schema helpers -------------------------------------------------------

    def _prop_schema(self, name: str, value) -> Property | None:
        p = self.config.property(name)
        if p is not None:
            return p
        dt = _infer_type(value)
        if dt is None:
            return None
        return Property(name=name, data_type=dt)

    @property
    def doc_count(self) -> int:
        return int(self._meta.get("doc_count", 0))

    def _save_meta(self):
        self._meta["arrays"] = sorted(self.array_props)
        self.meta_bucket.put(b"__aggregates__", self._meta)

    def reconcile_doc_count(self, actual: int) -> None:
        """Re-anchor doc_count to the objects bucket at shard open: a crash
        between index_objects and the objects-bucket commit leaves ghost doc
        ids counted here forever (they're never unindexed), drifting BM25
        idf/avg-length. Reconciling at open bounds the drift to one crash
        window."""
        with self._lock:
            if self.doc_count != actual:
                self._meta["doc_count"] = int(actual)
                self._save_meta()
                self._version += 1

    # -- mutation -------------------------------------------------------------

    def index_object(self, obj) -> None:
        self.index_objects([obj])

    def index_objects(self, objs) -> None:
        """Batch insert: one WAL frame per bucket family per batch
        (reference: updateInvertedIndexLSM per put, shard_write_put.go:454)."""
        search_upd: dict[bytes, dict] = {}
        # analyzer-output concat jobs: (prefix, keys, entry_offs, cols...)
        search_jobs: list[tuple] = []
        filter_jobs: list[tuple] = []
        filter_add: dict[bytes, set] = {}
        numeric_add: dict[bytes, set] = {}
        null_add: dict[bytes, set] = {}
        geo_puts: list[tuple[bytes, object]] = []
        all_docs: set[int] = set()
        prop_len_delta: dict[str, list] = {}  # prop -> [total_delta, count_delta]

        # native batch analyzer: one FFI call per (text prop, batch) for
        # ASCII values (csrc wn_analyze_batch — the import hot loop,
        # reference inverted/analyzer.go per put). Non-ASCII values and
        # odd shapes keep the unicode-aware Python path; ASCII-ness is a
        # property of the value, so index/unindex key derivation stays
        # consistent either way.
        text_handled = self._index_text_batch(
            objs, search_jobs, filter_jobs, prop_len_delta)

        for obj in objs:
            doc = obj.doc_id
            all_docs.add(doc)
            for name, value in obj.properties.items():
                if (name, doc) in text_handled:
                    continue  # batch analyzer wrote postings + filter keys
                self._collect_index_prop(
                    doc, name, value, search_upd, filter_add, numeric_add,
                    null_add, geo_puts, prop_len_delta)
            if self.config.inverted.index_timestamps:
                for tname, tval in (
                        ("_creationTimeUnix", obj.creation_time_ms),
                        ("_lastUpdateTimeUnix", obj.last_update_time_ms)):
                    nk = tname.encode() + _SEP + _enc_f64(float(tval))
                    numeric_add.setdefault(nk, set()).add(doc)

        with self._lock:
            if search_upd:
                self.searchable_bucket.map_set_many(search_upd.items())
            for pfx, keys, eoffs, docs_c, tfs_c, lens_c in search_jobs:
                self.searchable_bucket.map_set_columns_concat(
                    keys, eoffs, docs_c, tfs_c, lens_c, prefix=pfx)
            for pfx, keys, eoffs, docs_c in filter_jobs:
                self.filter_bucket.bitmap_add_concat(
                    keys, eoffs, docs_c.astype(np.uint64), prefix=pfx)
            filter_add.setdefault(_ALL_DOCS, set()).update(all_docs)
            self.filter_bucket.bitmap_add_many(filter_add.items())
            if numeric_add:
                self.numeric_bucket.bitmap_add_many(numeric_add.items())
            if null_add:
                self.null_bucket.bitmap_add_many(null_add.items())
            if geo_puts:
                self.geo_bucket.put_many(geo_puts)
            self._meta["doc_count"] = self.doc_count + len(objs)
            props_meta = self._meta.setdefault("props", {})
            for prop, (dl, dc) in prop_len_delta.items():
                pm = props_meta.setdefault(prop, {"total_len": 0, "len_count": 0})
                pm["total_len"] += dl
                pm["len_count"] += dc
            self._save_meta()
            self._version += 1
            # cache invalidation for every touched key; when a batch
            # touches more keys than the cache could plausibly hold hot,
            # one clear beats tens of thousands of per-key pops (the pops
            # were 5% of the whole import profile)
            for k in search_upd:
                self._post_cache.pop(k)
            n_touched = sum(len(j[1]) for j in search_jobs)
            if n_touched > 2048 or n_touched > len(self._post_cache.d):
                self._post_cache.clear()
            else:
                for pfx, keys, _e, *_cols in search_jobs:
                    for k in keys:
                        self._post_cache.pop(pfx + k)
            n_touched = sum(len(j[1]) for j in filter_jobs)
            if n_touched > 2048 or n_touched > len(self._bitmap_cache.d):
                self._bitmap_cache.clear()
            else:
                for pfx, keys, _e, _d in filter_jobs:
                    for k in keys:
                        self._bitmap_cache.pop((B_FILTER, pfx + k))
            for k in filter_add:
                self._bitmap_cache.pop((B_FILTER, k))
            for k in numeric_add:
                self._bitmap_cache.pop((B_NUMERIC, k))
            for k in null_add:
                self._bitmap_cache.pop((B_NULL, k))
            for k, _ in geo_puts:
                self._geo_cache.pop(k.split(_SEP, 1)[0].decode(), None)

    _JOIN_BY_TOKENIZATION = {"word": "\x01", "lowercase": " ",
                             "whitespace": " "}

    def _index_text_batch(self, objs, search_jobs, filter_jobs,
                          prop_len_delta) -> set:
        """Batch-analyze ASCII text properties through the native analyzer
        (one FFI call per prop per batch). Returns the (prop, doc) pairs
        fully handled — postings, text filter keys, and prop-length
        aggregates — identically to the per-value Python path. Output
        lands in ``search_jobs``/``filter_jobs`` as whole-prop concat
        columns for the storage layer's one-call native writes."""
        from weaviate_tpu_torch import native

        if not native.available():
            return set()
        handled: set = set()
        jobs: dict[str, tuple[list[int], list[str]]] = {}
        props: dict[str, Property] = {}
        for obj in objs:
            for name, value in obj.properties.items():
                prop = props.get(name)
                if prop is None:
                    prop = self._prop_schema(name, value)
                    if prop is None or prop.data_type not in (
                            DataType.TEXT, DataType.TEXT_ARRAY):
                        continue
                    props[name] = prop
                if prop.data_type not in (DataType.TEXT,
                                          DataType.TEXT_ARRAY):
                    continue
                if not (prop.index_searchable or prop.index_filterable):
                    continue
                if isinstance(value, str):
                    if not value.isascii():
                        continue
                elif isinstance(value, (list, tuple)):
                    join = self._JOIN_BY_TOKENIZATION.get(prop.tokenization)
                    if join is None or not all(
                            isinstance(v, str) and v.isascii()
                            for v in value):
                        continue  # field-mode arrays keep the Python path
                    value = join.join(value)
                else:
                    continue
                docs, vals = jobs.setdefault(name, ([], []))
                docs.append(obj.doc_id)
                vals.append(value)
                handled.add((name, obj.doc_id))
        for name, (docs, vals) in jobs.items():
            prop = props[name]
            res = native.analyze_batch(vals, prop.tokenization)
            if res is None:  # lib vanished mid-flight: Python path
                for d in docs:
                    handled.discard((name, d))
                continue
            terms, eoffs, rows, tfs, row_tokens = res
            pfx = name.encode() + _SEP
            docs_arr = np.asarray(docs, dtype=np.int64)
            # whole-prop CONCAT columns: the per-term entry layout is the
            # analyzer's own (entry_offs into docs/tfs/lens); the storage
            # layer applies + WAL-frames them in one native call per prop
            # (kv.py map_set_columns_concat / bitmap_add_concat)
            keys = terms  # analyzer emits bytes keys directly
            docs_col = docs_arr[rows]
            if prop.index_searchable:
                search_jobs.append((pfx, keys, eoffs, docs_col, tfs,
                                    row_tokens[rows]))
                d = prop_len_delta.setdefault(name, [0, 0])
                d[0] += int(row_tokens.sum())
                d[1] += len(docs)
            if prop.index_filterable:
                filter_jobs.append((pfx + b"t", keys, eoffs, docs_col))
        return handled

    def _collect_index_prop(self, doc, name, value, search_upd, filter_add,
                            numeric_add, null_add, geo_puts, prop_len_delta):
        prop = self._prop_schema(name, value)
        if prop is None:
            return
        pfx = name.encode() + _SEP
        if value is None:
            if self.config.inverted.index_null_state:
                null_add.setdefault(name.encode(), set()).add(doc)
            return
        if prop.index_searchable and prop.data_type in (
                DataType.TEXT, DataType.TEXT_ARRAY):
            tokens = tokenize(value, prop.tokenization)
            counts: dict[str, int] = {}
            for t in tokens:
                counts[t] = counts.get(t, 0) + 1
            n_tok = len(tokens)
            for t, c in counts.items():
                search_upd.setdefault(pfx + t.encode(), {})[doc] = [c, n_tok]
            d = prop_len_delta.setdefault(name, [0, 0])
            d[0] += n_tok
            d[1] += 1
        if not prop.index_filterable:
            return
        for vk in self._filter_keys(prop, value):
            bk = _value_key(vk)
            if bk is not None:
                cur = filter_add.get(pfx + bk)
                if cur is None:
                    filter_add[pfx + bk] = {doc}
                elif isinstance(cur, set):
                    cur.add(doc)
                else:
                    # the batch analyzer stored an ndarray for this key
                    # (ASCII docs) — widen to a set to absorb this doc
                    s = set(cur.tolist())
                    s.add(doc)
                    filter_add[pfx + bk] = s
        dt = prop.data_type
        if dt in (DataType.INT, DataType.NUMBER):
            numeric_add.setdefault(pfx + _enc_f64(float(value)), set()).add(doc)
        elif dt == DataType.DATE:
            numeric_add.setdefault(pfx + _enc_f64(parse_date(value)),
                                   set()).add(doc)
        elif dt in (DataType.INT_ARRAY, DataType.NUMBER_ARRAY):
            self.array_props.add(name)
            for v in set(value):
                numeric_add.setdefault(pfx + _enc_f64(float(v)), set()).add(doc)
        elif dt == DataType.DATE_ARRAY:
            self.array_props.add(name)
            for v in set(value):
                numeric_add.setdefault(pfx + _enc_f64(parse_date(v)),
                                       set()).add(doc)
        elif dt == DataType.GEO:
            geo_puts.append((pfx + struct.pack(">Q", doc),
                             [float(value["latitude"]),
                              float(value["longitude"])]))

    def unindex_object(self, obj) -> None:
        self.unindex_objects([obj])

    def unindex_objects(self, objs) -> None:
        """Remove docs' postings by re-deriving their keys from the CURRENT
        schema — batched: one apply pass per bucket family for the whole
        batch (the per-object form paid repeated bitmap passes).
        Consequently changing a property's tokenization,
        data type, or the stopword config after objects are indexed leaves
        stale postings for already-indexed docs on later delete/update
        (the keys recomputed under the new config differ from those
        written). The reference forbids mutating tokenization in place for
        the same reason; stopword-config updates remain allowed for parity
        with the reference's mutable invertedIndexConfig, at the
        documented cost that existing docs need a reindex to pick the
        change up cleanly."""
        if not objs:
            return
        search_del: dict[bytes, set] = {}
        filter_del: dict[bytes, set] = {}
        numeric_del: dict[bytes, set] = {}
        null_del: dict[bytes, set] = {}
        geo_del: list[bytes] = []
        prop_len_delta: dict[str, list] = {}

        for obj in objs:
            self._collect_unindex(obj, search_del, filter_del, numeric_del,
                                  null_del, geo_del, prop_len_delta)

        with self._lock:
            if search_del:
                self.searchable_bucket.map_delete_many(search_del.items())
            all_docs = filter_del.setdefault(_ALL_DOCS, set())
            all_docs.update(o.doc_id for o in objs)
            self.filter_bucket.bitmap_remove_many(filter_del.items())
            if numeric_del:
                self.numeric_bucket.bitmap_remove_many(numeric_del.items())
            if null_del:
                self.null_bucket.bitmap_remove_many(null_del.items())
            for k in geo_del:
                self.geo_bucket.delete(k)
            self._meta["doc_count"] = max(self.doc_count - len(objs), 0)
            props_meta = self._meta.setdefault("props", {})
            for prop, (dl, dc) in prop_len_delta.items():
                pm = props_meta.setdefault(prop,
                                           {"total_len": 0, "len_count": 0})
                pm["total_len"] += dl
                pm["len_count"] += dc
            self._save_meta()
            self._version += 1
            for k in search_del:
                self._post_cache.pop(k)
            for k in filter_del:
                self._bitmap_cache.pop((B_FILTER, k))
            for k in numeric_del:
                self._bitmap_cache.pop((B_NUMERIC, k))
            for k in null_del:
                self._bitmap_cache.pop((B_NULL, k))
            for k in geo_del:
                self._geo_cache.pop(k.split(_SEP, 1)[0].decode(), None)

    def _collect_unindex(self, obj, search_del, filter_del, numeric_del,
                         null_del, geo_del, prop_len_delta) -> None:
        doc = obj.doc_id
        for name, value in obj.properties.items():
            prop = self._prop_schema(name, value)
            if prop is None:
                continue
            pfx = name.encode() + _SEP
            if value is None:
                null_del.setdefault(name.encode(), set()).add(doc)
                continue
            if prop.index_searchable and prop.data_type in (
                    DataType.TEXT, DataType.TEXT_ARRAY):
                tokens = tokenize(value, prop.tokenization)
                for term in set(tokens):
                    search_del.setdefault(pfx + term.encode(), set()).add(doc)
                d = prop_len_delta.setdefault(name, [0, 0])
                d[0] -= len(tokens)
                d[1] -= 1
            for vk in self._filter_keys(prop, value):
                bk = _value_key(vk)
                if bk is not None:
                    filter_del.setdefault(pfx + bk, set()).add(doc)
            dt = prop.data_type
            if dt in (DataType.INT, DataType.NUMBER):
                numeric_del.setdefault(pfx + _enc_f64(float(value)),
                                       set()).add(doc)
            elif dt == DataType.DATE:
                numeric_del.setdefault(pfx + _enc_f64(parse_date(value)),
                                       set()).add(doc)
            elif dt in (DataType.INT_ARRAY, DataType.NUMBER_ARRAY):
                for v in set(value):
                    numeric_del.setdefault(pfx + _enc_f64(float(v)),
                                           set()).add(doc)
            elif dt == DataType.DATE_ARRAY:
                for v in set(value):
                    numeric_del.setdefault(pfx + _enc_f64(parse_date(v)),
                                           set()).add(doc)
            elif dt == DataType.GEO:
                geo_del.append(pfx + struct.pack(">Q", doc))

        if self.config.inverted.index_timestamps:
            for tname, tval in (("_creationTimeUnix", obj.creation_time_ms),
                                ("_lastUpdateTimeUnix", obj.last_update_time_ms)):
                nk = tname.encode() + _SEP + _enc_f64(float(tval))
                numeric_del.setdefault(nk, set()).add(doc)

    def _filter_keys(self, prop: Property, value) -> list:
        """Exact-match keys under which a value is filterable (text values
        are tokenized: reference Equal-on-text matches per-term)."""
        if value is None:
            return []
        dt = prop.data_type
        if dt in (DataType.TEXT, DataType.TEXT_ARRAY):
            return list(set(tokenize(value, prop.tokenization)))
        if dt in (DataType.BOOL, DataType.UUID):
            return [value]
        if dt in (DataType.BOOL_ARRAY, DataType.UUID_ARRAY):
            return list(set(value))
        if dt in (DataType.INT, DataType.NUMBER):
            return [float(value)]
        if dt == DataType.DATE:
            return [parse_date(value)]
        if dt in (DataType.INT_ARRAY, DataType.NUMBER_ARRAY):
            return [float(v) for v in set(value)]
        if dt == DataType.DATE_ARRAY:
            return [parse_date(v) for v in value]
        return []

    # -- read accessors (filters.py + BM25 consume these) ---------------------

    def postings(self, prop: str, term: str):
        """(ids int64 sorted, tfs f32, lens f32) for one (prop, term)."""
        return self.postings_with_bounds(prop, term)[:3]

    def postings_with_bounds(self, prop: str, term: str):
        """(ids, tfs, lens, max_tf, min_len) — the bounds are computed once
        at posting load and cached; they feed the MaxScore per-term score
        upper bound (the analog of the reference's WAND block-max impacts,
        bm25_searcher.go:551) at O(1) per query."""
        from weaviate_tpu_torch.runtime.metrics import (postings_cache_hits,
                                                  postings_cache_misses)

        key = prop.encode() + _SEP + term.encode()
        with self._lock:
            hit = self._post_cache.get(key)
            if hit is not None:
                postings_cache_hits.inc()
                return hit
            version = self._version
        postings_cache_misses.inc()
        m = self.searchable_bucket.get_map(key)
        if not m:
            out = (np.empty(0, np.int64), np.empty(0, np.float32),
                   np.empty(0, np.float32), 0.0, 1.0)
        else:
            ids = np.fromiter(m.keys(), dtype=np.int64, count=len(m))
            order = np.argsort(ids)
            ids = ids[order]
            tfs = np.fromiter((v[0] for v in m.values()), dtype=np.float32,
                              count=len(m))[order]
            lens = np.fromiter((v[1] for v in m.values()), dtype=np.float32,
                               count=len(m))[order]
            out = (ids, tfs, lens, float(tfs.max()), float(lens.min()))
        with self._lock:
            if self._version == version:
                self._post_cache.put(key, out)
        return out

    def _bitmap(self, bucket_name: str, bucket, key: bytes) -> np.ndarray:
        ck = (bucket_name, key)
        with self._lock:
            hit = self._bitmap_cache.get(ck)
            if hit is not None:
                return hit
            version = self._version
        arr = bucket.get_bitmap(key)
        with self._lock:
            if self._version == version:
                self._bitmap_cache.put(ck, arr)
        return arr

    def all_docs(self) -> np.ndarray:
        """Sorted uint64 ids of live docs."""
        return self._bitmap(B_FILTER, self.filter_bucket, _ALL_DOCS)

    def filterable_ids(self, prop: str, value) -> np.ndarray:
        bk = _value_key(value)
        if bk is None:
            return np.empty(0, np.uint64)
        return self._bitmap(B_FILTER, self.filter_bucket,
                            prop.encode() + _SEP + bk)

    def null_ids(self, prop: str) -> np.ndarray:
        return self._bitmap(B_NULL, self.null_bucket, prop.encode())

    def text_vocab(self, prop: str):
        """Iterate (token, ids) over the text vocabulary of a prop (LIKE)."""
        pfx = prop.encode() + _SEP + b"t"
        for k, v in self.filter_bucket.iter_range(pfx, pfx + b"\xff" * 4):
            from weaviate_tpu_torch import native

            ids = native.difference_sorted(v["add"], v["del"])
            if len(ids):
                yield k[len(pfx):].decode(), ids

    def numeric_range_ids(self, prop: str, lo: float | None, hi: float | None,
                          lo_incl: bool = True, hi_incl: bool = False):
        """Union of doc bitmaps for values in the given range — an LSM
        range scan over order-preserving keys (reference: searcher.go
        range row readers over roaringset)."""
        from weaviate_tpu_torch import native

        pfx = prop.encode() + _SEP
        if lo is None:
            start = pfx
        else:
            start = pfx + _enc_f64(lo)
            if not lo_incl:
                start += b"\x00"
        if hi is None:
            stop = pfx + b"\xff" * 9
        else:
            stop = pfx + _enc_f64(hi)
            if hi_incl:
                stop += b"\x00"
        parts = []
        for _k, v in self.numeric_bucket.iter_range(start, stop):
            ids = native.difference_sorted(v["add"], v["del"])
            if len(ids):
                parts.append(ids)
        if not parts:
            return np.empty(0, np.uint64)
        # one concatenate+unique instead of repeated pairwise unions —
        # a wide range over mostly-unique values would otherwise go
        # quadratic in the number of distinct keys
        return np.unique(np.concatenate(parts))

    def geo_arrays(self, prop: str):
        """(ids int64, lats f64, lons f64) for every doc with a geo value
        on ``prop`` (grid-sorted order)."""
        g = self.geo_grid(prop)
        return g.ids, g.lats, g.lons

    def geo_grid(self, prop: str) -> "GeoGrid":
        """Grid-bucketed geo index for ``prop`` — materialized from the
        geo bucket once and cached; WITHIN_GEO_RANGE touches only the
        cells intersecting the query circle instead of every geo row
        (the reference keeps a per-property geo vector index,
        adapters/repos/db/vector/geo/geo.go:35 — on TPU a host grid +
        vectorized haversine over the candidate cells is both simpler
        and sublinear)."""
        with self._lock:
            hit = self._geo_cache.get(prop)
            if hit is not None:
                return hit
            version = self._version
        pfx = prop.encode() + _SEP
        ids, lats, lons = [], [], []
        for k, v in self.geo_bucket.iter_range(pfx, pfx + b"\xff" * 9):
            (doc,) = struct.unpack(">Q", k[len(pfx):])
            ids.append(doc)
            lats.append(v[0])
            lons.append(v[1])
        grid = GeoGrid(np.asarray(ids, np.int64),
                       np.asarray(lats, np.float64),
                       np.asarray(lons, np.float64))
        with self._lock:
            if self._version == version:
                self._geo_cache[prop] = grid
        return grid

    def avg_len(self, prop: str) -> float:
        pm = self._meta.get("props", {}).get(prop)
        if not pm or not pm.get("len_count"):
            return 1.0
        return max(pm["total_len"] / pm["len_count"], 1e-9)

    # -- BM25F scoring --------------------------------------------------------

    def searchable_props(self) -> list[str]:
        props = [p.name for p in self.config.properties
                 if p.index_searchable and p.data_type in (
                     DataType.TEXT, DataType.TEXT_ARRAY)]
        if props:
            return props
        # fall back to every prop with length aggregates (auto-schema'd)
        return sorted(self._meta.get("props", {}).keys())

    def _bm25_plan(self, query: str,
                   properties: list[str] | None = None):
        """Shared BM25F planning prologue (host scorer AND the
        hybridplane's posting pack): parse ``name^boost`` specs, analyze
        the query per property, load postings, and compute per-term
        idf / MaxScore upper bounds. Returns ``(term_rows, avg_len)``
        with ``term_rows`` a list of ``(idf, ub, fields)`` in sorted-term
        order (fields = ``(ids, tfs, lens, boost, prop_name)``), or None
        when no term has a live posting."""
        props: list[tuple[str, float]] = []
        for spec in (properties or self.searchable_props()):
            name, _, boost = spec.partition("^")
            props.append((name, float(boost) if boost else 1.0))
        n = max(self.doc_count, 1)
        avg_len = {name: self.avg_len(name) for name, _ in props}

        # the query analyzes per-property with THAT property's
        # tokenization (reference: bm25_searcher analyzes per field);
        # a term's df = docs containing it in ANY searched property
        # (BM25F treats props as fields of one doc)
        term_fields: dict[str, list] = {}
        for name, boost in props:
            sch = self.config.property(name)
            tok = sch.tokenization if sch is not None else "word"
            for term in self.stopwords.filter(
                    sorted(set(tokenize(query, tok)))):
                term_fields.setdefault(term, []).append((name, boost))
        if not term_fields:
            return None

        k1, b = self.k1, self.b
        term_rows = []  # (idf, ub, [(ids, tfs, lens, boost, prop_name)])
        for term, tf_props in sorted(term_fields.items()):
            fields = []
            df_union = None
            s_max = 0.0  # upper bound on the field-summed normalized tf
            for name, boost in tf_props:
                ids, tfs, lens, max_tf, min_len = \
                    self.postings_with_bounds(name, term)
                if not len(ids):
                    continue
                fields.append((ids, tfs, lens, boost, name))
                norm_lo = max(1.0 - b + b * min_len / avg_len[name], 1e-9)
                s_max += boost * max_tf / norm_lo
                df_union = ids if df_union is None else \
                    np.union1d(df_union, ids)
            if not fields:
                continue
            df = len(df_union)
            idf = math.log(1.0 + (n - df + 0.5) / (df + 0.5))
            # tf saturation is monotone: score_t(doc) <= idf * s/(k1+s)
            ub = idf * s_max / (k1 + s_max)
            term_rows.append((idf, ub, fields))
        if not term_rows:
            return None
        return term_rows, avg_len

    def bm25_search(self, query: str, k: int = 10,
                    properties: list[str] | None = None,
                    allow_mask: np.ndarray | None = None):
        """BM25F over ``properties`` (``name^boost`` syntax supported).

        Returns (doc_ids [<=k] int64, scores [<=k] f32) descending.
        Reference: inverted/bm25_searcher.go:73 (BM25F), boosts parsed the
        same way (bm25_searcher.go propertyBoosts).
        """
        plan = self._bm25_plan(query, properties)
        if plan is None:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        term_rows, avg_len = plan
        k1, b = self.k1, self.b

        def score_candidates(cand: np.ndarray) -> np.ndarray:
            """Exact BM25F over ``cand`` (sorted) across ALL query terms —
            non-candidate postings are probed by binary search, never
            expanded."""
            scores = np.zeros(len(cand), dtype=np.float32)
            for idf, _ub, fields in term_rows:
                # BM25F: per-field length-normalized tf, weighted-summed
                # across fields, then saturated once
                tf_acc = np.zeros(len(cand), dtype=np.float32)
                for ids, tfs, lens, boost, name in fields:
                    # probe DIRECTION matters: search the candidates into
                    # the posting — O(|cand| log |posting|) — so a 1M-id
                    # stop-term posting costs log-time per candidate, not a
                    # full pass (the WAND property)
                    pos = np.searchsorted(ids, cand)
                    inb = (pos < len(ids))
                    pos_c = np.clip(pos, 0, len(ids) - 1)
                    hit = inb & (ids[pos_c] == cand)
                    if not hit.any():
                        continue
                    src = pos_c[hit]
                    norm = 1.0 - b + b * lens[src] / avg_len[name]
                    tf_acc[hit] += boost * tfs[src] / np.maximum(norm, 1e-9)
                scores += idf * tf_acc / (k1 + tf_acc)
            return scores

        # --- MaxScore pruning (reference: WAND pivot, bm25_searcher.go:100,
        # :551). Terms sort by score upper bound; the candidate universe is
        # the union of the first j ("essential") postings only. Any doc
        # outside it scores <= sum of the remaining UBs, so once that tail
        # is below the running k-th best score the top-k is provably
        # identical to exhaustive scoring — high-df stop-like terms never
        # expand the universe, they are only probed at candidate positions.
        term_rows.sort(key=lambda t: -t[1])
        ubs = np.asarray([t[1] for t in term_rows], dtype=np.float64)
        tail_ub = np.concatenate([np.cumsum(ubs[::-1])[::-1], [0.0]])

        def allowed(ids: np.ndarray) -> np.ndarray:
            if allow_mask is None:
                return ids
            keep = ids[ids < len(allow_mask)]
            return keep[allow_mask[keep]]

        cand = np.empty(0, np.int64)
        scores = np.empty(0, np.float32)
        n_terms = len(term_rows)
        for j in range(1, n_terms + 1):
            new_ids = allowed(np.unique(np.concatenate(
                [ids for ids, *_ in term_rows[j - 1][2]])))
            # incremental: docs already scored carry their (exact, all-term)
            # scores over — only genuinely new candidates get a scoring pass,
            # so every doc is scored exactly once across all iterations
            fresh = new_ids
            if len(cand):
                pos = np.searchsorted(cand, new_ids)
                pos_c = np.clip(pos, 0, len(cand) - 1)
                fresh = new_ids[(pos >= len(cand)) | (cand[pos_c] != new_ids)]
            if len(fresh):
                fresh_scores = score_candidates(fresh)
                merged = np.concatenate([cand, fresh])
                order = np.argsort(merged, kind="stable")
                cand = merged[order]
                scores = np.concatenate([scores, fresh_scores])[order]
            if len(cand) == 0:
                continue
            if len(cand) >= k:
                kth = float(np.partition(scores, len(scores) - k)[len(scores) - k])
                if tail_ub[j] < kth:
                    break
        self.last_bm25_stats = {
            "terms": n_terms,
            "essential_terms": j if term_rows else 0,
            "candidates": int(len(cand)),
            "postings_total": int(sum(
                len(ids) for _, _, fields in term_rows
                for ids, *_ in fields)),
        }
        if len(cand) == 0:
            return np.empty(0, np.int64), np.empty(0, np.float32)

        k_eff = min(k, len(cand))
        top = np.argpartition(-scores, k_eff - 1)[:k_eff]
        order = top[np.argsort(-scores[top], kind="stable")]
        return cand[order], scores[order]

    def bm25_pack(self, query: str,
                  properties: list[str] | None = None,
                  allow_mask: np.ndarray | None = None, *,
                  max_candidates: int = 4096):
        """Plan one query for DEVICE scoring (the hybridplane pack).

        Same prologue as ``bm25_search`` (analysis, postings, idf, ub
        ordering) but instead of scoring, the ALLOWED UNION of every
        term's postings ships as the candidate universe — a superset of
        the MaxScore essential union, so the device top-k is provably
        the exhaustive top-k — as dense per-(term, prop) segment planes
        over the candidate axis (ops/bm25.py layout). Segments pack in
        ub-DESCENDING term order with fields in query order, mirroring
        the host scorer's accumulation order for f32 parity. Returns a
        dict of host arrays + scalars (the shard layer adds store slots
        and fusion params to make a ``SparseOperand``), or None when the
        device path should not take the query (no live terms, empty
        allowed union, or a candidate universe past ``max_candidates``
        — the planner's budget gate; callers fall back to the host
        scorer)."""
        plan = self._bm25_plan(query, properties)
        if plan is None:
            return None
        term_rows, avg_len = plan
        term_rows = sorted(term_rows, key=lambda t: -t[1])
        all_ids = np.unique(np.concatenate(
            [ids for _idf, _ub, fields in term_rows
             for ids, *_ in fields]))
        if allow_mask is not None:
            keep = all_ids[all_ids < len(allow_mask)]
            cand = keep[allow_mask[keep]]
        else:
            cand = all_ids
        postings_total = int(sum(
            len(ids) for _idf, _ub, fields in term_rows
            for ids, *_ in fields))
        if len(cand) == 0 or len(cand) > max_candidates:
            return None
        c = len(cand)
        seg_tf, seg_len, seg_term, seg_boost, seg_avg = [], [], [], [], []
        idf_arr = np.zeros(len(term_rows), np.float32)
        for t_idx, (idf, _ub, fields) in enumerate(term_rows):
            idf_arr[t_idx] = idf
            for ids, tfs, lens, boost, name in fields:
                pos = np.searchsorted(ids, cand)
                inb = pos < len(ids)
                pos_c = np.clip(pos, 0, len(ids) - 1)
                hit = inb & (ids[pos_c] == cand)
                row_tf = np.zeros(c, np.float32)
                row_len = np.zeros(c, np.float32)
                src = pos_c[hit]
                row_tf[hit] = tfs[src]
                row_len[hit] = lens[src]
                seg_tf.append(row_tf)
                seg_len.append(row_len)
                seg_term.append(t_idx)
                seg_boost.append(boost)
                seg_avg.append(avg_len[name])
        stats = {
            "terms": len(term_rows),
            "candidates": c,
            "postings_total": postings_total,
            # posting entries the planner did NOT materialize as
            # candidate columns (multi-term/multi-prop overlap + allow
            # filtering) — the explain plane's "pruned frac"
            "pruned_frac": round(1.0 - c / max(postings_total, 1), 6),
        }
        return {
            "doc_ids": cand.astype(np.int64),
            "seg_tf": np.stack(seg_tf),
            "seg_len": np.stack(seg_len),
            "seg_term": np.asarray(seg_term, np.int32),
            "seg_boost": np.asarray(seg_boost, np.float32),
            "seg_avg": np.asarray(seg_avg, np.float32),
            "idf": idf_arr,
            "k1": float(self.k1),
            "b": float(self.b),
            # host-rounded f32(1 - b): numpy's weak scalar cast makes
            # the host's ``1.0 - b + <f32>`` effectively f32((1-b)) + x;
            # shipping the pre-rounded value keeps device parity exact
            "one_minus_b": float(np.float32(1.0 - self.b)),
            "stats": stats,
        }
