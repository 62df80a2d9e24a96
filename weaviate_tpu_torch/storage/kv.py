"""LSM-style KV store with strategy-typed buckets.

Reference: adapters/repos/db/lsmkv — a ``Store`` is a directory of named
``Bucket``s (store.go:36, bucket.go:45), each with an active memtable, a
WAL, and a stack of immutable sorted segments, compacted in the background.
Four value strategies (strategies.go:21-25):

- ``replace``     last write wins (object storage)
- ``set``         unordered value collection with per-value deletes
- ``map``         key -> {mapKey: mapValue} with per-mapKey deletes
- ``roaringset``  key -> bitmap of doc ids (additions/removals sets)

Segment files are mmap'd with an on-disk binary-searchable key index and a
per-segment bloom filter (reference: segment.go:28 mmap, segmentindex/,
segment_bloom_filters.go) — a get-miss costs k bloom probes per segment,
not a footer scan, and opening a segment reads only its footer, O(1) RAM.

The write path never writes segments: a full memtable is *sealed* (memtable
+ its WAL move to a pending list, a fresh WAL starts) and background
maintenance turns sealed memtables into segments (reference: flush cycle in
store_cyclecallbacks.go keeps flushes off the user write path). Batched
writes share one WAL frame and one lock acquisition (``put_many`` /
``map_set_many`` / ``bitmap_add_many``).

doc-id bitmaps are sorted numpy uint64 arrays varint-delta-coded on disk,
the dense analog of the reference's roaring bitmaps (sroar).
"""

from __future__ import annotations

import hashlib
import heapq
import io
import logging
import mmap
import os
import struct
import threading
from typing import Iterable, Iterator

import msgpack
import numpy as np

from weaviate_tpu_torch import native
from weaviate_tpu_torch.runtime import faultline, tracing
from weaviate_tpu_torch.storage import fsutil, recovery
from weaviate_tpu_torch.storage.wal import ReplayReport, WriteAheadLog

logger = logging.getLogger(__name__)

STRATEGIES = ("replace", "set", "map", "roaringset")
_TOMBSTONE = "__tomb__"
_MAGIC_V2 = b"WVS2"
_BLOOM_K = 6
_BLOOM_BITS_PER_KEY = 10


def _merge_values(strategy: str, older, newer):
    """Merge two strategy values, newer taking precedence."""
    if strategy == "replace":
        return newer
    if strategy == "set":
        # value: {"add": set, "del": set}
        add = (older["add"] - newer["del"]) | newer["add"]
        dele = (older["del"] | newer["del"]) - newer["add"]
        return {"add": add, "del": dele}
    if strategy == "map":
        # value: {"set": {k: v}, "del": set} (lazy column form coalesced)
        older = _coalesce_map(older)
        newer = _coalesce_map(newer)
        out = dict(older.get("set", {}))
        for k in newer.get("del", set()):
            out.pop(k, None)
        out.update(newer.get("set", {}))
        dele = (older.get("del", set()) | newer.get("del", set())) - set(
            newer.get("set", {})
        )
        return {"set": out, "del": dele}
    # roaringset: value {"add": np.uint64[], "del": np.uint64[]} — arrays are
    # kept sorted+unique at every boundary so the native C++ set algebra
    # (weaviate_tpu/native, csrc/weaviate_native.cpp) applies directly.
    # Memtable-internal values may be LAZY ({"lazy": [parts...]}) — adds
    # accumulated without merging; coalesce before any algebra.
    older = _coalesce_roaring(older)
    newer = _coalesce_roaring(newer)
    if len(newer["del"]) == 0 and len(older["del"]) == 0:
        # import fast path (adds only): 1 call instead of 4 — the per-key
        # FFI overhead dominated batch imports
        return {"add": native.union_sorted(older["add"], newer["add"]),
                "del": older["del"]}
    add = native.union_sorted(
        native.difference_sorted(older["add"], newer["del"]), newer["add"]
    )
    dele = native.difference_sorted(
        native.union_sorted(older["del"], newer["del"]), newer["add"]
    )
    return {"add": add, "del": dele}


def _coalesce_map(v):
    """Collapse a lazy postings map value ({"plazy": [(docs, tfs, lens),
    ...]}) into canonical {"set": {doc: [tf, len]}, "del": set()} form.
    The import path hands the analyzer's COLUMN arrays straight through;
    the doc->payload dict materializes once per key at read/flush instead
    of once per (term, doc) posting in Python."""
    if isinstance(v, dict) and "plazy" in v:
        out: dict = {}
        for docs, tfs, lens in v["plazy"]:
            for d, t, ln in zip(docs.tolist(), tfs.tolist(), lens.tolist()):
                out[d] = [t, ln]
        return {"set": out, "del": v.get("del", set())}
    return v


def _coalesce_roaring(v):
    """Collapse a lazy memtable roaringset value into canonical
    {"add": sorted-unique u64, "del": ...} form. The memtable appends
    per-write add-arrays to a ``lazy`` list instead of merging each one
    through the set algebra — one np.unique over the concatenation at
    read/flush time replaces hundreds of per-key FFI unions on the
    import hot path."""
    if isinstance(v, dict) and "lazy" in v:
        parts = v["lazy"]
        add = (np.unique(np.concatenate(parts)) if len(parts) > 1
               else parts[0])
        return {"add": add, "del": v["del"]}
    return v


def _sorted_unique_u64(ids) -> np.ndarray:
    """Ascending unique uint64 from any iterable; already-sorted ndarray
    input (the batch analyzer's per-term doc arrays) skips the sort."""
    if isinstance(ids, np.ndarray):
        a = ids.astype(np.uint64, copy=False)
        if len(a) < 2 or bool(np.all(a[1:] > a[:-1])):
            return a
        return np.unique(a)
    return np.unique(np.asarray(list(ids), np.uint64))


def _empty_value(strategy: str):
    if strategy == "replace":
        return None
    if strategy == "set":
        return {"add": set(), "del": set()}
    if strategy == "map":
        return {"set": {}, "del": set()}
    return {"add": np.empty(0, np.uint64), "del": np.empty(0, np.uint64)}


def _pack_value(strategy: str, value) -> bytes:
    if strategy == "replace":
        return msgpack.packb({"v": value}, use_bin_type=True)
    if strategy == "set":
        return msgpack.packb(
            {"add": sorted(value["add"]), "del": sorted(value["del"])},
            use_bin_type=True,
        )
    if strategy == "map":
        return msgpack.packb(
            {"set": value["set"], "del": sorted(value["del"])}, use_bin_type=True
        )
    # roaringset: varint-delta-coded sorted ids (native codec) — ~1 byte/id
    # for dense doc-id runs vs 8 raw (reference: sroar container packing)
    return msgpack.packb(
        {
            "vadd": native.varint_encode(value["add"]),
            "nadd": len(value["add"]),
            "vdel": native.varint_encode(value["del"]),
            "ndel": len(value["del"]),
        },
        use_bin_type=True,
    )


def _unpack_value(strategy: str, raw: bytes):
    obj = msgpack.unpackb(raw, raw=False, strict_map_key=False)
    if strategy == "replace":
        return obj["v"]
    if strategy == "set":
        return {"add": set(obj["add"]), "del": set(obj["del"])}
    if strategy == "map":
        return {"set": obj["set"], "del": set(obj["del"])}
    if "add" in obj:  # pre-varint on-disk format: sorted but NOT deduped
        return {
            "add": np.unique(np.frombuffer(obj["add"], np.uint64)),
            "del": np.unique(np.frombuffer(obj["del"], np.uint64)),
        }
    return {
        "add": native.varint_decode(obj["vadd"], count_hint=obj["nadd"]),
        "del": native.varint_decode(obj["vdel"], count_hint=obj["ndel"]),
    }


def _is_tomb_record(raw: bytes) -> bool:
    obj = msgpack.unpackb(raw, raw=False, strict_map_key=False)
    return isinstance(obj, dict) and obj.get("__tomb__") is True


def _replace_segment_lookup(segments_newest_first, key: bytes):
    """Replace-strategy point lookup over a segment stack: first hit wins,
    tombstones shadow. The bloom key hash is computed once and probed
    against every segment (one blake2b per lookup, not per segment).
    Shared by Bucket.get and Bucket.get_many so batched and single-key
    reads can never diverge."""
    hashes = _bloom_hashes(key) if segments_newest_first else None
    for seg in segments_newest_first:
        raw = seg.get(key, hashes)
        if raw is not None:
            return None if _is_tomb_record(raw) else \
                _unpack_value("replace", raw)
    return None


def _bloom_hashes(key: bytes) -> tuple[int, int]:
    """Two independent 64-bit hashes (double hashing drives k probes)."""
    d = hashlib.blake2b(key, digest_size=16).digest()
    return (
        int.from_bytes(d[:8], "little"),
        int.from_bytes(d[8:], "little") | 1,  # odd => full cycle mod 2^m
    )


class _Segment:
    """Immutable sorted segment file, mmap'd (format v2).

    Layout (little-endian):

        "WVS2"
        [record bytes...]            each value written at its recorded offset
        [keys blob]                  concatenated key bytes
        [index]                      n entries x (koff u64, klen u32, voff u64, vlen u32)
        [bloom]                      u64 words
        footer msgpack {n, keys_off, idx_off, bloom_off, bloom_words}
        u64 footer_off

    Only the footer is parsed at open; key lookups binary-search the on-disk
    index through the mmap (reference: segmentindex/ on-disk b-tree-ish
    index + segment.go:28 mmap) after a bloom-filter check
    (segment_bloom_filters.go).
    """

    _IDX = np.dtype([("koff", "<u8"), ("klen", "<u4"),
                     ("voff", "<u8"), ("vlen", "<u4")])

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        size = os.path.getsize(path)
        if size < 16:
            raise ValueError("segment shorter than header+footer")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:4] != _MAGIC_V2:
            raise ValueError("segment is not WVS2 format")
        (foot_off,) = struct.unpack_from("<Q", self._mm, size - 8)
        if not 4 <= foot_off <= size - 8:
            raise ValueError("segment footer offset out of range")
        footer = msgpack.unpackb(self._mm[foot_off : size - 8], raw=False)
        try:
            self.n = int(footer["n"])
            keys_off = int(footer["keys_off"])
            idx_off = int(footer["idx_off"])
            bloom_off = int(footer["bloom_off"])
            bloom_words = int(footer["bloom_words"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"segment footer malformed: {e}") from e
        if not (4 <= keys_off <= idx_off <= bloom_off <= foot_off):
            raise ValueError("segment footer offsets out of range")
        if idx_off + self.n * self._IDX.itemsize > bloom_off:
            raise ValueError("segment index truncated")
        if bloom_off + bloom_words * 8 > foot_off:
            raise ValueError("segment bloom truncated")
        # zero-copy views into the mmap — O(1) RAM per open segment
        self._idx = np.frombuffer(self._mm, dtype=self._IDX, count=self.n,
                                  offset=idx_off)
        self._bloom = np.frombuffer(self._mm, dtype="<u8", count=bloom_words,
                                    offset=bloom_off)
        self._bloom_bits = bloom_words * 64
        self._keys_off = keys_off
        # validate extremes once so a bit-flipped index can't point outside
        # the file on later reads
        if self.n:
            e0, e1 = self._idx[0], self._idx[self.n - 1]
            for e in (e0, e1):
                if int(e["koff"]) + int(e["klen"]) > idx_off or \
                   int(e["voff"]) + int(e["vlen"]) > keys_off:
                    raise ValueError("segment index offsets out of range")

    # -- key access ----------------------------------------------------------

    def _key_at(self, i: int) -> bytes:
        e = self._idx[i]
        off = int(e["koff"])
        return self._mm[off : off + int(e["klen"])]

    def _value_at(self, i: int) -> bytes:
        e = self._idx[i]
        off = int(e["voff"])
        return self._mm[off : off + int(e["vlen"])]

    def _maybe_contains(self, key: bytes,
                        hashes: tuple[int, int] | None = None) -> bool:
        if self._bloom_bits == 0:
            return self.n > 0
        # the caller may hoist the (relatively costly) key hash and probe
        # many segments with it — one blake2b per lookup, not per segment
        h1, h2 = hashes if hashes is not None else _bloom_hashes(key)
        m = self._bloom_bits
        bloom = self._bloom
        for i in range(_BLOOM_K):
            bit = (h1 + i * h2) % m
            if not (int(bloom[bit >> 6]) >> (bit & 63)) & 1:
                return False
        return True

    def get(self, key: bytes,
            hashes: tuple[int, int] | None = None) -> bytes | None:
        if self.n == 0 or not self._maybe_contains(key, hashes):
            return None
        lo, hi = 0, self.n
        while lo < hi:  # binary search over the on-disk index
            mid = (lo + hi) // 2
            k = self._key_at(mid)
            if k < key:
                lo = mid + 1
            elif k > key:
                hi = mid
            else:
                return self._value_at(mid)
        return None

    def iter_items(self, start: bytes | None = None
                   ) -> Iterator[tuple[bytes, bytes]]:
        lo = 0
        if start is not None:  # binary search the first key >= start
            hi = self.n
            while lo < hi:
                mid = (lo + hi) // 2
                if self._key_at(mid) < start:
                    lo = mid + 1
                else:
                    hi = mid
        for i in range(lo, self.n):
            yield self._key_at(i), self._value_at(i)

    def iter_keys(self) -> Iterator[bytes]:
        for i in range(self.n):
            yield self._key_at(i)

    def close(self) -> None:
        # numpy views pin the mmap buffer — drop them before closing
        self._idx = None
        self._bloom = None
        try:
            self._mm.close()
            self._f.close()
        except (OSError, BufferError):
            pass

    @classmethod
    def write(cls, path: str, items: Iterable[tuple[bytes, bytes]]) -> "_Segment":
        """Write a segment from key-sorted (key, value_bytes) pairs."""
        tmp = path + ".tmp"
        keys: list[bytes] = []
        idx_rows: list[tuple[int, int, int, int]] = []
        with open(tmp, "wb") as f:
            f.write(_MAGIC_V2)
            for k, v in items:
                idx_rows.append((0, len(k), f.tell(), len(v)))
                keys.append(k)
                # crashpoint per record: a crash/torn schedule here
                # leaves a partial segment at .tmp — never renamed, so
                # recovery cannot even see it (the covering WAL replays)
                fsutil.guarded_write(f, v, "segment.write.mid", path=tmp)
            keys_off = f.tell()
            off = keys_off
            for i, k in enumerate(keys):
                koff, klen, voff, vlen = idx_rows[i]
                idx_rows[i] = (off, klen, voff, vlen)
                off += len(k)
                f.write(k)
            idx_off = f.tell()
            idx = np.array(idx_rows, dtype=cls._IDX) if idx_rows else \
                np.empty(0, dtype=cls._IDX)
            f.write(idx.tobytes())
            bloom_off = f.tell()
            n = len(keys)
            bloom_words = max((n * _BLOOM_BITS_PER_KEY + 63) // 64, 1) if n else 0
            bloom = np.zeros(bloom_words, dtype=np.uint64)
            if n:
                m = bloom_words * 64
                for k in keys:
                    h1, h2 = _bloom_hashes(k)
                    for i in range(_BLOOM_K):
                        bit = (h1 + i * h2) % m
                        bloom[bit >> 6] |= np.uint64(1 << (bit & 63))
            f.write(bloom.tobytes())
            foot_off = f.tell()
            f.write(msgpack.packb({
                "n": n, "keys_off": keys_off, "idx_off": idx_off,
                "bloom_off": bloom_off, "bloom_words": bloom_words,
            }, use_bin_type=True))
            f.write(struct.pack("<Q", foot_off))
            f.flush()
            os.fsync(f.fileno())
        # fsync-file -> rename -> fsync-dir: the segment's NAME must be
        # durable before the WAL that covers it may be deleted (fsutil
        # ordering rules; handle already fsynced above)
        fsutil.atomic_replace(tmp, path, fsync_file_first=False,
                              crashpoint="segment.write.pre_rename")
        return cls(path)


class _SegmentV1:
    """Round-1 segment format reader (footer key list in RAM) — kept so
    restores of old backup fileset still open."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            size = f.seek(0, os.SEEK_END)
            if size < 8:
                raise ValueError("segment shorter than its footer pointer")
            f.seek(-8, os.SEEK_END)
            (foot_off,) = struct.unpack("<Q", f.read(8))
            if foot_off > size - 8:
                raise ValueError("segment footer offset out of range")
            f.seek(foot_off)
            footer = msgpack.unpackb(f.read(size - 8 - foot_off), raw=False)
        keys, offs, lens = (footer.get("keys"), footer.get("offs"),
                            footer.get("lens")) if isinstance(footer, dict) \
            else (None, None, None)
        if not (isinstance(keys, list) and isinstance(offs, list)
                and isinstance(lens, list)
                and len(keys) == len(offs) == len(lens)):
            raise ValueError("segment footer malformed")
        for off, ln in zip(offs, lens):
            if not (isinstance(off, int) and isinstance(ln, int)
                    and 0 <= off and 0 <= ln and off + ln <= foot_off):
                raise ValueError("segment footer offsets out of range")
        prev = None
        for k in keys:
            if not isinstance(k, bytes):
                raise ValueError("segment footer key is not bytes")
            if prev is not None and k < prev:
                raise ValueError("segment footer keys out of order")
            prev = k
        self.n = len(keys)
        self.keys: list[bytes] = keys
        self.offs: list[int] = offs
        self.lens: list[int] = lens

    def _maybe_contains(self, key: bytes, hashes=None) -> bool:
        return True

    def get(self, key: bytes, hashes=None) -> bytes | None:
        import bisect

        i = bisect.bisect_left(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            with open(self.path, "rb") as f:
                f.seek(self.offs[i])
                return f.read(self.lens[i])
        return None

    def iter_items(self, start: bytes | None = None
                   ) -> Iterator[tuple[bytes, bytes]]:
        import bisect

        lo = 0 if start is None else bisect.bisect_left(self.keys, start)
        with open(self.path, "rb") as f:
            for i in range(lo, self.n):
                f.seek(self.offs[i])
                yield self.keys[i], f.read(self.lens[i])

    def iter_keys(self) -> Iterator[bytes]:
        yield from self.keys

    def close(self) -> None:
        pass


def _open_segment(path: str):
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == _MAGIC_V2:
        return _Segment(path)
    return _SegmentV1(path)


class _Memtable:
    """In-RAM sorted-on-demand write buffer backed by one WAL file.

    Two backends: the Python dict (``data``) and, for the two
    inverted-index strategies, the native C++ postings table (``nat``,
    csrc wn_pt_*) — the import hot path runs whole (prop, batch) columns
    through one FFI call there instead of ~15 Python ops per term. The
    dict backend remains the fallback (WEAVIATE_TPU_NO_NATIVE=1) and
    conformance oracle; "map" buckets only opt in via postings_schema
    because the native table fixes the value shape to doc->(tf, len)."""

    __slots__ = ("data", "bytes", "wal", "nat")

    def __init__(self, wal: WriteAheadLog | None, strategy: str | None = None,
                 postings_schema: bool = False):
        self.data: dict[bytes, object] = {}
        self.bytes = 0
        self.wal = wal
        self.nat = None
        if (strategy == "roaringset"
                or (strategy == "map" and postings_schema)):
            if native.available():
                self.nat = native.PostingsTable(strategy)

    @property
    def has_data(self) -> bool:
        if self.nat is not None:
            return len(self.nat) > 0
        return bool(self.data)

    def _nat_apply(self, strategy: str, key: bytes, value) -> None:
        nat = self.nat
        if value is _TOMBSTONE:
            nat.tomb(key)
        elif strategy == "map":
            if "plazy" in value:
                for docs, tfs, lens in value["plazy"]:
                    nat.map_columns([key], np.asarray([0, len(docs)]),
                                    docs, tfs, lens, frame=False)
            else:
                dele = value.get("del") or ()
                if dele:
                    dele = np.asarray(sorted(dele), dtype=np.int64)
                    nat.map_delete([key], np.asarray([0, len(dele)]), dele)
                ent = value.get("set") or {}
                if ent:
                    docs = np.fromiter(ent.keys(), np.int64, len(ent))
                    tfs = np.asarray([v[0] for v in ent.values()], np.uint32)
                    lens = np.asarray([v[1] for v in ent.values()], np.uint32)
                    nat.map_columns([key], np.asarray([0, len(docs)]),
                                    docs, tfs, lens, frame=False)
        else:  # roaringset
            value = _coalesce_roaring(value)
            if len(value["del"]):
                nat.roar([key], np.asarray([0, len(value["del"])]),
                         value["del"], is_del=True, frame=False)
            if len(value["add"]):
                nat.roar([key], np.asarray([0, len(value["add"])]),
                         value["add"], frame=False)
        self.bytes += len(key) + 64

    def apply(self, strategy: str, key: bytes, value) -> None:
        if self.nat is not None:
            self._nat_apply(strategy, key, value)
            return
        cur = self.data.get(key)
        if value is _TOMBSTONE or cur is _TOMBSTONE or cur is None:
            self.data[key] = value
        elif (strategy == "roaringset" and len(value["del"]) == 0
                and (("lazy" in cur) or len(cur["del"]) == 0)):
            # import hot path: APPEND the add-array; coalesce lazily at
            # read/flush (per-key eager unions dominated batch imports)
            if "lazy" in cur:
                cur["lazy"].append(value["add"])
            else:
                self.data[key] = {"lazy": [cur["add"], value["add"]],
                                  "del": cur["del"]}
        elif (strategy == "map" and "plazy" in value
                and ("plazy" in cur or not cur.get("del"))):
            # import hot path: append the analyzer's column arrays; a
            # plain-dict cur (rare mixed writes) absorbs the coalesced
            # columns instead of converting back to arrays
            if "plazy" in cur:
                cur["plazy"].extend(value["plazy"])
            else:
                cur["set"].update(_coalesce_map(value)["set"])
        elif (strategy == "map" and "plazy" not in value
                and not value.get("del") and "plazy" not in cur
                and not cur.get("del")):
            # import hot path: the memtable owns ``cur`` (layer-merged
            # copies are made at read time), so fold the update in place
            # instead of copying both dicts per posting key
            cur["set"].update(value["set"])
        else:
            self.data[key] = _merge_values(strategy, cur, value)
        self.bytes += len(key) + 64

    def packed_items(self, strategy: str) -> Iterator[tuple[bytes, bytes]]:
        if self.nat is not None:
            # one native pass: sorted keys, values already in segment format
            yield from self.nat.packed_items()
            return
        for k in sorted(self.data):
            v = self.data[k]
            if v is _TOMBSTONE:
                yield k, msgpack.packb({"__tomb__": True}, use_bin_type=True)
            else:
                if strategy == "roaringset":
                    v = _coalesce_roaring(v)
                elif strategy == "map":
                    v = _coalesce_map(v)
                yield k, _pack_value(strategy, v)


class Bucket:
    """Named bucket: memtable + WAL + segment stack (reference bucket.go:45).

    Lock discipline: ``_lock`` guards the memtable trio (active, sealed
    list, segment list) and WAL handoff — all O(1) or O(batch) work.
    Segment writes and compaction run outside the lock on immutable
    snapshots; they re-acquire only to swap list entries.
    """

    #: sealed memtables allowed before writers must flush inline
    MAX_SEALED = 4

    def __init__(self, dir_path: str, name: str, strategy: str = "replace",
                 memtable_limit: int = 4 * 1024 * 1024, sync_wal: bool = False,
                 postings_schema: bool = False):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        self.name = name
        self.strategy = strategy
        # opt-in native memtable for "map" buckets whose values are
        # postings (doc -> (tf, len)); roaringset buckets always qualify
        self.postings_schema = postings_schema
        self.dir = os.path.join(dir_path, name)
        os.makedirs(self.dir, exist_ok=True)
        self.memtable_limit = memtable_limit
        self.sync_wal = sync_wal
        self._lock = threading.RLock()
        self._flush_lock = threading.Lock()  # serializes segment writers
        self._segments: list = []  # oldest -> newest
        self._sealed: list[_Memtable] = []  # oldest -> newest
        # per-bucket metric children resolved once (reference:
        # lsmkv/metrics.go wires the same vecs per bucket). Label =
        # collection/shard/bucket derived from the directory — a bare
        # bucket name ('searchable') is shared by every shard and would
        # collapse the gauges into last-writer-wins.
        from weaviate_tpu_torch.runtime import metrics as _m

        parts = os.path.normpath(dir_path).split(os.sep)[-2:]
        label = "/".join([p for p in parts if p] + [name])
        self._wal_bytes_metric = _m.lsm_wal_bytes.labels(label)
        self._memtable_metric = _m.lsm_memtable_bytes.labels(label)
        self._flush_metric = _m.lsm_flush_duration.labels(label)
        self._compaction_metric = _m.lsm_compaction_duration.labels(label)
        # recovery report: everything this open repairs/quarantines is
        # filed to storage/recovery (log + counters + /v1/debug/storage)
        self._recovery = recovery.BucketRecovery(label)
        self._load_segments()
        self._wal_seq = 0
        self._write_gen = 0
        self._maintain_gen = -1
        self._mem = self._new_mem(None)
        self._recover_wals()
        if self._mem.wal is None:
            self._mem.wal = self._new_wal()
        recovery.record(self._recovery)

    # -- startup -------------------------------------------------------------

    def _load_segments(self):
        """Open every on-disk segment. Caller holds ``_lock`` — in
        practice __init__, before the bucket is shared."""
        # a crash mid-segment-write leaves a .tmp that was never
        # renamed: invisible to recovery (the covering WAL replays),
        # but clean it up so torn bytes don't accumulate forever
        for f in os.listdir(self.dir):
            if f.endswith(".db.tmp"):
                try:
                    os.remove(os.path.join(self.dir, f))
                except OSError:
                    pass
        segs = sorted(
            f for f in os.listdir(self.dir)
            if f.startswith("segment-") and f.endswith(".db")
        )
        self._segments = []
        for s in segs:
            path = os.path.join(self.dir, s)
            try:
                self._segments.append(_open_segment(path))
            except (ValueError, struct.error, KeyError, TypeError,
                    msgpack.exceptions.UnpackException) as e:
                # parse-shaped failures only: a transient OSError (fd
                # limit, momentary EACCES) must propagate — renaming a
                # HEALTHY segment to .corrupt would silently lose it.
                # A truncated/bit-flipped segment must not brick the whole
                # bucket (reference: corrupt_commit_logs_fixer.go skips
                # unreadable tail entries) — quarantine it and continue;
                # anti-entropy or reimport restores the lost range
                logger.error(
                    "bucket %s: segment %s is corrupt (%s) — quarantined "
                    "as .corrupt, its records are lost", self.name, s, e)
                self._recovery.segments_quarantined += 1
                self._recovery.quarantined_files.append(s)
                try:
                    os.replace(path, path + ".corrupt")
                except OSError:
                    pass
        # monotonic segment sequence — never reuse or go below an existing
        # number, or newest-wins ordering breaks after compaction
        self._next_seq = (
            max((int(s.split("-")[1].split(".")[0]) for s in segs), default=-1) + 1
        )

    def _new_mem(self, wal) -> _Memtable:
        return _Memtable(wal, strategy=self.strategy,
                         postings_schema=self.postings_schema)

    def _new_wal(self) -> WriteAheadLog:
        """Mint the next WAL file. Caller holds ``_lock`` (seal path)
        or runs during single-threaded __init__."""
        path = os.path.join(self.dir, f"wal-{self._wal_seq:06d}.bin")
        self._wal_seq += 1
        return WriteAheadLog(path, sync=self.sync_wal)

    def _recover_wals(self) -> None:
        """Replay every WAL (sealed-but-unflushed + active) into the active
        memtable, oldest first; a single legacy ``wal.bin`` replays too.
        Caller holds ``_lock`` — __init__, before the bucket is shared."""
        names = sorted(
            f for f in os.listdir(self.dir)
            if (f.startswith("wal-") or f == "wal.bin") and f.endswith(".bin")
        )
        replayed_paths = []
        for nm in names:
            path = os.path.join(self.dir, nm)
            rep = ReplayReport()
            for payload in WriteAheadLog.replay(path, rep):
                rec = msgpack.unpackb(payload, raw=False, strict_map_key=False)
                if "B" in rec:  # raw-value batch frame (map import path)
                    for k, v in rec["B"]:
                        self._mem.apply(
                            self.strategy, k,
                            {"set": v["set"], "del": set(v["del"])})
                elif "P" in rec:  # postings-column map import frame
                    for k, db_, tb, lb in rec["P"]:
                        self._mem.apply(self.strategy, k, {
                            "plazy": [(np.frombuffer(db_, np.int64),
                                       np.frombuffer(tb, np.uint32),
                                       np.frombuffer(lb, np.uint32))],
                            "del": set()})
                elif "R" in rec:  # flat roaringset import frame
                    for k, vadd, nadd, vdel, ndel in rec["R"]:
                        self._mem.apply(self.strategy, k, {
                            "add": native.varint_decode(vadd,
                                                        count_hint=nadd),
                            "del": native.varint_decode(vdel,
                                                        count_hint=ndel)})
                elif "b" in rec:  # batch frame
                    for k, v in rec["b"]:
                        self._mem.apply(
                            self.strategy, k,
                            _unpack_value(self.strategy, v)
                            if v is not None else _TOMBSTONE)
                else:
                    self._mem.apply(
                        self.strategy, rec["k"],
                        _unpack_value(self.strategy, rec["v"])
                        if rec["v"] is not None else _TOMBSTONE)
            replayed_paths.append(path)
            self._recovery.wal_files_replayed += 1
            self._recovery.frames_replayed += rep.frames
            self._recovery.bytes_truncated += rep.bytes_truncated
            if rep.quarantined:
                self._recovery.wals_quarantined += 1
                self._recovery.quarantined_files.append(nm)
            if nm.startswith("wal-"):
                seq = int(nm.split("-")[1].split(".")[0])
                self._wal_seq = max(self._wal_seq, seq + 1)
        if self._mem.has_data:
            # recovered state becomes one (durably renamed) segment;
            # only then may the stale WALs delete — reversing this
            # order would lose the replayed frames to a second crash
            items = list(self._mem.packed_items(self.strategy))
            seg = self._write_segment(items)
            self._segments.append(seg)
            self._mem = self._new_mem(None)
            self._recovery.segments_recovered += 1
        for path in replayed_paths:
            # a quarantined WAL was renamed .corrupt — the remove is a
            # no-op there, the evidence file stays for forensics
            fsutil.remove_durable(path)

    # -- write path ----------------------------------------------------------

    def _log_and_apply(self, key: bytes, value) -> None:
        """Single-record write tail: WAL append, memtable apply, seal
        check. Caller holds ``_lock``."""
        packed = None if value is _TOMBSTONE else _pack_value(self.strategy, value)
        payload = msgpack.packb({"k": key, "v": packed}, use_bin_type=True)
        self._wal_bytes_metric.inc(len(payload))
        self._mem.wal.append(payload)
        self._mem.apply(self.strategy, key, value)
        self._write_gen += 1
        self._memtable_metric.set(self._mem.bytes)
        if self._mem.bytes >= self.memtable_limit:
            self._seal()

    def _append_frame_and_apply(self, payload: bytes, pairs) -> None:
        """Shared tail of every batch write path: WAL append, memtable
        apply, write-gen bump, metrics, seal check. Caller holds _lock."""
        self._wal_bytes_metric.inc(len(payload))
        self._mem.wal.append(payload)
        for k, v in pairs:
            self._mem.apply(self.strategy, k, v)
        self._write_gen += 1
        self._memtable_metric.set(self._mem.bytes)
        if self._mem.bytes >= self.memtable_limit:
            self._seal()

    def _log_and_apply_many(self, pairs: list[tuple[bytes, object]]) -> None:
        """One WAL frame + one memtable pass for a whole batch."""
        if self.strategy == "map" and len(pairs) > 8 and not any(
                v is _TOMBSTONE for _, v in pairs):
            # import hot path: ONE msgpack pack for the whole frame (raw
            # values, "B" tag) instead of one _pack_value per posting key
            frame = [[k, {"set": v["set"], "del": sorted(v["del"])}]
                     for k, v in pairs]
            payload = msgpack.packb({"B": frame}, use_bin_type=True)
            self._append_frame_and_apply(payload, pairs)
            return
        if self.strategy == "roaringset" and len(pairs) > 8 and not any(
                v is _TOMBSTONE for _, v in pairs):
            # import hot path: varint-encode every block in ONE native call
            # and pack ONE flat frame ("R" tag) — a per-key msgpack.packb
            # here was ~10% of the whole import profile
            adds = [v["add"] for _, v in pairs]
            dels = [v["del"] for _, v in pairs]
            enc = native.varint_encode_many(adds + dels)
            n = len(pairs)
            frame = [
                [k, enc[i], len(adds[i]), enc[n + i], len(dels[i])]
                for i, (k, _v) in enumerate(pairs)
            ]
            payload = msgpack.packb({"R": frame}, use_bin_type=True)
            self._append_frame_and_apply(payload, pairs)
            return
        frame = [
            [k, None if v is _TOMBSTONE else _pack_value(self.strategy, v)]
            for k, v in pairs
        ]
        payload = msgpack.packb({"b": frame}, use_bin_type=True)
        self._append_frame_and_apply(payload, pairs)

    def _seal(self) -> None:
        """Active memtable -> sealed list; fresh memtable + WAL. O(1): the
        segment write happens in background maintenance (flush_pending).
        Never flushes inline — the writer applies backpressure AFTER
        releasing ``_lock`` (lock order is _flush_lock -> _lock; flushing
        from under _lock would ABBA-deadlock against maintenance)."""
        if not self._mem.has_data:
            return
        self._sealed.append(self._mem)
        self._mem = self._new_mem(self._new_wal())

    def _backpressure(self) -> None:
        """Writer-side valve, called WITHOUT ``_lock``: when sealed
        memtables back up past MAX_SEALED, the writer pays for one flush
        instead of RAM growing without bound (reference: memtable flush
        blocks the put when the flushing queue backs up).

        Deliberately lock-free HERE, but db-layer callers wrap whole
        batches in shard/collection locks, so the flush's fsync still
        lands inside THEIR critical sections — graftlint G9 baselines
        that cluster; the fix shape (stage under the lock, pay
        backpressure after release) is ROADMAP item 6."""
        if len(self._sealed) > self.MAX_SEALED:
            self.flush_pending(max_tables=1)

    def put(self, key: bytes, value) -> None:
        """replace strategy: store value (any msgpack-able object)."""
        assert self.strategy == "replace"
        with self._lock:
            self._log_and_apply(key, value)
        self._backpressure()

    def put_many(self, pairs: Iterable[tuple[bytes, object]]) -> None:
        assert self.strategy == "replace"
        pairs = list(pairs)
        if not pairs:
            return
        with self._lock:
            self._log_and_apply_many(pairs)
        self._backpressure()

    def delete(self, key: bytes) -> None:
        assert self.strategy == "replace"
        with self._lock:
            self._log_and_apply(key, _TOMBSTONE)
        self._backpressure()

    def delete_many(self, keys: Iterable[bytes]) -> None:
        """Batch tombstones in one WAL frame (import writes one per
        object to clear any prior delete marker — per-key frames were a
        measurable slice of the batch-import profile)."""
        assert self.strategy == "replace"
        keys = list(keys)
        if not keys:
            return
        with self._lock:
            self._log_and_apply_many([(k, _TOMBSTONE) for k in keys])
        self._backpressure()

    def set_add(self, key: bytes, values) -> None:
        assert self.strategy == "set"
        with self._lock:
            self._log_and_apply(key, {"add": set(values), "del": set()})
        self._backpressure()

    def set_remove(self, key: bytes, values) -> None:
        assert self.strategy == "set"
        with self._lock:
            self._log_and_apply(key, {"add": set(), "del": set(values)})
        self._backpressure()

    def map_set(self, key: bytes, mapping: dict) -> None:
        assert self.strategy == "map"
        with self._lock:
            self._log_and_apply(key, {"set": dict(mapping), "del": set()})
        self._backpressure()

    def map_set_many(self, pairs: Iterable[tuple[bytes, dict]]) -> None:
        """Batch of (key, mapping) updates in one WAL frame."""
        assert self.strategy == "map"
        pairs = [(k, {"set": dict(m), "del": set()}) for k, m in pairs]
        if not pairs:
            return
        with self._lock:
            self._log_and_apply_many(pairs)
        self._backpressure()

    def map_set_columns_many(
            self, pairs: list[tuple[bytes, tuple]]) -> None:
        """Import fast path for postings maps: each value is a COLUMN
        triple (docs int64[], tfs, lens) from the batch analyzer. One
        WAL frame of raw array bytes ("P" tag), lazy memtable appends —
        the doc->payload dicts materialize once at read/flush instead of
        per (term, doc) posting in Python."""
        assert self.strategy == "map"
        if not pairs:
            return
        frame = [
            [k, d.astype(np.int64, copy=False).tobytes(),
             np.asarray(t, np.uint32).tobytes(),
             np.asarray(ln, np.uint32).tobytes()]
            for k, (d, t, ln) in pairs
        ]
        payload = msgpack.packb({"P": frame}, use_bin_type=True)
        lazy_pairs = [
            (k, {"plazy": [(np.asarray(d, np.int64),
                            np.asarray(t), np.asarray(ln))],
                 "del": set()})
            for k, (d, t, ln) in pairs
        ]
        with self._lock:
            self._append_frame_and_apply(payload, lazy_pairs)
        self._backpressure()

    def _concat_tail(self, mem, payload: bytes) -> None:
        """Post-native-write tail under _lock: WAL append + accounting
        (the memtable apply already happened inside the native call)."""
        self._wal_bytes_metric.inc(len(payload))
        mem.wal.append(payload)
        mem.bytes = mem.nat.bytes
        self._write_gen += 1
        self._memtable_metric.set(mem.bytes)
        if mem.bytes >= self.memtable_limit:
            self._seal()

    def map_set_columns_concat(self, keys: list[bytes],
                               entry_offs: np.ndarray, docs: np.ndarray,
                               tfs: np.ndarray, lens: np.ndarray,
                               prefix: bytes = b"") -> None:
        """Import fast path: a whole (prop, batch) of postings columns in
        ONE native call — memtable apply and "P" WAL frame come out of
        the same pass (csrc wn_pt_map_columns). Key i is
        prefix + keys[i]; its entries are the [entry_offs[i],
        entry_offs[i+1]) slice of the columns."""
        assert self.strategy == "map"
        if not len(keys):
            return
        if self._mem.nat is None:  # dict-memtable fallback: legacy path
            docs = np.asarray(docs)
            pairs = []
            for i, k in enumerate(keys):
                sl = slice(int(entry_offs[i]), int(entry_offs[i + 1]))
                pairs.append((prefix + k,
                              (docs[sl], np.asarray(tfs)[sl],
                               np.asarray(lens)[sl])))
            return self.map_set_columns_many(pairs)
        with self._lock:
            mem = self._mem
            payload = mem.nat.map_columns(keys, entry_offs, docs, tfs,
                                          lens, prefix=prefix, frame=True)
            self._concat_tail(mem, payload)
        self._backpressure()

    def bitmap_add_concat(self, keys: list[bytes], entry_offs: np.ndarray,
                          ids: np.ndarray, prefix: bytes = b"",
                          is_del: bool = False) -> None:
        """Import fast path twin for roaringset buckets: per-key id blocks
        (unsorted ok) applied + "R"-framed in one native call."""
        assert self.strategy == "roaringset"
        if not len(keys):
            return
        if self._mem.nat is None:
            ids = np.asarray(ids, dtype=np.uint64)
            pairs = [(prefix + k,
                      ids[int(entry_offs[i]):int(entry_offs[i + 1])])
                     for i, k in enumerate(keys)]
            if is_del:
                return self.bitmap_remove_many(pairs)
            return self.bitmap_add_many(pairs)
        with self._lock:
            mem = self._mem
            payload = mem.nat.roar(keys, entry_offs, ids, is_del=is_del,
                                   prefix=prefix, frame=True)
            self._concat_tail(mem, payload)
        self._backpressure()

    def map_delete(self, key: bytes, map_keys) -> None:
        assert self.strategy == "map"
        with self._lock:
            self._log_and_apply(key, {"set": {}, "del": set(map_keys)})
        self._backpressure()

    def map_delete_many(self, pairs: Iterable[tuple[bytes, Iterable]]) -> None:
        assert self.strategy == "map"
        pairs = [(k, {"set": {}, "del": set(mks)}) for k, mks in pairs]
        if not pairs:
            return
        with self._lock:
            self._log_and_apply_many(pairs)
        self._backpressure()

    def bitmap_add(self, key: bytes, ids) -> None:
        assert self.strategy == "roaringset"
        with self._lock:
            self._log_and_apply(
                key,
                {"add": np.unique(np.asarray(list(ids), np.uint64)),
                 "del": np.empty(0, np.uint64)},
            )
        self._backpressure()

    def _bitmap_concat_args(self, pairs):
        """(key, iterable) pairs -> the concat-call triple; shared by the
        add and remove batch paths so their normalization cannot drift."""
        keys = [k for k, _ in pairs]
        blocks = [np.fromiter(v, np.uint64, len(v))
                  if isinstance(v, (set, frozenset))
                  else np.asarray(v).astype(np.uint64, copy=False)
                  for _, v in pairs]
        offs = np.zeros(len(blocks) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blocks], out=offs[1:])
        ids = (np.concatenate(blocks) if offs[-1]
               else np.empty(0, np.uint64))
        return keys, offs, ids

    def bitmap_add_many(self, pairs: Iterable[tuple[bytes, Iterable]]) -> None:
        assert self.strategy == "roaringset"
        pairs = list(pairs)
        if not pairs:
            return
        if self._mem.nat is not None:
            # route through the one-call native path (it sorts/dedupes
            # each block itself)
            keys, offs, ids = self._bitmap_concat_args(pairs)
            return self.bitmap_add_concat(keys, offs, ids)
        pairs = [
            (k, {"add": _sorted_unique_u64(ids),
                 "del": np.empty(0, np.uint64)})
            for k, ids in pairs
        ]
        with self._lock:
            self._log_and_apply_many(pairs)
        self._backpressure()

    def bitmap_remove(self, key: bytes, ids) -> None:
        assert self.strategy == "roaringset"
        with self._lock:
            self._log_and_apply(
                key,
                {"add": np.empty(0, np.uint64),
                 "del": np.unique(np.asarray(list(ids), np.uint64))},
            )
        self._backpressure()

    def bitmap_remove_many(self, pairs: Iterable[tuple[bytes, Iterable]]) -> None:
        assert self.strategy == "roaringset"
        pairs = list(pairs)
        if not pairs:
            return
        if self._mem.nat is not None:
            keys, offs, ids = self._bitmap_concat_args(pairs)
            return self.bitmap_add_concat(keys, offs, ids, is_del=True)
        pairs = [
            (k, {"add": np.empty(0, np.uint64),
                 "del": np.unique(np.asarray(list(ids), np.uint64))})
            for k, ids in pairs
        ]
        with self._lock:
            self._log_and_apply_many(pairs)
        self._backpressure()

    # -- read path -----------------------------------------------------------

    def get(self, key: bytes):
        """Merged view across memtable + sealed + segments (newest wins).

        ``replace`` walks newest -> oldest and stops at the first hit;
        merge strategies fold oldest -> newest."""
        coalesce = (_coalesce_roaring if self.strategy == "roaringset"
                    else _coalesce_map if self.strategy == "map" else None)
        with self._lock:
            mem_layers = []
            for m in [*self._sealed, self._mem]:
                if m.nat is not None:
                    raw = m.nat.get_packed(key)
                    v = None
                    if raw is not None:
                        v = (_TOMBSTONE if _is_tomb_record(raw)
                             else _unpack_value(self.strategy, raw))
                    mem_layers.append(v)
                    continue
                v = m.data.get(key)
                if coalesce is not None and isinstance(v, dict):
                    canon = coalesce(v)
                    if canon is not v:
                        # write the canonical form back so a hot key is
                        # coalesced once, not on every read
                        m.data[key] = canon
                    v = canon
                mem_layers.append(v)
            segments = list(self._segments)
        if self.strategy == "replace":
            for v in reversed(mem_layers):
                if v is not None:
                    return None if v is _TOMBSTONE else v
            return _replace_segment_lookup(list(reversed(segments)), key)
        layers = []
        for seg in segments:
            raw = seg.get(key)
            if raw is not None:
                layers.append(_TOMBSTONE if _is_tomb_record(raw)
                              else _unpack_value(self.strategy, raw))
        layers.extend(v for v in mem_layers if v is not None)
        if not layers:
            return None
        out = _empty_value(self.strategy)
        seen_any = False
        for layer in layers:
            if layer is _TOMBSTONE:
                out = _empty_value(self.strategy)  # wipes prior layers
                seen_any = False
            else:
                out = _merge_values(self.strategy, out, layer)
                seen_any = True
        return out if seen_any else None

    def get_many(self, keys: list[bytes]) -> list:
        """Batched replace-strategy point lookups: ONE layer snapshot for
        the whole batch instead of a lock + sealed-list copy per key (the
        per-object docid update-check was ~5 us/object of pure snapshot
        overhead on the import path).

        The memtable probes run UNDER the lock, like ``get``'s — the
        active memtable dict keeps mutating under concurrent writers, so
        probing it unlocked could race a resize (and would let the two
        paths diverge). Segments are immutable once listed, so the disk
        lookups for memtable misses happen after the lock drops."""
        assert self.strategy == "replace"
        # faultline point: the batched property-fetch feed (native
        # plane reply building + warm pass read through here) — chaos
        # runs inject errors/latency/corruption without touching disk
        directive = faultline.fire("kv.get_many", bucket=self.name,
                                   n=len(keys))
        misses: list[int] = []
        out: list = []
        with tracing.span("kv.get_many", bucket=self.name, n=len(keys)):
            with self._lock:
                # newest first; replace memtables are always dict-backed
                mems = [m.data for m in [*self._sealed, self._mem][::-1]]
                segments = list(self._segments)[::-1]
                for idx, key in enumerate(keys):
                    for m in mems:
                        v = m.get(key)
                        if v is not None:
                            out.append(None if v is _TOMBSTONE else v)
                            break
                    else:
                        out.append(None)
                        misses.append(idx)
            for idx in misses:
                out[idx] = _replace_segment_lookup(segments, keys[idx])
            if directive == "corrupt":
                # deterministic damage: flip the first byte of every
                # value — consumers must contain the decode failure
                # (error their own reply, never hang or crash the store)
                out = [bytes([v[0] ^ 0xFF]) + v[1:]
                       if isinstance(v, bytes) and v else v for v in out]
            return out

    def get_set(self, key: bytes) -> set:
        v = self.get(key)
        return set() if v is None else set(v["add"])

    def get_map(self, key: bytes) -> dict:
        v = self.get(key)
        return {} if v is None else dict(v["set"])

    def get_bitmap(self, key: bytes) -> np.ndarray:
        v = self.get(key)
        if v is None:
            return np.empty(0, np.uint64)
        return native.difference_sorted(v["add"], v["del"])

    def _merged_layers(self, start: bytes | None = None,
                       stop: bytes | None = None):
        """Snapshot of (segments, memtables oldest->newest) for iteration.

        Sealed memtables are immutable; the ACTIVE memtable keeps mutating
        under concurrent writers, and iteration sorts its keys lazily, so a
        shallow dict copy is taken while still holding the lock (otherwise a
        concurrent put() resizing the dict raises mid-sort). Native-backed
        memtables materialize their [start, stop) items (still packed) in
        one call under the lock."""
        with self._lock:
            mems = []
            for m in [*self._sealed, self._mem]:
                if m.nat is not None:
                    mems.append(m.nat.packed_items(start, stop))
                elif m is self._mem:
                    mems.append(dict(m.data))
                else:
                    mems.append(m.data)
            return list(self._segments), mems

    def iter_merged(self, start: bytes | None = None,
                    stop: bytes | None = None
                    ) -> Iterator[tuple[bytes, object]]:
        """Streaming key-ordered cursor over merged layers, tombstones
        included (value is _TOMBSTONE) — the compaction/scan primitive
        (reference: segment cursors, lsmkv/cursor.go). ``start``/``stop``
        bound the key range [start, stop) — segments seek via their on-disk
        index, so a range scan costs O(log n + range)."""
        segments, mems = self._merged_layers(start, stop)

        def seg_iter(seg, rank):
            for k, raw in seg.iter_items(start=start):
                if stop is not None and k >= stop:
                    return
                v = _TOMBSTONE if _is_tomb_record(raw) else \
                    _unpack_value(self.strategy, raw)
                yield k, rank, v

        def mem_iter(data, rank):
            if isinstance(data, list):  # native table: (key, packed) pairs
                for k, raw in data:
                    v = _TOMBSTONE if _is_tomb_record(raw) else \
                        _unpack_value(self.strategy, raw)
                    yield k, rank, v
                return
            coalesce = (_coalesce_roaring if self.strategy == "roaringset"
                        else _coalesce_map if self.strategy == "map"
                        else None)
            for k in sorted(data):
                if start is not None and k < start:
                    continue
                if stop is not None and k >= stop:
                    return
                v = data[k]
                if coalesce is not None and isinstance(v, dict):
                    v = coalesce(v)
                yield k, rank, v

        iters = [seg_iter(s, i) for i, s in enumerate(segments)]
        iters += [mem_iter(d, len(segments) + i) for i, d in enumerate(mems)]
        merged = heapq.merge(*iters, key=lambda t: (t[0], t[1]))
        cur_key: bytes | None = None
        cur_val = None
        for k, _rank, v in merged:
            if k != cur_key:
                if cur_key is not None:
                    yield cur_key, cur_val
                cur_key, cur_val = k, v
            else:
                if v is _TOMBSTONE or cur_val is _TOMBSTONE:
                    cur_val = v
                else:
                    cur_val = _merge_values(self.strategy, cur_val, v)
        if cur_key is not None:
            yield cur_key, cur_val

    def keys(self) -> list[bytes]:
        return [k for k, v in self.iter_merged() if v is not _TOMBSTONE]

    def iter_items(self) -> Iterator[tuple[bytes, object]]:
        """Cursor over merged live items in key order (reference: segment
        cursors used by the flat index full scan)."""
        for k, v in self.iter_merged():
            if v is not _TOMBSTONE:
                yield k, v

    def iter_range(self, start: bytes | None = None,
                   stop: bytes | None = None
                   ) -> Iterator[tuple[bytes, object]]:
        """Live merged items with keys in [start, stop)."""
        for k, v in self.iter_merged(start, stop):
            if v is not _TOMBSTONE:
                yield k, v

    def __len__(self) -> int:
        n = 0
        for _ in self.iter_items():
            n += 1
        return n

    # -- flush / compaction --------------------------------------------------

    @property
    def dirty(self) -> bool:
        """True when unflushed entries exist (active or sealed memtables)."""
        return self._mem.has_data or bool(self._sealed)

    @property
    def segment_count(self) -> int:
        return len(self._segments)

    def _write_segment(self, items: list[tuple[bytes, bytes]]):
        """Write one segment file. Caller holds ``_flush_lock`` (flush/
        compaction serialization) or runs during single-threaded
        __init__ recovery; ``_next_seq`` is only touched under those."""
        path = os.path.join(self.dir, f"segment-{self._next_seq:06d}.db")
        self._next_seq += 1
        return _Segment.write(path, items)

    def flush_pending(self, max_tables: int | None = None) -> bool:
        """Turn sealed memtables into segments (background work; reference:
        store_cyclecallbacks.go flush cycle). Returns True if flushed any."""
        did = False
        with self._flush_lock:
            while True:
                with self._lock:
                    if not self._sealed:
                        break
                    if max_tables is not None and max_tables <= 0:
                        break
                    mt = self._sealed[0]
                    seq_path = os.path.join(
                        self.dir, f"segment-{self._next_seq:06d}.db")
                    self._next_seq += 1
                    items = list(mt.packed_items(self.strategy))
                # segment write happens outside the bucket lock
                with self._flush_metric.time():
                    seg = _Segment.write(seq_path, items)
                with self._lock:
                    self._segments.append(seg)
                    self._sealed.pop(0)
                if mt.wal is not None:
                    mt.wal.close()
                    # the covering WAL deletes only AFTER the segment's
                    # rename is durable (atomic_replace inside
                    # _Segment.write); a crash in this window replays
                    # the WAL onto the new segment — idempotent
                    fsutil.remove_durable(mt.wal.path,
                                          crashpoint="segment.post_rename")
                did = True
                if max_tables is not None:
                    max_tables -= 1
        return did

    def flush(self) -> None:
        """Force: seal the active memtable and write every pending segment
        (close/backup; reference bucket.FlushMemtable)."""
        with self._lock:
            self._seal()
        self.flush_pending()

    def maintain(self, compact_above: int = 4) -> bool:
        """One background cycle: flush sealed memtables; compact when the
        segment stack grows past the threshold. Seals the active memtable
        only when it is IDLE (no writes since the previous cycle) — a
        steady trickle of small writes must not become one tiny segment
        per cycle plus recurring full-bucket compactions."""
        did = self.flush_pending()
        with self._lock:
            idle = self._write_gen == self._maintain_gen
            self._maintain_gen = self._write_gen
            if self._mem.has_data and not self._sealed and idle:
                self._seal()
        did = self.flush_pending() or did
        if self.segment_count > compact_above:
            self.compact()
            did = True
        return did

    def compact(self) -> None:
        """Merge the current segment stack into one, strategy-aware,
        dropping tombstones (reference: segment_group_compaction.go +
        compactor_{replace,set,map}.go). Streams through a k-way merge —
        peak RAM is O(1) records, not the whole bucket."""
        with self._flush_lock, self._compaction_metric.time():
            with self._lock:
                snapshot = list(self._segments)
            if len(snapshot) <= 1:
                return

            def seg_iter(seg, rank):
                for k, raw in seg.iter_items():
                    v = _TOMBSTONE if _is_tomb_record(raw) else \
                        _unpack_value(self.strategy, raw)
                    yield k, rank, v

            merged = heapq.merge(
                *[seg_iter(s, i) for i, s in enumerate(snapshot)],
                key=lambda t: (t[0], t[1]))

            def live_items():
                cur_key: bytes | None = None
                cur_val = None
                for k, _rank, v in merged:
                    if k != cur_key:
                        if cur_key is not None and cur_val is not _TOMBSTONE:
                            yield cur_key, _pack_value(self.strategy, cur_val)
                        cur_key, cur_val = k, v
                    else:
                        if v is _TOMBSTONE or cur_val is _TOMBSTONE:
                            cur_val = v
                        else:
                            cur_val = _merge_values(self.strategy, cur_val, v)
                if cur_key is not None and cur_val is not _TOMBSTONE:
                    yield cur_key, _pack_value(self.strategy, cur_val)

            # Crash safety: write the merged segment as a NEW higher-seq
            # segment first, then delete the old ones. A crash in between
            # leaves old + merged coexisting, which replays consistently
            # (merge is idempotent; replace takes the newest layer).
            with self._lock:
                path = os.path.join(
                    self.dir, f"segment-{self._next_seq:06d}.db")
                self._next_seq += 1
            # stream the merge straight into the segment writer — peak RAM
            # stays O(1) records even for multi-GB buckets
            merged_seg = _Segment.write(path, live_items())
            if merged_seg.n == 0:
                merged_seg.close()
                try:
                    os.remove(path)
                except OSError:
                    pass
                merged_seg = None
            with self._lock:
                tail = self._segments[len(snapshot):]  # flushed meanwhile
                self._segments = ([merged_seg] if merged_seg else []) + tail
            # unlink only — concurrent readers may still hold the old list
            # snapshot; the inode stays alive until their references drop
            # and GC closes the mmap (POSIX unlink-while-open semantics).
            # Durable unlink: a crash that rolls a delete back leaves
            # old + merged coexisting, which replays consistently, but
            # the fsync keeps the window one crash wide, not unbounded.
            for seg in snapshot:
                fsutil.remove_durable(seg.path)

    def close(self) -> None:
        self.flush()
        with self._lock:
            if self._mem.wal is not None:
                self._mem.wal.close()
                # an empty active WAL leaves no recovery work behind
                try:
                    if os.path.getsize(self._mem.wal.path) == 0:
                        os.remove(self._mem.wal.path)
                except OSError:
                    pass
            for seg in self._segments:
                seg.close()


class KVStore:
    """Directory of named buckets (reference Store, lsmkv/store.go:36)."""

    def __init__(self, dir_path: str, sync_wal: bool = False):
        self.dir = dir_path
        self.sync_wal = sync_wal
        os.makedirs(dir_path, exist_ok=True)
        self._buckets: dict[str, Bucket] = {}
        self._lock = threading.Lock()

    def bucket(self, name: str, strategy: str = "replace", **kwargs) -> Bucket:
        """``sync_wal`` in ``kwargs`` overrides the store default —
        the raft bucket pins ``sync_wal=True`` regardless of config
        (an unsynced vote/log ack breaks raft's safety argument). An
        explicit override that CONTRADICTS an already-open bucket
        raises: silently returning the unsynced instance would make the
        pin a no-op and reopen the double-vote window with zero
        diagnostic."""
        explicit_sync = kwargs.get("sync_wal")
        with self._lock:
            if name not in self._buckets:
                kwargs.setdefault("sync_wal", self.sync_wal)
                self._buckets[name] = Bucket(
                    self.dir, name, strategy, **kwargs
                )
            b = self._buckets[name]
            if b.strategy != strategy:
                raise ValueError(
                    f"bucket {name!r} exists with strategy {b.strategy!r}"
                )
            if explicit_sync is not None and b.sync_wal != explicit_sync:
                raise ValueError(
                    f"bucket {name!r} is already open with sync_wal="
                    f"{b.sync_wal}; an explicit sync_wal={explicit_sync} "
                    "request cannot be honored after the fact")
            return b

    def buckets(self) -> list[Bucket]:
        with self._lock:
            return list(self._buckets.values())

    def close(self) -> None:
        with self._lock:
            for b in self._buckets.values():
                b.close()
            self._buckets.clear()
