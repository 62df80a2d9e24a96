"""Binary object codec.

Reference: entities/storobj/storage_object.go:567 (MarshalBinary) — a
versioned binary layout of [version, docID, timestamps, UUID, vector(s),
properties]. Here the layout is:

    u8  version (=1)
    u64 doc_id
    u64 creation_time_unix_ms
    u64 last_update_time_unix_ms
    16B uuid (raw bytes)
    u32 n_named_vectors
      per named vector: u16 name_len, name utf8, u32 dim, dim*f32
    u32 props_len, msgpack(properties)

msgpack replaces the reference's JSON property payload (smaller, faster,
schema-free); vectors are raw little-endian f32 exactly like the reference.
"""

from __future__ import annotations

import struct
import time
import uuid as uuid_mod
from dataclasses import dataclass, field

import msgpack
import numpy as np

_VERSION = 1
_HEADER = struct.Struct("<BQQQ16s")


@dataclass
class StorageObject:
    uuid: str
    doc_id: int = 0
    properties: dict = field(default_factory=dict)
    vectors: dict[str, np.ndarray] = field(default_factory=dict)
    creation_time_ms: int = 0
    last_update_time_ms: int = 0

    def __post_init__(self):
        if not self.creation_time_ms:
            self.creation_time_ms = int(time.time() * 1000)
        if not self.last_update_time_ms:
            self.last_update_time_ms = self.creation_time_ms

    @property
    def vector(self) -> np.ndarray | None:
        """Default (unnamed) vector, stored under ''."""
        return self.vectors.get("")

    @vector.setter
    def vector(self, v):
        self.vectors[""] = np.asarray(v, dtype=np.float32)

    def to_bytes(self) -> bytes:
        u = self.uuid
        try:
            # canonical 36-char form: hex-parse directly (uuid.UUID() costs
            # ~5x as much and this runs once per imported object)
            uid = bytes.fromhex(u.replace("-", "")) if len(u) in (32, 36) \
                else uuid_mod.UUID(u).bytes
            if len(uid) != 16:
                uid = uuid_mod.UUID(u).bytes
        except ValueError:
            uid = uuid_mod.UUID(u).bytes
        parts = [
            _HEADER.pack(
                _VERSION,
                self.doc_id,
                self.creation_time_ms,
                self.last_update_time_ms,
                uid,
            ),
            struct.pack("<I", len(self.vectors)),
        ]
        for name, vec in sorted(self.vectors.items()):
            nb = name.encode("utf-8")
            vec = np.ascontiguousarray(vec, dtype=np.float32)
            parts.append(struct.pack("<H", len(nb)))
            parts.append(nb)
            parts.append(struct.pack("<I", vec.shape[0]))
            parts.append(vec.tobytes())
        props = msgpack.packb(self.properties, use_bin_type=True)
        parts.append(struct.pack("<I", len(props)))
        parts.append(props)
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "StorageObject":
        version, doc_id, ctime, mtime, uid = _HEADER.unpack_from(data, 0)
        if version != _VERSION:
            raise ValueError(f"unsupported storage object version {version}")
        off = _HEADER.size
        (n_vecs,) = struct.unpack_from("<I", data, off)
        off += 4
        vectors: dict[str, np.ndarray] = {}
        for _ in range(n_vecs):
            (nlen,) = struct.unpack_from("<H", data, off)
            off += 2
            name = data[off : off + nlen].decode("utf-8")
            off += nlen
            (dim,) = struct.unpack_from("<I", data, off)
            off += 4
            vec = np.frombuffer(data, dtype="<f4", count=dim, offset=off).copy()
            off += 4 * dim
            vectors[name] = vec
        (plen,) = struct.unpack_from("<I", data, off)
        off += 4
        props = msgpack.unpackb(data[off : off + plen], raw=False)
        return cls(
            uuid=str(uuid_mod.UUID(bytes=uid)),
            doc_id=doc_id,
            properties=props,
            vectors=vectors,
            creation_time_ms=ctime,
            last_update_time_ms=mtime,
        )

    def touch(self):
        self.last_update_time_ms = int(time.time() * 1000)

    def content_hash(self) -> bytes:
        """Replica-comparable digest: EXCLUDES doc_id, which is assigned
        per-replica and legitimately differs (replication digests,
        usecases/replica hashtree leaves)."""
        import hashlib

        h = hashlib.sha1()
        h.update(uuid_mod.UUID(self.uuid).bytes)
        h.update(self.last_update_time_ms.to_bytes(8, "little"))
        for name, vec in sorted(self.vectors.items()):
            h.update(name.encode())
            h.update(np.ascontiguousarray(vec, dtype=np.float32).tobytes())
        h.update(msgpack.packb(self.properties, use_bin_type=True))
        return h.digest()[:16]
