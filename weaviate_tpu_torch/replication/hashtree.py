"""Merkle hashtree over a shard's object digests (port of
``weaviate_tpu/replication/hashtree.py``; host only).

Reference: usecases/replica/hashtree/ (plain/compact/segmented trees,
diff readers). Leaves are 2^depth buckets keyed by uuid hash; a leaf's
hash is the XOR of its entry hashes (order-independent, incrementally
mergeable), inner nodes hash their children. Two replicas walk the tree
top-down exchanging node hashes to find the leaf ranges that differ,
then reconcile only those buckets' entries.
"""

from __future__ import annotations

import hashlib

import xxhash

HASH_LEN = 16


def entry_hash(uuid: str, mtime: int, deleted: bool, content_hash: bytes) -> bytes:
    h = hashlib.sha256()
    h.update(uuid.encode())
    h.update(mtime.to_bytes(8, "little"))
    h.update(b"D" if deleted else b"L")
    h.update(content_hash)
    return h.digest()[:HASH_LEN]


def digest_rank(d: dict) -> tuple:
    """Total order over replica digests: newest mtime wins; at equal
    mtime a tombstone beats an object; at a full tie the content hash
    breaks it DETERMINISTICALLY — both sides of a conflict order the
    same way, so same-millisecond divergent writes still converge
    instead of re-diffing forever."""
    return (d["mtime"], 1 if d["deleted"] else 0, d["hash"])


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


class MerkleTree:
    """levels[0] = root ... levels[depth] = leaves (2^depth buckets)."""

    def __init__(self, depth: int = 8):
        self.depth = depth
        self.n_leaves = 1 << depth
        self.leaves = [bytes(HASH_LEN)] * self.n_leaves
        self._levels: list[list[bytes]] | None = None

    @staticmethod
    def bucket_of(uuid: str, depth: int) -> int:
        return xxhash.xxh64_intdigest(uuid) % (1 << depth)

    def insert(self, uuid: str, mtime: int, deleted: bool,
               content_hash: bytes) -> None:
        b = self.bucket_of(uuid, self.depth)
        self.leaves[b] = _xor(self.leaves[b],
                              entry_hash(uuid, mtime, deleted, content_hash))
        self._levels = None

    def _build(self) -> list[list[bytes]]:
        if self._levels is None:
            levels = [self.leaves]
            cur = self.leaves
            while len(cur) > 1:
                nxt = []
                for i in range(0, len(cur), 2):
                    h = hashlib.sha256()
                    h.update(cur[i])
                    h.update(cur[i + 1])
                    nxt.append(h.digest()[:HASH_LEN])
                levels.append(nxt)
                cur = nxt
            levels.reverse()  # [root ... leaves]
            self._levels = levels
        return self._levels

    @property
    def root(self) -> bytes:
        return self._build()[0][0]

    def level_hashes(self, level: int, positions: list[int]) -> list[bytes]:
        lv = self._build()[level]
        return [lv[p] for p in positions]

    def diff_buckets(self, peer_level_fn) -> list[int]:
        """Walk down against a peer; returns differing leaf buckets.

        ``peer_level_fn(level, positions) -> list[bytes]`` returns the
        peer's node hashes (the RPC). Exchange volume is O(diff * depth),
        the point of the reference's hashtree sync.
        """
        candidates = [0]
        if peer_level_fn(0, [0])[0] == self.root:
            return []
        for level in range(1, self.depth + 1):
            children = [c for p in candidates for c in (2 * p, 2 * p + 1)]
            mine = self.level_hashes(level, children)
            theirs = peer_level_fn(level, children)
            candidates = [c for c, m, t in zip(children, mine, theirs)
                          if m != t]
            if not candidates:
                return []
        return candidates
