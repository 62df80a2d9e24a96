"""HNSW graph index (port of ``weaviate_tpu/engine/hnsw.py``).

Reference: adapters/repos/db/vector/hnsw/ (index.go:39 struct, insert.go:226
Add, search.go:64 SearchByVector, heuristic.go neighbor selection,
delete.go tombstones, commit_logger.go:246 durability).

The graph lives on the host, as in the JAX package: a graph walk is
dependent pointer-chasing, so every hop scores ALL unvisited neighbors of
the popped candidate in one vectorized numpy batch, and the port's native
host library (``native.HnswNative``, the C++ walker) runs searches and the
per-layer ef-search of inserts. ``device`` (default: the card) decides
where a bulk build's kNN graph and link selection run
(``engine/hnsw_build.py``: ``fused_topk_scan`` over a bf16 copy of the
corpus on the card, the JAX package's host path on the CPU) and where a
PQ codebook trains.

Durability: optional append-only commit log (reference commit_logger.go)
with snapshot-condense (condensor.go) and replay-on-open (startup.go:57).
The shard layer instead replays vectors from the objects bucket; the
commit log serves standalone/embedded users of the index.
"""

from __future__ import annotations

import heapq
import math
import os
import pickle
import random
import threading

import numpy as np
import torch

from weaviate_tpu_torch.device import resolve
from weaviate_tpu_torch.runtime import faultline
from weaviate_tpu_torch.storage.wal import WriteAheadLog

# filtered queries with fewer allowed candidates than this do a brute-force
# scan instead of a graph walk (reference: flatSearchCutoff, hnsw/index.go:95)
DEFAULT_FLAT_CUTOFF = 40_000

# reference: dynamic ef bounds (entities/vectorindex/hnsw/config.go defaults)
AUTO_EF_MIN, AUTO_EF_MAX, AUTO_EF_FACTOR = 100, 500, 8


class HNSWIndex:
    """Implements the reference ``VectorIndex`` contract
    (adapters/repos/db/vector_index.go:24-45) with an HNSW graph."""

    index_type = "hnsw"

    def __init__(self, dim: int, metric: str = "l2-squared",
                 max_connections: int = 32, ef_construction: int = 128,
                 ef: int = -1, capacity: int = 1024, seed: int = 0,
                 flat_cutoff: int = DEFAULT_FLAT_CUTOFF,
                 commit_log_dir: str | None = None,
                 condense_above_bytes: int = 16 << 20, device=None,
                 **_ignored):
        if metric not in ("l2-squared", "dot", "cosine", "cosine-dot",
                          "manhattan", "hamming"):
            raise ValueError(f"unsupported hnsw metric {metric!r}")
        self.device = resolve(device)
        self.dim = dim
        self.metric = metric
        self.m = max_connections
        self.m0 = 2 * max_connections  # layer-0 budget (reference maxConnections*2)
        self.ef_construction = ef_construction
        self.ef = ef
        self.flat_cutoff = flat_cutoff
        self._ml = 1.0 / math.log(max(self.m, 2))
        self._rng = random.Random(seed)
        self._lock = threading.RLock()

        cap = max(capacity, 64)
        self._vecs = np.zeros((cap, dim), dtype=np.float32)
        self._levels = np.full(cap, -1, dtype=np.int32)  # -1 = unused slot
        self._doc_ids = np.full(cap, -1, dtype=np.int64)
        self._tombstone = np.zeros(cap, dtype=bool)
        # per-slot list over layers of int32 neighbor-slot arrays
        self._links: list[list[np.ndarray]] = [[] for _ in range(cap)]
        self._visited = np.zeros(cap, dtype=np.int64)  # visit-epoch stamps
        self._visit_epoch = 0
        # runtime PQ compression state (compress.go:38): codes + codebook
        # when compressed, and the per-query ADC LUT during a search
        self._codes: np.ndarray | None = None
        self._pq_codebook = None
        self._pq_cents: np.ndarray | None = None  # host copy of the codebook
        self._pq_rescore = 4
        self._adc_lut: np.ndarray | None = None
        self._id_to_slot: dict[int, int] = {}
        self._count = 0
        self._ep = -1  # entrypoint slot
        self._max_level = -1

        # native graph mirror (csrc wn_hnsw_*): the C++ walker replaces the
        # Python heap loop for searches AND the per-layer ef-search of
        # inserts; kept current incrementally via _set_links / vector /
        # tombstone writes, re-uploaded in one batched sync after bulk
        # mutations (bulk_build / restore / WAL replay mark it dirty)
        self._native = None
        self._native_dirty = False

        # WAL appends (and the wal_sync-gated fsync) run inside ``_lock``
        # so the log order matches mutation order — graftlint G9 baselines
        # this cluster with a reason; decoupling needs the sequenced WAL
        # queue sketched in ROADMAP item 6 (enqueue under the lock, append
        # and fsync on a writer thread outside it, replay in sequence)
        self._log: WriteAheadLog | None = None
        self._log_dir = commit_log_dir
        self._condense_above = condense_above_bytes
        if commit_log_dir:
            os.makedirs(commit_log_dir, exist_ok=True)
            self._replay(commit_log_dir)
            self._log = WriteAheadLog(os.path.join(commit_log_dir, "hnsw.wal"))

        if self._native is None:
            from weaviate_tpu_torch import native as _nat

            if _nat.hnsw_supported(metric):
                try:
                    self._native = _nat.HnswNative(dim, metric)
                except Exception:
                    self._native = None
        self._native_dirty = self._count > 0

        # memory-ledger host-tier entry: the graph's arrays live in host
        # RAM (placement="host" — excluded from device admission totals,
        # visible in the /v1/debug/memory breakdown)
        from weaviate_tpu_torch.runtime import hbm_ledger

        self._hbm_owner = hbm_ledger.current_owner()
        self._hbm_keys: dict[str, int] = {}
        import weakref

        weakref.finalize(self, hbm_ledger.ledger.release_many,
                         self._hbm_keys.values())
        self._hbm_sync()

    def _hbm_sync(self):
        if not hasattr(self, "_hbm_keys"):
            return  # _grow during WAL replay, before the ledger wiring
        from weaviate_tpu_torch.runtime import hbm_ledger

        nbytes = sum(int(a.nbytes) for a in (
            self._vecs, self._levels, self._doc_ids, self._tombstone,
            self._visited))
        if self._codes is not None:
            nbytes += int(self._codes.nbytes)
        hbm_ledger.ledger.set_keyed(
            self._hbm_keys, "graph", nbytes, owner=self._hbm_owner,
            dtype="float32", placement="host")

    # -- distance (host batch engine) ----------------------------------------

    def _norm(self, v: np.ndarray) -> np.ndarray:
        if self.metric in ("cosine", "cosine-dot"):
            n = np.linalg.norm(v, axis=-1, keepdims=True)
            return v / np.where(n > 1e-30, n, 1.0)
        return v

    def _dist(self, q: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """Distance from query [d] to a slot batch [m] — one vectorized op
        (replaces the per-pair asm call of distancer/asm/*.s).

        With an active per-query ADC LUT (compressed graph traversal,
        reference compress.go:38: candidate scoring runs on PQ codes), the
        hop costs one [m_rows, m] code gather + LUT sum instead of a
        [m_rows, d] float read; final candidates rescore exactly."""
        if self._adc_lut is not None:
            codes = self._codes[slots]  # [m_rows, m]
            return np.take_along_axis(
                self._adc_lut, codes.astype(np.int64).T, axis=1
            ).sum(axis=0)
        rows = self._vecs[slots]
        if self.metric == "l2-squared":
            diff = rows - q
            return np.einsum("md,md->m", diff, diff)
        if self.metric in ("dot",):
            return -(rows @ q)
        if self.metric in ("cosine", "cosine-dot"):
            return 1.0 - rows @ q  # both sides normalized at insert/query
        if self.metric == "manhattan":
            return np.abs(rows - q).sum(axis=1)
        # hamming over float values (reference hamming.go:18-27)
        return (rows != q).sum(axis=1).astype(np.float32)

    def _dist_pair(self, a: int, b: int) -> float:
        return float(self._dist(self._vecs[a], np.array([b]))[0])

    # -- capacity -------------------------------------------------------------

    def _grow(self, need: int):
        """Capacity-double every parallel array. Caller holds ``_lock``."""
        cap = len(self._vecs)
        if need <= cap:
            return
        new_cap = cap
        while new_cap < need:
            new_cap *= 2
        self._vecs = np.vstack([self._vecs,
                                np.zeros((new_cap - cap, self.dim), np.float32)])
        self._levels = np.concatenate([self._levels,
                                       np.full(new_cap - cap, -1, np.int32)])
        self._doc_ids = np.concatenate([self._doc_ids,
                                        np.full(new_cap - cap, -1, np.int64)])
        self._tombstone = np.concatenate([self._tombstone,
                                          np.zeros(new_cap - cap, bool)])
        self._visited = np.concatenate([self._visited,
                                        np.zeros(new_cap - cap, np.int64)])
        if self._codes is not None:
            self._codes = np.vstack([
                self._codes,
                np.zeros((new_cap - cap, self._codes.shape[1]), np.uint8)])
        self._links.extend([] for _ in range(new_cap - cap))
        for i in range(cap, new_cap):
            self._links[i] = []
        self._hbm_sync()

    # -- graph search core ----------------------------------------------------

    def _search_layer(self, q: np.ndarray, eps: list[tuple[float, int]],
                      ef: int, layer: int) -> list[tuple[float, int]]:
        """Best-first ef-search on one layer (reference
        searchLayerByVectorWithDistancer, search.go:173-341). Entry/exit is
        a list of (dist, slot) tuples. Tombstoned nodes are traversed but
        returned too — callers filter; pruning them here would disconnect
        regions behind tombstones (same reason the reference keeps them).
        Caller holds ``_lock`` (the epoch-stamped visited marks are
        exactly why: two unlocked searches would share an epoch)."""
        if (self._native is not None and not self._native_dirty
                and self._adc_lut is None):
            d, s = self._native.search_layer(
                q, ef, layer,
                np.asarray([slot for _d, slot in eps], dtype=np.int64),
                np.asarray([dd for dd, _s in eps], dtype=np.float32))
            return list(zip(d.tolist(), s.tolist()))
        # epoch-stamped visited marks: allocation-free per call (a fresh
        # bool[capacity] per layer-search dominates at 1M-slot capacities)
        self._visit_epoch += 1
        epoch = self._visit_epoch
        visited = self._visited
        cand: list[tuple[float, int]] = []  # min-heap
        top: list[tuple[float, int]] = []  # max-heap via negated dist
        for d, s in eps:
            visited[s] = epoch
            heapq.heappush(cand, (d, s))
            heapq.heappush(top, (-d, s))
        while cand:
            d, c = heapq.heappop(cand)
            if top and d > -top[0][0] and len(top) >= ef:
                break
            links = self._links[c]
            if layer >= len(links):
                continue
            neigh = links[layer]
            if len(neigh) == 0:
                continue
            fresh = neigh[visited[neigh] != epoch]
            if len(fresh) == 0:
                continue
            visited[fresh] = epoch
            dists = self._dist(q, fresh)  # ← the batched hop
            worst = -top[0][0] if top else np.inf
            for nd, ns in zip(dists.tolist(), fresh.tolist()):
                if len(top) < ef or nd < worst:
                    heapq.heappush(cand, (nd, ns))
                    heapq.heappush(top, (-nd, ns))
                    if len(top) > ef:
                        heapq.heappop(top)
                    worst = -top[0][0]
        return sorted((-d, s) for d, s in top)

    def _greedy_descend(self, q: np.ndarray, slot: int, dist: float,
                        from_level: int, to_level: int) -> tuple[float, int]:
        """ef=1 walk down the upper layers (search.go:479 descent loop)."""
        for layer in range(from_level, to_level, -1):
            improved = True
            while improved:
                improved = False
                links = self._links[slot]
                if layer >= len(links) or len(links[layer]) == 0:
                    break
                neigh = links[layer]
                dists = self._dist(q, neigh)
                j = int(np.argmin(dists))
                if dists[j] < dist:
                    dist, slot = float(dists[j]), int(neigh[j])
                    improved = True
        return dist, slot

    # -- native mirror --------------------------------------------------------

    def _native_sync(self):
        """Re-upload the whole graph to the native mirror in one batched
        pass — the recovery path after mutations that bypass the
        incremental mirror (bulk_build's direct link writes, restore,
        WAL replay). O(count) once; incremental afterward. Caller
        holds ``_lock``."""
        nat = self._native
        if nat is None:
            return
        nat.reset(len(self._vecs))
        n = self._count
        if n:
            nat.set_vectors(0, np.ascontiguousarray(self._vecs[:n]))
            slots: list[int] = []
            layers: list[int] = []
            counts: list[int] = []
            total = 0
            for s in range(n):
                for ly, arr in enumerate(self._links[s]):
                    slots.append(s)
                    layers.append(ly)
                    counts.append(len(arr))
                    total += len(arr)
            if slots:
                neigh = np.empty(total, dtype=np.int32)
                pos = 0
                for s in range(n):
                    for arr in self._links[s]:
                        neigh[pos:pos + len(arr)] = arr
                        pos += len(arr)
                nat.set_links_batch(
                    np.asarray(slots, dtype=np.int64),
                    np.asarray(layers, dtype=np.int32),
                    np.asarray(counts, dtype=np.int32), neigh)
            dead = np.nonzero(self._tombstone[:n]
                              | (self._doc_ids[:n] < 0))[0]
            if len(dead):
                nat.set_tombstones(dead)
        self._native_dirty = False

    # -- neighbor selection (heuristic.go) ------------------------------------

    def _select_heuristic(self, cands: list[tuple[float, int]],
                          m: int) -> list[int]:
        """Keep a candidate only if it is closer to the query than to every
        already-selected neighbor — the diversity heuristic of
        heuristic.go (selectNeighborsHeuristic) — then BACKFILL pruned
        candidates nearest-first up to the budget (hnswlib
        keepPrunedConnections / reference's returnList top-up): without
        the backfill the graph ends up far under-connected and recall
        collapses (round-2 measured 0.60@ef=64 on 200k without it)."""
        cands = sorted(cands)
        slots = np.asarray([c for _d, c in cands], dtype=np.int64)
        if len(slots) <= 1:
            return [int(s) for s in slots[:m]]
        # pairwise candidate distances in ONE vectorized pass — the greedy
        # scan then only indexes the matrix (the per-candidate _dist-call
        # loop dominated insert time once backfill made graphs dense)
        rows = self._vecs[slots]
        if self.metric == "l2-squared":
            sq = np.einsum("md,md->m", rows, rows)
            pair = sq[:, None] - 2.0 * (rows @ rows.T) + sq[None, :]
        elif self.metric == "dot":
            pair = -(rows @ rows.T)
        elif self.metric in ("cosine", "cosine-dot"):
            pair = 1.0 - rows @ rows.T  # rows pre-normalized at insert
        elif self.metric == "manhattan":
            pair = np.abs(rows[:, None, :] - rows[None, :, :]).sum(-1)
        else:  # hamming over float values
            pair = (rows[:, None, :] != rows[None, :, :]).sum(-1).astype(
                np.float32)
        # greedy scan with a RUNNING dominated mask: selecting candidate j
        # dominates every candidate closer to j than to the query — one
        # vectorized compare per selection instead of one np.all per
        # candidate (the 8.5M tiny-np.all pattern that ate ~60% of insert
        # time in profiling)
        dists = np.asarray([d for d, _c in cands], dtype=np.float32)
        n = len(slots)
        dominated = np.zeros(n, dtype=bool)
        selected: list[int] = []
        for i in range(n):
            if len(selected) >= m:
                break
            if dominated[i]:
                continue
            selected.append(i)
            dominated |= pair[:, i] <= dists
        if len(selected) < m:
            # backfill pruned candidates nearest-first (hnswlib
            # keepPrunedConnections; recall collapses without it)
            sel_mask = np.zeros(n, dtype=bool)
            sel_mask[selected] = True
            for i in np.nonzero(dominated & ~sel_mask)[0]:
                if len(selected) >= m:
                    break
                selected.append(int(i))
        return [int(slots[i]) for i in selected]

    def _set_links(self, slot: int, layer: int, neighbors: list[int]):
        links = self._links[slot]
        while len(links) <= layer:
            links.append(np.empty(0, dtype=np.int32))
        links[layer] = np.asarray(neighbors, dtype=np.int32)
        if self._native is not None:
            self._native.set_links(slot, layer, links[layer])
        if self._log is not None:
            self._log.append(pickle.dumps(
                ("L", int(self._doc_ids[slot]), layer,
                 self._doc_ids[links[layer]].tolist()),
                protocol=pickle.HIGHEST_PROTOCOL))

    def _add_backlink(self, neighbor: int, slot: int, layer: int):
        links = self._links[neighbor]
        while len(links) <= layer:
            links.append(np.empty(0, dtype=np.int32))
        cur = links[layer]
        if slot in cur:
            return
        budget = self.m0 if layer == 0 else self.m
        if len(cur) < budget:
            self._set_links(neighbor, layer, cur.tolist() + [slot])
            return
        # over-full: re-select with the heuristic over old + new
        # (reference insert.go connectNeighbor shrink path)
        q = self._vecs[neighbor]
        cand_slots = np.concatenate([cur, [slot]])
        dists = self._dist(q, cand_slots)
        cands = list(zip(dists.tolist(), cand_slots.tolist()))
        self._set_links(neighbor, layer, self._select_heuristic(cands, budget))

    # -- mutation -------------------------------------------------------------

    def add(self, doc_id: int, vector: np.ndarray) -> None:
        self.add_batch([doc_id], np.asarray(vector, dtype=np.float32)[None, :])

    # empty-index batches at least this large build via the device bulk
    # path (engine/hnsw_build.py) instead of incremental insert
    BULK_BUILD_MIN = 4096

    def add_batch(self, doc_ids, vectors: np.ndarray) -> None:
        doc_ids = np.asarray(doc_ids, dtype=np.int64)
        vectors = self._norm(np.asarray(vectors, dtype=np.float32))
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        if len(doc_ids) != len(vectors):
            raise ValueError(f"{len(doc_ids)} ids != {len(vectors)} vectors")
        if vectors.shape[1] != self.dim:
            raise ValueError(f"vector dim {vectors.shape[1]} != index dim {self.dim}")
        with self._lock:
            if self._native_dirty and self._native is not None:
                # catch up after a bulk mutation so incremental inserts
                # keep the fast per-layer search
                self._native_sync()
            # dispatch decided under the lock: a concurrent first batch
            # must not race two bulk_builds (the RLock makes the nested
            # bulk_build acquisition re-entrant). Metrics without a scan
            # kernel keep the incremental path — the host knn fallback would
            # materialize O(block*n*d) broadcast temporaries for
            # manhattan/hamming.
            if (self._count == 0 and len(vectors) >= self.BULK_BUILD_MIN
                    and self.metric in ("l2-squared", "dot", "cosine",
                                        "cosine-dot")
                    and len(set(doc_ids.tolist())) == len(doc_ids)):
                from weaviate_tpu_torch.engine.hnsw_build import bulk_build

                bulk_build(self, doc_ids, vectors,
                           knn_k=max(self.m0, self.ef_construction // 2))
                return
            batch_codes = None
            if self._codes is not None:
                # one device encode for the whole batch, not one copy per row
                from weaviate_tpu_torch.ops.pq import pq_encode

                batch_codes = pq_encode(self._pq_codebook, vectors)
            for j, (doc_id, vec) in enumerate(zip(doc_ids.tolist(), vectors)):
                self._insert_one(
                    int(doc_id), vec,
                    code=None if batch_codes is None else batch_codes[j])

    def _insert_one(self, doc_id: int, vec: np.ndarray, code=None):
        """Graph insert core. Caller holds ``_lock`` (add_batch/replay)."""
        old = self._id_to_slot.get(doc_id)
        if old is not None:
            # update = tombstone old node + fresh insert (the reference
            # re-adds under a new doc id; inside one index this is the analog)
            self._tombstone[old] = True
            self._doc_ids[old] = -1
            if self._native is not None:
                self._native.set_tombstones([old])
        slot = self._count
        self._grow(slot + 1)
        self._count += 1
        level = int(-math.log(max(self._rng.random(), 1e-12)) * self._ml)
        self._vecs[slot] = vec
        if self._native is not None:
            self._native.set_vectors(slot, vec)
        if self._codes is not None:
            if code is None:
                from weaviate_tpu_torch.ops.pq import pq_encode

                code = pq_encode(self._pq_codebook, vec[None, :])[0]
            self._codes[slot] = code
        self._levels[slot] = level
        self._doc_ids[slot] = doc_id
        self._id_to_slot[doc_id] = slot
        if self._log is not None:
            self._log.append(pickle.dumps(
                ("N", doc_id, level, vec.tobytes()),
                protocol=pickle.HIGHEST_PROTOCOL))
        if self._ep < 0:
            self._ep, self._max_level = slot, level
            self._set_links(slot, 0, [])
            self._maybe_condense()
            return
        ep_d = float(self._dist(vec, np.array([self._ep]))[0])
        ep_d, ep = self._greedy_descend(vec, self._ep, ep_d,
                                        self._max_level, level)
        eps = [(ep_d, ep)]
        for layer in range(min(level, self._max_level), -1, -1):
            cands = self._search_layer(vec, eps, self.ef_construction, layer)
            budget = self.m0 if layer == 0 else self.m
            neighbors = self._select_heuristic(cands, budget)
            self._set_links(slot, layer, neighbors)
            for n in neighbors:
                self._add_backlink(n, slot, layer)
            eps = cands
        if level > self._max_level:
            self._ep, self._max_level = slot, level
            if self._log is not None:
                self._log.append(pickle.dumps(("E", doc_id, level),
                                              protocol=pickle.HIGHEST_PROTOCOL))
        self._maybe_condense()

    def delete(self, *doc_ids) -> None:
        """Tombstone (reference delete.go: delete marks, cleanup re-links)."""
        with self._lock:
            dead_slots = []
            for doc_id in doc_ids:
                slot = self._id_to_slot.pop(int(doc_id), None)
                if slot is None:
                    continue
                self._tombstone[slot] = True
                self._doc_ids[slot] = -1
                dead_slots.append(slot)
                if self._log is not None:
                    self._log.append(pickle.dumps(("D", int(doc_id)),
                                                  protocol=pickle.HIGHEST_PROTOCOL))
            if self._native is not None and dead_slots:
                self._native.set_tombstones(dead_slots)

    def cleanup_tombstones(self) -> int:
        """Physically unlink tombstoned nodes, re-linking their neighbors
        through the heuristic (reference tombstone-cleanup cycle,
        hnsw/delete.go + index_cyclecallbacks). Returns nodes removed."""
        with self._lock:
            dead = np.nonzero(self._tombstone[: self._count])[0]
            if len(dead) == 0:
                return 0
            dead_set = set(dead.tolist())
            for slot in range(self._count):
                if slot in dead_set:
                    continue
                for layer, neigh in enumerate(self._links[slot]):
                    if len(neigh) == 0 or not np.any(self._tombstone[neigh]):
                        continue
                    alive = neigh[~self._tombstone[neigh]].tolist()
                    # candidates: alive old neighbors + alive 2-hop via dead
                    cand_set = set(alive)
                    for dn in neigh[self._tombstone[neigh]].tolist():
                        if layer < len(self._links[dn]):
                            for nn in self._links[dn][layer].tolist():
                                if nn != slot and not self._tombstone[nn]:
                                    cand_set.add(nn)
                    budget = self.m0 if layer == 0 else self.m
                    cand = np.fromiter(cand_set, dtype=np.int64)
                    if len(cand):
                        dists = self._dist(self._vecs[slot], cand)
                        sel = self._select_heuristic(
                            list(zip(dists.tolist(), cand.tolist())), budget)
                    else:
                        sel = []
                    self._set_links(slot, layer, sel)
            for slot in dead.tolist():
                self._links[slot] = []
                self._levels[slot] = -1
                self._tombstone[slot] = False  # slot stays burned (not reused)
                if self._native is not None:
                    self._native.clear_links(slot)
            if self._native is not None:
                # burned slots stay tombstoned in the mirror: the native
                # output filter is the only doc_id<0 check it has
                self._native.set_tombstones(dead)
            if self._ep in dead_set:
                self._elect_entrypoint()
            return len(dead)

    def _elect_entrypoint(self):
        """Re-pick ep/max_level after the old entrypoint died. Caller
        holds ``_lock`` (tombstone cleanup)."""
        live = [s for s in range(self._count)
                if self._doc_ids[s] >= 0 and not self._tombstone[s]]
        if not live:
            self._ep, self._max_level = -1, -1
            return
        best = max(live, key=lambda s: int(self._levels[s]))
        self._ep, self._max_level = best, int(self._levels[best])
        if self._log is not None:
            self._log.append(pickle.dumps(
                ("E", int(self._doc_ids[best]), self._max_level),
                protocol=pickle.HIGHEST_PROTOCOL))

    # -- queries --------------------------------------------------------------

    def contains(self, doc_id: int) -> bool:
        return int(doc_id) in self._id_to_slot

    def __len__(self) -> int:
        return len(self._id_to_slot)

    def _effective_ef(self, k: int) -> int:
        if self.ef > 0:
            return max(self.ef, k)
        # dynamic ef (reference autoEf* defaults)
        return min(max(k * AUTO_EF_FACTOR, AUTO_EF_MIN), AUTO_EF_MAX)

    def _allowed_slots(self, allow_list) -> np.ndarray | None:
        if allow_list is None:
            return None
        allow_list = np.asarray(allow_list)
        if allow_list.dtype == np.bool_:
            allow_list = np.nonzero(allow_list)[0]
        slots = [self._id_to_slot[int(i)] for i in allow_list.tolist()
                 if int(i) in self._id_to_slot]
        return np.asarray(slots, dtype=np.int64)

    def search_by_vector(self, query: np.ndarray, k: int,
                         allow_list: np.ndarray | None = None):
        q = self._norm(np.asarray(query, dtype=np.float32).reshape(-1))
        with self._lock:
            allowed = self._allowed_slots(allow_list)
            if allowed is not None and len(allowed) <= self.flat_cutoff:
                # small filter → brute force beats a constrained graph walk
                # (reference flat_search.go + flatSearchCutoff, index.go:95)
                if len(allowed) == 0:
                    return (np.empty(0, np.int64), np.empty(0, np.float32))
                dists = self._dist(q, allowed)
                order = np.argsort(dists, kind="stable")[:k]
                return self._doc_ids[allowed[order]], dists[order].astype(np.float32)
            if self._ep < 0:
                return (np.empty(0, np.int64), np.empty(0, np.float32))
            ef = max(self._effective_ef(k), k)
            if self._native is not None and self._codes is None:
                # fused native walk: greedy descent + layer-0 ef-search +
                # live/allowed filter in one C++ call (the ≥2k-QPS serving
                # path; the Python walker below is the fallback/oracle)
                if self._native_dirty:
                    self._native_sync()
                allow_u8 = None
                if allowed is not None:
                    allow_u8 = np.zeros(len(self._vecs), dtype=np.uint8)
                    allow_u8[allowed] = 1
                d, s = self._native.search(q, k, ef, self._ep,
                                           self._max_level, allow_u8)
                return self._doc_ids[s].copy(), d.astype(np.float32)
            if self._codes is not None:
                # compressed traversal: ADC hops, oversampled frontier,
                # exact rescore of the result set (compress.go pattern)
                ef = max(ef, k * self._pq_rescore)
                self._adc_lut = self._query_lut(q)
                try:
                    d0 = float(self._dist(q, np.array([self._ep]))[0])
                    d0, ep = self._greedy_descend(q, self._ep, d0,
                                                  self._max_level, 0)
                    cands = self._search_layer(q, [(d0, ep)], ef, 0)
                finally:
                    self._adc_lut = None
                slots = np.asarray([s for _d, s in cands], dtype=np.int64)
                exact = self._dist(q, slots)
                cands = sorted(zip(exact.tolist(), slots.tolist()))
            else:
                d0 = float(self._dist(q, np.array([self._ep]))[0])
                d0, ep = self._greedy_descend(q, self._ep, d0,
                                              self._max_level, 0)
                cands = self._search_layer(q, [(d0, ep)], ef, 0)
            allow_mask = None
            if allowed is not None:
                allow_mask = np.zeros(len(self._vecs), dtype=bool)
                allow_mask[allowed] = True
            out_ids, out_d = [], []
            for d, s in cands:
                if self._tombstone[s] or self._doc_ids[s] < 0:
                    continue
                if allow_mask is not None and not allow_mask[s]:
                    continue
                out_ids.append(int(self._doc_ids[s]))
                out_d.append(d)
                if len(out_ids) == k:
                    break
            return (np.asarray(out_ids, dtype=np.int64),
                    np.asarray(out_d, dtype=np.float32))

    # per-query allow lists ride the per-row loop below — the batcher can
    # coalesce filtered requests into one batch_fn call for this index too
    supports_batched_filters = True
    # the loop runs a REAL graph search per row, so pow2 batch padding
    # would buy nothing and cost up to 2x work — the batcher skips it
    compiled_batch_shapes = False

    def search_by_vector_batch(self, queries: np.ndarray, k: int,
                               allow_list=None):
        """``allow_list`` may be one shared allow list or a list/tuple of
        per-query allow lists (entries None or array-like), matching the
        FlatIndex batched contract."""
        from weaviate_tpu_torch.engine.flat import _per_query_allow

        queries = np.asarray(queries, dtype=np.float32)
        ids = np.full((len(queries), k), -1, dtype=np.int64)
        dists = np.full((len(queries), k), np.float32(np.inf), dtype=np.float32)
        per_query = _per_query_allow(allow_list)
        for b, q in enumerate(queries):
            al = allow_list[b] if per_query else allow_list
            i, d = self.search_by_vector(q, k, al)
            ids[b, : len(i)] = i
            dists[b, : len(d)] = d
        return ids, dists

    def search_by_vector_distance(self, query: np.ndarray, max_distance: float,
                                  allow_list: np.ndarray | None = None):
        """Range search by widening ef until the frontier crosses the
        threshold (reference SearchByVectorDistance: iterative widening)."""
        k = 64
        while True:
            ids, d = self.search_by_vector(query, k, allow_list)
            if len(d) < k or (len(d) and d[-1] > max_distance):
                within = d <= max_distance
                return ids[within], d[within]
            if k >= max(len(self._id_to_slot), 1):
                within = d <= max_distance
                return ids[within], d[within]
            k *= 4

    # -- compression hook -----------------------------------------------------

    @property
    def compressed(self) -> bool:
        return self._codes is not None

    def compress(self, quantization: str = "pq", pq_segments: int | None = None,
                 pq_centroids: int = 16, rescore_limit: int = 4,
                 **_ignored) -> None:
        """Runtime compression of a LIVE graph (reference compress.go:38-89:
        train PQ on current contents, swap the cache for a compressed one,
        log AddPQ). Traversal distances switch to per-query ADC lookups
        over uint8 codes; the ef result set is exact-rescored against the
        retained f32 rows before returning, so recall stays within the
        rescore envelope."""
        if quantization != "pq":
            raise ValueError("hnsw supports runtime quantization='pq' "
                             "(bq has no ADC form for graph hops)")
        if self.metric not in ("l2-squared", "dot", "cosine", "cosine-dot"):
            raise ValueError(
                f"no ADC form for metric {self.metric!r}")
        from weaviate_tpu_torch.ops.pq import pq_encode, pq_fit

        with self._lock:
            if self._codes is not None:
                raise RuntimeError("index is already compressed")
            live = np.nonzero(
                (self._doc_ids[: self._count] >= 0)
                & ~self._tombstone[: self._count])[0]
            if len(live) < pq_centroids:
                raise RuntimeError(
                    f"need >= {pq_centroids} live vectors to train PQ, "
                    f"have {len(live)}")
            if not pq_segments:
                from weaviate_tpu_torch.ops.pq import default_pq_segments

                pq_segments = default_pq_segments(self.dim, pq_centroids)
            self._pq_rescore = rescore_limit
            self._pq_codebook = pq_fit(self._vecs[live], m=pq_segments,
                                       k=pq_centroids, iters=8,
                                       device=self.device)
            self._pq_cents = self._pq_codebook.centroids.cpu().numpy()
            self._codes = np.zeros((len(self._vecs), pq_segments),
                                   dtype=np.uint8)
            if self._count:
                self._codes[: self._count] = pq_encode(
                    self._pq_codebook, self._vecs[: self._count])
            self._hbm_sync()
            # durability: one condensed snapshot carries codes + codebook
            # (the reference logs an AddPQ record; a snapshot is the same
            # fixed point)
            if self._log is not None:
                self.condense()

    def _query_lut(self, q: np.ndarray) -> np.ndarray:
        """Per-query ADC table [m, k]: segment-wise distance from q to
        every centroid (exact ADC for l2; dot/cosine fold linearly).

        Numpy twin of ops/pq.py:pq_lut — the device version would cost a
        host<->device round trip per query on this host-graph path."""
        cents = self._pq_cents  # [m, k, ds], the codebook's host copy
        m, kc, ds = cents.shape
        qs = q.reshape(m, ds)
        if self.metric == "l2-squared":
            diff = qs[:, None, :] - cents
            return np.einsum("mkd,mkd->mk", diff, diff)
        if self.metric == "dot":
            return -np.einsum("md,mkd->mk", qs, cents)
        if self.metric in ("cosine", "cosine-dot"):
            lut = -np.einsum("md,mkd->mk", qs, cents)
            lut[0] += 1.0  # constant shift once, exact for the sum
            return lut
        raise RuntimeError(
            f"compressed traversal unsupported for metric {self.metric!r}")

    # -- maintenance ----------------------------------------------------------

    def maintenance(self) -> bool:
        return self.cleanup_tombstones() > 0

    def compact(self):
        self.cleanup_tombstones()

    # -- persistence ----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "index_type": self.index_type,
                "dim": self.dim,
                "metric": self.metric,
                "m": self.m,
                "ef_construction": self.ef_construction,
                "ef": self.ef,
                "count": self._count,
                "vectors": self._vecs[: self._count].copy(),
                "levels": self._levels[: self._count].copy(),
                "doc_ids": self._doc_ids[: self._count].copy(),
                "tombstone": self._tombstone[: self._count].copy(),
                "links": [[l.tolist() for l in self._links[s]]
                          for s in range(self._count)],
                "ep": self._ep,
                "max_level": self._max_level,
                "pq_codes": (self._codes[: self._count].copy()
                             if self._codes is not None else None),
                "pq_codebook": (
                    self._pq_cents.copy()
                    if self._pq_codebook is not None else None),
                "pq_rescore": self._pq_rescore,
            }

    @classmethod
    def restore(cls, snap: dict, **kwargs) -> "HNSWIndex":
        idx = cls(dim=snap["dim"], metric=snap["metric"],
                  max_connections=snap["m"],
                  ef_construction=snap["ef_construction"], ef=snap["ef"],
                  capacity=max(snap["count"], 64), **kwargs)
        n = snap["count"]
        idx._count = n
        idx._vecs[:n] = snap["vectors"]
        idx._levels[:n] = snap["levels"]
        idx._doc_ids[:n] = snap["doc_ids"]
        idx._tombstone[:n] = snap["tombstone"]
        for s in range(n):
            idx._links[s] = [np.asarray(l, dtype=np.int32)
                             for l in snap["links"][s]]
        idx._ep = snap["ep"]
        idx._max_level = snap["max_level"]
        idx._id_to_slot = {int(d): s for s, d in enumerate(snap["doc_ids"])
                           if d >= 0}
        if snap.get("pq_codebook") is not None:
            from weaviate_tpu_torch.ops.pq import PQCodebook

            idx._pq_cents = np.array(snap["pq_codebook"], dtype=np.float32)
            idx._pq_codebook = PQCodebook(
                torch.from_numpy(idx._pq_cents.copy()).to(idx.device))
            idx._pq_rescore = snap.get("pq_rescore", 4)
            m = snap["pq_codes"].shape[1]
            idx._codes = np.zeros((len(idx._vecs), m), dtype=np.uint8)
            idx._codes[:n] = snap["pq_codes"]
        idx._native_dirty = True  # fields were set past the mirror
        idx._hbm_sync()  # codes allocated after __init__'s sync
        return idx

    # -- commit log (reference commit_logger.go / condensor.go) ---------------

    def _maybe_condense(self):
        if self._log is None or self._log.size() < self._condense_above:
            return
        self.condense()

    def condense(self):
        """Replace the op log with a snapshot (reference condensor.go:27 —
        theirs rewrites a minimal op stream; a snapshot is the same
        fixed point).

        Crash ordering: the snapshot must be DURABLY renamed into place
        before the op log resets — fsync tmp, rename, fsync dir, only
        then truncate. The old code reset the log right after an
        un-fsynced ``os.replace``: a crash could leave a zero-length (or
        garbage) hnsw.snap AND an empty log, losing the whole graph.
        The ``hnsw.snap.pre/post_replace`` crashpoints kill in exactly
        those two windows; restart must replay to the same graph."""
        if self._log_dir is None:
            return
        from weaviate_tpu_torch.storage import fsutil

        with self._lock:
            tmp = os.path.join(self._log_dir, "hnsw.snap.tmp")
            final = os.path.join(self._log_dir, "hnsw.snap")
            with open(tmp, "wb") as f:
                pickle.dump(self.snapshot(), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
                f.flush()
                os.fsync(f.fileno())
            fsutil.atomic_replace(tmp, final, fsync_file_first=False,
                                  crashpoint="hnsw.snap.pre_replace")
            faultline.fire("hnsw.snap.post_replace", path=final)
            self._log.reset()

    def _replay(self, log_dir: str):
        """Caller holds ``_lock`` — or, the common case, runs from
        __init__ before the index is shared with any other thread."""
        snap_path = os.path.join(log_dir, "hnsw.snap")
        if os.path.exists(snap_path):
            with open(snap_path, "rb") as f:
                snap = pickle.load(f)
            restored = HNSWIndex.restore(snap, device=self.device)
            # adopt graph state + graph hyperparams from the snapshot, but
            # keep this instance's runtime knobs (flat_cutoff, RNG seed,
            # log config) — restore() would reset them to defaults
            keep = ("_log", "_log_dir", "_condense_above", "flat_cutoff",
                    "_rng", "ef")
            self.__dict__.update(
                {k: v for k, v in restored.__dict__.items() if k not in keep})
        wal_path = os.path.join(log_dir, "hnsw.wal")
        if not os.path.exists(wal_path):
            return
        snap_count = self._count
        from weaviate_tpu_torch.storage import recovery
        from weaviate_tpu_torch.storage.wal import ReplayReport

        rep = ReplayReport()
        parts = os.path.normpath(log_dir).split(os.sep)[-2:]
        rec = recovery.BucketRecovery(
            "/".join([p for p in parts if p] + ["hnsw.wal"]))
        for payload in WriteAheadLog.replay(wal_path, rep):
            op = pickle.loads(payload)
            tag = op[0]
            if tag == "N":
                _, doc_id, level, raw = op
                vec = np.frombuffer(raw, dtype=np.float32)
                old = self._id_to_slot.get(doc_id)
                if old is not None:
                    self._tombstone[old] = True
                    self._doc_ids[old] = -1
                slot = self._count
                self._grow(slot + 1)
                self._count += 1
                self._vecs[slot] = vec
                self._levels[slot] = level
                self._doc_ids[slot] = doc_id
                self._id_to_slot[doc_id] = slot
                if self._ep < 0 or level > self._max_level:
                    self._ep, self._max_level = slot, level
            elif tag == "L":
                _, doc_id, layer, neigh_ids = op
                slot = self._id_to_slot.get(doc_id)
                if slot is None:
                    continue
                neigh = [self._id_to_slot[i] for i in neigh_ids
                         if i in self._id_to_slot]
                links = self._links[slot]
                while len(links) <= layer:
                    links.append(np.empty(0, dtype=np.int32))
                links[layer] = np.asarray(neigh, dtype=np.int32)
            elif tag == "D":
                _, doc_id = op
                slot = self._id_to_slot.pop(doc_id, None)
                if slot is not None:
                    self._tombstone[slot] = True
                    self._doc_ids[slot] = -1
            elif tag == "E":
                _, doc_id, level = op
                slot = self._id_to_slot.get(doc_id)
                if slot is not None:
                    self._ep, self._max_level = slot, level
        rec.wal_files_replayed = 1
        rec.frames_replayed = rep.frames
        rec.bytes_truncated = rep.bytes_truncated
        if rep.quarantined:
            rec.wals_quarantined = 1
            rec.quarantined_files.append("hnsw.wal")
        recovery.record(rec)
        if self._codes is not None and self._count > snap_count:
            # inserts logged after the compress snapshot carry no codes in
            # their WAL records — re-encode the replayed tail in one batch
            # or ADC traversal would score them against all-zero codes
            from weaviate_tpu_torch.ops.pq import pq_encode

            self._codes[snap_count: self._count] = pq_encode(
                self._pq_codebook, self._vecs[snap_count: self._count])
        self._native_dirty = True  # replay mutates links past the mirror

    def close(self):
        if self._log is not None:
            self.condense()
            self._log.close()
