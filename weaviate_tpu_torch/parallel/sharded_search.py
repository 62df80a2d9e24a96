"""Row-sharded brute-force top-k over a device mesh (port of
``weaviate_tpu/parallel/sharded_search.py``).

The cross-shard query path is, as in the JAX package:

    per-shard chunked scan  ->  local top-k  ->  candidate merge
    ->  merge top-k

Each shard of a :class:`RowSharded` corpus lives on its mesh device and
runs the port's own scan (``ops/topk.chunked_topk_distances``, the BQ /
PQ4 / PQ top-k, the IVF-PQ probe) on its rows, under a
``torch.cuda.device`` guard so that a kernel launches on the shard's card.
On the 1-D ``shard`` mesh the merge concatenates every shard's [B, kk]
(distance, id) pairs shard-major and selects exactly once. On the
hierarchical ``('host', 'ici')`` mesh it is TWO-LEVEL: an exact reduce
over a host's shards first, then one winner block per host crosses
between hosts and is reduced again, so cross-host traffic is O(hosts*k)
pairs per query instead of O(devices*k). Across processes a block crosses
the process group once (``torch.distributed.all_gather``). Both merges
give the same answer bit for bit: exact top-k is mergeable, and both
concatenate candidates in the same derived order, so even distance ties
resolve alike.

Placement is not hand-wired: every operand resolves through the rule
tables of ``parallel/partition.py``, and a row-sharded operand must be a
``RowSharded`` cut on the dim its rule names. A per-query allow mask
([B, N] bool) is column-sharded row-aligned with the corpus; each shard
packs its own slice into allow words on its device.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE
from weaviate_tpu_torch.ops.kernels import mask_pad_cols, pack_allow_bitmask_t
from weaviate_tpu_torch.ops.topk import chunked_topk_distances, topk_smallest
from weaviate_tpu_torch.parallel import partition
from weaviate_tpu_torch.parallel.mesh import (HOST_AXIS, ICI_AXIS, Mesh,
                                              _world, is_hierarchical,
                                              local_shards, merge_device,
                                              n_row_shards)
from weaviate_tpu_torch.runtime import kernelscope, tracing


def dcn_compact_default() -> bool:
    """WEAVIATE_TPU_DCN_COMPACT=1 packs the cross-host candidate block
    as (bf16 distance, uint32 slot) — 6 bytes/candidate instead of 8.
    OFF by default: bf16 rounding can reorder near-tied candidates, so
    the bit-identical-to-1-D parity contract only holds when distances
    are bf16-exact (e.g. BQ hamming counts at dim <= 256)."""
    return os.environ.get("WEAVIATE_TPU_DCN_COMPACT", "0").lower() in (
        "1", "true", "on")


# -- placed values -------------------------------------------------------------


class RowSharded:
    """A tensor cut in equal row shards along ``dim`` over a mesh (the
    counterpart of a row-sharded ``jax.Array``): ``parts[s]`` is shard
    ``s``'s slice on ``mesh.devices[s]``, for every shard this process
    holds, and None for another process's. ``shape`` is the global
    shape."""

    def __init__(self, parts: list, shape: tuple, dim: int, mesh: Mesh,
                 dtype: torch.dtype):
        self.parts = parts
        self.shape = tuple(int(s) for s in shape)
        self.dim = dim
        self.mesh = mesh
        self.dtype = dtype

    @property
    def local_rows(self) -> int:
        return self.shape[self.dim] // len(self.parts)

    def element_size(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.element_size()

    def local(self) -> list:
        """(shard, tensor) of every shard this process holds."""
        return [(s, t) for s, t in enumerate(self.parts) if t is not None]

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the merge device);
        across processes through one all_gather."""
        device = merge_device(self.mesh) if device is None else device
        block = torch.cat([t.to(device) for _, t in self.local()], self.dim)
        return _all_gather_cat(block, self.dim)

    def _route(self, slots: np.ndarray):
        """(shard, positions into ``slots``, local rows) per local shard
        that one of ``slots`` (global rows of dim 0) falls in."""
        slots = np.asarray(slots, dtype=np.int64)
        owner = slots // self.local_rows
        for s, t in self.local():
            sel = np.flatnonzero(owner == s)
            if len(sel):
                yield s, t, sel, slots[sel] - s * self.local_rows

    def index_copy_(self, slots: np.ndarray, values: torch.Tensor) -> None:
        """Write ``values`` [m, ...] at global rows ``slots`` [m], each
        into the shard that owns it (dim 0)."""
        for _, t, sel, loc in self._route(slots):
            t.index_copy_(0, torch.from_numpy(loc).to(t.device),
                          values[torch.from_numpy(sel).to(values.device)].to(t.device))

    def index_fill_(self, slots: np.ndarray, value) -> None:
        for _, t, _, loc in self._route(slots):
            t.index_fill_(0, torch.from_numpy(loc).to(t.device), value)

    def take(self, slots: np.ndarray, device=None) -> torch.Tensor:
        """Rows at global ``slots`` (dim 0) on ``device`` (default: the
        merge device). Across processes every process calls it with the
        same ``slots``: one all_gather brings each row from the process
        that holds it."""
        device = merge_device(self.mesh) if device is None else device
        slots = np.asarray(slots, dtype=np.int64)
        out = torch.zeros((len(slots),) + self.shape[1:], dtype=self.dtype,
                          device=device)
        for _, t, sel, loc in self._route(slots):
            out[torch.from_numpy(sel).to(device)] = t[
                torch.from_numpy(loc).to(t.device)].to(device)
        if _world() == 1:
            return out
        every = _all_gather_cat(out[None], 0)  # [world, len(slots), ...]
        owner = np.asarray(self.mesh.processes)[slots // self.local_rows]
        return every[torch.from_numpy(owner).to(device),
                     torch.arange(len(slots), device=device)]


class Replicated:
    """One tensor placed on every distinct device of a mesh."""

    def __init__(self, by_device: dict, shape: tuple):
        self.by_device = by_device
        self.shape = tuple(shape)

    def on(self, device) -> torch.Tensor:
        return self.by_device[str(torch.device(device))]


def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(arr))
    return arr


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes (uint8, the last dim widened): the one dtype
    every process-group backend carries."""
    t = t.contiguous()
    return t.to(torch.uint8) if t.dtype == torch.bool else t.view(torch.uint8)


def _from_bytes(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b = b.contiguous()
    return b.bool() if dtype == torch.bool else b.view(dtype)


def _all_gather_cat(block: torch.Tensor, dim: int) -> torch.Tensor:
    """Every process's ``block`` concatenated along ``dim`` in rank order
    (the block itself in one process)."""
    world = _world()
    if world == 1:
        return block
    import torch.distributed as dist

    wire = _bytes(block)
    out = [torch.empty_like(wire) for _ in range(world)]
    dist.all_gather(out, wire)
    return torch.cat([_from_bytes(o, block.dtype) for o in out], dim)


def shard_array(arr, mesh: Mesh, dim: int = 0) -> RowSharded:
    """Place ``arr`` (numpy or tensor) on ``mesh`` row-sharded along
    ``dim``: shard ``s`` gets rows [s*L, (s+1)*L) on ``mesh.devices[s]``.
    In a multi-process run each process places only its own shards (JAX
    ``shard_array`` through ``make_array_from_callback``)."""
    t = _as_tensor(arr)
    n = n_row_shards(mesh)
    rows = t.shape[dim]
    if rows % n:
        raise ValueError(f"{rows} rows on dim {dim} do not split over "
                         f"{n} shards")
    per = rows // n
    parts: list = [None] * n
    for s in local_shards(mesh):
        parts[s] = t.narrow(dim, s * per, per).contiguous().to(mesh.devices[s])
    return RowSharded(parts, tuple(t.shape), dim, mesh, t.dtype)


def replicate_array(arr, mesh: Mesh) -> Replicated:
    """``arr`` (numpy or tensor) on every distinct device this process's
    shards use: one copy a device, however many shards share it."""
    t = _as_tensor(arr)
    by_device = {}
    for s in local_shards(mesh):
        key = str(mesh.devices[s])
        if key not in by_device:
            by_device[key] = t.to(mesh.devices[s])
    return Replicated(by_device, tuple(t.shape))


def sharded_zeros(shape, dtype, mesh: Mesh, dim: int = 0) -> RowSharded:
    """A zero tensor allocated in its sharded layout: each shard only its
    own rows, on its device."""
    n = n_row_shards(mesh)
    if shape[dim] % n:
        raise ValueError(f"{shape[dim]} rows do not split over {n} shards")
    local_shape = list(shape)
    local_shape[dim] = shape[dim] // n
    parts: list = [None] * n
    for s in local_shards(mesh):
        parts[s] = torch.zeros(local_shape, dtype=dtype, device=mesh.devices[s])
    return RowSharded(parts, tuple(shape), dim, mesh, dtype)


def grow_rows(arr: RowSharded, pad_rows: int, mesh: Mesh) -> RowSharded:
    """Append ``pad_rows`` zero rows (dim 0) to a row-sharded tensor.

    The global row order is kept, as the JAX package's concatenate keeps
    it: global row r is shard r // L' after the growth, so the rows that
    change shard are copied across (on one card, a copy on that card).
    Each new shard is built from the old slices it covers plus zeros, so
    no device holds the whole tensor. Across processes the rows travel
    through one all_gather."""
    n = n_row_shards(mesh)
    old_rows = arr.shape[0]
    new_rows = old_rows + pad_rows
    if new_rows % n:
        raise ValueError(f"{new_rows} rows do not split over {n} shards")
    old_per, new_per = old_rows // n, new_rows // n
    whole = None
    if any(t is None for t in arr.parts):
        whole = arr.gather()
    parts: list = [None] * n
    for s in local_shards(mesh):
        dev = mesh.devices[s]
        lo, hi = s * new_per, (s + 1) * new_per
        pieces = []
        if whole is not None:
            if lo < old_rows:
                pieces.append(whole[lo:min(hi, old_rows)].to(dev))
        else:
            for src in range(lo // old_per, min(n, -(-min(hi, old_rows) // old_per))):
                a = max(lo, src * old_per) - src * old_per
                b = min(hi, old_rows, (src + 1) * old_per) - src * old_per
                if b > a:
                    pieces.append(arr.parts[src][a:b].to(dev))
        have = sum(p.shape[0] for p in pieces)
        if have < new_per:
            pieces.append(torch.zeros((new_per - have,) + arr.shape[1:],
                                      dtype=arr.dtype, device=dev))
        parts[s] = torch.cat(pieces) if len(pieces) > 1 else pieces[0].contiguous()
    return RowSharded(parts, (new_rows,) + arr.shape[1:], 0, mesh, arr.dtype)


def tracked_shard_array(arr, mesh: Mesh, dim: int = 0,
                        component: str = "sharded",
                        owner: dict | None = None) -> RowSharded:
    """``shard_array`` + a memory-ledger entry tied to the placed value's
    lifetime: the helper for transient sharded operands like per-query
    allow masks."""
    out = shard_array(arr, mesh, dim=dim)
    from weaviate_tpu_torch.runtime.hbm_ledger import ledger

    ledger.track(component, out, sharding="sharded", **(owner or {}))
    return out


def _shard_guard(device: torch.device):
    """Launch on the shard's card: a kernel called through ctypes goes to
    the current CUDA device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _operands(rules, named: dict, mesh: Mesh):
    """Per-shard accessors of the named operands, placed by ``rules``: a
    row-sharded operand must be a ``RowSharded`` cut on the rule's dim;
    a replicated one is placed once on each device the shards use."""
    specs = partition.match_partition_rules(rules, named, mesh)
    out = {}
    for name, arr in named.items():
        dim = partition.sharded_dim(specs[name])
        if arr is None:
            out[name] = lambda s, dev: None
        elif dim is None:
            rep = arr if isinstance(arr, Replicated) else replicate_array(arr, mesh)
            out[name] = lambda s, dev, _r=rep: _r.on(dev)
        else:
            if not isinstance(arr, RowSharded) or arr.dim != dim:
                raise ValueError(
                    f"operand {name!r} must be row-sharded on dim {dim} "
                    f"(shard_array(..., dim={dim}))")
            out[name] = lambda s, dev, _a=arr: _a.parts[s]
    return out


# -- the merges ----------------------------------------------------------------


def _exchange(blocks: list, device) -> list:
    """Every process's (d, i) blocks in rank order: the one crossing of
    the process group in a merge (the blocks themselves in one process).
    A block travels as one byte tensor: the distances' bytes (f32, or
    bf16 when compact) beside the ids' (the JAX package's uint32 bitcast
    of the ids is the same bytes), 8 or 6 bytes a pair."""
    blocks = [(d.to(device), i.to(device)) for d, i in blocks]
    world = _world()
    if world == 1:
        return blocks
    import torch.distributed as dist

    d_type = blocks[0][0].dtype
    d_bytes = blocks[0][0].shape[-1] * blocks[0][0].element_size()
    packed = torch.stack([torch.cat([_bytes(d), _bytes(i)], -1)
                          for d, i in blocks])
    out = [torch.empty_like(packed) for _ in range(world)]
    dist.all_gather(out, packed)
    return [(_from_bytes(blk[..., :d_bytes], d_type),
             _from_bytes(blk[..., d_bytes:], torch.int32))
            for t in out for blk in t]


def _ici_merge_topk(parts: list, k_out: int, device):
    """The 1-D cross-shard merge: every shard's [B, kk] pairs
    concatenated shard-major per query, then one exact top-k (JAX
    ``_ici_merge_topk``: an all_gather over the axis)."""
    parts = _exchange(parts, device)
    n_sh = len(parts)
    kk = parts[0][0].shape[1]
    cat_d = torch.cat([d for d, _ in parts], 1)
    cat_i = torch.cat([i for _, i in parts], 1)
    return topk_smallest(cat_d, cat_i, min(k_out, n_sh * kk))


def _two_level_merge_topk(parts: list, mesh: Mesh, k_out: int, device,
                          compact: bool = False):
    """Hierarchical merge: an exact reduce over each host's shards, then
    one winner block per host crosses between hosts and is reduced again.

    Level 1: a host's ``n_ici`` candidate sets concatenate in shard order
    and reduce to the host's top-k1 (k1 = min(k_out, n_ici*kk)). Level 2:
    each host's block, padded with +inf to ``n_ici`` equal slices (JAX
    slices it over the ICI ranks so one copy crosses the wire; the padded
    block is the same bytes), crosses once, and the host-major
    concatenation reduces to the final top-k. +inf sorts after every real
    and every masked candidate, so a pad never displaces one. ``compact``
    carries the cross-host distances as bf16."""
    n_hosts = int(mesh.shape[HOST_AXIS])
    n_ici = int(mesh.shape[ICI_AXIS])
    kk = next(p for p in parts if p is not None)[0].shape[1]
    k1 = min(k_out, n_ici * kk)
    k_final = min(k_out, n_hosts * n_ici * kk)
    per_rank = -(-k1 // n_ici)
    pad = per_rank * n_ici - k1
    blocks = []
    for h in range(n_hosts):
        host = parts[h * n_ici:(h + 1) * n_ici]
        if host[0] is None:  # another process's host
            continue
        host_d, host_i = topk_smallest(
            torch.cat([d.to(device) for d, _ in host], 1),
            torch.cat([i.to(device) for _, i in host], 1), k1)
        if n_hosts == 1:
            return host_d, host_i  # degenerate: k1 == k_final
        if pad:
            b = host_d.shape[0]
            host_d = torch.cat([host_d, torch.full((b, pad), float("inf"),
                                                   device=device)], 1)
            host_i = torch.cat([host_i, torch.full((b, pad), -1,
                                                   dtype=host_i.dtype,
                                                   device=device)], 1)
        if compact:
            host_d = host_d.to(torch.bfloat16)
        blocks.append((host_d, host_i))
    blocks = _exchange(blocks, device)  # the cross-host hop
    cat_d = torch.cat([d for d, _ in blocks], 1).float()
    cat_i = torch.cat([i for _, i in blocks], 1)
    return topk_smallest(cat_d, cat_i, k_final)


def merge_candidates(parts: list, mesh: Mesh, k_out: int,
                     compact: bool = False):
    """Mesh-shape dispatch of the cross-shard merge over per-shard
    ``(d [B, kk], i [B, kk])`` candidates (``parts[s]`` None for another
    process's shard): 1-D or two-level. The result lands on the mesh's
    merge device."""
    device = merge_device(mesh)
    if is_hierarchical(mesh):
        return _two_level_merge_topk(parts, mesh, k_out, device,
                                     compact=compact)
    return _ici_merge_topk([p for p in parts if p is not None], k_out, device)


def topology_dcn_candidate_bytes(n_hosts: int, n_local: int, k: int,
                                 kk: int | None = None, *,
                                 level: str = "two_level",
                                 compact: bool = False) -> int:
    """Pure topology arithmetic: per-query candidate bytes ONE host sends
    to the other hosts during the merge of an ``n_hosts x n_local`` pod.
    ``kk`` is the per-device candidate count (defaults to k);
    ``compact`` counts the bf16+uint32 wire format (6 B/pair vs 8)."""
    kk = k if kk is None else kk
    if n_hosts <= 1:
        return 0
    if level == "flat":
        # each of the host's n_local devices ships kk pairs (f32+int32)
        # to the other hosts
        return n_local * kk * 8 * (n_hosts - 1)
    pair = 6 if compact else 8
    k1 = min(k, n_local * kk)
    per_rank = -(-k1 // n_local)  # ICI-rank slice width (inf-padded)
    return per_rank * n_local * pair * (n_hosts - 1)


def merge_dcn_candidate_bytes(mesh: Mesh, k: int, kk: int | None = None,
                              *, level: str = "auto",
                              compact: bool = False) -> int:
    """``topology_dcn_candidate_bytes`` for a concrete mesh (0 when the
    mesh is single-host)."""
    from weaviate_tpu_torch.parallel.mesh import host_count

    n_hosts = host_count(mesh)
    if n_hosts <= 1:
        return 0
    if level == "auto":
        level = "two_level" if is_hierarchical(mesh) else "flat"
    return topology_dcn_candidate_bytes(
        n_hosts, n_row_shards(mesh) // n_hosts, k, kk, level=level,
        compact=compact)


def _explain_merge(mesh: Mesh, k: int, compact: bool) -> None:
    hier = is_hierarchical(mesh)
    kernelscope.explain_note(
        "merge", shards=n_row_shards(mesh), hierarchical=bool(hier),
        hosts=int(mesh.shape[HOST_AXIS]) if hier else 1,
        ici=int(mesh.shape[ICI_AXIS]) if hier else n_row_shards(mesh),
        dcn_compact=bool(compact), k=k)


# -- the scans -----------------------------------------------------------------


def _allow_slice(allow_s: torch.Tensor | None, rows: int):
    """A shard's [B, rows] bool allow columns packed into allow words on
    the shard's device."""
    if allow_s is None:
        return None
    return pack_allow_bitmask_t(allow_s.bool(), mask_pad_cols(rows))


def sharded_candidates(q, x: RowSharded, valid, x_sq_norms, *, k: int,
                       chunk_size: int, metric: str, mesh: Mesh,
                       use_pallas: bool = False, selection: str = "exact",
                       allow_rows=None) -> list:
    """The per-shard half of ``sharded_topk``: each shard's top-k over
    its rows, ids global (``id_offset = shard * local_rows``; dead
    entries stay -1). Returns ``parts[s]`` = (d [B, k], i [B, k]) on the
    shard's device, None for another process's shard."""
    ops = _operands(partition.SEARCH_RULES,
                    {"q": q, "x": x, "valid": valid, "x_sq_norms": x_sq_norms,
                     "allow_rows": allow_rows}, mesh)
    local_rows = x.local_rows
    parts: list = [None] * n_row_shards(mesh)
    for s in local_shards(mesh):
        dev = mesh.devices[s]
        with _shard_guard(dev):
            parts[s] = chunked_topk_distances(
                ops["q"](s, dev), ops["x"](s, dev), k=k,
                chunk_size=chunk_size, metric=metric,
                valid=ops["valid"](s, dev),
                x_sq_norms=ops["x_sq_norms"](s, dev),
                id_offset=s * local_rows, use_pallas=use_pallas,
                selection=selection,
                allow_bits=_allow_slice(ops["allow_rows"](s, dev), local_rows))
    return parts


def sharded_topk(q, x: RowSharded, valid, x_sq_norms, *, k: int,
                 chunk_size: int, metric: str, mesh: Mesh,
                 use_pallas: bool = False,
                 selection: str = "exact", allow_rows=None,
                 dcn_compact: bool | None = None):
    """Top-k of ``q`` [B, d] against the row-sharded corpus ``x`` [N, d].

    ``x`` / ``valid`` / ``x_sq_norms`` are ``RowSharded`` on dim 0; ``q``
    is a tensor, numpy array or ``Replicated``. ``allow_rows`` ([B, N]
    bool per-query masks) is ``RowSharded`` on dim 1, row-aligned with the
    corpus. Returns (dists [B, k], global ids [B, k]) on the mesh's merge
    device, ids indexing the unsharded [N] row space."""
    if dcn_compact is None:
        dcn_compact = dcn_compact_default()
    with tracing.span("spmd.sharded_topk", shards=n_row_shards(mesh),
                      k=k, rows=int(x.shape[0]),
                      hierarchical=is_hierarchical(mesh),
                      filtered=allow_rows is not None):
        _explain_merge(mesh, k, dcn_compact)
        parts = sharded_candidates(
            q, x, valid, x_sq_norms, k=k, chunk_size=chunk_size,
            metric=metric, mesh=mesh, use_pallas=use_pallas,
            selection=selection, allow_rows=allow_rows)
        return merge_candidates(parts, mesh, k, compact=dcn_compact)


def _rescore_local(q, rows_bf16, i_c, metric: str, local_rows: int,
                   k_out: int):
    """Exact rescore of a shard's candidates against its own bf16 rows
    (no cross-device vector traffic)."""
    rows = rows_bf16[i_c.clamp(0, local_rows - 1).long()].float()
    if metric in ("cosine", "cosine-dot"):
        dd = 1.0 - torch.einsum("bd,bkd->bk", q, rows)
    elif metric == "dot":
        dd = -torch.einsum("bd,bkd->bk", q, rows)
    else:
        diff = q[:, None, :] - rows
        dd = (diff * diff).sum(-1)
    dd = torch.where(i_c >= 0, dd, torch.full_like(dd, MASKED_DISTANCE))
    return topk_smallest(dd, i_c, min(k_out, i_c.shape[1]))


def sharded_quantized_candidates(q, q_words, codes: RowSharded, valid,
                                 rescore_rows, centroids, *, k: int,
                                 k_out: int, chunk_size: int,
                                 quantization: str, metric: str, mesh: Mesh,
                                 use_pallas: bool = False,
                                 selection: str = "approx",
                                 allow_rows=None) -> list:
    """The per-shard half of ``sharded_quantized_topk``: each shard's
    compressed scan (and, with ``rescore_rows``, its exact rescore),
    ids global; dead ids stay -1."""
    from weaviate_tpu_torch.ops import bq as bq_ops
    from weaviate_tpu_torch.ops import pq as pq_ops

    ops = _operands(partition.QUANTIZED_RULES,
                    {"q": q, "q_words": q_words, "centroids": centroids,
                     "codes": codes, "valid": valid,
                     "rescore_rows": rescore_rows, "allow_rows": allow_rows},
                    mesh)
    local_rows = codes.local_rows
    parts: list = [None] * n_row_shards(mesh)
    for s in local_shards(mesh):
        dev = mesh.devices[s]
        with _shard_guard(dev):
            q_ = ops["q"](s, dev)
            codes_, valid_ = ops["codes"](s, dev), ops["valid"](s, dev)
            ab = _allow_slice(ops["allow_rows"](s, dev), local_rows)
            kl = min(k, local_rows)
            if quantization == "bq":
                d_c, i_c = bq_ops.bq_topk(
                    ops["q_words"](s, dev), codes_, k=kl,
                    chunk_size=chunk_size, valid=valid_,
                    use_pallas=use_pallas, selection=selection,
                    allow_bits=ab)
            elif quantization == "pq4":
                d_c, i_c = pq_ops.pq4_topk(
                    q_, codes_, ops["centroids"](s, dev), k=kl,
                    chunk_size=chunk_size, metric=metric, valid=valid_,
                    selection=selection, allow_bits=ab)
            else:
                d_c, i_c = pq_ops.pq_topk(
                    q_, codes_, ops["centroids"](s, dev), k=kl,
                    chunk_size=chunk_size, metric=metric, valid=valid_,
                    allow_bits=ab)
            resc = ops["rescore_rows"](s, dev)
            if resc is not None:
                d_c, i_c = _rescore_local(q_.float(), resc, i_c, metric,
                                          local_rows, k_out)
            gid = torch.where(i_c >= 0, i_c + s * local_rows,
                              torch.full_like(i_c, -1))
            parts[s] = (d_c, gid)
    return parts


def sharded_quantized_topk(q, q_words, codes: RowSharded, valid,
                           rescore_rows, centroids, *, k: int, k_out: int,
                           chunk_size: int, quantization: str, metric: str,
                           mesh: Mesh, use_pallas: bool = False,
                           selection: str = "approx", allow_rows=None,
                           dcn_compact: bool | None = None):
    """Compressed scan over row-sharded codes, then the merge.

    Codes [N, m|w] (and the optional bf16 ``rescore_rows`` [N, d]) are
    ``RowSharded``; each shard scans its rows (BQ hamming / PQ4 / PQ
    ADC), selects ``k`` local candidates, optionally rescores them
    exactly against its own rows, and only (distance, id) pairs reach the
    merge. ``q`` is the f32 query (normalized for cosine), ``q_words``
    the packed query bits for BQ. ``allow_rows`` is column-sharded like
    the flat scan's. Returns (dists [B, k_out], global ids)."""
    if dcn_compact is None:
        dcn_compact = dcn_compact_default()
    with tracing.span("spmd.quantized_topk", shards=n_row_shards(mesh),
                      k=k_out, rows=int(codes.shape[0]),
                      quantization=quantization,
                      hierarchical=is_hierarchical(mesh),
                      filtered=allow_rows is not None):
        _explain_merge(mesh, k_out, dcn_compact)
        parts = sharded_quantized_candidates(
            q, q_words, codes, valid, rescore_rows, centroids, k=k,
            k_out=k_out, chunk_size=chunk_size, quantization=quantization,
            metric=metric, mesh=mesh, use_pallas=use_pallas,
            selection=selection, allow_rows=allow_rows)
        return merge_candidates(parts, mesh, k_out, compact=dcn_compact)


def sharded_ivf_pq_topk(q, centroids, list_codes, list_valid, list_slots,
                        list_tvals, pq_centroids, *, k: int, nprobe: int,
                        metric: str, mesh: Mesh, dcn_compact: bool = False):
    """IVF-PQ probe over LIST-sharded posting lists.

    ``centroids`` [nlist, d], ``list_codes`` [nlist, cap, m],
    ``list_valid`` / ``list_slots`` / ``list_tvals`` [nlist, cap] are
    ``RowSharded`` on the list dim; ``q`` and the PQ codebook are
    replicated. Each shard ranks ITS centroids, probes its top-nprobe
    lists (the union covers at least the global top-nprobe) with
    ``engine/ivf._ivf_probe_topk_pq`` and contributes k candidates to the
    merge. Distances are the int8-quantized ADC approximations and are
    not rescored here: the merged SLOTS are the contract."""
    from weaviate_tpu_torch.engine.ivf import _ivf_probe_topk_pq

    ops = _operands(partition.IVF_RULES,
                    {"q": q, "centroids": centroids, "list_codes": list_codes,
                     "list_valid": list_valid, "list_slots": list_slots,
                     "list_tvals": list_tvals, "pq_centroids": pq_centroids},
                    mesh)
    parts: list = [None] * n_row_shards(mesh)
    for s in local_shards(mesh):
        dev = mesh.devices[s]
        with _shard_guard(dev):
            cent = ops["centroids"](s, dev)
            codes = ops["list_codes"](s, dev)
            local_nlist = cent.shape[0]
            cn = (cent.float() ** 2).sum(-1)
            parts[s] = _ivf_probe_topk_pq(
                ops["q"](s, dev), cent, cn, codes, ops["list_valid"](s, dev),
                ops["list_slots"](s, dev), ops["list_tvals"](s, dev),
                ops["pq_centroids"](s, dev), None,
                min(k, local_nlist * codes.shape[1]),
                min(nprobe, local_nlist), metric)
    return merge_candidates(parts, mesh, k, compact=dcn_compact)
