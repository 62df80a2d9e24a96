"""Carry the JAX package's state into the port.

``store_from_jax_snapshot`` / ``quantized_store_from_jax_snapshot`` /
``epoch_store_from_jax_snapshot`` / ``flat_from_jax_snapshot`` /
``ivf_from_jax_snapshot`` / ``dynamic_from_jax_snapshot`` /
``hnsw_from_jax_snapshot`` take the numpy dicts that the JAX package's
``DeviceVectorStore.snapshot()``, ``QuantizedVectorStore.snapshot()``,
``EpochStore.snapshot()``, ``FlatIndex.snapshot()``,
``IVFIndex.snapshot()``, ``DynamicIndex.snapshot()`` and
``HNSWIndex.snapshot()`` return (plain numpy and Python values — this
module imports nothing of the JAX package) and build the port's store /
index from them on ``device``, or row-sharded over ``mesh`` (the store,
quantized, epoch, flat and dynamic converters; the slots and shard
boundaries are the JAX mesh store's). An IVF snapshot carries its coarse
centroids and, under residual PQ, its codebook, so the port probes the
same partition; an HNSW snapshot carries the graph link for link. The
port's own snapshots are the same dicts, so the JAX package restores
them as they are. A quantized snapshot carries its PQ
codebook ([m, 16, ds] f32) and, for a codes-only store, its codes and sign
prefix, so the port scans the very same codes; ``pq_codebook`` carries a
codebook alone (its centroids as numpy), for a store built beside the
JAX one. On-disk state needs no conversion: the storage layer is the same
code, so ``db.Database`` opens a data directory the JAX package wrote.
"""

from __future__ import annotations

import numpy as np
import torch

from weaviate_tpu_torch.device import resolve
from weaviate_tpu_torch.engine.dynamic import DynamicIndex
from weaviate_tpu_torch.engine.epochs import EpochStore
from weaviate_tpu_torch.engine.flat import FlatIndex
from weaviate_tpu_torch.engine.hnsw import HNSWIndex
from weaviate_tpu_torch.engine.ivf import IVFIndex
from weaviate_tpu_torch.engine.quantized import QuantizedVectorStore
from weaviate_tpu_torch.engine.store import DeviceVectorStore
from weaviate_tpu_torch.ops.pq import PQCodebook


def _host_snapshot(snap: dict) -> dict:
    out = dict(snap)
    out["valid"] = np.asarray(snap["valid"], dtype=bool)
    if "vectors" in snap:
        out["vectors"] = np.asarray(snap["vectors"], dtype=np.float32)
    if snap.get("codebook") is not None:
        out["codebook"] = np.asarray(snap["codebook"], dtype=np.float32)
    for key in ("codes", "prefix_t"):
        if snap.get(key) is not None:
            out[key] = np.asarray(snap[key])
    return out


def store_from_jax_snapshot(snap: dict, device=None, mesh=None,
                            **kwargs) -> DeviceVectorStore:
    """The port's ``DeviceVectorStore`` holding the same rows, slots,
    metric, storage dtype and chunk size as the JAX store's snapshot."""
    return DeviceVectorStore.restore(_host_snapshot(snap), device=device,
                                     mesh=mesh, **kwargs)


def quantized_store_from_jax_snapshot(snap: dict, device=None, mesh=None,
                                      **kwargs) -> QuantizedVectorStore:
    """The port's ``QuantizedVectorStore`` from the JAX store's snapshot:
    the same quantization, codebook, rescore mode, prefix, rows or codes,
    and slots."""
    return QuantizedVectorStore.restore(_host_snapshot(snap), device=device,
                                        mesh=mesh, **kwargs)


def pq_codebook(centroids, device=None) -> PQCodebook:
    """The port's ``PQCodebook`` from a codebook's centroids ([m, k, ds],
    e.g. ``np.asarray(jax_store.codebook.centroids)``)."""
    return PQCodebook(torch.from_numpy(np.array(
        centroids, dtype=np.float32)).to(resolve(device)))


def epoch_store_from_jax_snapshot(snap: dict, device=None, mesh=None,
                                  **kwargs) -> EpochStore:
    """The port's ``EpochStore`` from the JAX epoch store's snapshot: the
    same global slots, re-split by the same ``epoch_rows``, and the same
    quantization and codebook."""
    return EpochStore.restore(_host_snapshot(snap), device=device, mesh=mesh,
                              **kwargs)


def flat_from_jax_snapshot(snap: dict, device=None, mesh=None,
                           **kwargs) -> FlatIndex:
    """The port's ``FlatIndex`` (store + id<->slot tables) from the JAX
    ``FlatIndex.snapshot()``, plain, quantized or epoch-backed."""
    out = _host_snapshot(snap)
    out["slot_to_id"] = np.asarray(snap["slot_to_id"], dtype=np.int64)
    return FlatIndex.restore(out, device=device, mesh=mesh, **kwargs)


def _host_ivf_snapshot(snap: dict) -> dict:
    out = dict(snap)
    out["valid"] = np.asarray(snap["valid"], dtype=bool)
    out["slot_to_id"] = np.asarray(snap["slot_to_id"], dtype=np.int64)
    out["live_vectors"] = np.asarray(snap["live_vectors"], dtype=np.float32)
    out["live_slots"] = np.asarray(snap["live_slots"], dtype=np.int64)
    for key in ("centroids", "pq_codebook"):
        if snap.get(key) is not None:
            out[key] = np.asarray(snap[key], dtype=np.float32)
    return out


def ivf_from_jax_snapshot(snap: dict, device=None, **kwargs) -> IVFIndex:
    """The port's ``IVFIndex`` from the JAX ``IVFIndex.snapshot()``: the
    same coarse centroids (and residual-PQ codebook), live rows and
    slots, rebuilt into posting lists on ``device``."""
    return IVFIndex.restore(_host_ivf_snapshot(snap), device=device, **kwargs)


def dynamic_from_jax_snapshot(snap: dict, device=None, mesh=None,
                              **kwargs) -> DynamicIndex:
    """The port's ``DynamicIndex`` from the JAX ``DynamicIndex.snapshot()``,
    in the same regime (flat below the threshold, IVF once upgraded)."""
    if snap.get("dynamic_upgraded"):
        out = _host_ivf_snapshot(snap)
    else:
        out = _host_snapshot(snap)
        out["slot_to_id"] = np.asarray(snap["slot_to_id"], dtype=np.int64)
    return DynamicIndex.restore(out, device=device, mesh=mesh, **kwargs)


def hnsw_from_jax_snapshot(snap: dict, device=None, **kwargs) -> HNSWIndex:
    """The port's ``HNSWIndex`` from the JAX ``HNSWIndex.snapshot()``:
    the same vectors, levels, doc ids, tombstones, links, entry point and
    (when compressed) PQ codes and codebook."""
    return HNSWIndex.restore(snap, device=device, **kwargs)
