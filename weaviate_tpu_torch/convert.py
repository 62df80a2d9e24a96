"""Carry the JAX package's state into the port.

``store_from_jax_snapshot`` / ``quantized_store_from_jax_snapshot`` /
``flat_from_jax_snapshot`` take the numpy dicts that the JAX package's
``DeviceVectorStore.snapshot()``, ``QuantizedVectorStore.snapshot()`` and
``FlatIndex.snapshot()`` return (plain numpy and Python values — this
module imports nothing of the JAX package) and build the port's store /
index from them on ``device``. A quantized snapshot carries its PQ
codebook ([m, 16, ds] f32) and, for a codes-only store, its codes and sign
prefix, so the port scans the very same codes. On-disk state needs no
conversion: the storage layer is the same code, so ``db.Database`` opens a
data directory the JAX package wrote.
"""

from __future__ import annotations

import numpy as np

from weaviate_tpu_torch.engine.flat import FlatIndex
from weaviate_tpu_torch.engine.quantized import QuantizedVectorStore
from weaviate_tpu_torch.engine.store import DeviceVectorStore


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


def store_from_jax_snapshot(snap: dict, device=None, **kwargs) -> DeviceVectorStore:
    """The port's ``DeviceVectorStore`` holding the same rows, slots,
    metric, storage dtype and chunk size as the JAX store's snapshot."""
    return DeviceVectorStore.restore(_host_snapshot(snap), device=device, **kwargs)


def quantized_store_from_jax_snapshot(snap: dict, device=None,
                                      **kwargs) -> QuantizedVectorStore:
    """The port's ``QuantizedVectorStore`` from the JAX store's snapshot:
    the same quantization, codebook, rescore mode, prefix, rows or codes,
    and slots."""
    return QuantizedVectorStore.restore(_host_snapshot(snap), device=device, **kwargs)


def flat_from_jax_snapshot(snap: dict, device=None, **kwargs) -> FlatIndex:
    """The port's ``FlatIndex`` (store + id<->slot tables) from the JAX
    ``FlatIndex.snapshot()``, plain or quantized."""
    out = _host_snapshot(snap)
    out["slot_to_id"] = np.asarray(snap["slot_to_id"], dtype=np.int64)
    return FlatIndex.restore(out, device=device, **kwargs)
