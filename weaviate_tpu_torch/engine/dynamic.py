"""Dynamic index: exact flat scan below a threshold, IVF ANN above (port of
``weaviate_tpu/engine/dynamic.py``).

Reference: adapters/repos/db/vector/dynamic/index.go starts flat and
upgrades to HNSW once the object count crosses a threshold
(ShouldUpgrade :348, Upgrade :370). As in the JAX package the upgrade
target is the IVF index, and the swap happens inline at the insert that
crosses the threshold (the IVF delta buffer absorbs the migrated rows).
The flat regime scans on the card with ``distance_block`` and
``fused_topk_pairs``; the IVF regime is ``engine/ivf.py``.
"""

from __future__ import annotations

import threading

import numpy as np

from weaviate_tpu_torch.engine.flat import FlatIndex
from weaviate_tpu_torch.engine.ivf import IVFIndex


class DynamicIndex:
    """VectorIndex-contract wrapper delegating to flat, then IVF, on
    ``device`` (default: the card)."""

    index_type = "dynamic"

    def __init__(self, dim: int, metric: str = "l2-squared",
                 threshold: int = 100_000, mesh=None, capacity: int = 8192,
                 chunk_size: int = 8192, nlist: int = 0, nprobe: int = 0,
                 upgrade_quantization: str | None = None, device=None,
                 **flat_kwargs):
        self.dim = dim
        self.metric = metric
        self.threshold = threshold
        self.mesh = mesh
        self._nlist = nlist
        self._nprobe = nprobe
        self._chunk_size = chunk_size
        # residency of the upgrade TARGET: the flat regime stays full
        # precision, the IVF index it migrates into can start quantized
        self._upgrade_quantization = upgrade_quantization
        self._lock = threading.RLock()
        # captured so the upgrade (which runs on an insert thread, outside
        # any shard owner scope) keeps the new index's ledger attribution
        from weaviate_tpu_torch.runtime import hbm_ledger

        self._hbm_owner = hbm_ledger.current_owner()
        self._impl = FlatIndex(dim=dim, metric=metric, mesh=mesh,
                               capacity=capacity, chunk_size=chunk_size,
                               device=device, **flat_kwargs)

    # -- upgrade lifecycle ----------------------------------------------------

    @property
    def upgraded(self) -> bool:
        return isinstance(self._impl, IVFIndex)

    def _device(self):
        return self._impl.store.device

    def should_upgrade(self) -> bool:
        """Reference ShouldUpgrade (dynamic/index.go:348). Quantized flat
        stays flat: the compressed scan is already the fast path."""
        return (not self.upgraded and self.mesh is None
                and not self._impl.compressed
                and len(self._impl) >= self.threshold)

    def upgrade(self) -> None:
        """Migrate the flat contents into a fresh IVF index on the same
        device (reference Upgrade, dynamic/index.go:370)."""
        with self._lock:
            if self.upgraded:
                return
            flat = self._impl
            snap = flat.snapshot()
            slot_to_id = snap["slot_to_id"]
            valid = snap["valid"]
            live = [s for s in range(min(len(slot_to_id), len(valid)))
                    if valid[s] and slot_to_id[s] >= 0]
            from weaviate_tpu_torch.runtime import hbm_ledger

            with hbm_ledger.owner(**self._hbm_owner):
                ivf = IVFIndex(dim=self.dim, metric=self.metric,
                               chunk_size=self._chunk_size,
                               nlist=self._nlist, nprobe=self._nprobe,
                               train_threshold=max(self.threshold, 256),
                               dtype=getattr(flat.store, "dtype", None),
                               quantization=self._upgrade_quantization,
                               device=self._device())
            if live:
                ids = slot_to_id[live]
                vecs = snap["vectors"][live]
                ivf.add_batch(ids, vecs)
                if not ivf.trained:
                    ivf.train()
            self._impl = ivf

    # -- VectorIndex contract (delegated) ------------------------------------

    def add(self, doc_id: int, vector) -> None:
        self.add_batch([doc_id], np.asarray(vector)[None, :])

    def add_batch(self, doc_ids, vectors) -> None:
        with self._lock:
            self._impl.add_batch(doc_ids, vectors)
            if self.should_upgrade():
                self.upgrade()

    def maintain(self) -> None:
        """Maintenance tick (db/shard.py epoch_maintenance): catch a
        deferred upgrade (a restore that landed above the threshold
        without an insert) and forward the tick to the live impl."""
        with self._lock:
            if self.should_upgrade():
                self.upgrade()
            impl_maintain = getattr(self._impl, "maintain", None)
            if impl_maintain is not None:
                impl_maintain()

    def __getattr__(self, name):
        # everything else (search/delete/len/compact/...) hits the live impl
        return getattr(self._impl, name)

    def __len__(self) -> int:
        return len(self._impl)

    def snapshot(self) -> dict:
        snap = self._impl.snapshot()
        snap["index_type"] = "dynamic"
        snap["dynamic_threshold"] = self.threshold
        snap["dynamic_upgraded"] = self.upgraded
        snap["dynamic_upgrade_quantization"] = self._upgrade_quantization
        return snap

    @classmethod
    def restore(cls, snap: dict, mesh=None, **kwargs) -> "DynamicIndex":
        idx = cls.__new__(cls)
        idx.threshold = snap.get("dynamic_threshold", 100_000)
        idx.mesh = mesh
        idx.dim = snap["dim"]
        idx.metric = snap["metric"]
        idx._nlist = snap.get("nlist", 0)
        idx._nprobe = snap.get("nprobe", 0)
        idx._chunk_size = snap.get("chunk_size", 8192)
        idx._upgrade_quantization = snap.get("dynamic_upgrade_quantization")
        idx._lock = threading.RLock()
        from weaviate_tpu_torch.runtime import hbm_ledger

        idx._hbm_owner = hbm_ledger.current_owner()
        if snap.get("dynamic_upgraded"):
            idx._impl = IVFIndex.restore(snap, **kwargs)
        else:
            idx._impl = FlatIndex.restore(snap, mesh=mesh, **kwargs)
        return idx
