"""The system under test: the port's server as a deployment runs it.

``weaviate_tpu_torch.server.Server`` over its own database in a directory
of the run's ``TMPDIR``, gRPC served by the native data plane
(``WEAVIATE_TPU_NATIVE_DATAPLANE=1``), REST on a port the OS picks, no
telemetry, every other setting the program's default (background LSM
maintenance and driftwatch cycles included). The collection is created
from the configuration's schema and filled through ``Collection.batch_put``.

Everything of the program that the benchmark reads is read here: the
server and its plane, the plane's counters, the kernels' launch counts,
and (in a traced run) the calls into the shard's filter, timed by a
wrapper of this module and named for the profiler with
``record_function``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

NATIVE_FLAG = "WEAVIATE_TPU_NATIVE_DATAPLANE"
IMPORT_BATCH = 1000  # objects a batch_put call, as a client batches them


class Deployment:
    def __init__(self, config: dict, data_dir: str, device: str):
        self.config = config
        self.data_dir = data_dir
        self.device = device
        self.server = None
        self.col = None
        self.name = config["collection"]["name"]

    # -- bring-up ---------------------------------------------------------

    def start(self) -> None:
        from weaviate_tpu_torch.api.grpc.native_plane import NativeDataPlane
        from weaviate_tpu_torch.config import ServerConfig
        from weaviate_tpu_torch.server import Server

        os.environ[NATIVE_FLAG] = "1"
        cfg = ServerConfig(data_path=self.data_dir, host="127.0.0.1", rest_port=0,
                           grpc_port=0, disable_telemetry=True)
        self.server = Server(cfg, device=self.device).start()
        if not isinstance(self.server.grpc, NativeDataPlane):
            raise RuntimeError(
                f"the server serves gRPC through {type(self.server.grpc).__name__}, "
                "not the native data plane (libnghttp2.so.14 or g++ missing?)")

    @property
    def port(self) -> int:
        return int(self.server.grpc.port)

    @property
    def plane(self):
        return self.server.grpc

    def create_and_import(self, ds) -> float:
        """The collection from the configuration's schema, filled through
        ``batch_put`` in client-sized batches; returns the import seconds."""
        from weaviate_tpu_torch.schema.config import CollectionConfig

        db = self.server.db
        self.col = db.create_collection(
            CollectionConfig.from_dict(self.config["collection"]))
        t0 = time.perf_counter()
        n = len(ds.vectors)
        for s in range(0, n, IMPORT_BATCH):
            e = min(n, s + IMPORT_BATCH)
            objs = [{"uuid": ds.uuids[i], "properties": {"key": int(ds.keys[i])},
                     "vector": ds.vectors[i]} for i in range(s, e)]
            res = self.col.batch_put(objs)
            bad = [r for r in res if r.get("status") != "SUCCESS"]
            if bad:
                raise RuntimeError(f"import failed: {bad[0]}")
        return time.perf_counter() - t0

    def drain(self, timeout_s: float = 600.0) -> int:
        """Flush the import's memtables and run the LSM maintenance cycle
        until it finds nothing to do, so that the window measures queries
        and not the import's compaction. Each pass holds the cycle
        manager's pause, so a compaction the background cycle has in
        flight ends before the pass that finds nothing left. Returns the
        passes it took."""
        self.col.flush()
        cycles = self.server.db.cycles
        deadline = time.monotonic() + timeout_s
        passes = 0
        while time.monotonic() < deadline:
            passes += 1
            with cycles.pause():
                busy = any(shard.maintenance() for shard in self.col.shards.values())
            if not busy:
                return passes
        raise RuntimeError(f"LSM maintenance still busy after {timeout_s} s "
                           f"({cycles.stats()})")

    def warm_plane(self, timeout_s: float = 120.0) -> None:
        """After the first Search: the plane's registration of the
        collection and its reply cache, filled."""
        if not self.plane.wait_registered(self.name, timeout_s):
            raise RuntimeError(f"the plane did not register {self.name}")
        if not self.plane.warm_collection(self.name):
            raise RuntimeError(f"the plane's reply cache for {self.name} did not warm")

    def request_head(self, traffic: dict) -> bytes:
        """A serialized SearchRequest without its near_vector."""
        from weaviate_tpu_torch.api.grpc import v1_pb2 as pb

        req = pb.SearchRequest(collection=self.name, limit=int(traffic["limit"]),
                               uses_123_api=True)
        for m in traffic["metadata"]:
            setattr(req.metadata, m, True)
        flt = traffic.get("filter")
        if flt is not None:
            req.filters.operator = getattr(pb.Filters, "OPERATOR_" + _snake(flt["operator"]))
            req.filters.target.property = flt["property"]
            req.filters.value_int = int(flt["value"])
        return req.SerializeToString()

    # -- counters ---------------------------------------------------------

    def counters(self) -> dict:
        from weaviate_tpu_torch.ops import kernels

        fast, fallback = self.plane.dp.stats()
        cache = self.plane.dp.cache_stats()
        return {"fast": fast, "fallback": fallback,
                "cache_hits": cache["hits"], "cache_misses": cache["misses"],
                "launches": dict(kernels.launch_counts),
                "cycles": {k: v["runs"] for k, v in
                           self.server.db.cycles.stats().items()}}

    def live_rows(self) -> int:
        return sum(s.object_count() for s in self.col.shards.values())

    def stop(self) -> None:
        if self.server is not None:
            self.server.stop()
            self.server = None
            self.col = None


def _snake(name: str) -> str:
    """GreaterThanEqual -> GREATER_THAN_EQUAL."""
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i:
            out.append("_")
        out.append(ch.upper())
    return "".join(out)


class LayerProbe:
    """Wrappers around the calls into the layers, installed for a traced
    run only: each call is timed on the host's monotonic clock (ns) and
    named ``portbench.<layer>`` for the profiler."""

    LAYERS = {
        "allow_mask": ("weaviate_tpu_torch.db.shard", "Shard", "allow_mask"),
    }

    def __init__(self):
        self.calls: dict[str, list] = {k: [] for k in self.LAYERS}
        self._lock = threading.Lock()
        self._saved = []

    def install(self) -> None:
        import importlib

        for layer, (mod, cls, meth) in self.LAYERS.items():
            klass = getattr(importlib.import_module(mod), cls)
            orig = getattr(klass, meth)
            self._saved.append((klass, meth, orig))
            setattr(klass, meth, self._wrap(layer, orig))

    def uninstall(self) -> None:
        for klass, meth, orig in reversed(self._saved):
            setattr(klass, meth, orig)
        self._saved.clear()

    def _wrap(self, layer: str, orig):
        probe = self

        def wrapped(*args, **kwargs):
            t0 = time.monotonic_ns()
            with torch.profiler.record_function(f"portbench.{layer}"):
                try:
                    return orig(*args, **kwargs)
                finally:
                    t1 = time.monotonic_ns()
                    with probe._lock:
                        probe.calls[layer].append((t0, t1))

        return wrapped


@contextlib.contextmanager
def profiled(on: bool):
    """torch.profiler over the host and the card, or nothing."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
