"""Server entry point: ``python -m weaviate_tpu_torch`` (port of
``weaviate_tpu/server.py``).

Reference: cmd/weaviate-server/main.go → configure_api.go:456 — assemble
config, auth, modules, DB, cluster, REST + gRPC + metrics listeners, then
serve until signaled. Single node by default; ``RAFT_JOIN`` with more
than one member (or ``CLUSTER_JOIN``) boots a ``cluster.ClusterNode``
(gossip + Raft + the internal data plane) at replication factor 1.

The database's vectors live on ``device``: the CUDA card by default; a
machine without one raises unless the caller names ``device="cpu"``.
Under the JAX server's conditions (a coordinator in
``DCN_COORDINATOR_ADDRESS``, or ``WEAVIATE_TPU_VIRTUAL_HOSTS`` > 1) the
server first joins the process group and row-shards every collection over
``parallel.mesh.default_mesh()``, which is None on a single device.
"""

from __future__ import annotations

import logging
import os
import signal
import threading

from weaviate_tpu_torch.config import ServerConfig
from weaviate_tpu_torch.device import resolve

logger = logging.getLogger("weaviate_tpu_torch.server")

VERSION = "0.1.0"


class Server:
    """Owns every subsystem; ``start()`` returns once listeners are up
    (tests drive it in-process), ``serve_forever()`` blocks."""

    def __init__(self, config: ServerConfig | None = None, device=None,
                 db=None):
        """``db``: serve an open ``Database`` (embedded use: the process
        already holds the data directory) instead of opening
        ``config.data_path``; the server then neither starts its cycles
        nor closes it."""
        # resolved first: without CUDA and without device= this raises
        # before anything reads the environment or touches the disk
        self.device = resolve(device)
        if db is not None and db.device != self.device:
            raise ValueError(f"database on {db.device}, server on "
                             f"{self.device}")
        self.config = config or ServerConfig.from_env()
        self._stop = threading.Event()
        self.node = None
        self._own_db = db is None
        self.db = db
        self.auth = None
        self.modules = None
        self.rest = None
        self.grpc = None
        self.telemeter = None
        self.metrics_server = None

    # -- assembly (configure_api.go:456 ordering) -------------------------

    def start(self) -> "Server":
        """Everything ``assemble()`` starts, then the gRPC listener."""
        self.assemble()
        self.grpc = self._start_grpc()
        logger.info("weaviate-tpu-torch %s serving REST on %s gRPC on :%s "
                    "(device %s)", VERSION, self.rest.address,
                    self.grpc.port, self.device)
        return self

    def assemble(self) -> "Server":
        """Config checks, the database, the runtime planes, auth, modules,
        the REST (+ GraphQL) listener, metrics and telemetry: all of
        ``start()`` but the gRPC listener, which needs ``grpcio``. A
        caller on a machine without it serves REST alone through here."""
        cfg = self.config
        self._setup_logging()

        # the multi-process data plane first: with DCN_COORDINATOR_ADDRESS
        # set, the mesh spans every process's devices
        from weaviate_tpu_torch.parallel.mesh import (default_mesh,
                                                      is_multiprocess,
                                                      maybe_initialize_distributed,
                                                      virtual_hosts)

        if maybe_initialize_distributed():
            logger.info("joined the multi-process group")
        cluster_mode = len(cfg.raft_join) > 1 or bool(cfg.cluster_join)
        if cluster_mode and not self._own_db:
            raise ValueError("a cluster node opens its own database: "
                             "RAFT_JOIN / CLUSTER_JOIN exclude db=")
        # the kernel build cache (build/torch_kernels) and its hit / miss
        # / nvcc-duration metrics, before the first kernel launch
        from weaviate_tpu_torch.runtime.compile_cache import \
            ensure_compile_cache

        ensure_compile_cache()

        from weaviate_tpu_torch.auth import AuthConfig, AuthStack
        from weaviate_tpu_torch.modules import default_provider
        from weaviate_tpu_torch.runtime.memwatch import MemoryMonitor

        auth_cfg = AuthConfig.from_env()
        if not auth_cfg.anonymous_enabled or auth_cfg.api_keys or \
                auth_cfg.oidc_enabled or auth_cfg.admin_users or \
                auth_cfg.readonly_users:
            self.auth = AuthStack(auth_cfg)

        if self._own_db:
            # always constructed: the device budget may come from
            # allocator stats alone, so gating must not hinge on any
            # HBM_* env
            memwatch = MemoryMonitor(
                host_limit_bytes=cfg.memory_limit_bytes or None,
                device_limit_bytes=cfg.hbm_device_limit_bytes or None,
                high_watermark=cfg.hbm_high_watermark,
                low_watermark=cfg.hbm_low_watermark)

            # row-sharded serving (JAX server.py): over the hierarchical
            # mesh on a multi-process runtime or a virtual-host pod; one
            # device keeps one buffer (default_mesh() is None there)
            mesh = (default_mesh(self.device)
                    if is_multiprocess() or (virtual_hosts() or 1) > 1
                    else None)
            if mesh is not None:
                logger.info("serving over %s mesh: %s",
                            "hierarchical" if "host" in mesh.axis_names
                            else "1-D", mesh.shape)

            if cluster_mode:
                from weaviate_tpu_torch.cluster.node import ClusterNode

                peers = cfg.raft_join or [cfg.cluster_hostname]
                self.node = ClusterNode(
                    cfg.cluster_hostname, cfg.data_path, raft_peers=peers,
                    host=cfg.host, port=cfg.cluster_data_port,
                    advertise=cfg.cluster_advertise or None,
                    remote_timeout=cfg.remote_rpc_timeout_s,
                    sync_wal=cfg.wal_sync, mesh=mesh,
                    device=None if mesh is not None else self.device)
                self.node.start(seed_addrs=cfg.cluster_join or None)
                self.db = self.node.db
            else:
                from weaviate_tpu_torch.db.database import Database

                self.db = Database(cfg.data_path,
                                   local_node=cfg.cluster_hostname,
                                   start_cycles=True,
                                   memory_monitor=memwatch,
                                   async_indexing=cfg.async_indexing or None,
                                   sync_wal=cfg.wal_sync, device=self.device,
                                   mesh=mesh)

        # tailboard: incident snapshots land in the data dir; explicit
        # SLO config (if any) replaces defaults
        from weaviate_tpu_torch.runtime import (driftwatch, kernelscope,
                                                tailboard)

        data_dir = self.db.data_dir
        tailboard.configure(data_dir=data_dir,
                            enabled=cfg.tailboard_enabled,
                            slos_json=cfg.slo_config or None)
        # kernelscope: on-demand profile captures persist under
        # <data_dir>/kernelscope, pruned to the last PROFILING_KEEP, and
        # trace the serving device. driftwatch: history ring + sealed
        # live baseline under <data_dir>/driftwatch; the cycle itself is
        # registered by Database (start_cycles=True here runs it)
        kernelscope.configure(data_dir=data_dir, keep=cfg.profile_keep,
                              device=self.device)
        driftwatch.configure(data_dir=data_dir,
                             enabled=cfg.driftwatch_enabled,
                             interval=cfg.drift_interval_s)

        self.modules = default_provider(self.db, enabled=cfg.enabled_modules)
        # FROZEN tenant tier: ship offloaded tenants through a backup
        # backend (reference: offload-s3 module + tenantactivity FROZEN)
        offload_name = os.environ.get("OFFLOAD_BACKEND", "")
        if offload_name:
            self.db.set_offload_backend(
                self.modules.backup_backend(offload_name))

        from weaviate_tpu_torch.api.rest import RestServer

        if self.node is not None:
            # schema writes through Raft, /v1/nodes from membership, and
            # the participant side of cluster backups on the internal port
            self.rest = self.node.serve_rest(
                host=cfg.host, port=cfg.rest_port, modules=self.modules,
                auth=self.auth, query_deadline_s=cfg.query_deadline_s)
        else:
            self.rest = RestServer(self.db, host=cfg.host,
                                   port=cfg.rest_port, modules=self.modules,
                                   auth=self.auth,
                                   query_deadline_s=cfg.query_deadline_s)
            self.rest.start()

        self._start_profiler(cfg.profiling_port)

        if cfg.prometheus_enabled:
            from weaviate_tpu_torch.runtime.metrics import serve_metrics

            self.metrics_server = serve_metrics(cfg.host,
                                                cfg.prometheus_port)

        if not cfg.disable_telemetry:
            from weaviate_tpu_torch.runtime.telemetry import Telemeter

            self.telemeter = Telemeter(self.db, version=VERSION,
                                       data_dir=data_dir)
            self.telemeter.start()
        return self

    def _start_grpc(self):
        cfg = self.config
        from weaviate_tpu_torch.api.grpc.server import GrpcServer

        use_native_plane = False
        if os.environ.get("WEAVIATE_TPU_NATIVE_DATAPLANE") == "1" \
                and self.auth is None:
            from weaviate_tpu_torch import dataplane

            # without the library (or libnghttp2.so.14) the Python gRPC
            # server serves, as the JAX server does
            use_native_plane = dataplane.available()
        if use_native_plane:
            # the C++ transport serves the port; the (unstarted) GrpcServer
            # donates its handler logic to the fallback path
            from weaviate_tpu_torch.api.grpc.native_plane import NativeDataPlane

            handlers = GrpcServer(self.db, host=cfg.host, port=0,
                                  modules=self.modules, auth=None)
            plane = NativeDataPlane(self.db, handlers, host=cfg.host,
                                    port=cfg.grpc_port).start()
            logger.info("native gRPC data plane enabled")
            return plane
        return GrpcServer(self.db, host=cfg.host, port=cfg.grpc_port,
                          modules=self.modules, auth=self.auth).start()

    def _start_profiler(self, port: int) -> bool:
        """Returns whether a profiler server was started.
        ``PROFILING_PORT=0`` (the default) means never. The JAX server
        starts ``jax.profiler``'s server; torch has no counterpart, so
        the port starts none and says where captures are served: ``GET
        /v1/debug/profile?ms=N`` runs a torch.profiler capture inline."""
        if not port:
            return False
        logger.info("PROFILING_PORT=%s: torch has no profiler server; "
                    "kernel captures are served at /v1/debug/profile?ms=N",
                    port)
        return False

    def _setup_logging(self) -> None:
        level = getattr(logging, self.config.log_level.upper(),
                        logging.INFO)
        if self.config.log_format == "json":
            import json as _json

            class JsonFormatter(logging.Formatter):
                def format(self, record):
                    return _json.dumps({
                        "level": record.levelname.lower(),
                        "msg": record.getMessage(),
                        "logger": record.name,
                        "time": self.formatTime(record),
                    })

            handler = logging.StreamHandler()
            handler.setFormatter(JsonFormatter())
            logging.basicConfig(level=level, handlers=[handler])
        else:
            logging.basicConfig(
                level=level,
                format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    # -- lifecycle ---------------------------------------------------------

    def serve_forever(self) -> None:
        try:
            signal.signal(signal.SIGTERM, lambda *_: self._stop.set())
            signal.signal(signal.SIGINT, lambda *_: self._stop.set())
        except ValueError:
            pass  # not the main thread
        self._stop.wait()
        self.stop()

    def stop(self) -> None:
        self._stop.set()
        if self.telemeter is not None:
            self.telemeter.stop()
        if self.metrics_server is not None:
            # release the monitoring port — a leaked listener makes an
            # in-process restart fail with EADDRINUSE
            self.metrics_server.shutdown()
            self.metrics_server.server_close()
            self.metrics_server = None
        if self.grpc is not None:
            self.grpc.stop()
        if self.node is not None:
            self.node.close()  # closes its REST server and database too
        else:
            if self.rest is not None:
                self.rest.stop()
            if self.db is not None and self._own_db:
                self.db.close()


def main() -> None:
    Server().start().serve_forever()


if __name__ == "__main__":
    main()
