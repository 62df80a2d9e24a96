"""Server entry point: ``python -m weaviate_tpu_torch`` (port of
``weaviate_tpu/server.py``, its single-node branch).

Reference: cmd/weaviate-server/main.go → configure_api.go:456 — assemble
config, auth, modules, DB, REST + gRPC + metrics listeners, then serve
until signaled. The port serves one node on one device: the modes the
JAX server enters for a mesh (``DCN_COORDINATOR_ADDRESS``,
``WEAVIATE_TPU_VIRTUAL_HOSTS`` > 1; ROADMAP Queue 1 item 6) or a cluster
(``RAFT_JOIN`` with more than one member, ``CLUSTER_JOIN``; item 7)
raise instead of serving without their modules.

The database's vectors live on ``device``: the CUDA card by default; a
machine without one raises unless the caller names ``device="cpu"``.
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

CLUSTER = "cluster mode: ROADMAP Queue 1 item 7"


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

        from weaviate_tpu_torch.parallel.mesh import require_single_device

        require_single_device()
        if len(cfg.raft_join) > 1 or cfg.cluster_join:
            raise NotImplementedError(
                f"RAFT_JOIN / CLUSTER_JOIN: {CLUSTER}")
        # The JAX server warms its persistent XLA compilation cache here
        # (ensure_compile_cache). The port has no counterpart: its kernel
        # build directory (build/torch_kernels) is its cache.

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

            from weaviate_tpu_torch.db.database import Database

            self.db = Database(cfg.data_path,
                               local_node=cfg.cluster_hostname,
                               start_cycles=True,
                               memory_monitor=memwatch,
                               async_indexing=cfg.async_indexing or None,
                               sync_wal=cfg.wal_sync, device=self.device)

        # tailboard: incident snapshots land in the data dir; explicit
        # SLO config (if any) replaces defaults
        from weaviate_tpu_torch.runtime import (driftwatch, kernelscope,
                                                tailboard)

        data_dir = self.db.data_dir
        tailboard.configure(data_dir=data_dir,
                            enabled=cfg.tailboard_enabled,
                            slos_json=cfg.slo_config or None)
        # kernelscope and driftwatch are configuration only in the port
        # (their planes are ROADMAP Queue 1 item 8)
        kernelscope.configure(data_dir=data_dir, keep=cfg.profile_keep)
        driftwatch.configure(data_dir=data_dir,
                             enabled=cfg.driftwatch_enabled,
                             interval=cfg.drift_interval_s)

        self.modules = default_provider(self.db, enabled=cfg.enabled_modules)
        # the FROZEN tenant tier (OFFLOAD_BACKEND) needs tenants: the
        # Database raises, naming item 7
        offload_name = os.environ.get("OFFLOAD_BACKEND", "")
        if offload_name:
            self.db.set_offload_backend(
                self.modules.backup_backend(offload_name))

        from weaviate_tpu_torch.api.rest import RestServer

        self.rest = RestServer(self.db, host=cfg.host, port=cfg.rest_port,
                               modules=self.modules, auth=self.auth,
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

        if os.environ.get("WEAVIATE_TPU_NATIVE_DATAPLANE") == "1" \
                and self.auth is None:
            # the native data plane (C++ over nghttp2) is ROADMAP Queue 1
            # item 2; the JAX server serves the Python gRPC server the same
            # way when its library is absent (server.py:167-186)
            logger.info("native gRPC data plane not ported (ROADMAP Queue 1 "
                        "item 2): serving the Python gRPC server")
        return GrpcServer(self.db, host=cfg.host, port=cfg.grpc_port,
                          modules=self.modules, auth=self.auth).start()

    def _start_profiler(self, port: int) -> bool:
        """Returns whether a profiler server was started.
        ``PROFILING_PORT=0`` (the default) means never. The JAX server
        starts ``jax.profiler``'s server, best effort; the port has no
        profiler server until ROADMAP Queue 1 item 8 and says so."""
        if not port:
            return False
        logger.warning("PROFILING_PORT=%s: the port has no profiler server "
                       "until ROADMAP Queue 1 item 8", port)
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
        if self.rest is not None:
            self.rest.stop()
        if self.db is not None and self._own_db:
            self.db.close()


def main() -> None:
    Server().start().serve_forever()


if __name__ == "__main__":
    main()
