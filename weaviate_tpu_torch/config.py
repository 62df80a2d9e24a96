"""Server configuration from the environment.

Reference: usecases/config/environment.go (747 lines of env parsing) +
config_handler.go (yaml/json file) + go-flags. The same env surface is
honored here so a reference deployment's environment carries over;
``ServerConfig.from_env`` is the single entry point, with an optional
json/yaml config file via CONFIG_FILE (reference: --config-file flag).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field


def _flag(env, name: str, default: bool = False) -> bool:
    raw = env.get(name)
    if raw is None:
        return default
    return raw.lower() in ("true", "1", "on", "enabled")


def _csv(env, name: str) -> list[str]:
    return [s.strip() for s in env.get(name, "").split(",") if s.strip()]


def _int(env, name: str, default: int) -> int:
    raw = env.get(name)
    try:
        return int(raw) if raw else default
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}")


def _float(env, name: str, default: float) -> float:
    raw = env.get(name)
    try:
        return float(raw) if raw else default
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}")


def _fraction(env, name: str, default: float) -> float:
    raw = env.get(name)
    if not raw:
        return default
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}")
    if not 0.0 < v <= 1.0:
        raise ValueError(f"{name} must be in (0, 1], got {v}")
    return v


@dataclass
class ServerConfig:
    # persistence (PERSISTENCE_DATA_PATH, environment.go)
    data_path: str = "./data"
    # PERSISTENCE_WAL_SYNC: fsync every WAL append before acking the
    # write (durability over throughput — see bench.py durability_tax
    # for the cost). Off = the OS page cache decides when acked writes
    # hit disk, so a POWER failure (not a process crash) can lose the
    # tail. The raft bucket is pinned sync regardless (cluster/node.py).
    wal_sync: bool = False
    # API listeners
    host: str = "127.0.0.1"
    rest_port: int = 8080
    grpc_port: int = 50051
    # query defaults (QUERY_DEFAULTS_LIMIT / QUERY_MAXIMUM_RESULTS)
    query_defaults_limit: int = 25
    query_maximum_results: int = 10_000
    # modules (ENABLE_MODULES / DEFAULT_VECTORIZER_MODULE)
    enabled_modules: list[str] | None = None
    default_vectorizer_module: str = "none"
    # cluster (CLUSTER_HOSTNAME / RAFT_JOIN / CLUSTER_JOIN ...)
    cluster_advertise: str = ""
    cluster_hostname: str = "node-0"
    raft_join: list[str] = field(default_factory=list)
    cluster_join: list[str] = field(default_factory=list)
    cluster_data_port: int = 0
    # features
    async_indexing: bool = False
    auto_schema_enabled: bool = True
    # observability
    prometheus_enabled: bool = False
    prometheus_port: int = 2112
    # tailboard (always-on latency attribution): the per-request phase
    # timeline can be disabled wholesale (bench A/B, emergencies); SLO
    # objectives are a JSON list (WEAVIATE_TPU_SLO) overriding the
    # built-in availability/latency defaults — see runtime/tailboard.py
    tailboard_enabled: bool = True
    slo_config: str = ""
    profiling_port: int = 0  # 0 = profiler server off (PROFILING_PORT)
    # kernelscope: how many /v1/debug/profile?ms=N captures to keep
    # persisted under <data_dir>/kernelscope (PROFILING_KEEP)
    profile_keep: int = 8
    # driftwatch: online recall/perf drift plane (canary probes + live
    # telemetry vs benchkeeper bands) on a cyclemanager period
    driftwatch_enabled: bool = True
    drift_interval_s: float = 30.0
    log_level: str = "info"
    log_format: str = "text"
    disable_telemetry: bool = False
    # resources (GOMEMLIMIT analog: device + host budgets for memwatch)
    memory_limit_bytes: int = 0  # 0 = unlimited
    # HBM admission control (runtime/memwatch.py watermark gating):
    # imports are refused with 507 past high*budget and accepted again
    # under low*budget (hysteresis). The budget comes from allocator
    # stats where available, else HBM_DEVICE_LIMIT_BYTES.
    hbm_device_limit_bytes: int = 0  # 0 = allocator-reported / unlimited
    hbm_high_watermark: float = 0.9
    hbm_low_watermark: float = 0.8
    # failure policy (runtime/retry.py + cluster/transport.py):
    # remote_rpc_timeout_s replaces cluster/remote.py's hard-coded 30s
    # per-attempt ceiling; query_deadline_s is the default request time
    # budget opened at the REST edge (0 = none unless the client sends
    # X-Request-Timeout), propagated down through the batcher, shard
    # fan-out and every transport call
    remote_rpc_timeout_s: float = 30.0
    query_deadline_s: float = 0.0
    # backups
    backup_filesystem_path: str = ""

    @classmethod
    def from_env(cls, env=None) -> "ServerConfig":
        env = os.environ if env is None else env
        cfg = cls(
            data_path=env.get("PERSISTENCE_DATA_PATH", "./data"),
            wal_sync=_flag(env, "PERSISTENCE_WAL_SYNC"),
            host=env.get("BIND_ADDRESS", env.get("ORIGIN_HOST",
                                                 "127.0.0.1")),
            rest_port=_int(env, "PORT", 8080),
            grpc_port=_int(env, "GRPC_PORT", 50051),
            query_defaults_limit=_int(env, "QUERY_DEFAULTS_LIMIT", 25),
            query_maximum_results=_int(env, "QUERY_MAXIMUM_RESULTS", 10_000),
            enabled_modules=_csv(env, "ENABLE_MODULES") or None,
            default_vectorizer_module=env.get(
                "DEFAULT_VECTORIZER_MODULE", "none"),
            cluster_hostname=env.get("CLUSTER_HOSTNAME", "node-0"),
            raft_join=_csv(env, "RAFT_JOIN"),
            cluster_join=_csv(env, "CLUSTER_JOIN"),
            cluster_data_port=_int(env, "CLUSTER_DATA_BIND_PORT", 0),
            cluster_advertise=env.get("CLUSTER_ADVERTISE_ADDR", ""),
            async_indexing=_flag(env, "ASYNC_INDEXING"),
            auto_schema_enabled=_flag(env, "AUTOSCHEMA_ENABLED", True),
            prometheus_enabled=_flag(env, "PROMETHEUS_MONITORING_ENABLED"),
            prometheus_port=_int(env, "PROMETHEUS_MONITORING_PORT", 2112),
            tailboard_enabled=_flag(env, "WEAVIATE_TPU_TAILBOARD", True),
            slo_config=env.get("WEAVIATE_TPU_SLO", ""),
            profiling_port=_int(env, "PROFILING_PORT", 0),
            profile_keep=_int(env, "PROFILING_KEEP", 8),
            driftwatch_enabled=_flag(env, "WEAVIATE_TPU_DRIFTWATCH", True),
            drift_interval_s=_float(env, "WEAVIATE_TPU_DRIFT_INTERVAL_S",
                                    30.0),
            log_level=env.get("LOG_LEVEL", "info"),
            log_format=env.get("LOG_FORMAT", "text"),
            disable_telemetry=_flag(env, "DISABLE_TELEMETRY"),
            memory_limit_bytes=_int(env, "MEMORY_LIMIT_BYTES", 0),
            hbm_device_limit_bytes=_int(env, "HBM_DEVICE_LIMIT_BYTES", 0),
            hbm_high_watermark=_fraction(env, "HBM_HIGH_WATERMARK", 0.9),
            hbm_low_watermark=_fraction(env, "HBM_LOW_WATERMARK", 0.8),
            remote_rpc_timeout_s=_float(env, "REMOTE_RPC_TIMEOUT_S", 30.0),
            query_deadline_s=_float(env, "QUERY_DEADLINE_S", 0.0),
            backup_filesystem_path=env.get("BACKUP_FILESYSTEM_PATH", ""),
        )
        path = env.get("CONFIG_FILE", "")
        if path:
            cfg = cfg.merge_file(path)
        return cfg

    def merge_file(self, path: str) -> "ServerConfig":
        """Overlay a json (or flat yaml subset) config file — file values
        win over env, matching the reference's precedence for
        --config-file."""
        with open(path) as f:
            raw = f.read()
        try:
            data = json.loads(raw)
        except json.JSONDecodeError:
            # minimal yaml: "key: value" lines (the reference accepts
            # yaml; full yaml needs no dependency for flat files)
            data = {}
            for line in raw.splitlines():
                line = line.split("#", 1)[0].strip()
                if ":" in line:
                    k, _, v = line.partition(":")
                    data[k.strip()] = v.strip()
        out = ServerConfig(**{**self.__dict__})
        for k, v in data.items():
            key = k.replace("-", "_")
            if hasattr(out, key):
                cur = getattr(out, key)
                if isinstance(cur, bool):
                    v = str(v).lower() in ("true", "1", "on")
                elif isinstance(cur, int):
                    v = int(v)
                elif isinstance(cur, float):
                    v = float(v)
                elif isinstance(cur, list) and isinstance(v, str):
                    v = [s.strip() for s in v.split(",") if s.strip()]
                setattr(out, key, v)
        return out
