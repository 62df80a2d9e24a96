"""REST API: the /v1 surface.

Reference: adapters/handlers/rest/ (go-swagger server; spec
openapi-specs/schema.json) — /v1/objects, /v1/schema (+tenants),
/v1/batch/objects, /v1/graphql, /v1/nodes, /v1/meta, /.well-known/*.
Hand-rolled stdlib server instead of generated swagger code; the route
set and JSON shapes mirror the reference handlers
(handlers_objects.go, handlers_schema.go, handlers_batch_objects.go).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from weaviate_tpu_torch import __version__ as VERSION

# Weaviate API level implemented (reference openapi-specs/schema.json)
API_VERSION = "1.25.2"
from weaviate_tpu_torch.cluster.transport import CircuitOpenError
from weaviate_tpu_torch.db.shard import ShardReadOnlyError
from weaviate_tpu_torch.filters.filters import Filter
from weaviate_tpu_torch.runtime import (degrade, faultline, retry, tailboard,
                                  tracing)
from weaviate_tpu_torch.runtime.memwatch import InsufficientMemoryError
from weaviate_tpu_torch.schema.config import CollectionConfig, Property

logger = logging.getLogger(__name__)


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class RawResponse:
    """Non-JSON dispatch result (e.g. Prometheus text exposition)."""

    __slots__ = ("body", "content_type")

    def __init__(self, body: bytes, content_type: str):
        self.body = body
        self.content_type = content_type


# the fixed REST route classes — root-span names (which become
# span_duration label values) must come from this closed set, never from
# raw client paths, or a URL scanner inflates the metrics registry
# without bound
_ROUTE_CLASSES = frozenset((
    ".well-known", "meta", "metrics", "nodes", "cluster",
    "tenant-activity", "graphql", "schema", "objects", "batch",
    "backups", "classifications", "debug"))
# probe/scrape/introspection routes: health checks and metrics scrapes
# arrive every few seconds in production and would evict real query
# traces from the debug ring — they are not traced unless forced
_UNTRACED_ROUTES = frozenset(
    (".well-known", "meta", "metrics", "nodes", "debug", "unmatched"))


# the debug surface, declaratively: this table drives BOTH dispatch and
# the GET /v1/debug index, so an endpoint cannot exist without being
# listed (tests assert the round trip). Keys are the /v1/debug/<name>
# path segment.
DEBUG_ENDPOINTS = {
    "traces": "Finished-trace ring (newest first; ?limit=N). "
              "?tail=true serves the tail-retained ring instead: slow, "
              "errored, deadline-exceeded, degraded and fault-injected "
              "requests kept at completion regardless of "
              "TRACE_SAMPLE_RATE, with per-phase timings.",
    "memory": "HBM ledger breakdown: per-collection/shard/component "
              "device bytes, allocator-vs-ledger delta, admission "
              "watermarks and pressure state.",
    "storage": "Per-bucket crash-recovery reports from the last open: "
               "WAL frames replayed, torn tails truncated, files "
               "quarantined .corrupt, segments rebuilt.",
    "replication": "Anti-entropy convergence: hashbeat rounds, "
                   "divergent-entry estimates, staged-2PC state and "
                   "breaker/peer health per replicated shard.",
    "perf": "Last benchkeeper perf-gate verdict: per-entry values, "
            "deltas vs the reasoned baseline, regressions/stale/"
            "missing counts.",
    "slo": "SLO engine state: per-objective availability/latency "
           "windows, good/bad counts, multi-window burn rates, and "
           "which objectives are currently burning.",
    "flight": "Flight recorder: recent batcher and native-plane "
              "dispatch records (batch size, k bucket, queue depth, "
              "wait, epoch fanout, attributed device ms + source, "
              "transfer-window occupancy), the structured slow-query "
              "log, and on-disk incident snapshots.",
    "kernelscope": "Device-time truth plane: per-(kind, batch, k) "
                   "dispatch-variant residency EWMAs with their "
                   "drain/wall attribution source (drain: CUDA-event "
                   "time on the card), the sampled memcpy estimator, "
                   "per-tenant device-seconds meters and dispatch "
                   "totals. Per-query plans ride ?explain=true on "
                   "/v1/graphql (or x-explain gRPC metadata).",
    "profile": "On-demand kernel profiles: paramless lists the last K "
               "persisted captures; ?ms=N runs a capture for N ms and "
               "returns per-kernel device-ms ranked by the kernel "
               "registry from a torch.profiler capture (?id=<capture> "
               "fetches a full persisted capture).",
    "drift": "Driftwatch verdict plane: open findings with the gate "
             "verdict, per-entry trend deltas from the last live "
             "telemetry classification against benchkeeper bands, and "
             "per-canary state (probe set, sealed references, recall/"
             "residency history through the real query batcher).",
}


def _route_class(path: str) -> str:
    segs = [s for s in path.split("/") if s]
    if segs and segs[0] == "v1":
        segs = segs[1:]
    head = segs[0] if segs else ".well-known"
    return head if head in _ROUTE_CLASSES else "unmatched"


def object_to_json(class_name: str, obj, tenant: str | None = None) -> dict:
    out = {
        "class": class_name,
        "id": obj.uuid,
        "properties": obj.properties,
        "creationTimeUnix": obj.creation_time_ms,
        "lastUpdateTimeUnix": obj.last_update_time_ms,
    }
    if tenant:
        out["tenant"] = tenant
    if obj.vector is not None:
        out["vector"] = np.asarray(obj.vector).tolist()
    named = {k: np.asarray(v).tolist() for k, v in obj.vectors.items() if k}
    if named:
        out["vectors"] = named
    return out


def property_from_json(d: dict) -> Property:
    """Accepts native {"name", "data_type"} and reference-style
    {"name", "dataType": ["text"]} payloads."""
    data_type = d.get("data_type")
    if data_type is None and d.get("dataType"):
        dt = d["dataType"]
        data_type = dt[0] if isinstance(dt, list) else dt
    return Property(
        name=d["name"],
        data_type=data_type or "text",
        tokenization=d.get("tokenization", "word"),
        index_filterable=d.get("index_filterable",
                               d.get("indexFilterable", True)),
        index_searchable=d.get("index_searchable",
                               d.get("indexSearchable", True)),
        description=d.get("description", ""),
    )


def _index_config_from_json(index_type: str | None, d: dict | None):
    """Map the reference's vectorIndexConfig JSON (entities/vectorindex/
    {hnsw,flat}/config.go) onto VectorIndexConfig; native snake_case keys
    pass straight through."""
    from weaviate_tpu_torch.schema.config import VectorIndexConfig
    import dataclasses

    out = VectorIndexConfig()
    if index_type:
        out.index_type = index_type
    if not d:
        return out
    native = {f.name for f in dataclasses.fields(VectorIndexConfig)}
    for k, v in d.items():
        if k in native:
            setattr(out, k, v)
    if "distance" in d:
        out.metric = d["distance"]
    if "efConstruction" in d:
        out.ef_construction = d["efConstruction"]
    if "maxConnections" in d:
        out.max_connections = d["maxConnections"]
    pq = d.get("pq") or {}
    if pq.get("enabled"):
        out.quantization = "pq"
        out.pq_segments = pq.get("segments") or None
        out.pq_centroids = pq.get("centroids", out.pq_centroids)
    bq = d.get("bq") or {}
    if bq.get("enabled"):
        out.quantization = "bq"
        out.rescore_limit = bq.get("rescoreLimit", out.rescore_limit)
    return out


def class_to_wire(cfg: CollectionConfig) -> dict:
    """Serialize a collection config as the reference's models.Class JSON
    (openapi-specs/schema.json "Class") — the shape the official client's
    _CollectionConfig parser and every external weaviate tool expect.
    The internal snake_case dict (``cfg.to_dict()``) stays for
    persistence and the intra-cluster API; the PUBLIC wire speaks
    camelCase."""
    def _prop(p) -> dict:
        out = {
            "name": p.name,
            "dataType": [p.data_type],
            "description": p.description,
            "indexFilterable": p.index_filterable,
            "indexSearchable": p.index_searchable,
            "tokenization": p.tokenization,
        }
        if p.nested:
            out["nestedProperties"] = [_prop(np_) for np_ in p.nested]
        return out

    def _index_cfg(ix) -> dict:
        out = {
            "distance": ix.metric,
            "ef": ix.ef,
            "efConstruction": ix.ef_construction,
            "maxConnections": ix.max_connections,
            "pq": {"enabled": ix.quantization == "pq",
                   "segments": ix.pq_segments or 0,
                   "centroids": ix.pq_centroids},
            "bq": {"enabled": ix.quantization == "bq",
                   "rescoreLimit": ix.rescore_limit},
        }
        if ix.index_type == "dynamic":
            out["threshold"] = ix.flat_to_ann_threshold
        return out

    inv = cfg.inverted
    default = None
    named = {}
    for v in cfg.vectors:
        if v.name == "":
            default = v
        else:
            named[v.name] = v
    if default is None and not named:
        from weaviate_tpu_torch.schema.config import VectorConfig

        default = VectorConfig()
    out = {
        "class": cfg.name,
        "description": cfg.description,
        "properties": [_prop(p) for p in cfg.properties],
        "invertedIndexConfig": {
            "bm25": {"k1": inv.bm25_k1, "b": inv.bm25_b},
            "stopwords": {"preset": inv.stopwords_preset,
                          "additions": inv.stopwords_additions,
                          "removals": inv.stopwords_removals},
            "indexTimestamps": inv.index_timestamps,
            "indexNullState": inv.index_null_state,
            "indexPropertyLength": inv.index_property_length,
            "cleanupIntervalSeconds": 60,
        },
        "multiTenancyConfig": {
            "enabled": cfg.multi_tenancy.enabled,
            "autoTenantCreation": cfg.multi_tenancy.auto_tenant_creation,
            "autoTenantActivation": cfg.multi_tenancy.auto_tenant_activation,
        },
        "replicationConfig": {
            "factor": cfg.replication.factor,
            "asyncEnabled": cfg.replication.async_enabled,
        },
        "shardingConfig": {
            "desiredCount": cfg.sharding.desired_count,
            "virtualPerPhysical": cfg.sharding.virtual_per_physical,
        },
        "moduleConfig": cfg.module_config,
    }
    if default is not None:
        out["vectorizer"] = default.vectorizer
        out["vectorIndexType"] = default.index.index_type
        out["vectorIndexConfig"] = _index_cfg(default.index)
    if named:
        out["vectorConfig"] = {
            name: {
                "vectorizer": {v.vectorizer: v.module_config or {}},
                "vectorIndexType": v.index.index_type,
                "vectorIndexConfig": _index_cfg(v.index),
            } for name, v in named.items()
        }
    return out


def config_from_json(d: dict) -> CollectionConfig:
    """Accepts the native config dict AND the reference's class JSON shape
    (entities/models.Class): top-level "class"/"vectorizer"/
    "vectorIndexType"/"vectorIndexConfig"/"moduleConfig", camelCase
    sub-configs, and named-vector "vectorConfig"."""
    from weaviate_tpu_torch.schema.config import (
        InvertedIndexConfig,
        MultiTenancyConfig,
        ReplicationConfig,
        ShardingConfig,
        VectorConfig,
    )

    d = dict(d)
    if "name" not in d and "class" in d:
        d["name"] = d.pop("class")
    if d.get("properties") and isinstance(d["properties"][0], dict):
        # normalize per property — payloads may mix native and
        # reference-style entries
        d["properties"] = [vars(property_from_json(p)) if isinstance(p, dict)
                           else p for p in d["properties"]]

    # reference-style top-level vectorizer / index config → default space
    vectorizer = d.pop("vectorizer", None)
    v_index_type = d.pop("vectorIndexType", None)
    v_index_cfg = d.pop("vectorIndexConfig", None)
    module_config = d.pop("moduleConfig", None)
    named = d.pop("vectorConfig", None)  # weaviate named vectors
    if "vectors" not in d and (vectorizer or v_index_type or v_index_cfg
                               or named):
        vecs = []
        if named:
            for vname, vc in named.items():
                vz, mc = "none", {}
                raw_vz = vc.get("vectorizer")
                if isinstance(raw_vz, dict) and raw_vz:
                    vz = next(iter(raw_vz))
                    mc = raw_vz[vz] or {}
                elif isinstance(raw_vz, str):
                    vz = raw_vz
                vecs.append(VectorConfig(
                    name=vname,
                    index=_index_config_from_json(
                        vc.get("vectorIndexType"),
                        vc.get("vectorIndexConfig")),
                    vectorizer=vz if vz else "none",
                    module_config=mc,
                ))
        else:
            mc = {}
            if isinstance(module_config, dict) and vectorizer and \
                    vectorizer in module_config:
                mc = module_config[vectorizer] or {}
            vecs.append(VectorConfig(
                index=_index_config_from_json(v_index_type, v_index_cfg),
                vectorizer=vectorizer or "none",
                module_config=mc,
            ))
        d["vectors"] = [vars(v) if not isinstance(v, dict) else v
                        for v in vecs]
        d["vectors"] = [
            {**v, "index": vars(v["index"])
             if not isinstance(v["index"], dict) else v["index"]}
            for v in d["vectors"]
        ]
    if module_config is not None and "module_config" not in d:
        d["module_config"] = module_config

    # camelCase sub-config shims
    inv = d.pop("invertedIndexConfig", None)
    if inv is not None and "inverted" not in d:
        bm25 = inv.get("bm25") or {}
        sw = inv.get("stopwords") or {}
        d["inverted"] = vars(InvertedIndexConfig(
            bm25_k1=bm25.get("k1", 1.2),
            bm25_b=bm25.get("b", 0.75),
            stopwords_preset=sw.get("preset", "en"),
            stopwords_additions=sw.get("additions") or [],
            stopwords_removals=sw.get("removals") or [],
            index_timestamps=inv.get("indexTimestamps", False),
            index_null_state=inv.get("indexNullState", False),
            index_property_length=inv.get("indexPropertyLength", False),
        ))
    sh = d.pop("shardingConfig", None)
    if sh is not None and "sharding" not in d:
        d["sharding"] = vars(ShardingConfig(
            desired_count=sh.get("desiredCount", 1),
            virtual_per_physical=sh.get("virtualPerPhysical", 128),
        ))
    mt = d.pop("multiTenancyConfig", None)
    if mt is not None and "multi_tenancy" not in d:
        d["multi_tenancy"] = vars(MultiTenancyConfig(
            enabled=mt.get("enabled", False),
            auto_tenant_creation=mt.get("autoTenantCreation", False),
            auto_tenant_activation=mt.get("autoTenantActivation", False),
        ))
    rp = d.pop("replicationConfig", None)
    if rp is not None and "replication" not in d:
        d["replication"] = vars(ReplicationConfig(
            factor=rp.get("factor", 1),
            async_enabled=rp.get("asyncEnabled", False),
        ))

    # drop unknown top-level keys rather than TypeError-ing the constructor
    import dataclasses

    known = {f.name for f in dataclasses.fields(CollectionConfig)}
    d = {k: v for k, v in d.items() if k in known}
    return CollectionConfig.from_dict(d)


class RestServer:
    """``db``: the node-local Database. ``schema_target``: where schema
    writes go — the Database itself (single node) or a ClusterNode
    (Raft path); both expose the same method names. ``node``: optional
    ClusterNode for /v1/nodes."""

    _DEFAULT_GRAPHQL = object()  # sentinel: build an executor; None = off

    def __init__(self, db, host: str = "127.0.0.1", port: int = 0,
                 schema_target=None, node=None,
                 graphql_executor=_DEFAULT_GRAPHQL,
                 modules=None, auth=None,
                 query_deadline_s: float | None = None):
        self.db = db
        self.schema_target = schema_target or db
        self.node = node
        self.auth = auth  # AuthStack | None (None = open access)
        # default request time budget (0 = none unless the client sends
        # X-Request-Timeout / ?timeout=); propagated via retry.deadline
        if query_deadline_s is None:
            query_deadline_s = float(
                os.environ.get("QUERY_DEADLINE_S", "0") or 0)
        self.query_deadline_s = query_deadline_s
        if graphql_executor is RestServer._DEFAULT_GRAPHQL:
            from weaviate_tpu_torch.api.graphql import GraphQLExecutor

            graphql_executor = GraphQLExecutor(db, modules)
        self.graphql_executor = graphql_executor
        self.modules = modules  # module Provider for import vectorization
        if modules is not None:
            from weaviate_tpu_torch.backup import BackupManager

            self.backup_manager = BackupManager(
                db, modules,
                node_name=getattr(node, "name", None) or db.local_node,
                schema_target=self.schema_target, node=node)
        else:
            self.backup_manager = None
        self.classification_manager = None  # built lazily on first use
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _run(self, method: str):
                parsed = urllib.parse.urlparse(self.path)
                params = {k: v[0] for k, v in
                          urllib.parse.parse_qs(parsed.query).items()}
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) if length else b""
                # every data-path request gets a root trace (cheap spans
                # are always on); ?trace=true forces device-time
                # sampling. Probe/scrape routes skip tracing (unless
                # forced) so they can't flood the debug ring, and auth
                # runs BEFORE the trace opens — unauthenticated clients
                # must not be able to evict real traces from the ring.
                force = params.get("trace") == "true"
                route = _route_class(parsed.path)
                if route in _UNTRACED_ROUTES and not force:
                    trace_cm = contextlib.nullcontext()
                else:
                    trace_cm = tracing.trace(f"rest.{method} /{route}",
                                             force=force)
                # request time budget: explicit header/param wins, else
                # the server default; 0/absent = no deadline. The budget
                # propagates down through the batcher, shard fan-out and
                # every transport call (retry.remaining caps per-attempt
                # timeouts), so a retry can never outlive the request.
                budget = outer.query_deadline_s
                try:
                    raw_budget = self.headers.get("X-Request-Timeout") \
                        or params.get("timeout")
                    if raw_budget:
                        budget = float(raw_budget)
                except ValueError:
                    budget = outer.query_deadline_s
                # content negotiation for /v1/metrics (OpenMetrics with
                # exemplars) rides params — dispatch has no header access
                accept = self.headers.get("Accept", "")
                if "application/openmetrics-text" in accept:
                    params["_accept_openmetrics"] = "true"
                extra_headers: dict[str, str] = {}
                markers: list = []
                # always-on timeline (tailboard): opened for the same
                # request set tracing covers; wraps the WHOLE handling
                # INCLUDING the error mapping below, so the tail-based
                # keep/drop decision sees the response status
                timeline_cm = (
                    contextlib.nullcontext()
                    if route in _UNTRACED_ROUTES and not force
                    else tailboard.request(route, method=method))
                def _handle():
                    nonlocal markers
                    try:
                        if outer.auth is not None and \
                                not parsed.path.startswith("/.well-known"):
                            from weaviate_tpu_torch.auth import (
                                AuthError,
                                ForbiddenError,
                            )

                            # POST /v1/graphql is query-only (this API
                            # has no mutations) — same verb as gRPC
                            # Search
                            verb = "read" if method in ("GET", "HEAD") \
                                or parsed.path == "/v1/graphql" else "write"
                            try:
                                outer.auth.check(
                                    self.headers.get("Authorization"),
                                    verb)
                            except AuthError as e:
                                raise ApiError(401, str(e))
                            except ForbiddenError as e:
                                raise ApiError(403, str(e))
                        with trace_cm, retry.deadline(budget), \
                                degrade.collecting(), \
                                faultline.node_scope(outer.db.local_node):
                            body = json.loads(raw) if raw else None
                            status, payload = outer.dispatch(
                                method, parsed.path, params, body)
                            # explicit partial-result marker: a degraded
                            # scatter-gather or downgraded-consistency
                            # read must be visible to the client, never
                            # silent
                            markers = degrade.snapshot()
                            if markers and isinstance(payload, dict):
                                payload["degraded"] = markers
                        return status, payload
                    except ApiError as e:
                        return e.status, {"error": [{"message": e.message}]}
                    except (KeyError, FileNotFoundError) as e:
                        return 404, {"error": [{"message": str(e)}]}
                    except ValueError as e:
                        return 422, {"error": [{"message": str(e)}]}
                    except ShardReadOnlyError as e:
                        return 422, {"error": [{"message": str(e)}]}
                    except InsufficientMemoryError as e:
                        # typed 507 Insufficient Storage: admission
                        # control refused BEFORE allocating (memwatch
                        # watermarks) — the client should back off or
                        # free capacity, not retry blindly
                        return 507, {"error": [{
                            "message": str(e),
                            "code": "INSUFFICIENT_MEMORY",
                            "projectedBytes": e.projected,
                            "budgetBytes": e.budget,
                            "usageSource": e.source,
                        }]}
                    except retry.DeadlineExceeded as e:
                        # typed 504: the request's time budget ran out —
                        # not a generic 500, so clients/gateways can
                        # distinguish "took too long" from "broke"
                        return 504, {"error": [{
                            "message": str(e),
                            "code": "DEADLINE_EXCEEDED",
                            "layer": e.layer,
                        }]}
                    except retry.OverloadedError as e:
                        # RFC 9110: integer delta-seconds (fractions
                        # would be ignored by conforming clients),
                        # floor of 1
                        extra_headers["Retry-After"] = \
                            str(max(1,
                                    -(-int(e.retry_after_s * 1000) // 1000)))
                        return 503, {"error": [{
                            "message": str(e),
                            "code": "OVERLOADED",
                        }]}
                    except CircuitOpenError as e:
                        # the whole request depended on a peer whose
                        # breaker is open (e.g. an unreplicated remote
                        # shard write): retriable 503 with the breaker's
                        # cooldown hint (integer delta-seconds per
                        # RFC 9110, floor of 1)
                        extra_headers["Retry-After"] = \
                            str(max(1,
                                    -(-int(e.retry_after_s * 1000) // 1000)))
                        return 503, {"error": [{
                            "message": str(e),
                            "code": "CIRCUIT_OPEN",
                        }]}
                    except Exception as e:
                        logger.exception("REST %s %s failed", method,
                                         self.path)
                        return 500, {"error": [{"message": str(e)}]}

                with timeline_cm:
                    # the error mapping runs INSIDE the timeline (and the
                    # trace closes inside _handle), so the tail keep/drop
                    # decision sees both the finished trace AND the
                    # response status
                    status, payload = _handle()
                    tailboard.complete(status, degraded=bool(markers))
                if isinstance(payload, RawResponse):
                    self.send_response(status)
                    self.send_header("Content-Type", payload.content_type)
                    self.send_header("Content-Length",
                                     str(len(payload.body)))
                    self.end_headers()
                    if method != "HEAD":
                        self.wfile.write(payload.body)
                    return
                data = b"" if payload is None else json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for hk, hv in extra_headers.items():
                    self.send_header(hk, hv)
                self.end_headers()
                if method != "HEAD":
                    self.wfile.write(data)

            def do_GET(self):
                self._run("GET")

            def do_POST(self):
                self._run("POST")

            def do_PUT(self):
                self._run("PUT")

            def do_PATCH(self):
                self._run("PATCH")

            def do_DELETE(self):
                self._run("DELETE")

            def do_HEAD(self):
                self._run("HEAD")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            daemon=True,
                                            name=f"rest-{self.port}")
            self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread = None

    # -- routing --------------------------------------------------------------

    def dispatch(self, method: str, path: str, params: dict, body):
        seg = [s for s in path.split("/") if s]
        # /.well-known/* — the reference serves these under the /v1
        # basePath (swagger basePath /v1; the official client probes
        # /v1/.well-known/...), and bare-root works too; accept both.
        if seg[:2] == ["v1", ".well-known"]:
            seg = seg[1:]
        if seg[:1] == [".well-known"]:
            if seg[1:] == ["ready"] or seg[1:] == ["live"]:
                return 200, {}
            if seg[1:] == ["openid-configuration"]:
                oidc = None if self.auth is None else \
                    self.auth.openid_configuration()
                if oidc is None:
                    raise ApiError(404, "OIDC is not configured")
                return 200, oidc
            raise KeyError(path)
        if not seg or seg[0] != "v1":
            raise KeyError(path)
        seg = seg[1:]

        if seg == ["meta"]:
            # `version` carries the WEAVIATE API level this server speaks
            # (the reference pins 1.25.2, openapi-specs/schema.json) — the
            # official v4 client parses it as semver and refuses anything
            # below 1.23.7. The implementation's own version rides in a
            # separate field.
            return 200, {"version": API_VERSION, "hostname": self.address,
                         "tpuServerVersion": VERSION,
                         "grpcMaxMessageSize": 104858000,
                         "modules": self.modules.meta()
                         if self.modules is not None else {}}
        if seg == ["metrics"]:
            # real Prometheus exposition (the reference serves text on
            # the monitoring port; serving it here too lets Prometheus
            # scrape either port). A JSON wrapper would not parse.
            # OpenMetrics negotiation (Accept header, or ?format=) gets
            # exemplar-carrying buckets + the # EOF terminator; the
            # shared scrape() helper runs the read-point refreshes
            from weaviate_tpu_torch.runtime.metrics import scrape

            om = (params.get("_accept_openmetrics") == "true"
                  or params.get("format") == "openmetrics")
            return 200, RawResponse(*scrape(openmetrics=om))
        if seg[:1] == ["debug"]:
            return self._debug(seg[1:], params)
        if seg == ["nodes"]:
            verbose = params.get("output") == "verbose"
            return 200, {"nodes": self._nodes_payload(verbose=verbose)}
        if seg == ["cluster", "statistics"]:
            # Raft/cluster introspection (reference: /v1/cluster/statistics,
            # handlers for cluster statistics over the raft Store)
            if self.node is None:
                return 200, {"statistics": [{
                    "name": self.db.local_node, "status": "HEALTHY",
                    "raft": None, "standalone": True}],
                    "synchronized": True}
            raft = self.node.raft
            return 200, {"statistics": [{
                "name": self.node.name,
                "status": "HEALTHY",
                "leaderId": raft.leader_id,
                "raft": {"state": raft.role, "term": raft.current_term,
                         "commitIndex": raft.commit_index,
                         "appliedIndex": raft.commit_index,
                         "numPeers": len(raft.peers) - 1},
                "open": True, "bootstrapped": True,
                "dbLoaded": True,
                "isVoter": True,
                "candidates": {n: True for n in raft.peers},
            }], "synchronized": raft.leader_id is not None}
        if seg == ["tenant-activity"]:
            # hot/cold tenant usage (reference:
            # rest/tenantactivity/handler.go)
            out = {}
            for name in self.db.list_collections():
                snap = self.db.get_collection(name).tenant_activity_snapshot()
                if snap:
                    out[name] = snap
            return 200, out
        if seg == ["graphql"] and method == "POST":
            if self.graphql_executor is None:
                raise ApiError(501, "graphql not enabled")
            if params.get("explain") == "true":
                # per-query EXPLAIN (kernelscope): install a request-
                # level sink on THIS thread; the batcher merges each
                # dispatch's plan back here after the waiter wakes.
                # Explain never perturbs the dispatch itself — same
                # program, padding and slicing as the unexplained path.
                from weaviate_tpu_torch.runtime import kernelscope

                token = kernelscope.explain_begin()
                try:
                    out = self.graphql_executor(body or {})
                finally:
                    explain_plan = kernelscope.explain_end(token)
                if isinstance(out, dict):
                    out["_explain"] = explain_plan
            else:
                out = self.graphql_executor(body or {})
            if isinstance(out, dict) and params.get("trace") == "true" \
                    and tracing.is_sampled():
                # the inline breakdown rides ONLY explicitly requested
                # (?trace=true) responses — background TRACE_SAMPLE_RATE
                # sampling must not change response shapes clients see
                out["_debug"] = {
                    "traceId": tracing.current_trace_id(),
                    "timing": tracing.current_timing(),
                }
            return 200, out
        if seg[:1] == ["schema"]:
            return self._schema(method, seg[1:], body)
        if seg[:1] == ["objects"]:
            return self._objects(method, seg[1:], params, body)
        if seg == ["batch", "objects"] and method == "POST":
            return self._batch_objects(body or {})
        if seg == ["batch", "objects"] and method == "DELETE":
            return self._batch_delete(body or {}, params)
        if seg == ["batch", "references"] and method == "POST":
            return self._batch_references(body or [])
        if seg[:1] == ["backups"]:
            return self._backups(method, seg[1:], body)
        if seg[:1] == ["classifications"]:
            return self._classifications(method, seg[1:], body)
        raise KeyError(path)

    def _classifications(self, method: str, seg: list[str], body):
        """POST /v1/classifications, GET /v1/classifications/{id}
        (reference: handlers_classification.go)."""
        if method == "POST" and not seg:
            from weaviate_tpu_torch.api.validation import (CLASSIFICATION,
                                                     validate_body)

            validate_body(CLASSIFICATION, body or {}, "classification")
        from weaviate_tpu_torch.classification import (
            ClassificationError,
            ClassificationManager,
        )

        if self.classification_manager is None:
            self.classification_manager = ClassificationManager(
                self.db, self.modules)
        mgr = self.classification_manager
        try:
            if not seg and method == "POST":
                b = body or {}
                settings = b.get("settings") or {}
                where = b.get("filters", {}).get("sourceWhere") \
                    if b.get("filters") else None
                train = b.get("filters", {}).get("trainingSetWhere") \
                    if b.get("filters") else None
                from weaviate_tpu_torch.filters.filters import Filter

                return 201, mgr.start(
                    b.get("class", ""),
                    b.get("classifyProperties") or [],
                    based_on_properties=b.get("basedOnProperties"),
                    kind=b.get("type", "knn"), settings=settings,
                    where=None if where is None else Filter.from_dict(where),
                    training_set_where=None if train is None
                    else Filter.from_dict(train),
                    tenant=b.get("tenant"))
            if len(seg) == 1 and method == "GET":
                return 200, mgr.get(seg[0])
        except ClassificationError as e:
            raise ApiError(422, str(e))
        raise KeyError("/v1/classifications/" + "/".join(seg))

    def _patch_merge(self, col, uuid: str, body: dict, tenant):
        """PATCH /v1/objects/{class}/{id} merge semantics (reference:
        usecases/objects/merge.go). Caller holds col.uuid_lock(uuid)."""
        existing = col.get_object(uuid, tenant=tenant)
        if existing is None:
            raise ApiError(404, f"object {uuid} not found")
        merged = dict(existing.properties)
        merged.update(body.get("properties", {}))
        body["properties"] = merged

        # Carry existing vectors forward for spaces with no vectorizer —
        # vectorizer-backed spaces are left absent so _put_object re-embeds
        # the merged properties (reference re-vectorizes on merge; a copied
        # vector would pin the pre-edit embedding forever). If this server
        # CANNOT re-embed (no module provider, or the module isn't
        # registered), keep the existing vector: stale beats silently
        # dropping the object from vector search.
        def _keeps(vec_name):
            vc = col.config.vector_config(vec_name)
            if vc is None or vc.vectorizer in ("", "none"):
                return True
            return (self.modules is None
                    or self.modules.get(vc.vectorizer) is None)

        if "vector" not in body and existing.vector is not None \
                and _keeps(""):
            body["vector"] = np.asarray(existing.vector).tolist()
        if "vectors" not in body:
            named = {k: np.asarray(v).tolist()
                     for k, v in existing.vectors.items()
                     if k and _keeps(k)}
            if named:
                body["vectors"] = named
        body["creationTimeUnix"] = existing.creation_time_ms
        return self._put_object(body, tenant)

    def _references(self, method: str, class_name: str, uuid: str,
                    prop: str, body, tenant):
        """Cross-reference CRUD (reference: handlers_objects.go
        /v1/objects/{class}/{id}/references/{prop}): POST appends a
        beacon, PUT replaces all, DELETE removes one."""
        col = self.db.get_collection(class_name)
        if col.config.property(prop) is None or \
                col.config.property(prop).data_type != "cref":
            raise ApiError(422, f"property {prop!r} of {class_name} is not "
                           "a reference property")
        def beacon_of(b):
            beacon = b.get("beacon") if isinstance(b, dict) else b
            if not isinstance(beacon, str) or not beacon:
                raise ApiError(422, "reference payload needs a 'beacon' "
                               "string")
            return beacon

        # read-modify-write under a per-uuid lock: two concurrent reference
        # additions to the same object must not lose each other's append,
        # but a slow replica in the replicated put must not block the whole
        # collection (see Collection.uuid_lock)
        with col.uuid_lock(uuid):
            obj = col.get_object(uuid, tenant=tenant)
            if obj is None:
                raise ApiError(404, f"object {uuid} not found")
            refs = list(obj.properties.get(prop) or [])
            if method == "POST":
                refs.append({"beacon": beacon_of(body or {})})
            elif method == "PUT":
                items = body if isinstance(body, list) else [body or {}]
                refs = [{"beacon": beacon_of(b)} for b in items]
            elif method == "DELETE":
                want = beacon_of(body or {})
                refs = [r for r in refs
                        if (r.get("beacon") if isinstance(r, dict)
                            else str(r)) != want]
            else:
                raise KeyError("references")
            props = dict(obj.properties)
            props[prop] = refs
            col.put_object(props, vector=obj.vector,
                           vectors=obj.vectors or None, uuid=uuid,
                           tenant=tenant,
                           creation_time_ms=obj.creation_time_ms)
        return 200, None

    def _batch_delete(self, body: dict, params: dict):
        """DELETE /v1/batch/objects (reference: handlers_batch_delete —
        {"match": {"class", "where"}, "dryRun", "output"})."""
        from weaviate_tpu_torch.filters.filters import Filter

        match = body.get("match") or {}
        class_name = match.get("class", "")
        where = match.get("where")
        if not class_name or where is None:
            raise ApiError(422, "batch delete needs match.class and "
                           "match.where")
        col = self.db.get_collection(class_name)
        try:
            where_f = Filter.from_dict(where)
        except (KeyError, ValueError, TypeError) as e:
            raise ApiError(422, f"invalid match.where filter: {e}")
        result = col.batch_delete(
            where_f,
            tenant=params.get("tenant") or body.get("tenant"),
            dry_run=bool(body.get("dryRun")),
            verbose=body.get("output") == "verbose",
            consistency=params.get("consistency_level", "QUORUM"))
        return 200, {
            "match": match,
            "output": body.get("output", "minimal"),
            "dryRun": bool(body.get("dryRun")),
            "results": {
                "matches": result["matches"],
                "successful": result["successful"],
                "failed": result["failed"],
                # reference shape: null unless output=verbose
                "objects": result.get("objects")
                if body.get("output") == "verbose" else None,
            },
        }

    def _batch_references(self, body: list):
        """POST /v1/batch/references (reference: handlers_batch —
        [{from: weaviate://localhost/Class/uuid/prop, to: beacon}])."""
        if not isinstance(body, list):
            raise ApiError(422, "batch references payload must be a list")
        results = []
        for item in body:
            try:
                if not isinstance(item, dict):
                    raise ValueError("each reference must be an object "
                                     "with 'from' and 'to'")
                src = item.get("from", "")
                parts = [p for p in src.split("/") if p]
                # weaviate:, localhost, Class, uuid, prop
                if len(parts) < 4:
                    raise ValueError(f"malformed 'from' beacon {src!r}")
                cls, uid, prop = parts[-3], parts[-2], parts[-1]
                to = item.get("to")
                if not isinstance(to, str) or not to:
                    raise ValueError("'to' must be a beacon string")
                col = self.db.get_collection(cls)
                pcfg = col.config.property(prop)
                if pcfg is None or pcfg.data_type != "cref":
                    raise ValueError(
                        f"property {prop!r} of {cls} is not a reference "
                        "property")
                with col.uuid_lock(uid):  # see _references: no lost appends
                    obj = col.get_object(uid, tenant=item.get("tenant"))
                    if obj is None:
                        raise ValueError(f"source object {uid} not found")
                    refs = list(obj.properties.get(prop) or [])
                    refs.append({"beacon": to})
                    props = dict(obj.properties)
                    props[prop] = refs
                    col.put_object(props, vector=obj.vector,
                                   vectors=obj.vectors or None, uuid=uid,
                                   tenant=item.get("tenant"),
                                   creation_time_ms=obj.creation_time_ms)
                results.append({"result": {"status": "SUCCESS"}})
            except (KeyError, ValueError) as e:
                results.append({"result": {
                    "status": "FAILED",
                    "errors": {"error": [{"message": str(e)}]}}})
        return 200, results

    def _backups(self, method: str, seg: list[str], body):
        """Reference routes (handlers_backup.go):
        POST /v1/backups/{backend}            start backup
        GET  /v1/backups/{backend}/{id}       backup status
        POST /v1/backups/{backend}/{id}/restore    start restore
        GET  /v1/backups/{backend}/{id}/restore    restore status
        """
        from weaviate_tpu_torch.backup import BackupError
        from weaviate_tpu_torch.modules.base import ModuleError

        if self.backup_manager is None:
            raise ApiError(422, "backups require a module provider")
        if method == "POST" and len(seg) == 1:
            from weaviate_tpu_torch.api.validation import BACKUP, validate_body

            validate_body(BACKUP, body or {}, "backup")
        try:
            if len(seg) == 1 and method == "POST":
                b = body or {}
                return 200, self.backup_manager.start_backup(
                    seg[0], b.get("id", ""), include=b.get("include"),
                    exclude=b.get("exclude"))
            if len(seg) == 2 and method == "GET":
                return 200, self.backup_manager.backup_status(seg[0], seg[1])
            if len(seg) == 3 and seg[2] == "restore":
                if method == "POST":
                    b = body or {}
                    return 200, self.backup_manager.start_restore(
                        seg[0], seg[1], include=b.get("include"),
                        exclude=b.get("exclude"))
                if method == "GET":
                    return 200, self.backup_manager.restore_status(
                        seg[0], seg[1])
        except (BackupError, ModuleError) as e:
            raise ApiError(422, str(e))
        raise KeyError("/v1/backups/" + "/".join(seg))

    def _debug(self, seg: list[str], params: dict):
        """The /v1/debug surface. ``GET /v1/debug`` is the index: every
        endpoint in :data:`DEBUG_ENDPOINTS` with a one-line description
        (the same table this dispatcher routes by, so listing and
        serving cannot drift apart)."""
        if not seg:
            return 200, {"endpoints": [
                {"path": f"/v1/debug/{name}", "description": desc}
                for name, desc in sorted(DEBUG_ENDPOINTS.items())]}
        name = seg[0]
        if seg[1:] or name not in DEBUG_ENDPOINTS:
            raise KeyError("/v1/debug/" + "/".join(seg))
        if name == "memory":
            return 200, self._debug_memory()
        if name == "storage":
            return 200, self._debug_storage()
        if name == "replication":
            return 200, self._debug_replication()
        if name == "perf":
            # last benchkeeper gate verdict + per-section trend deltas
            # (tools/benchkeeper persists the artifact; perfgate loads
            # it and republishes the weaviate_tpu_bench_* gauges)
            from weaviate_tpu_torch.runtime import perfgate

            return 200, perfgate.snapshot()
        if name == "slo":
            # objectives + sliding-window burn rates (refreshes the
            # weaviate_tpu_slo_burn_rate gauges + incident sweep)
            return 200, tailboard.debug_slo()
        if name == "flight":
            # dispatch-record ring + structured slowlog + snapshots
            return 200, tailboard.debug_flight()
        if name == "kernelscope":
            # device-time truth plane: compiled-variant residency
            # EWMAs, memcpy model, per-tenant meters, capture index
            from weaviate_tpu_torch.runtime import kernelscope

            return 200, kernelscope.snapshot()
        if name == "drift":
            # online drift plane: gate verdict + findings + canary and
            # live-telemetry trends (runtime/driftwatch.py)
            from weaviate_tpu_torch.runtime import driftwatch

            return 200, driftwatch.snapshot()
        if name == "profile":
            # paramless: cheap — list persisted captures only. A
            # capture is an explicit ?ms=N opt-in (the paramless form
            # is exercised by the debug-index round-trip test and must
            # never spin the profiler).
            from weaviate_tpu_torch.runtime import kernelscope

            if "id" in params:
                cap = kernelscope.load_capture(params["id"])
                if cap is None:
                    raise KeyError("/v1/debug/profile?id=" + params["id"])
                return 200, cap
            if "ms" in params:
                try:
                    ms = int(params["ms"])
                except ValueError:
                    raise ApiError(422, "ms must be an integer")
                if not 0 < ms <= 10_000:
                    raise ApiError(422, "ms must be in (0, 10000]")
                return 200, kernelscope.capture_profile(ms)
            return 200, {"captures": kernelscope.list_captures()}
        # traces: the finished-trace ring (tracing tentpole; sampled
        # traces carry device_ms attribution), or — ?tail=true — the
        # tail-retained ring the keep-at-completion decision feeds
        try:
            limit = int(params.get("limit", 50))
        except ValueError:
            raise ApiError(422, "limit must be an integer")
        if params.get("tail") == "true":
            return 200, {"traces": tailboard.tail_traces(limit)}
        return 200, {"traces": tracing.recent_traces(limit)}

    def _debug_memory(self) -> dict:
        """GET /v1/debug/memory: the HBM ledger's labeled breakdown —
        top allocations, per-collection rollup, and (when the backend
        exposes allocator stats) the allocator-vs-ledger delta. The
        ledger counts labeled data arrays only; the delta is
        executables beyond the estimate, replication overhead, and XLA
        scratch."""
        from weaviate_tpu_torch.runtime.hbm_ledger import ledger
        from weaviate_tpu_torch.runtime.memwatch import device_memory_stats

        from weaviate_tpu_torch.parallel.mesh import host_count

        snap = ledger.snapshot()
        # per-MESH-HOST device bytes (hierarchical sharding attribution)
        # — distinct from each collection's host-RAM-tier "hostBytes"
        snap["hbmHostBytes"] = ledger.host_rollup(
            host_count(getattr(self.db, "mesh", None)))
        mw = getattr(self.db, "memwatch", None)
        budget = mw.device_budget() if mw is not None else None
        out = {
            "ledger": {**snap, "budgetBytes": budget},
            "allocator": device_memory_stats(),
        }
        if mw is not None:
            out["pressure"] = mw.under_pressure
            out["highWatermark"] = mw.high_watermark
            out["lowWatermark"] = mw.low_watermark
        deltas = {}
        for dev, stats in out["allocator"].items():
            if stats.get("bytesInUse") is not None:
                deltas[dev] = int(stats["bytesInUse"]) - snap["totalBytes"]
        if deltas:
            out["allocatorDelta"] = deltas
        return out

    def _debug_storage(self) -> dict:
        """GET /v1/debug/storage: per-bucket crash-recovery reports
        (frames replayed, torn-tail bytes truncated, WALs/segments
        quarantined, segments recovered) filed at every bucket open,
        plus the effective durability config. The crashtest harness
        (tools/crashtest) asserts a non-empty report here after every
        kill-restart cycle; the same registry feeds the
        weaviate_tpu_recovery_* counters."""
        from weaviate_tpu_torch.storage import recovery

        out = recovery.snapshot()
        out["config"] = {
            "syncWal": bool(getattr(self.db, "sync_wal", False)),
            # the raft bucket ignores syncWal — pinned durable
            "raftBucketPinnedSync": self.node is not None,
        }
        return out

    def _debug_replication(self) -> dict:
        """GET /v1/debug/replication: anti-entropy convergence state —
        per-shard last-beat age, rounds run, entries reconciled, last
        diff size and divergence estimate, plus read-path divergence
        observations, the staged 2PC entries and any armed partition
        topology. The same registry feeds
        weaviate_tpu_hashbeat_rounds_total and
        weaviate_tpu_replica_divergent_entries."""
        from weaviate_tpu_torch.replication.hashbeater import (
            replication_status)
        from weaviate_tpu_torch.runtime import faultline as _faultline

        out = replication_status.snapshot()
        # staged-2PC visibility: live (un-committed, un-aborted) entries
        # per loaded shard and how many the TTL path expired
        staged = {}
        for cname in self.db.list_collections():
            col = self.db.get_collection(cname)
            with col._lock:
                items = sorted(col.shards.items())
            for sname, shard in items:
                st = shard.staged_status()
                if st["staged"] or st["expired_total"]:
                    staged[f"{cname}/{sname}"] = st
        out["staged"] = staged
        topo = _faultline.topology_snapshot()
        if topo:
            out["partitions"] = topo  # armed topology faults (chaos runs)
        return out

    def _local_shard_details(self) -> list[dict]:
        """Per-shard breakdown for ?output=verbose (reference:
        nodes/handler.go verbose output with shard object counts), plus
        each shard's ledger-attributed device bytes."""
        from weaviate_tpu_torch.runtime.hbm_ledger import ledger

        out = []
        for cname in self.db.list_collections():
            col = self.db.get_collection(cname)
            with col._lock:  # writers load shards concurrently
                items = sorted(col.shards.items())
            for sname, shard in items:
                out.append({
                    "name": sname, "class": cname,
                    "objectCount": shard.object_count(),
                    "vectorIndexingStatus": "READONLY"
                    if shard.read_only else "READY",
                    "vectorQueueLength": sum(
                        q.size() for q in shard._index_queues.values()),
                    "hbmBytes": ledger.shard_bytes(cname, sname),
                })
        return out

    def _nodes_payload(self, verbose: bool = False) -> list[dict]:
        if self.node is not None:
            infos = self.node.membership.nodes()
            # gossip states → the reference's node-status vocabulary
            # (entities/models.NodeStatus: HEALTHY/UNHEALTHY/UNAVAILABLE)
            status_map = {"alive": "HEALTHY", "suspect": "UNHEALTHY",
                          "dead": "UNAVAILABLE", "left": "UNAVAILABLE"}
            nodes = [{
                "name": i.name,
                "status": status_map.get(i.status.lower(),
                                         i.status.upper()),
                "version": VERSION,
                "stats": i.meta,
            } for i in sorted(infos.values(), key=lambda x: x.name)]
            from weaviate_tpu_torch.runtime.memwatch import (
                device_memory_stats,
            )

            from weaviate_tpu_torch.runtime.hbm_ledger import ledger

            from weaviate_tpu_torch.parallel.mesh import host_count

            local_health = degrade.health()
            for n in nodes:
                if n["name"] == self.db.local_node:
                    n["stats"] = {**(n.get("stats") or {}),
                                  "deviceMemory": device_memory_stats(),
                                  "hbmLedgerBytes": ledger.total_bytes(),
                                  # per-mesh-host rollup (sums to
                                  # hbmLedgerBytes — ROADMAP item 2)
                                  "hbmHostBytes": ledger.host_rollup(
                                      host_count(self.db.mesh))}
                    # component health (degrade registry): a faulted
                    # batcher/native-plane dispatch path flips this
                    n["health"] = local_health
                    if not local_health["healthy"]:
                        n["status"] = "UNHEALTHY"
                    if verbose:
                        # shard details are known for THIS node (remote
                        # breakdowns would need an RPC fan-out, as in the
                        # reference)
                        n["shards"] = self._local_shard_details()
            return nodes
        shard_count = sum(len(c.shards) for c in self.db.collections.values())
        object_count = sum(
            s.object_count() for c in self.db.collections.values()
            for s in c.shards.values())
        from weaviate_tpu_torch.parallel.mesh import host_count
        from weaviate_tpu_torch.runtime.hbm_ledger import ledger
        from weaviate_tpu_torch.runtime.memwatch import device_memory_stats

        local_health = degrade.health()
        node = {"name": self.db.local_node,
                "status": "HEALTHY" if local_health["healthy"]
                else "UNHEALTHY",
                "version": VERSION,
                "health": local_health,
                "stats": {"shardCount": shard_count,
                          "objectCount": object_count,
                          "deviceMemory": device_memory_stats(),
                          "hbmLedgerBytes": ledger.total_bytes(),
                          "hbmHostBytes": ledger.host_rollup(
                              host_count(self.db.mesh))}}
        if verbose:
            node["shards"] = self._local_shard_details()
        return [node]

    # -- /v1/schema -----------------------------------------------------------

    def _schema(self, method: str, seg: list[str], body):
        if not seg:
            if method == "GET":
                return 200, {"classes": [
                    class_to_wire(self.db.get_collection(n).config)
                    for n in self.db.list_collections()]}
            if method == "POST":
                from weaviate_tpu_torch.api.validation import (SCHEMA_CLASS,
                                                         validate_body)

                validate_body(SCHEMA_CLASS, body or {}, "class")
                cfg = config_from_json(body or {})
                self.schema_target.create_collection(cfg)
                return 200, class_to_wire(cfg)
        elif len(seg) == 1:
            name = seg[0]
            if method == "GET":
                return 200, class_to_wire(self.db.get_collection(name).config)
            if method == "PUT":
                # update mutable class config (reference: PUT /v1/schema/{c}).
                # PARTIAL update semantics: only sections present in the
                # body overlay the current config — parsing the body alone
                # would fill omitted fields with defaults and silently
                # reset them (e.g. replication factor back to 1).
                import copy

                d = dict(body or {})
                d.setdefault("class", name)
                parsed = config_from_json(d)
                if parsed.name != name:
                    raise ApiError(422, "class name in body does not match "
                                   "the path")
                merged = copy.deepcopy(
                    self.db.get_collection(name).config)
                if "description" in d:
                    merged.description = parsed.description
                if "invertedIndexConfig" in d or "inverted" in d:
                    merged.inverted = parsed.inverted
                if "replicationConfig" in d or "replication" in d:
                    merged.replication = parsed.replication
                if "moduleConfig" in d or "module_config" in d:
                    merged.module_config = parsed.module_config
                if "multiTenancyConfig" in d or "multi_tenancy" in d:
                    merged.multi_tenancy = parsed.multi_tenancy
                if any(k in d for k in ("vectorizer", "vectorIndexType",
                                        "vectorIndexConfig",
                                        "vectorConfig", "vectors")):
                    merged.vectors = parsed.vectors
                self.schema_target.update_collection(merged)
                return 200, class_to_wire(self.db.get_collection(name).config)
            if method == "DELETE":
                self.schema_target.delete_collection(name)
                return 200, None
        elif len(seg) == 2 and seg[1] == "shards" and method == "GET":
            col = self.db.get_collection(seg[0])
            out = []
            for shard_name in col.sharding.shard_names:
                if not col._is_local(shard_name):
                    out.append({"name": shard_name, "status": "REMOTE",
                                "vectorQueueSize": 0})
                    continue
                if col.sharding.status_of(shard_name) == "COLD":
                    # deactivated tenants stay on disk — loading them for
                    # a status listing would defeat the offload
                    out.append({"name": shard_name, "status": "COLD",
                                "vectorQueueSize": 0})
                    continue
                shard = col._load_shard(shard_name)
                qsize = sum(q.size() for q in shard._index_queues.values())
                out.append({
                    "name": shard_name,
                    "status": "READONLY" if shard.read_only else "READY",
                    "vectorQueueSize": qsize,
                })
            return 200, out
        elif len(seg) == 3 and seg[1] == "shards" and method == "PUT":
            col = self.db.get_collection(seg[0])
            status = (body or {}).get("status", "").upper()
            if status not in ("READY", "READONLY"):
                raise ApiError(422, "shard status must be READY or READONLY")
            if seg[2] not in col.sharding.shard_names or \
                    not col._is_local(seg[2]):
                raise ApiError(404, f"shard {seg[2]!r} is not local")
            if col.sharding.status_of(seg[2]) == "COLD":
                raise ApiError(422, f"tenant shard {seg[2]!r} is COLD; "
                               "activate it before changing shard status")
            col._load_shard(seg[2]).set_read_only(status == "READONLY")
            return 200, {"status": status}
        elif len(seg) == 2 and seg[1] == "properties" and method == "POST":
            prop = property_from_json(body or {})
            self.schema_target.add_property(seg[0], prop)
            return 200, body
        elif len(seg) == 2 and seg[1] == "tenants":
            name = seg[0]
            col = self.db.get_collection(name)
            if method == "GET":
                return 200, [
                    {"name": t,
                     "activityStatus": col.sharding.status_of(t)}
                    for t in col.tenants()]
            if method == "PUT":
                # HOT/COLD offload (reference: PUT tenants with
                # activityStatus)
                tenants = [t if isinstance(t, dict) else {"name": t}
                           for t in (body or [])]
                self.schema_target.update_tenant_status(name, tenants)
                return 200, [
                    {"name": t["name"],
                     "activityStatus": col.sharding.status_of(t["name"])}
                    for t in tenants]
            tenants = [t["name"] if isinstance(t, dict) else t
                       for t in (body or [])]
            if method == "POST":
                self.schema_target.add_tenants(name, tenants)
                return 200, [{"name": t} for t in tenants]
            if method == "DELETE":
                self.schema_target.remove_tenants(name, tenants)
                return 200, None
        raise KeyError("/v1/schema/" + "/".join(seg))

    # -- /v1/objects ----------------------------------------------------------

    def _objects(self, method: str, seg: list[str], params: dict, body):
        tenant = params.get("tenant")
        # collection/tenant identity for the always-on phase histograms
        # (label values pass the tailboard's top-K cardinality guard)
        if len(seg) >= 2 and seg[0] != "validate":
            tailboard.annotate(collection=seg[0], tenant=tenant)
        elif tenant:
            tailboard.annotate(tenant=tenant)
        if not seg:
            if method == "GET":
                return self._list_objects(params)
            if method == "POST":
                return self._put_object(body or {}, tenant)
        elif len(seg) == 1 and seg[0] != "validate":
            # deprecated class-less route (reference: /v1/objects/{id}
            # scans classes; kept for old clients)
            uuid = seg[0]
            consistency = params.get("consistency_level")
            for cname in self.db.list_collections():
                col = self.db.get_collection(cname)
                if col.config.multi_tenancy.enabled:
                    continue  # tenant-less lookup cannot address MT data
                try:
                    obj = col.get_object(uuid, consistency=consistency)
                except Exception:
                    # one unhealthy, unrelated class must not break the
                    # scan for an object living elsewhere
                    continue
                if obj is None:
                    continue
                # resolve the class, delegate to the modern class-scoped
                # handler so consistency/result semantics stay identical
                return self._objects(method, [cname, uuid], params, body)
            raise ApiError(404, f"object {uuid} not found in any class")
        elif seg == ["validate"] and method == "POST":
            # dry-run validation (reference: POST /v1/objects/validate)
            b = dict(body or {})
            cls = b.get("class", "")
            col = self.db.get_collection(cls)
            props = b.get("properties") or {}
            for key in props:
                if col.config.property(key) is None:
                    raise ApiError(422, f"property {key!r} is not part of "
                                   f"class {cls}")
            vec = b.get("vector")
            if vec is not None and not isinstance(vec, list):
                raise ApiError(422, "vector must be a number array")
            return 200, None
        elif len(seg) == 4 and seg[2] == "references":
            return self._references(method, seg[0], seg[1], seg[3], body,
                                    tenant)
        elif len(seg) == 2:
            class_name, uuid = seg
            col = self.db.get_collection(class_name)
            if method in ("GET", "HEAD"):
                consistency = params.get("consistency_level")
                obj = col.get_object(uuid, tenant=tenant,
                                     consistency=consistency)
                if obj is None:
                    raise ApiError(404, f"object {uuid} not found")
                return 200, object_to_json(class_name, obj, tenant=tenant)
            if method in ("PUT", "PATCH"):
                body = dict(body or {})
                body.setdefault("class", class_name)
                body["id"] = uuid
                if method == "PATCH":
                    # merge is a read-modify-write: serialize against
                    # concurrent reference appends / PATCHes of the same
                    # object (same per-uuid lock as _references)
                    with col.uuid_lock(uuid):
                        return self._patch_merge(col, uuid, body, tenant)
                return self._put_object(body, tenant)
            if method == "DELETE":
                deleted = col.delete_object(
                    uuid, tenant=tenant,
                    consistency=params.get("consistency_level", "QUORUM"))
                if not deleted:
                    raise ApiError(404, f"object {uuid} not found")
                return 204, None
        raise KeyError("/v1/objects/" + "/".join(seg))

    def _put_object(self, body: dict, tenant: str | None):
        from weaviate_tpu_torch.api.validation import OBJECT, validate_body

        validate_body(OBJECT, body or {}, "object")
        class_name = body.get("class") or body.get("collection")
        if not class_name:
            raise ApiError(422, "object is missing a class")
        tailboard.annotate(collection=class_name,
                           tenant=tenant or body.get("tenant"))
        col = self.db.get_collection(class_name)
        spec = {"properties": body.get("properties", {}),
                "vector": body.get("vector"), "vectors": body.get("vectors")}
        if self.modules is not None:
            self.modules.vectorize_batch(col.config, [spec])
        uuid = col.put_object(
            spec["properties"],
            vector=spec.get("vector"),
            vectors=spec.get("vectors"),
            uuid=body.get("id"),
            tenant=tenant or body.get("tenant"),
            creation_time_ms=int(body.get("creationTimeUnix") or 0),
        )
        eff_tenant = tenant or body.get("tenant")
        obj = col.get_object(uuid, tenant=eff_tenant)
        return 200, object_to_json(class_name, obj, tenant=eff_tenant)

    def _list_objects(self, params: dict):
        class_name = params.get("class")
        if not class_name:
            raise ApiError(422, "listing requires ?class=")
        col = self.db.get_collection(class_name)
        limit = int(params.get("limit", 25))
        offset = int(params.get("offset", 0))
        sort = None
        if params.get("sort"):
            orders = (params.get("order") or "asc").split(",")
            paths = params["sort"].split(",")
            sort = [{"path": p, "order": orders[min(i, len(orders) - 1)]}
                    for i, p in enumerate(paths)]
        where = None
        if params.get("where"):
            where = Filter.from_dict(json.loads(params["where"]))
        objs = col.fetch_objects(limit=limit, offset=offset, sort=sort,
                                 where=where, tenant=params.get("tenant"),
                                 after=params.get("after"))
        return 200, {
            "objects": [object_to_json(class_name, o,
                                       tenant=params.get("tenant"))
                        for o in objs],
            "totalResults": len(objs),
        }

    # -- /v1/batch/objects -----------------------------------------------------

    def _batch_objects(self, body: dict):
        from weaviate_tpu_torch.api.validation import (BATCH_OBJECTS,
                                                 validate_body)

        validate_body(BATCH_OBJECTS, body or {}, "batch")
        objects = body.get("objects", [])
        # group by (class, tenant): one batch_put call writes to exactly one
        # tenant — grouping by class alone would land cross-tenant objects
        # in the first entry's tenant
        by_target: dict[tuple[str, str | None], list[tuple[int, dict]]] = {}
        for i, spec in enumerate(objects):
            cname = spec.get("class") or spec.get("collection") or ""
            by_target.setdefault((cname, spec.get("tenant")), []).append((i, spec))
        results: list[dict | None] = [None] * len(objects)
        for (cname, tenant), entries in by_target.items():
            try:
                col = self.db.get_collection(cname)
            except KeyError as e:
                for i, spec in entries:
                    results[i] = {"id": spec.get("id"), "result": {
                        "status": "FAILED", "errors": {"error": [
                            {"message": str(e)}]}}}
                continue
            specs = [{
                "uuid": spec.get("id"),
                "properties": spec.get("properties", {}),
                "vector": spec.get("vector"),
                "vectors": spec.get("vectors"),
            } for _i, spec in entries]
            if self.modules is not None:
                try:
                    self.modules.vectorize_batch(col.config, specs)
                except Exception as exc:  # per-object errors, not whole-batch
                    from weaviate_tpu_torch.modules.provider import needs_vector

                    kept_entries, kept_specs = [], []
                    for (i, spec_body), spec in zip(entries, specs):
                        if needs_vector(col.config, spec):
                            results[i] = {"id": spec.get("uuid"), "result": {
                                "status": "FAILED", "errors": {"error": [
                                    {"message": f"vectorize: {exc}"}]}}}
                        else:
                            kept_entries.append((i, spec_body))
                            kept_specs.append(spec)
                    entries, specs = kept_entries, kept_specs
            outcomes = col.batch_put(specs, tenant=tenant)
            for (i, _spec), out in zip(entries, outcomes):
                if out["status"] == "SUCCESS":
                    results[i] = {"id": out["uuid"],
                                  "result": {"status": "SUCCESS"}}
                else:
                    results[i] = {"id": out.get("uuid"), "result": {
                        "status": "FAILED", "errors": {"error": [
                            {"message": out.get("error", "")}]}}}
        return 200, results


