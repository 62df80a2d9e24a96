"""gRPC v1 service implementation.

Reference: adapters/handlers/grpc/v1/service.go (Search :173, BatchObjects
:126), parse_search_request.go (proto -> search params), prepare_reply.go
(results -> proto). One unary-unary handler per RPC; request parsing and
reply marshalling live next to each other per RPC, mirroring the
reference's parse/prepare split.
"""

from __future__ import annotations

import logging
import time
import uuid as _uuid
from concurrent.futures import ThreadPoolExecutor

import grpc
import numpy as np
from google.protobuf import json_format

from weaviate_tpu_torch.api.grpc import v1_pb2 as pb
from weaviate_tpu_torch.filters.filters import Filter, Operator
from weaviate_tpu_torch.schema.config import DataType

logger = logging.getLogger(__name__)

_SERVICE = "weaviate.v1.Weaviate"

_CONSISTENCY = {
    pb.CONSISTENCY_LEVEL_UNSPECIFIED: "QUORUM",
    pb.CONSISTENCY_LEVEL_ONE: "ONE",
    pb.CONSISTENCY_LEVEL_QUORUM: "QUORUM",
    pb.CONSISTENCY_LEVEL_ALL: "ALL",
}

_OPERATORS = {
    pb.Filters.OPERATOR_EQUAL: Operator.EQUAL,
    pb.Filters.OPERATOR_NOT_EQUAL: Operator.NOT_EQUAL,
    pb.Filters.OPERATOR_GREATER_THAN: Operator.GREATER_THAN,
    pb.Filters.OPERATOR_GREATER_THAN_EQUAL: Operator.GREATER_THAN_EQUAL,
    pb.Filters.OPERATOR_LESS_THAN: Operator.LESS_THAN,
    pb.Filters.OPERATOR_LESS_THAN_EQUAL: Operator.LESS_THAN_EQUAL,
    pb.Filters.OPERATOR_AND: Operator.AND,
    pb.Filters.OPERATOR_OR: Operator.OR,
    pb.Filters.OPERATOR_WITHIN_GEO_RANGE: Operator.WITHIN_GEO_RANGE,
    pb.Filters.OPERATOR_LIKE: Operator.LIKE,
    pb.Filters.OPERATOR_IS_NULL: Operator.IS_NULL,
    pb.Filters.OPERATOR_CONTAINS_ANY: Operator.CONTAINS_ANY,
    pb.Filters.OPERATOR_CONTAINS_ALL: Operator.CONTAINS_ALL,
}


class ApiError(Exception):
    def __init__(self, code: grpc.StatusCode, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


# ---------------------------------------------------------------------------
# request parsing (reference: v1/parse_search_request.go)
# ---------------------------------------------------------------------------

def _vector_from(vector_bytes: bytes, vector_floats) -> np.ndarray | None:
    if vector_bytes:
        return np.frombuffer(vector_bytes, dtype="<f4").astype(np.float32)
    if len(vector_floats):
        return np.asarray(list(vector_floats), dtype=np.float32)
    return None


def filters_from_pb(f: "pb.Filters") -> Filter:
    op = _OPERATORS.get(f.operator)
    if op is None:
        raise ApiError(grpc.StatusCode.INVALID_ARGUMENT,
                       f"unknown filter operator {f.operator}")
    if op in (Operator.AND, Operator.OR):
        return Filter(op, operands=[filters_from_pb(c) for c in f.filters])
    # target path: new-style FilterTarget.property, else legacy 'on'
    path: list[str] | None = None
    which = f.target.WhichOneof("target")
    if which == "property":
        path = [f.target.property]
    elif which in ("single_target", "multi_target"):
        tgt = getattr(f.target, which)
        sub = tgt.target.WhichOneof("target")
        path = [tgt.on] + ([tgt.target.property] if sub == "property" else [])
    elif which == "count":
        path = [f.target.count.on]
    elif len(f.on):
        path = list(f.on)
    value_field = f.WhichOneof("test_value")
    value = None
    if value_field is not None:
        raw = getattr(f, value_field)
        if value_field in ("value_text_array", "value_int_array",
                          "value_boolean_array", "value_number_array"):
            value = list(raw.values)
        elif value_field == "value_geo":
            value = {"geoCoordinates": {"latitude": raw.latitude,
                                        "longitude": raw.longitude},
                     "distance": {"max": raw.distance}}
        else:
            value = raw
    return Filter(op, path=path, value=value)


def _struct_to_dict(s) -> dict:
    """google.protobuf.Struct -> dict, MessageToDict-compatible (numbers
    stay floats — Struct is JSON-typed) at ~1/10 the cost; this runs once
    per imported object on the gRPC hot path."""
    out = {}
    for k, v in s.fields.items():
        kind = v.WhichOneof("kind")
        if kind == "string_value":
            out[k] = v.string_value
        elif kind == "number_value":
            out[k] = v.number_value
        elif kind == "bool_value":
            out[k] = v.bool_value
        elif kind == "struct_value":
            out[k] = _struct_to_dict(v.struct_value)
        elif kind == "list_value":
            out[k] = [
                (_struct_to_dict(e.struct_value)
                 if e.WhichOneof("kind") == "struct_value"
                 else json_format.MessageToDict(e))
                for e in v.list_value.values]
        else:  # null_value / unset
            out[k] = None
    return out


def _props_from_batch_object(bo: "pb.BatchObject") -> dict:
    """Flatten the typed batch property payload back into a plain dict
    (the reference re-assembles models.Object the same way,
    v1/batch_parse_request.go). Iterates only the SET fields — walking
    all ten repeated-array fields per object cost ~10 µs each on the
    import hot path."""
    p = bo.properties
    props: dict = {}
    refs: list = []  # applied LAST — pre-rewrite precedence: a prop name
    # set both as a ref and as an array resolves to the ref beacons
    for fd, val in p.ListFields():
        name = fd.name
        if name == "non_ref_properties":
            props.update(_struct_to_dict(val))
        elif name == "number_array_properties":
            for arr in val:
                props[arr.prop_name] = (
                    list(np.frombuffer(arr.values_bytes, dtype="<f8"))
                    if arr.values_bytes else list(arr.values))
        elif name in ("int_array_properties", "text_array_properties",
                      "boolean_array_properties"):
            for arr in val:
                props[arr.prop_name] = list(arr.values)
        elif name == "object_properties":
            for obj in val:
                props[obj.prop_name] = _object_value_to_dict(obj.value)
        elif name == "object_array_properties":
            for arr in val:
                props[arr.prop_name] = [
                    _object_value_to_dict(v) for v in arr.values]
        elif name == "empty_list_props":
            for nm in val:
                props[nm] = []
        elif name == "single_target_ref_props":
            for ref in val:
                refs.append((ref.prop_name, [
                    {"beacon": f"weaviate://localhost/{u}"}
                    for u in ref.uuids]))
        elif name == "multi_target_ref_props":
            for ref in val:
                refs.append((ref.prop_name, [
                    {"beacon":
                     f"weaviate://localhost/{ref.target_collection}/{u}"}
                    for u in ref.uuids]))
    for name, beacons in refs:
        props[name] = beacons
    return props


def _object_value_to_dict(val: "pb.ObjectPropertiesValue") -> dict:
    out = json_format.MessageToDict(val.non_ref_properties)
    for arr in val.number_array_properties:
        out[arr.prop_name] = (
            list(np.frombuffer(arr.values_bytes, dtype="<f8"))
            if arr.values_bytes else list(arr.values))
    for arr in val.int_array_properties:
        out[arr.prop_name] = list(arr.values)
    for arr in val.text_array_properties:
        out[arr.prop_name] = list(arr.values)
    for arr in val.boolean_array_properties:
        out[arr.prop_name] = list(arr.values)
    for obj in val.object_properties:
        out[obj.prop_name] = _object_value_to_dict(obj.value)
    for arr in val.object_array_properties:
        out[arr.prop_name] = [_object_value_to_dict(v) for v in arr.values]
    for name in val.empty_list_props:
        out[name] = []
    return out


# ---------------------------------------------------------------------------
# reply marshalling (reference: v1/prepare_reply.go, mapping.go)
# ---------------------------------------------------------------------------

def _to_value(x, dtype: str | None) -> "pb.Value":
    v = pb.Value()
    if x is None:
        v.null_value = 0
        return v
    if isinstance(x, bool):
        v.bool_value = x
        return v
    if isinstance(x, (int, float, np.integer, np.floating)) \
            and dtype == DataType.INT:
        # Struct-borne numbers are f64; the schema says this one is an int
        v.int_value = int(x)
        return v
    if isinstance(x, (int, float, np.floating, np.integer)):
        if dtype == DataType.DATE:
            v.date_value = str(x)
        else:
            v.number_value = float(x)
        return v
    if isinstance(x, str):
        if dtype == DataType.DATE:
            v.date_value = x
        elif dtype == DataType.UUID:
            v.uuid_value = x
        elif dtype == DataType.BLOB:
            v.blob_value = x
        else:
            v.text_value = x
        return v
    if isinstance(x, dict):
        if "latitude" in x and "longitude" in x:
            v.geo_value.latitude = float(x["latitude"])
            v.geo_value.longitude = float(x["longitude"])
            return v
        for key, sub in x.items():
            v.object_value.fields[key].CopyFrom(_to_value(sub, None))
        return v
    if isinstance(x, (list, tuple, np.ndarray)):
        lv = v.list_value
        seq = list(x)
        if not seq:
            lv.text_values.SetInParent()
        elif all(isinstance(e, bool) for e in seq):
            lv.bool_values.values.extend(seq)
        elif dtype == DataType.INT_ARRAY or all(
                isinstance(e, (int, np.integer)) and not isinstance(e, bool)
                for e in seq):
            lv.int_values.values = np.asarray(seq, dtype="<i8").tobytes()
        elif all(isinstance(e, (int, float, np.floating, np.integer))
                 for e in seq):
            lv.number_values.values = np.asarray(seq, dtype="<f8").tobytes()
        elif dtype == DataType.DATE_ARRAY:
            lv.date_values.values.extend(str(e) for e in seq)
        elif dtype == DataType.UUID_ARRAY:
            lv.uuid_values.values.extend(str(e) for e in seq)
        elif all(isinstance(e, dict) for e in seq):
            for e in seq:
                props = lv.object_values.values.add()
                for key, sub in e.items():
                    props.fields[key].CopyFrom(_to_value(sub, None))
        else:
            lv.text_values.values.extend(str(e) for e in seq)
        return v
    v.text_value = str(x)
    return v


def _f32_bytes(vec) -> bytes:
    return np.asarray(vec, dtype="<f4").tobytes()


class GrpcServer:
    """``db``: node-local Database (or anything exposing get_collection).
    ``modules``: optional module Provider for nearText / generative /
    rerank (usecases/modules analog)."""

    def __init__(self, db, host: str = "127.0.0.1", port: int = 0,
                 modules=None, auth=None, max_workers: int | None = None):
        # 64 workers: handlers mostly BLOCK on the query batcher's device
        # dispatch, so the pool bounds how many queries can coalesce into
        # one batch — 16 capped measured batch sizes at ~8 under 32
        # concurrent streams (GRPC_MAX_WORKERS overrides)
        self.db = db
        self.modules = modules
        self.auth = auth
        if max_workers is None:
            import os

            max_workers = int(os.environ.get("GRPC_MAX_WORKERS", "64"))
        self._max_workers = max_workers
        handlers = {
            "Search": self._search,
            "BatchObjects": self._batch_objects,
            "BatchDelete": self._batch_delete,
            "TenantsGet": self._tenants_get,
        }
        req_types = {
            "Search": pb.SearchRequest,
            "BatchObjects": pb.BatchObjectsRequest,
            "BatchDelete": pb.BatchDeleteRequest,
            "TenantsGet": pb.TenantsGetRequest,
        }
        verbs = {"Search": "read", "TenantsGet": "read",
                 "BatchObjects": "write", "BatchDelete": "write"}
        method_handlers = {}
        for name, fn in handlers.items():
            method_handlers[name] = grpc.unary_unary_rpc_method_handler(
                self._wrap(fn, verbs[name], name),
                request_deserializer=req_types[name].FromString,
                response_serializer=lambda resp: resp.SerializeToString(),
            )
        self._server = grpc.server(ThreadPoolExecutor(max_workers=self._max_workers))
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, method_handlers),))
        # grpc.health.v1.Health/Check — the official v4 client health-checks
        # the channel during connect() and refuses the server without it
        # (reference wires grpc-health-probe the same way). The wire format
        # is tiny (HealthCheckResponse{status: SERVING} = 0x08 0x01), so the
        # handler is hand-rolled rather than depending on
        # grpcio-health-checking (not in the image).
        health_handlers = {
            "Check": grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: b"\x08\x01",
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b,
            ),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(
                "grpc.health.v1.Health", health_handlers),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.host = host

    def start(self):
        self._server.start()
        return self

    def stop(self, grace: float = 0.5):
        self._server.stop(grace)

    # -- plumbing -----------------------------------------------------------

    @staticmethod
    def _grpc_http_status(code) -> int:
        """gRPC status -> HTTP-ish status for the tailboard's SLO/tail
        accounting (>=500 counts against availability). Client-caused
        codes must land BELOW 500 — UNIMPLEMENTED (nearText without a
        vectorizer module) and FAILED_PRECONDITION (tenant ops on a
        non-MT collection) are request mistakes, not server failures,
        and a stream of them must not page the availability SLO."""
        try:
            return {
                grpc.StatusCode.UNAUTHENTICATED: 401,
                grpc.StatusCode.PERMISSION_DENIED: 403,
                grpc.StatusCode.NOT_FOUND: 404,
                grpc.StatusCode.ALREADY_EXISTS: 409,
                grpc.StatusCode.ABORTED: 409,
                grpc.StatusCode.INVALID_ARGUMENT: 422,
                grpc.StatusCode.OUT_OF_RANGE: 422,
                grpc.StatusCode.FAILED_PRECONDITION: 422,
                grpc.StatusCode.UNIMPLEMENTED: 422,
                grpc.StatusCode.CANCELLED: 499,
                grpc.StatusCode.RESOURCE_EXHAUSTED: 503,
                grpc.StatusCode.UNAVAILABLE: 503,
                grpc.StatusCode.DEADLINE_EXCEEDED: 504,
            }.get(code, 500)
        except TypeError:  # unhashable stub in tests
            return 500

    def _wrap(self, fn, verb: str = "write", rpc_name: str = "rpc"):
        from weaviate_tpu_torch.runtime import tracing

        def handler(request, context):
            # request root trace; clients force device-time sampling by
            # sending an "x-trace: true" metadata key (the gRPC analog
            # of the REST ?trace=true param)
            try:
                md = dict(context.invocation_metadata() or [])
            except Exception:  # noqa: BLE001 — tests stub the context
                md = {}
            force = md.get("x-trace") == "true"
            # "x-explain: true" metadata is the gRPC analog of the REST
            # ?explain=true param: the structured query plan rides back
            # as trailing metadata (protos carry no spare field for it)
            explain = md.get("x-explain") == "true"
            # adopt the client's gRPC deadline as this request's budget:
            # the contextvar propagates it down through the batcher,
            # shard fan-out and every transport call
            from weaviate_tpu_torch.cluster.transport import CircuitOpenError
            from weaviate_tpu_torch.runtime import retry

            budget = None
            expired = False
            try:
                rem = context.time_remaining()
                # no-deadline clients surface as None OR as a huge
                # sentinel (grpc reports ~infinity); adopting that
                # would overflow downstream waits — treat it as "no
                # budget". A deadline that ALREADY elapsed in transit
                # must abort now, not run the full search for a client
                # gRPC has cancelled.
                if rem is not None:
                    if rem <= 0:
                        expired = True
                    elif rem < 86400.0 * 365:
                        budget = rem
            except Exception:  # noqa: BLE001 — tests stub the context
                pass
            if expired:
                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                              "deadline expired before handling began")
            from weaviate_tpu_torch.runtime import tailboard

            # always-on timeline (tailboard): the rpc name is the
            # operation label; complete() runs BEFORE each abort (abort
            # raises) so the tail keep/drop decision sees the status
            with tailboard.request(f"grpc.{rpc_name.lower()}"):
                try:
                    # auth precedes the trace: rejected clients must not
                    # be able to fill the debug-trace ring
                    self._check_auth(context, verb)
                    from weaviate_tpu_torch.runtime import degrade

                    with tracing.trace(f"grpc.{rpc_name}", force=force), \
                            retry.deadline(budget), degrade.collecting():
                        plan = None
                        if explain:
                            from weaviate_tpu_torch.runtime import kernelscope

                            token = kernelscope.explain_begin()
                            try:
                                reply = fn(request, context)
                            finally:
                                plan = kernelscope.explain_end(token)
                        else:
                            reply = fn(request, context)
                        # a degraded (partial) answer must be visible on
                        # the gRPC surface too: marker list rides
                        # trailing metadata (protos carry no spare field
                        # for it). set_trailing_metadata may only be
                        # called once, so degrade markers and the
                        # explain plan share one call.
                        markers = degrade.snapshot()
                        trailers = []
                        if markers:
                            import json as _json

                            trailers.append(
                                ("x-degraded", _json.dumps(markers)))
                        if plan is not None:
                            import json as _json

                            trailers.append(
                                ("x-explain", _json.dumps(plan)))
                        if trailers:
                            try:
                                context.set_trailing_metadata(
                                    tuple(trailers))
                            except Exception:  # noqa: BLE001 — stubbed ctx
                                pass
                        tailboard.complete(200, degraded=bool(markers))
                        return reply
                except ApiError as e:
                    tailboard.complete(self._grpc_http_status(e.code))
                    context.abort(e.code, e.message)
                except KeyError as e:
                    tailboard.complete(404)
                    context.abort(grpc.StatusCode.NOT_FOUND, str(e))
                except ValueError as e:
                    tailboard.complete(422)
                    context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
                except retry.DeadlineExceeded as e:
                    # typed: budget ran out mid-flight — not INTERNAL
                    tailboard.complete(504)
                    context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                                  str(e))
                except (retry.OverloadedError, CircuitOpenError) as e:
                    # retriable overload / open breaker: clients back off
                    tailboard.complete(503)
                    context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
                except Exception as e:  # noqa: BLE001 — INTERNAL
                    logger.exception("grpc handler failed")
                    tailboard.complete(500)
                    context.abort(grpc.StatusCode.INTERNAL, str(e))
        return handler

    def _check_auth(self, context, verb: str):
        """auth interceptor analog (reference: grpc/server.go auth
        interceptor reads the authorization metadata key)."""
        if self.auth is None:
            return
        from weaviate_tpu_torch.auth import AuthError, ForbiddenError

        md = dict(context.invocation_metadata() or [])
        try:
            self.auth.check(md.get("authorization") or None, verb)
        except AuthError as e:
            raise ApiError(grpc.StatusCode.UNAUTHENTICATED, str(e))
        except ForbiddenError as e:
            raise ApiError(grpc.StatusCode.PERMISSION_DENIED, str(e))

    def _collection(self, name: str):
        return self.db.get_collection(name)

    # -- Search (service.go:173) --------------------------------------------

    def _search(self, req: "pb.SearchRequest", context) -> "pb.SearchReply":
        start = time.perf_counter()
        col = self._collection(req.collection)
        tenant = req.tenant or None
        # identity for the always-on phase histograms (tailboard top-K
        # guard clamps the label values)
        from weaviate_tpu_torch.runtime import tailboard

        tailboard.annotate(collection=req.collection, tenant=tenant)
        limit = req.limit or 10
        where = filters_from_pb(req.filters) if req.HasField("filters") else None
        autocut = req.autocut

        search_kind = None
        for field in ("near_vector", "near_object", "near_text", "bm25_search",
                      "hybrid_search", "near_image", "near_audio", "near_video",
                      "near_depth", "near_thermal", "near_imu"):
            if req.HasField(field):
                search_kind = field
                break

        results = None
        fetched_objects = None
        if search_kind == "near_vector":
            nv = req.near_vector
            vec = _vector_from(nv.vector_bytes, nv.vector)
            if vec is None:
                raise ApiError(grpc.StatusCode.INVALID_ARGUMENT,
                               "nearVector requires a vector")
            max_dist = nv.distance if nv.HasField("distance") else (
                2 * (1 - nv.certainty) if nv.HasField("certainty") else None)
            vec_name = nv.target_vectors[0] if nv.target_vectors else ""
            results = col.near_vector(
                vec, k=limit + req.offset, vec_name=vec_name, tenant=tenant,
                where=where, max_distance=max_dist, autocut=autocut)
        elif search_kind == "near_object":
            no = req.near_object
            anchor = col.get_object(no.id, tenant=tenant)
            if anchor is None:
                raise ApiError(grpc.StatusCode.NOT_FOUND,
                               f"nearObject id {no.id} not found")
            vec_name = no.target_vectors[0] if no.target_vectors else ""
            vec = anchor.vectors.get(vec_name)
            if vec is None:
                raise ApiError(grpc.StatusCode.INVALID_ARGUMENT,
                               f"anchor object has no vector {vec_name!r}")
            max_dist = no.distance if no.HasField("distance") else None
            results = col.near_vector(
                vec, k=limit + req.offset, vec_name=vec_name, tenant=tenant,
                where=where, max_distance=max_dist, autocut=autocut)
        elif search_kind == "near_text":
            nt = req.near_text
            vec_name = nt.target_vectors[0] if nt.target_vectors else ""
            vec = self._vectorize_query(col, " ".join(nt.query), nt, vec_name)
            max_dist = nt.distance if nt.HasField("distance") else (
                2 * (1 - nt.certainty) if nt.HasField("certainty") else None)
            results = col.near_vector(
                vec, k=limit + req.offset, vec_name=vec_name, tenant=tenant,
                where=where, max_distance=max_dist, autocut=autocut)
        elif search_kind == "bm25_search":
            results = col.bm25(req.bm25_search.query, k=limit + req.offset,
                               properties=list(req.bm25_search.properties) or None,
                               tenant=tenant, where=where, autocut=autocut)
        elif search_kind == "hybrid_search":
            h = req.hybrid_search
            vec = _vector_from(h.vector_bytes, h.vector)
            vec_name = h.target_vectors[0] if h.target_vectors else ""
            if vec is None and h.HasField("near_vector"):
                vec = _vector_from(h.near_vector.vector_bytes,
                                   h.near_vector.vector)
                # a vector riding in near_vector may name its target
                # there instead of on the Hybrid message
                if not vec_name and h.near_vector.target_vectors:
                    vec_name = h.near_vector.target_vectors[0]
            if vec is None and (h.HasField("near_text") or h.query) \
                    and self._has_vectorizer(col, vec_name):
                nt = h.near_text if h.HasField("near_text") else None
                text = " ".join(nt.query) if nt is not None else h.query
                vec = self._vectorize_query(col, text, nt, vec_name)
            fusion = "rankedFusion" \
                if h.fusion_type == pb.Hybrid.FUSION_TYPE_RANKED \
                else "relativeScore"
            # honor alpha verbatim — clients always send it, and proto3
            # cannot distinguish an explicit 0 (pure BM25) from unset
            results = col.hybrid(h.query, vector=vec, alpha=h.alpha,
                                 k=limit + req.offset,
                                 properties=list(h.properties) or None,
                                 vec_name=vec_name, tenant=tenant,
                                 fusion=fusion, where=where, autocut=autocut)
        elif search_kind is not None:
            results = self._near_media(col, req, search_kind, limit, tenant,
                                       where, autocut)
        else:
            sort = [{"path": list(s.path), "order":
                     "asc" if s.ascending else "desc"} for s in req.sort_by]
            fetched_objects = col.fetch_objects(
                limit=limit, offset=req.offset, sort=sort or None,
                where=where, tenant=tenant, after=req.after or None)

        if results is not None and req.offset:
            results = results[req.offset:]
        if results is not None:
            results = results[:limit]

        reply = pb.SearchReply()
        meta_req = req.metadata if req.HasField("metadata") else None
        props_req = req.properties if req.HasField("properties") else None
        # pre-1.23 clients set neither api flag and read the deprecated
        # Struct field (search_get.proto:272); modern clients
        # (uses_123_api / uses_125_api) read the typed non_ref_props
        legacy_props = not (req.uses_123_api or req.uses_125_api)
        generative = req.generative if req.HasField("generative") else None
        rerank = req.rerank if req.HasField("rerank") else None

        if results is not None and rerank is not None:
            results = self._rerank(col, results, rerank)

        dtype_of = {p.name: p.data_type for p in col.config.properties}
        if results is not None and req.HasField("group_by"):
            self._group_results(col, reply, results, req.group_by,
                                meta_req, props_req, dtype_of)
        elif results is not None:
            for r in results:
                if r.object is None:
                    continue
                out = reply.results.add()
                self._fill_result(col, out, r.object, r, meta_req, props_req,
                                  dtype_of, legacy_props=legacy_props)
        else:
            for obj in fetched_objects:
                out = reply.results.add()
                self._fill_result(col, out, obj, None, meta_req, props_req,
                                  dtype_of, legacy_props=legacy_props)

        if generative is not None:
            self._generate(col, reply, generative)

        reply.took = time.perf_counter() - start
        return reply

    # -- module hooks (filled in by the module provider when attached) -------

    def _has_vectorizer(self, col, vec_name: str = "") -> bool:
        if self.modules is None:
            return False
        try:
            return self.modules.vectorizer_for(col.config, vec_name) is not None
        except Exception:  # configured module not registered -> BM25 fallback
            return False

    def _vectorize_query(self, col, text: str, near_text,
                         vec_name: str = "") -> np.ndarray:
        if self.modules is None:
            raise ApiError(grpc.StatusCode.UNIMPLEMENTED,
                           "nearText requires a vectorizer module")
        vec = self.modules.vectorize_query(col.config, text, vec_name)
        if near_text is not None:
            vec = self.modules.apply_moves(col, vec, near_text, vec_name)
        return vec

    def _near_media(self, col, req, kind, limit, tenant, where, autocut):
        if self.modules is None:
            raise ApiError(grpc.StatusCode.UNIMPLEMENTED,
                           f"{kind} requires a multi2vec module")
        msg = getattr(req, kind)
        media = getattr(msg, kind.replace("near_", ""))
        vec_name = msg.target_vectors[0] if msg.target_vectors else ""
        vec = self.modules.vectorize_media(
            col.config, kind.replace("near_", ""), media, vec_name)
        max_dist = msg.distance if msg.HasField("distance") else None
        return col.near_vector(vec, k=limit + req.offset, vec_name=vec_name,
                               tenant=tenant, where=where,
                               max_distance=max_dist, autocut=autocut)

    def _rerank(self, col, results, rerank):
        if self.modules is None:
            raise ApiError(grpc.StatusCode.UNIMPLEMENTED,
                           "rerank requires a reranker module")
        docs = [str((r.object.properties if r.object else {}).get(
            rerank.property, "")) for r in results]
        scores = self.modules.rerank(col.config, rerank.query or "", docs)
        for r, s in zip(results, scores):
            r.rerank_score = s
        results.sort(key=lambda r: -(r.rerank_score or 0.0))
        return results

    def _generate(self, col, reply, generative):
        if self.modules is None:
            raise ApiError(grpc.StatusCode.UNIMPLEMENTED,
                           "generative search requires a generative module")
        outs = list(reply.results) or [o for g in reply.group_by_results
                                       for o in g.objects]
        if generative.single_response_prompt:
            for out in outs:
                props = json_format.MessageToDict(
                    out.properties.non_ref_properties)
                props.update({k: _value_to_py(v) for k, v in
                              out.properties.non_ref_props.fields.items()})
                text = self.modules.generate_single(
                    col.config, generative.single_response_prompt, props)
                out.metadata.generative = text
                out.metadata.generative_present = True
        if generative.grouped_response_task:
            all_props = []
            for out in outs:
                props = {k: _value_to_py(v) for k, v in
                         out.properties.non_ref_props.fields.items()}
                if generative.grouped_properties:
                    props = {k: v for k, v in props.items()
                             if k in generative.grouped_properties}
                all_props.append(props)
            reply.generative_grouped_result = self.modules.generate_grouped(
                col.config, generative.grouped_response_task, all_props)

    # -- result marshalling --------------------------------------------------

    def _fill_result(self, col, out: "pb.SearchResult", obj, res,
                     meta_req, props_req, dtype_of=None,
                     legacy_props=False):
        md = out.metadata
        if meta_req is None or meta_req.uuid:
            md.id = obj.uuid
        if meta_req is not None:
            if meta_req.vector and obj.vector is not None:
                md.vector_bytes = _f32_bytes(obj.vector)
            for name in meta_req.vectors:
                if name in obj.vectors:
                    v = md.vectors.add()
                    v.name = name
                    v.vector_bytes = _f32_bytes(obj.vectors[name])
            if meta_req.creation_time_unix:
                md.creation_time_unix = obj.creation_time_ms
                md.creation_time_unix_present = True
            if meta_req.last_update_time_unix:
                md.last_update_time_unix = obj.last_update_time_ms
                md.last_update_time_unix_present = True
            if res is not None and res.distance is not None:
                if meta_req.distance:
                    md.distance = res.distance
                    md.distance_present = True
                if meta_req.certainty:
                    md.certainty = max(0.0, 1.0 - res.distance / 2.0)
                    md.certainty_present = True
            if res is not None and meta_req.score and res.score is not None:
                md.score = res.score
                md.score_present = True
        # rerank score rides along whenever a reranker ran, like the
        # reference's _additional{rerank} — not gated on MetadataRequest
        rr = getattr(res, "rerank_score", None) if res is not None else None
        if rr is not None:
            md.rerank_score = rr
            md.rerank_score_present = True
        props = out.properties
        if dtype_of is None:
            dtype_of = {p.name: p.data_type for p in col.config.properties}
        requested = None
        if props_req is not None and not props_req.return_all_nonref_properties:
            requested = set(props_req.non_ref_properties) or None
        for key, val in obj.properties.items():
            if requested is not None and key not in requested:
                continue
            dtype = dtype_of.get(key)
            if dtype == DataType.REFERENCE:
                continue
            props.non_ref_props.fields[key].CopyFrom(_to_value(val, dtype))
            if legacy_props and dtype != DataType.GEO:
                try:
                    # Struct.update merges key-by-key (ParseDict would
                    # clear previously-written keys)
                    props.non_ref_properties.update({key: val})
                except Exception:  # noqa: BLE001 - non-Struct-able value
                    pass
        props.target_collection = col.config.name

    def _group_results(self, col, reply, results, group_by,
                       meta_req, props_req, dtype_of=None):
        """Group hits by a property value (reference: GroupBy over one
        path entry, prepare_reply.go groupByResults)."""
        path = list(group_by.path)
        prop = path[0] if path else ""
        groups: dict[str, list] = {}
        order: list[str] = []
        for r in results:
            if r.object is None:
                continue
            key = str(r.object.properties.get(prop))
            if key not in groups:
                if group_by.number_of_groups and \
                        len(order) >= group_by.number_of_groups:
                    continue
                groups[key] = []
                order.append(key)
            if group_by.objects_per_group and \
                    len(groups[key]) >= group_by.objects_per_group:
                continue
            groups[key].append(r)
        for key in order:
            members = groups[key]
            g = reply.group_by_results.add()
            g.name = key
            dists = [m.distance for m in members if m.distance is not None]
            if dists:
                g.min_distance = min(dists)
                g.max_distance = max(dists)
            g.number_of_objects = len(members)
            for m in members:
                out = g.objects.add()
                self._fill_result(col, out, m.object, m, meta_req, props_req,
                                  dtype_of)

    # -- BatchObjects (service.go:126) ---------------------------------------

    def _batch_objects(self, req: "pb.BatchObjectsRequest",
                       context) -> "pb.BatchObjectsReply":
        start = time.perf_counter()
        consistency = _CONSISTENCY[req.consistency_level] \
            if req.HasField("consistency_level") else "QUORUM"
        by_target: dict[tuple[str, str], list[tuple[int, "pb.BatchObject"]]] = {}
        for i, bo in enumerate(req.objects):
            by_target.setdefault((bo.collection, bo.tenant), []).append((i, bo))
        reply = pb.BatchObjectsReply()
        for (cname, tenant), entries in by_target.items():
            try:
                col = self._collection(cname)
            except KeyError as e:
                for i, _bo in entries:
                    err = reply.errors.add()
                    err.index = i
                    err.error = str(e)
                continue
            specs = []
            for _i, bo in entries:
                spec = {"uuid": bo.uuid or None,
                        "properties": _props_from_batch_object(bo)}
                vec = _vector_from(bo.vector_bytes, bo.vector)
                if vec is not None:
                    spec["vector"] = vec
                named = {}
                for v in bo.vectors:
                    named[v.name] = np.frombuffer(
                        v.vector_bytes, dtype="<f4").astype(np.float32)
                if named:
                    spec["vectors"] = named
                specs.append(spec)
            if self.modules is not None:
                try:
                    self.modules.vectorize_batch(col.config, specs)
                except Exception as e:  # per-object errors, not whole-batch
                    from weaviate_tpu_torch.modules.provider import needs_vector

                    kept = []
                    for (i, _bo), spec in zip(entries, specs):
                        if needs_vector(col.config, spec):
                            err = reply.errors.add()
                            err.index = i
                            err.error = f"vectorize: {e}"
                        else:
                            kept.append(((i, _bo), spec))
                    entries = [ent for ent, _s in kept]
                    specs = [s for _ent, s in kept]
            outcomes = col.batch_put(specs, tenant=tenant or None,
                                     consistency=consistency)
            for (i, _bo), out in zip(entries, outcomes):
                if out["status"] != "SUCCESS":
                    err = reply.errors.add()
                    err.index = i
                    err.error = out.get("error", "")
        reply.took = time.perf_counter() - start
        return reply

    # -- BatchDelete ---------------------------------------------------------

    def _batch_delete(self, req: "pb.BatchDeleteRequest",
                      context) -> "pb.BatchDeleteReply":
        start = time.perf_counter()
        col = self._collection(req.collection)
        if not req.HasField("filters"):
            # a filterless batch delete would wipe the collection; the
            # reference requires match.where (usecases/objects validation)
            raise ApiError(grpc.StatusCode.INVALID_ARGUMENT,
                           "batch delete requires a where filter")
        where = filters_from_pb(req.filters)
        consistency = _CONSISTENCY[req.consistency_level] \
            if req.HasField("consistency_level") else "QUORUM"
        result = col.batch_delete(
            where, tenant=req.tenant or None, dry_run=req.dry_run,
            verbose=req.verbose, consistency=consistency)
        reply = pb.BatchDeleteReply(
            matches=result["matches"], successful=result["successful"],
            failed=result["failed"])
        for entry in result["objects"]:
            obj = reply.objects.add()
            try:  # clients expect raw UUID bytes (batch_delete.proto uuid)
                obj.uuid = _uuid.UUID(entry["id"]).bytes
            except ValueError:
                obj.uuid = entry["id"].encode()
            obj.successful = entry["successful"]
            if entry.get("error"):
                obj.error = entry["error"]
        reply.took = time.perf_counter() - start
        return reply

    # -- TenantsGet ----------------------------------------------------------

    def _tenants_get(self, req: "pb.TenantsGetRequest",
                     context) -> "pb.TenantsGetReply":
        start = time.perf_counter()
        col = self._collection(req.collection)
        if not col.config.multi_tenancy.enabled:
            raise ApiError(grpc.StatusCode.FAILED_PRECONDITION,
                           "multi-tenancy is not enabled")
        names = col.tenants()
        if req.HasField("names"):
            wanted = set(req.names.values)
            names = [n for n in names if n in wanted]
        reply = pb.TenantsGetReply()
        for n in sorted(names):
            t = reply.tenants.add()
            t.name = n
            t.activity_status = pb.TENANT_ACTIVITY_STATUS_HOT
        reply.took = time.perf_counter() - start
        return reply


def _value_to_py(v: "pb.Value"):
    kind = v.WhichOneof("kind")
    if kind is None or kind == "null_value":
        return None
    raw = getattr(v, kind)
    if kind == "list_value":
        lk = raw.WhichOneof("kind")
        if lk == "number_values":
            return list(np.frombuffer(raw.number_values.values, dtype="<f8"))
        if lk == "int_values":
            return list(np.frombuffer(raw.int_values.values, dtype="<i8"))
        if lk is not None:
            return list(getattr(raw, lk).values)
        return [_value_to_py(e) for e in raw.values]
    if kind == "object_value":
        return {k: _value_to_py(sub) for k, sub in raw.fields.items()}
    if kind == "geo_value":
        return {"latitude": raw.latitude, "longitude": raw.longitude}
    return raw
