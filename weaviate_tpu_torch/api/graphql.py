"""GraphQL API: /v1/graphql Get / Aggregate / Explore.

Reference: adapters/handlers/graphql — the schema is generated at runtime
from the class schema (graphql/schema.go:98-109) and serves local/get
(class_builder_fields.go: nearVector/nearObject/nearText/bm25/hybrid/where/
sort/limit/autocut args, _additional properties), local/aggregate, and
local/explore. No GraphQL library ships in this environment, so this module
carries a small spec-subset lexer/parser (operations, selection sets,
arguments with object/list/enum/variable values, aliases, fragments are NOT
needed by the reference clients' query shapes) and executes directly
against the Database — schema validation happens against CollectionConfig
at execution time, the same information the reference bakes into its
generated schema.
"""

from __future__ import annotations

import json
import re

import numpy as np

from weaviate_tpu_torch.modules.base import ModuleError

# ---------------------------------------------------------------------------
# Lexer / parser (GraphQL spec subset)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[\s,]+)
  | (?P<comment>\#[^\n\r]*)
  | (?P<spread>\.\.\.)
  | (?P<name>[_A-Za-z][_0-9A-Za-z]*)
  | (?P<float>-?\d+\.\d+([eE][+-]?\d+)?|-?\d+[eE][+-]?\d+)
  | (?P<int>-?\d+)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<punct>[{}()\[\]:$!=])
    """,
    re.VERBOSE,
)

_JSON_ESCAPE_RE = re.compile(r"\\u([0-9a-fA-F]{4})|\\(.)")
_JSON_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f"}


def _unescape_fallback(m: re.Match) -> str:
    if m.group(1) is not None:
        return chr(int(m.group(1), 16))
    return _JSON_ESCAPES.get(m.group(2), m.group(2))


class GraphQLError(Exception):
    pass


def _tokenize(src: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise GraphQLError(f"unexpected character {src[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        out.append((kind, m.group(0)))
    out.append(("eof", ""))
    return out


class _Var:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name


class Field:
    __slots__ = ("name", "alias", "args", "selections")

    def __init__(self, name, alias=None, args=None, selections=None):
        self.name = name
        self.alias = alias or name
        self.args = args or {}
        self.selections = selections or []

    def sel(self, name: str) -> "Field | None":
        for f in self.selections:
            if isinstance(f, Field) and f.name == name:
                return f
        return None

    def fragments(self) -> "list[InlineFragment]":
        return [f for f in self.selections if isinstance(f, InlineFragment)]


class InlineFragment:
    """``... on ClassName { ... }`` — how the reference's GraphQL schema
    types cross-reference properties (class_builder_fields.go ref
    resolution)."""

    __slots__ = ("type_name", "selections")

    def __init__(self, type_name, selections):
        self.type_name = type_name
        self.selections = selections

    def sel(self, name: str):
        for f in self.selections:
            if isinstance(f, Field) and f.name == name:
                return f
        return None


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, value):
        kind, v = self.next()
        if v != value:
            raise GraphQLError(f"expected {value!r}, got {v!r}")

    def parse_document(self) -> list[Field]:
        kind, v = self.peek()
        if v == "query":
            self.next()
            # optional operation name and variable definitions
            kind, v = self.peek()
            if kind == "name":
                self.next()
            if self.peek()[1] == "(":
                # skip variable definitions: ($x: Type = default, ...)
                depth = 0
                while True:
                    _, v = self.next()
                    if v == "(":
                        depth += 1
                    elif v == ")":
                        depth -= 1
                        if depth == 0:
                            break
        elif v == "mutation":
            raise GraphQLError("mutations are not supported")
        return self.parse_selection_set()

    def parse_selection_set(self) -> list[Field]:
        self.expect("{")
        fields = []
        while self.peek()[1] != "}":
            fields.append(self.parse_field())
        self.next()  # consume }
        return fields

    def parse_field(self) -> Field:
        kind, name = self.next()
        if kind == "spread":
            _, on = self.next()
            if on != "on":
                raise GraphQLError("only inline fragments ('... on Type') "
                                   "are supported")
            kind2, type_name = self.next()
            if kind2 != "name":
                raise GraphQLError("expected type name after '... on'")
            return InlineFragment(type_name, self.parse_selection_set())
        if kind != "name":
            raise GraphQLError(f"expected field name, got {name!r}")
        alias = None
        if self.peek()[1] == ":":
            self.next()
            kind2, real = self.next()
            if kind2 != "name":
                raise GraphQLError(f"expected field name after alias")
            alias, name = name, real
        args = {}
        if self.peek()[1] == "(":
            self.next()
            while self.peek()[1] != ")":
                _, key = self.next()
                self.expect(":")
                args[key] = self.parse_value()
            self.next()
        selections = []
        if self.peek()[1] == "{":
            selections = self.parse_selection_set()
        return Field(name, alias, args, selections)

    def parse_value(self):
        kind, v = self.next()
        if v == "$":
            _, name = self.next()
            return _Var(name)
        if v == "{":
            obj = {}
            while self.peek()[1] != "}":
                _, key = self.next()
                self.expect(":")
                obj[key] = self.parse_value()
            self.next()
            return obj
        if v == "[":
            arr = []
            while self.peek()[1] != "]":
                arr.append(self.parse_value())
            self.next()
            return arr
        if kind == "int":
            return int(v)
        if kind == "float":
            return float(v)
        if kind == "string":
            # The string grammar (see _TOKEN_RE) is JSON-compatible; json.loads
            # handles \uXXXX and backslash escapes without re-interpreting
            # UTF-8 bytes as Latin-1 the way unicode_escape would.
            try:
                return json.loads(v)
            except ValueError:
                # Literal control characters are legal for us but not JSON.
                return _JSON_ESCAPE_RE.sub(_unescape_fallback, v[1:-1])
        if kind == "name":
            if v == "true":
                return True
            if v == "false":
                return False
            if v == "null":
                return None
            return v  # enum — stays a bare string
        raise GraphQLError(f"unexpected value token {v!r}")


def parse_query(src: str) -> list[Field]:
    return _Parser(_tokenize(src)).parse_document()


def _resolve_vars(value, variables: dict):
    if isinstance(value, _Var):
        if value.name not in (variables or {}):
            raise GraphQLError(f"variable ${value.name} not provided")
        return variables[value.name]
    if isinstance(value, dict):
        return {k: _resolve_vars(v, variables) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve_vars(v, variables) for v in value]
    return value


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


class _NearTextShim:
    """Duck-types the gRPC NearText proto for Provider.apply_moves."""

    class _Move:
        def __init__(self, d):
            self.concepts = d.get("concepts") or []
            objs = d.get("objects") or []
            self.uuids = [o.get("id") or o.get("beacon", "").split("/")[-1]
                          for o in objs]
            self.force = d.get("force", 0.0)

    def __init__(self, d: dict):
        self._moves = {}
        if d.get("moveTo"):
            self._moves["move_to"] = self._Move(d["moveTo"])
        if d.get("moveAwayFrom"):
            self._moves["move_away"] = self._Move(d["moveAwayFrom"])

    def HasField(self, name):
        return name in self._moves

    def __getattr__(self, name):
        try:
            return self._moves[name]
        except KeyError:
            raise AttributeError(name)


def _certainty_to_distance(c: float) -> float:
    # reference: certainty = 1 - d/2 for cosine (additional/certainty.go)
    return 2.0 * (1.0 - float(c))


def _distance_to_certainty(d: float) -> float:
    return 1.0 - float(d) / 2.0


class GraphQLExecutor:
    """Callable for RestServer(graphql_executor=...): payload dict
    {"query": ..., "variables": ...} -> GraphQL response dict."""

    def __init__(self, db, modules=None):
        self.db = db
        self.modules = modules

    def __call__(self, payload: dict) -> dict:
        try:
            query = payload.get("query") or ""
            variables = payload.get("variables") or {}
            roots = parse_query(query)
            data = {}
            for root in roots:
                if root.name == "Get":
                    data[root.alias] = self._get_root(root, variables)
                elif root.name == "Aggregate":
                    data[root.alias] = self._aggregate_root(root, variables)
                elif root.name == "Explore":
                    data[root.alias] = self._explore(root, variables)
                else:
                    raise GraphQLError(f"unknown root field {root.name!r}")
            return {"data": data}
        except (GraphQLError, ModuleError, KeyError, ValueError,
                TypeError) as e:
            msg = str(e) if str(e) else repr(e)
            return {"data": None, "errors": [{"message": msg}]}

    # -- Get -----------------------------------------------------------------

    def _get_root(self, root: Field, variables) -> dict:
        out = {}
        for cls_field in root.selections:
            if isinstance(cls_field, InlineFragment):
                raise GraphQLError(
                    "inline fragments are only supported inside "
                    "reference-property selections")
            out[cls_field.alias] = self._get_class(cls_field, variables)
        return out

    def _get_class(self, f: Field, variables) -> list[dict]:
        col = self.db.get_collection(f.name)
        args = {k: _resolve_vars(v, variables) for k, v in f.args.items()}
        limit = int(args.get("limit", 25))
        offset = int(args.get("offset", 0))
        tenant = args.get("tenant")
        # identity for the always-on phase histograms (tailboard top-K
        # guard clamps the label values)
        from weaviate_tpu_torch.runtime import tailboard

        tailboard.annotate(collection=f.name, tenant=tenant)
        autocut = int(args.get("autocut", 0))
        where = self._parse_where(args.get("where"))
        k = limit + offset

        near_vec, vec_name, max_distance = self._resolve_near(
            col, args, tenant)
        if near_vec is not None:
            search = "vector"
        elif "bm25" in args:
            search = "bm25"
        elif "hybrid" in args:
            search = "hybrid"
        else:
            search = None

        if search == "vector":
            results = col.near_vector(
                near_vec, k=k, vec_name=vec_name, tenant=tenant,
                where=where, max_distance=max_distance, autocut=autocut)
        elif search == "bm25":
            d = args["bm25"]
            results = col.bm25(d.get("query", ""), k=k,
                               properties=d.get("properties"),
                               tenant=tenant, where=where, autocut=autocut)
        elif search == "hybrid":
            d = args["hybrid"]
            tv = d.get("targetVectors")
            hv = d.get("vector")
            if hv is None and self.modules is not None and d.get("query"):
                try:
                    hv = self.modules.vectorize_query(
                        col.config, d["query"], tv[0] if tv else "")
                except Exception:
                    hv = None  # degrade to sparse-only like the reference
            fusion = {"rankedFusion": "ranked",
                      "relativeScoreFusion": "relativeScore"}.get(
                          d.get("fusionType", ""), "relativeScore")
            results = col.hybrid(
                d.get("query", ""), vector=hv,
                alpha=float(d.get("alpha", 0.75)), k=k,
                properties=d.get("properties"),
                vec_name=tv[0] if tv else "", tenant=tenant,
                fusion=fusion, where=where, autocut=autocut)
        else:
            # plain listing (with optional sort / cursor)
            if "groupBy" in args:
                raise GraphQLError(
                    "groupBy requires a search argument (nearVector/"
                    "nearText/bm25/hybrid/...)")
            sort = args.get("sort")
            if sort is not None and not isinstance(sort, list):
                sort = [sort]
            objs = col.fetch_objects(
                limit=limit, offset=offset, tenant=tenant,
                sort=[{"path": s.get("path"), "order": s.get("order", "asc")}
                      for s in sort] if sort else None,
                where=where, after=args.get("after"))
            return [self._render_object(f, col, o, None, tenant)
                    for o in objs]

        sort = args.get("sort")
        if sort is not None:
            # sort composes with search results (reference sorter/
            # objects_sorter.go keeps the distance pairing through it)
            from weaviate_tpu_torch.query.sorter import sort_search_results

            if not isinstance(sort, list):
                sort = [sort]
            results = sort_search_results(
                results,
                [{"path": s.get("path"), "order": s.get("order", "asc")}
                 for s in sort])
        results = results[offset:offset + limit]
        rerank_field = None
        add = f.sel("_additional")
        if add is not None:
            rerank_field = add.sel("rerank")
        if rerank_field is not None:
            results = self._apply_rerank(col, results, rerank_field.args)
        if "groupBy" in args:
            return self._render_grouped(f, col, results, args["groupBy"],
                                        tenant)
        return [self._render_result(f, col, r, tenant)
                for r in results]

    def _render_hit(self, f: Field, col, r, tenant) -> dict:
        """One groupBy hit, rendered through the query's
        group{hits{...}} selection set (falls back to id+distance when
        the query names no hit fields)."""
        add = f.sel("_additional")
        group_f = add.sel("group") if add is not None else None
        hits_f = group_f.sel("hits") if group_f is not None else None
        if hits_f is not None and hits_f.selections:
            return self._render_result(hits_f, col, r, tenant)
        return {"_additional": {"id": r.uuid, "distance": r.distance}}

    def _resolve_near(self, col, args: dict, tenant=None):
        """Resolve any near* argument to (vector, vec_name, max_distance);
        (None, "", None) when no near arg is present. One resolver for the
        Get and Aggregate roots so their semantics (named vectors,
        distance/certainty thresholds, nearText moves) cannot drift."""

        def _target(d):
            tv = d.get("targetVectors")
            return tv[0] if tv else ""

        def _max_dist(d):
            if "distance" in d:
                return float(d["distance"])
            if "certainty" in d:
                return _certainty_to_distance(d["certainty"])
            return None

        if "nearVector" in args:
            d = args["nearVector"]
            return (np.asarray(d["vector"], dtype=np.float32),
                    _target(d), _max_dist(d))
        if "nearObject" in args:
            d = args["nearObject"]
            uid = d.get("id") or d.get("beacon", "").split("/")[-1]
            anchor = col.get_object(uid, tenant=tenant)
            if anchor is None:
                raise GraphQLError(f"nearObject anchor {uid} not found")
            vec_name = _target(d)
            vec = (anchor.vectors.get(vec_name) if vec_name
                   else anchor.vector)
            if vec is None:
                raise GraphQLError(f"anchor {uid} has no vector")
            return vec, vec_name, _max_dist(d)
        if "nearText" in args:
            d = args["nearText"]
            if self.modules is None:
                raise GraphQLError("nearText requires a vectorizer module")
            vec_name = _target(d)
            vec = self.modules.vectorize_query(
                col.config, " ".join(d.get("concepts") or []), vec_name)
            vec = self.modules.apply_moves(
                col, vec, _NearTextShim(d), vec_name)
            return vec, vec_name, _max_dist(d)
        # near<Media>: vectorize through the class's multi2vec module
        for arg_name, kind in (("nearImage", "image"),
                               ("nearAudio", "audio"),
                               ("nearVideo", "video"),
                               ("nearThermal", "thermal"),
                               ("nearDepth", "depth"),
                               ("nearIMU", "imu")):
            if arg_name in args:
                if self.modules is None:
                    raise GraphQLError(
                        f"{arg_name} requires a multi2vec module")
                d = args[arg_name]
                vec_name = _target(d)
                vec = self.modules.vectorize_media(
                    col.config, kind, d.get(kind, ""), vec_name)
                return vec, vec_name, _max_dist(d)
        return None, "", None

    def _render_grouped(self, f: Field, col, results, group_by,
                        tenant) -> list[dict]:
        """Get-level groupBy (reference: groupBy{path groups
        objectsPerGroup} + _additional{group{...}}): one returned entry
        per group, hits nested under _additional.group."""
        path = group_by.get("path")
        prop = path[0] if isinstance(path, list) else path
        max_groups = max(int(group_by.get("groups", 5)), 1)
        per_group = max(int(group_by.get("objectsPerGroup", 5)), 1)
        groups: dict = {}
        order: list = []
        for r in results:
            obj = r.object or col.get_object(r.uuid, tenant=tenant)
            if obj is None:
                continue
            value = obj.properties.get(prop)
            key = tuple(value) if isinstance(value, list) else value
            try:
                hash(key)
            except TypeError:  # dict-typed / nested values
                key = repr(value)
            if key not in groups:
                if len(groups) >= max_groups:
                    continue
                groups[key] = []
                order.append(key)
            if len(groups[key]) < per_group:
                r.object = obj
                groups[key].append(r)
        out = []
        for gid, key in enumerate(order):
            hits = groups[key]
            best = hits[0]
            row = self._render_result(f, col, best, tenant)
            dists = [h.distance for h in hits if h.distance is not None]
            add = row.setdefault("_additional", {})
            add["group"] = {
                "id": gid,
                "groupedBy": {"value": key if not isinstance(key, tuple)
                              else list(key),
                              "path": [prop]},
                "count": len(hits),
                "minDistance": min(dists) if dists else None,
                "maxDistance": max(dists) if dists else None,
                "hits": [self._render_hit(f, col, h, tenant)
                         for h in hits],
            }
            out.append(row)
        return out

    def _apply_rerank(self, col, results, rr_args):
        if self.modules is None:
            raise GraphQLError("rerank requires a reranker module")
        prop = rr_args.get("property", "")
        docs = []
        for r in results:
            obj = r.object or col.get_object(r.uuid)
            docs.append(str((obj.properties if obj else {}).get(prop, "")))
        scores = self.modules.rerank(col.config, rr_args.get("query") or "",
                                     docs)
        for r, s in zip(results, scores):
            r.rerank_score = s
        results.sort(key=lambda r: -(r.rerank_score or 0.0))
        return results

    def _render_result(self, f: Field, col, r, tenant=None) -> dict:
        obj = r.object or col.get_object(r.uuid, tenant=tenant)
        return self._render_object(f, col, obj, r, tenant)

    def _render_object(self, f: Field, col, obj, result,
                       tenant=None) -> dict:
        out = {}
        for sel in f.selections:
            if isinstance(sel, InlineFragment):
                continue  # fragments only make sense under a ref property
            if sel.name == "_additional":
                out[sel.alias] = self._additional(sel, col, obj, result)
            elif obj is not None:
                value = obj.properties.get(sel.name)
                if sel.selections and isinstance(value, list):
                    out[sel.alias] = self._render_refs(sel, value, tenant)
                else:
                    out[sel.alias] = value
            else:
                out[sel.alias] = None
        return out

    def _render_refs(self, sel: Field, beacons: list,
                     tenant=None) -> list[dict]:
        """Resolve cross-reference beacons and render each target through
        the matching inline fragment (reference: ref-property fields are
        GraphQL union types over the target classes)."""
        out = []
        frags = {fr.type_name: fr for fr in sel.fragments()}
        for ref in beacons:
            beacon = ref.get("beacon", "") if isinstance(ref, dict) \
                else str(ref)
            parts = [p for p in beacon.split("/") if p]
            if len(parts) < 2:
                continue
            uid = parts[-1]
            cls_name = parts[-2] if len(parts) >= 3 and \
                parts[-2][0:1].isupper() else None
            candidates = [cls_name] if cls_name else \
                self.db.list_collections()
            for cname in candidates:
                try:
                    target_col = self.db.get_collection(cname)
                    # MT targets resolve within the query's tenant; a
                    # tenant-less lookup at an MT class is skipped, not
                    # fatal (ValueError from _check_tenant)
                    target = target_col.get_object(uid, tenant=tenant)
                except (KeyError, ValueError):
                    continue
                if target is None:
                    continue
                frag = frags.get(cname)
                if frag is None:
                    break  # resolved, but the query doesn't want this type
                row = self._render_object(
                    Field(sel.name, selections=frag.selections),
                    target_col, target, None, tenant)
                row["__typename"] = cname
                out.append(row)
                break
        return out

    def _additional(self, add: Field, col, obj, result) -> dict:
        out = {}
        for sel in add.selections:
            if isinstance(sel, InlineFragment):
                continue
            n = sel.name
            if n == "id":
                out[sel.alias] = obj.uuid if obj else (
                    result.uuid if result else None)
            elif n == "vector":
                v = obj.vector if obj is not None else None
                out[sel.alias] = None if v is None else np.asarray(v).tolist()
            elif n == "vectors":
                out[sel.alias] = {
                    k: np.asarray(v).tolist()
                    for k, v in (obj.vectors if obj else {}).items()}
            elif n == "distance":
                out[sel.alias] = None if result is None else result.distance
            elif n == "certainty":
                d = None if result is None else result.distance
                out[sel.alias] = None if d is None else _distance_to_certainty(d)
            elif n == "score":
                out[sel.alias] = None if result is None else result.score
            elif n == "rerank":
                rr = getattr(result, "rerank_score", None)
                out[sel.alias] = [{"score": rr}]
            elif n == "creationTimeUnix":
                out[sel.alias] = str(obj.creation_time_ms) if obj else None
            elif n == "lastUpdateTimeUnix":
                out[sel.alias] = str(obj.last_update_time_ms) if obj else None
            elif n == "generate":
                out[sel.alias] = self._generate(sel, col, obj)
            elif n == "answer":
                out[sel.alias] = self._answer(sel, col, obj)
            elif n == "tokens":
                out[sel.alias] = self._tokens(sel, col, obj)
            elif n == "summary":
                out[sel.alias] = self._summary(sel, col, obj)
            else:
                out[sel.alias] = None
        return out

    def _obj_text(self, col, obj, properties=None) -> str:
        props = obj.properties if obj is not None else {}
        keys = properties or [p.name for p in col.config.properties
                              if p.data_type in ("text", "text[]")]
        parts = []
        for key in keys:
            v = props.get(key)
            if isinstance(v, str):
                parts.append(v)
            elif isinstance(v, list):
                parts.extend(x for x in v if isinstance(x, str))
        return " ".join(parts)

    def _answer(self, sel: Field, col, obj) -> dict:
        if self.modules is None:
            raise GraphQLError("answer requires a qna module")
        question = sel.args.get("question", "")
        props = sel.args.get("properties")
        text = self._obj_text(col, obj, props)
        ans = self.modules.answer(col.config, text, question)
        ans.setdefault("result", ans.get("answer"))
        return ans

    def _tokens(self, sel: Field, col, obj) -> list[dict]:
        if self.modules is None:
            raise GraphQLError("tokens requires a ner module")
        props = sel.args.get("properties")
        return self.modules.ner(col.config,
                                self._obj_text(col, obj, props))

    def _summary(self, sel: Field, col, obj) -> list[dict]:
        if self.modules is None:
            raise GraphQLError("summary requires a sum module")
        props = sel.args.get("properties")
        return self.modules.summarize(col.config,
                                      self._obj_text(col, obj, props))

    def _generate(self, sel: Field, col, obj) -> dict:
        if self.modules is None:
            raise GraphQLError("generate requires a generative module")
        res = {}
        props = obj.properties if obj is not None else {}
        args = sel.args
        if "singleResult" in args:
            prompt = (args["singleResult"] or {}).get("prompt", "")
            res["singleResult"] = self.modules.generate_single(
                col.config, prompt, props)
        if "groupedResult" in args:
            task = (args["groupedResult"] or {}).get("task", "")
            res["groupedResult"] = self.modules.generate_grouped(
                col.config, task, [props])
        res["error"] = None
        return res

    # -- Aggregate -----------------------------------------------------------

    def _aggregate_root(self, root: Field, variables) -> dict:
        out = {}
        for cls_field in root.selections:
            if isinstance(cls_field, InlineFragment):
                raise GraphQLError(
                    "inline fragments are only supported inside "
                    "reference-property selections")
            out[cls_field.alias] = self._aggregate_class(cls_field, variables)
        return out

    def _aggregate_class(self, f: Field, variables):
        col = self.db.get_collection(f.name)
        args = {k: _resolve_vars(v, variables) for k, v in f.args.items()}
        where = self._parse_where(args.get("where"))
        tenant = args.get("tenant")
        group_by = args.get("groupBy")
        if isinstance(group_by, list):
            group_by = group_by[0] if group_by else None
        near_vec, near_vec_name, near_max_dist = self._resolve_near(
            col, args, tenant)

        props, requested = [], {}
        wants_grouped = False
        for sel in f.selections:
            if sel.name in ("meta", "groupedBy"):
                wants_grouped = wants_grouped or sel.name == "groupedBy"
                continue
            props.append(sel.name)
            metrics = []
            for m in sel.selections:
                metrics.append(m.name)
            requested[sel.name] = metrics or None

        agg = col.aggregate(properties=props or None, group_by=group_by,
                            where=where, tenant=tenant, requested=requested,
                            near_vector=near_vec,
                            near_vec_name=near_vec_name,
                            near_max_distance=near_max_dist,
                            object_limit=args.get("objectLimit"))

        def render(meta_count, properties, grouped_value=None):
            row = {}
            for sel in f.selections:
                if sel.name == "meta":
                    row[sel.alias] = {"count": meta_count}
                elif sel.name == "groupedBy":
                    row[sel.alias] = {"value": grouped_value,
                                      "path": [group_by] if group_by else []}
                else:
                    row[sel.alias] = properties.get(sel.name)
            return row

        if group_by:
            return [render(g["meta"]["count"], g["properties"],
                           g["groupedBy"]["value"])
                    for g in agg.get("groups", [])]
        return [render(agg["meta"]["count"], agg["properties"])]

    # -- Explore ---------------------------------------------------------------

    def _explore(self, root: Field, variables) -> list[dict]:
        args = {k: _resolve_vars(v, variables) for k, v in root.args.items()}
        limit = int(args.get("limit", 20))
        hits = []
        for name in self.db.list_collections():
            col = self.db.get_collection(name)
            if "nearVector" in args:
                vec = np.asarray(args["nearVector"]["vector"],
                                 dtype=np.float32)
            elif "nearText" in args:
                if self.modules is None:
                    raise GraphQLError("nearText requires a vectorizer")
                try:
                    vec = self.modules.vectorize_query(
                        col.config, " ".join(args["nearText"].get(
                            "concepts") or []), "")
                except Exception:
                    continue  # class without a vectorizer: skip
            else:
                raise GraphQLError("Explore requires nearVector or nearText")
            try:
                for r in col.near_vector(vec, k=limit,
                                         include_objects=False):
                    hits.append((r.distance, name, r.uuid))
            except Exception:
                continue  # dimension mismatch etc.
        hits.sort(key=lambda h: h[0])
        out = []
        for dist, cls, uid in hits[:limit]:
            row = {}
            for sel in root.selections:
                if sel.name == "beacon":
                    row[sel.alias] = f"weaviate://localhost/{cls}/{uid}"
                elif sel.name == "className":
                    row[sel.alias] = cls
                elif sel.name == "distance":
                    row[sel.alias] = dist
                elif sel.name == "certainty":
                    row[sel.alias] = _distance_to_certainty(dist)
                else:
                    row[sel.alias] = None
            out.append(row)
        return out

    # -- helpers ---------------------------------------------------------------

    @staticmethod
    def _parse_where(w):
        if w is None:
            return None
        from weaviate_tpu_torch.filters.filters import Filter

        return Filter.from_dict(w)
