"""Property aggregations with shard-combinable partials.

Reference: adapters/repos/db/aggregator/ — numerical (count/min/max/mean/
median/mode/sum, numerical.go), text topOccurrences (text.go), boolean
totals+percentages (boolean.go), date min/max/median/mode (date.go);
cross-shard merge in shard_combiner.go.

Design: each shard folds its objects into a serializable *partial*
(counts + value counters, mirroring the reference's ``valueCounter``
maps), partials merge associatively across shards/nodes, and the final
numbers are computed once at the coordinator. Median and mode are exact
because the partial carries the full value histogram, not a sketch.
"""

from __future__ import annotations

from collections import Counter
from datetime import datetime, timezone

NUMERICAL_AGGS = ("count", "minimum", "maximum", "mean", "median", "mode", "sum")
TEXT_AGGS = ("count", "topOccurrences")
BOOLEAN_AGGS = ("count", "totalTrue", "totalFalse", "percentageTrue", "percentageFalse")
DATE_AGGS = ("count", "minimum", "maximum", "median", "mode")


def _parse_date(v: str) -> float:
    """ISO-8601 → epoch seconds (dates aggregate on their timeline order)."""
    s = v.replace("Z", "+00:00")
    dt = datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


class PropertyAggregator:
    """Accumulates one property's values; type inferred from data."""

    def __init__(self):
        self.kind: str | None = None  # numerical | text | boolean | date
        self.count = 0
        self.sum = 0.0
        self.values = Counter()  # histogram: value -> occurrences

    # -- fold ----------------------------------------------------------------

    def add(self, value) -> None:
        if value is None:
            return
        if isinstance(value, bool):
            kind = "boolean"
        elif isinstance(value, (int, float)):
            kind = "numerical"
        elif isinstance(value, str):
            kind = "text"
            try:
                _parse_date(value)
                kind = "date"
            except ValueError:
                pass
        elif isinstance(value, list):
            for v in value:
                self.add(v)
            return
        else:
            return
        if self.kind is None:
            self.kind = kind
        elif self.kind != kind:
            # mixed types: degrade to text, keep counting occurrences
            # (a date-looking string among text keeps the text kind)
            if {self.kind, kind} == {"text", "date"}:
                self.kind = "text"
            else:
                return
        self.count += 1
        if kind == "numerical":
            self.sum += float(value)
            self.values[float(value)] += 1
        else:
            self.values[value] += 1

    # -- partial protocol ------------------------------------------------------

    def to_partial(self) -> dict:
        return {
            "kind": self.kind,
            "count": self.count,
            "sum": self.sum,
            "values": [[k, c] for k, c in self.values.items()],
        }

    @classmethod
    def from_partial(cls, d: dict) -> "PropertyAggregator":
        agg = cls()
        agg.kind = d["kind"]
        agg.count = d["count"]
        agg.sum = d["sum"]
        agg.values = Counter({(tuple(k) if isinstance(k, list) else k): c
                              for k, c in d["values"]})
        return agg

    def merge(self, other: "PropertyAggregator") -> None:
        if other.kind is None:
            return
        if self.kind is None:
            self.kind = other.kind
        elif self.kind != other.kind:
            if {self.kind, other.kind} == {"text", "date"}:
                self.kind = "text"
            else:
                return
        self.count += other.count
        self.sum += other.sum
        self.values.update(other.values)

    # -- finalize ----------------------------------------------------------------

    def _sorted_numeric(self):
        if self.kind == "date":
            return sorted(self.values.items(), key=lambda kv: _parse_date(kv[0]))
        return sorted(self.values.items())

    def _median(self):
        """Exact median from the histogram (reference computes from
        valueCounter, numerical.go buildPairsFromCounts)."""
        target = self.count // 2
        seen = 0
        pairs = self._sorted_numeric()
        for i, (v, c) in enumerate(pairs):
            seen += c
            if seen > target:
                return v
            if seen == target and self.count % 2 == 0 and self.kind == "numerical":
                nxt = pairs[i + 1][0] if i + 1 < len(pairs) else v
                return (v + nxt) / 2.0
        return pairs[-1][0] if pairs else None

    def _mode(self):
        if not self.values:
            return None
        return max(self.values.items(), key=lambda kv: (kv[1],))[0]

    def finalize(self, requested: list[str] | None = None, top_occurrences_limit: int = 5) -> dict:
        if self.kind is None or self.count == 0:
            return {"count": 0}
        if self.kind == "numerical":
            out = {
                "count": self.count,
                "minimum": min(self.values),
                "maximum": max(self.values),
                "mean": self.sum / self.count,
                "median": self._median(),
                "mode": self._mode(),
                "sum": self.sum,
            }
        elif self.kind == "boolean":
            t = self.values.get(True, 0)
            f = self.values.get(False, 0)
            out = {
                "count": self.count,
                "totalTrue": t,
                "totalFalse": f,
                "percentageTrue": t / self.count,
                "percentageFalse": f / self.count,
            }
        elif self.kind == "date":
            pairs = self._sorted_numeric()
            out = {
                "count": self.count,
                "minimum": pairs[0][0],
                "maximum": pairs[-1][0],
                "median": self._median(),
                "mode": self._mode(),
            }
        else:  # text
            top = self.values.most_common(top_occurrences_limit)
            out = {
                "count": self.count,
                "type": "text",
                "topOccurrences": [{"value": v, "occurs": c} for v, c in top],
            }
        out["type"] = self.kind if self.kind != "text" else "text"
        if requested:
            keep = set(requested) | {"type"}
            out = {k: v for k, v in out.items() if k in keep}
        return out


# -- shard-level fold ----------------------------------------------------------


def aggregate_objects(objects, properties: list[str] | None = None,
                      group_by: str | None = None) -> dict:
    """Fold an iterable of StorageObjects into a partial aggregation dict.

    Returns {"count": N, "properties": {name: partial}, "groups": {value:
    {"count": n, "properties": ...}}} — everything JSON-serializable so it
    can cross node boundaries (reference: per-shard Aggregate then
    shard_combiner.go merge).
    """
    props = properties or []
    total = 0
    aggs = {p: PropertyAggregator() for p in props}
    groups: dict = {}
    for obj in objects:
        total += 1
        vals = obj.properties
        for p in props:
            aggs[p].add(vals.get(p))
        if group_by is not None:
            gv = vals.get(group_by)
            gvs = gv if isinstance(gv, list) else [gv]
            for g in gvs:
                if g is None:
                    continue
                grp = groups.setdefault(
                    g, {"count": 0, "properties": {p: PropertyAggregator() for p in props}})
                grp["count"] += 1
                for p in props:
                    grp["properties"][p].add(vals.get(p))
    return {
        "count": total,
        "properties": {p: a.to_partial() for p, a in aggs.items()},
        "groups": {
            _group_key(g): {
                "value": g,
                "count": grp["count"],
                "properties": {p: a.to_partial() for p, a in grp["properties"].items()},
            }
            for g, grp in groups.items()
        },
    }


def _group_key(v) -> str:
    # JSON object keys must be strings; keep the raw value in the payload
    return f"{type(v).__name__}:{v}"


def combine_partials(partials: list[dict]) -> dict:
    """Associative merge of shard partials (reference: shard_combiner.go)."""
    total = 0
    aggs: dict[str, PropertyAggregator] = {}
    groups: dict[str, dict] = {}
    for part in partials:
        total += part["count"]
        for p, d in part["properties"].items():
            a = PropertyAggregator.from_partial(d)
            if p in aggs:
                aggs[p].merge(a)
            else:
                aggs[p] = a
        for key, grp in part.get("groups", {}).items():
            dst = groups.get(key)
            if dst is None:
                groups[key] = {
                    "value": grp["value"],
                    "count": grp["count"],
                    "properties": {p: PropertyAggregator.from_partial(d)
                                   for p, d in grp["properties"].items()},
                }
            else:
                dst["count"] += grp["count"]
                for p, d in grp["properties"].items():
                    a = PropertyAggregator.from_partial(d)
                    if p in dst["properties"]:
                        dst["properties"][p].merge(a)
                    else:
                        dst["properties"][p] = a
    return {"count": total, "properties": aggs, "groups": groups}


def finalize_aggregation(combined: dict, requested: dict[str, list[str]] | None = None,
                         top_occurrences_limit: int = 5) -> dict:
    """Combined partial → API-shaped result (entities/aggregation/result.go)."""
    req = requested or {}
    out = {
        "meta": {"count": combined["count"]},
        "properties": {
            p: a.finalize(req.get(p), top_occurrences_limit)
            for p, a in combined["properties"].items()
        },
    }
    if combined["groups"]:
        grps = []
        for grp in combined["groups"].values():
            grps.append({
                "groupedBy": {"value": grp["value"]},
                "meta": {"count": grp["count"]},
                "properties": {
                    p: a.finalize(req.get(p), top_occurrences_limit)
                    for p, a in grp["properties"].items()
                },
            })
        grps.sort(key=lambda g: -g["meta"]["count"])
        out["groups"] = grps
    return out
