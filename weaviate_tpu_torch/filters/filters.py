"""Filter operator tree and its evaluation against a shard's inverted index.

Reference: entities/filters/filters.go (Operator enum, Clause tree) +
adapters/repos/db/inverted/searcher.go (per-clause row readers producing
roaring bitmaps, merged with and/or/not set algebra).

The TPU twist: the result is a dense bool mask over the shard's doc-id
space, shipped to the device and ANDed with the live-slot mask *inside*
the top-k scan (SURVEY §7 hard part #3) — filtering costs one vector
`logical_and`, not a host-side candidate loop.
"""

from __future__ import annotations

import fnmatch
import math
import re
from dataclasses import dataclass, field

import numpy as np

from weaviate_tpu_torch.schema.config import DataType
from weaviate_tpu_torch.text.inverted import InvertedIndex, parse_date
from weaviate_tpu_torch.text.tokenizer import tokenize


class Operator:
    AND = "And"
    OR = "Or"
    NOT = "Not"  # children negated against the full doc set
    EQUAL = "Equal"
    NOT_EQUAL = "NotEqual"
    GREATER_THAN = "GreaterThan"
    GREATER_THAN_EQUAL = "GreaterThanEqual"
    LESS_THAN = "LessThan"
    LESS_THAN_EQUAL = "LessThanEqual"
    LIKE = "Like"
    IS_NULL = "IsNull"
    CONTAINS_ANY = "ContainsAny"
    CONTAINS_ALL = "ContainsAll"
    WITHIN_GEO_RANGE = "WithinGeoRange"

    LOGICAL = {AND, OR, NOT}
    RANGE = {GREATER_THAN, GREATER_THAN_EQUAL, LESS_THAN, LESS_THAN_EQUAL}


@dataclass
class Filter:
    operator: str
    path: str | list[str] | None = None  # property name (list = ref path, last = prop)
    value: object = None
    operands: list["Filter"] = field(default_factory=list)

    # convenience constructors ------------------------------------------------

    @classmethod
    def and_(cls, *operands):
        return cls(Operator.AND, operands=list(operands))

    @classmethod
    def or_(cls, *operands):
        return cls(Operator.OR, operands=list(operands))

    @classmethod
    def not_(cls, *operands):
        return cls(Operator.NOT, operands=list(operands))

    @classmethod
    def where(cls, path: str, operator: str, value):
        return cls(operator, path=path, value=value)

    @property
    def prop(self) -> str:
        if isinstance(self.path, (list, tuple)):
            return self.path[-1]
        return self.path

    # serialization (REST/gRPC where-filter payloads) --------------------------

    def to_dict(self) -> dict:
        d = {"operator": self.operator}
        if self.path is not None:
            d["path"] = self.path if isinstance(self.path, list) else [self.path]
        if self.value is not None:
            d["value"] = self.value
        if self.operands:
            d["operands"] = [o.to_dict() for o in self.operands]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Filter":
        # accept both our canonical form and weaviate REST's typed values
        # (valueText/valueInt/valueNumber/valueBoolean/valueDate/valueGeoRange)
        value = d.get("value")
        if value is None:
            for key in ("valueText", "valueString", "valueInt", "valueNumber",
                        "valueBoolean", "valueDate", "valueGeoRange",
                        "valueTextArray", "valueIntArray", "valueNumberArray",
                        "valueBooleanArray"):
                if key in d:
                    value = d[key]
                    break
        return cls(
            operator=d["operator"],
            path=d.get("path"),
            value=value,
            operands=[cls.from_dict(o) for o in d.get("operands", [])],
        )


def _geo_distance_m(lat1, lon1, lat2, lon2):
    """Haversine distance in meters (vectorized). Reference:
    distancer/geo_spatial.go uses the same great-circle formula."""
    rlat1, rlon1, rlat2, rlon2 = (np.radians(x) for x in (lat1, lon1, lat2, lon2))
    a = (np.sin((rlat2 - rlat1) / 2) ** 2
         + np.cos(rlat1) * np.cos(rlat2) * np.sin((rlon2 - rlon1) / 2) ** 2)
    return 2 * 6_371_000.0 * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def compute_allow_mask(f: Filter, inv: InvertedIndex, size: int) -> np.ndarray:
    """Evaluate a filter tree to a bool mask over [0, size) doc ids."""
    return _eval(f, inv, size)


def _full(inv: InvertedIndex, size: int) -> np.ndarray:
    return _from_ids(inv.all_docs(), size)


def _from_ids(ids, size: int) -> np.ndarray:
    """Sorted id array (or any iterable of ids) -> dense bool mask."""
    mask = np.zeros(size, dtype=bool)
    arr = np.asarray(ids, dtype=np.int64) if not isinstance(ids, np.ndarray) \
        else ids.astype(np.int64, copy=False)
    if len(arr):
        arr = arr[arr < size]
        if len(arr):
            mask[arr] = True
    return mask


def _eval(f: Filter, inv: InvertedIndex, size: int) -> np.ndarray:
    op = f.operator
    if op in Operator.LOGICAL:
        if not f.operands:
            raise ValueError(f"{op} filter requires operands")
        masks = [_eval(o, inv, size) for o in f.operands]
        if op == Operator.AND:
            out = masks[0]
            for m in masks[1:]:
                out = out & m
            return out
        if op == Operator.OR:
            out = masks[0]
            for m in masks[1:]:
                out = out | m
            return out
        # NOT: docs not matching any operand
        out = masks[0]
        for m in masks[1:]:
            out = out | m
        return _full(inv, size) & ~out

    prop = f.prop
    if prop is None:
        raise ValueError(f"filter {op} requires a path")

    if op == Operator.IS_NULL:
        null_mask = _from_ids(inv.null_ids(prop), size)
        if f.value:
            return null_mask
        return _full(inv, size) & ~null_mask

    if op == Operator.WITHIN_GEO_RANGE:
        grid = inv.geo_grid(prop)
        if not len(grid):
            return np.zeros(size, dtype=bool)
        spec = f.value  # {"geoCoordinates": {latitude, longitude}, "distance": {"max": m}}
        center = spec.get("geoCoordinates", spec)
        max_m = float(spec["distance"]["max"] if "distance" in spec
                      else spec["max"])
        clat = float(center["latitude"])
        clon = float(center["longitude"])
        # grid prune first (sublinear), exact haversine on the survivors
        pos = grid.candidate_positions(clat, clon, max_m)
        d = _geo_distance_m(clat, clon, grid.lats[pos], grid.lons[pos])
        mask = np.zeros(size, dtype=bool)
        cand_ids = grid.ids[pos]
        hit = cand_ids[(d <= max_m) & (cand_ids < size)]
        mask[hit] = True
        return mask

    if op in Operator.RANGE:
        threshold = f.value
        if isinstance(threshold, str):
            threshold = parse_date(threshold)
        threshold = float(threshold)
        # LSM range scan over order-preserving numeric keys; array props
        # index every element, giving any-element semantics for free
        # (reference: searcher.go range row readers)
        if op == Operator.GREATER_THAN:
            ids = inv.numeric_range_ids(prop, threshold, None, lo_incl=False)
        elif op == Operator.GREATER_THAN_EQUAL:
            ids = inv.numeric_range_ids(prop, threshold, None, lo_incl=True)
        elif op == Operator.LESS_THAN:
            ids = inv.numeric_range_ids(prop, None, threshold, hi_incl=False)
        else:
            ids = inv.numeric_range_ids(prop, None, threshold, hi_incl=True)
        return _from_ids(ids, size)

    if op == Operator.LIKE:
        # ?/* wildcards range-scanned over the text vocabulary
        # (reference: inverted/like_regexp.go)
        pattern = str(f.value).lower()
        rx = re.compile(fnmatch.translate(pattern))
        mask = np.zeros(size, dtype=bool)
        for token, ids in inv.text_vocab(prop):
            if rx.match(token.lower()):
                mask |= _from_ids(ids, size)
        return mask

    if op in (Operator.EQUAL, Operator.NOT_EQUAL,
              Operator.CONTAINS_ANY, Operator.CONTAINS_ALL):
        values = f.value if isinstance(f.value, (list, tuple)) else [f.value]
        masks = [_match_value(inv, prop, v, size) for v in values]
        if op == Operator.CONTAINS_ALL:
            out = masks[0]
            for m in masks[1:]:
                out = out & m
            return out
        out = masks[0]
        for m in masks[1:]:
            out = out | m
        if op == Operator.NOT_EQUAL:
            return _full(inv, size) & ~out
        return out

    raise ValueError(f"unknown filter operator {op!r}")


def _match_value(inv: InvertedIndex, prop: str, value, size: int) -> np.ndarray:
    """Exact-match a single value against the filterable index. Text values
    tokenize; multi-token text matches docs containing ALL tokens
    (reference Equal-on-text semantics)."""
    if isinstance(value, bool):
        return _from_ids(inv.filterable_ids(prop, value), size)
    if isinstance(value, (int, float)):
        return _from_ids(inv.filterable_ids(prop, float(value)), size)
    if isinstance(value, str):
        # date-valued? keys are floats for date props
        sch = inv.config.property(prop)
        if sch is not None and sch.data_type in (DataType.DATE, DataType.DATE_ARRAY):
            try:
                return _from_ids(inv.filterable_ids(prop, parse_date(value)), size)
            except ValueError:
                return np.zeros(size, dtype=bool)
        if sch is not None and sch.data_type in (DataType.UUID, DataType.UUID_ARRAY):
            return _from_ids(inv.filterable_ids(prop, value), size)
        tokenization = sch.tokenization if sch is not None else "word"
        tokens = tokenize(value, tokenization)
        if not tokens:
            return np.zeros(size, dtype=bool)
        out = _from_ids(inv.filterable_ids(prop, tokens[0]), size)
        for t in tokens[1:]:
            out = out & _from_ids(inv.filterable_ids(prop, t), size)
        return out
    return np.zeros(size, dtype=bool)
