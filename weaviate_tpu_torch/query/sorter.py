"""Object sorting by property paths / id / special keys.

Reference: adapters/repos/db/sorter/ — comparators for every property
data type with explicit null ordering (basic_comparators.go), applied to
result sets before pagination; search results carry their distances
through the sort (objects_sorter.go:21 Sort(objects, distances)).
"""

from __future__ import annotations

from weaviate_tpu_torch.query.aggregator import _parse_date


def _sort_key_value(obj, path: str):
    """Extract a comparable value; None sorts last regardless of order."""
    if path in ("_id", "id", "uuid"):
        return obj.uuid
    if path == "_creationTimeUnix":
        return getattr(obj, "creation_time_ms", 0)
    if path == "_lastUpdateTimeUnix":
        return getattr(obj, "last_update_time_ms", 0)
    v = obj.properties.get(path)
    if isinstance(v, str):
        try:
            return _parse_date(v)  # dates sort on the timeline
        except ValueError:
            return v
    if isinstance(v, list):
        return len(v)  # reference sorts arrays by length
    if isinstance(v, bool):
        return int(v)
    return v


def _multikey_sort(items: list, sort_specs: list[dict], key_of) -> list:
    """Stable multi-key sort applied right-to-left so the first spec
    dominates (reference: objects_sorter.go). ``key_of(item, path)``
    extracts the comparable; None sorts last regardless of order, and
    mixed-type keys compare within the dominant type (others go last)."""
    out = list(items)
    for spec in reversed(sort_specs):
        path = spec["path"] if isinstance(spec["path"], str) else spec["path"][0]
        desc = spec.get("order", "asc") == "desc"
        keyed = [(key_of(it, path), it) for it in out]
        nones = [it for kv, it in keyed if kv is None]
        present = [(kv, it) for kv, it in keyed if kv is not None]
        try:
            present.sort(key=lambda t: t[0], reverse=desc)
        except TypeError:
            present.sort(key=lambda t: (str(type(t[0])), str(t[0])),
                         reverse=desc)
        out = [it for _, it in present] + nones
    return out


def sort_objects(objects: list, sort_specs: list[dict]) -> list:
    """Stable multi-key sort of StorageObjects. ``sort_specs``:
    [{"path": "name", "order": "asc"|"desc"}, ...]."""
    return _multikey_sort(objects, sort_specs, _sort_key_value)


def sort_search_results(results: list, sort_specs: list[dict]) -> list:
    """Sort SEARCH results (SearchResult: .object/.distance/.score) —
    the reference's objects_sorter.go:21 Sort(objects, distances) keeps
    the object<->distance pairing through the sort; the special paths
    ``_distance``/``distance`` and ``_score`` sort the search metric
    itself, composing with property keys in one stable multi-key sort."""

    def key_of(r, path: str):
        if path in ("_distance", "distance"):
            return r.distance
        if path in ("_score", "score"):
            return r.score
        if r.object is None:
            return r.uuid if path in ("_id", "id", "uuid") else None
        return _sort_key_value(r.object, path)

    return _multikey_sort(results, sort_specs, key_of)
