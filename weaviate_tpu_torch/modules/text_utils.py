"""Object -> corpus-text assembly shared by all text2vec modules.

Reference: usecases/modulecomponents/vectorizer/object_texts.go — class name
(camelCase split, lowered) + per-property values for indexed text
properties, optionally prefixed with the (lowered) property name; property
order is sorted for determinism.

Module-config keys honored (same names as the reference class settings):
  vectorizeClassName (default True), properties (allow-list),
  skippedProperties, vectorizePropertyName (default False).
"""

from __future__ import annotations

import re

_CAMEL = re.compile(r"[A-Z]?[a-z0-9]+|[A-Z]+(?![a-z])")


def camel_to_lower(name: str) -> str:
    return " ".join(m.group(0).lower() for m in _CAMEL.finditer(name))


def _text_values(value) -> list[str]:
    if isinstance(value, str):
        return [value.lower()]
    if isinstance(value, (list, tuple)):
        return [v.lower() for v in value if isinstance(v, str)]
    return []


def object_corpus(class_name: str, properties: dict, config: dict,
                  searchable_props: set[str] | None = None) -> str:
    """Build the text that represents one object to the embedder."""
    corpus: list[str] = []
    if config.get("vectorizeClassName", True):
        corpus.append(camel_to_lower(class_name))
    allow = set(config["properties"]) if config.get("properties") else None
    skip = set(config.get("skippedProperties", []))
    for prop_name in sorted(properties):
        if allow is not None and prop_name not in allow:
            continue
        if prop_name in skip:
            continue
        if searchable_props is not None and prop_name not in searchable_props:
            continue
        values = _text_values(properties[prop_name])
        if not values:
            continue
        if config.get("vectorizePropertyName", False):
            lower = camel_to_lower(prop_name)
            values = [f"{lower} {v}" for v in values]
        corpus.extend(values)
    return " ".join(corpus)
