"""Declarative request-body validation for the REST /v1 surface.

Reference: go-swagger validates every body against the OpenAPI spec
(adapters/handlers/rest/embedded_spec.go) and answers 422 with structured
errors before any handler runs. This is the hand-rolled equivalent for the
write payloads: a compact spec language (required fields, typed fields,
nested specs) that produces the same shaped failures — field path + what
was expected — instead of handler-level 500s or silent coercion.
"""

from __future__ import annotations

import uuid as uuid_mod


def _type_name(spec) -> str:
    return {
        "str": "string", "num": "number", "int": "integer",
        "bool": "boolean", "dict": "object", "uuid": "uuid string",
        "vector": "number array", "strlist": "string array",
    }.get(spec, str(spec))


def _check(value, spec, path: str, errors: list[str]):
    if spec == "str":
        if not isinstance(value, str):
            errors.append(f"{path} must be a string")
    elif spec == "num":
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            errors.append(f"{path} must be a number")
    elif spec == "int":
        if isinstance(value, bool) or not isinstance(value, int):
            errors.append(f"{path} must be an integer")
    elif spec == "bool":
        if not isinstance(value, bool):
            errors.append(f"{path} must be a boolean")
    elif spec == "dict":
        if not isinstance(value, dict):
            errors.append(f"{path} must be an object")
    elif spec == "uuid":
        if not isinstance(value, str):
            errors.append(f"{path} must be a uuid string")
        else:
            try:
                uuid_mod.UUID(value)
            except ValueError:
                errors.append(f"{path} is not a valid uuid")
    elif spec == "vector":
        if not isinstance(value, list) or any(
                isinstance(v, bool) or not isinstance(v, (int, float))
                for v in value):
            errors.append(f"{path} must be a number array")
    elif spec == "strlist":
        if not isinstance(value, list) or any(
                not isinstance(v, str) for v in value):
            errors.append(f"{path} must be a string array")
    elif spec == "str_or_strlist":
        if not (isinstance(value, str) or (
                isinstance(value, list)
                and all(isinstance(v, str) for v in value))):
            errors.append(f"{path} must be a string or string array")
    elif isinstance(spec, dict):
        _check_obj(value, spec, path, errors)
    elif isinstance(spec, list):  # homogeneous list of sub-spec
        if not isinstance(value, list):
            errors.append(f"{path} must be an array")
        else:
            for i, v in enumerate(value):
                _check(v, spec[0], f"{path}[{i}]", errors)


def _check_obj(value, spec: dict, path: str, errors: list[str]):
    if not isinstance(value, dict):
        errors.append(f"{path} must be an object")
        return
    for name in spec.get("required", ()):
        # "a|b" = alternatives (the surface accepts lenient aliases,
        # e.g. class/name, dataType/data_type)
        alts = name.split("|")
        if all(value.get(a) in (None, "") for a in alts):
            errors.append(f"{path}.{alts[0]} is required")
    for name, sub in spec.get("fields", {}).items():
        if name in value and value[name] is not None:
            _check(value[name], sub, f"{path}.{name}", errors)


OBJECT = {
    "required": (),
    "fields": {
        "class": "str",
        "collection": "str",
        "id": "uuid",
        "properties": "dict",
        "vector": "vector",
        "vectors": "dict",
        "tenant": "str",
    },
}

BATCH_OBJECTS = {
    "fields": {
        "objects": [OBJECT],
        "fields": "strlist",
    },
}

SCHEMA_CLASS = {
    "required": ("class|name",),
    "fields": {
        "class": "str",
        "name": "str",
        "description": "str",
        "vectorizer": "str",
        "vectorIndexType": "str",
        "vectorIndexConfig": "dict",
        "invertedIndexConfig": "dict",
        "replicationConfig": "dict",
        "shardingConfig": "dict",
        "multiTenancyConfig": "dict",
        "moduleConfig": "dict",
        "properties": [{
            "required": ("name", "dataType|data_type|dataTypes"),
            "fields": {
                "name": "str",
                "dataType": "str_or_strlist",
                "data_type": "str_or_strlist",
                "description": "str",
                "tokenization": "str",
                "indexFilterable": "bool",
                "indexSearchable": "bool",
            },
        }],
    },
}

REFERENCE = {
    "required": ("beacon",),
    "fields": {"beacon": "str"},
}

CLASSIFICATION = {
    "required": ("class", "classifyProperties"),
    "fields": {
        "class": "str",
        "classifyProperties": "strlist",
        "basedOnProperties": "strlist",
        "type": "str",
        "settings": "dict",
    },
}

BACKUP = {
    "required": ("id",),
    "fields": {"id": "str", "include": "strlist", "exclude": "strlist",
               "config": "dict"},
}


def validate_body(spec: dict, body, what: str = "body") -> None:
    """Raise ValueError (REST maps it to 422) listing EVERY structural
    problem, not just the first — the reference's swagger errors do the
    same."""
    errors: list[str] = []
    _check_obj(body, spec, what, errors)
    if errors:
        raise ValueError("; ".join(errors))
