"""CRD openAPIV3 validation schema, derived from the dataclass contract.

Port of ``seldon_core_tpu/operator/crd_schema.py``. The reference ships CRD
validation produced by expanding swagger ``$ref``s to finite depth so the
recursive ``PredictiveUnit`` graph can be validated by the API server
(util/custom-resource-definitions/expand-validation.py). The JAX package
compiles pydantic's ``SeldonDeployment.model_json_schema()``; the port's
spec is frozen dataclasses (``graph/spec.py``), so this module first
derives the same JSON schema from their type hints, in pydantic's shape:

- each dataclass and each ``str`` enum is one ``$defs`` entry reached by
  ``$ref`` (so the recursive ``PredictiveUnit.children`` stays finite);
- ``Optional[X]`` is ``anyOf [X, {"type": "null"}]``; ``tuple[X, ...]`` an
  array of X; ``Mapping[str, X]`` an object with ``additionalProperties``;
- fields without a default are ``required``; a class's own docstring is
  its ``description``.

It then compiles that into a Kubernetes *structural* schema exactly as the
JAX package does (``_compile``, copied):

- every ``$ref`` is inlined (k8s forbids refs);
- the recursive ``PredictiveUnit.children`` ref expands to a finite depth
  (deeper graphs still apply — the leaf level degrades to a permissive
  object and the operator's full validation (graph/validation.py) takes
  over, the reference's split of API-server vs operator checks);
- ``anyOf [X, null]`` optionals collapse to ``X`` + ``nullable: true``;
- objects without declared properties carry
  ``x-kubernetes-preserve-unknown-fields``.

``TpuSpec.extra`` is no field of the contract. A JAX spec knob the port
reads from it and refuses by name (``graph/validation.py::
UNPORTED_DECODE_KNOBS``, none at present) would stay in the schema with its
JAX type (``_EXTRA_FIELDS``): a structural schema prunes unknown fields, and
a pruned knob would reach the operator silently dropped instead of refused.
"""

from __future__ import annotations

import enum
import inspect
import typing
from collections.abc import Mapping
from dataclasses import MISSING, fields, is_dataclass
from typing import Any, Union

# deep enough for every shipped example (deepest: transformer -> router ->
# model over combiner = 4) with headroom; the API server rejects absurdly
# nested schemas, so this is a bound, not a target
DEFAULT_GRAPH_DEPTH = 8

_DROP_KEYS = ("title", "default", "discriminator", "definitions", "$defs")

# (class, field) pairs that are not part of the CR contract
_SKIP_FIELDS = frozenset({("TpuSpec", "extra")})
# fields of the JAX contract that the port keeps outside its dataclasses:
# class -> {field: type hint}
_EXTRA_FIELDS: dict[str, dict[str, Any]] = {}

_PRIMITIVES = {str: "string", int: "integer", float: "number", bool: "boolean"}


def _description(cls) -> str | None:
    """The class's own docstring, cleaned as pydantic cleans it; None for
    the signature line ``dataclass`` writes when there is none."""
    doc = cls.__dict__.get("__doc__")
    if not doc or doc.startswith(f"{cls.__name__}("):
        return None
    return inspect.cleandoc(doc)


def _type_schema(tp: Any, defs: dict) -> dict:
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if origin is Union:
        opts = [a for a in args if a is not type(None)]
        out = [_type_schema(a, defs) for a in opts]
        if len(opts) < len(args):
            out.append({"type": "null"})
        return {"anyOf": out}
    if origin in (tuple, list):
        return {"items": _type_schema(args[0], defs), "type": "array"}
    if origin in (dict, Mapping):
        return {"additionalProperties": _type_schema(args[1], defs), "type": "object"}
    if tp is Any:
        return {}
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        defs.setdefault(tp.__name__, {"enum": [m.value for m in tp], "title": tp.__name__, "type": "string"})
        return {"$ref": f"#/$defs/{tp.__name__}"}
    if is_dataclass(tp):
        if tp.__name__ not in defs:
            defs[tp.__name__] = {}  # a recursive reference finds the name taken
            defs[tp.__name__] = _object_schema(tp, defs)
        return {"$ref": f"#/$defs/{tp.__name__}"}
    if tp in _PRIMITIVES:
        return {"type": _PRIMITIVES[tp]}
    raise TypeError(f"no JSON schema for {tp!r}")


def _object_schema(cls, defs: dict) -> dict:
    hints = typing.get_type_hints(cls)
    props: dict = {}
    required: list[str] = []
    for f in fields(cls):
        if (cls.__name__, f.name) in _SKIP_FIELDS:
            continue
        props[f.name] = _type_schema(hints[f.name], defs)
        if f.default is MISSING and f.default_factory is MISSING:
            required.append(f.name)
    for name, hint in _EXTRA_FIELDS.get(cls.__name__, {}).items():
        props[name] = _type_schema(hint, defs)
    out: dict = {}
    doc = _description(cls)
    if doc is not None:
        out["description"] = doc
    out["properties"] = props
    if required:
        out["required"] = required
    out["title"] = cls.__name__
    out["type"] = "object"
    return out


def model_json_schema(cls) -> dict:
    """``cls``'s JSON schema in pydantic's shape: the root object with every
    nested dataclass and enum under ``$defs``."""
    defs: dict = {}
    root = _object_schema(cls, defs)
    if defs:
        root["$defs"] = dict(sorted(defs.items()))
    return root


def _is_nullable_anyof(node: dict) -> Any:
    opts = [o for o in node.get("anyOf", ()) if o != {"type": "null"}]
    if len(opts) == 1 and len(opts) + 1 == len(node["anyOf"]):
        return opts[0]
    return None


def _compile(node: Any, defs: dict, depth_left: int) -> Any:
    if isinstance(node, list):
        return [_compile(n, defs, depth_left) for n in node]
    if not isinstance(node, dict):
        return node

    if "$ref" in node:
        name = node["$ref"].rsplit("/", 1)[-1]
        if name == "PredictiveUnit":
            if depth_left <= 0:
                # graph deeper than the expansion: API server passes it
                # through, operator validation still applies in full
                return {"type": "object", "x-kubernetes-preserve-unknown-fields": True}
            depth_left -= 1
        return _compile(defs[name], defs, depth_left)

    inner = _is_nullable_anyof(node)
    if inner is not None:
        out = _compile(inner, defs, depth_left)
        if isinstance(out, dict):
            out = {**out, "nullable": True}
        return out

    out = {}
    for key, value in node.items():
        if key in _DROP_KEYS:
            continue
        if key == "anyOf":
            # residual general anyOf is not structural; degrade to permissive
            return {"type": "object", "x-kubernetes-preserve-unknown-fields": True}
        if key == "additionalProperties" and value is True:
            out["x-kubernetes-preserve-unknown-fields"] = True
            continue
        out[key] = _compile(value, defs, depth_left)

    if (
        out.get("type") == "object"
        and "properties" not in out
        and "additionalProperties" not in out
    ):
        # a map with a typed additionalProperties schema has no unknown
        # fields to preserve (and the flag beside it can trip structural
        # validation); only truly shapeless objects get the escape hatch
        out.setdefault("x-kubernetes-preserve-unknown-fields", True)
    return out


def deployment_validation_schema(max_graph_depth: int = DEFAULT_GRAPH_DEPTH) -> dict:
    """Structural openAPIV3 schema for the SeldonDeployment ``spec`` field."""
    from seldon_core_tpu_torch.graph.spec import SeldonDeployment

    schema = model_json_schema(SeldonDeployment)
    defs = schema.get("$defs", {})
    spec_schema = schema["properties"]["spec"]
    return _compile(spec_schema, defs, max_graph_depth)
