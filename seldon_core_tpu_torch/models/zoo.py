"""Model zoo: named model builders -> (apply_fn, params, metadata).

Port of ``seldon_core_tpu/models/zoo.py`` for ``zoo://`` URIs:
``zoo://<name>[?k=v...]`` builds a registered model with a fresh
deterministic init (numpy draws, so a seed gives the JAX package's
parameters bit for bit) and loads it into a ModelRuntime on the
deployment's device. The graph unit factory serves implementation
``JAX_MODEL`` — the deployment JSON keeps that name so one file serves
both packages.
"""

from __future__ import annotations

import urllib.parse
from dataclasses import dataclass
from typing import Any, Callable

import torch

from seldon_core_tpu_torch.graph.spec import ContainerSpec, PredictiveUnit, parameters_dict
from seldon_core_tpu_torch.models.base import ModelRuntime, ModelUnit

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass
class ModelSpec:
    """What a builder returns: everything needed to instantiate a runtime."""

    apply_fn: Callable[[Any, torch.Tensor], torch.Tensor]
    params: Any  # tree of numpy arrays
    feature_shape: tuple[int, ...]
    class_names: tuple[str, ...] = ()
    # "cast": integer payloads are values; "ids": token ids, kept int32
    int_inputs: str = "cast"


Builder = Callable[..., ModelSpec]
_REGISTRY: dict[str, Builder] = {}


def register_model(name: str):
    def deco(fn: Builder) -> Builder:
        _REGISTRY[name] = fn
        return fn

    return deco


def _register_models() -> None:
    from seldon_core_tpu_torch.models import bert  # noqa: F401 - registers on import


def get_model(name: str, **kwargs) -> ModelSpec:
    if name not in _REGISTRY:
        _register_models()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def _runtime_from_modelspec(ms: ModelSpec, tpu_cfg, device=None) -> ModelRuntime:
    dtype_name = getattr(tpu_cfg, "dtype", "float32")
    if dtype_name not in DTYPES:
        raise ValueError(f"tpu.dtype must be one of {sorted(DTYPES)}, got {dtype_name!r}")
    rt = ModelRuntime(
        ms.apply_fn,
        ms.params,
        device=device,
        buckets=tuple(getattr(tpu_cfg, "batch_buckets", ()) or ()),
        max_batch=getattr(tpu_cfg, "max_batch", 64),
        dtype=DTYPES[dtype_name],
        class_names=ms.class_names,
        int_inputs=ms.int_inputs,
        offload_compute=getattr(tpu_cfg, "offload_compute", "auto"),
    )
    rt.feature_shape = ms.feature_shape
    return rt


def _parse_zoo_uri(uri: str) -> tuple[str, dict]:
    parsed = urllib.parse.urlparse(uri)
    name = parsed.netloc or parsed.path.lstrip("/")
    kwargs: dict[str, Any] = {}
    for k, v in urllib.parse.parse_qsl(parsed.query):
        try:
            kwargs[k] = int(v)
        except ValueError:
            try:
                kwargs[k] = float(v)
            except ValueError:
                kwargs[k] = v
    return name, kwargs


def build_runtime_from_uri(
    uri: str, tpu_cfg, device=None, extra_params: dict | None = None
) -> ModelRuntime:
    """``extra_params``: unit parameters beyond model/model_uri, merged as
    builder kwargs under the URI's own query string (the URI wins)."""
    if not uri.startswith("zoo://"):
        raise ValueError(f"unsupported model_uri '{uri}' (the torch port serves zoo:// only)")
    name, kwargs = _parse_zoo_uri(uri)
    ms = get_model(name, **{**(extra_params or {}), **kwargs})
    return _runtime_from_modelspec(ms, tpu_cfg, device)


def make_model_unit(spec: PredictiveUnit, context: dict) -> ModelUnit:
    """Factory for implementation=JAX_MODEL units: the model comes from a
    unit parameter ``model_uri`` (or the ``model`` shorthand), or from the
    unit's container; every other unit parameter is a builder kwarg."""
    params = parameters_dict(spec.parameters)
    uri = params.get("model_uri") or (
        f"zoo://{params['model']}" if "model" in params else None
    )
    extra = {k: v for k, v in params.items() if k not in ("model", "model_uri")}
    if uri is None:
        container = (context.get("containers") or {}).get(spec.name)
        uri = getattr(container, "model_uri", "") or None
    if uri is None:
        raise ValueError(f"JAX_MODEL unit '{spec.name}' needs a model_uri parameter")
    runtime = build_runtime_from_uri(
        uri, context.get("tpu"), context.get("device"), extra_params=extra
    )
    return ModelUnit(spec, runtime)


def unit_from_container(spec: PredictiveUnit, container: ContainerSpec, context: dict) -> ModelUnit:
    runtime = build_runtime_from_uri(container.model_uri, context.get("tpu"), context.get("device"))
    return ModelUnit(spec, runtime)
