"""Model zoo: named model builders -> (apply_fn, params, metadata).

Port of ``seldon_core_tpu/models/zoo.py`` for ``zoo://`` URIs:
``zoo://<name>[?k=v...]`` builds a registered model with a fresh
deterministic init and loads it into a ModelRuntime on the deployment's
device. The graph unit factory serves implementation ``JAX_MODEL`` — the
deployment JSON keeps that name so one file serves both packages.

Initialisation: ``bert_*`` and ``resnet*`` draw with numpy in the JAX
package, and the port makes the same draws, so a seed gives that package's
parameters bit for bit. The small models here (``iris_logistic``,
``iris_mlp``, ``mnist_mlp``) draw with ``jax.random`` there; the port
cannot repeat those draws without JAX and draws with
``np.random.default_rng(seed)`` instead, so their weights differ between
the packages for the same seed (tests carry the JAX parameters across).

Apply functions are module-level, not per-build closures: two builds of
one architecture share function identity, which is what lets graph fusion
(``engine/fused.py``) stack their parameters and vmap once.
"""

from __future__ import annotations

import inspect
import threading
import urllib.parse
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
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
    # numpy leaf -> array or tensor in the port's layout, applied once at
    # load (models/convert.py); None keeps the JAX package's layout
    layout: Callable[[np.ndarray], Any] | None = None


Builder = Callable[..., ModelSpec]
_REGISTRY: dict[str, Builder] = {}


def register_model(name: str):
    def deco(fn: Builder) -> Builder:
        _REGISTRY[name] = fn
        return fn

    return deco


def _register_models() -> None:
    from seldon_core_tpu_torch.models import bert, resnet  # noqa: F401 - register on import


# Heavy builds are memoized per (name, builder-relevant kwargs): a same-seed
# build is deterministic and nothing downstream writes into the parameters
# (ModelRuntime copies them to the device), so the ensemble's three ResNet50s
# and a second server of the same deployment build each seed once. Bounded
# LRU; a lock serializes the table, and concurrent first builds of one key
# wait for the builder instead of building twice.
_HEAVY_CACHE: OrderedDict[tuple, ModelSpec] = OrderedDict()
_HEAVY_CACHE_MAX = 4
_CACHEABLE = frozenset({"resnet50", "bert_base"})
_HEAVY_CACHE_LOCK = threading.Lock()
_HEAVY_BUILDING: dict[tuple, threading.Event] = {}


def _heavy_cache_key(name: str, kwargs: dict) -> tuple | None:
    """(name, kwargs restricted to the builder's own parameters, defaults
    filled in): unit parameters the builder swallows through ``**_`` do not
    split the key, nor does spelling out a default. None when a value is
    unhashable (then the build is not cached)."""
    sig = inspect.signature(_REGISTRY[name])
    named = {
        k: p for k, p in sig.parameters.items() if p.kind is not inspect.Parameter.VAR_KEYWORD
    }
    bound = sig.bind_partial(**{k: v for k, v in kwargs.items() if k in named})
    bound.apply_defaults()
    key = (name, tuple(sorted((k, v) for k, v in bound.arguments.items() if k in named)))
    try:
        hash(key)
    except TypeError:
        return None
    return key


def get_model(name: str, **kwargs) -> ModelSpec:
    if name not in _REGISTRY:
        _register_models()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; known: {sorted(_REGISTRY)}")
    key = _heavy_cache_key(name, kwargs) if name in _CACHEABLE else None
    if key is None:
        return _REGISTRY[name](**kwargs)
    with _HEAVY_CACHE_LOCK:
        if key in _HEAVY_CACHE:
            _HEAVY_CACHE.move_to_end(key)
            return _HEAVY_CACHE[key]
        in_flight = _HEAVY_BUILDING.get(key)
        am_builder = in_flight is None
        if am_builder:
            in_flight = _HEAVY_BUILDING[key] = threading.Event()
    if not am_builder:
        in_flight.wait()
        with _HEAVY_CACHE_LOCK:
            if key in _HEAVY_CACHE:
                _HEAVY_CACHE.move_to_end(key)
                return _HEAVY_CACHE[key]
        # the builder raised: build for ourselves, uncached
        return _REGISTRY[name](**kwargs)
    try:
        spec = _REGISTRY[name](**kwargs)
        with _HEAVY_CACHE_LOCK:
            _HEAVY_CACHE[key] = spec
            while len(_HEAVY_CACHE) > _HEAVY_CACHE_MAX:
                _HEAVY_CACHE.popitem(last=False)
        return spec
    finally:
        with _HEAVY_CACHE_LOCK:
            _HEAVY_BUILDING.pop(key, None)
        in_flight.set()


# ------------------------------------------------------------------ builders


def _dense_init(rng: np.random.Generator, n_in: int, n_out: int) -> dict:
    scale = (2.0 / n_in) ** 0.5
    return {
        "w": (rng.standard_normal((n_in, n_out)) * scale).astype(np.float32),
        "b": np.zeros((n_out,), np.float32),
    }


def dense(p, x):
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    """Serving probabilities: float32 whatever the compute dtype (they leave
    as float32; rounding them to bfloat16 first would cost each row's sum up
    to 4e-3)."""
    return torch.softmax(logits, dim=-1, dtype=torch.float32)


def _apply_logistic(p, x):
    return softmax_f32(dense(p, x))


def _apply_mlp2(p, x):
    return softmax_f32(dense(p["l2"], torch.relu(dense(p["l1"], x))))


def _apply_mean_sigmoid(p, x):
    return torch.sigmoid(x.mean(dim=-1, keepdim=True))


def _apply_mlp3_flat(p, x):
    x = x.reshape(x.shape[0], -1)
    h = torch.relu(dense(p["l1"], x))
    h = torch.relu(dense(p["l2"], h))
    return softmax_f32(dense(p["l3"], h))


_IRIS_CLASSES = ("setosa", "versicolor", "virginica")


@register_model("iris_logistic")
def build_iris_logistic(seed: int = 0, **_) -> ModelSpec:
    """Logistic head, 4 features -> 3 classes (the sklearn-iris equivalent)."""
    return ModelSpec(_apply_logistic, _dense_init(np.random.default_rng(seed), 4, 3), (4,), _IRIS_CLASSES)


@register_model("iris_mlp")
def build_iris_mlp(seed: int = 0, hidden: int = 32, **_) -> ModelSpec:
    rng = np.random.default_rng(seed)
    params = {"l1": _dense_init(rng, 4, hidden), "l2": _dense_init(rng, hidden, 3)}
    return ModelSpec(_apply_mlp2, params, (4,), _IRIS_CLASSES)


@register_model("mean_classifier")
def build_mean_classifier(**_) -> ModelSpec:
    """Sigmoid of the feature mean -> a single score."""
    return ModelSpec(_apply_mean_sigmoid, {}, (4,), ("proba",))


@register_model("mnist_mlp")
def build_mnist_mlp(seed: int = 0, hidden: int = 512, **_) -> ModelSpec:
    """Deep-MNIST equivalent: flat 784 input -> 10 softmax."""
    rng = np.random.default_rng(seed)
    params = {
        "l1": _dense_init(rng, 784, hidden),
        "l2": _dense_init(rng, hidden, hidden),
        "l3": _dense_init(rng, hidden, 10),
    }
    return ModelSpec(_apply_mlp3_flat, params, (784,), tuple(str(i) for i in range(10)))


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
        layout=ms.layout,
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
