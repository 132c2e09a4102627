"""Model zoo: named model builders -> (apply_fn, params, metadata).

Port of ``seldon_core_tpu/models/zoo.py``: ``zoo://<name>[?k=v...]``
builds a registered model with a fresh deterministic init, ``file://<dir>``
restores a checkpoint either package wrote and ``hf-bert://<dir>`` imports
a Hugging Face BERT classifier, each into a ModelRuntime on the
deployment's device. The graph unit factory serves implementation
``JAX_MODEL`` — the deployment JSON keeps that name so one file serves both
packages.

Initialisation: ``bert_*``, ``resnet*`` and ``tiny_gpt`` draw with numpy in
the JAX package, and the port makes the same draws, so a seed gives that package's
parameters bit for bit. The small models here (``iris_logistic``,
``iris_mlp``, ``mnist_mlp``) draw with ``jax.random`` there; the port
cannot repeat those draws without JAX and draws with
``np.random.default_rng(seed)`` instead, so their weights differ between
the packages for the same seed (tests carry the JAX parameters across).

Apply functions are module-level, not per-build closures: two builds of
one architecture share function identity, which is what lets graph fusion
(``engine/fused.py``) stack their parameters and vmap once.

On a mesh (``parallel/mesh.py``) a runtime takes the spec's
``apply_factory(mesh)`` (the JAX package's hook: ``bert_*`` for ring,
Ulysses and tensor parallelism, ``moe_mlp`` for expert parallelism,
``pipe_mlp`` for pipeline stages) and places the parameters per position
from ``param_pspecs``; a model without a factory runs its single-position
apply on each data lead. ``moe_mlp`` and ``pipe_mlp`` draw their dense
layers with ``jax.random`` in the JAX package and with numpy here (as the
small models above do); ``init_moe`` is the JAX package's numpy draw.
A ``finetune`` unit trains over whatever mesh it serves on
(``models/online.py``). A generative model (``tiny_gpt``, no
``param_pspecs``) serves its fused ``generate`` on any ``tpu.mesh`` as the
JAX package runs it: parameters replicated, the batch split over the
"data" leads, other axes replicated, buckets rounded up to the data axis's
multiple; tensor-parallel decode is ``tpu.decode_mesh_axes``
(``parallel/tp.py``). With ``tpu.weight_quant="int8"`` a generative model
serves on int8 weights (``models/decoder.py``), through the fused path.
"""

from __future__ import annotations

import inspect
import logging
import threading
import urllib.parse
from collections import OrderedDict
from functools import partial
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from seldon_core_tpu_torch.graph.spec import (
    TYPE_METHODS,
    ContainerSpec,
    PredictiveUnit,
    PredictiveUnitMethod,
    bool_param,
    parameters_dict,
)
from seldon_core_tpu_torch.models.base import ModelRuntime, ModelUnit
from seldon_core_tpu_torch.models.quant import is_quantized_leaf, payload
from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul
from seldon_core_tpu_torch.parallel.pipeline import stage_of

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
    # generative decoders advertise their decode geometry ({"seq": prompt
    # bucket, "max_new_tokens": cap}) so serving can offer the
    # continuous-batching scheduler (tpu.decode_slots)
    generative: dict | None = None
    # the partition rule of the parameter tree over mesh axes (a tree of
    # parallel.mesh.P); None replicates every leaf
    param_pspecs: Any = None
    # mesh -> the apply to serve on it (a parallel.mesh.MeshApply); None
    # runs apply_fn on each data lead
    apply_factory: Callable[[Any], Any] | None = None


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
# tiny_gpt and draft at GPT-2-small widths take seconds of numpy draws, and
# a speculative deployment is served beside its eager twin and a copy with
# speculation off; a distilled draft is not cached (its file may change)
_CACHEABLE = frozenset({"resnet50", "bert_base", "tiny_gpt", "draft"})
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
    key = _heavy_cache_key(name, kwargs) if name in _CACHEABLE and not kwargs.get("distilled") else None
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
    """x @ w + b; a quantized ``w`` goes through the W8A16 kernel
    (``ops/int8_matmul.py``), which dequantizes in registers."""
    w = p["w"]
    if is_quantized_leaf(w):
        return int8_matmul(x, payload(w), w["scale"], p["b"])
    return x @ w.to(x.dtype) + p["b"].to(x.dtype)


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


def _pipe_stage_fn(p, h):
    """One pipeline stage: a residual tanh block, [mb, d] -> [mb, d]."""
    return h + torch.tanh(h @ p["w"].to(h.dtype) + p["b"].to(h.dtype))


def _apply_pipe_tower_seq(p, x):
    """The stages in turn on one position: the math the pipelined path
    computes."""
    h = dense(p["embed"], x)
    for s in range(p["stages"]["w"].shape[0]):
        h = _pipe_stage_fn(stage_of(p["stages"], s), h)
    return softmax_f32(dense(p["head"], h))


def _pipe_apply_factory(mesh):
    """A "pipe" axis runs the stages as a GPipe pipeline, one stage per
    position (``parallel/pipeline.py``), with ``n_stages`` microbatches
    where the bucket divides, else one; without it the stacked stages run
    in turn on each data lead."""
    from seldon_core_tpu_torch.parallel.collectives import replicated
    from seldon_core_tpu_torch.parallel.mesh import PIPE_AXIS, MeshApply, data_parallel, memoised_apply
    from seldon_core_tpu_torch.parallel.pipeline import pipeline_shards

    if PIPE_AXIS not in mesh.shape:
        return data_parallel(_apply_pipe_tower_seq, mesh)
    n_stages = mesh.shape[PIPE_AXIS]

    def apply_pipelined(params, xs):
        batch = xs[0].shape[0]
        m = n_stages if batch % n_stages == 0 else 1

        def micro(p, x):
            h = dense(p["embed"], x)
            return h.reshape(m, batch // m, h.shape[-1])

        stages = [stage_of(p["stages"], 0) for p in params]  # each position holds [1, ...] of the stack
        outs = pipeline_shards(_pipe_stage_fn, stages, replicated(micro, mesh, PIPE_AXIS, params, xs), mesh, PIPE_AXIS)
        out: list = [None] * mesh.size
        for lead in mesh.leads():
            out[lead] = softmax_f32(dense(params[lead]["head"], outs[lead].reshape(batch, -1)))
        return out

    return memoised_apply(("pipe_mlp", mesh), lambda: MeshApply(apply_pipelined, mesh, "pipe_mlp"))


@register_model("pipe_mlp")
def build_pipe_mlp(seed: int = 0, n_in: int = 16, d: int = 64, stages: int = 4, classes: int = 3, **_) -> ModelSpec:
    """Pipeline-parallel serving model: a residual MLP tower whose stages
    shard one per position over a "pipe" mesh axis (``tpu.mesh: {"pipe":
    S}``); without one the same stacked parameters run in turn, so the
    deployment alone decides the strategy."""
    from seldon_core_tpu_torch.parallel.mesh import P

    rng = np.random.default_rng(seed)
    params = {
        "embed": _dense_init(rng, n_in, d),
        "stages": {
            "w": (rng.standard_normal((stages, d, d)) * (1.0 / d) ** 0.5).astype(np.float32),
            "b": np.zeros((stages, d), np.float32),
        },
        "head": _dense_init(rng, d, classes),
    }
    pspecs = {"embed": {"w": P(), "b": P()}, "stages": {"w": P("pipe"), "b": P("pipe")},
              "head": {"w": P(), "b": P()}}
    return ModelSpec(_apply_pipe_tower_seq, params, (n_in,), tuple(f"c{i}" for i in range(classes)),
                     param_pspecs=pspecs, apply_factory=_pipe_apply_factory)


def _apply_moe_mlp(p, x):
    """[batch, features] -> class probabilities through a top-1 MoE FFN:
    embed, a residual MoE block over a one-token sequence, softmax head."""
    from seldon_core_tpu_torch.ops.moe import moe_ffn

    h = dense(p["embed"], x)[:, None, :]
    h = h + moe_ffn(p["moe"], h)
    return softmax_f32(dense(p["head"], h[:, 0, :]))


def _moe_apply_factory(mesh):
    """An "expert" axis splits the experts over its positions
    (``ops/moe.py::moe_ffn_shards``: each position's slab, then one psum);
    without one each data lead computes every expert."""
    from seldon_core_tpu_torch.ops.moe import moe_ffn_shards
    from seldon_core_tpu_torch.parallel.collectives import replicated
    from seldon_core_tpu_torch.parallel.mesh import EXPERT_AXIS, MeshApply, data_parallel, memoised_apply

    if EXPERT_AXIS not in mesh.shape:
        return data_parallel(_apply_moe_mlp, mesh)

    def apply_experts(params, xs):
        hs = replicated(lambda p, x: dense(p["embed"], x)[:, None, :], mesh, EXPERT_AXIS, params, xs)
        moe = moe_ffn_shards([p["moe"] for p in params], hs, mesh, EXPERT_AXIS)
        out: list = [None] * mesh.size
        for lead in mesh.leads():
            out[lead] = softmax_f32(dense(params[lead]["head"], (hs[lead] + moe[lead])[:, 0, :]))
        return out

    return memoised_apply(("moe_mlp", mesh), lambda: MeshApply(apply_experts, mesh, "moe_mlp"))


@register_model("moe_mlp")
def build_moe_mlp(seed: int = 0, n_in: int = 16, d_model: int = 64, d_ff: int = 128, n_experts: int = 8,
                  classes: int = 3, **_) -> ModelSpec:
    """Expert-parallel serving model: a mixture-of-experts classifier whose
    expert weights split over the mesh "expert" axis (``ops/moe.py::
    moe_pspecs``); without a mesh the same parameters serve dense."""
    from seldon_core_tpu_torch.ops.moe import init_moe, moe_pspecs
    from seldon_core_tpu_torch.parallel.mesh import P

    rng = np.random.default_rng((seed, 1))  # apart from init_moe's own stream
    params = {
        "embed": _dense_init(rng, n_in, d_model),
        "moe": init_moe(seed, d_model=d_model, d_ff=d_ff, n_experts=n_experts),
        "head": _dense_init(rng, d_model, classes),
    }
    pspecs = {"embed": {"w": P(), "b": P()}, "moe": moe_pspecs(), "head": {"w": P(), "b": P()}}
    return ModelSpec(_apply_moe_mlp, params, (n_in,), tuple(f"c{i}" for i in range(classes)),
                     param_pspecs=pspecs, apply_factory=_moe_apply_factory)


@register_model("tiny_gpt")
def build_tiny_gpt(
    seed: int = 0,
    vocab: int = 512,
    hidden: int = 128,
    layers: int = 2,
    ffn: int = 256,
    max_len: int = 128,
    seq: int = 32,
    max_new_tokens: int = 16,
    resid_scale: float = 1.0,
    **_,
) -> ModelSpec:
    """GPT-style causal decoder served by greedy KV-cache generation
    (models/decoder.py): prefill through the causal attention policy (the
    flash kernel on the card from 4096 tokens), then single-token steps.
    The prompt bucket and ``max_new_tokens`` are deployment parameters.
    Wire: int token ids in, ids out ([b, seq + max_new_tokens], int32)."""
    from seldon_core_tpu_torch.models.decoder import init_decoder

    if seq + max_new_tokens > max_len:
        raise ValueError(
            f"seq={seq} + max_new_tokens={max_new_tokens} exceeds "
            f"max_len={max_len} — raise max_len"
        )
    params = init_decoder(
        seed, vocab=vocab, hidden=hidden, layers=layers, ffn=ffn, max_len=max_len,
        resid_scale=resid_scale,
    )
    return ModelSpec(
        partial(_apply_tiny_gpt, max_new_tokens=max_new_tokens),
        params,
        (seq,),
        int_inputs="ids",
        generative={"seq": seq, "max_new_tokens": max_new_tokens},
    )


@register_model("draft")
def build_draft(
    seed: int = 0,
    vocab: int = 512,
    hidden: int = 128,
    layers: int = 1,
    ffn: int = 256,
    max_len: int = 128,
    resid_scale: float = 1.0,
    seq: int = 32,
    max_new_tokens: int = 16,
    distilled: str = "",
    features: int = 0,
    **_,
) -> ModelSpec:
    """Draft decoder for speculative decoding (``tpu.decode_draft_model``):
    ``tiny_gpt`` with a one-layer default, and it delegates to
    ``build_tiny_gpt``. ``init_decoder`` draws positionally from one seeded
    generator, so a draft built with the target's seed, vocab, hidden, ffn
    and max_len (the scheduler injects vocab and max_len) IS the target's
    embeddings and leading layers: early-exit self-speculation. With the
    default init the truncated layers carry little of the target's logits;
    builds meant as drafts set ``resid_scale`` on both, so the shared
    prefix carries the prediction.

    ``features=1`` builds the EAGLE-style feature-draft head instead
    (``models/decoder.init_feature_draft``): one layer whose input fuses the
    target's last hidden state with the token embedding. ``hidden`` must be
    the target's (the scheduler injects it, and ``ffn``, from the target);
    ``layers`` and ``resid_scale`` do not apply. The head serves only
    through ``tpu.decode_draft_model``: its apply raises to say so.

    ``distilled=/path/to.npz`` refills either kind's weights from a
    distillation checkpoint (``training/distill_draft.py``, the JAX
    package's ``.npz`` format, so each package reads the other's). The
    load asserts every leaf's shape against this build's, so the URI still
    carries the whole geometry and ``distilled`` only swaps the values."""
    if features:
        from seldon_core_tpu_torch.models.decoder import init_feature_draft

        params = init_feature_draft(seed, vocab=vocab, hidden=hidden, ffn=ffn, max_len=max_len)
        if distilled:
            from seldon_core_tpu_torch.training.distill_draft import load_draft_checkpoint

            params = load_draft_checkpoint(str(distilled), params)
        return ModelSpec(_feature_draft_apply, params, (seq,), (), int_inputs="ids")
    ms = build_tiny_gpt(
        seed=seed, vocab=vocab, hidden=hidden, layers=layers, ffn=ffn, max_len=max_len,
        seq=seq, max_new_tokens=max_new_tokens, resid_scale=resid_scale,
    )
    if distilled:
        from seldon_core_tpu_torch.training.distill_draft import load_draft_checkpoint

        ms.params = load_draft_checkpoint(str(distilled), ms.params)
    return ms


def _feature_draft_apply(p, x):
    raise ValueError(
        "a feature-draft head (zoo://draft?features=1) conditions on the "
        "target's hidden states and cannot serve standalone — point "
        "tpu.decode_draft_model at it instead"
    )


def _apply_tiny_gpt(p, x, *, max_new_tokens: int):
    from seldon_core_tpu_torch.models.decoder import generate

    return generate(p, x, max_new_tokens)


def _runtime_from_modelspec(ms: ModelSpec, tpu_cfg, device=None, cuda_graphs: bool = True,
                            mesh=None) -> ModelRuntime:
    """The spec's runtime on ``device``, or over ``mesh`` with the apply its
    ``apply_factory(mesh)`` gives (JAX ``models/zoo.py:526-540``)."""
    dtype_name = getattr(tpu_cfg, "dtype", "float32")
    if dtype_name not in DTYPES:
        raise ValueError(f"tpu.dtype must be one of {sorted(DTYPES)}, got {dtype_name!r}")
    weight_quant = getattr(tpu_cfg, "weight_quant", "")
    apply_fn = ms.apply_fn
    if mesh is not None and ms.apply_factory is not None:
        apply_fn = ms.apply_factory(mesh)
    rt = ModelRuntime(
        apply_fn,
        ms.params,
        device=device,
        buckets=tuple(getattr(tpu_cfg, "batch_buckets", ()) or ()),
        max_batch=getattr(tpu_cfg, "max_batch", 64),
        dtype=DTYPES[dtype_name],
        class_names=ms.class_names,
        int_inputs=ms.int_inputs,
        offload_compute=getattr(tpu_cfg, "offload_compute", "auto"),
        layout=ms.layout,
        weight_quant=weight_quant,
        cuda_graphs=cuda_graphs,
        mesh=mesh,
        param_pspecs=ms.param_pspecs,
    )
    rt.feature_shape = ms.feature_shape
    rt.generative = ms.generative
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
    uri: str, tpu_cfg, device=None, extra_params: dict | None = None, cuda_graphs: bool = True, mesh=None
) -> ModelRuntime:
    """``extra_params``: unit parameters beyond model/model_uri, merged as
    builder kwargs under the URI's own query string (the URI wins).
    ``cuda_graphs=False`` builds the eager twin (``ModelRuntime``); ``mesh``
    serves the model over a mesh's positions.

    Schemes: ``zoo://<name>?k=v`` (a seeded zoo build), ``file://<dir>`` (a
    checkpoint of either package, ``persistence/checkpoint.py``) and
    ``hf-bert://<dir>?seq=N`` (a local ``save_pretrained`` directory of a
    ``BertForSequenceClassification``, ``models/hf_import.py``)."""
    extra_params = extra_params or {}
    if uri.startswith("zoo://"):
        name, kwargs = _parse_zoo_uri(uri)
        ms = get_model(name, **{**extra_params, **kwargs})
    elif uri.startswith("file://"):
        if extra_params:
            logging.getLogger(__name__).warning(
                "file:// checkpoints ignore extra unit parameters %s (the "
                "builder and its kwargs are baked into the checkpoint)",
                sorted(extra_params),
            )
        from seldon_core_tpu_torch.persistence.checkpoint import restore_model

        ms = restore_model(uri[len("file://"):])
    elif uri.startswith("hf-bert://"):
        ms = _hf_bert_spec(uri, extra_params)
    else:
        raise ValueError(f"unsupported model_uri '{uri}'")
    return _runtime_from_modelspec(ms, tpu_cfg, device, cuda_graphs, mesh)


def _hf_bert_spec(uri: str, extra_params: dict) -> ModelSpec:
    """The ``hf-bert://`` branch of the JAX package's
    ``build_runtime_from_uri``: the URI's query wins over the unit
    parameters, ``seq`` defaults to 128 and may not pass the checkpoint's
    position table, ``attn_kernel`` picks the apply, and on a mesh the
    spec carries BERT's apply factory and partition rule: ``seq_parallel``
    (ring or ulysses) acts on a "seq" axis (JAX ``zoo.py:635-647``)."""
    from seldon_core_tpu_torch.models.bert import apply_for_kernel, bert_apply_factory, bert_pspecs, infer_heads
    from seldon_core_tpu_torch.models.hf_import import (
        bert_params_from_hf,
        check_bert_geometry,
        class_names_from_config,
        load_hf_bert_dir,
    )

    path, _, query = uri[len("hf-bert://"):].partition("?")
    kwargs = {
        **{k: str(v) for k, v in extra_params.items()},
        **dict(urllib.parse.parse_qsl(query)),  # the uri's query wins
    }
    apply = apply_for_kernel(str(kwargs.get("attn_kernel", "auto")))
    state, config = load_hf_bert_dir(path)
    check_bert_geometry(path, state, config)
    params = bert_params_from_hf(state)
    seq = int(kwargs.get("seq", 128))
    max_len = int(params["pos_emb"].shape[0])
    if seq > max_len:
        raise ValueError(
            f"hf-bert seq={seq} exceeds the checkpoint's "
            f"max_position_embeddings={max_len} — failing fast instead "
            "of an opaque XLA broadcast error at warmup"
        )
    return ModelSpec(
        apply,
        params,
        (seq,),
        class_names_from_config(config, params["head"]["w"].shape[1]),
        int_inputs="ids",
        param_pspecs=bert_pspecs(params),
        apply_factory=partial(bert_apply_factory, seq_parallel=str(kwargs.get("seq_parallel", "ring")),
                              num_heads=infer_heads(params), attn_kernel=str(kwargs.get("attn_kernel", "auto"))),
    )


def make_model_unit(spec: PredictiveUnit, context: dict) -> ModelUnit:
    """Factory for implementation=JAX_MODEL units: the model comes from a
    unit parameter ``model_uri`` (or the ``model`` shorthand), or from the
    unit's container; every other unit parameter but ``finetune`` is a
    builder kwarg. ``finetune`` true (``bool_param``: the string "false" is
    false) builds an ``OnlineFinetuneModelUnit`` (``models/online.py``), as
    ``make_jax_model_unit`` does, on the context's mesh as on one device,
    and is refused with int8 weights before any parameter is built."""
    params = parameters_dict(spec.parameters)
    uri = params.get("model_uri") or (
        f"zoo://{params['model']}" if "model" in params else None
    )
    extra = {k: v for k, v in params.items() if k not in ("model", "model_uri", "finetune")}
    if uri is None:
        container = (context.get("containers") or {}).get(spec.name)
        uri = getattr(container, "model_uri", "") or None
    if uri is None:
        raise ValueError(f"JAX_MODEL unit '{spec.name}' needs a model_uri parameter")
    finetune = bool_param(params.get("finetune", False))
    if finetune and getattr(context.get("tpu"), "weight_quant", "") == "int8":
        raise ValueError(
            f"unit '{spec.name}': finetune=true cannot combine with "
            "tpu.weight_quant='int8' — gradients over int8 weight payloads "
            "are undefined and updates would corrupt the frozen per-channel "
            "scales; serve the finetuning replica unquantized"
        )
    runtime = build_runtime_from_uri(
        uri, context.get("tpu"), context.get("device"), extra_params=extra,
        cuda_graphs=context.get("cuda_graphs", True), mesh=context.get("mesh"),
    )
    if finetune:
        from seldon_core_tpu_torch.models.online import OnlineFinetuneModelUnit

        effective = tuple(spec.methods) or TYPE_METHODS.get(spec.type, ())
        if PredictiveUnitMethod.SEND_FEEDBACK not in effective:
            logging.getLogger(__name__).warning(
                "finetune=true on unit '%s' but SEND_FEEDBACK is not in its "
                "methods — feedback will never reach it (run the spec "
                "through defaulting, or add the method explicitly)",
                spec.name,
            )
        return OnlineFinetuneModelUnit(spec, runtime)
    return ModelUnit(spec, runtime)


def unit_from_container(spec: PredictiveUnit, container: ContainerSpec, context: dict) -> ModelUnit:
    runtime = build_runtime_from_uri(container.model_uri, context.get("tpu"), context.get("device"),
                                     cuda_graphs=context.get("cuda_graphs", True), mesh=context.get("mesh"))
    return ModelUnit(spec, runtime)
