"""BERT encoder classifier as PyTorch functions on a parameter tree.

Port of ``seldon_core_tpu/models/bert.py`` (single device). Parameters are
the JAX package's tree — ``init_bert`` makes the same numpy draws in the
same order, so a seed gives bit-identical weights — with tensors as leaves.
Serving contract: ``apply(params, x)`` with x int token ids [batch, seq]
-> [batch, num_classes] probabilities.

Attention follows the deployment knob ``attn_kernel``:

- ``auto``: dense below FLASH_MIN_SEQ, blockwise above, and the CUDA flash
  kernel for tensors on the card from PALLAS_MIN_SEQ when the KV length is
  a 128-multiple;
- ``pallas``: the CUDA flash kernel (its plain version for CPU tensors)
  whenever the KV length tiles by the JAX kernel's rule, blockwise
  otherwise;
- ``blockwise``: blockwise at any length.

On a mesh (``bert_apply_factory``, the JAX package's
``_bert_apply_factory``, memoised per mesh and strategy), one body serves
every mesh (``_mesh_hidden``):

- a "seq" axis serves sequence-parallel: every layer runs on each
  position's block of the sequence, and attention is ring attention
  (``ops/ring_attention.py``, the default) or Ulysses
  (``seq_parallel=ulysses``, ``ops/ulysses.py``; heads that the axis does
  not divide are refused at build). A request length the axis does not
  divide runs unsharded, with the single-device policy, as ring's fallback
  does in the JAX package. ``attn_kernel`` does not apply there;
- a "model" axis serves Megatron tensor parallelism (``bert_pspecs``):
  ``qkv`` and ``mlp_in`` column-parallel, ``attn_out`` and ``mlp_out``
  row-parallel, one psum per residual branch with the row-parallel bias
  added once after it. The packed q|k|v columns are split per slab, so each
  position holds whole heads of q, k and v (a plain split of the columns,
  which is how ``P(None, "model")`` reads in the JAX package, hands the
  first position only q heads). Attention on a position's heads follows
  ``attn_kernel``; with ``pallas`` each position's heads go through the
  flash kernel as strided views of its QKV projection. With
  ``weight_quant=int8`` each position's W8A16 calls take its shard of the
  int8 payloads (``quant.quantized_pspecs``): qkv's q, k and v column slabs
  with their scales, ``mlp_in``'s columns, and the rows of ``attn_out`` and
  ``mlp_out`` with no bias in the kernel (the bias follows the psum);
- both axes together: each (seq, model) position holds its sequence block
  and its model slice of the heads; ring or Ulysses runs over "seq" within
  each model index (Ulysses where the heads of a model position divide the
  seq axis, refused by name otherwise), and the row-parallel psums run over
  "model";
- a mesh with neither runs the single-device apply on each data lead.

The same body ends in probabilities for serving (``bert_apply_factory``) or
logits for training (``bert_logits_factory``, which on a "seq" mesh takes
each position's sequence block as placed by ``P("data", "seq")``); it runs
under autograd like any torch code, the flash kernel apart
(``ops/flash_attention.py::refuse_autograd``).

With ``tpu.weight_quant="int8"`` every projection (qkv, attn_out, mlp_in,
mlp_out, the head) is a quantized leaf that ``dense`` hands to the W8A16
kernel: 4 launches a layer and one for the head. The embedding tables are
not matmul operands: a quantized one (``pos_emb``; ``tok_emb`` only below
8193 rows, as in ``bert_tiny``) gathers its int8 rows and dequantizes
those, as the JAX package dequantizes before its gather.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import numpy as np
import torch

from seldon_core_tpu_torch.models.quant import embed, is_quantized_leaf, payload
from seldon_core_tpu_torch.models.zoo import ModelSpec, dense, register_model, softmax_f32
from seldon_core_tpu_torch.ops.attention import (
    FLASH_MIN_SEQ,
    PALLAS_MIN_SEQ,
    blockwise_attention,
    naive_attention,
)
from seldon_core_tpu_torch.ops.flash_attention import DEFAULT_BLOCK_K, flash_attention
from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul
from seldon_core_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, P, Packed


def _dense_init(rng: np.random.Generator, n_in, n_out):
    scale = (2.0 / (n_in + n_out)) ** 0.5
    return {
        "w": (rng.standard_normal((n_in, n_out)) * scale).astype(np.float32),
        "b": np.zeros((n_out,), np.float32),
    }


def _ln_init(d):
    return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}


def _layer_init(rng, hidden, ffn):
    return {
        "qkv": _dense_init(rng, hidden, 3 * hidden),
        "attn_out": _dense_init(rng, hidden, hidden),
        "ln1": _ln_init(hidden),
        "mlp_in": _dense_init(rng, hidden, ffn),
        "mlp_out": _dense_init(rng, ffn, hidden),
        "ln2": _ln_init(hidden),
    }


def init_bert(
    seed: int = 0,
    vocab: int = 30522,
    hidden: int = 768,
    layers: int = 12,
    ffn: int = 3072,
    max_len: int = 512,
    num_classes: int = 2,
) -> dict:
    """numpy parameter tree; heads = hidden // 64, derived at apply time."""
    rng = np.random.default_rng(seed)
    params: dict[str, Any] = {
        "tok_emb": (rng.standard_normal((vocab, hidden)) * 0.02).astype(np.float32),
        "pos_emb": (rng.standard_normal((max_len, hidden)) * 0.02).astype(np.float32),
        "ln_emb": _ln_init(hidden),
        "layers": [_layer_init(rng, hidden, ffn) for _ in range(layers)],
        "head": _dense_init(rng, hidden, num_classes),
    }
    return params


def _ln(p, x, eps=1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def _default_attention(q, k, v):
    if q.shape[2] >= FLASH_MIN_SEQ:
        if q.shape[2] >= PALLAS_MIN_SEQ and q.is_cuda and k.shape[2] % 128 == 0:
            return flash_attention(q, k, v)
        return blockwise_attention(q, k, v, block_size=512)
    return naive_attention(q, k, v)


def _pallas_attention(q, k, v):
    """attn_kernel=pallas: the flash kernel whenever the KV length tiles
    (16-aligned and a 128-multiple or one KV block), blockwise otherwise —
    the JAX package's shape rule."""
    sk = k.shape[2]
    if sk % 16 == 0 and (sk % 128 == 0 or sk <= DEFAULT_BLOCK_K):
        return flash_attention(q, k, v)
    return blockwise_attention(q, k, v, block_size=512)


def _blockwise_only_attention(q, k, v):
    return blockwise_attention(q, k, v, block_size=512)


_KERNEL_IMPLS = {
    "auto": _default_attention,
    "pallas": _pallas_attention,
    "blockwise": _blockwise_only_attention,
}


def _qkv_heads(p, x, head_dim):
    """q, k, v as [b, heads, s, head_dim] views of one QKV projection (on a
    "model" position, of its heads' columns)."""
    b, s, _ = x.shape
    qkv = dense(p["qkv"], x)
    width = qkv.shape[-1] // 3

    def heads(t):
        return t.reshape(b, s, width // head_dim, head_dim).transpose(1, 2)

    q, k, v = qkv.split(width, dim=-1)
    return heads(q), heads(k), heads(v)


def _merge_heads(ctx):
    """[b, heads, s, head_dim] -> [b, s, heads * head_dim]; a view when ctx
    lies as [b, s, heads, head_dim], as the CUDA kernel writes it."""
    b, h, s, d = ctx.shape
    return ctx.transpose(1, 2).reshape(b, s, h * d)


def _mlp(p, x):
    # exact erf GELU, as BERT (paper and HF) uses
    return dense(p["mlp_out"], torch.nn.functional.gelu(dense(p["mlp_in"], x), approximate="none"))


def _layer_finish(p, x, ctx):
    """The layer after attention: output projection, residual and norm,
    then the MLP block."""
    x = _ln(p["ln1"], x + dense(p["attn_out"], _merge_heads(ctx)))
    return _ln(p["ln2"], x + _mlp(p, x))


def _layer_apply(p, x, num_heads, attn_impl):
    return _layer_finish(p, x, attn_impl(*_qkv_heads(p, x, x.shape[-1] // num_heads)))


def _infer_heads(params: dict) -> int:
    hidden = params["ln_emb"]["scale"].shape[-1]
    return max(1, hidden // 64)


infer_heads = _infer_heads


def _embed(params: dict, ids: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Token plus position embeddings of ``ids`` [b, s] at positions
    ``offset`` on, normalized, in the compute dtype."""
    # the runtime's compute dtype: a norm vector is never quantized, and the
    # runtime casts every floating leaf that is not a scale to that dtype
    compute_dtype = params["ln_emb"]["scale"].dtype
    positions = torch.arange(offset, offset + ids.shape[1], device=ids.device)
    h = embed(params["tok_emb"], ids, compute_dtype) + embed(params["pos_emb"], positions, compute_dtype)[None]
    return _ln(params["ln_emb"], h)


def _classify(params: dict, h: torch.Tensor) -> torch.Tensor:
    cls = h[:, 0, :]  # [CLS] pooling
    pooler = params.get("pooler")
    if pooler is not None:  # HF tanh pooler, present on imported checkpoints
        cls = torch.tanh(dense(pooler, cls))
    return dense(params["head"], cls)


def bert_logits(params: dict, x: torch.Tensor, attn_impl=_default_attention) -> torch.Tensor:
    """x: token ids [batch, seq] (any numeric dtype) -> logits [batch, classes]."""
    num_heads = _infer_heads(params)
    h = _embed(params, x.long())
    for lp in params["layers"]:
        h = _layer_apply(lp, h, num_heads, attn_impl)
    return _classify(params, h)


def make_apply_bert(attn_impl):
    """Serving apply (float32 softmax probabilities) with the given
    attention."""

    def apply(params, x):
        return softmax_f32(bert_logits(params, x, attn_impl))

    return apply


_KERNEL_APPLIES: dict = {}
# the logits of each attn_kernel value, one function each
_KERNEL_LOGITS = {name: partial(bert_logits, attn_impl=impl) for name, impl in _KERNEL_IMPLS.items()}


def apply_for_kernel(attn_kernel: str):
    """The serving apply for an ``attn_kernel`` knob value, one function per
    value (two builds share it, as in the JAX package)."""
    if attn_kernel not in _KERNEL_IMPLS:
        raise ValueError(
            f"attn_kernel must be one of {sorted(_KERNEL_IMPLS)}, got {attn_kernel!r}"
        )
    if attn_kernel not in _KERNEL_APPLIES:
        _KERNEL_APPLIES[attn_kernel] = make_apply_bert(_KERNEL_IMPLS[attn_kernel])
    return _KERNEL_APPLIES[attn_kernel]


def bert_pspecs(params: dict) -> dict:
    """Megatron tensor parallelism over the mesh "model" axis: ``qkv`` and
    ``mlp_in`` column-parallel (``qkv`` per q, k and v slab, so a position
    holds whole heads), ``attn_out`` and ``mlp_out`` row-parallel;
    embeddings, norms, the head and an imported pooler replicated."""
    ln = {"scale": P(), "bias": P()}
    rep = {"w": P(), "b": P()}
    layer = {
        "qkv": {"w": P(None, Packed(MODEL_AXIS, 3)), "b": P(Packed(MODEL_AXIS, 3))},
        "attn_out": {"w": P(MODEL_AXIS, None), "b": P()},
        "ln1": ln,
        "mlp_in": {"w": P(None, MODEL_AXIS), "b": P(MODEL_AXIS)},
        "mlp_out": {"w": P(MODEL_AXIS, None), "b": P()},
        "ln2": ln,
    }
    specs = {"tok_emb": P(), "pos_emb": P(), "ln_emb": ln, "layers": [layer for _ in params["layers"]], "head": rep}
    if "pooler" in params:
        specs["pooler"] = rep
    return specs


def _rows_matmul(x, w):
    """A row-parallel partial product ``x @ w`` with no bias (it is added
    once, after the psum); a quantized ``w`` (a position's rows of the int8
    payload, with the leaf's scales) goes through the W8A16 kernel."""
    if is_quantized_leaf(w):
        return int8_matmul(x, payload(w), w["scale"], None)
    return x @ w.to(x.dtype)


def _mesh_hidden(mesh, params, ids, offsets, attend, attn_impl):
    """The encoder over the mesh, one body for every BERT mesh: position p
    holds its ids block ``ids[p]`` [b, s_p] at sequence offset
    ``offsets[p]``, its "model" slice of the heads and MLP columns, and
    returns its block of the final hidden states. The stream replicated
    over "model" is computed once per device in each model group; ``qkv``
    and ``mlp_in`` are column-parallel, ``attn_out`` and ``mlp_out``
    row-parallel with one psum over "model" each and the bias added once
    after it (on a mesh without "model" the psum is the position's own
    product). Attention is ``attend`` over the "seq" axis (ring or Ulysses,
    within each model index), else ``attn_impl`` on each position's heads."""
    from seldon_core_tpu_torch.parallel.collectives import psum, replicated

    num_heads = _infer_heads(params[0])
    head_dim = params[0]["ln_emb"]["scale"].shape[-1] // num_heads

    def residual(norm, bias):
        return lambda x, y: _ln(norm, x + y + bias.to(y.dtype))

    hs = replicated(lambda p, x, o: _embed(p, x.long(), o), mesh, MODEL_AXIS, params, ids, offsets)
    for li in range(len(params[0]["layers"])):
        lps = [pp["layers"][li] for pp in params]
        q, k, v = zip(*(_qkv_heads(lp, h, head_dim) for lp, h in zip(lps, hs)))
        ctx = attend(q, k, v, mesh, seq_axis=SEQ_AXIS) if attend else [attn_impl(*t) for t in zip(q, k, v)]
        attn = psum([_rows_matmul(_merge_heads(c), lp["attn_out"]["w"]) for lp, c in zip(lps, ctx)], mesh,
                    MODEL_AXIS)
        hs = replicated(lambda lp, h, a: residual(lp["ln1"], lp["attn_out"]["b"])(h, a), mesh, MODEL_AXIS,
                        lps, hs, attn)
        mlp = psum([_rows_matmul(torch.nn.functional.gelu(dense(lp["mlp_in"], h), approximate="none"),
                                 lp["mlp_out"]["w"]) for lp, h in zip(lps, hs)], mesh, MODEL_AXIS)
        hs = replicated(lambda lp, h, m: residual(lp["ln2"], lp["mlp_out"]["b"])(h, m), mesh, MODEL_AXIS,
                        lps, hs, mlp)
    return hs


def _mesh_apply(mesh, strategy: str, attn_kernel: str, head: str):
    """BERT over a mesh with a "seq" axis, a "model" axis or both, ending in
    softmax probabilities (``head="probs"``, serving) or logits
    (``head="logits"``, training). Inputs are each data lead's rows: the
    whole sequence for serving (each "seq" position takes its block of it),
    each position's sequence block already for training (a batch placed by
    ``P("data", "seq")``).

    A length the "seq" axis does not split, or a Ulysses mesh whose heads
    per "model" position it does not divide, runs the single-device
    attention policy on the whole sequence, as JAX's ring apply falls back:
    on each data lead without a "model" axis, on every position's heads
    with one."""
    from seldon_core_tpu_torch.ops.ring_attention import ring_attention_shards
    from seldon_core_tpu_torch.ops.ulysses import ulysses_attention_shards
    from seldon_core_tpu_torch.parallel.mesh import MeshApply, data_parallel

    n, m = mesh.size_of(SEQ_AXIS), mesh.size_of(MODEL_AXIS)
    has_seq, has_model = SEQ_AXIS in mesh.shape, MODEL_AXIS in mesh.shape
    seq_blocks = has_seq and head == "logits"
    attend = (ring_attention_shards if strategy == "ring" else ulysses_attention_shards) if has_seq else None
    attn_impl = _KERNEL_IMPLS[attn_kernel]
    finish = (lambda p, h: softmax_f32(_classify(p, h))) if head == "probs" else _classify
    unsharded = data_parallel(apply_for_kernel("auto") if head == "probs" else _KERNEL_LOGITS["auto"], mesh)

    def run(params, xs):
        offsets = [0] * mesh.size
        ids, attend_now = xs, attend
        if has_seq:
            heads = _infer_heads(params[0]) // m
            if seq_blocks:
                blk = xs[0].shape[1]
                offsets = [mesh.coord(p, SEQ_AXIS) * blk for p in range(mesh.size)]
            elif xs[0].shape[1] % n or (strategy == "ulysses" and heads % n):
                if not has_model:
                    return unsharded(params, xs)
                attend_now = None  # the whole sequence on every position, the single-device policy
            else:
                blk = xs[0].shape[1] // n
                offsets = [mesh.coord(p, SEQ_AXIS) * blk for p in range(mesh.size)]
                ids = [x[:, o:o + blk] for x, o in zip(xs, offsets)]
        hs = _mesh_hidden(mesh, params, ids, offsets, attend_now,
                          attn_impl if not has_seq else _default_attention)
        out: list = [None] * mesh.size
        for lead in mesh.leads(DATA_AXIS):
            out[lead] = finish(params[lead], hs[lead])
        return out

    if has_seq and has_model:
        name = f"bert_{strategy}_tp"
    elif has_seq:
        name = f"bert_{strategy}"
    else:
        name = f"bert_tp_{attn_kernel}"
    x_dims = {DATA_AXIS: 0, SEQ_AXIS: 1} if seq_blocks else None
    return MeshApply(run, mesh, name if head == "probs" else f"{name}_logits", x_dims)


def _checked_strategy(mesh, seq_parallel: str, num_heads: int | None, attn_kernel: str) -> None:
    """The build-time refusals of a BERT mesh, by name: an unknown strategy
    or attention knob, Ulysses heads (per "model" position) that the "seq"
    axis does not divide, heads that the "model" axis does not divide."""
    apply_for_kernel(attn_kernel)  # an unknown knob fails here
    if SEQ_AXIS in mesh.shape and seq_parallel not in ("ring", "ulysses"):
        raise ValueError(f"seq_parallel must be 'ring' or 'ulysses', got {seq_parallel!r}")
    if num_heads is None:
        return
    m = mesh.size_of(MODEL_AXIS)
    if MODEL_AXIS in mesh.shape and num_heads % m:
        raise ValueError(f"tensor parallelism needs attention heads divisible by the model-axis size: "
                         f"{num_heads} heads vs model={m}")
    if SEQ_AXIS in mesh.shape and seq_parallel == "ulysses":
        n = mesh.shape[SEQ_AXIS]
        if (num_heads // m) % n != 0:
            per = f"{num_heads // m} heads per model position" if m > 1 else f"{num_heads} heads"
            raise ValueError(
                f"seq_parallel=ulysses needs attention heads divisible "
                f"by the seq-axis size: {per} vs seq={n} — "
                "use a smaller seq axis or seq_parallel=ring"
            )


def bert_apply_factory(mesh, seq_parallel: str = "ring", num_heads: int | None = None, attn_kernel: str = "auto"):
    """The serving apply on ``mesh`` (JAX ``models/bert.py:298-360``): a
    "seq" axis turns on sequence parallelism (ring by default, Ulysses on
    ``seq_parallel=ulysses``, whose heads per "model" position must divide
    the axis: refused at build), a "model" axis tensor parallelism (heads
    must divide it), both together each within the other, and otherwise the
    ``attn_kernel`` apply runs on each data lead. Memoised per (mesh,
    strategy), so two builds share one apply."""
    from seldon_core_tpu_torch.parallel.mesh import data_parallel, memoised_apply

    _checked_strategy(mesh, seq_parallel, num_heads, attn_kernel)
    if SEQ_AXIS not in mesh.shape and MODEL_AXIS not in mesh.shape:
        return data_parallel(apply_for_kernel(attn_kernel), mesh)
    strategy = seq_parallel if SEQ_AXIS in mesh.shape else ""
    kernel = attn_kernel if SEQ_AXIS not in mesh.shape else "auto"
    return memoised_apply(("bert", strategy, kernel, "probs", mesh),
                          lambda: _mesh_apply(mesh, strategy, kernel, "probs"))


def bert_logits_factory(mesh, seq_parallel: str = "ring", num_heads: int | None = None, attn_kernel: str = "auto"):
    """The same forward as ``bert_apply_factory`` ending in logits: the
    ``logits_fn`` of ``training/steps.py::make_sharded_train_step`` on a
    mesh. On a "seq" mesh it takes each position's sequence block (a batch
    placed by ``P("data", "seq")``) in place of the whole sequence."""
    from seldon_core_tpu_torch.parallel.mesh import data_parallel, memoised_apply

    _checked_strategy(mesh, seq_parallel, num_heads, attn_kernel)
    if SEQ_AXIS not in mesh.shape and MODEL_AXIS not in mesh.shape:
        return data_parallel(_KERNEL_LOGITS[attn_kernel], mesh)
    strategy = seq_parallel if SEQ_AXIS in mesh.shape else ""
    kernel = attn_kernel if SEQ_AXIS not in mesh.shape else "auto"
    return memoised_apply(("bert", strategy, kernel, "logits", mesh),
                          lambda: _mesh_apply(mesh, strategy, kernel, "logits"))


@register_model("bert_base")
def build_bert_base(
    seed: int = 0,
    num_classes: int = 2,
    max_len: int = 512,
    seq: int = 128,
    seq_parallel: str = "ring",
    attn_kernel: str = "auto",
    **_,
) -> ModelSpec:
    if seq > max_len:
        raise ValueError(
            f"seq={seq} exceeds max_len={max_len} (position table size) — "
            "raise max_len for long-context deployments"
        )
    apply = apply_for_kernel(attn_kernel)  # an unknown knob fails before the init
    return _bert_spec(apply, init_bert(seed, num_classes=num_classes, max_len=max_len), seq, num_classes,
                      seq_parallel, attn_kernel)


def _bert_spec(apply, params, seq, num_classes, seq_parallel, attn_kernel) -> ModelSpec:
    return ModelSpec(
        apply,
        params,
        (seq,),
        tuple(f"class_{i}" for i in range(num_classes)),
        int_inputs="ids",
        param_pspecs=bert_pspecs(params),
        apply_factory=partial(bert_apply_factory, seq_parallel=seq_parallel, num_heads=_infer_heads(params),
                              attn_kernel=attn_kernel),
    )


@register_model("bert_tiny")
def build_bert_tiny(
    seed: int = 0,
    vocab: int = 1024,
    hidden: int = 128,
    layers: int = 2,
    ffn: int = 256,
    max_len: int = 128,
    num_classes: int = 2,
    seq: int = 16,
    seq_parallel: str = "ring",
    attn_kernel: str = "auto",
    **_,
) -> ModelSpec:
    """Shrunk config for tests."""
    if seq > max_len:
        raise ValueError(f"seq={seq} exceeds max_len={max_len}")
    apply = apply_for_kernel(attn_kernel)
    params = init_bert(
        seed, vocab=vocab, hidden=hidden, layers=layers, ffn=ffn,
        max_len=max_len, num_classes=num_classes,
    )
    return _bert_spec(apply, params, seq, num_classes, seq_parallel, attn_kernel)
