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
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from seldon_core_tpu_torch.models.zoo import ModelSpec, dense, register_model, softmax_f32
from seldon_core_tpu_torch.ops.attention import (
    FLASH_MIN_SEQ,
    PALLAS_MIN_SEQ,
    blockwise_attention,
    naive_attention,
)
from seldon_core_tpu_torch.ops.flash_attention import DEFAULT_BLOCK_K, flash_attention


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


def _attention(p, x, num_heads, attn_impl):
    b, s, d = x.shape
    head = d // num_heads
    q, k, v = dense(p["qkv"], x).split(d, dim=-1)

    def heads(t):  # a view of the QKV output, [b, heads, s, head]
        return t.reshape(b, s, num_heads, head).transpose(1, 2)

    ctx = attn_impl(heads(q), heads(k), heads(v))
    # a view when ctx lies as [b, s, heads, head], as the CUDA kernel writes it
    ctx = ctx.transpose(1, 2).reshape(b, s, d)
    return dense(p["attn_out"], ctx)


def _layer_apply(p, x, num_heads, attn_impl):
    x = _ln(p["ln1"], x + _attention(p, x, num_heads, attn_impl))
    # exact erf GELU, as BERT (paper and HF) uses
    h = torch.nn.functional.gelu(dense(p["mlp_in"], x), approximate="none")
    return _ln(p["ln2"], x + dense(p["mlp_out"], h))


def _infer_heads(params: dict) -> int:
    hidden = params["layers"][0]["qkv"]["w"].shape[0]
    return max(1, hidden // 64)


def bert_logits(params: dict, x: torch.Tensor, attn_impl=_default_attention) -> torch.Tensor:
    """x: token ids [batch, seq] (any numeric dtype) -> logits [batch, classes]."""
    ids = x.long()
    num_heads = _infer_heads(params)
    compute_dtype = params["tok_emb"].dtype
    h = params["tok_emb"][ids] + params["pos_emb"][: ids.shape[1]][None, :, :]
    h = _ln(params["ln_emb"], h.to(compute_dtype))
    for lp in params["layers"]:
        h = _layer_apply(lp, h, num_heads, attn_impl)
    cls = h[:, 0, :]  # [CLS] pooling
    pooler = params.get("pooler")
    if pooler is not None:  # HF tanh pooler, present on imported checkpoints
        cls = torch.tanh(dense(pooler, cls))
    return dense(params["head"], cls)


def make_apply_bert(attn_impl):
    """Serving apply (float32 softmax probabilities) with the given
    attention."""

    def apply(params, x):
        return softmax_f32(bert_logits(params, x, attn_impl))

    return apply


def apply_for_kernel(attn_kernel: str):
    """The serving apply for an ``attn_kernel`` knob value."""
    if attn_kernel not in _KERNEL_IMPLS:
        raise ValueError(
            f"attn_kernel must be one of {sorted(_KERNEL_IMPLS)}, got {attn_kernel!r}"
        )
    return make_apply_bert(_KERNEL_IMPLS[attn_kernel])


@register_model("bert_base")
def build_bert_base(
    seed: int = 0,
    num_classes: int = 2,
    max_len: int = 512,
    seq: int = 128,
    attn_kernel: str = "auto",
    **_,
) -> ModelSpec:
    if seq > max_len:
        raise ValueError(
            f"seq={seq} exceeds max_len={max_len} (position table size) — "
            "raise max_len for long-context deployments"
        )
    apply = apply_for_kernel(attn_kernel)  # an unknown knob fails before the init
    return ModelSpec(
        apply,
        init_bert(seed, num_classes=num_classes, max_len=max_len),
        (seq,),
        tuple(f"class_{i}" for i in range(num_classes)),
        int_inputs="ids",
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
    return ModelSpec(
        apply, params, (seq,), tuple(f"class_{i}" for i in range(num_classes)),
        int_inputs="ids",
    )
