"""Naive and blockwise (flash-style) attention in plain PyTorch.

Port of ``seldon_core_tpu/ops/attention.py``. Shapes are [batch, heads, seq,
head_dim]. ``blockwise_attention`` processes the KV axis in blocks with
running (max, denominator, numerator) statistics, so memory is O(block)
instead of O(seq^2); the JAX ``lax.scan`` over blocks is a Python loop here.
"""

from __future__ import annotations

from functools import lru_cache

import torch

NEG_INF = -1e30

# Sequence-length thresholds of the attention policy (models/bert.py and
# causal_attention_auto). Both are TPU-derived: FLASH_MIN_SEQ is where the
# dense score matrix gave way to blockwise, PALLAS_MIN_SEQ the crossover the
# Pallas kernel showed on a TPU. Neither has been measured on the H100.
FLASH_MIN_SEQ = 1024
PALLAS_MIN_SEQ = 4096


@lru_cache(maxsize=64)
def _sqrt_d(d: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """sqrt(d) as a 0-dim tensor on ``device``, uploaded once: a CUDA graph
    capture refuses an upload, and the eager run before each capture makes
    this one. It is made outside inference mode, so a training step may
    save it for its backward after a served forward made it."""
    with torch.inference_mode(False):
        return torch.tensor(d**0.5, dtype=dtype, device=device)


def _scaled_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    s = torch.einsum("bhqd,bhkd->bhqk", q, k)
    return s / _sqrt_d(q.shape[-1], q.dtype, q.device)


def _block_stats(q, k, v, mask=None):
    """One KV block: (m, l, o) running stats for online softmax."""
    s = _scaled_scores(q, k)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m, l, o


def combine_stats(m1, l1, o1, m2, l2, o2):
    """Merge two online-softmax partials (associative, so blockwise
    attention is exact, not approximate)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = a1 * l1 + a2 * l2
    o = a1[..., None] * o1 + a2[..., None] * o2
    return m, l, o


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    block_size: int = 512,
    causal: bool = False,
) -> torch.Tensor:
    """Exact attention with KV processed in blocks of ``block_size``; a
    ragged last block is zero-padded and its padded keys masked out."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    block = min(block_size, sk)
    if sk % block:
        pad = block - sk % block
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    n_blocks = k.shape[2] // block
    q_pos = torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h, sq), dtype=q.dtype, device=q.device)
    o = torch.zeros((b, h, sq, d), dtype=q.dtype, device=q.device)
    for blk in range(n_blocks):
        kb = k[:, :, blk * block : (blk + 1) * block]
        vb = v[:, :, blk * block : (blk + 1) * block]
        k_pos = blk * block + torch.arange(block, device=q.device)
        mask = (k_pos < sk)[None, None, None, :]
        if causal:
            mask = mask & (k_pos[None, None, None, :] <= q_pos[None, None, :, None])
        m, l, o = combine_stats(m, l, o, *_block_stats(q, kb, vb, mask))
    return o / l[..., None]


def naive_attention(q, k, v, *, causal: bool = False) -> torch.Tensor:
    """Reference O(seq^2) attention."""
    s = _scaled_scores(q, k)
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def causal_attention_auto(q, k, v) -> torch.Tensor:
    """The causal attention policy: dense below FLASH_MIN_SEQ, blockwise
    above it, the CUDA flash kernel for tensors on the card from
    PALLAS_MIN_SEQ when the KV length is a 128-multiple."""
    s = q.shape[2]
    if s >= FLASH_MIN_SEQ:
        if s >= PALLAS_MIN_SEQ and q.is_cuda and k.shape[2] % 128 == 0:
            from seldon_core_tpu_torch.ops.flash_attention import flash_attention

            return flash_attention(q, k, v, causal=True)
        return blockwise_attention(q, k, v, block_size=512, causal=True)
    return naive_attention(q, k, v, causal=True)
