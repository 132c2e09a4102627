"""GPT-style causal decoder with KV-cache generation: the generative tier.

Port of ``seldon_core_tpu/models/decoder.py``: the dense model, the fused
``generate`` oracle, the slot-cache blocks and the paged-KV blocks the
continuous-batching scheduler (``serving/decode_scheduler.py``) runs, and
draft-model speculation (the k-chain, the token tree and the EAGLE-style
feature head). The function names are the JAX package's. Parameters are
the same tree with torch tensors as leaves (``models/convert.py``);
``init_decoder`` and ``init_feature_draft`` make the JAX package's numpy
draws, so a seed gives its parameters bit for bit.

What changes in the port:

- ``lax.scan`` over the decode steps is a Python loop over static
  ``[L, b, h, max_ctx, hd]`` caches, and every cache or pool write happens
  in place (the counterpart of the JAX package's buffer donation): the
  functions that take a cache or a pool write into it and return it.
- Prefill attention goes through ``ops/attention.causal_attention_auto``:
  dense below 1024 tokens, blockwise above, and on a CUDA tensor the
  hand-written flash kernel (``csrc/flash_attention.cu``, causal mode) from
  4096 tokens.
- ``lax.dynamic_update_slice`` clamps a block's start so that it fits; the
  slot writes below clamp the same way.
- Sampling draws come from a ``torch.Generator`` seeded from
  ``(seed, tick, stream)``, not from ``jax.random``: sampled tokens differ
  from the JAX package's, greedy and ``top_k=1`` tokens do not. A
  speculative round draws its proposals and its acceptance from two other
  streams of the same tick (the JAX package's ``fold_in(key, 1)`` and
  ``fold_in(key, 2)``), each stream's draws in a fixed order.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.parallel import tp as tp_mod
from seldon_core_tpu_torch.parallel.collectives import _on as _to
from seldon_core_tpu_torch.parallel.tp import Placed, TPLayer, TPParams, kv_placed

NEG_INF = -1e30


def _dense(rng: np.random.Generator, n_in: int, n_out: int) -> dict:
    scale = (2.0 / (n_in + n_out)) ** 0.5
    return {
        "w": (rng.standard_normal((n_in, n_out)) * scale).astype(np.float32),
        "b": np.zeros((n_out,), np.float32),
    }


def _ln_init(d: int) -> dict:
    return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}


# LayerNorm's epsilon rounded to each dtype, as jnp.asarray(1e-5, x.dtype)
# rounds it; a Python scalar, so no step copies it to the device
_LN_EPS = {dt: float(torch.tensor(1e-5, dtype=dt)) for dt in (torch.float32, torch.bfloat16, torch.float16)}


def _ln(p: dict, x: torch.Tensor) -> torch.Tensor:
    # jnp.var is the biased variance; torch.var is not unless told
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + _LN_EPS[x.dtype])
    return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def init_decoder(
    seed: int = 0,
    vocab: int = 512,
    hidden: int = 128,
    layers: int = 2,
    ffn: int = 256,
    max_len: int = 128,
    resid_scale: float = 1.0,
) -> dict:
    """Numpy parameter tree, bit-identical to the JAX package's for the same
    arguments. ``resid_scale`` scales the residual-branch output projections
    (attn_out, mlp_out) after drawing them; at 1.0 nothing is scaled."""
    heads = _heads_for(hidden)
    if hidden % heads:
        raise ValueError(
            f"hidden={hidden} not divisible by its derived head count "
            f"{heads} (head_dim-64 convention)"
        )
    rng = np.random.default_rng(seed)

    def _resid(p: dict) -> dict:
        if resid_scale != 1.0:
            p["w"] = (p["w"] * np.float32(resid_scale)).astype(np.float32)
        return p

    return {
        "tok_emb": (rng.standard_normal((vocab, hidden)) * 0.02).astype(np.float32),
        "pos_emb": (rng.standard_normal((max_len, hidden)) * 0.02).astype(np.float32),
        "layers": [
            {
                "ln1": _ln_init(hidden),
                "qkv": _dense(rng, hidden, 3 * hidden),
                "attn_out": _resid(_dense(rng, hidden, hidden)),
                "ln2": _ln_init(hidden),
                "mlp_in": _dense(rng, hidden, ffn),
                "mlp_out": _resid(_dense(rng, ffn, hidden)),
            }
            for _ in range(layers)
        ],
        "ln_f": _ln_init(hidden),
        # the lm head reuses tok_emb^T (weight tying)
    }


def _heads_for(hidden: int) -> int:
    return max(1, hidden // 64) if hidden >= 64 else 2


def _heads(params: dict) -> int:
    return _heads_for(params["layers"][0]["qkv"]["w"].shape[0])


def _split_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """[b, s, d] -> [b, h, s, d // h], a view: the three slices of one fused
    QKV projection reach the flash kernel without a copy."""
    b, s, d = t.shape
    return t.reshape(b, s, h, d // h).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = t.shape
    return t.transpose(1, 2).reshape(b, s, h * hd)


def _causal_attention(q, k, v):
    """Prefill attention: the causal policy of ``ops/attention.py`` (the
    flash kernel on the card from 4096 tokens)."""
    from seldon_core_tpu_torch.ops.attention import causal_attention_auto

    return causal_attention_auto(q, k, v)


def _proj(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def _mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The residual MLP half of a layer (erf GELU, as jax.nn.gelu with
    approximate=False)."""
    hdn = F.gelu(_proj(p["mlp_in"], _ln(p["ln2"], x)))
    return x + _proj(p["mlp_out"], hdn)


def _qkv(p: dict, x: torch.Tensor, h: int):
    q, k, v = _proj(p["qkv"], _ln(p["ln1"], x)).chunk(3, dim=-1)
    return _split_heads(q, h), _split_heads(k, h), _split_heads(v, h)


# On a decode mesh (``parallel/tp.py``) a layer's parameters are a
# ``TPLayer`` and its KV buffers ``Placed``: the replicated stream and the
# full q/k/v of the replicated qkv projection stay on the lead position, the
# attention below runs once per position on its heads against its part of
# the buffers (``_per_head``), and ``_close`` ends each residual branch in
# one psum. Single-device parameters take the same code with one "position".


def _per_head(p, fn, heads, *args):
    """``fn(*heads, *args)`` -> the attention context [n, m, h * hd] of the
    heads it is given. ``heads``: full-head tensors [n, h, ...] (or None).
    On a decode mesh it runs once per position, on the position's heads and
    its parts of the ``Placed`` buffers in ``args``, and returns the list."""
    if isinstance(p, TPLayer):
        return p.each(fn, heads, args)
    return fn(*heads, *args)


def _close(p, x, ctx):
    """The layer after attention: the output projection and the residual,
    then the MLP half. On a decode mesh ``ctx`` holds each position's heads:
    ``attn_out`` row-parallel, ``mlp_in`` column- and ``mlp_out``
    row-parallel, each branch summed by one psum with its bias added once,
    after it (two reduces per layer)."""
    if not isinstance(p, TPLayer):
        return _mlp(p, x + _proj(p["attn_out"], ctx))
    mesh, axis, shards = p.mesh, p.axis, p.shards
    part = [c @ s["attn_out"]["w"].to(c.dtype) for c, s in zip(ctx, shards)]
    x = x + tp_mod.row_parallel(part, shards[0]["attn_out"]["b"].to(x.dtype), mesh, axis)
    hn = _ln(p["ln2"], x)
    part = [F.gelu(_proj(s["mlp_in"], _to(hn, dev))) @ s["mlp_out"]["w"].to(hn.dtype)
            for s, dev in zip(shards, mesh.positions)]
    return x + tp_mod.row_parallel(part, shards[0]["mlp_out"]["b"].to(x.dtype), mesh, axis)


def _layer_prefill(p, x, h):
    """Returns (x_out, k[b, h, s, hd], v[b, h, s, hd]) for the cache."""
    q, k, v = _qkv(p, x, h)
    ctx = _per_head(p, lambda q, k, v: _merge_heads(_causal_attention(q, k, v)), (q, k, v))
    return _close(p, x, ctx), k, v


def _attend(q, cache_k, cache_v, valid, dtype):
    """Attention of q [n, h, m, hd] over the whole static cache [n, h, T, hd]
    in float32; ``valid`` [n or 1, m, T] marks the keys each query sees
    (the others get -1e30, so their mass is exactly zero). Returns the
    context [n, m, h * hd] in ``dtype``."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("nhqd,nhkd->nhqk", q.float(), cache_k.float()) * scale
    s = torch.where(valid[:, None], s, NEG_INF)
    ctx = torch.einsum("nhqk,nhkd->nhqd", torch.softmax(s, dim=-1), cache_v.float())
    return _merge_heads(ctx.to(dtype))


def _layer_step(p, x, cache_k, cache_v, pos: int, h):
    """One token through one layer against the cache. x: [b, 1, d]; cache
    [b, h, max_ctx, hd], written in place at ``pos``; tokens <= pos are
    attended to. Returns (x_out, cache_k, cache_v)."""
    q, k, v = _qkv(p, x, h)
    cache_k[:, :, pos : pos + 1] = k
    cache_v[:, :, pos : pos + 1] = v
    valid = (torch.arange(cache_k.shape[2], device=x.device) <= pos)[None, None, :]
    return _close(p, x, _attend(q, cache_k, cache_v, valid, x.dtype)), cache_k, cache_v


def _embed(params, ids, pos_offset: int = 0):
    h = params["tok_emb"][ids]
    return h + params["pos_emb"][pos_offset : pos_offset + ids.shape[1]][None, :, :]


def _embed_one(params, tok: torch.Tensor, pos: int) -> torch.Tensor:
    """tok: [b, 1] -> [b, 1, d] with the position-``pos`` embedding."""
    return params["tok_emb"][tok] + params["pos_emb"][pos : pos + 1][None, :, :]


def _logits(params, x):
    x = _ln(params["ln_f"], x)
    return x @ params["tok_emb"].t().to(x.dtype)  # weight-tied head


def _long(ids) -> torch.Tensor:
    return ids.long() if isinstance(ids, torch.Tensor) else torch.as_tensor(np.asarray(ids)).long()


def generate(params: dict, ids: torch.Tensor, max_new_tokens: int) -> torch.Tensor:
    """Greedy decode: ids[b, s] -> [b, s + max_new_tokens] int32.

    Prefill fills the KV caches in one causal pass; then ``max_new_tokens -
    1`` single-token steps run against the static caches (the first token
    comes from prefill), written in place. No step reads back to the host."""
    dev = params["tok_emb"].device
    ids = _long(ids).to(dev)
    b, s = ids.shape
    heads = _heads(params)
    max_ctx = s + max_new_tokens
    max_len = params["pos_emb"].shape[0]
    if max_ctx > max_len:
        raise ValueError(
            f"prompt {s} + max_new_tokens {max_new_tokens} exceeds the "
            f"position table ({max_len}) — raise max_len"
        )
    x = _embed(params, ids)
    hd = x.shape[-1] // heads
    n_layers = len(params["layers"])
    cache_k = torch.zeros((n_layers, b, heads, max_ctx, hd), dtype=x.dtype, device=dev)
    cache_v = torch.zeros_like(cache_k)
    for li, lp in enumerate(params["layers"]):
        x, k, v = _layer_prefill(lp, x, heads)
        cache_k[li, :, :, :s] = k
        cache_v[li, :, :, :s] = v
    tok = torch.argmax(_logits(params, x[:, -1:, :]), dim=-1)  # [b, 1]
    gen = [tok]
    for pos in range(s, s + max_new_tokens - 1):
        x = _embed_one(params, tok, pos)
        for li, lp in enumerate(params["layers"]):
            x, _, _ = _layer_step(lp, x, cache_k[li], cache_v[li], pos, heads)
        tok = torch.argmax(_logits(params, x), dim=-1)
        gen.append(tok)
    return torch.cat([ids, *gen], dim=1).to(torch.int32)


# --------------------------------------------------------------------------
# Continuous-batching building blocks (serving/decode_scheduler.py): the
# fused ``generate`` split into a prefill, a static [L, n_slots, h, max_ctx,
# hd] slot cache, a per-slot decode step and sampling. All shapes are
# static in (n_slots, max_ctx), so one program shape serves every batch
# composition.


def decoder_dims(params: dict) -> dict:
    """Static geometry the scheduler sizes its cache from."""
    hidden = params["layers"][0]["qkv"]["w"].shape[0]
    heads = _heads(params)
    return {
        "layers": len(params["layers"]),
        "heads": heads,
        "hidden": hidden,
        "head_dim": hidden // heads,
        "vocab": params["tok_emb"].shape[0],
        "max_len": params["pos_emb"].shape[0],
    }


def prefill(params: dict, ids) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One causal pass over prompts ids[b, s] -> (logits[b, vocab],
    k[L, b, h, s, hd], v[L, b, h, s, hd])."""
    ids = _long(ids).to(params["tok_emb"].device)
    heads = _heads(params)
    x = _embed(params, ids)
    ks, vs = [], []
    for lp in params["layers"]:
        x, k, v = _layer_prefill(lp, x, heads)
        ks.append(k)
        vs.append(v)
    logits = _logits(params, x[:, -1:, :])[:, 0, :]
    return logits, torch.stack(ks), torch.stack(vs)


def _buffer(params, shape, dtype, fill: float = 0.0):
    """A KV buffer of global ``shape`` on the parameters' device, or over
    their decode mesh by the KV layout (``parallel/tp.py::kv_placed``)."""
    if isinstance(params, TPParams):
        return kv_placed(shape, dtype, params.mesh, params.axis, fill)
    return torch.full(shape, fill, dtype=dtype, device=params["tok_emb"].device)


def init_slot_cache(params: dict, n_slots: int, max_ctx: int, dtype=torch.float32):
    """Zeroed slot KV cache pair, each [L, n_slots, heads, max_ctx, hd]
    (head-sharded over a decode mesh)."""
    d = decoder_dims(params)
    shape = (d["layers"], n_slots, d["heads"], max_ctx, d["head_dim"])
    return _buffer(params, shape, dtype), _buffer(params, shape, dtype)


def write_prefill(cache_k, cache_v, k, v, slot: int):
    """Write one prefilled sequence's K/V (k[L, 1, h, s, hd]) into ``slot``
    positions 0..s-1, in place."""
    s = k.shape[3]
    cache_k[:, slot : slot + 1, :, :s] = k
    cache_v[:, slot : slot + 1, :, :s] = v
    return cache_k, cache_v


def _block_index(positions: torch.Tensor, m: int, length: int) -> torch.Tensor:
    """[n, m] cache rows of an m-wide block written at positions[i], the
    start clamped so the block fits, as lax.dynamic_update_slice does."""
    start = positions.clamp(0, length - m)
    return start[:, None] + torch.arange(m, device=positions.device)[None, :]


def _layer_step_slots(p, x, cache_k, cache_v, positions, h, counts=None, starts=None):
    """_layer_step at PER-SLOT positions and m queries per slot. x: [n, m,
    d]; cache [n, h, max_ctx, hd]; positions [n]: slot i's query j sits at
    positions[i] + j, writes its K/V there and attends to cache entries <=
    positions[i] + j. ``counts`` [n] (chunked prefill): slot i keeps only its
    first counts[i] K/V entries and leaves the rest of its cache as it was.
    ``starts`` [n]: slot i's attention lower bound, entries before starts[i]
    masked out (the feature head on a prefix-warm admission, whose reused
    span has no draft K/V); None keeps the whole [0, pos] window."""
    q, k, v = _qkv(p, x, h)  # [n, h, m, hd]
    ctx = _per_head(p, _slots_attend, (q, k, v), cache_k, cache_v, positions, counts, starts, x.dtype)
    return _close(p, x, ctx), cache_k, cache_v


def _slots_attend(q, k, v, cache_k, cache_v, positions, counts, starts, dtype):
    """``_layer_step_slots``' cache write and attention on the heads given."""
    n, m = q.shape[0], q.shape[2]
    dev = q.device
    rows = torch.arange(n, device=dev)[:, None]
    cols = _block_index(positions, m, cache_k.shape[2])
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # [n, m, h, hd]
    if counts is not None:
        keep = (torch.arange(m, device=dev)[None, :] < counts[:, None])[:, :, None, None]
        kt = torch.where(keep, kt, cache_k[rows, :, cols, :])
        vt = torch.where(keep, vt, cache_v[rows, :, cols, :])
    cache_k[rows, :, cols, :] = kt.to(cache_k.dtype)
    cache_v[rows, :, cols, :] = vt.to(cache_v.dtype)
    q_pos = positions[:, None] + torch.arange(m, device=dev)[None, :]
    keys = torch.arange(cache_k.shape[2], device=dev)[None, None, :]
    valid = keys <= q_pos[:, :, None]
    if starts is not None:
        valid = valid & (keys >= starts[:, None, None])
    return _attend(q, cache_k, cache_v, valid, dtype)


def _slots_forward(params, cache_k, cache_v, tokens, positions, counts=None):
    """Shared body of decode_step and chunk_prefill: tokens[n, m] with slot
    i's query j at positions[i] + j (junk queries past the position table
    clip it; their logits are never read)."""
    heads = _heads(params)
    tokens, positions = tokens.long(), positions.long()
    counts = None if counts is None else counts.long()
    m = tokens.shape[1]
    max_len = params["pos_emb"].shape[0]
    pidx = (positions[:, None] + torch.arange(m, device=tokens.device)[None, :]).clamp(0, max_len - 1)
    x = params["tok_emb"][tokens] + params["pos_emb"][pidx]
    for li, lp in enumerate(params["layers"]):
        x, _, _ = _layer_step_slots(lp, x, cache_k[li], cache_v[li], positions, heads, counts)
    return _logits(params, x)


def decode_step(params, cache_k, cache_v, tokens, positions):
    """One decode step for every slot: consume tokens[n] at positions[n],
    return (logits[n, vocab], cache_k, cache_v) with each slot's K/V
    written at its own position. Free slots step too (position 0)."""
    logits = _slots_forward(params, cache_k, cache_v, tokens[:, None], positions)
    return logits[:, 0, :], cache_k, cache_v


def chunk_prefill(params, cache_k, cache_v, tokens, positions, counts):
    """One prefill chunk for every slot: consume tokens[n, c] with slot i's
    token j at positions[i] + j, keeping only the first counts[i] K/V
    entries per slot. Returns (logits[n, c, vocab], cache_k, cache_v);
    logits[i, counts[i] - 1] is the next-token distribution after slot i's
    last consumed token."""
    return _slots_forward(params, cache_k, cache_v, tokens, positions, counts), cache_k, cache_v


def verify_step(params, cache_k, cache_v, tokens, positions):
    """decode_step widened to m queries per slot: consume tokens[n, m] (the
    last emitted token and the m-1 draft proposals) with slot i's query j at
    positions[i] + j; returns (logits[n, m, vocab], cache_k, cache_v) with
    every query's K/V written at its own position. logits[i, j] is the
    next-token distribution after consuming query j, what j sequential
    decode steps give for the same prefix."""
    return _slots_forward(params, cache_k, cache_v, tokens, positions), cache_k, cache_v


def _transform_logits(logits: torch.Tensor, temperature, top_k) -> torch.Tensor:
    """top_k restriction (<= 0: the full vocabulary), then temperature
    scaling, per row. top_k is data, not shape."""
    vocab = logits.shape[-1]
    temperature = torch.as_tensor(temperature, device=logits.device).expand(logits.shape[:-1])
    top_k = torch.as_tensor(top_k, device=logits.device).expand(logits.shape[:-1])
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_idx = (top_k - 1).clamp(0, vocab - 1).long()
    thresh = torch.gather(sorted_desc, -1, k_idx[..., None])
    restricted = torch.where(logits < thresh, float("-inf"), logits)
    masked = torch.where(top_k[..., None] > 0, restricted, logits)
    return masked / temperature.clamp_min(1e-6)[..., None].to(logits.dtype)


# draw streams of one scheduler tick: the step (or chunk) sample, a
# speculative round's draft proposals, its acceptance
STREAM_STEP, STREAM_DRAFT, STREAM_VERIFY = 0, 1, 2
_STREAM_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant: streams never share a seed


def sampling_generator(seed: int, tick: int, device, stream: int = STREAM_STEP) -> torch.Generator:
    """The draw stream of one sampling call, deterministic in (seed, tick,
    stream). Stream 0 is seeded (seed << 32) | tick; another stream XORs in
    a multiple of an odd constant whose high bits are set, so for one seed
    no two (tick, stream) pairs share a generator seed."""
    base = ((int(seed) & 0xFFFFFFFF) << 32) | (int(tick) & 0xFFFFFFFF)
    g = torch.Generator(device=device)
    g.manual_seed(base ^ ((int(stream) * _STREAM_MIX) & 0xFFFFFFFFFFFFFFFF))
    return g


def _gumbel_argmax(scaled: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of the logits ``scaled`` (the Gumbel-max
    trick, as jax.random.categorical), int64."""
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device).clamp_(1e-20, 1.0)
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)


def sample_tokens(logits, temperature, top_k, generator: torch.Generator | None) -> torch.Tensor:
    """Per row: greedy argmax where temperature <= 0, else a draw from the
    temperature-scaled distribution restricted to the top_k logits.
    ``generator`` may be None only when no row samples."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temperature = torch.as_tensor(temperature, device=logits.device)
    if generator is None:
        return greedy
    sampled = _gumbel_argmax(_transform_logits(logits.float(), temperature, top_k), generator).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


# ------------------------------------------------------------- paged KV
# Block-table KV memory (serving/kv_pool.py owns the allocator): K/V lives
# in a shared page pool [L, n_pages, h, page_size, hd] and each slot carries
# a static-shape block table [max_pages] of physical page ids. Same masks,
# same float32 attention as the slot blocks, but the cache is read through
# a page gather and written through a per-token page/offset scatter.
# Physical page 0 is a junk sink: free slots' block tables are all zero and
# masked-off writes land there, so a static-shape step never touches a live
# page. The pool state is a tuple: (k, v), or (k_q, k_scale, k_zp, v_q,
# v_scale, v_zp) in int8 mode with one (scale, zero point) per page row.


def paged_kv_init(params, n_pages: int, page_size: int, dtype=torch.float32, kv_dtype: str = "") -> tuple:
    """Zeroed page pool state tuple on the parameters' device (over a decode
    mesh: head-sharded payloads, replicated scale planes)."""
    d = decoder_dims(params)
    shape = (d["layers"], n_pages, d["heads"], page_size, d["head_dim"])
    if kv_dtype == "int8":
        sshape = (d["layers"], n_pages, page_size)
        # scale 1 / zero point 0: junk pages read back as exact zeros
        return (
            _buffer(params, shape, torch.int8),
            _buffer(params, sshape, torch.float32, 1.0),
            _buffer(params, sshape, torch.float32),
            _buffer(params, shape, torch.int8),
            _buffer(params, sshape, torch.float32, 1.0),
            _buffer(params, sshape, torch.float32),
        )
    if kv_dtype:
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (want '' or 'int8')")
    return (_buffer(params, shape, dtype), _buffer(params, shape, dtype))


def paged_copy(pool: tuple, src, dst) -> tuple:
    """Copy pool pages src[i] -> dst[i] in every state component, in place
    (the copy-on-write primitive; padding entries copy page 0 onto itself),
    on every position of a decode mesh."""
    for a in pool:
        for t in tp_mod.tensors_of(a):
            s, d = _to(src, t.device), _to(dst, t.device)
            t[:, d] = t[:, s]
    return pool


def _quant_rows(x: torch.Tensor):
    """Per-row asymmetric int8: x[N, h, hd] -> (q[N, h, hd] int8, scale[N],
    zp[N]) with q = round((x - zp) / scale) in [-127, 127], rounding half to
    even as jnp.round does."""
    lo = x.amin(dim=(1, 2))
    hi = x.amax(dim=(1, 2))
    zp = (hi + lo) * 0.5
    scale = torch.clamp_min((hi - lo) / 254.0, 1e-8)
    q = torch.round((x - zp[:, None, None]) / scale[:, None, None]).clamp(-127, 127).to(torch.int8)
    return q, scale, zp


def _paged_write(kv: tuple, k, v, bt, positions, counts):
    """Scatter the step's new K/V (k, v: [n, h, m, hd], slot i's entry j at
    positions[i] + j) into one layer's pool slices through the block
    tables, in place. Entries beyond counts[i] or past the virtual length go
    to junk page 0 instead: duplicate writes happen only there, which every
    mask hides. Over a decode mesh ``k``/``v`` hold every head: int8 rows
    are quantized over all of them, then each position stores its heads."""
    n, h, m, hd = k.shape
    ps = _local(kv[0]).shape[2]
    n_log = bt.shape[1]
    gp = positions[:, None] + torch.arange(m, device=k.device)[None, :]  # global positions
    lp = (gp // ps).clamp(0, n_log - 1)
    phys = torch.gather(bt, 1, lp)
    ok = (gp >= 0) & (gp < n_log * ps)
    if counts is not None:
        ok = ok & (torch.arange(m, device=k.device)[None, :] < counts[:, None])
    pf = torch.where(ok, phys, 0).reshape(-1)
    of = (gp % ps).reshape(-1)
    kt = k.transpose(1, 2).reshape(n * m, h, hd)  # per-token rows
    vt = v.transpose(1, 2).reshape(n * m, h, hd)
    if len(kv) == 2:
        _scatter_rows(kv[0], pf, of, kt)
        _scatter_rows(kv[1], pf, of, vt)
        return kv
    kq, sk, zk, vq, sv, zv = kv
    for (qa, sa, za), rows in (((kq, sk, zk), kt), ((vq, sv, zv), vt)):
        q, scale, zp = _quant_rows(rows.float())
        _scatter_rows(qa, pf, of, q)
        _scatter_rows(sa, pf, of, scale)
        _scatter_rows(za, pf, of, zp)
    return kv


def _local(a):
    """A buffer's first part (itself off a mesh): its local shape and dtype."""
    return a.parts[0] if isinstance(a, Placed) else a


def _scatter_rows(a, pf, of, rows) -> None:
    """``a[pf, :, of, :] = rows`` (a payload, rows [N, h, hd]) or
    ``a[pf, of] = rows`` (a scale plane, rows [N]), in place; a head-sharded
    payload takes each position's heads."""
    if not isinstance(a, Placed):
        if a.dim() == 4:
            a[pf, :, of, :] = rows.to(a.dtype)
        else:
            a[pf, of] = rows
        return

    def put(t, i):
        dev = t.device
        _scatter_rows(t, _to(pf, dev), _to(of, dev), a.block(i, rows, 1))

    a.each_part(put)


def _paged_gather(kv: tuple, bt):
    """Each slot's pages as a virtual contiguous cache [n, h, max_pages *
    page_size, hd] in float32; int8 mode dequantizes here."""
    if len(kv) == 2:
        k = kv[0][bt].float()  # [n, P, h, ps, hd]
        v = kv[1][bt].float()
    else:
        kq, sk, zk, vq, sv, zv = kv
        k = kq[bt].float() * sk[bt][:, :, None, :, None] + zk[bt][:, :, None, :, None]
        v = vq[bt].float() * sv[bt][:, :, None, :, None] + zv[bt][:, :, None, :, None]
    n, p, h, ps, hd = k.shape
    k = k.transpose(1, 2).reshape(n, h, p * ps, hd)
    v = v.transpose(1, 2).reshape(n, h, p * ps, hd)
    return k, v


def _layer_step_paged(p, x, kv, bt, positions, h, counts=None):
    """_layer_step_slots over the page pool: the new K/V scatters through
    the block tables first, then attention reads the pool back through a
    page gather, so a query sees the keys earlier queries of the same step
    just wrote. Returns (x_out, kv)."""
    q, k, v = _qkv(p, x, h)
    kv = _paged_write(kv, k, v, bt, positions, counts)
    ctx = _per_head(p, _paged_attend, (q,), kv, bt, positions, x.dtype)
    return _close(p, x, ctx), kv


def _paged_attend(q, kv, bt, positions, dtype):
    """``_layer_step_paged``'s attention on the heads given, over their
    part of the pool."""
    cache_k, cache_v = _paged_gather(kv, bt)
    m = q.shape[2]
    q_pos = positions[:, None] + torch.arange(m, device=q.device)[None, :]
    valid = torch.arange(cache_k.shape[2], device=q.device)[None, None, :] <= q_pos[:, :, None]
    return _attend(q, cache_k, cache_v, valid, dtype)


def _paged_forward(params, pool, bt, tokens, positions, counts=None):
    """Shared body of the paged decode and chunk steps: tokens[n, m] with
    slot i's query j at positions[i] + j; returns (logits[n, m, vocab],
    hidden[n, m, d], pool), the pool written in place."""
    heads = _heads(params)
    tokens, positions, bt = tokens.long(), positions.long(), bt.long()
    counts = None if counts is None else counts.long()
    m = tokens.shape[1]
    max_len = params["pos_emb"].shape[0]
    pidx = (positions[:, None] + torch.arange(m, device=tokens.device)[None, :]).clamp(0, max_len - 1)
    x = params["tok_emb"][tokens] + params["pos_emb"][pidx]
    for li, lp in enumerate(params["layers"]):
        x, _ = _layer_step_paged(lp, x, tuple(a[li] for a in pool), bt, positions, heads, counts)
    return _logits(params, x), x, pool


def paged_decode_step(params, pool, bt, tokens, positions):
    """decode_step over the page pool: consume tokens[n] at positions[n];
    returns (logits[n, vocab], hidden[n, d], pool)."""
    logits, hidden, pool = _paged_forward(params, pool, bt, tokens[:, None], positions)
    return logits[:, 0, :], hidden[:, 0, :], pool


def paged_chunk_prefill(params, pool, bt, tokens, positions, counts):
    """chunk_prefill over the page pool: persist only the first counts[i]
    K/V entries per slot (the rest go to the junk page). Returns (logits,
    hidden[n, c, d], pool)."""
    return _paged_forward(params, pool, bt, tokens, positions, counts)


def paged_verify_step(params, pool, bt, tokens, positions):
    """verify_step over the page pool: m queries per slot, logits[i, j]
    scored after consuming query j — the widened speculative verify.
    Returns (logits, hidden[n, m, d], pool)."""
    return _paged_forward(params, pool, bt, tokens, positions)


# ------------------------------------------------ speculative decoding
# Draft-model speculation (Leviathan et al.; Chen et al.): a small draft
# decoder proposes k tokens per slot in one dispatch, the target scores all
# k+1 queries against the pool in one widened dispatch, and the longest
# valid prefix is accepted. Speculative writes need no rollback: positions
# advance only by the accepted length, so rejected entries sit beyond every
# later mask until the next consumed token overwrites them.


def draft_propose(params, cache_k, cache_v, tokens, positions, temperature, top_k, generator, k: int):
    """k autoregressive draft steps: from each slot's last emitted token,
    propose (draft_tokens[n, k] int32, draft_logits[n, k, vocab], cache_k,
    cache_v), the flat draft cache written in place. Greedy rows propose
    the argmax; sampled rows draw from the same transformed distribution
    ``sample_tokens`` serves (the q that acceptance corrects against).
    ``generator`` may be None only when no row samples."""
    toks = tokens
    drafts, logit_steps = [], []
    for j in range(k):
        logits, cache_k, cache_v = decode_step(params, cache_k, cache_v, toks, positions + j)
        toks = sample_tokens(logits, temperature, top_k, generator)
        drafts.append(toks)
        logit_steps.append(logits)
    # one more cache-fill step consuming the LAST proposal at pos + k
    # (logits discarded): a fully accepted round moves the slot past pos +
    # k without consuming d_k here, and without this write the draft cache
    # keeps a hole inside every later mask and the accept rate decays
    decode_step(params, cache_k, cache_v, toks, positions + k)
    return torch.stack(drafts, dim=1), torch.stack(logit_steps, dim=1), cache_k, cache_v


def speculative_accept(target_logits, draft_tokens, draft_logits, limits, temperature, top_k, generator):
    """The acceptance rule. target_logits [n, k+1, V] (position j scored
    after consuming query j), the draft's proposals [n, k] and raw logits
    [n, k, V], per-slot accept limits [n] (0..k): returns (out_tokens
    [n, k+1] int32, n_accepted [n] int32); slot i emits
    out_tokens[i, :n_accepted[i] + 1].

    Greedy rows (temperature <= 0) accept the longest draft prefix equal to
    the target's own argmax chain and emit the target's argmax at the first
    mismatch: sequential greedy decoding, by induction. Sampled rows accept
    d_j with probability min(1, p(d_j) / q(d_j)) and resample a true
    rejection from the residual max(p - q, 0); a limit clamp is not a
    rejection (nothing was proposed there), its bonus samples p.
    ``generator`` may be None only when no row samples."""
    n, kp1, _ = target_logits.shape
    k = kp1 - 1
    dev = target_logits.device
    rows = torch.arange(n, device=dev)
    draft_tokens = draft_tokens.long()
    limits = limits.long()
    greedy_t = torch.argmax(target_logits, dim=-1)  # [n, k+1]
    ok = draft_tokens == greedy_t[:, :k]
    if generator is not None:
        temp, topk = temperature[:, None], top_k[:, None]
        p = torch.softmax(_transform_logits(target_logits.float(), temp, topk), dim=-1)
        q = torch.softmax(_transform_logits(draft_logits.float(), temp, topk), dim=-1)
        p_d = torch.gather(p[:, :k], -1, draft_tokens[..., None])[..., 0]
        q_d = torch.gather(q, -1, draft_tokens[..., None])[..., 0]
        u = torch.rand((n, k), generator=generator, device=dev)
        ok = torch.where(temperature[:, None] > 0, u * q_d < p_d, ok)  # u < p/q without the division
    ok = ok & (torch.arange(k, device=dev)[None, :] < limits[:, None])
    n_acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    bonus = greedy_t[rows, n_acc]
    if generator is not None:
        p_a = p[rows, n_acc]
        q_a = torch.where((n_acc < k)[:, None], q[rows, n_acc.clamp(max=k - 1)], 0.0)
        residual = (p_a - q_a).clamp_min(0.0)
        rsum = residual.sum(dim=-1, keepdim=True)
        residual = torch.where(rsum > 1e-9, residual / rsum.clamp_min(1e-9), p_a)
        dist = torch.where((n_acc < limits)[:, None], residual, p_a)  # a draft existed here and lost
        bonus = torch.where(temperature > 0, _gumbel_argmax(torch.log(dist + 1e-38), generator), bonus)
    out = torch.cat([draft_tokens, torch.zeros((n, 1), dtype=torch.long, device=dev)], dim=1)
    out[rows, n_acc] = bonus
    return out.to(torch.int32), n_acc.to(torch.int32)


# -------------------------------------------------- tree speculation
# The draft proposes a token TREE (``branching[d]`` candidates per depth
# under every surviving branch; models/spec_tree.py owns the layout) and the
# target scores the flattened tree in one widened dispatch; acceptance
# walks the longest valid path. Sibling nodes at one depth would collide on
# one (page, offset), so the tree forward never writes the pool: in-dispatch
# queries read their ancestors' K/V in registers through the ancestor mask,
# and only the accepted path is committed afterwards, every other column
# sent to junk page 0.


def sequence_hidden(params, ids):
    """Teacher-forced (logits, hidden) at every position: ids[b, s] ->
    ([b, s, vocab], [b, s, d]); ``hidden`` is the final layer's residual
    stream (pre-``ln_f``)."""
    ids = _long(ids).to(params["tok_emb"].device)
    heads = _heads(params)
    x = _embed(params, ids)
    for lp in params["layers"]:
        x, _, _ = _layer_prefill(lp, x, heads)
    return _logits(params, x), x


def sequence_logits(params, ids):
    """Teacher-forced logits at every position: ids[b, s] -> [b, s, vocab];
    row j is the next-token distribution after tokens 0..j."""
    return sequence_hidden(params, ids)[0]


@lru_cache(maxsize=32)
def _tree_tables(tree, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ancestor_mask [width, width] bool, block_depth [width], child_table
    [width, max_b]) of a tree on ``device``, copied once: a program that
    uploaded them per call would wait on the card at every upload, and a
    CUDA graph capture refuses the upload, so the decode scheduler makes
    them when it builds its tree, before any program runs."""
    return (
        torch.from_numpy(tree.ancestor_mask).to(device),
        torch.from_numpy(tree.block_depth).long().to(device),
        torch.from_numpy(tree.child_table).long().to(device),
    )


def _layer_tree_flat(p, x, cache_k, cache_v, positions, h, ek, ev, sub_mask, starts=None):
    """One layer of a draft tree-expansion step over the FLAT draft cache:
    x [n, c, d] carries one depth's nodes; attention reads the cache at
    entries <= positions[i] (prompt, committed tokens and the root's fresh
    write) plus the in-register K/V of every node proposed so far this round
    (``ek``/``ev`` [n, h, E, hd], grown per depth; never written to the
    cache). ``sub_mask`` [c, E + c] is the ancestor-or-self mask over those
    nodes; ``starts`` [n] opens slot i's cache window at starts[i] (see
    ``_layer_step_slots``). Returns (x_out, ek', ev') with this depth's K/V
    appended."""
    q, k, v = _qkv(p, x, h)  # [n, h, c, hd]
    ek = k if ek is None else torch.cat([ek, k], dim=2)
    ev = v if ev is None else torch.cat([ev, v], dim=2)
    ctx = _per_head(p, _tree_flat_attend, (q, ek, ev), cache_k, cache_v, positions, sub_mask, starts, x.dtype)
    return _close(p, x, ctx), ek, ev


def _tree_flat_attend(q, ek, ev, cache_k, cache_v, positions, sub_mask, starts, dtype):
    """``_layer_tree_flat``'s attention on the heads given: the cache window
    plus the in-register nodes under the ancestor mask."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qf = q.float()
    c_len = cache_k.shape[2]
    s_cache = torch.einsum("nhqd,nhkd->nhqk", qf, cache_k.float()) * scale
    keys = torch.arange(c_len, device=q.device)[None, None, None, :]
    valid = keys <= positions[:, None, None, None]
    if starts is not None:
        valid = valid & (keys >= starts[:, None, None, None])
    s_cache = torch.where(valid, s_cache, NEG_INF)
    s_ext = torch.einsum("nhqd,nhkd->nhqk", qf, ek.float()) * scale
    s_ext = torch.where(sub_mask[None, None], s_ext, NEG_INF)
    p_attn = torch.softmax(torch.cat([s_cache, s_ext], dim=-1), dim=-1)
    ctx = torch.einsum("nhqk,nhkd->nhqd", p_attn[..., :c_len], cache_v.float()) + torch.einsum(
        "nhqk,nhkd->nhqd", p_attn[..., c_len:], ev.float()
    )
    return _merge_heads(ctx.to(dtype))


def _tree_candidates(parent_logits, temperature, top_k, generator, b: int):
    """One depth's candidates [n, c_prev * b] in parent-major block order,
    from the parents' logits [n, c_prev, V]. Greedy rows take the top-b
    distinct tokens (branch 0 is the chain's argmax proposal); sampled rows
    draw b i.i.d. tokens from the transformed distribution ``sample_tokens``
    serves, which is what makes the per-depth recursive rejection in
    ``speculative_accept_tree`` exact."""
    n, c_prev, _ = parent_logits.shape
    cand = torch.topk(parent_logits, b, dim=-1).indices  # [n, c_prev, b]
    if generator is not None:
        scaled = _transform_logits(
            parent_logits.reshape(n * c_prev, -1).float(),
            temperature.repeat_interleave(c_prev),
            top_k.repeat_interleave(c_prev),
        )
        sampled = torch.stack([_gumbel_argmax(scaled, generator) for _ in range(b)], dim=-1)
        cand = torch.where((temperature > 0)[:, None, None], sampled.reshape(n, c_prev, b), cand)
    return cand.reshape(n, c_prev * b).to(torch.int32)


def draft_propose_tree(params, cache_k, cache_v, tokens, positions, temperature, top_k, generator, tree):
    """Grow the whole proposal tree: a root decode step (consume the last
    emitted token at ``pos`` and write its K/V — always consumed, so the
    write is never speculative), then ``tree.depth`` widened expansions,
    each proposing ``branching[d]`` children per node.

    Returns (node_tokens [n, n_tree] int32, block_logits [n, width, V],
    node_k [L, n, h, n_tree, hd], node_v, cache_k, cache_v): block j's
    logits are the draft's next-token distribution after consuming block
    j's token along its path (block 0: the root), the q each node's
    children are corrected against. The cache gains only the root's entry;
    the verify dispatch commits the accepted path (``draft_tree_commit``)."""
    heads = _heads(params)
    max_len = params["pos_emb"].shape[0]
    positions = positions.long()
    mask = _tree_tables(tree, positions.device)[0]
    logits0, cache_k, cache_v = decode_step(params, cache_k, cache_v, tokens, positions)
    n_layers = len(params["layers"])
    ek: list = [None] * n_layers
    ev: list = [None] * n_layers
    block_logits, node_tokens = [logits0[:, None, :]], []
    parent_logits = logits0[:, None, :]
    for d in range(1, tree.depth + 1):
        c_d, start = tree.level_counts[d - 1], tree.level_starts[d - 1]
        toks_d = _tree_candidates(parent_logits, temperature, top_k, generator, tree.branching[d - 1])
        node_tokens.append(toks_d)
        pidx = (positions + d).clamp(0, max_len - 1)
        x = params["tok_emb"][toks_d.long()] + params["pos_emb"][pidx][:, None, :]
        sub_mask = mask[start : start + c_d, 1 : start + c_d]
        for li, lp in enumerate(params["layers"]):
            x, ek[li], ev[li] = _layer_tree_flat(
                lp, x, cache_k[li], cache_v[li], positions, heads, ek[li], ev[li], sub_mask
            )
        parent_logits = _logits(params, x)  # [n, c_d, V]
        block_logits.append(parent_logits)
    return (
        torch.cat(node_tokens, dim=1),
        torch.cat(block_logits, dim=1),
        torch.stack(ek),
        torch.stack(ev),
        cache_k,
        cache_v,
    )


def _layer_tree_paged(p, x, kv, bt, positions, h, mask):
    """One layer of the widened target tree verify over the page pool: all
    ``width`` blocks at once, attention over the gathered cache (entries
    strictly before ``pos``: nothing speculative lives there) plus the
    dispatch's own fresh K/V under the ancestor mask. The pool is not
    written. int8 pools round-trip the fresh K/V through the per-row
    quantizer the commit will apply (and fp pools through the pool dtype),
    so every value a query reads is what the sequential plain path would
    read back from the pool. Returns (x_out, k, v) with the raw fresh K/V
    for the commit."""
    q, k, v = _qkv(p, x, h)  # [n, h, m, hd]
    n, hh, m, hd = k.shape
    if len(kv) == 6:

        def _rt(t):
            qr, sc, zp = _quant_rows(t.transpose(1, 2).reshape(n * m, hh, hd).float())
            deq = qr.float() * sc[:, None, None] + zp[:, None, None]
            return deq.reshape(n, m, hh, hd).transpose(1, 2)

        k_att, v_att = _rt(k), _rt(v)
    else:
        pool_dtype = _local(kv[0]).dtype
        k_att, v_att = k.to(pool_dtype).float(), v.to(pool_dtype).float()
    ctx = _per_head(p, _tree_paged_attend, (q, k_att, v_att), kv, bt, positions, mask, x.dtype)
    return _close(p, x, ctx), k, v


def _tree_paged_attend(q, k_att, v_att, kv, bt, positions, mask, dtype):
    """``_layer_tree_paged``'s attention on the heads given: their part of
    the pool before ``pos`` plus the dispatch's fresh K/V under the
    ancestor mask."""
    cache_k, cache_v = _paged_gather(kv, bt)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qf = q.float()
    c_len = cache_k.shape[2]
    s_cache = torch.einsum("nhqd,nhkd->nhqk", qf, cache_k) * scale
    valid = torch.arange(c_len, device=q.device)[None, None, None, :] < positions[:, None, None, None]
    s_cache = torch.where(valid, s_cache, NEG_INF)
    s_blk = torch.einsum("nhqd,nhkd->nhqk", qf, k_att) * scale
    s_blk = torch.where(mask[None, None], s_blk, NEG_INF)
    p_attn = torch.softmax(torch.cat([s_cache, s_blk], dim=-1), dim=-1)
    ctx = torch.einsum("nhqk,nhkd->nhqd", p_attn[..., :c_len], cache_v) + torch.einsum(
        "nhqk,nhkd->nhqd", p_attn[..., c_len:], v_att
    )
    return _merge_heads(ctx.to(dtype))


def paged_tree_verify(params, pool, bt, tokens, positions, tree):
    """Score the flattened tree in one widened dispatch: tokens [n, width]
    (block 0 the last emitted token, blocks 1.. the tree nodes), block j at
    position ``pos + depth(j)``. logits[i, j] is the target's next-token
    distribution after consuming block j's token along its path. Returns
    (logits [n, width, V], hidden [n, width, d], new_k [L, n, h, width, hd],
    new_v); the pool is untouched (``paged_tree_commit`` writes the
    accepted path)."""
    heads = _heads(params)
    max_len = params["pos_emb"].shape[0]
    tokens, positions, bt = tokens.long(), positions.long(), bt.long()
    mask, block_depth, _ = _tree_tables(tree, tokens.device)
    pidx = (positions[:, None] + block_depth[None, :]).clamp(0, max_len - 1)
    x = params["tok_emb"][tokens] + params["pos_emb"][pidx]
    nk, nv = [], []
    for li, lp in enumerate(params["layers"]):
        x, k, v = _layer_tree_paged(lp, x, tuple(a[li] for a in pool), bt, positions, heads, mask)
        nk.append(k)
        nv.append(v)
    return _logits(params, x), x, torch.stack(nk), torch.stack(nv)


def _select_path(node_kv: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """node_kv [L, n, h, W, hd] -> [L, n, h, D, hd]: slot i's columns
    idx[i] (int64 [n, D])."""
    L, n, h, _, hd = node_kv.shape
    return torch.gather(node_kv, 3, idx[None, :, None, :, None].expand(L, n, h, idx.shape[1], hd))


def paged_tree_commit(pool, bt, new_k, new_v, path_idx, positions, n_acc):
    """Write the ACCEPTED path's K/V (the root block and the chosen node at
    depths 1..n_acc) through the block tables at ``pos..pos+n_acc``, in
    place; every column past ``n_acc + 1`` goes to junk page 0 by the
    counts mask, so the pool holds exactly what sequential decoding would
    have written."""
    idx = path_idx.long()
    k_sel, v_sel = _select_path(new_k, idx), _select_path(new_v, idx)
    bt, positions, counts = bt.long(), positions.long(), n_acc.long() + 1
    for li in range(new_k.shape[0]):
        _paged_write(tuple(a[li] for a in pool), k_sel[li], v_sel[li], bt, positions, counts)
    return pool


def draft_tree_commit(cache_k, cache_v, node_k, node_v, path_idx, positions, n_acc):
    """The draft-side twin of ``paged_tree_commit``: write the accepted
    path's draft K/V into the flat draft cache at ``pos+1..pos+n_acc`` (the
    root's entry at ``pos`` was written by the draft dispatch itself), in
    place. node_k/node_v [L, n, h, n_tree, hd] are in node order, so
    ``path_idx[:, 1:] - 1`` selects the chosen node per depth; columns past
    ``n_acc`` keep the cache's bytes (a masked select: a zero-accept slot
    changes nothing)."""
    depth = path_idx.shape[1] - 1
    idx = (path_idx[:, 1:].long() - 1).clamp_min(0)
    k_sel, v_sel = _select_path(node_k, idx), _select_path(node_v, idx)  # [L, n, h, D, hd]
    n = idx.shape[0]
    rows = torch.arange(n, device=idx.device)[:, None]
    cols = _block_index(positions.long() + 1, depth, cache_k.shape[3])
    keep = (torch.arange(depth, device=idx.device)[None, :] < n_acc.long()[:, None])[:, :, None, None]

    def commit(cache, sel):  # cache [L, n, h, T, hd], sel [L, n, h, D, hd]
        dev = cache.device
        r, c_, kp = _to(rows, dev), _to(cols, dev), _to(keep, dev)
        for li in range(cache.shape[0]):
            c = cache[li]  # [n, h, T, hd]
            c[r, :, c_, :] = torch.where(kp, sel[li].transpose(1, 2).to(c.dtype), c[r, :, c_, :])

    for cache, sel in ((cache_k, k_sel), (cache_v, v_sel)):
        _each_block(cache, sel, 2, commit)
    return cache_k, cache_v


def _each_block(buf, full: torch.Tensor, dim: int, fn) -> None:
    """``fn(buffer, values)``: once, or over a decode mesh once per position
    with its part of ``buf`` and its heads of ``full`` (head axis ``dim``)."""
    if isinstance(buf, Placed):
        buf.each_part(lambda t, i: fn(t, buf.block(i, full, dim)))
    else:
        fn(buf, full)


def speculative_accept_tree(target_logits, block_tokens, draft_logits, width_limits, temperature, top_k,
                            generator, tree):
    """Longest-accepted-PATH walk over the scored tree. Per depth the
    current node's children (in branch order, gated by ``width_limits
    [n, depth]``, the per-slot tighten/adapt mask; width 0 at a depth ends
    that slot's walk as a limit clamp, not a rejection) are tried:

    - greedy rows (temperature <= 0) accept the child equal to the target's
      own argmax at the current node: sequential greedy decoding, for any
      draft;
    - sampled rows run recursive rejection resampling (SpecInfer): each
      candidate (i.i.d. from the draft's q) accepts with probability
      min(1, r(c)/q(c)) against the running residual r (r starts at the
      target's p; a rejection folds q out: r <- norm(max(r - q, 0))).

    The bonus token at the final node samples the target's p, or after a
    true rejection the final residual. Returns (out_tokens [n, depth+1]
    int32 — slot i emits out[:n_acc[i]+1], n_acc [n] int32, path_idx
    [n, depth+1] int32 block indices, path_idx[:, 0] = 0). ``generator``
    may be None only when no row samples."""
    n, _, vocab = target_logits.shape
    dev = target_logits.device
    rows = torch.arange(n, device=dev)
    block_tokens = block_tokens.long()
    width_limits = width_limits.long()
    greedy_t = torch.argmax(target_logits, dim=-1)  # [n, width]
    child_tab = _tree_tables(tree, dev)[2]
    sampled = generator is not None
    if sampled:
        temp, topk = temperature[:, None], top_k[:, None]
        p_all = torch.softmax(_transform_logits(target_logits.float(), temp, topk), dim=-1)
        q_all = torch.softmax(_transform_logits(draft_logits.float(), temp, topk), dim=-1)
        sampled_row = temperature > 0
        rejected = torch.zeros(n, dtype=torch.bool, device=dev)
        rej_dist = torch.zeros((n, vocab), dtype=torch.float32, device=dev)
    cur = torch.zeros(n, dtype=torch.long, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    n_acc = torch.zeros(n, dtype=torch.long, device=dev)
    path_blocks = []
    for d in range(1, tree.depth + 1):
        b = tree.branching[d - 1]
        ch = child_tab[cur][:, :b]  # [n, b] candidate block indices
        ch_tok = torch.gather(block_tokens, 1, ch)
        wl = width_limits[:, d - 1]
        step_ok = alive & (wl > 0)
        in_w = torch.arange(b, device=dev)[None, :] < wl[:, None]
        # greedy arm: at most one candidate can match (top-b is distinct)
        g_match = (ch_tok == greedy_t[rows, cur][:, None]) & in_w
        acc_d, sel = g_match.any(dim=1), torch.argmax(g_match.to(torch.uint8), dim=1)
        if sampled:
            p_cur, q_cur = p_all[rows, cur], q_all[rows, cur]
            r = p_cur
            s_acc = torch.zeros(n, dtype=torch.bool, device=dev)
            s_sel = torch.zeros(n, dtype=torch.long, device=dev)
            for bi in range(b):
                c_tok = ch_tok[:, bi : bi + 1]
                r_c = torch.gather(r, 1, c_tok)[:, 0]
                q_c = torch.gather(q_cur, 1, c_tok)[:, 0]
                u = torch.rand(n, generator=generator, device=dev)
                considered = in_w[:, bi] & ~s_acc
                ok_bi = considered & (u * q_c < r_c)  # u < r/q without dividing
                s_sel = torch.where(ok_bi, bi, s_sel)
                s_acc = s_acc | ok_bi
                # a rejected candidate folds its proposal out of the residual
                r_new = (r - q_cur).clamp_min(0.0)
                rs = r_new.sum(dim=-1, keepdim=True)
                r_new = torch.where(rs > 1e-9, r_new / rs.clamp_min(1e-9), p_cur)
                r = torch.where((considered & ~ok_bi)[:, None], r_new, r)
            acc_d = torch.where(sampled_row, s_acc, acc_d)
            sel = torch.where(sampled_row, s_sel, sel)
        acc_d = acc_d & step_ok
        if sampled:
            # a TRUE rejection (candidates existed, all lost) pins the final
            # residual as the bonus distribution; a limit clamp does not
            rej_now = step_ok & ~acc_d
            rej_dist = torch.where((rej_now & ~rejected)[:, None], r, rej_dist)
            rejected = rejected | rej_now
        cur = torch.where(acc_d, ch[rows, sel], cur)
        n_acc = n_acc + acc_d.long()
        alive = alive & acc_d
        path_blocks.append(cur)
    bonus = greedy_t[rows, cur]
    if sampled:
        dist = torch.where(rejected[:, None], rej_dist, p_all[rows, cur])
        bonus = torch.where(sampled_row, _gumbel_argmax(torch.log(dist + 1e-38), generator), bonus)
    path_idx = torch.cat([torch.zeros((n, 1), dtype=torch.long, device=dev), torch.stack(path_blocks, dim=1)], dim=1)
    out = torch.cat(
        [torch.gather(block_tokens, 1, path_idx[:, 1:]), torch.zeros((n, 1), dtype=torch.long, device=dev)], dim=1
    )
    out[rows, n_acc] = bonus
    return out.to(torch.int32), n_acc.to(torch.int32), path_idx.to(torch.int32)


# ------------------------------------------------------ feature-level draft
# EAGLE-style feature drafting (Li et al., EAGLE): the draft head conditions
# on the TARGET's last hidden state, the final layer's residual stream that
# the paged programs above return as ``hidden``, instead of re-embedding
# tokens through truncated layers. The head is one transformer layer and a
# weight-tied LM head; its input at position j is
# ``fc([target_feature_{j-1} ; tok_emb(token_j)])`` (position 0 pads the
# feature with zeros), and the tree expansion autoregresses in feature
# space: a depth-d node's input feature is its parent node's own hidden.
# The cache discipline is the token tree's: a flat per-slot K/V cache of
# one layer, a root write that is never speculative, expansion K/V in
# registers, and only the accepted path committed (``draft_tree_commit``).
# On a prefix-warm admission the reused span has no draft K/V, and
# ``starts`` opens the head's attention window at the computed suffix.


def is_feature_draft(params) -> bool:
    """Whether a draft's parameter tree is the feature-head layout (the
    ``fc`` fuse marks it; a truncated decoder has none)."""
    return isinstance(params, dict) and "fc" in params


def init_feature_draft(seed: int = 0, vocab: int = 512, hidden: int = 128, ffn: int = 256,
                       max_len: int = 128) -> dict:
    """Numpy feature-head parameters, bit-identical to the JAX package's:
    the ``fc`` [2*hidden -> hidden] fuse, one decoder layer, a position
    table and the weight-tied LM head. ``hidden`` must equal the target's
    (the fuse consumes the target's feature). The draws follow
    ``init_decoder``'s positional order with ``fc`` drawn last, so a head
    built with the target's seed, vocab, hidden and ffn starts with the
    target's embeddings and leading layer verbatim."""
    heads = _heads_for(hidden)
    if hidden % heads:
        raise ValueError(f"hidden={hidden} not divisible by its derived head count {heads}")
    rng = np.random.default_rng(seed)
    return {
        "tok_emb": (rng.standard_normal((vocab, hidden)) * 0.02).astype(np.float32),
        "pos_emb": (rng.standard_normal((max_len, hidden)) * 0.02).astype(np.float32),
        "layers": [
            {
                "ln1": _ln_init(hidden),
                "qkv": _dense(rng, hidden, 3 * hidden),
                "attn_out": _dense(rng, hidden, hidden),
                "ln2": _ln_init(hidden),
                "mlp_in": _dense(rng, hidden, ffn),
                "mlp_out": _dense(rng, ffn, hidden),
            }
        ],
        "ln_f": _ln_init(hidden),
        "fc": _dense(rng, 2 * hidden, hidden),
    }


def _feature_fuse(params: dict, feats, tokens, pidx) -> torch.Tensor:
    """The head's input embedding ``fc([feature ; tok_emb(token)])`` plus the
    position embedding: feats [n, m, d] aligned with tokens [n, m], pidx
    position indices broadcastable to [n, m] (already clipped)."""
    emb = params["tok_emb"][tokens]
    return _proj(params["fc"], torch.cat([feats.to(emb.dtype), emb], dim=-1)) + params["pos_emb"][pidx]


def feature_sequence_logits(params: dict, ids, feats) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced head forward: ids [b, s] with the target's aligned
    features feats [b, s, d] (``sequence_hidden``'s second output) ->
    (logits [b, s, vocab], head hidden [b, s, d]). Input j fuses feature j-1
    with token j (feature -1 = zeros), so logits[j] predicts token j+1: the
    serving root step's conditioning."""
    ids = _long(ids).to(params["tok_emb"].device)
    heads = _heads(params)
    s = ids.shape[1]
    fin = torch.cat([torch.zeros_like(feats[:, :1]), feats[:, :-1]], dim=1)
    x = _feature_fuse(params, fin, ids, torch.arange(s, device=ids.device)[None, :])
    for lp in params["layers"]:
        x, _, _ = _layer_prefill(lp, x, heads)
    return _logits(params, x), x


def feature_chunk_prefill(params: dict, cache_k, cache_v, tokens, target_hidden, prev_feat, positions, counts,
                          starts):
    """The head's teacher-forced prefill of one chunk round, beside the
    target's: tokens [n, c] (the chunk's prompt ids), the target's hidden
    for the same chunk [n, c, d], and ``prev_feat`` [n, d], the carried
    feature at positions[i] - 1 (zeros where positions == starts, a slot's
    first computed position, as the recipe pads position 0). Writes the
    head's K/V in place under the target chunk's ``counts`` mask (a
    counts-0 slot changes nothing) with the ``starts`` window. Returns
    (cache_k, cache_v)."""
    heads = _heads(params)
    max_len = params["pos_emb"].shape[0]
    tokens, positions = tokens.long(), positions.long()
    counts, starts = counts.long(), starts.long()
    m = tokens.shape[1]
    first = (positions == starts)[:, None]
    fin0 = torch.where(first, torch.zeros_like(prev_feat), prev_feat)
    fin = torch.cat([fin0[:, None, :], target_hidden[:, :-1, :].to(fin0.dtype)], dim=1)
    pidx = (positions[:, None] + torch.arange(m, device=tokens.device)[None, :]).clamp(0, max_len - 1)
    x = _feature_fuse(params, fin, tokens, pidx)
    for li, lp in enumerate(params["layers"]):
        x, _, _ = _layer_step_slots(lp, x, cache_k[li], cache_v[li], positions, heads, counts=counts, starts=starts)
    return cache_k, cache_v


def draft_propose_features(params: dict, cache_k, cache_v, feats, tokens, positions, starts, temperature, top_k,
                           generator, tree):
    """``draft_propose_tree`` with the feature head: the root step fuses each
    slot's carried target feature (``feats`` [n, d], the hidden at position
    ``pos - 1``) with the last emitted token and writes its K/V at ``pos``;
    each expansion depth fuses the parent node's own head hidden with the
    candidate token. The same candidate rule, draw order, block layout and
    return shape as the token tree draft, so the verify, the acceptance
    and the commits are shared."""
    heads = _heads(params)
    max_len = params["pos_emb"].shape[0]
    tokens, positions, starts = tokens.long(), positions.long(), starts.long()
    mask = _tree_tables(tree, positions.device)[0]
    x = _feature_fuse(params, feats[:, None, :], tokens[:, None], positions.clamp(0, max_len - 1)[:, None])
    for li, lp in enumerate(params["layers"]):
        x, _, _ = _layer_step_slots(lp, x, cache_k[li], cache_v[li], positions, heads, starts=starts)
    logits0 = _logits(params, x)[:, 0, :]
    n_layers = len(params["layers"])
    ek: list = [None] * n_layers
    ev: list = [None] * n_layers
    block_logits, node_tokens = [logits0[:, None, :]], []
    parent_logits, parent_feats = logits0[:, None, :], x
    for d in range(1, tree.depth + 1):
        b = tree.branching[d - 1]
        c_d, start = tree.level_counts[d - 1], tree.level_starts[d - 1]
        toks_d = _tree_candidates(parent_logits, temperature, top_k, generator, b)
        node_tokens.append(toks_d)
        pidx = (positions + d).clamp(0, max_len - 1)[:, None]
        x = _feature_fuse(params, parent_feats.repeat_interleave(b, dim=1), toks_d.long(), pidx)
        sub_mask = mask[start : start + c_d, 1 : start + c_d]
        for li, lp in enumerate(params["layers"]):
            x, ek[li], ev[li] = _layer_tree_flat(
                lp, x, cache_k[li], cache_v[li], positions, heads, ek[li], ev[li], sub_mask, starts=starts
            )
        parent_logits, parent_feats = _logits(params, x), x
        block_logits.append(parent_logits)
    return (
        torch.cat(node_tokens, dim=1),
        torch.cat(block_logits, dim=1),
        torch.stack(ek),
        torch.stack(ev),
        cache_k,
        cache_v,
    )


def reference_generate(params: dict, ids, max_new_tokens: int) -> np.ndarray:
    """Cache-less reference: a full forward per step (the slow obvious
    implementation the cached one must match token for token)."""
    ids = np.asarray(ids, dtype=np.int32)
    heads = _heads(params)
    dev = params["tok_emb"].device
    for _ in range(max_new_tokens):
        x = _embed(params, torch.from_numpy(ids).long().to(dev))
        for lp in params["layers"]:
            x, _, _ = _layer_prefill(lp, x, heads)
        nxt = torch.argmax(_logits(params, x[:, -1:, :]), dim=-1).cpu().numpy()
        ids = np.concatenate([ids, nxt.astype(np.int32)], axis=1)
    return ids
