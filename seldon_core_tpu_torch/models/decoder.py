"""GPT-style causal decoder with KV-cache generation: the generative tier.

Port of ``seldon_core_tpu/models/decoder.py``: the dense model, the fused
``generate`` oracle, the slot-cache blocks and the paged-KV blocks the
continuous-batching scheduler (``serving/decode_scheduler.py``) runs. The
function names are the JAX package's. Parameters are the same tree with
torch tensors as leaves (``models/convert.py``); ``init_decoder`` makes the
JAX package's numpy draws, so a seed gives its parameters bit for bit.

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
  ``(seed, tick)``, not from ``jax.random``: sampled tokens differ from the
  JAX package's, greedy and ``top_k=1`` tokens do not.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def _layer_prefill(p, x, h):
    """Returns (x_out, k[b, h, s, hd], v[b, h, s, hd]) for the cache."""
    q, k, v = _qkv(p, x, h)
    ctx = _merge_heads(_causal_attention(q, k, v))
    x = x + _proj(p["attn_out"], ctx)
    return _mlp(p, x), k, v


def _masked_attention(p, x, q, cache_k, cache_v, valid):
    """Attention of q [n, h, m, hd] over the whole static cache [n, h, T, hd]
    in float32; ``valid`` [n or 1, m, T] marks the keys each query sees
    (the others get -1e30, so their mass is exactly zero). Returns x plus
    the attention projection."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("nhqd,nhkd->nhqk", q.float(), cache_k.float()) * scale
    s = torch.where(valid[:, None], s, NEG_INF)
    ctx = torch.einsum("nhqk,nhkd->nhqd", torch.softmax(s, dim=-1), cache_v.float())
    return x + _proj(p["attn_out"], _merge_heads(ctx.to(x.dtype)))


def _layer_step(p, x, cache_k, cache_v, pos: int, h):
    """One token through one layer against the cache. x: [b, 1, d]; cache
    [b, h, max_ctx, hd], written in place at ``pos``; tokens <= pos are
    attended to. Returns (x_out, cache_k, cache_v)."""
    q, k, v = _qkv(p, x, h)
    cache_k[:, :, pos : pos + 1] = k
    cache_v[:, :, pos : pos + 1] = v
    valid = (torch.arange(cache_k.shape[2], device=x.device) <= pos)[None, None, :]
    x = _masked_attention(p, x, q, cache_k, cache_v, valid)
    return _mlp(p, x), cache_k, cache_v


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


def init_slot_cache(params: dict, n_slots: int, max_ctx: int, dtype=torch.float32):
    """Zeroed slot KV cache pair, each [L, n_slots, heads, max_ctx, hd]."""
    d = decoder_dims(params)
    shape = (d["layers"], n_slots, d["heads"], max_ctx, d["head_dim"])
    dev = params["tok_emb"].device
    return torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev)


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


def _layer_step_slots(p, x, cache_k, cache_v, positions, h, counts=None):
    """_layer_step at PER-SLOT positions and m queries per slot. x: [n, m,
    d]; cache [n, h, max_ctx, hd]; positions [n]: slot i's query j sits at
    positions[i] + j, writes its K/V there and attends to cache entries <=
    positions[i] + j. ``counts`` [n] (chunked prefill): slot i keeps only its
    first counts[i] K/V entries and leaves the rest of its cache as it was."""
    q, k, v = _qkv(p, x, h)  # [n, h, m, hd]
    n, m = x.shape[0], x.shape[1]
    rows = torch.arange(n, device=x.device)[:, None]
    cols = _block_index(positions, m, cache_k.shape[2])
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # [n, m, h, hd]
    if counts is not None:
        keep = (torch.arange(m, device=x.device)[None, :] < counts[:, None])[:, :, None, None]
        kt = torch.where(keep, kt, cache_k[rows, :, cols, :])
        vt = torch.where(keep, vt, cache_v[rows, :, cols, :])
    cache_k[rows, :, cols, :] = kt.to(cache_k.dtype)
    cache_v[rows, :, cols, :] = vt.to(cache_v.dtype)
    q_pos = positions[:, None] + torch.arange(m, device=x.device)[None, :]
    valid = torch.arange(cache_k.shape[2], device=x.device)[None, None, :] <= q_pos[:, :, None]
    x = _masked_attention(p, x, q, cache_k, cache_v, valid)
    return _mlp(p, x), cache_k, cache_v


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


def sampling_generator(seed: int, tick: int, device) -> torch.Generator:
    """The draw stream of one sampling call, deterministic in (seed, tick)."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(tick) & 0xFFFFFFFF))
    return g


def sample_tokens(logits, temperature, top_k, generator: torch.Generator | None) -> torch.Tensor:
    """Per row: greedy argmax where temperature <= 0, else a draw from the
    temperature-scaled distribution restricted to the top_k logits (the
    Gumbel-max trick, as jax.random.categorical). ``generator`` may be None
    only when no row samples."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temperature = torch.as_tensor(temperature, device=logits.device)
    if generator is None:
        return greedy
    scaled = _transform_logits(logits.float(), temperature, top_k)
    u = torch.rand(scaled.shape, generator=generator, device=logits.device).clamp_(1e-20, 1.0)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1).to(torch.int32)
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
    """Zeroed page pool state tuple on the parameters' device."""
    d = decoder_dims(params)
    dev = params["tok_emb"].device
    shape = (d["layers"], n_pages, d["heads"], page_size, d["head_dim"])
    if kv_dtype == "int8":
        sshape = (d["layers"], n_pages, page_size)
        # scale 1 / zero point 0: junk pages read back as exact zeros
        return (
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.ones(sshape, dtype=torch.float32, device=dev),
            torch.zeros(sshape, dtype=torch.float32, device=dev),
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.ones(sshape, dtype=torch.float32, device=dev),
            torch.zeros(sshape, dtype=torch.float32, device=dev),
        )
    if kv_dtype:
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (want '' or 'int8')")
    return (torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev))


def paged_copy(pool: tuple, src, dst) -> tuple:
    """Copy pool pages src[i] -> dst[i] in every state component, in place
    (the copy-on-write primitive; padding entries copy page 0 onto itself)."""
    for a in pool:
        a[:, dst] = a[:, src]
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
    mask hides."""
    n, h, m, hd = k.shape
    ps = kv[0].shape[2]
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
        pk, pv = kv
        pk[pf, :, of, :] = kt.to(pk.dtype)
        pv[pf, :, of, :] = vt.to(pv.dtype)
        return kv
    kq, sk, zk, vq, sv, zv = kv
    for (qa, sa, za), rows in (((kq, sk, zk), kt), ((vq, sv, zv), vt)):
        q, scale, zp = _quant_rows(rows.float())
        qa[pf, :, of, :] = q
        sa[pf, of] = scale
        za[pf, of] = zp
    return kv


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
    cache_k, cache_v = _paged_gather(kv, bt)
    m = x.shape[1]
    q_pos = positions[:, None] + torch.arange(m, device=x.device)[None, :]
    valid = torch.arange(cache_k.shape[2], device=x.device)[None, None, :] <= q_pos[:, :, None]
    x = _masked_attention(p, x, q, cache_k, cache_v, valid)
    return _mlp(p, x), kv


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
