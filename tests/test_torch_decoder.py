"""The port's decoder (seldon_core_tpu_torch/models/decoder.py) against the
JAX package's on the same parameters and inputs, float32 on the CPU.

init_decoder must draw bit-identical parameters. Every other comparison is
float32 computed two ways (XLA on the CPU, PyTorch on the CPU): logits and
K/V agree within rtol 1e-4 / atol 1e-5 (the reduction-order bound the JAX
package's own paged-vs-flat test uses, tests/test_kv_pool.py); greedy ids
are identical, checked teacher-forced so that a near-tie cannot compound.
The int8 quantizer is exact on identical inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.models import decoder as jd
from seldon_core_tpu_torch.models import decoder as td
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.ops.attention import FLASH_MIN_SEQ

TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")
TINY = dict(vocab=128, hidden=64, layers=2, ffn=128, max_len=96)
SEQ, MAX_NEW = 8, 10


def _pair(seed=3, **kw):
    """(JAX params, port params) of one numpy draw."""
    p = jd.init_decoder(seed=seed, **{**TINY, **kw})
    return p, params_to_torch(p, CPU)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _ids(n, seq=SEQ, seed=1, vocab=TINY["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, (n, seq)).astype(np.int32)


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=5, vocab=96, hidden=128, layers=3, ffn=64, max_len=40,
                                                   resid_scale=0.1)])
def test_init_decoder_is_bit_identical(kw):
    ours, theirs = td.init_decoder(**kw), jd.init_decoder(**kw)
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for x, y in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_prefill_logits_and_kv_match_jax():
    jp, tp = _pair()
    ids = _ids(3)
    jl, jk, jv = jax.jit(jd.prefill)(jp, jnp.asarray(ids))
    with torch.inference_mode():
        tl, tk, tv = td.prefill(tp, torch.from_numpy(ids))
    for a, b in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


def _teacher_forced_argmax(tp, seqs: np.ndarray, start: int) -> np.ndarray:
    """The port's greedy choice at every generated position of ``seqs``,
    from one causal forward over the given tokens."""
    with torch.inference_mode():
        x = td._embed(tp, torch.from_numpy(np.array(seqs)).long())
        for lp in tp["layers"]:
            x, _, _ = td._layer_prefill(lp, x, td._heads(tp))
        logits = td._logits(tp, x)
    return _np(torch.argmax(logits[:, start - 1 : -1], dim=-1))


@pytest.mark.parametrize("seq,max_new", [(SEQ, MAX_NEW), (1, 5)])
def test_generate_ids_teacher_forced_and_reference(seq, max_new):
    jp, tp = _pair()
    ids = _ids(4, seq=seq, seed=2)
    want = np.asarray(jax.jit(jd.generate, static_argnums=2)(jp, jnp.asarray(ids), max_new))
    # teacher-forced: the port's argmax at each step of the JAX sequence
    np.testing.assert_array_equal(_teacher_forced_argmax(tp, want, seq), want[:, seq:])
    with torch.inference_mode():
        got = _np(td.generate(tp, torch.from_numpy(ids), max_new))
        ref = td.reference_generate(tp, ids, max_new)
    assert got.dtype == np.int32 and got.shape == (4, seq + max_new)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ref, got)


def test_generate_refuses_past_the_position_table():
    _, tp = _pair()
    with pytest.raises(ValueError, match="position table"):
        td.generate(tp, torch.zeros(1, 90, dtype=torch.int32), 10)


def test_decode_step_slots_match_jax():
    """prefill -> write into slot 2 of 4 -> per-slot decode steps, the free
    slots stepping at position 0: logits and both caches agree."""
    jp, tp = _pair()
    ids = _ids(1, seed=6)
    n, slot, ctx = 4, 2, SEQ + MAX_NEW
    jck, jcv = jd.init_slot_cache(jp, n, ctx)
    _, jk, jv = jax.jit(jd.prefill)(jp, jnp.asarray(ids))
    jck, jcv = jd.write_prefill(jck, jcv, jk, jv, slot)
    step = jax.jit(jd.decode_step)
    with torch.inference_mode():
        tck, tcv = td.init_slot_cache(tp, n, ctx)
        _, tk, tv = td.prefill(tp, torch.from_numpy(ids))
        td.write_prefill(tck, tcv, tk, tv, slot)
        toks = np.zeros(n, np.int32)
        pos = np.zeros(n, np.int32)
        for i, t in enumerate([5, 17, 99]):
            toks[slot], pos[slot] = t, SEQ + i
            jl, jck, jcv = step(jp, jck, jcv, jnp.asarray(toks), jnp.asarray(pos))
            tl, _, _ = td.decode_step(tp, tck, tcv, torch.from_numpy(toks), torch.from_numpy(pos))
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(_np(tck), np.asarray(jck), **TOL)
    np.testing.assert_allclose(_np(tcv), np.asarray(jcv), **TOL)


def test_chunk_prefill_ragged_counts_match_jax():
    """Three chunk rounds with ragged counts (0 included) and one slot whose
    block start clamps at the end of the cache, as dynamic_update_slice
    clamps it."""
    jp, tp = _pair()
    n, c, ctx = 3, 4, SEQ + MAX_NEW
    rng = np.random.default_rng(7)
    jck, jcv = jd.init_slot_cache(jp, n, ctx)
    chunk = jax.jit(jd.chunk_prefill)
    with torch.inference_mode():
        tck, tcv = td.init_slot_cache(tp, n, ctx)
        for pos, counts in (([0, 0, 16], [4, 0, 2]), ([4, 0, 2], [3, 4, 1]), ([7, 4, 3], [0, 2, 4])):
            toks = rng.integers(0, TINY["vocab"], (n, c)).astype(np.int32)
            pos, counts = np.asarray(pos, np.int32), np.asarray(counts, np.int32)
            jl, jck, jcv = chunk(jp, jck, jcv, *(jnp.asarray(a) for a in (toks, pos, counts)))
            tl, _, _ = td.chunk_prefill(tp, tck, tcv, *(torch.from_numpy(a) for a in (toks, pos, counts)))
            for i in range(n):
                if counts[i]:
                    np.testing.assert_allclose(_np(tl[i, : counts[i]]), np.asarray(jl[i, : counts[i]]), **TOL)
    np.testing.assert_allclose(_np(tck), np.asarray(jck), **TOL)
    np.testing.assert_allclose(_np(tcv), np.asarray(jcv), **TOL)


def test_quant_rows_is_exact():
    x = np.random.default_rng(4).standard_normal((40, 2, 64)).astype(np.float32) * 3
    x[3] = 0.0  # a constant row: the 1e-8 scale floor
    x[5, 0, :4] = [0.5, -0.5, 1.5, 2.5]  # halves
    jq, js, jz = jd._quant_rows(jnp.asarray(x))
    tq, ts, tz = td._quant_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(_np(tz), np.asarray(jz))


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_paged_steps_match_jax(kv_dtype):
    """paged_chunk_prefill then paged_decode_step on a pool shared by three
    slots (slot 0 free, block table all zero): logits agree, the pool
    agrees (int8 payloads within one step, where float32 noise lands on a
    rounding boundary), and the free slot's writes touched only page 0."""
    jp, tp = _pair()
    ps, n = 4, 3
    pps = -(-(SEQ + MAX_NEW) // ps)
    bt = np.zeros((n, pps), np.int32)
    bt[1] = np.arange(1, 1 + pps)
    bt[2] = np.arange(1 + pps, 1 + 2 * pps)
    ids = _ids(n, seed=8)
    counts = np.array([0, SEQ, 5], np.int32)
    zero = np.zeros(n, np.int32)
    jpool = jd.paged_kv_init(jp, 1 + 2 * pps, ps, kv_dtype=kv_dtype)
    with torch.inference_mode():
        tpool = td.paged_kv_init(tp, 1 + 2 * pps, ps, kv_dtype=kv_dtype)
        jl, _, jpool = jax.jit(jd.paged_chunk_prefill)(jp, jpool, *(jnp.asarray(a) for a in (bt, ids, zero, counts)))
        tl, _, _ = td.paged_chunk_prefill(tp, tpool, *(torch.from_numpy(a) for a in (bt, ids, zero, counts)))
        for i in (1, 2):
            np.testing.assert_allclose(_np(tl[i, : counts[i]]), np.asarray(jl[i, : counts[i]]), **TOL)
        toks = np.array([0, 11, 40], np.int32)
        pos = counts.copy()
        step = jax.jit(jd.paged_decode_step)
        for _ in range(3):
            jl, _, jpool = step(jp, jpool, jnp.asarray(bt), jnp.asarray(toks), jnp.asarray(pos))
            tl, _, _ = td.paged_decode_step(tp, tpool, torch.from_numpy(bt), torch.from_numpy(toks),
                                            torch.from_numpy(pos))
            np.testing.assert_allclose(_np(tl[1:]), np.asarray(jl[1:]), **TOL)
            toks = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
            pos = pos + 1
    for a, b in zip(tpool, jpool):
        a, b = _np(a)[:, 1:], np.asarray(b)[:, 1:]  # page 0 holds junk in both
        if a.dtype == np.int8:
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
            assert (a != b).mean() < 0.01
        else:
            np.testing.assert_allclose(a, b, **TOL)


def test_sample_tokens_greedy_and_top_k1():
    logits = np.random.default_rng(9).standard_normal((6, 50)).astype(np.float32)
    temps = np.array([0.0, 0.0, 0.7, 2.0, 5.0, -1.0], np.float32)
    topk = np.array([0, 3, 1, 1, 1, 0], np.int32)
    greedy = np.argmax(logits, axis=-1)
    jout = np.asarray(jd.sample_tokens(jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(topk), jax.random.key(0)))
    tl = torch.from_numpy(logits)
    tout = _np(td.sample_tokens(tl, torch.from_numpy(temps), torch.from_numpy(topk),
                                td.sampling_generator(0, 1, "cpu")))
    # greedy rows and top_k=1 rows are argmax in both packages
    np.testing.assert_array_equal(tout, greedy)
    np.testing.assert_array_equal(jout, greedy)
    # the draws are deterministic in (seed, tick), and move with the tick
    hot = torch.from_numpy(np.full(64, 3.0, np.float32))
    wide = torch.zeros(64, 50)
    a = td.sample_tokens(wide, hot, torch.zeros(64, dtype=torch.int32), td.sampling_generator(7, 2, "cpu"))
    b = td.sample_tokens(wide, hot, torch.zeros(64, dtype=torch.int32), td.sampling_generator(7, 2, "cpu"))
    c = td.sample_tokens(wide, hot, torch.zeros(64, dtype=torch.int32), td.sampling_generator(7, 3, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # transform: top-k keeps exactly k finite logits, scaled by 1 / T
    t = _np(td._transform_logits(tl, torch.from_numpy(temps), torch.from_numpy(topk)))
    j = np.asarray(jd._transform_logits(jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(topk)))
    np.testing.assert_allclose(t, j, rtol=1e-6)


def test_layer_prefill_at_flash_min_seq_matches_jax():
    """_layer_prefill from FLASH_MIN_SEQ tokens, where both packages take
    blockwise causal attention (the card takes the flash kernel from 4096)."""
    jp, tp = _pair(max_len=FLASH_MIN_SEQ + 8)
    x = (np.random.default_rng(10).standard_normal((1, FLASH_MIN_SEQ, 64)) * 0.5).astype(np.float32)
    jx, jk, jv = jax.jit(jd._layer_prefill, static_argnums=2)(jp["layers"][0], jnp.asarray(x), 1)
    with torch.inference_mode():
        tx, tk, tv = td._layer_prefill(tp["layers"][0], torch.from_numpy(x), 1)
    for a, b in ((tx, jx), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


def test_generate_long_prompt_matches_jax():
    """The slice as a whole at tiny widths: a 1024-token prompt (blockwise
    causal prefill in both packages) and 6 greedy tokens, teacher-forced."""
    max_new = 6
    jp, tp = _pair(max_len=FLASH_MIN_SEQ + max_new)
    ids = _ids(1, seq=FLASH_MIN_SEQ, seed=12)
    want = np.asarray(jax.jit(jd.generate, static_argnums=2)(jp, jnp.asarray(ids), max_new))
    np.testing.assert_array_equal(_teacher_forced_argmax(tp, want, FLASH_MIN_SEQ), want[:, FLASH_MIN_SEQ:])
    with torch.inference_mode():
        got = _np(td.generate(tp, torch.from_numpy(ids), max_new))
    np.testing.assert_array_equal(got, want)
