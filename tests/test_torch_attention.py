"""The port's naive / blockwise / causal-auto attention against the JAX
package's on the same numpy inputs (float32; tolerance 2e-5 as
tests/test_ops.py uses — both sides sum in f32, in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seldon_core_tpu.ops import attention as jax_attn
from seldon_core_tpu_torch.ops import attention as attn

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(s=64, b=2, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))


def _run(fn_t, fn_j, qkv, **kw):
    got = fn_t(*(torch.from_numpy(a) for a in qkv), **kw).numpy()
    ref = np.asarray(fn_j(*(jnp.asarray(a) for a in qkv), **kw))
    return got, ref


@pytest.mark.parametrize("causal", [False, True])
def test_naive_matches_jax(causal):
    got, ref = _run(attn.naive_attention, jax_attn.naive_attention, _qkv(s=48), causal=causal)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize(
    "s,causal",
    [(64, False), (48, True), (40, False)],  # s=40: ragged last block is padded and masked
)
def test_blockwise_matches_jax(s, causal):
    got, ref = _run(
        attn.blockwise_attention, jax_attn.blockwise_attention, _qkv(s=s),
        block_size=16, causal=causal,
    )
    np.testing.assert_allclose(got, ref, **TOL)
    naive = attn.naive_attention(*(torch.from_numpy(a) for a in _qkv(s=s)), causal=causal)
    np.testing.assert_allclose(got, naive.numpy(), **TOL)


def test_combine_stats_matches_jax():
    rng = np.random.default_rng(2)
    parts = [rng.standard_normal(shape).astype(np.float32) for shape in [(2, 3), (2, 3), (2, 3, 4)] * 2]
    parts[1] = np.abs(parts[1])
    parts[4] = np.abs(parts[4])
    got = attn.combine_stats(*(torch.from_numpy(p) for p in parts))
    ref = jax_attn.combine_stats(*(jnp.asarray(p) for p in parts))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("s", [32, attn.FLASH_MIN_SEQ])  # dense arm, blockwise arm
def test_causal_attention_auto_matches_jax(s):
    assert attn.FLASH_MIN_SEQ == jax_attn.FLASH_MIN_SEQ
    assert attn.PALLAS_MIN_SEQ == jax_attn.PALLAS_MIN_SEQ
    got, ref = _run(
        attn.causal_attention_auto, jax_attn.causal_attention_auto, _qkv(s=s, b=1, h=1)
    )
    np.testing.assert_allclose(got, ref, **TOL)
