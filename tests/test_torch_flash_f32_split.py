"""The numerics of the float32 flash kernel's design, on the CPU.

``csrc/flash_attention.cu::flash_fwd_f32`` forms both products (q·Kᵀ and
P·V) on the tensor cores in tf32: each operand x is split into
big = tf32_rna(x) and small = tf32_rna(x - big), and a product is
big·big' + big·small' + small·big' ("3xTF32"). The card cannot run here,
so this emulates those products in numpy, within the plain algorithm of
``flash_attention_reference`` (q scaled in f32, f32 softmax statistics,
rows with l == 0 divided by 1), and holds the emulation against the JAX
Pallas kernel in interpret mode, as ``tests/test_torch_flash.py`` runs it,
on the same numpy inputs:

- three passes agree with the JAX kernel within that file's float32
  tolerance (2e-5), and within ``chip_smoke.KERNEL_TOL["float32"]``'s
  relative L2 (1e-5), which the card holds the kernel to;
- one tf32 pass (big·big' alone) exceeds that relative L2: the check on
  the card can tell the two routes apart.

TF32 rounding to nearest (ties away from zero, as ``cvt.rna``): the low 13
bits of the float32 pattern cleared after adding 0x1000.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

from chip_smoke import KERNEL_TOL

F32 = dict(rtol=2e-5, atol=2e-5)
SHAPE = (2, 3, 256, 256)  # b, h, sq, sk
NEG_INF = np.float32(-1e30)


def tf32_rna(x: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_product(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a @ b with tf32 operands: 3 passes (big·big + big·small + small·big,
    the two small terms first) or 1 (big·big), each summed in f32."""
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    if passes == 1:
        return np.matmul(a_big, b_big)
    a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
    return (np.matmul(a_small, b_big) + np.matmul(a_big, b_small)) + np.matmul(a_big, b_big)


def emulated_kernel(q, k, v, causal: bool, passes: int) -> np.ndarray:
    """``flash_attention_reference``'s algorithm with the kernel's products."""
    qs = (q * np.float32(1.0 / np.sqrt(q.shape[-1]))).astype(np.float32)
    s = tf32_product(qs, np.swapaxes(k, -1, -2), passes)
    if causal:
        keep = np.tril(np.ones(s.shape[-2:], dtype=bool))
        s = np.where(keep, s, NEG_INF)
    p = np.exp(s - s.max(axis=-1, keepdims=True)).astype(np.float32)
    l = p.sum(axis=-1, keepdims=True, dtype=np.float32)
    o = tf32_product(p, v, passes)
    return (o / np.where(l == 0, np.float32(1), l)).astype(np.float32)


def _inputs(d: int):
    rng = np.random.default_rng(d)
    b, h, sq, sk = SHAPE
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32) for s in (sq, sk, sk))


@functools.lru_cache(maxsize=None)
def _jax_kernel(d: int, causal: bool) -> np.ndarray:
    import jax.numpy as jnp

    from seldon_core_tpu.ops import flash_attention

    q, k, v = _inputs(d)
    out = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128, causal=causal)
    return np.asarray(out, dtype=np.float32)


def _rel_l2(got, ref) -> float:
    g, r = got.astype(np.float64), ref.astype(np.float64)
    return float(np.linalg.norm(g - r) / np.linalg.norm(r))


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_split_products_against_the_jax_kernel(d, causal, passes):
    got = emulated_kernel(*_inputs(d), causal=causal, passes=passes)
    ref = _jax_kernel(d, causal)
    rel_limit = KERNEL_TOL["float32"][1]
    if passes == 3:
        np.testing.assert_allclose(got, ref, **F32)
        assert _rel_l2(got, ref) <= rel_limit
    else:
        assert _rel_l2(got, ref) > rel_limit
