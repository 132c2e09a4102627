"""The numerics of the float32 W8A16 body's design, on the CPU.

``csrc/int8_matmul.cu::tf32x2_body`` forms x @ q on the tensor cores in
tf32. An int8 q (|q| <= 127, 7 significant bits) is exact in tf32, so only
x is split: hi = x with its low 13 bits cleared (what the tensor core reads
of a float32 register) and lo = (x - hi) with its low 13 bits cleared, and
a product is lo·q + hi·q ("2xTF32"). The card cannot run here, so this
emulates the body in numpy, step by step:

- each mma.sync k8 step adds its 8 exact products to the accumulator it is
  given and truncates the sum to float32 (round toward zero), lo first,
  then hi;
- each 32-deep K stage starts from a fresh accumulator, which an f32 add
  (round to nearest) folds into the running sum;
- the per-channel scale and the bias come last, y = acc * scale + bias in
  one rounding.

It holds that emulation against the JAX package's float32 ``dequantize``
and matmul (``seldon_core_tpu/models/quant.py``) on the same numpy inputs,
at BERT-base's qkv K = 768 (and a K that ends mid-stage) with a few rows:
within rtol 1e-5 / atol 1e-4 (``tests/test_torch_int8_gpu.py``'s float32
bound) and ``chip_smoke.KERNEL_TOL["float32"]`` (64 ulps of max|ref|,
relative L2 1e-5), which the card holds the kernel to; one pass (hi·q
alone) exceeds that relative L2, so the check on the card tells the two
routes apart.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from chip_smoke import agreement
from seldon_core_tpu_torch.models.quant import payload, quantize_params

M, N = 8, 2304  # a few rows of BERT-base's qkv projection (N = 3 x 768)
STAGE, STEP = 32, 8  # K per stage and per mma.sync k8 step
F32 = dict(rtol=1e-5, atol=1e-4)


def tf32_trunc(x: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = tf32_trunc(x)
    return hi, tf32_trunc((x - hi).astype(np.float32))


def round_toward_zero(v: np.ndarray) -> np.ndarray:
    """float64 -> float32, truncated as the tensor cores add."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def emulated_body(x, q, scale, bias, passes: int) -> np.ndarray:
    """tf32x2_body's arithmetic: x [M, K] float32, q [K, N] int8."""
    k = x.shape[1]
    hi, lo = split(x)
    operands = (lo, hi) if passes == 2 else (hi,)
    qf = q.astype(np.float64)
    acc = np.zeros((x.shape[0], q.shape[1]), np.float32)
    for s0 in range(0, k, STAGE):
        part = np.zeros_like(acc)  # a fresh accumulator each stage
        for k0 in range(s0, min(s0 + STAGE, k), STEP):
            for a in operands:
                products = a[:, k0:k0 + STEP].astype(np.float64) @ qf[k0:k0 + STEP]  # exact
                part = round_toward_zero(part.astype(np.float64) + products)
        acc = (acc + part).astype(np.float32)
    return (acc.astype(np.float64) * scale.astype(np.float64) + bias).astype(np.float32)


def _inputs(k: int):
    rng = np.random.default_rng(k)
    w = (rng.standard_normal((k, N)) * np.exp(rng.uniform(-1.0, 1.0, N)) / np.sqrt(k)).astype(np.float32)
    leaf = quantize_params({"w": w})["w"]
    x = rng.standard_normal((M, k)).astype(np.float32)
    bias = (rng.standard_normal(N) * 0.1).astype(np.float32)
    return x, payload(leaf), leaf["scale"].reshape(-1), bias


@functools.lru_cache(maxsize=None)
def _jax_reference(k: int) -> np.ndarray:
    import jax.numpy as jnp

    from seldon_core_tpu.models import quant as jax_quant

    x, q, scale, bias = _inputs(k)
    w = jax_quant.dequantize({"w": {jax_quant._QKEY: q, "scale": scale.reshape(1, -1)}}, jnp.float32)["w"]
    y = jnp.matmul(jnp.asarray(x), w, precision="highest") + jnp.asarray(bias)
    return np.asarray(y, dtype=np.float32)


def _rel_l2(got, ref) -> float:
    g, r = got.astype(np.float64), ref.astype(np.float64)
    return float(np.linalg.norm(g - r) / np.linalg.norm(r))


def test_q_is_exact_in_tf32_and_the_split_keeps_x_to_2_to_the_minus_20():
    q = np.arange(-127, 128, dtype=np.int8).astype(np.float32)
    np.testing.assert_array_equal(tf32_trunc(q), q)
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    hi, lo = split(x)
    assert (tf32_trunc(hi) == hi).all() and (tf32_trunc(lo) == lo).all()
    assert np.max(np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)) <= 2.0 ** -20
    assert np.max(np.abs(hi.astype(np.float64) - x) / np.abs(x)) > 2.0 ** -12  # hi alone keeps 11 bits


@pytest.mark.parametrize("passes", [2, 1])
@pytest.mark.parametrize("k", [768, 776])
def test_split_products_against_the_jax_dequantize_and_matmul(k, passes):
    got = emulated_body(*_inputs(k), passes=passes)
    ref = _jax_reference(k)
    verdict = agreement(torch.from_numpy(got), torch.from_numpy(ref.copy()), "float32")
    if passes == 2:
        np.testing.assert_allclose(got, ref, **F32)
        assert verdict["ok"], verdict
    else:
        assert _rel_l2(got, ref) > verdict["rel_l2_limit"]
        assert not verdict["ok"]
