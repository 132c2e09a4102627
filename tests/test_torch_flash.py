"""The port's flash_attention against the JAX Pallas kernel.

On the CPU the port's wrapper computes its plain version
(flash_attention_reference); the JAX kernel runs in interpret mode, as
tests/test_ops.py runs it. Same numpy inputs into both. Tolerances:
float32 2e-5 (both sides sum in f32 in different orders); bfloat16 and
float16 4 ulps of max|ref| in the dtype and a relative L2 error of 1e-2 —
the two sides round p at different points (per 16-key block in JAX, once
per row here; per 128-key tile in the CUDA kernel), which at most flips the
rounding of an output element, while a 5% error in the softmax normaliser
exceeds both limits.

JAX is imported inside the tests that compare with it, so that the card's
host, which has no JAX, still collects the file for its ``-m gpu`` test.
"""

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.ops import flash_attention as ft
from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES, flash_attention

F32 = dict(rtol=2e-5, atol=2e-5)
MANTISSA_BITS = {torch.bfloat16: 7, torch.float16: 10}


def _assert_close_in_ulps(got, ref, dtype):
    got, ref = got.double().cpu(), ref.double().cpu()
    ulp = 2.0 ** (np.floor(np.log2(ref.abs().max().item())) - MANTISSA_BITS[dtype])
    assert (got - ref).abs().max().item() <= 4 * ulp
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-2


def _np_qkv(sq=64, sk=None, b=2, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    sk = sq if sk is None else sk
    return (
        rng.standard_normal((b, h, sq, d)).astype(np.float32),
        rng.standard_normal((b, h, sk, d)).astype(np.float32),
        rng.standard_normal((b, h, sk, d)).astype(np.float32),
    )


@pytest.fixture
def jax_ops():
    import jax.numpy as jnp

    from seldon_core_tpu.ops import flash_attention, naive_attention

    return jnp, flash_attention, naive_attention


def _both(jax_ops, qkv, dtype="f32", **kw):
    jnp, jax_flash, _ = jax_ops
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in qkv), **kw)
    ref = jax_flash(*(jnp.asarray(a, jdt) for a in qkv), **kw)
    return got.float().numpy(), np.asarray(ref.astype(jnp.float32))


def test_flash_attention_matches_naive(jax_ops):
    jnp, _, jax_naive = jax_ops
    qkv = _np_qkv()
    got, ref = _both(jax_ops, qkv, block_q=16, block_k=16)
    np.testing.assert_allclose(got, ref, **F32)
    np.testing.assert_allclose(
        got, np.asarray(jax_naive(*(jnp.asarray(a) for a in qkv))), **F32
    )


def test_flash_attention_q_padding(jax_ops):
    got, ref = _both(jax_ops, _np_qkv(sq=40, sk=64, b=1, seed=1), block_q=16, block_k=16)
    assert got.shape == (1, 2, 40, 16)
    np.testing.assert_allclose(got, ref, **F32)


def test_flash_attention_rejects_ragged_kv(jax_ops):
    jnp, jax_flash, _ = jax_ops
    q, k, v = _np_qkv(sq=40)
    with pytest.raises(ValueError, match="multiple of 128"):
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=16, block_k=16)
    with pytest.raises(ValueError, match="multiple of 128"):
        flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            block_q=16, block_k=16,
        )


@pytest.mark.parametrize("block_q,block_k", [(16, 16), (32, 16)])
def test_flash_attention_causal_matches_jax(jax_ops, block_q, block_k):
    got, ref = _both(jax_ops, _np_qkv(), block_q=block_q, block_k=block_k, causal=True)
    np.testing.assert_allclose(got, ref, **F32)


def test_flash_attention_causal_with_q_padding(jax_ops):
    got, ref = _both(jax_ops, _np_qkv(sq=40, sk=64, b=1, seed=3), block_q=16, block_k=16, causal=True)
    np.testing.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bf16_matches_jax(jax_ops, causal):
    got, ref = _both(jax_ops, _np_qkv(d=64, b=1, seed=5), dtype="bf16", block_q=16, block_k=16, causal=causal)
    _assert_close_in_ulps(torch.tensor(got), torch.tensor(ref), torch.bfloat16)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing(monkeypatch):
    LAUNCHES.reset()
    calls = []
    plain = ft.flash_attention_reference
    monkeypatch.setattr(ft, "flash_attention_reference", lambda *a, **k: calls.append(1) or plain(*a, **k))
    q, k, v = (torch.from_numpy(a) for a in _np_qkv())
    flash_attention(q, k, v)
    flash_attention(q, k, v, causal=True)
    assert len(calls) == 2
    assert LAUNCHES.count == 0


def test_flash_attention_rejects_mismatched_shapes():
    q, k, v = (torch.from_numpy(a) for a in _np_qkv())
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :1], v[:, :1])
    with pytest.raises(ValueError):
        flash_attention(q[0], k[0], v[0])


def _bert_views(b=2, s=64, h=2, d=16, seed=7, dtype=torch.float32, device="cpu"):
    """q, k, v as models/bert.py cuts them from one fused QKV projection
    [b, s, 3*h*d]: views with batch stride 3*h*d*s, head stride d and seq
    stride 3*h*d."""
    fused = torch.from_numpy(np.random.default_rng(seed).standard_normal((b, s, 3 * h * d)).astype(np.float32))
    fused = fused.to(device=device, dtype=dtype)
    return tuple(t.reshape(b, s, h, d).transpose(1, 2) for t in fused.split(h * d, dim=-1))


@pytest.mark.parametrize("causal", [False, True])
def test_strided_views_match_contiguous_copies(causal):
    views = _bert_views()
    assert not any(t.is_contiguous() for t in views)
    got = flash_attention(*views, block_q=16, block_k=16, causal=causal)
    ref = flash_attention(*(t.contiguous() for t in views), block_q=16, block_k=16, causal=causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_strided_views_match_jax(jax_ops, causal):
    jnp, jax_flash, _ = jax_ops
    views = _bert_views(seed=11)
    got = flash_attention(*views, block_q=16, block_k=16, causal=causal)
    ref = jax_flash(*(jnp.asarray(t.contiguous().numpy()) for t in views), block_q=16, block_k=16, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def _layout_cases():
    x = torch.zeros(2, 3, 64, 64, dtype=torch.bfloat16)
    buf = torch.zeros(2 * 3 * 64 * 196 + 8, dtype=torch.bfloat16)
    return {
        "bert_views": (_bert_views(h=3, d=64, dtype=torch.bfloat16)[1], None),
        "contiguous": (x, None),
        "head_transposed": (torch.zeros(2, 64, 3, 64, dtype=torch.bfloat16).transpose(1, 2), None),
        # the stride of a dimension of size 1 is never stepped
        "batch_of_one_any_stride": (buf.as_strided((1, 3, 64, 64), (5, 4096, 64, 1)), None),
        "last_dim_transposed": (x.transpose(2, 3), "last-dimension stride"),
        "stride_not_multiple_of_8": (buf.as_strided((2, 3, 64, 64), (3 * 64 * 196, 64, 196, 1)), "multiples of 8"),
        "unaligned_base": (buf[1:1 + x.numel()].view(2, 3, 64, 64), "16-byte aligned"),
    }


@pytest.mark.parametrize("case", list(_layout_cases()))
def test_kernel_layout_check(case):
    t, refusal = _layout_cases()[case]
    if refusal is None:
        ft.check_kernel_layout("q", t)
    else:
        with pytest.raises(ValueError, match=refusal):
            ft.check_kernel_layout("q", t)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,causal,sq,sk,d",
    [
        (torch.bfloat16, False, 512, 512, 64),
        (torch.bfloat16, True, 200, 256, 128),
        (torch.float16, True, 100, 96, 64),
        (torch.float32, False, 40, 64, 64),
        (torch.float32, True, 77, 130, 128),
        # fewer keys than one tile, one query row, more rows than keys
        (torch.bfloat16, True, 300, 128, 64),
        (torch.float16, False, 1, 16, 128),
        (torch.float32, True, 100, 32, 64),
        (torch.bfloat16, False, 65, 48, 128),
        # the float32 body's 64-key tiles: keys ragged across them, and a
        # causal block with far more keys than rows
        (torch.float32, False, 100, 200, 64),
        (torch.float32, True, 64, 1024, 64),
    ],
)
def test_kernel_matches_plain_version_on_card(cuda, dtype, causal, sq, sk, d):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, 3, sq, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, 3, sk, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, 3, sk, d, generator=g, device=cuda).to(dtype)
    before = LAUNCHES.count
    got = flash_attention(q, k, v, causal=causal, block_k=4096)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 1
    ref = ft.flash_attention_reference(q, k, v, causal=causal)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **F32)
    else:
        _assert_close_in_ulps(got, ref, dtype)


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 2, 64, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(x, x, x)
    y = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    flash_attention(y, y, y)  # a head-transposed view goes in as it lies
    torch.cuda.synchronize()
    w = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="last-dimension stride"):
        flash_attention(w, w, w)
    z = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="supports"):
        flash_attention(z, z, z)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,causal,s,h,d",
    [
        (torch.bfloat16, False, 512, 12, 64),  # BERT-base
        (torch.bfloat16, True, 200, 3, 128),
        (torch.float16, False, 65, 2, 64),
        (torch.float32, True, 77, 3, 128),
        (torch.float32, False, 512, 12, 128),  # the float32 body at d = 128 over 32-key tiles
    ],
)
def test_kernel_on_bert_layout_views_matches_plain_version(cuda, dtype, causal, s, h, d):
    torch.backends.cuda.matmul.allow_tf32 = False
    views = _bert_views(b=2, s=s, h=h, d=d, seed=3, dtype=dtype, device=cuda)
    before = LAUNCHES.count
    got = flash_attention(*views, causal=causal, block_k=4096)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 1
    assert got.transpose(1, 2).is_contiguous()  # [b, s, h, d] in memory
    ref = ft.flash_attention_reference(*views, causal=causal)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **F32)
    else:
        _assert_close_in_ulps(got, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", dict(rtol=2e-4, atol=2e-5)), ("bfloat16", dict(rtol=0, atol=2e-2))])
def test_bert_pallas_arm_launches_the_kernel_on_card(cuda, dtype, tol):
    """bert_tiny with attn_kernel=pallas on the card: one launch per layer
    per forward, probabilities as the same weights give with blockwise
    attention (float32: tests/test_models_heavy.py's tolerance; bf16: the
    activations keep 8 significant bits through every layer)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from seldon_core_tpu_torch.graph.spec import TpuSpec
    from seldon_core_tpu_torch.models.bert import apply_for_kernel
    from seldon_core_tpu_torch.models.zoo import _runtime_from_modelspec, get_model

    ms = get_model("bert_tiny", seed=2, seq=128, attn_kernel="pallas")
    rt = _runtime_from_modelspec(ms, TpuSpec(batch_buckets=(4,), max_batch=4, dtype=dtype), cuda)
    # warmed as served: a key's first use also runs the eager forward its
    # graph is captured from, which launches the kernel too
    rt.warmup()
    ids = np.random.default_rng(0).integers(0, 1024, size=(3, 128))
    before = LAUNCHES.count
    got = rt.predict(ids)
    assert LAUNCHES.count - before == len(rt.params["layers"])
    with torch.inference_mode():
        ref = apply_for_kernel("blockwise")(rt.params, torch.from_numpy(ids.astype(np.int32)).to(cuda))
    np.testing.assert_allclose(got, ref.float().cpu().numpy(), **tol)
