"""The port's BERT against the JAX package's on the same weights.

init_bert must draw bit-identical parameters; the serving probabilities of
bert_tiny must match the JAX model at rtol 2e-4 / atol 2e-5 (float32, the
tolerance tests/test_models_heavy.py holds the Pallas arm to against
blockwise) for each attention arm: dense at seq 16, the flash arm at seq 128
(JAX kernel in interpret mode, the port's plain version on the CPU) and
blockwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.models import bert as jax_bert
from seldon_core_tpu.models.base import ModelRuntime as JaxRuntime
from seldon_core_tpu_torch.models import bert
from seldon_core_tpu_torch.models.convert import params_to_numpy, params_to_torch
from seldon_core_tpu_torch.models.zoo import get_model, _runtime_from_modelspec
from seldon_core_tpu_torch.graph.spec import TpuSpec

TOL = dict(rtol=2e-4, atol=2e-5)
TINY = dict(vocab=512, hidden=128, layers=2, ffn=256, max_len=128)


@pytest.mark.parametrize(
    "kw", [dict(seed=0, **TINY), dict(seed=3, vocab=96, hidden=64, layers=3, ffn=32, max_len=16, num_classes=5)]
)
def test_init_bert_is_bit_identical(kw):
    ours, theirs = bert.init_bert(**kw), jax_bert.init_bert(**kw)
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    a, b = jax.tree.leaves(ours), jax.tree.leaves(theirs)
    assert len(a) == len(b) == 2 + 2 + 12 * kw["layers"] + 2
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_convert_round_trips():
    params = jax.tree.map(np.asarray, jax_bert.init_bert(1, **TINY))
    back = params_to_numpy(params_to_torch(params, torch.device("cpu")))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(x, y)
    # bf16 placement rounds exactly as jnp.asarray(a, bfloat16) does
    bf = params_to_numpy(params_to_torch(params, torch.device("cpu"), torch.bfloat16))
    ref = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), params)
    for x, y in zip(jax.tree.leaves(bf), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(x, y)
    ids = params_to_torch({"i": np.arange(4, dtype=np.int32)}, torch.device("cpu"), torch.bfloat16)
    assert ids["i"].dtype == torch.int32


@pytest.mark.parametrize(
    "seq,kernel", [(16, "auto"), (128, "pallas"), (128, "blockwise")]
)
def test_bert_tiny_matches_jax(seq, kernel, monkeypatch):
    ms = get_model("bert_tiny", seed=2, seq=seq, attn_kernel=kernel)
    rt = _runtime_from_modelspec(ms, TpuSpec(batch_buckets=(2,), max_batch=2), "cpu")
    jparams = jax_bert.init_bert(
        2, vocab=1024, hidden=128, layers=2, ffn=256, max_len=128, num_classes=2
    )
    jrt = JaxRuntime(jax_bert._apply_for_kernel(kernel), jparams, buckets=(2,), int_inputs="ids")
    ids = (np.arange(2 * seq).reshape(2, seq) * 7) % 1024

    calls = []
    if kernel == "pallas":
        real = bert.flash_attention
        monkeypatch.setattr(bert, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    got = rt.predict(ids)
    ref = np.asarray(jrt.predict(ids))
    assert got.shape == (2, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **TOL)
    if kernel == "pallas":
        assert len(calls) == 2  # one flash call per layer


def test_auto_policy_routes_by_length_and_device(monkeypatch):
    calls = {"flash": 0, "blockwise": 0, "naive": 0}
    for name in calls:
        fn_name = {"flash": "flash_attention", "blockwise": "blockwise_attention", "naive": "naive_attention"}[name]
        real = getattr(bert, fn_name)
        monkeypatch.setattr(
            bert, fn_name, lambda *a, _n=name, _r=real, **k: calls.__setitem__(_n, calls[_n] + 1) or _r(*a, **k)
        )
    q = torch.zeros(1, 1, bert.PALLAS_MIN_SEQ, 8)
    bert._default_attention(q, q, q)  # long, but on the CPU: blockwise, never the kernel
    bert._default_attention(q[:, :, :32], q[:, :, :32], q[:, :, :32])
    assert calls == {"flash": 0, "blockwise": 1, "naive": 1}
    bert._pallas_attention(q[:, :, :40], q[:, :, :40], q[:, :, :40])  # 40 % 16 != 0
    assert calls["blockwise"] == 2 and calls["flash"] == 0


def test_unknown_attn_kernel_raises():
    with pytest.raises(ValueError, match="attn_kernel"):
        get_model("bert_tiny", attn_kernel="cuda")
    with pytest.raises(ValueError, match="seq"):
        get_model("bert_tiny", seq=256)


def test_bf16_runtime_keeps_ids_exact_and_returns_float32():
    ms = get_model("bert_tiny", seq=16)
    rt = _runtime_from_modelspec(ms, TpuSpec(batch_buckets=(1, 4), max_batch=4, dtype="bfloat16"), "cpu")
    assert rt.params["tok_emb"].dtype == torch.bfloat16
    seen = []
    real = rt.apply_fn
    rt.apply_fn = lambda p, x: seen.append(x) or real(p, x)
    ids = np.array([[257, 1000, 1023] + [5] * 13], dtype=np.float32)  # JSON wire floats
    out = rt.predict(np.repeat(ids, 5, axis=0))  # 5 rows: split 4 + 1
    assert out.shape == (5, 2) and out.dtype == np.float32
    assert [tuple(x.shape) for x in seen] == [(4, 16), (1, 16)]
    assert seen[0].dtype == torch.int32 and seen[0][0, :3].tolist() == [257, 1000, 1023]
