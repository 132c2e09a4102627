"""Ring and Ulysses sequence parallelism and BERT's tensor parallelism,
against the JAX package on the same virtual meshes.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces; the port's side on mesh positions ``[torch.device("cpu")] * N``.
Tolerances mirror the JAX tests: attention at rtol 2e-5 / atol 2e-6
(``tests/test_ops.py`` holds ring to 2e-5 / 2e-5, ``tests/test_models_heavy.py``
Ulysses to 2e-5 / 2e-6), served BERT at 2e-4 / 2e-5
(``tests/test_models_heavy.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from seldon_core_tpu.graph.spec import TpuSpec as JaxTpuSpec
from seldon_core_tpu.models.base import ModelRuntime as JaxRuntime
from seldon_core_tpu.models.bert import make_apply_bert as jax_make_apply_bert
from seldon_core_tpu.models.bert import make_ring_attention as jax_make_ring_attention
from seldon_core_tpu.models.zoo import build_runtime_from_uri as jax_build_runtime_from_uri
from seldon_core_tpu.models.zoo import get_model as jax_get_model
from seldon_core_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from seldon_core_tpu.ops.ulysses import ulysses_attention as jax_ulysses_attention
from seldon_core_tpu_torch.graph.spec import TpuSpec
from seldon_core_tpu_torch.models.bert import bert_apply_factory
from seldon_core_tpu_torch.models.zoo import _runtime_from_modelspec, build_runtime_from_uri, get_model
from seldon_core_tpu_torch.ops.ring_attention import ring_attention
from seldon_core_tpu_torch.ops.ulysses import ulysses_attention
from seldon_core_tpu_torch.parallel import Mesh, mesh_from_spec

CPU = torch.device("cpu")


def _qkv(b=2, h=2, s=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]


def _jax_mesh(axes):
    sizes = list(axes.values())
    return JaxMesh(np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes), tuple(axes))


def _mesh(axes):
    return Mesh(axes, [CPU] * int(np.prod(list(axes.values()))))


@pytest.mark.parametrize("axes,shape,causal", [
    ({"seq": 4}, (2, 2, 64, 16), False),
    ({"seq": 4}, (2, 2, 64, 16), True),
    ({"seq": 8}, (1, 1, 64, 16), False),
    ({"seq": 8}, (1, 1, 64, 16), True),
    ({"data": 2, "seq": 4}, (2, 2, 64, 16), True),
])
def test_ring_attention_matches_jax(axes, shape, causal):
    q, k, v = _qkv(*shape)
    want = np.asarray(jax_ring_attention(*map(jnp.asarray, (q, k, v)), _jax_mesh(axes), causal=causal))
    got = ring_attention(*map(torch.from_numpy, (q, k, v)), _mesh(axes), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("axes,shape,causal", [
    ({"seq": 4}, (2, 8, 32, 16), False),
    ({"seq": 4}, (2, 8, 32, 16), True),
    ({"data": 2, "seq": 4}, (2, 8, 32, 16), False),
    ({"seq": 8}, (1, 8, 64, 16), True),
    ({"seq": 4}, (1, 4, 2048, 8), False),  # the gathered sequence takes the blockwise path
])
def test_ulysses_attention_matches_jax(axes, shape, causal):
    q, k, v = _qkv(*shape, seed=1)
    want = np.asarray(jax_ulysses_attention(*map(jnp.asarray, (q, k, v)), _jax_mesh(axes), causal=causal))
    got = ulysses_attention(*map(torch.from_numpy, (q, k, v)), _mesh(axes), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_ring_refuses_a_ragged_sequence():
    q, k, v = _qkv(s=30)
    with pytest.raises(ValueError, match="seq 30 not divisible by ring size 4"):
        ring_attention(*map(torch.from_numpy, (q, k, v)), _mesh({"seq": 4}))
    with pytest.raises(ValueError, match="seq 30 not divisible by ring size 4"):
        jax_ring_attention(*map(jnp.asarray, (q, k, v)), _jax_mesh({"seq": 4}))


def test_ulysses_refuses_heads_the_axis_does_not_divide():
    q, k, v = _qkv(h=2, s=32)
    with pytest.raises(ValueError, match="2 heads not divisible by seq-axis size 4"):
        ulysses_attention(*map(torch.from_numpy, (q, k, v)), _mesh({"seq": 4}))
    with pytest.raises(ValueError, match="2 heads not divisible by seq-axis size 4"):
        jax_ulysses_attention(*map(jnp.asarray, (q, k, v)), _jax_mesh({"seq": 4}))


def test_ulysses_deployment_with_indivisible_heads_is_refused_at_build():
    """bert_tiny has 2 heads: a Ulysses deployment over {"seq": 4} is refused
    when it is built, in both packages."""
    with pytest.raises(ValueError, match="heads divisible"):
        _runtime_from_modelspec(get_model("bert_tiny", seq_parallel="ulysses"), TpuSpec(batch_buckets=[2],
                                max_batch=2), CPU, mesh=_mesh({"seq": 4}))
    from seldon_core_tpu.models.zoo import _runtime_from_modelspec as jax_runtime_from_modelspec

    with pytest.raises(ValueError, match="heads divisible"):
        jax_runtime_from_modelspec(jax_get_model("bert_tiny", seq_parallel="ulysses"),
                                   JaxTpuSpec(batch_buckets=[2], max_batch=2), _jax_mesh({"seq": 4}))


@pytest.mark.parametrize("strategy,axes,kw", [
    ("ring", {"seq": 4}, {}),
    ("ulysses", {"seq": 4}, {"hidden": 256, "ffn": 512}),  # 4 heads: the Ulysses path runs
    ("ring", {"data": 2, "seq": 4}, {}),
])
def test_bert_tiny_served_over_a_seq_mesh_matches_jax(strategy, axes, kw):
    """bert_tiny over a seq mesh, built from the same URI in both packages
    (the same numpy draws), the same probabilities."""
    query = "&".join([f"seq_parallel={strategy}", "max_len=64", "seq=64", *(f"{k}={v}" for k, v in kw.items())])
    ids = np.random.default_rng(0).integers(0, 1024, (4, 64)).astype(np.float32)
    want = np.asarray(jax_build_runtime_from_uri(
        f"zoo://bert_tiny?{query}", JaxTpuSpec(max_batch=4, batch_buckets=[4], donate_input=False),
        mesh=_jax_mesh(axes)).predict(ids))
    rt = build_runtime_from_uri(f"zoo://bert_tiny?{query}", TpuSpec(max_batch=4, batch_buckets=[4]), CPU,
                                mesh=_mesh(axes))
    assert rt.apply_fn.name == f"bert_{strategy}"
    np.testing.assert_allclose(rt.predict(ids), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_a_length_the_seq_axis_does_not_split_serves_unsharded(strategy):
    """50 tokens over {"seq": 4}: the single-device policy, as JAX's ring
    apply falls back to it, and the same answer."""
    kw = {"hidden": 256, "ffn": 512} if strategy == "ulysses" else {}
    ids = np.random.default_rng(1).integers(0, 1024, (1, 50))
    jms = jax_get_model("bert_tiny", max_len=64, **kw)
    want = np.asarray(jax_make_apply_bert(jax_make_ring_attention(_jax_mesh({"seq": 4})))(
        jms.params, jnp.asarray(ids, jnp.int32)))
    rt = _runtime_from_modelspec(get_model("bert_tiny", max_len=64, seq=50, seq_parallel=strategy, **kw),
                                 TpuSpec(batch_buckets=[1], max_batch=1), CPU, mesh=_mesh({"seq": 4}))
    np.testing.assert_allclose(rt.predict(ids.astype(np.float32)), want, rtol=2e-4, atol=2e-5)


def test_mesh_applies_are_memoised():
    """engine/fused.py detects homogeneous ensembles by apply identity: one
    apply per (mesh, strategy), as JAX's _bert_apply_factory."""
    assert bert_apply_factory(_mesh({"seq": 4})) is bert_apply_factory(_mesh({"seq": 4}))
    assert bert_apply_factory(_mesh({"model": 2})) is bert_apply_factory(_mesh({"model": 2}))
    assert bert_apply_factory(_mesh({"seq": 4}), "ulysses") is not bert_apply_factory(_mesh({"seq": 4}))


@pytest.mark.parametrize("attn_kernel", ["auto", "pallas"])
def test_bert_tiny_tensor_parallel_matches_jax(attn_kernel):
    """JAX's test_bert_tp_sharded_matches_single_device setup over {"data":
    1, "model": 2}: the same probabilities, and each position's q, k and v
    columns are whole heads (its heads' 64 columns of each slab)."""
    ms = get_model("bert_tiny", attn_kernel=attn_kernel)
    jms = jax_get_model("bert_tiny")
    ids = np.arange(32, dtype=np.int32).reshape(2, 16) % 512
    jmesh = _jax_mesh({"data": 1, "model": 2})
    want = JaxRuntime(jms.apply_fn, jms.params, mesh=jmesh, param_pspecs=jms.param_pspecs, buckets=(2,),
                      max_batch=2, dtype=jnp.float32, donate=False).predict(ids.astype(np.float32))
    rt = _runtime_from_modelspec(ms, TpuSpec(batch_buckets=[2], max_batch=2), CPU,
                                 mesh=mesh_from_spec({"data": 1, "model": 2}, [CPU] * 2))
    assert rt.apply_fn.name == f"bert_tp_{attn_kernel}"
    np.testing.assert_allclose(rt.predict(ids.astype(np.float32)), want, rtol=2e-4, atol=2e-5)
    hidden, head = 128, 64
    for li, layer in enumerate(ms.params["layers"]):
        w, b = layer["qkv"]["w"], layer["qkv"]["b"]
        for p in range(2):
            cols = np.concatenate([np.arange(s * hidden + p * head, s * hidden + (p + 1) * head) for s in range(3)])
            np.testing.assert_array_equal(rt.params[p]["layers"][li]["qkv"]["w"].numpy(), w[:, cols])
            np.testing.assert_array_equal(rt.params[p]["layers"][li]["qkv"]["b"].numpy(), b[cols])
            assert rt.params[p]["layers"][li]["attn_out"]["w"].shape == (hidden // 2, hidden)


def test_tensor_parallel_refuses_heads_the_axis_does_not_divide():
    with pytest.raises(ValueError, match="heads divisible by the model-axis size: 2 heads vs model=4"):
        _runtime_from_modelspec(get_model("bert_tiny"), TpuSpec(batch_buckets=[4], max_batch=4), CPU,
                                mesh=_mesh({"model": 4}))


def test_a_seq_and_model_mesh_and_int8_on_a_model_axis_are_refused_by_name():
    """A seq+model mesh, once refused by name, serves: ring attention over
    "seq" within each model index and the row-parallel psums over "model",
    answering as the unsharded runtime does (held against JAX's runtime on
    the same mesh in ``tests/test_torch_mesh_grads.py``); Ulysses, whose
    one head per model position the seq axis cannot divide, is refused by
    name. int8 on a "model" axis, once refused too, serves since
    ``quant.quantized_pspecs`` was ported: each position holds its shard of
    every int8 payload and the scales of its columns, and answers as the
    unsharded int8 runtime does (held against the JAX runtime in
    ``tests/test_torch_tp_decode.py``)."""
    fp = TpuSpec(batch_buckets=[2], max_batch=2)
    both = _runtime_from_modelspec(get_model("bert_tiny"), fp, CPU, mesh=_mesh({"seq": 2, "model": 2}))
    assert both.apply_fn.name == "bert_ring_tp"
    ids = np.random.default_rng(3).integers(0, 1024, (2, 16)).astype(np.float32)
    np.testing.assert_allclose(both.predict(ids), _runtime_from_modelspec(get_model("bert_tiny"), fp, CPU).predict(ids),
                               rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="1 heads per model position vs seq=2"):
        _runtime_from_modelspec(get_model("bert_tiny", seq_parallel="ulysses"), fp, CPU,
                                mesh=_mesh({"seq": 2, "model": 2}))
    cfg = TpuSpec(batch_buckets=[2], max_batch=2, weight_quant="int8")
    rt = _runtime_from_modelspec(get_model("bert_tiny"), cfg, CPU, mesh=_mesh({"model": 2}))
    one = _runtime_from_modelspec(get_model("bert_tiny"), cfg, CPU)
    qkv = rt.params[1]["layers"][0]["qkv"]["w"]
    assert tuple(qkv["__int8_weight__"].shape) == (128, 192) and tuple(qkv["scale"].shape) == (1, 192)
    assert rt.param_bytes() == one.param_bytes()
    ids = np.random.default_rng(4).integers(0, 1024, (2, 16)).astype(np.float32)
    np.testing.assert_allclose(rt.predict(ids), one.predict(ids), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("axes,query", [({"seq": 4}, "seq_parallel=ring"), ({"data": 1, "model": 2}, "attn_kernel=pallas")])
def test_hf_bert_on_a_mesh_matches_jax(tmp_path, axes, query):
    """The hf-bert:// branch takes BERT's mesh apply and partition rule, as
    JAX's does (``zoo.py:635-647``): a tiny saved checkpoint over a seq mesh
    (ring) and a model mesh, against the JAX branch over the same mesh."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                                  intermediate_size=256, max_position_embeddings=64, num_labels=3,
                                  attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)
    torch.manual_seed(0)
    transformers.BertForSequenceClassification(cfg).eval().save_pretrained(tmp_path)
    uri = f"hf-bert://{tmp_path}?seq=32&{query}"
    ids = np.random.default_rng(5).integers(0, 128, (4, 32)).astype(np.float32)
    want = np.asarray(jax_build_runtime_from_uri(uri, JaxTpuSpec(max_batch=4, batch_buckets=[4],
                                                                 donate_input=False), mesh=_jax_mesh(axes)).predict(ids))
    rt = build_runtime_from_uri(uri, TpuSpec(max_batch=4, batch_buckets=[4]), CPU, mesh=_mesh(axes))
    assert rt.mesh.shape == axes
    np.testing.assert_allclose(rt.predict(ids), want, rtol=2e-4, atol=2e-5)


def test_int8_on_a_data_mesh_serves_like_one_device():
    """weight_quant int8 on a data-only mesh: every position serves the
    quantized weights (through the W8A16 op, its plain version here) and
    the answers are the one-device runtime's."""
    tpu = TpuSpec(batch_buckets=[4], max_batch=4, weight_quant="int8")
    ids = np.random.default_rng(6).integers(0, 1024, (4, 16)).astype(np.float32)
    one = _runtime_from_modelspec(get_model("bert_tiny"), tpu, CPU).predict(ids)
    rt = _runtime_from_modelspec(get_model("bert_tiny"), tpu, CPU, mesh=_mesh({"data": 2}))
    from seldon_core_tpu_torch.models.quant import payload

    assert payload(rt.params[0]["layers"][0]["qkv"]["w"]).dtype == torch.int8
    np.testing.assert_allclose(rt.predict(ids), one, rtol=1e-6, atol=1e-7)
