"""The port's weight-only int8 serving against the JAX package's.

- ``quantize_params`` gives int8 payloads and float32 scales bit-identical
  to ``seldon_core_tpu.models.quant.quantize_params`` on ``init_bert``
  (tiny), the MNIST MLP and ``resnet_tiny``, with the same leaves quantized
  (``pos_emb`` included) and the rest untouched;
- int8 runtimes agree with the JAX package's int8 runtimes on the same
  weights and inputs: float32 to 1e-5, bfloat16 within the JAX package's
  own int8 tolerances (tests/test_quant.py: 2e-2 for the MLPs, 3e-2 for
  BERT), and a fused ensemble of quantized members agrees with the JAX
  package's fused ensemble and runs every member's matmul as one batched
  call (the kernel's member dimension on the card);
- the plain version of the W8A16 kernel equals ``x @ dequantize(q) + b`` of
  the JAX package for one member and for three stacked members;
- ``bert_int8.json`` passes the port's spec and defaulting, and its ``tpu``
  block serves a ``bert_tiny`` copy on the CPU within 3e-2 of the JAX
  package serving the same CR; a generative model with ``weight_quant`` and
  a bad ``weight_quant`` value are refused by name;
- ``donate_input`` is accepted and changes no output.

The kernel itself is held against its plain version on the card by
tests/test_torch_int8_gpu.py and ``chip_smoke.py`` phase 7.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.engine.executor import build_executor as jax_build_executor
from seldon_core_tpu.graph.spec import SeldonDeployment as JaxDeployment
from seldon_core_tpu.core.message import SeldonMessage as JaxMessage
from seldon_core_tpu.models import bert as jax_bert
from seldon_core_tpu.models import quant as jax_quant
from seldon_core_tpu.models import resnet as jax_resnet
from seldon_core_tpu.models.base import ModelRuntime as JaxRuntime
from seldon_core_tpu.models.zoo import get_model as jax_get_model
from seldon_core_tpu_torch.core.message import SeldonMessage
from seldon_core_tpu_torch.engine.executor import build_executor
from seldon_core_tpu_torch.engine.fused import FusedUnit
from seldon_core_tpu_torch.graph.defaulting import default_deployment, spec_problems
from seldon_core_tpu_torch.graph.spec import PredictorSpec, SeldonDeployment, TpuSpec
from seldon_core_tpu_torch.models import bert, quant, resnet, zoo
from seldon_core_tpu_torch.models.base import ModelRuntime
from seldon_core_tpu_torch.ops import int8_matmul as i8
from seldon_core_tpu_torch.serving.server import PredictorServer

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
MLP_BF16_ATOL = 2e-2  # tests/test_quant.py:53
BERT_BF16_ATOL = 3e-2  # tests/test_quant.py:94
IRIS_X = np.asarray([[5.1, 3.5, 1.4, 0.2], [6.7, 3.0, 5.2, 2.3], [5.9, 3.0, 4.2, 1.5]], np.float32)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tiny_bert_params():
    return jax_bert.init_bert(0, vocab=1024, hidden=128, layers=2, ffn=256, max_len=128)


def _tiny_resnet_params():
    return jax_resnet.fold_batchnorm(jax_resnet.init_resnet(0, depth=18, num_classes=10, width=16))


def _flat(tree, prefix=""):
    """{path: leaf} with quantized marker dicts kept as leaves."""
    if quant.is_quantized_leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


PARAM_TREES = {
    "bert_tiny": _tiny_bert_params,
    "mnist_mlp": lambda: _np_tree(jax_get_model("mnist_mlp").params),
    "resnet_tiny": _tiny_resnet_params,
}


@pytest.mark.parametrize("name", sorted(PARAM_TREES))
def test_quantize_params_bit_identical_to_jax(name):
    params = PARAM_TREES[name]()
    ours, theirs = _flat(quant.quantize_params(params)), _flat(jax_quant.quantize_params(params))
    assert ours.keys() == theirs.keys()
    n_quantized = 0
    for path, leaf in ours.items():
        ref = theirs[path]
        assert quant.is_quantized_leaf(leaf) == jax_quant.is_quantized_leaf(ref), path
        if quant.is_quantized_leaf(leaf):
            n_quantized += 1
            assert leaf["__int8_weight__"].dtype == np.int8 and leaf["scale"].dtype == np.float32
            np.testing.assert_array_equal(leaf["__int8_weight__"], np.asarray(ref["__int8_weight__"]))
            assert leaf["scale"].tobytes() == np.asarray(ref["scale"]).tobytes(), path
        else:
            np.testing.assert_array_equal(np.asarray(leaf), np.asarray(ref))
    assert n_quantized > 0
    if name == "bert_tiny":
        # pos_emb (128 rows) and the tiny vocab table (1024 rows) are tables
        # the rule still quantizes; BERT-base's 30522-row table it does not
        assert quant.is_quantized_leaf(ours["/pos_emb"]) and quant.is_quantized_leaf(ours["/tok_emb"])
        table = {"tok_emb": np.zeros((30522, 8), np.float32)}
        assert not quant.is_quantized_leaf(quant.quantize_params(table)["tok_emb"])
        assert not jax_quant.is_quantized_leaf(jax_quant.quantize_params(table)["tok_emb"])


def test_quantize_params_is_idempotent_and_dequantize_matches_jax():
    w = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    once = quant.quantize_params({"w": w})
    twice = quant.quantize_params(once)
    assert twice["w"] is once["w"]
    leaf = {k: torch.from_numpy(v) for k, v in once["w"].items()}
    for dtype, jdtype in DTYPES.values():
        got = quant.dequantize(leaf, dtype).float().numpy()
        want = np.asarray(jax_quant.dequantize(once, jdtype)["w"].astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


def _jax_mlp(name):
    ms = jax_get_model(name)
    return ms, _np_tree(ms.params)


MLP_CASES = {  # name: (the port's apply, an input)
    "iris_mlp": (zoo._apply_mlp2, IRIS_X),
    "mnist_mlp": (zoo._apply_mlp3_flat, np.random.default_rng(0).uniform(0, 1, (3, 784)).astype(np.float32)),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(MLP_CASES))
def test_int8_mlp_runtime_matches_jax(name, dtype):
    """The JAX package draws these weights with jax.random: they are
    carried across."""
    ms, params = _jax_mlp(name)
    apply, x = MLP_CASES[name]
    tdtype, jdtype = DTYPES[dtype]
    want = JaxRuntime(ms.apply_fn, params, buckets=[4], dtype=jdtype, weight_quant="int8").predict(x)
    rt = ModelRuntime(apply, params, device=CPU, buckets=[4], dtype=tdtype, weight_quant="int8")
    got = rt.predict(x)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, atol=MLP_BF16_ATOL)
    assert (np.argmax(got, 1) == np.argmax(want, 1)).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_bert_tiny_runtime_matches_jax(dtype):
    params = _tiny_bert_params()
    tdtype, jdtype = DTYPES[dtype]
    ids = np.random.default_rng(0).integers(0, 1024, (4, 16))
    want = JaxRuntime(jax_bert.apply_bert, params, buckets=[4], dtype=jdtype, int_inputs="ids",
                      weight_quant="int8").predict(ids)
    rt = ModelRuntime(bert.apply_for_kernel("auto"), params, device=CPU, buckets=[4], dtype=tdtype,
                      int_inputs="ids", weight_quant="int8")
    assert quant.is_quantized_leaf(rt.params["tok_emb"]) and rt.params["tok_emb"]["scale"].dtype == torch.float32
    got = rt.predict(ids)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, atol=BERT_BF16_ATOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_resnet_tiny_runtime_matches_jax(dtype):
    """Quantized on the JAX layout, then laid out: the HWIO payload becomes
    OIHW and its (1, 1, 1, O) scale (O, 1, 1, 1), float32."""
    params = _tiny_resnet_params()
    tdtype, jdtype = DTYPES[dtype]
    x = np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want_rt = JaxRuntime(jax_resnet.apply_resnet, params, buckets=[2], dtype=jdtype, weight_quant="int8")
    rt = ModelRuntime(resnet.apply_resnet, params, device=CPU, buckets=[2], dtype=tdtype,
                      layout=resnet.conv_layout, weight_quant="int8")
    stem = rt.params["stem"]["conv"]
    assert stem["__int8_weight__"].dtype == torch.int8 and stem["__int8_weight__"].shape == (16, 3, 7, 7)
    assert stem["scale"].shape == (16, 1, 1, 1) and stem["scale"].dtype == torch.float32
    got, want = rt.predict(x), want_rt.predict(x)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)  # tests/test_models_heavy.py's ResNet tolerance
    else:
        np.testing.assert_allclose(got, want, atol=MLP_BF16_ATOL)


def _predictor(graph: dict, tpu: dict) -> dict:
    return {"name": "p", "graph": graph, "tpu": {"max_batch": 4, **tpu}}


def _model(name, uri):
    return {"name": name, "type": "MODEL", "implementation": "JAX_MODEL",
            "parameters": [{"name": "model_uri", "value": uri, "type": "STRING"}]}


async def test_fused_ensemble_of_quantized_members_matches_jax(monkeypatch):
    """Three int8 resnet_tiny members (bit-identical init in both packages)
    fuse into one unit; each forward runs every member's head as ONE
    batched W8A16 call over the member axis, and the ensemble agrees with
    the JAX package's fused int8 ensemble."""
    graph = {"name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
             "children": [_model(f"m{i}", f"zoo://resnet_tiny?seed={i}") for i in range(3)]}
    pred = _predictor(graph, {"weight_quant": "int8"})
    ours = build_executor(PredictorSpec.from_dict(pred), context={"device": "cpu"})
    theirs = jax_build_executor(JaxDeployment.from_dict({"spec": {"name": "d", "predictors": [pred]}}).spec.predictors[0])
    assert isinstance(ours.root.unit, FusedUnit)
    members = []
    batched = i8._batched
    monkeypatch.setattr(i8, "_batched", lambda x, q, s, b: members.append(q.shape[0]) or batched(x, q, s, b))
    x = np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    got = np.asarray((await ours.execute(SeldonMessage.from_array(x))).array)
    want = np.asarray((await theirs.execute(JaxMessage.from_array(x))).array)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert members == [3]  # one call for the three heads


@pytest.mark.parametrize("members", [1, 3])
def test_int8_matmul_plain_version_matches_jax_dequantize_matmul(members):
    rng = np.random.default_rng(members)
    leaves = [jax_quant.quantize_params({"w": rng.standard_normal((24, 5)).astype(np.float32)})["w"]
              for _ in range(members)]
    b = rng.standard_normal((members, 5)).astype(np.float32)
    x = rng.standard_normal((7, 24)).astype(np.float32)
    want = np.stack([
        np.asarray(jnp.asarray(x) @ jax_quant.dequantize(leaf, jnp.float32) + b[i])
        for i, leaf in enumerate(leaves)
    ])
    q = torch.from_numpy(np.stack([leaf["__int8_weight__"] for leaf in leaves]))
    s = torch.from_numpy(np.stack([leaf["scale"] for leaf in leaves]))
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    if members == 1:
        got = i8.int8_matmul(xt, q[0], s[0], bt[0])[None]
    else:
        with torch.inference_mode():
            got = torch.func.vmap(i8.int8_matmul, in_dims=(None, 0, 0, 0))(xt, q, s, bt)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_prequantized_params_keep_f32_scales_in_plain_runtime():
    qparams = quant.quantize_params({"w": np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32),
                                     "b": np.zeros(8, np.float32)})
    rt = ModelRuntime(zoo.dense, qparams, device=CPU, buckets=[2], dtype=torch.bfloat16)
    assert rt.params["w"]["scale"].dtype == torch.float32 and rt.params["w"]["__int8_weight__"].dtype == torch.int8
    assert rt.params["b"].dtype == torch.bfloat16
    assert np.isfinite(rt.predict(np.ones((1, 16), np.float32))).all()


def test_quantized_nbytes_matches_actual_residency():
    _, params = _jax_mlp("iris_mlp")
    rt = ModelRuntime(zoo._apply_mlp2, params, device=CPU, buckets=[4], weight_quant="int8")
    actual = sum(t.nbytes for t in _flat(rt.params).values() if isinstance(t, torch.Tensor))
    actual += sum(t["__int8_weight__"].nbytes + t["scale"].nbytes
                  for t in _flat(rt.params).values() if quant.is_quantized_leaf(t))
    assert sum(quant.quantized_nbytes(a) for a in _flat(params).values()) == actual
    full = ModelRuntime(zoo._apply_mlp2, params, device=CPU, buckets=[4])
    assert actual < 0.6 * sum(t.nbytes for t in _flat(full.params).values())


def _bert_int8_copy(seq: int = 16) -> dict:
    """examples/deployments/bert_int8.json with its model cut to bert_tiny:
    the same tpu block (bf16, bucket 32, weight_quant int8)."""
    obj = json.loads((REPO / "examples" / "deployments" / "bert_int8.json").read_text())
    params = obj["spec"]["predictors"][0]["graph"]["parameters"]
    params[:] = [{"name": "model_uri", "value": f"zoo://bert_tiny?seq={seq}", "type": "STRING"}]
    return obj


@pytest.mark.parametrize("path", [REPO / "examples" / "deployments" / "bert_int8.json",
                                  REPO / "seldon_core_tpu_torch" / "deployments" / "bert_int8.json"],
                         ids=["example", "port_copy"])
def test_bert_int8_deployment_passes_spec_and_defaulting(path):
    dep = default_deployment(SeldonDeployment.from_dict(json.loads(path.read_text())), n_devices=1)
    tpu = dep.spec.predictors[0].tpu
    assert (tpu.weight_quant, tpu.dtype, tuple(tpu.batch_buckets), tpu.max_batch) == ("int8", "bfloat16", (32,), 32)
    assert "weight_quant" not in tpu.extra and spec_problems("main", tpu) == []


async def test_bert_int8_tpu_block_serves_a_bert_tiny_copy_like_jax():
    obj = _bert_int8_copy()
    pred = default_deployment(SeldonDeployment.from_dict(obj), n_devices=1).spec.predictors[0]
    server = PredictorServer(pred, device="cpu")
    rt = server.executor.root.unit.runtime
    assert rt.weight_quant == "int8" and quant.is_quantized_leaf(rt.params["layers"][0]["qkv"]["w"])
    ids = np.random.default_rng(3).integers(0, 1024, (5, 16)).astype(np.float32)
    got = np.asarray((await server.service.predict(SeldonMessage.from_array(ids))).array)
    jpred = JaxDeployment.from_dict(obj).spec.predictors[0]
    want = np.asarray((await jax_build_executor(jpred).execute(JaxMessage.from_array(ids))).array)
    np.testing.assert_allclose(got, want, atol=BERT_BF16_ATOL)
    await server.stop()


def test_weight_quant_refusals_by_name():
    with pytest.raises(ValueError, match="weight_quant"):
        ModelRuntime(zoo.dense, {}, device=CPU, buckets=[2], weight_quant="fp4")
    assert any("weight_quant 'fp4'" in p for p in spec_problems("p", TpuSpec.from_dict({"weight_quant": "fp4"})))
    bad = _bert_int8_copy()
    bad["spec"]["predictors"][0]["tpu"]["weight_quant"] = "fp4"
    with pytest.raises(ValueError, match="weight_quant 'fp4' unsupported"):
        PredictorServer(default_deployment(SeldonDeployment.from_dict(bad), n_devices=1).spec.predictors[0],
                        device="cpu")
    # a generative model on int8 weights, once refused by name, serves
    # (held against JAX's int8 generate in tests/test_torch_int8_generate.py)
    gen = {"spec": {"name": "g", "predictors": [_predictor(_model("gpt", "zoo://tiny_gpt"),
                                                           {"weight_quant": "int8"})]}}
    runtime = PredictorServer(SeldonDeployment.from_dict(gen).spec.predictors[0],
                              device="cpu").executor.root.unit.runtime
    assert runtime.weight_quant == "int8" and runtime.generative is not None


@pytest.mark.parametrize("tpu", [{"weight_quant": "fp4"}, {"deadline_ms": -1}, {"queue_timeout_ms": -5},
                                 {"batch_timeout_ms": -1}, {"weight_quant": "int8", "deadline_ms": 0}])
def test_spec_problems_match_jax_validation(tpu):
    """The port's rules for these tpu knobs give the JAX package's
    validation messages (seldon_core_tpu/graph/validation.py)."""
    from seldon_core_tpu.graph.validation import ValidationError, validate_deployment

    cr = {"spec": {"name": "d", "predictors": [{"name": "p", "graph": {"name": "m", "implementation": "SIMPLE_MODEL"},
                                                "tpu": tpu}]}}
    try:
        validate_deployment(JaxDeployment.from_dict(cr))
        want = []
    except ValidationError as e:
        want = e.problems
    assert spec_problems("p", SeldonDeployment.from_dict(cr).spec.predictors[0].tpu) == want


@pytest.mark.parametrize("donate", [False, True])
async def test_donate_input_changes_no_output(donate):
    """donate_input is accepted (JAX donation lets XLA reuse the input
    buffer; eager PyTorch frees it when its last reference drops) and the
    answer is the same either way."""
    tpu = {"donate_input": donate}
    pred = PredictorSpec.from_dict(_predictor(_model("m", "zoo://iris_mlp?seed=4"), tpu))
    assert pred.tpu.donate_input is donate and spec_problems("p", pred.tpu) == []
    ref = PredictorSpec.from_dict(_predictor(_model("m", "zoo://iris_mlp?seed=4"), {}))
    got = await build_executor(pred, context={"device": "cpu"}).execute(SeldonMessage.from_array(IRIS_X))
    want = await build_executor(ref, context={"device": "cpu"}).execute(SeldonMessage.from_array(IRIS_X))
    np.testing.assert_array_equal(np.asarray(got.array), np.asarray(want.array))
