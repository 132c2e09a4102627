"""The W8A16 kernel on the card (``-m gpu``; each skips here).

- ``csrc/int8_matmul.cu`` against its plain version, ``x @ dequantize(q,
  scale) + b``, in bfloat16 and float32, one member and three stacked
  members through the vmap rule (one launch for all), ragged and aligned
  shapes (float32 sums in another order: rtol 1e-5; bf16 rounds y once
  where the plain version rounds twice: 2e-2);
- the wgmma body at its edges (M % 128, K % 64 and N % 128 not 0; three
  stacked members with a K that ends mid-tile, per-member and shared x),
  each launched once on the body ``select_body`` names;
- the narrow body (``splitk``) at N 1, 2, 3 and 8, M 1, 5, 32 and 4096, K 4,
  768 and 776, in bf16 and float32, and the float32 tensor-core body
  (``tf32x2``) with M, N and K ragged against its tiles and three stacked
  members (shared and per-member x), each launched once on its body;
- the few-rows body (``fewrows``) at GPT-2-small's four projections on a
  decode step's 8 rows and BERT's pooler on 32, N and K ragged against its
  tile and k16 steps, three stacked members (shared and per-member x) and
  no bias, in bf16, f16 and float32, each launched once on its body, and
  two runs bit for bit;
- every body refusing a call it cannot take;
- a ``bert_tiny`` int8 deployment served on ``cuda`` launches the kernel
  2 x 4 + 1 = 9 times per forward and answers as the same deployment on the
  CPU (plain version) within 2e-2 in bf16;
- a fused ensemble of three int8 ``iris_mlp`` members (one apply function,
  so the members are vmapped) launches each of its 2 matmuls once for all
  members, and answers as the same ensemble on the CPU.

Nothing here imports JAX: the card's host has none. The CPU side is held
against the JAX package by tests/test_torch_quant.py.
"""

import asyncio

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.core.message import SeldonMessage
from seldon_core_tpu_torch.engine.fused import FusedUnit
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.models import quant
from seldon_core_tpu_torch.ops import int8_matmul as i8
from seldon_core_tpu_torch.serving.server import PredictorServer

BF16_ATOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A16 kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    # the plain version sums in float32, as the kernel and the JAX package
    # do (cuBLAS may otherwise reduce bf16 split-K partials in bf16)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 64, 768, 2304), (1, 5, 4, 3), (3, 40, 96, 20)])
def test_int8_matmul_kernel_matches_plain_version(cuda, shape, dtype):
    e, m, k, n = shape
    rng = np.random.default_rng(0)
    leaves = [quant.quantize_params({"w": rng.standard_normal((k, n)).astype(np.float32)})["w"] for _ in range(e)]
    q = torch.from_numpy(np.stack([quant.payload(leaf) for leaf in leaves])).to(cuda)
    s = torch.from_numpy(np.stack([leaf["scale"] for leaf in leaves])).reshape(e, n).to(cuda)
    b = torch.randn(e, n, device=cuda).to(dtype)
    x = torch.randn(e, m, k, device=cuda).to(dtype)
    before = i8.LAUNCHES.count
    if e == 1:
        got = i8.int8_matmul(x[0], q[0], s[0], b[0])[None]
    else:
        got = torch.func.vmap(i8.int8_matmul)(x, q, s, b)
    torch.cuda.synchronize()
    assert i8.LAUNCHES.count == before + 1
    want = i8._batched_reference(x, q, s, b)
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else dict(rtol=BF16_ATOL, atol=BF16_ATOL)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _case(cuda, e, m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    leaves = [quant.quantize_params({"w": rng.standard_normal((k, n)).astype(np.float32)})["w"] for _ in range(e)]
    q = torch.from_numpy(np.stack([quant.payload(leaf) for leaf in leaves])).to(cuda)
    s = torch.from_numpy(np.stack([leaf["scale"] for leaf in leaves])).reshape(e, n).to(cuda)
    b = torch.randn(e, n, device=cuda).to(dtype)
    return q, s, b


@pytest.mark.gpu
@pytest.mark.parametrize("shared_x", [False, True])
@pytest.mark.parametrize("shape, body", [
    ((1, 300, 776, 400), "wgmma"),  # M % 128, K % 64 and N % 128 all ragged
    ((3, 40, 776, 48), "wgmma"),  # members whose K ends mid-tile
    ((3, 40, 772, 48), "mma"),  # K % 8 != 0: TMA cannot stride x's rows
])
def test_int8_matmul_body_edges_match_plain_version(cuda, shape, body, shared_x):
    e, m, k, n = shape
    q, s, b = _case(cuda, e, m, k, n, torch.bfloat16, seed=1)
    x1 = torch.randn(1 if shared_x else e, m, k, device=cuda).to(torch.bfloat16)
    x = x1.expand(e, m, k)
    before = {name: c.count for name, c in i8.LAUNCHES_BY_BODY.items()}
    if e == 1:
        got = i8.int8_matmul(x1[0], q[0], s[0], b[0])[None]
    else:
        got = torch.func.vmap(i8.int8_matmul, in_dims=(None if shared_x else 0, 0, 0, 0))(
            x1[0] if shared_x else x1, q, s, b)
    torch.cuda.synchronize()
    assert {name: c.count - before[name] for name, c in i8.LAUNCHES_BY_BODY.items()} == {
        name: int(name == body) for name in i8.LAUNCHES_BY_BODY}
    want = i8._batched_reference(x, q, s, b)
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_ATOL, atol=BF16_ATOL)


def _one_launch_on(body, fn):
    before = {name: c.count for name, c in i8.LAUNCHES_BY_BODY.items()}
    got = fn()
    torch.cuda.synchronize()
    assert {name: c.count - before[name] for name, c in i8.LAUNCHES_BY_BODY.items()} == {
        name: int(name == body) for name in i8.LAUNCHES_BY_BODY}
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [4, 768, 776])
@pytest.mark.parametrize("m", [1, 5, 32, 4096])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_narrow_outputs_take_splitk_and_match_plain_version(cuda, n, m, k, dtype):
    q, s, b = _case(cuda, 1, m, k, n, dtype, seed=n + m + k)
    x = torch.randn(m, k, device=cuda).to(dtype)
    got = _one_launch_on("splitk", lambda: i8.int8_matmul(x, q[0], s[0], b[0]))
    want = i8._batched_reference(x[None], q, s, b)[0]
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else dict(rtol=BF16_ATOL, atol=BF16_ATOL)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("shared_x", [False, True])
@pytest.mark.parametrize("shape", [
    (1, 300, 776, 400),  # M % 128, K % 32 and N % 128 all ragged
    (1, 4000, 768, 2304),  # BERT-base's qkv with M off its tiles
    (1, 200, 772, 16),  # one narrow tile past the cut, K % 32 = 4
    (3, 40, 776, 48),  # members whose K ends mid-stage
])
def test_wide_float32_takes_tf32x2_and_matches_plain_version(cuda, shape, shared_x):
    e, m, k, n = shape
    q, s, b = _case(cuda, e, m, k, n, torch.float32, seed=2)
    x1 = torch.randn(1 if shared_x else e, m, k, device=cuda)
    x = x1.expand(e, m, k)
    if e == 1:
        got = _one_launch_on("tf32x2", lambda: i8.int8_matmul(x1[0], q[0], s[0], b[0])[None])
    else:
        fused = torch.func.vmap(i8.int8_matmul, in_dims=(None if shared_x else 0, 0, 0, 0))
        got = _one_launch_on("tf32x2", lambda: fused(x1[0] if shared_x else x1, q, s, b))
    torch.testing.assert_close(got, i8._batched_reference(x, q, s, b), rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_int8_matmul_refuses_a_body_that_cannot_take_the_call(cuda):
    q, s, b = _case(cuda, 1, 8, 4, 3, torch.bfloat16)
    x = torch.randn(1, 8, 4, device=cuda).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="wgmma body"):
        i8._launch(x, q, s, b, body="wgmma")  # K = 4, N = 3: no TMA map
    with pytest.raises(RuntimeError, match="fma body"):
        i8._launch(x, q, s, b, body="fma")  # bf16 activations
    with pytest.raises(RuntimeError, match="tf32x2 body"):
        i8._launch(x, q, s, b, body="tf32x2")  # bf16 activations
    with pytest.raises(RuntimeError, match="mma body"):
        i8._launch(x.float(), q, s, b.float(), body="mma")  # float32 activations
    with pytest.raises(RuntimeError, match="tf32x2 body"):
        i8._launch(x.float(), q, s, b.float(), body="tf32x2")  # N = 3: no TMA map of q
    q16, s16, b16 = _case(cuda, 1, 8, 6, 16, torch.float32)
    with pytest.raises(RuntimeError, match="tf32x2 body"):
        i8._launch(torch.randn(1, 8, 6, device=cuda), q16, s16, b16, body="tf32x2")  # K = 6: x rows off 16 bytes
    for dtype in (torch.bfloat16, torch.float32):  # the narrow body takes any shape
        i8._launch(x.to(dtype), q, s, b.to(dtype), body="splitk")
    with pytest.raises(RuntimeError, match="fewrows body"):
        i8._launch(x, q, s, b, body="fewrows")  # N = 3: the narrow body's
    q768, s768, b768 = _case(cuda, 1, 33, 768, 768, torch.bfloat16)
    x33 = torch.randn(1, 33, 768, device=cuda).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="fewrows body"):
        i8._launch(x33, q768, s768, b768, body="fewrows")  # one row past FEW_ROWS_WIDE
    i8._launch(x33[:, :32], q768, s768, b768, body="fewrows")


def _tolerance(dtype):
    return dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else dict(rtol=BF16_ATOL, atol=BF16_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("shape", [
    (1, 8, 768, 2304),  # GPT-2-small's qkv on a decode step's rows
    (1, 8, 768, 768),  # attn_out
    (1, 8, 768, 3072),  # mlp_in
    (1, 8, 3072, 768),  # mlp_out
    (1, 1, 3072, 768),  # one row
    (1, 32, 768, 768),  # BERT's pooler on 32 [CLS] rows
    (1, 3, 776, 2312),  # N off the 32-channel tile, K off a k16 step
    (1, 8, 3072, 760),  # N ending mid-tile at K = 3072
])
def test_few_rows_take_fewrows_and_match_plain_version(cuda, shape, dtype):
    e, m, k, n = shape
    q, s, b = _case(cuda, e, m, k, n, dtype, seed=m + k + n)
    x = torch.randn(m, k, device=cuda).to(dtype)
    got = _one_launch_on("fewrows", lambda: i8.int8_matmul(x, q[0], s[0], b[0]))
    again = i8.int8_matmul(x, q[0], s[0], b[0])
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # the K slices meet in a fixed order
    torch.testing.assert_close(got.float(), i8._batched_reference(x[None], q, s, b)[0].float(), **_tolerance(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shared_x", [False, True])
def test_fewrows_stacked_members_and_no_bias_match_plain_version(cuda, shared_x, dtype):
    e, m, k, n = 3, 8, 776, 768
    q, s, b = _case(cuda, e, m, k, n, dtype, seed=3)
    x1 = torch.randn(1 if shared_x else e, m, k, device=cuda).to(dtype)
    fused = torch.func.vmap(i8.int8_matmul, in_dims=(None if shared_x else 0, 0, 0, 0))
    got = _one_launch_on("fewrows", lambda: fused(x1[0] if shared_x else x1, q, s, b))
    torch.testing.assert_close(got.float(), i8._batched_reference(x1.expand(e, m, k), q, s, b).float(),
                               **_tolerance(dtype))
    plain = _one_launch_on("fewrows", lambda: i8.int8_matmul(x1[0], q[0], s[0]))
    torch.testing.assert_close(plain.float(), i8._batched_reference(x1[:1], q[:1], s[:1], None)[0].float(),
                               **_tolerance(dtype))


def _predictor(graph, dtype="bfloat16"):
    return PredictorSpec.from_dict({"name": "p", "graph": graph, "tpu": {
        "max_batch": 4, "batch_buckets": [4], "dtype": dtype, "weight_quant": "int8"}})


def _model(name, uri):
    return {"name": name, "type": "MODEL", "implementation": "JAX_MODEL",
            "parameters": [{"name": "model_uri", "value": uri, "type": "STRING"}]}


def _serve(predictor, device, ids):
    """(server, answer, W8A16 launches of the request) from a warmed server:
    on the card a key's first use also runs the eager forward its graph is
    captured from."""
    server = PredictorServer(predictor, device=device, enable_batching=False)
    server.warmup()
    before = i8.LAUNCHES.count
    out = asyncio.run(server.service.predict(SeldonMessage.from_array(ids)))
    return server, np.asarray(out.array), i8.LAUNCHES.count - before


@pytest.mark.gpu
def test_bert_tiny_int8_launches_per_forward_and_answers_like_the_cpu(cuda):
    ids = np.random.default_rng(1).integers(0, 1024, (3, 16)).astype(np.float32)
    pred = _predictor(_model("bert", "zoo://bert_tiny?seq=16"))
    _, got, launches = _serve(pred, "cuda", ids)
    assert launches == 2 * 4 + 1
    _, want, _ = _serve(pred, "cpu", ids)
    np.testing.assert_allclose(got, want, atol=BF16_ATOL)


@pytest.mark.gpu
def test_bert_tiny_float32_int8_launches_by_body_and_answers_like_the_cpu(cuda):
    ids = np.random.default_rng(1).integers(0, 1024, (3, 16)).astype(np.float32)
    pred = _predictor(_model("bert", "zoo://bert_tiny?seq=16"), dtype="float32")
    before = {name: c.count for name, c in i8.LAUNCHES_BY_BODY.items()}
    _, got, launches = _serve(pred, "cuda", ids)
    assert launches == 2 * 4 + 1
    by_body = {name: c.count - before[name] for name, c in i8.LAUNCHES_BY_BODY.items()}
    assert by_body["tf32x2"] >= 8 and by_body["splitk"] >= 1 and by_body["fma"] == by_body["mma"] == 0
    _, want, _ = _serve(pred, "cpu", ids)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.gpu
def test_fused_int8_ensemble_launches_once_for_all_members(cuda):
    graph = {"name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
             "children": [_model(f"m{i}", f"zoo://iris_mlp?seed={i}") for i in range(3)]}
    x = np.random.default_rng(2).uniform(0, 8, (2, 4)).astype(np.float32)
    server, got, launches = _serve(_predictor(graph), "cuda", x)
    assert isinstance(server.executor.root.unit, FusedUnit)
    assert launches == 2
    _, want, _ = _serve(_predictor(graph), "cpu", x)
    np.testing.assert_allclose(got, want, atol=BF16_ATOL)
