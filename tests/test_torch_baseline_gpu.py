"""The BASELINE graph shapes served on the card (``-m gpu``; each skips here).

- a fused 3x resnet_tiny average ensemble on ``cuda`` (float32, TF32 off),
  fed a uint8 npy body: one FusedUnit, answers equal to the same deployment
  on the CPU at rtol 1e-4 / atol 1e-5 (tests/test_models_heavy.py's ResNet
  tolerance; the CPU side is held against the JAX package by
  tests/test_torch_graph.py) and to the unfused walk on the card;
- a transformer -> epsilon-greedy -> 2x bert_tiny DAG at seq 128 with
  ``attn_kernel=pallas`` on ``cuda``: one kernel launch per layer per
  request, answers as blockwise attention gives on the routed arm's weights
  (float32, tests/test_models_heavy.py's 2e-4 / 2e-5), and a feedback that
  moves only the routed arm.

Nothing here imports JAX: the card's host has none.
"""

import asyncio
import io
import json

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.core.codec_json import message_from_json
from seldon_core_tpu_torch.core.codec_npy import array_from_npy
from seldon_core_tpu_torch.core.message import SeldonMessage
from seldon_core_tpu_torch.engine.fused import FusedUnit
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.serving.server import PredictorServer
from seldon_core_tpu_torch.serving.wire import WireRequest, engine_predictions

RESNET_TOL = dict(rtol=1e-4, atol=1e-5)
BERT_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(name, uri, **params):
    return {"name": name, "type": "MODEL", "implementation": "JAX_MODEL",
            "parameters": [{"name": "model_uri", "value": uri, "type": "STRING"}]
            + [{"name": k, "value": v, "type": "STRING"} for k, v in params.items()]}


def _server(graph, device, **tpu):
    spec = PredictorSpec.from_dict({"name": "p", "graph": graph, "tpu": {"max_batch": 4, **tpu}})
    return PredictorServer(spec, device=device, enable_batching=False)


async def _npy_predict(server, x):
    buf = io.BytesIO()
    np.save(buf, x)
    req = WireRequest("POST", "/api/v0.1/predictions", {"content-type": "application/x-npy"}, buf.getvalue())
    resp = await engine_predictions(server.service, req)
    assert resp.status == 200 and resp.content_type == "application/x-npy", resp.body[:200]
    return array_from_npy(resp.body)


@pytest.mark.gpu
def test_fused_resnet_ensemble_on_card(cuda):
    graph = {"name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
             "children": [_model(f"m{i}", f"zoo://resnet_tiny?seed={i}") for i in range(3)]}
    on_card, on_cpu = _server(graph, cuda), _server(graph, "cpu")
    assert isinstance(on_card.executor.root.unit, FusedUnit) and not on_card.executor.root.children
    unfused = _server(graph, cuda, fuse_graph=False)
    x = np.random.default_rng(0).integers(0, 256, size=(3, 32, 32, 3), dtype=np.uint8)
    got = asyncio.run(_npy_predict(on_card, x))
    assert got.shape == (3, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, asyncio.run(_npy_predict(on_cpu, x)), **RESNET_TOL)
    walked = asyncio.run(unfused.executor.execute(SeldonMessage.from_array(x)))
    np.testing.assert_allclose(got, np.asarray(walked.array), **RESNET_TOL)


@pytest.mark.gpu
def test_epsilon_greedy_bert_dag_on_card(cuda):
    from seldon_core_tpu_torch.core.message import Feedback
    from seldon_core_tpu_torch.models.bert import apply_for_kernel
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES

    arms = [_model(f"bert-{c}", f"zoo://bert_tiny?seed={i}&seq=128", attn_kernel="pallas")
            for i, c in enumerate("ab")]
    graph = {"name": "scale", "type": "TRANSFORMER", "implementation": "MEAN_TRANSFORMER",
             "parameters": [{"name": "means", "value": "0.0", "type": "STRING"}],
             "children": [{"name": "eg", "type": "ROUTER", "implementation": "EPSILON_GREEDY",
                           "parameters": [{"name": "epsilon", "value": "0.5", "type": "FLOAT"},
                                          {"name": "seed", "value": "1", "type": "INT"}],
                           "children": arms}]}
    server = _server(graph, cuda)
    router_node = server.executor.root.children[0]
    blockwise = apply_for_kernel("blockwise")
    rng = np.random.default_rng(1)
    for n in (1, 3, 2, 1):
        ids = rng.integers(0, 1024, size=(n, 128))
        before = LAUNCHES.count
        out = asyncio.run(server.service.predict(message_from_json(json.dumps({"data": {"ndarray": ids.tolist()}}))))
        route = out.meta.routing["eg"]
        runtime = router_node.children[route].unit.runtime
        assert LAUNCHES.count - before == len(runtime.params["layers"])
        with torch.inference_mode():
            ref = blockwise(runtime.params, torch.from_numpy(ids.astype(np.int32)).to(cuda))
        np.testing.assert_allclose(np.asarray(out.array), ref.float().cpu().numpy(), **BERT_TOL)
    router = router_node.unit
    counts = list(router.counts)
    asyncio.run(server.service.send_feedback(Feedback(response=out, reward=1.0)))
    assert router.counts == [c + (i == route) for i, c in enumerate(counts)]
    assert router.rewards[route] == 1.0 and router.rewards[1 - route] == 0.0
