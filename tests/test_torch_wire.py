"""The port's wire against the JAX package's, through both fast ingresses.

- an ``application/x-npy`` body is answered in npy with the meta in the
  ``Seldon-Meta`` header (cut to puid and routing above 6144 bytes); npy
  ``binData`` in a JSON body is answered as npy ``binData``;
- an object-dtype npy is refused with code 101;
- ``POST /api/v0.1/feedback`` reaches the ε-greedy router, and both
  packages' routers hold the same state after the same traffic;
- the port's server and the JAX package's answer the same iris, iris A/B,
  MNIST and tiny-ResNet ensemble requests, on the JAX package's weights
  carried across: float32 deployments at rtol 1e-5 / atol 1e-6 (the fused
  tests' tolerance; resnet at rtol 1e-4 / atol 1e-5, its model tests'),
  the bfloat16 MNIST deployment at atol 4e-3 (the port's softmax runs in
  float32 on the bf16 logits, the JAX package's in bf16: one bf16 rounding
  of a probability < 1 is under 2^-9);
- the mesh rule: ``{"data": 8}`` shrinks to one device, ``{"data": 2,
  "model": 4}`` is refused, as ``parallel/mesh.py::mesh_from_spec`` does.
"""

import asyncio
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from seldon_core_tpu.engine import build_executor as jax_build_executor
from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictorSpec
from seldon_core_tpu.parallel.mesh import mesh_from_spec as jax_mesh_from_spec
from seldon_core_tpu.serving.fast_http import engine_routes as jax_engine_routes
from seldon_core_tpu.serving.fast_http import start_fast_server as jax_start_fast_server
from seldon_core_tpu.serving.service import PredictionService as JaxPredictionService
from seldon_core_tpu_torch.core.message import Meta, SeldonMessage
from seldon_core_tpu_torch.graph.defaulting import mesh_from_spec
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor
from seldon_core_tpu_torch.serving.wire import META_HEADER_MAX, npy_wire_response

REPO = Path(__file__).resolve().parents[1]
DEPLOYMENTS = REPO / "seldon_core_tpu_torch" / "deployments"
F32_TOL = dict(rtol=1e-5, atol=1e-6)
RESNET_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = 4e-3


def _npy(arr, allow_pickle=False) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=allow_pickle)
    return buf.getvalue()


async def _http(port, path, body, ctype="application/json"):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(
            f"POST {path} HTTP/1.1\r\nHost: t\r\nContent-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode() + body
        )
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, _, v in (ln.partition(":") for ln in lines[1:])}
    return int(lines[0].split(" ")[1]), headers, payload


def _port_server(path):
    predictor, dep = load_predictor(str(path))
    return PredictorServer(predictor, deployment_name=dep, device="cpu")


def _jax_service(path):
    obj = json.loads(Path(path).read_text())
    spec = JaxPredictorSpec.model_validate(obj["spec"]["predictors"][0])
    return JaxPredictionService(jax_build_executor(spec), deployment_name=obj["spec"]["name"])


def _carry_weights(node, jax_node):
    """Give each port model the JAX package's parameters (the small zoo
    models draw with jax.random there, with numpy here)."""
    rt, jrt = getattr(node.unit, "runtime", None), getattr(jax_node.unit, "runtime", None)
    if rt is not None:
        host = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jrt.params)
        rt.params = params_to_torch(host, rt.device, rt.dtype)
    for c, jc in zip(node.children, jax_node.children):
        _carry_weights(c, jc)


async def _serve_both(path, requests, *, carry=True):
    """Each (route, body, content type) to the port's and the JAX package's
    server for one deployment file, in turn; returns the port's server, the
    JAX service and both lists of (status, headers, body)."""
    server = _port_server(path)
    jservice = _jax_service(path)
    if carry:
        _carry_weights(server.executor.root, jservice.executor.root)
    await server.start("127.0.0.1", 0)
    jserver = await jax_start_fast_server(jax_engine_routes(jservice, {"paused": False}), "127.0.0.1", 0)
    jport = jserver.sockets[0].getsockname()[1]
    ours, theirs = [], []
    try:
        for req in requests:
            ours.append(await _http(server.port, *req))
            theirs.append(await _http(jport, *req))
    finally:
        await server.stop()
        jserver.close()
        await jserver.wait_closed()
    return server, jservice, ours, theirs


def _json_probs(body):
    return np.asarray(json.loads(body)["data"]["ndarray"], dtype=np.float64)


def _iris_rows(n, seed):
    return np.random.default_rng(seed).uniform(0, 8, size=(n, 4)).round(1)


@pytest.mark.parametrize("name", ["iris", "iris_abtest"])
async def test_iris_deployments_answer_as_jax(name):
    reqs = [("/api/v0.1/predictions", json.dumps({"data": {"ndarray": _iris_rows(n, n).tolist()}}).encode())
            for n in (1, 3, 2, 1, 4, 1)]
    _, _, ours, theirs = await _serve_both(DEPLOYMENTS / f"{name}.json", reqs)
    for (s, _, b), (js, _, jb) in zip(ours, theirs):
        assert s == js == 200
        out, jout = json.loads(b), json.loads(jb)
        assert out["meta"].get("routing") == jout["meta"].get("routing")
        assert out["data"]["names"] == jout["data"]["names"] == ["setosa", "versicolor", "virginica"]
        np.testing.assert_allclose(_json_probs(b), _json_probs(jb), **F32_TOL)


async def test_mnist_bf16_answers_as_jax():
    x = np.random.default_rng(2).uniform(0, 1, size=(3, 784)).astype(np.float32)
    reqs = [("/api/v0.1/predictions", _npy(x), "application/x-npy")]
    _, _, ours, theirs = await _serve_both(DEPLOYMENTS / "mnist.json", reqs)
    (s, h, b), (js, jh, jb) = ours[0], theirs[0]
    assert s == js == 200 and h["content-type"] == jh["content-type"] == "application/x-npy"
    got, ref = np.load(io.BytesIO(b)), np.load(io.BytesIO(jb))
    assert got.shape == ref.shape == (3, 10) and got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_ATOL)
    assert json.loads(h["seldon-meta"])["tags"]["names"] == [str(i) for i in range(10)]


def _tiny_resnet_ensemble(tmp_path):
    obj = json.loads((DEPLOYMENTS / "resnet_ensemble.json").read_text())
    pred = obj["spec"]["predictors"][0]
    for child in pred["graph"]["children"]:
        uri = child["parameters"][0]["value"]
        child["parameters"][0]["value"] = uri.replace("resnet50", "resnet_tiny")
    pred["tpu"] = {"max_batch": 4, "dtype": "float32"}
    path = tmp_path / "resnet_tiny_ensemble.json"
    path.write_text(json.dumps(obj))
    return path


async def test_tiny_resnet_ensemble_npy_answers_as_jax(tmp_path):
    """init_resnet is bit-identical in both packages: no weights to carry."""
    x = np.random.default_rng(4).integers(0, 256, size=(3, 32, 32, 3), dtype=np.uint8)
    reqs = [("/api/v0.1/predictions", _npy(x), "application/x-npy")]
    server, _, ours, theirs = await _serve_both(_tiny_resnet_ensemble(tmp_path), reqs, carry=False)
    (s, h, b), (js, jh, jb) = ours[0], theirs[0]
    assert server.executor.root.unit.image == "fused[rn-a,rn-b,rn-c]"
    assert s == js == 200 and h["content-type"] == "application/x-npy"
    meta = json.loads(h["seldon-meta"])
    assert meta["requestPath"] == json.loads(jh["seldon-meta"])["requestPath"]
    assert meta["tags"]["names"] == [f"class_{i}" for i in range(10)]
    got, ref = np.load(io.BytesIO(b)), np.load(io.BytesIO(jb))
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got, ref, **RESNET_TOL)


async def test_npy_bindata_in_json_and_bad_npy():
    x = _iris_rows(2, 9).astype(np.float32)
    import base64

    body = json.dumps({"binData": base64.b64encode(_npy(x)).decode()}).encode()
    obj_npy = _npy(np.array([{"a": 1}], dtype=object), allow_pickle=True)
    reqs = [
        ("/api/v0.1/predictions", body),
        ("/api/v0.1/predictions", obj_npy, "application/x-npy"),
        ("/api/v0.1/predictions", b"\x93NUMPY garbage", "application/x-npy"),
    ]
    _, _, ours, theirs = await _serve_both(DEPLOYMENTS / "iris.json", reqs)
    (s, _, b), (js, _, jb) = ours[0], theirs[0]
    assert s == js == 200
    got = np.load(io.BytesIO(base64.b64decode(json.loads(b)["binData"])))
    ref = np.load(io.BytesIO(base64.b64decode(json.loads(jb)["binData"])))
    np.testing.assert_allclose(got, ref, **F32_TOL)
    for (s, _, b), (js, _, jb) in zip(ours[1:], theirs[1:]):
        assert s == js == 400
        assert json.loads(b)["code"] == json.loads(jb)["code"] == 101


def test_seldon_meta_header_is_cut_above_the_limit():
    small = npy_wire_response(SeldonMessage(bin_data=b"x", meta=Meta(puid="p", routing={"r": 1})))
    assert json.loads(small.headers["Seldon-Meta"]) == {"puid": "p", "routing": {"r": 1}}
    big = npy_wire_response(
        SeldonMessage(bin_data=b"x", meta=Meta(puid="p", routing={"r": 1}, tags={"t": "v" * META_HEADER_MAX}))
    )
    assert json.loads(big.headers["Seldon-Meta"]) == {"puid": "p", "routing": {"r": 1}, "truncated": True}
    assert big.content_type == "application/x-npy" and big.body == b"x"


def _eg_deployment(tmp_path):
    dep = {"spec": {"name": "eg", "predictors": [{"name": "main", "graph": {
        "name": "eg", "type": "ROUTER", "implementation": "EPSILON_GREEDY",
        "parameters": [{"name": "epsilon", "value": "0.3", "type": "FLOAT"},
                       {"name": "seed", "value": "5", "type": "INT"}],
        "children": [
            {"name": "a", "type": "MODEL", "implementation": "JAX_MODEL",
             "parameters": [{"name": "model", "value": "iris_logistic", "type": "STRING"}]},
            {"name": "b", "type": "MODEL", "implementation": "JAX_MODEL",
             "parameters": [{"name": "model", "value": "iris_mlp", "type": "STRING"}]}]}}]}}
    path = tmp_path / "eg.json"
    path.write_text(json.dumps(dep))
    return path


async def test_feedback_over_the_fast_ingress_moves_the_router_as_jax(tmp_path):
    path = _eg_deployment(tmp_path)
    server, jservice = _port_server(path), _jax_service(path)
    await server.start("127.0.0.1", 0)
    jserver = await jax_start_fast_server(jax_engine_routes(jservice, {"paused": False}), "127.0.0.1", 0)
    jport = jserver.sockets[0].getsockname()[1]
    rewards = np.random.default_rng(1).uniform(size=12)
    try:
        for r in rewards:
            req = json.dumps({"data": {"ndarray": _iris_rows(1, 0).tolist()}}).encode()
            outs = []
            for port in (server.port, jport):
                s, _, b = await _http(port, "/api/v0.1/predictions", req)
                assert s == 200
                resp = json.loads(b)
                fb = json.dumps({"request": json.loads(req), "response": resp, "reward": float(r)}).encode()
                fs, _, fbody = await _http(port, "/api/v0.1/feedback", fb)
                assert fs == 200 and json.loads(fbody)["meta"]["puid"]
                outs.append(resp["meta"]["routing"])
            assert outs[0] == outs[1]
        bad = await _http(server.port, "/api/v0.1/feedback", b"{nope")
    finally:
        await server.stop()
        jserver.close()
        await jserver.wait_closed()
    assert bad[0] == 400 and json.loads(bad[2])["code"] == 101
    router, jrouter = server.executor.root.unit, jservice.executor.root.unit
    assert router.counts == jrouter.counts and sum(router.counts) == len(rewards)
    np.testing.assert_allclose(router.rewards, jrouter.rewards, rtol=0, atol=1e-12)


@pytest.mark.parametrize(
    "axes,want",
    [({"data": 8}, {"data": 1}), ({"data": 1}, None), ({}, None), ({"data": 2, "model": 4}, ValueError),
     ({"model": 2}, ValueError)],
)
def test_mesh_rule_matches_jax_on_one_device(axes, want):
    device = jax.devices()[:1]
    if want is ValueError:
        with pytest.raises(ValueError, match="needs"):
            mesh_from_spec(axes, n_devices=1)
        with pytest.raises(ValueError, match="needs"):
            jax_mesh_from_spec(axes, devices=device)
        return
    got = mesh_from_spec(axes, n_devices=1)
    ref = jax_mesh_from_spec(axes, devices=device)
    assert got == want and (ref is None if want is None else dict(ref.shape) == want)


def test_server_refuses_a_mesh_one_device_cannot_hold():
    predictor, name = load_predictor(str(REPO / "examples" / "deployments" / "full_dag_bert.json"))
    with pytest.raises(ValueError, match="needs 8 devices"):
        PredictorServer(predictor, deployment_name=name, device="cpu")
