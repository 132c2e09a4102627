"""Two parts of the reference's engine wire the port serves as the JAX
engine does (``seldon_core_tpu/serving/fast_http.py``, ``wire.py``), each
request sent to both packages' fast ingresses and the answers compared:

- ``/pause`` and ``/unpause``, for GET and POST: text bodies ``paused`` and
  ``unpaused`` with 200, after which ``/ready`` answers 503 ``paused``, then
  200 ``ready`` again;
- the reference's ``json=`` form field, in an urlencoded or a multipart
  body, on ``/api/v0.1/predictions``, ``/api/v0.1/predictions/stream`` and
  ``/api/v0.1/feedback``: the same answer as the JSON body, and a form
  without the field (or with a field that is not JSON) answers 400 with
  code 101 and the JAX engine's reason.
"""

import asyncio
import json
from pathlib import Path
from urllib.parse import urlencode

import jax
import numpy as np
import pytest

from seldon_core_tpu.engine import build_executor as jax_build_executor
from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictorSpec
from seldon_core_tpu.serving.fast_http import engine_routes as jax_engine_routes
from seldon_core_tpu.serving.fast_http import start_fast_server as jax_start_fast_server
from seldon_core_tpu.serving.service import PredictionService as JaxPredictionService
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

DEPLOYMENTS = Path(__file__).resolve().parents[1] / "seldon_core_tpu_torch" / "deployments"
BOUNDARY = "seldonformboundary"
IRIS_ROWS = [[5.1, 3.5, 1.4, 0.2], [6.7, 3.0, 5.2, 2.3]]


async def _http(port, method, path, body=b"", ctype="application/json"):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(
            f"{method} {path} HTTP/1.1\r\nHost: t\r\nContent-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode() + body
        )
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, _, v in (ln.partition(":") for ln in lines[1:])}
    if headers.get("transfer-encoding") == "chunked":
        payload = _dechunk(payload)
    return int(lines[0].split(" ")[1]), payload


def _dechunk(raw: bytes) -> bytes:
    out = b""
    while raw:
        size, _, rest = raw.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            break
        out, raw = out + rest[:n], rest[n + 2:]
    return out


def _carry_weights(node, jax_node):
    """Give each port model the JAX package's parameters (the small zoo
    models draw with jax.random there, with numpy here)."""
    rt, jrt = getattr(node.unit, "runtime", None), getattr(jax_node.unit, "runtime", None)
    if rt is not None:
        host = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jrt.params)
        rt.params = params_to_torch(host, rt.device, rt.dtype)
    for c, jc in zip(node.children, jax_node.children):
        _carry_weights(c, jc)


async def _both(name: str, requests):
    """Each (method, path, body, content type) to the port's and the JAX
    engine's fast ingress for one deployment, in turn: two lists of
    (status, body)."""
    path = DEPLOYMENTS / f"{name}.json"
    predictor, dep = load_predictor(str(path))
    server = PredictorServer(predictor, deployment_name=dep, device="cpu")
    obj = json.loads(path.read_text())
    jservice = JaxPredictionService(jax_build_executor(JaxPredictorSpec.model_validate(obj["spec"]["predictors"][0])),
                                    deployment_name=obj["spec"]["name"])
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
    return ours, theirs


@pytest.mark.parametrize("method", ["GET", "POST"])
async def test_pause_and_unpause_like_jax(method):
    requests = [("GET", "/ready"), (method, "/pause"), ("GET", "/ready"), (method, "/unpause"), ("GET", "/ready")]
    ours, theirs = await _both("iris", requests)
    assert ours == theirs
    assert ours == [(200, b"ready"), (200, b"paused"), (503, b"paused"), (200, b"unpaused"), (200, b"ready")]


def _form(obj, encoding: str, field: str = "json") -> tuple[bytes, str]:
    """A body carrying ``obj`` (a dict, or raw text) in the form field."""
    text = obj if isinstance(obj, str) else json.dumps(obj)
    if encoding == "urlencoded":
        return urlencode({field: text}).encode(), "application/x-www-form-urlencoded"
    body = (f"--{BOUNDARY}\r\nContent-Disposition: form-data; name=\"{field}\"\r\n\r\n{text}\r\n"
            f"--{BOUNDARY}--\r\n").encode()
    return body, f"multipart/form-data; boundary={BOUNDARY}"


def _probs(body: bytes) -> np.ndarray:
    return np.asarray(json.loads(body)["data"]["ndarray"], np.float64)


@pytest.mark.parametrize("encoding", ["urlencoded", "multipart"])
async def test_form_predictions_like_jax(encoding):
    """A ``json=`` prediction answers as its JSON body does, on both
    engines (the port's weights carried from the JAX package's)."""
    msg = {"data": {"ndarray": IRIS_ROWS}}
    ours, theirs = await _both("iris", [("POST", "/api/v0.1/predictions", json.dumps(msg).encode()),
                                        ("POST", "/api/v0.1/predictions", *_form(msg, encoding))])
    assert [s for s, _ in ours] == [s for s, _ in theirs] == [200, 200]
    np.testing.assert_array_equal(_probs(ours[1][1]), _probs(ours[0][1]))
    np.testing.assert_allclose(_probs(ours[1][1]), _probs(theirs[1][1]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("encoding", ["urlencoded", "multipart"])
async def test_form_feedback_like_jax(encoding):
    """A ``json=`` feedback reaches the router as its JSON body does."""
    fb = {"request": {"data": {"ndarray": IRIS_ROWS[:1]}},
          "response": {"meta": {"routing": {"ab": 1}}, "data": {"ndarray": [[0.1, 0.2, 0.7]]}}, "reward": 1.0}
    ours, theirs = await _both("iris_abtest", [("POST", "/api/v0.1/feedback", json.dumps(fb).encode()),
                                               ("POST", "/api/v0.1/feedback", *_form(fb, encoding))])
    assert [s for s, _ in ours] == [s for s, _ in theirs] == [200, 200]
    strip = lambda b: {k: v for k, v in json.loads(b).items() if k != "meta"}  # noqa: E731 - puids differ
    assert strip(ours[1][1]) == strip(ours[0][1]) == strip(theirs[1][1])


def _sse(body: bytes) -> list:
    return [json.loads(line[len(b"data: "):]) for line in body.split(b"\n\n") if line.startswith(b"data: ")]


@pytest.mark.parametrize("encoding", ["urlencoded", "multipart"])
async def test_form_stream_like_jax(encoding):
    """A ``json=`` body on the SSE route streams what its JSON body does:
    ``tiny_gpt`` (the fused generate, the same numpy weights in both
    packages) ends in a done event with the same ids on both engines."""
    ids = np.random.default_rng(3).integers(0, 512, (1, 32)).tolist()
    msg = {"data": {"ndarray": ids}}
    ours, theirs = await _both("tiny_gpt", [("POST", "/api/v0.1/predictions/stream", json.dumps(msg).encode()),
                                            ("POST", "/api/v0.1/predictions/stream", *_form(msg, encoding))])
    assert [s for s, _ in ours] == [s for s, _ in theirs] == [200, 200]
    done = [next(e for e in _sse(b) if e.get("done")) for _, b in ours + theirs]
    assert len({json.dumps(d["ids"]) for d in done}) == 1 and len(done[0]["ids"][0]) == 48


ROUTES = ("/api/v0.1/predictions", "/api/v0.1/predictions/stream", "/api/v0.1/feedback")
BAD_FORMS = {
    "urlencoded_without_json": lambda: _form({"data": {"ndarray": IRIS_ROWS}}, "urlencoded", field="payload"),
    "multipart_without_json": lambda: _form({"data": {"ndarray": IRIS_ROWS}}, "multipart", field="payload"),
    "urlencoded_field_not_json": lambda: _form("{not json", "urlencoded"),
    "multipart_field_not_json": lambda: _form("{not json", "multipart"),
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("form", sorted(BAD_FORMS))
async def test_bad_form_bodies_answer_like_jax(route, form):
    """A form without the ``json`` field, or whose field is not JSON,
    answers 400 code 101 with the JAX engine's status body."""
    ours, theirs = await _both("iris_abtest", [("POST", route, *BAD_FORMS[form]())])
    (status, body), (jstatus, jbody) = ours[0], theirs[0]
    assert status == jstatus == 400
    got, want = json.loads(body), json.loads(jbody)
    assert got == want and got["code"] == 101 and got["status"] == "FAILURE"
    if form.endswith("without_json"):
        assert got["info"] == "missing 'json' form field"

