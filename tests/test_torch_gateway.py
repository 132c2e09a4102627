"""The port's OAuth gateway (``seldon_core_tpu_torch/gateway/``, served by
``serving/fast_http.py::gateway_routes``) against the JAX package's, on
the CPU:

- every REST case of ``tests/test_gateway.py`` on the port: the token and
  prediction round trip with its audit record, bad credentials, the
  missing token's error shape, a removed deployment, the file token store
  across a restart, key rotation, the npy binary path with OAuth, and
  ``RemoteBackend``'s JSON and npy hop (its 5xx retry and the engine's
  status-JSON codes passed through);
- ``test_fast_gateway_oauth_flow_matches_aiohttp_app`` of
  ``tests/test_fast_http.py``: the port's gateway and the JAX aiohttp
  gateway app answer the same requests alike;
- lockstep: one request sequence (a token by Basic auth, by an urlencoded
  and by a multipart form; predictions; a feedback; each refusal) through
  the JAX gateway and the port's, both serving ``iris`` (iris_logistic)
  with the JAX parameters carried across: equal status codes and error
  bodies, probabilities within 1e-5 (float32);
- gRPC (``tests/test_gateway.py``'s gRPC gateway and
  ``tests/test_fast_http.py``'s gRPC-Web cases): the gRPC gateway in both
  modes (a missing token a 205 failure message, a token served and
  audited), gRPC-Web on the gateway's fast ingress answering as native
  gRPC does (both package spellings, a bad token inside grpc-status:0,
  malformed framing grpc-status:3, the CORS preflight, feedback), random
  bodies always framed, and the same gRPC-Web response bytes as the JAX
  wire for the same deterministic answers.
"""

import asyncio
import base64
import json
import re
from pathlib import Path
from urllib.parse import urlencode

import jax
import numpy as np
import pytest

from seldon_core_tpu.engine import build_executor as jax_build_executor
from seldon_core_tpu.gateway.app import Gateway as JaxGateway
from seldon_core_tpu.gateway.app import InProcessBackend as JaxInProcessBackend
from seldon_core_tpu.gateway.app import build_gateway_app as jax_build_gateway_app
from seldon_core_tpu.gateway.oauth import OAuthProvider as JaxOAuthProvider
from seldon_core_tpu.gateway.store import DeploymentStore as JaxDeploymentStore
from seldon_core_tpu.graph.spec import DeploymentSpec as JaxDeploymentSpec
from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictorSpec
from seldon_core_tpu.serving.fast_http import gateway_routes as jax_gateway_routes
from seldon_core_tpu.serving.fast_http import start_fast_server as jax_start_fast_server
from seldon_core_tpu.serving.service import PredictionService as JaxPredictionService
from seldon_core_tpu_torch.core.codec_npy import array_from_npy, is_npy, npy_from_array
from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import SeldonMessage
from seldon_core_tpu_torch.engine.executor import build_executor
from seldon_core_tpu_torch.gateway import (
    DeploymentStore,
    FileTokenStore,
    Gateway,
    InProcessBackend,
    MemoryAuditSink,
    OAuthProvider,
    RemoteBackend,
)
from seldon_core_tpu_torch.graph.spec import DeploymentSpec, PredictorSpec
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.serving.fast_http import engine_routes, gateway_routes, start_fast_server
from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor
from seldon_core_tpu_torch.serving.service import PredictionService

DEPLOYMENTS = Path(__file__).resolve().parents[1] / "seldon_core_tpu_torch" / "deployments"
SIMPLE = {"name": "default", "graph": {"name": "simple-model", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}


async def _http(port, method, path, body=b"", headers=None):
    """One request on its own connection: (status, lower-case headers, body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write(
            f"{method} {path} HTTP/1.1\r\nHost: t\r\nContent-Length: {len(body)}\r\n{extra}"
            f"Connection: close\r\n\r\n".encode() + body
        )
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    hdrs = {k.strip().lower(): v.strip() for k, _, v in (ln.partition(":") for ln in lines[1:])}
    return int(lines[0].split(" ")[1]), hdrs, payload


def _form(**fields) -> tuple[bytes, dict]:
    return urlencode(fields).encode(), {"Content-Type": "application/x-www-form-urlencoded"}


def _service():
    return PredictionService(build_executor(PredictorSpec.from_dict(SIMPLE)), deployment_name="dep1")


def _gateway(audit=None):
    oauth = OAuthProvider()
    store = DeploymentStore(oauth=oauth)
    backend = InProcessBackend()
    gw = Gateway(store=store, oauth=oauth, backend=backend, audit=audit)
    store.deployment_added(DeploymentSpec(name="dep1", oauth_key="oauth-key-1", oauth_secret="oauth-secret-1"))
    backend.register("dep1", _service())
    return gw


class _Served:
    """The port's gateway on a free port for one test."""

    def __init__(self, gw):
        self.gw = gw

    async def __aenter__(self):
        self.server = await start_fast_server(gateway_routes(self.gw), "127.0.0.1", 0)
        self.port = self.server.sockets[0].getsockname()[1]
        return self

    async def __aexit__(self, *exc):
        self.server.close()
        await self.server.wait_closed()

    async def token(self, key="oauth-key-1", secret="oauth-secret-1"):
        body, headers = _form(grant_type="client_credentials", client_id=key, client_secret=secret)
        status, _, raw = await _http(self.port, "POST", "/oauth/token", body, headers)
        assert status == 200, raw
        out = json.loads(raw)
        assert out["token_type"] == "bearer"
        assert out["expires_in"] == 12 * 3600  # the reference's 12 h tokens
        return out["access_token"]

    async def predict(self, payload, token=None):
        headers = {"Content-Type": "application/json"}
        if token:
            headers["Authorization"] = f"Bearer {token}"
        status, _, raw = await _http(self.port, "POST", "/api/v0.1/predictions", json.dumps(payload).encode(), headers)
        return status, json.loads(raw)


async def test_token_and_predict_roundtrip():
    audit = MemoryAuditSink()
    async with _Served(_gateway(audit=audit)) as s:
        token = await s.token()
        status, body = await s.predict({"data": {"ndarray": [[1.0, 2.0, 3.0]]}}, token)
        assert status == 200, body
        np.testing.assert_allclose(body["data"]["ndarray"], [[0.1, 0.9, 0.5]], rtol=1e-6)
        # the (request, response) pair went to the client's topic
        (record,) = audit.topics["oauth-key-1"]
        assert record["request"]["data"]["ndarray"] == [[1.0, 2.0, 3.0]]
        assert record["response"]["data"] == body["data"]


async def test_bad_credentials_rejected():
    async with _Served(_gateway()) as s:
        body, headers = _form(client_id="oauth-key-1", client_secret="wrong")
        status, _, raw = await _http(s.port, "POST", "/oauth/token", body, headers)
        assert status == 401
        assert json.loads(raw)["error"] == "invalid_client"


async def test_missing_token_gives_reference_error_shape():
    async with _Served(_gateway()) as s:
        status, body = await s.predict({"data": {"ndarray": [[1.0]]}})
        assert status == 401
        assert body["code"] == 205  # APIFE_GRPC_NO_PRINCIPAL_FOUND
        assert body["status"] == "FAILURE"


async def test_removed_deployment_gives_no_running_deployment():
    gw = _gateway()
    async with _Served(gw) as s:
        token = await s.token()
        gw.store.deployment_removed("dep1")
        # the client and its tokens go with the deployment
        status, body = await s.predict({"data": {"ndarray": [[1.0]]}}, token)
        assert status == 401 and body["code"] == 205
        # a principal whose deployment is gone while its token lives
        gw.store.deployment_added(DeploymentSpec(name="dep1", oauth_key="oauth-key-1", oauth_secret="oauth-secret-1"))
        token = await s.token()
        gw.store._by_key.clear()
        status, body = await s.predict({"data": {"ndarray": [[1.0]]}}, token)
        assert status == 500 and body["code"] == ErrorCode.APIFE_NO_RUNNING_DEPLOYMENT.code


def test_file_token_store_survives_restart(tmp_path):
    path = str(tmp_path / "tokens.json")
    oauth1 = OAuthProvider(token_store=FileTokenStore(path))
    oauth1.add_client("c1", "s1")
    token = oauth1.issue_token("c1", "s1")["access_token"]
    oauth1.add_client("c2", "s2")
    revoked = oauth1.issue_token("c2", "s2")["access_token"]
    oauth1.remove_client("c2")
    # a fresh provider over the same file still honours the live token, and
    # the compaction on load keeps only it
    oauth2 = OAuthProvider(token_store=FileTokenStore(path))
    assert oauth2.principal(token) == "c1"
    assert oauth2.principal(revoked) is None
    assert len((tmp_path / "tokens.json").read_text().splitlines()) == 1


def test_oauth_key_rotation_revokes_old_key():
    oauth = OAuthProvider()
    store = DeploymentStore(oauth=oauth)
    store.deployment_added(DeploymentSpec(name="d", oauth_key="old", oauth_secret="s"))
    token = oauth.issue_token("old", "s")["access_token"]
    assert store.by_principal("old") is not None
    store.deployment_added(DeploymentSpec(name="d", oauth_key="new", oauth_secret="s2"))
    assert store.by_principal("old") is None  # the retired key no longer routes
    assert oauth.principal(token) is None  # its tokens are revoked
    with pytest.raises(PermissionError):
        oauth.issue_token("old", "s")  # and it mints no more
    assert store.by_principal("new") is not None


async def test_gateway_npy_binary_path_with_oauth():
    async with _Served(_gateway()) as s:
        token = await s.token()
        status, headers, raw = await _http(
            s.port, "POST", "/api/v0.1/predictions", npy_from_array(np.ones((2, 4), np.float32)),
            {"Content-Type": "application/x-npy", "Authorization": f"Bearer {token}"},
        )
        assert status == 200
        assert headers["content-type"] == "application/x-npy"
        np.testing.assert_allclose(array_from_npy(raw), [[0.1, 0.9, 0.5]] * 2, rtol=1e-6)
        assert json.loads(headers["seldon-meta"])["puid"]


async def test_remote_backend_json_and_binary_npy_hop():
    """The gateway-to-engine network hop: a JSON predict round-trips, an
    npy predict forwards the raw body and gets its meta back from the
    Seldon-Meta header; a 5xx is retried once; an engine's status-JSON 4xx
    passes through with its own code."""
    engine = await start_fast_server(engine_routes(_service(), {"paused": False}), "127.0.0.1", 0)
    port = engine.sockets[0].getsockname()[1]
    backend = RemoteBackend(resolve=lambda d: f"http://127.0.0.1:{port}")
    dep = DeploymentSpec(name="dep1")
    try:
        from seldon_core_tpu_torch.core.codec_json import message_from_dict

        out = await backend.predict(dep, message_from_dict({"data": {"ndarray": [[1.0, 2.0, 3.0, 4.0]]}}))
        assert out.array.shape[0] == 1
        out2 = await backend.predict(dep, SeldonMessage(bin_data=npy_from_array(np.ones((2, 4), np.float32))),
                                     wire_npy=True)
        assert is_npy(out2.bin_data)  # binary end to end
        assert array_from_npy(out2.bin_data).shape[0] == 2
        assert out2.meta.puid  # from the Seldon-Meta header
    finally:
        await backend.close()
        engine.close()
        await engine.wait_closed()

    hits = []

    async def flaky(req):
        from seldon_core_tpu_torch.serving.wire import WireResponse

        hits.append(req.path)
        if len(hits) == 1:
            return WireResponse(status=500, body=b"boom")
        if len(hits) == 2:
            return WireResponse.json({"data": {"ndarray": [[1.0]]}})
        return WireResponse.json({"code": 101, "info": "bad", "reason": "Invalid JSON", "status": "FAILURE"},
                                 status=400)

    server = await start_fast_server({("POST", "/api/v0.1/predictions"): flaky}, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    backend = RemoteBackend(resolve=lambda d: f"http://127.0.0.1:{port}")
    try:
        out = await backend.predict(dep, SeldonMessage.from_array(np.ones((1, 1), np.float32)))
        assert out.array.tolist() == [[1.0]] and len(hits) == 2  # the 5xx was retried once
        with pytest.raises(APIException) as err:
            await backend.predict(dep, SeldonMessage.from_array(np.ones((1, 1), np.float32)))
        assert err.value.error is ErrorCode.ENGINE_INVALID_JSON and len(hits) == 3  # a 4xx is not retried
    finally:
        await backend.close()
        server.close()
        await server.wait_closed()


def _jax_gateway(predictor_obj: dict, name: str, key: str, secret: str):
    oauth = JaxOAuthProvider()
    store = JaxDeploymentStore(oauth=oauth)
    backend = JaxInProcessBackend()
    gw = JaxGateway(store=store, oauth=oauth, backend=backend)
    service = JaxPredictionService(jax_build_executor(JaxPredictorSpec.model_validate(predictor_obj)),
                                   deployment_name=name)
    store.deployment_added(JaxDeploymentSpec(name=name, oauth_key=key, oauth_secret=secret))
    backend.register(name, service)
    return gw, service


async def test_fast_gateway_oauth_flow_matches_aiohttp_app():
    """The port's gateway and the JAX package's aiohttp gateway app answer
    the same requests alike (up to the per-request puid)."""
    from aiohttp.test_utils import TestClient, TestServer

    jgw, _ = _jax_gateway(SIMPLE, "dep1", "k1", "s1")
    oauth = OAuthProvider()
    store = DeploymentStore(oauth=oauth)
    backend = InProcessBackend()
    gw = Gateway(store=store, oauth=oauth, backend=backend)
    store.deployment_added(DeploymentSpec(name="dep1", oauth_key="k1", oauth_secret="s1"))
    backend.register("dep1", _service())
    aio = TestClient(TestServer(jax_build_gateway_app(jgw)))
    await aio.start_server()
    try:
        async with _Served(gw) as s:
            token = await s.token("k1", "s1")
            jtoken = jgw.oauth.issue_token("k1", "s1")["access_token"]
            body = json.dumps({"data": {"ndarray": [[1.0, 2.0, 3.0]]}}).encode()
            status, _, fast_body = await _http(s.port, "POST", "/api/v0.1/predictions", body,
                                               {"Content-Type": "application/json",
                                                "Authorization": f"Bearer {token}"})
            resp = await aio.post("/api/v0.1/predictions", data=body,
                                  headers={"Content-Type": "application/json", "Authorization": f"Bearer {jtoken}"})
            assert (status, resp.status) == (200, 200)
            np.testing.assert_allclose(json.loads(fast_body)["data"]["ndarray"],
                                       (await resp.json())["data"]["ndarray"], rtol=1e-6)
            for auth in ("Bearer nope", ""):
                headers = {"Content-Type": "application/json"}
                if auth:
                    headers["Authorization"] = auth
                status, _, fast_err = await _http(s.port, "POST", "/api/v0.1/predictions", body, headers)
                resp = await aio.post("/api/v0.1/predictions", data=body, headers=headers)
                assert status == resp.status == 401
                assert json.loads(fast_err) == await resp.json()
    finally:
        await aio.close()


BOUNDARY = "gatewayformboundary"


def _multipart(fields: dict) -> tuple[bytes, dict]:
    parts = b"".join(
        f'--{BOUNDARY}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
        for k, v in fields.items()
    )
    return parts + f"--{BOUNDARY}--\r\n".encode(), {"Content-Type": f"multipart/form-data; boundary={BOUNDARY}"}


def _carry_weights(node, jax_node):
    rt, jrt = getattr(node.unit, "runtime", None), getattr(jax_node.unit, "runtime", None)
    if rt is not None:
        rt.params = params_to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32), jrt.params), rt.device,
                                    rt.dtype)
    for c, jc in zip(node.children, jax_node.children):
        _carry_weights(c, jc)


def _lockstep_requests(token_ok: str, token_bad: str):
    """(label, method, path, body, headers) of the sequence, given the
    tokens the first exchanges will issue (filled in as they come)."""
    rows = {"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2], [6.7, 3.0, 5.2, 2.3]]}}
    js = {"Content-Type": "application/json"}
    return [
        ("predict", "POST", "/api/v0.1/predictions", json.dumps(rows).encode(),
         {**js, "Authorization": f"Bearer {token_ok}"}),
        ("predict form", "POST", "/api/v0.1/predictions",
         *(lambda b, h: (b, {**h, "Authorization": f"Bearer {token_ok}"}))(*_form(json=json.dumps(rows)))),
        ("feedback", "POST", "/api/v0.1/feedback",
         json.dumps({"request": rows, "response": {"meta": {}}, "reward": 1.0}).encode(),
         {**js, "Authorization": f"Bearer {token_ok}"}),
        ("no token", "POST", "/api/v0.1/predictions", json.dumps(rows).encode(), js),
        ("bad token", "POST", "/api/v0.1/predictions", json.dumps(rows).encode(),
         {**js, "Authorization": "Bearer not-a-token"}),
        ("bad json", "POST", "/api/v0.1/predictions", b"{not json", {**js, "Authorization": f"Bearer {token_ok}"}),
        ("form without json", "POST", "/api/v0.1/predictions",
         *(lambda b, h: (b, {**h, "Authorization": f"Bearer {token_ok}"}))(*_form(other="1"))),
        ("feedback no token", "POST", "/api/v0.1/feedback", b"{}", js),
        ("removed deployment", "POST", "/api/v0.1/predictions", json.dumps(rows).encode(),
         {**js, "Authorization": f"Bearer {token_bad}"}),
    ]


async def test_lockstep_with_the_jax_gateway_on_iris():
    path = DEPLOYMENTS / "iris.json"
    obj = json.loads(path.read_text())
    key, secret = obj["spec"]["oauth_key"], obj["spec"]["oauth_secret"]
    predictor, dep = load_predictor(str(path))
    server = PredictorServer(predictor, deployment_name=dep, device="cpu")
    jgw, jservice = _jax_gateway(obj["spec"]["predictors"][0], dep, key, secret)
    _carry_weights(server.executor.root, jservice.executor.root)
    oauth = OAuthProvider()
    store = DeploymentStore(oauth=oauth)
    backend = InProcessBackend()
    gw = Gateway(store=store, oauth=oauth, backend=backend)
    store.deployment_added(DeploymentSpec(name=dep, oauth_key=key, oauth_secret=secret, predictors=(predictor,)))
    backend.register(dep, server.service)
    # a second client whose deployment the store forgets while its token lives
    for g in (gw, jgw):
        g.oauth.add_client("orphan", "orphan-secret")
    jserver = await jax_start_fast_server(jax_gateway_routes(jgw), "127.0.0.1", 0)
    jport = jserver.sockets[0].getsockname()[1]
    try:
        async with _Served(gw) as s:
            tokens = {}
            basic = base64.b64encode(f"{key}:{secret}".encode()).decode()
            token_requests = [
                ("basic", b"grant_type=client_credentials",
                 {"Authorization": f"Basic {basic}", "Content-Type": "application/x-www-form-urlencoded"}),
                ("form", *_form(grant_type="client_credentials", client_id=key, client_secret=secret)),
                ("multipart", *_multipart({"grant_type": "client_credentials", "client_id": key,
                                           "client_secret": secret})),
                ("wrong secret", *_form(grant_type="client_credentials", client_id=key, client_secret="nope")),
                ("orphan", *_form(grant_type="client_credentials", client_id="orphan",
                                  client_secret="orphan-secret")),
            ]
            for label, body, headers in token_requests:
                ours = await _http(s.port, "POST", "/oauth/token", body, headers)
                theirs = await _http(jport, "POST", "/oauth/token", body, headers)
                assert ours[0] == theirs[0], label
                o, t = json.loads(ours[2]), json.loads(theirs[2])
                if ours[0] == 200:
                    assert o.keys() == t.keys() and o["expires_in"] == t["expires_in"], label
                    tokens[label] = (o["access_token"], t["access_token"])
                else:
                    assert o == t == {"error": "invalid_client", "error_description": "Bad client credentials"}, label
            assert set(tokens) == {"basic", "form", "multipart", "orphan"}
            ours_seq = _lockstep_requests(tokens["multipart"][0], tokens["orphan"][0])
            theirs_seq = _lockstep_requests(tokens["multipart"][1], tokens["orphan"][1])
            for (label, method, p, body, headers), (_, _, _, jbody, jheaders) in zip(ours_seq, theirs_seq):
                ours = await _http(s.port, method, p, body, headers)
                theirs = await _http(jport, method, p, jbody, jheaders)
                assert ours[0] == theirs[0], (label, ours, theirs)
                o, t = json.loads(ours[2]), json.loads(theirs[2])
                if ours[0] != 200:
                    if label == "bad json":  # the parsers' messages differ; code and reason do not
                        o.pop("info"), t.pop("info")
                    assert o == t, label
                elif "data" in t:
                    np.testing.assert_allclose(np.asarray(o["data"]["ndarray"], np.float32),
                                               np.asarray(t["data"]["ndarray"], np.float32), atol=1e-5)
                    assert o["data"]["names"] == t["data"]["names"]
    finally:
        jserver.close()
        await jserver.wait_closed()


# ------------------------------------------------------------------ gRPC


def _web_frames(body: bytes) -> list:
    frames, i = [], 0
    while i < len(body):
        n = int.from_bytes(body[i + 1:i + 5], "big")
        frames.append((body[i], body[i + 5:i + 5 + n]))
        i += 5 + n
    return frames


def _tensor_pb(values):
    from seldon_core_tpu_torch.proto import prediction_pb2 as pb

    req = pb.SeldonMessage()
    req.data.tensor.shape.extend([1, len(values)])
    req.data.tensor.values.extend(values)
    return req


@pytest.mark.parametrize("mode", ["aio", "sync"])
async def test_grpc_gateway_auth_and_predict(mode):
    """Both ingress modes (grpc.aio, and the C-core server bridging each
    call into the loop) serve the same auth, predict, audit and feedback
    contract as the JAX gateway."""
    import grpc

    from seldon_core_tpu_torch.gateway.grpc_gateway import start_gateway_grpc
    from seldon_core_tpu_torch.proto import prediction_pb2 as pb
    from seldon_core_tpu_torch.proto.services import ServiceStub

    audit = MemoryAuditSink()
    gw = _gateway(audit=audit)
    token = gw.oauth.issue_token("oauth-key-1", "oauth-secret-1")["access_token"]
    server = await start_gateway_grpc(gw, host="127.0.0.1", port=0, mode=mode)
    try:
        async with grpc.aio.insecure_channel(f"127.0.0.1:{server.bound_port}") as channel:
            stub = ServiceStub(channel, "Seldon")
            req = pb.SeldonMessage()
            req.data.ndarray.values.add().list_value.values.add().number_value = 1.0
            for md in ((), (("oauth_token", "not-a-token"),)):
                resp = await stub.Predict(req, metadata=md)
                assert resp.status.code == 205 and resp.status.status == pb.Status.FAILURE
            resp = await stub.Predict(req, metadata=(("oauth_token", token),))
            assert not resp.HasField("status")
            np.testing.assert_allclose([v.number_value for v in resp.data.ndarray.values[0].list_value.values],
                                       [0.1, 0.9, 0.5], rtol=1e-6)
            (record,) = audit.topics["oauth-key-1"]
            assert record["request"]["data"]["ndarray"] == [[1.0]]
            fb = pb.Feedback(reward=1.0)
            ack = await ServiceStub(channel, "Seldon", package="seldon.protos").SendFeedback(
                fb, metadata=(("oauth_token", token),))
            assert not ack.HasField("status")
            assert (await stub.SendFeedback(fb)).status.code == 205
    finally:
        await server.stop(None)
    with pytest.raises(ValueError, match="'sync' or 'aio'"):
        await start_gateway_grpc(gw, "127.0.0.1", 0, mode="threads")


async def test_grpc_web_predict_on_fast_ingress_matches_native_grpc():
    """gRPC-Web Seldon.Predict rides the gateway's fast ingress with the
    native gateway's semantics: oauth_token as a header, proto in and out,
    application failures inside the SeldonMessage."""
    import grpc

    from seldon_core_tpu_torch.gateway.grpc_gateway import start_gateway_grpc
    from seldon_core_tpu_torch.proto import prediction_pb2 as pb
    from seldon_core_tpu_torch.proto.services import ServiceStub
    from seldon_core_tpu_torch.serving.wire import grpc_web_frame

    gw = _gateway()
    token = gw.oauth.issue_token("oauth-key-1", "oauth-secret-1")["access_token"]
    req = _tensor_pb([1.0, 2.0, 3.0])
    raw = req.SerializeToString()
    web = {"Content-Type": "application/grpc-web+proto", "oauth_token": token}
    native = await start_gateway_grpc(gw, "127.0.0.1", 0)
    try:
        async with _Served(gw) as s:
            st, hdrs, body = await _http(s.port, "POST", "/seldon.tpu.Seldon/Predict", grpc_web_frame(0, raw), web)
            assert st == 200 and hdrs["content-type"] == "application/grpc-web+proto"
            assert hdrs["access-control-allow-origin"] == "*"
            frames = _web_frames(body)
            assert [f for f, _ in frames] == [0, 0x80] and b"grpc-status:0" in frames[1][1]
            out = pb.SeldonMessage.FromString(frames[0][1])
            async with grpc.aio.insecure_channel(f"127.0.0.1:{native.bound_port}") as ch:
                native_out = await ServiceStub(ch, "Seldon").Predict(req, metadata=(("oauth_token", token),))
            assert out.data.tensor.values == native_out.data.tensor.values
            assert list(out.data.names) == list(native_out.data.names)
            st, _, body = await _http(s.port, "POST", "/seldon.protos.Seldon/Predict", grpc_web_frame(0, raw), web)
            assert st == 200 and pb.SeldonMessage.FromString(_web_frames(body)[0][1]).data.tensor.values == \
                out.data.tensor.values
            # the Bearer header serves too; a bad oauth_token is a 205 failure under grpc-status:0
            st, _, body = await _http(s.port, "POST", "/seldon.tpu.Seldon/Predict", grpc_web_frame(0, raw),
                                      {"Content-Type": "application/grpc-web+proto",
                                       "Authorization": f"Bearer {token}"})
            assert st == 200 and not pb.SeldonMessage.FromString(_web_frames(body)[0][1]).HasField("status")
            st, _, body = await _http(s.port, "POST", "/seldon.tpu.Seldon/Predict", grpc_web_frame(0, raw),
                                      {**web, "oauth_token": "bad"})
            (f0, fail), (f1, trailer) = _web_frames(body)
            assert st == 200 and pb.SeldonMessage.FromString(fail).status.code == 205 and b"grpc-status:0" in trailer
            # malformed framing: trailers only, grpc-status 3, the message percent-encoded
            st, _, body = await _http(s.port, "POST", "/seldon.tpu.Seldon/Predict", b"\x00\x00\x00", web)
            ((flags, trailer),) = _web_frames(body)
            assert st == 200 and flags == 0x80 and b"grpc-status:3" in trailer and trailer.count(b"\r\n") == 2
            # CORS preflight: 204 with no body
            st, hdrs, body = await _http(s.port, "OPTIONS", "/seldon.tpu.Seldon/Predict", b"",
                                         {"Origin": "http://app.example", "Access-Control-Request-Method": "POST",
                                          "Access-Control-Request-Headers": "content-type,oauth_token"})
            assert st == 204 and body == b"" and "content-length" not in hdrs
            assert hdrs["access-control-allow-origin"] == "*" and "oauth_token" in hdrs["access-control-allow-headers"]
            fb = pb.Feedback(reward=1.0)
            fb.request.CopyFrom(req)
            fb.response.meta.routing["r"] = 0
            st, _, body = await _http(s.port, "POST", "/seldon.tpu.Seldon/SendFeedback",
                                      grpc_web_frame(0, fb.SerializeToString()), web)
            frames = _web_frames(body)
            assert st == 200 and [f for f, _ in frames] == [0, 0x80] and b"grpc-status:0" in frames[1][1]
    finally:
        await native.stop(None)


async def test_grpc_web_fuzz_never_crashes_always_frames():
    """Arbitrary bytes at the gRPC-Web route always come back as a framed
    answer with HTTP 200 and the trailer frame last."""
    import random

    from seldon_core_tpu_torch.serving.wire import grpc_web_frame

    gw = _gateway()
    token = gw.oauth.issue_token("oauth-key-1", "oauth-secret-1")["access_token"]
    rng = random.Random(0)
    bodies = [b"", b"\x00", b"\x80\x00\x00\x00\x00", b"\x01\x00\x00\x00\x00"]
    bodies += [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40))) for _ in range(40)]
    bodies += [grpc_web_frame(0, b"\xff\xfe\xfd"), grpc_web_frame(0, _tensor_pb([1.0]).SerializeToString()) + b"JUNK"]
    async with _Served(gw) as s:
        for body in bodies:
            st, hdrs, resp = await _http(s.port, "POST", "/seldon.tpu.Seldon/Predict", body,
                                         {"Content-Type": "application/grpc-web+proto", "oauth_token": token})
            assert st == 200 and hdrs["content-type"] == "application/grpc-web+proto", body
            frames = _web_frames(resp)
            assert frames and frames[-1][0] == 0x80 and b"grpc-status:" in frames[-1][1], (body, resp)


async def test_grpc_web_bytes_equal_the_jax_wire():
    """The wire helpers and the served deterministic answers (refusals,
    malformed frames) are byte for byte the JAX package's."""
    from seldon_core_tpu.serving import wire as jwire
    from seldon_core_tpu_torch.serving import wire

    assert wire.GRPC_WEB_ROUTES == jwire.GRPC_WEB_ROUTES
    assert wire.GRPC_WEB_CORS_HEADERS == jwire.GRPC_WEB_CORS_HEADERS
    assert wire.GRPC_WEB_CTYPE == jwire.GRPC_WEB_CTYPE
    payload = _tensor_pb([1.0, 2.5]).SerializeToString()
    assert wire.grpc_web_frame(0, payload) == jwire.grpc_web_frame(0, payload)
    for body in (b"", b"\x80\x00\x00\x00\x00", b"\x01\x00\x00\x00\x00", b"\x00\x00\x00\x00\x09ab",
                 wire.grpc_web_frame(0, payload) + b"x", wire.grpc_web_frame(0, payload)):
        try:
            want = jwire.grpc_web_first_message(body)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                wire.grpc_web_first_message(body)
        else:
            assert wire.grpc_web_first_message(body) == want
    for msg in ("plain", "CR\r\nLF and ünïcode %", "invalid grpc-web request: Error parsing message"):
        ours, theirs = wire._grpc_web_error(3, msg), jwire._grpc_web_error(3, msg)
        assert (ours.body, ours.headers, ours.content_type) == (theirs.body, theirs.headers, theirs.content_type)
    ours, theirs = wire._grpc_web_response(payload), jwire._grpc_web_response(payload)
    assert (ours.body, ours.headers) == (theirs.body, theirs.headers)
    # served: the same refusals through both gateways' fast ingress
    jgw, _ = _jax_gateway(SIMPLE, "dep1", "oauth-key-1", "oauth-secret-1")
    jserver = await jax_start_fast_server(jax_gateway_routes(jgw), "127.0.0.1", 0)
    jport = jserver.sockets[0].getsockname()[1]
    try:
        async with _Served(_gateway()) as s:
            frame = wire.grpc_web_frame(0, payload)
            for body, headers in ((frame, {}), (frame, {"oauth_token": "nope"}), (b"\x00\x00", {}),
                                  (b"\x01\x00\x00\x00\x00", {"oauth_token": "nope"})):
                headers = {"Content-Type": "application/grpc-web+proto", **headers}
                for path in ("/seldon.tpu.Seldon/Predict", "/seldon.protos.Seldon/SendFeedback"):
                    ours = await _http(s.port, "POST", path, body, headers)
                    theirs = await _http(jport, "POST", path, body, headers)
                    assert ours[0] == theirs[0] and ours[2] == theirs[2], (path, body, ours, theirs)
    finally:
        jserver.close()
        await jserver.wait_closed()


async def test_grpc_web_without_protobuf_answers_a_framed_internal_error(monkeypatch):
    """On a host without google.protobuf a gRPC-Web request is answered
    with a framed grpc-status 13 naming the module; the connection and the
    REST routes keep serving."""
    import sys

    for name in ("seldon_core_tpu_torch.core.codec_proto", "seldon_core_tpu_torch.proto.prediction_pb2"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "google.protobuf", None)
    from seldon_core_tpu_torch.serving.wire import grpc_web_frame

    async with _Served(_gateway()) as s:
        token = await s.token()
        st, hdrs, body = await _http(s.port, "POST", "/seldon.tpu.Seldon/Predict", grpc_web_frame(0, b""),
                                     {"Content-Type": "application/grpc-web+proto", "oauth_token": token})
        ((flags, trailer),) = _web_frames(body)
        assert st == 200 and flags == 0x80 and b"grpc-status:13" in trailer and b"google.protobuf" in trailer
        status, out = await s.predict({"data": {"ndarray": [[1.0]]}}, token)
        assert status == 200
        np.testing.assert_allclose(out["data"]["ndarray"], [[0.1, 0.9, 0.5]], rtol=1e-6)
