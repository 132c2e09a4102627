"""Ingress gateway: OAuth2 and the external prediction API (reference
api-frontend).

Port of ``seldon_core_tpu/gateway/app.py`` without its aiohttp app: the
port serves the gateway on its own ingress (``serving/fast_http.py::
gateway_routes`` over the handlers of ``serving/wire.py``), and its
``RemoteBackend`` speaks through ``serving/http_client.py``.

Parity (C13): POST /api/v0.1/predictions and /api/v0.1/feedback with
Bearer auth, POST /oauth/token (client_credentials), principal ->
deployment lookup (APIFE_NO_RUNNING_DEPLOYMENT when absent,
PredictionService.java:42-46), the request/response audit after every
prediction (RestClientController.java:164), ingress metrics.

Backends: ``InProcessBackend`` calls a PredictionService living in this
process; ``RemoteBackend`` crosses the network to an engine on another
host (pooled HTTP, the reference's 500 ms connect and 2 s total timeouts,
one retry on a 5xx or a transport failure), passing the engine's
status-JSON error codes through.
"""

from __future__ import annotations

import json
import os

from seldon_core_tpu_torch.core.codec_json import (
    feedback_to_dict,
    message_from_dict,
    message_to_dict,
    meta_from_dict,
)
from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Feedback, SeldonMessage
from seldon_core_tpu_torch.gateway.audit import AuditSink, NullAuditSink
from seldon_core_tpu_torch.gateway.oauth import OAuthProvider
from seldon_core_tpu_torch.gateway.store import DeploymentStore
from seldon_core_tpu_torch.serving.http_client import HttpPool, PoolPerLoop
from seldon_core_tpu_torch.utils.env import TEST_CLIENT_KEY, TEST_CLIENT_SECRET


class Backend:
    """Where the gateway sends a deployment's traffic. ``wire_npy``: the
    client declared application/x-npy, which the backend honours (decode
    to the tensor arm, or forward the raw bytes). ``traceparent``: the
    client's W3C trace header, which the engine continues."""

    async def predict(
        self, deployment, msg: SeldonMessage, wire_npy: bool = False, traceparent: str | None = None
    ) -> SeldonMessage:
        raise NotImplementedError

    async def feedback(self, deployment, fb: Feedback) -> SeldonMessage:
        raise NotImplementedError


class InProcessBackend(Backend):
    """Deployment name -> PredictionService in this process: the
    gateway-to-engine hop is a function call."""

    def __init__(self):
        self.services: dict[str, object] = {}

    def register(self, name: str, service) -> None:
        self.services[name] = service

    def unregister(self, name: str) -> None:
        self.services.pop(name, None)

    def _service(self, deployment):
        svc = self.services.get(deployment.name)
        if svc is None:
            raise APIException(ErrorCode.APIFE_NO_RUNNING_DEPLOYMENT, deployment.name)
        return svc

    async def predict(
        self, deployment, msg: SeldonMessage, wire_npy: bool = False, traceparent: str | None = None
    ) -> SeldonMessage:
        return await self._service(deployment).predict(msg, wire_npy=wire_npy, traceparent=traceparent)

    async def feedback(self, deployment, fb: Feedback) -> SeldonMessage:
        return await self._service(deployment).send_feedback(fb)


class RemoteBackend(Backend):
    """Pooled HTTP to a per-deployment engine host. Reference parity:
    api-frontend InternalPredictionService.java: a 150-connection pool
    (:60-61), timeouts connect 500 ms / total 2000 ms (:52-54), one retry
    on a failure that may be transient (HttpRetryHandler.java)."""

    def __init__(self, resolve=None):
        # resolve(deployment) -> base url; default: k8s-style service DNS
        self._resolve = resolve or (lambda d: f"http://{d.name}:8000")
        self._pools = PoolPerLoop(lambda: HttpPool(connect_timeout_s=0.5, total_timeout_s=2.0))

    async def _roundtrip(self, deployment, path: str, body: bytes, content_type: str, headers: dict | None):
        """POST with one retry; returns the response. A 5xx or a transport
        failure is retried once; a 4xx re-raises the engine's status-JSON
        error code when the body has that shape, else APIFE_MICROSERVICE_ERROR."""
        pool = await self._pools.get()
        url = self._resolve(deployment) + path
        last_exc: Exception | None = None
        for _ in range(2):  # the original and one retry
            try:
                resp = await pool.post(url, body, headers, content_type=content_type)
            except (ConnectionError, OSError, TimeoutError) as e:
                last_exc = e
                continue
            if resp.status >= 500:
                last_exc = APIException(ErrorCode.APIFE_MICROSERVICE_ERROR, resp.body[:200].decode(errors="replace"))
                continue
            if resp.status >= 400:
                try:
                    parsed = json.loads(resp.body)
                except (ValueError, UnicodeDecodeError):
                    parsed = None
                if isinstance(parsed, dict) and parsed.get("status") == "FAILURE":
                    code = parsed.get("code")
                    err = next((e for e in ErrorCode if e.code == code), ErrorCode.APIFE_MICROSERVICE_ERROR)
                    raise APIException(err, str(parsed.get("info", "")))
                raise APIException(ErrorCode.APIFE_MICROSERVICE_ERROR, resp.body[:200].decode(errors="replace"))
            return resp
        if isinstance(last_exc, APIException):
            raise last_exc
        raise APIException(ErrorCode.APIFE_MICROSERVICE_ERROR, f"{type(last_exc).__name__}: {last_exc}")

    async def predict(
        self, deployment, msg: SeldonMessage, wire_npy: bool = False, traceparent: str | None = None
    ) -> SeldonMessage:
        tp_headers = {"traceparent": traceparent} if traceparent else {}
        if wire_npy and msg.bin_data is not None:
            # keep the binary path across the hop: the raw npy body with its
            # declaration, meta back in the Seldon-Meta header
            resp = await self._roundtrip(
                deployment, "/api/v0.1/predictions", msg.bin_data, "application/x-npy", tp_headers
            )
            if resp.content_type == "application/x-npy":
                meta = meta_from_dict(json.loads(resp.headers.get("seldon-meta", "{}")))
                return SeldonMessage(bin_data=resp.body, meta=meta)
            return message_from_dict(resp.json())  # a bytes-out graph answers JSON
        resp = await self._roundtrip(
            deployment, "/api/v0.1/predictions", json.dumps(message_to_dict(msg)).encode(),
            "application/json", tp_headers,
        )
        return message_from_dict(resp.json())

    async def feedback(self, deployment, fb: Feedback) -> SeldonMessage:
        resp = await self._roundtrip(
            deployment, "/api/v0.1/feedback", json.dumps(feedback_to_dict(fb)).encode(), "application/json", None
        )
        return message_from_dict(resp.json())

    async def close(self) -> None:
        await self._pools.close()


class Gateway:
    def __init__(
        self,
        store: DeploymentStore | None = None,
        oauth: OAuthProvider | None = None,
        backend: Backend | None = None,
        audit: AuditSink | None = None,
        metrics=None,
    ):
        self.oauth = oauth or OAuthProvider()
        self.store = store or DeploymentStore(oauth=self.oauth)
        if self.store.oauth is None:
            self.store.oauth = self.oauth
        self.backend = backend or InProcessBackend()
        self.audit = audit or NullAuditSink()
        self.metrics = metrics
        # the reference's backdoor: TEST_CLIENT_KEY registers a test client
        # (AuthorizationServerConfiguration.java:78-96)
        test_key = os.environ.get(TEST_CLIENT_KEY, "")
        if test_key:
            self.oauth.add_client(test_key, os.environ.get(TEST_CLIENT_SECRET, "secret"))

    def principal_from_auth(self, auth: str) -> str:
        """The principal of an ``Authorization: Bearer`` header, or 401
        APIFE_GRPC_NO_PRINCIPAL_FOUND."""
        if auth.lower().startswith("bearer "):
            principal = self.oauth.principal(auth[7:].strip())
            if principal:
                return principal
        raise APIException(ErrorCode.APIFE_GRPC_NO_PRINCIPAL_FOUND, "invalid or missing token")

    def deployment_for(self, principal: str):
        """The principal's deployment (its oauth_key), or
        APIFE_NO_RUNNING_DEPLOYMENT. The test client's principal maps to the
        first deployment by name, if any."""
        dep = self.store.by_principal(principal)
        if dep is None:
            if principal == os.environ.get(TEST_CLIENT_KEY, "") and self.store.names():
                return self.store.by_name(self.store.names()[0])
            raise APIException(ErrorCode.APIFE_NO_RUNNING_DEPLOYMENT, principal)
        return dep
