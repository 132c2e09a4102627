"""A graph node served by another process over the reference's internal
REST API.

Port of the REST path of ``seldon_core_tpu/engine/remote.py``
(``_RestSession``, ``RemoteUnit``): a node whose spec declares an
``endpoint`` and has nothing in-process is a ``RemoteUnit``, which calls
the unit's methods on ``http://{service_host}:{service_port}``:
``/predict`` for a MODEL unit and ``/transform-input`` for the others,
``/transform-output``, ``/route`` (the branch comes back as a 1x1 tensor),
``/aggregate`` (``seldonMessages``) and ``/send-feedback``. Every body is
the reference's form-encoded ``json=`` field, so an unmodified reference
model container plugs in, and every hop carries the W3C ``traceparent`` of
the unit span that made it (the server continues that trace).

Failures, as the resilience layer (``engine/executor.py``) reads them:
a non-200 answer raises ENGINE_MICROSERVICE_ERROR, retryable and counted
against the endpoint's breaker only when its status is 5xx (a 4xx is the
deterministic answer of a healthy backend); a transport failure (refused,
reset, a pooled connection the server closed, a timeout) is the same
error, retryable; a transport timeout on a request whose deadline budget
is spent is the 504 budget error; a body that does not parse is
ENGINE_INVALID_RESPONSE. The pool's total timeout is replaced by the
request's remaining budget (``resilience.call_timeout``).

gRPC endpoints are not ported: ``graph/validation.py`` refuses them by
name, and a RemoteUnit built for one raises.
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np

from seldon_core_tpu_torch import telemetry
from seldon_core_tpu_torch.core.codec_json import feedback_to_dict, message_from_dict, message_to_dict
from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Feedback, SeldonMessage
from seldon_core_tpu_torch.engine.resilience import call_timeout, current_deadline, deadline_exceeded
from seldon_core_tpu_torch.engine.units import Unit
from seldon_core_tpu_torch.graph.spec import EndpointType, PredictiveUnit, PredictiveUnitType
from seldon_core_tpu_torch.graph.validation import GRPC_ENDPOINT_REFUSAL
from seldon_core_tpu_torch.serving.http_client import HttpPool, PoolPerLoop
from seldon_core_tpu_torch.utils.env import rest_timeouts


def _make_rest_pool() -> HttpPool:
    connect_s, total_s = rest_timeouts()
    return HttpPool(connect_timeout_s=connect_s, total_timeout_s=total_s)


# One pooled client per event loop, shared by every RemoteUnit on it; the
# timeouts are read from the environment when a loop's pool is built.
_RestSession = PoolPerLoop(_make_rest_pool)


class RemoteUnit(Unit):
    """Graph unit whose methods execute in an external service."""

    def __init__(self, spec: PredictiveUnit):
        super().__init__(spec)
        ep = spec.endpoint
        if ep is None or not ep.service_port:
            raise ValueError(f"RemoteUnit '{spec.name}' needs an endpoint")
        if ep.type == EndpointType.GRPC:
            raise ValueError(f"unit '{spec.name}': {GRPC_ENDPOINT_REFUSAL}")
        self.endpoint = ep
        self.base_url = f"http://{ep.service_host}:{ep.service_port}"

    @staticmethod
    def _raise_if_deadline(e: BaseException, where: str) -> None:
        """A transport timeout on a request whose budget has run out is the
        deadline firing: 504 budget exhaustion, not a retryable 5xx."""
        d = current_deadline()
        if d is not None and d.expired():
            raise deadline_exceeded(where) from e

    @staticmethod
    def _status_error(url: str, status: int, body: bytes) -> APIException:
        """A non-200 answer: retryable (and breaker-counted) only if 5xx."""
        return APIException(
            ErrorCode.ENGINE_MICROSERVICE_ERROR,
            f"{url} -> {status}: {body[:300].decode('utf-8', errors='replace')}",
            retryable=status >= 500,
        )

    async def _rest_call(self, path: str, payload: dict) -> SeldonMessage:
        url = self.base_url + path
        # the reference's wire quirk: the message rides a form field json=
        fields = {"json": json.dumps(payload)}
        tp = telemetry.traceparent()
        headers = {"traceparent": tp} if tp is not None else None
        try:
            pool = await _RestSession.get()
            # a stamped deadline replaces the pool's total timeout with what
            # remains of the budget (raising 504 if nothing does)
            timeout_s = call_timeout(pool.total_timeout_s) if current_deadline() is not None else None
            resp = await pool.post_form(url, fields, headers, timeout_s=timeout_s)
        except APIException:
            raise
        except Exception as e:  # noqa: BLE001 - transport errors normalised
            self._raise_if_deadline(e, url)
            raise APIException(ErrorCode.ENGINE_MICROSERVICE_ERROR, f"{url}: {type(e).__name__}: {e}") from e
        if resp.status != 200:
            raise self._status_error(url, resp.status, resp.body)
        try:
            return message_from_dict(json.loads(resp.body))
        except (ValueError, APIException) as e:
            raise APIException(ErrorCode.ENGINE_INVALID_RESPONSE, f"{url}: {e}") from e

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        # MODEL containers expose /predict, the others /transform-input
        path = "/predict" if self.spec.type == PredictiveUnitType.MODEL else "/transform-input"
        return await self._rest_call(path, message_to_dict(msg))

    async def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._rest_call("/transform-output", message_to_dict(msg))

    async def route(self, msg: SeldonMessage) -> int:
        reply = await self._rest_call("/route", message_to_dict(msg))
        if reply.data is None:
            raise APIException(ErrorCode.ENGINE_INVALID_RESPONSE, "router returned no data")
        return int(np.asarray(reply.array).reshape(-1)[0])

    async def aggregate(self, msgs: Sequence[SeldonMessage]) -> SeldonMessage:
        return await self._rest_call("/aggregate", {"seldonMessages": [message_to_dict(m) for m in msgs]})

    async def send_feedback(self, feedback: Feedback, routing: int) -> None:
        await self._rest_call("/send-feedback", feedback_to_dict(feedback))
