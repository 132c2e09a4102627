"""A graph node served by another process over the reference's internal
REST API or its gRPC services.

Port of ``seldon_core_tpu/engine/remote.py`` (``_RestSession``,
``RemoteUnit``): a node whose spec declares an ``endpoint`` and has
nothing in-process is a ``RemoteUnit``. Over REST it calls the unit's
methods on ``http://{service_host}:{service_port}``:
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

Over gRPC (an endpoint of ``type: GRPC``) it calls the per-unit-type
service a reference container serves, under the ``seldon.protos``
package: ``Model.Predict`` for a MODEL, ``Router.Route`` and
``Router.SendFeedback`` for a ROUTER, ``Transformer.TransformInput``,
``OutputTransformer.TransformOutput``, ``Combiner.Aggregate``, else
``Generic``. One ``grpc.aio`` channel is cached per unit and per event
loop (a channel of a loop that has ended is rebuilt on the running one),
with a stub per service: never a channel per call, the reference's perf
hazard. The per-call timeout is ``GRPC_DEADLINE_S`` or the request's
remaining budget, the ``traceparent`` rides as metadata, and the channel
keeps gRPC's default message limits, as the JAX engine's does. An
UNAVAILABLE status drops the cached channel, which has a subchannel pool
of its own (a restarted backend is reached again without rebuilding the
engine, where a channel of grpc's shared pool would inherit the dead
connection's reconnect backoff); INVALID_ARGUMENT and the other
deterministic statuses are neither retried nor counted against the
breaker; other failures are ENGINE_MICROSERVICE_ERROR for the resilience
layer to classify. ``grpc`` and ``google.protobuf`` are imported only
when a gRPC unit makes its first call.
"""

from __future__ import annotations

import asyncio
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
from seldon_core_tpu_torch.serving.http_client import HttpPool, PoolPerLoop
from seldon_core_tpu_torch.utils.env import rest_timeouts

GRPC_DEADLINE_S = 5.0  # reference InternalPredictionService.java:77 (the
# default only: a request with a deadline budget uses what remains of it)


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
        self.endpoint = ep
        self.base_url = f"http://{ep.service_host}:{ep.service_port}"
        self.is_grpc = ep.type == EndpointType.GRPC
        self._grpc_channel = None  # cached, never per call
        self._grpc_loop = None  # the event loop the cached channel lives on
        self._stub_cache: dict[str, object] = {}

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

    # ----------------------------------------------------------- gRPC path
    def _grpc_service_for(self, method: str) -> str:
        """The per-unit-type service a reference container serves
        (prediction.proto:84-103); the port's own gRPC server also serves
        Generic, reference wrappers do not."""
        t = self.spec.type
        if method == "Predict" or (method == "TransformInput" and t == PredictiveUnitType.MODEL):
            return "Model"
        if method in ("Route", "SendFeedback") and t == PredictiveUnitType.ROUTER:
            return "Router"
        if method == "TransformInput":
            return "Transformer"
        if method == "TransformOutput":
            return "OutputTransformer"
        if method == "Aggregate":
            return "Combiner"
        return "Generic"

    @staticmethod
    def _is_transport_failure(e: BaseException) -> bool:
        """A failure that indicts the channel (refused, backend gone, reset)
        rather than the request: UNAVAILABLE. Other statuses keep it."""
        code = getattr(e, "code", None)
        if not callable(code):
            return isinstance(e, (ConnectionError, OSError))
        try:
            import grpc

            return code() is grpc.StatusCode.UNAVAILABLE
        except Exception:  # noqa: BLE001 - classification must never raise
            return False

    @staticmethod
    def _grpc_retryable(e: BaseException) -> bool | None:
        """False for the deterministic request-level statuses (never
        replayed, never counted against the breaker); None lets the
        resilience layer classify ENGINE_MICROSERVICE_ERROR (retryable)."""
        code = getattr(e, "code", None)
        if not callable(code):
            return None
        try:
            import grpc

            deterministic = (
                grpc.StatusCode.INVALID_ARGUMENT,
                grpc.StatusCode.NOT_FOUND,
                grpc.StatusCode.ALREADY_EXISTS,
                grpc.StatusCode.PERMISSION_DENIED,
                grpc.StatusCode.UNAUTHENTICATED,
                grpc.StatusCode.FAILED_PRECONDITION,
                grpc.StatusCode.OUT_OF_RANGE,
                grpc.StatusCode.UNIMPLEMENTED,
            )
            return False if code() in deterministic else None
        except Exception:  # noqa: BLE001 - classification must never raise
            return None

    def _channel(self):
        """The cached channel of the running loop, built on first use."""
        import grpc

        loop = asyncio.get_running_loop()
        if self._grpc_channel is None or self._grpc_loop is not loop:
            # a channel of a loop that has ended cannot be awaited here:
            # drop it with its stubs
            self._stub_cache.clear()
            # a subchannel pool of its own: from grpc's process-wide pool a
            # rebuilt channel would inherit the dead connection's reconnect
            # backoff, and fail again after the backend has restarted
            self._grpc_channel = grpc.aio.insecure_channel(
                f"{self.endpoint.service_host}:{self.endpoint.service_port}",
                options=(("grpc.use_local_subchannel_pool", 1),),
            )
            self._grpc_loop = loop
        return self._grpc_channel

    async def _invalidate_channel(self, channel) -> None:
        """Drop and close the cached channel if it is still the one that
        failed (a concurrent call may have rebuilt it already)."""
        if self._grpc_channel is not channel:
            return
        self._grpc_channel = None
        self._grpc_loop = None
        self._stub_cache.clear()
        try:
            await channel.close()
        except Exception:  # noqa: BLE001 - teardown of a dead channel
            pass

    async def _grpc_call(self, method: str, request_pb) -> SeldonMessage:
        from seldon_core_tpu_torch.core.codec_proto import message_from_proto
        from seldon_core_tpu_torch.proto.services import ServiceStub

        channel = self._channel()
        service = self._grpc_service_for(method)
        stub = self._stub_cache.get(service)
        if stub is None:
            # reference containers serve package seldon.protos; the bytes
            # are the same under either package
            stub = self._stub_cache[service] = ServiceStub(channel, service, package="seldon.protos")
        rpc_method = "Predict" if service == "Model" else method
        tp = telemetry.traceparent()
        metadata = (("traceparent", tp),) if tp is not None else None
        try:
            reply = await getattr(stub, rpc_method)(
                request_pb, timeout=call_timeout(GRPC_DEADLINE_S), metadata=metadata
            )
        except APIException:
            raise
        except Exception as e:  # noqa: BLE001 - transport and status errors normalised
            if self._is_transport_failure(e):
                await self._invalidate_channel(channel)
            where = f"gRPC {service}.{rpc_method}"
            self._raise_if_deadline(e, where)
            raise APIException(
                ErrorCode.ENGINE_MICROSERVICE_ERROR, f"{where}: {e}", retryable=self._grpc_retryable(e)
            ) from e
        return message_from_proto(reply)

    @staticmethod
    def _to_proto(msg: SeldonMessage):
        from seldon_core_tpu_torch.core.codec_proto import message_to_proto

        return message_to_proto(msg)

    # ------------------------------------------------------------- methods
    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        if self.is_grpc:
            return await self._grpc_call("TransformInput", self._to_proto(msg))
        # MODEL containers expose /predict, the others /transform-input
        path = "/predict" if self.spec.type == PredictiveUnitType.MODEL else "/transform-input"
        return await self._rest_call(path, message_to_dict(msg))

    async def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        if self.is_grpc:
            return await self._grpc_call("TransformOutput", self._to_proto(msg))
        return await self._rest_call("/transform-output", message_to_dict(msg))

    async def route(self, msg: SeldonMessage) -> int:
        if self.is_grpc:
            reply = await self._grpc_call("Route", self._to_proto(msg))
        else:
            reply = await self._rest_call("/route", message_to_dict(msg))
        if reply.data is None:
            raise APIException(ErrorCode.ENGINE_INVALID_RESPONSE, "router returned no data")
        return int(np.asarray(reply.array).reshape(-1)[0])

    async def aggregate(self, msgs: Sequence[SeldonMessage]) -> SeldonMessage:
        if self.is_grpc:
            from seldon_core_tpu_torch.core.codec_proto import message_list_to_proto

            return await self._grpc_call("Aggregate", message_list_to_proto(msgs))
        return await self._rest_call("/aggregate", {"seldonMessages": [message_to_dict(m) for m in msgs]})

    async def send_feedback(self, feedback: Feedback, routing: int) -> None:
        if self.is_grpc:
            from seldon_core_tpu_torch.core.codec_proto import feedback_to_proto

            await self._grpc_call("SendFeedback", feedback_to_proto(feedback))
            return
        await self._rest_call("/send-feedback", feedback_to_dict(feedback))

    async def close(self) -> None:
        """Close the cached gRPC channel (a no-op for a REST unit, whose
        pool is per loop: ``_RestSession.close()``)."""
        channel = self._grpc_channel
        if channel is not None and self._grpc_loop is asyncio.get_running_loop():
            await self._invalidate_channel(channel)
        self._grpc_channel = self._grpc_loop = None
        self._stub_cache.clear()


async def close_remote_units(executor) -> None:
    """Close the gRPC channels of every remote unit of a graph."""
    for node in executor.root.walk():
        if isinstance(node.unit, RemoteUnit):
            await node.unit.close()
