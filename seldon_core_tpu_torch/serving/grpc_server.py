"""gRPC ingress for a predictor server.

Port of ``seldon_core_tpu/serving/grpc_server.py`` (reference engine
SeldonGrpcServer.java, SeldonService.java:45): ``Seldon.Predict`` and
``Seldon.SendFeedback`` reach the PredictionService, and the per-unit-type
services (Model, Router, Transformer, OutputTransformer, Combiner,
Generic) call the ROOT unit, so this process can stand in for a reference
model container inside another engine's graph. Every service is served
under both package prefixes (``proto/services.py``), with 64 MiB message
limits. An APIException answers a failure SeldonMessage, not a transport
error; a ``traceparent`` metadata key continues the caller's trace, and the
per-unit services open an ``ingress:{method}`` span as the internal REST
API does.

One difference from the JAX package, on purpose: ``Admin.ServerInfo``
reports the device this process serves on (``platform`` "gpu" with the
card count, or "cpu" with 1), where the JAX server reports
``jax.devices()``.
"""

from __future__ import annotations

import numpy as np

from seldon_core_tpu_torch.core.errors import APIException
from seldon_core_tpu_torch.core.message import SeldonMessage

MAX_MESSAGE_BYTES = 64 * 1024 * 1024
SERVER_OPTIONS = (
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
)


def failure_proto(e: APIException):
    """The reference's answer to an application error: a SeldonMessage
    whose status carries the error code (the call itself succeeds)."""
    from seldon_core_tpu_torch.core.codec_proto import message_to_proto

    return message_to_proto(SeldonMessage.failure(e.error.code, e.error.message, e.info))


def _wrap(fn):
    async def handler(request, context):
        try:
            return await fn(request, context)
        except APIException as e:
            return failure_proto(e)

    return handler


def metadata_value(metadata, key: str) -> str | None:
    """The first value of ``key`` in a call's invocation metadata."""
    for k, v in metadata or ():
        if k == key:
            return v
    return None


def _traceparent(context) -> str | None:
    """The caller's W3C trace context, sent as a ``traceparent`` metadata
    key (the HTTP header's twin)."""
    try:
        return metadata_value(context.invocation_metadata(), "traceparent")
    except Exception:  # noqa: BLE001 - metadata access must never fail a call
        return None


def device_info(device) -> tuple[str, int]:
    """(platform, device_count) of the device a server computes on."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        return "gpu", torch.cuda.device_count()
    return "cpu", 1


async def start_grpc_server(service, host: str = "0.0.0.0", port: int = 5000, *, device=None):
    """Serve ``service`` over gRPC on ``host:port`` and return the started
    ``grpc.aio`` server; ``port`` 0 binds a free port, which the server's
    ``bound_port`` attribute holds. ``device``: what ServerInfo reports."""
    import grpc

    from seldon_core_tpu_torch.core.codec_proto import (
        feedback_from_proto,
        message_from_proto,
        message_list_from_proto,
        message_to_proto,
    )
    from seldon_core_tpu_torch.proto import prediction_pb2 as pb
    from seldon_core_tpu_torch.proto.services import add_service

    server = grpc.aio.server(options=list(SERVER_OPTIONS))
    platform, device_count = device_info(device)

    def _unit_trace(context, method: str):
        return service.tracer.request_trace(
            f"ingress:{method}",
            parent=_traceparent(context),
            attrs={"deployment": service.deployment_name, "method": method},
        )

    @_wrap
    async def predict(request, context):
        out = await service.predict(message_from_proto(request), traceparent=_traceparent(context))
        return message_to_proto(out)

    @_wrap
    async def send_feedback(request, context):
        out = await service.send_feedback(feedback_from_proto(request), traceparent=_traceparent(context))
        return message_to_proto(out)

    @_wrap
    async def transform_input(request, context):
        with _unit_trace(context, "transform-input"):
            out = await service.executor.root.unit.transform_input(message_from_proto(request))
        return message_to_proto(out)

    @_wrap
    async def transform_output(request, context):
        with _unit_trace(context, "transform-output"):
            out = await service.executor.root.unit.transform_output(message_from_proto(request))
        return message_to_proto(out)

    @_wrap
    async def route(request, context):
        with _unit_trace(context, "route"):
            branch = await service.executor.root.unit.route(message_from_proto(request))
        return message_to_proto(SeldonMessage.from_array(np.asarray([[branch]], dtype=np.float32)))

    @_wrap
    async def aggregate(request, context):
        with _unit_trace(context, "aggregate"):
            out = await service.executor.root.unit.aggregate(message_list_from_proto(request))
        return message_to_proto(out)

    async def server_info(request, context):
        return pb.ServerInfo(
            deployment_name=service.deployment_name,
            predictor_name=service.predictor_name,
            device_count=device_count,
            platform=platform,
        )

    add_service(server, "Seldon", {"Predict": predict, "SendFeedback": send_feedback})
    add_service(server, "Model", {"Predict": predict})
    add_service(server, "Router", {"Route": route, "SendFeedback": send_feedback})
    add_service(server, "Transformer", {"TransformInput": transform_input})
    add_service(server, "OutputTransformer", {"TransformOutput": transform_output})
    add_service(server, "Combiner", {"Aggregate": aggregate})
    add_service(
        server,
        "Generic",
        {
            "TransformInput": transform_input,
            "TransformOutput": transform_output,
            "Route": route,
            "Aggregate": aggregate,
            "SendFeedback": send_feedback,
        },
    )
    add_service(server, "Admin", {"ServerInfo": server_info})

    bound = server.add_insecure_port(f"{host}:{port}")
    if not bound:
        raise OSError(f"gRPC could not bind {host}:{port}")
    server.bound_port = bound
    await server.start()
    return server
