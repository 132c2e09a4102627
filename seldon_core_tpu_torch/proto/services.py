"""gRPC service surface, built on grpc generic handlers (no codegen plugin).

Port of ``seldon_core_tpu/proto/services.py``. Service and method names
match the reference contract (prediction.proto:76-109): Generic, Model,
Router, Transformer, OutputTransformer, Combiner, Seldon, plus the
TPU-native Admin. Reference clients address methods as
``/seldon.protos.<Service>/<Method>`` while the proto package is
``seldon.tpu``, so servers register BOTH package prefixes: the payload
bytes are the same either way (field numbers match).
"""

from __future__ import annotations

from typing import Callable

import grpc

from seldon_core_tpu_torch.proto import prediction_pb2 as pb

PACKAGES = ("seldon.tpu", "seldon.protos")

# service -> {method: (request_cls, response_cls)}
SERVICES: dict[str, dict[str, tuple]] = {
    "Generic": {
        "TransformInput": (pb.SeldonMessage, pb.SeldonMessage),
        "TransformOutput": (pb.SeldonMessage, pb.SeldonMessage),
        "Route": (pb.SeldonMessage, pb.SeldonMessage),
        "Aggregate": (pb.SeldonMessageList, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
    "Model": {"Predict": (pb.SeldonMessage, pb.SeldonMessage)},
    "Router": {
        "Route": (pb.SeldonMessage, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
    "Transformer": {"TransformInput": (pb.SeldonMessage, pb.SeldonMessage)},
    "OutputTransformer": {"TransformOutput": (pb.SeldonMessage, pb.SeldonMessage)},
    "Combiner": {"Aggregate": (pb.SeldonMessageList, pb.SeldonMessage)},
    "Seldon": {
        "Predict": (pb.SeldonMessage, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
    # TPU-native addition
    "Admin": {"ServerInfo": (pb.ServerInfoRequest, pb.ServerInfo)},
}


def _serialize(m) -> bytes:
    return m.SerializeToString()


def generic_handler(service: str, methods: dict[str, Callable], package: str) -> grpc.GenericRpcHandler:
    """A GenericRpcHandler for unary-unary methods (async handlers on a
    grpc.aio server, plain ones on a sync server)."""
    spec = SERVICES[service]
    rpc_handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=spec[name][0].FromString, response_serializer=_serialize
        )
        for name, fn in methods.items()
    }
    return grpc.method_handlers_generic_handler(f"{package}.{service}", rpc_handlers)


def add_service(server, service: str, methods: dict[str, Callable]) -> None:
    """Register an implementation under both package prefixes."""
    for package in PACKAGES:
        server.add_generic_rpc_handlers((generic_handler(service, methods, package),))


class ServiceStub:
    """Client stub over a channel for one service (sync or aio channel)."""

    def __init__(self, channel, service: str, package: str = "seldon.tpu"):
        self._methods = {
            name: channel.unary_unary(
                f"/{package}.{service}/{name}",
                request_serializer=_serialize,
                response_deserializer=resp_cls.FromString,
            )
            for name, (_, resp_cls) in SERVICES[service].items()
        }

    def __getattr__(self, name: str):
        try:
            return self._methods[name]
        except KeyError as e:
            raise AttributeError(name) from e
