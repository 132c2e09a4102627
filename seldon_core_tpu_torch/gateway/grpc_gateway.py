"""gRPC ingress gateway with ``oauth_token`` metadata auth.

Port of ``seldon_core_tpu/gateway/grpc_gateway.py`` (reference
api-frontend SeldonGrpcServer.java, HeaderServerInterceptor.java:42-75):
reads the metadata key ``oauth_token``, resolves the token's principal and
its deployment, and forwards ``Seldon.Predict`` / ``Seldon.SendFeedback``
to the gateway's backend; every prediction goes to the audit sink, as on
REST. A missing or unknown token, and every other application error,
answer a failure SeldonMessage (``APIFE_GRPC_NO_PRINCIPAL_FOUND``, code
205, for the token), never a transport error. A ``traceparent`` metadata
key is forwarded so the engine continues the caller's trace.

Two server modes, both returning an object with an async ``stop(grace)``
and a ``bound_port``:

- ``aio`` (default): pure ``grpc.aio``, everything on the event loop;
- ``sync``: the C-core ``grpc.server`` with four worker threads; HTTP/2
  framing and the proto parse run in C threads, and each RPC bridges once
  into the loop (``run_coroutine_threadsafe``), where auth, codec, backend
  and audit stay loop-confined as on the REST path.
"""

from __future__ import annotations

import asyncio

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.serving.grpc_server import SERVER_OPTIONS, failure_proto, metadata_value

OAUTH_METADATA_KEY = "oauth_token"  # HeaderServerInterceptor.java:42-44


def _gateway_methods(gw):
    """The loop-confined request coroutines shared by both server modes:
    ``(predict, send_feedback)``, each taking (request proto, metadata)."""
    from seldon_core_tpu_torch.core.codec_proto import feedback_from_proto, message_from_proto, message_to_proto

    def _auth(metadata):
        token = metadata_value(metadata, OAUTH_METADATA_KEY) or ""
        principal = gw.oauth.principal(token) if token else None
        if not principal:
            raise APIException(ErrorCode.APIFE_GRPC_NO_PRINCIPAL_FOUND, OAUTH_METADATA_KEY)
        return principal, gw.deployment_for(principal)

    async def predict(request, metadata):
        try:
            principal, dep = _auth(metadata)
            msg = message_from_proto(request)
            out = await gw.backend.predict(dep, msg, traceparent=metadata_value(metadata, "traceparent"))
            gw.audit.send(principal, msg, out)
            return message_to_proto(out)
        except APIException as e:
            return failure_proto(e)

    async def send_feedback(request, metadata):
        try:
            _, dep = _auth(metadata)
            return message_to_proto(await gw.backend.feedback(dep, feedback_from_proto(request)))
        except APIException as e:
            return failure_proto(e)

    return predict, send_feedback


async def start_gateway_grpc(gw, host: str = "0.0.0.0", port: int = 5000, mode: str = "aio"):
    """Start the gateway's gRPC ingress on ``host:port`` (0 binds a free
    port) in ``mode`` ``"aio"`` or ``"sync"``."""
    if mode == "aio":
        return await _start_aio(gw, host, port)
    if mode != "sync":
        raise ValueError(f"grpc gateway mode must be 'sync' or 'aio', got {mode!r}")
    return await _start_sync(gw, host, port)


def _bind(server, host: str, port: int) -> int:
    bound = server.add_insecure_port(f"{host}:{port}")
    if not bound:
        raise OSError(f"gRPC could not bind {host}:{port}")
    return bound


async def _start_aio(gw, host: str, port: int):
    import grpc

    from seldon_core_tpu_torch.proto.services import add_service

    server = grpc.aio.server(options=list(SERVER_OPTIONS))
    predict, send_feedback = _gateway_methods(gw)

    async def predict_rpc(request, context):
        return await predict(request, context.invocation_metadata())

    async def feedback_rpc(request, context):
        return await send_feedback(request, context.invocation_metadata())

    add_service(server, "Seldon", {"Predict": predict_rpc, "SendFeedback": feedback_rpc})
    server.bound_port = _bind(server, host, port)
    await server.start()
    return server


class _SyncBridgeServer:
    """A C-core ``grpc.server`` whose handlers bridge into the asyncio loop.

    A worker thread only takes the parsed request, makes ONE
    run_coroutine_threadsafe into the loop that owns the backend, waits
    for the result and hands the response back to C: gateway and backend
    state stay loop-confined, so nothing needs a lock."""

    def __init__(self, server, bound_port: int, pool):
        self._server = server
        self.bound_port = bound_port
        self._pool = pool  # the handlers' threads, which grpc.Server.stop leaves running

    async def stop(self, grace):
        # grpc.Server.stop is thread-safe and returns at once; wait off-loop,
        # then stop and join the handler threads
        event = self._server.stop(grace)
        await asyncio.get_running_loop().run_in_executor(None, event.wait)
        await asyncio.get_running_loop().run_in_executor(None, self._pool.shutdown)


async def _start_sync(gw, host: str, port: int) -> _SyncBridgeServer:
    from concurrent import futures

    import grpc

    from seldon_core_tpu_torch.proto.services import add_service

    loop = asyncio.get_running_loop()
    predict, send_feedback = _gateway_methods(gw)

    def bridge(coro_fn):
        def handler(request, context):
            return asyncio.run_coroutine_threadsafe(coro_fn(request, context.invocation_metadata()), loop).result()

        return handler

    # few threads: handlers only park on the loop bridge; C-core does the
    # HTTP/2 and parse work on its own threads
    pool = futures.ThreadPoolExecutor(max_workers=4, thread_name_prefix="seldon-grpc-gateway")
    server = grpc.server(pool, options=list(SERVER_OPTIONS))
    add_service(server, "Seldon", {"Predict": bridge(predict), "SendFeedback": bridge(send_feedback)})
    bound = _bind(server, host, port)
    server.start()
    return _SyncBridgeServer(server, bound, pool)
