"""The OAuth ingress gateway (port of ``seldon_core_tpu/gateway/``, its
names less the aiohttp app: the port serves REST and gRPC-Web with
``serving/fast_http.py::gateway_routes``). The gRPC gateway,
``gateway/grpc_gateway.py::start_gateway_grpc``, is imported from its
module: it needs ``grpc``."""

from seldon_core_tpu_torch.gateway.app import (
    Backend,
    Gateway,
    InProcessBackend,
    RemoteBackend,
)
from seldon_core_tpu_torch.gateway.audit import (
    AuditSink,
    JsonlAuditSink,
    KafkaAuditSink,
    MemoryAuditSink,
    NullAuditSink,
    make_audit_sink,
)
from seldon_core_tpu_torch.gateway.oauth import (
    FileTokenStore,
    InMemoryTokenStore,
    OAuthProvider,
    make_token_store,
)
from seldon_core_tpu_torch.gateway.store import DeploymentStore

__all__ = [
    "AuditSink",
    "Backend",
    "DeploymentStore",
    "FileTokenStore",
    "Gateway",
    "InMemoryTokenStore",
    "InProcessBackend",
    "JsonlAuditSink",
    "KafkaAuditSink",
    "MemoryAuditSink",
    "NullAuditSink",
    "OAuthProvider",
    "RemoteBackend",
    "make_audit_sink",
    "make_token_store",
]
