"""The OAuth ingress gateway (port of ``seldon_core_tpu/gateway/``, its
names less the gRPC gateway and the aiohttp app: the port serves it with
``serving/fast_http.py::gateway_routes``)."""

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
