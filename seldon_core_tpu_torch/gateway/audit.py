"""Request/response audit stream.

Port of ``seldon_core_tpu/gateway/audit.py`` over the port's codec;
``kafka://`` stays gated on its client library (absent, the sink records
nothing), as in the JAX package.

Parity: reference api-frontend Kafka producer (C17,
KafkaRequestResponseProducer.java) — publishes the (request, response) pair
to a topic named after the OAuth client id, fire-and-forget, and the gateway
must keep serving when the broker is down (:49-57 catches producer errors).

Sinks are pluggable: in-memory ring (tests), JSONL file per client (the
single-host log equivalent of a topic), Kafka when a client lib exists.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from seldon_core_tpu_torch.core.codec_json import message_to_dict
from seldon_core_tpu_torch.core.message import SeldonMessage


class AuditSink:
    def send(self, client_id: str, request: SeldonMessage, response: SeldonMessage) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullAuditSink(AuditSink):
    def send(self, client_id, request, response) -> None:
        pass


class MemoryAuditSink(AuditSink):
    """Bounded ring per client (test double for the Kafka consumer check
    kafka/tests/src/read_predictions.py)."""

    def __init__(self, maxlen: int = 1000):
        self.topics: dict[str, collections.deque] = {}
        self._lock = threading.Lock()
        self.maxlen = maxlen

    def send(self, client_id, request, response) -> None:
        with self._lock:
            topic = self.topics.setdefault(client_id, collections.deque(maxlen=self.maxlen))
            topic.append(
                {
                    "ts": time.time(),
                    "request": message_to_dict(request),
                    "response": message_to_dict(response),
                }
            )


class JsonlAuditSink(AuditSink):
    """One append-only JSONL file per client id under ``directory`` — the
    single-host stand-in for one Kafka topic per client."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()

    def send(self, client_id, request, response) -> None:
        record = {
            "ts": time.time(),
            "request": message_to_dict(request),
            "response": message_to_dict(response),
        }
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in client_id) or "anon"
        path = os.path.join(self.directory, f"{safe}.jsonl")
        line = json.dumps(record) + "\n"
        try:
            with self._lock, open(path, "a") as f:
                f.write(line)
        except OSError:
            # audit must never take down serving (reference
            # KafkaRequestResponseProducer.java:68-71 swallows the same way)
            pass


class KafkaAuditSink(AuditSink):
    """Kafka producer when a client library is importable; errors are
    swallowed like the reference's (KafkaRequestResponseProducer.java:68-71 —
    audit must never take down serving)."""

    def __init__(self, bootstrap: str):
        from kafka import KafkaProducer  # gated: not in the base image

        self._producer = KafkaProducer(
            bootstrap_servers=bootstrap,
            value_serializer=lambda v: json.dumps(v).encode(),
        )

    def send(self, client_id, request, response) -> None:
        try:
            self._producer.send(
                client_id,
                {
                    "ts": time.time(),
                    "request": message_to_dict(request),
                    "response": message_to_dict(response),
                },
            )
        except Exception:  # noqa: BLE001
            pass


def make_audit_sink(url: str | None) -> AuditSink:
    """'' | None -> null; mem:// -> memory; file://<dir> -> jsonl;
    kafka://host:port -> kafka (falls back to null if lib missing)."""
    if not url:
        return NullAuditSink()
    if url.startswith("mem://"):
        return MemoryAuditSink()
    if url.startswith("file://"):
        return JsonlAuditSink(url[len("file://") :])
    if url.startswith("kafka://"):
        try:
            return KafkaAuditSink(url[len("kafka://") :])
        except ImportError:
            return NullAuditSink()
    raise ValueError(f"unknown audit sink url: {url}")
