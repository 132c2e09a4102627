"""Structured JSON access logs, one line per ingress request.

Port of ``seldon_core_tpu/telemetry/access_log.py``, unchanged.

Gated by ``ENGINE_ACCESS_LOG=json`` (anything else = off, the default —
at serving rates an unconditional per-request log line is a real cost).
Lines go to a dedicated non-propagating logger ("seldon.access") with a
stderr handler, so enabling access logs never depends on the embedding
application's logging config and never double-prints through root handlers.

Every line carries the correlation ids: puid (the user-visible request id)
and trace_id (the telemetry trace — paste into GET /traces/{id}).
"""

from __future__ import annotations

import json
import logging
import os
import sys

from seldon_core_tpu_torch.utils.env import ENGINE_ACCESS_LOG

_LOGGER_NAME = "seldon.access"
_configured = False


def enabled(env: dict | None = None) -> bool:
    env = env if env is not None else os.environ
    return str(env.get(ENGINE_ACCESS_LOG, "")).strip().lower() == "json"


def access_logger() -> logging.Logger:
    lg = logging.getLogger(_LOGGER_NAME)
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(message)s"))
        lg.addHandler(handler)
        lg.setLevel(logging.INFO)
        lg.propagate = False
        _configured = True
    return lg


def log_request(
    *,
    deployment: str,
    method: str,
    puid: str,
    trace_id: str = "",
    status: int = 200,
    duration_ms: float = 0.0,
    batch: int = 1,
    degraded: str = "",
    retries: int = 0,
    tokens: int = 0,
    slo: str = "",
) -> None:
    """Emit one access-log line (no-op unless ENGINE_ACCESS_LOG=json).
    ``tokens``/``slo`` are the generative tier's goodput fields: generated
    tokens delivered by this request, and the decode scheduler's SLO
    verdict ("met" | "breached" — present only when the deployment
    declares decode_slo_* targets or the request rode a deadline budget),
    so the log line, the goodput metrics, and the flight recorder agree
    about what each request got."""
    if not enabled():
        return
    line = {
        "puid": puid,
        "trace_id": trace_id,
        "deployment": deployment,
        "method": method,
        "status": status,
        "duration_ms": round(duration_ms, 3),
        "batch": batch,
    }
    if degraded:
        line["degraded"] = degraded
    if retries:
        line["retries"] = retries
    if tokens:
        line["tokens"] = tokens
    if slo:
        line["slo"] = slo
    access_logger().info(json.dumps(line, separators=(",", ":")))
