"""Transport-neutral engine predict handler (port of
``seldon_core_tpu/serving/wire.py::engine_predictions``).

Every failure leaves as the reference's status-JSON body with the error
code's HTTP status, never as an HTML 500.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field

from seldon_core_tpu_torch.core.codec_json import message_from_json, message_to_json
from seldon_core_tpu_torch.core.errors import APIException, ErrorCode

log = logging.getLogger(__name__)


@dataclass
class WireRequest:
    """What a transport reduces a request to: method, path, LOWERCASE
    header dict, raw body bytes."""

    method: str
    path: str
    headers: dict[str, str]
    body: bytes


@dataclass
class WireResponse:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json"
    headers: dict[str, str] = field(default_factory=dict)

    @staticmethod
    def text(text: str, status: int = 200) -> "WireResponse":
        return WireResponse(status=status, body=text.encode(), content_type="text/plain")


def failure_response(e: BaseException, op: str) -> WireResponse:
    if not isinstance(e, APIException):
        log.exception("unhandled error serving %s", op)
        e = APIException(ErrorCode.ENGINE_MICROSERVICE_ERROR, str(e))
    return WireResponse(status=e.error.http_status, body=json.dumps(e.to_status_json()).encode())


async def engine_predictions(service, req: WireRequest) -> WireResponse:
    """POST /api/v0.1/predictions against one PredictionService (JSON
    bodies; binary tensor payloads are not part of this port)."""
    try:
        ctype = req.headers.get("content-type", "").split(";", 1)[0].strip().lower()
        if ctype in ("application/x-npy", "application/octet-stream"):
            raise APIException(
                ErrorCode.ENGINE_INVALID_JSON,
                f"content type {ctype} is not served by the torch port; send JSON",
            )
        out = await service.predict(message_from_json(req.body))
        return WireResponse(body=message_to_json(out).encode())
    except Exception as e:  # noqa: BLE001 - wire boundary
        return failure_response(e, "predict")
