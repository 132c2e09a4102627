"""Transport-neutral engine handlers (port of
``seldon_core_tpu/serving/wire.py``: ``engine_predictions``,
``engine_feedback``, ``classify_binary_bytes`` and ``npy_wire_response``).

Every failure leaves as the reference's status-JSON body with the error
code's HTTP status, never as an HTML 500.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field

from seldon_core_tpu_torch.core.codec_json import (
    feedback_from_dict,
    message_from_json,
    message_to_json,
    meta_to_dict,
)
from seldon_core_tpu_torch.core.codec_npy import is_npy
from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import SeldonMessage

log = logging.getLogger(__name__)

NPY_CONTENT_TYPES = ("application/x-npy", "application/octet-stream")
# a Seldon-Meta header longer than this is cut to puid and routing
META_HEADER_MAX = 6144


@dataclass
class WireRequest:
    """What a transport reduces a request to: method, path, LOWERCASE
    header dict, raw body bytes."""

    method: str
    path: str
    headers: dict[str, str]
    body: bytes

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "").split(";", 1)[0].strip().lower()


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


def classify_binary_bytes(ctype: str, raw: bytes) -> str:
    """``"npy"``, ``"bin"`` or ``"json"``: application/x-npy is npy;
    application/octet-stream is npy when the bytes start with the npy
    magic, else opaque binData; any other content type is JSON."""
    if ctype not in NPY_CONTENT_TYPES:
        return "json"
    if ctype == "application/x-npy" or is_npy(raw):
        return "npy"
    return "bin"


def npy_wire_response(out: SeldonMessage) -> WireResponse:
    """Raw npy body, meta in the ``Seldon-Meta`` header; a meta longer than
    META_HEADER_MAX is cut to puid and routing with ``truncated``."""
    meta_json = json.dumps(meta_to_dict(out.meta))
    if len(meta_json) > META_HEADER_MAX:
        meta_json = json.dumps(
            {"puid": out.meta.puid, "routing": dict(out.meta.routing), "truncated": True}
        )
    return WireResponse(body=out.bin_data, content_type="application/x-npy", headers={"Seldon-Meta": meta_json})


async def engine_predictions(service, req: WireRequest) -> WireResponse:
    """POST /api/v0.1/predictions against one PredictionService: a JSON
    SeldonMessage, or a raw npy body answered in npy."""
    try:
        kind = classify_binary_bytes(req.content_type, req.body)
        if kind != "json":
            out = await service.predict(SeldonMessage(bin_data=req.body), wire_npy=kind == "npy")
            if kind == "npy" and is_npy(out.bin_data):
                return npy_wire_response(out)
            return WireResponse(body=message_to_json(out).encode())
        out = await service.predict(message_from_json(req.body))
        return WireResponse(body=message_to_json(out).encode())
    except Exception as e:  # noqa: BLE001 - wire boundary
        return failure_response(e, "predict")


async def engine_feedback(service, req: WireRequest) -> WireResponse:
    """POST /api/v0.1/feedback: a JSON Feedback whose response meta carries
    the routing to reward."""
    try:
        try:
            obj = json.loads(req.body)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise APIException(ErrorCode.ENGINE_INVALID_JSON, str(e)) from e
        out = await service.send_feedback(feedback_from_dict(obj))
        return WireResponse(body=message_to_json(out).encode())
    except Exception as e:  # noqa: BLE001 - wire boundary
        return failure_response(e, "feedback")
