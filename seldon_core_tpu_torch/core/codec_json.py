"""JSON wire codec for SeldonMessage (port of ``seldon_core_tpu/core/codec_json.py``).

Wire shapes:

    {"meta": {"puid": ..., "tags": {...}, "routing": {...}},
     "data": {"names": [...], "tensor": {"shape": [...], "values": [...]}}}
    {"data": {"names": [...], "ndarray": [[...], ...]}}
    {"binData": "<base64>"} | {"strData": "..."}
    {"status": {"code": ..., "info": ..., "reason": ..., "status": "FAILURE"}}

    {"request": {...}, "response": {...}, "reward": r, "truth": {...}}  (Feedback)

The pure-Python path only; arrays decode to host numpy, and a tensor payload
on any device is read back to the host when encoded.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Mapping

import numpy as np

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import (
    DataKind,
    DefaultData,
    Feedback,
    Meta,
    SeldonMessage,
    Status,
    StatusFlag,
)
from seldon_core_tpu_torch.core.tensor import to_host

DEFAULT_DTYPE = np.float32  # the reference wire format is float64


def _decode_default_data(obj: Mapping[str, Any], dtype: Any) -> DefaultData:
    if not isinstance(obj, Mapping):
        raise APIException(ErrorCode.ENGINE_INVALID_JSON, "data must be a JSON object")
    names = tuple(obj.get("names") or ())
    if "tensor" in obj:
        t = obj["tensor"]
        try:
            values = np.asarray(t.get("values", []), dtype=dtype)
            shape = tuple(int(s) for s in t.get("shape", []))
            array = values.reshape(shape) if shape else values
        except (AttributeError, ValueError, TypeError) as e:
            raise APIException(ErrorCode.ENGINE_INVALID_JSON, f"bad tensor: {e}") from e
        return DefaultData(names=names, array=array, kind=DataKind.TENSOR)
    if "ndarray" in obj:
        try:
            array = np.asarray(obj["ndarray"], dtype=dtype)
        except (ValueError, TypeError):
            # non-numeric payloads keep numpy's inferred dtype, as the
            # reference microservice does; numeric models fail later
            try:
                array = np.asarray(obj["ndarray"])
            except (ValueError, TypeError) as e:
                raise APIException(
                    ErrorCode.ENGINE_INVALID_JSON, f"bad ndarray: {e}"
                ) from e
        return DefaultData(names=names, array=array, kind=DataKind.NDARRAY)
    raise APIException(ErrorCode.ENGINE_INVALID_JSON, "data must contain tensor or ndarray")


def _decode_meta(obj: Mapping[str, Any] | None) -> Meta:
    if not obj:
        return Meta()
    return Meta(
        puid=obj.get("puid", ""),
        tags=dict(obj.get("tags") or {}),
        routing={k: int(v) for k, v in (obj.get("routing") or {}).items()},
        request_path=dict(obj.get("requestPath") or {}),
    )


def _decode_status(obj: Mapping[str, Any] | None) -> Status | None:
    if not obj:
        return None
    flag = obj.get("status", "SUCCESS")
    return Status(
        code=int(obj.get("code", 200)),
        info=obj.get("info", ""),
        reason=obj.get("reason", ""),
        status=StatusFlag.FAILURE if flag in ("FAILURE", 1) else StatusFlag.SUCCESS,
    )


def message_from_dict(obj: Mapping[str, Any], dtype: Any = DEFAULT_DTYPE) -> SeldonMessage:
    if not isinstance(obj, Mapping):
        raise APIException(ErrorCode.ENGINE_INVALID_JSON, "message must be a JSON object")
    meta = _decode_meta(obj.get("meta"))
    status = _decode_status(obj.get("status"))
    if "data" in obj:
        return SeldonMessage(data=_decode_default_data(obj["data"], dtype), meta=meta, status=status)
    if "binData" in obj:
        try:
            raw = base64.b64decode(obj["binData"])
        except Exception as e:  # noqa: BLE001 - normalise any b64 failure
            raise APIException(ErrorCode.ENGINE_INVALID_JSON, f"bad binData: {e}") from e
        return SeldonMessage(bin_data=raw, meta=meta, status=status)
    if "strData" in obj:
        return SeldonMessage(str_data=str(obj["strData"]), meta=meta, status=status)
    if "jsonData" in obj:
        return SeldonMessage(json_data=obj["jsonData"], meta=meta, status=status)
    return SeldonMessage(meta=meta, status=status)


def message_from_json(text: str | bytes, dtype: Any = DEFAULT_DTYPE) -> SeldonMessage:
    try:
        obj = json.loads(text)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise APIException(ErrorCode.ENGINE_INVALID_JSON, str(e)) from e
    return message_from_dict(obj, dtype)


def feedback_from_dict(obj: Mapping[str, Any], dtype: Any = DEFAULT_DTYPE) -> Feedback:
    if not isinstance(obj, Mapping):
        raise APIException(ErrorCode.ENGINE_INVALID_JSON, "feedback must be a JSON object")
    return Feedback(
        request=message_from_dict(obj["request"], dtype) if "request" in obj else None,
        response=message_from_dict(obj["response"], dtype) if "response" in obj else None,
        reward=float(obj.get("reward", 0.0)),
        truth=message_from_dict(obj["truth"], dtype) if "truth" in obj else None,
    )


def _encode_array(data: DefaultData) -> dict[str, Any]:
    out: dict[str, Any] = {}
    if data.names:
        out["names"] = list(data.names)
    arr = to_host(data.array)
    if data.kind == DataKind.NDARRAY:
        out["ndarray"] = arr.tolist()
    else:
        out["tensor"] = {
            "shape": [int(s) for s in arr.shape],
            "values": arr.reshape(-1).astype(np.float64).tolist(),
        }
    return out


def _encode_meta(meta: Meta) -> dict[str, Any]:
    out: dict[str, Any] = {"puid": meta.puid}
    if meta.tags:
        out["tags"] = dict(meta.tags)
    if meta.routing:
        out["routing"] = dict(meta.routing)
    if meta.request_path:
        out["requestPath"] = dict(meta.request_path)
    return out


def message_to_dict(msg: SeldonMessage) -> dict[str, Any]:
    out: dict[str, Any] = {"meta": _encode_meta(msg.meta)}
    if msg.status is not None:
        out["status"] = {
            "code": msg.status.code,
            "info": msg.status.info,
            "reason": msg.status.reason,
            "status": msg.status.status.name,
        }
    if msg.data is not None:
        out["data"] = _encode_array(msg.data)
    elif msg.bin_data is not None:
        out["binData"] = base64.b64encode(msg.bin_data).decode("ascii")
    elif msg.str_data is not None:
        out["strData"] = msg.str_data
    elif msg.json_data is not None:
        out["jsonData"] = msg.json_data
    return out


def message_to_json(msg: SeldonMessage) -> str:
    return json.dumps(message_to_dict(msg))


# meta alone, for binary responses that carry it in a header
meta_to_dict = _encode_meta


def feedback_to_dict(fb: Feedback) -> dict[str, Any]:
    out: dict[str, Any] = {"reward": fb.reward}
    if fb.request is not None:
        out["request"] = message_to_dict(fb.request)
    if fb.response is not None:
        out["response"] = message_to_dict(fb.response)
    if fb.truth is not None:
        out["truth"] = message_to_dict(fb.truth)
    return out
