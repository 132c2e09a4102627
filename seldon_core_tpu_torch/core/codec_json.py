"""JSON wire codec for SeldonMessage (port of ``seldon_core_tpu/core/codec_json.py``).

Wire shapes:

    {"meta": {"puid": ..., "tags": {...}, "routing": {...}},
     "data": {"names": [...], "tensor": {"shape": [...], "values": [...]}}}
    {"data": {"names": [...], "ndarray": [[...], ...]}}
    {"binData": "<base64>"} | {"strData": "..."}
    {"status": {"code": ..., "info": ..., "reason": ..., "status": "FAILURE"}}

    {"request": {...}, "response": {...}, "reward": r, "truth": {...}}  (Feedback)

Arrays decode to host numpy, and a tensor payload on any device is read back
to the host when encoded. ``message_from_json_fast`` and
``message_to_json_fast`` move the number matrix through the native codec
(``native/``) on bodies large enough to gain, and fall back to the Python
path on anything else, as the JAX package's do.
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


# Below this body size the C matrix codec loses: the span search, splice
# and ctypes call cost more than parsing a few dozen numbers in Python.
_SMALL_BODY_BYTES = 4096


def message_from_json_fast(raw: bytes, dtype: Any = DEFAULT_DTYPE) -> SeldonMessage:
    """Hot-path decode: the ndarray number matrix (the bulk of the body)
    parses in C (``native/``) and the small envelope in Python json; any
    deviation falls back to ``message_from_json``, which stays the semantic
    source of truth. Small bodies skip the C path entirely."""
    if len(raw) < _SMALL_BODY_BYTES:
        return message_from_json(raw, dtype)
    if dtype is DEFAULT_DTYPE:
        from seldon_core_tpu_torch import native

        span = native.find_ndarray_span(raw)
        if span is not None:
            s, e = span
            array = native.parse_ndarray(raw[s:e])
            if array is not None:
                try:
                    obj = json.loads(raw[:s] + b"null" + raw[e:])
                except (json.JSONDecodeError, UnicodeDecodeError) as exc:
                    raise APIException(ErrorCode.ENGINE_INVALID_JSON, str(exc)) from exc
                data = obj.get("data") if isinstance(obj, Mapping) else None
                # the spliced null must be this message's data.ndarray (not a
                # nested request's), and tensor must not sit beside it (the
                # Python path prefers tensor); otherwise fall back
                if isinstance(data, Mapping) and data.get("ndarray", "") is None and "tensor" not in data:
                    msg = message_from_dict({k: v for k, v in obj.items() if k != "data"}, dtype)
                    return SeldonMessage(
                        data=DefaultData(names=tuple(data.get("names") or ()), array=array, kind=DataKind.NDARRAY),
                        meta=msg.meta,
                        status=msg.status,
                    )
    return message_from_json(raw, dtype)


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


_SENTINEL = "\x00NDARRAY\x00"


def message_to_json_fast(msg: SeldonMessage) -> bytes:
    """Hot-path encode: a float32 2D ndarray of more than 256 values
    serializes in C, the envelope in Python json with a placeholder
    spliced; anything else goes through ``message_to_json``."""
    arr = to_host(msg.data.array) if msg.data is not None else None
    if (
        arr is not None
        and msg.data.kind == DataKind.NDARRAY
        and arr.ndim == 2
        and arr.size > 256  # small matrices: tolist and dumps beat the C call
        and arr.dtype == np.float32  # float64 would lose precision in C
    ):
        from seldon_core_tpu_torch import native

        body = native.encode_ndarray(arr)
        if body is not None:
            obj: dict[str, Any] = {"meta": _encode_meta(msg.meta)}
            if msg.status is not None:
                obj["status"] = {
                    "code": msg.status.code,
                    "info": msg.status.info,
                    "reason": msg.status.reason,
                    "status": msg.status.status.name,
                }
            data: dict[str, Any] = {}
            if msg.data.names:
                data["names"] = list(msg.data.names)
            data["ndarray"] = _SENTINEL
            obj["data"] = data
            text = json.dumps(obj).encode()
            # data is inserted last, so its placeholder is the rightmost
            # occurrence: a client-forged copy of the sentinel in meta tags
            # or names is never the one spliced
            head, _, tail = text.rpartition(b'"\\u0000NDARRAY\\u0000"')
            return head + body + tail
    return message_to_json(msg).encode()


# meta alone, for binary responses that carry it in a header
meta_to_dict = _encode_meta
meta_from_dict = _decode_meta


def feedback_to_dict(fb: Feedback) -> dict[str, Any]:
    out: dict[str, Any] = {"reward": fb.reward}
    if fb.request is not None:
        out["request"] = message_to_dict(fb.request)
    if fb.response is not None:
        out["response"] = message_to_dict(fb.response)
    if fb.truth is not None:
        out["truth"] = message_to_dict(fb.truth)
    return out
