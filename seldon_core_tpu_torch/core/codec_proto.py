"""Protobuf wire codec for SeldonMessage / Feedback / SeldonMessageList.

Port of ``seldon_core_tpu/core/codec_proto.py``, over the port's
``core/message.py``: the counterpart of ``codec_json`` at the gRPC edge,
with the reference contract's field numbers (``proto/prediction.proto``).
Arrays decode to host numpy as float32 by default; a ``tensor`` travels as
``repeated double`` (float64), and a payload on the card is read back to
the host when encoded. The ``jsonData`` arm has no proto field and encodes
as a message without data, as in the JAX codec.

Importing this module imports ``google.protobuf``: the port imports it
only inside the functions that serve or call gRPC.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
from google.protobuf import struct_pb2

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
from seldon_core_tpu_torch.proto import prediction_pb2 as pb

DEFAULT_DTYPE = np.float32


# ---------------------------------------------------------------- value glue


def _value_to_py(v: struct_pb2.Value) -> Any:
    kind = v.WhichOneof("kind")
    if kind == "number_value":
        return v.number_value
    if kind == "string_value":
        return v.string_value
    if kind == "bool_value":
        return v.bool_value
    if kind == "list_value":
        return [_value_to_py(x) for x in v.list_value.values]
    if kind == "struct_value":
        return {k: _value_to_py(x) for k, x in v.struct_value.fields.items()}
    return None


def _py_to_value(obj: Any) -> struct_pb2.Value:
    v = struct_pb2.Value()
    if obj is None:
        v.null_value = struct_pb2.NULL_VALUE
    elif isinstance(obj, bool):
        v.bool_value = obj
    elif isinstance(obj, (int, float)):
        v.number_value = float(obj)
    elif isinstance(obj, str):
        v.string_value = obj
    elif isinstance(obj, (list, tuple)):
        v.list_value.values.extend(_py_to_value(x) for x in obj)
    elif isinstance(obj, Mapping):
        for k, x in obj.items():
            v.struct_value.fields[k].CopyFrom(_py_to_value(x))
    else:
        v.string_value = str(obj)
    return v


def _ndarray_to_listvalue(arr: np.ndarray) -> struct_pb2.ListValue:
    lv = struct_pb2.ListValue()

    def fill(target: struct_pb2.ListValue, a) -> None:
        if a.ndim == 1:
            for x in a:
                target.values.append(struct_pb2.Value(number_value=float(x)))
            return
        for row in a:
            fill(target.values.add().list_value, row)

    fill(lv, np.asarray(arr, dtype=np.float64))
    return lv


def _listvalue_to_ndarray(lv: struct_pb2.ListValue, dtype) -> np.ndarray:
    return np.asarray([_value_to_py(v) for v in lv.values], dtype=dtype)


# ------------------------------------------------------------------- decode


def message_from_proto(m: pb.SeldonMessage, dtype: Any = DEFAULT_DTYPE) -> SeldonMessage:
    meta = Meta(
        puid=m.meta.puid,
        tags={k: _value_to_py(v) for k, v in m.meta.tags.items()},
        routing=dict(m.meta.routing),
        request_path=dict(m.meta.requestPath),
    )
    status = None
    if m.HasField("status"):
        status = Status(
            code=m.status.code,
            info=m.status.info,
            reason=m.status.reason,
            status=StatusFlag(m.status.status),
        )
    arm = m.WhichOneof("data_oneof")
    if arm == "data":
        names = tuple(m.data.names)
        if m.data.WhichOneof("data_oneof") == "tensor":
            t = m.data.tensor
            values = np.fromiter(t.values, dtype=np.float64, count=len(t.values)).astype(dtype)
            array = values.reshape(tuple(t.shape)) if len(t.shape) else values
            data = DefaultData(names=names, array=array, kind=DataKind.TENSOR)
        else:
            data = DefaultData(names=names, array=_listvalue_to_ndarray(m.data.ndarray, dtype), kind=DataKind.NDARRAY)
        return SeldonMessage(data=data, meta=meta, status=status)
    if arm == "binData":
        return SeldonMessage(bin_data=m.binData, meta=meta, status=status)
    if arm == "strData":
        return SeldonMessage(str_data=m.strData, meta=meta, status=status)
    return SeldonMessage(meta=meta, status=status)


def feedback_from_proto(f: pb.Feedback, dtype: Any = DEFAULT_DTYPE) -> Feedback:
    return Feedback(
        request=message_from_proto(f.request, dtype) if f.HasField("request") else None,
        response=message_from_proto(f.response, dtype) if f.HasField("response") else None,
        reward=f.reward,
        truth=message_from_proto(f.truth, dtype) if f.HasField("truth") else None,
    )


def message_list_from_proto(ml: pb.SeldonMessageList, dtype: Any = DEFAULT_DTYPE) -> list[SeldonMessage]:
    return [message_from_proto(m, dtype) for m in ml.seldonMessages]


# ------------------------------------------------------------------- encode


def message_to_proto(msg: SeldonMessage) -> pb.SeldonMessage:
    m = pb.SeldonMessage()
    m.meta.puid = msg.meta.puid
    for k, v in msg.meta.tags.items():
        m.meta.tags[k].CopyFrom(_py_to_value(v))
    for k, v in msg.meta.routing.items():
        m.meta.routing[k] = int(v)
    for k, v in msg.meta.request_path.items():
        m.meta.requestPath[k] = str(v)
    if msg.status is not None:
        m.status.code = msg.status.code
        m.status.info = msg.status.info
        m.status.reason = msg.status.reason
        m.status.status = int(msg.status.status)
    if msg.data is not None:
        m.data.names.extend(msg.data.names)
        arr = to_host(msg.data.array)
        if msg.data.kind == DataKind.NDARRAY:
            m.data.ndarray.CopyFrom(_ndarray_to_listvalue(arr))
        else:
            m.data.tensor.shape.extend(int(s) for s in arr.shape)
            m.data.tensor.values.extend(arr.reshape(-1).astype(np.float64).tolist())
    elif msg.bin_data is not None:
        m.binData = msg.bin_data
    elif msg.str_data is not None:
        m.strData = msg.str_data
    return m


def feedback_to_proto(fb: Feedback) -> pb.Feedback:
    f = pb.Feedback()
    if fb.request is not None:
        f.request.CopyFrom(message_to_proto(fb.request))
    if fb.response is not None:
        f.response.CopyFrom(message_to_proto(fb.response))
    f.reward = float(fb.reward)
    if fb.truth is not None:
        f.truth.CopyFrom(message_to_proto(fb.truth))
    return f


def message_list_to_proto(msgs: Sequence[SeldonMessage]) -> pb.SeldonMessageList:
    out = pb.SeldonMessageList()
    for m in msgs:
        out.seldonMessages.append(message_to_proto(m))
    return out
