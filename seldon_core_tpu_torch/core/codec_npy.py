"""Binary tensor codec: npy bytes <-> numpy arrays.

Port of ``seldon_core_tpu/core/codec_npy.py``. The JSON wire spends 8-18
bytes per value; the standard npy container (``numpy.lib.format``) carries a
224x224x3 uint8 image in 147 KB. Every numpy client makes it with
``np.save``, and it decodes without a copy for C-contiguous arrays.

Ingress rule (``serving/service.py``): a request whose ``binData`` arm
starts with the npy magic, or whose REST body is ``application/x-npy``, is
decoded into the tensor ``data`` arm before the micro-batcher, and the
response tensor goes back as npy. Other ``binData`` stays opaque.
"""

from __future__ import annotations

import io

import numpy as np

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode

NPY_MAGIC = b"\x93NUMPY"


def is_npy(raw: bytes | None) -> bool:
    return raw is not None and raw[: len(NPY_MAGIC)] == NPY_MAGIC


def array_from_npy(raw: bytes) -> np.ndarray:
    """Decode npy bytes. allow_pickle stays False: an object-dtype payload
    would otherwise run arbitrary code on the serving path."""
    try:
        arr = np.load(io.BytesIO(raw), allow_pickle=False)
    except Exception as e:  # noqa: BLE001 - wire input, map to error taxonomy
        raise APIException(ErrorCode.ENGINE_INVALID_JSON, f"bad npy payload: {e}") from e
    if arr.dtype == object:  # defense in depth; np.load refuses already
        raise APIException(ErrorCode.ENGINE_INVALID_JSON, "object npy refused")
    return arr


def npy_from_array(array) -> bytes:
    arr = np.asarray(array)
    if arr.dtype.kind == "V" or not arr.dtype.isnative or arr.dtype.hasobject:
        # dtypes no npy client decodes travel as float32
        arr = arr.astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()
