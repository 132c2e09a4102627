"""The subset of msgpack that flax's ``serialization.to_bytes`` writes.

The JAX package saves a parameter tree as ``flax.serialization.to_bytes``;
the card's host has neither ``flax`` nor ``msgpack``, so the port keeps
this codec, byte for byte what ``msgpack.packb`` writes for the same tree:

- maps, arrays, str, bin, int, float (float64), bool and nil;
- ext 1, an ndarray, packed as the msgpack array ``(shape, dtype name,
  C-order bytes)``; ext 3, a numpy scalar, packed the same way as a
  0-d array;
- flax's state-dict conventions: a list is stored as a map keyed ``"0"``,
  ``"1"``, ...; a leaf over ``MAX_CHUNK_SIZE`` bytes is stored as
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  of flat pieces, each at most ``MAX_CHUNK_SIZE`` bytes.

``bfloat16`` arrays (the dtype name flax writes for them) decode through
``torch.frombuffer`` and widen to float32, since numpy has no bfloat16.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax's: msgpack holds at most 2**31 - 1 bytes per object
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# ------------------------------------------------------------------ encoding


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"), (0xFFFFFFFF, 0xCE, ">I"),
                                 (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack's uint64")
    else:
        for limit, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"), (-0x80000000, 0xD2, ">i"),
                                 (-0x8000000000000000, 0xD3, ">q")):
            if v >= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack's int64")


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int, codes: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32-bit
    form (``codes``; None where the family has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for limit, code, fmt in zip((0xFF, 0xFFFF, 0xFFFFFFFF), codes, (">B", ">H", ">I")):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of ndarrays.")
    return packb((tuple(a.shape), a.dtype.name, a.tobytes("C")))


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif type(obj) is dict:
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif type(obj) in (list, tuple):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} into a flax state dict")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# ------------------------------------------------------------------ decoding


def _dtype_array(buf: bytes, name: str, shape) -> np.ndarray:
    if name == "bfloat16":
        t = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16) if buf else torch.empty(0, dtype=torch.bfloat16)
        return t.float().numpy().reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is not one flax writes for a parameter tree")
    shape, name, buf = unpackb(data)
    a = _dtype_array(buf, name if isinstance(name, str) else name.decode(), tuple(shape))
    return a if code == EXT_NDARRAY else a[()]


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos : self.pos + n].tobytes()
        self.pos += n
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in sized:
            return self.take(self.num(sized[c]))
        if c in (0xC7, 0xC8, 0xC9):
            n = self.num({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c])
            code = self.num(">b")
            return _ext(code, self.take(n))
        if c == 0xCA:
            return self.num(">f")
        if c == 0xCB:
            return self.num(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in ints:
            return self.num(ints[c])
        if c in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            code = self.num(">b")
            return _ext(code, self.take({0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}[c]))
        if c in (0xD9, 0xDA, 0xDB):
            return self.take(self.num({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[c])).decode("utf-8")
        if c in (0xDC, 0xDD):
            return self.array(self.num(">H" if c == 0xDC else ">I"))
        if c in (0xDE, 0xDF):
            return self.map(self.num(">H" if c == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{c:02x} is not one flax writes")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes):
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of msgpack data follow the object")
    return obj


# --------------------------------------------------------- flax's state dicts


def _chunk(a: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / a.dtype.itemsize))
    flat = a.reshape(-1)
    pieces = [flat[i : i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(a.shape)},
            "chunks": {str(i): p for i, p in enumerate(pieces)}}


def to_state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict``, then its chunking: dicts keep their keys as
    str, lists and tuples become maps keyed by index, an array leaf over
    ``MAX_CHUNK_SIZE`` bytes becomes the chunked form."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def unchunk(state: Any) -> Any:
    """The chunked leaves of a restored state dict as whole arrays."""
    if isinstance(state, dict):
        if CHUNKED in state:
            shape = tuple(state["shape"][str(i)] for i in range(len(state["shape"])))
            pieces = [state["chunks"][str(i)] for i in range(len(state["chunks"]))]
            return np.concatenate(pieces).reshape(shape)
        return {k: unchunk(v) for k, v in state.items()}
    return state


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes`` of a tree of dicts, lists and numpy
    leaves."""
    return packb(to_state_dict(tree))


def restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the state dict, chunked
    leaves joined."""
    return unchunk(unpackb(data))
