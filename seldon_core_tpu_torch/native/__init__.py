"""Native wire codec: g++ build at first use, ctypes binding, Python fallback.

Port of ``seldon_core_tpu/native/__init__.py``; ``fastcodec.cpp`` beside
this file is the JAX package's source byte for byte. The C++ side parses
and serializes the ndarray number matrix and parses the HTTP/1.1 request
head, the CPU cost of a REST prediction once the graph runs in-process:

    find_ndarray_span(raw: bytes) -> (start, end) | None
    parse_ndarray(raw: bytes) -> np.ndarray (float32, 1D or 2D) | None
    encode_ndarray(arr) -> bytes | None
    pad_rows(arr, bucket) -> np.ndarray
    parse_http_head(buf) -> ParsedHead | 0 | -1 | None

Every entry returns None (or falls back to numpy) when the library is
unavailable or the payload is not a rectangular numeric array; callers keep
the pure-Python path as the semantic source of truth.

One difference from the JAX module, on purpose: the library is built into
the checkout's git-ignored ``build/native/`` (named by a hash of the
source, under a pid-unique temporary name, then renamed), never next to the
source, and never at import: the first call that needs it builds it. A
failed build logs a warning. ``stats()`` counts, per entry, the calls the C
path answered and those that fell back to Python, so a host where the
library quietly failed to build shows it; ``python_only()`` turns the
library off inside a ``with`` block (a test hook for measuring the codec
against the Python path in one process).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "fastcodec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

ENTRIES = ("find_ndarray_span", "parse_ndarray", "encode_ndarray", "pad_rows", "parse_http_head")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False
_forced_off = False

_stats_lock = threading.Lock()
_stats = {name: {"c": 0, "python": 0} for name in ENTRIES}


def _count(entry: str, path: str) -> None:
    with _stats_lock:
        _stats[entry][path] += 1


def stats() -> dict:
    """``{"available", "library", "entries": {entry: {"c", "python"}}}``:
    per entry, the calls the C path answered and the calls that fell back
    to Python (no library, or a payload the C side declined)."""
    with _stats_lock:
        entries = {k: dict(v) for k, v in _stats.items()}
    return {"available": _lib is not None and not _forced_off,
            "library": None if _lib is None else _lib._name, "entries": entries}


def reset_stats() -> None:
    with _stats_lock:
        for v in _stats.values():
            v["c"] = v["python"] = 0


@contextlib.contextmanager
def python_only():
    """Within the block every entry takes its Python path, as on a host
    without a compiler."""
    global _forced_off
    prev, _forced_off = _forced_off, True
    try:
        yield
    finally:
        _forced_off = prev


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"_fastcodec-{digest}.so"


def _build() -> Path | None:
    try:
        so = library_path()
        if so.exists():
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # pid-unique temp name: concurrent processes (a platform and a
        # microservice on one host) may both build; a shared temp path would
        # interleave writes and the rename could install a corrupt library
        tmp = so.with_name(f"{so.name}.tmp.{os.getpid()}")
        try:
            res = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SRC)],
                capture_output=True,
                timeout=120,
            )
            if res.returncode != 0:
                log.warning("fastcodec build failed; the wire codec runs in Python: %s",
                            res.stderr.decode()[:500])
                return None
            tmp.replace(so)
        finally:
            # a failed or timed-out build must not strand its temp file
            with contextlib.suppress(OSError):
                tmp.unlink()
        return so
    except Exception as e:  # noqa: BLE001 - no compiler, read-only checkout
        log.warning("fastcodec build unavailable; the wire codec runs in Python: %s", e)
        return None


def get_lib():
    """The loaded library or None. Thread-safe, builds at most once."""
    global _lib, _build_failed
    if _forced_off:
        return None
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _build()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.ndarray_find.restype = ctypes.c_int
        lib.ndarray_find.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.ndarray_probe.restype = ctypes.c_int
        lib.ndarray_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.ndarray_parse.restype = ctypes.c_int
        lib.ndarray_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.c_long,
        ]
        lib.ndarray_encode.restype = ctypes.c_long
        lib.ndarray_encode.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_long,
        ]
        lib.pad_rows_f32.restype = ctypes.c_int
        lib.pad_rows_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.http_parse_head.restype = ctypes.c_long
        lib.http_parse_head.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),  # method_len
            ctypes.POINTER(ctypes.c_long),  # path_off
            ctypes.POINTER(ctypes.c_long),  # path_len
            ctypes.POINTER(ctypes.c_longlong),  # content_length
            ctypes.POINTER(ctypes.c_long),  # flags
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),  # ctype
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),  # auth
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def find_ndarray_span(raw: bytes) -> tuple[int, int] | None:
    lib = get_lib()
    if lib is None:
        _count("find_ndarray_span", "python")
        return None
    start, end = ctypes.c_long(), ctypes.c_long()
    rc = lib.ndarray_find(raw, len(raw), ctypes.byref(start), ctypes.byref(end))
    _count("find_ndarray_span", "c" if rc == 0 else "python")
    if rc != 0:
        return None
    return start.value, end.value


def parse_ndarray(raw: bytes) -> np.ndarray | None:
    """Parse a JSON 1D/2D numeric array (bytes) to float32. None on any
    deviation (ragged, strings, nesting >2): the caller falls back to json."""
    lib = get_lib()
    if lib is None:
        _count("parse_ndarray", "python")
        return None
    rows, cols = ctypes.c_long(), ctypes.c_long()
    is2d = ctypes.c_int()
    rc = lib.ndarray_probe(
        raw, len(raw), ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(is2d)
    )
    if rc != 0:
        _count("parse_ndarray", "python")
        return None
    r, c = rows.value, cols.value
    out = np.empty(r * c, dtype=np.float32)
    if r * c:
        rc = lib.ndarray_parse(
            raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), r, c
        )
        if rc != 0:
            _count("parse_ndarray", "python")
            return None
    _count("parse_ndarray", "c")
    return out.reshape(r, c) if is2d.value else out.reshape(c)


def encode_ndarray(arr: np.ndarray) -> bytes | None:
    """float32 2D matrix -> JSON bytes ('[[...],[...]]'). None if the
    library is absent or the array is not 2D float-convertible."""
    lib = get_lib()
    if lib is None or arr.ndim != 2:
        _count("encode_ndarray", "python")
        return None
    a = np.ascontiguousarray(arr, dtype=np.float32)
    cap = a.size * 32 + a.shape[0] * 2 + 16
    buf = ctypes.create_string_buffer(cap)
    n = lib.ndarray_encode(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        a.shape[0],
        a.shape[1],
        buf,
        cap,
    )
    if n < 0:
        _count("encode_ndarray", "python")
        return None
    _count("encode_ndarray", "c")
    return buf.raw[:n]


def pad_rows(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad the batch axis to ``bucket`` (C memcpy when available)."""
    a = np.ascontiguousarray(arr, dtype=np.float32)
    n, feat = a.shape[0], int(np.prod(a.shape[1:], initial=1))
    lib = get_lib()
    if lib is None:
        _count("pad_rows", "python")
        out = np.zeros((bucket, *a.shape[1:]), dtype=np.float32)
        out[:n] = a
        return out
    out = np.empty((bucket, *a.shape[1:]), dtype=np.float32)
    rc = lib.pad_rows_f32(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        feat,
        bucket,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    _count("pad_rows", "c")
    if rc != 0:
        raise ValueError(f"pad_rows: batch {n} exceeds bucket {bucket}")
    return out


# HTTP head-parse flag bits (mirror fastcodec.cpp)
HDRF_HAS_CTYPE = 1
HDRF_CONN_CLOSE = 2
HDRF_HAS_TE = 4  # Transfer-Encoding header present (any value)
HDRF_HAS_CLEN = 8


class ParsedHead:
    """One parsed HTTP/1.1 request head (C fast path)."""

    __slots__ = ("body_start", "method", "path", "content_length", "flags",
                 "content_type", "authorization")

    def __init__(self, body_start, method, path, content_length, flags,
                 content_type, authorization):
        self.body_start = body_start
        self.method = method
        self.path = path
        self.content_length = content_length  # -1 when the header is absent
        self.flags = flags
        self.content_type = content_type  # raw value or None
        self.authorization = authorization  # raw value or None


# one source of truth for the head-parse out-buffer capacities: the scratch
# allocation, the caps passed to C and the truncation checks move together
# (a cap raised past the allocation would make the C memcpy overflow)
_CTYPE_CAP = 512
_AUTH_CAP = 4096

_parse_tls = threading.local()


def _parse_scratch():
    """Per-thread reusable ctypes out-params for parse_http_head, which the
    hot path calls once a request."""
    s = getattr(_parse_tls, "scratch", None)
    if s is None:
        s = (
            ctypes.c_long(),  # method_len
            ctypes.c_long(),  # path_off
            ctypes.c_long(),  # path_len
            ctypes.c_longlong(),  # clen
            ctypes.c_long(),  # flags
            ctypes.create_string_buffer(_CTYPE_CAP),
            ctypes.c_long(),  # ctype_len
            ctypes.create_string_buffer(_AUTH_CAP),
            ctypes.c_long(),  # auth_len
        )
        _parse_tls.scratch = s
    return s


def parse_http_head(buf) -> "ParsedHead | int | None":
    """Parse an HTTP/1.1 request head in one C pass.

    Returns a ParsedHead, 0 when the head is incomplete (read more), -1
    when malformed, or None when the library is unavailable or a captured
    value may be truncated (the caller uses its Python parse)."""
    lib = get_lib()
    if lib is None:
        _count("parse_http_head", "python")
        return None
    raw = bytes(buf)
    (
        method_len,
        path_off,
        path_len,
        clen,
        flags,
        ctype_buf,
        ctype_len,
        auth_buf,
        auth_len,
    ) = _parse_scratch()
    rc = lib.http_parse_head(
        raw, len(raw),
        ctypes.byref(method_len),
        ctypes.byref(path_off), ctypes.byref(path_len),
        ctypes.byref(clen), ctypes.byref(flags),
        ctype_buf, _CTYPE_CAP, ctypes.byref(ctype_len),
        auth_buf, _AUTH_CAP, ctypes.byref(auth_len),
    )
    if rc <= 0:
        # an incomplete or malformed head may have copied an Authorization
        # value before the parse stopped: the reused scratch must not keep it
        ctypes.memset(auth_buf, 0, _AUTH_CAP)
        _count("parse_http_head", "c")
        return 0 if rc == 0 else -1
    if ctype_len.value >= _CTYPE_CAP or auth_len.value >= _AUTH_CAP:
        # possible truncation (an oversized JWT): a clipped credential would
        # 401 here and pass the Python parse, so hand the head to Python
        ctypes.memset(auth_buf, 0, _AUTH_CAP)
        _count("parse_http_head", "python")
        return None
    head = ParsedHead(
        body_start=int(rc),
        method=raw[: method_len.value].decode("latin-1"),
        path=raw[path_off.value : path_off.value + path_len.value].decode("latin-1"),
        content_length=int(clen.value),
        flags=int(flags.value),
        content_type=(
            ctype_buf.raw[: ctype_len.value].decode("latin-1")
            if ctype_len.value >= 0
            else None
        ),
        authorization=(
            auth_buf.raw[: auth_len.value].decode("latin-1")
            if auth_len.value >= 0
            else None
        ),
    )
    if auth_len.value > 0:
        # the reused scratch must not keep the client's credential past the
        # request
        ctypes.memset(auth_buf, 0, auth_len.value)
    _count("parse_http_head", "c")
    return head
