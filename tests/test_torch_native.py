"""The port's native wire codec (``seldon_core_tpu_torch/native``): every case
of the JAX package's ``tests/test_native.py`` on the port's library, the two
libraries' outputs on the same bytes, the fast JSON codecs against the JAX
package's, and the C head parser against the Python one (``serving/
fast_http.py``), drawn at random and by hypothesis."""

import json
import random

import numpy as np
import pytest

from seldon_core_tpu import native as jax_native
from seldon_core_tpu.core import codec_json as jax_codec
from seldon_core_tpu.serving import fast_http as jax_fast_http
from seldon_core_tpu_torch import native
from seldon_core_tpu_torch.core.codec_json import (
    message_from_dict,
    message_from_json,
    message_from_json_fast,
    message_to_dict,
    message_to_json_fast,
)
from seldon_core_tpu_torch.core.errors import APIException
from seldon_core_tpu_torch.core.message import DataKind, DefaultData, Meta, SeldonMessage
from seldon_core_tpu_torch.serving import fast_http
from seldon_core_tpu_torch.serving.fast_http import (
    _MAX_BODY,
    PyHead,
    _header_from_head,
    head_from_c,
    parse_head_py,
)


def _big(obj: dict) -> bytes:
    """A body past the 4096-byte cut, so the C path is taken."""
    raw = json.dumps(obj).encode()
    assert len(raw) >= 4096, len(raw)
    return raw


def _rows(n: int, cols: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cols)).astype(np.float32).tolist()


# ------------------------------------------------ the JAX package's 19 cases


def test_library_builds():
    assert native.available()
    assert native.stats()["library"].startswith(str(native.BUILD_DIR))


def test_find_span_simple():
    raw = b'{"data": {"names": ["a"], "ndarray": [[1.0, 2.0]]}}'
    s, e = native.find_ndarray_span(raw)
    assert raw[s:e] == b"[[1.0, 2.0]]"


def test_find_span_ignores_key_inside_string_value():
    raw = b'{"note": "the \\"ndarray\\" key", "data": {"ndarray": [[3]]}}'
    s, e = native.find_ndarray_span(raw)
    assert raw[s:e] == b"[[3]]"


def test_parse_2d():
    arr = native.parse_ndarray(b"[[1.5, -2e3, 3], [4, 5.25, 6]]")
    np.testing.assert_array_equal(arr, np.asarray([[1.5, -2000.0, 3.0], [4.0, 5.25, 6.0]], np.float32))


def test_parse_1d():
    arr = native.parse_ndarray(b"[1, 2, 3.5]")
    assert arr.shape == (3,)
    assert arr[2] == 3.5


def test_parse_rejects_ragged_and_strings():
    assert native.parse_ndarray(b"[[1, 2], [3]]") is None
    assert native.parse_ndarray(b'[["a", "b"]]') is None
    assert native.parse_ndarray(b"[[[1]]]") is None  # 3D: the Python path


def test_encode_roundtrips_float32_exactly():
    arr = np.random.default_rng(0).standard_normal((7, 5)).astype(np.float32)
    back = np.asarray(json.loads(native.encode_ndarray(arr)), np.float32)
    np.testing.assert_array_equal(back, arr)  # %.9g round-trips float32


def test_pad_rows():
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = native.pad_rows(arr, 4)
    assert out.shape == (4, 3)
    np.testing.assert_array_equal(out[:2], arr)
    assert out[2:].sum() == 0
    with pytest.raises(ValueError):
        native.pad_rows(arr, 1)


@pytest.mark.parametrize("size", ["small", "large"])
def test_fast_decode_matches_python_decode(size):
    rows = [[1.0, 2.0], [3.0, 4.0]] if size == "small" else _rows(300, 2)
    raw = json.dumps({
        "meta": {"puid": "p1", "tags": {"k": "v"}, "routing": {"r": 1}},
        "data": {"names": ["x", "y"], "ndarray": rows},
    }).encode()
    fast, slow = message_from_json_fast(raw), message_from_json(raw)
    np.testing.assert_array_equal(fast.array, slow.array)
    assert fast.names == slow.names
    assert fast.meta.puid == slow.meta.puid
    assert fast.meta.routing == slow.meta.routing
    assert fast.data.kind == DataKind.NDARRAY


def test_fast_decode_falls_back_on_nested_request():
    # a feedback-shaped body whose first ndarray key is a nested request's
    raw = _big({"request": {"data": {"ndarray": _rows(150, 4)}}, "data": {"ndarray": [[1.0]]}})
    np.testing.assert_array_equal(message_from_json_fast(raw).array, message_from_json(raw).array)


def test_fast_decode_falls_back_on_string_categories():
    msg = message_from_json_fast(_big({"data": {"ndarray": [["red", 1.0]] * 500}}))
    assert msg.array.shape == (500, 2)


def test_fast_encode_matches_python_encode():
    msg = message_from_dict({"meta": {"puid": "q"}, "data": {"names": ["a"], "ndarray": _rows(64, 8)}})
    fast, slow = json.loads(message_to_json_fast(msg)), message_to_dict(msg)
    assert fast["meta"]["puid"] == slow["meta"]["puid"]
    assert fast["data"]["names"] == slow["data"]["names"]
    np.testing.assert_array_equal(np.asarray(fast["data"]["ndarray"], np.float32),
                                  np.asarray(slow["data"]["ndarray"], np.float32))


def test_fast_decode_malformed_json_raises_api_exception():
    with pytest.raises(APIException):
        message_from_json_fast(b'{"data": {"ndarray": [[1.0]}')
    with pytest.raises(APIException):
        message_from_json_fast(b'{"data": {"ndarray": ' + json.dumps(_rows(200, 4)).encode() + b'}')


def test_parse_rejects_malformed_number_tokens():
    for bad in (b"[[.5]]", b"[[1-2]]", b"[[1.2.3]]", b"[[5.]]", b"[[+1]]"):
        assert native.parse_ndarray(bad) is None, bad
    arr = native.parse_ndarray(b"[[-1.5e-3, 0.5, 2E4]]")
    np.testing.assert_allclose(arr, [[-0.0015, 0.5, 20000.0]], rtol=1e-6)


def test_fast_encode_survives_forged_sentinel_in_tags():
    msg = message_from_dict({"meta": {"puid": "p", "tags": {"t": "\x00NDARRAY\x00"}},
                             "data": {"ndarray": _rows(40, 8)}})
    out = json.loads(message_to_json_fast(msg))
    assert out["meta"]["tags"]["t"] == "\x00NDARRAY\x00"
    np.testing.assert_array_equal(np.asarray(out["data"]["ndarray"], np.float32), msg.array)


def test_fast_encode_leaves_float64_to_python_path():
    precise = 123456789.12345679
    arr = np.full((20, 20), precise, np.float64)
    msg = SeldonMessage(data=DefaultData(names=(), array=arr, kind=DataKind.NDARRAY), meta=Meta(puid="p"))
    assert json.loads(message_to_json_fast(msg))["data"]["ndarray"][0][0] == precise  # no float32 cut


def test_fast_decode_prefers_tensor_like_oracle():
    raw = _big({"data": {"tensor": {"shape": [1, 2], "values": [9.0, 9.0]}, "ndarray": _rows(200, 4)}})
    fast, slow = message_from_json_fast(raw), message_from_json(raw)
    np.testing.assert_array_equal(fast.array, slow.array)
    assert fast.data.kind == slow.data.kind == DataKind.TENSOR


def test_http_parse_head_fields_and_edges():
    req = (
        b"POST /api/v0.1/predictions?x=1 HTTP/1.1\r\n"
        b"Host: h\r\n"
        b"Content-Type: multipart/form-data; boundary=abc\r\n"
        b"AUTHORIZATION: Bearer tok\r\n"
        b"Connection: close\r\n"
        b"Content-Length: 3\r\n\r\nxyz"
    )
    h = native.parse_http_head(req)
    assert h.method == "POST" and h.path == "/api/v0.1/predictions?x=1"
    assert h.content_length == 3
    assert h.content_type == "multipart/form-data; boundary=abc"
    assert h.authorization == "Bearer tok"
    assert h.flags & native.HDRF_HAS_CTYPE and h.flags & native.HDRF_CONN_CLOSE and h.flags & native.HDRF_HAS_CLEN
    assert req[h.body_start:] == b"xyz"
    assert native.parse_http_head(req[:25]) == 0
    assert native.parse_http_head(b"NOSPACES\r\n\r\n") == -1
    assert native.parse_http_head(b"GET /p HTTP/1.1\r\nContent-Length: 1x\r\n\r\n") == -1
    h2 = native.parse_http_head(b"GET /ready HTTP/1.1\r\nHost: h\r\n\r\n")
    assert not (h2.flags & native.HDRF_HAS_CLEN) and h2.content_length == -1
    assert native.parse_http_head(b"POST /p HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n").flags & native.HDRF_HAS_TE
    h4 = native.parse_http_head(b"POST /p HTTP/1.1\r\nTransfer-Encoding: gzip, chunked\r\n"
                                b"Content-Length: 4\r\n\r\nbody")
    assert h4.flags & native.HDRF_HAS_TE and h4.flags & native.HDRF_HAS_CLEN
    for bad in (
        b"POST /p HTTP/1.1\r\nTransfer-Encoding : chunked\r\nContent-Length: 4\r\n\r\nbody",
        b"POST /p HTTP/1.1\r\nContent-Length: 4\r\nContent-Length: 10\r\n\r\n",
        b"POST /p HTTP/1.1\r\n Transfer-Encoding: chunked\r\nContent-Length: 4\r\n\r\nbody",
        b"POST /p HTTP/1.1\r\nX-A: a\nTransfer-Encoding: chunked\r\nContent-Length: 4\r\n\r\nbody",
        b"POST /p HTTP/1.1\r\nX-A: a\rX-B: b\r\nContent-Length: 4\r\n\r\nbody",
    ):
        assert native.parse_http_head(bad) == -1, bad
    h5 = native.parse_http_head(b"POST /p HTTP/1.1\r\nContent-Length: 4\r\nContent-Length: 4\r\n\r\nbody")
    assert h5.content_length == 4


def test_http_parse_head_hardening():
    assert native.parse_http_head(b"POST /p HTTP/1.1\r\nContent-Length: 18446744073709551620\r\n\r\n") == -1
    assert native.parse_http_head(b"GET /p\r\nContent-Length: 5\r\n\r\nhello") == -1
    assert native.parse_http_head(b"GET /p HTTP/1.1\r\ncontent-length\x00x: 3\r\n\r\n") == -1
    assert native.parse_http_head(b"POST /p HTTP/1.1\r\nTransfer-Encoding\x0c: chunked\r\n"
                                  b"Content-Length: 4\r\n\r\nbody") == -1
    h6 = native.parse_http_head(b"POST /p HTTP/1.1\r\nContent-Length: 4\r\nContent-Length: 04\r\n\r\nbody")
    assert h6.content_length == 4
    # a >4 KB Authorization: the C path declines so Python reads it uncut
    req = b"GET /p HTTP/1.1\r\nAuthorization: Bearer " + b"a" * 5000 + b"\r\n\r\n"
    assert native.parse_http_head(req) is None


# ------------------------------------------- the two libraries on one input

SPANS = [
    b'{"data": {"names": ["a"], "ndarray": [[1.0, 2.0]]}}',
    b'{"note": "the \\"ndarray\\" key", "data": {"ndarray": [[3]]}}',
    b'{"data": {"tensor": {"values": [1]}}}',
    b'{"ndarray": "x"}',
    b"[1, 2]",
]
MATRICES = [
    b"[[1.5, -2e3, 3], [4, 5.25, 6]]", b"[1, 2, 3.5]", b"[[1, 2], [3]]", b'[["a", "b"]]', b"[[[1]]]", b"[[.5]]",
    b"[[1-2]]", b"[[5.]]", b"[[+1]]", b"[[-1.5e-3, 0.5, 2E4]]", b"[]", b"[[]]", b"[[1e39]]", b"[[1e-50, 0]]",
]
HEADS = [
    b"POST /api/v0.1/predictions?x=1 HTTP/1.1\r\nHost: h\r\nContent-Type: application/json\r\n"
    b"AUTHORIZATION: Bearer tok\r\nConnection: close\r\nContent-Length: 3\r\n\r\nxyz",
    b"GET /ready HTTP/1.1\r\nHost: h\r\n\r\n",
    b"POST /p HTTP/1.1\r\nTransfer-Encoding: gzip, chunked\r\nContent-Length: 4\r\n\r\nbody",
    b"POST /p HTTP/1.1\r\nContent-Length: 4\r\nContent-Length: 04\r\n\r\nbody",
    b"POST /p HTTP/1.1\r\nContent-Length: 4\r\nContent-Length: 10\r\n\r\n",
    b"POST /p HTTP/1.1\r\nContent-Type: a\r\nContent-Type: b\r\nContent-Length: 0\r\n\r\n",
    b"GET /p HTTP/1.1\r\nAuthorization: Bearer " + b"a" * 5000 + b"\r\n\r\n",
    b"POST /p HTTP/1.1\r\nContent-Le",
]


def _head_tuple(h):
    if h is None or isinstance(h, int):
        return h
    return (h.body_start, h.method, h.path, h.content_length, h.flags, h.content_type, h.authorization)


@pytest.mark.parametrize("raw", SPANS)
def test_libraries_agree_on_spans(raw):
    assert native.find_ndarray_span(raw) == jax_native.find_ndarray_span(raw)


@pytest.mark.parametrize("raw", MATRICES)
def test_libraries_agree_on_matrices(raw):
    mine, theirs = native.parse_ndarray(raw), jax_native.parse_ndarray(raw)
    assert (mine is None) == (theirs is None)
    if mine is not None:
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (32, 300)])
def test_libraries_agree_on_encode_and_pad(shape):
    arr = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    assert native.encode_ndarray(arr) == jax_native.encode_ndarray(arr)
    np.testing.assert_array_equal(native.pad_rows(arr, shape[0] + 3), jax_native.pad_rows(arr, shape[0] + 3))


@pytest.mark.parametrize("raw", HEADS)
def test_libraries_agree_on_heads(raw):
    assert _head_tuple(native.parse_http_head(raw)) == _head_tuple(jax_native.parse_http_head(raw))


# ------------------------------------- the fast codecs against the JAX ones

CODEC_BODIES = {
    "small": {"meta": {"puid": "a"}, "data": {"ndarray": [[1.0, 2.0]]}},
    "large": {"meta": {"puid": "b", "tags": {"k": "v"}, "routing": {"r": 2}},
              "data": {"names": ["a", "b", "c", "d"], "ndarray": _rows(200, 4, 1)}},
    "one_d": {"data": {"ndarray": _rows(1, 700, 2)[0]}},
    "nested": {"request": {"data": {"ndarray": _rows(150, 4)}}, "data": {"ndarray": [[1.0]]}},
    "strings": {"data": {"ndarray": [["red", 1.0]] * 500}},
    "tensor_beside": {"data": {"tensor": {"shape": [1, 2], "values": [9.0, 9.0]}, "ndarray": _rows(200, 4)}},
    "status": {"status": {"code": 200, "info": "", "reason": "", "status": "SUCCESS"},
               "data": {"ndarray": _rows(300, 3, 4)}},
}


@pytest.mark.parametrize("name", sorted(CODEC_BODIES))
def test_fast_decode_matches_jax(name):
    raw = json.dumps(CODEC_BODIES[name]).encode()
    mine, theirs = message_from_json_fast(raw), jax_codec.message_from_json_fast(raw)
    np.testing.assert_array_equal(np.asarray(mine.array), np.asarray(theirs.array))
    assert np.asarray(mine.array).dtype == np.asarray(theirs.array).dtype
    assert mine.data.kind.name == theirs.data.kind.name
    assert mine.names == tuple(theirs.names)
    assert (mine.meta.puid, mine.meta.tags, mine.meta.routing) == (
        theirs.meta.puid, theirs.meta.tags, theirs.meta.routing)


@pytest.mark.parametrize("name", ["large", "status", "forged", "float64", "small"])
def test_fast_encode_matches_jax_bytes(name):
    body = {"forged": {"meta": {"puid": "p", "tags": {"t": "\x00NDARRAY\x00"}}, "data": {"ndarray": _rows(40, 8)}},
            "float64": None}.get(name, CODEC_BODIES.get(name))
    if name == "float64":
        arr = np.full((20, 20), 123456789.12345679, np.float64)
        mine = SeldonMessage(data=DefaultData(names=(), array=arr, kind=DataKind.NDARRAY), meta=Meta(puid="p"))
        theirs = jax_codec.SeldonMessage(data=jax_codec.DefaultData(names=(), array=arr, kind=jax_codec.DataKind.NDARRAY),
                                         meta=jax_codec.Meta(puid="p"))
    else:
        mine, theirs = message_from_dict(body), jax_codec.message_from_dict(body)
    assert message_to_json_fast(mine) == jax_codec.message_to_json_fast(theirs)


def test_stats_count_c_hits_and_fallbacks():
    native.reset_stats()
    message_from_json_fast(json.dumps(CODEC_BODIES["large"]).encode())
    message_from_json_fast(json.dumps(CODEC_BODIES["strings"]).encode())
    message_to_json_fast(message_from_dict(CODEC_BODIES["large"]))
    entries = native.stats()["entries"]
    assert entries["parse_ndarray"] == {"c": 1, "python": 1}
    assert entries["find_ndarray_span"]["c"] == 2
    assert entries["encode_ndarray"] == {"c": 1, "python": 0}
    with native.python_only():
        assert not native.available() and not native.stats()["available"]
        msg = message_from_json_fast(json.dumps(CODEC_BODIES["large"]).encode())
        assert native.parse_http_head(HEADS[0]) is None
    assert msg.array.shape == (200, 4)
    entries = native.stats()["entries"]
    assert entries["find_ndarray_span"]["python"] == 1 and entries["parse_http_head"]["python"] == 1
    assert native.available()


def test_library_is_built_into_build_dir_not_at_import(tmp_path):
    import subprocess
    import sys

    code = ("import seldon_core_tpu_torch.native as n, seldon_core_tpu_torch.serving.fast_http, "
            "seldon_core_tpu_torch.core.codec_json; print(n._lib is None)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=str(native.BUILD_DIR.parents[1]))
    assert out.stdout.strip() == "True"
    assert native.library_path().parent == native.BUILD_DIR
    assert native.library_path().name.startswith("_fastcodec-")


def test_failed_build_warns_and_falls_back(monkeypatch, caplog):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "SRC", native.SRC.with_name("missing.cpp"))
    with caplog.at_level("WARNING"):
        assert native.parse_ndarray(b"[[1]]") is None
    assert any("fastcodec" in r.message for r in caplog.records)
    raw = json.dumps(CODEC_BODIES["large"]).encode()
    np.testing.assert_array_equal(message_from_json_fast(raw).array, message_from_json(raw).array)


# ------------------------------------- the C head parser against the Python

_CMP_HEADERS = ("content-type", "authorization", "oauth_token", "traceparent", "accept")


def _verdict(p):
    if p is None:
        return None
    if p == 0:
        return ("incomplete",)
    if isinstance(p, tuple):
        # both refuse and close; the status may differ (a 20-digit length
        # is malformed to C, too large to Python), as in the JAX package
        return ("reject",)
    assert isinstance(p, PyHead)
    keep_alive = p.headers.get("connection", "").lower() != "close"
    return ("accept", p.method, p.path, p.clen, p.body_start, keep_alive,
            tuple(p.headers.get(k) for k in _CMP_HEADERS))


def _c_verdict(raw: bytes):
    parsed = native.parse_http_head(raw)
    return None if parsed is None else _verdict(head_from_c(parsed, raw))


HEADER_POOL = [
    b"Host: t", b"Content-Type: application/json", b"content-type:  text/plain ", b"Content-Length: 4",
    b"Content-Length: 04", b"Content-Length: 10", b"Content-Length: -4", b"Content-Length: +4",
    b"Content-Length: 1_0", b"Content-Length: 99999999999999999999", b"Content-Length:\x0c10",
    b"Content-Length:\x0b4", b"content-LENGTH: 4", b"Transfer-Encoding: chunked",
    b"Transfer-Encoding: gzip, chunked", b"transfer-encoding: IDENTITY", b"Transfer-Encoding : chunked",
    b"Transfer-Encoding\x0c: chunked", b" Transfer-Encoding: chunked", b"X-A: a\nTransfer-Encoding: chunked",
    b"X-B: b\rX-C: c", b"Connection: close", b"Connection: keep-alive", b"connection:\tCLOSE",
    b"Authorization: Bearer tok", b"authorization: Bearer other", b"oauth_token: tokA", b"OAuth_Token:\t tokB",
    b"traceparent: 00-aa-bb-01", b"Traceparent: 00-cc-dd-01", b"Accept: application/openmetrics-text",
    b"colonless line", b"Bad Name: v", b"\x00: v", b": empty-name", b"X-Long: " + b"v" * 600,
]


def test_c_and_python_parsers_agree_fuzz():
    """The JAX package's fuzz (tests/test_fast_http.py) on the port: random
    request lines, headers from a pool of smuggling shapes, truncations and
    single-byte mutations. The verdicts must agree, and an accepted head must
    hand the handler the same method, path, length, keep-alive and headers."""
    rng = random.Random(1337)
    methods = ["GET", "POST", "PUT", "HEAD", "DELETE", "OPTIONS", "PATCH", "G\x00T", ""]
    paths = ["/", "/api/v0.1/predictions", "/p?x=1", "/a b", "", "/seldon.protos.Seldon/Predict"]
    versions = ["HTTP/1.1", "HTTP/1.0", "", "HTTP/9.9"]
    mismatches, compared = [], 0
    for _ in range(4000):
        req_line = f"{rng.choice(methods)} {rng.choice(paths)} {rng.choice(versions)}".encode("latin-1")
        lines = [req_line] + [rng.choice(HEADER_POOL) for _ in range(rng.randrange(0, 6))]
        raw = b"\r\n".join(lines) + b"\r\n\r\n" + b"body-bytes-here"
        if rng.random() < 0.15:
            raw = raw[: rng.randrange(0, len(raw))]
        if rng.random() < 0.25 and raw:
            pos = rng.randrange(0, min(len(raw), 80))
            raw = raw[:pos] + bytes([rng.randrange(0, 256)]) + raw[pos + 1:]
        c = _c_verdict(raw)
        if c is None:
            continue
        compared += 1
        p = _verdict(parse_head_py(raw))
        if c != p:
            mismatches.append((raw[:160], c, p))
    assert compared > 3000
    assert not mismatches, mismatches[:5]


def test_parse_head_takes_python_where_c_declines():
    raw = b"GET /p HTTP/1.1\r\nAuthorization: Bearer " + b"a" * 5000 + b"\r\n\r\n"
    head = fast_http.parse_head(raw)
    assert head.headers["authorization"] == "Bearer " + "a" * 5000
    with native.python_only():
        assert _verdict(fast_http.parse_head(HEADS[0])) == _verdict(parse_head_py(HEADS[0]))


@pytest.mark.parametrize("name", [b"oauth_token", b"traceparent", b"accept", b"connection"])
def test_header_from_head_matches_jax_and_python(name):
    import itertools

    key = name.decode()
    for n, spelling, ows in itertools.product([0, 1, 2, 3], [key, key.upper(), key.title()], ["", " ", "\t "]):
        lines = [b"POST /seldon.tpu.Seldon/Predict HTTP/1.1", b"Host: t"]
        lines += [f"{spelling}:{ows}v{i}".encode() for i in range(n)]
        lines.append(b"Content-Length: 0")
        raw = b"\r\n".join(lines) + b"\r\n\r\n"
        head = raw[: raw.find(b"\r\n\r\n") + 2]
        mine = _header_from_head(head, name)
        assert mine == jax_fast_http._header_from_head(head, name)
        assert mine == parse_head_py(raw).headers.get(key)


hypothesis = pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

finite_f32 = st.floats(min_value=-1e6, max_value=1e6, allow_nan=False, allow_infinity=False, width=32)


@st.composite
def heads(draw):
    """A request head as a client or an attacker writes it: a method, a
    path, a version and headers drawn from values that matter to framing,
    duplicated and in any case."""
    method = draw(st.sampled_from(["GET", "POST", "PUT", "DELETE", "OPTIONS", "HEAD", "PATCH"]))
    path = draw(st.sampled_from(["/api/v0.1/predictions", "/seldon.tpu.Seldon/Predict", "/p?x=1", "/metrics"]))
    names = st.sampled_from(["Content-Length", "content-length", "Content-Type", "Authorization", "Connection",
                             "connection", "Transfer-Encoding", "oauth_token", "OAUTH_TOKEN", "traceparent",
                             "Accept", "X-Other"])
    values = st.sampled_from(["0", "4", "04", "12", "close", "Close", "keep-alive", "chunked", "Bearer t",
                              "application/json", "a b", "", "00-ab-cd-01", "-1", "4 "])
    headers = draw(st.lists(st.tuples(names, st.sampled_from(["", " ", "\t", "  "]), values), max_size=6))
    lines = [f"{method} {path} HTTP/1.1"] + [f"{k}:{ows}{v}" for k, ows, v in headers]
    raw = ("\r\n".join(lines) + "\r\n\r\n").encode() + draw(st.binary(max_size=16))
    if draw(st.booleans()) and draw(st.booleans()):
        raw = raw[: draw(st.integers(0, len(raw)))]
    return raw


@settings(max_examples=400, deadline=None)
@given(heads())
def test_c_and_python_heads_agree_hypothesis(raw):
    c = _c_verdict(raw)
    if c is not None:
        assert c == _verdict(parse_head_py(raw)), raw


@st.composite
def message_dicts(draw):
    rows, cols = draw(st.integers(1, 40)), draw(st.integers(1, 40))
    msg: dict = {"data": {"ndarray": [[draw(finite_f32) for _ in range(cols)] for _ in range(rows)]}}
    if draw(st.booleans()):
        msg["data"]["names"] = [draw(st.text(alphabet="abcxyz_", min_size=1, max_size=8)) for _ in range(cols)]
    if draw(st.booleans()):
        msg["meta"] = {
            "puid": draw(st.text(alphabet="0123456789abcdef", max_size=16)),
            "tags": draw(st.dictionaries(st.text(alphabet="abc", min_size=1, max_size=4), st.text(max_size=8),
                                         max_size=3)),
            "routing": draw(st.dictionaries(st.text(alphabet="nr", min_size=1, max_size=3), st.integers(-1, 5),
                                            max_size=3)),
        }
    return msg


@settings(max_examples=60, deadline=None)
@given(message_dicts())
def test_fast_codecs_agree_with_oracle_and_jax(obj):
    raw = json.dumps(obj).encode()
    fast, slow = message_from_json_fast(raw), message_from_dict(obj)
    np.testing.assert_array_equal(np.asarray(fast.array), np.asarray(slow.array))
    assert fast.names == slow.names and fast.meta.tags == slow.meta.tags
    assert message_to_json_fast(slow) == jax_codec.message_to_json_fast(jax_codec.message_from_dict(obj))
    np.testing.assert_array_equal(np.asarray(fast.array), np.asarray(jax_codec.message_from_json_fast(raw).array))
