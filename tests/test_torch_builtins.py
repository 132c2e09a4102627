"""SHADOW, OUTLIER_DETECTOR, PYTHON_CLASS and the npy wire toggle in the
port against the JAX package.

The scenarios of the JAX tests (``tests/test_executor.py`` outlier, score
adapter and shadow tests, ``tests/test_examples_deploy.py`` fraud and
shadow examples, ``tests/test_example_models.py`` PYTHON_CLASS tests), each
driven through both packages on the same inputs: the same answers, tags,
routing, agreement verdicts and refusal messages. Served cases run the
port's ``PredictorServer`` on the CPU over REST beside the JAX package's
executor (or its fast ingress), the port's iris models carrying the JAX
package's parameters (they draw with ``jax.random`` there). Probabilities
are compared at atol 1e-6 (float32, the same weights on two CPU forwards).
"""

import asyncio
import base64
import io
import json
import re
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from seldon_core_tpu.core.errors import APIException as JaxAPIException
from seldon_core_tpu.core.message import SeldonMessage as JaxMessage
from seldon_core_tpu.engine import builtin as jax_builtin
from seldon_core_tpu.engine.executor import build_executor as jax_build_executor
from seldon_core_tpu.engine.units import OutlierDetectorUnit as JaxOutlierUnit
from seldon_core_tpu.engine.units import PythonClassUnit as JaxPythonClassUnit
from seldon_core_tpu.graph.spec import SeldonDeployment as JaxDeployment
from seldon_core_tpu.graph.validation import validate_deployment as jax_validate
from seldon_core_tpu.metrics.registry import Metrics as JaxMetrics
from seldon_core_tpu.serving.fast_http import engine_routes as jax_engine_routes
from seldon_core_tpu.serving.fast_http import start_fast_server as jax_start_fast_server
from seldon_core_tpu.serving.microservice import load_user_object as jax_load_user_object
from seldon_core_tpu.serving.service import PredictionService as JaxPredictionService
from seldon_core_tpu_torch.core.errors import APIException
from seldon_core_tpu_torch.core.message import SeldonMessage
from seldon_core_tpu_torch.engine import builtin
from seldon_core_tpu_torch.engine.executor import build_executor
from seldon_core_tpu_torch.engine.units import OutlierDetectorUnit, PythonClassUnit
from seldon_core_tpu_torch.graph.spec import SeldonDeployment
from seldon_core_tpu_torch.graph.validation import ValidationError, validate_deployment
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.serving.microservice import load_user_object
from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

ROOT = Path(__file__).resolve().parents[1]
PORT_DEPLOYMENTS = ROOT / "seldon_core_tpu_torch" / "deployments"
PORT_MODELS = ROOT / "seldon_core_tpu_torch" / "examples" / "models"
JAX_DEPLOYMENTS = ROOT / "examples" / "deployments"
JAX_MODELS = ROOT / "examples" / "models"
ATOL = 1e-6

PKGS = {
    "port": SimpleNamespace(
        build=lambda pred, context=None, **kw: build_executor(pred, context={"device": "cpu", **(context or {})},
                                                               **kw),
        Dep=SeldonDeployment, Msg=SeldonMessage, PyUnit=PythonClassUnit, OdUnit=OutlierDetectorUnit,
        make_py=builtin.make_python_class_unit, Error=APIException, models=PORT_MODELS,
    ),
    "jax": SimpleNamespace(
        build=jax_build_executor, Dep=JaxDeployment, Msg=JaxMessage, PyUnit=JaxPythonClassUnit,
        OdUnit=JaxOutlierUnit, make_py=jax_builtin.make_python_class_unit, Error=JaxAPIException,
        models=JAX_MODELS,
    ),
}


def _pred(pkg, graph: dict, tpu: dict | None = None):
    pred = {"name": "p", "graph": graph, **({"tpu": tpu} if tpu else {})}
    return pkg.Dep.from_dict({"spec": {"name": "d", "predictors": [pred]}}).spec.predictors[0]


def _arr(msg):
    return np.asarray(msg.array)


async def _both(fn):
    """fn(pkg) for the port and the JAX package, in turn."""
    return await fn(PKGS["port"]), await fn(PKGS["jax"])


# ------------------------------------------------------------ outlier detectors

OD_GRAPH = {
    "name": "od", "type": "TRANSFORMER", "implementation": "OUTLIER_DETECTOR",
    "parameters": [
        {"name": "means", "value": "0,0,0,0", "type": "STRING"},
        {"name": "stds", "value": "1,1,1,1", "type": "STRING"},
        {"name": "threshold", "value": "2.0", "type": "FLOAT"},
    ],
    "children": [{"name": "m", "implementation": "SIMPLE_MODEL"}],
}


async def test_outlier_detector_tags_like_jax():
    rows = [np.ones((1, 4), np.float32), np.asarray([[9.0, 0.0, 0.0, 0.0]], np.float32),
            np.asarray([[0.5, -2.5, 1.0, 0.0], [0.0, 0.0, 0.0, 1.5]], np.float32)]

    async def run(pkg):
        ex = pkg.build(_pred(pkg, OD_GRAPH))
        outs = [await ex.execute(pkg.Msg.from_array(x, ("f0", "f1", "f2", "f3"))) for x in rows]
        many = await ex.execute_many([pkg.Msg.from_array(x) for x in rows[:2]])
        return [(o.meta.tags, _arr(o)) for o in outs + many]

    ours, theirs = await _both(run)
    assert [t for t, _ in ours] == [t for t, _ in theirs]
    assert ours[0][0] == {"outlierScore": 1.0, "outlier": False}
    assert ours[1][0] == {"outlierScore": 9.0, "outlier": True}
    for (_, a), (_, b) in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("params", [[{"name": "stds", "value": "0", "type": "STRING"}],
                                    [{"name": "means", "value": "not,numbers", "type": "STRING"}]],
                         ids=["zero_std", "not_numbers"])
def test_outlier_detector_bad_stats_refused_like_jax(params):
    graph = {"name": "od", "type": "TRANSFORMER", "implementation": "OUTLIER_DETECTOR", "parameters": params}
    errors = []
    for pkg in PKGS.values():
        with pytest.raises(ValueError) as e:
            pkg.build(_pred(pkg, graph))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


class _Scorer:
    def score(self, X, names):
        return np.max(X, axis=1)  # per-row scores


async def test_user_score_adapter_like_jax():
    graph = {"name": "od", "type": "TRANSFORMER", "children": [{"name": "m", "implementation": "SIMPLE_MODEL"}]}
    x = np.asarray([[1.0, 3.0, 2.0, 0.0], [4.0, 0.5, 0.0, 1.0]], np.float32)

    async def run(pkg):
        pred = _pred(pkg, graph)
        ex = pkg.build(pred, context={"units": {"od": pkg.OdUnit(pred.graph, _Scorer())}})
        out = await ex.execute(pkg.Msg.from_array(x))
        with pytest.raises(pkg.Error) as e:
            await ex.execute(pkg.Msg(bin_data=b"raw"))
        return out.meta.tags, _arr(out), str(e.value)

    ours, theirs = await _both(run)
    assert ours[0] == theirs[0] == {"outlierScore": [3.0, 4.0]}
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[2] == theirs[2] and "needs tensor data" in ours[2]


# ---------------------------------------------------------------------- shadow

SHADOW_GRAPH = {
    "name": "sh", "type": "ROUTER", "implementation": "SHADOW",
    "children": [{"name": n, "type": "MODEL"} for n in ("primary", "same", "slow", "broken")],
}
SLOW_S = 1.0


class _Times10:
    def predict(self, X, names):
        return X * 10.0


class _SlowReversed:
    async def predict(self, X, names):
        await asyncio.sleep(SLOW_S)
        return X[:, ::-1] * 10.0  # another argmax: a disagreement


class _Broken:
    def predict(self, X, names):
        raise RuntimeError("candidate blew up")


async def test_shadow_mirrors_without_blocking_like_jax():
    """Child 0 answers; a slow candidate does not hold the answer back; a
    failing one never reaches the caller and counts as a disagreement; the
    batched walk mirrors once per message."""
    x = np.asarray([[1.0, 5.0, 2.0, 0.0]], np.float32)

    async def run(pkg):
        pred = _pred(pkg, SHADOW_GRAPH)
        kids = pred.graph.children
        units = {"primary": pkg.PyUnit(kids[0], _Times10()), "same": pkg.PyUnit(kids[1], _Times10()),
                 "slow": pkg.PyUnit(kids[2], _SlowReversed()), "broken": pkg.PyUnit(kids[3], _Broken())}
        seen = []
        ex = pkg.build(pred, context={"units": units}, shadow_compare_hook=lambda n, a: seen.append((n, a)))
        t0 = time.perf_counter()
        out = await ex.execute(pkg.Msg.from_array(x))
        answered_s = time.perf_counter() - t0
        assert not any(n == "slow" for n, _ in seen)  # still sleeping
        await asyncio.wait_for(ex.drain_shadows(), timeout=10)
        single = sorted(seen)
        seen.clear()
        outs = await ex.execute_many([pkg.Msg.from_array(x) for _ in range(3)])
        await asyncio.wait_for(ex.drain_shadows(), timeout=10)
        assert not ex._shadow_tasks
        return answered_s, out, single, sorted(seen), outs

    for answered_s, out, single, batched, outs in await _both(run):
        assert answered_s < SLOW_S / 2, answered_s
        np.testing.assert_array_equal(_arr(out), x * 10.0)
        assert dict(out.meta.routing) == {"sh": 0}
        assert single == [("broken", False), ("same", True), ("slow", False)]
        assert batched == sorted([("broken", False), ("same", True), ("slow", False)] * 3)
        for o in outs:
            np.testing.assert_array_equal(_arr(o), x * 10.0)
            assert dict(o.meta.routing) == {"sh": 0}


def test_shadow_needs_two_children_like_jax():
    graph = {"name": "sh", "type": "ROUTER", "implementation": "SHADOW",
             "children": [{"name": "only", "type": "MODEL", "implementation": "SIMPLE_MODEL"}]}
    errors = []
    for pkg in PKGS.values():
        with pytest.raises(pkg.Error) as e:
            pkg.build(_pred(pkg, graph))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "SHADOW 'sh' needs >= 2 children" in errors[0]


@pytest.mark.parametrize("name", sorted(PKGS))
async def test_drain_shadows_with_an_already_finished_task(name):
    pkg = PKGS[name]
    graph = {"name": "sh", "type": "ROUTER", "implementation": "SHADOW",
             "children": [{"name": n, "type": "MODEL", "implementation": "SIMPLE_MODEL"} for n in ("a", "b")]}
    ex = pkg.build(_pred(pkg, graph))
    await ex.execute(pkg.Msg.from_array(np.ones((1, 4), np.float32)))
    await asyncio.sleep(0.05)  # the mirror finishes; its discard callback may still be queued
    await asyncio.wait_for(ex.drain_shadows(), timeout=5)
    assert not ex._shadow_tasks


# ------------------------------------------------------------- served examples


async def _post(port: int, body: bytes, ctype: str = "application/json", path: str = "/api/v0.1/predictions"):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"POST {path} HTTP/1.1\r\nHost: t\r\nContent-Type: {ctype}\r\nContent-Length: {len(body)}\r\n"
                     f"Connection: close\r\n\r\n".encode() + body)
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, _, v in (ln.partition(":") for ln in lines[1:])}
    return int(lines[0].split(" ")[1]), headers, payload


async def _get(port: int, path: str) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return raw.partition(b"\r\n\r\n")[2]


def _carry_weights(node, jax_node):
    """The JAX package's parameters into each port model of the graph."""
    rt, jrt = getattr(node.unit, "runtime", None), getattr(jax_node.unit, "runtime", None)
    if rt is not None:
        rt.params = params_to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32), jrt.params), rt.device, rt.dtype)
    for c, jc in zip(node.children, jax_node.children):
        _carry_weights(c, jc)


def _jax_executor(name: str, **kw):
    obj = json.loads((JAX_DEPLOYMENTS / f"{name}.json").read_text())
    return jax_build_executor(JaxDeployment.from_dict(obj).spec.predictors[0], **kw), obj["spec"]["name"]


def _shadow_samples(text: str) -> dict:
    return {m.group(1): float(m.group(2)) for m in
            re.finditer(r"seldon_tpu_shadow_comparisons_total\{([^}]*)\} (\S+)", text)}


async def test_iris_shadow_served_with_agreement_counts_like_jax():
    """iris_shadow end to end: the production model answers (as the JAX
    package's does on the same weights), routing names branch 0, and
    /metrics counts the candidate's agreement as the JAX registry counts
    it."""
    rows = np.random.default_rng(3).uniform(0, 8, (12, 4)).round(2)
    predictor, dep_name = load_predictor(str(PORT_DEPLOYMENTS / "iris_shadow.json"))
    server = PredictorServer(predictor, deployment_name=dep_name, device="cpu")
    jmetrics = JaxMetrics()
    jex, _ = _jax_executor("iris_shadow", shadow_compare_hook=lambda n, a: jmetrics.shadow_compare(
        dep_name, predictor.name, n, a))
    _carry_weights(server.executor.root, jex.root)
    await server.start("127.0.0.1", 0)
    try:
        answers = []
        for r in rows:
            status, _, body = await _post(server.port, json.dumps({"data": {"ndarray": [r.tolist()]}}).encode())
            assert status == 200, body
            answers.append(json.loads(body))
        await server.executor.drain_shadows()
        ours = _shadow_samples((await _get(server.port, "/metrics")).decode())
    finally:
        await server.stop()
    for r, out in zip(rows, answers):
        ref = await jex.execute(JaxMessage.from_array(np.asarray([r])))
        np.testing.assert_allclose(out["data"]["ndarray"], np.asarray(ref.array), rtol=0, atol=ATOL)
        assert out["meta"]["routing"] == dict(ref.meta.routing) == {"mirror": 0}
        assert out["data"]["names"] == list(ref.names)
    await jex.drain_shadows()
    theirs = _shadow_samples(jmetrics.export().decode())
    assert ours == theirs
    assert sum(ours.values()) == len(rows) and all('shadow_unit="candidate"' in k for k in ours)


async def test_fraud_outlier_served_like_jax():
    rows = [[99000000.0, 10.0, 10.0], [178197.0, 833883.0, 855113.0], [1000.0, 2e6, 3e6]]
    predictor, dep_name = load_predictor(str(PORT_DEPLOYMENTS / "fraud_outlier.json"))
    server = PredictorServer(predictor, deployment_name=dep_name, device="cpu")
    # mean_classifier warms at 4 features and serves 3 here: a key of its own
    server.warmup()
    jex, _ = _jax_executor("fraud_outlier")
    await server.start("127.0.0.1", 0)
    try:
        answers = []
        for r in rows:
            status, _, body = await _post(server.port, json.dumps({"data": {"ndarray": [r]}}).encode())
            assert status == 200, body
            answers.append(json.loads(body))
    finally:
        await server.stop()
    assert server.executor.root.children[0].unit.runtime.recompiles_since_warmup() == 1
    for r, out in zip(rows, answers):
        ref = await jex.execute(JaxMessage.from_array(np.asarray([r])))
        np.testing.assert_allclose(out["data"]["ndarray"], np.asarray(ref.array), rtol=0, atol=ATOL)
        assert out["meta"]["tags"] == dict(ref.meta.tags)
    assert answers[0]["meta"]["tags"]["outlier"] is True and answers[1]["meta"]["tags"]["outlierScore"] == 0.0


# ---------------------------------------------------------------- PYTHON_CLASS


def _py_graph(module: str, model_dir: str, **params):
    extra = [{"name": k, "value": str(v), "type": "STRING"} for k, v in params.items()]
    return {"name": "u", "type": "MODEL", "implementation": "PYTHON_CLASS",
            "parameters": [{"name": "module", "value": module, "type": "STRING"},
                           {"name": "model_dir", "value": model_dir, "type": "STRING"}, *extra]}


async def test_python_class_serves_mean_classifier_like_jax():
    x = np.random.default_rng(4).normal(size=(5, 4)).astype(np.float32)

    async def run(pkg):
        ex = pkg.build(_pred(pkg, _py_graph("MeanClassifier", str(pkg.models / "mean_classifier"))))
        out = await ex.execute(pkg.Msg.from_array(x))
        return _arr(out), tuple(out.names)

    (a, names), (b, jnames) = await _both(run)
    np.testing.assert_array_equal(a, b)
    assert names == jnames == ("proba",)


async def test_python_class_serves_fraud_detector_like_jax():
    """FraudDetector has no predict(): as a PYTHON_CLASS model the data
    passes through; wrapped in the outlier adapter it tags each request."""
    x = np.asarray([[99000000.0, 10.0, 10.0], [178197.0, 833883.0, 855113.0]])

    async def run(pkg):
        ex = pkg.build(_pred(pkg, _py_graph("FraudDetector", str(pkg.models / "fraud_detector"))))
        passed = await ex.execute(pkg.Msg.from_array(x))
        pred = _pred(pkg, {"name": "od", "type": "TRANSFORMER"})
        loader = load_user_object if pkg is PKGS["port"] else jax_load_user_object
        user = loader("FraudDetector", str(pkg.models / "fraud_detector"), {"threshold": 3.0})
        scored = await pkg.build(pred, context={"units": {"od": pkg.OdUnit(pred.graph, user)}}).execute(
            pkg.Msg.from_array(x))
        return _arr(passed), scored.meta.tags

    (a, tags), (b, jtags) = await _both(run)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, x)
    assert tags == jtags and tags["outlierScore"] > 100


def test_python_class_missing_module_message_like_jax():
    errors = []
    for pkg in PKGS.values():
        spec = _pred(pkg, {"name": "u", "type": "MODEL", "implementation": "PYTHON_CLASS"}).graph
        with pytest.raises(pkg.Error) as e:
            pkg.make_py(spec, {})
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "needs a 'module' parameter" in errors[0]


def test_python_class_refused_without_allow_like_jax():
    errors = []
    for pkg in PKGS.values():
        pred = _pred(pkg, _py_graph("MeanClassifier", str(pkg.models / "mean_classifier")))
        with pytest.raises(pkg.Error) as e:
            pkg.build(pred, context={"allow_python_class": False})
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "allow_python_class" in errors[0]


ECHO = '''import numpy as np


class Echo:
    def predict(self, X, feature_names):
        if isinstance(X, bytes):
            return X[::-1]
        if isinstance(X, str):
            return X.upper()
        return np.asarray(X) * 2
'''


@pytest.fixture
def echo_dir(tmp_path):
    (tmp_path / "Echo.py").write_text(ECHO)
    return str(tmp_path)


async def test_raw_bindata_reaches_user_predict_like_jax(echo_dir):
    async def run(pkg):
        ex = pkg.build(_pred(pkg, _py_graph("Echo", echo_dir)))
        b = await ex.execute(pkg.Msg(bin_data=b"\x01\x02raw"))
        s = await ex.execute(pkg.Msg(str_data="text"))
        return b.bin_data, b.array, s.str_data

    ours, theirs = await _both(run)
    assert ours == theirs == (b"war\x02\x01", None, "TEXT")


def _npy(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _normalised(status: int, headers: dict, body: bytes):
    """(status, kind, payload) with the request's random puid removed."""
    if headers.get("content-type", "").startswith("application/x-npy"):
        meta = json.loads(headers["seldon-meta"])
        meta.pop("puid", None)
        return status, "npy", np.load(io.BytesIO(body)).tolist(), meta
    obj = json.loads(body)
    obj.get("meta", {}).pop("puid", None)
    return status, "json", obj


@pytest.mark.parametrize("sniff", [True, False], ids=["sniff_on", "sniff_off"])
async def test_decode_npy_bindata_toggle_like_jax(echo_dir, sniff):
    """An explicit application/x-npy body is decoded either way; an npy body
    sent as application/octet-stream is decoded only with the toggle on,
    else it reaches the user as opaque bytes; a non-npy octet-stream is
    opaque bytes either way. Status, kind and body as the JAX engine's."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    requests = [(_npy(x), "application/x-npy"), (_npy(x), "application/octet-stream"),
                (b"opaque\x00bytes", "application/octet-stream")]
    graph, tpu = _py_graph("Echo", echo_dir), {"decode_npy_bindata": sniff}
    server = PredictorServer(_pred(PKGS["port"], graph, tpu), deployment_name="echo", device="cpu")
    jpred = _pred(PKGS["jax"], graph, tpu)
    assert jpred.tpu.decode_npy_bindata is sniff and server.service.decode_npy is sniff
    jservice = JaxPredictionService(jax_build_executor(jpred), deployment_name="echo", decode_npy=sniff)
    await server.start("127.0.0.1", 0)
    jserver = await jax_start_fast_server(jax_engine_routes(jservice, {"paused": False}), "127.0.0.1", 0)
    try:
        ours = [_normalised(*await _post(server.port, body, ctype)) for body, ctype in requests]
        theirs = [_normalised(*await _post(jserver.sockets[0].getsockname()[1], body, ctype))
                  for body, ctype in requests]
    finally:
        await server.stop()
        jserver.close()
        await jserver.wait_closed()
    assert ours == theirs
    assert ours[0][1] == "npy" and ours[0][2] == (x * 2).tolist()
    assert ours[1][1] == ("npy" if sniff else "json")
    if not sniff:
        assert base64.b64decode(ours[1][2]["binData"]) == _npy(x)[::-1]
    assert base64.b64decode(ours[2][2]["binData"]) == b"opaque\x00bytes"[::-1]


def test_predictors_must_agree_on_decode_npy_bindata_like_jax():
    obj = {"spec": {"name": "d", "predictors": [
        {"name": "a", "graph": {"name": "m", "implementation": "SIMPLE_MODEL"}},
        {"name": "b", "graph": {"name": "m", "implementation": "SIMPLE_MODEL"}, "tpu": {"decode_npy_bindata": False}},
    ]}}
    with pytest.raises(ValidationError) as ours:
        validate_deployment(SeldonDeployment.from_dict(obj))
    with pytest.raises(ValueError) as theirs:
        jax_validate(JaxDeployment.from_dict(obj))
    assert ours.value.problems == theirs.value.problems
    assert ours.value.problems == ["all predictors must agree on tpu.decode_npy_bindata "
                                   "(wire-level sniffing is per-deployment, not per-predictor)"]
