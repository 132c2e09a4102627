"""Remote units (``seldon_core_tpu_torch/engine/remote.py``), the pooled
client under them (``serving/http_client.py``) and the executor's
endpoint-keyed breakers, on the CPU, against the JAX package where it has
a counterpart (``tests/test_remote_unit.py``'s REST cases):

- a REST model node behind a reference-style server (form ``json=`` in);
  the port's microservice serving an engine's remote unit; the internal
  API's ``/route``, ``/aggregate``, ``/transform-output`` and
  ``/send-feedback``;
- a 4xx neither retried nor counted against the breaker, a 5xx both; a
  transport failure retryable; an expired budget a 504; a body that does
  not parse ENGINE_INVALID_RESPONSE; a pooled connection the server closed
  dropped before reuse, and one that dies under a request a transport
  error, never a hang;
- two nodes on one endpoint share one breaker (node-keyed breakers fail
  this test), the first declared spec governing it;
- the pool: one per event loop, close/get serialized, split timeouts,
  chunked and Content-Length bodies, at most ``limit`` connections;
- across packages: the JAX engine's RemoteUnit consuming the port's
  microservice and the port's RemoteUnit the JAX microservice, equal
  answers; a tiny split DAG (transformer -> epsilon-greedy -> two
  ``bert_tiny`` arms served as their own unit servers) equal to the
  in-process DAG, bit for bit, and to the JAX package's in-process DAG
  within the BERT parity tolerance (rtol 2e-4, atol 2e-5);
- gRPC units (``tests/test_remote_unit.py``'s gRPC cases): a GRPC endpoint
  validates and picks the per-unit-type service as the JAX unit does; a
  gRPC model node; the JAX engine's gRPC RemoteUnit against the port's
  gRPC server and the port's against the JAX server, equal answers; the
  cached channel dropped on a transport failure and a backend restarted
  on the same port reached again, and one channel per event loop;
  INVALID_ARGUMENT neither retried nor counted against the breaker,
  INTERNAL both; a tiny split DAG over gRPC equal to the REST split and
  the in-process DAG; the gRPC hop continuing the caller's trace
  (``tests/test_telemetry.py``'s gRPC case);
- the slice served with aiohttp, grpcio, protobuf, pydantic, redis and
  kafka unimportable.
"""

import asyncio
import json
import logging
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from seldon_core_tpu.engine import build_executor as jax_build_executor
from seldon_core_tpu.engine.remote import RemoteUnit as JaxRemoteUnit
from seldon_core_tpu.graph import SeldonDeployment as JaxSeldonDeployment
from seldon_core_tpu.serving.microservice import load_user_object as jax_load_user_object
from seldon_core_tpu.serving.microservice import serve_microservice as jax_serve_microservice
from seldon_core_tpu.serving.service import PredictionService as JaxPredictionService
from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Feedback, Meta, SeldonMessage
from seldon_core_tpu_torch.engine import remote
from seldon_core_tpu_torch.engine.executor import build_executor
from seldon_core_tpu_torch.engine.remote import RemoteUnit, _RestSession
from seldon_core_tpu_torch.engine.resilience import DEADLINE, Deadline, is_retryable
from seldon_core_tpu_torch.graph.spec import SeldonDeployment
from seldon_core_tpu_torch.graph.validation import ValidationError, validate_deployment
from seldon_core_tpu_torch.serving.fast_http import start_fast_server
from seldon_core_tpu_torch.serving.http_client import HttpPool, PoolPerLoop
from seldon_core_tpu_torch.serving.microservice import load_user_object, serve_microservice
from seldon_core_tpu_torch.serving.server import PredictorServer
from seldon_core_tpu_torch.serving.wire import WireResponse, payload_obj
from seldon_core_tpu_torch.utils.env import (
    ENGINE_REST_CONNECT_TIMEOUT_S,
    ENGINE_REST_TOTAL_TIMEOUT_S,
    rest_timeouts,
)

ROOT = Path(__file__).resolve().parents[1]


def _unit(name, port, etype="REST", utype="MODEL", params=()):
    return {"name": name, "type": utype, "parameters": list(params),
            "endpoint": {"service_host": "127.0.0.1", "service_port": port, "type": etype}}


def _predictor(graph: dict, cls=SeldonDeployment):
    return cls.from_dict({"spec": {"name": "d", "predictors": [{"name": "p", "graph": graph}]}}).spec.predictors[0]


def _jax_predictor(graph: dict):
    return JaxSeldonDeployment.from_dict({"spec": {"name": "d", "predictors": [{"name": "p", "graph": graph}]}}) \
        .spec.predictors[0]


def _ones(n=1, d=4, v=1.0):
    return SeldonMessage.from_array(np.full((n, d), v, np.float32))


class _Routes:
    """A fast-ingress server on a free port for a test, from a route table."""

    def __init__(self, routes):
        self.routes = routes

    async def __aenter__(self):
        self.server = await start_fast_server(self.routes, "127.0.0.1", 0)
        self.port = self.server.sockets[0].getsockname()[1]
        return self

    async def __aexit__(self, *exc):
        await _RestSession.close()
        self.server.close()
        await self.server.wait_closed()


def _write_class(directory: Path, name: str, body: str) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    (directory / f"{name}.py").write_text(textwrap.dedent(body))
    return directory


async def test_remote_rest_model_node():
    seen = []

    async def predict(req):
        seen.append((req.content_type, payload_obj(req, ErrorCode.ENGINE_INVALID_JSON), req.headers))
        return WireResponse.json({"data": {"names": ["c0"], "ndarray": [[0.7]]}, "meta": {"tags": {"served": "rest"}}})

    async with _Routes({("POST", "/predict"): predict}) as s:
        ex = build_executor(_predictor(_unit("remote-model", s.port)))
        assert isinstance(ex.root.unit, RemoteUnit)
        out = await ex.execute(_ones())
        np.testing.assert_allclose(np.asarray(out.array), [[0.7]])
        assert out.meta.tags == {"served": "rest"}
    ctype, obj, _ = seen[0]
    # the reference's wire quirk: the message in an urlencoded json= field
    assert ctype == "application/x-www-form-urlencoded"
    assert obj["data"]["tensor"] == {"shape": [1, 4], "values": [1.0] * 4}


async def test_our_microservice_serves_engine_remote_rest_unit(tmp_path):
    user = load_user_object("Doubler", str(_write_class(tmp_path / "m", "Doubler", """
        class Doubler:
            def predict(self, X, names):
                return X * 2.0
    """)))
    server, _, _ = await serve_microservice(user, "Doubler", "MODEL", host="127.0.0.1", http_port=0)
    port = server.sockets[0].getsockname()[1]
    try:
        ex = build_executor(_predictor(_unit("remote-model", port)))
        out = await ex.execute(_ones(v=3.0))
        np.testing.assert_allclose(np.asarray(out.array), [[6.0] * 4])
    finally:
        await _RestSession.close()
        server.close()
        await server.wait_closed()


async def test_internal_api_route_aggregate_feedback_endpoints(tmp_path):
    """/route answers the branch as a 1x1 tensor, /aggregate takes
    seldonMessages, /transform-output and /send-feedback reach the user
    class; a graph's RemoteUnits call each of them."""
    d = _write_class(tmp_path / "r", "PickOne", """
        import numpy as np

        class PickOne:
            def route(self, X, names):
                return 1
            def aggregate(self, Xs, names):
                return np.sum(np.stack([np.asarray(x) for x in Xs]), axis=0)
            def transform_output(self, X, names):
                return X + 100.0
            def send_feedback(self, X, names, routing, reward, truth):
                self.saw = reward
    """)
    for stype in ("ROUTER", "COMBINER", "OUTPUT_TRANSFORMER"):
        pool = HttpPool()
        user = load_user_object("PickOne", str(d))
        server, _, _ = await serve_microservice(user, "PickOne", stype, host="127.0.0.1", http_port=0)
        port = server.sockets[0].getsockname()[1]
        base = f"http://127.0.0.1:{port}"
        try:
            if stype == "ROUTER":
                resp = await pool.post(f"{base}/route", json.dumps({"data": {"ndarray": [[1.0, 2.0]]}}).encode())
                assert resp.status == 200
                assert resp.json()["data"]["tensor"] == {"shape": [1, 1], "values": [1.0]}
                fb = {"request": {"data": {"ndarray": [[1.0, 2.0]]}},
                      "response": {"meta": {"routing": {"PickOne": 1}}}, "reward": 0.5}
                resp = await pool.post(f"{base}/send-feedback", json.dumps(fb).encode())
                assert resp.status == 200 and user.saw == 0.5
                unit = RemoteUnit(_predictor(_unit("PickOne", port, utype="ROUTER")).graph)
                assert await unit.route(_ones()) == 1
                await unit.send_feedback(Feedback(request=_ones(), reward=0.25), 1)
                assert user.saw == 0.25
            elif stype == "COMBINER":
                unit = RemoteUnit(_predictor(_unit("PickOne", port, utype="COMBINER")).graph)
                out = await unit.aggregate([_ones(v=1.0), _ones(v=2.0)])
                np.testing.assert_allclose(np.asarray(out.array), [[3.0] * 4])
            else:
                unit = RemoteUnit(_predictor(_unit("PickOne", port, utype="OUTPUT_TRANSFORMER")).graph)
                out = await unit.transform_output(_ones(v=1.0))
                np.testing.assert_allclose(np.asarray(out.array), [[101.0] * 4])
        finally:
            # the server's wait_closed waits for its clients' kept-alive connections
            await pool.close()
            await _RestSession.close()
            server.close()
            await server.wait_closed()


RETRY_AND_BREAKER = (
    {"name": "retry_max_attempts", "value": "3", "type": "INT"},
    {"name": "retry_backoff_ms", "value": "1", "type": "FLOAT"},
    {"name": "breaker_failure_threshold", "value": "1", "type": "INT"},
)


@pytest.mark.parametrize("status,hits,state", [(400, 1, "closed"), (422, 1, "closed"), (503, 1, "open")])
async def test_remote_4xx_is_deterministic_not_retried_not_breaker_counted(status, hits, state):
    """A 4xx is the deterministic answer of a healthy backend: not replayed,
    not counted against the endpoint's breaker. A 5xx is retryable and
    counted (the breaker of threshold 1 opens at once and stops the
    retries)."""
    seen = []

    async def predict(req):
        seen.append(1)
        return WireResponse.json({"status": "bad payload"}, status=status)

    async with _Routes({("POST", "/predict"): predict}) as s:
        ex = build_executor(_predictor(_unit("remote-model", s.port, params=RETRY_AND_BREAKER)))
        with pytest.raises(APIException) as err:
            await ex.execute(_ones())
        # a 5xx opened the breaker, which refuses the retry
        cause = err.value.__cause__ if status >= 500 else err.value
        assert err.value.error is (ErrorCode.ENGINE_BREAKER_OPEN if status >= 500 else
                                   ErrorCode.ENGINE_MICROSERVICE_ERROR)
        assert cause.error is ErrorCode.ENGINE_MICROSERVICE_ERROR
        assert cause.retryable is (status >= 500) and is_retryable(cause) is (status >= 500)
        assert len(seen) == hits
        assert ex.breaker_for("remote-model").state == state


async def test_transport_failures_and_bad_bodies(free_port_pair=None):
    from tests.conftest import free_port

    unit = RemoteUnit(_predictor(_unit("m", free_port())).graph)
    with pytest.raises(APIException) as err:  # nothing listens: retryable, breaker-counted
        await unit.transform_input(_ones())
    assert err.value.error is ErrorCode.ENGINE_MICROSERVICE_ERROR and is_retryable(err.value)
    assert err.value.retryable is None

    async def garbage(req):
        return WireResponse(body=b"<html>not json</html>", content_type="text/html")

    async def slow(req):
        await asyncio.sleep(2.0)
        return WireResponse.json({"data": {"ndarray": [[1.0]]}})

    async with _Routes({("POST", "/predict"): garbage, ("POST", "/transform-input"): slow}) as s:
        with pytest.raises(APIException) as err:
            await RemoteUnit(_predictor(_unit("m", s.port)).graph).transform_input(_ones())
        assert err.value.error is ErrorCode.ENGINE_INVALID_RESPONSE
        slow_unit = RemoteUnit(_predictor(_unit("m", s.port, utype="TRANSFORMER")).graph)
        token = DEADLINE.set(Deadline(0.15))
        try:
            # the budget replaces the pool's 5 s total: a 504, not a 500
            with pytest.raises(APIException) as err:
                await asyncio.wait_for(slow_unit.transform_input(_ones()), 1.5)
            assert err.value.error is ErrorCode.REQUEST_DEADLINE_EXCEEDED
        finally:
            DEADLINE.reset(token)
        token = DEADLINE.set(Deadline(-1.0))  # spent before the call: no dispatch
        try:
            with pytest.raises(APIException) as err:
                await slow_unit.transform_input(_ones())
            assert err.value.error is ErrorCode.REQUEST_DEADLINE_EXCEEDED
        finally:
            DEADLINE.reset(token)


def _breaker_graph(threshold_b: int = 2):
    breaker = lambda t: ({"name": "breaker_failure_threshold", "value": str(t), "type": "INT"},  # noqa: E731
                         {"name": "breaker_error_rate", "value": "1.0", "type": "FLOAT"})
    return lambda port: {
        "name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
        "children": [_unit("m1", port, params=breaker(2)), _unit("m2", port, params=breaker(threshold_b))],
    }


async def test_two_nodes_on_one_endpoint_share_one_breaker(caplog):
    """m1 and m2 live on one endpoint: their failures land on one breaker,
    which opens after the first request's two failures (threshold 2) and
    then fast-fails both without a call. Breakers keyed by node would each
    hold one failure and stay closed."""
    seen = []

    async def predict(req):
        seen.append(1)
        return WireResponse.json({"status": "down"}, status=500)

    async with _Routes({("POST", "/predict"): predict}) as s:
        ex = build_executor(_predictor(_breaker_graph()(s.port)))
        assert ex.breaker_for("m1") is ex.breaker_for("m2")
        with pytest.raises(APIException):
            await ex.execute(_ones())
        assert len(seen) == 2 and ex.breaker_for("m1").state == "open"
        with pytest.raises(APIException) as err:
            await ex.execute(_ones())
        assert err.value.error is ErrorCode.ENGINE_BREAKER_OPEN and len(seen) == 2
        assert f"127.0.0.1:{s.port}" in err.value.info  # named by its endpoint
        # a conflicting spec on the second node: the first declared governs
        with caplog.at_level(logging.WARNING, logger="seldon_core_tpu_torch.engine.executor"):
            ex2 = build_executor(_predictor(_breaker_graph(threshold_b=5)(s.port)))
        assert ex2.breaker_for("m2").failure_threshold == 2
        assert any("first-declared wins" in r.getMessage() for r in caplog.records)


async def _raw_server(handler):
    server = await asyncio.start_server(handler, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1]


async def _read_request(reader):
    head = await reader.readuntil(b"\r\n\r\n")
    clen = 0
    for line in head.split(b"\r\n"):
        k, _, v = line.partition(b":")
        if k.strip().lower() == b"content-length":
            clen = int(v)
    return head + await reader.readexactly(clen)


async def test_pool_frames_bodies_and_survives_closed_connections():
    """Content-Length and chunked bodies; a kept-alive connection the
    server closed is dropped before reuse (the next request succeeds on a
    new one); a connection that dies under a request fails it as a
    transport error, within the timeout, never a hang."""
    state = {"conns": 0, "mode": "ok"}

    async def handler(reader, writer):
        state["conns"] += 1
        try:
            while True:
                await _read_request(reader)
                if state["mode"] == "drop":
                    return  # close without an answer
                if state["mode"] == "chunked":
                    writer.write(b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n"
                                 b"5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n")
                else:
                    writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok")
                await writer.drain()
                if state["mode"] == "idle-close":
                    return  # the server's idle timeout: it closes after answering
        except (asyncio.IncompleteReadError, ConnectionError):
            return
        finally:
            writer.close()

    server, port = await _raw_server(handler)
    pool = HttpPool(connect_timeout_s=1.0, total_timeout_s=2.0)
    url = f"http://127.0.0.1:{port}/x"
    try:
        assert (await pool.post(url, b"{}")).body == b"ok"
        assert (await pool.post(url, b"{}")).body == b"ok"
        assert state["conns"] == 1  # kept alive
        state["mode"] = "chunked"
        assert (await pool.post(url, b"{}")).body == b"hello world"
        state["mode"] = "idle-close"
        assert (await pool.post(url, b"{}")).body == b"ok"
        await asyncio.sleep(0.05)  # the FIN arrives while the connection idles
        state["mode"] = "ok"
        assert (await pool.post(url, b"{}")).body == b"ok"
        assert state["conns"] == 2  # the closed one was dropped, not reused
        state["mode"] = "drop"
        with pytest.raises((ConnectionError, OSError)):
            await asyncio.wait_for(pool.post(url, b"{}"), 3.0)
        assert pool.open_connections == 0
    finally:
        await pool.close()
        server.close()
        await server.wait_closed()


async def test_pool_holds_its_connection_limit():
    active = {"now": 0, "peak": 0}

    async def handler(reader, writer):
        try:
            while True:
                await _read_request(reader)
                active["now"] += 1
                active["peak"] = max(active["peak"], active["now"])
                await asyncio.sleep(0.05)
                active["now"] -= 1
                writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok")
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            return
        finally:
            writer.close()

    server, port = await _raw_server(handler)
    pool = HttpPool(limit=2)
    try:
        out = await asyncio.gather(*(pool.post(f"http://127.0.0.1:{port}/x", b"") for _ in range(6)))
        assert [r.body for r in out] == [b"ok"] * 6
        assert active["peak"] == 2 and pool.open_connections <= 2
    finally:
        await pool.close()
        server.close()
        await server.wait_closed()


def test_rest_session_is_per_loop_and_close_get_are_serialized(monkeypatch):
    """The split timeouts come from the environment when a loop's pool is
    built; each event loop gets its own pool, never a dead loop's; close
    and get overlapping never hand back a closed pool."""
    assert rest_timeouts({}) == (1.0, 5.0)
    assert rest_timeouts({ENGINE_REST_CONNECT_TIMEOUT_S: "0.25", ENGINE_REST_TOTAL_TIMEOUT_S: "9"}) == (0.25, 9.0)
    assert rest_timeouts({ENGINE_REST_CONNECT_TIMEOUT_S: "nope", ENGINE_REST_TOTAL_TIMEOUT_S: "-1"}) == (1.0, 5.0)
    monkeypatch.setenv(ENGINE_REST_CONNECT_TIMEOUT_S, "0.5")
    monkeypatch.setenv(ENGINE_REST_TOTAL_TIMEOUT_S, "7")
    session = PoolPerLoop(remote._make_rest_pool)

    async def first():
        pool = await session.get()
        assert (pool.connect_timeout_s, pool.total_timeout_s) == (0.5, 7.0)
        assert await session.get() is pool
        return pool

    async def churn():
        async def one(i):
            if i % 3 == 2:
                await session.close()
                return None
            pool = await session.get()
            assert not pool.closed
            return pool

        results = await asyncio.gather(*(one(i) for i in range(30)))
        assert any(r is not None for r in results)
        await session.close()

    p1 = asyncio.run(first())
    p2 = asyncio.run(first())  # a new loop: a new pool, the stale one closed
    assert p1 is not p2 and p1.closed
    asyncio.run(churn())


async def test_grpc_endpoints_are_refused_by_name():
    """A GRPC endpoint is served now: it validates, as in the JAX package,
    and builds a gRPC RemoteUnit that calls the per-unit-type service and
    shares its breaker per host:port with a REST node of that endpoint."""
    graph = {"name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
             "children": [_unit("remote-model", 5001, etype="GRPC"), _unit("rest-model", 5001)]}
    cr = {"spec": {"name": "d", "predictors": [{"name": "p", "graph": graph}]}}
    validate_deployment(SeldonDeployment.from_dict(cr))
    with pytest.raises(ValidationError):
        validate_deployment(SeldonDeployment.from_dict({"spec": {"name": "d", "predictors": [
            {"name": "p", "graph": {"name": "x", "type": "ROUTER", "children": []}}]}}))
    ex = build_executor(_predictor(graph))
    grpc_unit, rest_unit = (c.unit for c in ex.root.children)
    assert isinstance(grpc_unit, RemoteUnit) and grpc_unit.is_grpc and not rest_unit.is_grpc
    assert ex.breaker_for("remote-model") is ex.breaker_for("rest-model")
    services = {t: RemoteUnit(_predictor(_unit("u", 5001, etype="GRPC", utype=t)).graph)
                for t in ("MODEL", "ROUTER", "TRANSFORMER", "OUTPUT_TRANSFORMER", "COMBINER")}
    jax_services = {t: JaxRemoteUnit(_predictor(_unit("u", 5001, etype="GRPC", utype=t), JaxSeldonDeployment).graph)
                    for t in services}
    for method in ("Predict", "TransformInput", "TransformOutput", "Route", "Aggregate", "SendFeedback"):
        for t, unit in services.items():
            assert unit._grpc_service_for(method) == jax_services[t]._grpc_service_for(method), (t, method)
    assert services["MODEL"]._grpc_service_for("TransformInput") == "Model"
    assert services["ROUTER"]._grpc_service_for("SendFeedback") == "Router"


DOUBLER = """
    class Doubler:
        def predict(self, X, names):
            return X * 2.0 + 1.0
"""


async def test_engines_consume_the_other_packages_microservice(tmp_path):
    """The JAX engine's RemoteUnit against the port's microservice and the
    port's RemoteUnit against the JAX microservice give the answers the
    class gives in-process."""
    from seldon_core_tpu.engine.remote import _RestSession as JaxRestSession
    from seldon_core_tpu.core.message import SeldonMessage as JaxSeldonMessage

    d = _write_class(tmp_path / "m", "Doubler", DOUBLER)
    x = np.arange(8, dtype=np.float32).reshape(2, 4) / 3.0
    want = x * 2.0 + 1.0
    ours, _, _ = await serve_microservice(load_user_object("Doubler", str(d)), "Doubler", "MODEL",
                                          host="127.0.0.1", http_port=0)
    from tests.conftest import free_port

    jport = free_port()
    runner, jgrpc, _ = await jax_serve_microservice(jax_load_user_object("Doubler", str(d)), "Doubler", "MODEL",
                                                    host="127.0.0.1", http_port=jport)
    try:
        port = ours.sockets[0].getsockname()[1]
        jex = jax_build_executor(_jax_predictor(_unit("remote-model", port)))
        jout = await jex.execute(JaxSeldonMessage.from_array(x))
        ex = build_executor(_predictor(_unit("remote-model", jport)))
        out = await ex.execute(SeldonMessage.from_array(x))
        np.testing.assert_array_equal(np.asarray(jout.array), want)
        np.testing.assert_array_equal(np.asarray(out.array), want)
    finally:
        await JaxRestSession.close()
        await _RestSession.close()
        ours.close()
        await ours.wait_closed()
        if jgrpc is not None:
            await jgrpc.stop(None)
        await runner.cleanup()


def _tiny_dag(arms) -> dict:
    return {
        "name": "input-scaler", "type": "TRANSFORMER", "implementation": "MEAN_TRANSFORMER",
        "parameters": [{"name": "means", "value": "0.0", "type": "STRING"}],
        "children": [{
            "name": "eg", "type": "ROUTER", "implementation": "EPSILON_GREEDY",
            "parameters": [{"name": "epsilon", "value": "0.3", "type": "FLOAT"},
                           {"name": "seed", "value": "7", "type": "INT"}],
            "children": arms,
        }],
    }


def _arm(name: str, seed: int) -> dict:
    return {"name": name, "type": "MODEL", "implementation": "JAX_MODEL",
            "parameters": [{"name": "model_uri", "value": f"zoo://bert_tiny?seed={seed}&seq=16", "type": "STRING"}]}


def _dep(graph: dict, name: str) -> dict:
    return {"spec": {"name": name, "predictors": [{"name": "main", "graph": graph,
                                                   "tpu": {"max_batch": 4, "batch_buckets": [1, 4]}}]}}


async def test_tiny_split_dag_equals_in_process_dag_and_jax():
    """Both arms served by their own unit servers and reached over the
    internal REST API: routes request by request and probabilities bit for
    bit those of the in-process DAG (float32 on the CPU: the JSON round
    trip of float32 is exact), and within the BERT parity tolerance of the
    JAX package's in-process DAG (bert_tiny draws bit-identical weights in
    both packages); a feedback moves only the routed arm's reward."""
    arms = [_arm("bert-a", 0), _arm("bert-b", 1)]
    arm_servers = []
    for arm in arms:
        pred = SeldonDeployment.from_dict(_dep(arm, arm["name"])).spec.predictors[0]
        srv = PredictorServer(pred, deployment_name=arm["name"], device="cpu")
        srv.warmup()
        await srv.start("127.0.0.1", 0)
        arm_servers.append(srv)
    remote_arms = [_unit(a["name"], s.port) for a, s in zip(arms, arm_servers)]
    split = PredictorServer(SeldonDeployment.from_dict(_dep(_tiny_dag(remote_arms), "split")).spec.predictors[0],
                            deployment_name="split", device="cpu")
    local = PredictorServer(SeldonDeployment.from_dict(_dep(_tiny_dag(arms), "local")).spec.predictors[0],
                            deployment_name="local", device="cpu")
    local.warmup()
    jax_ex = jax_build_executor(JaxSeldonDeployment.from_dict(_dep(_tiny_dag(arms), "jax")).spec.predictors[0])
    jax_service = JaxPredictionService(jax_ex, deployment_name="jax")
    from seldon_core_tpu.core.message import SeldonMessage as JaxSeldonMessage

    rng = np.random.default_rng(3)
    try:
        assert [type(c.unit).__name__ for c in split.executor.root.children[0].children] == ["RemoteUnit"] * 2
        routes = []
        for _ in range(8):
            ids = rng.integers(0, 1024, size=(1, 16)).astype(np.float32)
            a = await split.service.predict(SeldonMessage.from_array(ids))
            b = await local.service.predict(SeldonMessage.from_array(ids))
            c = await jax_service.predict(JaxSeldonMessage.from_array(ids))
            assert a.meta.routing == b.meta.routing == dict(c.meta.routing)
            np.testing.assert_array_equal(np.asarray(a.array), np.asarray(b.array))
            np.testing.assert_allclose(np.asarray(a.array), np.asarray(c.array), rtol=2e-4, atol=2e-5)
            routes.append(a.meta.routing["eg"])
        assert set(routes) == {0, 1}  # both arms were reached
        router = split.executor.root.children[0].unit
        counts, rewards = list(router.counts), list(router.rewards)
        await split.service.send_feedback(Feedback(response=a, reward=1.0))
        want = [r + (1.0 if i == routes[-1] else 0.0) for i, r in enumerate(rewards)]
        assert router.rewards == want and router.counts == [c + (i == routes[-1]) for i, c in enumerate(counts)]
    finally:
        await _RestSession.close()
        for srv in (*arm_servers, split, local):
            await srv.stop()


def test_slice_serves_without_optional_client_libraries(tmp_path):
    """The gateway, a remote unit and the microservice with aiohttp,
    grpcio, protobuf, pydantic, redis and kafka unimportable."""
    _write_class(tmp_path / "m", "Doubler", DOUBLER)
    code = textwrap.dedent(f"""
        import sys
        BLOCKED = ("aiohttp", "grpc", "google.protobuf", "pydantic", "redis", "kafka", "jax", "seldon_core_tpu.")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if any(name == b.rstrip(".") or name.startswith(b if b.endswith(".") else b + ".")
                       for b in BLOCKED):
                    raise ImportError(f"blocked: {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
        import asyncio, json
        import numpy as np
        from seldon_core_tpu_torch.core.message import SeldonMessage
        from seldon_core_tpu_torch.engine.executor import build_executor
        from seldon_core_tpu_torch.graph.spec import SeldonDeployment
        from seldon_core_tpu_torch.serving.fast_http import gateway_routes, start_fast_server
        from seldon_core_tpu_torch.serving.http_client import HttpPool
        from seldon_core_tpu_torch.serving.microservice import load_user_object, serve_microservice
        from seldon_core_tpu_torch.serving.server import load_predictor
        from seldon_core_tpu_torch.tools.stack import build_gateway_stack

        async def main():
            ms, _, _ = await serve_microservice(load_user_object("Doubler", {str(tmp_path / "m")!r}), "Doubler",
                                                "MODEL", host="127.0.0.1", http_port=0)
            port = ms.sockets[0].getsockname()[1]
            graph = {{"name": "r", "type": "MODEL",
                      "endpoint": {{"service_host": "127.0.0.1", "service_port": port, "type": "REST"}}}}
            pred = SeldonDeployment.from_dict({{"spec": {{"name": "d", "predictors": [
                {{"name": "p", "graph": graph}}]}}}}).spec.predictors[0]
            out = await build_executor(pred).execute(SeldonMessage.from_array(np.ones((1, 4), np.float32)))
            pred, name = load_predictor({str(ROOT / "seldon_core_tpu_torch/deployments/iris.json")!r})
            server, gw, _, token = build_gateway_stack(pred, deployment_name=name, device="cpu")
            gws = await start_fast_server(gateway_routes(gw), "127.0.0.1", 0)
            pool = HttpPool()
            gport = gws.sockets[0].getsockname()[1]
            r = await pool.post(f"http://127.0.0.1:{{gport}}/api/v0.1/predictions",
                                json.dumps({{"data": {{"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}}}).encode(),
                                {{"Authorization": "Bearer " + token}})
            await pool.close()
            blocked = sorted(m for m in sys.modules if m.split(".")[0] in ("aiohttp", "grpc", "pydantic", "redis",
                                                                           "kafka", "jax"))
            print(json.dumps({{"remote": np.asarray(out.array).tolist(), "gateway": r.status, "blocked": blocked}}))
            ms.close(); gws.close()

        asyncio.run(main())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=180, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"remote": [[3.0] * 4], "gateway": 200, "blocked": []}


# ------------------------------------------------------------------ gRPC

SIMPLE_GRAPH = {"name": "simple-model", "type": "MODEL", "implementation": "SIMPLE_MODEL"}


def _simple_service(**kw):
    from seldon_core_tpu_torch.serving.service import PredictionService

    return PredictionService(build_executor(_predictor(SIMPLE_GRAPH)), **kw)


async def _grpc_server(service, port: int = 0):
    from seldon_core_tpu_torch.serving.grpc_server import start_grpc_server

    return await start_grpc_server(service, "127.0.0.1", port)


async def _jax_grpc_server(service):
    """The JAX package's gRPC server on port 0, and the port it bound (its
    start_grpc_server does not return it)."""
    import grpc

    from seldon_core_tpu.serving.grpc_server import start_grpc_server

    bound, real = {}, grpc.aio.server

    def recording(*a, **k):
        server = real(*a, **k)
        add = server.add_insecure_port
        server.add_insecure_port = lambda addr: bound.setdefault("port", add(addr))
        return server

    grpc.aio.server = recording
    try:
        server = await start_grpc_server(service, "127.0.0.1", 0)
    finally:
        grpc.aio.server = real
    return server, bound["port"]


async def test_remote_grpc_model_node():
    server = await _grpc_server(_simple_service())
    try:
        ex = build_executor(_predictor(_unit("remote-model", server.bound_port, etype="GRPC")))
        out = await ex.execute(_ones())
        np.testing.assert_allclose(np.asarray(out.array), [[0.1, 0.9, 0.5]], rtol=1e-6)
        await remote.close_remote_units(ex)
        assert ex.root.unit._grpc_channel is None
    finally:
        await server.stop(None)


async def test_grpc_hops_across_packages_give_equal_answers(tmp_path):
    """The JAX engine's gRPC RemoteUnit against the port's gRPC server and
    the port's against the JAX server: the wire is the reference's."""
    from seldon_core_tpu.core.message import SeldonMessage as JaxSeldonMessage

    d = _write_class(tmp_path / "m", "Doubler", DOUBLER)
    x = np.arange(8, dtype=np.float32).reshape(2, 4) / 3.0
    want = x * 2.0 + 1.0
    ours = await serve_microservice(load_user_object("Doubler", str(d)), "Doubler", "MODEL", host="127.0.0.1",
                                    enable_rest=False, grpc_port=0)
    jservice = JaxPredictionService(jax_build_executor(_jax_predictor(
        {"name": "Doubler", "type": "MODEL", "implementation": "SIMPLE_MODEL"})))
    jserver, jport = await _jax_grpc_server(jservice)
    try:
        assert ours[0] is None  # GRPC only: no REST listener
        jex = jax_build_executor(_jax_predictor(_unit("remote-model", ours.grpc_server.bound_port, etype="GRPC")))
        jout = await jex.execute(JaxSeldonMessage.from_array(x))
        np.testing.assert_array_equal(np.asarray(jout.array), want)
        await jex.root.unit.close()
        ex = build_executor(_predictor(_unit("remote-model", jport, etype="GRPC")))
        out = await ex.execute(SeldonMessage.from_array(x))
        np.testing.assert_allclose(np.asarray(out.array), [[0.1, 0.9, 0.5]] * 2, rtol=1e-6)
        jdirect = await jservice.predict(JaxSeldonMessage.from_array(x))
        np.testing.assert_array_equal(np.asarray(out.array), np.asarray(jdirect.array))
        await remote.close_remote_units(ex)
    finally:
        await jserver.stop(None)
        await ours.grpc_server.stop(None)


async def test_grpc_channel_invalidated_on_transport_failure_and_recovers():
    """A failed call at the transport drops the cached channel; a backend
    started again on the same port is then reached by the same engine."""
    import grpc

    server = await _grpc_server(_simple_service())
    port = server.bound_port
    breaker = ({"name": "breaker_failure_threshold", "value": "5", "type": "INT"},)
    ex = build_executor(_predictor(_unit("remote-model", port, etype="GRPC", params=breaker)))
    unit = ex.root.unit
    try:
        await ex.execute(_ones())
        assert unit._grpc_channel is not None and unit._stub_cache
        await server.stop(None)
        with pytest.raises(APIException) as err:
            await ex.execute(_ones())
        assert err.value.error is ErrorCode.ENGINE_MICROSERVICE_ERROR and is_retryable(err.value)
        assert unit._grpc_channel is None and unit._stub_cache == {}
        assert ex.breaker_for("remote-model")._consecutive_failures >= 1
        server = await _grpc_server(_simple_service(), port)
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as probe:
            await asyncio.wait_for(probe.channel_ready(), 30)
        out = await ex.execute(_ones())
        np.testing.assert_allclose(np.asarray(out.array), [[0.1, 0.9, 0.5]], rtol=1e-6)
        assert unit._grpc_channel is not None  # a healthy channel stays cached
    finally:
        await server.stop(None)
        await unit.close()


def test_grpc_channel_is_per_event_loop():
    """A channel cached on a loop that has ended is rebuilt on the next
    one, never awaited across loops."""
    async def call(port):
        out = await unit.transform_input(_ones())
        return unit._grpc_channel, np.asarray(out.array)

    async def serve_and_call():
        server = await _grpc_server(_simple_service())
        try:
            unit.endpoint = unit.endpoint.__class__(service_host="127.0.0.1", service_port=server.bound_port,
                                                   type=unit.endpoint.type)
            return await call(server.bound_port)
        finally:
            await server.stop(None)

    unit = RemoteUnit(_predictor(_unit("m", 1, etype="GRPC")).graph)
    first, a = asyncio.run(serve_and_call())
    second, b = asyncio.run(serve_and_call())
    assert first is not second
    np.testing.assert_array_equal(a, b)


async def _aborting_server(code_name: str, seen: list):
    """A gRPC model container whose Model.Predict fails with ``code``."""
    import grpc

    from seldon_core_tpu_torch.proto.services import add_service

    async def predict(request, context):
        seen.append(1)
        await context.abort(getattr(grpc.StatusCode, code_name), "refused")

    server = grpc.aio.server()
    add_service(server, "Model", {"Predict": predict})
    port = server.add_insecure_port("127.0.0.1:0")
    await server.start()
    return server, port


@pytest.mark.parametrize("code,hits,state,retryable", [
    ("INVALID_ARGUMENT", 1, "closed", False), ("FAILED_PRECONDITION", 1, "closed", False),
    ("INTERNAL", 1, "open", True)])
async def test_grpc_deterministic_statuses_are_not_retried_nor_breaker_counted(code, hits, state, retryable):
    """INVALID_ARGUMENT-class statuses are the deterministic answer of a
    healthy backend: not replayed, not counted against the breaker. Other
    statuses are retryable and counted (the breaker of threshold 1 opens at
    once and stops the retries), as in the JAX unit."""
    seen = []
    server, port = await _aborting_server(code, seen)
    try:
        ex = build_executor(_predictor(_unit("remote-model", port, etype="GRPC", params=RETRY_AND_BREAKER)))
        with pytest.raises(APIException) as err:
            await ex.execute(_ones())
        cause = err.value.__cause__ if retryable else err.value
        assert cause.error is ErrorCode.ENGINE_MICROSERVICE_ERROR and is_retryable(cause) is retryable
        assert cause.retryable == JaxRemoteUnit._grpc_retryable(cause.__cause__)
        assert len(seen) == hits and ex.breaker_for("remote-model").state == state
        assert ex.root.unit._grpc_channel is not None  # an application status keeps the channel
        await remote.close_remote_units(ex)
    finally:
        await server.stop(None)


async def test_tiny_split_dag_over_grpc_equals_rest_split_and_in_process_dag():
    """The two bert_tiny arms served by unit servers with a gRPC port beside
    REST: an engine whose arms' endpoints are GRPC, one whose arms are REST
    and the in-process DAG route every request alike and answer bit for
    bit; a feedback over gRPC moves only the routed arm's reward."""
    arms = [_arm("bert-a", 0), _arm("bert-b", 1)]
    arm_servers = []
    for arm in arms:
        pred = SeldonDeployment.from_dict(_dep(arm, arm["name"])).spec.predictors[0]
        srv = PredictorServer(pred, deployment_name=arm["name"], device="cpu")
        srv.warmup()
        await srv.start("127.0.0.1", 0, grpc_port=0)
        arm_servers.append(srv)

    def engine(etype, ports, name):
        remote_arms = [_unit(a["name"], p, etype=etype) for a, p in zip(arms, ports)]
        return PredictorServer(SeldonDeployment.from_dict(_dep(_tiny_dag(remote_arms), name)).spec.predictors[0],
                               deployment_name=name, device="cpu")

    grpc_split = engine("GRPC", [s.grpc_port for s in arm_servers], "grpc-split")
    rest_split = engine("REST", [s.port for s in arm_servers], "rest-split")
    local = PredictorServer(SeldonDeployment.from_dict(_dep(_tiny_dag(arms), "local")).spec.predictors[0],
                            deployment_name="local", device="cpu")
    local.warmup()
    rng = np.random.default_rng(4)
    try:
        assert all(c.unit.is_grpc for c in grpc_split.executor.root.children[0].children)
        routes = []
        for _ in range(8):
            ids = rng.integers(0, 1024, size=(1, 16)).astype(np.float32)
            a, b, c = [await s.service.predict(SeldonMessage.from_array(ids))
                       for s in (grpc_split, rest_split, local)]
            assert a.meta.routing == b.meta.routing == c.meta.routing
            np.testing.assert_array_equal(np.asarray(a.array), np.asarray(c.array))
            np.testing.assert_array_equal(np.asarray(b.array), np.asarray(c.array))
            routes.append(a.meta.routing["eg"])
        assert set(routes) == {0, 1}
        router = grpc_split.executor.root.children[0].unit
        rewards = list(router.rewards)
        await grpc_split.service.send_feedback(Feedback(response=a, reward=1.0))
        assert router.rewards == [r + (1.0 if i == routes[-1] else 0.0) for i, r in enumerate(rewards)]
    finally:
        await _RestSession.close()
        for srv in (*arm_servers, grpc_split, rest_split, local):
            await srv.stop()


async def test_grpc_remote_hop_continues_trace():
    """The unit server's ingress span of a gRPC hop stitches under the
    engine's unit span through the traceparent metadata key."""
    from seldon_core_tpu_torch import telemetry as tel
    from seldon_core_tpu_torch.serving.service import PredictionService
    from seldon_core_tpu_torch.telemetry.store import SpanStore

    tracer = tel.Tracer(store=SpanStore(sample_rate=1.0))
    child = _simple_service(deployment_name="child", tracer=tracer)
    server = await _grpc_server(child)
    try:
        parent = PredictionService(build_executor(_predictor(_unit("remote-model", server.bound_port,
                                                                   etype="GRPC"))),
                                   deployment_name="parent", tracer=tracer)
        out = await parent.predict(SeldonMessage.from_array(np.ones((1, 4), np.float32),
                                                            meta=Meta(tags={"trace": True})))
        spans = tracer.store.get(out.meta.puid).to_dict()["trace"]
        assert len({s["trace_id"] for s in spans}) == 1
        by_id = {s["span_id"]: s for s in spans}
        child_ingress = [s for s in spans if s["name"] == "ingress"
                         and s.get("attrs", {}).get("deployment") == "child"]
        assert len(child_ingress) == 1
        assert by_id[child_ingress[0]["parent_id"]]["name"].startswith("remote-model.")
        await remote.close_remote_units(parent.executor)
    finally:
        await server.stop(None)
