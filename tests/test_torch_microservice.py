"""The standalone microservice (``seldon_core_tpu_torch/serving/
microservice.py``) against the JAX package's, on the CPU:

- ``parse_parameters`` equal to the JAX function on the same env JSON;
- ``SERVICE_TYPES`` (OUTLIER_DETECTOR included) and
  ``build_single_unit_predictor``: the JAX package's types, a childless
  unit of the service type;
- ``--persistence``: a user object's state snapshotted at shutdown and
  restored when the next process boots on the same store;
- the CLI (``python -m seldon_core_tpu_torch.serving.microservice``)
  serving the internal API on ``--port``, ``PREDICTIVE_UNIT_PARAMETERS``
  reaching the constructor, ``GRPC`` serving ``Model.Predict`` on
  ``--grpc-port`` and no REST port, ``BOTH`` serving both;
- ``serve_microservice(grpc_port=..., enable_rest=False)``: gRPC only, as
  the JAX package's (``tests/test_tools.py``'s GRPC-only case);
- an OUTLIER_DETECTOR microservice tagging ``outlierScore`` as the JAX
  package's does.
"""

import asyncio
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from seldon_core_tpu.serving import microservice as jax_microservice
from seldon_core_tpu_torch.core.message import Feedback, SeldonMessage
from seldon_core_tpu_torch.graph.spec import PredictiveUnitType
from seldon_core_tpu_torch.serving import microservice
from seldon_core_tpu_torch.serving.http_client import HttpPool

ROOT = Path(__file__).resolve().parents[1]

PARAMETER_CASES = [
    None,
    "",
    "[]",
    json.dumps([{"name": "n", "value": "3", "type": "INT"}, {"name": "lr", "value": "0.5", "type": "FLOAT"},
                {"name": "d", "value": "1e-3", "type": "DOUBLE"}, {"name": "tag", "value": "x"}]),
    json.dumps([{"name": f"b{i}", "value": v, "type": "BOOL"} for i, v in enumerate(["true", "True", "1", "yes",
                                                                                       "no", "false", "0"])]),
    json.dumps([{"name": "s", "value": "7", "type": "STRING"}, {"name": "i", "value": 12, "type": "INT"}]),
]


@pytest.mark.parametrize("raw", PARAMETER_CASES)
def test_parse_parameters_matches_jax(raw):
    ours, theirs = microservice.parse_parameters(raw), jax_microservice.parse_parameters(raw)
    assert ours == theirs
    assert [type(v) for v in ours.values()] == [type(v) for v in theirs.values()]


@pytest.mark.parametrize("stype", sorted(jax_microservice.SERVICE_TYPES))
def test_service_types_and_single_unit_predictor(stype):
    assert set(microservice.SERVICE_TYPES) == set(jax_microservice.SERVICE_TYPES)
    pred = microservice.build_single_unit_predictor("Unit", stype)
    jpred = jax_microservice.build_single_unit_predictor("Unit", stype)
    assert pred.graph.name == jpred.graph.name == "Unit"
    assert pred.graph.type.value == jpred.graph.type.value
    assert pred.graph.children == () and list(jpred.graph.children) == []
    if stype == "OUTLIER_DETECTOR":
        assert pred.graph.type == PredictiveUnitType.TRANSFORMER


def _write(directory: Path, name: str, body: str) -> str:
    directory.mkdir(parents=True, exist_ok=True)
    (directory / f"{name}.py").write_text(textwrap.dedent(body))
    return str(directory)


COUNTER = """
    class Counter:
        def __init__(self, start=0):
            self.n = start
        def predict(self, X, names):
            return X * 0 + self.n
        def route(self, X, names):
            return self.n % 2
        def send_feedback(self, X, names, routing, reward, truth):
            self.n += int(reward)
"""


async def test_persistence_restores_user_state_on_boot(tmp_path):
    model_dir = _write(tmp_path / "m", "Counter", COUNTER)
    url = f"file://{tmp_path / 'state'}"
    user = microservice.load_user_object("Counter", model_dir)
    # a router learns from feedback (a MODEL unit takes none, as in the reference)
    server, service, persister = await microservice.serve_microservice(
        user, "Counter", "ROUTER", host="127.0.0.1", http_port=0, persistence_url=url)
    try:
        for _ in range(3):
            await service.send_feedback(Feedback(request=SeldonMessage.from_array(np.ones((1, 2))), reward=2.0))
        assert user.n == 6
    finally:
        server.close()
        await server.wait_closed()
        persister.stop()  # the shutdown's final snapshot
    # the next process: a fresh object from the class, restored on boot
    fresh = microservice.load_user_object("Counter", model_dir)
    assert fresh.n == 0
    server, service, persister = await microservice.serve_microservice(
        fresh, "Counter", "ROUTER", host="127.0.0.1", http_port=0, persistence_url=url)
    try:
        assert fresh.n == 6
        assert await service.executor.root.unit.route(SeldonMessage.from_array(np.ones((1, 2), np.float32))) == 0
    finally:
        server.close()
        await server.wait_closed()
        persister.stop()


def _cli(model_dir: str, *args: str):
    """The microservice CLI serving Counter(start=5); returns the process
    and its "serving ..." line."""
    env = {**os.environ, "PREDICTIVE_UNIT_PARAMETERS": json.dumps([{"name": "start", "value": "5", "type": "INT"}])}
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.serving.microservice", "Counter", *args,
         "--service-type", "MODEL", "--model-dir", model_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env,
    )
    for line in proc.stdout:
        if " serving " in line:
            return proc, line
    proc.wait(timeout=30)
    raise AssertionError("the microservice exited before serving")


def _stop(proc) -> None:
    proc.terminate()
    proc.wait(timeout=30)
    assert proc.returncode == 0


def test_cli_serves_the_internal_api_and_refuses_grpc(tmp_path):
    """REST on --port; GRPC serves Model.Predict on --grpc-port (0: a free
    port) and opens no REST port; BOTH serves the two; an unknown api is
    refused by argparse."""
    import re

    import grpc

    from seldon_core_tpu_torch.proto import prediction_pb2 as pb
    from seldon_core_tpu_torch.proto.services import ServiceStub
    from tests.conftest import free_port

    model_dir = _write(tmp_path / "m", "Counter", COUNTER)
    out = subprocess.run([sys.executable, "-m", "seldon_core_tpu_torch.serving.microservice", "Counter", "SOAP",
                          "--model-dir", model_dir], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 2 and "invalid choice: 'SOAP'" in out.stderr

    def ask_rest(port):
        async def ask():
            pool = HttpPool()
            try:
                body = json.dumps({"data": {"ndarray": [[1.0, 2.0]]}}).encode()
                return [await pool.post(f"http://127.0.0.1:{port}{p}", body) for p in ("/predict",
                                                                                       "/api/v0.1/predictions")]
            finally:
                await pool.close()

        for resp in asyncio.run(ask()):
            assert resp.status == 200 and resp.json()["data"]["ndarray"] == [[5.0, 5.0]]

    def ask_grpc(port):
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            req = pb.SeldonMessage()
            row = req.data.ndarray.values.add().list_value
            for v in (1.0, 2.0):
                row.values.add().number_value = v
            reply = ServiceStub(ch, "Model", package="seldon.protos").Predict(req, timeout=30)
        assert [v.number_value for v in reply.data.ndarray.values[0].list_value.values] == [5.0, 5.0]

    port = free_port()
    proc, line = _cli(model_dir, "REST", "--port", str(port))
    try:
        assert f"serving REST :{port}" in line and "gRPC" not in line
        ask_rest(port)
    finally:
        _stop(proc)
    proc, line = _cli(model_dir, "GRPC", "--grpc-port", "0")
    try:
        assert "REST" not in line
        ask_grpc(int(re.search(r"gRPC :(\d+)", line).group(1)))
    finally:
        _stop(proc)
    proc, line = _cli(model_dir, "BOTH", "--port", "0", "--grpc-port", "0")
    try:
        ask_rest(int(re.search(r"REST :(\d+)", line).group(1)))
        ask_grpc(int(re.search(r"gRPC :(\d+)", line).group(1)))
    finally:
        _stop(proc)


async def test_microservice_grpc_only_has_no_rest(tmp_path):
    """serve_microservice with gRPC alone, as the JAX package's: no REST
    listener, Model.Predict answering, the service and persister as
    before."""
    import grpc

    from seldon_core_tpu_torch.proto import prediction_pb2 as pb
    from seldon_core_tpu_torch.proto.services import ServiceStub

    class Ident:
        def predict(self, X, names):
            return X

    served = await microservice.serve_microservice(Ident(), "Ident", "MODEL", host="127.0.0.1", grpc_port=0,
                                                   enable_rest=False)
    server, service, persister = served
    try:
        assert server is None and persister is None and service.deployment_name == "Ident"
        async with grpc.aio.insecure_channel(f"127.0.0.1:{served.grpc_server.bound_port}") as channel:
            req = pb.SeldonMessage()
            req.data.ndarray.values.add().list_value.values.add().number_value = 3.0
            reply = await ServiceStub(channel, "Model").Predict(req)
            assert reply.data.ndarray.values[0].list_value.values[0].number_value == 3.0
    finally:
        await served.grpc_server.stop(None)
    rest = await microservice.serve_microservice(Ident(), "Ident", "MODEL", host="127.0.0.1", http_port=0)
    assert rest.grpc_server is None
    rest[0].close()
    await rest[0].wait_closed()


async def test_outlier_detector_microservice_tags_like_jax(tmp_path):
    model_dir = _write(tmp_path / "o", "Scorer", """
        import numpy as np

        class Scorer:
            def score(self, X, names):
                return np.abs(np.asarray(X)).sum(axis=1)
    """)
    x = np.array([[1.0, -2.0], [3.0, 4.0]], np.float32)
    server, service, _ = await microservice.serve_microservice(
        microservice.load_user_object("Scorer", model_dir), "Scorer", "OUTLIER_DETECTOR", host="127.0.0.1",
        http_port=0)
    jserver = None
    try:
        from tests.conftest import free_port

        pool = HttpPool()
        port = server.sockets[0].getsockname()[1]
        jport = free_port()
        jserver, jgrpc, _ = await jax_microservice.serve_microservice(
            jax_microservice.load_user_object("Scorer", model_dir), "Scorer", "OUTLIER_DETECTOR", host="127.0.0.1",
            http_port=jport)
        body = json.dumps({"data": {"ndarray": x.tolist()}}).encode()
        ours = await pool.post(f"http://127.0.0.1:{port}/transform-input", body)
        theirs = await pool.post(f"http://127.0.0.1:{jport}/transform-input", body)
        await pool.close()
        assert ours.status == theirs.status == 200
        assert ours.json()["meta"]["tags"] == theirs.json()["meta"]["tags"] == {"outlierScore": [3.0, 7.0]}
        assert ours.json()["data"]["ndarray"] == theirs.json()["data"]["ndarray"] == x.tolist()
    finally:
        server.close()
        await server.wait_closed()
        if jserver is not None:
            await jserver.cleanup()
