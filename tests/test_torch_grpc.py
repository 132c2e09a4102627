"""The gRPC contract, codec and server of the port against the JAX package's,
on the CPU:

- the shipped ``.proto`` files say what the JAX package's say (the same
  text but for comments, and protoc compiles both to the same
  descriptors), the generated ``*_pb2`` modules are the same files, and
  their serialized descriptors equal byte for byte; ``services.SERVICES``
  equals the JAX table by service, method and message full name;
- the protoc cases of ``tests/test_proto_codegen.py``: the shipped file
  compiles from a clean directory into the reference's service surface,
  and a stub built from the descriptor set drives the port's live server;
- ``message_to_proto(...).SerializeToString(deterministic=True)`` equal
  between the packages for every arm and meta field, feedback and message
  lists, and the decoded messages equal (a hypothesis property too);
- the cases of ``tests/test_grpc.py`` on the port's server: predict and
  feedback, the ``seldon.protos`` prefix, ``Model``, ``ServerInfo`` (one
  "cpu" device here) and the npy binData round trip;
- lockstep: the same requests to the JAX gRPC server and the port's,
  serving ``iris_logistic`` with the JAX parameters carried across,
  probabilities within 1e-5;
- the server CLI: ``--grpc-port 0`` serves REST alone; where ``grpc``
  cannot be imported, the default port is skipped with a warning naming
  the module and an explicit ``--grpc-port`` is an error.

Every server binds port 0 and reads the bound port back.
"""

import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import grpc
import jax
import numpy as np
import pytest
from google.protobuf import descriptor_pb2, descriptor_pool, message_factory
from hypothesis import given, settings
from hypothesis import strategies as st

from seldon_core_tpu.core import codec_proto as jax_codec
from seldon_core_tpu.core.codec_json import message_from_dict as jax_message_from_dict
from seldon_core_tpu.core.message import DataKind as JaxDataKind
from seldon_core_tpu.core.message import Feedback as JaxFeedback
from seldon_core_tpu.core.message import Meta as JaxMeta
from seldon_core_tpu.core.message import SeldonMessage as JaxSeldonMessage
from seldon_core_tpu.engine import build_executor as jax_build_executor
from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictorSpec
from seldon_core_tpu.proto import PROTO_DIR as JAX_PROTO_DIR
from seldon_core_tpu.proto import prediction_pb2 as jax_pb
from seldon_core_tpu.proto import seldon_deployment_pb2 as jax_deployment_pb
from seldon_core_tpu.proto import services as jax_services
from seldon_core_tpu.serving import grpc_server as jax_grpc_server
from seldon_core_tpu.serving.service import PredictionService as JaxPredictionService
from seldon_core_tpu_torch.core import codec_proto
from seldon_core_tpu_torch.core.codec_json import message_from_dict
from seldon_core_tpu_torch.core.codec_npy import array_from_npy, npy_from_array
from seldon_core_tpu_torch.core.message import DataKind, Feedback, Meta, SeldonMessage, Status, StatusFlag
from seldon_core_tpu_torch.engine.executor import build_executor
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.proto import PROTO_DIR, prediction_pb2, seldon_deployment_pb2
from seldon_core_tpu_torch.proto.services import SERVICES, ServiceStub
from seldon_core_tpu_torch.serving.grpc_server import start_grpc_server
from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor
from seldon_core_tpu_torch.serving.service import PredictionService

ROOT = Path(__file__).resolve().parents[1]
SIMPLE = {"name": "p", "graph": {"name": "simple-model", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}
PROTOS = ("prediction.proto", "seldon_deployment.proto")


def _service(name="d", predictor="p"):
    return PredictionService(build_executor(PredictorSpec.from_dict(SIMPLE)), deployment_name=name,
                             predictor_name=predictor)


class _Grpc:
    """The port's gRPC server on a free port for one test, and a channel."""

    def __init__(self, service):
        self.service = service

    async def __aenter__(self):
        self.server = await start_grpc_server(self.service, "127.0.0.1", 0)
        self.channel = grpc.aio.insecure_channel(f"127.0.0.1:{self.server.bound_port}")
        return self

    async def __aexit__(self, *exc):
        await self.channel.close()
        await self.server.stop(None)


# ------------------------------------------------------------ the contract


def _code(text: str) -> str:
    """A .proto file without its comments and blank lines."""
    lines = (re.sub(r"//.*", "", ln).rstrip() for ln in text.splitlines())
    return "\n".join(ln for ln in lines if ln)


def _protoc(src: Path, tmp_path: Path) -> descriptor_pb2.FileDescriptorSet:
    """protoc the file from a clean directory, like a third party."""
    if shutil.which("protoc") is None:
        pytest.skip("protoc not installed")
    work = tmp_path / src.parent.parent.name
    work.mkdir(parents=True, exist_ok=True)
    shutil.copy(src, work / src.name)
    out = work / "fds.pb"
    res = subprocess.run(["protoc", f"--proto_path={work}", f"--descriptor_set_out={out}", "--include_imports",
                          str(work / src.name)], capture_output=True, timeout=60)
    assert res.returncode == 0, res.stderr.decode()
    fds = descriptor_pb2.FileDescriptorSet()
    fds.ParseFromString(out.read_bytes())
    return fds


@pytest.mark.parametrize("name", PROTOS)
def test_proto_files_and_descriptors_equal_jax(name, tmp_path):
    ours, theirs = (PROTO_DIR / name).read_text(), (JAX_PROTO_DIR / name).read_text()
    assert _code(ours) == _code(theirs)
    pb2 = name.replace(".proto", "_pb2.py")
    assert (PROTO_DIR / pb2).read_bytes() == (JAX_PROTO_DIR / pb2).read_bytes()
    module, jax_module = {"prediction.proto": (prediction_pb2, jax_pb),
                          "seldon_deployment.proto": (seldon_deployment_pb2, jax_deployment_pb)}[name]
    assert module.DESCRIPTOR.serialized_pb == jax_module.DESCRIPTOR.serialized_pb
    # one file in protobuf's default pool: both modules share its classes
    assert module.DESCRIPTOR is jax_module.DESCRIPTOR
    compiled = {f.name: f for f in _protoc(PROTO_DIR / name, tmp_path).file}
    jax_compiled = {f.name: f for f in _protoc(JAX_PROTO_DIR / name, tmp_path).file}
    assert compiled == jax_compiled


def test_services_table_equals_jax():
    def table(services):
        return {svc: {m: (req.DESCRIPTOR.full_name, resp.DESCRIPTOR.full_name) for m, (req, resp) in methods.items()}
                for svc, methods in services.items()}

    assert table(SERVICES) == table(jax_services.SERVICES)
    assert jax_services.PACKAGES == ("seldon.tpu", "seldon.protos")


# the reference contract surface (prediction.proto:76-109)
REFERENCE_SERVICES = {
    "Generic": {
        "TransformInput": ("SeldonMessage", "SeldonMessage"),
        "TransformOutput": ("SeldonMessage", "SeldonMessage"),
        "Route": ("SeldonMessage", "SeldonMessage"),
        "Aggregate": ("SeldonMessageList", "SeldonMessage"),
        "SendFeedback": ("Feedback", "SeldonMessage"),
    },
    "Model": {"Predict": ("SeldonMessage", "SeldonMessage")},
    "Router": {"Route": ("SeldonMessage", "SeldonMessage"), "SendFeedback": ("Feedback", "SeldonMessage")},
    "Transformer": {"TransformInput": ("SeldonMessage", "SeldonMessage")},
    "OutputTransformer": {"TransformOutput": ("SeldonMessage", "SeldonMessage")},
    "Combiner": {"Aggregate": ("SeldonMessageList", "SeldonMessage")},
    "Seldon": {"Predict": ("SeldonMessage", "SeldonMessage"), "SendFeedback": ("Feedback", "SeldonMessage")},
}


def test_shipped_proto_compiles_and_ships_reference_services(tmp_path):
    (main,) = [f for f in _protoc(PROTO_DIR / "prediction.proto", tmp_path).file if f.name == "prediction.proto"]
    assert main.package == "seldon.tpu"
    compiled = {s.name: {m.name: (m.input_type.rsplit(".", 1)[-1], m.output_type.rsplit(".", 1)[-1])
                         for m in s.method} for s in main.service}
    for svc, methods in REFERENCE_SERVICES.items():
        assert compiled[svc] == methods, svc
    for svc, methods in compiled.items():
        runtime = {name: (req.DESCRIPTOR.name, resp.DESCRIPTOR.name) for name, (req, resp) in SERVICES[svc].items()}
        assert runtime == methods, svc
    assert set(SERVICES) == set(compiled)


async def test_descriptor_generated_stub_drives_the_ports_live_server(tmp_path):
    """Message classes and method paths built only from protoc's output (a
    third party's codegen) call the port's server."""
    fds = _protoc(PROTO_DIR / "prediction.proto", tmp_path)
    pool = descriptor_pool.DescriptorPool()
    for f in fds.file:
        pool.Add(f)
    msg_cls = message_factory.GetMessageClass(pool.FindMessageTypeByName("seldon.tpu.SeldonMessage"))
    svc = pool.FindServiceByName("seldon.tpu.Seldon")
    async with _Grpc(_service()) as g:
        call = g.channel.unary_unary(f"/{svc.full_name}/Predict", request_serializer=lambda m: m.SerializeToString(),
                                     response_deserializer=msg_cls.FromString)
        req = msg_cls.FromString(codec_proto.message_to_proto(
            SeldonMessage.from_array(np.ones((2, 4), np.float32))).SerializeToString())
        reply = await call(req)
        assert reply.meta.puid
        out = codec_proto.message_from_proto(prediction_pb2.SeldonMessage.FromString(reply.SerializeToString()))
        np.testing.assert_allclose(np.asarray(out.array), [[0.1, 0.9, 0.5]] * 2, rtol=1e-6)


# --------------------------------------------------------------- the codec

META = dict(puid="p-1", tags={"k": "v", "n": 2.0, "flag": True, "nested": {"a": [1.0, "x"]}, "none": None},
            routing={"r": 1, "eg": -1}, request_path={"model": "image:1"})
ARR = np.asarray([[1.5, -2.25, 3.0], [4.0, 5.5, 1e-7]], np.float32)


def _pair(kind: str):
    """The same message built from each package's classes."""
    def build(msg_cls, meta_cls, kind_cls, status_factory):
        meta = meta_cls(**META) if kind != "plain" else meta_cls()
        if kind in ("tensor", "ndarray", "plain"):
            return msg_cls.from_array(ARR, ("a", "b", "c"), meta=meta,
                                      kind=kind_cls.NDARRAY if kind == "ndarray" else kind_cls.TENSOR)
        if kind == "binData":
            return msg_cls(bin_data=b"\x00\x93NUMPY-ish bytes", meta=meta)
        if kind == "strData":
            return msg_cls(str_data="hello, reference", meta=meta)
        if kind == "status":
            return msg_cls(status=status_factory(), meta=meta)
        raise AssertionError(kind)

    from seldon_core_tpu.core.message import Status as JaxStatus
    from seldon_core_tpu.core.message import StatusFlag as JaxStatusFlag

    ours = build(SeldonMessage, Meta, DataKind, lambda: Status(code=205, info="oauth_token", reason="No Principal",
                                                               status=StatusFlag.FAILURE))
    theirs = build(JaxSeldonMessage, JaxMeta, JaxDataKind,
                   lambda: JaxStatus(code=205, info="oauth_token", reason="No Principal", status=JaxStatusFlag.FAILURE))
    return ours, theirs


def _wire(m) -> bytes:
    return m.SerializeToString(deterministic=True)


def _same_message(a, b) -> None:
    assert (a.meta.puid, dict(a.meta.tags), dict(a.meta.routing), dict(a.meta.request_path)) == (
        b.meta.puid, dict(b.meta.tags), dict(b.meta.routing), dict(b.meta.request_path))
    assert (a.bin_data, a.str_data) == (b.bin_data, b.str_data)
    assert (a.status is None) == (b.status is None)
    if a.status is not None:
        assert (a.status.code, a.status.info, a.status.reason, int(a.status.status)) == (
            b.status.code, b.status.info, b.status.reason, int(b.status.status))
    assert (a.data is None) == (b.data is None)
    if a.data is not None:
        assert a.data.names == b.data.names and a.data.kind.value == b.data.kind.value
        x, y = np.asarray(a.array), np.asarray(b.array)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("kind", ["tensor", "ndarray", "plain", "binData", "strData", "status"])
def test_message_bytes_equal_jax(kind):
    ours, theirs = _pair(kind)
    wire = _wire(codec_proto.message_to_proto(ours))
    assert wire == _wire(jax_codec.message_to_proto(theirs))
    back = codec_proto.message_from_proto(prediction_pb2.SeldonMessage.FromString(wire))
    _same_message(back, jax_codec.message_from_proto(jax_pb.SeldonMessage.FromString(wire)))
    _same_message(back, ours)


def test_feedback_and_message_list_bytes_equal_jax():
    (req, jreq), (resp, jresp), (truth, jtruth) = _pair("tensor"), _pair("status"), _pair("ndarray")
    fb = codec_proto.feedback_to_proto(Feedback(request=req, response=resp, reward=0.75, truth=truth))
    jfb = jax_codec.feedback_to_proto(JaxFeedback(request=jreq, response=jresp, reward=0.75, truth=jtruth))
    assert _wire(fb) == _wire(jfb)
    back = codec_proto.feedback_from_proto(prediction_pb2.Feedback.FromString(_wire(fb)))
    assert back.reward == 0.75
    for a, b in ((back.request, req), (back.response, resp), (back.truth, truth)):
        _same_message(a, b)
    assert codec_proto.feedback_from_proto(prediction_pb2.Feedback()).request is None
    ml = codec_proto.message_list_to_proto([req, truth])
    assert _wire(ml) == _wire(jax_codec.message_list_to_proto([jreq, jtruth]))
    for a, b in zip(codec_proto.message_list_from_proto(ml), (req, truth)):
        _same_message(a, b)


def test_card_tensors_and_the_json_arm_encode_as_jax():
    """A torch tensor payload encodes as its host values; the jsonData arm,
    which the proto lacks, as a message without data (the JAX codec's
    answer)."""
    import torch

    ours = codec_proto.message_to_proto(SeldonMessage.from_array(torch.from_numpy(ARR)))
    assert _wire(ours) == _wire(jax_codec.message_to_proto(JaxSeldonMessage.from_array(ARR)))
    blank = codec_proto.message_to_proto(SeldonMessage(json_data={"a": 1}))
    assert blank.WhichOneof("data_oneof") is None


finite = st.floats(min_value=-1e6, max_value=1e6, allow_nan=False, allow_infinity=False, width=32)


@st.composite
def message_dicts(draw):
    rows, cols = draw(st.integers(1, 4)), draw(st.integers(1, 5))
    data = {draw(st.sampled_from(["ndarray", "tensor"])): None}
    values = [[draw(finite) for _ in range(cols)] for _ in range(rows)]
    if "tensor" in data:
        data = {"tensor": {"shape": [rows, cols], "values": [v for r in values for v in r]}}
    else:
        data = {"ndarray": values}
    if draw(st.booleans()):
        data["names"] = [draw(st.text(alphabet="abcxyz_", min_size=1, max_size=6)) for _ in range(cols)]
    msg = {"data": data}
    if draw(st.booleans()):
        msg["meta"] = {
            "puid": draw(st.text(alphabet="0123456789abcdef", max_size=12)),
            "tags": draw(st.dictionaries(st.text(alphabet="abc", min_size=1, max_size=4),
                                         st.one_of(st.text(max_size=6), finite.map(float), st.booleans()),
                                         max_size=3)),
            "routing": draw(st.dictionaries(st.text(alphabet="nr", min_size=1, max_size=3), st.integers(-1, 5),
                                            max_size=3)),
            "requestPath": draw(st.dictionaries(st.text(alphabet="xy", min_size=1, max_size=3),
                                                st.text(alphabet="img:1", max_size=6), max_size=2)),
        }
    return msg


@settings(max_examples=40, deadline=None)
@given(message_dicts())
def test_codec_property_bytes_and_round_trip_equal_jax(obj):
    ours, theirs = message_from_dict(obj), jax_message_from_dict(obj)
    wire = _wire(codec_proto.message_to_proto(ours))
    assert wire == _wire(jax_codec.message_to_proto(theirs))
    back = codec_proto.message_from_proto(prediction_pb2.SeldonMessage.FromString(wire))
    _same_message(back, jax_codec.message_from_proto(jax_pb.SeldonMessage.FromString(wire)))
    np.testing.assert_array_equal(np.asarray(back.array), np.asarray(ours.array, np.float32))
    assert back.meta.routing == ours.meta.routing


# -------------------------------------------------------- the gRPC server


async def test_grpc_predict_and_feedback_end_to_end():
    async with _Grpc(_service()) as g:
        stub = ServiceStub(g.channel, "Seldon")
        req = codec_proto.message_to_proto(SeldonMessage.from_array(np.ones((2, 4), np.float32)))
        out = codec_proto.message_from_proto(await stub.Predict(req))
        np.testing.assert_allclose(np.asarray(out.array), np.repeat([[0.1, 0.9, 0.5]], 2, 0), rtol=1e-6)
        assert out.meta.puid
        ack = await stub.SendFeedback(prediction_pb2.Feedback(reward=1.0))
        assert ack.meta.puid
        # the reference's package spelling and the Model service, same server
        for service, package in (("Seldon", "seldon.protos"), ("Model", "seldon.tpu"), ("Model", "seldon.protos")):
            reply = await ServiceStub(g.channel, service, package=package).Predict(req)
            np.testing.assert_allclose(np.asarray(codec_proto.message_from_proto(reply).array),
                                       np.asarray(out.array))


async def test_grpc_admin_server_info_reports_the_ports_device():
    async with _Grpc(_service("dep", "main")) as g:
        info = await ServiceStub(g.channel, "Admin").ServerInfo(prediction_pb2.ServerInfoRequest())
        assert (info.deployment_name, info.predictor_name) == ("dep", "main")
        assert (info.platform, info.device_count) == ("cpu", 1)


async def test_grpc_bindata_npy_roundtrip():
    async with _Grpc(_service()) as g:
        req = codec_proto.message_to_proto(SeldonMessage(bin_data=npy_from_array(np.ones((2, 4), np.uint8))))
        out = codec_proto.message_from_proto(await ServiceStub(g.channel, "Seldon").Predict(req))
        assert out.bin_data is not None and out.data is None
        np.testing.assert_allclose(array_from_npy(out.bin_data), [[0.1, 0.9, 0.5]] * 2, rtol=1e-6)
        assert out.meta.tags.get("names") == ["c0", "c1", "c2"]


async def test_grpc_unit_services_call_the_root_unit_and_failures_are_messages():
    """Router.Route answers the branch as a 1x1 tensor, Combiner.Aggregate
    takes a SeldonMessageList; an application error (here a spent deadline
    budget) is a FAILURE message with its code, not a transport error."""
    children = [SIMPLE["graph"], {**SIMPLE["graph"], "name": "b"}]
    router = {"name": "p", "graph": {"name": "ab", "type": "ROUTER", "implementation": "RANDOM_ABTEST",
                                     "parameters": [{"name": "ratioA", "value": "1.0", "type": "FLOAT"}],
                                     "children": children}}
    service = PredictionService(build_executor(PredictorSpec.from_dict(router)), deployment_name="d")
    req = codec_proto.message_to_proto(SeldonMessage.from_array(np.ones((1, 4), np.float32)))
    async with _Grpc(service) as g:
        for stub in (ServiceStub(g.channel, "Router", package="seldon.protos"), ServiceStub(g.channel, "Generic")):
            reply = await stub.Route(req)
            assert list(reply.data.tensor.shape) == [1, 1] and list(reply.data.tensor.values) == [0.0]
        late = SeldonMessage.from_array(np.ones((1, 4), np.float32), meta=Meta(tags={"deadline_ms": 1e-6}))
        bad = await ServiceStub(g.channel, "Seldon").Predict(codec_proto.message_to_proto(late))
        assert bad.status.status == prediction_pb2.Status.FAILURE and bad.status.code == 304
    combiner = {"name": "p", "graph": {"name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
                                       "children": children}}
    service = PredictionService(build_executor(PredictorSpec.from_dict(combiner)), deployment_name="d")
    async with _Grpc(service) as g:
        msgs = [SeldonMessage.from_array(np.full((1, 2), v, np.float32)) for v in (1.0, 3.0)]
        reply = await ServiceStub(g.channel, "Combiner").Aggregate(codec_proto.message_list_to_proto(msgs))
        np.testing.assert_allclose(np.asarray(codec_proto.message_from_proto(reply).array), [[2.0, 2.0]])


def _carry_weights(node, jax_node):
    rt, jrt = getattr(node.unit, "runtime", None), getattr(jax_node.unit, "runtime", None)
    if rt is not None:
        rt.params = params_to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32), jrt.params), rt.device,
                                    rt.dtype)
    for c, jc in zip(node.children, jax_node.children):
        _carry_weights(c, jc)


async def test_lockstep_with_the_jax_grpc_server_on_iris(monkeypatch):
    """The same requests to the JAX package's gRPC server and the port's,
    serving iris_logistic with the JAX parameters carried across."""
    import json

    path = ROOT / "seldon_core_tpu_torch" / "deployments" / "iris.json"
    predictor, dep = load_predictor(str(path))
    server = PredictorServer(predictor, deployment_name=dep, device="cpu", enable_batching=False)
    jservice = JaxPredictionService(jax_build_executor(JaxPredictorSpec.model_validate(
        json.loads(path.read_text())["spec"]["predictors"][0])), deployment_name=dep)
    _carry_weights(server.executor.root, jservice.executor.root)
    bound = {}
    real = grpc.aio.server

    def recording_server(*a, **k):
        s = real(*a, **k)
        add = s.add_insecure_port
        s.add_insecure_port = lambda addr: bound.setdefault("port", add(addr))
        return s

    monkeypatch.setattr(grpc.aio, "server", recording_server)
    jserver = await jax_grpc_server.start_grpc_server(jservice, "127.0.0.1", 0)
    monkeypatch.setattr(grpc.aio, "server", real)
    await server.start("127.0.0.1", 0, grpc_port=0)
    rng = np.random.default_rng(5)
    try:
        async with grpc.aio.insecure_channel(f"127.0.0.1:{server.grpc_port}") as ch, \
                grpc.aio.insecure_channel(f"127.0.0.1:{bound['port']}") as jch:
            for rows in (1, 3, 7):
                x = (rng.random((rows, 4)) * 6).astype(np.float32)
                for kind in (DataKind.TENSOR, DataKind.NDARRAY):
                    req = codec_proto.message_to_proto(SeldonMessage.from_array(x, kind=kind))
                    ours = await ServiceStub(ch, "Seldon").Predict(req)
                    theirs = await jax_services.ServiceStub(jch, "Seldon").Predict(req)
                    assert ours.data.WhichOneof("data_oneof") == theirs.data.WhichOneof("data_oneof") == kind.value
                    a = np.asarray(codec_proto.message_from_proto(ours).array)
                    b = np.asarray(jax_codec.message_from_proto(theirs).array)
                    assert a.shape == b.shape == (rows, 3)
                    np.testing.assert_allclose(a, b, atol=1e-5)
            fb = prediction_pb2.Feedback(reward=1.0)
            ours = await ServiceStub(ch, "Seldon").SendFeedback(fb)
            theirs = await jax_services.ServiceStub(jch, "Seldon").SendFeedback(fb)
            assert ours.HasField("status") == theirs.HasField("status")
    finally:
        await jserver.stop(None)
        await server.stop()


def _server_cli(*args: str, block_grpc: bool = False):
    """The server CLI on iris (``--device cpu --port 0``) in a process of
    its own: (process, its "serving" line or None, the output read)."""
    code = textwrap.dedent(f"""
        import sys
        if {block_grpc!r}:
            class Block:
                def find_spec(self, name, path=None, target=None):
                    if name == "grpc" or name.startswith("grpc."):
                        raise ImportError("blocked: grpc", name="grpc")
            sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
        from seldon_core_tpu_torch.serving.server import main
        main(sys.argv[1:])
    """)
    proc = subprocess.Popen([sys.executable, "-c", code, "--deployment",
                             str(ROOT / "seldon_core_tpu_torch/deployments/iris.json"), "--device", "cpu",
                             "--host", "127.0.0.1", "--port", "0", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    seen = []
    for line in proc.stdout:
        seen.append(line)
        if re.search(r" serving REST :\d+", line):
            return proc, line, "".join(seen)
    proc.wait(timeout=30)
    return proc, None, "".join(seen)


def test_server_cli_grpc_port_and_a_host_without_grpc():
    for args, block, want in ((("--grpc-port", "0"), False, "REST only"),
                              ((), True, "warned"), (("--grpc-port", "5099"), True, "refused")):
        proc, line, out = _server_cli(*args, block_grpc=block)
        try:
            if want == "refused":
                assert line is None and proc.returncode != 0 and "grpc" in out, out[-2000:]
                continue
            assert line is not None and "serving REST :" in line and "gRPC" not in line, out[-2000:]
            if want == "warned":
                assert "gRPC not served: grpc cannot be imported" in out
        finally:
            if proc.poll() is None:
                proc.terminate()
                proc.wait(timeout=30)
