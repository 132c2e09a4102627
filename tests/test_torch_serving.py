"""The port's serving path against the JAX package's, on the CPU.

- the dataclass spec parser agrees with the JAX pydantic parser on every
  example deployment (and on the port's own), raw and defaulted;
- a PredictorServer serving bert_tiny through the fast ingress answers
  /ping, /ready and JSON predictions that match the JAX ModelRuntime on the
  same weights (float32, rtol 2e-4 / atol 2e-5: tests/test_models_heavy.py's
  tolerance for the same model across attention arms);
- bad JSON is a 400 with code 101;
- a fresh interpreter serves a request with neither jax nor seldon_core_tpu
  imported, and no module of the port imports either.
"""

import ast
import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from seldon_core_tpu.graph import defaulting as jax_defaulting
from seldon_core_tpu.graph import spec as jax_spec
from seldon_core_tpu.models import bert as jax_bert
from seldon_core_tpu.models.base import ModelRuntime as JaxRuntime
from seldon_core_tpu_torch.core import tensor as port_tensor
from seldon_core_tpu_torch.graph import defaulting, spec
from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "seldon_core_tpu_torch"
DEPLOYMENTS = sorted((REPO / "examples" / "deployments").glob("*.json")) + sorted(
    (PACKAGE / "deployments").glob("*.json")
)
TOL = dict(rtol=2e-4, atol=2e-5)
SEQ = 16


def _enum(v):
    return None if v is None else v.value


def _unit_fields(u):
    return (
        u.name,
        _enum(u.type),
        _enum(u.implementation),
        [m.value for m in u.methods],
        None if u.endpoint is None else (u.endpoint.service_host, u.endpoint.service_port, u.endpoint.type.value),
        [(p.name, p.value, p.type.value, p.typed_value()) for p in u.parameters],
        [_unit_fields(c) for c in u.children],
    )


def _key_fields(dep):
    return (
        dep.apiVersion,
        dep.kind,
        dep.metadata.name,
        dep.spec.name,
        [
            (
                p.name,
                p.replicas,
                dict(p.annotations),
                _unit_fields(p.graph),
                [(c.name, c.image, c.model_uri, dict(c.env)) for c in p.componentSpec.containers],
                dict(p.tpu.mesh),
                list(p.tpu.batch_buckets),
                p.tpu.max_batch,
                p.tpu.batch_timeout_ms,
                p.tpu.queue_timeout_ms,
                p.tpu.dtype,
                p.tpu.offload_compute,
                p.tpu.fuse_graph,
                p.tpu.deadline_ms,
                p.tpu.batch_across_requests,
                p.tpu.weight_quant,
                p.tpu.donate_input,
                p.tpu.decode_replicas,
                p.tpu.decode_router_policy,
                p.tpu.decode_autoscale_replicas,
                p.tpu.decode_autoscale_queue_depth,
                p.tpu.decode_health_poll_ms,
                p.tpu.decode_health_miss_threshold,
                p.tpu.decode_drain_timeout_ms,
            )
            for p in dep.spec.predictors
        ],
    )


@pytest.mark.parametrize("path", DEPLOYMENTS, ids=lambda p: p.name)
def test_spec_parser_agrees_with_jax(path):
    obj = json.loads(path.read_text())
    ours, theirs = spec.SeldonDeployment.from_dict(obj), jax_spec.SeldonDeployment.from_dict(obj)
    assert _key_fields(ours) == _key_fields(theirs)
    ours_d = defaulting.default_deployment(ours, n_devices=1)
    theirs_d = jax_defaulting.default_deployment(theirs, n_devices=1)
    assert _key_fields(ours_d) == _key_fields(theirs_d)


def test_spec_parser_rejects_what_jax_rejects():
    bad = {"spec": {"predictors": [{"name": "p", "graph": {"name": "g", "type": "NOPE"}}]}}
    with pytest.raises(ValueError, match="NOPE"):
        spec.SeldonDeployment.from_dict(bad)
    with pytest.raises(ValueError, match="graph"):
        spec.SeldonDeployment.from_dict({"spec": {"predictors": [{"name": "p"}]}})


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_tensor.resolve_device(None)
    assert port_tensor.resolve_device("cpu") == torch.device("cpu")


def _deployment(tmp_path, kernel="auto"):
    dep = {
        "spec": {
            "name": "tiny",
            "predictors": [
                {
                    "name": "main",
                    "graph": {
                        "name": "bert",
                        "type": "MODEL",
                        "implementation": "JAX_MODEL",
                        "parameters": [
                            {"name": "model_uri", "value": f"zoo://bert_tiny?seq={SEQ}&seed=4", "type": "STRING"},
                            {"name": "attn_kernel", "value": kernel, "type": "STRING"},
                        ],
                    },
                    "tpu": {"max_batch": 4, "batch_buckets": [1, 4], "batch_timeout_ms": 20},
                }
            ],
        }
    }
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(dep))
    return path


async def _request(port, method, path, body=b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
        f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode() + body
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), payload


def _ids(n, seed):
    return np.random.default_rng(seed).integers(0, 1024, size=(n, SEQ))


def _jax_probs(ids):
    params = jax_bert.init_bert(4, vocab=1024, hidden=128, layers=2, ffn=256, max_len=128)
    return np.asarray(JaxRuntime(jax_bert.apply_bert, params, buckets=(1, 4), int_inputs="ids").predict(ids))


def test_predictor_server_matches_jax_over_fast_ingress(tmp_path):
    predictor, name = load_predictor(str(_deployment(tmp_path)))
    server = PredictorServer(predictor, deployment_name=name, device="cpu")
    server.warmup()
    batches = [_ids(1, 0), _ids(1, 1), _ids(1, 2), _ids(3, 3)]

    async def drive():
        await server.start("127.0.0.1", 0)
        try:
            ping = await _request(server.port, "GET", "/ping")
            ready = await _request(server.port, "GET", "/ready")
            # concurrent single rows coalesce in the micro-batcher
            # (execute_many); the 3-row request rides alone
            bodies = [
                json.dumps({"data": {"ndarray": b.tolist()}}).encode() for b in batches[:3]
            ] + [json.dumps({"meta": {"puid": "abc"}, "data": {"tensor": {"shape": [3, SEQ], "values": batches[3].ravel().tolist()}}}).encode()]
            preds = await asyncio.gather(
                *(_request(server.port, "POST", "/api/v0.1/predictions", b) for b in bodies)
            )
            bad = await _request(server.port, "POST", "/api/v0.1/predictions", b"{not json")
            missing = await _request(server.port, "GET", "/nope")
        finally:
            await server.stop()
        return ping, ready, preds, bad, missing

    ping, ready, preds, bad, missing = asyncio.run(drive())
    assert ping == (200, b"pong") and ready == (200, b"ready")
    assert missing[0] == 404
    assert bad[0] == 400 and json.loads(bad[1])["code"] == 101
    ref = _jax_probs(np.concatenate(batches))
    got = []
    for (status, body), b in zip(preds, batches):
        assert status == 200
        out = json.loads(body)
        data = out["data"]
        assert data["names"] == ["class_0", "class_1"]
        arr = np.asarray(data["ndarray"]) if "ndarray" in data else np.asarray(data["tensor"]["values"]).reshape(data["tensor"]["shape"])
        assert arr.shape == (len(b), 2)
        got.append(arr)
        assert out["meta"]["puid"]
    assert json.loads(preds[3][1])["meta"]["puid"] == "abc"
    np.testing.assert_allclose(np.concatenate(got), ref, **TOL)
    assert server.batcher.stat_batches < 4  # the single rows did merge


def test_stopped_server_reports_not_ready(tmp_path):
    predictor, _ = load_predictor(str(_deployment(tmp_path)))
    server = PredictorServer(predictor, device="cpu", enable_batching=False)

    async def drive():
        await server.start("127.0.0.1", 0)
        port = server.port
        server.state["paused"] = True
        status = await _request(port, "GET", "/ready")
        await server.stop()
        return status

    assert asyncio.run(drive()) == (503, b"paused")


_SUBPROCESS = r"""
import asyncio, json, sys
import numpy as np
from seldon_core_tpu_torch.core.codec_json import message_from_json, message_to_dict
from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

predictor, name = load_predictor(sys.argv[1])
server = PredictorServer(predictor, deployment_name=name, device="cpu")
ids = np.arange(2 * %d).reshape(2, %d) %% 1024
out = asyncio.run(server.service.predict(message_from_json(json.dumps({"data": {"ndarray": ids.tolist()}}))))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "seldon_core_tpu"))
print(json.dumps({"probs": message_to_dict(out)["data"]["ndarray"], "leaked": leaked}))
""" % (SEQ, SEQ)


def test_port_serves_without_jax_in_a_fresh_interpreter(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS, str(_deployment(tmp_path, "pallas"))],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    ids = np.arange(2 * SEQ).reshape(2, SEQ) % 1024
    np.testing.assert_allclose(np.asarray(out["probs"]), _jax_probs(ids), **TOL)


def test_server_cli_serves_on_cpu(tmp_path):
    # gRPC off (its default port is a fixed number): the REST ingress alone
    env = {**os.environ, "PYTHONPATH": str(REPO), "ENGINE_SERVER_GRPC_PORT": "0"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.serving.server",
         "--deployment", str(_deployment(tmp_path)), "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0", "--warmup"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=tmp_path,
    )
    try:
        line = proc.stdout.readline()
        assert "serving REST :" in line, proc.stderr.read() if proc.poll() is not None else line
        port = int(line.split("serving REST :")[1].split()[0])
        body = json.dumps({"data": {"ndarray": _ids(1, 9).tolist()}}).encode()
        status, payload = asyncio.run(_request(port, "POST", "/api/v0.1/predictions", body))
        assert status == 200
        np.testing.assert_allclose(
            np.asarray(json.loads(payload)["data"]["ndarray"]), _jax_probs(_ids(1, 9)), **TOL
        )
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode == 0


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_module_of_the_port_imports_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        (str(f.relative_to(REPO)), m)
        for f in files
        for m in _imported_modules(f)
        if m.split(".")[0] in ("jax", "jaxlib", "seldon_core_tpu")
    ]
    assert bad == []


def test_warm_pool_threads_runs_one_forward_on_every_pool_thread():
    """On the card, warmup also runs a forward on each compute-pool thread
    (cuDNN and cuBLAS handles are per thread); each thread takes exactly one."""
    import threading

    from seldon_core_tpu_torch.graph.spec import TpuSpec
    from seldon_core_tpu_torch.models import base, zoo

    rt = zoo._runtime_from_modelspec(zoo.get_model("iris_logistic"), TpuSpec(batch_buckets=(1,)), "cpu")
    threads = []
    real = rt.predict
    rt.predict = lambda x: threads.append(threading.current_thread().name) or real(x)
    rt._warm_pool_threads(np.zeros((1, 4), np.float32))
    assert len(threads) == len(set(threads)) == base.COMPUTE_POOL_WORKERS
    assert all(name.startswith("seldon-compute") for name in threads)
