"""The port's control plane (``seldon_core_tpu_torch/operator/``,
``seldon_core_tpu_torch/platform.py``) against the JAX package's, on the CPU:

- every case of ``tests/test_operator.py`` on the port's manager, route
  table and platform (``iris_logistic``, ``mnist_mlp``, ``bert_tiny``);
- lockstep: one sequence of applies, updates, refusals (a latched invalid
  spec, an admission refusal) and deletes through the JAX manager and the
  port's, with equal ReconcileResults, statuses and resident bytes;
- equal spec hashes for every file of ``seldon_core_tpu_torch/deployments/``;
- ``estimate_deployment_bytes`` equal to the JAX package's for iris,
  ``bert_tiny`` and an int8 ``bert_tiny``, and the built bytes beside it;
- the manifests against the JAX package's, less the accelerator fields
  and the image;
- the profiler endpoints' codes over ``torch.profiler``;
- what the card phase checks at full width, at tiny widths: a hot update
  under concurrent traffic (no failure, every answer the old or the new
  version's), a deleted or replaced version's runtime unreachable, router
  state surviving a re-apply through the state store, a generative
  deployment served without a decode scheduler, the CLI, and the platform
  importing with neither ``jax``, ``aiohttp`` nor ``pydantic``.
"""

import asyncio
import base64
import copy
import gc
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest

from seldon_core_tpu.graph.spec import SeldonDeployment as JaxSeldonDeployment
from seldon_core_tpu.operator import DeploymentManager as JaxDeploymentManager
from seldon_core_tpu.operator import create_resources as jax_create_resources
from seldon_core_tpu.operator import reconciler as jax_reconciler
from seldon_core_tpu_torch.core.codec_json import message_from_dict
from seldon_core_tpu_torch.core.message import Feedback
from seldon_core_tpu_torch.graph.spec import SeldonDeployment, to_json
from seldon_core_tpu_torch.operator import DeploymentManager, create_resources, operator_routes
from seldon_core_tpu_torch.operator import reconciler
from seldon_core_tpu_torch.operator.api import BASE
from seldon_core_tpu_torch.serving.fast_http import start_fast_server

ROOT = Path(__file__).resolve().parents[1]
DEPLOYMENTS = ROOT / "seldon_core_tpu_torch" / "deployments"
IRIS_ROW = {"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}


def _cr(name="mydep", model="iris_logistic", replicas=1, oauth_key="k1", tpu=None, params=()):
    graph = {
        "name": "clf",
        "type": "MODEL",
        "implementation": "JAX_MODEL",
        "parameters": [{"name": "model", "value": model, "type": "STRING"}, *params],
    }
    pred = {"name": "p", "replicas": replicas, "graph": graph}
    if tpu is not None:
        pred["tpu"] = tpu
    return {
        "apiVersion": "machinelearning.seldon.io/v1alpha1",
        "kind": "SeldonDeployment",
        "metadata": {"name": name},
        "spec": {"name": name, "oauth_key": oauth_key, "oauth_secret": "s1", "predictors": [pred]},
    }


def _bad(cr):
    cr = copy.deepcopy(cr)
    cr["spec"]["predictors"][0]["graph"] = {"name": "r", "type": "ROUTER", "implementation": "RANDOM_ABTEST"}
    return cr


def _manager(**kw):
    return DeploymentManager(device="cpu", **kw)


async def _http(port, method, path, body=b"", headers=None):
    """One request on its own connection: (status, body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\nContent-Length: {len(body)}\r\n{extra}"
                     f"Connection: close\r\n\r\n".encode() + body)
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), payload


async def _json(port, method, path, obj=None):
    body = b"" if obj is None else json.dumps(obj).encode()
    status, payload = await _http(port, method, path, body, {"Content-Type": "application/json"})
    return status, json.loads(payload) if payload else None


# ------------------------------------------ the JAX package's cases, ported


def test_apply_creates_then_unchanged_then_updates():
    m = _manager()
    assert m.apply(_cr()).action == "created"
    assert m.status("mydep").state == "Available"
    assert m.status("mydep").predictorStatus[0].replicas == 1
    assert m.apply(_cr()).action == "unchanged"
    assert m.apply(_cr(replicas=3)).action == "updated"
    assert m.status("mydep").predictorStatus[0].replicas == 3


def test_failed_latch_until_spec_changes():
    m = _manager()
    r1 = m.apply(_bad(_cr()))
    assert r1.action == "failed" and m.status("mydep").state == "FAILED"
    r2 = m.apply(_bad(_cr()))
    assert r2.action == "failed" and "unchanged" in r2.message
    assert m.apply(_cr()).action == "created"


def test_delete_unregisters():
    from seldon_core_tpu_torch.gateway import DeploymentStore, InProcessBackend, OAuthProvider

    store = DeploymentStore(oauth=OAuthProvider())
    backend = InProcessBackend()
    m = _manager(store=store, backend=backend)
    m.apply(_cr())
    assert store.by_principal("k1") is not None and "mydep" in backend.services
    assert m.delete("mydep").action == "deleted"
    assert store.by_principal("k1") is None and "mydep" not in backend.services
    assert m.delete("mydep").action == "unchanged"


async def test_running_deployment_predicts():
    m = _manager()
    m.apply(_cr())
    out = await m.get("mydep").predict(message_from_dict({"data": {"ndarray": [[1.0, 2.0, 3.0, 4.0]]}}))
    assert out.array.shape == (1, 3)


def test_watch_directory_applies_and_deletes(tmp_path):
    from seldon_core_tpu_torch.operator.reconciler import DirectoryWatcher

    m = _manager()
    d = tmp_path / "crs"
    d.mkdir()
    watcher = DirectoryWatcher(m, str(d))
    (d / "a.json").write_text(json.dumps(_cr("depa")))
    watcher.scan_once()
    assert m.names() == ["depa"]
    (d / "b.json").write_text(json.dumps(_cr("depb", oauth_key="k2")))
    watcher.scan_once()
    assert set(m.names()) == {"depa", "depb"}
    (d / "a.json").unlink()
    watcher.scan_once()
    assert m.names() == ["depb"]


def test_create_resources_manifests():
    dep = SeldonDeployment.from_dict(_cr(tpu={"mesh": {"data": 8}}))
    deploy, svc = create_resources(dep)
    assert deploy["kind"] == "Deployment"
    assert deploy["spec"]["strategy"]["rollingUpdate"]["maxUnavailable"] == "10%"
    container = deploy["spec"]["template"]["spec"]["containers"][0]
    env = {e["name"]: e["value"] for e in container["env"]}
    assert json.loads(base64.b64decode(env["ENGINE_PREDICTOR"]))["graph"]["name"] == "clf"
    pod = deploy["spec"]["template"]["spec"]
    assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    assert container["resources"]["limits"]["nvidia.com/gpu"] == "8"
    assert deploy["spec"]["template"]["metadata"]["annotations"]["prometheus.io/scrape"] == "true"
    assert svc["kind"] == "Service"
    assert {p["port"] for p in svc["spec"]["ports"]} == {8000, 5000}


async def test_platform_end_to_end():
    """Apply through the control API, then predict through the gateway with
    an OAuth token, on one port."""
    from seldon_core_tpu_torch.platform import Platform

    platform = Platform(metrics_enabled=False, device="cpu")
    await platform.serve("127.0.0.1", 0, grpc_port=None)
    port = platform.port
    try:
        status, body = await _json(port, "POST", BASE, _cr("irisdep", oauth_key="gwkey"))
        assert status == 200 and body["action"] == "created", body
        status, body = await _json(port, "GET", BASE)
        assert body["items"][0]["name"] == "irisdep"
        assert body["items"][0]["status"]["state"] == "Available"
        status, tok = await _http(port, "POST", "/oauth/token", b"client_id=gwkey&client_secret=s1",
                                  {"Content-Type": "application/x-www-form-urlencoded"})
        token = json.loads(tok)["access_token"]
        status, payload = await _http(port, "POST", "/api/v0.1/predictions", json.dumps(IRIS_ROW).encode(),
                                      {"Authorization": f"Bearer {token}", "Content-Type": "application/json"})
        assert status == 200, payload
        assert len(json.loads(payload)["data"]["ndarray"][0]) == 3
        status, body = await _json(port, "POST", "/v1/gc-policy")
        assert status == 200 and body["frozen"] > 0
        status, body = await _json(port, "DELETE", BASE + "/irisdep")
        assert body["action"] == "deleted"
        status, _ = await _json(port, "GET", BASE + "/irisdep")
        assert status == 404
        status, body = await _json(port, "DELETE", BASE + "/irisdep")
        assert status == 404 and body["action"] == "unchanged"
        status, body = await _json(port, "POST", BASE, _bad(_cr("broken")))
        assert status == 400 and body["action"] == "failed"
        status, payload = await _http(port, "POST", BASE, b"{not json")
        assert status == 400 and b"invalid JSON" in payload
    finally:
        await platform.stop()


def test_invalid_cr_shape_returns_failed_not_raises():
    m = _manager()
    r = m.apply({"metadata": {"name": "badshape"}, "spec": {"name": "badshape", "predictors": "oops"}})
    assert r.action == "failed" and m.status("badshape").state == "FAILED"


def test_watcher_keeps_deployment_on_torn_read(tmp_path):
    from seldon_core_tpu_torch.operator.reconciler import DirectoryWatcher

    m = _manager()
    watcher = DirectoryWatcher(m, str(tmp_path))
    (tmp_path / "a.json").write_text(json.dumps(_cr("depa")))
    watcher.scan_once()
    assert m.names() == ["depa"]
    (tmp_path / "a.json").write_text('{"apiVersion": "machinelearni')
    watcher.scan_once()
    assert m.names() == ["depa"]
    (tmp_path / "a.json").unlink()
    watcher.scan_once()
    assert m.names() == []


def test_gpu_request_refuses_more_cards_than_a_node():
    from seldon_core_tpu_torch.operator.resources import gpu_request

    assert [gpu_request(n) for n in (1, 2, 6, 8)] == [1, 2, 6, 8]
    with pytest.raises(ValueError, match="one node holds at most 8"):
        gpu_request(9)
    with pytest.raises(ValueError, match="16 cards"):
        create_resources(SeldonDeployment.from_dict(_cr(tpu={"mesh": {"data": 4, "model": 4}})))


def test_failed_update_keeps_running_version_available():
    m = _manager()
    m.apply(_cr())
    r = m.apply(_bad(_cr()))
    assert r.action == "failed"
    st = m.status("mydep")
    assert st.state == "Available" and "update rejected" in st.description
    assert m.get("mydep") is not None
    assert m.apply(_cr()).action == "unchanged"
    assert m.status("mydep").description == ""


def test_single_card_mesh_still_requests_a_gpu():
    deploy = create_resources(SeldonDeployment.from_dict(_cr(tpu={"mesh": {"data": 1}})))[0]
    pod = deploy["spec"]["template"]["spec"]
    assert pod["nodeSelector"]["cloud.google.com/gke-accelerator"] == "nvidia-h100-80gb"
    assert pod["containers"][0]["resources"]["limits"]["nvidia.com/gpu"] == "1"


def test_hbm_budget_admission_control():
    probe = _manager()
    probe.apply(_cr("probe"))
    one = probe.hbm_usage()["deployments"]["probe"]
    assert one > 0
    m = _manager(hbm_budget_bytes=int(one * 1.5))
    assert m.apply(_cr("first", oauth_key="kA")).action == "created"
    r = m.apply(_cr("second", oauth_key="kB"))
    assert r.action == "failed" and "insufficient HBM" in r.message
    assert m.status("second").state == "FAILED"
    assert m.names() == ["first"]
    m.delete("first")
    assert m.apply(_cr("second", oauth_key="kB")).action == "created"
    usage = m.hbm_usage()
    assert usage["total"] == usage["deployments"]["second"] and usage["budget"] == int(one * 1.5)


def test_hbm_rejected_update_keeps_serving():
    probe = _manager()
    probe.apply(_cr("p0"))
    one = probe.hbm_usage()["deployments"]["p0"]
    m = _manager(hbm_budget_bytes=int(one * 1.5))
    m.apply(_cr("dep"))
    r = m.apply(_cr("dep", model="mnist_mlp"))
    assert r.action == "failed" and "insufficient HBM" in r.message
    st = m.status("dep")
    assert st.state == "Available" and "update rejected" in st.description
    assert m.get("dep") is not None


def test_concurrent_apply_delete_stress():
    import concurrent.futures

    m = _manager()

    def worker(i):
        name = f"dep{i % 4}"
        assert m.apply(_cr(name, oauth_key=f"k{i % 4}")).action in ("created", "updated", "unchanged")
        if i % 3 == 0:
            m.delete(name)
        return True

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        assert all(pool.map(worker, range(32)))
    for name in m.names():
        assert m.status(name) is not None and name in m.hbm_usage()["deployments"]


async def test_platform_applied_cr_serves_on_one_card_and_ticks_feedback():
    """A CR with an 8-device data mesh is held to the one device the
    manager serves (the mesh rule shrinks the data axis), its runtimes live
    on that device, and feedback ticks the model feedback counters as the
    standalone server's does."""
    from seldon_core_tpu_torch.metrics.registry import Metrics

    metrics = Metrics()
    m = _manager(metrics=metrics)
    cr = _cr(tpu={"mesh": {"data": 8}})
    cr["spec"]["predictors"][0]["graph"] = {
        "name": "ab",
        "type": "ROUTER",
        "implementation": "RANDOM_ABTEST",
        "parameters": [{"name": "ratioA", "value": "0.5", "type": "FLOAT"}],
        "children": [{"name": f"clf{i}", "type": "MODEL", "implementation": "JAX_MODEL",
                      "parameters": [{"name": "model", "value": "iris_logistic", "type": "STRING"}]}
                     for i in range(2)],
    }
    assert m.apply(cr).action == "created"
    running = m.get("mydep")
    runtimes = running.runtimes()
    assert len(runtimes) == 2
    for rt in runtimes:
        assert rt.device.type == "cpu"
        assert all(t.device.type == "cpu" for t in reconciler._leaves(rt.params))
    req = message_from_dict({"data": {"ndarray": [[1.0, 2.0, 3.0, 4.0]]}})
    resp = await running.predict(req)
    assert resp.array.shape == (1, 3)
    await running.send_feedback(Feedback(request=req, response=resp, reward=1.0))
    exported = metrics.export().decode()
    assert "seldon_api_model_feedback_total{" in exported and 'model_name="ab"' in exported
    with pytest.raises(ValueError, match="needs 8 devices"):
        m._default_service_factory(SeldonDeployment.from_dict(_cr(tpu={"mesh": {"data": 2, "model": 4}})),
                                   SeldonDeployment.from_dict(_cr(tpu={"mesh": {"data": 2, "model": 4}}))
                                   .spec.predictors[0])


async def test_profiler_admin_endpoints(tmp_path):
    """start/stop over torch.profiler: a double start and a stop without a
    start are 409s, a bad duration 400, the auto-stop writes the trace, and
    a failed stop keeps the state so it can be retried."""
    import torch

    server = await start_fast_server(operator_routes(_manager()), "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    try:
        out_dir = str(tmp_path / "prof")
        status, body = await _json(port, "POST", f"/profiler/start?dir={out_dir}")
        assert status == 200 and body["tracing"] == out_dir
        assert (await _json(port, "POST", "/profiler/start"))[0] == 409
        torch.ones(64, 64) @ torch.ones(64, 64)  # something to trace
        status, body = await _json(port, "POST", "/profiler/stop")
        assert status == 200 and body["written"] == out_dir
        assert json.loads(Path(body["trace"]).read_text())["traceEvents"]
        assert (await _json(port, "POST", "/profiler/stop"))[0] == 409
        assert (await _json(port, "POST", "/profiler/start?duration_ms=abc"))[0] == 400

        auto = str(tmp_path / "auto")
        status, body = await _json(port, "POST", f"/profiler/start?dir={auto}&duration_ms=50")
        assert status == 200 and body["auto_stop_ms"] == 50.0
        for _ in range(200):
            await asyncio.sleep(0.02)
            if (Path(auto) / "trace.json").exists() and (await _json(port, "POST", "/profiler/stop"))[0] == 409:
                break
        assert (Path(auto) / "trace.json").exists()
        assert (await _json(port, "POST", "/profiler/stop"))[0] == 409

        failing = str(tmp_path / "failing")
        assert (await _json(port, "POST", f"/profiler/start?dir={failing}"))[0] == 200
        real = torch.profiler.profile.export_chrome_trace
        calls = []

        def flaky(self, path):
            calls.append(path)
            if len(calls) == 1:
                raise OSError("disk full")
            return real(self, path)

        torch.profiler.profile.export_chrome_trace = flaky
        try:
            status, body = await _json(port, "POST", "/profiler/stop")
            assert status == 500 and "disk full" in body["error"]
            status, body = await _json(port, "POST", "/profiler/stop")  # retried
            assert status == 200 and body["written"] == failing
        finally:
            torch.profiler.profile.export_chrome_trace = real
    finally:
        server.close()
        await server.wait_closed()


# --------------------------------------------- the port against the JAX one


def _deployment_files():
    return sorted(DEPLOYMENTS.glob("*.json"))


@pytest.mark.parametrize("path", _deployment_files(), ids=lambda p: p.stem)
def test_spec_hash_equals_the_jax_hash(path):
    obj = json.loads(path.read_text())
    mine = reconciler._spec_hash(SeldonDeployment.from_dict(obj))
    assert mine == jax_reconciler._spec_hash(JaxSeldonDeployment.from_dict(obj))


def test_spec_hash_tells_apart_keys_the_port_refuses():
    # the JAX package drops an unknown tpu key; the port keeps (and refuses)
    # it, so a CR that differs only there must not look unchanged
    plain = _cr(tpu={"max_batch": 4})
    odd = _cr(tpu={"max_batch": 4, "decode_beam": 2})
    assert reconciler._spec_hash(SeldonDeployment.from_dict(plain)) != reconciler._spec_hash(
        SeldonDeployment.from_dict(odd))


ESTIMATES = {
    "iris": _cr(model="iris_logistic"),
    "bert_tiny": _cr(model="bert_tiny"),
    "bert_tiny_bf16": _cr(model="bert_tiny", tpu={"dtype": "bfloat16"}),
    "bert_tiny_int8": _cr(model="bert_tiny", tpu={"dtype": "bfloat16", "weight_quant": "int8"}),
    "mnist_uri": _cr(params=({"name": "model_uri", "value": "zoo://mnist_mlp?hidden=64", "type": "STRING"},)),
}


@pytest.mark.parametrize("name", sorted(ESTIMATES))
def test_estimate_and_built_bytes_against_jax(name):
    """The host estimate equals the JAX package's byte for byte. The built
    bytes equal the estimate for float32 and bfloat16; for int8 the port
    also keeps the quantization scheme's leaves the estimate counts, so all
    three agree (a difference would be named here, leaf by leaf)."""
    cr = ESTIMATES[name]
    mine = reconciler.estimate_deployment_bytes(SeldonDeployment.from_dict(cr))
    theirs = jax_reconciler.estimate_deployment_bytes(JaxSeldonDeployment.from_dict(cr))
    assert mine == theirs > 0
    m = _manager()
    assert m.apply(cr).action == "created"
    built = m.hbm_usage()["deployments"]["mydep"]
    jm = JaxDeploymentManager()
    assert jm.apply(cr).action == "created"
    jax_built = jm.hbm_usage()["deployments"]["mydep"]
    if built != jax_built or built != mine:
        runtime = m.get("mydep").runtimes()[0]
        leaves = {k: v for k, v in runtime.params.items()} if isinstance(runtime.params, dict) else {}
        pytest.fail(f"{name}: built {built} B, JAX built {jax_built} B, estimate {mine} B; "
                    f"top-level leaves {sorted(leaves)}")


def _strip_accelerator(manifests: list) -> list:
    out = copy.deepcopy(manifests)
    for m in out:
        if m["kind"] != "Deployment":
            continue
        pod = m["spec"]["template"]["spec"]
        pod.pop("nodeSelector", None)
        container = pod["containers"][0]
        container.pop("image")
        container["resources"].pop("limits", None)
        for e in container["env"]:
            if e["name"] == "ENGINE_PREDICTOR":
                e["value"] = json.loads(base64.b64decode(e["value"]))
    return out


@pytest.mark.parametrize("path", ["iris", "iris_abtest", "bert_base_flash", "full_dag_bert", "gpt2_small_replicated"])
def test_manifests_equal_jax_less_accelerator_fields(path):
    obj = json.loads((DEPLOYMENTS / f"{path}.json").read_text())
    obj["spec"]["predictors"][0].setdefault("tpu", {})["mesh"] = {"data": 4}
    mine = _strip_accelerator(create_resources(SeldonDeployment.from_dict(obj)))
    theirs = _strip_accelerator(jax_create_resources(JaxSeldonDeployment.from_dict(obj)))
    assert mine == theirs
    limits = create_resources(SeldonDeployment.from_dict(obj))[0]["spec"]["template"]["spec"]["containers"][0]
    assert limits["resources"]["limits"] == {"nvidia.com/gpu": "4"}


def _jax_status(st):
    return None if st is None else st.model_dump(mode="json")


def _status(st):
    return None if st is None else to_json(st)


def test_lockstep_with_the_jax_manager():
    """One sequence through both managers: creates, an unchanged re-apply,
    an update, a latched invalid spec and its repair, an admission refusal
    and the same spec after a delete, a schema failure, deletes."""
    one = None
    probe = _manager()
    probe.apply(_cr("probe"))
    one = probe.hbm_usage()["deployments"]["probe"]
    budget = int(one * 2.5)
    mine, theirs = _manager(hbm_budget_bytes=budget), JaxDeploymentManager(hbm_budget_bytes=budget)
    steps = [
        ("apply", _cr("a", oauth_key="ka")),
        ("apply", _cr("a", oauth_key="ka")),
        ("apply", _cr("a", oauth_key="ka", replicas=2)),
        ("apply", _cr("b", oauth_key="kb")),
        ("apply", _cr("c", oauth_key="kc")),  # over the budget
        ("apply", _bad(_cr("a", oauth_key="ka"))),
        ("apply", _bad(_cr("a", oauth_key="ka"))),  # latched
        ("apply", _cr("a", oauth_key="ka", replicas=2)),  # unchanged, status repaired
        ("delete", "b"),
        ("apply", _cr("c", oauth_key="kc")),  # fits now
        ("apply", {"metadata": {"name": "shape"}, "spec": {"name": "shape", "predictors": "oops"}}),
        ("apply", {"metadata": {}, "spec": {}}),
        ("delete", "nope"),
        ("delete", "a"),
    ]
    for i, (op, arg) in enumerate(steps):
        r_mine = mine.apply(arg) if op == "apply" else mine.delete(arg)
        r_theirs = theirs.apply(arg) if op == "apply" else theirs.delete(arg)
        assert (r_mine.name, r_mine.action) == (r_theirs.name, r_theirs.action), i
        if r_mine.action == "failed" and "insufficient HBM" in r_theirs.message:
            assert r_mine.message == r_theirs.message, i
        for name in ("a", "b", "c", "shape"):
            st_mine, st_theirs = _status(mine.status(name)), _jax_status(theirs.status(name))
            if name == "shape" and st_theirs is not None:
                # a CR that fails to parse is described by each package's
                # own parser (pydantic's text there)
                st_mine.pop("description"), st_theirs.pop("description")
            assert st_mine == st_theirs, (i, name)
        assert mine.names() == theirs.names(), i
        assert mine.hbm_usage() == theirs.hbm_usage(), i


# ------------------------------------------- what the card phase checks, tiny


def _bert_cr(name, seed, oauth_key):
    return _cr(name, oauth_key=oauth_key,
               params=({"name": "model_uri", "value": f"zoo://bert_tiny?seq=16&seed={seed}", "type": "STRING"},),
               tpu={"max_batch": 8, "batch_buckets": [1, 8]})


async def test_hot_update_under_traffic_answers_old_or_new_and_frees_the_old():
    """16 concurrent users on one deployment while it is re-applied with
    another seed off the loop: no request fails, every answer is the old
    version's or the new one's, every answer after apply returns the new
    one's, a sibling's answers do not move, and the old version's runtime
    becomes unreachable once drained."""
    from seldon_core_tpu_torch.gateway import InProcessBackend

    backend = InProcessBackend()
    m = _manager(backend=backend)
    assert m.apply(_bert_cr("bert", 0, "kb")).action == "created"
    assert m.apply(_cr("iris", oauth_key="ki")).action == "created"
    ids = np.random.default_rng(0).integers(0, 1024, size=(16, 16)).astype(np.float32)

    async def ask(name, row):
        dep = SeldonDeployment.from_dict(_cr(name)).spec
        out = await backend.predict(dep, message_from_dict({"data": {"ndarray": [row]}}))
        return np.asarray(out.array)[0]

    old = [await ask("bert", ids[i].tolist()) for i in range(16)]
    iris_before = await ask("iris", IRIS_ROW["data"]["ndarray"][0])
    old_runtime = weakref.ref(m.get("bert").runtimes()[0])
    applied = asyncio.Event()
    answers, after, failures = [], [], []

    async def user(u):
        while not applied.is_set() or len(after) < 32:
            seen = applied.is_set()
            try:
                got = await ask("bert", ids[u].tolist())
            except Exception as e:  # noqa: BLE001 - counted
                failures.append(repr(e))
                continue
            answers.append((u, got))
            if seen:
                after.append((u, got))

    users = [asyncio.ensure_future(user(u)) for u in range(16)]
    await asyncio.sleep(0.05)
    result = await asyncio.get_running_loop().run_in_executor(None, m.apply, _bert_cr("bert", 1, "kb"))
    assert result.action == "updated"
    applied.set()
    await asyncio.gather(*users)
    new = [await ask("bert", ids[i].tolist()) for i in range(16)]
    assert not failures, failures[:3]
    assert any(not np.array_equal(old[i], new[i]) for i in range(16))
    for u, got in answers:
        assert np.array_equal(got, old[u]) or np.array_equal(got, new[u])
    for u, got in after:
        assert np.array_equal(got, new[u])
    np.testing.assert_array_equal(await ask("iris", IRIS_ROW["data"]["ndarray"][0]), iris_before)
    for _ in range(50):
        await asyncio.sleep(0.01)
        gc.collect()
        if old_runtime() is None:
            break
    assert old_runtime() is None, gc.get_referrers(old_runtime())[:3]


def test_deleted_deployment_is_unreachable():
    m = _manager()
    m.apply(_bert_cr("bert", 0, "kb"))
    running = m.get("bert")
    running.warmup()
    refs = [weakref.ref(running), weakref.ref(running.runtimes()[0]), weakref.ref(running.runtimes()[0].graphs)]
    del running
    assert m.delete("bert").action == "deleted"
    gc.collect()
    assert [r() is None for r in refs] == [True, True, True]


def _bandit_cr(replicas=1):
    cr = _cr("bandit", replicas=replicas)
    cr["spec"]["predictors"][0]["graph"] = {
        "name": "eg",
        "type": "ROUTER",
        "implementation": "EPSILON_GREEDY",
        "parameters": [{"name": "epsilon", "value": "0.1", "type": "FLOAT"},
                       {"name": "seed", "value": "7", "type": "INT"}],
        "children": [{"name": f"clf{i}", "type": "MODEL", "implementation": "JAX_MODEL",
                      "parameters": [{"name": "model", "value": "iris_logistic", "type": "STRING"}]}
                     for i in range(2)],
    }
    return cr


async def test_router_state_survives_reapply_through_the_store(tmp_path):
    """An epsilon-greedy router with a file state store: its learned arms
    are flushed by the old version and restored into the new one."""
    m = _manager(state_store_url=f"file://{tmp_path}")
    assert m.apply(_bandit_cr()).action == "created"
    running = m.get("bandit")
    root = running.services["p"].executor.root.unit
    req = message_from_dict(IRIS_ROW)
    for reward in (1.0, 0.0, 1.0):
        resp = await running.predict(req)
        await running.send_feedback(Feedback(request=req, response=resp, reward=reward))
    arms = (list(root.counts), list(root.rewards))
    assert sum(arms[0]) == 3
    assert m.apply(_bandit_cr(replicas=2)).action == "updated"
    restored = m.get("bandit").services["p"].executor.root.unit
    assert restored is not root
    assert (restored.counts, restored.rewards) == arms
    assert os.listdir(tmp_path)


async def test_generative_deployment_serves_fused_generate_without_a_scheduler():
    obj = json.loads((DEPLOYMENTS / "tiny_gpt.json").read_text())
    m = _manager()
    assert m.apply(obj).action == "created"
    svc = next(iter(m.get(obj["metadata"]["name"]).services.values()))
    assert svc.decode_scheduler is None
    runtime = m.get(obj["metadata"]["name"]).runtimes()[0]
    seq = runtime.generative["seq"]
    out = await m.get(obj["metadata"]["name"]).predict(message_from_dict({"data": {"ndarray": [list(range(seq))]}}))
    assert np.asarray(out.array).shape[0] == 1


def test_platform_imports_without_jax_aiohttp_or_pydantic():
    code = (
        "import sys\n"
        "for m in ('jax', 'aiohttp', 'pydantic', 'seldon_core_tpu'): sys.modules[m] = None\n"
        "import seldon_core_tpu_torch.platform, seldon_core_tpu_torch.operator, seldon_core_tpu_torch.native\n"
        "from seldon_core_tpu_torch.operator import k8s_watcher, k8s_http, resources\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(ROOT), timeout=120)
    assert out.stdout.strip() == "ok", out.stderr[-2000:]


def test_platform_cli_on_the_cpu_and_refusing_a_missing_card(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    args = [sys.executable, "-m", "seldon_core_tpu_torch.platform", "--host", "127.0.0.1", "--port", "0",
            "--no-grpc", "--apply", str(DEPLOYMENTS / "iris.json")]
    import torch

    if not torch.cuda.is_available():
        bad = subprocess.run(args, capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=120)
        assert bad.returncode != 0 and "torch.cuda.is_available() is false" in bad.stderr
    proc = subprocess.Popen(args + ["--device", "cpu", "--fast-ingress", "--admin-port", "0"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path))
    try:
        line = proc.stdout.readline()
        assert "platform serving REST :" in line and "admin :" in line and "on cpu" in line, proc.stderr.read()
    finally:
        proc.terminate()
        proc.wait(timeout=60)


def test_watch_flags_are_mutually_exclusive():
    from seldon_core_tpu_torch import platform

    with pytest.raises(SystemExit):
        platform.main(["--watch-dir", "x", "--watch-k8s", "--device", "cpu"])


async def test_a_frozen_version_is_collected_after_update_and_delete(monkeypatch):
    """The serving GC policy freezes what is alive (a server's start, the
    platform's boot, POST /v1/gc-policy); a version frozen so and then
    replaced or deleted must still be collected, or its tensors stay on the
    card for good; once it has gone the heap is frozen again."""
    from seldon_core_tpu_torch.gateway import InProcessBackend
    from seldon_core_tpu_torch.serving import gc_policy
    from seldon_core_tpu_torch.serving.gc_policy import apply_serving_gc_policy

    monkeypatch.setattr(gc_policy, "_applied", gc_policy._applied)  # restored after the test
    backend = InProcessBackend()
    m = _manager(backend=backend)
    m.apply(_bert_cr("bert", 0, "kb"))
    dep = SeldonDeployment.from_dict(_cr("bert")).spec
    await backend.predict(dep, message_from_dict({"data": {"ndarray": [list(range(16))]}}))
    old = weakref.ref(m.get("bert").runtimes()[0])
    apply_serving_gc_policy()
    try:
        result = await asyncio.get_running_loop().run_in_executor(None, m.apply, _bert_cr("bert", 1, "kb"))
        assert result.action == "updated"
        await backend.predict(dep, message_from_dict({"data": {"ndarray": [list(range(16))]}}))
        newer = weakref.ref(m.get("bert").runtimes()[0])
        for _ in range(100):
            await asyncio.sleep(0.01)
            if old() is None and m.release.stat_refreezes:
                break
        assert old() is None
        # the heap is frozen again once the old version has gone, the new
        # one with it: the delete below must thaw it
        assert m.release.stat_refreezes == 1
        assert m.delete("bert").action == "deleted"
        for _ in range(100):
            await asyncio.sleep(0.01)
            if newer() is None and m.release.stat_refreezes == 2:
                break
        assert newer() is None
        assert m.release.stat_refreezes == 2
    finally:
        gc.unfreeze()


async def test_a_version_held_past_its_drain_is_collected_by_a_later_settle(monkeypatch):
    """A dropped version still held when its drain ends (a request not yet
    resumed) is looked at again later: the heap stays thawed until it has
    gone, then is frozen again; where the serving GC policy was never
    applied, nothing is frozen."""
    from seldon_core_tpu_torch.operator.reconciler import _Release
    from seldon_core_tpu_torch.serving import gc_policy

    class Version:  # a RunningDeployment's shape: no services, no runtimes
        services: dict = {}

        def runtimes(self):
            return []

    freezes = []
    monkeypatch.setattr(gc, "freeze", lambda: freezes.append(1))
    monkeypatch.setattr(gc_policy, "_applied", True)
    release = _Release()
    release.SETTLE_DELAY_S = 0.01
    v = Version()
    v.cycle = v  # only the cycle collector frees it
    settle = release.drop(v)
    held, v = v, None
    settle()  # still held: nothing frozen, a retry scheduled
    assert release.stat_refreezes == 0 and not freezes
    gone = weakref.ref(held)
    held = None
    for _ in range(100):
        await asyncio.sleep(0.01)
        if release.stat_refreezes:
            break
    assert gone() is None and release.stat_refreezes == 1 and freezes == [1]
    monkeypatch.setattr(gc_policy, "_applied", False)
    unfrozen = _Release()
    unfrozen.drop(Version())()
    assert unfrozen.stat_refreezes == 0 and freezes == [1]


def test_a_collected_graph_cache_hands_its_capture_stream_on(monkeypatch):
    """cuBLAS keeps a workspace per (handle, stream) for the process: a
    deployment applied after another was deleted captures on the deleted
    one's stream, so applies and deletes do not grow the card's memory;
    a live cache's stream stays its own."""
    import torch

    from seldon_core_tpu_torch.ops import graphs

    made = []

    class _Stream:
        def __init__(self, device=None):
            made.append(self)

    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(graphs, "_FREE_STREAMS", {})
    cuda = torch.device("cuda")
    first = graphs.GraphCache(cuda)
    second = graphs.GraphCache(cuda)
    assert first.stream is not second.stream and len(made) == 2
    kept = first.stream
    del first
    gc.collect()
    third = graphs.GraphCache(cuda)
    assert third.stream is kept and len(made) == 2
    assert graphs.GraphCache(cuda).stream is not third.stream and len(made) == 3
    assert second.stream is not third.stream
