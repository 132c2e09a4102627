"""The three mesh deployments served by both packages.

``moe.json`` ({"data": 2, "expert": 4}), ``pipeline_tower.json`` ({"pipe":
4}) and a ``bert_tiny`` copy of ``bert_seq_parallel.json`` ({"data": 2,
"seq": 4}, Ulysses; float32 and 256 wide, so its 4 heads divide the seq
axis and the comparison holds at the JAX tests' float32 tolerance) are
served by the JAX ``PredictorServer`` over its 8 virtual CPU devices and by
the port's ``PredictorServer(device="cpu", mesh_devices=[cpu] * 8)``.
``moe_mlp`` and ``pipe_mlp`` draw their dense layers with ``jax.random`` in
the JAX package, so the port serves the JAX build's parameters, carried
across by ``models/convert.py::carry_params``; BERT's are the same numpy
draws in both. Answers agree at rtol 2e-5 / atol 2e-6 (MoE and the
pipeline, ``tests/test_parallel.py``) and 2e-4 / 2e-5 (BERT,
``tests/test_models_heavy.py``). The port's platform serves ``moe.json``
and a {"pipe": 4} CR as JAX's ``test_moe_example_deployment_serves_through_platform``
and ``test_pipe_mesh_serves_through_platform_cr`` do, and without positions
asked for the three files are refused by the mesh rule on one device.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from seldon_core_tpu.core.codec_json import message_from_dict as jax_message_from_dict
from seldon_core_tpu.graph.spec import SeldonDeployment as JaxSeldonDeployment
from seldon_core_tpu.models.zoo import get_model as jax_get_model
from seldon_core_tpu.serving.server import PredictorServer as JaxPredictorServer
from seldon_core_tpu_torch.core.codec_json import message_from_dict
from seldon_core_tpu_torch.graph.defaulting import default_deployment
from seldon_core_tpu_torch.graph.spec import SeldonDeployment
from seldon_core_tpu_torch.models import zoo
from seldon_core_tpu_torch.models.convert import carry_params
from seldon_core_tpu_torch.operator.reconciler import DeploymentManager
from seldon_core_tpu_torch.serving.server import PredictorServer

CPU = torch.device("cpu")
DEPLOYMENTS = "seldon_core_tpu_torch/deployments"


def _load(name: str) -> dict:
    with open(f"{DEPLOYMENTS}/{name}.json") as f:
        return json.load(f)


def _bert_tiny_copy() -> dict:
    dep = _load("bert_seq_parallel")
    pred = dep["spec"]["predictors"][0]
    pred["graph"]["parameters"] = [
        {"name": "model", "value": "bert_tiny", "type": "STRING"},
        {"name": "seq_parallel", "value": "ulysses", "type": "STRING"},
        {"name": "hidden", "value": "256", "type": "INT"},
        {"name": "ffn", "value": "512", "type": "INT"},
    ]
    pred["tpu"]["dtype"] = "float32"
    return dep


def _jax_params(model: str, params: dict):
    kwargs = {p["name"]: int(p["value"]) for p in params if p["type"] == "INT"}
    return jax.tree.map(np.asarray, jax_get_model(model, **kwargs).params)


@pytest.fixture
def carried(monkeypatch):
    """The port's zoo builds moe_mlp and pipe_mlp with the JAX build's
    parameters (same kwargs), checked leaf for leaf."""
    def carry(model):
        build = zoo._REGISTRY[model]

        def built(**kwargs):
            spec = build(**kwargs)
            jms = jax_get_model(model, **{k: v for k, v in kwargs.items() if isinstance(v, int)})
            return dataclasses.replace(spec, params=carry_params(spec.params, jax.tree.map(np.asarray, jms.params)))

        monkeypatch.setitem(zoo._REGISTRY, model, built)

    for model in ("moe_mlp", "pipe_mlp"):
        carry(model)


def _predictors(dep: dict):
    jax_pred = JaxSeldonDeployment.model_validate(copy.deepcopy(dep)).spec.predictors[0]
    pred = default_deployment(SeldonDeployment.from_dict(copy.deepcopy(dep)), n_devices=1).spec.predictors[0]
    return jax_pred, pred


CASES = {
    "moe": (lambda: _load("moe"), 16, "float", (2e-5, 2e-6), {"data": 2, "expert": 4}),
    "pipeline_tower": (lambda: _load("pipeline_tower"), 16, "float", (2e-5, 2e-6), {"pipe": 4}),
    "bert_tiny_seq_parallel": (_bert_tiny_copy, 16, "ids", (2e-4, 2e-5), {"data": 2, "seq": 4}),
}


@pytest.mark.parametrize("name", sorted(CASES))
async def test_mesh_deployment_served_like_jax(name, carried):
    """Each file served by both packages' servers over 8 positions: the same
    answers for a full bucket and a padded one, the mesh as the file says,
    and no new capture key after warmup."""
    make, width, kind, (rtol, atol), axes = CASES[name]
    dep = make()
    jax_pred, pred = _predictors(dep)
    jax_srv = JaxPredictorServer(jax_pred, deployment_name=dep["spec"]["name"], enable_batching=False)
    srv = PredictorServer(pred, deployment_name=dep["spec"]["name"], enable_batching=False, device="cpu",
                          mesh_devices=[CPU] * 8)
    srv.warmup()
    runtime = srv.executor.root.unit.runtime
    assert runtime.mesh.shape == axes == dict(jax_srv.mesh.shape)
    assert runtime.mesh.n_devices == 1 and srv.service.mesh_attrs["mesh_positions"] == runtime.mesh.size
    assert srv.service.mesh_attrs["mesh_eager"] is False
    rng = np.random.default_rng(7)
    for rows in (8, 5):
        x = rng.integers(0, 1024, (rows, width)) if kind == "ids" else rng.standard_normal((rows, width))
        body = {"data": {"ndarray": x.tolist()}}
        want = np.asarray((await jax_srv.executor.execute(jax_message_from_dict(body))).array)
        got = np.asarray((await srv.executor.execute(message_from_dict(body))).array)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert runtime.recompiles_since_warmup() == 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_deployment_without_positions_is_refused(name):
    """On one device, with no positions asked for, the mesh rule refuses
    each file: no path serves a sharded deployment unsharded."""
    _, pred = _predictors(CASES[name][0]())
    with pytest.raises(ValueError, match="needs [48] devices, have 1"):
        PredictorServer(pred, device="cpu")


async def test_moe_example_deployment_serves_through_platform(carried):
    """moe.json through the port's control plane over 8 positions."""
    m = DeploymentManager(device="cpu", mesh_devices=[CPU] * 8)
    r = m.apply(_load("moe"))
    assert r.action == "created", r.message
    try:
        out = await m.get("moe-classifier").predict(message_from_dict({"data": {"ndarray": [[0.5] * 16]}}))
        probs = np.asarray(out.array)
        assert probs.shape == (1, 3)
        np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
        svc = next(iter(m.get("moe-classifier").services.values()))
        rt = next(u.runtime for u in svc.executor.units() if getattr(u, "runtime", None))
        assert rt.mesh is not None and rt.mesh.size == 8
        assert rt.mesh.shape == {"data": 2, "expert": 4}
        # expert slabs and shared replicas: the same bytes as one copy
        assert m.hbm_usage()["deployments"]["moe-classifier"] == rt.param_bytes() == sum(
            np.asarray(a).nbytes for a in jax.tree.leaves(_jax_params("moe_mlp", _load("moe")["spec"]["predictors"][0]
                                                                      ["graph"]["parameters"])))
    finally:
        m.delete("moe-classifier")


async def test_pipe_mesh_serves_through_platform_cr(carried):
    cr = {
        "apiVersion": "machinelearning.seldon.io/v1alpha1",
        "kind": "SeldonDeployment",
        "metadata": {"name": "pipedep"},
        "spec": {
            "name": "pipedep",
            "predictors": [{
                "name": "p",
                "tpu": {"mesh": {"pipe": 4}, "batch_buckets": [8], "max_batch": 8},
                "graph": {"name": "tower", "type": "MODEL", "implementation": "JAX_MODEL",
                          "parameters": [{"name": "model", "value": "pipe_mlp", "type": "STRING"}]},
            }],
        },
    }
    m = DeploymentManager(device="cpu", mesh_devices=[CPU] * 4)
    assert m.apply(cr).action == "created"
    try:
        out = await m.get("pipedep").predict(message_from_dict({"data": {"ndarray": np.ones((8, 16)).tolist()}}))
        arr = np.asarray(out.array)
        assert arr.shape == (8, 3)
        np.testing.assert_allclose(arr.sum(axis=1), 1.0, rtol=1e-5)
        svc = next(iter(m.get("pipedep").services.values()))
        rt = next(u.runtime for u in svc.executor.units() if getattr(u, "runtime", None))
        assert [tuple(pp["stages"]["w"].shape) for pp in rt.params] == [(1, 64, 64)] * 4
    finally:
        m.delete("pipedep")
    refused = DeploymentManager(device="cpu")
    r = refused.apply(cr)
    assert r.action == "failed" and "needs 4 devices, have 1" in r.message


async def test_a_fused_island_on_a_mesh_serves_like_its_members():
    """A COMBINER over two moe_mlp members on {"data": 2, "expert": 4}
    fuses into one runtime on the members' mesh; its answer is the mean of
    the members served alone."""
    dep = copy.deepcopy(_load("moe"))
    pred = dep["spec"]["predictors"][0]
    members = [{"name": f"m{i}", "type": "MODEL", "implementation": "JAX_MODEL",
                "parameters": [{"name": "model", "value": "moe_mlp", "type": "STRING"},
                               {"name": "seed", "value": str(i), "type": "INT"}]} for i in range(2)]
    pred["graph"] = {"name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER", "children": members}
    _, fused_pred = _predictors(dep)
    srv = PredictorServer(fused_pred, enable_batching=False, device="cpu", mesh_devices=[CPU] * 8)
    runtime = srv.executor.root.unit.runtime
    assert runtime.mesh.shape == {"data": 2, "expert": 4} and len(runtime.params) == 8
    x = np.random.default_rng(3).standard_normal((4, 16))
    got = np.asarray((await srv.executor.execute(message_from_dict({"data": {"ndarray": x.tolist()}}))).array)
    alone = []
    for m in members:
        solo = copy.deepcopy(dep)
        solo["spec"]["predictors"][0]["graph"] = m
        s = PredictorServer(_predictors(solo)[1], enable_batching=False, device="cpu", mesh_devices=[CPU] * 8)
        alone.append(np.asarray((await s.executor.execute(message_from_dict({"data": {"ndarray": x.tolist()}}))).array))
    np.testing.assert_allclose(got, np.mean(alone, axis=0), rtol=1e-6, atol=1e-7)



def _island(shape: str) -> dict:
    """moe.json with its graph replaced by a COMBINER over two moe_mlp
    members, alone or under a MEAN_TRANSFORMER's input or output centring,
    or both (JAX's ``tests/test_fused.py::_full_dag_predictor`` shape)."""
    dep = copy.deepcopy(_load("moe"))
    members = [{"name": f"m{i}", "type": "MODEL", "implementation": "JAX_MODEL",
                "parameters": [{"name": "model", "value": "moe_mlp", "type": "STRING"},
                               {"name": "seed", "value": str(i), "type": "INT"}]} for i in range(2)]
    graph = {"name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER", "children": members}
    if shape in ("output", "both"):
        graph = {"name": "shift-out", "type": "OUTPUT_TRANSFORMER", "implementation": "MEAN_TRANSFORMER",
                 "parameters": [{"name": "means", "value": "-0.25", "type": "STRING"}], "children": [graph]}
    if shape in ("input", "both"):
        graph = {"name": "center-in", "type": "TRANSFORMER", "implementation": "MEAN_TRANSFORMER",
                 "parameters": [{"name": "means", "value": "1.0", "type": "STRING"}], "children": [graph]}
    dep["spec"]["predictors"][0]["graph"] = graph
    return dep


@pytest.mark.parametrize("shape", ["combiner", "input", "output", "both"])
async def test_a_fused_island_on_a_mesh_serves_like_jax(shape, carried):
    """The island, transforms included, fuses into one runtime on the
    members' {"data": 2, "expert": 4} mesh in both packages, and the port's
    answer is the JAX ``PredictorServer``'s over its 8 virtual devices, at
    the MoE tolerance (rtol 2e-5 / atol 2e-6), for a full bucket and a
    padded one."""
    from seldon_core_tpu.engine.fused import FusedUnit as JaxFusedUnit
    from seldon_core_tpu_torch.engine.fused import FusedUnit

    dep = _island(shape)
    jax_pred, pred = _predictors(dep)
    jax_srv = JaxPredictorServer(jax_pred, enable_batching=False)
    srv = PredictorServer(pred, enable_batching=False, device="cpu", mesh_devices=[CPU] * 8)
    srv.warmup()
    assert isinstance(jax_srv.executor.root.unit, JaxFusedUnit) and not jax_srv.executor.root.children
    assert isinstance(srv.executor.root.unit, FusedUnit) and not srv.executor.root.children
    runtime = srv.executor.root.unit.runtime
    assert runtime.mesh.shape == {"data": 2, "expert": 4} == dict(jax_srv.mesh.shape)
    rng = np.random.default_rng(11)
    for rows in (8, 5):
        body = {"data": {"ndarray": rng.standard_normal((rows, 16)).tolist()}}
        want = np.asarray((await jax_srv.executor.execute(jax_message_from_dict(body))).array)
        got = np.asarray((await srv.executor.execute(message_from_dict(body))).array)
        assert got.shape == want.shape == (rows, 3)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    assert runtime.recompiles_since_warmup() == 0

def test_what_a_mesh_does_not_serve_yet_is_refused_by_name():
    """What was once refused on a mesh now serves over it. Fine-tuning
    trains over its mesh: a unit on {"seq": 2} and one on {"data": 2} keep
    their meshes, and a step moves the answer they serve alike (held
    against JAX's units in ``tests/test_torch_sharded_training.py``). A
    generative model, once refused on an axis other than data and moved to
    the first position on a data-only mesh, keeps either mesh and answers
    as unsharded (held against JAX's server in
    ``test_a_generative_model_on_a_mesh_serves_like_jax``)."""
    from seldon_core_tpu_torch.graph.spec import TpuSpec
    from seldon_core_tpu_torch.models.online import OnlineFinetuneModelUnit
    from seldon_core_tpu_torch.models.zoo import _runtime_from_modelspec, get_model, make_model_unit
    from seldon_core_tpu_torch.parallel import mesh_from_spec

    unit = SeldonDeployment.from_dict({"spec": {"predictors": [{"name": "p", "graph": _finetune_graph()}]}}
                                      ).spec.predictors[0].graph
    mesh = mesh_from_spec({"data": 2}, [CPU] * 2)
    tpu = TpuSpec(batch_buckets=[2], max_batch=2)
    x = np.asarray([[5.0, 3.0, 4.0, 1.0]] * 8, np.float32)
    moved = []
    for axes in ({"seq": 2}, {"data": 2}):
        learner = make_model_unit(unit, {"tpu": tpu, "device": CPU, "mesh": mesh_from_spec(axes, [CPU] * 2)})
        assert isinstance(learner, OnlineFinetuneModelUnit) and learner.runtime.mesh.shape == axes
        before = learner.runtime.predict(x[:2])
        learner._train(x, np.full(8, 2, np.int32))
        after = learner.runtime.predict(x[:2])
        assert learner._steps_taken == 1 and after[0, 2] > before[0, 2] + 0.05
        moved.append(after)
    np.testing.assert_allclose(moved[0], moved[1], rtol=1e-6, atol=1e-7)
    gpt = dict(seq=8, max_new_tokens=4)
    ids = np.random.default_rng(3).integers(0, 512, (2, 8)).astype(np.int32)
    want = _runtime_from_modelspec(get_model("tiny_gpt", **gpt), tpu, CPU).predict(ids)
    for axes in ({"seq": 2}, {"data": 2}):
        rt = _runtime_from_modelspec(get_model("tiny_gpt", **gpt), tpu, CPU, mesh=mesh_from_spec(axes, [CPU] * 2))
        assert rt.mesh.shape == axes
        np.testing.assert_array_equal(rt.predict(ids), want)


def _gpt_mesh_dep(axes: dict) -> dict:
    return {"spec": {"name": "g", "predictors": [{
        "name": "p", "graph": {"name": "gpt", "type": "MODEL", "implementation": "JAX_MODEL", "parameters": [
            {"name": "model", "value": "tiny_gpt", "type": "STRING"},
            {"name": "seq", "value": "8", "type": "INT"},
            {"name": "max_new_tokens", "value": "5", "type": "INT"}]},
        "tpu": {"dtype": "float32", "max_batch": 4, "mesh": axes}}]}}


@pytest.mark.parametrize("axes", [{"seq": 2}, {"data": 2, "model": 2}, {"data": 2}], ids=lambda a: str(a))
async def test_a_generative_model_on_a_mesh_serves_like_jax(axes):
    """``tiny_gpt`` (no partition rule) on a mesh, as the JAX server runs
    it: parameters replicated, the batch split over the data leads, the
    other axes replicated, buckets rounded up to the data axis's multiple;
    the same ids for a full bucket and a padded one, and no key after
    warmup."""
    dep = _gpt_mesh_dep(axes)
    jax_pred, pred = _predictors(dep)
    n = int(np.prod(list(axes.values())))
    jax_srv = JaxPredictorServer(jax_pred, deployment_name="g", enable_batching=False)
    srv = PredictorServer(pred, deployment_name="g", enable_batching=False, device="cpu", mesh_devices=[CPU] * n)
    srv.warmup()
    runtime = srv.executor.root.unit.runtime
    jax_runtime = jax_srv.executor.root.unit.runtime
    assert runtime.mesh.shape == axes == dict(jax_srv.mesh.shape)
    assert runtime.buckets == jax_runtime.buckets == ((2, 4) if "data" in axes else (1, 2, 4))
    assert runtime.apply_fn.name.startswith("data_parallel")
    rng = np.random.default_rng(11)
    for rows in (4, 3):
        body = {"data": {"ndarray": rng.integers(0, 512, (rows, 8)).tolist()}}
        want = np.asarray((await jax_srv.executor.execute(jax_message_from_dict(body))).array)
        got = np.asarray((await srv.executor.execute(message_from_dict(body))).array)
        assert got.shape == want.shape == (rows, 13)
        np.testing.assert_array_equal(got, want)
    assert runtime.recompiles_since_warmup() == 0


def _finetune_graph() -> dict:
    return {"name": "clf", "type": "MODEL", "implementation": "JAX_MODEL", "parameters": [
        {"name": "model", "value": "iris_logistic", "type": "STRING"},
        {"name": "finetune", "value": "true", "type": "BOOL"},
        {"name": "finetune_batch", "value": "8", "type": "INT"},
        {"name": "finetune_lr", "value": "0.5", "type": "FLOAT"},
        {"name": "finetune_optimizer", "value": "sgd", "type": "STRING"}]}


def test_a_data_only_mesh_stays_on_the_server_device(monkeypatch):
    """Without positions asked for, a mesh builds over the host's cards only
    where it shards over an axis other than data: the defaulted {"data":
    cards} of a host with two cards stays on the server's one card."""
    from seldon_core_tpu_torch.parallel import mesh_from_spec, serving_positions

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    card, cards = [torch.device("cuda", 0)], [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert serving_positions({"data": 2}, "cuda:0") == card
    assert serving_positions(None, "cuda:0") == card
    assert serving_positions({"data": 2, "pipe": 1}, "cuda:0") == card
    assert serving_positions({"data": 1, "seq": 2}, "cuda:0") == cards
    assert serving_positions({"expert": 2}, "cuda:0") == cards
    assert serving_positions({"data": 2}, "cuda:0", [CPU] * 2) == [CPU] * 2
    assert mesh_from_spec({"data": 2}, serving_positions({"data": 2}, "cuda:0")) is None


async def test_a_defaulted_data_mesh_serves_captured_and_finetunes():
    """A deployment defaulted on two devices ({"data": 2}) serves as it did
    before meshes: no mesh, its forward captured per bucket, and its
    fine-tuning unit learns from feedback, through the server and through
    the platform's control plane."""
    from seldon_core_tpu_torch.core.codec_json import feedback_from_dict
    from seldon_core_tpu_torch.models.online import OnlineFinetuneModelUnit

    dep = {"metadata": {"name": "ft"}, "spec": {"name": "ft", "predictors": [{"name": "p", "graph": _finetune_graph()}]}}
    pred = default_deployment(SeldonDeployment.from_dict(copy.deepcopy(dep)), n_devices=2).spec.predictors[0]
    assert pred.tpu.mesh == {"data": 2}
    srv = PredictorServer(pred, enable_batching=False, device="cpu")
    srv.warmup()
    unit = {u.name: u for u in srv.executor.units()}["clf"]
    assert srv.mesh is None and isinstance(unit, OnlineFinetuneModelUnit)
    rt = unit.runtime
    assert rt.mesh is None and rt.cuda_graphs and rt.device == CPU
    x = [[5.0, 3.0, 4.0, 1.0]]
    body = message_from_dict({"data": {"ndarray": x}})
    before = np.asarray((await srv.executor.execute(body)).array)
    for _ in range(8):
        await srv.executor.send_feedback(feedback_from_dict({
            "request": {"data": {"ndarray": x * 2}}, "response": {}, "reward": 1.0,
            "truth": {"data": {"ndarray": [[2], [2]]}}}))
    after = np.asarray((await srv.executor.execute(body)).array)
    assert unit._steps_taken == 2 and after[0, 2] > before[0, 2] + 0.05
    assert rt.recompiles_since_warmup() == 0

    m = DeploymentManager(device="cpu")
    dep["spec"]["predictors"][0]["tpu"] = {"mesh": {"data": 2}}
    assert m.apply(dep).action == "created"
    try:
        svc = next(iter(m.get("ft").services.values()))
        assert not svc.mesh_attrs
        assert isinstance({u.name: u for u in svc.executor.units()}["clf"], OnlineFinetuneModelUnit)
    finally:
        m.delete("ft")
