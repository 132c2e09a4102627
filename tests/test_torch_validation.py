"""The port's deployment validation (``graph/validation.py``) held to the
JAX package's (``seldon_core_tpu/graph/validation.py``) on the same CR
dicts: the same verdict, and every problem the reference names, word for
word, in the port's refusal, through ``validate_deployment``,
``load_predictor`` (the whole deployment) and ``PredictorServer`` (the
predictor it is given, as the JAX server's ``_prepare`` holds it).

The cases: the six specs the port served before it validated (a ROUTER
with no children, duplicate unit names, batch buckets that do not ascend,
``max_batch`` 0, ``replicas`` -1, an ``oauth_key`` without its secret),
every deployment of ``seldon_core_tpu_torch/deployments/`` and the
examples the port serves. Besides, the decode fleet and tensor-parallel
knobs the port does not serve: refused by name, and held to the
reference's rules, whose messages appear beside the port's own.
"""

import copy
import json
from pathlib import Path

import pytest

from seldon_core_tpu.graph.defaulting import default_deployment as jax_default_deployment
from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictorSpec
from seldon_core_tpu.graph.spec import SeldonDeployment as JaxDeployment
from seldon_core_tpu.graph.validation import ValidationError as JaxValidationError
from seldon_core_tpu.graph.validation import validate_deployment as jax_validate
from seldon_core_tpu_torch import graph
from seldon_core_tpu_torch.graph.defaulting import default_deployment
from seldon_core_tpu_torch.graph.spec import PredictorSpec, SeldonDeployment
from seldon_core_tpu_torch.graph.validation import ValidationError, validate_deployment
from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor, validate_predictor

ROOT = Path(__file__).resolve().parent.parent
PORT_DEPLOYMENTS = ROOT / "seldon_core_tpu_torch" / "deployments"
# the examples the port serves (a copy of each lives in PORT_DEPLOYMENTS,
# the feature draft's without its distilled checkpoint)
SERVED_EXAMPLES = ("bert_int8", "full_dag_bert", "gpt_continuous_batching", "iris", "iris_abtest",
                   "iris_fallback_breaker", "mnist", "resnet_ensemble", "tiny_gpt", "tiny_gpt_feature_draft",
                   "tiny_gpt_paged_kv", "tiny_gpt_replicated", "tiny_gpt_speculative", "tiny_gpt_tree_speculation")


def _abtest() -> dict:
    return json.loads((PORT_DEPLOYMENTS / "iris_abtest.json").read_text())


def _f1(edit) -> dict:
    obj = _abtest()
    edit(obj["spec"], obj["spec"]["predictors"][0])
    return obj


def _set(d: dict, **kw):
    d.update(kw)


F1_SPECS = {
    "router_without_children": lambda: _f1(lambda spec, pred: _set(pred["graph"], children=[])),
    "duplicate_unit_names": lambda: _f1(lambda spec, pred: _set(pred["graph"]["children"][1], name="iris-a")),
    "batch_buckets_not_ascending": lambda: _f1(lambda spec, pred: _set(pred, tpu={"batch_buckets": [8, 2]})),
    "max_batch_zero": lambda: _f1(lambda spec, pred: _set(pred, tpu={"max_batch": 0})),
    "replicas_negative": lambda: _f1(lambda spec, pred: _set(pred, replicas=-1)),
    "oauth_key_without_secret": lambda: _f1(lambda spec, pred: spec.pop("oauth_secret")),
}
CASES = {
    **{f"f1/{name}": make for name, make in F1_SPECS.items()},
    **{f"deployments/{p.stem}": (lambda p=p: json.loads(p.read_text()))
       for p in sorted(PORT_DEPLOYMENTS.glob("*.json"))},
    **{f"examples/{name}": (lambda p=ROOT / "examples" / "deployments" / f"{name}.json": json.loads(p.read_text()))
       for name in SERVED_EXAMPLES},
}


def _jax_problems(obj: dict) -> list[str]:
    try:
        jax_validate(jax_default_deployment(JaxDeployment.from_dict(copy.deepcopy(obj))))
    except JaxValidationError as e:
        return e.problems
    return []


def _jax_prepare_problems(pred: dict, name: str) -> list[str]:
    """The JAX server's ``_prepare`` verdict on one predictor."""
    from seldon_core_tpu.serving.server import _prepare

    try:
        _prepare(JaxPredictorSpec.model_validate(copy.deepcopy(pred)), name)
    except JaxValidationError as e:
        return e.problems
    return []


def _port_problems(obj: dict) -> list[str]:
    try:
        validate_deployment(default_deployment(SeldonDeployment.from_dict(obj), n_devices=1))
    except ValidationError as e:
        return e.problems
    return []


@pytest.mark.parametrize("case", sorted(CASES))
def test_validation_matches_jax(case, tmp_path):
    obj = CASES[case]()
    want = _jax_problems(obj)
    assert bool(want) == case.startswith("f1/"), want
    got = _port_problems(obj)
    assert got == want
    path = tmp_path / "dep.json"
    path.write_text(json.dumps(obj))
    if want:
        with pytest.raises(ValidationError) as e:
            load_predictor(str(path))
        assert e.value.problems == want
    else:
        load_predictor(str(path))
    name = obj["spec"].get("name", "")
    for pred in obj["spec"]["predictors"]:
        want_pred = _jax_prepare_problems(pred, name)
        spec = PredictorSpec.from_dict(pred)
        if not want_pred:
            validate_predictor(spec, name)
            continue
        # refused before anything is built
        with pytest.raises(ValidationError) as e:
            PredictorServer(spec, deployment_name=name, device="cpu")
        assert e.value.problems == want_pred


def _gpt(**tpu) -> dict:
    return {"spec": {"name": "g", "predictors": [{
        "name": "p", "graph": {"name": "gpt", "type": "MODEL", "implementation": "JAX_MODEL"},
        "tpu": {"decode_slots": 2, **tpu}}]}}


UNPORTED_CASES = {
    "replicated_example": lambda: json.loads((ROOT / "examples/deployments/tiny_gpt_replicated.json").read_text()),
    "tensor_parallel_example": lambda: json.loads(
        (ROOT / "examples/deployments/tiny_gpt_tensor_parallel.json").read_text()),
    "replicas_zero": lambda: _gpt(decode_replicas=0),
    "autoscale_without_depth": lambda: _gpt(decode_autoscale_replicas=3),
    "autoscale_cap_below_fleet": lambda: _gpt(decode_replicas=3, decode_autoscale_replicas=2,
                                              decode_autoscale_queue_depth=4),
    "depth_without_autoscale": lambda: _gpt(decode_autoscale_queue_depth=4),
    "bad_router_policy": lambda: _gpt(decode_replicas=2, decode_router_policy="random"),
    "policy_on_one_replica": lambda: _gpt(decode_router_policy="bandit"),
    "health_knobs": lambda: _gpt(decode_health_poll_ms=-1, decode_health_miss_threshold=0,
                                 decode_drain_timeout_ms=-5),
    "poll_on_one_replica": lambda: _gpt(decode_health_poll_ms=50),
    "fleet_without_slots": lambda: _gpt(decode_slots=0, decode_replicas=2),
    "fleet_with_mesh_axes": lambda: _gpt(decode_replicas=2, decode_mesh_axes={"tp": 2}),
    "two_mesh_axes": lambda: _gpt(decode_mesh_axes={"tp": 2, "sp": 1}),
    "mesh_axis_zero": lambda: _gpt(decode_mesh_axes={"tp": 0}),
    "mesh_axes_without_slots": lambda: _gpt(decode_slots=0, decode_mesh_axes={"tp": 2}),
    "npy_bindata_disagrees": lambda: {"spec": {"name": "g", "predictors": [
        {"name": "a", "graph": {"name": "m", "implementation": "SIMPLE_MODEL"}},
        {"name": "b", "graph": {"name": "m", "implementation": "SIMPLE_MODEL"},
         "tpu": {"decode_npy_bindata": False}}]}},
}


# knobs of UNPORTED_CASES the port serves now: held to the reference's
# rules alone, word for word (the replicated fleet's since it was ported,
# tensor-parallel decode's, decode_mesh_axes, since it was)
SERVED_CASES = {"npy_bindata_disagrees", "replicated_example", "replicas_zero", "autoscale_without_depth",
                "autoscale_cap_below_fleet", "depth_without_autoscale", "bad_router_policy",
                "policy_on_one_replica", "health_knobs", "poll_on_one_replica", "fleet_without_slots",
                "tensor_parallel_example", "fleet_with_mesh_axes", "two_mesh_axes", "mesh_axis_zero",
                "mesh_axes_without_slots"}


@pytest.mark.parametrize("case", sorted(UNPORTED_CASES))
def test_unported_knobs_refused_by_name_with_the_jax_rules(case):
    """A knob the port does not serve is refused by name, and every problem
    the reference's rules find in it is named too, word for word; a served
    one gets the reference's verdict alone."""
    obj = UNPORTED_CASES[case]()
    want = _jax_problems(obj)
    assert bool(want) == (not case.endswith("_example"))  # the two examples pass the reference
    got = _port_problems(obj)
    assert [p for p in got if "not part of the torch port" not in p] == want
    assert any("not part of the torch port" in p for p in got) == (case not in SERVED_CASES)
    assert bool(got) == (not case.endswith("_example"))  # the served examples pass the port too


def test_graph_package_exports_validation():
    """``seldon_core_tpu_torch.graph`` exports what the JAX ``graph``
    package does."""
    import seldon_core_tpu.graph as jax_graph

    assert sorted(graph.__all__) == sorted(jax_graph.__all__)
    assert graph.validate_deployment is validate_deployment and graph.ValidationError is ValidationError
    assert issubclass(ValidationError, ValueError)
