"""The port's graph units, feedback and fusion against the JAX package's.

- RANDOM_ABTEST and EPSILON_GREEDY give the JAX package's routing sequence
  for the same requests (both draw from ``random.Random``), and after the
  same feedback the ε-greedy router's state is equal;
- MEAN_TRANSFORMER and AVERAGE_COMBINER fail with the JAX package's error
  codes;
- ``fuse_graph`` mirrors tests/test_fused.py: a homogeneous ensemble stacks
  its members and runs one ``torch.func.vmap``, a heterogeneous one runs
  them in turn, a router subtree never fuses, a transformer -> combiner DAG
  fuses to one unit; fused and unfused agree at rtol 1e-5 / atol 1e-6
  (tests/test_fused.py's tolerance);
- the fused resnet_tiny ensemble (bit-identical init in both packages)
  agrees with the JAX package's fused ensemble at rtol 1e-4 / atol 1e-5
  (tests/test_models_heavy.py's ResNet tolerance).
"""

import numpy as np
import pytest

from seldon_core_tpu.core.codec_json import message_from_dict as jax_message_from_dict
from seldon_core_tpu.core.message import Feedback as JaxFeedback
from seldon_core_tpu.core.message import Meta as JaxMeta
from seldon_core_tpu.core.message import SeldonMessage as JaxMessage
from seldon_core_tpu.engine import build_executor as jax_build_executor
from seldon_core_tpu.engine.fused import FusedUnit as JaxFusedUnit
from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictorSpec
from seldon_core_tpu_torch.core.codec_json import message_from_dict
from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Feedback, Meta, SeldonMessage
from seldon_core_tpu_torch.engine.builtin import EpsilonGreedyRouter
from seldon_core_tpu_torch.engine.executor import build_executor
from seldon_core_tpu_torch.engine.fused import FusedUnit
from seldon_core_tpu_torch.engine.units import Unit
from seldon_core_tpu_torch.graph.spec import PredictorSpec

FUSE_TOL = dict(rtol=1e-5, atol=1e-6)
RESNET_TOL = dict(rtol=1e-4, atol=1e-5)
MSG = {"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2], [4.9, 3.0, 1.4, 0.2]]}}
CPU = {"device": "cpu"}


def _model(name, uri):
    return {
        "name": name,
        "type": "MODEL",
        "implementation": "JAX_MODEL",
        "parameters": [{"name": "model_uri", "value": uri, "type": "STRING"}],
    }


def _router(impl, params, children):
    return {
        "name": "r",
        "type": "ROUTER",
        "implementation": impl,
        "parameters": params,
        "children": children,
    }


def _ensemble(uris, name="avg"):
    return {
        "name": name,
        "type": "COMBINER",
        "implementation": "AVERAGE_COMBINER",
        "children": [_model(f"m{i}", u) for i, u in enumerate(uris)],
    }


def _predictor(graph, fuse=True):
    return {"name": "p", "graph": graph, "tpu": {"fuse_graph": fuse, "max_batch": 8}}


def _ours(graph, fuse=True):
    return build_executor(PredictorSpec.from_dict(_predictor(graph, fuse)), context=CPU)


def _theirs(graph, fuse=True):
    return jax_build_executor(JaxPredictorSpec.model_validate(_predictor(graph, fuse)))


def _arr(msg):
    return np.asarray(msg.array)


IRIS_PAIR = [_model("a", "zoo://iris_logistic"), _model("b", "zoo://iris_mlp")]


@pytest.mark.parametrize(
    "impl,params",
    [
        ("RANDOM_ABTEST", [{"name": "ratioA", "value": "0.5", "type": "FLOAT"}]),
        ("RANDOM_ABTEST", [{"name": "ratioA", "value": "0.2", "type": "FLOAT"}]),
        ("EPSILON_GREEDY", [{"name": "epsilon", "value": "0.5", "type": "FLOAT"},
                            {"name": "seed", "value": "11", "type": "INT"}]),
    ],
)
async def test_routing_sequence_equals_jax(impl, params):
    graph = _router(impl, params, IRIS_PAIR)
    ours, theirs = _ours(graph), _theirs(graph)
    got = [(await ours.execute(message_from_dict(MSG))).meta.routing["r"] for _ in range(40)]
    want = [(await theirs.execute(jax_message_from_dict(MSG))).meta.routing["r"] for _ in range(40)]
    assert got == want and set(got) == {0, 1}


async def test_epsilon_greedy_state_after_feedback_equals_jax():
    graph = _router("EPSILON_GREEDY", [{"name": "epsilon", "value": "0.2", "type": "FLOAT"},
                                       {"name": "seed", "value": "3", "type": "INT"}], IRIS_PAIR)
    ours, theirs = _ours(graph), _theirs(graph)
    rewards = np.random.default_rng(0).uniform(size=30)
    routes = []
    for r in rewards:
        out = await ours.execute(message_from_dict(MSG))
        jout = await theirs.execute(jax_message_from_dict(MSG))
        routes.append((out.meta.routing["r"], jout.meta.routing["r"]))
        await ours.send_feedback(Feedback(response=out, reward=float(r)))
        await theirs.send_feedback(
            JaxFeedback(response=JaxMessage(meta=JaxMeta(routing=dict(jout.meta.routing))), reward=float(r))
        )
    assert all(a == b for a, b in routes)
    mine, ref = ours.root.unit, theirs.root.unit
    assert mine.counts == ref.counts and sum(mine.counts) == len(rewards)
    np.testing.assert_allclose(mine.rewards, ref.rewards, rtol=0, atol=1e-12)
    assert set(ours.stateful_units()) == set(theirs.stateful_units()) == {"r"}


async def test_feedback_moves_only_the_routed_arm():
    graph = _router("EPSILON_GREEDY", [{"name": "epsilon", "value": "0.0", "type": "FLOAT"}], IRIS_PAIR)
    ex = _ours(graph)
    router = ex.root.unit
    assert isinstance(router, EpsilonGreedyRouter)
    fb = Feedback(response=SeldonMessage(meta=Meta(routing={"r": 1})), reward=1.0)
    await ex.send_feedback(fb)
    assert router.counts == [0, 1] and router.rewards == [0.0, 1.0]
    with pytest.raises(APIException) as e:
        await ex.send_feedback(Feedback(response=SeldonMessage(meta=Meta(routing={"r": 5})), reward=1.0))
    assert e.value.error is ErrorCode.ENGINE_INVALID_ROUTING


def _mean_transformer(means, child, typ="TRANSFORMER"):
    return {
        "name": "t",
        "type": typ,
        "implementation": "MEAN_TRANSFORMER",
        "parameters": [{"name": "means", "value": means, "type": "STRING"}],
        "children": [child],
    }


def _error_code(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test compares what each raises
        return getattr(getattr(e, "error", None), "code", type(e).__name__)
    return None


_ERROR_GRAPHS = {
    "transformer_means": _mean_transformer("1,2", _model("m", "zoo://iris_mlp")),  # 2 means, 4 features
    "output_transformer_means": _mean_transformer(  # 2 means, 3 outputs
        "1,2", _model("m", "zoo://iris_mlp"), "OUTPUT_TRANSFORMER"
    ),
    "combiner_shapes": {"name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
                        "children": [_model("m0", "zoo://iris_mlp"), _model("m1", "zoo://mean_classifier")]},
}


@pytest.mark.parametrize(
    "name,fuse",
    [("transformer_means", False), ("transformer_means", True), ("output_transformer_means", False),
     ("output_transformer_means", True), ("combiner_shapes", False)],
)
def test_error_codes_equal_jax(name, fuse):
    import asyncio

    graph = _ERROR_GRAPHS[name]
    ours = _error_code(lambda: asyncio.run(_ours(graph, fuse).execute(message_from_dict(MSG))))
    theirs = _error_code(lambda: asyncio.run(_theirs(graph, fuse).execute(jax_message_from_dict(MSG))))
    assert ours == theirs and ours in (103, 106)


def test_mean_transformer_needs_means_as_in_jax():
    graph = _mean_transformer("", _model("m", "zoo://iris_mlp"))
    with pytest.raises(ValueError, match="means"):
        _ours(graph)
    with pytest.raises(ValueError, match="means"):
        _theirs(graph)


async def test_combiner_averages_device_tensors_and_host_arrays_alike():
    import torch

    from seldon_core_tpu_torch.engine.builtin import AverageCombinerUnit
    from seldon_core_tpu_torch.graph.spec import PredictiveUnit

    unit = AverageCombinerUnit(PredictiveUnit(name="avg"))
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = a * 3
    host = await unit.aggregate([SeldonMessage.from_array(a), SeldonMessage.from_array(b)])
    mixed = await unit.aggregate([SeldonMessage.from_array(torch.from_numpy(a)), SeldonMessage.from_array(b)])
    assert isinstance(host.array, np.ndarray) and isinstance(mixed.array, torch.Tensor)
    np.testing.assert_array_equal(host.array, (a + b) / 2)
    np.testing.assert_array_equal(mixed.array.numpy(), (a + b) / 2)


async def _fused_vs_plain(graph, msg=MSG):
    fused, plain = _ours(graph, True), _ours(graph, False)
    out_f = await fused.execute(message_from_dict(msg))
    out_p = await plain.execute(message_from_dict(msg))
    np.testing.assert_allclose(_arr(out_f), _arr(out_p), **FUSE_TOL)
    assert out_f.names == out_p.names
    return fused, plain


async def test_homogeneous_ensemble_fuses_into_one_vmap():
    graph = _ensemble([f"zoo://iris_mlp?seed={i}" for i in range(3)])
    fused, plain = await _fused_vs_plain(graph)
    assert isinstance(fused.root.unit, FusedUnit) and not fused.root.children
    assert fused.root.unit.image == "fused[m0,m1,m2]"
    assert not isinstance(plain.root.unit, FusedUnit)
    members = fused.root.unit.runtime.params["members"]
    assert isinstance(members, dict)  # one stacked tree, not a list of trees
    assert all(leaf.shape[0] == 3 for leaf in (members["l1"]["w"], members["l2"]["b"]))


async def test_heterogeneous_ensemble_fuses():
    fused, _ = await _fused_vs_plain(_ensemble(["zoo://iris_mlp?seed=0", "zoo://iris_logistic?seed=1"]))
    assert isinstance(fused.root.unit, FusedUnit)
    assert isinstance(fused.root.unit.runtime.params["members"], list)


async def test_router_subtree_never_fuses_but_its_island_does():
    graph = _router("RANDOM_ABTEST", [{"name": "ratioA", "value": "0.5", "type": "FLOAT"}],
                    [_ensemble(["zoo://iris_mlp?seed=0", "zoo://iris_mlp?seed=1"], "avg0"),
                     _model("solo", "zoo://iris_logistic")])
    ex = _ours(graph)
    assert not isinstance(ex.root.unit, FusedUnit) and len(ex.root.children) == 2
    assert isinstance(ex.root.children[0].unit, FusedUnit)
    assert not isinstance(ex.root.children[1].unit, FusedUnit)
    out = await ex.execute(message_from_dict(MSG))
    assert "r" in out.meta.routing and _arr(out).shape == (2, 3)


async def test_model_with_children_does_not_fuse():
    chain = _model("chain-head", "zoo://iris_mlp")
    chain["children"] = [_model("inner", "zoo://mean_classifier")]
    graph = {"name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
             "children": [chain, _model("leaf", "zoo://mean_classifier")]}
    fused, _ = await _fused_vs_plain(graph, {"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}})
    assert not isinstance(fused.root.unit, FusedUnit)


def _dag():
    """transformer -> output transformer -> combiner(2 models)."""
    return _mean_transformer("1.0", {
        "name": "shift-out",
        "type": "OUTPUT_TRANSFORMER",
        "implementation": "MEAN_TRANSFORMER",
        "parameters": [{"name": "means", "value": "-0.25", "type": "STRING"}],
        "children": [_ensemble([f"zoo://iris_mlp?seed={i}" for i in range(2)])],
    })


async def test_transformer_combiner_dag_fuses_to_one_unit():
    fused, plain = await _fused_vs_plain(_dag())
    assert isinstance(fused.root.unit, FusedUnit) and fused.root.children == []
    assert not isinstance(plain.root.unit, FusedUnit)


async def test_opaque_transformer_blocks_fusion_island():
    class Doubler(Unit):
        async def transform_input(self, msg):
            return msg.with_array(np.asarray(msg.array) * 2)

    graph = {"name": "opaque", "type": "TRANSFORMER",
             "children": [_ensemble([f"zoo://iris_mlp?seed={i}" for i in range(2)])]}
    spec = PredictorSpec.from_dict(_predictor(graph))
    ex = build_executor(spec, context={**CPU, "units": {"opaque": Doubler(spec.graph)}})
    assert not isinstance(ex.root.unit, FusedUnit)
    assert isinstance(ex.root.children[0].unit, FusedUnit)
    assert _arr(await ex.execute(message_from_dict(MSG))).shape == (2, 3)


async def test_fused_graph_matches_jax_fused_graph_on_the_same_weights():
    """The DAG above with the JAX package's iris weights carried across."""
    ours, theirs = _ours(_dag()), _theirs(_dag())
    assert isinstance(theirs.root.unit, JaxFusedUnit) and isinstance(ours.root.unit, FusedUnit)
    jmembers = theirs.root.unit.runtime.params["members"]
    ours.root.unit.runtime.params["members"] = _to_torch(jmembers)
    got = _arr(await ours.execute(message_from_dict(MSG)))
    ref = np.asarray((await theirs.execute(jax_message_from_dict(MSG))).array)
    np.testing.assert_allclose(got, ref, **FUSE_TOL)


def _to_torch(tree):
    import jax
    import torch

    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


async def test_fused_resnet_tiny_ensemble_matches_jax():
    graph = _ensemble([f"zoo://resnet_tiny?seed={i}" for i in range(3)])
    x = np.random.default_rng(1).integers(0, 256, size=(2, 32, 32, 3)).astype(np.float32)
    msg = {"data": {"ndarray": x.tolist()}}
    fused, _ = await _fused_vs_plain(graph, msg)
    theirs = _theirs(graph)
    assert isinstance(fused.root.unit, FusedUnit) and isinstance(theirs.root.unit, JaxFusedUnit)
    got = _arr(await fused.execute(message_from_dict(msg)))
    ref = np.asarray((await theirs.execute(jax_message_from_dict(msg))).array)
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, ref, **RESNET_TOL)


async def test_simple_units():
    graph = {"name": "r", "type": "ROUTER", "implementation": "SIMPLE_ROUTER",
             "children": [{"name": "s", "type": "MODEL", "implementation": "SIMPLE_MODEL"},
                          _model("m", "zoo://iris_mlp")]}
    out = await _ours(graph).execute(message_from_dict(MSG))
    assert out.meta.routing == {"r": 0} and out.names == ("c0", "c1", "c2")
    np.testing.assert_array_equal(_arr(out), np.float32([[0.1, 0.9, 0.5]] * 2))


async def test_unported_builtins_are_refused():
    # PREFIX_AFFINITY, the last built-in the port refused, is served now:
    # no built-in is refused, and it routes as the JAX package's does
    from seldon_core_tpu_torch.engine.builtin import _NOT_PORTED

    assert _NOT_PORTED == ()
    graph = {"name": "p", "type": "ROUTER", "implementation": "PREFIX_AFFINITY",
             "parameters": [{"name": "seed", "value": "0", "type": "INT"}],
             "children": [{"name": "s", "type": "MODEL", "implementation": "SIMPLE_MODEL"},
                          {"name": "t", "type": "MODEL", "implementation": "SIMPLE_MODEL"}]}
    ids = {"data": {"ndarray": [list(range(20))]}}
    out = await _ours(graph).execute(message_from_dict(ids))
    ref = await _theirs(graph).execute(jax_message_from_dict(ids))
    assert out.meta.routing == dict(ref.meta.routing) and out.meta.routing["p"] in (0, 1)
