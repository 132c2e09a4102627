"""Online fine-tuning in the port (``models/online.py``, the zoo's
``finetune`` wiring, ``ModelRuntime.load_params``, ``StatePersister``) held
to the JAX package's (tests/test_online.py) in lockstep, on the CPU.

Each case builds the same predictor in both packages, carries the JAX
unit's parameters into the port's runtime (the two zoos draw the small
models' weights differently), sends both the same feedback and compares
the served probabilities after every feedback: within 1e-5 in float32
(both sum the same few products; measured under 1e-6), within 2e-3 in
bfloat16 (the two optimizers round their moments at different points).

Fault F4: before this slice the port built a plain ``ModelUnit`` for
``finetune: true``, whose ``send_feedback`` does nothing, so
``test_finetune_unit_wired_and_learns`` failed: the port's prediction for
[[5, 3, 4, 1]] stayed put while the JAX package's moved.
"""

import logging
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.core.codec_json import feedback_from_dict as jax_feedback
from seldon_core_tpu.core.codec_json import message_from_dict as jax_message
from seldon_core_tpu.engine import build_executor as jax_build_executor
from seldon_core_tpu.graph.defaulting import default_deployment as jax_default_deployment
from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictorSpec
from seldon_core_tpu.graph.spec import SeldonDeployment as JaxDeployment
from seldon_core_tpu.models.online import OnlineFinetuneModelUnit as JaxOnlineUnit
from seldon_core_tpu_torch.core.codec_json import feedback_from_dict, message_from_dict
from seldon_core_tpu_torch.engine.executor import build_executor
from seldon_core_tpu_torch.graph.defaulting import default_deployment
from seldon_core_tpu_torch.graph.spec import PredictiveUnitMethod, PredictorSpec, SeldonDeployment
from seldon_core_tpu_torch.models.base import ModelRuntime, ModelUnit
from seldon_core_tpu_torch.models.convert import params_to_numpy, params_to_torch, tree_map
from seldon_core_tpu_torch.models.online import OnlineFinetuneModelUnit
from seldon_core_tpu_torch.persistence.state import FileStateStore, StatePersister
from seldon_core_tpu_torch.training.distill_draft import flatten_params

CPU = torch.device("cpu")
# served probabilities: the JAX package rounds bf16 rows to bf16, the port
# serves them in float32 (ROADMAP, deliberate differences), 2^-8 apart at 1
TOL = {"float32": 1e-5, "bfloat16": 4e-3}
# parameter leaves: in bf16 the two optimizers round their moments and
# updates at different points, so a leaf may sit two bf16 steps apart
# (rtol 2^-6), and a leaf near 0 a few steps apart at the scale of one
# update (Adam moves a leaf by about lr = 1e-3 a step: 3e-5 is 4 bf16
# steps there)
PARAM_TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=2**-6, atol=3e-5)}
X_IRIS = [[5.0, 3.0, 4.0, 1.0]]


def _graph(batch=8, lr=0.5, opt="sgd", model="iris_logistic", methods=("TRANSFORM_INPUT", "SEND_FEEDBACK"),
           finetune="true", finetune_type="BOOL", extra=()) -> dict:
    g = {
        "name": "clf",
        "type": "MODEL",
        "implementation": "JAX_MODEL",
        "parameters": [
            {"name": "model_uri" if "://" in model else "model", "value": model, "type": "STRING"},
            {"name": "finetune", "value": finetune, "type": finetune_type},
            {"name": "finetune_batch", "value": str(batch), "type": "INT"},
            {"name": "finetune_lr", "value": str(lr), "type": "FLOAT"},
            {"name": "finetune_optimizer", "value": opt, "type": "STRING"},
            *extra,
        ],
    }
    if methods is not None:
        g["methods"] = list(methods)
    return g


def _predictor(tpu=None, **kw) -> dict:
    d = {"name": "p", "graph": _graph(**kw)}
    if tpu is not None:
        d["tpu"] = tpu
    return d


def _clf(ex):
    return {u.name: u for u in ex.units()}["clf"]


def _pair(pred: dict):
    """(JAX executor, port executor) of one predictor, the port's runtime
    holding the JAX unit's parameters."""
    jex = jax_build_executor(JaxPredictorSpec.model_validate(pred))
    tex = build_executor(PredictorSpec.from_dict(pred), context={"device": "cpu"})
    jrt, trt = _clf(jex).runtime, _clf(tex).runtime
    trt.load_params(params_to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32), jrt.params), CPU, trt.dtype))
    return jex, tex


async def _predict_both(jex, tex, x):
    j = np.asarray((await jex.execute(jax_message({"data": {"ndarray": x}}))).array, np.float32)
    t = np.asarray((await tex.execute(message_from_dict({"data": {"ndarray": x}}))).array, np.float32)
    return j, t


def _fb(x, truth) -> dict:
    return {"request": {"data": {"ndarray": x}}, "response": {}, "reward": 1.0, "truth": {"data": {"ndarray": truth}}}


async def _feedback_both(jex, tex, fb: dict):
    await jex.send_feedback(jax_feedback(fb))
    await tex.send_feedback(feedback_from_dict(fb))


def _dtype(tex) -> str:
    return str(_clf(tex).runtime.dtype).removeprefix("torch.")


async def _lockstep(jex, tex, feedbacks, probe):
    """Send each feedback to both; after each, the probe's probabilities
    and every parameter leaf agree within the dtype's tolerances. Returns
    (before, after) of the port's probabilities."""
    dtype = _dtype(tex)
    tol, ptol = TOL[dtype], PARAM_TOL[dtype]
    j0, t0 = await _predict_both(jex, tex, probe)
    np.testing.assert_allclose(t0, j0, atol=tol, rtol=0)
    for fb in feedbacks:
        await _feedback_both(jex, tex, fb)
        j, t = await _predict_both(jex, tex, probe)
        np.testing.assert_allclose(t, j, atol=tol, rtol=0)
        want = flatten_params(jax.tree.map(lambda a: np.asarray(a, np.float32), _clf(jex).runtime.params))
        got = flatten_params(_clf(tex).runtime.params)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **ptol, err_msg=k)
        assert _clf(tex)._steps_taken == _clf(jex)._steps_taken
        assert _clf(tex)._buffer_y == _clf(jex)._buffer_y
    return t0, t


async def test_finetune_unit_wired_and_learns():
    """F4: 80 labelled examples of class 2 in feedbacks of two rows (10
    steps at batch 8) move both packages' prediction for [[5, 3, 4, 1]]
    alike, and the taught class's probability rises."""
    jex, tex = _pair(_predictor(batch=8, lr=0.5))
    assert isinstance(_clf(tex), OnlineFinetuneModelUnit) and isinstance(_clf(jex), JaxOnlineUnit)
    fbs = [_fb(X_IRIS * 2, [[2], [2]]) for _ in range(40)]
    before, after = await _lockstep(jex, tex, fbs, X_IRIS)
    assert _clf(tex)._steps_taken == 10
    assert after[0, 2] > before[0, 2] + 0.1


async def test_finetune_second_probe_learns():
    """The JAX test's own probe and class: 4 feedbacks of 2 rows, 1 step."""
    x = [[1.0, 0.5, -0.5, 2.0]]
    jex, tex = _pair(_predictor(batch=8, lr=0.5))
    before, after = await _lockstep(jex, tex, [_fb(x * 2, [[2], [2]]) for _ in range(4)], x)
    assert _clf(tex)._steps_taken >= 1
    assert after[0, 2] > before[0, 2]


async def test_finetune_accepts_onehot_truth():
    jex, tex = _pair(_predictor(batch=2, lr=0.5))
    await _lockstep(jex, tex, [_fb([[1, 2, 3, 4], [4, 3, 2, 1]], [[0, 1, 0], [1, 0, 0]])], X_IRIS)
    assert _clf(tex)._steps_taken == 1


async def test_finetune_ignores_malformed_feedback():
    jex, tex = _pair(_predictor(batch=2))
    no_truth = {"request": {"data": {"ndarray": [[1, 2, 3, 4]]}}, "response": {}, "reward": 1.0}
    await _lockstep(jex, tex, [no_truth, _fb([[1, 2, 3, 4]], [[1], [2]])], X_IRIS)
    assert _clf(tex)._steps_taken == 0
    assert len(_clf(tex)._buffer_y) == 0


async def test_large_feedback_payload_drains_fully():
    jex, tex = _pair(_predictor(batch=4, lr=0.1))
    await _lockstep(jex, tex, [_fb([[1.0, 2.0, 3.0, 4.0]] * 10, [[1]] * 10)], X_IRIS)
    assert _clf(tex)._steps_taken == 2  # 10 rows / batch 4 -> 2 steps
    assert len(_clf(tex)._buffer_y) == 2  # the remainder only


async def test_finetune_adam_in_lockstep():
    """Adam (the default optimizer): torch.optim.Adam against optax.adam
    through five steps."""
    jex, tex = _pair(_predictor(batch=4, lr=0.05, opt="adam"))
    rng = np.random.default_rng(3)
    fbs = [_fb(rng.uniform(0, 8, (4, 4)).round(2).tolist(), rng.integers(0, 3, (4, 1)).tolist()) for _ in range(5)]
    await _lockstep(jex, tex, fbs, X_IRIS)
    assert _clf(tex)._steps_taken == 5


async def test_finetune_mnist_bf16_adam_in_lockstep():
    """The compute dtype: ``mnist_mlp`` in bfloat16 (``mnist.json``'s
    dtype) with Adam trains on the bf16 serving parameters, as the
    reference's step does, with the float32 features the reference's step
    takes."""
    extra = ({"name": "hidden", "value": "64", "type": "INT"},)
    jex, tex = _pair(_predictor(batch=4, lr=1e-3, opt="adam", model="mnist_mlp", extra=extra,
                                tpu={"dtype": "bfloat16"}))
    assert _dtype(tex) == "bfloat16"
    rng = np.random.default_rng(4)
    fbs = [_fb(rng.uniform(0, 1, (4, 784)).round(3).tolist(), [[7]] * 4) for _ in range(3)]
    probe = rng.uniform(0, 1, (2, 784)).round(3).tolist()
    before, after = await _lockstep(jex, tex, fbs, probe)
    assert after[0, 7] > before[0, 7]


async def test_finetune_state_persists(tmp_path):
    """Learned weights, buffer and Adam moments survive a restart through the
    persister; the restored unit's next step equals an uninterrupted one."""
    store = FileStateStore(str(tmp_path))
    pred = PredictorSpec.from_dict(_predictor(batch=2, lr=0.5, opt="adam"))
    ex1 = build_executor(pred, context={"device": "cpu"})
    p1 = StatePersister(store, "dep")
    p1.attach(ex1.units())
    fb = feedback_from_dict(_fb([[1, 2, 3, 4], [1, 2, 3, 4], [4, 3, 2, 1]], [[2], [2], [0]]))
    await ex1.send_feedback(fb)
    assert _clf(ex1)._steps_taken == 1 and _clf(ex1)._buffer_y == [0]
    msg = {"data": {"ndarray": [[1, 2, 3, 4]]}}
    trained = np.asarray((await ex1.execute(message_from_dict(msg))).array)
    assert p1.persist_now() == 1

    ex2 = build_executor(pred, context={"device": "cpu"})
    p2 = StatePersister(store, "dep")
    assert p2.attach(ex2.units()) == 1
    restored = np.asarray((await ex2.execute(message_from_dict(msg))).array)
    np.testing.assert_allclose(restored, trained, rtol=1e-5)
    assert _clf(ex2)._steps_taken == 1 and _clf(ex2)._buffer_y == [0]
    # one more step on each: the moments came back too
    nxt = feedback_from_dict(_fb([[4, 3, 2, 1]], [[0]]))
    await ex1.send_feedback(nxt)
    await ex2.send_feedback(nxt)
    a = np.asarray((await ex1.execute(message_from_dict(msg))).array)
    b = np.asarray((await ex2.execute(message_from_dict(msg))).array)
    np.testing.assert_array_equal(a, b)


def test_jax_persisted_params_restore_into_the_port(tmp_path):
    """A state the JAX unit persisted (an SGD unit: no moments) restores
    into the port's unit: the buffer, the step count and the weights."""
    store = FileStateStore(str(tmp_path))
    pred = _predictor(batch=3, lr=0.5)
    jex = jax_build_executor(JaxPredictorSpec.model_validate(pred))
    ju = _clf(jex)
    ju._buffer_x, ju._buffer_y, ju._steps_taken = [np.ones(4, np.float32)], [1], 4
    from seldon_core_tpu.persistence.state import StatePersister as JaxStatePersister

    jp = JaxStatePersister(store, "dep")
    jp.attach(jex.units())
    assert jp.persist_now() == 1
    tex = build_executor(PredictorSpec.from_dict(pred), context={"device": "cpu"})
    assert StatePersister(store, "dep").attach(tex.units()) == 1
    tu = _clf(tex)
    assert tu._steps_taken == 4 and tu._buffer_y == [1]
    want = jax.tree.map(np.asarray, ju.runtime.params)
    got = params_to_numpy(tu.runtime.params)
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k], want[k])


def _deployment(methods) -> dict:
    return {
        "metadata": {"name": "d"},
        "spec": {"name": "d", "predictors": [{"name": "p", "graph": _graph(methods=methods)}]},
    }


@pytest.mark.parametrize("methods", [None, ("TRANSFORM_INPUT",)], ids=["absent", "explicit_without_feedback"])
def test_defaulting_injects_send_feedback_for_finetune(methods):
    out = default_deployment(SeldonDeployment.from_dict(_deployment(methods)))
    jout = jax_default_deployment(JaxDeployment.from_dict(_deployment(methods)))
    got = [m.value for m in out.spec.predictors[0].graph.methods]
    assert got == [m.value for m in jout.spec.predictors[0].graph.methods]
    assert PredictiveUnitMethod.SEND_FEEDBACK.value in got and PredictiveUnitMethod.TRANSFORM_INPUT.value in got


@pytest.mark.parametrize("value,vtype", [("false", "STRING"), ("false", "BOOL"), ("0", "STRING")])
def test_string_false_does_not_enable_finetune(value, vtype):
    pred = _predictor(finetune=value, finetune_type=vtype)
    jex = jax_build_executor(JaxPredictorSpec.model_validate(pred))
    tex = build_executor(PredictorSpec.from_dict(pred), context={"device": "cpu"})
    assert not isinstance(_clf(jex), JaxOnlineUnit)
    assert type(_clf(tex)) is ModelUnit


def test_finetune_refused_with_int8_weights():
    pred = _predictor(tpu={"weight_quant": "int8"})
    with pytest.raises(ValueError) as je:
        jax_build_executor(JaxPredictorSpec.model_validate(pred))
    with pytest.raises(ValueError) as te:
        build_executor(PredictorSpec.from_dict(pred), context={"device": "cpu"})
    assert str(te.value) == str(je.value) and "finetune=true cannot combine" in str(te.value)


def test_missing_send_feedback_warns(caplog):
    pred = _predictor(methods=("TRANSFORM_INPUT",))
    with caplog.at_level(logging.WARNING):
        jax_build_executor(JaxPredictorSpec.model_validate(pred))
    jax_text = caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        tex = build_executor(PredictorSpec.from_dict(pred), context={"device": "cpu"})
    assert "SEND_FEEDBACK is not in its methods" in jax_text
    assert "SEND_FEEDBACK is not in its methods" in caplog.text
    assert isinstance(_clf(tex), OnlineFinetuneModelUnit)


async def test_feedback_through_a_kernel_without_backward_fails_like_the_reference():
    """A unit whose forward reaches the flash kernel (BERT at seq 128 with
    ``attn_kernel=pallas``): the reference's step through its Pallas kernel
    raises and the weights stay; the port's wrapper raises by name on every
    route, the step fails and the weights stay."""
    pred = _predictor(batch=2, lr=0.1, model="zoo://bert_tiny?seq=128&attn_kernel=pallas")
    jex, tex = _pair(pred)
    x = np.random.default_rng(0).integers(0, 100, (2, 128)).tolist()
    j0, t0 = await _predict_both(jex, tex, x)
    fb = _fb(x, [[1], [1]])
    with pytest.raises(Exception):
        await jex.send_feedback(jax_feedback(fb))
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        await tex.send_feedback(feedback_from_dict(fb))
    j1, t1 = await _predict_both(jex, tex, x)
    np.testing.assert_array_equal(j1, j0)
    np.testing.assert_array_equal(t1, t0)
    assert _clf(tex)._steps_taken == _clf(jex)._steps_taken == 0


async def test_finetune_unit_inside_a_fused_island_loses_its_feedback():
    """Inherited, in both packages: an AVERAGE_COMBINER over two finetune
    units fuses (``tpu.fuse_graph``, the default) into one island that
    snapshots the members' parameters and takes no feedback, so labelled
    feedback changes nothing in either package."""
    members = [dict(_graph(batch=2, lr=0.5), name=f"clf{i}") for i in range(2)]
    pred = {"name": "p", "graph": {"name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
                                   "children": members}}
    jex = jax_build_executor(JaxPredictorSpec.model_validate(pred))
    tex = build_executor(PredictorSpec.from_dict(pred), context={"device": "cpu"})
    assert not any(isinstance(u, JaxOnlineUnit) for u in jex.units())
    assert not any(isinstance(u, OnlineFinetuneModelUnit) for u in tex.units())
    x = X_IRIS
    j0 = np.asarray((await jex.execute(jax_message({"data": {"ndarray": x}}))).array)
    t0 = np.asarray((await tex.execute(message_from_dict({"data": {"ndarray": x}}))).array)
    for _ in range(4):
        await _feedback_both(jex, tex, _fb(X_IRIS * 2, [[2], [2]]))
    np.testing.assert_array_equal(np.asarray((await jex.execute(jax_message({"data": {"ndarray": x}}))).array), j0)
    np.testing.assert_array_equal(np.asarray((await tex.execute(message_from_dict({"data": {"ndarray": x}}))).array),
                                  t0)


def _versions(unit):
    """Record every tree ``load_params`` publishes (numpy), the unit's
    starting weights first."""
    rt = unit.runtime
    snapshot = lambda tree: tree_map(np.array, params_to_numpy(tree))  # noqa: E731 - copies, not views
    versions = [snapshot(rt.params)]
    real = rt.load_params

    def record(tree):
        real(tree)
        versions.append(snapshot(tree))

    rt.load_params = record
    return versions


def _forward(unit, tree, x) -> np.ndarray:
    """The served forward on ``tree``: an eager twin runtime (the same
    bucket padding and casts)."""
    rt = unit.runtime
    twin = ModelRuntime(rt.apply_fn, tree, device=CPU, buckets=rt.buckets, dtype=rt.dtype, cuda_graphs=False)
    return twin.predict(x)


async def _predicts_during_steps(unit, ex, x, steps: int):
    """Predicts from more threads than the host has cores, with the
    interpreter switching threads as often as it can, while ``steps``
    feedback steps run; returns the served rows."""
    served, stop = [], threading.Event()

    def predicting():
        while not stop.is_set():
            served.append(unit.runtime.predict(x))

    threads = [threading.Thread(target=predicting) for _ in range((os.cpu_count() or 1) + 1)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    for t in threads:
        t.start()
    rng = np.random.default_rng(5)
    try:
        for _ in range(steps):
            await ex.send_feedback(feedback_from_dict(_fb(rng.uniform(0, 8, (2, 4)).tolist(), [[2], [1]])))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    served.append(unit.runtime.predict(x))
    return served


@pytest.mark.parametrize("torn", [False, True], ids=["whole_updates", "planted_torn_update"])
async def test_concurrent_predicts_see_one_version(torn):
    """Every prediction served while steps run equals the forward of one
    published version; a planted update that copies half the leaves fails
    that check. The warmed runtime adds no dispatch key."""
    ex = build_executor(PredictorSpec.from_dict(_predictor(batch=2, lr=0.5, opt="adam")),
                        context={"device": "cpu"})
    unit = _clf(ex)
    rt = unit.runtime
    rt.warmup()
    if torn:  # the planted fault: "w" lands, "b" does not
        real = rt.load_params
        rt.load_params = lambda tree: real({"w": tree["w"], "b": rt.params["b"].detach().clone()})
    versions = _versions(unit)
    x = np.asarray(X_IRIS * 3, np.float32)
    served = await _predicts_during_steps(unit, ex, x, steps=6)
    assert unit._steps_taken == 6 and len(versions) == 7
    forwards = [_forward(unit, v, x) for v in versions]
    matched = [any(np.array_equal(row, f) for f in forwards) for row in served]
    if torn:
        assert not all(matched)
    else:
        assert all(matched), f"{matched.count(False)} of {len(served)} rows match no published version"
        np.testing.assert_array_equal(served[-1], forwards[-1])
    assert unit.runtime.recompiles_since_warmup() == 0
