"""Training over the mesh in the port against the JAX package: the sharded
train step, the pipeline's backward, and ``finetune: true`` units served
over "seq" x "model", "pipe" and "expert" meshes.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces; the port's side on mesh positions ``[torch.device("cpu")] * N``.
Inputs are numpy draws from a seed, shared by both; ``moe_mlp`` and
``pipe_mlp`` serve the JAX build's parameters (``carry_params``).

Tolerances:

- the first step's gradients at rtol 1e-4 / atol 1e-6 and the pipeline's
  gradients at the same (``tests/test_parallel.py::
  test_pipeline_gradients_match_sequential``);
- each step's loss at rtol 1e-4: the sharded forward sums in another order
  (ring attention's online softmax, the psums) and AdamW carries that into
  the next step's loss (measured 5e-5 at the third step);
- parameters after the steps, sharded against unsharded: Adam moves a
  leaf by about lr a step whatever its gradient's size, so an element whose
  gradient is near 0 may step the other way in the other summation order.
  Every element within 2 x lr x steps, and at most 0.5% of them beyond 1e-5
  (measured: 133 of 110338 beyond 1e-5, the largest 5.5e-3, lr 5e-3, 5
  steps);
- served answers before fine-tuning within 2e-4 / 2e-5 (BERT, JAX's
  ``test_bert_tp_sharded_matches_single_device``) and 2e-5 / 2e-6 (MoE and
  the pipeline, ``tests/test_parallel.py``); after Adam steps, within 2e-4
  / 2e-5 for every model, for the reason above (the pipeline measured
  3.3e-6 on an answer of 0.058 after two steps at lr 0.05).
"""

import copy
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh as JaxMesh, PartitionSpec as JP

from seldon_core_tpu.core.codec_json import feedback_from_dict as jax_feedback
from seldon_core_tpu.graph.spec import SeldonDeployment as JaxSeldonDeployment
from seldon_core_tpu.models.bert import bert_logits as jax_bert_logits
from seldon_core_tpu.models.bert import bert_pspecs as jax_bert_pspecs
from seldon_core_tpu.models.online import OnlineFinetuneModelUnit as JaxOnlineUnit
from seldon_core_tpu.models.zoo import get_model as jax_get_model
from seldon_core_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from seldon_core_tpu.training.steps import cross_entropy as jax_cross_entropy
from seldon_core_tpu.training.steps import make_sharded_train_step as jax_make_sharded_train_step
from seldon_core_tpu_torch.core.codec_json import feedback_from_dict, message_from_dict
from seldon_core_tpu_torch.graph.defaulting import default_deployment
from seldon_core_tpu_torch.graph.spec import SeldonDeployment
from seldon_core_tpu_torch.models import zoo
from seldon_core_tpu_torch.models.bert import bert_logits, bert_logits_factory, bert_pspecs, init_bert
from seldon_core_tpu_torch.models.convert import carry_params, tree_map
from seldon_core_tpu_torch.models.online import OnlineFinetuneModelUnit
from seldon_core_tpu_torch.parallel import Mesh, P, gather_params
from seldon_core_tpu_torch.parallel.mesh import gather_blocks
from seldon_core_tpu_torch.parallel.pipeline import pipeline_apply
from seldon_core_tpu_torch.serving.server import PredictorServer
from seldon_core_tpu_torch.training.steps import (
    adamw,
    init_state,
    make_sharded_train_step,
    make_train_step,
    shard_state,
    tree_leaves,
)

CPU = torch.device("cpu")
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-4
BERT_TOL = dict(rtol=2e-4, atol=2e-5)
SMALL_TOL = dict(rtol=2e-5, atol=2e-6)


def _jax_mesh(axes):
    sizes = list(axes.values())
    return JaxMesh(np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes), tuple(axes))


def _mesh(axes):
    return Mesh(axes, [CPU] * int(np.prod(list(axes.values()))))


def _leaves_like(own, other) -> list:
    """``other``'s leaves (a JAX tree: dicts rebuilt in sorted key order) in
    the order of ``own``'s tree."""
    if isinstance(own, dict):
        return [x for k in own for x in _leaves_like(own[k], other[k])]
    if isinstance(own, (list, tuple)):
        return [x for a, b in zip(own, other) for x in _leaves_like(a, b)]
    return [np.asarray(other)]


def _hold_params(got: list, want: list, lr: float, steps: int) -> None:
    """Parameters of two summation orders after ``steps`` Adam steps: every
    element within 2 x lr x steps, at most 0.5% of them beyond 1e-5."""
    beyond, total = 0, 0
    for g, w in zip(got, want):
        d = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        assert d.max() <= 2 * lr * steps, d.max()
        beyond += int((d > 1e-5).sum())
        total += d.size
    assert beyond <= 0.005 * total, (beyond, total)


def _hold_updates(got, want, init, rtol=0.25):
    """Per leaf, the update ``got - init`` within ``rtol`` of ``want - init``
    in norm, whatever the rate: a state that never moved reads 1.0. Not 0:
    the key third of a qkv bias has a gradient that is 0 but for rounding
    (softmax ignores a shift common to every key), and Adam steps it by
    about lr on that noise, which another summation order draws otherwise
    (0.096 here against the unsharded step; every other leaf under 1e-4)."""
    for g, w, p0 in zip(got, want, init):
        g, w, p0 = (np.asarray(a, np.float64) for a in (g, w, p0))
        assert np.linalg.norm(g - w) <= rtol * np.linalg.norm(w - p0), (np.linalg.norm(g - w), np.linalg.norm(w - p0))


# ------------------------------------------------------- the sharded step


def _bert_batch():
    params = init_bert(0, vocab=64, hidden=128, layers=1, ffn=128, max_len=16, num_classes=2)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 64, (4, 16)).astype(np.int32)
    y = rng.integers(0, 2, (4,)).astype(np.int32)
    return params, x, y


def test_sharded_train_step_matches_jax_and_the_loss_decreases():
    """The twin of JAX's ``test_sharded_train_step_loss_decreases``: BERT on
    a ("data", "seq", "model") 2x2x2 mesh, AdamW 5e-3, the batch split over
    data and seq. The first step's gradients equal ``jax.grad`` of JAX's
    loss on the same batch, every step's loss JAX's sharded step's, the
    loss falls and the step count is 5; the gathered parameters after the
    steps are the port's unsharded step's."""
    params, x, y = _bert_batch()
    axes = {"data": 2, "seq": 2, "model": 2}
    jitted, jstate, jbatch = jax_make_sharded_train_step(
        jax_bert_logits, optax.adamw(5e-3), _jax_mesh(axes), jax_bert_pspecs(params),
        batch_pspec=JP("data", "seq"), init_params=params)
    jx, jy = jax.device_put(jnp.asarray(x), jbatch["x"]), jax.device_put(jnp.asarray(y), jbatch["y"])
    want_losses = []
    for _ in range(5):
        jstate, metrics = jitted(jstate, {"x": jx, "y": jy})
        want_losses.append(float(metrics["loss"]))
    want_grads = jax.jit(jax.grad(lambda p: jax_cross_entropy(jax_bert_logits(p, jnp.asarray(x)), jnp.asarray(y))))(
        jax.tree.map(jnp.asarray, params))

    mesh = _mesh(axes)
    step, state, placement = make_sharded_train_step(
        bert_logits_factory(mesh), adamw(5e-3), mesh, bert_pspecs(params),
        batch_pspec=P("data", "seq"), init_params=params)
    assert placement["x"].dims == {"data": 0, "seq": 1}
    assert state.params[0]["layers"][0]["qkv"]["w"].shape == (128, 192)
    losses = []
    for i in range(5):
        state, metrics = step(state, {"x": x, "y": y})
        losses.append(float(metrics["loss"]))
        if i == 0:
            grads = gather_blocks(state.params, lambda t: t.grad)
            for g, w in zip(grads, _leaves_like(params, want_grads)):
                np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0], losses
    assert state.step == 5

    flat, flat_step = init_state(params, adamw(5e-3)), make_train_step(bert_logits)
    for _ in range(5):
        flat, _ = flat_step(flat, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    got, init = [t.numpy() for t in tree_leaves(gather_params(state.params))], tree_leaves(params)
    for want in ([t.detach().numpy() for t in tree_leaves(flat.params)], _leaves_like(params, jstate.params)):
        _hold_params(got, want, 5e-3, 5)
        _hold_updates(got, want, init)
    with pytest.raises(AssertionError):  # the check reads a state that never moved
        _hold_updates(init, got, init)


@pytest.mark.parametrize("axes,batch_pspec,strategy", [
    ({"data": 2, "seq": 2}, P("data", "seq"), "ring"),
    ({"seq": 2, "model": 2}, P(None, "seq"), "ulysses"),
    ({"data": 2, "model": 2}, P("data"), "ring"),
])
def test_sharded_step_first_gradients_match_jax_grad(axes, batch_pspec, strategy):
    """Other meshes and Ulysses (4 heads: 2 per model position divide the
    seq axis): the first step's gradients equal ``jax.grad`` of the same
    loss on one device, and the loss is the global batch's mean."""
    params = init_bert(1, vocab=64, hidden=256, layers=1, ffn=128, max_len=16, num_classes=3)
    rng = np.random.default_rng(1)
    x, y = rng.integers(0, 64, (4, 16)).astype(np.int32), rng.integers(0, 3, (4,)).astype(np.int32)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_cross_entropy(jax_bert_logits(p, jnp.asarray(x)), jnp.asarray(y))))(
        jax.tree.map(jnp.asarray, params))
    mesh = _mesh(axes)
    step, state, _ = make_sharded_train_step(
        bert_logits_factory(mesh, strategy, num_heads=4), adamw(1e-3), mesh,
        bert_pspecs(params), batch_pspec=batch_pspec, init_params=params)
    state, metrics = step(state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    assert float(metrics["loss"]) == pytest.approx(float(want_loss), rel=1e-5)
    for g, w in zip(gather_blocks(state.params, lambda t: t.grad), _leaves_like(params, want_grads)):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


def test_sharded_step_refuses_a_batch_split_its_apply_does_not_take():
    params, x, y = _bert_batch()
    mesh = _mesh({"data": 2, "seq": 2})
    with pytest.raises(ValueError, match="takes its input split as"):
        make_sharded_train_step(bert_logits_factory(mesh), adamw(1e-3), mesh, bert_pspecs(params),
                                batch_pspec=P("data"), init_params=params)


def test_a_mesh_of_one_position_keeps_the_single_device_step():
    """``logits_fn`` stays a single-device function where the mesh has one
    position: the step is ``make_train_step``'s, on that position's device."""
    params, x, y = _bert_batch()
    step, state, placement = make_sharded_train_step(bert_logits, adamw(5e-3), Mesh({"data": 1}, [CPU]), None,
                                                     init_params=params)
    flat, flat_step = init_state(params, adamw(5e-3)), make_train_step(bert_logits)
    for _ in range(2):
        state, got = step(state, {"x": placement["x"](x), "y": placement["y"](y)})
        flat, want = flat_step(flat, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
        assert float(got["loss"]) == float(want["loss"])


def test_shard_state_places_the_moments_beside_their_blocks():
    """A state that took a step, then placed: each block's Adam moments are
    the cut of the full ones, and its next step gives the unsharded next
    step's parameters."""
    params, x, y = _bert_batch()
    flat, flat_step = init_state(params, adamw(5e-3)), make_train_step(bert_logits)
    flat, _ = flat_step(flat, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    mesh = _mesh({"data": 2, "model": 2})
    placed, specs = shard_state(flat, mesh, bert_pspecs(params))
    assert specs is not None and placed.step == 1
    qkv = placed.params[1]["layers"][0]["qkv"]["w"]
    moment = placed.optimizer.state[qkv]["exp_avg"]
    full = flat.optimizer.state[flat.params["layers"][0]["qkv"]["w"]]["exp_avg"]
    cols = np.concatenate([np.arange(s * 128 + 64, s * 128 + 128) for s in range(3)])
    np.testing.assert_array_equal(moment.numpy(), full.numpy()[:, cols])
    step, _, _ = make_sharded_train_step(bert_logits_factory(mesh), adamw(5e-3), mesh, bert_pspecs(params),
                                         init_params=params)
    placed, _ = step(placed, {"x": x, "y": y})
    flat, _ = flat_step(flat, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    _hold_params([t.numpy() for t in tree_leaves(gather_params(placed.params))],
                 [t.detach().numpy() for t in tree_leaves(flat.params)], 5e-3, 1)


# ------------------------------------------------------- the pipeline


def _stage_fn_jax(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def test_pipeline_gradients_match_jax_and_sequential():
    """The twin of JAX's ``test_pipeline_gradients_match_sequential``: 4
    stages, d 8, 4 microbatches; the gradients of the mean square of the
    pipeline's output equal JAX's through its pipeline and the sequential
    stages', and a bubble tick adds nothing."""
    stages, d = 4, 8
    rng = np.random.default_rng(0)
    params = {"w": (rng.standard_normal((stages, d, d)) * 0.3).astype(np.float32),
              "b": (rng.standard_normal((stages, d)) * 0.1).astype(np.float32)}
    x = np.random.default_rng(2).standard_normal((4, 2, d)).astype(np.float32)
    jmesh = JaxMesh(np.asarray(jax.devices()[:stages]), ("pipe",))
    want = jax.jit(jax.grad(lambda p: jnp.mean(jax_pipeline_apply(_stage_fn_jax, p, jnp.asarray(x), jmesh) ** 2)))(
        jax.tree.map(jnp.asarray, params))

    def sequential(p):
        outs = []
        for m in range(x.shape[0]):
            h = torch.from_numpy(x[m])
            for s in range(stages):
                h = _stage_fn(tree_map(lambda a, s=s: a[s], p), h)
            outs.append(h)
        return torch.stack(outs)

    got = {}
    for name, run in (("pipe", lambda p: pipeline_apply(_stage_fn, p, torch.from_numpy(x), _mesh({"pipe": stages}))),
                      ("seq", sequential)):
        p = tree_map(lambda a: torch.from_numpy(a.copy()).requires_grad_(True), params)
        (run(p) ** 2).mean().backward()
        got[name] = {k: v.grad.numpy() for k, v in p.items()}
    for k in ("w", "b"):
        np.testing.assert_allclose(got["pipe"][k], np.asarray(want[k]), **GRAD_TOL)
        np.testing.assert_allclose(got["pipe"][k], got["seq"][k], **GRAD_TOL)


# ------------------------------------------------------- finetune units


@pytest.fixture
def carried(monkeypatch):
    """The port's zoo builds moe_mlp and pipe_mlp with the JAX build's
    parameters (same kwargs), checked leaf for leaf."""
    for model in ("moe_mlp", "pipe_mlp"):
        build = zoo._REGISTRY[model]

        def built(build=build, model=model, **kwargs):
            spec = build(**kwargs)
            jms = jax_get_model(model, **{k: v for k, v in kwargs.items() if isinstance(v, int)})
            return dataclasses.replace(spec, params=carry_params(spec.params, jax.tree.map(np.asarray, jms.params)))

        monkeypatch.setitem(zoo._REGISTRY, model, built)


def _finetune_dep(model: str, mesh: dict, params: list, batch: int, lr: float) -> dict:
    graph = {"name": "clf", "type": "MODEL", "implementation": "JAX_MODEL",
             "methods": ["TRANSFORM_INPUT", "SEND_FEEDBACK"], "parameters": [
        {"name": "model", "value": model, "type": "STRING"}, *params,
        {"name": "finetune", "value": "true", "type": "BOOL"},
        {"name": "finetune_batch", "value": str(batch), "type": "INT"},
        {"name": "finetune_lr", "value": str(lr), "type": "FLOAT"},
        {"name": "finetune_optimizer", "value": "adam", "type": "STRING"}]}
    return {"metadata": {"name": "ft"}, "spec": {"name": "ft", "predictors": [
        {"name": "p", "graph": graph, "tpu": {"mesh": mesh, "batch_buckets": [4], "max_batch": 4,
                                              "dtype": "float32"}}]}}


def _int(name, value):
    return {"name": name, "value": str(value), "type": "INT"}


FINETUNE_CASES = {
    # bert_tiny's 2 heads: one per model position, ring over "seq"
    "bert_tiny_seq_model": ("bert_tiny", {"seq": 2, "model": 2}, [_int("seq", 16)], "ids", 16, BERT_TOL,
                            "bert_ring_tp"),
    "pipe_mlp_pipe": ("pipe_mlp", {"pipe": 2}, [_int("stages", 2)], "float", 16, SMALL_TOL, "pipe_mlp"),
    "moe_mlp_data_expert": ("moe_mlp", {"data": 2, "expert": 2}, [_int("n_experts", 4)], "float", 16, SMALL_TOL,
                            "moe_mlp"),
}


def _rows(kind, rng, n, width):
    if kind == "ids":
        return rng.integers(0, 1024, (n, width)).astype(float).tolist()
    return rng.standard_normal((n, width)).round(3).tolist()


def _jax_unit(dep: dict, model: str, params: list, axes: dict):
    """JAX's ``OnlineFinetuneModelUnit`` over a JAX runtime on the same mesh:
    the model's apply factory there (``moe_mlp`` has none: GSPMD shards its
    single-device apply by its specs), except BERT's, whose ring ``shard_map``
    JAX refuses on a mesh with a "model" axis (its out_specs replication
    check): BERT takes its single-device apply, sharded by GSPMD from
    ``bert_pspecs``, the same function."""
    from seldon_core_tpu.models.base import ModelRuntime as JaxRuntime

    spec = JaxSeldonDeployment.model_validate(copy.deepcopy(dep)).spec.predictors[0].graph
    jms = jax_get_model(model, **{p["name"]: int(p["value"]) for p in params})
    jmesh = _jax_mesh(axes)
    factory = None if model.startswith("bert") else jms.apply_factory
    apply = factory(jmesh) if factory is not None else jms.apply_fn
    rt = JaxRuntime(apply, jms.params, mesh=jmesh, param_pspecs=jms.param_pspecs, buckets=(4,), max_batch=4,
                    dtype=jnp.float32, donate=False)
    return JaxOnlineUnit(spec, rt), jms.apply_fn


@pytest.mark.parametrize("name", sorted(FINETUNE_CASES))
async def test_a_finetune_unit_trains_over_its_mesh_like_jax(name, carried):
    """A ``finetune: true`` unit served over its mesh takes the same feedback
    as JAX's unit over the same mesh (2 steps of Adam at batch 4, fed 3 rows
    at a time): the same answers before, and after each feedback the
    answers of JAX's learned parameters (read through its single-device
    apply: JAX's serving jit refuses the shardings its own step hands back
    on the expert mesh), the answers moved, no new capture after warmup; a
    snapshot of the mesh unit restores into a one-device unit that answers
    the same, and both go on learning alike."""
    model, axes, params, kind, width, tol, apply_name = FINETUNE_CASES[name]
    dep = _finetune_dep(model, axes, params, batch=4, lr=0.05 if kind == "float" else 0.01)
    pred = default_deployment(SeldonDeployment.from_dict(copy.deepcopy(dep)), n_devices=1).spec.predictors[0]
    srv = PredictorServer(pred, enable_batching=False, device="cpu", mesh_devices=[CPU] * int(np.prod(list(axes.values()))))
    srv.warmup()
    junit, japply = _jax_unit(dep, model, params, axes)
    unit = {u.name: u for u in srv.executor.units()}["clf"]
    assert isinstance(unit, OnlineFinetuneModelUnit)
    rt = unit.runtime
    assert rt.mesh.shape == axes and rt.apply_fn.name == apply_name
    rng = np.random.default_rng(23)
    rows = _rows(kind, rng, 4, width)
    probe = {"data": {"ndarray": rows}}
    jx = jnp.asarray(np.asarray(rows), jnp.int32 if kind == "ids" else jnp.float32)

    async def served():
        return np.asarray((await srv.executor.execute(message_from_dict(probe))).array)

    before = await served()
    np.testing.assert_allclose(before, junit.runtime.predict(np.asarray(rows, np.float32)), **tol)
    for _ in range(3):
        fb = {"request": {"data": {"ndarray": _rows(kind, rng, 3, width)}}, "response": {}, "reward": 1.0,
              "truth": {"data": {"ndarray": rng.integers(0, 2, (3, 1)).tolist()}}}
        await junit.send_feedback(jax_feedback(fb), 0)
        await srv.executor.send_feedback(feedback_from_dict(fb))
        after = await served()
        np.testing.assert_allclose(after, np.asarray(japply(jax.tree.map(np.asarray, junit.runtime.params), jx)),
                                   **BERT_TOL)
    assert unit._steps_taken == junit._steps_taken == 2
    assert np.abs(after - before).max() > 1e-4
    assert rt.recompiles_since_warmup() == 0

    snap = pickle.loads(pickle.dumps(unit.__getstate__()))
    one_dep = copy.deepcopy(dep)
    one_dep["spec"]["predictors"][0]["tpu"]["mesh"] = {"data": 1}
    one = PredictorServer(default_deployment(SeldonDeployment.from_dict(one_dep), n_devices=1).spec.predictors[0],
                          enable_batching=False, device="cpu")
    one_unit = {u.name: u for u in one.executor.units()}["clf"]
    assert one_unit.runtime.mesh is None
    one_unit.__setstate__(snap)
    np.testing.assert_allclose(np.asarray((await one.executor.execute(message_from_dict(probe))).array), after,
                               **BERT_TOL)
    # one more step on each, from the restored moments, then the one-device
    # unit's snapshot back onto the mesh unit
    fb = {"request": {"data": {"ndarray": _rows(kind, rng, 4, width)}}, "response": {}, "reward": 1.0,
          "truth": {"data": {"ndarray": [[1]] * 4}}}
    await one.executor.send_feedback(feedback_from_dict(fb))
    await srv.executor.send_feedback(feedback_from_dict(fb))
    np.testing.assert_allclose(await served(),
                               np.asarray((await one.executor.execute(message_from_dict(probe))).array), **BERT_TOL)
    unit.__setstate__(one_unit.__getstate__())
    assert unit._steps_taken == one_unit._steps_taken == 3
