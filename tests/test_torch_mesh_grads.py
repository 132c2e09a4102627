"""Gradients through the port's sharded forwards against ``jax.grad`` of
the JAX package's ``shard_map`` programs, and BERT served over "seq" x
"model" against JAX's runtime on the same mesh.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces; the port's side on mesh positions ``[torch.device("cpu")] * N``,
where a replicated result is one tensor shared by a group's positions: the
programs below read it once per group (``out_specs=P()``) and once per
position (``out_specs`` naming the axis), so a gradient counted once per
position would show. Inputs are numpy draws from a seed.

Tolerances: the collectives move and add float32 values, at rtol 1e-5 /
atol 1e-6; ring and Ulysses attention at rtol 1e-4 / atol 1e-5 (their
softmax partials combine in another order than JAX's scan); MoE at 1e-4 /
1e-6 (``tests/test_parallel.py``'s gradient tolerance); served BERT at
2e-4 / 2e-5 (JAX's ``test_bert_tp_sharded_matches_single_device``).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as JP

from seldon_core_tpu.models.base import ModelRuntime as JaxRuntime
from seldon_core_tpu.models.zoo import get_model as jax_get_model
from seldon_core_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from seldon_core_tpu.ops.ulysses import ulysses_attention as jax_ulysses_attention
from seldon_core_tpu.parallel.compat import shard_map
from seldon_core_tpu_torch.graph.spec import TpuSpec
from seldon_core_tpu_torch.models.convert import carry_params, tree_map
from seldon_core_tpu_torch.models.zoo import _moe_apply_factory, build_runtime_from_uri, get_model
from seldon_core_tpu_torch.ops.ring_attention import ring_attention
from seldon_core_tpu_torch.ops.ulysses import ulysses_attention
from seldon_core_tpu_torch.parallel import Mesh, place_params
from seldon_core_tpu_torch.parallel import collectives as col
from seldon_core_tpu_torch.parallel.mesh import gather_blocks
from seldon_core_tpu_torch.training.steps import data_split_apply, grad_mode, trainable_leaf

CPU = torch.device("cpu")
COL_TOL = dict(rtol=1e-5, atol=1e-6)
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
MOE_TOL = dict(rtol=1e-4, atol=1e-6)
BERT_TOL = dict(rtol=2e-4, atol=2e-5)


def _jax_mesh(axes):
    sizes = list(axes.values())
    return JaxMesh(np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes), tuple(axes))


def _mesh(axes):
    return Mesh(axes, [CPU] * int(np.prod(list(axes.values()))))


def _draw(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_grad(body, axes, in_spec, out_spec, x, c):
    """``jax.grad`` of sum(c * shard_map(body)(x)) on the virtual devices."""
    fn = shard_map(body, mesh=_jax_mesh(axes), in_specs=(in_spec,), out_specs=out_spec)
    return np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(jnp.asarray(c) * fn(a))))(jnp.asarray(x)))


def _port_grad(program, x, c):
    """The gradient of sum(c * program(x)) through the port's collectives."""
    t = torch.from_numpy(x.copy()).requires_grad_(True)
    (torch.from_numpy(c) * program(t)).sum().backward()
    return t.grad.numpy()


# ------------------------------------------------------------ collectives

AXES = {"data": 2, "expert": 4}
SPLIT = {"data": 0, "expert": 1}


@pytest.mark.parametrize("read", ["once_per_group", "every_position"])
def test_psum_gradient_matches_jax(read):
    """psum over "expert": read once per data group (out_specs P("data")),
    or every position's copy (P("data", "expert"))."""
    x, m = _draw((4, 8), 0), _mesh(AXES)
    if read == "once_per_group":
        c, out_spec, out_dims = _draw((4, 2), 1), JP("data"), {"data": 0}
    else:
        c, out_spec, out_dims = _draw((4, 8), 1), JP("data", "expert"), SPLIT
    want = _jax_grad(lambda a: lax.psum(a, "expert"), AXES, JP("data", "expert"), out_spec, x, c)
    got = _port_grad(lambda t: col.unshard(col.psum(col.shard(t, m, SPLIT), m, "expert"), m, out_dims, CPU), x, c)
    np.testing.assert_allclose(got, want, **COL_TOL)


@pytest.mark.parametrize("read", ["once_per_group", "every_position"])
def test_all_gather_gradient_matches_jax(read):
    """all_gather over "expert", every position's copy read, or only the
    first copy of each data group (JAX types the gathered value as varying,
    so its program reads the first block of P("data", "expert"))."""
    x, m = _draw((4, 8), 2), _mesh(AXES)
    width = 8 if read == "once_per_group" else 32
    c = _draw((4, width), 3)
    want = _jax_grad(lambda a: lax.all_gather(a, "expert", axis=1, tiled=True), AXES, JP("data", "expert"),
                     JP("data", "expert"), x, np.pad(c, ((0, 0), (0, 32 - width))))
    got = _port_grad(lambda t: col.unshard(col.all_gather(col.shard(t, m, SPLIT), m, "expert", dim=1), m, SPLIT,
                                           CPU)[:, :width], x, c)
    np.testing.assert_allclose(got, want, **COL_TOL)


def test_all_to_all_gradient_matches_jax():
    """[b, h, s, d] sequence-sharded to head-sharded, Ulysses' exchange."""
    axes, x = {"seq": 4}, _draw((2, 8, 16, 3), 4)
    c = _draw((2, 8, 16, 3), 5)
    m = _mesh(axes)
    want = _jax_grad(lambda a: lax.all_to_all(a, "seq", 1, 2, tiled=True), axes, JP(None, None, "seq"),
                     JP(None, "seq"), x, c)
    got = _port_grad(lambda t: col.unshard(col.all_to_all(col.shard(t, m, {"seq": 2}), m, "seq", 1, 2), m,
                                           {"seq": 1}, CPU), x, c)
    np.testing.assert_allclose(got, want, **COL_TOL)


@pytest.mark.parametrize("perm", [[(i, (i + 1) % 4) for i in range(4)], [(0, 1), (1, 2), (2, 3)]])
def test_ppermute_gradient_matches_jax(perm):
    """A ring shift, and the pipeline's open chain (position 0 receives
    zeros)."""
    axes, x, c = {"pipe": 4}, _draw((8, 3), 6), _draw((8, 3), 7)
    m = _mesh(axes)
    want = _jax_grad(lambda a: lax.ppermute(jnp.tanh(a), "pipe", perm), axes, JP("pipe"), JP("pipe"), x, c)
    got = _port_grad(lambda t: col.unshard(col.ppermute([torch.tanh(s) for s in col.shard(t, m, {"pipe": 0})], m,
                                                        "pipe", perm), m, {"pipe": 0}, CPU), x, c)
    np.testing.assert_allclose(got, want, **COL_TOL)


@pytest.mark.parametrize("combine", ["replicated", "per_unique"])
def test_replicated_compute_gradient_matches_jax(combine):
    """A value replicated over "expert", computed once per device in each
    group (``replicated``) or once per distinct input (``per_unique``),
    then each position's own product with its weight slab, psummed: the
    gradient reaches the input once, as in JAX's program."""
    x, w, c = _draw((4, 6), 8), _draw((6, 8), 9), _draw((4, 2), 10)
    m = _mesh(AXES)

    def body(a, wl):
        return lax.psum(jnp.tanh(a) @ wl, "expert")

    fn = shard_map(body, mesh=_jax_mesh(AXES), in_specs=(JP("data"), JP(None, "expert")), out_specs=JP("data"))
    want_x, want_w = jax.jit(jax.grad(lambda a, b: jnp.sum(jnp.asarray(c) * fn(a, b)), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = torch.from_numpy(x.copy()).requires_grad_(True), torch.from_numpy(w.copy()).requires_grad_(True)
    xs, ws = col.shard(xt, m, {"data": 0}), col.shard(wt, m, {"expert": 1})
    if combine == "replicated":
        h = col.replicated(torch.tanh, m, "expert", xs)
    else:
        h = col.per_unique(torch.tanh, xs)
    out = col.psum([a @ b for a, b in zip(h, ws)], m, "expert")
    (torch.from_numpy(c) * col.unshard(out, m, {"data": 0}, CPU)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **COL_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_w), **COL_TOL)


def test_shard_and_unshard_gradients_are_the_identity_blocks():
    """shard then a per-position map then unshard: the gradient of each
    block is its own, as shard_map's in and out specs give it."""
    axes = {"data": 2, "seq": 4}
    x, c, m = _draw((4, 8, 2), 11), _draw((4, 8, 2), 12), _mesh(axes)
    want = _jax_grad(lambda a: jnp.sin(a) * 2.0, axes, JP("data", "seq"), JP("data", "seq"), x, c)
    got = _port_grad(lambda t: col.unshard([torch.sin(b) * 2.0 for b in col.shard(t, m, {"data": 0, "seq": 1})],
                                           m, {"data": 0, "seq": 1}, CPU), x, c)
    np.testing.assert_allclose(got, want, **COL_TOL)


# ------------------------------------------------------ ring and Ulysses


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_gradients_match_jax(strategy, causal):
    """q, k and v gradients of sum(c * attention) over 4 "seq" positions,
    against ``jax.grad`` through JAX's ring and Ulysses ``shard_map``s."""
    shape = (2, 4, 32, 8)
    q, k, v, c = (_draw(shape, s) for s in (20, 21, 22, 23))
    jfn = jax_ring_attention if strategy == "ring" else jax_ulysses_attention
    fn = ring_attention if strategy == "ring" else ulysses_attention
    jmesh, m = _jax_mesh({"seq": 4}), _mesh({"seq": 4})
    want = jax.jit(jax.grad(lambda a, b, d: jnp.sum(jnp.asarray(c) * jfn(a, b, d, jmesh, causal=causal)),
                            argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (q, k, v)]
    (torch.from_numpy(c) * fn(*ts, m, causal=causal)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **ATTN_TOL)


# ------------------------------------------------------------------- MoE


def test_moe_gradients_over_the_expert_axis_match_jax():
    """``moe_mlp`` over {"data": 2, "expert": 2} (4 experts, a slab of 2 per
    position, the gate-weighted psum over "expert"): the gradient of the
    fine-tuning loss (JAX ``models/online.py:74-78``) on every leaf, the
    gate's included, against ``jax.grad`` through JAX's apply with its
    parameters sharded by ``moe_pspecs`` on the same mesh."""
    jms = jax_get_model("moe_mlp", n_experts=4)
    ms = get_model("moe_mlp", n_experts=4)
    params = carry_params(ms.params, jax.tree.map(np.asarray, jms.params))
    rng = np.random.default_rng(30)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    y = rng.integers(0, 3, (6,))
    axes = {"data": 2, "expert": 2}
    jmesh = _jax_mesh(axes)
    shardings = jax.tree.map(lambda s: NamedSharding(jmesh, s), jms.param_pspecs, is_leaf=lambda s: isinstance(s, JP))

    def loss(p):
        probs = jms.apply_fn(p, jnp.asarray(x))
        return -jnp.mean(jnp.take_along_axis(jnp.log(probs + 1e-9), jnp.asarray(y)[:, None], axis=-1))

    want = jax.jit(jax.grad(loss))(jax.device_put(jax.tree.map(jnp.asarray, jms.params), shardings))

    m = _mesh(axes)
    placed = place_params(params, ms.param_pspecs, m, lambda a, dev: trainable_leaf(a, dev))
    assert placed[1]["moe"]["w1"].shape[0] == 2 and placed[1]["moe"]["gate"] is placed[0]["moe"]["gate"]
    with grad_mode():
        probs = data_split_apply(_moe_apply_factory(m), placed, torch.from_numpy(x), m)
        loss_t = -torch.log(probs + 1e-9).gather(-1, torch.from_numpy(y)[:, None]).mean()
        loss_t.backward()
    got = gather_blocks(placed, lambda t: t.grad)
    flat_want = []
    tree_map(lambda a: flat_want.append(a), {k: {kk: np.asarray(want[k][kk]) for kk in params[k]} for k in params})
    assert len(got) == len(flat_want) == 9
    for g, w in zip(got, flat_want):
        np.testing.assert_allclose(g.numpy(), w, **MOE_TOL)


# ----------------------------------------------------- BERT, seq x model


@pytest.mark.parametrize("strategy,kw", [("ring", {}), ("ulysses", {"hidden": 256, "ffn": 512})])
def test_bert_over_seq_and_model_serves_like_jax(strategy, kw):
    """``bert_tiny`` over {"seq": 2, "model": 2}: each position its sequence
    block and its heads (ring: 1 head per model position; Ulysses: 4 heads,
    2 per model position, split again over "seq"), against JAX's runtime on
    the same mesh: for Ulysses with JAX's ``_bert_apply_factory``; JAX's
    ring ``shard_map`` refuses a mesh with a "model" axis (its out_specs
    replication check), so for ring its runtime serves the single-device
    apply sharded by GSPMD from ``bert_pspecs``, the same function."""
    query = "&".join([f"seq_parallel={strategy}", "seq=32", "max_len=32", *(f"{k}={v}" for k, v in kw.items())])
    axes = {"seq": 2, "model": 2}
    jmesh = _jax_mesh(axes)
    jms = jax_get_model("bert_tiny", max_len=32, seq_parallel=strategy, **kw)
    ids = np.random.default_rng(31).integers(0, 1024, (4, 32)).astype(np.float32)
    apply = jms.apply_factory(jmesh) if strategy == "ulysses" else jms.apply_fn
    want = JaxRuntime(apply, jms.params, mesh=jmesh, param_pspecs=jms.param_pspecs, buckets=(4,), max_batch=4,
                      dtype=jnp.float32, donate=False).predict(ids)
    rt = build_runtime_from_uri(f"zoo://bert_tiny?{query}", TpuSpec(batch_buckets=[4], max_batch=4), CPU,
                                mesh=_mesh(axes))
    assert rt.apply_fn.name == f"bert_{strategy}_tp"
    assert rt.params[3]["layers"][0]["qkv"]["w"].shape[1] == 3 * rt.params[0]["ln_emb"]["scale"].shape[0] // 2
    np.testing.assert_allclose(rt.predict(ids), np.asarray(want), **BERT_TOL)
    if strategy == "ring":
        with pytest.raises(ValueError, match="replicat"):
            jax.jit(partial(jax_ring_attention, mesh=jmesh))(*(jnp.zeros((1, 2, 32, 8)),) * 3)


# ------------------------------------------------ copies on distinct devices


def test_copies_of_a_block_on_distinct_devices_take_one_update():
    """On two cards ``place_params`` gives each data index its own copy of
    a block that one card would share: emulated here by cloning data index
    1's tensors on the CPU. After a step every copy took the sum of the
    copies' gradients (``sum_replica_grads``) and the same update, and the
    parameters are those of the shared placement."""
    from seldon_core_tpu_torch.models.bert import bert_logits_factory, bert_pspecs, init_bert
    from seldon_core_tpu_torch.parallel.mesh import PositionParams, unique_tensors
    from seldon_core_tpu_torch.training.steps import TrainState, make_sharded_train_step, sgd

    params = init_bert(2, vocab=64, hidden=128, layers=1, ffn=128, max_len=16, num_classes=2)
    rng = np.random.default_rng(40)
    batch = {"x": rng.integers(0, 64, (4, 16)).astype(np.int32), "y": rng.integers(0, 2, (4,)).astype(np.int32)}
    m = _mesh({"data": 2, "model": 2})
    step, shared, _ = make_sharded_train_step(bert_logits_factory(m), sgd(0.1), m, bert_pspecs(params),
                                              init_params=params)
    _, base, _ = make_sharded_train_step(bert_logits_factory(m), sgd(0.1), m, bert_pspecs(params), init_params=params)
    clones: dict = {}
    trees = [tree if m.coord(p, "data") == 0 else
             tree_map(lambda t: clones.setdefault(id(t), t.detach().clone().requires_grad_(True)), tree)
             for p, tree in enumerate(base.params)]
    copied = PositionParams(trees, base.params.keys)
    assert len(unique_tensors(copied)) > len(unique_tensors(shared.params))
    copied = TrainState(copied, sgd(0.1)(unique_tensors(copied)), 0)
    shared, _ = step(shared, batch)
    copied, _ = step(copied, batch)
    for p in range(m.size):
        for a, b in zip(tree_leaves_of(copied.params[p]), tree_leaves_of(shared.params[p])):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6, atol=1e-7)
    first, second = copied.params[0]["tok_emb"], copied.params[2]["tok_emb"]
    assert first is not second and torch.equal(first.grad, second.grad) and torch.equal(first, second)


def tree_leaves_of(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out
