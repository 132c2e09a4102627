"""The port's mesh, collectives, pipeline and MoE against the JAX package.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces; the port's side on mesh positions ``[torch.device("cpu")] * N``.
Inputs are numpy draws from a seed, shared by both. Tolerances are those of
the JAX tests each one mirrors (``tests/test_parallel.py``): the pipeline at
rtol 1e-5 / atol 1e-6, MoE at 2e-5 / 2e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as JP

from seldon_core_tpu.ops import moe as jmoe
from seldon_core_tpu.parallel.mesh import mesh_from_spec as jax_mesh_from_spec
from seldon_core_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from seldon_core_tpu_torch.models.convert import params_to_torch, tree_map
from seldon_core_tpu_torch.ops import moe
from seldon_core_tpu_torch.parallel import Mesh, P, Packed, mesh_from_spec, place_params
from seldon_core_tpu_torch.parallel import collectives as col
from seldon_core_tpu_torch.parallel.pipeline import pipeline_apply

CPU = torch.device("cpu")


def _positions(n):
    return [CPU] * n


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ------------------------------------------------------------------ the mesh


@pytest.mark.parametrize("axes,n", [
    ({"data": 8}, 8), ({"data": 2, "seq": 4}, 8), ({"data": 4, "model": 2}, 4), ({"data": 2, "expert": 4}, 8),
    ({"pipe": 4}, 8), ({"data": 1}, 8), ({"data": 8}, 2), ({}, 8),
])
def test_mesh_from_spec_matches_jax(axes, n):
    """Same axes and device count: the same shape (the data axis shrinks
    where it divides), or None where one device is asked for."""
    want = jax_mesh_from_spec(axes, jax.devices()[:n])
    got = mesh_from_spec(axes, _positions(n))
    if want is None:
        assert got is None
        return
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.size == want.devices.size
    assert got.n_devices == 1  # every position on the one CPU device


@pytest.mark.parametrize("axes,n", [({"model": 4}, 2), ({"data": 3, "seq": 4}, 8), ({"pipe": 4}, 2)])
def test_mesh_refusal_matches_jax(axes, n):
    with pytest.raises(ValueError) as want:
        jax_mesh_from_spec(axes, jax.devices()[:n])
    with pytest.raises(ValueError) as got:
        mesh_from_spec(axes, _positions(n))
    assert str(got.value) == str(want.value)


def test_mesh_attributes_say_when_forwards_run_eagerly():
    """Positions on one device serve captured; positions over two cards run
    every forward eagerly, and the spans' mesh attributes say so."""
    one = Mesh({"data": 2, "seq": 2}, _positions(4)).describe()
    assert one == {"mesh": "data=2,seq=2", "mesh_positions": 4, "mesh_devices": 1, "mesh_eager": False}
    two = Mesh({"data": 2, "seq": 2}, [torch.device("cuda", i % 2) for i in range(4)]).describe()
    assert two["mesh_devices"] == 2 and two["mesh_eager"] is True

def test_mesh_coordinates_are_row_major():
    """Position p of {"data": 2, "seq": 4} is (p // 4, p % 4), as the JAX
    mesh reshapes its device list."""
    m = Mesh({"data": 2, "seq": 4}, _positions(8))
    assert [(m.coord(p, "data"), m.coord(p, "seq")) for p in range(8)] == [(p // 4, p % 4) for p in range(8)]
    assert m.groups("seq") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert m.groups("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert m.leads("data") == [0, 4]
    assert m == Mesh({"data": 2, "seq": 4}, _positions(8)) and hash(m) == hash(Mesh({"data": 2, "seq": 4},
                                                                                    _positions(8)))


def test_place_params_shards_and_shares_replicas():
    """A sharded leaf's blocks per position; a replicated leaf one tensor
    shared by every position on the device; a Packed dimension split per
    slab; an axis the mesh lacks dropped to replicated."""
    m = Mesh({"data": 2, "model": 2}, _positions(4))
    w = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)  # packed of 3 slabs of 2 columns
    tree = {"rep": np.ones(3, np.float32), "col": w, "packed": w, "missing": w}
    specs = {"rep": P(), "col": P(None, "model"), "packed": P(None, Packed("model", 3)), "missing": P("seq")}
    placed = place_params(tree, specs, m, lambda a, dev: params_to_torch(a, dev))
    assert all(pp["rep"] is placed[0]["rep"] for pp in placed)
    for p, pp in enumerate(placed):
        i = m.coord(p, "model")
        np.testing.assert_array_equal(pp["col"].numpy(), w[:, 3 * i:3 * i + 3])
        np.testing.assert_array_equal(pp["packed"].numpy(), w[:, [2 * s + i for s in range(3)]])
        assert pp["missing"].shape == (4, 6)


# ------------------------------------------------------------ the collectives


def _shards(n, shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def test_psum_matches_numpy():
    m = Mesh({"data": 2, "expert": 4}, _positions(8))
    xs = _shards(8, (3, 5))
    got = col.psum([_t(x) for x in xs], m, "expert")
    for p in range(8):
        group = m.groups("expert")[m.coord(p, "data")]
        np.testing.assert_allclose(got[p].numpy(), np.sum([xs[q] for q in group], axis=0), rtol=1e-6, atol=1e-6)


def test_all_gather_matches_numpy():
    m = Mesh({"seq": 4}, _positions(4))
    xs = _shards(4, (2, 3))
    got = col.all_gather([_t(x) for x in xs], m, "seq", dim=1)
    for p in range(4):
        np.testing.assert_array_equal(got[p].numpy(), np.concatenate(xs, axis=1))


def test_all_to_all_matches_numpy():
    """Member j receives chunk j of every member along the split dim,
    concatenated in member order: lax.all_to_all(tiled=True)."""
    n = 4
    m = Mesh({"seq": n}, _positions(n))
    xs = _shards(n, (2, 8, 3, 5))
    got = col.all_to_all([_t(x) for x in xs], m, "seq", split_dim=1, concat_dim=2)
    for j in range(n):
        want = np.concatenate([np.split(xs[i], n, axis=1)[j] for i in range(n)], axis=2)
        np.testing.assert_array_equal(got[j].numpy(), want)


def test_ppermute_matches_numpy():
    n = 4
    m = Mesh({"pipe": n}, _positions(n))
    xs = _shards(n, (3,))
    got = col.ppermute([_t(x) for x in xs], m, "pipe", [(i, i + 1) for i in range(n - 1)])
    np.testing.assert_array_equal(got[0].numpy(), np.zeros(3, np.float32))
    for i in range(1, n):
        np.testing.assert_array_equal(got[i].numpy(), xs[i - 1])


def test_shard_and_unshard_round_trip():
    m = Mesh({"data": 2, "seq": 4}, _positions(8))
    x = _t(np.random.default_rng(1).standard_normal((4, 3, 16, 2)))
    blocks = col.shard(x, m, {"data": 0, "seq": 2})
    assert blocks[5].shape == (2, 3, 4, 2)
    np.testing.assert_array_equal(blocks[5].numpy(), x[2:4, :, 4:8].numpy())
    np.testing.assert_array_equal(col.unshard(blocks, m, {"data": 0, "seq": 2}, CPU).numpy(), x.numpy())


# --------------------------------------------------------------- the pipeline


def _stage_fn_jax(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _stage_params(stages, d, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((stages, d, d)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((stages, d)) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("stages,micro", [(2, 3), (4, 4), (8, 2)])
def test_pipeline_matches_jax(stages, micro):
    d = 8
    params = _stage_params(stages, d)
    x = np.random.default_rng(1).standard_normal((micro, 2, d)).astype(np.float32)
    jmesh = JaxMesh(np.asarray(jax.devices()[:stages]), ("pipe",))
    want = np.asarray(jax_pipeline_apply(_stage_fn_jax, jax.tree.map(jnp.asarray, params), jnp.asarray(x), jmesh))
    got = pipeline_apply(_stage_fn, tree_map(_t, params), _t(x), Mesh({"pipe": stages}, _positions(stages)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_pipeline_refuses_a_stacked_axis_other_than_the_pipe():
    params = tree_map(_t, _stage_params(3, 4))
    with pytest.raises(ValueError, match="stacked axis is 3 but mesh 'pipe' axis has 4 devices"):
        pipeline_apply(_stage_fn, params, torch.zeros(2, 1, 4), Mesh({"pipe": 4}, _positions(4)))
    jmesh = JaxMesh(np.asarray(jax.devices()[:4]), ("pipe",))
    with pytest.raises(ValueError, match="stacked axis is 3 but mesh 'pipe' axis has 4 devices"):
        jax_pipeline_apply(_stage_fn_jax, jax.tree.map(jnp.asarray, _stage_params(3, 4)), jnp.zeros((2, 1, 4)),
                           jmesh)


# ---------------------------------------------------------------------- MoE


def test_init_moe_is_the_jax_draw():
    ours, theirs = moe.init_moe(3, 16, 32, 8), jmoe.init_moe(3, 16, 32, 8)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]))


def test_moe_ffn_sharded_matches_jax_sharded_and_dense():
    """{"data": 2, "expert": 4}: each position holds a [E/4, d, f] slab of
    w1, and the sharded result equals JAX's expert-sharded jit and its
    dense result."""
    d_model, d_ff, n_experts = 16, 32, 8
    params = moe.init_moe(0, d_model, d_ff, n_experts)
    x = np.random.default_rng(3).standard_normal((2, 4, d_model)).astype(np.float32)

    jparams = jax.tree.map(jnp.asarray, params)
    dense = np.asarray(jmoe.moe_ffn(jparams, jnp.asarray(x)))
    jmesh = JaxMesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "expert"))
    shardings = jax.tree.map(lambda s: NamedSharding(jmesh, s), jmoe.moe_pspecs("expert"),
                             is_leaf=lambda v: isinstance(v, JP))
    sharded = np.asarray(jax.jit(jmoe.moe_ffn)(jax.device_put(jparams, shardings),
                                               jax.device_put(jnp.asarray(x), NamedSharding(jmesh, JP()))))

    m = Mesh({"data": 2, "expert": 4}, _positions(8))
    placed = place_params(params, moe.moe_pspecs(), m, lambda a, dev: params_to_torch(a, dev))
    assert {tuple(pp["w1"].shape) for pp in placed} == {(n_experts // 4, d_model, d_ff)}
    xs = col.shard(_t(x), m, {"data": 0})
    got = col.unshard(moe.moe_ffn_shards(placed, xs, m), m, {"data": 0}, CPU).numpy()
    np.testing.assert_allclose(got, sharded, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(moe.moe_ffn(tree_map(_t, params), _t(x)).numpy(), dense, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("seed", [1, 2])
def test_moe_load_balance_loss_matches_jax(seed):
    params = moe.init_moe(seed, 8, 16, 4)
    x = np.random.default_rng(4).standard_normal((2, 8, 8)).astype(np.float32)
    want = float(jmoe.moe_load_balance_loss(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    got = float(moe.moe_load_balance_loss(tree_map(_t, params), _t(x)))
    assert got == pytest.approx(want, rel=1e-5)
    assert 0.9 <= got <= 4.0
