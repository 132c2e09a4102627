"""The port's ResNet against the JAX package's on the same weights.

- ``init_resnet`` (and ``fold_batchnorm``, ``space_to_depth_stem`` on top
  of it) draws bit-identical parameters;
- ``resnet_logits`` agrees in float32: relative L2 <= 1e-5 and max abs
  error <= 1e-5 of max|logit| (measured about 5e-7 for both; the depth-50
  logits reach a few hundred). Logits, not probabilities: random-init
  ResNets saturate their softmax, so a probability check cannot see a
  padding fault. Cases: resnet_tiny at 32x32, the bottleneck path (depth 50,
  width 8), odd sizes (33), the space-to-depth stem, unfolded BatchNorm;
  ``apply_resnet`` probabilities at rtol 1e-4 / atol 1e-5, the tolerance of
  tests/test_models_heavy.py::test_fold_batchnorm_matches_unfolded;
- the same check fails for a stem padded (3, 3) and a max-pool padded
  (1, 1) symmetrically, the shape-preserving faults XLA's asymmetric SAME
  padding invites;
- the uint8 image wire: a uint8 batch reaches the device as uint8, warmup
  runs that signature, and the answer equals the JAX runtime's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from seldon_core_tpu.models import resnet as jax_resnet
from seldon_core_tpu.models.base import ModelRuntime as JaxRuntime
from seldon_core_tpu_torch.graph.spec import TpuSpec
from seldon_core_tpu_torch.models import resnet, zoo
from seldon_core_tpu_torch.models.convert import params_to_torch

LOGIT_REL_L2 = 1e-5
LOGIT_MAX_ABS = 1e-5  # of max|logit|
PROB_TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")


def _scramble_bn_stats(p, rng):
    """Non-trivial BN stats, so folding changes the math."""
    if isinstance(p, dict):
        if {"scale", "bias", "mean", "var"} <= p.keys():
            c = p["scale"].shape[0]
            p["scale"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            p["bias"] = rng.standard_normal(c).astype(np.float32)
            p["mean"] = rng.standard_normal(c).astype(np.float32)
            p["var"] = rng.uniform(0.2, 3.0, c).astype(np.float32)
        else:
            for v in p.values():
                _scramble_bn_stats(v, rng)
    elif isinstance(p, list):
        for v in p:
            _scramble_bn_stats(v, rng)


def _leaves(tree):
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("depth,width", [(18, 16), (50, 8)])
def test_init_resnet_is_bit_identical(depth, width):
    ours = resnet.init_resnet(3, depth=depth, num_classes=10, width=width)
    theirs = jax_resnet.init_resnet(3, depth=depth, num_classes=10, width=width)
    pairs = [
        (ours, theirs),
        (resnet.fold_batchnorm(ours), jax_resnet.fold_batchnorm(theirs)),
        (
            resnet.space_to_depth_stem(resnet.fold_batchnorm(ours)),
            jax_resnet.space_to_depth_stem(jax_resnet.fold_batchnorm(theirs)),
        ),
    ]
    for a_tree, b_tree in pairs:
        assert jax.tree.structure(a_tree) == jax.tree.structure(b_tree)
        for a, b in zip(_leaves(a_tree), _leaves(b_tree)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _port_params(np_params):
    return params_to_torch(np_params, CPU, torch.float32, resnet.conv_layout)


def _logit_gap(got, ref):
    rel_l2 = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    max_abs = float(np.abs(got - ref).max() / np.abs(ref).max())
    return rel_l2, max_abs


def _agrees(got, ref) -> bool:
    rel_l2, max_abs = _logit_gap(got, ref)
    return rel_l2 <= LOGIT_REL_L2 and max_abs <= LOGIT_MAX_ABS


# (depth, width, image size, fold BN, space-to-depth stem)
CASES = {
    "tiny_32": (18, 16, 32, True, False),
    "bottleneck_32": (50, 8, 32, True, False),
    "odd_33": (18, 16, 33, True, False),
    "bottleneck_odd_33": (50, 8, 33, True, False),
    "space_to_depth_64": (50, 8, 64, True, True),
    "unfolded_bn_32": (50, 8, 32, False, False),
}


def _case(name):
    depth, width, size, fold, s2d = CASES[name]
    params = jax_resnet.init_resnet(3, depth=depth, num_classes=10, width=width)
    _scramble_bn_stats(params, np.random.default_rng(5))
    if fold:
        params = jax_resnet.fold_batchnorm(params)
    if s2d:
        params = jax_resnet.space_to_depth_stem(params)
    x = np.random.default_rng(7).standard_normal((2, size, size, 3)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("name", sorted(CASES))
def test_resnet_logits_match_jax(name):
    params, x = _case(name)
    jparams = jax.tree.map(jnp.asarray, params)
    ref = np.asarray(jax_resnet.resnet_logits(jparams, jnp.asarray(x)))
    tparams = _port_params(params)
    with torch.inference_mode():
        got = resnet.resnet_logits(tparams, torch.from_numpy(x)).numpy()
        probs = resnet.apply_resnet(tparams, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 10)
    assert _agrees(got, ref), _logit_gap(got, ref)
    np.testing.assert_allclose(probs, np.asarray(jax_resnet.apply_resnet(jparams, jnp.asarray(x))), **PROB_TOL)


def _stem_padded_3_3(orig):
    return lambda size, k, stride: (3, 3) if k == 7 else orig(size, k, stride)


def _pool_padded_1_1(h):
    return F.max_pool2d(h, 3, 2, padding=1)


@pytest.mark.parametrize("name", ["tiny_32", "bottleneck_32"])
@pytest.mark.parametrize("fault", ["stem_3_3", "max_pool_1_1"])
def test_logit_check_fails_for_symmetric_padding(name, fault, monkeypatch):
    """A symmetric pad keeps every output shape and shifts the image by a
    pixel: the logits check above must see it."""
    params, x = _case(name)
    ref = np.asarray(jax_resnet.resnet_logits(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    if fault == "stem_3_3":
        monkeypatch.setattr(resnet, "_same_pads", _stem_padded_3_3(resnet._same_pads))
    else:
        monkeypatch.setattr(resnet, "_max_pool_same", _pool_padded_1_1)
    with torch.inference_mode():
        got = resnet.resnet_logits(_port_params(params), torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    rel_l2, _ = _logit_gap(got, ref)
    assert not _agrees(got, ref) and rel_l2 > 100 * LOGIT_REL_L2


def test_conv_layout_is_oihw_channels_last():
    w = np.arange(7 * 5 * 3 * 4, dtype=np.float32).reshape(7, 5, 3, 4)  # HWIO
    t = resnet.conv_layout(w)
    assert t.shape == (4, 3, 7, 5) and t.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(t.numpy(), w.transpose(3, 2, 0, 1))
    b = np.ones(4, np.float32)
    assert resnet.conv_layout(b) is b


def test_uint8_wire_goes_to_the_device_raw_and_matches_jax():
    ms = zoo.get_model("resnet_tiny", seed=2)
    rt = zoo._runtime_from_modelspec(ms, TpuSpec(batch_buckets=(1, 4), max_batch=4), CPU)
    seen = []
    real = rt._forward
    rt._forward = lambda x: seen.append(x.dtype) or real(x)
    rt.warmup()
    assert set(seen) == {torch.float32, torch.uint8}  # both wire dtypes per bucket
    seen.clear()
    x = np.random.default_rng(3).integers(0, 256, size=(3, 32, 32, 3), dtype=np.uint8)
    got = rt.predict(x)
    assert seen == [torch.uint8] and got.dtype == np.float32 and got.shape == (3, 10)
    jms = jax_resnet.build_resnet_tiny(seed=2)
    jrt = JaxRuntime(jms.apply_fn, jms.params, buckets=(1, 4))
    jrt.feature_shape = jms.feature_shape
    np.testing.assert_allclose(got, np.asarray(jrt.predict(x)), **PROB_TOL)
    # tabular models never take uint8 raw: their batch is cast on the host
    iris = zoo._runtime_from_modelspec(zoo.get_model("iris_logistic"), TpuSpec(batch_buckets=(2,)), CPU)
    assert not iris._uint8_wire()


def test_heavy_model_memo_shares_builds():
    kw = dict(depth=18, width=8, image_size=32)
    a = zoo.get_model("resnet50", seed=0, **kw)
    assert zoo.get_model("resnet50", seed=0, finetune_lr=0.01, **kw) is a  # unknown kwargs ignored
    assert zoo.get_model("resnet50", **kw) is a  # an omitted default is the same build
    assert zoo.get_model("resnet50", seed=1, **kw) is not a
    assert zoo.get_model("iris_mlp") is not zoo.get_model("iris_mlp")  # light models are not cached
