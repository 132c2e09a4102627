"""The port's train steps and distillation recipe (``training/steps.py``,
``training/distill_draft.py``) held to the JAX package's
(``seldon_core_tpu/training/``) on the same numpy inputs, on the CPU.

Tolerances, float32: the losses and the cross-entropy / KL functions within
rtol 1e-5; ``torch.optim.Adam`` / ``SGD`` against ``optax.adam`` / ``sgd``
on the same gradients within rtol 1e-5, atol 1e-6 over five updates; every
parameter leaf after three steps of each step maker within rtol 1e-4, atol
5e-6. The step makers are compared under SGD, which carries the gradient
itself into the leaves: under Adam a leaf whose true gradient is 0 (the
key bias, which softmax cancels) moves by a whole learning rate in the
direction of its rounding noise, which the two packages draw differently.
``distill`` at a tiny width: the accept proxies equal (they count argmax
agreements), the KL history within rtol 1e-3.

Also: the ``.npz`` checkpoint in both directions, the CLI round trip into
``zoo://draft?features=1&distilled=`` (the twin of
tests/test_feature_draft.py::test_distill_features_cli_smoke), the
feature noise's scale, and the kernel wrappers refusing autograd.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seldon_core_tpu.models import decoder as jd
from seldon_core_tpu.training import distill_draft as jdd
from seldon_core_tpu.training import steps as js
from seldon_core_tpu_torch.models import decoder as td
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.models.zoo import get_model
from seldon_core_tpu_torch.ops.flash_attention import flash_attention
from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul
from seldon_core_tpu_torch.serving.decode_scheduler import DecodeScheduler
from seldon_core_tpu_torch.training import distill_draft as tdd
from seldon_core_tpu_torch.training import steps as ts

CPU = torch.device("cpu")
VOCAB = 128
LEAF_TOL = dict(rtol=1e-4, atol=5e-6)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _assert_trees(got, want, **tol):
    g, w = tdd.flatten_params(got), jdd.flatten_params(jax.tree.map(np.asarray, want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


# ------------------------------------------------------------- the losses


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((8, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, 8).astype(np.int32)
    want = float(js.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    assert float(ts.cross_entropy(_t(logits), _t(labels))) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("temp", [0.5, 1.0])
def test_kl_from_teacher_matches_jax(temp):
    rng = np.random.default_rng(1)
    t = rng.standard_normal((3, 7, 50)).astype(np.float32) * 2
    s = rng.standard_normal((3, 7, 50)).astype(np.float32) * 2
    want = float(js.kl_from_teacher(jnp.asarray(t), jnp.asarray(s), temp))
    assert float(ts.kl_from_teacher(_t(t), _t(s), temp)) == pytest.approx(want, rel=1e-5)


# ------------------------------------------------------- the optimizers


@pytest.mark.parametrize("name,lr", [("adam", 1e-3), ("adam", 0.1), ("sgd", 0.5)])
def test_optimizer_matches_optax(name, lr):
    """Five updates on the same gradients: torch's Adam at its defaults is
    optax.adam (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias
    corrected), torch's SGD optax.sgd."""
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)}
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 10.0 ** rng.integers(-4, 2)).astype(np.float32),
                          params) for _ in range(5)]
    opt = getattr(optax, name)(lr)
    jp, jstate = jax.tree.map(jnp.asarray, params), None
    jstate = opt.init(jp)
    state = ts.init_state(params, getattr(ts, name)(lr))
    for g in grads:
        updates, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, leaf in state.params.items():
            leaf.grad = _t(g[k]).clone()
        state.optimizer.step()
    _assert_trees(state.params, jp, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- the step makers


def _mlp_params():
    rng = np.random.default_rng(3)
    return {"l1": {"w": rng.standard_normal((6, 16)).astype(np.float32) * 0.5, "b": np.zeros(16, np.float32)},
            "l2": {"w": rng.standard_normal((16, 4)).astype(np.float32) * 0.5, "b": np.zeros(4, np.float32)}}


def test_train_step_matches_jax():
    rng = np.random.default_rng(4)
    batches = [{"x": rng.standard_normal((8, 6)).astype(np.float32), "y": rng.integers(0, 4, 8).astype(np.int32)}
               for _ in range(3)]

    def jfn(p, x):
        return jnp.tanh(x @ p["l1"]["w"] + p["l1"]["b"]) @ p["l2"]["w"] + p["l2"]["b"]

    def tfn(p, x):
        return torch.tanh(x @ p["l1"]["w"] + p["l1"]["b"]) @ p["l2"]["w"] + p["l2"]["b"]

    opt = optax.sgd(0.5)
    jstate, jstep = js.init_state(jax.tree.map(jnp.asarray, _mlp_params()), opt), js.make_train_step(jfn, opt)
    state, step = ts.init_state(_mlp_params(), ts.sgd(0.5)), ts.make_train_step(tfn)
    for b in batches:
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, {k: _t(v) for k, v in b.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]), rel=1e-6)
    assert state.step == int(jstate.step) == 3
    _assert_trees(state.params, jstate.params, **LEAF_TOL)


def _decoder(seed, layers):
    return jd.init_decoder(seed=seed, vocab=VOCAB, hidden=64, layers=layers, ffn=128, max_len=32, resid_scale=0.5)


def _ids(n, s=12, seed=5):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, s)).astype(np.int32)


def test_distill_step_matches_jax():
    target, draft = _decoder(0, 2), _decoder(0, 1)
    opt = optax.sgd(1.0)
    jstate = js.init_state(jax.tree.map(jnp.asarray, draft), opt)
    jstep = js.make_distill_step(jd.sequence_logits, opt, 0.5)
    state, step = ts.init_state(draft, ts.sgd(1.0)), ts.make_distill_step(td.sequence_logits, 0.5)
    for i in range(3):
        ids = _ids(4, seed=10 + i)
        t = np.asarray(jd.sequence_logits(target, jnp.asarray(ids)))
        jstate, jm = jstep(jstate, {"x": jnp.asarray(ids), "t": jnp.asarray(t)})
        state, m = step(state, {"x": _t(ids), "t": _t(t)})
        assert float(m["kl"]) == pytest.approx(float(jm["kl"]), rel=1e-5)
        assert float(m["top1_agreement"]) == pytest.approx(float(jm["top1_agreement"]), rel=1e-6)
    _assert_trees(state.params, jstate.params, **LEAF_TOL)


@pytest.mark.parametrize("self_cond", [0.0, 0.5])
def test_feature_distill_step_matches_jax(self_cond):
    target = _decoder(0, 2)
    head = jd.init_feature_draft(seed=0, vocab=VOCAB, hidden=64, ffn=128, max_len=32)
    opt = optax.sgd(1.0)
    jstate = js.init_state(jax.tree.map(jnp.asarray, head), opt)
    jstep = js.make_feature_distill_step(opt, 0.5, 1.0, 0.0, self_cond)
    state, step = ts.init_state(head, ts.sgd(1.0)), ts.make_feature_distill_step(0.5, 1.0, 0.0, self_cond)
    for i in range(3):
        ids = _ids(4, seed=20 + i)
        t, f = (np.asarray(a) for a in jd.sequence_hidden(target, jnp.asarray(ids)))
        jstate, jm = jstep(jstate, {"x": jnp.asarray(ids), "t": jnp.asarray(t), "f": jnp.asarray(f)})
        state, m = step(state, {"x": _t(ids), "t": _t(t), "f": _t(f)})
        for k in ("kl", "feat_mse"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
        assert float(m["top1_agreement"]) == pytest.approx(float(jm["top1_agreement"]), rel=1e-6)
    _assert_trees(state.params, jstate.params, **LEAF_TOL)


def test_feature_noise_has_the_reference_scale():
    """The noise's std is feat_noise x std(f) (population std, as jnp.std),
    drawn from the (7, step) generator: deterministic per step, new each
    step."""
    f = torch.from_numpy(np.random.default_rng(6).standard_normal((8, 64, 64)).astype(np.float32) * 3 + 1)
    noisy = ts.feature_noise(f, 0.2, step=4)
    assert float((noisy - f).std()) == pytest.approx(0.2 * float(f.std(unbiased=False)), rel=0.02)
    assert float((noisy - f).mean()) == pytest.approx(0.0, abs=0.01)
    torch.testing.assert_close(ts.feature_noise(f, 0.2, step=4), noisy, rtol=0, atol=0)
    assert not torch.equal(ts.feature_noise(f, 0.2, step=5), noisy)


def test_training_after_a_served_forward():
    """A forward under inference mode first (what a server does) must not
    leave a cached inference tensor that a later step saves for backward."""
    target = params_to_torch(_decoder(0, 2), CPU)
    with torch.inference_mode():
        td.sequence_logits(target, _t(_ids(2)))
    state = ts.init_state(_decoder(0, 1), ts.adam(1e-3))
    ids = _t(_ids(2))
    with torch.inference_mode():
        teacher = td.sequence_logits(target, ids)
    state, m = ts.make_distill_step(td.sequence_logits)(state, {"x": ids, "t": teacher})
    assert np.isfinite(float(m["kl"])) and state.step == 1


# ------------------------------------------------------------- the recipe


@pytest.mark.parametrize("features", [False, True], ids=["truncated", "feature_head"])
def test_distill_matches_jax(features):
    kw = dict(seed=0, vocab=64, hidden=32, layers=2, ffn=64, max_len=24, seq=4, horizon=12, batch=4, steps=6,
              eval_prompts=4, log_every=1, features=features, feat_noise=0.0)
    want = jdd.distill(**kw)
    got = tdd.distill(device="cpu", **kw)
    assert got.keys() == want.keys()
    for k in ("accept_proxy_before", "accept_proxy_after", "steps", "features", "geometry", "checkpoint"):
        assert got[k] == want[k], k
    for k in ("final_kl", "final_top1", "final_feat_mse"):
        if k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-4), k
    assert len(got["history"]) == len(want["history"]) == 6
    for g, w in zip(got["history"], want["history"]):
        assert g.keys() == w.keys() and g["step"] == w["step"]
        for k in set(g) - {"step"}:
            assert g[k] == pytest.approx(w[k], rel=1e-3, abs=1e-4), (g["step"], k)


def test_distill_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdd.distill(vocab=64, hidden=32, layers=2, ffn=64, max_len=24, seq=4, horizon=12, steps=1)


@pytest.mark.parametrize("features", [False, True], ids=["truncated", "feature_head"])
def test_checkpoint_round_trip_both_ways(features, tmp_path):
    """A checkpoint either package writes loads in the other, leaf for leaf;
    a geometry mismatch raises the reference's message in both."""
    kind = {"features": 1} if features else {"layers": 1, "seq": 4, "max_new_tokens": 4}
    geom = dict(vocab=64, hidden=32, ffn=64, max_len=24, **kind)
    from seldon_core_tpu.models.zoo import get_model as jax_get_model

    jparams = jax_get_model("draft", seed=3, **geom).params
    tparams = get_model("draft", seed=4, **geom).params
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jdd.save_draft_checkpoint(jpath, jparams)
    tdd.save_draft_checkpoint(tpath, params_to_torch(tparams, CPU))
    like = get_model("draft", **geom).params
    _assert_trees(tdd.load_draft_checkpoint(jpath, like), jparams, rtol=0, atol=0)
    back = jdd.load_draft_checkpoint(tpath, jax_get_model("draft", **geom).params)
    _assert_trees(tparams, back, rtol=0, atol=0)
    other = dict(geom, hidden=16, ffn=32)
    with pytest.raises(ValueError) as te:
        tdd.load_draft_checkpoint(jpath, get_model("draft", **other).params)
    with pytest.raises(ValueError) as je:
        jdd.load_draft_checkpoint(jpath, jax_get_model("draft", **other).params)
    assert str(te.value) == str(je.value) and "different geometry" in str(te.value)
    missing_key = str(tmp_path / "short.npz")
    np.savez(missing_key, **{k: v for k, v in jdd.flatten_params(jparams).items() if k != "ln_f.scale"})
    with pytest.raises(ValueError) as te:
        tdd.load_draft_checkpoint(missing_key, like)
    with pytest.raises(ValueError) as je:
        jdd.load_draft_checkpoint(missing_key, jax_get_model("draft", **geom).params)
    assert str(te.value) == str(je.value) and "missing 'ln_f.scale'" in str(te.value)


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "seldon_core_tpu_torch.training.distill_draft", *args],
                          capture_output=True, text=True, timeout=600, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": ROOT})


def test_distill_features_cli_round_trip(tmp_path):
    """A tiny feature distillation through the ``python -m`` CLI on the CPU
    lifts the accept proxy over init, and its checkpoint serves through
    ``zoo://draft?features=1&distilled=``: greedy output equal to the fused
    oracle, and the head accepts."""
    ck = tmp_path / "feat.npz"
    proc = _cli("--features", "--device", "cpu", "--vocab", str(VOCAB), "--hidden", "64", "--layers", "2",
                "--ffn", "128", "--max-len", "48", "--seq", "8", "--horizon", "24", "--batch", "8",
                "--steps", "30", "--log-every", "0", "--out", str(ck))
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["features"] is True
    assert report["accept_proxy_after"] > report["accept_proxy_before"] + 0.1
    ms = get_model("draft", features=1, vocab=VOCAB, hidden=64, ffn=128, max_len=48, distilled=str(ck))
    init = jd.init_feature_draft(seed=0, vocab=VOCAB, hidden=64, ffn=128, max_len=48)
    assert td.is_feature_draft(ms.params) and not np.array_equal(ms.params["fc"]["w"], init["fc"]["w"])

    async def serve():
        target = params_to_torch(td.init_decoder(seed=0, vocab=VOCAB, hidden=64, layers=2, ffn=128, max_len=48), CPU)
        ids = np.random.default_rng(13).integers(0, VOCAB, (2, 8)).astype(np.int32)
        with torch.inference_mode():
            oracle = td.generate(target, torch.from_numpy(ids), 10).numpy()
        s = DecodeScheduler(target, seq_len=8, max_new_tokens=10, n_slots=2,
                            draft_params=params_to_torch(ms.params, CPU), spec_tree="2,1")
        s.warmup()
        try:
            outs = [await s.submit(row) for row in ids]
            for o, row in zip(outs, oracle):
                np.testing.assert_array_equal(np.asarray(o), row)
            assert s.stat_spec_accepted > 0
        finally:
            await s.close()

    import asyncio

    asyncio.run(serve())


def test_distill_cli_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is the card")
    proc = _cli("--steps", "1", "--vocab", "64", "--hidden", "32", "--layers", "2", "--ffn", "64")
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr


# --------------------------------------------- kernels without a backward


def test_flash_attention_refuses_autograd():
    q, k, v = (torch.randn(1, 2, 128, 64) for _ in range(3))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        flash_attention(q, k, v)
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert out.grad_fn is None and out.shape == q.shape
    flash_attention(q.detach(), k, v)  # no input requires grad: served as before


def test_int8_matmul_refuses_autograd():
    x = torch.randn(4, 8, requires_grad=True)
    q = torch.randint(-127, 128, (8, 3), dtype=torch.int8)
    scale = torch.rand(1, 3) * 0.01
    with pytest.raises(RuntimeError, match="int8_matmul has no backward"):
        int8_matmul(x, q, scale)
    with torch.no_grad():
        int8_matmul(x, q, scale)
    bias = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="int8_matmul has no backward"):
        int8_matmul(x.detach(), q, scale, bias)
