"""The EAGLE-style feature draft of the port (``models/decoder.py``'s head
and the decode scheduler's feature mode) held to the JAX package's
(tests/test_feature_draft.py) on the same numpy weights, on the CPU.

The load-bearing invariants:

- the head's parameter stream is the JAX package's bit for bit, and shares
  the target's leading draws (embeddings and layer; ``fc`` drawn last);
- the teacher-forced head forward shifts features by one, and the head's
  chunk prefill and tree proposal equal the JAX package's (greedy tokens
  equal, K/V and logits within rtol 1e-5, atol 1e-5 in float32);
- the scheduler's feature rounds are greedy bit-identical to the plain
  scheduler and the fused oracle for any head, cold and prefix-warm, on
  the serial and the pipelined loop, with no new dispatch key on mixed
  plain and speculative traffic;
- each slot's carried feature is the target's hidden at its last consumed
  position;
- a chain config promotes to the branching-1 tree under the JAX package's
  program names and its verify-width cap.

One of the JAX file's tests waits for a part of the port that does not
exist yet: the tensor-parallel agreement test (tensor-parallel decode,
ROADMAP item 12). The distillation CLI test's twin is in
tests/test_torch_training.py.
"""

import asyncio
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import decoder as jd
from seldon_core_tpu.models.spec_tree import SpecTree as JaxSpecTree
from seldon_core_tpu.serving.decode_scheduler import DecodeScheduler as JaxDecodeScheduler
from seldon_core_tpu_torch.core.message import Meta, SeldonMessage
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.models import decoder as td
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.models.spec_tree import MAX_TREE_NODES, SpecTree
from seldon_core_tpu_torch.models.zoo import get_model
from seldon_core_tpu_torch.serving.decode_scheduler import DecodeScheduler
from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

SEQ = 8
MAX_NEW = 10
VOCAB = 128
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
DEPLOYMENTS = Path(__file__).resolve().parent.parent / "seldon_core_tpu_torch" / "deployments"


def _np_params(layers=2):
    return jd.init_decoder(seed=3, vocab=VOCAB, hidden=64, layers=layers, ffn=128, max_len=64, resid_scale=0.1)


def _np_head(seed=3, hidden=64, ffn=128):
    return jd.init_feature_draft(seed=seed, vocab=VOCAB, hidden=hidden, ffn=ffn, max_len=64)


@pytest.fixture(scope="module")
def target():
    p = _np_params()
    return p, params_to_torch(p, CPU)


def _prompts(n, seed=1):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, SEQ)).astype(np.int32)


def _shared_prompts(n, shared=5, seed=2):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, VOCAB, shared).astype(np.int32)
    return np.stack([np.concatenate([head, rng.integers(0, VOCAB, SEQ - shared)]).astype(np.int32)
                     for _ in range(n)])


def _scheduler(tp, head=None, n_slots=2, loop="pipelined", **kw) -> DecodeScheduler:
    if head is not None:
        kw["draft_params"] = params_to_torch(head, CPU)
    s = DecodeScheduler(tp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=n_slots, **kw)
    s.pipeline_enabled = loop == "pipelined"
    s.warmup()
    return s


def _oracle(tp, ids, max_new=MAX_NEW):
    with torch.inference_mode():
        return td.generate(tp, torch.from_numpy(ids), max_new).numpy()


def _np(t):
    return t.detach().float().cpu().numpy()


# ------------------------------------------------------------- head model


def test_feature_head_param_stream_is_the_jax_heads():
    """The head's draws are the JAX package's bit for bit, and a head built
    with the target's seed, vocab, hidden and ffn starts with the target's
    embeddings and leading layer, ``fc`` drawn last."""
    ours, theirs, t = td.init_feature_draft(seed=3, vocab=VOCAB, hidden=64, ffn=128, max_len=64), _np_head(), \
        _np_params()
    flat_ours, flat_theirs = jax.tree_util.tree_leaves_with_path(ours), jax.tree_util.tree_leaves_with_path(theirs)
    assert [p for p, _ in flat_ours] == [p for p, _ in flat_theirs]
    for (path, a), (_, b) in zip(flat_ours, flat_theirs):
        assert a.dtype == b.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert td.is_feature_draft(ours) and not td.is_feature_draft(t)
    assert not td.is_feature_draft(params_to_torch(t, CPU)) and td.is_feature_draft(params_to_torch(ours, CPU))
    for key in ("tok_emb", "pos_emb"):
        np.testing.assert_array_equal(ours[key], t[key])
    for key in ("qkv", "mlp_in"):
        np.testing.assert_array_equal(ours["layers"][0][key]["w"], t["layers"][0][key]["w"])
    assert ours["fc"]["w"].shape == (128, 64)
    with pytest.raises(ValueError, match="divisible"):
        td.init_feature_draft(hidden=129)


def test_feature_sequence_logits_match_jax_and_shift(target):
    """Against the JAX head on the target's features, and the shift: input j
    fuses feature j-1 with token j, so position 0 sees none of the
    features, position 1 moves with feature 0, and the last feature feeds
    nothing."""
    jp, tp = target
    jh = _np_head()
    th = params_to_torch(jh, CPU)
    ids = _prompts(2, seed=7)[:, :4]
    _, jf = jd.sequence_hidden(jp, jnp.asarray(ids))
    jl, jx = jd.feature_sequence_logits(jh, jnp.asarray(ids), jf)
    with torch.inference_mode():
        _, tf = td.sequence_hidden(tp, ids)
        np.testing.assert_allclose(_np(tf), np.asarray(jf), **TOL)
        base, feats = td.feature_sequence_logits(th, ids, tf)
        assert base.shape == (2, 4, VOCAB) and feats.shape == (2, 4, 64)
        np.testing.assert_allclose(_np(base), np.asarray(jl), **TOL)
        np.testing.assert_allclose(_np(feats), np.asarray(jx), **TOL)
        bumped = tf.clone()
        bumped[:, 0] += 10.0
        moved, _ = td.feature_sequence_logits(th, ids, bumped)
        np.testing.assert_allclose(_np(base)[:, 0], _np(moved)[:, 0], rtol=1e-5)
        assert not np.allclose(_np(base)[:, 1], _np(moved)[:, 1])
        tail = tf.clone()
        tail[:, -1] += 10.0
        same, _ = td.feature_sequence_logits(th, ids, tail)
        np.testing.assert_allclose(_np(base), _np(same), rtol=1e-5)


def _cache_inputs(rng, n=3, ctx=24, hd=64, heads=1):
    shape = (1, n, heads, ctx, hd)
    return (rng.standard_normal(shape) * 0.1).astype(np.float32), (rng.standard_normal(shape) * 0.1).astype(np.float32)


@pytest.mark.parametrize("first", [True, False])
def test_feature_chunk_prefill_matches_jax(first):
    """The head's teacher-forced chunk: the K/V written under the counts
    mask with the starts window equal the JAX package's; a slot whose chunk
    starts at its window zeroes the carried feature, and a counts-0 slot
    writes nothing."""
    rng = np.random.default_rng(5)
    jh = _np_head()
    th = params_to_torch(jh, CPU)
    ck, cv = _cache_inputs(rng)
    tokens = rng.integers(0, VOCAB, (3, 4)).astype(np.int32)
    hidden = rng.standard_normal((3, 4, 64)).astype(np.float32)
    prev = rng.standard_normal((3, 64)).astype(np.float32)
    positions = np.array([0, 5, 9], np.int32)
    counts = np.array([4, 2, 0], np.int32)
    starts = positions.copy() if first else np.array([0, 3, 2], np.int32)
    jk, jv = jd.feature_chunk_prefill(jh, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(tokens), jnp.asarray(hidden),
                                      jnp.asarray(prev), jnp.asarray(positions), jnp.asarray(counts),
                                      jnp.asarray(starts))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.inference_mode():
        out_k, out_v = td.feature_chunk_prefill(th, tk, tv, *(torch.from_numpy(a) for a in (
            tokens, hidden, prev, positions, counts, starts)))
    assert out_k is tk and out_v is tv  # in place
    np.testing.assert_allclose(_np(tk), np.asarray(jk), **TOL)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(_np(tk)[:, 2], ck[:, 2])  # counts 0: untouched


@pytest.mark.parametrize("tree_text", ["2,2,1", "1,1,1"])
def test_draft_propose_features_matches_jax(tree_text):
    """The feature tree proposal at greedy rows (top-k=1 candidates equal
    the JAX package's), its block logits, node K/V and the root's cache
    write within float32 rounding, with a warm window open on one slot."""
    rng = np.random.default_rng(8)
    jh = _np_head()
    th = params_to_torch(jh, CPU)
    ck, cv = _cache_inputs(rng)
    feats = rng.standard_normal((3, 64)).astype(np.float32)
    tokens = rng.integers(0, VOCAB, 3).astype(np.int32)
    positions = np.array([8, 12, 15], np.int32)
    starts = np.array([0, 4, 0], np.int32)
    zf, zi = np.zeros(3, np.float32), np.zeros(3, np.int32)
    jout = jd.draft_propose_features(jh, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(feats), jnp.asarray(tokens),
                                     jnp.asarray(positions), jnp.asarray(starts), jnp.asarray(zf), jnp.asarray(zi),
                                     jax.random.key(0), JaxSpecTree.from_text(tree_text))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.inference_mode():
        tout = td.draft_propose_features(th, tk, tv, *(torch.from_numpy(a) for a in (
            feats, tokens, positions, starts, zf, zi)), None, SpecTree.from_text(tree_text))
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    for got, want in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # the window matters: the same proposal without it differs on slot 1
    tk2, tv2 = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.inference_mode():
        wide = td.draft_propose_features(th, tk2, tv2, *(torch.from_numpy(a) for a in (
            feats, tokens, positions, np.zeros(3, np.int32), zf, zi)), None, SpecTree.from_text(tree_text))
    assert not np.allclose(_np(wide[1])[1], _np(tout[1])[1])
    np.testing.assert_allclose(_np(wide[1])[0], _np(tout[1])[0], rtol=1e-6)


def test_starts_none_keeps_the_slot_masks_bit_for_bit():
    """``starts=None`` is the mask the target paths ran before the window
    existed, and an all-zero window is the same mask."""
    rng = np.random.default_rng(3)
    p = params_to_torch(_np_params(layers=1), CPU)["layers"][0]
    ck, cv = _cache_inputs(rng)
    x = torch.from_numpy(rng.standard_normal((3, 2, 64)).astype(np.float32))
    pos = torch.tensor([3, 7, 11])
    outs = []
    for starts in (None, torch.zeros(3, dtype=torch.long)):
        k, v = torch.from_numpy(ck[0].copy()), torch.from_numpy(cv[0].copy())
        with torch.inference_mode():
            outs.append(td._layer_step_slots(p, x, k, v, pos, 1, starts=starts)[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# ----------------------------------------------------- scheduler equivalence


@pytest.mark.parametrize("loop", ["serial", "pipelined"])
async def test_feature_tree_greedy_bit_identical_to_plain_and_oracle(target, loop):
    """Greedy output with an untrained head matches the plain scheduler, the
    port's fused oracle and the JAX package's generate token for token,
    cold and prefix-warm, on both loops: the acceptance rule owns
    correctness for any draft."""
    jp, tp = target
    ids = _shared_prompts(6)
    oracle = _oracle(tp, ids)
    np.testing.assert_array_equal(oracle, np.asarray(jd.generate(jp, jnp.asarray(ids), MAX_NEW)))
    plain = _scheduler(tp, prefix_slots=4, kv_page_size=4, loop=loop)
    p_outs = await asyncio.gather(*(plain.submit(row) for row in ids[:3]))
    p_outs += await asyncio.gather(*(plain.submit(row) for row in ids[3:]))
    await plain.close()
    sched = _scheduler(tp, _np_head(seed=11), spec_tree="2,2,1", prefix_slots=4, kv_page_size=4, loop=loop)
    assert sched.feature_draft
    outs = await asyncio.gather(*(sched.submit(row) for row in ids[:3]))
    outs += await asyncio.gather(*(sched.submit(row) for row in ids[3:]))
    for o, p, row in zip(outs, p_outs, oracle):
        np.testing.assert_array_equal(o, p)
        np.testing.assert_array_equal(o, row)
    assert sched.stat_spec_dispatches > 0
    assert sched.stat_prefix_hits > 0  # the warm wave hit
    assert (sched._draft_start > 0).any()  # and opened its window past the reused span
    assert sched.recompiles_since_warmup() == 0
    assert (sched.stat_pipelined_rounds > 0) == (loop == "pipelined")
    sched.pool.alloc.check()
    await sched.close()


@pytest.mark.parametrize("spec_k", [None, 0])
async def test_carried_feature_is_the_targets_last_hidden(target, spec_k):
    """After a greedy request alone, the slot's carried feature is the
    target's hidden at the last position it consumed (the token before the
    last emitted one), whether the rounds were speculative or plain
    (``spec_k=0``: every round a ``step_f``)."""
    _, tp = target
    sched = _scheduler(tp, _np_head(), spec_tree="2,1")
    row = _prompts(1, seed=13)[0]
    before = sched.stat_spec_dispatches
    out = await sched.submit(row, spec_k=spec_k)
    slot = sched._free[-1]  # the slot this request retired from
    assert (sched.stat_spec_dispatches > before) == (spec_k is None)
    with torch.inference_mode():
        _, hidden = td.sequence_hidden(tp, out[None, :-1])
    torch.testing.assert_close(sched._feat[slot], hidden[0, -1], rtol=1e-5, atol=1e-5)
    await sched.close()


async def test_feature_chain_promotion_and_compile_counts(target):
    """decode_spec_k without decode_spec_tree promotes a feature draft to
    the branching-1 tree, and the feature program names replace step,
    chunk and draft admit in compile_counts(), as the JAX scheduler's."""
    jp, tp = target
    head = _np_head()
    ids = _prompts(3, seed=5)
    oracle = _oracle(tp, ids)
    sched = _scheduler(tp, head, spec_k=3)
    assert sched.feature_draft and sched.spec_tree.branching == (1, 1, 1)
    jsched = JaxDecodeScheduler(jp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=2, draft_params=head, spec_k=3)
    assert set(sched.compile_counts()) == set(jsched.compile_counts())
    assert {"step_f", "chunk_f", "draft_feat", "ftree_verify", "copy"} == set(sched.compile_counts())
    outs = await asyncio.gather(*(sched.submit(row) for row in ids))
    for o, row in zip(outs, oracle):
        np.testing.assert_array_equal(o, row)
    assert sched.recompiles_since_warmup() == 0
    await sched.close()


@pytest.mark.parametrize("loop", ["serial", "pipelined"])
async def test_feature_sampled_topk1_deterministic(target, loop):
    """temperature > 0 with top_k=1 is the argmax: the eager sampled round
    pair through the feature verify reproduces greedy."""
    _, tp = target
    ids = _prompts(2, seed=9)
    oracle = _oracle(tp, ids)
    sched = _scheduler(tp, _np_head(), spec_tree="2,1", loop=loop)
    outs = await asyncio.gather(*(sched.submit(row, temperature=0.7, top_k=1) for row in ids))
    for o, row in zip(outs, oracle):
        np.testing.assert_array_equal(o, row)
    assert sched.stat_eager_rounds > 0 and sched.recompiles_since_warmup() == 0
    await sched.close()


async def test_feature_mixed_plain_spec_zero_recompiles(target):
    """An accept floor degrades the untrained head to plain rounds with
    periodic probes: plain, chunk and feature-tree rounds interleave on one
    warmed key set, probe rounds are tagged in the flight frames, and tree
    rounds carry their width mask."""
    _, tp = target
    ids = _prompts(6, seed=23)
    oracle = _oracle(tp, ids)
    sched = _scheduler(tp, _np_head(seed=11), spec_tree="2,2,1", spec_accept_floor=0.6)
    outs = await asyncio.gather(*(sched.submit(row) for row in ids[:3]))
    outs += await asyncio.gather(*(sched.submit(row) for row in ids[3:]))
    for o, row in zip(outs, oracle):
        np.testing.assert_array_equal(o, row)
    assert sched._adapt.rate < 0.6
    assert sched.recompiles_since_warmup() == 0
    frames = sched.flight.snapshot()
    assert sched._adapt.probes >= 1 and any(f.probe for f in frames)
    assert any(f.spec_widths for f in frames if f.mode == "tree")
    assert {f.mode for f in frames} >= {"plain", "tree"}
    await sched.close()


def _jax_error(**kw) -> str:
    with pytest.raises(ValueError) as e:
        JaxDecodeScheduler(_np_params(), seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=2, **kw)
    return str(e.value)


@pytest.mark.parametrize("case", ["hidden_mismatch", "chain_width_cap"])
def test_feature_refusals_give_the_jax_messages(target, case):
    """A head whose hidden differs from the target's, and a chain past the
    verify headroom that the promotion must not bypass, are refused at
    build with the JAX scheduler's messages."""
    _, tp = target
    if case == "hidden_mismatch":
        kw = dict(draft_params=jd.init_feature_draft(seed=3, vocab=VOCAB, hidden=128, ffn=128, max_len=64),
                  spec_tree="2,1")
        needle = "feature draft hidden"
    else:
        kw = dict(draft_params=_np_head(), spec_k=MAX_TREE_NODES + 1)
        needle = "widened-verify"
    want = _jax_error(**kw)
    assert needle in want
    with pytest.raises(ValueError) as e:
        DecodeScheduler(tp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=2,
                        **{**kw, "draft_params": params_to_torch(kw["draft_params"], CPU)})
    assert str(e.value) == want


# --------------------------------------------------------- serving wiring


def _predictor(**tpu) -> PredictorSpec:
    return PredictorSpec.from_dict({
        "name": "p",
        "graph": {"name": "gpt", "type": "MODEL", "implementation": "JAX_MODEL", "parameters": [
            {"name": "model", "value": "tiny_gpt", "type": "STRING"},
            {"name": "seq", "value": str(SEQ), "type": "INT"},
            {"name": "max_new_tokens", "value": "6", "type": "INT"},
            {"name": "vocab", "value": str(VOCAB), "type": "INT"}]},
        "tpu": {"max_batch": 4, "batch_buckets": [4], "decode_slots": 2,
                "decode_draft_model": "zoo://draft?features=1", "decode_spec_tree": "2,1", **tpu},
    })


async def test_serving_feature_draft_wiring():
    """decode_draft_model=zoo://draft?features=1 through the server: the
    draft takes the target's hidden and ffn beside its vocab and max_len,
    the head layout turns feature mode on, and the buffered reply equals
    the fused zoo apply, with and without meta.tags.spec_k = 0."""
    server = PredictorServer(_predictor(), device="cpu")
    sched = server.decode_scheduler
    assert sched is not None and sched.feature_draft and sched.spec_tree.branching == (2, 1)
    dims = td.decoder_dims(sched.draft_params)
    assert (dims["hidden"], dims["vocab"], dims["layers"]) == (128, VOCAB, 1)
    assert sched.draft_params["layers"][0]["mlp_in"]["w"].shape == (128, 256)
    server.warmup()
    try:
        ids = _prompts(2, seed=41)
        want = server.executor.root.unit.runtime.predict(ids)
        out = await server.service.predict(SeldonMessage.from_array(ids))
        np.testing.assert_array_equal(np.asarray(out.array), want)
        before = sched.stat_spec_dispatches
        assert before > 0
        out = await server.service.predict(SeldonMessage.from_array(ids[:1], meta=Meta(tags={"spec_k": 0})))
        np.testing.assert_array_equal(np.asarray(out.array), want[:1])
        assert sched.stat_spec_dispatches == before
        assert sched.recompiles_since_warmup() == 0
    finally:
        await server.stop()


def test_zoo_feature_draft_builds_and_refuses_standalone(tmp_path):
    """The zoo's head is the JAX zoo's, its apply refuses to serve
    standalone with the JAX message, and a distilled head loads as the JAX
    zoo loads it: a missing checkpoint raises the same error type in both,
    a checkpoint the JAX package wrote gives both the same weights."""
    from seldon_core_tpu.models.zoo import get_model as jax_get_model

    ms = get_model("draft", features=1, vocab=VOCAB, hidden=64, ffn=128, max_len=64)
    jms = jax_get_model("draft", features=1, vocab=VOCAB, hidden=64, ffn=128, max_len=64)
    assert td.is_feature_draft(ms.params)
    np.testing.assert_array_equal(ms.params["fc"]["w"], np.asarray(jms.params["fc"]["w"]))
    with pytest.raises(ValueError) as e:
        ms.apply_fn(ms.params, np.zeros((1, SEQ), np.int32))
    with pytest.raises(ValueError) as je:
        jms.apply_fn(jms.params, np.zeros((1, SEQ), np.int32))
    assert str(e.value) == str(je.value) and "decode_draft_model" in str(e.value)
    from seldon_core_tpu.training.distill_draft import save_draft_checkpoint as jax_save

    geom = dict(features=1, vocab=VOCAB, hidden=64, ffn=128, max_len=64)
    missing = str(tmp_path / "missing.npz")
    with pytest.raises(FileNotFoundError):
        jax_get_model("draft", **geom, distilled=missing)
    with pytest.raises(FileNotFoundError):
        get_model("draft", **geom, distilled=missing)
    ck = str(tmp_path / "head.npz")
    jax_save(ck, jax_get_model("draft", seed=9, **geom).params)
    loaded, jloaded = get_model("draft", **geom, distilled=ck), jax_get_model("draft", **geom, distilled=ck)
    assert td.is_feature_draft(loaded.params)
    np.testing.assert_array_equal(loaded.params["fc"]["w"], np.asarray(jloaded.params["fc"]["w"]))
    assert not np.array_equal(loaded.params["fc"]["w"], ms.params["fc"]["w"])  # the seed-0 build's


@pytest.mark.parametrize("name", ["tiny_gpt_feature_draft", "gpt2_small_feature_draft"])
def test_feature_deployment_files_build_on_the_cpu(name):
    """The two feature-draft deployments parse, pass validation and build a
    feature-mode scheduler whose head has the target's widths (the
    GPT-2-small one is built, not served: its widths are the card's)."""
    path = DEPLOYMENTS / f"{name}.json"
    predictor, _ = load_predictor(str(path))
    server = PredictorServer(predictor, device="cpu")
    sched = server.decode_scheduler
    assert sched is not None and sched.feature_draft
    tpu = json.loads(path.read_text())["spec"]["predictors"][0]["tpu"]
    assert sched.spec_tree.branching == tuple(int(b) for b in tpu["decode_spec_tree"].split(","))
    assert "distilled" not in tpu["decode_draft_model"]
    dims, ddims = td.decoder_dims(sched.params), td.decoder_dims(sched.draft_params)
    assert (ddims["vocab"], ddims["max_len"], ddims["hidden"]) == (dims["vocab"], dims["max_len"], dims["hidden"])
    assert ddims["layers"] == 1 and sched.draft_params["tok_emb"].dtype == torch.float32
    assert sched._feat.shape == (sched.n_slots, dims["hidden"]) and sched._feat.dtype == sched.params["tok_emb"].dtype
    if name == "gpt2_small_feature_draft":
        assert (dims["vocab"], dims["hidden"], dims["layers"], dims["heads"]) == (50257, 768, 12, 12)
        assert sched.spec_tree.n_tree == MAX_TREE_NODES and sched.n_slots == 8
        # the head (float32) starts with the bf16 target's leading layer
        torch.testing.assert_close(sched.draft_params["layers"][0]["qkv"]["w"].to(torch.bfloat16),
                                   sched.params["layers"][0]["qkv"]["w"], rtol=0, atol=0)


async def test_tiny_feature_deployment_serves_like_plain():
    """tiny_gpt_feature_draft served on the CPU: every greedy row equals the
    same deployment with speculation off."""
    path = DEPLOYMENTS / "tiny_gpt_feature_draft.json"
    predictor, _ = load_predictor(str(path))
    server = PredictorServer(predictor, device="cpu")
    server.warmup()
    sched = server.decode_scheduler
    try:
        ids = np.random.default_rng(4).integers(0, 512, (4, sched.seq_len)).astype(np.int32)
        out = await server.service.predict(SeldonMessage.from_array(ids))
        want = server.executor.root.unit.runtime.predict(ids)
        np.testing.assert_array_equal(np.asarray(out.array), want)
        assert sched.stat_spec_dispatches > 0 and sched.recompiles_since_warmup() == 0
    finally:
        await server.stop()
