"""Speculative rounds of the port's decode scheduler
(seldon_core_tpu_torch/serving/decode_scheduler.py) held to the JAX
package's speculation contracts (tests/test_decode_scheduler.py,
tests/test_spec_tree.py) on the CPU.

The load-bearing one: greedy output with a k-chain or a token tree is, token
for token, the port's fused ``generate`` and the JAX package's speculative
scheduler on the same weights, for a draft that accepts most proposals and
for one that accepts almost none. Plus the degenerate tree as the chain, the
per-request tags, no new dispatch key over mixed traffic, EOS inside an
accepted burst, the accept floor, composition with int8 pages, prefix
reuse and chunked prefill, the validation messages and the serving wiring.
"""

import asyncio
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seldon_core_tpu.models import decoder as jd
from seldon_core_tpu.serving.decode_scheduler import DecodeScheduler as JaxDecodeScheduler
from seldon_core_tpu_torch.core.errors import APIException
from seldon_core_tpu_torch.core.message import Meta, SeldonMessage
from seldon_core_tpu_torch.graph.defaulting import decode_problems
from seldon_core_tpu_torch.graph.spec import PredictorSpec, TpuSpec
from seldon_core_tpu_torch.models import decoder as td
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.serving.decode_scheduler import DecodeScheduler, _TreeAutoTuner
from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

SEQ = 8
MAX_NEW = 10
VOCAB = 128
CPU = torch.device("cpu")
DEPLOYMENTS = Path(__file__).resolve().parent.parent / "seldon_core_tpu_torch" / "deployments"


def _np_params(layers=2, seed=3, resid_scale=0.1):
    return jd.init_decoder(seed=seed, vocab=VOCAB, hidden=64, layers=layers, ffn=128, max_len=64,
                           resid_scale=resid_scale)


DRAFTS = {
    # the seed-shared 1-of-2-layer truncation: most proposals accepted
    "high_accept": lambda: _np_params(layers=1),
    # no relation to the target: almost every proposal rejected
    "low_accept": lambda: _np_params(layers=1, seed=99, resid_scale=1.0),
}


@pytest.fixture(scope="module")
def target():
    p = _np_params()
    return p, params_to_torch(p, CPU)


def _prompts(n, seed=1):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, SEQ)).astype(np.int32)


def _scheduler(tp, draft=None, n_slots=2, **kw) -> DecodeScheduler:
    if draft is not None:
        kw["draft_params"] = params_to_torch(draft, CPU)
    s = DecodeScheduler(tp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=n_slots, **kw)
    s.warmup()
    return s


def _oracle(tp, ids, max_new=MAX_NEW):
    with torch.inference_mode():
        return td.generate(tp, torch.from_numpy(ids), max_new).numpy()


@pytest.mark.parametrize("shape", ["chain", "tree"])
@pytest.mark.parametrize("pair", sorted(DRAFTS))
async def test_greedy_equals_generate_and_the_jax_scheduler(target, shape, pair):
    """Four prompts through two slots (mid-stream admission, slot reuse):
    every row equals the port's generate, the JAX package's generate and
    the JAX speculative scheduler's output on the same weights."""
    jp, tp = target
    draft = DRAFTS[pair]()
    kw = {"spec_k": 3} if shape == "chain" else {"spec_tree": "2,2,1"}
    ids = _prompts(4, seed=21)
    oracle = _oracle(tp, ids)
    np.testing.assert_array_equal(oracle, np.asarray(jd.generate(jp, jnp.asarray(ids), MAX_NEW)))
    sched = _scheduler(tp, draft, **kw)
    outs = await asyncio.gather(*(sched.submit(row) for row in ids))
    jsched = JaxDecodeScheduler(jp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=2, draft_params=draft, **kw)
    jsched.warmup()
    jouts = await asyncio.gather(*(jsched.submit(row) for row in ids))
    await jsched.close()
    for row, out, jout in zip(oracle, outs, jouts):
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out, row)
        np.testing.assert_array_equal(out, jout)
    assert sched.stat_spec_dispatches > 0 and sched.recompiles_since_warmup() == 0
    rate = sched.stat_spec_accepted / sched.stat_spec_proposed
    if pair == "high_accept":
        assert rate > 0.5 and sched.stat_spec_ride_emitted / sched.stat_spec_rides > 1.5
    else:
        assert rate < 0.2
    assert sched.stat_spec_rides <= sched.stat_spec_ride_emitted <= sched.stat_spec_emitted
    sched.pool.alloc.check()
    await sched.close()


async def test_degenerate_tree_equals_the_chain(target):
    """'1,1,1,1' is the chain at k=4: the tree programs' output equals the
    chain programs' and the oracle."""
    _, tp = target
    draft = DRAFTS["high_accept"]()
    ids = _prompts(3, seed=31)
    oracle = _oracle(tp, ids)
    outs = {}
    for name, kw in (("chain", {"spec_k": 4}), ("tree", {"spec_tree": "1,1,1,1"})):
        sched = _scheduler(tp, draft, **kw)
        assert sched.spec_k == 4 and (sched.spec_tree is None) == (name == "chain")
        outs[name] = await asyncio.gather(*(sched.submit(row) for row in ids))
        assert sched.stat_spec_dispatches > 0
        await sched.close()
    for row, c, t in zip(oracle, outs["chain"], outs["tree"]):
        np.testing.assert_array_equal(c, row)
        np.testing.assert_array_equal(t, row)


async def test_spec_k0_opt_out_and_tighten_only_tags(target):
    """spec_k=0 opts a request out (an all-opted-out workload runs only
    plain steps); spec_k and spec_tree clamp tighten-only; a malformed
    spec_tree is a 400 at submit; the tags parse from meta.tags."""
    _, tp = target
    draft = DRAFTS["high_accept"]()
    ids = _prompts(4, seed=41)
    oracle = _oracle(tp, ids)
    sched = _scheduler(tp, draft, spec_k=3)
    outs = await asyncio.gather(*(sched.submit(row, spec_k=0) for row in ids[:2]))
    assert sched.stat_spec_dispatches == 0 and sched.stat_steps > 0
    outs += await asyncio.gather(sched.submit(ids[2], spec_k=100), sched.submit(ids[3], spec_k=0))
    assert sched.stat_spec_dispatches > 0
    for row, out in zip(oracle, outs):
        np.testing.assert_array_equal(out, row)
    assert sched.request_params_from_meta(Meta(tags={"spec_k": "2", "spec_tree": "1,1"})) == {
        "spec_k": 2, "spec_tree": "1,1"}
    with pytest.raises(APIException, match="meta.tags.spec_k must be a number"):
        sched.request_params_from_meta(Meta(tags={"spec_k": "x"}))
    await sched.close()

    tree = _scheduler(tp, draft, spec_tree="2,2,1")
    with pytest.raises(APIException, match="spec_tree") as e:
        await tree.submit(ids[0], spec_tree="4,nope")
    assert e.value.error.http_status == 400
    before = tree.stat_spec_dispatches
    np.testing.assert_array_equal(await tree.submit(ids[0], spec_tree="0"), oracle[0])  # full opt-out
    assert tree.stat_spec_dispatches == before
    for tag in ("9,9,9", "2,0,5", "1"):
        np.testing.assert_array_equal(await tree.submit(ids[1], spec_tree=tag), oracle[1])
    assert tree.stat_spec_dispatches > before
    await tree.close()


@pytest.mark.parametrize("shape", ["chain", "tree"])
async def test_no_new_dispatch_key_over_mixed_traffic(target, shape):
    """Plain opt-outs, tightened chains and trees, sampled rows, short
    budgets and a prefill chunk tighten: warmup dispatched every key."""
    _, tp = target
    kw = {"spec_k": 3} if shape == "chain" else {"spec_tree": "2,2,1"}
    sched = _scheduler(tp, DRAFTS["high_accept"](), n_slots=3, prefill_chunk=4, **kw)
    counts = sched.compile_counts()
    spec_keys = ("draft", "verify") if shape == "chain" else ("draft_tree", "tree_verify")
    assert counts == {"step": 1, "chunk": len(sched.chunk_buckets), "copy": len(sched.pool.copy_buckets),
                      "draft_admit": len(sched.admit_buckets), spec_keys[0]: 1, spec_keys[1]: 1}
    ids = _prompts(8, seed=2)
    oracle = _oracle(tp, ids)
    variants = [{}, {"spec_k": 0}, {"spec_k": 1}, {"spec_tree": "1,1,1"}, {"spec_tree": "2"},
                {"temperature": 0.7, "top_k": 3}, {"max_new_tokens": 3}, {"prefill_chunk": 1}]
    outs = await asyncio.gather(*(sched.submit(row, **variants[i]) for i, row in enumerate(ids)))
    for i, (row, out) in enumerate(zip(oracle, outs)):
        if "temperature" not in variants[i]:
            np.testing.assert_array_equal(out, row[: SEQ + variants[i].get("max_new_tokens", MAX_NEW)])
    assert sched.recompiles_since_warmup() == 0, sched.compile_counts()
    await sched.close()


@pytest.mark.parametrize("shape", ["chain", "tree"])
async def test_sampled_top_k1_is_the_greedy_oracle(target, shape):
    """temperature > 0 with top_k=1 drives the sampled acceptance (p/q
    ratios, residual resampling, bonus draws) through one-hot
    distributions: the tokens must be the greedy oracle's."""
    _, tp = target
    kw = {"spec_k": 3} if shape == "chain" else {"spec_tree": "2,2,1"}
    sched = _scheduler(tp, DRAFTS["high_accept"](), **kw)
    ids = _prompts(3, seed=5)
    outs = await asyncio.gather(*(sched.submit(row, temperature=5.0, top_k=1) for row in ids))
    for row, out in zip(_oracle(tp, ids), outs):
        np.testing.assert_array_equal(out, row)
    assert sched.stat_spec_dispatches > 0
    await sched.close()


async def test_eos_retires_inside_an_accepted_burst(target):
    """An EOS that arrives as an accepted draft token (not the round's
    bonus) ends the row there: nothing after it is emitted, and every
    emitted token was counted once."""
    _, tp = target
    ids = _prompts(1, seed=1)
    oracle = _oracle(tp, ids)[0]
    # this prompt's third generated token is the first of a run that the
    # draft predicts: the round that emits it accepts it as a draft token
    eos = int(oracle[SEQ + 2])
    assert eos not in oracle[SEQ : SEQ + 2]
    sched = _scheduler(tp, DRAFTS["high_accept"](), spec_k=4, eos_id=eos)
    seen = []
    out = await sched.submit(ids[0], on_token=lambda tok, idx: seen.append((idx, tok)))
    np.testing.assert_array_equal(out, oracle[: SEQ + 3])
    assert seen == [(i, int(t)) for i, t in enumerate(oracle[SEQ : SEQ + 3])]
    # the first token comes from the prompt's chunk round, the rest from
    # speculative rounds; a round that emitted fewer than its accepted + 1
    # tokens was cut at the EOS
    assert sched.stat_spec_emitted == len(out) - SEQ - 1
    assert sched.stat_spec_accepted >= 1
    assert sched.stat_spec_emitted < sched.stat_spec_accepted + sched.stat_spec_dispatches
    assert sched.active == 0
    await sched.close()


def test_tree_autotuner_matches_jax_policy():
    """The controller is the JAX package's: the same decisions over the
    same observation sequence (depth degrade, probes, width narrowing and
    recovery)."""
    from seldon_core_tpu.models.spec_tree import SpecTree as JaxTree
    from seldon_core_tpu.serving.decode_scheduler import _TreeAutoTuner as JaxTuner
    from seldon_core_tpu_torch.models.spec_tree import SpecTree

    rng = np.random.default_rng(0)
    ours = _TreeAutoTuner(0.4, 3, SpecTree.from_text("4,3,2"), alpha=0.5, probe_every=4)
    theirs = JaxTuner(0.4, 3, JaxTree.from_text("4,3,2"), alpha=0.5, probe_every=4)
    for r in range(80):
        assert ours.decide() == theirs.decide(), r
        phase = (r // 20) % 2  # alternating bad and good stretches
        paths = [(int(rng.integers(0, 2 if phase == 0 else 4)), 3) for _ in range(2)]
        accepted = sum(a for a, _ in paths)
        ours.update(accepted, 6, paths=paths)
        theirs.update(accepted, 6, paths=paths)
        assert ours.rate == pytest.approx(theirs.rate) and ours.reach == pytest.approx(theirs.reach)
    assert ours.probes == theirs.probes > 0


async def test_accept_floor_degrades_to_plain_rounds(target):
    """A draft that accepts almost nothing under an accept floor: the rate
    estimate falls below the floor within one generation, later traffic
    runs plain rounds (speculative rounds only as probes), and greedy
    output stays the oracle's."""
    _, tp = target
    ids = _prompts(6, seed=23)
    oracle = _oracle(tp, ids)
    sched = _scheduler(tp, DRAFTS["low_accept"](), spec_tree="2,2,1", spec_accept_floor=0.6)
    outs = await asyncio.gather(*(sched.submit(row) for row in ids[:2]))
    assert sched._adapt.rate < 0.6
    spec_before, rounds_before = sched.stat_spec_dispatches, sched.stat_steps
    outs += await asyncio.gather(*(sched.submit(row) for row in ids[2:]))
    for row, out in zip(oracle, outs):
        np.testing.assert_array_equal(out, row)
    spec_growth = sched.stat_spec_dispatches - spec_before
    assert spec_growth <= max(1, (sched.stat_steps - rounds_before) // 4)
    assert sched.recompiles_since_warmup() == 0
    await sched.close()


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
async def test_tree_over_paged_prefix_and_chunks_equals_plain(target, kv_dtype):
    """Composition: tree speculation over small pages (int8 or fp), a warm
    prefix cache and chunked prefill emits the plain scheduler's tokens,
    cold and warm, with copy-on-write, and the allocator's audit holds."""
    _, tp = target
    head = np.random.default_rng(17).integers(0, VOCAB, 5)
    ids = np.stack([np.concatenate([head, np.random.default_rng(s).integers(0, VOCAB, SEQ - 5)])
                    for s in range(4)]).astype(np.int32)
    kw = dict(n_slots=2, kv_page_size=4, kv_dtype=kv_dtype, prefix_slots=4, prefill_chunk=4)
    plain = _scheduler(tp, **kw)
    want = [await plain.submit(ids[0], cache_prefix=5)] + await asyncio.gather(*(plain.submit(r) for r in ids[1:]))
    await plain.close()
    sched = _scheduler(tp, DRAFTS["high_accept"](), spec_tree="2,1", **kw)
    got = [await sched.submit(ids[0], cache_prefix=5)] + await asyncio.gather(*(sched.submit(r) for r in ids[1:]))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert sched.stat_spec_dispatches > 0 and sched.stat_prefix_hits > 0
    assert sched.recompiles_since_warmup() == 0
    sched.pool.alloc.check()
    await sched.close()


def test_ctor_refusals():
    tp = params_to_torch(_np_params(), CPU)
    dp = params_to_torch(DRAFTS["high_accept"](), CPU)
    kw = dict(seq_len=SEQ, max_new_tokens=MAX_NEW)
    with pytest.raises(ValueError, match="needs a draft model"):
        DecodeScheduler(tp, spec_k=2, **kw)
    with pytest.raises(ValueError, match="needs a draft model"):
        DecodeScheduler(tp, spec_tree="2,1", **kw)
    with pytest.raises(ValueError, match="caps at 64"):
        DecodeScheduler(tp, draft_params=dp, spec_tree="9,9", **kw)
    with pytest.raises(ValueError, match="widened-verify headroom"):
        DecodeScheduler(tp, draft_params=dp, spec_k=65, **kw)
    wrong_vocab = params_to_torch(jd.init_decoder(seed=3, vocab=96, hidden=64, layers=1, ffn=128, max_len=64), CPU)
    with pytest.raises(ValueError, match="shared vocabulary"):
        DecodeScheduler(tp, draft_params=wrong_vocab, spec_k=2, **kw)
    short = params_to_torch(jd.init_decoder(seed=3, vocab=VOCAB, hidden=64, layers=1, ffn=128, max_len=12), CPU)
    with pytest.raises(ValueError, match="draft position table"):
        DecodeScheduler(tp, draft_params=short, spec_k=2, **kw)
    # a draft without a depth is no speculation
    assert not DecodeScheduler(tp, draft_params=dp, **kw).spec_enabled


# ------------------------------------------------------------ validation

BAD_SPECS = [
    dict(decode_slots=4, decode_draft_model="zoo://draft", decode_spec_tree="4,x"),
    dict(decode_slots=4, decode_draft_model="zoo://draft", decode_spec_tree="9,9"),
    dict(decode_slots=4, decode_draft_model="zoo://draft", decode_spec_k=65),
    dict(decode_draft_model="zoo://draft", decode_spec_tree="2,1"),
    dict(decode_slots=4, decode_spec_tree="2,1"),
    dict(decode_slots=4, decode_spec_k=-1),
    dict(decode_slots=4, decode_draft_model="zoo://draft", decode_spec_k=2, decode_spec_accept_floor=1.5),
    dict(decode_slots=4, decode_spec_accept_floor=0.5),
    dict(decode_spec_k=3),
]


@pytest.mark.parametrize("tpu", BAD_SPECS + [dict(decode_slots=4, decode_draft_model="zoo://draft",
                                                  decode_spec_k=4, decode_spec_accept_floor=0.5)])
def test_decode_problems_give_the_jax_validation_messages(tpu):
    from seldon_core_tpu.graph.defaulting import default_deployment
    from seldon_core_tpu.graph.spec import SeldonDeployment
    from seldon_core_tpu.graph.validation import ValidationError, validate_deployment

    dep = default_deployment(SeldonDeployment.from_dict({"spec": {"name": "d", "predictors": [
        {"name": "p", "graph": {"name": "m", "type": "MODEL", "implementation": "JAX_MODEL"}, "tpu": tpu}]}}))
    try:
        validate_deployment(dep)
        want = []
    except ValidationError as e:
        want = [p for p in e.problems if "decode_spec" in p or "decode_draft" in p]
    got = decode_problems("p", TpuSpec.from_dict(tpu))
    assert got == want
    assert bool(got) == (tpu in BAD_SPECS)


# -------------------------------------------------------- serving wiring


def _predictor(**tpu_extra) -> PredictorSpec:
    return PredictorSpec.from_dict({
        "name": "p",
        "graph": {
            "name": "gpt", "type": "MODEL", "implementation": "JAX_MODEL",
            "parameters": [
                {"name": "model", "value": "tiny_gpt", "type": "STRING"},
                {"name": "seq", "value": str(SEQ), "type": "INT"},
                {"name": "max_new_tokens", "value": "6", "type": "INT"},
                {"name": "vocab", "value": str(VOCAB), "type": "INT"},
                {"name": "resid_scale", "value": "0.1", "type": "FLOAT"},
            ],
        },
        "tpu": {"max_batch": 4, "batch_buckets": [4], "decode_slots": 2, **tpu_extra},
    })


@pytest.mark.parametrize("tpu,reason", [
    ({"decode_draft_model": "zoo://draft?resid_scale=0.1"}, "needs BOTH"),
    ({"decode_draft_model": "zoo://iris_mlp", "decode_spec_k": 2}, "not a decoder"),
])
def test_serving_warns_and_disables(tpu, reason, caplog):
    server = PredictorServer(_predictor(**tpu), device="cpu")
    assert server.decode_scheduler is not None and not server.decode_scheduler.spec_enabled
    assert reason in caplog.text


@pytest.mark.parametrize("query,features", [("features=1&", True), ("", False)], ids=["feature_head", "truncated"])
def test_zoo_refuses_unported_draft_kinds_by_name(query, features, tmp_path):
    """``zoo://draft?distilled=`` as the JAX package serves it, for both
    kinds: a missing checkpoint fails the server's build with the JAX
    zoo's error type, and a checkpoint the JAX package wrote (from another
    seed, at the geometry the scheduler injects from the target) serves
    with exactly its weights."""
    from seldon_core_tpu.models.zoo import get_model as jax_get_model
    from seldon_core_tpu.training.distill_draft import flatten_params as jax_flatten
    from seldon_core_tpu.training.distill_draft import save_draft_checkpoint as jax_save
    from seldon_core_tpu_torch.training.distill_draft import flatten_params

    geom = {"vocab": VOCAB, "max_len": 128, **({"hidden": 128, "ffn": 256} if features else {})}
    missing = str(tmp_path / "missing.npz")
    with pytest.raises(FileNotFoundError):
        jax_get_model("draft", **geom, **({"features": 1} if features else {}), distilled=missing)
    with pytest.raises(FileNotFoundError):
        PredictorServer(_predictor(decode_draft_model=f"zoo://draft?{query}distilled={missing}", decode_spec_k=2),
                        device="cpu")
    ck = str(tmp_path / "d.npz")
    jax_save(ck, jax_get_model("draft", seed=5, **geom, **({"features": 1} if features else {})).params)
    server = PredictorServer(_predictor(decode_draft_model=f"zoo://draft?{query}distilled={ck}", decode_spec_k=2),
                             device="cpu")
    sched = server.decode_scheduler
    assert sched.spec_enabled and td.is_feature_draft(sched.draft_params) == features
    want = jax_flatten(jax_get_model("draft", **geom, **({"features": 1} if features else {}), distilled=ck).params)
    got = flatten_params(sched.draft_params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


async def test_speculative_serving_through_the_server():
    """TpuSpec knobs -> scheduler_for_executor: the draft takes the target's
    vocab and max_len; the buffered reply equals the fused zoo apply of the
    same weights, with and without meta.tags.spec_k = 0."""
    server = PredictorServer(_predictor(decode_draft_model="zoo://draft?resid_scale=0.1", decode_spec_k=3),
                             device="cpu")
    sched = server.decode_scheduler
    assert sched.spec_enabled and sched.spec_k == 3 and sched.draft_params["tok_emb"].shape[0] == VOCAB
    torch.testing.assert_close(sched.draft_params["layers"][0]["qkv"]["w"], sched.params["layers"][0]["qkv"]["w"])
    server.warmup()
    try:
        ids = _prompts(3, seed=7)
        runtime = server.executor.root.unit.runtime
        want = runtime.predict(ids)
        out = await server.service.predict(SeldonMessage.from_array(ids))
        np.testing.assert_array_equal(np.asarray(out.array), want)
        assert sched.stat_spec_dispatches > 0
        before = sched.stat_spec_dispatches
        out = await server.service.predict(SeldonMessage.from_array(ids[:1], meta=Meta(tags={"spec_k": 0})))
        np.testing.assert_array_equal(np.asarray(out.array), want[:1])
        assert sched.stat_spec_dispatches == before
        assert sched.recompiles_since_warmup() == 0
    finally:
        await server.stop()


@pytest.mark.parametrize("name", ["tiny_gpt_speculative", "tiny_gpt_tree_speculation", "gpt2_small_speculative"])
def test_deployment_files_build_on_the_cpu(name):
    """The three speculative deployments parse, pass validation and build a
    speculating scheduler on the CPU (the GPT-2-small one is built, not
    served: its widths are the card's)."""
    path = DEPLOYMENTS / f"{name}.json"
    predictor, _ = load_predictor(str(path))
    assert decode_problems(predictor.name, predictor.tpu) == []
    server = PredictorServer(predictor, device="cpu")
    sched = server.decode_scheduler
    assert sched is not None and sched.spec_enabled
    dep = json.loads(path.read_text())["spec"]["predictors"][0]["tpu"]
    if "decode_spec_tree" in dep:
        assert sched.spec_tree.branching == tuple(int(b) for b in dep["decode_spec_tree"].split(","))
    else:
        assert sched.spec_tree is None and sched.spec_k == dep["decode_spec_k"]
    dims, ddims = td.decoder_dims(sched.params), td.decoder_dims(sched.draft_params)
    assert (ddims["vocab"], ddims["max_len"], ddims["hidden"]) == (dims["vocab"], dims["max_len"], dims["hidden"])
    assert ddims["layers"] < dims["layers"]
    assert sched.draft_params["tok_emb"].dtype == torch.float32
    if name == "gpt2_small_speculative":
        assert (dims["vocab"], dims["hidden"], dims["layers"], dims["heads"]) == (50257, 768, 12, 12)
        assert sched.params["tok_emb"].dtype == torch.bfloat16 and sched.n_slots == 8


# ---------------------------------------------------------- pipelined rounds


async def _staggered(sched, ids, stagger=0.002, **kw):
    async def one(i):
        await asyncio.sleep(i * stagger)
        return await sched.submit(ids[i], **kw)

    return await asyncio.gather(*(one(i) for i in range(len(ids))))


@pytest.mark.parametrize("shape", ["chain", "tree"])
async def test_pipelined_spec_rounds_bit_identical(target, shape):
    """Speculative rounds through the pipelined twin (the greedy pair and
    its readback queued from the loop's thread, the window, then the wait):
    chain and tree rows equal the serial loop's, the port's generate and
    the JAX package's generate, bit for bit."""
    jp, tp = target
    ids = _prompts(4, seed=17)
    kw = {"spec_tree": "2,2,1"} if shape == "tree" else {"spec_k": 3}
    oracle = _oracle(tp, ids)
    np.testing.assert_array_equal(oracle, np.asarray(jd.generate(jp, jnp.asarray(ids), MAX_NEW)))
    serial = _scheduler(tp, DRAFTS["high_accept"](), **kw)
    serial.pipeline_enabled = False
    serial_outs = await _staggered(serial, ids)
    await serial.close()
    piped = _scheduler(tp, DRAFTS["high_accept"](), **kw)
    outs = await _staggered(piped, ids)
    for a, b, row in zip(serial_outs, outs, oracle):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, row)
    assert piped.stat_spec_dispatches > 0 and piped.stat_pipelined_rounds > 0
    assert serial.stat_pipelined_rounds == 0
    assert piped.recompiles_since_warmup() == 0
    piped.pool.alloc.check()
    await piped.close()


@pytest.mark.parametrize("shape", ["chain", "tree"])
async def test_pipelined_sampled_rows_equal_the_serial_loop(target, shape):
    """Sampled speculative rounds run their eager pair on the worker while
    the window runs on the loop: with every request admitted in the same
    round (all submitted at once, a slot each), the sampled rows of the two
    loops are identical, draws per (seed, tick, stream) unchanged."""
    _, tp = target
    ids = _prompts(3, seed=29)
    kw = {"spec_tree": "2,2,1"} if shape == "tree" else {"spec_k": 3}
    rows = {}
    for pipe in (False, True):
        s = _scheduler(tp, DRAFTS["high_accept"](), n_slots=3, seed=11, **kw)
        s.pipeline_enabled = pipe
        rows[pipe] = await asyncio.gather(*(s.submit(row, temperature=0.9, top_k=8) for row in ids))
        assert s.stat_eager_rounds > 0 and s.stat_spec_dispatches > 0
        assert (s.stat_pipelined_rounds > 0) == pipe
        s.pool.alloc.check()
        await s.close()
    for a, b in zip(rows[False], rows[True]):
        np.testing.assert_array_equal(a, b)
