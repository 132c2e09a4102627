"""The port's host and store KV tiers (seldon_core_tpu_torch/serving/
kv_host_tier.py, persistence/state.py, the allocator's preseed_pin and the
decode scheduler's demotion and promotion) held to the JAX package's
contracts (tests/test_kv_tier.py, but for the sibling pull, which waits for
the fleet) on the CPU:

- the tier and the allocator, driven in lockstep with the JAX package's
  through the same operations, end in the same state;
- a device eviction (pin reclaim or the index's LRU cap) demotes the
  entry's bytes, a later miss promotes them back, and greedy ids stay
  bit-identical to a cold prefill and to the JAX oracle (fp and int8 pools,
  plain and tree rounds, pipelined and serial loops), with no new key;
- the store tier, ``meta.tags.kv_tier``, a corrupt store entry, the spec
  rules and the serving wiring.
"""

import asyncio
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.models import decoder as jd
from seldon_core_tpu.persistence.state import FileStateStore as JaxFileStateStore
from seldon_core_tpu.serving.kv_host_tier import KVHostTier as JaxKVHostTier
from seldon_core_tpu.serving.kv_host_tier import tier_store_key as jax_tier_store_key
from seldon_core_tpu.serving.kv_pool import PageAllocator as JaxPageAllocator
from seldon_core_tpu_torch.core.errors import APIException
from seldon_core_tpu_torch.core.message import Meta
from seldon_core_tpu_torch.graph.defaulting import decode_problems
from seldon_core_tpu_torch.graph.spec import PredictorSpec, TpuSpec
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.persistence.state import FileStateStore, make_state_store, state_key
from seldon_core_tpu_torch.serving import decode_scheduler
from seldon_core_tpu_torch.serving.decode_scheduler import DecodeScheduler
from seldon_core_tpu_torch.serving.kv_host_tier import KVHostTier, tier_store_key
from seldon_core_tpu_torch.serving.kv_pool import PageAllocator
from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

SEQ = 8
MAX_NEW = 6
VOCAB = 128
HOST_BUDGET = 1 << 26  # ample for the tiny pools
CPU = torch.device("cpu")
DEPLOYMENTS = Path(__file__).resolve().parent.parent / "seldon_core_tpu_torch" / "deployments"


def _np_params(**kw):
    return jd.init_decoder(seed=3, vocab=VOCAB, hidden=64, layers=2, ffn=128, max_len=64, **kw)


@pytest.fixture(scope="module")
def params():
    """(numpy params, the port's tensors, the JAX greedy oracle)."""
    p = _np_params()
    gen = jax.jit(jd.generate, static_argnums=2)
    return p, params_to_torch(p, CPU), lambda ids: np.asarray(gen(p, jnp.asarray(ids), MAX_NEW))


def _scheduler(tp, n_slots=2, **kw) -> DecodeScheduler:
    s = DecodeScheduler(tp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=n_slots, **kw)
    s.warmup()
    return s


def _prompts(n, seed=1):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, SEQ)).astype(np.int32)


def _fake_comps(n_pages, fill=1.0):
    # one pool-component lookalike [L, n_pages, h, page_size, hd]
    return [np.full((2, n_pages, 2, 4, 4), fill, np.float32)]


# ------------------------------------------------------------- tier unit


def test_store_keys_and_files_match_the_jax_package(tmp_path):
    """The store half is the reference's: the same key for a span, the same
    file for a key, so a store written by one package serves the other."""
    tokens = np.arange(8, dtype=np.int32)
    assert tier_store_key("d", tokens) == jax_tier_store_key("d", tokens)
    assert state_key("d", "u") == "persistence_d_u"
    ours, theirs = FileStateStore(str(tmp_path)), JaxFileStateStore(str(tmp_path))
    ours.save("a/b", b"x")
    assert theirs.load("a/b") == b"x" and ours.load("a_b") is None
    with pytest.raises(ValueError, match="unknown state store url"):
        make_state_store("bogus://x")
    assert make_state_store("") is None


def test_relative_file_store_resolves_against_the_working_directory(tmp_path, monkeypatch):
    """``file://<relative dir>`` is a directory of the working directory
    the store was made in, wherever the process moves afterwards."""
    monkeypatch.chdir(tmp_path)
    store = make_state_store("file://kv_tier_store")
    assert store.directory == str(tmp_path / "kv_tier_store")
    monkeypatch.chdir(tmp_path.parent)
    store.save("k", b"x")
    assert FileStateStore(str(tmp_path / "kv_tier_store")).load("k") == b"x"


def _tiers(tmp_path, budget):
    return [cls(budget, page_size=4, store=store_cls(str(tmp_path / name)), deployment="t")
            for cls, store_cls, name in ((KVHostTier, FileStateStore, "port"),
                                         (JaxKVHostTier, JaxFileStateStore, "jax"))]


def test_host_tier_put_probe_fetch_and_lru_spill_like_jax(tmp_path):
    """The JAX test's sequence on both tiers in lockstep: every answer and
    the final snapshots agree."""
    entry_bytes = _fake_comps(1)[0].nbytes
    a, b, c = (np.arange(i, i + 4, dtype=np.int32) for i in (0, 4, 8))
    ab = np.concatenate([a, np.arange(100, 104, dtype=np.int32)])
    results = []
    for tier in _tiers(tmp_path, 2 * entry_bytes):
        out = [tier.put(a, _fake_comps(1, 1.0)), tier.put(b, _fake_comps(1, 2.0)), len(tier), tier.host_bytes,
               tier.probe(np.concatenate([a, a])), tier.probe(c), tier.fetch(a) is not None,
               tier.put(c, _fake_comps(1, 3.0)), len(tier), tier.store_entries, tier.probe(b),
               tier.probe(b, include_store=False)]
        tokens, comps, src = tier.fetch(b)
        out += [src, tokens.tolist(), comps[0].tolist(), tier.stat_promotions_store,
                tier.put(b, _fake_comps(1)), tier.put(ab, _fake_comps(2)), tier.probe(ab), tier.snapshot()]
        results.append(out)
    assert results[0] == results[1]
    assert results[0][:12] == [True, True, 2, 2 * entry_bytes, 4, 0, True, True, 2, 1, 4, 0]
    assert results[0][12] == "store"


def test_host_tier_no_store_evicts_and_corrupt_store_degrades(tmp_path):
    entry_bytes = _fake_comps(1)[0].nbytes
    a, b = np.arange(4, dtype=np.int32), np.arange(4, 8, dtype=np.int32)
    tier = KVHostTier(entry_bytes, page_size=4, deployment="t")
    assert tier.put(a, _fake_comps(1)) and tier.put(b, _fake_comps(1))
    assert len(tier) == 1 and tier.stat_evictions == 1 and tier.probe(a) == 0
    store = FileStateStore(str(tmp_path))
    tier2 = KVHostTier(entry_bytes, page_size=4, store=store, deployment="t")
    assert tier2.put(a, _fake_comps(1)) and tier2.put(b, _fake_comps(1))  # a spills
    assert tier2.store_entries == 1
    store.save(tier_store_key("t", a), b"not a pickle")
    assert tier2.fetch(a) is None
    assert tier2.store_entries == 0 and tier2.stat_store_drops == 1
    assert tier2.put(a, _fake_comps(1)) and tier2.put(b, _fake_comps(1))
    store.save(tier_store_key("t", a), pickle.dumps({"page_size": 999, "kv_dtype": "", "tokens": a,
                                                     "components": _fake_comps(1)}))
    assert tier2.fetch(a) is None and tier2.stat_store_drops == 2


def test_partial_page_spans_clamp_down():
    tier = KVHostTier(1 << 20, page_size=4, deployment="t")
    assert not tier.put(np.arange(3, dtype=np.int32), _fake_comps(1))
    assert tier.put(np.arange(6, dtype=np.int32), _fake_comps(1))
    assert tier.probe(np.arange(6, dtype=np.int32)) == 4


def test_allocator_tier_soak_in_lockstep_with_jax():
    """The JAX package's 10k-operation soak (admit, write, capture, demote,
    promote through preseed_pin, retire, sibling pull) on the port's
    allocator and tier and on the JAX package's, in lockstep: every answer
    and the allocators' states agree, the consistency audit holds every 50
    operations, and the drain leaks nothing."""
    rng = np.random.default_rng(7)
    n_slots, ps, pps = 4, 4, 5
    allocs = [cls(n_pages=3 * pps + 2, page_size=ps, n_slots=n_slots, pages_per_slot=pps)
              for cls in (PageAllocator, JaxPageAllocator)]
    tiers = [cls(1 << 16, page_size=ps, deployment="soak") for cls in (KVHostTier, JaxKVHostTier)]
    siblings = [cls(1 << 16, page_size=ps, deployment="soak2") for cls in (KVHostTier, JaxKVHostTier)]
    cursor, forked = [-1] * n_slots, [False] * n_slots
    pins: list = []  # ((port pin, JAX pin), token span): demotable device entries
    known: list = []  # token spans the tiers may hold
    serial = [0]

    def _span(n_tokens):
        serial[0] += 1
        return np.full(n_tokens, serial[0] % (1 << 30), np.int32)

    def both(fn, *per):
        """``fn`` on each allocator (with its own pin of each pair in
        ``per``): the same answer from both, pins compared by their pages."""
        out = [fn(al, *(pair[i] for pair in per)) for i, al in enumerate(allocs)]
        a, b = (getattr(o, "pages", o) for o in out)
        assert a == b
        return out

    for step in range(10_000):
        free_slots = [s for s in range(n_slots) if cursor[s] < 0]
        busy = [s for s in range(n_slots) if cursor[s] >= 0]
        r = rng.random()
        if r < 0.22 and free_slots:
            slot = int(rng.choice(free_slots))
            if pins and rng.random() < 0.5:
                pair, _ = pins[int(rng.integers(len(pins)))]
                reuse = int(rng.integers(1, len(pair[0].pages) * ps + 1))
                ok = both(lambda al, pin: al.try_admit(slot, pin.pages, reuse, extra_reserve=1), pair)[0]
                start = reuse
            else:
                ok = both(lambda al: al.try_admit(slot, (), 0, extra_reserve=1))[0]
                start = 0
            if ok:
                cursor[slot], forked[slot] = start, False
        elif r < 0.47 and busy:
            slot = int(rng.choice(busy))
            count = int(rng.integers(1, ps + 2))
            both(lambda al: al.prepare_write(slot, cursor[slot], count))
            cursor[slot] = min(cursor[slot] + count, pps * ps)
        elif r < 0.60 and busy:
            slot = int(rng.choice(busy))
            upto = min(cursor[slot], 12)
            if upto >= 1 and not forked[slot]:
                length = int(rng.integers(1, upto + 1))
                got = both(lambda al: al.capture(slot, length))
                if got[0] is not None:
                    pins.append((tuple(got), _span(len(got[0].pages) * ps)))
                    forked[slot] = True
        elif r < 0.72 and pins:
            pair, span = pins.pop(int(rng.integers(len(pins))))
            if pair[0].pin_id in allocs[0]._pins:
                assert tiers[0].put(span, _fake_comps(len(pair[0].pages))) == \
                    tiers[1].put(span, _fake_comps(len(pair[1].pages)))
                known.append(span)
                both(lambda al, pin: al.release(pin.pin_id), pair)
        elif r < 0.84 and known:
            span = known[int(rng.integers(len(known)))]
            got = [t.fetch(span) for t in tiers]
            assert (got[0] is None) == (got[1] is None)
            if got[0] is not None:
                n = len(got[0][0]) // ps
                pair = both(lambda al: al.preseed_pin(n))
                if pair[0] is not None:
                    pins.append((tuple(pair), _span(n * ps)))
        elif r < 0.92 and busy:
            slot = int(rng.choice(busy))
            both(lambda al: al.retire(slot))
            cursor[slot] = -1
        elif known:
            span = known[int(rng.integers(len(known)))]
            for tier, sib in zip(tiers, siblings):
                got = tier.fetch(span)
                if got is not None:
                    sib.put(got[0], got[1])
        if step % 50 == 0:
            pins = [(pair, t) for pair, t in pins if pair[0].pin_id in allocs[0]._pins]
            for al in allocs:
                al.check()
            assert allocs[0].free_pages == allocs[1].free_pages
            assert np.array_equal(allocs[0].refs, allocs[1].refs)
            assert np.array_equal(allocs[0].block_tables, allocs[1].block_tables)
    pins = [(pair, t) for pair, t in pins if pair[0].pin_id in allocs[0]._pins]
    for slot in range(n_slots):
        if cursor[slot] >= 0:
            both(lambda al: al.retire(slot))
    for pair, _ in pins:
        both(lambda al, pin: al.release(pin.pin_id), pair)
    for al in allocs:
        al.check()
        assert al.free_pages == al.n_pages - 1, "pages leaked after the drain"
    assert tiers[0].snapshot() == tiers[1].snapshot() and siblings[0].snapshot() == siblings[1].snapshot()
    assert tiers[0].stat_demotions_host > 0 and tiers[0].stat_promotions_host > 0 and len(siblings[0]) > 0


# --------------------------------- bit-identity: warm-from-host == cold


async def _evict_then_resubmit(sched, ids, oracle, **resubmit_kw):
    """A (captured at retirement), then B (its capture evicts A's entry from
    the one-entry index, which demotes it), then A again (a device miss:
    promotion)."""
    np.testing.assert_array_equal(await sched.submit(ids[0]), oracle[0])
    np.testing.assert_array_equal(await sched.submit(ids[1]), oracle[1])
    assert sched.stat_tier_demotions >= 1, "the eviction did not demote"
    return await sched.submit(ids[0], **resubmit_kw)


@pytest.mark.parametrize("pipelined", [True, False])
async def test_warm_from_host_bit_identical_greedy_fp(params, pipelined):
    _, tp, oracle_fn = params
    ids = _prompts(2, seed=11)
    oracle = oracle_fn(ids)
    sched = _scheduler(tp, prefix_slots=1, kv_page_size=4, kv_host_bytes=HOST_BUDGET)
    sched.pipeline_enabled = pipelined
    out = await _evict_then_resubmit(sched, ids, oracle)
    np.testing.assert_array_equal(out, oracle[0])
    assert sched.stat_tier_promotions >= 1 and sched.stat_prefix_hits >= 1
    assert sched.flight.promotions_total >= 1
    assert sched.recompiles_since_warmup() == 0, sched.compile_counts()
    sched.pool.alloc.check()
    await sched.close()


async def test_warm_from_host_int8_matches_own_cold_output(params):
    """int8 pools sit within a tolerance of fp ones, but warm-from-host is
    bit-identical to the same scheduler's cold output: the scale and zero
    point planes ride verbatim."""
    _, tp, _ = params
    ids = _prompts(2, seed=13)
    sched = _scheduler(tp, prefix_slots=1, kv_page_size=4, kv_dtype="int8", kv_host_bytes=HOST_BUDGET)
    cold0 = await sched.submit(ids[0])
    await sched.submit(ids[1])
    assert sched.stat_tier_demotions >= 1
    np.testing.assert_array_equal(await sched.submit(ids[0]), cold0)
    assert sched.stat_tier_promotions >= 1
    assert sched.recompiles_since_warmup() == 0, sched.compile_counts()
    await sched.close()


async def test_warm_from_host_tree_spec_bit_identical():
    tgt = _np_params(resid_scale=0.1)
    drf = jd.init_decoder(seed=3, vocab=VOCAB, hidden=64, layers=1, ffn=128, max_len=64, resid_scale=0.1)
    ids = _prompts(2, seed=17)
    oracle = np.asarray(jd.generate(tgt, jnp.asarray(ids), MAX_NEW))
    sched = _scheduler(params_to_torch(tgt, CPU), draft_params=params_to_torch(drf, CPU), spec_tree="2,1",
                       prefix_slots=1, kv_page_size=4, kv_host_bytes=HOST_BUDGET)
    out = await _evict_then_resubmit(sched, ids, oracle)
    np.testing.assert_array_equal(out, oracle[0])
    assert sched.stat_tier_promotions >= 1 and sched.stat_spec_dispatches > 0
    assert sched.recompiles_since_warmup() == 0, sched.compile_counts()
    await sched.close()


async def test_store_tier_promotes_through_and_kv_tier_tag(params, tmp_path):
    """kv_host_bytes=1: every demotion falls through to the store; a
    resubmit promotes store -> device, bit-identical. kv_tier="host" skips
    the store, "off" skips promotion, anything else is a client error."""
    _, tp, oracle_fn = params
    ids = _prompts(2, seed=19)
    oracle = oracle_fn(ids)
    sched = _scheduler(tp, prefix_slots=1, kv_page_size=4, kv_host_bytes=1,
                       kv_store=make_state_store(f"file://{tmp_path}"))
    np.testing.assert_array_equal(await sched.submit(ids[0]), oracle[0])
    np.testing.assert_array_equal(await sched.submit(ids[1]), oracle[1])
    assert sched._host_tier.stat_demotions_store >= 1
    np.testing.assert_array_equal(await sched.submit(ids[0], kv_tier="host"), oracle[0])
    assert sched.stat_tier_promotions == 0
    np.testing.assert_array_equal(await sched.submit(ids[1], kv_tier="off"), oracle[1])
    assert sched.stat_tier_promotions == 0
    np.testing.assert_array_equal(await sched.submit(ids[0]), oracle[0])
    assert sched.stat_tier_promotions >= 1 and sched._host_tier.stat_promotions_store >= 1
    with pytest.raises(APIException):
        await sched.submit(ids[0], kv_tier="bogus")
    assert sched.recompiles_since_warmup() == 0, sched.compile_counts()
    await sched.close()


async def test_corrupt_store_entry_degrades_to_a_cold_prefill(params, tmp_path):
    _, tp, oracle_fn = params
    ids = _prompts(2, seed=21)
    oracle = oracle_fn(ids)
    sched = _scheduler(tp, prefix_slots=1, kv_page_size=4, kv_host_bytes=1,
                       kv_store=make_state_store(f"file://{tmp_path}"),
                       deployment_name="corrupt")
    await sched.submit(ids[0])
    await sched.submit(ids[1])  # A's entry is in the store now
    (key,) = [k for k in sched._host_tier._store_index if list(k) == ids[0][:len(k)].tolist()]
    sched._host_tier.store.save(sched._host_tier._store_index[key][0], b"garbage")
    np.testing.assert_array_equal(await sched.submit(ids[0]), oracle[0])
    assert sched._host_tier.stat_store_drops == 1 and sched.stat_tier_promotions == 0
    await sched.close()


async def test_pool_pressure_reclaim_demotes_not_loses(params):
    """The allocator-pressure path (_on_pins_reclaimed): a tight page budget
    reclaims prefix pins to admit new work; with the host tier they demote,
    and a resubmit promotes back bit-identically."""
    _, tp, oracle_fn = params
    ids = _prompts(4, seed=23)
    oracle = oracle_fn(ids)
    sched = _scheduler(tp, n_slots=2, prefix_slots=8, kv_page_size=4, kv_pages=10, kv_host_bytes=HOST_BUDGET)
    for i, row in enumerate(ids):
        np.testing.assert_array_equal(await sched.submit(row), oracle[i])
    assert sched.stat_tier_demotions >= 1, "the pressure reclaim did not demote"
    np.testing.assert_array_equal(await sched.submit(ids[0]), oracle[0])
    assert sched.stat_tier_promotions >= 1
    sched.pool.alloc.check()
    assert sched.recompiles_since_warmup() == 0, sched.compile_counts()
    await sched.close()


async def test_promotion_inside_the_overlap_window(params):
    """An admission decided under an in-flight step promotes inside the
    window (counted), and its ids equal the JAX oracle."""
    _, tp, oracle_fn = params
    ids = _prompts(3, seed=27)
    oracle = oracle_fn(ids)
    sched = _scheduler(tp, n_slots=2, prefix_slots=1, kv_page_size=4, kv_host_bytes=HOST_BUDGET)
    await sched.submit(ids[0])
    await sched.submit(ids[1])  # A demoted
    real, tasks = sched._overlap_window, []

    def window():
        if not tasks:  # A arrives while C's step is in flight
            tasks.append(asyncio.Task(sched.submit(ids[0]), loop=asyncio.get_running_loop(), eager_start=True))
        real()

    sched._overlap_window = window
    out_c = await sched.submit(ids[2])
    out_a = await tasks[0]
    np.testing.assert_array_equal(out_a, oracle[0])
    np.testing.assert_array_equal(out_c, oracle[2])
    assert sched.stat_tier_promote_overlap >= 1 and sched.stat_pipeline_admits >= 1
    await sched.close()


async def test_preseed_from_the_jax_schedulers_export(params):
    """The spill schema is the JAX package's: a JAX scheduler's exported
    prefix state preseeds the port's pool, and the port's first request on
    that prompt admits warm with the oracle's ids."""
    from seldon_core_tpu.serving.decode_scheduler import DecodeScheduler as JaxDecodeScheduler

    jp, tp, oracle_fn = params
    ids = _prompts(1, seed=29)
    js = JaxDecodeScheduler(jp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=2, prefix_slots=4, kv_page_size=4)
    js.warmup()
    await js.submit(ids[0])
    payload = js.export_prefix_state()
    await js.close()
    sched = _scheduler(tp, prefix_slots=4, kv_page_size=4)
    assert sched.preseed_prefix_state(payload) == 1 and sched.stat_prefix_preseeded == 1
    np.testing.assert_array_equal(await sched.submit(ids[0]), oracle_fn(ids)[0])
    assert sched.stat_prefix_hits == 1
    assert sched.preseed_prefix_state({**payload, "page_size": 8}) == 0  # geometry mismatch: skipped
    sched.pool.alloc.check()
    await sched.close()


# ------------------------------------------------------- knobs/validation

TIER_CASES = [
    (dict(decode_slots=2, decode_prefix_slots=4, decode_kv_host_bytes=1 << 20,
          decode_kv_store_tier="file:///tmp/kvtier"), None),
    (dict(decode_slots=2, decode_kv_host_bytes=-1), "decode_kv_host_bytes must be >= 0"),
    (dict(decode_slots=2, decode_kv_host_bytes=1024), "needs decode_prefix_slots"),
    (dict(decode_slots=2, decode_prefix_slots=4, decode_kv_store_tier="file:///tmp/x"), "needs decode_kv_host_bytes"),
]


@pytest.mark.parametrize("tpu,needle", TIER_CASES)
def test_validation_rejects_bad_tier_knobs(tpu, needle):
    """The port's decode_problems against the JAX package's
    validate_deployment on the same tpu block: the same verdict and
    message."""
    from seldon_core_tpu.graph.defaulting import default_deployment
    from seldon_core_tpu.graph.spec import SeldonDeployment
    from seldon_core_tpu.graph.validation import ValidationError, validate_deployment

    dep = default_deployment(SeldonDeployment.from_dict({"spec": {"name": "d", "predictors": [{
        "name": "p", "graph": {"name": "m", "type": "MODEL", "implementation": "JAX_MODEL"}, "tpu": tpu}]}}))
    problems = decode_problems("p", TpuSpec.from_dict(tpu))
    if needle is None:
        validate_deployment(dep)
        assert problems == []
        return
    with pytest.raises(ValidationError, match=needle) as e:
        validate_deployment(dep)
    assert len(problems) == 1 and needle in problems[0] and problems[0] in str(e.value)


def _tier_predictor(**tpu) -> PredictorSpec:
    return PredictorSpec.from_dict({
        "name": "p",
        "graph": {"name": "gpt", "type": "MODEL", "implementation": "JAX_MODEL", "parameters": [
            {"name": "model", "value": "tiny_gpt", "type": "STRING"},
            {"name": "seq", "value": str(SEQ), "type": "INT"},
            {"name": "max_new_tokens", "value": "6", "type": "INT"},
            {"name": "vocab", "value": str(VOCAB), "type": "INT"}]},
        "tpu": {"max_batch": 4, "batch_buckets": [4], "decode_slots": 2, "decode_prefix_slots": 4,
                "decode_kv_page_size": 4, "decode_kv_host_bytes": 1 << 20, **tpu},
    })


async def test_serving_wiring_strict_ctor_degrading_executor(params, tmp_path, monkeypatch):
    """Direct construction is strict about the store URL (the port's
    scheduler takes the store the factory made, and the factory raises);
    through serving a bad URL disables the store tier alone and the host
    tier serves. meta.tags.kv_tier reaches the request parameters."""
    with pytest.raises(ValueError, match="unknown state store url"):
        DecodeScheduler(params[1], seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=1, prefix_slots=2,
                        kv_host_bytes=1024, kv_store=make_state_store("bogus://x"))
    server = PredictorServer(_tier_predictor(decode_kv_store_tier="bogus://nope"), deployment_name="d", device="cpu")
    sched = server.decode_scheduler
    assert sched._host_tier is not None and sched._host_tier.store is None
    assert sched.request_params_from_meta(Meta(tags={"kv_tier": "off"})) == {"kv_tier": "off"}
    await server.stop()
    made, real_make = [], decode_scheduler.make_state_store
    monkeypatch.setattr(decode_scheduler, "make_state_store", lambda url: made.append(url) or real_make(url))
    server = PredictorServer(_tier_predictor(decode_kv_store_tier=f"file://{tmp_path}"), deployment_name="d",
                             device="cpu")
    assert made == [f"file://{tmp_path}"]  # the factory makes the store once
    assert server.decode_scheduler._host_tier.store.directory == str(tmp_path)
    await server.stop()


async def test_served_tier_metrics_like_jax(tmp_path):
    """Through a served scheduler, the demotion, promotion and tier-bytes
    families move under the reference's names."""
    server = PredictorServer(_tier_predictor(decode_prefix_slots=1, decode_kv_store_tier=f"file://{tmp_path}"),
                             deployment_name="kv-tier-metrics", device="cpu")
    server.warmup()
    sched = server.decode_scheduler
    ids = _prompts(2, seed=31)
    for i in (0, 1, 0):
        await sched.submit(ids[i])
    text = server.metrics.export().decode()
    assert 'seldon_tpu_decode_kv_demotions_total{deployment_name="kv-tier-metrics",tier="host"} ' in text
    assert 'seldon_tpu_decode_kv_promotions_total{deployment_name="kv-tier-metrics",tier="host"} 1.0' in text
    assert 'seldon_tpu_decode_kv_tier_bytes{deployment_name="kv-tier-metrics",tier="host"}' in text
    await server.stop()


def test_flight_frame_promotions_aggregate():
    from seldon_core_tpu_torch.telemetry.flight import FlightFrame, FlightRecorder

    rec = FlightRecorder(n_slots=2, name="t", capacity=8, enabled=True)
    base = dict(seq=0, t_ns=1, mode="step", active=1, prefilling=0, queued=0, admitted=0, retired=0, blocked="",
                tokens=1, accepted=0, proposed=0, spec_depth=0, busy_ns=(0, 100, 0, 0, 0), gap_ns=50, kv_free=3,
                kv_live=2, kv_prefix=0, cow=0)
    rec.record(FlightFrame(**base, promotions=2))
    rec.record(FlightFrame(**{**base, "seq": 1}))
    assert rec.promotions_total == 2 and rec.aggregate()["promotions"] == 2
    frames = rec.snapshot()
    assert frames[0].to_dict()["promotions"] == 2 and "promotions" not in frames[1].to_dict()


def test_kv_tier_deployment_builds_as_a_tiny_copy(tmp_path):
    """gpt2_small_kv_tier.json at tiny_gpt widths: it parses, passes the
    rules, and serves with both tiers on the CPU."""
    dep = json.loads((DEPLOYMENTS / "gpt2_small_kv_tier.json").read_text())
    pred = dep["spec"]["predictors"][0]
    tpu = pred["tpu"]
    assert tpu["decode_kv_host_bytes"] > 0 and tpu["decode_kv_store_tier"].startswith("file://")
    assert tpu["decode_prefix_slots"] == 8 and tpu["decode_kv_page_size"] == 16 and tpu["decode_slots"] == 8
    tpu.update(dtype="float32", decode_kv_store_tier=f"file://{tmp_path}")
    for p in pred["graph"]["parameters"]:
        p["value"] = {"vocab": "128", "hidden": "64", "layers": "2", "ffn": "128"}.get(p["name"], p["value"])
    path = tmp_path / "tier.json"
    path.write_text(json.dumps(dep))
    predictor, name = load_predictor(str(path))
    assert decode_problems("main", predictor.tpu) == []
    server = PredictorServer(predictor, deployment_name=name, device="cpu")
    sched = server.decode_scheduler
    assert sched._host_tier is not None and sched._host_tier.store is not None
    budget = sched.pool.n_pages - 1 - sched.n_slots * sched.pool.pages_per_slot
    assert budget < sched.prefix_slots * sched.pool.alloc.pages_for(sched.seq_len), \
        "the page budget keeps every prefix of the traffic resident"
