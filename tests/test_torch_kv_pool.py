"""Paged KV memory in the port (seldon_core_tpu_torch/serving/kv_pool.py and
the paged blocks of models/decoder.py), held to the JAX package's
contracts (tests/test_kv_pool.py):

- the allocator copy is sound: the same 10k-operation soak and budget
  cases as the JAX package's allocator;
- the paged attention blocks give the flat slot blocks' logits for the same
  K/V, and the scheduler over the pool gives the JAX package's greedy
  ``generate`` token for token across prefix sharing, copy-on-write and
  reclaim, with no new dispatch key after warmup;
- a step writes live pages at most once per (page, offset): duplicate
  writes land only on junk page 0;
- int8 KV stays within the JAX package's teacher-forced logit bound (0.25).
"""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.models import decoder as jd
from seldon_core_tpu.serving.kv_pool import PageAllocator as JaxPageAllocator
from seldon_core_tpu_torch.models import decoder as td
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.serving.decode_scheduler import DecodeScheduler
from seldon_core_tpu_torch.serving.kv_pool import PageAllocator

SEQ = 8
MAX_NEW = 10
VOCAB = 128
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def params():
    """(the port's tensors, the JAX greedy oracle) of one numpy draw."""
    p = jd.init_decoder(seed=3, vocab=VOCAB, hidden=64, layers=2, ffn=128, max_len=96)
    gen = jax.jit(jd.generate, static_argnums=2)
    return params_to_torch(p, CPU), lambda ids, n=MAX_NEW: np.asarray(gen(p, jnp.asarray(ids), n))


def _scheduler(tp, n_slots=2, seq_len=SEQ, max_new=MAX_NEW, **kw) -> DecodeScheduler:
    s = DecodeScheduler(tp, seq_len=seq_len, max_new_tokens=max_new, n_slots=n_slots, **kw)
    s.warmup()
    return s


def _shared_prompts(n, seq=SEQ, shared=5, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (n, seq)).astype(np.int32)
    ids[1:, :shared] = ids[0, :shared]
    return ids


# ------------------------------------------------------ allocator invariants


def _soak(cls):
    """10k random admissions (with and without prefix sharing), writes
    (fresh pages and copy-on-write), captures, releases and retirements,
    audited every 50 operations, then drained and audited again. Returns
    the state before the drain: block tables, refcounts, free list and the
    allocator's snapshot."""
    rng = np.random.default_rng(0)
    n_slots, ps, pps = 4, 4, 5  # 20-token virtual context in 4-token pages
    alloc = cls(n_pages=3 * pps + 2, page_size=ps, n_slots=n_slots, pages_per_slot=pps)
    seq_len = 12
    cursor = [-1] * n_slots  # -1: slot free, else the next write position
    forked = [False] * n_slots  # one mid-flight capture per tenancy
    pins: list = []
    for step in range(10_000):
        free_slots = [s for s in range(n_slots) if cursor[s] < 0]
        busy = [s for s in range(n_slots) if cursor[s] >= 0]
        r = rng.random()
        if r < 0.30 and free_slots:
            slot = int(rng.choice(free_slots))
            pin = pins[int(rng.integers(len(pins)))] if pins and rng.random() < 0.6 else None
            if pin is not None:
                reuse = int(rng.integers(1, len(pin.pages) * ps + 1))
                ok = alloc.try_admit(slot, pin.pages, reuse, extra_reserve=1)
                start = reuse
            else:
                ok = alloc.try_admit(slot, (), 0, extra_reserve=1)
                start = 0
            if ok:
                cursor[slot] = start
                forked[slot] = False
        elif r < 0.65 and busy:
            slot = int(rng.choice(busy))
            count = int(rng.integers(1, ps + 2))
            for s_, d_ in alloc.prepare_write(slot, cursor[slot], count):
                assert s_ != d_ and d_ != 0
            cursor[slot] = min(cursor[slot] + count, pps * ps)
        elif r < 0.80 and busy:
            slot = int(rng.choice(busy))
            upto = min(cursor[slot], seq_len)
            if upto >= 1 and not forked[slot]:
                pin = alloc.capture(slot, int(rng.integers(1, upto + 1)))
                if pin is not None:
                    pins.append(pin)
                    forked[slot] = True
        elif r < 0.92 and busy:
            slot = int(rng.choice(busy))
            alloc.retire(slot)
            cursor[slot] = -1
        elif pins:
            alloc.release(pins.pop(int(rng.integers(len(pins)))).pin_id)
        if step % 50 == 0:
            pins = [p for p in pins if p.pin_id in alloc._pins]  # reclaimed behind our back
            alloc.check()
    alloc.check()
    state = (alloc.block_tables.copy(), alloc.refs.copy(), list(alloc._free), alloc.snapshot())
    for slot in range(n_slots):
        if cursor[slot] >= 0:
            alloc.retire(slot)
    for pin in pins:
        if pin.pin_id in alloc._pins:
            alloc.release(pin.pin_id)
    alloc.check()
    assert alloc.free_pages == alloc.n_pages - 1, "pages leaked after drain"
    return state


def test_allocator_soak_invariants_and_parity_with_jax():
    """The port's allocator survives the JAX package's soak with every
    audit passing, and the same operations take it to the JAX package's
    block tables, refcounts, free list and counters."""
    ours, theirs = _soak(PageAllocator), _soak(JaxPageAllocator)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[2:] == theirs[2:]


def test_allocator_budget_floor_and_deadlock_guard():
    with pytest.raises(ValueError, match="minimal residency"):
        PageAllocator(n_pages=5, page_size=4, n_slots=2, pages_per_slot=5)
    alloc = PageAllocator(n_pages=8, page_size=4, n_slots=2, pages_per_slot=3)
    assert alloc.try_admit(0, (), 0)
    alloc.prepare_write(0, 0, 12)  # full residency: the reservation is spent
    with pytest.raises(RuntimeError, match="reservation"):
        alloc._alloc(0)


def test_scheduler_rejects_undersized_page_budget(params):
    with pytest.raises(ValueError, match="minimal residency"):
        DecodeScheduler(params[0], seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=2, kv_page_size=4, kv_pages=3)


# ------------------------------------------------- paged vs flat attention


def test_paged_blocks_match_flat_chunk_and_decode_logits(params):
    """For the same chunk-built K/V the paged gather/scatter attention gives
    the flat slot blocks' logits, and the free slots' writes touched no
    live page."""
    tp, _ = params
    ps, ctx, n_slots, slot = 4, SEQ + MAX_NEW, 3, 1
    pps = -(-ctx // ps)
    ids = np.random.default_rng(5).integers(0, VOCAB, SEQ).astype(np.int32)
    bt = np.zeros((n_slots, pps), np.int32)
    bt[slot] = np.arange(1 + slot * pps, 1 + (slot + 1) * pps)
    toks = np.zeros((n_slots, SEQ), np.int32)
    toks[slot] = ids
    zero = np.zeros(n_slots, np.int32)
    counts = np.zeros(n_slots, np.int32)
    counts[slot] = SEQ
    t = torch.from_numpy
    with torch.inference_mode():
        ck, cv = td.init_slot_cache(tp, n_slots, ctx)
        pool = td.paged_kv_init(tp, 1 + n_slots * pps, ps)
        fl, _, _ = td.chunk_prefill(tp, ck, cv, t(toks), t(zero), t(counts))
        pl, _, _ = td.paged_chunk_prefill(tp, pool, t(bt), t(toks), t(zero), t(counts))
        np.testing.assert_allclose(pl[slot].numpy(), fl[slot].numpy(), rtol=1e-5, atol=1e-6)
        t1, p1 = zero.copy(), zero.copy()
        t1[slot], p1[slot] = int(torch.argmax(pl[slot, SEQ - 1])), SEQ
        fl, _, _ = td.decode_step(tp, ck, cv, t(t1), t(p1))
        pl, _, _ = td.paged_decode_step(tp, pool, t(bt), t(t1), t(p1))
        np.testing.assert_allclose(pl[slot].numpy(), fl[slot].numpy(), rtol=1e-5, atol=1e-6)
    for other in range(n_slots):
        if other != slot:
            assert not pool[0][:, 1 + other * pps].any()


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_live_pages_never_receive_duplicate_writes(kv_dtype):
    """_paged_write on one layer's pool with free slots, counts-0 slots, a
    masked chunk tail, a slot running past its virtual length and a slot
    mapping pages another slot maps: every (page, offset) of a live page
    is written by at most one entry and holds that entry's K/V, every
    masked entry lands on junk page 0, and nothing else moves."""
    ps, pps, n, m, h, hd = 4, 5, 5, 4, 2, 8
    bt = torch.tensor([[0, 0, 0, 0, 0],  # free
                       [1, 2, 3, 4, 5],
                       [6, 7, 8, 0, 0],  # partly mapped
                       [9, 10, 11, 12, 13],
                       [14, 15, 16, 17, 18]])
    pos = torch.tensor([0, 16, 9, 0, 5])
    counts = torch.tensor([0, 4, 3, 0, 2])  # slot 1 runs past the virtual length
    g = torch.Generator().manual_seed(0)
    k, v = torch.randn(n, h, m, hd, generator=g), torch.randn(n, h, m, hd, generator=g)
    pool = tuple(a[0] for a in td.paged_kv_init({"tok_emb": torch.zeros(1, h * hd), "pos_emb": torch.zeros(1, 1),
                                                  "layers": [{"qkv": {"w": torch.zeros(h * hd, 1)}}]},
                                                 19, ps, kv_dtype=kv_dtype))
    assert td._heads_for(h * hd) == h
    before = [a.clone() for a in pool]
    td._paged_write(pool, k, v, bt, pos, counts)
    writers = {}
    for i in range(n):
        for j in range(m):
            gp = int(pos[i]) + j
            if j < counts[i] and gp < pps * ps:
                writers.setdefault((int(bt[i, gp // ps]), gp % ps), []).append((i, j))
    assert all(len(w) == 1 for w in writers.values()), writers
    assert all(page != 0 for page, _ in writers)
    payload = pool[0].float() if not kv_dtype else pool[0].float() * pool[1][:, None, :, None] + pool[2][:, None, :, None]
    for (page, off), [(i, j)] in writers.items():
        tol = 0 if not kv_dtype else float(k[i, :, j].max() - k[i, :, j].min()) / 254 * 0.51
        assert (payload[page, :, off] - k[i, :, j]).abs().max() <= tol + 1e-7
    written = {page for page, _ in writers}
    for page in range(1, 19):
        if page not in written:
            assert all(torch.equal(a[page], b[page]) for a, b in zip(pool, before)), page


# ------------------------------------------------ scheduler over the pool


async def test_paged_scheduler_cow_and_reclaim_no_new_dispatch_keys(params):
    """A tight page budget under shared-prefix traffic drives copy-free
    shares, boundary-page copy-on-write and pin reclaim, with greedy output
    equal to the JAX package's generate and no new dispatch key."""
    tp, oracle_fn = params
    ids = _shared_prompts(10, shared=5, seed=11)
    oracle = oracle_fn(ids)
    sched = _scheduler(tp, n_slots=2, prefix_slots=4, prefill_chunk=4, kv_page_size=4, kv_pages=14)
    assert sched.compile_counts()["copy"] == len(sched.pool.copy_buckets)
    out0 = await sched.submit(ids[0], cache_prefix=5)
    np.testing.assert_array_equal(out0, oracle[0])
    outs = await asyncio.gather(*(sched.submit(row) for row in ids[1:]))
    for row, out in zip(oracle[1:], outs):
        np.testing.assert_array_equal(out, row)
    a = sched.pool.alloc
    assert sched.stat_prefix_hits >= 8
    assert a.stat_pages_shared > 0 and a.stat_cow_copies > 0
    assert sched.recompiles_since_warmup() == 0, sched.compile_counts()
    a.check()
    await sched.close()


async def test_page_budget_throttles_admission_without_deadlock(params):
    tp, oracle_fn = params
    ids = _shared_prompts(6, shared=0, seed=9)
    oracle = oracle_fn(ids)
    sched = _scheduler(tp, n_slots=4, kv_page_size=4, kv_pages=12)  # room for ~2 slots, not 4
    outs = await asyncio.gather(*(sched.submit(row) for row in ids))
    for row, out in zip(oracle, outs):
        np.testing.assert_array_equal(out, row)
    assert sched.stat_peak_active <= 2 and sched.stat_admit_blocked_rounds > 0
    sched.pool.alloc.check()
    assert sched.pool.alloc.free_pages == sched.pool.n_pages - 1
    await sched.close()


# --------------------------------------------------------------- int8 KV


def test_int8_kv_teacher_forced_logit_parity(params):
    """The same token stream (teacher-forced from the fp pool) through the
    int8 pool stays within 0.25 in the logits at every step, and is not
    identical (it is quantized)."""
    tp, _ = params
    ps, ctx = 4, SEQ + MAX_NEW
    pps = -(-ctx // ps)
    ids = np.random.default_rng(2).integers(0, VOCAB, SEQ).astype(np.int32)
    bt = torch.arange(1, 1 + pps)[None, :]
    streams = {}
    with torch.inference_mode():
        pools = {"fp": td.paged_kv_init(tp, 1 + pps, ps), "int8": td.paged_kv_init(tp, 1 + pps, ps, kv_dtype="int8")}
        for name, pool in pools.items():
            lg, _, _ = td.paged_chunk_prefill(tp, pool, bt, torch.from_numpy(ids[None]), torch.zeros(1),
                                              torch.tensor([SEQ]))
            streams[name] = [lg[0, SEQ - 1].numpy()]
        tok = int(np.argmax(streams["fp"][0]))
        for i in range(MAX_NEW - 1):
            for name, pool in pools.items():
                lg, _, _ = td.paged_decode_step(tp, pool, bt, torch.tensor([tok]), torch.tensor([SEQ + i]))
                streams[name].append(lg[0].numpy())
            tok = int(np.argmax(streams["fp"][-1]))
    worst = max(float(np.abs(a - b).max()) for a, b in zip(streams["fp"], streams["int8"]))
    assert 0.0 < worst < 0.25, worst


async def test_int8_kv_scheduler_end_to_end(params):
    tp, oracle_fn = params
    ids = _shared_prompts(6, shared=5, seed=21)
    oracle = oracle_fn(ids)
    sched = _scheduler(tp, n_slots=2, prefix_slots=4, prefill_chunk=4, kv_page_size=4, kv_dtype="int8")
    outs = await asyncio.gather(*(sched.submit(row) for row in ids))
    agree = 0
    for row, out in zip(oracle, outs):
        assert out.shape == row.shape and out.min() >= 0 and out.max() < VOCAB
        np.testing.assert_array_equal(out[:SEQ], row[:SEQ])
        agree += int(np.sum(out[SEQ:] == row[SEQ:]))
    assert agree / (len(ids) * MAX_NEW) > 0.5
    assert sched.stat_prefix_hits > 0 and sched.recompiles_since_warmup() == 0
    sched.pool.alloc.check()
    await sched.close()
