"""One captured CUDA graph per dispatch key (seldon_core_tpu_torch/ops/graphs.py)
in the runtime and the decode scheduler, held to the JAX package's compiled
programs on the CPU.

On the CPU an entry runs its function eagerly on the same static buffers a
card replay reads, so these tests run the code the card runs except the
capture itself:

- ``ModelRuntime`` through the static-buffer runner: at every bucket equal,
  bit for bit, to the forward on a freshly padded batch, and for iris and a
  2-layer BERT within the port-vs-JAX tolerances of the JAX runtime
  (float32, rtol 2e-4 / atol 2e-5: tests/test_models_heavy.py's);
  ``compile_counts()`` counts one key per (bucket, wire dtype), and a key
  first met after warmup counts as a recompile;
- the decode scheduler with static inputs and in-place device block
  tables: greedy ids equal to the JAX scheduler's, ``compile_counts()``
  under the JAX scheduler's program names, and no new key after mixed
  admissions;
- the capture's bookkeeping, on a stand-in for ``torch.cuda``'s graph API:
  launches counted while capturing are taken back and credited once per
  replay, no garbage collection runs while capturing, and a capture that
  fails raises;
- two threads predicting on one runtime each get their own rows back, also
  when one forward holds its entry while the other waits.

The ``gpu`` twins capture on the card (``-m gpu``; each skips here). JAX is
imported inside the tests that use it: the card's host has none.
"""

import asyncio
import contextlib
import gc
import sys
import threading
import time

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.core.tensor import pad_batch
from seldon_core_tpu_torch.graph.spec import TpuSpec
from seldon_core_tpu_torch.models import zoo
from seldon_core_tpu_torch.models.base import ModelRuntime
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.ops import flash_attention, graphs, int8_matmul
from seldon_core_tpu_torch.serving.decode_scheduler import DecodeScheduler

CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-5)
SEQ, MAX_NEW, VOCAB = 8, 10, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _iris_pair(device=CPU, buckets=(1, 2, 4), cuda_graphs=True):
    """(the port's runtime, the JAX runtime) on the JAX package's iris
    weights (the two zoos draw them differently)."""
    import jax

    from seldon_core_tpu.models import zoo as jzoo
    from seldon_core_tpu.models.base import ModelRuntime as JaxRuntime

    ms = jzoo.get_model("iris_logistic", seed=3)
    params = jax.tree.map(np.asarray, ms.params)
    rt = ModelRuntime(zoo._apply_logistic, params, device=device, buckets=buckets, cuda_graphs=cuda_graphs)
    rt.feature_shape = (4,)
    return rt, JaxRuntime(ms.apply_fn, ms.params, buckets=buckets)


def _bert_pair(buckets=(1, 2, 4)):
    from seldon_core_tpu.models import bert as jax_bert
    from seldon_core_tpu.models.base import ModelRuntime as JaxRuntime

    rt = zoo._runtime_from_modelspec(zoo.get_model("bert_tiny", seed=2, seq=16),
                                     TpuSpec(batch_buckets=buckets, max_batch=max(buckets)), CPU)
    jparams = jax_bert.init_bert(2, vocab=1024, hidden=128, layers=2, ffn=256, max_len=128, num_classes=2)
    return rt, JaxRuntime(jax_bert._apply_for_kernel("auto"), jparams, buckets=buckets, int_inputs="ids")


def _today(rt: ModelRuntime, x: np.ndarray) -> np.ndarray:
    """The forward on a freshly padded batch, no static buffer."""
    bucket = next(b for b in rt.buckets if b >= len(x))
    padded, n = pad_batch(x, bucket)
    return rt._forward(torch.from_numpy(padded)).numpy()[:n]


@pytest.mark.parametrize("model", ["iris", "bert_tiny"])
def test_static_buffer_runner_equals_todays_path_and_jax(model):
    rt, jrt = _iris_pair() if model == "iris" else _bert_pair()
    rng = np.random.default_rng(5)
    rt.warmup()
    assert rt.compile_counts() == {"forward": len(rt.buckets)}
    for b in rt.buckets:
        for n in sorted({b, max(1, b - 1)}):
            if model == "iris":
                x = rng.random((n, 4)).astype(np.float32)
            else:
                x = rng.integers(0, 1024, (n, 16)).astype(np.int32)
            got = rt.predict(x)
            np.testing.assert_array_equal(got, _today(rt, x.astype(np.float32 if model == "iris" else np.int32)))
            np.testing.assert_allclose(got, np.asarray(jrt.predict(x)), **TOL)
    assert rt.recompiles_since_warmup() == 0


def test_runtime_counts_keys_per_wire_dtype_and_late_keys():
    """A uint8 image runtime has two keys per bucket (float32 and uint8
    wires); a runtime asked for a bucket's key only after warmup counts it
    as a recompile, as jax.jit would compile it then."""
    rt = ModelRuntime(lambda p, x: x.float().mean(dim=(1, 2, 3))[:, None] * p["s"], {"s": np.ones(1, np.float32)},
                      device=CPU, buckets=(1, 4))
    assert rt.recompiles_since_warmup() == -1
    rt.feature_shape = (2, 2, 3)
    rt.warmup()
    assert rt.compile_counts() == {"forward": 4} and rt.recompiles_since_warmup() == 0
    x = np.arange(12, dtype=np.uint8).reshape(1, 2, 2, 3)
    np.testing.assert_array_equal(rt.predict(x), [[5.5]])
    assert rt.recompiles_since_warmup() == 0
    late = ModelRuntime(lambda p, x: x * p["s"], {"s": np.ones(1, np.float32)}, device=CPU, buckets=(1, 4))
    late.feature_shape = (3,)
    late.buckets = (1,)
    late.warmup()
    late.buckets = (1, 4)
    late.predict(np.ones((3, 3), np.float32))
    assert late.compile_counts() == {"forward": 2} and late.recompiles_since_warmup() == 1


# ------------------------------------------------------------ decode tier
def _decoder():
    from seldon_core_tpu.models import decoder as jd

    p = jd.init_decoder(seed=3, vocab=VOCAB, hidden=64, layers=2, ffn=128, max_len=64, resid_scale=0.1)
    return p, params_to_torch(p, CPU)


@pytest.mark.parametrize("shape", ["plain", "chain", "tree"])
async def test_scheduler_static_buffers_equal_the_jax_scheduler(shape):
    """Mixed admissions (five prompts through three slots, chunked prefill,
    prefix reuse, 4-token pages, budgets and spec_k tightens): greedy ids
    equal the JAX scheduler's on the same weights, compile_counts() has the
    JAX scheduler's program names, and warmup built every key."""
    from seldon_core_tpu.models import decoder as jd
    from seldon_core_tpu.serving.decode_scheduler import DecodeScheduler as JaxDecodeScheduler

    jp, tp = _decoder()
    kw = dict(n_slots=3, prefill_chunk=4, prefix_slots=2, kv_page_size=4)
    if shape != "plain":
        kw["draft_params"] = jd.init_decoder(seed=3, vocab=VOCAB, hidden=64, layers=1, ffn=128, max_len=64,
                                             resid_scale=0.1)
        kw.update({"spec_k": 3} if shape == "chain" else {"spec_tree": "2,2,1"})
    ids = np.random.default_rng(4).integers(0, VOCAB, (5, SEQ)).astype(np.int32)
    ids[3, :5] = ids[0, :5]  # a shared prefix
    asks = [{}, {"max_new_tokens": 4}, {"prefill_chunk": 2}, {}, {"max_new_tokens": 7}]
    if shape != "plain":
        asks[1]["spec_k"] = 0
        asks[4]["spec_k"] = 1
    ours_kw = dict(kw, draft_params=params_to_torch(kw["draft_params"], CPU)) if shape != "plain" else kw
    sched = DecodeScheduler(tp, seq_len=SEQ, max_new_tokens=MAX_NEW, **ours_kw)
    sched.warmup()
    jsched = JaxDecodeScheduler(jp, seq_len=SEQ, max_new_tokens=MAX_NEW, **kw)
    jsched.warmup()
    outs = await asyncio.gather(*(sched.submit(row, **a) for row, a in zip(ids, asks)))
    # the prefix-sharing prompt again, after its twin retired
    outs.append(await sched.submit(ids[3]))
    jouts = await asyncio.gather(*(jsched.submit(row, **a) for row, a in zip(ids, asks)))
    jouts.append(await jsched.submit(ids[3]))
    assert set(sched.compile_counts()) == set(jsched.compile_counts())
    await jsched.close()
    for out, jout in zip(outs, jouts):
        np.testing.assert_array_equal(out, jout)
    assert sched.recompiles_since_warmup() == 0, sched.compile_counts()
    assert sched.stat_prefix_hits > 0 and sched.stat_eager_rounds == 0
    keys = sched.graphs.keys()
    assert ("step", 3) in keys and all(("chunk", 3, c) in keys for c in sched.chunk_buckets)
    sched.pool.alloc.check()
    await sched.close()


async def test_sampled_rounds_run_eagerly_and_are_counted():
    """A sampled speculative round pair runs eagerly (its draws come from
    the tick's generator streams), the greedy ones through the entries; no
    key appears for either."""
    from seldon_core_tpu.models import decoder as jd

    _, tp = _decoder()
    draft = params_to_torch(jd.init_decoder(seed=3, vocab=VOCAB, hidden=64, layers=1, ffn=128, max_len=64,
                                            resid_scale=0.1), CPU)
    sched = DecodeScheduler(tp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=2, draft_params=draft, spec_k=3)
    sched.warmup()
    ids = np.random.default_rng(6).integers(0, VOCAB, (2, SEQ)).astype(np.int32)
    greedy = await sched.submit(ids[0])
    assert sched.stat_eager_rounds == 0 and sched.stat_spec_dispatches > 0
    sampled = await sched.submit(ids[1], temperature=0.8)
    assert sched.stat_eager_rounds > 0 and len(sampled) == SEQ + MAX_NEW
    with torch.inference_mode():
        np.testing.assert_array_equal(greedy, _port_generate(tp, ids[:1])[0])
    assert sched.recompiles_since_warmup() == 0
    await sched.close()


def _port_generate(tp, ids):
    from seldon_core_tpu_torch.models import decoder as td

    return td.generate(tp, torch.from_numpy(ids), MAX_NEW).numpy()


async def test_block_tables_are_one_device_tensor_written_in_place():
    _, tp = _decoder()
    sched = DecodeScheduler(tp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=2, kv_page_size=4)
    sched.warmup()
    bt_dev = sched.pool.bt_device
    ptr = bt_dev.data_ptr()
    ids = np.random.default_rng(7).integers(0, VOCAB, (2, SEQ)).astype(np.int32)
    outs = await asyncio.gather(*(sched.submit(row) for row in ids))
    np.testing.assert_array_equal(np.stack(outs), _port_generate(tp, ids))
    assert sched.pool.bt_device.data_ptr() == ptr and bt_dev.shape == sched.pool.alloc.block_tables.shape
    # the error path rebuilds the pool in place: the entries' addresses hold
    state_ptrs = [a.data_ptr() for a in sched.pool.state]
    sched._reset_device_state()
    assert [a.data_ptr() for a in sched.pool.state] == state_ptrs
    assert not any(bool(a.any()) for a in sched.pool.state)
    await sched.close()


# ------------------------------------------------- capture bookkeeping
class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    """A stand-in for torch.cuda's graph API: the capture context runs the
    function as a real capture records it (the wrappers count their
    launches), and a replay runs no Python at all, as a real one."""
    state = {"fail": False, "gc_while_capturing": None}

    class _Stream:
        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode="global"):
        # a collection here could destroy another graph mid-capture
        state["gc_while_capturing"] = gc.isenabled()
        yield
        if state["fail"]:
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())

    def cache():
        c = graphs.GraphCache(CPU)
        c.capture, c.stream = True, _Stream()
        return c

    return state, cache


def _two_kernel_fn(x):
    """Stands for a forward with one flash wgmma launch and one int8 wgmma launch."""
    flash_attention.LAUNCHES.add()
    flash_attention.LAUNCHES_BY_BODY["wgmma"].add()
    int8_matmul.LAUNCHES.add()
    int8_matmul.LAUNCHES_BY_BODY["wgmma"].add()
    return x * 2


def test_replays_credit_the_launches_counted_at_capture(fake_cuda):
    state, make = fake_cuda
    cache = make()
    entry = cache.entry(("forward", 4, "<f4"), _two_kernel_fn, [((4,), torch.float32)])
    flash_attention.reset_launches()
    int8_matmul.reset_launches()
    entry.run(np.ones(4, np.float32))
    # the eager run before the capture launched once; the capture counted
    # one more that never ran, taken back; the first replay credits one
    # flash, flash by body: wgmma, f32, onetile; int8, int8 by body: fma,
    # mma, wgmma, splitk, tf32x2, fewrows
    assert entry.launches == [1, 1, 0, 0, 1, 0, 0, 1, 0, 0, 0]
    assert flash_attention.LAUNCHES.count == 2 and int8_matmul.LAUNCHES_BY_BODY["wgmma"].count == 2
    assert flash_attention.LAUNCHES_BY_BODY["wgmma"].count == 2
    for i in range(3):
        entry.run(np.ones(4, np.float32))
        assert flash_attention.LAUNCHES.count == 3 + i and int8_matmul.LAUNCHES.count == 3 + i
    assert entry.graph.replays == 4 and cache.stat_captures == 1 and cache.counts() == {"forward": 1}
    assert int8_matmul.LAUNCHES_BY_BODY["mma"].count == 0 and flash_attention.LAUNCHES_BY_BODY["onetile"].count == 0
    assert state["gc_while_capturing"] is False and gc.isenabled()


def test_a_failed_capture_raises_and_never_runs_eager(fake_cuda):
    state, make = fake_cuda
    state["fail"] = True
    entry = make().entry(("forward", 4, "<f4"), _two_kernel_fn, [((4,), torch.float32)])
    with pytest.raises(RuntimeError, match="capturing"):
        entry.run(np.ones(4, np.float32))
    assert entry.graph is None


# ------------------------------------------------------------- threads
def test_two_threads_on_one_runtime_get_their_own_rows():
    """The entry's lock keeps copy-in, forward and copy-out together: the
    forward sleeps between reading its static input and using it, so a
    second writer would show through."""

    def apply(p, x):
        x0 = x.clone()
        time.sleep(0.0005)
        return x0 * p["s"] + (x - x0)  # x's bytes after the sleep must still be x0's

    rt = ModelRuntime(apply, {"s": np.full(3, 2.0, np.float32)}, device=CPU, buckets=(2,))
    rt.feature_shape = (3,)
    rt.warmup()
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(60):
            x = rng.random((2, 3)).astype(np.float32)
            y = rt.predict(x)
            if not np.array_equal(y, x * 2):
                errors.append((seed, x, y))

    try:
        threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:1]


def test_a_held_forward_keeps_its_buffers_from_the_next_request():
    """A forward abandoned at its deadline still holds its entry: a later
    request on the same key waits for it and never replays over its
    buffers."""
    release, entered = threading.Event(), threading.Event()

    def apply(p, x):
        if float(x[0, 0]) == 1.0:
            entered.set()
            release.wait(timeout=30)
        return x * p["s"]

    rt = ModelRuntime(apply, {"s": np.full(1, 3.0, np.float32)}, device=CPU, buckets=(1,))
    rt.feature_shape = (1,)
    rt.warmup()
    out = {}
    first = threading.Thread(target=lambda: out.update(a=rt.predict(np.ones((1, 1), np.float32))))
    second = threading.Thread(target=lambda: out.update(b=rt.predict(np.full((1, 1), 5.0, np.float32))))
    first.start()
    assert entered.wait(timeout=30)
    second.start()
    second.join(timeout=0.2)
    assert second.is_alive() and "b" not in out
    release.set()
    first.join(timeout=30)
    second.join(timeout=30)
    assert not first.is_alive() and not second.is_alive()
    assert out["a"].tolist() == [[3.0]] and out["b"].tolist() == [[15.0]]


# ------------------------------------------------------------ the card
@pytest.mark.gpu
def test_captured_runtime_equals_eager_on_the_card(cuda):
    """bert_tiny at seq 128 through the flash kernel: one graph per bucket,
    bit for bit the eager twin's rows, and one flash launch per layer
    credited per replay."""
    tpu = TpuSpec(batch_buckets=(1, 4), max_batch=4)
    ms = zoo.get_model("bert_tiny", seed=2, seq=128, attn_kernel="pallas")
    cap = zoo._runtime_from_modelspec(ms, tpu, cuda)
    eager = zoo._runtime_from_modelspec(ms, tpu, cuda, cuda_graphs=False)
    cap.warmup()
    eager.warmup()
    assert cap.graphs.stat_captures == 2 and cap.compile_counts() == {"forward": 2}
    rng = np.random.default_rng(1)
    for n in (1, 3, 4):
        ids = rng.integers(0, 1024, (n, 128)).astype(np.int32)
        flash_attention.LAUNCHES.reset()
        got = cap.predict(ids)
        assert flash_attention.LAUNCHES.count == 2
        np.testing.assert_array_equal(got, eager.predict(ids))
    assert cap.recompiles_since_warmup() == 0


@pytest.mark.gpu
async def test_captured_scheduler_equals_eager_and_generate_on_the_card(cuda):
    from seldon_core_tpu_torch.models import decoder as td

    p = td.init_decoder(seed=3, vocab=VOCAB, hidden=64, layers=2, ffn=128, max_len=64, resid_scale=0.1)
    tp = params_to_torch(p, cuda)
    draft = params_to_torch(td.init_decoder(seed=3, vocab=VOCAB, hidden=64, layers=1, ffn=128, max_len=64,
                                            resid_scale=0.1), cuda)
    ids = np.random.default_rng(4).integers(0, VOCAB, (5, SEQ)).astype(np.int32)
    outs = {}
    for graphs_on in (True, False):
        sched = DecodeScheduler(tp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=3, prefill_chunk=4,
                                draft_params=draft, spec_k=3, cuda_graphs=graphs_on)
        sched.warmup()
        assert sched.graphs.stat_captures == (sum(sched.compile_counts().values()) if graphs_on else 0)
        outs[graphs_on] = await asyncio.gather(*(sched.submit(row) for row in ids))
        assert sched.recompiles_since_warmup() == 0
        await sched.close()
    with torch.inference_mode():
        ref = td.generate(tp, torch.from_numpy(ids).to(cuda), MAX_NEW).cpu().numpy()
    for a, b, r in zip(outs[True], outs[False], ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, r)
