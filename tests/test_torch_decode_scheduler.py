"""The port's continuous-batching decode scheduler
(seldon_core_tpu_torch/serving/decode_scheduler.py) held to the JAX
package's scheduler contracts (tests/test_decode_scheduler.py) on the CPU.

The load-bearing one: greedy decoding through the scheduler gives, token
for token, the port's fused ``generate`` and the JAX package's ``generate``
on the same parameters, whatever the admission order, slot reuse or
neighbours of a sequence. Plus admission under full slots, EOS retirement,
per-request sampling, no new dispatch key after warmup, the error paths,
the serving wiring (batcher, server, SSE through the fast ingress) and the
refusal of every decode_* knob the port does not serve.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.models import decoder as jd
from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Meta, SeldonMessage
from seldon_core_tpu_torch.graph.defaulting import UNPORTED_DECODE_KNOBS, decode_problems
from seldon_core_tpu_torch.graph.spec import PredictorSpec, TpuSpec
from seldon_core_tpu_torch.models import decoder as td
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.serving.decode_scheduler import DecodeScheduler
from seldon_core_tpu_torch.serving.server import PredictorServer

SEQ = 8
MAX_NEW = 10
VOCAB = 128
CPU = torch.device("cpu")


def _numpy_params():
    return jd.init_decoder(seed=3, vocab=VOCAB, hidden=64, layers=2, ffn=128, max_len=64)


@pytest.fixture(scope="module")
def params():
    """(numpy params, the port's tensors, JAX greedy oracle)."""
    p = _numpy_params()
    gen = jax.jit(jd.generate, static_argnums=2)
    return p, params_to_torch(p, CPU), lambda ids, n=MAX_NEW: np.asarray(gen(p, jnp.asarray(ids), n))


def _prompts(n, seed=1):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, SEQ)).astype(np.int32)


def _scheduler(tp, n_slots=2, **kw) -> DecodeScheduler:
    s = DecodeScheduler(tp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=n_slots, **kw)
    s.warmup()
    return s


def _port_oracle(tp, ids, max_new=MAX_NEW):
    with torch.inference_mode():
        return td.generate(tp, torch.from_numpy(ids), max_new).numpy()


async def test_matches_both_oracles_with_midstream_admission(params):
    """A sequence admitted while two others are mid-generation decodes
    exactly what the fused batch gives, in the port and in the JAX
    package."""
    _, tp, jax_oracle = params
    ids = _prompts(3)
    oracle = jax_oracle(ids)
    np.testing.assert_array_equal(_port_oracle(tp, ids), oracle)
    sched = _scheduler(tp, n_slots=3)
    a_started = asyncio.Event()

    def on_token(tok, idx):
        if idx >= 2:
            a_started.set()

    t_a = asyncio.ensure_future(sched.submit(ids[0], on_token=on_token))
    t_b = asyncio.ensure_future(sched.submit(ids[1]))
    await a_started.wait()  # a and b are mid-generation now
    assert sched.active == 2
    t_c = asyncio.ensure_future(sched.submit(ids[2]))
    outs = await asyncio.gather(t_a, t_b, t_c)
    for row, out in zip(oracle, outs):
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out, row)
    await sched.close()


async def test_admission_under_full_slots_and_slot_reuse(params):
    _, tp, jax_oracle = params
    ids = _prompts(5, seed=9)
    oracle = jax_oracle(ids)
    sched = _scheduler(tp, n_slots=2)
    outs = await asyncio.gather(*(sched.submit(row) for row in ids))
    for row, out in zip(oracle, outs):
        np.testing.assert_array_equal(out, row)
    assert sched.stat_peak_active <= 2
    assert sched.stat_admitted == 5 and sched.stat_retired == 5
    assert sched.active == 0 and len(sched._free) == 2
    sched.pool.alloc.check()
    await sched.close()


async def test_eos_retirement_frees_slot_early(params):
    _, tp, jax_oracle = params
    ids = _prompts(1, seed=4)
    oracle = jax_oracle(ids)[0]
    eos = int(oracle[SEQ + 2])  # the 3rd greedy token stops generation
    sched = _scheduler(tp, n_slots=2, eos_id=eos)
    out = await sched.submit(ids[0])
    cut = SEQ + list(oracle[SEQ:]).index(eos) + 1
    np.testing.assert_array_equal(out, oracle[:cut])
    assert len(out) < len(oracle)
    assert sched.active == 0
    await sched.close()


async def test_per_request_sampling_params(params):
    _, tp, jax_oracle = params
    ids = _prompts(2, seed=5)
    oracle = jax_oracle(ids)
    sched = _scheduler(tp, n_slots=2)
    # top_k=1 at any temperature is argmax
    out = await sched.submit(ids[0], temperature=5.0, top_k=1)
    np.testing.assert_array_equal(out, oracle[0])
    out = await sched.submit(ids[1], max_new_tokens=3)
    np.testing.assert_array_equal(out, oracle[1][: SEQ + 3])
    out = await sched.submit(ids[1], max_new_tokens=10_000)  # clamps to the cap
    np.testing.assert_array_equal(out, oracle[1])
    # sampled rows: in the vocabulary, and the same draws for the same
    # (seed, tick) sequence
    a = _scheduler(tp, n_slots=1, seed=7)
    b = _scheduler(tp, n_slots=1, seed=7)
    sa = await a.submit(ids[0], temperature=1.5)
    sb = await b.submit(ids[0], temperature=1.5)
    np.testing.assert_array_equal(sa, sb)
    assert sa.min() >= 0 and sa.max() < VOCAB
    for s in (sched, a, b):
        await s.close()


async def test_no_new_dispatch_key_after_warmup(params):
    _, tp, _ = params
    ids = _prompts(6, seed=2)
    sched = DecodeScheduler(tp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=3, prefill_chunk=4)
    assert sched.recompiles_since_warmup() == -1
    sched.warmup()
    counts = sched.compile_counts()
    assert counts == {"step": 1, "chunk": len(sched.chunk_buckets), "copy": len(sched.pool.copy_buckets)}
    outs = await asyncio.gather(
        *(sched.submit(row, max_new_tokens=3 + i, temperature=0.5 * (i % 2), top_k=i, prefill_chunk=1 + i % 3)
          for i, row in enumerate(ids))
    )
    assert all(len(o) > SEQ for o in outs)
    assert sched.recompiles_since_warmup() == 0, sched.compile_counts()
    await sched.close()


async def test_wrong_prompt_length_rejected(params):
    sched = _scheduler(params[1])
    with pytest.raises(APIException, match="seq_len") as e:
        await sched.submit(np.zeros(SEQ + 3, np.int32))
    assert e.value.error.code == 101 and e.value.error.http_status == 400
    await sched.close()


async def test_queue_timeout_expires_unadmitted_requests(params):
    _, tp, jax_oracle = params
    ids = _prompts(2, seed=8)
    oracle = jax_oracle(ids)
    sched = _scheduler(tp, n_slots=1, queue_timeout_s=1e-4)
    t_a = asyncio.ensure_future(sched.submit(ids[0]))
    t_b = asyncio.ensure_future(sched.submit(ids[1]))
    np.testing.assert_array_equal(await t_a, oracle[0])
    with pytest.raises(APIException, match="timed out waiting") as e:
        await t_b
    assert e.value.error == ErrorCode.REQUEST_TIMEOUT
    await sched.close()


async def test_closed_scheduler_rejects_and_drains(params):
    _, tp, jax_oracle = params
    ids = _prompts(1)
    sched = _scheduler(tp)
    out_task = asyncio.ensure_future(sched.submit(ids[0]))
    await asyncio.sleep(0)  # let it admit
    await sched.close()
    np.testing.assert_array_equal(await out_task, jax_oracle(ids)[0])
    with pytest.raises(APIException, match="closed"):
        await sched.submit(ids[0])


async def test_abort_cancels_in_flight_and_restores_the_pool(params):
    sched = _scheduler(params[1], n_slots=1)
    tasks = [asyncio.ensure_future(sched.submit(row)) for row in _prompts(2, seed=3)]
    await asyncio.sleep(0.01)
    await sched.abort()
    for t in tasks:
        with pytest.raises(asyncio.CancelledError):
            await t
    sched.pool.alloc.check()
    assert sched.pool.alloc.free_pages == sched.pool.n_pages - 1


# --------------------------------------------------------- serving wiring


def _predictor(n_slots: int, **tpu_extra) -> PredictorSpec:
    return PredictorSpec.from_dict({
        "name": "p",
        "graph": {
            "name": "gpt", "type": "MODEL", "implementation": "JAX_MODEL",
            "parameters": [
                {"name": "model", "value": "tiny_gpt", "type": "STRING"},
                {"name": "seq", "value": str(SEQ), "type": "INT"},
                {"name": "max_new_tokens", "value": "6", "type": "INT"},
                {"name": "vocab", "value": str(VOCAB), "type": "INT"},
            ],
        },
        "tpu": {"max_batch": 4, "batch_buckets": [4], "decode_slots": n_slots, **tpu_extra},
    })


async def test_scheduler_through_server_and_batcher():
    """The micro-batcher hands generative rows to the scheduler; the
    buffered response equals the fused zoo apply of the port and the JAX
    package's tiny_gpt, with per-row lengths in meta.tags.gen_lens."""
    from seldon_core_tpu.models.zoo import get_model as jax_get_model

    server = PredictorServer(_predictor(2), deployment_name="d", device="cpu")
    assert server.decode_scheduler is not None and server.batcher is not None
    server.warmup()
    try:
        ids = _prompts(3, seed=7)
        out = await server.service.predict(SeldonMessage.from_array(ids))
        ms = jax_get_model("tiny_gpt", seq=SEQ, max_new_tokens=6, vocab=VOCAB)
        oracle = np.asarray(jax.jit(ms.apply_fn)(ms.params, jnp.asarray(ids)))
        np.testing.assert_array_equal(np.asarray(out.array).astype(np.int32), oracle)
        assert out.meta.tags["gen_lens"] == [6, 6, 6]
        runtime = server.executor.root.unit.runtime
        np.testing.assert_array_equal(runtime.predict(ids), oracle)  # the fused path
        # per-request budget through meta.tags; short rows pad with 0
        msg = SeldonMessage.from_array(ids[:1], meta=Meta(tags={"max_new_tokens": 2}))
        out = await server.service.predict(msg)
        np.testing.assert_array_equal(np.asarray(out.array), oracle[:1, : SEQ + 2])
        assert out.meta.tags["gen_lens"] == [2]
        with pytest.raises(APIException, match="must be a number"):
            await server.service.predict(SeldonMessage.from_array(ids[:1], meta=Meta(tags={"top_k": "x"})))
        assert server.decode_scheduler.recompiles_since_warmup() == 0
    finally:
        await server.stop()


async def test_non_generative_graph_ignores_decode_slots():
    pred = PredictorSpec.from_dict({
        "name": "p",
        "graph": {"name": "m", "type": "MODEL", "implementation": "JAX_MODEL",
                  "parameters": [{"name": "model", "value": "iris_mlp", "type": "STRING"}]},
        "tpu": {"max_batch": 4, "batch_buckets": [4], "decode_slots": 4},
    })
    server = PredictorServer(pred, deployment_name="d", device="cpu")
    assert server.decode_scheduler is None
    out = await server.service.predict(SeldonMessage.from_array(np.ones((2, 4), np.float32)))
    assert np.asarray(out.array).shape == (2, 3)
    await server.stop()


async def _read_sse_response(reader):
    """One chunked HTTP response: (status, headers, SSE data objects,
    number of chunks)."""
    status = int((await reader.readline()).split(b" ")[1])
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b""):
            break
        k, _, v = line.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    assert headers.get("transfer-encoding") == "chunked"
    chunks = []
    while True:
        size = int((await reader.readline()).strip(), 16)
        if size == 0:
            await reader.readline()
            break
        chunks.append(await reader.readexactly(size))
        await reader.readexactly(2)
    events = [json.loads(f[len(b"data: "):]) for f in b"".join(chunks).split(b"\n\n") if f.startswith(b"data: ")]
    return status, headers, events, len(chunks)


async def test_streaming_e2e_through_fast_ingress():
    """SSE on the fast ingress: one chunk per token, then a done event whose
    ids equal the buffered /predictions answer for the same prompt; a bad
    prompt length is a plain 400 before any stream starts."""
    server = PredictorServer(_predictor(2), deployment_name="d", device="cpu")
    server.warmup()
    await server.start("127.0.0.1", 0)
    port = server.port

    async def post(path, body):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write((f"POST {path} HTTP/1.1\r\nHost: t\r\nContent-Type: application/json\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        return reader, writer

    try:
        ids = _prompts(1, seed=11)
        body = json.dumps({"data": {"ndarray": ids.tolist()}}).encode()
        reader, writer = await post("/api/v0.1/predictions/stream", body)
        status, headers, events, n_chunks = await _read_sse_response(reader)
        writer.close()
        assert status == 200 and headers["content-type"] == "text/event-stream"
        tokens = [e for e in events if "token" in e]
        done = events[-1]
        assert done["done"] is True and done["puid"]
        assert len(tokens) == 6 == done["gen_lens"][0] and n_chunks >= len(tokens)
        assert [e["index"] for e in tokens] == list(range(6))
        reader, writer = await post("/api/v0.1/predictions", body)
        head = await reader.readuntil(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 200")
        clen = int(next(ln for ln in head.split(b"\r\n") if ln.lower().startswith(b"content-length")).split(b":")[1])
        buffered = np.asarray(json.loads(await reader.readexactly(clen))["data"]["ndarray"], np.int64)[0]
        writer.close()
        np.testing.assert_array_equal([e["token"] for e in tokens], buffered[SEQ:])
        np.testing.assert_array_equal(done["ids"][0], buffered)
        reader, writer = await post("/api/v0.1/predictions/stream", json.dumps({"data": {"ndarray": [[1, 2, 3]]}}).encode())
        assert (await reader.readline()).split(b" ")[1] == b"400"
        writer.close()
    finally:
        await server.stop()


# the speculation knobs, once in UNPORTED_DECODE_KNOBS, are served now: set
# alone, each is refused by the JAX package's validation rule that names it,
# except the draft model alone, which serves with speculation off (the JAX
# package's warn-and-disable case)
SERVED_SPEC_KNOBS = {"decode_draft_model": "", "decode_spec_accept_floor": 0.0, "decode_spec_k": 0,
                     "decode_spec_tree": ""}
# the SLO targets, once unported too, are served: set alone on a scheduler
# deployment, each reaches the scheduler
SERVED_SLO_KNOBS = {"decode_slo_itl_ms": 0.0, "decode_slo_ttft_ms": 0.0}
# the KV tier knobs, once unported too, are served: set alone, each is
# refused by the JAX package's rule that names it (the host tier needs the
# prefix cache, the store needs the host tier)
SERVED_TIER_KNOBS = {"decode_kv_host_bytes": 0, "decode_kv_store_tier": ""}
# the npy wire toggle, once unported too, is served: set alone, it reaches
# the prediction service
SERVED_WIRE_KNOBS = {"decode_npy_bindata": True}
# the replicated fleet's knobs, once unported too, are served: set alone,
# decode_replicas builds the fleet, the miss threshold and the drain budget
# serve one scheduler (the JAX package ignores them there), and each other
# is refused by the JAX package's rule that names it
SERVED_FLEET_KNOBS = {"decode_replicas": 1, "decode_router_policy": "", "decode_autoscale_replicas": 0,
                      "decode_autoscale_queue_depth": 0, "decode_health_poll_ms": 0.0,
                      "decode_health_miss_threshold": 3, "decode_drain_timeout_ms": 5000.0}
ONCE_UNPORTED = {**UNPORTED_DECODE_KNOBS, **SERVED_SPEC_KNOBS, **SERVED_SLO_KNOBS, **SERVED_TIER_KNOBS,
                 **SERVED_WIRE_KNOBS, **SERVED_FLEET_KNOBS}


@pytest.mark.parametrize("knob", sorted(ONCE_UNPORTED))
def test_unported_decode_knob_refused_by_name(knob):
    default = ONCE_UNPORTED[knob]
    value = {str: "x", int: 2, float: 0.5, dict: {"tp": 2}, bool: False}[type(default)]
    if knob == "decode_draft_model":
        server = PredictorServer(_predictor(2, **{knob: "zoo://draft"}), device="cpu")
        assert not server.decode_scheduler.spec_enabled
    elif knob in SERVED_SLO_KNOBS:
        server = PredictorServer(_predictor(2, **{knob: value}), device="cpu")
        assert getattr(server.decode_scheduler, knob.replace("decode_", "").replace("_ms", "_s")) == value / 1e3
        assert knob not in UNPORTED_DECODE_KNOBS
    elif knob in SERVED_WIRE_KNOBS:
        server = PredictorServer(_predictor(2, **{knob: value}), device="cpu")
        assert server.service.decode_npy is value
        assert knob not in UNPORTED_DECODE_KNOBS
    elif knob in ("decode_replicas", "decode_health_miss_threshold", "decode_drain_timeout_ms"):
        server = PredictorServer(_predictor(2, **{knob: value}), device="cpu")
        sched = server.decode_scheduler
        assert getattr(server.predictor.tpu, knob) == value and knob not in UNPORTED_DECODE_KNOBS
        assert len(sched.replicas) == value if knob == "decode_replicas" else isinstance(sched, DecodeScheduler)
    else:
        with pytest.raises(ValueError, match=knob):
            PredictorServer(_predictor(2, **{knob: value}), device="cpu")
        if knob in SERVED_TIER_KNOBS or knob in SERVED_FLEET_KNOBS:
            assert knob not in UNPORTED_DECODE_KNOBS
    # the JAX package's default is no request for the feature: accepted
    assert decode_problems("p", TpuSpec.from_dict({"decode_slots": 2, knob: default})) == []


@pytest.mark.parametrize("tpu,needle", [
    ({"decode_slots": 2, "decode_kv_page_size": 16, "decode_prefill_chunk": 24}, "multiple of decode_kv_page_size"),
    ({"decode_slots": 4, "decode_kv_pages": 4}, "below decode_slots"),
    ({"decode_slots": 2, "decode_kv_dtype": "fp8"}, "unsupported"),
    ({"decode_kv_dtype": "int8"}, "need decode_slots"),
    ({"decode_prefill_chunk": 8}, "need decode_slots"),
    ({"decode_slots": 2, "decode_prefix_ctx": 8}, "needs decode_prefix_slots"),
    ({"decode_slots": 2, "decode_eos_id": -2}, "decode_eos_id"),
    ({"decode_slots": 2, "decode_prefix_slots": -1}, "must be >= 0"),
    ({"decode_slots": 2, "decode_slo_ttft_ms": -1.0}, "decode_slo_ttft_ms must be >= 0"),
    ({"decode_slo_itl_ms": 5.0}, "need decode_slots"),
])
def test_decode_knob_validation(tpu, needle):
    problems = decode_problems("p", TpuSpec.from_dict(tpu))
    assert len(problems) == 1 and needle in problems[0], problems


# ---------------------------------------------------------- pipelined rounds
#
# The pipelined round loop (ENGINE_DECODE_PIPELINE, on by default): round
# N+1's host phases run under round N's in-flight dispatch against shadow
# state, reconciled after the readback walks. The JAX package's contracts
# (tests/test_decode_scheduler.py, tests/test_flight_recorder.py): greedy
# output bit-identical to the serial loop and the oracle, no new key, and a
# rollback-safe deferral under tight page budgets. On the CPU the pipelined
# round runs the same code with eager entries.


def _serial(s: DecodeScheduler) -> DecodeScheduler:
    """The serial loop on one scheduler (ENGINE_DECODE_PIPELINE=off)."""
    s.pipeline_enabled = False
    return s


async def _staggered(sched, ids, budgets=None, stagger=0.002):
    async def one(i):
        await asyncio.sleep(i * stagger)
        kw = {} if budgets is None else {"max_new_tokens": int(budgets[i])}
        return await sched.submit(ids[i], **kw)

    return await asyncio.gather(*(one(i) for i in range(len(ids))))


async def test_pipelined_greedy_bit_identical_midstream(params):
    """Mixed mid-stream admissions and retirements: the pipelined loop's
    rows equal the serial loop's, the JAX oracle's and the JAX pipelined
    scheduler's, bit for bit; the window hid host work (overlap in the
    frames) and the phase split still fits in the gap."""
    from seldon_core_tpu.serving.decode_scheduler import DecodeScheduler as JaxDecodeScheduler

    jp, tp, jax_oracle = params
    ids = _prompts(6, seed=31)
    budgets = [3, MAX_NEW, 5, 2, MAX_NEW, 4]
    oracle = jax_oracle(ids)
    serial = _serial(_scheduler(tp, n_slots=2))
    serial_outs = await _staggered(serial, ids, budgets)
    await serial.close()
    assert serial.stat_pipelined_rounds == 0
    piped = _scheduler(tp, n_slots=2)
    assert piped._pipeline_on()
    outs = await _staggered(piped, ids, budgets)
    jsched = JaxDecodeScheduler(jp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=2)
    jsched.warmup()
    jouts = await _staggered(jsched, ids, budgets)
    await jsched.close()
    for i, (a, b, j) in enumerate(zip(serial_outs, outs, jouts)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, oracle[i][: SEQ + budgets[i]])
        np.testing.assert_array_equal(b, j)
    assert piped.stat_pipelined_rounds > 0
    agg = piped.flight.aggregate()
    assert agg["overlap_of_gap"] > 0.0
    assert agg["overlap_of_gap"] + agg["bubble_residual"] == pytest.approx(1.0, abs=2e-4)
    assert agg["phase_of_gap"] <= 1.0
    piped.pool.alloc.check()
    await piped.close()


async def test_pipelined_prefix_warm_admissions(params):
    """Prefix-warm admissions under the pipeline: the seed request's
    retirement captures its prompt, sharers then admit against the warm
    index; rows equal the serial loop's and the hits count the same."""
    _, tp, jax_oracle = params
    shared, distinct = _prompts(1, seed=8)[0], _prompts(1, seed=9)[0]
    ids = np.stack([shared, shared, shared, distinct])

    def mk(pipe: bool) -> DecodeScheduler:
        s = _scheduler(tp, n_slots=2, prefix_slots=4)
        return s if pipe else _serial(s)

    serial = mk(False)
    serial_outs = [await serial.submit(ids[0])] + await _staggered(serial, ids[1:])
    await serial.close()
    piped = mk(True)
    outs = [await piped.submit(ids[0])] + await _staggered(piped, ids[1:])
    oracle = jax_oracle(ids)
    for a, b, o in zip(serial_outs, outs, oracle):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, o)
    assert piped.stat_prefix_hits == serial.stat_prefix_hits >= 1
    assert piped.stat_pipelined_rounds > 0 and piped.recompiles_since_warmup() == 0
    await piped.close()


async def test_pipelined_tight_pages_deferred_admit_rollback(params):
    """A page budget that fits one slot's worst case: the admission tried
    under an in-flight dispatch is refused by the pre-retire pool and
    defers to the serial walk, which admits once the retirement frees the
    pages. Rows equal the oracle, the allocator audit holds, the deferral
    is counted."""
    _, tp, jax_oracle = params
    ids = _prompts(3, seed=23)
    sched = _scheduler(tp, n_slots=2, kv_page_size=4, kv_pages=7)  # 5 pages a slot: one slot and slack
    assert sched._pipeline_on()
    outs = await _staggered(sched, ids, stagger=0.001)
    for row, out in zip(jax_oracle(ids), outs):
        np.testing.assert_array_equal(out, row)
    assert sched.stat_admit_blocked_rounds > 0
    assert sched.stat_pipeline_deferred > 0
    sched.pool.alloc.check()
    await sched.close()


async def test_pipeline_expiry_never_fails_a_decided_admit_and_failed_futures_roll_back(params):
    """Two reconcile edges: the window's expiry sweep must not time out a
    waiter the same window decided, and a decision whose future settled
    during the flight (cancelled or failed) rolls its reservation back."""
    import time as _time

    from seldon_core_tpu_torch.serving.decode_scheduler import _Seq

    sched = _scheduler(params[1], n_slots=2)
    loop = asyncio.get_running_loop()
    seq = _Seq(_prompts(1, seed=41)[0], 4, 0.0, 0, 0, None, loop.create_future())
    seq.uid = 10_001
    seq.deadline = _time.perf_counter() - 1.0
    sched._waiting.append(seq)
    sched._overlap_window()  # decides the admission, then sweeps
    assert len(sched._pending_admits) == 1
    assert not seq.future.done(), "the sweep expired a decided admission"
    sched._apply_pending()
    assert sched._slots[seq.slot] is seq and seq.prefilling
    seq2 = _Seq(_prompts(1, seed=43)[0], 4, 0.0, 0, 0, None, loop.create_future())
    seq2.uid = 10_002
    sched._waiting.append(seq2)
    sched._pipeline_admit()
    assert len(sched._pending_admits) == 1
    seq2.future.set_exception(APIException(ErrorCode.REQUEST_TIMEOUT, "expired mid-flight"))
    free_before = len(sched._free)
    sched._apply_pending()
    assert sched.stat_pipeline_rollbacks == 1
    assert len(sched._free) == free_before
    assert all(s is None or s is seq for s in sched._slots)
    sched.pool.alloc.check()
    seq.future.cancel()
    await sched.close()


async def test_pipeline_reconcile_upgrades_to_post_capture_prefix_hit(params):
    """A decision made before a capture the same round's walk performs is
    upgraded at the reconcile to the warm mapping the serial loop would
    have served."""
    from seldon_core_tpu_torch.serving.decode_scheduler import _PendingAdmit, _Seq

    sched = _scheduler(params[1], n_slots=2, prefix_slots=4)
    shared = _prompts(1, seed=51)[0]
    await sched.submit(shared)  # a finished tenant captures the prompt at retirement
    assert sched._prefix_index.entries
    hits_before = sched.stat_prefix_hits
    seq = _Seq(shared, 4, 0.0, 0, 0, None, asyncio.get_running_loop().create_future())
    seq.uid = 20_001
    slot = sched._free[-1]
    assert sched.pool.alloc.try_admit(slot, (), 0, 0)  # the cold decision, made before the capture
    sched._waiting.append(seq)
    sched._pending_admits.append(_PendingAdmit(seq, slot, None, 0, 0))
    sched._apply_pending()
    assert sched._slots[slot] is seq
    assert seq.prefix_len > 0, "the reconcile kept the stale cold decision"
    assert sched.stat_prefix_hits == hits_before + 1
    sched.pool.alloc.check()
    seq.future.cancel()
    await sched.close()


async def test_pipelined_zero_recompiles_and_kill_switch(params, monkeypatch):
    """No new key with the pipeline on (sampled rows included), and the
    kill switches: ENGINE_DECODE_PIPELINE=off and sync timing each force
    the serial loop."""
    from seldon_core_tpu_torch.telemetry import flight as flight_mod

    _, tp, jax_oracle = params
    ids = _prompts(5, seed=37)
    sched = _scheduler(tp, n_slots=3)
    outs = await asyncio.gather(*(sched.submit(row, max_new_tokens=2 + i, temperature=0.5 * (i % 2), top_k=i)
                                  for i, row in enumerate(ids)))
    assert all(len(o) > SEQ for o in outs)
    assert sched.stat_pipelined_rounds > 0 and sched.recompiles_since_warmup() == 0
    await sched.close()
    forced = _scheduler(tp, n_slots=2)
    forced._sync_timing = True  # ENGINE_FLIGHT_SYNC_TIMING=on
    assert not forced._pipeline_on()
    np.testing.assert_array_equal(await forced.submit(ids[0]), jax_oracle(ids[:1])[0])
    assert forced.stat_pipelined_rounds == 0
    await forced.close()
    monkeypatch.setenv(flight_mod.ENGINE_DECODE_PIPELINE, "off")
    assert not flight_mod.decode_pipeline_enabled()
    off = DecodeScheduler(tp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=2)
    assert not off.pipeline_enabled and not off._pipeline_on()
    monkeypatch.setenv(flight_mod.ENGINE_DECODE_PIPELINE, "on")
    assert flight_mod.decode_pipeline_enabled()


async def test_pipelined_frames_carry_overlap(params):
    """With the pipeline on, plain frames carry overlap_ns > 0 and the
    phase split stays within each frame's gap (the JAX package's
    tests/test_flight_recorder.py contract)."""
    _, tp, _ = params
    s = _scheduler(tp, n_slots=4)
    await asyncio.gather(*(s.submit(row, max_new_tokens=4) for row in _prompts(6, seed=3)))
    assert s.recompiles_since_warmup() == 0
    frames = s.flight.snapshot()
    assert any(f.overlap_ns > 0 for f in frames)
    for f in frames:
        assert sum(f.phase_ns) <= f.gap_ns + 50_000, (f.seq, f.phase_ns, f.gap_ns)
    assert s.flight.aggregate()["overlap_of_gap"] > 0.0 and s.stat_pipelined_rounds > 0
    await s.close()


async def test_pipelined_chunk_plans_are_taken_only_while_their_key_holds(params):
    """With chunked prefill the window builds the next chunk round's arrays
    and the chunk round takes them (rows equal the oracle); a plan whose
    key no longer matches the live rows is discarded, and a key without
    the tenant's uid would hand one request's plan to another."""
    _, tp, jax_oracle = params
    ids = _prompts(4, seed=45)
    sched = _scheduler(tp, n_slots=2, prefill_chunk=2)
    outs = await _staggered(sched, ids)
    for row, out in zip(jax_oracle(ids), outs):
        np.testing.assert_array_equal(out, row)
    assert sched.stat_pipeline_plans_used > 0
    used = sched.stat_pipeline_plans_used
    sched._pending_chunk_plan = (((0, 7, 0, 2),), "stale")
    assert sched._pipeline_take_chunk_plan(((0, 8, 0, 2),)) is None  # same slot and span, another tenant
    assert sched._pending_chunk_plan is None and sched.stat_pipeline_plans_used == used
    await sched.close()


class _SlowEvent:
    """A readback event that reports done only after ``polls`` queries, or
    when synchronized; records the thread that synchronized it."""

    def __init__(self, polls: int):
        self.polls, self.synced_on = polls, None

    def query(self) -> bool:
        self.polls -= 1
        return self.polls < 0

    def synchronize(self) -> None:
        import threading

        self.synced_on = threading.current_thread().name


@pytest.mark.parametrize("spin_s, polls, handoff", [(1.0, 3, False), (0.0, 10**9, True)])
async def test_readback_wait_polls_within_its_bound_then_hands_off(params, spin_s, polls, handoff):
    """A pipelined round's readback is polled on the loop's thread for at
    most ``readback_spin_s``; a round still in flight then waits on the
    worker (the event's synchronize()), counted, never spinning on."""
    _, tp, _ = params
    sched = _scheduler(tp)
    sched.readback_spin_s = spin_s
    host, done = torch.arange(3, dtype=torch.int32), _SlowEvent(polls)
    got = await sched._await_readback(host, done)
    np.testing.assert_array_equal(got, [0, 1, 2])
    assert sched.stat_readback_handoffs == int(handoff)
    assert (done.synced_on or "").startswith("seldon-decode") == handoff
    await sched.close()
