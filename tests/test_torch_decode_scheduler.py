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
ONCE_UNPORTED = {**UNPORTED_DECODE_KNOBS, **SERVED_SPEC_KNOBS, **SERVED_SLO_KNOBS}


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
    else:
        with pytest.raises(ValueError, match=knob):
            PredictorServer(_predictor(2, **{knob: value}), device="cpu")
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
