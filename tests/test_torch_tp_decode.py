"""Tensor-parallel decode (``seldon_core_tpu_torch/parallel/tp.py`` and the
decode scheduler over a decode mesh) and int8 BERT over a "model" axis,
held to the JAX package's contracts (``tests/test_tp_decode.py``) on the CPU.

The load-bearing invariant, as there: placing the decoder's parameters,
the paged KV pool and the draft's flat cache over a decode mesh
(``tpu.decode_mesh_axes``) changes where the math runs, never what it
computes — greedy output at tp 2 and 4 equals the port's single-device
scheduler and the JAX package's fused ``generate`` on the same parameters,
speculation (chain, tree, feature head) and chunked/prefix/CoW traffic
included, with no dispatch key built after warmup. The JAX side runs on the
8 virtual CPU devices of ``tests/conftest.py``; the port's on positions
``[torch.device("cpu")] * N``, with the JAX package's numpy parameters
carried across (``models/convert.py::carry_params``). Planted faults (a
row-parallel bias added on every position, int8 scales taken per position's
heads) must fail the checks that guard them.
"""

import asyncio
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.models import decoder as jd
from seldon_core_tpu.parallel.tp import decode_mesh_problems as jax_problems
from seldon_core_tpu_torch.models import decoder as td
from seldon_core_tpu_torch.models.convert import carry_params, params_to_torch
from seldon_core_tpu_torch.parallel import tp as tp_mod
from seldon_core_tpu_torch.parallel.tp import Placed, decode_mesh_problems, decode_tp_mesh
from seldon_core_tpu_torch.serving.decode_scheduler import DecodeScheduler

SEQ = 8
MAX_NEW = 10
VOCAB = 128
CPU = torch.device("cpu")


def _np_params(layers=2, seed=3, hidden=256, ffn=512):
    # hidden 256 -> 4 heads (head_dim-64 convention), ffn 512: divisible by
    # every width under test
    return jd.init_decoder(seed=seed, vocab=VOCAB, hidden=hidden, layers=layers, ffn=ffn, max_len=64,
                           resid_scale=0.1)


def _port(np_params):
    """The JAX package's numpy parameters carried into the port's tree."""
    own = td.init_decoder(seed=99, vocab=VOCAB, hidden=np_params["tok_emb"].shape[1],
                          layers=len(np_params["layers"]), ffn=np_params["layers"][0]["mlp_in"]["w"].shape[1],
                          max_len=64)
    return params_to_torch(carry_params(own, np_params), CPU)


@pytest.fixture(scope="module")
def model():
    """(numpy params, port tensors, port 1-layer draft, JAX greedy oracle)."""
    p = _np_params()
    gen = jax.jit(jd.generate, static_argnums=2)
    return p, _port(p), _port(_np_params(layers=1)), lambda ids, n=MAX_NEW: np.asarray(gen(p, jnp.asarray(ids), n))


def _prompts(n, seed=1):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, SEQ)).astype(np.int32)


def _shared_prompts(n, shared=5, seed=2):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, VOCAB, shared).astype(np.int32)
    return np.stack([np.concatenate([head, rng.integers(0, VOCAB, SEQ - shared)]).astype(np.int32)
                     for _ in range(n)])


def _scheduler(params, tp=1, n_slots=3, **kw) -> DecodeScheduler:
    mesh = {"mesh_axes": {"tp": tp}, "devices": [CPU] * tp} if tp > 1 else {}
    s = DecodeScheduler(params, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=n_slots, **mesh, **kw)
    s.warmup()
    return s


async def _serve(sched, ids, **kw):
    outs = await asyncio.gather(*(sched.submit(row, **kw) for row in ids))
    return np.stack(outs)


# ------------------------------------------------------- width parity


@pytest.mark.parametrize("tp", [2, 4])
async def test_tp_greedy_matches_tp1_and_oracle(model, tp):
    """Greedy decode at tp 2 and 4 emits exactly the single-device
    scheduler's tokens and the JAX ``generate``'s, with no key built after
    warmup and every pool buffer laid out over exactly the positions."""
    _, params, _, oracle_fn = model
    ids = _prompts(3)
    oracle = oracle_fn(ids)
    one = _scheduler(params)
    np.testing.assert_array_equal(await _serve(one, ids), oracle)
    await one.close()
    sched = _scheduler(params, tp)
    assert sched.tp == tp and sched.mesh is not None and sched.mesh.size == tp
    base = sched.compile_counts()
    np.testing.assert_array_equal(await _serve(sched, ids), oracle)
    assert sched.compile_counts() == base and sched.recompiles_since_warmup() == 0
    audit = sched.shard_audit()
    assert audit["tp"] == tp and audit["mesh_devices"] == tp and audit["distinct_devices"] == 1
    assert audit["components_audited"] >= 2  # K + V pool payloads
    assert tuple(sched.pool.state[0].parts[0].shape)[2] == 4 // tp
    await sched.close()


@pytest.mark.parametrize("mode", ["chain", "tree", "feature"])
async def test_tp_speculation_token_identical(model, mode):
    """Speculation rides the mesh: the draft (a truncated decoder, or the
    feature head) and its flat cache shard like the target, and greedy
    speculative output at tp 2 equals the JAX oracle and the same scheduler
    at tp 1, chain, tree ("2,2,1,1") and feature head alike."""
    np_p, params, draft, oracle_fn = model
    if mode == "feature":
        draft = _port_feature(np_p)
        kw = {"draft_params": draft, "spec_tree": "2,2,1"}
    else:
        kw = {"draft_params": draft, **({"spec_k": 3} if mode == "chain" else {"spec_tree": "2,2,1,1"})}
    ids = _prompts(3, seed=11)
    oracle = oracle_fn(ids)
    outs = {}
    for tp in (1, 2):
        sched = _scheduler(params, tp, **kw)
        outs[tp] = await _serve(sched, ids)
        assert sched.recompiles_since_warmup() == 0
        assert sched.stat_spec_dispatches > 0  # speculation actually ran
        if tp == 2:
            # the draft's K/V audited beside the pool's payloads
            assert sched.shard_audit()["components_audited"] >= 4
        await sched.close()
    np.testing.assert_array_equal(outs[2], outs[1])
    np.testing.assert_array_equal(outs[2], oracle)


def _port_feature(np_p):
    head = jd.init_feature_draft(seed=3, vocab=VOCAB, hidden=256, ffn=512, max_len=64)
    own = td.init_feature_draft(seed=99, vocab=VOCAB, hidden=256, ffn=512, max_len=64)
    return params_to_torch(carry_params(own, head), CPU)


async def test_tp_int8_paged_prefix_agreement(model):
    """int8 paged KV over the mesh: the scale and zero-point planes come
    from the full fresh rows, so the single-device int8 contract carries
    over — JAX's > 0.5 greedy agreement with the fp oracle — and the port
    at tp 2 emits, row for row, what the JAX package's own int8 tp-2
    scheduler emits."""
    from seldon_core_tpu.serving.decode_scheduler import DecodeScheduler as JaxScheduler

    np_p, params, _, oracle_fn = model
    ids = _shared_prompts(6, shared=5, seed=21)
    oracle = oracle_fn(ids)
    kw = dict(n_slots=2, prefix_slots=4, prefill_chunk=4, kv_page_size=4, kv_dtype="int8")
    sched = _scheduler(params, 2, **kw)
    outs = await _serve(sched, ids)
    assert sched.recompiles_since_warmup() == 0
    await sched.close()
    np.testing.assert_array_equal(outs[:, :SEQ], oracle[:, :SEQ])
    agree = int(np.sum(outs[:, SEQ:] == oracle[:, SEQ:]))
    assert agree / oracle[:, SEQ:].size > 0.5, f"int8 tp=2 greedy agreement {agree}/{oracle[:, SEQ:].size}"
    jsched = JaxScheduler(np_p, seq_len=SEQ, max_new_tokens=MAX_NEW, mesh_axes={"tp": 2}, **kw)
    jsched.warmup()
    want = np.stack(await asyncio.gather(*(jsched.submit(row) for row in ids)))
    await jsched.close()
    np.testing.assert_array_equal(outs, want)


async def test_tp_zero_recompiles_mixed_traffic(model):
    """Chunked prefill, prefix hits, copy-on-write, admission beyond the
    slot count and per-request budgets ride the keys warmup() built, the
    outputs stay oracle-exact, and the allocator and shard audits pass."""
    _, params, _, oracle_fn = model
    ids = _shared_prompts(7, shared=5, seed=31)
    oracle = oracle_fn(ids)
    sched = _scheduler(params, 2, n_slots=2, prefix_slots=4, prefill_chunk=4, kv_page_size=4)
    base = sched.compile_counts()
    budgets = [MAX_NEW, 4, 7, MAX_NEW, 3, MAX_NEW, 5]
    outs = await asyncio.gather(*(sched.submit(row, max_new_tokens=b) for row, b in zip(ids, budgets)))
    for row, out, b in zip(oracle, outs, budgets):
        np.testing.assert_array_equal(out, row[: SEQ + b])
    assert sched.compile_counts() == base and sched.recompiles_since_warmup() == 0
    assert sched.stat_prefix_hits > 0 and sched.pool.stat_copy_dispatches > 0
    sched.pool.alloc.check()
    audit = sched.shard_audit()
    assert audit["mesh_devices"] == 2 and audit["components_audited"] >= 2
    await sched.close()


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
async def test_host_tier_round_trips_a_head_sharded_page(model, kv_dtype):
    """The host tier moves whole pages: a read gathers every position's
    heads, a write scatters them back, bit for bit; a demoted prefix entry
    promoted back decodes exactly what the same scheduler decoded cold."""
    _, params, _, _ = model
    ids = _prompts(2, seed=13)
    sched = _scheduler(params, 2, n_slots=2, prefix_slots=1, kv_page_size=4, kv_dtype=kv_dtype,
                       kv_host_bytes=1 << 26)
    cold0 = await sched.submit(ids[0])
    await sched.submit(ids[1])
    assert sched.stat_tier_demotions >= 1
    np.testing.assert_array_equal(await sched.submit(ids[0]), cold0)
    assert sched.stat_tier_promotions >= 1 and sched.recompiles_since_warmup() == 0
    pool = sched.pool
    live = [1, 2, 3]
    comps = pool.read_pages(live)
    assert [(c.shape[0], *c.shape[2:]) for c in comps] == [shape for shape, _ in pool.host_layout()]
    pool.write_pages([5, 6, 7], comps)
    for a, b in zip(pool.read_pages([5, 6, 7]), comps):
        assert a.tobytes() == b.tobytes()
    # the gathered page is every position's heads side by side
    heads = pool.state[0].parts[1][:, 2].numpy()
    want = comps[0][:, 1, 2:4]
    assert (heads.view(np.uint8) == want.view(np.uint8)).all()
    await sched.close()


# ------------------------------------------------------- planted faults


async def test_a_row_parallel_bias_added_on_every_position_fails(monkeypatch):
    """With nonzero row-parallel biases, tp 2 still equals tp 1; a bias
    added on every position's partial (then summed tp times) must not."""
    np_p = _np_params()
    rng = np.random.default_rng(5)
    for lp in np_p["layers"]:
        for name in ("attn_out", "mlp_out"):
            lp[name] = {**lp[name], "b": (rng.standard_normal(lp[name]["b"].shape) * 0.005).astype(np.float32)}
    params = _port(np_p)
    ids = _prompts(3, seed=17)
    one = _scheduler(params)
    want = await _serve(one, ids)
    await one.close()
    sched = _scheduler(params, 2)
    np.testing.assert_array_equal(await _serve(sched, ids), want)
    await sched.close()

    real = tp_mod.row_parallel

    def on_every_position(partials, bias, mesh, axis):
        return real([p + bias for p in partials], bias * 0, mesh, axis)

    monkeypatch.setattr(tp_mod, "row_parallel", on_every_position)
    bad = _scheduler(params, 2)
    got = await _serve(bad, ids)
    await bad.close()
    assert not np.array_equal(got, want), "a bias summed over the positions went unnoticed"


async def test_int8_scales_come_from_every_head(model, monkeypatch):
    """The int8 pool's page rows at tp 2 hold, for the first layer (whose
    input is the same embedding), the bytes the single-device pool holds;
    scales taken over one position's heads (each position quantizing its
    own) must not."""
    _, params, _, _ = model
    ids = torch.from_numpy(_prompts(2, seed=19)).long()
    bt = torch.tensor([[1, 2], [3, 4]])
    pos, counts = torch.zeros(2, dtype=torch.long), torch.full((2,), SEQ)

    def layer0(tp):
        p = params if tp == 1 else tp_mod.place_decoder(params, *decode_tp_mesh({"tp": tp}, params,
                                                                                  devices=[CPU] * tp)[:2])
        pool = td.paged_kv_init(p, 6, 4, kv_dtype="int8")
        td.paged_chunk_prefill(p, pool, bt, ids, pos, counts)
        return [(torch.cat(a.parts, dim=a.dim) if a.dim is not None else a.parts[0]) if isinstance(a, Placed) else a
                for a in (c[0] for c in pool)]

    want = layer0(1)
    for a, b in zip(layer0(2), want):
        assert torch.equal(a, b)

    real = td._paged_write

    def per_position(kv, k, v, bt, positions, counts):
        if not isinstance(kv[0], Placed):
            return real(kv, k, v, bt, positions, counts)
        n = len(kv[0].parts)
        for i in range(n):
            local = tuple(c.parts[i] for c in kv)
            real(local, tp_mod.head_block(k, 1, i, n), tp_mod.head_block(v, 1, i, n), bt, positions, counts)
        return kv

    monkeypatch.setattr(td, "_paged_write", per_position)
    got = layer0(2)
    assert not all(torch.equal(a, b) for a, b in zip(got, want)), "per-head int8 scales went unnoticed"


# ------------------------------------------------------- validation


def test_mesh_problems_and_ctor_raise(model):
    """``decode_mesh_problems`` names every defect with the JAX package's
    words (the JAX side counts its 8 virtual devices, the port the 8
    positions it is offered); direct construction raises."""
    np_p, params, _, _ = model
    small = jd.init_decoder(seed=1, vocab=VOCAB, hidden=64, layers=1, ffn=128, max_len=32)
    odd_ffn = jd.init_decoder(seed=1, vocab=VOCAB, hidden=256, layers=1, ffn=258, max_len=32)
    eight = [CPU] * 8
    cases = [({}, None, None), ({"tp": 2}, np_p, None), ({"tp": 2, "pp": 2}, None, None), ({"tp": 0}, None, None),
             ({"tp": 16}, None, None), ({"tp": 2}, small, None), ({"tp": 4}, odd_ffn, None),
             ({"tp": 2}, np_p, small)]
    for axes, p, d in cases:
        assert decode_mesh_problems(axes, p, d, eight) == jax_problems(axes, p, d), axes
    assert any("ONE" in p for p in decode_mesh_problems({"tp": 2, "pp": 2}, devices=eight))
    assert any("devices" in p for p in decode_mesh_problems({"tp": 16}, devices=eight))
    # a host of one device: "needs 2 devices, have 1"
    assert decode_mesh_problems({"tp": 2}, devices=[CPU]) == ["decode_mesh_axes={'tp': 2} needs 2 devices, have 1"]
    with pytest.raises(ValueError, match="n_heads"):
        DecodeScheduler(params_to_torch(small, CPU), seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=2,
                        mesh_axes={"tp": 2}, devices=[CPU] * 2)
    # width 1 is not an error — it degrades to one device
    assert decode_tp_mesh({"tp": 1}, params) == (None, None, 1)


def test_validation_rejects_mesh_knobs():
    """CR-level validation: decode_mesh_axes without decode_slots, with more
    than one axis, or a non-positive size, with the JAX package's messages;
    a width beyond the host's devices still validates."""
    from seldon_core_tpu.graph.spec import SeldonDeployment as JaxDeployment
    from seldon_core_tpu.graph.validation import ValidationError as JaxError
    from seldon_core_tpu.graph.validation import validate_deployment as jax_validate
    from seldon_core_tpu_torch.graph.spec import SeldonDeployment
    from seldon_core_tpu_torch.graph.validation import ValidationError, validate_deployment

    def dep(tpu):
        return {"spec": {"name": "d", "predictors": [{"name": "p", "graph": {
            "name": "m", "type": "MODEL", "implementation": "JAX_MODEL",
            "parameters": [{"name": "model", "value": "tiny_gpt", "type": "STRING"}]}, "tpu": tpu}]}}

    def problems(validate, error, cls, obj):
        try:
            validate(cls.from_dict(obj))
        except error as e:
            return e.problems
        return []

    for tpu, match in (({"decode_mesh_axes": {"tp": 2}}, "decode_slots"),
                       ({"decode_slots": 2, "decode_mesh_axes": {"tp": 2, "pp": 2}}, "exactly one"),
                       ({"decode_slots": 2, "decode_mesh_axes": {"tp": 0}}, ">= 1"),
                       ({"decode_slots": 2, "decode_mesh_axes": {"tp": 16}}, None),
                       ({"decode_slots": 2, "decode_mesh_axes": {"tp": 2}}, None)):
        got = problems(validate_deployment, ValidationError, SeldonDeployment, dep(tpu))
        assert got == problems(jax_validate, JaxError, JaxDeployment, dep(tpu))
        assert (match is None and not got) or any(match in p for p in got)


# ------------------------------------------------------- serving wiring


def _predictor(n_slots: int, hidden: int | None = 256, **tpu_extra):
    from seldon_core_tpu_torch.graph.spec import PredictorSpec

    geometry = [] if hidden is None else [{"name": "hidden", "value": str(hidden), "type": "INT"},
                                          {"name": "ffn", "value": "512", "type": "INT"}]
    return PredictorSpec.from_dict({
        "name": "p",
        "graph": {"name": "gpt", "type": "MODEL", "implementation": "JAX_MODEL", "parameters": [
            {"name": "model", "value": "tiny_gpt", "type": "STRING"},
            {"name": "seq", "value": str(SEQ), "type": "INT"},
            {"name": "max_new_tokens", "value": "6", "type": "INT"},
            {"name": "vocab", "value": str(VOCAB), "type": "INT"},
            *geometry]},
        "tpu": {"max_batch": 4, "batch_buckets": [4], "decode_slots": n_slots, **tpu_extra},
    })


async def test_serving_mesh_wiring_and_warn_disable(caplog):
    """decode_mesh_axes -> the server's decode scheduler over the server's
    ``mesh_devices``: the buffered response equals the JAX zoo's fused
    apply. Without positions enough (one device), or with heads the width
    does not divide, it serves one device with the JAX warning."""
    from seldon_core_tpu.models.zoo import get_model as jax_get_model
    from seldon_core_tpu_torch.core.message import SeldonMessage
    from seldon_core_tpu_torch.serving.server import PredictorServer

    server = PredictorServer(_predictor(2, decode_mesh_axes={"tp": 2}), deployment_name="d", device="cpu",
                             mesh_devices=[CPU] * 2)
    sched = server.decode_scheduler
    assert sched is not None and sched.tp == 2 and sched.mesh.positions == (CPU, CPU)
    server.warmup()
    try:
        ids = _prompts(2, seed=7)
        out = await server.service.predict(SeldonMessage.from_array(ids))
        ms = jax_get_model("tiny_gpt", seq=SEQ, max_new_tokens=6, vocab=VOCAB, hidden=256, ffn=512)
        oracle = np.asarray(jax.jit(ms.apply_fn)(ms.params, jnp.asarray(ids)))
        np.testing.assert_array_equal(np.asarray(out.array).astype(np.int32), oracle)
        assert sched.recompiles_since_warmup() == 0
    finally:
        await sched.close()

    for pred, why in ((_predictor(2, decode_mesh_axes={"tp": 2}), "needs 2 devices, have 1"),
                      (_predictor(2, hidden=None, decode_mesh_axes={"tp": 4}), "n_heads=2 not divisible")):
        caplog.clear()
        with caplog.at_level(logging.WARNING, "seldon_core_tpu_torch.serving.decode_scheduler"):
            kw = {} if "needs" in why else {"mesh_devices": [CPU] * 4}
            server2 = PredictorServer(pred, deployment_name="d2", device="cpu", **kw)
        sched2 = server2.decode_scheduler
        assert sched2 is not None and sched2.mesh is None and sched2.tp == 1
        assert any("unservable" in r.message and why in r.message for r in caplog.records)
        await sched2.close()


async def test_tp_gauge_and_span_attrs(model):
    """Spans carry mesh_axes/tp attributes and the per-device page gauge
    is fed with the tp label; a single-device scheduler labels tp=1 and
    adds no span attribute."""
    from seldon_core_tpu_torch.metrics import NullMetrics

    _, params, _, _ = model
    calls: list[tuple[int, int]] = []

    class _Rec(NullMetrics):
        def decode_kv_per_device(self, deployment, pages, tp):
            calls.append((pages, tp))

    sched = _scheduler(params, 2, n_slots=2, kv_page_size=4, metrics=_Rec(), deployment_name="d")
    assert sched._mesh_attrs == {"tp": 2, "mesh_axes": "tp=2"}
    ids = _prompts(2, seed=5)
    await _serve(sched, ids)
    assert calls and all(tp == 2 for _, tp in calls)
    assert max(pages for pages, _ in calls) > 0  # live pages were gauged
    await sched.close()
    calls.clear()
    sched1 = _scheduler(params, n_slots=2, metrics=_Rec(), deployment_name="d")
    assert sched1._mesh_attrs == {}
    await sched1.submit(ids[0])
    assert calls and all(tp == 1 for _, tp in calls)
    await sched1.close()


# ------------------------------------------------------- int8 BERT, "model"


def test_int8_bert_over_a_model_axis_matches_jax():
    """BERT (bert_tiny, attn_kernel=pallas) with weight_quant=int8 over
    {"model": 2}: each position's W8A16 calls take its shard of the int8
    payloads (``quant.quantized_pspecs``), and the answers equal the JAX
    runtime's over the same mesh at the JAX int8 tests' tolerance; the
    resident int8 bytes equal the unsharded runtime's on one device."""
    from seldon_core_tpu.graph.spec import TpuSpec as JaxTpuSpec
    from seldon_core_tpu.models.zoo import _runtime_from_modelspec as jax_runtime
    from seldon_core_tpu.models.zoo import get_model as jax_get_model
    from seldon_core_tpu_torch.graph.spec import TpuSpec
    from seldon_core_tpu_torch.models.zoo import _runtime_from_modelspec, get_model
    from seldon_core_tpu_torch.parallel import Mesh

    ids = np.random.default_rng(0).integers(0, 1024, (2, 16)).astype(np.float32)
    jrt = jax_runtime(jax_get_model("bert_tiny", attn_kernel="pallas"),
                      JaxTpuSpec(batch_buckets=[2], max_batch=2, weight_quant="int8", mesh={"model": 2}))
    want = jrt.predict(ids)
    cfg = TpuSpec(batch_buckets=[2], max_batch=2, weight_quant="int8")
    rt = _runtime_from_modelspec(get_model("bert_tiny", attn_kernel="pallas"), cfg, CPU,
                                 mesh=Mesh({"model": 2}, [CPU] * 2))
    assert rt.apply_fn.name == "bert_tp_pallas"
    np.testing.assert_allclose(rt.predict(ids), want, rtol=1e-3, atol=1e-4)
    one = _runtime_from_modelspec(get_model("bert_tiny", attn_kernel="pallas"), cfg, CPU)
    assert rt.param_bytes() == one.param_bytes()
    lp0, lp1 = (rt.params[p]["layers"][0] for p in (0, 1))
    # row-parallel: rows split, the scale (per output column) shared
    assert tuple(lp0["attn_out"]["w"]["__int8_weight__"].shape) == (64, 128)
    assert lp0["attn_out"]["w"]["scale"] is lp1["attn_out"]["w"]["scale"]
    # column-parallel: the scales go with the columns, contiguous copies
    for name, cols in (("qkv", 192), ("mlp_in", 128)):
        q = lp1[name]["w"]["__int8_weight__"]
        assert tuple(q.shape) == (128, cols) and q.is_contiguous()
        assert tuple(lp1[name]["w"]["scale"].shape) == (1, cols)
