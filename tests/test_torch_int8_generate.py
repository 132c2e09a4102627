"""Int8 weights on a generative model in the port against the JAX package.

The JAX package serves ``tiny_gpt`` with ``tpu.weight_quant="int8"``
through ``ModelRuntime``, whose apply runs the fused ``generate`` on
``dequantize(params)``; its decode scheduler does not take int8 weights and
keeps the fused path with a warning. The port quantizes with the same
numpy rule (``tok_emb`` of 512 rows and ``pos_emb`` included), runs every
projection through the W8A16 wrapper (its plain version on the CPU), the
embedding gathers through ``quant.embed``, and the weight-tied head on the
dequantized table.

Tolerances: float32 ids equal and prefill logits within rtol 1e-4 / atol
1e-5 (``tests/test_torch_decoder.py``'s reduction-order bound); bf16 ids
equal, or parting first where JAX's logits on the shared prefix put the
port's token within ``BF16_TIE_MARGIN`` of their top
(``chip_smoke.GEN_TIE_MARGIN``'s bf16 value).
"""

import json
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.graph.spec import SeldonDeployment as JaxSeldonDeployment
from seldon_core_tpu.models import decoder as jd
from seldon_core_tpu.models.quant import dequantize as jax_dequantize
from seldon_core_tpu.models.zoo import _runtime_from_modelspec as jax_runtime_from_modelspec
from seldon_core_tpu.models.zoo import get_model as jax_get_model
from seldon_core_tpu.serving.server import PredictorServer as JaxPredictorServer
from seldon_core_tpu_torch.graph.spec import SeldonDeployment
from seldon_core_tpu_torch.models import decoder as td
from seldon_core_tpu_torch.models.quant import dequantize, is_quantized_leaf, payload
from seldon_core_tpu_torch.models.zoo import _runtime_from_modelspec, get_model
from seldon_core_tpu_torch.serving.server import PredictorServer

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TIE_MARGIN = 0.1
SMALL = dict(seq=8, max_new_tokens=6)
JAX_WARNING = "decode scheduler does not support weight_quant yet — falling back to the fused whole-batch path"


def _tpu(dtype: str, weight_quant: str = "int8"):
    return SimpleNamespace(dtype=dtype, weight_quant=weight_quant, batch_buckets=[2], max_batch=2)


def _ids(n: int, seq: int, vocab: int = 512, seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (n, seq)).astype(np.int32)


def _pair(dtype: str, **kw):
    """The port's and the JAX package's int8 runtimes of one tiny_gpt build."""
    port = _runtime_from_modelspec(get_model("tiny_gpt", **{**SMALL, **kw}), _tpu(dtype), CPU)
    theirs = jax_runtime_from_modelspec(jax_get_model("tiny_gpt", **{**SMALL, **kw}), _tpu(dtype))
    return port, theirs


@pytest.mark.parametrize("kw", [{}, dict(seed=4, hidden=64, layers=3, ffn=128)])
def test_int8_generate_float32_matches_jax(kw):
    """Ids equal, and the prefill logits (every projection on int8, the
    tied head on the dequantized table) within the float32 bound."""
    port, theirs = _pair("float32", **kw)
    assert port.weight_quant == "int8"
    assert all(is_quantized_leaf(port.params[k]) for k in ("tok_emb", "pos_emb"))
    assert is_quantized_leaf(port.params["layers"][0]["qkv"]["w"])
    ids = _ids(2, SMALL["seq"])
    np.testing.assert_array_equal(port.predict(ids), np.asarray(theirs.predict(ids)))
    with torch.inference_mode():
        got = td.prefill(port.params, torch.from_numpy(ids))[0]
    want = jax.jit(jd.prefill)(jax_dequantize(theirs.params, jnp.float32), jnp.asarray(ids))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_int8_payloads_are_the_jax_packages():
    port, theirs = _pair("float32")
    for name in ("tok_emb", "pos_emb"):
        want = theirs.params[name]
        np.testing.assert_array_equal(payload(port.params[name]).numpy(), np.asarray(want["__int8_weight__"]))
        np.testing.assert_array_equal(port.params[name]["scale"].numpy(), np.asarray(want["scale"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_tied_head_over_a_quantized_table_is_jaxs(dtype):
    """The head over a quantized ``tok_emb``: the table dequantized in
    float32, then cast, then the product, as JAX's ``_logits`` on
    ``dequantize(params)``; and the embedding rows are JAX's gathers from
    the dequantized table, bit for bit."""
    port, theirs = _pair(dtype)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 1, 128)).astype(np.float32)).to(tdt)
    jp = jax_dequantize(theirs.params, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    want = np.asarray(jax.jit(jd._logits)(jp, jnp.asarray(x.float().numpy()).astype(jp["ln_f"]["scale"].dtype)),
                      np.float32)
    with torch.inference_mode():
        got = td._logits(port.params, x).float().numpy()
        rows = td._embed(port.params, torch.from_numpy(_ids(2, 4)).long())
    head = dequantize(port.params["tok_emb"], tdt)
    assert head.dtype == tdt and tuple(head.shape) == (512, 128)
    np.testing.assert_allclose(got, want, **(TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)))
    want_rows = np.asarray(jp["tok_emb"][jnp.asarray(_ids(2, 4))] + jp["pos_emb"][:4][None], np.float32)
    np.testing.assert_array_equal(rows.float().numpy(), want_rows)


def _partings(theirs, got: np.ndarray, want: np.ndarray, seq: int) -> list[tuple[int, int, float]]:
    """The tie rule, held by the reference: per row where the port's ids
    ``got`` part from JAX's ``want``, (row, first index that differs, the
    gap between the top logit and the logit of the port's token there), the
    logits being JAX's ``prefill`` on the prefix the two share, on the
    weights its int8 generate runs on (``dequantize`` to bf16)."""
    jp = jax_dequantize(theirs.params, jnp.bfloat16)
    out = []
    for r, (a, b) in enumerate(zip(got, want)):
        diff = np.nonzero(a[seq:] != b[seq:])[0]
        if not len(diff):
            continue
        t = seq + int(diff[0])
        logits = np.asarray(jax.jit(jd.prefill)(jp, jnp.asarray(b[None, :t]))[0][0], np.float32)
        out.append((r, t, float(logits.max() - logits[int(a[t])])))
    return out


def test_int8_generate_bf16_matches_jax_under_the_tie_rule():
    """bf16 ids equal JAX's, or part first where JAX's own logits put the
    port's token within ``BF16_TIE_MARGIN`` of the top; a planted wrong
    token (the reference's least likely) fails the same rule."""
    port, theirs = _pair("bfloat16")
    ids = _ids(2, SMALL["seq"], seed=7)
    got, want = port.predict(ids), np.asarray(theirs.predict(ids))
    seq = SMALL["seq"]
    assert got.shape == want.shape == (2, seq + SMALL["max_new_tokens"])
    for r, t, gap in _partings(theirs, got, want, seq):
        assert gap <= BF16_TIE_MARGIN, (r, t, gap)
    # the rule can fail: the reference's least likely token at the first
    # generated index of row 0
    jp = jax_dequantize(theirs.params, jnp.bfloat16)
    logits = np.asarray(jax.jit(jd.prefill)(jp, jnp.asarray(want[:1, :seq]))[0][0], np.float32)
    planted = want.copy()
    planted[0, seq] = int(np.argmin(logits))
    (r, t, gap), = _partings(theirs, planted, want, seq)
    assert (r, t) == (0, seq) and gap > BF16_TIE_MARGIN


def _gpt_dep(tpu: dict) -> dict:
    return {"spec": {"name": "g", "predictors": [{
        "name": "p", "graph": {"name": "gpt", "type": "MODEL", "implementation": "JAX_MODEL",
                               "parameters": [{"name": "model", "value": "tiny_gpt", "type": "STRING"},
                                              {"name": "seq", "value": "8", "type": "INT"},
                                              {"name": "max_new_tokens", "value": "6", "type": "INT"}]},
        "tpu": {"dtype": "float32", "batch_buckets": [2], "max_batch": 2, **tpu}}]}}


async def test_decode_slots_with_int8_serve_the_fused_path_with_jaxs_warning(caplog):
    """``decode_slots`` beside ``weight_quant``: both packages log the same
    warning, build no scheduler, and answer through the fused ``generate``
    with the same ids."""
    dep = _gpt_dep({"weight_quant": "int8", "decode_slots": 2})
    ids = _ids(2, 8, seed=3)
    with caplog.at_level(logging.WARNING):
        ours = PredictorServer(SeldonDeployment.from_dict(json.loads(json.dumps(dep))).spec.predictors[0],
                               device="cpu")
        theirs = JaxPredictorServer(JaxSeldonDeployment.from_dict(json.loads(json.dumps(dep))).spec.predictors[0])
    warned = [r for r in caplog.records if r.getMessage() == JAX_WARNING]
    assert {r.name for r in warned} == {"seldon_core_tpu_torch.serving.decode_scheduler",
                                        "seldon_core_tpu.serving.decode_scheduler"}
    assert ours.decode_scheduler is None and theirs.decode_scheduler is None
    ours.warmup()
    runtime = ours.executor.root.unit.runtime
    assert runtime.weight_quant == "int8" and runtime.recompiles_since_warmup() == 0
    from seldon_core_tpu.core.codec_json import message_from_dict as jax_message
    from seldon_core_tpu_torch.core.codec_json import message_from_dict

    got = await ours.executor.execute(message_from_dict({"data": {"ndarray": ids.tolist()}}))
    want = await theirs.executor.execute(jax_message({"data": {"ndarray": ids.tolist()}}))
    np.testing.assert_array_equal(np.asarray(got.array), np.asarray(want.array))
    assert runtime.recompiles_since_warmup() == 0


@pytest.mark.parametrize("dtype, prefill_body", [("bfloat16", "wgmma"), ("float32", "tf32x2")])
def test_int8_generate_asks_for_fewrows_at_every_decode_projection(monkeypatch, dtype, prefill_body):
    """A small-width int8 ``generate`` (2 rows, a 32-token prompt, 4 new
    tokens): the prefill's 64 rows ask for the tiled body at each of the 4
    projections a layer, and each of the 3 decode steps' 2 rows for the
    few-rows body. The CPU computes the plain version, so the rule is read
    where the card would launch."""
    from seldon_core_tpu_torch.ops import int8_matmul as i8

    port = _runtime_from_modelspec(get_model("tiny_gpt", seq=32, max_new_tokens=4), _tpu(dtype), CPU)
    layers = len(port.params["layers"])
    bodies = []
    batched = i8._batched
    monkeypatch.setattr(i8, "_batched", lambda x, q, s, b: bodies.append(i8.body_for(x, q)) or batched(x, q, s, b))
    out = port.predict(_ids(2, 32))
    assert out.shape == (2, 36)
    assert bodies == [prefill_body] * 4 * layers + ["fewrows"] * 4 * layers * 3
