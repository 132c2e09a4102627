"""The flash kernel's one-tile body, on the CPU (nothing here needs a card).

- ``select_body`` over a grid of shapes, dtypes and causal flags, against
  the C side's ``onetile_takes`` read from ``csrc/flash_attention.cu`` and
  evaluated in Python: the C rule takes exactly the calls the Python rule
  sends it, ``wgmma`` keeps every call of more than one 128-key tile, and
  float32 keeps its own body;
- the plain version at the short-key shapes the body takes, held against
  the JAX Pallas kernel in interpret mode on the same numpy inputs, in bf16
  and float32, with ``tests/test_torch_flash.py``'s tolerances (float32
  2e-5; bf16 4 ulps of max|ref| and a relative L2 error of 1e-2);
- a ``bert_tiny?seq=128`` DAG (transformer -> epsilon-greedy -> two
  ``attn_kernel=pallas`` arms) served on the CPU asks ``select_body`` for
  ``onetile`` at every layer of a batch past the cut, and for ``wgmma`` at
  bucket 1;
- ``flash_onetile_probe.py``'s variants still apply to the committed source.
"""

import asyncio
import difflib
import itertools
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import flash_onetile_probe as probe
from seldon_core_tpu_torch.ops import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
CODES = {F32: 0, BF16: 1, F16: 2}
F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _source() -> str:
    return (CSRC / "flash_attention.cu").read_text()


def _constants(src: str) -> dict:
    return {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}


def _c_rule(name: str):
    """``name``'s return expression in csrc/flash_attention.cu as a Python
    function of the C arguments."""
    src = _source()
    body = re.search(rf"bool {name}\(([^)]*)\) {{\s*return (.*?);\s*}}", src, re.S)
    assert body, f"{name} not found in flash_attention.cu"
    args = [a.split()[-1] for a in body.group(1).split(",")]
    expr = body.group(2).replace("&&", " and ").replace("||", " or ")
    return eval(f"lambda {', '.join(args)}: ({' '.join(expr.split())})", _constants(src))  # noqa: S307 - the repo's own source


def test_the_c_rule_takes_exactly_the_calls_the_python_rule_sends():
    src = _source()
    constants = _constants(src)
    assert (constants["OT_MAX_KEYS"], constants["OT_MIN_ITEMS"]) == (fa.ONETILE_MAX_KEYS, fa.ONETILE_MIN_ITEMS)
    assert re.search(r"static constexpr int D = 64, BQ = (\d+);", src).group(1) == str(fa.Q_BLOCK)
    # the launcher counts items as the Python rule does
    assert f"static_cast<long long>(b) * h * ((sq + {fa.Q_BLOCK - 1}) / {fa.Q_BLOCK})" in src
    rule = _c_rule("onetile_takes")
    checked = 0
    for dtype, d, b, h, sq, sk, causal in itertools.product(
            CODES, (64, 128), (1, 2, 5, 6, 8, 11, 64), (1, 3, 12), (1, 77, 128, 129, 300), (1, 16, 48, 112, 127, 128, 129,
                                                                                       256, 512), (False, True)):
        body = fa.select_body(b, h, sq, sk, d, dtype, causal)
        items = b * h * -(-sq // fa.Q_BLOCK)
        assert rule(items, sk, d, CODES[dtype], int(causal)) == (body == "onetile"), (dtype, d, b, h, sq, sk, causal)
        assert (body == "f32") == (dtype == F32)
        if sk > fa.ONETILE_MAX_KEYS and dtype != F32:
            assert body == "wgmma"
        checked += 1
    assert checked > 10000


@pytest.mark.parametrize("b, sq, sk, causal, want", [
    (64, 128, 128, False, "onetile"),  # the DAG's bucket 64: 768 items
    (8, 128, 128, False, "onetile"),  # bucket 8: 96 items
    (1, 128, 128, False, "wgmma"),  # bucket 1: 12 items, below the cut
    (64, 128, 128, True, "wgmma"),  # causal
    (64, 128, 256, False, "wgmma"),  # two tiles of keys
    (64, 77, 48, False, "onetile"),  # ragged q and keys inside one tile
    (5, 128, 128, False, "wgmma"),  # 60 items
    (1, 512, 128, False, "wgmma"),  # 4 q blocks: 48 items
    (2, 512, 128, False, "onetile"),  # 96 items
])
def test_select_body_at_the_served_shapes(b, sq, sk, causal, want):
    assert fa.select_body(b, 12, sq, sk, 64, BF16, causal) == want
    q, k = torch.zeros(b, 12, sq, 64, dtype=BF16), torch.zeros(b, 12, sk, 64, dtype=BF16)
    assert fa.body_for(q, k, causal) == want


def test_select_body_keeps_head_dim_128_and_float32_off_the_one_tile_body():
    assert fa.select_body(64, 12, 128, 128, 128, BF16, False) == "wgmma"
    assert fa.select_body(64, 12, 128, 128, 64, F16, False) == "onetile"
    assert fa.select_body(64, 12, 128, 128, 64, F32, False) == "f32"


@pytest.fixture
def jax_flash():
    import jax.numpy as jnp

    from seldon_core_tpu.ops import flash_attention

    return jnp, flash_attention


def _np_qkv(sq, sk, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, 3, s, 64)).astype(np.float32) for s in (sq, sk, sk))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq, sk", [(128, 128), (128, 16), (128, 48), (128, 112), (77, 128), (77, 48)])
def test_plain_version_at_short_keys_matches_jax(jax_flash, dtype, sq, sk):
    """The JAX kernel in interpret mode at its default blocks (one q block,
    one KV block of sk keys) against the port on the same inputs."""
    jnp, flash = jax_flash
    qkv = _np_qkv(sq, sk, seed=sq + sk)
    tdt, jdt = (F32, jnp.float32) if dtype == "float32" else (BF16, jnp.bfloat16)
    got = fa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in qkv))
    ref = flash(*(jnp.asarray(a, jdt) for a in qkv))
    assert got.shape == (2, 3, sq, 64)
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, **F32_TOL)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        assert np.abs(got - ref).max() <= 4 * ulp
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-2


def test_a_bert_tiny_dag_past_the_cut_asks_for_the_one_tile_body(monkeypatch):
    from seldon_core_tpu_torch.core.codec_json import message_from_json
    from seldon_core_tpu_torch.graph.spec import PredictorSpec
    from seldon_core_tpu_torch.models import bert
    from seldon_core_tpu_torch.serving.server import PredictorServer

    asked = []
    real = bert.flash_attention

    def recording(q, k, v, **kw):
        asked.append((tuple(q.shape), fa.body_for(q, k, kw.get("causal", False))))
        return real(q, k, v, **kw)

    monkeypatch.setattr(bert, "flash_attention", recording)
    arms = [{"name": f"bert-{c}", "type": "MODEL", "implementation": "JAX_MODEL",
             "parameters": [{"name": "model_uri", "value": f"zoo://bert_tiny?seed={i}&seq=128", "type": "STRING"},
                            {"name": "attn_kernel", "value": "pallas", "type": "STRING"}]}
            for i, c in enumerate("ab")]
    graph = {"name": "scale", "type": "TRANSFORMER", "implementation": "MEAN_TRANSFORMER",
             "parameters": [{"name": "means", "value": "0.0", "type": "STRING"}],
             "children": [{"name": "eg", "type": "ROUTER", "implementation": "EPSILON_GREEDY",
                           "parameters": [{"name": "epsilon", "value": "0.5", "type": "FLOAT"},
                                          {"name": "seed", "value": "1", "type": "INT"}],
                           "children": arms}]}
    batch = -(-fa.ONETILE_MIN_ITEMS // 2)  # bert_tiny: 2 heads of 64
    spec = PredictorSpec.from_dict({"name": "p", "graph": graph,
                                    "tpu": {"max_batch": batch, "batch_buckets": [1, batch],
                                            "dtype": "bfloat16"}})
    server = PredictorServer(spec, device="cpu", enable_batching=False)
    router_node = server.executor.root.children[0]
    layers = len(router_node.children[0].unit.runtime.params["layers"])
    rng = np.random.default_rng(0)
    for n, want in ((batch, "onetile"), (1, "wgmma")):
        asked.clear()
        ids = rng.integers(0, 1024, size=(n, 128))
        out = asyncio.run(server.service.predict(message_from_json(json.dumps({"data": {"ndarray": ids.tolist()}}))))
        probs = np.asarray(out.array)
        assert probs.shape == (n, 2) and np.isfinite(probs).all()
        assert asked == [((n if want == "wgmma" else batch, 2, 128, 64), want)] * layers, asked


@pytest.mark.parametrize("name, constant, value", [
    ("cut1", "OT_MIN_ITEMS", 1),
    ("stages2", "OT_STAGES", 2),
    ("stages4", "OT_STAGES", 4),
])
def test_each_probe_variant_changes_one_constant_of_the_committed_kernel(name, constant, value):
    src = probe.SRC.read_text()
    variants = probe.variants(src)
    assert variants["committed"] == src and len(set(variants.values())) == len(variants) == 6
    changed = [line for line in difflib.ndiff(src.splitlines(), variants[name].splitlines()) if line[:2] in ("- ", "+ ")]
    assert len(changed) == 2 and changed[0].startswith(f"- constexpr int {constant} = ")
    assert changed[1] == f"+ constexpr int {constant} = {value};"


def test_the_divide_variant_swaps_div_rn_for_the_compilers_division():
    src = probe.SRC.read_text()
    divide = probe.variants(src)["divide"]
    changed = [line for line in difflib.ndiff(src.splitlines(), divide.splitlines()) if line[:2] in ("- ", "+ ")]
    assert sorted(changed) == ["+   return x / d;", "-   const float q = x * r;", "-   return fmaf(fmaf(-d, q, x), r, q);"]


def test_the_traced_variant_marks_every_phase_and_changes_nothing_else():
    src = probe.SRC.read_text()
    traced = probe.variants(src)["traced"]
    assert [traced.count(f"OT_MARK({k});") for k in range(7)] == [1] * 7
    assert traced.count("ot_load[n] = clock64();") == 1 and traced.endswith(probe.TRACE_READ)
    untraced = re.sub(r"\n *(OT_MARK\(\d\);|if \(blockIdx.x == 0 && n < 8\) ot_load\[n\] = clock64\(\);)", "",
                      traced[:-len(probe.TRACE_READ)]).replace(probe.TRACE_DEF, "")
    assert untraced == src


@pytest.mark.parametrize("constant", ["OT_MIN_ITEMS", "OT_STAGES"])
def test_a_probe_variant_that_no_longer_applies_is_refused(constant):
    src = re.sub(rf"constexpr int {constant} = \d+;", "", probe.SRC.read_text())
    with pytest.raises(ValueError, match="one occurrence"):
        probe.variants(src)
