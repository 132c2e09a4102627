"""The W8A16 kernel's body rule (``ops/int8_matmul.py::select_body``), on the CPU.

The rule names the body a launch takes before the launch, from the shape,
dtype, strides and base addresses alone, and the C entry point refuses a
body that cannot take the call (the wrapper then raises; nothing retries
on another body). Here:

- outputs of at most ``NARROW_MAX_N`` columns (the BERT head, N = 2; iris,
  K = 4, N = 3), or up to 32 columns for at most 128 rows, take ``splitk``
  in bf16, f16 and float32, whatever their strides;
- wider outputs of at most ``FEW_ROWS_WIDE`` rows (GPT-2-small's four
  projections on a decode step's rows, BERT's pooler on 32 [CLS] rows)
  take ``fewrows`` in every dtype, whatever their strides, and one row more
  takes the tiled bodies;
- BERT-base's four projections at buckets 32 and 1 take ``wgmma`` in bf16
  and f16 and ``tf32x2`` in float32;
- wider bf16/f16 calls past those rows that TMA cannot address (an x view
  whose row stride is not a multiple of 8, rows closer than K, a base off
  16 bytes, N not a multiple of 16) take ``mma``; float32 calls TMA cannot
  address take ``fma``;
- stacked members are decided by their member strides: a shared x or q
  (stride 0) and aligned strides take ``wgmma``, misaligned ones ``mma``;
- the C side's rules (``wgmma_takes``, ``tf32x2_takes``, ``fewrows_takes``
  in ``csrc/int8_matmul.cu``), read from the source, accept exactly the
  calls the Python rule sends to those bodies;
- ``body_for`` derives the rule's arguments from tensors as the wrapper
  hands them to the kernel, and a ``bert_tiny`` int8 forward asks for
  ``wgmma`` (bf16) or ``tf32x2`` (float32) at every projection and
  ``splitk`` at the head.
"""

import itertools
import re

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.models import quant
from seldon_core_tpu_torch.models.base import ModelRuntime
from seldon_core_tpu_torch.models.zoo import get_model
from seldon_core_tpu_torch.ops import int8_matmul as i8
from seldon_core_tpu_torch.ops.kernel_build import CSRC

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
# BERT-base's projections (K, N); M = bucket x seq 128
BERT_BASE = {"qkv": (768, 2304), "attn_out": (768, 768), "mlp_in": (768, 3072), "mlp_out": (3072, 768)}
ALIGNED = 1 << 20  # a 16-byte-aligned address


def _rule(m, n, k, dtype=BF16, x_strides=None, q_member_stride=0, x_ptr=ALIGNED, q_ptr=ALIGNED):
    return i8.select_body(m, n, k, dtype, x_strides or (0, k), q_member_stride, x_ptr, q_ptr)


@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("bucket", [32, 1])
@pytest.mark.parametrize("proj", sorted(BERT_BASE))
def test_bert_base_projections_take_the_wgmma_body(proj, bucket, dtype):
    k, n = BERT_BASE[proj]
    assert _rule(bucket * 128, n, k, dtype) == "wgmma"


@pytest.mark.parametrize("case, args", [
    ("cls_rows_n40", dict(m=64, n=40, k=768, x_strides=(0, 128 * 768))),
    ("k4_n40", dict(m=64, n=40, k=4)),
    ("n_multiple_of_8_only", dict(m=64, n=40, k=64)),
    ("k_not_multiple_of_8", dict(m=64, n=64, k=60)),
    ("x_row_stride_not_multiple_of_8", dict(m=64, n=64, k=64, x_strides=(0, 68))),
    ("x_rows_closer_than_k", dict(m=64, n=64, k=64, x_strides=(0, 32))),
    ("x_base_off_16_bytes", dict(m=64, n=64, k=64, x_ptr=ALIGNED + 2)),
    ("q_base_off_16_bytes", dict(m=64, n=64, k=64, q_ptr=ALIGNED + 8)),
])
def test_shapes_tma_cannot_address_take_the_mma_body(case, args):
    assert _rule(**args) == "mma"


@pytest.mark.parametrize("shape", [(4096, 2304, 770), (64, 40, 4), (64, 40, 768)])
def test_float32_takes_the_fma_body(shape):
    """K not a multiple of 4, N not a multiple of 16: no TMA map of the
    operands, so the CUDA-core body."""
    m, n, k = shape
    assert _rule(m, n, k, dtype=F32) == "fma"


@pytest.mark.parametrize("dtype", [BF16, F16, F32])
@pytest.mark.parametrize("case, args", [
    ("bert_head_n2", dict(m=32, n=2, k=768, x_strides=(0, 128 * 768))),
    ("bert_head_bucket1", dict(m=1, n=2, k=768)),
    ("iris_k4_n3", dict(m=5, n=3, k=4)),
    ("n1", dict(m=4096, n=1, k=768)),
    ("n8_at_the_cut", dict(m=4096, n=8, k=3072)),
    ("ragged_k_misaligned_x", dict(m=32, n=2, k=770, x_strides=(0, 771), x_ptr=ALIGNED + 2)),
    ("shared_x_members", dict(m=40, n=3, k=776, x_strides=(0, 776), q_member_stride=776 * 3)),
])
def test_narrow_outputs_take_the_splitk_body(case, args, dtype):
    assert _rule(dtype=dtype, **args) == "splitk"


@pytest.mark.parametrize("dtype, want", [(BF16, "wgmma"), (F16, "wgmma"), (F32, "tf32x2")])
def test_the_cut_depends_on_the_width_and_for_a_few_rows_on_the_rows(dtype, want):
    assert (i8.NARROW_MAX_N, i8.NARROW_FEW_ROWS_MAX_N, i8.FEW_ROWS) == (8, 32, 128)
    odd = "fma" if dtype == F32 else "mma"
    assert _rule(4096, 8, 768, dtype) == "splitk"
    assert _rule(4096, 16, 768, dtype) == want and _rule(4096, 9, 768, dtype) == odd
    assert _rule(32, 16, 768, dtype) == _rule(128, 32, 768, dtype) == _rule(1, 24, 4, dtype) == "splitk"
    assert _rule(129, 16, 768, dtype) == want and _rule(128, 48, 768, dtype) == want


@pytest.mark.parametrize("bucket", [32, 1])
@pytest.mark.parametrize("proj", sorted(BERT_BASE))
def test_bert_base_float32_projections_take_the_tf32x2_body(proj, bucket):
    k, n = BERT_BASE[proj]
    assert _rule(bucket * 128, n, k, F32) == "tf32x2"


@pytest.mark.parametrize("case, args", [
    ("m_ragged", dict(m=4000, n=2304, k=768)),
    ("k_ragged_mid_stage", dict(m=256, n=768, k=776)),
    ("k_multiple_of_4_only", dict(m=256, n=768, k=772)),
    ("n_ragged", dict(m=256, n=400, k=768)),
    ("shared_x_members", dict(m=256, n=768, k=768, x_strides=(0, 768), q_member_stride=768 * 768)),
    ("per_member_x", dict(m=256, n=768, k=776, x_strides=(256 * 776, 776), q_member_stride=776 * 768)),
    ("base_16_bytes_in", dict(m=64, n=64, k=64, x_ptr=ALIGNED + 16)),
])
def test_wide_float32_that_tma_can_address_takes_tf32x2(case, args):
    assert _rule(dtype=F32, **args) == "tf32x2"


@pytest.mark.parametrize("case, args", [
    ("x_row_stride_off_4", dict(m=64, n=64, k=64, x_strides=(0, 66))),
    ("x_rows_closer_than_k", dict(m=64, n=64, k=64, x_strides=(0, 32))),
    ("x_member_stride_off_4", dict(m=64, n=64, k=64, x_strides=(64 * 66 + 2, 64))),
    ("x_base_off_16_bytes", dict(m=64, n=64, k=64, x_ptr=ALIGNED + 4)),
    ("q_base_off_16_bytes", dict(m=64, n=64, k=64, q_ptr=ALIGNED + 8)),
    ("q_member_stride_off_16", dict(m=64, n=64, k=64, q_member_stride=64 * 64 + 8)),
])
def test_misaligned_float32_takes_the_fma_body(case, args):
    assert _rule(dtype=F32, **args) == "fma"


def _c_rule(name: str):
    """``name``'s return expression in csrc/int8_matmul.cu as a Python
    function of the C arguments (pointers as integers)."""
    src = (CSRC / "int8_matmul.cu").read_text()
    body = re.search(rf"bool {name}\(([^)]*)\) {{\s*return (.*?);\s*}}", src, re.S)
    assert body, f"{name} not found in int8_matmul.cu"
    args = [a.split()[-1].lstrip("*") for a in body.group(1).split(",")]
    expr = re.sub(r"reinterpret_cast<uintptr_t>\((\w+)\)", r"\1", body.group(2))
    expr = expr.replace("&&", " and ").replace("||", " or ").replace(" / ", " // ")
    constants = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    return eval(f"lambda {', '.join(args)}: ({' '.join(expr.split())})", constants)  # noqa: S307 - the repo's own source


def test_the_c_rules_take_exactly_the_calls_the_python_rule_sends():
    c_rules = {"wgmma": _c_rule("wgmma_takes"), "tf32x2": _c_rule("tf32x2_takes")}
    codes = {F32: 0, BF16: 1, F16: 2}
    src = (CSRC / "int8_matmul.cu").read_text()
    assert int(re.search(r"constexpr int SK_NB = (\d+);", src).group(1)) == i8.NARROW_MAX_N
    checked = 0
    for dtype, k, n, row_extra, x_member, q_member, x_off, q_off in itertools.product(
            codes, (4, 6, 8, 64, 770, 776), (12, 16, 24, 400), (-32, 0, 2, 4, 8), (0, 2, 4, 8, 4096 * 800),
            (0, 8, 16, 800 * 400), (0, 4, 8, 16), (0, 8, 16)):
        x_row = k + row_extra
        if x_row <= 0:
            continue
        body = i8.select_body(4096, n, k, dtype, (x_member, x_row), q_member, ALIGNED + x_off, ALIGNED + q_off)
        for name, rule in c_rules.items():
            takes = rule(ALIGNED + x_off, ALIGNED + q_off, 4096, n, k, x_member, x_row, q_member, codes[dtype])
            assert takes == (body == name), (name, dtype, k, n, x_row, x_member, q_member, x_off, q_off, body)
        checked += 1
    assert checked > 10000


@pytest.mark.parametrize("x_member, q_member, want", [
    (0, 768 * 768, "wgmma"),  # one x shared by the members
    (256 * 768, 768 * 768, "wgmma"),  # per-member x and q
    (256 * 768, 0, "wgmma"),  # one q shared by the members
    (256 * 768 + 4, 768 * 768, "mma"),  # x's member stride off 8 elements
    (0, 768 * 768 + 8, "mma"),  # q's member stride off 16 bytes
])
def test_stacked_members_are_decided_by_member_strides(x_member, q_member, want):
    assert _rule(256, 768, 768, x_strides=(x_member, 768), q_member_stride=q_member) == want


def test_body_for_reads_the_tensors_as_the_wrapper_hands_them():
    q = torch.zeros(1, 768, 2304, dtype=torch.int8)
    x = torch.zeros(4, 128, 768, dtype=BF16).reshape(1, -1, 768)
    assert i8.body_for(x, q) == "wgmma"
    assert i8.body_for(x.float(), q) == "tf32x2"
    assert i8.body_for(x.float()[:, :, 2:], q[:, 2:]) == "fma"  # K = 766: no TMA map
    assert i8.body_for(x[:, :, 8:], q[:, 8:]) == "wgmma"  # 16 bytes in: still aligned
    assert i8.body_for(x[:, :, 4:], q[:, 4:]) == "mma"  # 8 bytes in: x's base is off
    assert i8.body_for(x[:, :1], q) == "fewrows"  # one row: a decode step's
    assert i8.body_for(x[:, :i8.FEW_ROWS_WIDE + 1], q) == "wgmma"
    cls = torch.zeros(32, 128, 768, dtype=BF16)[:, 0, :].reshape(1, -1, 768)  # BERT's [CLS] rows
    assert i8.body_for(cls, torch.zeros(1, 768, 2, dtype=torch.int8)) == "splitk"
    assert i8.body_for(cls, torch.zeros(1, 768, 40, dtype=torch.int8)) == "fewrows"
    cls64 = torch.zeros(64, 128, 768, dtype=BF16)[:, 0, :].reshape(1, -1, 768)
    assert i8.body_for(cls64, torch.zeros(1, 768, 40, dtype=torch.int8)) == "mma"
    stacked = torch.zeros(3, 768, 768, dtype=torch.int8)
    shared = torch.zeros(1, 256, 768, dtype=BF16).expand(3, 256, 768)
    assert i8.body_for(shared, stacked) == "wgmma"
    ragged = torch.zeros(3, 256, 776, dtype=BF16)[:, :, :772]  # K = 772: rows 8-aligned, K not
    assert i8.body_for(ragged, torch.zeros(3, 772, 768, dtype=torch.int8)) == "mma"


def _bodies_of_a_bert_tiny_int8_forward(monkeypatch, dtype) -> list:
    spec = get_model("bert_tiny", seq=16)
    rt = ModelRuntime(spec.apply_fn, quant.quantize_params(spec.params), device=torch.device("cpu"),
                      buckets=[4], dtype=dtype)
    bodies = []
    batched = i8._batched
    monkeypatch.setattr(i8, "_batched", lambda x, q, s, b: bodies.append(i8.body_for(x, q)) or batched(x, q, s, b))
    probs = rt.predict(np.random.default_rng(3).integers(0, 1024, (4, 16)).astype(np.float32))
    assert np.isfinite(probs).all()
    return bodies


def test_bert_tiny_int8_forward_asks_for_wgmma_at_every_projection(monkeypatch):
    """2 layers x 4 projections take wgmma, the 2-class head splitk: the
    CPU computes the plain version, so the rule is read where the card
    would launch."""
    assert _bodies_of_a_bert_tiny_int8_forward(monkeypatch, BF16) == ["wgmma"] * 8 + ["splitk"]


def test_bert_tiny_float32_int8_forward_asks_for_tf32x2_at_every_projection(monkeypatch):
    assert _bodies_of_a_bert_tiny_int8_forward(monkeypatch, F32) == ["tf32x2"] * 8 + ["splitk"]


# GPT-2-small's projections (K, N) on a decode step's rows; BERT-base's
# four are the same widths
GPT2_SMALL = BERT_BASE


@pytest.mark.parametrize("dtype", [BF16, F16, F32])
@pytest.mark.parametrize("case, args", [
    *((f"gpt2_{proj}_m{m}", dict(m=m, n=GPT2_SMALL[proj][1], k=GPT2_SMALL[proj][0]))
      for proj in sorted(GPT2_SMALL) for m in (1, 8)),
    ("pooler_m32", dict(m=32, n=768, k=768, x_strides=(0, 128 * 768))),
    ("n33_m32", dict(m=32, n=33, k=768)),
    ("n40_m5_k4", dict(m=5, n=40, k=4)),
    ("x_row_stride_off_16_bytes", dict(m=8, n=768, k=770, x_strides=(0, 771), x_ptr=ALIGNED + 2)),
    ("q_base_off_16_bytes", dict(m=8, n=776, k=768, q_ptr=ALIGNED + 8)),
    ("shared_x_members", dict(m=8, n=768, k=768, x_strides=(0, 768), q_member_stride=768 * 768)),
    ("per_member_x", dict(m=8, n=768, k=776, x_strides=(8 * 776, 776), q_member_stride=776 * 768)),
])
def test_few_rows_take_the_fewrows_body(case, args, dtype):
    assert _rule(dtype=dtype, **args) == "fewrows"


@pytest.mark.parametrize("dtype, want", [(BF16, "wgmma"), (F16, "wgmma"), (F32, "tf32x2")])
@pytest.mark.parametrize("proj", sorted(GPT2_SMALL))
def test_one_row_past_the_cut_takes_the_tiled_body_and_narrow_outputs_keep_splitk(proj, dtype, want):
    k, n = GPT2_SMALL[proj]
    assert _rule(i8.FEW_ROWS_WIDE, n, k, dtype) == "fewrows"
    assert _rule(i8.FEW_ROWS_WIDE + 1, n, k, dtype) == want
    for m in (1, 8, i8.FEW_ROWS_WIDE):
        assert _rule(m, 8, k, dtype) == _rule(m, 32, k, dtype) == "splitk"


@pytest.mark.parametrize("m", [1, 8, 32, 33, 128, 129, 4096])
def test_the_c_fewrows_rule_takes_exactly_the_calls_the_python_rule_sends(m):
    """``fewrows_takes`` against ``select_body`` over the product of shapes,
    strides and offsets the tiled bodies' rules are walked over, at rows on
    both sides of each cut, N on both sides of the narrow cuts."""
    rule = _c_rule("fewrows_takes")
    src = (CSRC / "int8_matmul.cu").read_text()
    constants = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (constants["FR_MAX_ROWS"], constants["FR_NARROW_N"], constants["FR_NARROW_ROWS"]) == (
        i8.FEW_ROWS_WIDE, i8.NARROW_FEW_ROWS_MAX_N, i8.FEW_ROWS)
    codes = {F32: 0, BF16: 1, F16: 2}
    checked = 0
    for dtype, k, n, row_extra, x_member, q_member, x_off, q_off in itertools.product(
            codes, (4, 6, 8, 64, 770, 776), (8, 12, 16, 32, 33, 40, 400), (-32, 0, 2, 4, 8),
            (0, 2, 4, 8, 4096 * 800), (0, 8, 16, 800 * 400), (0, 4, 8, 16), (0, 8, 16)):
        x_row = k + row_extra
        if x_row <= 0:
            continue
        body = i8.select_body(m, n, k, dtype, (x_member, x_row), q_member, ALIGNED + x_off, ALIGNED + q_off)
        assert rule(M=m, N=n) == (body == "fewrows"), (dtype, k, n, x_row, x_member, q_member, x_off, q_off, body)
        checked += 1
    assert checked > 10000


def test_fused_few_row_members_take_fewrows_past_their_strides():
    """Stacked members at a decode step's rows go to the few-rows body
    whatever their member strides, a shared x (stride 0) included."""
    stacked = torch.zeros(3, 768, 768, dtype=torch.int8)
    shared = torch.zeros(1, 8, 768, dtype=BF16).expand(3, 8, 768)
    assert i8.body_for(shared, stacked) == "fewrows"
    assert i8.body_for(torch.zeros(3, 8, 772, dtype=BF16), torch.zeros(3, 772, 768, dtype=torch.int8)) == "fewrows"
    assert i8.body_for(torch.zeros(3, 8, 768).float(), stacked) == "fewrows"
