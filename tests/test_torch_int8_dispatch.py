"""The W8A16 kernel's body rule (``ops/int8_matmul.py::select_body``), on the CPU.

The rule names the body a launch takes before the launch, from the shape,
dtype, strides and base addresses alone, and the C entry point refuses a
body that cannot take the call (the wrapper then raises; nothing retries
on another body). Here:

- BERT-base's four projections at buckets 32 and 1, in bf16 and f16, take
  ``wgmma``;
- the BERT head (N = 2), iris (K = 4, N = 3), an x view whose row stride
  is not a multiple of 8, rows closer than K, and a base off 16 bytes take
  ``mma``; float32 takes ``fma``;
- stacked members are decided by their member strides: a shared x or q
  (stride 0) and aligned strides take ``wgmma``, misaligned ones ``mma``;
- ``body_for`` derives the rule's arguments from tensors as the wrapper
  hands them to the kernel, and a ``bert_tiny`` int8 forward asks for
  ``wgmma`` at every projection and ``mma`` at the head.
"""

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.models import quant
from seldon_core_tpu_torch.models.base import ModelRuntime
from seldon_core_tpu_torch.models.zoo import get_model
from seldon_core_tpu_torch.ops import int8_matmul as i8

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
    ("bert_head_n2", dict(m=32, n=2, k=768, x_strides=(0, 128 * 768))),
    ("iris_k4_n3", dict(m=5, n=3, k=4)),
    ("n_multiple_of_8_only", dict(m=64, n=24, k=64)),
    ("k_not_multiple_of_8", dict(m=64, n=64, k=60)),
    ("x_row_stride_not_multiple_of_8", dict(m=64, n=64, k=64, x_strides=(0, 68))),
    ("x_rows_closer_than_k", dict(m=64, n=64, k=64, x_strides=(0, 32))),
    ("x_base_off_16_bytes", dict(m=64, n=64, k=64, x_ptr=ALIGNED + 2)),
    ("q_base_off_16_bytes", dict(m=64, n=64, k=64, q_ptr=ALIGNED + 8)),
])
def test_shapes_tma_cannot_address_take_the_mma_body(case, args):
    assert _rule(**args) == "mma"


@pytest.mark.parametrize("shape", [(4096, 2304, 768), (5, 3, 4), (32, 2, 768)])
def test_float32_takes_the_fma_body(shape):
    m, n, k = shape
    assert _rule(m, n, k, dtype=F32) == "fma"


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
    assert i8.body_for(x.float(), q) == "fma"
    assert i8.body_for(x[:, :, 8:], q[:, 8:]) == "wgmma"  # 16 bytes in: still aligned
    assert i8.body_for(x[:, :, 4:], q[:, 4:]) == "mma"  # 8 bytes in: x's base is off
    assert i8.body_for(x[:, :1], q) == "wgmma"  # one row: its stride is K
    cls = torch.zeros(32, 128, 768, dtype=BF16)[:, 0, :].reshape(1, -1, 768)  # BERT's [CLS] rows
    assert i8.body_for(cls, torch.zeros(1, 768, 2, dtype=torch.int8)) == "mma"
    stacked = torch.zeros(3, 768, 768, dtype=torch.int8)
    shared = torch.zeros(1, 256, 768, dtype=BF16).expand(3, 256, 768)
    assert i8.body_for(shared, stacked) == "wgmma"
    ragged = torch.zeros(3, 256, 776, dtype=BF16)[:, :, :772]  # K = 772: rows 8-aligned, K not
    assert i8.body_for(ragged, torch.zeros(3, 772, 768, dtype=torch.int8)) == "mma"


def test_bert_tiny_int8_forward_asks_for_wgmma_at_every_projection(monkeypatch):
    """2 layers x 4 projections take wgmma, the 2-class head mma: the CPU
    computes the plain version, so the rule is read where the card would
    launch."""
    spec = get_model("bert_tiny", seq=16)
    rt = ModelRuntime(spec.apply_fn, quant.quantize_params(spec.params), device=torch.device("cpu"),
                      buckets=[4], dtype=BF16)
    bodies = []
    batched = i8._batched
    monkeypatch.setattr(i8, "_batched", lambda x, q, s, b: bodies.append(i8.body_for(x, q)) or batched(x, q, s, b))
    probs = rt.predict(np.random.default_rng(3).integers(0, 1024, (4, 16)).astype(np.float32))
    assert np.isfinite(probs).all()
    assert bodies == ["wgmma"] * 8 + ["mma"]
