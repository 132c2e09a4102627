"""The flash kernel's one-tile body on the card (``-m gpu``; each skips here).

- the body against its plain version at the BERT DAG's seq-128 buckets (the
  QKV views BERT hands it) and at fewer keys than a tile, ragged and longer
  q, in bf16 and f16: 4 ulps of max|ref| in the dtype and a relative L2
  error of 1e-2 (``tests/test_torch_flash.py``'s bf16 tolerance), one
  launch counted on ``onetile``;
- a rerun and a CUDA graph replay bit for bit, and the ``wgmma`` body's
  output bit for bit (the two run the same operations on one tile);
- the refusal of the calls the body cannot take (more keys than a tile,
  causal, head_dim 128, float32, fewer items than the cut), with no launch
  counted, and the public wrapper sending those calls to their own bodies.

Nothing here imports JAX: the card's host has none.
"""

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.ops import flash_attention as fa

MANTISSA_BITS = {torch.bfloat16: 7, torch.float16: 10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    return torch.device("cuda")


def _inputs(b, h, sq, sk, dtype, views, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if views:  # as models/bert.py cuts them from one fused QKV projection
        fused = torch.randn(b, sq, 3 * h * 64, generator=g, device="cuda").to(dtype)
        return tuple(t.reshape(b, sq, h, 64).transpose(1, 2) for t in fused.split(h * 64, dim=-1))
    return tuple(torch.randn(b, h, s, 64, generator=g, device="cuda").to(dtype) for s in (sq, sk, sk))


def _assert_close_in_ulps(got, ref, dtype):
    got, ref = got.double().cpu(), ref.double().cpu()
    ulp = 2.0 ** (np.floor(np.log2(ref.abs().max().item())) - MANTISSA_BITS[dtype])
    assert (got - ref).abs().max().item() <= 4 * ulp
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-2


SHAPES = [  # b, h, sq, sk, QKV views
    (64, 12, 128, 128, True),  # the DAG's bucket 64
    (8, 12, 128, 128, True),  # bucket 8
    (64, 12, 128, 16, False),
    (64, 12, 77, 48, False),
    (32, 12, 300, 112, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b, h, sq, sk, views", SHAPES)
def test_one_tile_body_matches_plain_version_on_card(cuda, dtype, b, h, sq, sk, views):
    q, k, v = _inputs(b, h, sq, sk, dtype, views)
    assert fa.body_for(q, k) == "onetile"
    before = {body: c.count for body, c in fa.LAUNCHES_BY_BODY.items()}
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert {body: c.count - before[body] for body, c in fa.LAUNCHES_BY_BODY.items()} == {
        "wgmma": 0, "f32": 0, "onetile": 1}
    assert got.shape == (b, h, sq, 64) and got.transpose(1, 2).is_contiguous()
    _assert_close_in_ulps(got, fa.flash_attention_reference(q, k, v), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b, h, sq, sk, views", SHAPES)
def test_one_tile_body_reruns_and_replays_bit_for_bit(cuda, b, h, sq, sk, views):
    q, k, v = _inputs(b, h, sq, sk, torch.bfloat16, views, seed=1)
    first = fa.flash_attention(q, k, v)
    again = fa.flash_attention(q, k, v)
    graph, static = torch.cuda.CUDAGraph(), {}
    with torch.cuda.graph(graph):
        static["out"] = fa.flash_attention(q, k, v)
    graph.replay()
    wgmma = fa._launch(q, k, v, False, body="wgmma")
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(first, static["out"])
    assert torch.equal(first, wgmma)


@pytest.mark.gpu
@pytest.mark.parametrize("shape, causal, dtype, head_dim, body", [
    ((64, 12, 128, 256), False, torch.bfloat16, 64, "wgmma"),  # two tiles of keys
    ((64, 12, 128, 128), True, torch.bfloat16, 64, "wgmma"),
    ((64, 12, 128, 128), False, torch.bfloat16, 128, "wgmma"),
    ((64, 12, 128, 128), False, torch.float32, 64, "f32"),
    ((1, 12, 128, 128), False, torch.bfloat16, 64, "wgmma"),  # 12 items, below the cut
])
def test_one_tile_body_refuses_what_it_cannot_take(cuda, shape, causal, dtype, head_dim, body):
    b, h, sq, sk = shape
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(b, h, s, head_dim, generator=g, device="cuda").to(dtype) for s in (sq, sk, sk))
    fa.reset_launches()
    with pytest.raises(RuntimeError, match="onetile body"):
        fa._launch(q, k, v, causal, body="onetile")
    assert fa.LAUNCHES.count == 0
    assert fa.body_for(q, k, causal) == body
    fa.flash_attention(q, k, v, causal=causal, block_k=4096)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_BY_BODY[body].count == 1 and fa.LAUNCHES_BY_BODY["onetile"].count == 0
