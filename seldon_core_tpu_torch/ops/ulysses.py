"""Ulysses (all-to-all) sequence parallelism: exact attention over a
sequence-sharded mesh axis, the alternative strategy to ring attention.

Port of ``seldon_core_tpu/ops/ulysses.py`` (DeepSpeed-Ulysses,
arXiv:2309.14509). A tiled all-to-all re-shards each position's block from
sequence-sharded to head-sharded,

    [b, h, s/N, d]  --all_to_all-->  [b, h/N, s, d]

(position i takes head chunk i, and the sequence is concatenated in
position order, as the JAX package's ``tiled=True`` does), each position
attends over the whole sequence for its heads, and the inverse all-to-all
restores sequence sharding. Local attention follows the JAX package's
policy: dense below ``FLASH_MIN_SEQ``, blockwise above. Heads and sequence
must both divide by the seq axis's size.
"""

from __future__ import annotations

from typing import Sequence

import torch

from seldon_core_tpu_torch.ops.attention import FLASH_MIN_SEQ, blockwise_attention, naive_attention
from seldon_core_tpu_torch.parallel.collectives import all_to_all, shard, unshard
from seldon_core_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, Mesh


def _local_attention(q, k, v, causal: bool):
    if q.shape[2] < FLASH_MIN_SEQ:
        return naive_attention(q, k, v, causal=causal)
    return blockwise_attention(q, k, v, causal=causal)


def ulysses_attention_shards(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                             mesh: Mesh, *, seq_axis: str = SEQ_AXIS, causal: bool = False) -> list[torch.Tensor]:
    """Per position, its Q/K/V block [b, h, s/N, d] -> its output block."""
    qh, kh, vh = (all_to_all(t, mesh, seq_axis, split_dim=1, concat_dim=2) for t in (qs, ks, vs))
    o = [_local_attention(q, k, v, causal) for q, k, v in zip(qh, kh, vh)]
    return all_to_all(o, mesh, seq_axis, split_dim=2, concat_dim=1)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, *, seq_axis: str = SEQ_AXIS,
                      data_axis: str = DATA_AXIS, causal: bool = False) -> torch.Tensor:
    """q, k, v: [batch, heads, seq, head_dim] global tensors; returns the
    global output, as ``ring_attention`` does."""
    heads, seq = q.shape[1], q.shape[2]
    n = mesh.shape[seq_axis]
    if heads % n != 0:
        raise ValueError(
            f"ulysses: {heads} heads not divisible by seq-axis size {n} "
            "(heads are the all-to-all resharding currency — use ring "
            "attention for head counts below the mesh axis)"
        )
    if seq % n != 0:
        raise ValueError(f"ulysses: seq {seq} not divisible by seq-axis size {n}")
    dims = {data_axis: 0, seq_axis: 2}
    outs = ulysses_attention_shards(shard(q, mesh, dims), shard(k, mesh, dims), shard(v, mesh, dims), mesh,
                                    seq_axis=seq_axis, causal=causal)
    return unshard(outs, mesh, dims, q.device)
