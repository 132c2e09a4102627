"""Ring attention: exact attention over a sequence-sharded mesh axis.

Port of ``seldon_core_tpu/ops/ring_attention.py``. Each position of the
"seq" axis holds one block of Q, K and V ([b, h, s/N, d]). The K/V blocks
rotate around the ring so that position p receives from p + 1 (after step i
it holds the block of (p + i + 1) % N), while each position folds its local
Q against every visiting block into online-softmax partials
(``ops/attention.py::_block_stats`` / ``combine_stats``). After N steps
every Q block has attended to the whole sequence exactly. The causal mask
is on global positions: a position knows its block's offset from its
coordinate. On a mixed data + seq mesh the batch is split over "data" too.
The last rotation, whose blocks the JAX loop drops, is not made.
"""

from __future__ import annotations

from typing import Sequence

import torch

from seldon_core_tpu_torch.ops.attention import _block_stats, combine_stats
from seldon_core_tpu_torch.parallel.collectives import ppermute, shard, unshard
from seldon_core_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, Mesh


def ring_attention_shards(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                          mesh: Mesh, *, seq_axis: str = SEQ_AXIS, causal: bool = False) -> list[torch.Tensor]:
    """Per position, its Q/K/V block [b, h, s/N, d] -> its output block."""
    ring = mesh.shape[seq_axis]
    s = qs[0].shape[2]
    perm = [(j, (j - 1) % ring) for j in range(ring)]  # p receives from p + 1
    stats: list = [None] * mesh.size
    k_cur, v_cur = list(ks), list(vs)
    for i in range(ring):
        for p in range(mesh.size):
            me = mesh.coord(p, seq_axis)
            mask = None
            if causal:
                ar = torch.arange(s, device=qs[p].device)
                q_pos = me * s + ar
                k_pos = ((me + i) % ring) * s + ar
                mask = k_pos[None, None, None, :] <= q_pos[None, None, :, None]
            blk = _block_stats(qs[p], k_cur[p], v_cur[p], mask)
            stats[p] = blk if stats[p] is None else combine_stats(*stats[p], *blk)
        if i < ring - 1:
            k_cur = ppermute(k_cur, mesh, seq_axis, perm)
            v_cur = ppermute(v_cur, mesh, seq_axis, perm)
    return [o / l[..., None] for _, l, o in stats]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, *, seq_axis: str = SEQ_AXIS,
                   data_axis: str = DATA_AXIS, causal: bool = False) -> torch.Tensor:
    """q, k, v: [batch, heads, seq, head_dim] global tensors; returns the
    global output. seq must divide by the seq axis's size; the batch splits
    over ``data_axis`` where the mesh has it."""
    seq, ring = q.shape[2], mesh.shape[seq_axis]
    if seq % ring != 0:
        raise ValueError(f"seq {seq} not divisible by ring size {ring}")
    dims = {data_axis: 0, seq_axis: 2}
    outs = ring_attention_shards(shard(q, mesh, dims), shard(k, mesh, dims), shard(v, mesh, dims), mesh,
                                 seq_axis=seq_axis, causal=causal)
    return unshard(outs, mesh, dims, q.device)
