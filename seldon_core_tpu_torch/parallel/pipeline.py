"""Pipeline parallelism over a mesh axis: the GPipe microbatch schedule.

Port of ``seldon_core_tpu/parallel/pipeline.py``. Each position along the
"pipe" axis holds one stage's parameters, and activations flow from stage
s to stage s + 1 (the JAX package's ``lax.ppermute``; here the tensor
itself, or a peer copy between cards). The schedule is the (M + S - 1)-tick
loop: at tick t stage 0 feeds microbatch t while stage s works on
microbatch t - s, and the last stage keeps microbatch t - (S - 1) once the
pipe is full. A stage with no microbatch in a tick (the bubble) does no
work: the JAX package computes it on zeros and never keeps the result. The
last stage's buffer is then broadcast to every position of the pipe.

The backward needs no schedule of its own, as in the JAX package (where
``jax.grad`` transposes the scan and the ppermutes): autograd carries each
microbatch's gradient back along the same ticks, from the last stage's
kept output through the tensors the stages handed on, to every stage's
parameters. A bubble tick made nothing, so it sends nothing back. The
broadcast hands every position of a group one tensor on one device (a
copy per card across cards), and a loss reads it once per group
(``Mesh.leads``), so the broadcast does not multiply the gradient.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from seldon_core_tpu_torch.models.convert import tree_map
from seldon_core_tpu_torch.parallel.collectives import _on
from seldon_core_tpu_torch.parallel.mesh import PIPE_AXIS, Mesh, tree_leaves

StageFn = Callable[[Any, torch.Tensor], torch.Tensor]


def pipeline_shards(
    stage_fn: StageFn,
    stage_params: Sequence[Any],
    x_micro: Sequence[torch.Tensor],
    mesh: Mesh,
    pipe_axis: str = PIPE_AXIS,
) -> list[torch.Tensor]:
    """Per position: ``stage_params[p]`` is the stage that position holds
    (its leading stacked axis taken away) and ``x_micro[p]`` the [M, mb,
    ...] microbatch stack of its pipe group (only stage 0's is read).
    Returns, per position, the group's [M, mb, ...] outputs of the last
    stage."""
    n_stages = mesh.shape[pipe_axis]
    out: list = [None] * mesh.size
    for group in mesh.groups(pipe_axis):
        devs = [mesh.positions[p] for p in group]
        feed = x_micro[group[0]]
        n_micro = feed.shape[0]
        recv: list = [None] * n_stages
        kept: list = [None] * n_micro
        for t in range(n_micro + n_stages - 1):
            sent: list = [None] * n_stages
            for s in range(n_stages):
                if not 0 <= t - s < n_micro:
                    continue
                inp = _on(feed[t], devs[0]) if s == 0 else recv[s]
                sent[s] = stage_fn(stage_params[group[s]], inp)
            if sent[-1] is not None:
                kept[t - (n_stages - 1)] = sent[-1]
            # stage s -> s + 1; the last stage's send is dropped
            recv = [None] + [None if y is None else _on(y, devs[s + 1]) for s, y in enumerate(sent[:-1])]
        buf = torch.stack(kept)
        for p in group:
            out[p] = _on(buf, mesh.positions[p])
    return out


def stage_of(stacked: Any, stage: int) -> Any:
    """One stage's parameters out of a tree stacked [S, ...]."""
    return tree_map(lambda a: a[stage], stacked)


def pipeline_apply(
    stage_fn: StageFn,
    stage_params: Any,
    x_micro: torch.Tensor,
    mesh: Mesh,
    *,
    pipe_axis: str = PIPE_AXIS,
) -> torch.Tensor:
    """Run ``x_micro`` [M, mb, ...] through S pipeline stages, the JAX
    package's signature: ``stage_params`` is a tree whose leaves are
    stacked [S, ...] with S the pipe axis's size, and ``stage_fn(params,
    x)`` maps [mb, ...] to [mb, ...]. Returns [M, mb, ...]."""
    n_stages = mesh.shape[pipe_axis]
    for leaf in tree_leaves(stage_params):
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"stage_params stacked axis is {leaf.shape[0]} but mesh "
                f"'{pipe_axis}' axis has {n_stages} devices — they must match"
            )
    per_pos = [tree_map(lambda a, p=p: _on(a[mesh.coord(p, pipe_axis)], mesh.positions[p]), stage_params)
               for p in range(mesh.size)]
    xs = [_on(x_micro, d) for d in mesh.positions]
    return pipeline_shards(stage_fn, per_pos, xs, mesh, pipe_axis)[0]
