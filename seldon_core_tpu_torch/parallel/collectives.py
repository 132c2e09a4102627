"""Collectives between mesh positions, in list-of-shards form.

The JAX package writes its sharded ops under ``shard_map`` with
``lax.psum``, ``lax.all_gather``, ``lax.all_to_all`` and ``lax.ppermute``,
which XLA lowers to ICI transfers. The port's sharded ops hold one tensor per
mesh position (``parallel/mesh.py``) and move data between positions with
these functions, as copies and adds:

- between positions on one device they are tensor operations (a position
  receives the very tensor another holds: nothing is copied);
- between distinct cards they are peer copies (``Tensor.to``). That path is
  written to be right but has not run yet: the card's host has one H100;
- along an axis that spans processes (``parallel/distributed.py``), each
  process first acts on its own members, then one collective over the
  axis's process group joins the processes: an all-reduce, an all-gather,
  an all-to-all, or sends and receives for ``ppermute``.

Each function takes the shards of every position and the mesh axis to act
along, and acts within each group of positions that differ only along that
axis (``Mesh.groups``), as a collective over a named axis does.

They are plain tensor operations (adds, concatenations, slices, copies), so
autograd differentiates through them: the gradient of ``psum`` reaches every
shard it summed, of ``ppermute`` goes back along the inverse permutation, of
``all_to_all`` back through the inverse exchange, as the transposes of the
``lax`` collectives under ``shard_map`` do; the collectives across
processes are autograd functions whose backward is the transposed
collective. What differs is how a result is
held. On one device ``psum`` and ``all_gather`` hand every member of a group
the very same tensor, and ``replicated`` computes once per device; on
distinct cards each member holds its own copy. Either way a loss must read
a replicated result once per data group (``Mesh.leads``), never once per
position: summed over the positions that share it, it would count the
gradient once per position.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch

from seldon_core_tpu_torch.parallel import distributed as dist_ops
from seldon_core_tpu_torch.parallel.mesh import Mesh


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def psum(shards: Sequence[torch.Tensor], mesh: Mesh, axis: str) -> list[torch.Tensor]:
    """Every member of a group receives the sum of the group's shards (the
    sum is formed once per group, on its first member's device, in axis
    order; where the axis spans processes, each process's sum of its members
    is then all-reduced over them)."""
    out: list = [None] * mesh.size
    for group in mesh.groups(axis):
        total = shards[group[0]]
        dev = total.device
        for p in group[1:]:
            total = total + _on(shards[p], dev)
        if mesh.spans(axis):
            total = dist_ops.all_reduce(total, mesh.process_group(axis)[0])
        for p in group:
            out[p] = _on(total, mesh.positions[p])
    return out


def all_gather(shards: Sequence[torch.Tensor], mesh: Mesh, axis: str, dim: int) -> list[torch.Tensor]:
    """Every member receives the group's shards concatenated along ``dim``
    in axis order (``lax.all_gather(..., tiled=True)``); where the axis spans
    processes, the processes' concatenations are gathered in their order."""
    out: list = [None] * mesh.size
    for group in mesh.groups(axis):
        dev = mesh.positions[group[0]]
        whole = torch.cat([_on(shards[p], dev) for p in group], dim=dim)
        if mesh.spans(axis):
            whole = torch.cat(dist_ops.all_gather(whole, mesh.process_group(axis)[0]), dim=dim)
        for p in group:
            out[p] = _on(whole, mesh.positions[p])
    return out


def all_to_all(shards: Sequence[torch.Tensor], mesh: Mesh, axis: str, split_dim: int, concat_dim: int,
               ) -> list[torch.Tensor]:
    """Tiled all-to-all (``lax.all_to_all(..., tiled=True)``): member i
    splits its shard into N chunks along ``split_dim``; member j receives
    chunk j of every member, concatenated along ``concat_dim`` in member
    order. Where the axis spans processes (N = processes x members each),
    each process sends every other one, in one all-to-all, the chunks its
    members owe that process's members."""
    out: list = [None] * mesh.size
    procs = mesh.procs.get(axis, 1)
    for group in mesh.groups(axis):
        n_local = len(group)
        n = n_local * procs
        chunks = []
        for p in group:
            size = shards[p].shape[split_dim]
            if size % n:
                raise ValueError(f"all_to_all: dimension {split_dim} of size {size} does not split over "
                                 f"axis '{axis}' of size {n}")
            chunks.append(shards[p].chunk(n, dim=split_dim))
        if procs == 1:
            for j, p in enumerate(group):
                dev = mesh.positions[p]
                out[p] = torch.cat([_on(chunks[i][j], dev) for i in range(n)], dim=concat_dim)
            continue
        dev = mesh.positions[group[0]]
        # to process q: [my member i][q's member j] -> chunk q * n_local + j of member i
        sends = [torch.stack([torch.stack([_on(chunks[i][q * n_local + j], dev) for j in range(n_local)])
                              for i in range(n_local)]) for q in range(procs)]
        got = dist_ops.all_to_all(sends, mesh.process_group(axis)[0])
        for j, p in enumerate(group):
            out[p] = _on(torch.cat([got[r][i][j] for r in range(procs) for i in range(n_local)], dim=concat_dim),
                         mesh.positions[p])
    return out


def ppermute(shards: Sequence[torch.Tensor], mesh: Mesh, axis: str, perm: Sequence[tuple[int, int]],
             ) -> list[torch.Tensor]:
    """``lax.ppermute``: for each (src, dst) pair of axis indices, member
    dst receives member src's shard; a member that receives nothing gets
    zeros. Where the axis spans processes, indices are global along it
    (process-major), and a pair whose ends live in two processes is one send
    and one receive between them, all of a group's in one batch."""
    out: list = [None] * mesh.size
    n_local = mesh.size_of(axis)
    me = mesh.proc_coord.get(axis, 0)
    ranks = mesh.process_group(axis)[1] if mesh.spans(axis) else None
    for group in mesh.groups(axis):
        got: list = [None] * len(group)
        sends, recvs, recv_at = [], [], []
        for src, dst in perm:
            (ps, s), (pd, d) = divmod(src, n_local), divmod(dst, n_local)
            if ps == me and pd == me:
                got[d] = _on(shards[group[s]], mesh.positions[group[d]])
            elif ps == me:
                sends.append((ranks[pd], shards[group[s]]))
            elif pd == me:
                recvs.append((ranks[ps], shards[group[d]]))
                recv_at.append(d)
        if sends or recvs:
            for d, t in zip(recv_at, dist_ops.exchange(sends, recvs, mesh.process_group(axis)[0])):
                got[d] = _on(t, mesh.positions[group[d]])
        for i, p in enumerate(group):
            out[p] = got[i] if got[i] is not None else torch.zeros_like(shards[p])
    return out


def per_unique(fn: Callable[..., torch.Tensor], *shard_lists: Sequence[torch.Tensor]) -> list:
    """``fn`` over positions, called once per distinct tuple of input
    tensors: positions that hold the very same tensors (a replicated value
    on one device) share one result, as they would share one buffer."""
    cache: dict = {}
    out = []
    for args in zip(*shard_lists):
        key = tuple(id(a) for a in args)
        if key not in cache:
            cache[key] = fn(*args)
        out.append(cache[key])
    return out


def shard(x: torch.Tensor, mesh: Mesh, dims: Mapping[str, int]) -> list[torch.Tensor]:
    """A global tensor split over mesh axes: ``dims`` maps an axis to the
    dimension it splits (axes the mesh lacks are skipped; the tensor is
    replicated over the mesh's other axes). Each position's block lands on
    its device; positions on one device with the same block share one
    tensor."""
    dims = {a: d for a, d in dims.items() if a in mesh.shape}
    for a, d in dims.items():
        if x.shape[d] % mesh.shape[a]:
            raise ValueError(f"dimension {d} of size {x.shape[d]} does not split over axis '{a}' of size "
                             f"{mesh.shape[a]}")
    cache: dict = {}
    out = []
    for p in range(mesh.size):
        key = (tuple(mesh.coord(p, a) for a in dims), mesh.positions[p])
        if key not in cache:
            t = x
            for (a, d), i in zip(dims.items(), key[0]):
                n = t.shape[d] // mesh.shape[a]
                t = t.narrow(d, i * n, n)
            cache[key] = _on(t, key[1])
        out.append(cache[key])
    return out


def unshard(shards: Sequence[torch.Tensor], mesh: Mesh, dims: Mapping[str, int], device: torch.device,
            ) -> torch.Tensor:
    """The global tensor whose blocks the positions hold, split as ``shard``
    splits it: the blocks of the positions whose other coordinates are 0,
    concatenated on ``device``."""
    dims = {a: d for a, d in dims.items() if a in mesh.shape}
    blocks = {}
    for p in range(mesh.size):
        if all(mesh.coord(p, a) == 0 for a in mesh.axis_names if a not in dims):
            blocks[tuple(mesh.coord(p, a) for a in dims)] = _on(shards[p], device)
    for depth in reversed(range(len(dims))):
        d = list(dims.values())[depth]
        merged: dict = {}
        for key in sorted(blocks):
            merged.setdefault(key[:depth], []).append(blocks[key])
        blocks = {k: v[0] if len(v) == 1 else torch.cat(v, dim=d) for k, v in merged.items()}
    return blocks[()]


def replicated(fn: Callable[..., torch.Tensor], mesh: Mesh, axis: str, *shard_lists: Sequence) -> list:
    """``fn`` over positions for a value replicated over ``axis``: computed
    once per device in each group (at the group's first position on that
    device) and shared by the group's positions there."""
    out: list = [None] * mesh.size
    for group in mesh.groups(axis):
        done: dict = {}
        for p in group:
            dev = mesh.positions[p]
            if dev not in done:
                done[dev] = fn(*(lst[p] for lst in shard_lists))
            out[p] = done[dev]
    return out
