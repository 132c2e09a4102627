"""Device meshes and axis conventions, driven by one process or several.

Port of ``seldon_core_tpu/parallel/mesh.py``. The JAX package's mesh is
single-controller: one serving process builds a ``jax.sharding.Mesh`` and
drives every device of it through ``shard_map`` and GSPMD. The port's
counterpart is one process that drives a ``Mesh`` of ``torch.device``
*positions*:

    axis "data"   — the batch split over positions
    axis "model"  — tensor parallelism (BERT's Megatron pattern)
    axis "seq"    — sequence parallelism (ring or Ulysses attention)
    axis "expert" — expert parallelism (MoE)
    axis "pipe"   — pipeline stages (``parallel/pipeline.py``)

A position is one entry of the mesh's device array. Positions may repeat a
device, but only when the caller asks for it (``mesh_from_spec`` takes the
devices explicitly): ``[cuda:0] * 8`` on one card, or ``[cpu] * 8`` in the
tests, is the counterpart of XLA's forced host device count, and lets one
card run every sharded path at full width. What such a mesh cannot show is
interconnect traffic. ``Mesh.n_devices`` says how many distinct devices
back the positions.

Sharded values are lists with one tensor per position, in the mesh's flat
(row-major) order; ``parallel/collectives.py`` moves data between them.
A parameter tree is placed per position from the model's partition rule
(``place_params``): a leaf whose spec names a mesh axis is split over it,
and a replicated leaf is held once per distinct device, so eight positions
on one card share one copy of it. Axes a spec names that the mesh lacks are
dropped (those dimensions replicate), as the JAX runtime's
``to_mesh_spec`` does, with the same warning.

Training over a mesh keeps that placement. Every position computes with
the tensors it holds, so a block of a leaf held by positions on one device
is one tensor and autograd sums its gradient over those positions by
itself; copies of one block on distinct devices each receive the share of
the gradient their device computed. ``sum_replica_grads`` is the one rule
that makes them agree: each copy's gradient becomes the sum over the copies,
so every copy takes the same update. ``gather_params`` is the way back: the
full tree (BERT's packed q|k|v slabs put back in place) from the blocks the
positions hold.

Across OS processes (the JAX package's multi-host mesh): the processes
join one ``torch.distributed`` world with ``initialize_distributed``
(``parallel/distributed.py``: the JAX package's three variables, gloo or
NCCL), and ``process_mesh`` lays every process's positions out
rank-major. Each process drives its own block of positions: the mesh it
holds is that block (``shape``, ``positions``, ``groups`` and ``leads`` are
local), its placement keys name blocks of the global leaf
(``global_coord``), and a collective along an axis that spans processes
crosses them through that axis's process group. A process feeds and reads
only its own rows, as ``jax.make_array_from_process_local_data`` has it;
``sum_replica_grads`` all-reduces each block over the processes that hold
a copy. The runtime, the train step and ``gather_params`` take meshes
where only "data" crosses processes, so that each process holds every
block (``Mesh.check_data_only``); the server serves the mesh its own
positions hold (``serving/server.py::refuse_spanning_mesh``).
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, Iterable, Mapping, Sequence

import torch

from seldon_core_tpu_torch.graph.defaulting import mesh_from_spec as mesh_axes_for
from seldon_core_tpu_torch.models.quant import is_quantized_leaf, quantized_leaf_spec
from seldon_core_tpu_torch.parallel.distributed import (  # noqa: F401 - initialize_distributed re-exported
    all_gather_object,
    initialize_distributed,
    process_count,
    process_group,
    process_index,
    reduce_sum,
)

log = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"


def normalize_device(device: Any) -> torch.device:
    """``cuda`` with no index is the current card: two spellings of one card
    must compare equal when positions are grouped by device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


class Mesh:
    """Axis names and sizes over a row-major array of device positions.
    Hashable and compared by value, so applies memoised per mesh (as the
    JAX package memoises them per ``jax.sharding.Mesh``) are shared by two
    builds over the same positions.

    Positions may live in several processes (``process_mesh``): ``owners``
    names each global position's process, rank-major as ``jax.devices()``
    orders a multi-process slice. The mesh is then this process's view:
    ``shape``, ``positions``, ``coord``, ``groups`` and ``leads`` describe
    the positions it drives (a block of the global array), and
    ``global_shape`` with ``global_coord`` the whole. An axis that spans
    processes (``procs[axis] > 1``) adds a collective across them to
    ``parallel/collectives.py``'s ops along it, through the process group of
    ``process_group(axis)``; every such group is made at build, on every
    process, in one order."""

    def __init__(self, axes: Mapping[str, int], positions: Sequence[Any], owners: Sequence[int] | None = None):
        self.axis_names = tuple(str(a) for a in axes)
        self.global_shape = {str(a): int(s) for a, s in axes.items()}
        self.global_positions = tuple(normalize_device(d) for d in positions)
        total = math.prod(self.global_shape.values())
        if len(self.global_positions) != total:
            raise ValueError(f"mesh {self.global_shape} needs {total} positions, "
                             f"got {len(self.global_positions)}")
        self.owners = tuple(int(r) for r in owners) if owners is not None else None
        if self.owners is not None and len(self.owners) != total:
            raise ValueError(f"{len(self.owners)} owners for {total} positions")
        self.n_procs = len(set(self.owners)) if self.owners is not None else 1
        self.rank = process_index() if self.n_procs > 1 else 0
        if self.n_procs > 1:
            local = [i for i, r in enumerate(self.owners) if r == self.rank]
            self.shape = _local_block(self.global_shape, local)
        else:
            local = list(range(total))
            self.shape = dict(self.global_shape)
        self.procs = {a: self.global_shape[a] // self.shape[a] for a in self.axis_names}
        self.positions = tuple(self.global_positions[i] for i in local)
        self.size = len(self.positions)
        self.devices = tuple(dict.fromkeys(self.positions))  # distinct, in first-use order
        self.n_devices = len(self.devices)
        self._strides = _strides(self.axis_names, self.shape)
        self._global_strides = _strides(self.axis_names, self.global_shape)
        first = local[0]
        self.proc_coord = {a: (first // self._global_strides[a]) % self.global_shape[a] // self.shape[a]
                           for a in self.axis_names}
        self._groups: dict[str, tuple[Any, list[int]]] = {}
        if self.n_procs > 1:
            self._make_process_groups()

    def _rank_at(self, proc_coord: Mapping[str, int]) -> int:
        """The process that drives the block at these process coordinates."""
        index = sum(proc_coord[a] * self.shape[a] * self._global_strides[a] for a in self.axis_names)
        return self.owners[index]

    def _make_process_groups(self) -> None:
        """One process group per axis that spans processes (per block of
        the other spanning axes): every process makes each, in one order."""
        import itertools

        spanning = [a for a in self.axis_names if self.procs[a] > 1]
        for axis in spanning:
            rest = [a for a in spanning if a != axis]
            for fixed in itertools.product(*(range(self.procs[a]) for a in rest)):
                base = {**dict.fromkeys(self.axis_names, 0), **dict(zip(rest, fixed))}
                ranks = [self._rank_at({**base, axis: i}) for i in range(self.procs[axis])]
                group = process_group(ranks)
                if self.rank in ranks:
                    self._groups[axis] = (group, ranks)

    def spans(self, axis: str) -> bool:
        """Whether ``axis`` spans processes."""
        return self.procs.get(axis, 1) > 1

    def process_group(self, axis: str) -> tuple[Any, list[int]]:
        """(group, its ranks in axis order) of the processes that differ from
        this one only along ``axis`` (which spans processes)."""
        return self._groups[axis]

    def check_data_only(self, what: str) -> None:
        """Refuse, by name, a process mesh where an axis other than "data"
        spans processes: ``what`` takes each process's own rows."""
        crossing = [a for a in self.axis_names if a != DATA_AXIS and self.spans(a)]
        if crossing:
            raise ValueError(f"{what} over mesh {self.global_shape}: axis {crossing[0]!r} spans "
                             f"{self.procs[crossing[0]]} processes; only 'data' may cross processes")

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and (
            self.global_shape, self.axis_names, self.global_positions, self.owners, self.rank) == (
            other.global_shape, other.axis_names, other.global_positions, other.owners, other.rank)

    def __hash__(self) -> int:
        return hash((self.axis_names, tuple(self.global_shape.values()), self.global_positions, self.owners,
                     self.rank))

    def __repr__(self) -> str:
        procs = f", processes={self.n_procs}" if self.n_procs > 1 else ""
        return f"Mesh({self.global_shape}, positions={self.size}, devices={self.n_devices}{procs})"

    def size_of(self, axis: str) -> int:
        """The axis's size in this process's block, 1 when the mesh lacks it."""
        return self.shape.get(axis, 1)

    def coord(self, pos: int, axis: str) -> int:
        """Position ``pos``'s index along ``axis`` in this process's block
        (0 when the mesh lacks it)."""
        if axis not in self.shape:
            return 0
        return (pos // self._strides[axis]) % self.shape[axis]

    def global_coord(self, pos: int, axis: str) -> int:
        """Position ``pos``'s index along ``axis`` in the whole mesh."""
        if axis not in self.shape:
            return 0
        return self.proc_coord[axis] * self.shape[axis] + self.coord(pos, axis)

    def global_index(self, pos: int) -> int:
        """Position ``pos``'s index in the whole mesh's row-major order."""
        return sum(self.global_coord(pos, a) * self._global_strides[a] for a in self.axis_names)

    def groups(self, axis: str) -> list[list[int]]:
        """The positions that differ only along ``axis``, each group in axis
        order (one group per position when the mesh lacks the axis); where
        the axis spans processes, this process's members of each group."""
        if axis not in self.shape:
            return [[p] for p in range(self.size)]
        stride, n = self._strides[axis], self.shape[axis]
        return [[p + i * stride for i in range(n)] for p in range(self.size) if self.coord(p, axis) == 0]

    def leads(self, axis: str = DATA_AXIS) -> list[int]:
        """One position per index along ``axis`` (every other coordinate 0),
        in axis order: where a result replicated over the other axes is read."""
        stride = self._strides.get(axis, 0)
        return [i * stride for i in range(self.size_of(axis))]

    def describe(self) -> dict:
        """The mesh as span and boot-log attributes. ``mesh_eager``: the
        positions span devices, so every forward runs eagerly (one CUDA
        graph cannot span cards), and each request's span says so."""
        out = {"mesh": ",".join(f"{a}={s}" for a, s in self.global_shape.items()), "mesh_positions": self.size,
               "mesh_devices": self.n_devices, "mesh_eager": self.n_devices > 1}
        if self.n_procs > 1:
            out["mesh_processes"] = self.n_procs
        return out


def _strides(axis_names: Sequence[str], shape: Mapping[str, int]) -> dict[str, int]:
    out, stride = {}, 1
    for a in reversed(axis_names):
        out[a] = stride
        stride *= shape[a]
    return out


def _local_block(shape: Mapping[str, int], local: Sequence[int]) -> dict[str, int]:
    """The shape of the block of the row-major array that the global
    indices ``local`` cover; raises unless they are one aligned block (as
    positions laid out rank-major, an equal number per process, make)."""
    n, start = len(local), local[0]
    if list(local) != list(range(start, start + n)) or start % n:
        raise ValueError(f"positions {list(local)} of one process are not one aligned block of the mesh")
    out, rest = {}, n
    for a in reversed(list(shape)):
        size = shape[a]
        if rest >= size:
            if rest % size:
                raise ValueError(f"{n} positions per process do not tile mesh {dict(shape)}")
            out[a], rest = size, rest // size
        else:
            if size % rest:
                raise ValueError(f"{n} positions per process do not tile mesh {dict(shape)}")
            out[a], rest = rest, 1
    return {a: out[a] for a in shape}


def process_mesh(axes: Mapping[str, int], devices: Sequence[Any]) -> Mesh:
    """A Mesh over every process's ``devices`` (this process's positions;
    a list may repeat a device), laid out rank-major. Every process calls
    it, with as many positions each; one process gives an ordinary Mesh."""
    devices = [str(normalize_device(d)) for d in devices]
    if process_count() == 1:
        return Mesh(axes, devices)
    per_rank = all_gather_object(devices)
    if len({len(d) for d in per_rank}) != 1:
        raise ValueError(f"processes hold {[len(d) for d in per_rank]} positions: a process mesh needs as many "
                         "on each")
    positions = [d for devs in per_rank for d in devs]
    owners = [r for r, devs in enumerate(per_rank) for _ in devs]
    return Mesh(axes, positions, owners)


def mesh_from_spec(axes: Mapping[str, int] | None, devices: Sequence[Any]) -> Mesh | None:
    """A Mesh over ``devices`` (the cards a server sees, or the positions its
    caller asked for; a list may repeat a device). The JAX package's
    device-count rule (``graph/defaulting.py::mesh_from_spec``): one
    position asked for gives None, a mesh larger than the devices shrinks
    its data axis, and any other shortfall raises ValueError. The first
    positions in order are used. A data axis shrunk to one position gives
    None too (the JAX package keeps a one-device mesh, which serves as no
    mesh does): the runtime then serves unsharded, as without a mesh."""
    devices = list(devices)
    axes = mesh_axes_for(axes, len(devices))
    if axes is None or math.prod(axes.values()) == 1:
        return None
    return Mesh(axes, devices[: math.prod(axes.values())])


def local_cards(device: Any) -> list[torch.device]:
    """The devices a server on ``device`` sees: every card of the host for
    a CUDA device, else the device itself."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def serving_positions(axes: Mapping[str, int] | None, device: Any,
                      mesh_devices: Sequence[Any] | None = None) -> list:
    """The devices a server builds its ``tpu.mesh`` over: the positions its
    caller asked for; else the host's cards where the spec shards over an
    axis other than "data"; else the server's own device. A data-only mesh
    (the defaulted ``{"data": cards}``) thus stays on one device, captured,
    fine-tuning and unsharded as before meshes: replicas across cards wait
    for a run on several cards."""
    if mesh_devices is not None:
        return list(mesh_devices)
    if any(int(s) > 1 for a, s in (axes or {}).items() if a != DATA_AXIS):
        return local_cards(device)
    return [torch.device(device)]


class P(tuple):
    """A partition spec: one entry per dimension of a leaf, each None
    (replicated), an axis name, or a ``Packed`` entry. ``P()`` replicates
    the whole leaf."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


class Packed:
    """A dimension packed of ``parts`` equal slabs, each split over
    ``axis`` on its own: position i holds block i of every slab,
    concatenated. BERT's fused QKV projection is q|k|v packed on its output
    columns; a plain split of the columns would hand the first position only
    q heads."""

    def __init__(self, axis: str, parts: int):
        self.axis, self.parts = axis, int(parts)

    def __repr__(self) -> str:
        return f"Packed({self.axis!r}, {self.parts})"


class PositionParams(list):
    """A parameter tree per mesh position, already placed: what
    ``place_params`` returns and what a mesh runtime holds. ``keys`` names,
    per position and per leaf (in tree order), the block of the full leaf
    the position holds: the leaf's index and its index ranges per dimension
    (``()`` for the whole leaf). Equal keys are copies of one block. None
    where the trees were put together by hand (a fused ensemble's stack),
    which can neither be gathered nor trained. ``mesh``: the mesh they were
    placed over (keys name blocks of the global leaf, so on a process mesh
    equal keys in two processes are copies too)."""

    def __init__(self, trees: Iterable[Any] = (), keys: list | None = None, mesh: Mesh | None = None):
        super().__init__(trees)
        self.keys = keys
        self.mesh = mesh
        self._holders: dict | None = None

    def holders(self) -> dict:
        """Per block key, the processes that hold a copy (every process
        calls this together the first time on a process mesh)."""
        if self._holders is None:
            mine = sorted({k for keys in self.keys for k in keys})
            if self.mesh is None or self.mesh.n_procs == 1:
                self._holders = {k: (0,) for k in mine}
            else:
                held: dict = {}
                for rank, keys in enumerate(all_gather_object(mine)):
                    for k in keys:
                        held.setdefault(k, []).append(rank)
                self._holders = {k: tuple(v) for k, v in held.items()}
        return self._holders


def tree_leaves(tree: Any) -> Iterable[Any]:
    """Leaves of a dict / list tree (a quantized marker dict is one leaf)."""
    if is_quantized_leaf(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def _spec_tree_map(fn: Callable[[Any, Any], Any], tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a tree and its spec tree; a missing spec
    (None, or no spec tree at all) is replicated. A quantized leaf is one
    leaf, whose spec may be ``quant.quantized_pspecs``' pair."""
    if is_quantized_leaf(tree):
        return fn(tree, specs if isinstance(specs, dict) else quantized_leaf_spec(specs, tree))
    if not isinstance(tree, (dict, list, tuple)):
        return fn(tree, specs if isinstance(specs, P) else P())
    if isinstance(tree, dict):
        return {k: _spec_tree_map(fn, v, specs.get(k) if isinstance(specs, dict) else None) for k, v in tree.items()}
    sub = specs if isinstance(specs, (list, tuple)) and not isinstance(specs, P) else [None] * len(tree)
    return type(tree)(_spec_tree_map(fn, v, s) for v, s in zip(tree, sub))


def _mesh_spec(spec: P, mesh: Mesh, dropped: set) -> P:
    """The spec with the axes the mesh lacks dropped (recorded in ``dropped``)."""
    def keep(entry):
        if entry is None:
            return None
        axis = entry.axis if isinstance(entry, Packed) else entry
        if axis in mesh.shape:
            return entry
        dropped.add(axis)
        return None

    return P(*(keep(e) for e in spec))


def _shard_slices(shape: Sequence[int], spec: P, mesh: Mesh, pos: int) -> tuple:
    """Per dimension, the index ranges position ``pos`` holds: (start, stop)
    pairs (a Packed entry gives one range per slab). Raises where an axis
    does not divide its dimension."""
    out = []
    for dim, entry in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = shape[dim]
        if entry is None:
            out.append(((0, n),))
            continue
        axis, parts = (entry.axis, entry.parts) if isinstance(entry, Packed) else (entry, 1)
        k = mesh.global_shape[axis]
        if n % (parts * k):
            raise ValueError(f"dimension {dim} of size {n} does not split over mesh axis '{axis}' of size {k}"
                             + (f" in {parts} packed slabs" if parts > 1 else ""))
        slab, i = n // parts, mesh.global_coord(pos, axis)
        block = slab // k
        out.append(tuple((s * slab + i * block, s * slab + (i + 1) * block) for s in range(parts)))
    return tuple(out)


def take_shard(a: Any, slices: tuple) -> Any:
    """The shard of ``a`` (a numpy array or a tensor) that ``_shard_slices``
    names (``()``: all of it), as a new array of the same kind."""
    import numpy as np

    for dim, ranges in enumerate(slices):
        if len(ranges) == 1 and ranges[0] == (0, a.shape[dim]):
            continue
        if isinstance(a, torch.Tensor):
            a = torch.cat([a.narrow(dim, lo, hi - lo) for lo, hi in ranges], dim=dim)
        else:
            a = np.concatenate([a[(slice(None),) * dim + (slice(lo, hi),)] for lo, hi in ranges], axis=dim)
    return a if isinstance(a, torch.Tensor) else np.ascontiguousarray(a)


def place_params(params: Any, specs: Any, mesh: Mesh, place_leaf: Callable[[Any, torch.device], Any],
                 ) -> PositionParams:
    """One tree per position. ``place_leaf(leaf, device)`` turns a leaf (a
    numpy array, a tensor, or a quantized leaf) into the runtime's placed
    form on ``device``; each distinct (device, shard) is placed once and
    shared by the positions that hold it."""
    dropped: set = set()
    leaf_keys: list = []

    def leaf(a, spec):
        # a quantized leaf: its int8 payload and its scale, each by its spec
        parts = {k: (a[k], spec[k]) for k in a} if is_quantized_leaf(a) else {None: (a, spec)}
        parts = {k: (arr, _mesh_spec(sp, mesh, dropped)) for k, (arr, sp) in parts.items()}
        placed: dict = {}
        out, keys = [], []
        for pos in range(mesh.size):
            dev = mesh.positions[pos]
            sl = tuple(_shard_slices(tuple(arr.shape), sp, mesh, pos) if any(e is not None for e in sp) else ()
                       for arr, sp in parts.values())
            if (dev, sl) not in placed:
                shards = {k: take_shard(arr, s) if s else arr for (k, (arr, _)), s in zip(parts.items(), sl)}
                if None in shards:
                    placed[(dev, sl)] = place_leaf(shards[None], dev)
                else:
                    # a replicated scale beside a payload shard is still held
                    # once per device
                    new = place_leaf(shards, dev)
                    placed[(dev, sl)] = {k: placed.setdefault((dev, k, s), new[k]) for k, s in zip(shards, sl)}
            out.append(placed[(dev, sl)])
            keys.append((len(leaf_keys), sl))
        leaf_keys.append(keys)
        return _PerPos(out)

    tree = _spec_tree_map(leaf, params, specs)
    if dropped:
        log.warning("param shardings name axes %s missing from mesh %s — those dimensions are now REPLICATED "
                    "(full param copy per device along the missing axis)", sorted(dropped), mesh.shape)
    return PositionParams((_select(tree, pos) for pos in range(mesh.size)),
                          [[k[pos] for k in leaf_keys] for pos in range(mesh.size)], mesh)


class _PerPos(list):
    """A leaf's placed values, one per position (internal to place_params)."""


def _select(tree: Any, pos: int) -> Any:
    if isinstance(tree, _PerPos):
        return tree[pos]
    if isinstance(tree, dict):
        return {k: _select(v, pos) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_select(v, pos) for v in tree)
    return tree


def unique_tensors(trees: Iterable[Any]) -> list[torch.Tensor]:
    """Every tensor of the trees once (a leaf shared by positions counts
    once): what the positions' parameters hold on their devices."""
    seen: dict[int, torch.Tensor] = {}
    for tree in trees:
        for leaf in tree_leaves(tree):
            for t in (leaf.values() if is_quantized_leaf(leaf) else (leaf,)):
                if isinstance(t, torch.Tensor):
                    seen.setdefault(id(t), t)
    return list(seen.values())


def _keyed_leaves(params: PositionParams) -> Iterable[tuple[Any, tuple]]:
    """(leaf, key) over every position's leaves."""
    if params.keys is None:
        raise ValueError("these per-position parameters were not placed by place_params: they carry no block "
                         "keys to gather or train them by")
    for tree, keys in zip(params, params.keys):
        yield from zip(tree_leaves(tree), keys)


def map_unique(fn: Callable[[Any], Any], params: PositionParams) -> PositionParams:
    """``fn`` over every distinct leaf, once: a leaf that positions share
    stays shared in the result, which keeps the block keys."""
    from seldon_core_tpu_torch.models.convert import tree_map

    memo: dict[int, Any] = {}

    def leaf(a):
        if id(a) not in memo:
            memo[id(a)] = fn(a)
        return memo[id(a)]

    return PositionParams((tree_map(leaf, tree) for tree in params), params.keys, params.mesh)


def sum_replica_grads(params: PositionParams) -> None:
    """The gradient rule of a placed tree, after ``backward``: every copy of
    a block takes the sum of the copies' gradients. A copy on a distinct
    device stands in for the one parameter where that device computes, so
    the global function's gradient is the sum over copies; a block that
    positions share on one device is one tensor, already summed by
    autograd. The JAX package has no such step: GSPMD keeps one logical
    array per leaf.

    On a process mesh the copies held by other processes join the sum
    through one all-reduce per block over the processes that hold it, the
    blocks taken in one order on every process (leaf index, then index
    ranges): a process without a gradient for its copy sends zeros."""
    copies: dict = {}
    for leaf, key in _keyed_leaves(params):
        if isinstance(leaf, torch.Tensor):
            copies.setdefault(key, {}).setdefault(id(leaf), leaf)
    mesh = params.mesh
    across = mesh is not None and mesh.n_procs > 1
    holders = params.holders() if across else {}
    for key in sorted(copies):
        group = list(copies[key].values())
        grads = [t.grad for t in group if t.grad is not None]
        ranks = holders.get(key, (0,))
        if len(ranks) == 1 and len(group) == 1:
            continue
        if grads:
            total = grads[0]
            for g in grads[1:]:
                total = total + g.to(total.device)
        else:
            if len(ranks) == 1:
                continue
            total = torch.zeros_like(group[0])
        if len(ranks) > 1:
            total = reduce_sum(total, _holders_group(mesh, ranks))
        for t in group:
            t.grad = total.to(t.device, copy=True)


def _holders_group(mesh: Mesh, ranks: Sequence[int]):
    """The process group of a block's holders: the data axis's (a train
    step lets no other axis cross processes, ``Mesh.check_data_only``)."""
    group, members = mesh.process_group(DATA_AXIS) if mesh.spans(DATA_AXIS) else (None, [])
    if sorted(members) != sorted(ranks):
        raise ValueError(f"a block held by processes {sorted(ranks)} on mesh {mesh.global_shape}: copies may "
                         "cross processes along 'data' only")
    return group


def _assemble(blocks: Mapping[tuple, torch.Tensor], device: torch.device) -> torch.Tensor:
    """The full tensor from its blocks, each keyed by its index ranges per
    dimension (``()``: the whole tensor)."""
    if () in blocks:
        return blocks[()].detach().to(device, copy=True)
    first = next(iter(blocks.values()))
    ndim = first.dim()
    shape = [max(hi for sl in blocks for _, hi in sl[d]) for d in range(ndim)]
    out = torch.empty(shape, dtype=first.dtype, device=device)
    for sl, t in blocks.items():
        index = tuple(torch.cat([torch.arange(lo, hi, device=device) for lo, hi in sl[d]]).view(
            [-1 if k == d else 1 for k in range(ndim)]) for d in range(ndim))
        out[index] = t.detach().to(device)
    return out


def gather_blocks(params: PositionParams, value: Callable[[Any], Any], device: Any = None) -> list:
    """Per leaf index, the full form of ``value(leaf)`` put together from
    the blocks the positions hold: a tensor of the block's shape, or a dict
    of them (a quantized leaf's parts, each by its own block, or an
    optimizer's moments of the block; a 0-d entry is taken from the first
    block). A leaf whose value is None for every block gives None. On a
    process mesh every process calls it together, and each must hold every
    block (as where only "data" crosses processes)."""
    by_leaf: dict[int, dict] = {}
    for leaf, (i, sl) in _keyed_leaves(params):
        by_leaf.setdefault(i, {}).setdefault(sl, leaf)
    if params.mesh is not None and params.mesh.n_procs > 1:
        missing = sorted(set(params.holders()) - {(i, sl) for i, blocks in by_leaf.items() for sl in blocks})
        if missing:
            raise ValueError(f"{len(missing)} blocks of these parameters are held by other processes only "
                             f"(the first: leaf {missing[0][0]}): gather them where only 'data' crosses processes")
    device = normalize_device(device) if device is not None else None
    out = []
    for i in range(len(by_leaf)):
        vals = {sl: value(leaf) for sl, leaf in by_leaf[i].items()}
        first = next(iter(vals.values()))
        if first is None:
            out.append(None)
            continue
        quantized = is_quantized_leaf(next(iter(by_leaf[i].values())))
        parts = first if isinstance(first, dict) else {None: first}
        full = {}
        for j, (k, v0) in enumerate(parts.items()):
            dev = device if device is not None else v0.device
            if v0.dim() == 0:
                full[k] = v0.detach().to(dev, copy=True)
            else:
                full[k] = _assemble({sl[j if quantized else 0]: (v if k is None else v[k]) for sl, v in vals.items()},
                                    dev)
        out.append(full[None] if None in full else full)
    return out


def gather_params(params: PositionParams, device: Any = None) -> Any:
    """The full parameter tree from the blocks the positions hold (on
    ``device``, else the first position's), detached: what a checkpoint, an
    online unit's snapshot and the tests read. The decode tier's
    counterpart for its head-sharded buffers is ``parallel/tp.py::
    Placed.gather``."""
    from seldon_core_tpu_torch.models.convert import tree_map

    full = iter(gather_blocks(params, lambda leaf: leaf, device))
    return tree_map(lambda _: next(full), params[0])


class MeshApply:
    """A model's apply over a mesh: ``fn(params, xs)`` takes the positions'
    parameter trees (``PositionParams``) and their input blocks (the batch
    split over "data", replicated over the other axes) and returns a list
    per position in which each data lead (``Mesh.leads``) holds its block of
    the output; other entries may be None. What the JAX package's
    ``apply_factory(mesh)`` returns, with the collectives written out.
    Its operations are autograd's like any others: a loss read from the
    leads' blocks gives every placed parameter its gradient."""

    def __init__(self, fn: Callable[[Sequence[Any], Sequence[torch.Tensor]], list], mesh: Mesh, name: str,
                 x_dims: Mapping[str, int] | None = None):
        self.fn, self.mesh, self.name = fn, mesh, name
        # how the input is split over the positions (axis -> dimension):
        # the batch over "data"; a training apply may take sequence blocks
        self.x_dims = dict(x_dims) if x_dims is not None else {DATA_AXIS: 0}

    def __call__(self, params: Sequence[Any], xs: Sequence[torch.Tensor]) -> list:
        return self.fn(params, xs)

    def __repr__(self) -> str:
        return f"MeshApply({self.name}, {self.mesh})"


_MESH_APPLIES: dict = {}


def memoised_apply(key: Any, build: Callable[[], MeshApply]) -> MeshApply:
    """One MeshApply per key (a model's strategy and its mesh), so two
    builds of one deployment share it, as the JAX package's factories
    memoise theirs (``engine/fused.py`` detects homogeneous ensembles by
    apply identity)."""
    if key not in _MESH_APPLIES:
        _MESH_APPLIES[key] = build()
    return _MESH_APPLIES[key]


def data_parallel(apply_fn: Callable[[Any, torch.Tensor], torch.Tensor], mesh: Mesh) -> MeshApply:
    """A single-position apply run on each data lead's block with that
    position's parameters: how a model with no sharded form serves on a
    mesh (its other axes hold replicas and compute nothing)."""
    leads = tuple(mesh.leads(DATA_AXIS))

    def run(params, xs):
        out: list = [None] * mesh.size
        for p in leads:
            out[p] = apply_fn(params[p], xs[p])
        return out

    name = f"data_parallel({getattr(apply_fn, '__name__', 'apply')})"
    return memoised_apply(("data_parallel", apply_fn, mesh), lambda: MeshApply(run, mesh, name))
