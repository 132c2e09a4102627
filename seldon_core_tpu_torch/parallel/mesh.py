"""Device meshes and axis conventions, driven by one process.

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

``initialize_distributed`` (multi-host) is not ported yet.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, Iterable, Mapping, Sequence

import torch

from seldon_core_tpu_torch.graph.defaulting import mesh_from_spec as mesh_axes_for
from seldon_core_tpu_torch.models.quant import is_quantized_leaf, quantized_leaf_spec

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
    builds over the same positions."""

    def __init__(self, axes: Mapping[str, int], positions: Sequence[Any]):
        self.axis_names = tuple(str(a) for a in axes)
        self.shape = {str(a): int(s) for a, s in axes.items()}
        self.positions = tuple(normalize_device(d) for d in positions)
        if len(self.positions) != math.prod(self.shape.values()):
            raise ValueError(f"mesh {self.shape} needs {math.prod(self.shape.values())} positions, "
                             f"got {len(self.positions)}")
        self.size = len(self.positions)
        self.devices = tuple(dict.fromkeys(self.positions))  # distinct, in first-use order
        self.n_devices = len(self.devices)
        self._strides = {}
        stride = 1
        for a in reversed(self.axis_names):
            self._strides[a] = stride
            stride *= self.shape[a]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and (self.shape, self.axis_names, self.positions) == (
            other.shape, other.axis_names, other.positions)

    def __hash__(self) -> int:
        return hash((self.axis_names, tuple(self.shape.values()), self.positions))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, positions={self.size}, devices={self.n_devices})"

    def size_of(self, axis: str) -> int:
        """The axis's size, 1 when the mesh lacks it."""
        return self.shape.get(axis, 1)

    def coord(self, pos: int, axis: str) -> int:
        """Position ``pos``'s index along ``axis`` (0 when the mesh lacks it)."""
        if axis not in self.shape:
            return 0
        return (pos // self._strides[axis]) % self.shape[axis]

    def groups(self, axis: str) -> list[list[int]]:
        """The positions that differ only along ``axis``, each group in axis
        order (one group per position when the mesh lacks the axis)."""
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
        return {"mesh": ",".join(f"{a}={s}" for a, s in self.shape.items()), "mesh_positions": self.size,
                "mesh_devices": self.n_devices, "mesh_eager": self.n_devices > 1}


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
    ``place_params`` returns and what a mesh runtime holds."""


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
        k = mesh.shape[axis]
        if n % (parts * k):
            raise ValueError(f"dimension {dim} of size {n} does not split over mesh axis '{axis}' of size {k}"
                             + (f" in {parts} packed slabs" if parts > 1 else ""))
        slab, i = n // parts, mesh.coord(pos, axis)
        block = slab // k
        out.append(tuple((s * slab + i * block, s * slab + (i + 1) * block) for s in range(parts)))
    return tuple(out)


def _take_shard(a: Any, slices: tuple) -> Any:
    """The shard of ``a`` (a numpy array or a tensor) that ``_shard_slices``
    names, as a new array of the same kind."""
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

    def leaf(a, spec):
        # a quantized leaf: its int8 payload and its scale, each by its spec
        parts = {k: (a[k], spec[k]) for k in a} if is_quantized_leaf(a) else {None: (a, spec)}
        parts = {k: (arr, _mesh_spec(sp, mesh, dropped)) for k, (arr, sp) in parts.items()}
        placed: dict = {}
        out = []
        for pos in range(mesh.size):
            dev = mesh.positions[pos]
            sl = tuple(_shard_slices(tuple(arr.shape), sp, mesh, pos) if any(e is not None for e in sp) else ()
                       for arr, sp in parts.values())
            if (dev, sl) not in placed:
                shards = {k: _take_shard(arr, s) if s else arr for (k, (arr, _)), s in zip(parts.items(), sl)}
                if None in shards:
                    placed[(dev, sl)] = place_leaf(shards[None], dev)
                else:
                    # a replicated scale beside a payload shard is still held
                    # once per device
                    new = place_leaf(shards, dev)
                    placed[(dev, sl)] = {k: placed.setdefault((dev, k, s), new[k]) for k, s in zip(shards, sl)}
            out.append(placed[(dev, sl)])
        return _PerPos(out)

    tree = _spec_tree_map(leaf, params, specs)
    if dropped:
        log.warning("param shardings name axes %s missing from mesh %s — those dimensions are now REPLICATED "
                    "(full param copy per device along the missing axis)", sorted(dropped), mesh.shape)
    return PositionParams(_select(tree, pos) for pos in range(mesh.size))


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


class MeshApply:
    """A model's apply over a mesh: ``fn(params, xs)`` takes the positions'
    parameter trees (``PositionParams``) and their input blocks (the batch
    split over "data", replicated over the other axes) and returns a list
    per position in which each data lead (``Mesh.leads``) holds its block of
    the output; other entries may be None. What the JAX package's
    ``apply_factory(mesh)`` returns, with the collectives written out."""

    def __init__(self, fn: Callable[[Sequence[Any], Sequence[torch.Tensor]], list], mesh: Mesh, name: str):
        self.fn, self.mesh, self.name = fn, mesh, name

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
