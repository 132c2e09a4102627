"""Train steps over the port's parameter trees: fine-tuning and distillation.

Port of ``seldon_core_tpu/training/steps.py`` (``TrainState``,
``cross_entropy``, ``make_train_step``, ``init_state``, ``kl_from_teacher``,
``make_distill_step``, ``make_feature_distill_step``, ``shard_state``,
``make_sharded_train_step``). The JAX package's step
is a pure function of (state, batch) with an ``optax`` transformation; in the
port a state holds leaf tensors that require grad and a ``torch.optim``
optimizer over them, and a step updates both in place and returns the same
state with ``step`` one higher.

What changes in the port:

- The optimizer is a factory (``adam(lr)``, ``adamw(lr)``, ``sgd(lr)``)
  that ``init_state`` binds to the state's leaves, so the step makers take
  no optimizer. ``adam`` is ``torch.optim.Adam`` at its defaults, which are
  ``optax.adam``'s: b1 0.9, b2 0.999, eps 1e-8 added outside the square
  root, bias-corrected moments (``tests/test_torch_training.py`` holds the
  two update for update). ``adamw`` is ``torch.optim.AdamW`` at
  ``optax.adamw``'s weight decay (1e-4): both decay the parameter by lr x
  decay beside the Adam update. ``sgd`` is plain SGD, as ``optax.sgd``.
- ``feat_noise`` draws from a ``torch.Generator`` seeded from (7, step)
  (``models/decoder.sampling_generator``), not from
  ``jax.random.fold_in(key(7), step)``: the noise has the reference's
  scale, its draws differ.
- A step runs with autograd on and outside ``torch.inference_mode``
  whatever the caller's mode, on leaves that ``init_state`` made outside it.

Over a mesh (``parallel/mesh.py``) the port has no GSPMD to derive the
collectives from shardings, so:

- ``make_sharded_train_step``'s ``logits_fn`` is a model's mesh apply that
  returns logits (a ``MeshApply``, e.g. ``models/bert.py::
  bert_logits_factory``): it takes every position's parameter tree and
  input block and returns the data leads' blocks of logits. A
  single-position function runs on each data lead, as a runtime serves it,
  and on a mesh of one position the step is ``make_train_step``'s.
- The state's parameters are placed per position as a runtime's are
  (``place_params``: a block held by positions on one device is one
  tensor), and the optimizer runs over the distinct tensors, so a moment
  lives beside the block it tracks: Adam is elementwise, and the per-block
  update is the global one. After ``backward`` each block's copies on
  distinct devices take the sum of their gradients
  (``parallel/mesh.py::sum_replica_grads``, inside ``apply_gradients``), so
  every copy takes the same update.
- The loss is the cross-entropy mean over the global batch: the leads'
  logits are gathered in batch order before it is taken, once.

Over a mesh whose "data" axis spans processes (``parallel/mesh.py::
process_mesh``), each process feeds only its own rows, as
``jax.make_array_from_process_local_data`` has it: the batch placements
split this process's rows over its positions, and the step returns the
loss and accuracy of the global batch. Each process takes the
cross-entropy of its rows scaled to the global batch (its share of the
mean), so the losses of all processes sum to the global one, and its
backward gives each block's copies in this process their share of the
gradient; ``sum_replica_grads`` then all-reduces every block over the
processes that hold it. The loss is read once per data lead, and the
processes' leads are disjoint. Only "data" may cross processes here.
"""

from __future__ import annotations

import contextlib
import inspect
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.models.convert import tree_map
from seldon_core_tpu_torch.models.quant import is_quantized_leaf
from seldon_core_tpu_torch.parallel import distributed as dist_ops
from seldon_core_tpu_torch.parallel.collectives import shard, unshard
from seldon_core_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    MeshApply,
    P,
    PositionParams,
    data_parallel,
    gather_blocks,
    map_unique,
    place_params,
    sum_replica_grads,
    take_shard,
    unique_tensors,
)

LogitsFn = Callable[[Any, torch.Tensor], torch.Tensor]
OptimizerFactory = Callable[[list], torch.optim.Optimizer]
FEAT_NOISE_SEED = 7  # the reference's jax.random.key(7)


def adam(lr: float) -> OptimizerFactory:
    """``optax.adam(lr)``: torch's Adam at its (the same) defaults."""
    return partial(torch.optim.Adam, lr=lr)


def adamw(lr: float) -> OptimizerFactory:
    """``optax.adamw(lr)``: torch's AdamW at optax's weight decay. optax
    subtracts lr x (the Adam update + decay x the parameter), torch scales
    the parameter by 1 - lr x decay and subtracts lr x the Adam update: the
    same update."""
    return partial(torch.optim.AdamW, lr=lr, weight_decay=1e-4)


def sgd(lr: float) -> OptimizerFactory:
    """``optax.sgd(lr)``: no momentum, no weight decay."""
    return partial(torch.optim.SGD, lr=lr)


@dataclass
class TrainState:
    """The parameter tree (leaf tensors that require grad), the optimizer
    over its leaves, and the number of steps taken."""

    params: Any
    optimizer: torch.optim.Optimizer
    step: int = 0


def tree_leaves(tree: Any) -> list:
    """The leaves of a dict / list tree in its iteration order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def trainable_leaf(a: Any, device: Any = None, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A fresh leaf tensor that requires grad, made outside inference mode:
    a numpy or tensor leaf copied (onto ``device`` and into ``dtype`` where
    given). A weight-only int8 leaf has no gradient and is refused."""
    if is_quantized_leaf(a):
        raise ValueError("an int8 weight leaf cannot be trained: gradients over int8 payloads are undefined")
    with torch.inference_mode(False):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, copy=True))
        if not t.is_floating_point():
            raise ValueError(f"a parameter leaf of dtype {t.dtype} cannot be trained")
        t = t.detach().to(device=device if device is not None else t.device, dtype=dtype or t.dtype)
        return t.clone().requires_grad_(True)


def trainable(tree: Any, device: Any = None, dtype: torch.dtype | None = None) -> Any:
    """``trainable_leaf`` over a tree; over a placed tree
    (``PositionParams``) once per distinct tensor, so the copies keep the
    placement's sharing and block keys."""
    if isinstance(tree, PositionParams):
        return map_unique(lambda a: trainable_leaf(a, None, dtype), tree)
    return tree_map(lambda a: trainable_leaf(a, device, dtype), tree)


def optimized_tensors(params: Any) -> list:
    """The tensors an optimizer over ``params`` updates: the leaves in tree
    order, or a placed tree's distinct tensors."""
    return unique_tensors(params) if isinstance(params, PositionParams) else tree_leaves(params)


def init_state(params: Any, optimizer: OptimizerFactory, device: Any = None) -> TrainState:
    """A state over trainable copies of ``params`` (numpy or tensor leaves,
    or a placed tree), its optimizer's moments made lazily by the first
    step, as optax's are made by ``init``."""
    leaves = trainable(params, device)
    return TrainState(leaves, optimizer(optimized_tensors(leaves)), 0)


@contextlib.contextmanager
def grad_mode():
    """Autograd on, outside inference mode, whatever the caller's mode."""
    with torch.inference_mode(False), torch.enable_grad():
        yield


def apply_gradients(state: TrainState, loss: torch.Tensor) -> None:
    """One optimizer update from ``loss``'s gradient; ``state.step`` + 1.
    A placed tree's copies of a block first agree on their gradient
    (``sum_replica_grads``, across processes too)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if isinstance(state.params, PositionParams):
        sum_replica_grads(state.params)
    state.optimizer.step()
    state.step += 1


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def make_train_step(logits_fn: LogitsFn):
    """step(state, {"x", "y"}) -> (state, {"loss", "accuracy"})."""

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        with grad_mode():
            logits = logits_fn(state.params, batch["x"])
            loss = cross_entropy(logits, batch["y"])
            apply_gradients(state, loss)
        acc = (logits.detach().argmax(-1) == batch["y"].long()).float().mean()
        return state, {"loss": loss.detach(), "accuracy": acc}

    return step


def kl_from_teacher(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
                    teacher_temp: float = 1.0) -> torch.Tensor:
    """Mean KL(teacher || student) over every position; ``teacher_temp`` < 1
    sharpens the teacher first (the reference's docstring says why greedy
    acceptance wants it)."""
    t = F.log_softmax(teacher_logits.float() / teacher_temp, dim=-1)
    s = F.log_softmax(student_logits.float(), dim=-1)
    return (t.exp() * (t - s)).sum(-1).mean()


def _agreement(logits: torch.Tensor, teacher_logits: torch.Tensor) -> torch.Tensor:
    return (logits.detach().argmax(-1) == teacher_logits.argmax(-1)).float().mean()


def make_distill_step(logits_fn: LogitsFn, teacher_temp: float = 1.0):
    """KL distillation: batch {"x": ids [b, s], "t": the teacher's logits
    [b, s, vocab]} -> (state, {"kl", "top1_agreement"})."""

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        with grad_mode():
            logits = logits_fn(state.params, batch["x"])
            loss = kl_from_teacher(batch["t"], logits, teacher_temp)
            apply_gradients(state, loss)
        return state, {"kl": loss.detach(), "top1_agreement": _agreement(logits, batch["t"])}

    return step


def feature_noise(f: torch.Tensor, feat_noise: float, step: int) -> torch.Tensor:
    """The EAGLE input-noise augmentation: Gaussian noise of std
    ``feat_noise`` x the batch features' (population) std, drawn from the
    (7, step) generator."""
    from seldon_core_tpu_torch.models.decoder import sampling_generator

    g = sampling_generator(FEAT_NOISE_SEED, step, f.device)
    noise = torch.randn(f.shape, generator=g, device=f.device, dtype=torch.float32)
    return f + (feat_noise * f.std(unbiased=False) * noise).to(f.dtype)


def make_feature_distill_step(teacher_temp: float = 1.0, feat_weight: float = 1.0, feat_noise: float = 0.0,
                              self_cond: float = 0.0):
    """KL + feature-regression distillation of the feature head: batch {"x":
    ids [b, s], "t": the teacher's logits [b, s, vocab], "f": its final
    hidden [b, s, d]} -> (state, {"kl", "top1_agreement", "feat_mse"}), the
    metrics from the teacher-forced pass. ``feat_noise`` perturbs the input
    features (the target stays clean); ``self_cond`` adds a second pass on
    the head's own detached features at that weight."""
    from seldon_core_tpu_torch.models.decoder import feature_sequence_logits

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        f = batch["f"]
        f_in = feature_noise(f, feat_noise, state.step) if feat_noise > 0.0 else f
        with grad_mode():
            logits, head_feats = feature_sequence_logits(state.params, batch["x"], f_in)
            kl = kl_from_teacher(batch["t"], logits, teacher_temp)
            fmse = ((head_feats.float() - f.float()) ** 2).mean()
            loss = kl + feat_weight * fmse
            if self_cond > 0.0:
                logits2, head_feats2 = feature_sequence_logits(state.params, batch["x"], head_feats.detach())
                kl2 = kl_from_teacher(batch["t"], logits2, teacher_temp)
                fmse2 = ((head_feats2.float() - f.float()) ** 2).mean()
                loss = loss + self_cond * (kl2 + feat_weight * fmse2)
            apply_gradients(state, loss)
        return state, {"kl": kl.detach(), "top1_agreement": _agreement(logits, batch["t"]),
                       "feat_mse": fmse.detach()}

    return step


# ------------------------------------------------------------------ the mesh


def pspec_dims(pspec: P, mesh: Mesh) -> dict[str, int]:
    """A batch spec as axis -> dimension, for the axes the mesh has."""
    dims = {}
    for dim, entry in enumerate(pspec):
        if entry is None:
            continue
        if not isinstance(entry, str):
            raise ValueError(f"a batch spec entry must be one axis name or None, got {entry!r}")
        if entry in mesh.shape:
            dims[entry] = dim
    return dims


@dataclass(frozen=True)
class BatchPlacement:
    """Where a batch tensor goes, as ``NamedSharding(mesh, pspec)`` is to
    ``jax.device_put``: called on a host array or a tensor, it returns one
    block per position, split over ``dims`` (axis -> dimension) and on the
    position's device; on no mesh, the tensor on ``device``."""

    mesh: Mesh | None
    dims: Mapping[str, int]
    device: Any = None

    def __call__(self, x: Any) -> Any:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if self.mesh is None:
            return t.to(self.device) if self.device is not None else t
        return shard(t, self.mesh, self.dims)

    def gather(self, blocks: Any, device: Any) -> torch.Tensor:
        """The global tensor from blocks this placement made (a tensor or a
        host array is taken as the global one)."""
        if not isinstance(blocks, (list, tuple)) or self.mesh is None:
            return torch.as_tensor(np.asarray(blocks) if not isinstance(blocks, torch.Tensor) else blocks).to(device)
        return unshard(blocks, self.mesh, self.dims, device)


def gathered_optimizer_state(state: TrainState) -> dict:
    """The optimizer's state dict in the one-device form: per leaf (tree
    order) its moments as full tensors, so a placed state's snapshot
    restores into an unplaced one and the other way round."""
    sd = state.optimizer.state_dict()
    if not isinstance(state.params, PositionParams):
        return sd
    index = {id(t): j for j, t in enumerate(unique_tensors(state.params))}
    moments = gather_blocks(state.params, lambda leaf: sd["state"].get(index[id(leaf)]))
    full = {}
    for i, st in enumerate(moments):
        if st is not None:
            full[i] = st
    group = {**sd["param_groups"][0], "params": list(range(len(moments)))}
    return {"state": full, "param_groups": [group]}


def load_optimizer_state(state: TrainState, sd: dict) -> None:
    """``gathered_optimizer_state``'s form into the state's optimizer: on a
    placed tree each block's moments are cut from the full ones."""
    if not isinstance(state.params, PositionParams):
        state.optimizer.load_state_dict(sd)
        return
    uniq = unique_tensors(state.params)
    key_of: dict[int, tuple] = {}
    for tree, keys in zip(state.params, state.params.keys):
        for leaf, key in zip(tree_leaves(tree), keys):
            key_of.setdefault(id(leaf), key)

    def block(v, slices):
        # a copy each, the scalar step count too: torch's Adam adds to it in
        # place, once per tensor it steps
        if isinstance(v, torch.Tensor):
            return take_shard(v, slices).clone() if v.dim() > 0 else v.clone()
        return v

    per_tensor = {}
    for j, t in enumerate(uniq):
        i, sl = key_of[id(t)]
        st = sd["state"].get(i)
        if st is not None:
            per_tensor[j] = {k: block(v, sl[0]) for k, v in st.items()}
    group = {**sd["param_groups"][0], "params": list(range(len(uniq)))}
    state.optimizer.load_state_dict({"state": per_tensor, "param_groups": [group]})


def _placed_trainable(params: Any, param_pspecs: Any | None, mesh: Mesh) -> PositionParams:
    """Trainable blocks of ``params`` per position (None specs: replicated)."""
    return place_params(params, param_pspecs, mesh, lambda a, dev: trainable_leaf(a, dev))


def shard_state(state: TrainState, mesh: Mesh, param_pspecs: Any | None) -> tuple[TrainState, Any]:
    """The state placed over ``mesh``: its parameters per position by
    ``param_pspecs`` (None: replicated) as trainable blocks, a new optimizer
    of the same kind and settings over the distinct blocks, and the moments
    the state has (if it took steps) cut as the parameter each tracks.
    Returns the placed state and the specs it was placed by, where the JAX
    package returns its shardings."""
    params = _placed_trainable(state.params, param_pspecs, mesh)
    kind = type(state.optimizer)
    # the settings the constructor takes (AdamW's defaults also record a
    # decoupled_weight_decay flag its constructor does not)
    takes = inspect.signature(kind.__init__).parameters
    settings = {k: v for k, v in state.optimizer.defaults.items() if k in takes}
    placed = TrainState(params, kind(unique_tensors(params), **settings), state.step)
    sd = state.optimizer.state_dict()
    if sd["state"]:
        load_optimizer_state(placed, sd)
    return placed, param_pspecs


def make_sharded_train_step(
    logits_fn: LogitsFn | MeshApply,
    optimizer: OptimizerFactory,
    mesh: Mesh | None,
    param_pspecs: Any | None,
    *,
    batch_pspec: P = P(DATA_AXIS),
    label_pspec: P = P(DATA_AXIS),
    init_params: Any = None,
):
    """(step, placed state, {"x", "y"} batch placements) for a mesh, as the
    JAX package's ``make_sharded_train_step`` returns (jitted step, sharded
    state, shardings).

    The deliberate difference: ``logits_fn`` on a mesh is the model's mesh
    apply returning logits (the port has no GSPMD to derive one from a
    single-device function), and its ``x_dims`` must split what
    ``batch_pspec`` splits: ``P("data", "seq")`` hands each position its
    sequence block, which e.g. ``bert_logits_factory(mesh)`` takes on a
    "seq" mesh. A single-position function runs on each data lead and takes
    ``P("data")``. On no mesh, or a mesh of one position, the step is
    ``make_train_step``'s on that device. ``step(state, {"x", "y"})`` takes
    global tensors or host arrays (placed here) or the placements' blocks;
    its loss is the cross-entropy mean over the global batch, and ``loss``
    and ``accuracy`` come back as scalars on the first position's device.
    On a mesh across processes every process calls it and each step, with
    its own rows (``{"x", "y"}`` of this process), and each gets the global
    batch's loss and accuracy."""
    if mesh is None or (mesh.size == 1 and mesh.n_procs == 1):
        device = mesh.positions[0] if mesh is not None else None
        state = init_state(init_params, optimizer, device)
        place = BatchPlacement(None, {}, device)
        return make_train_step(logits_fn), state, {"x": place, "y": place}
    if not isinstance(logits_fn, MeshApply):
        logits_fn = data_parallel(logits_fn, mesh)
    mesh.check_data_only("a sharded train step")
    x_place = BatchPlacement(mesh, pspec_dims(batch_pspec, mesh))
    y_place = BatchPlacement(mesh, pspec_dims(label_pspec, mesh))
    wants = {a: d for a, d in logits_fn.x_dims.items() if a in mesh.shape}
    if dict(x_place.dims) != wants:
        raise ValueError(f"batch_pspec {tuple(batch_pspec)} splits {dict(x_place.dims)} over mesh {mesh.shape}, "
                         f"but {logits_fn.name} takes its input split as {wants}")
    params = _placed_trainable(init_params, param_pspecs, mesh)
    state = TrainState(params, optimizer(unique_tensors(params)), 0)
    lead = mesh.positions[0]
    split = {DATA_AXIS: 0}
    procs = mesh.procs.get(DATA_AXIS, 1)

    def step(state: TrainState, batch: Mapping[str, Any]):
        xs = batch["x"] if isinstance(batch["x"], (list, tuple)) else x_place(batch["x"])
        y = y_place.gather(batch["y"], lead)
        with grad_mode():
            logits = unshard(logits_fn(state.params, xs), mesh, split, lead)
            loss = cross_entropy(logits, y)
            if procs > 1:
                loss = loss / procs  # this process's share of the global mean (equal rows each)
            apply_gradients(state, loss)
        acc = (logits.detach().argmax(-1) == y.long()).float().mean()
        loss = loss.detach()
        if procs > 1:
            group = mesh.process_group(DATA_AXIS)[0]
            loss, acc = dist_ops.reduce_sum(loss, group), dist_ops.reduce_sum(acc, group) / procs
        return state, {"loss": loss, "accuracy": acc}

    return step, state, {"x": x_place, "y": y_place}


def data_split_apply(apply_fn: MeshApply, params: PositionParams, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A serving mesh apply on a global batch of any size: zero rows pad it
    to the data axis's multiple, it splits over "data", and the leads'
    blocks come back in batch order on the first position's device with the
    padding dropped (a loss over them is the global batch's). On a mesh
    across processes the batch is this process's rows, and so are the
    answers."""
    n, d = x.shape[0], mesh.size_of(DATA_AXIS)
    if n % d:
        x = torch.cat([x, x.new_zeros((d - n % d, *x.shape[1:]))])
    split = {DATA_AXIS: 0}
    return unshard(apply_fn(params, shard(x, mesh, split)), mesh, split, mesh.positions[0])[:n]
