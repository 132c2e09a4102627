"""Graph fusion: a pure subtree becomes one forward of one runtime.

Port of ``seldon_core_tpu/engine/fused.py``. Where the walker runs a
COMBINER by calling each child model and then averaging, a pure subtree is
collapsed at build time into one ``FusedUnit``: the members' applies and the
combine run as one function on one batch, with one bucket padding, one
upload and one readback instead of one per member.

Two strategies, picked from the members:
- homogeneous ensemble: every child shares one apply function and one
  parameter tree structure (3x resnet50 with different seeds), so the
  parameters stack on a leading ensemble axis and one
  ``torch.func.vmap(apply, in_dims=(0, None))`` computes every member (the
  JAX package's ``jax.vmap``);
- heterogeneous ensemble: the children run in turn inside the one apply.

Fusable units expose a pure-function hook (``engine/units.py``):
``as_pure_fn`` (combiner aggregate), ``as_pure_input_fn`` /
``as_pure_output_fn`` (transformer math). Model leaves, pure COMBINER
interiors and pure single-child TRANSFORMER / OUTPUT_TRANSFORMER interiors
fuse, so a transformer -> models -> combiner DAG is one forward. Routers and
units without a pure form never fuse; the executor walks around the fused
islands.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from seldon_core_tpu_torch.engine.executor import Node, _has_method
from seldon_core_tpu_torch.engine.units import Unit
from seldon_core_tpu_torch.graph.spec import PredictiveUnit, PredictiveUnitMethod, PredictiveUnitType
from seldon_core_tpu_torch.models.base import ModelRuntime, ModelUnit
from seldon_core_tpu_torch.models.zoo import DTYPES

_IDENTITY = "identity"


@dataclass
class _PureSubtree:
    apply_fn: Callable[[Any, torch.Tensor], torch.Tensor]
    params: Any
    class_names: tuple[str, ...]
    feature_shape: tuple[int, ...] | None
    device: torch.device
    n_models: int
    n_nodes: int  # forwards the fused one replaces (models + transforms)


def _pure_transform(node: Node, method: PredictiveUnitMethod):
    """The node's input/output transform as the walker would run it:
    _IDENTITY when the walker would not run it (method absent for the node
    type) or the unit keeps the base identity; (fn, params) when the unit
    has a pure form; None when the transform is opaque (blocks fusion)."""
    if not _has_method(node, method):
        return _IDENTITY
    unit = node.unit
    if method is PredictiveUnitMethod.TRANSFORM_INPUT:
        pure = unit.as_pure_input_fn()
        overridden = type(unit).transform_input is not Unit.transform_input
    else:
        pure = unit.as_pure_output_fn()
        overridden = type(unit).transform_output is not Unit.transform_output
    if pure is not None:
        return pure
    return None if overridden else _IDENTITY


def _same_structure(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same_structure(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (
            type(a) is type(b) and len(a) == len(b) and all(_same_structure(x, y) for x, y in zip(a, b))
        )
    return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.shape == b.shape


def _collect(node: Node) -> _PureSubtree | None:
    """Bottom-up: a model leaf, or a pure interior node (COMBINER with a
    pure aggregate, single-child TRANSFORMER / OUTPUT_TRANSFORMER) whose
    transforms are pure, over pure children."""
    unit = node.unit
    if not node.children:
        if isinstance(unit, ModelUnit):
            rt = unit.runtime
            return _PureSubtree(rt.apply_fn, rt.params, rt.class_names, rt.feature_shape, rt.device, 1, 1)
        return None

    # routers never fuse: routing is per-request host-side control flow
    if _has_method(node, PredictiveUnitMethod.ROUTE):
        return None
    # a MODEL unit with children is a chain head, not a combiner: fusing it
    # as an interior node would apply it to the list of child outputs
    if node.spec.type not in (
        PredictiveUnitType.COMBINER,
        PredictiveUnitType.TRANSFORMER,
        PredictiveUnitType.OUTPUT_TRANSFORMER,
    ):
        return None

    t_in = _pure_transform(node, PredictiveUnitMethod.TRANSFORM_INPUT)
    t_out = _pure_transform(node, PredictiveUnitMethod.TRANSFORM_OUTPUT)
    if t_in is None or t_out is None:
        return None
    if _has_method(node, PredictiveUnitMethod.AGGREGATE):
        pure = unit.as_pure_fn()
        if pure is None:
            return None
        combine_fn, combine_params = pure
    elif len(node.children) == 1:
        combine_fn, combine_params = None, None  # pass-through
    else:  # fan-out without aggregate is an executor error anyway
        return None

    children = [_collect(c) for c in node.children]
    if any(c is None for c in children):
        return None
    devices = {c.device for c in children}
    if len(devices) != 1:
        return None

    first = children[0]
    homogeneous = len(children) > 1 and all(
        c.apply_fn is first.apply_fn and _same_structure(c.params, first.params) for c in children
    )
    if homogeneous:
        member_params = _stack_trees([c.params for c in children])
        child_fn = first.apply_fn

        def inner(params, x):
            ys = torch.func.vmap(child_fn, in_dims=(0, None))(params, x)
            return list(ys.unbind(0))

    else:
        child_fns = tuple(c.apply_fn for c in children)
        member_params = [c.params for c in children]

        def inner(params, x, _fns=child_fns):
            return [f(p, x) for f, p in zip(_fns, params)]

    params: dict[str, Any] = {"members": member_params}
    if t_in is not _IDENTITY:
        params["t_in"] = t_in[1]
    if t_out is not _IDENTITY:
        params["t_out"] = t_out[1]

    def fused(
        params,
        x,
        _inner=inner,
        _combine=combine_fn,
        _cp=combine_params,
        _tin=None if t_in is _IDENTITY else t_in[0],
        _tout=None if t_out is _IDENTITY else t_out[0],
    ):
        if _tin is not None:
            x = _tin(params["t_in"], x)
        ys = _inner(params["members"], x)
        y = _combine(_cp, ys) if _combine is not None else ys[0]
        if _tout is not None:
            y = _tout(params["t_out"], y)
        return y

    return _PureSubtree(
        apply_fn=fused,
        params=params,
        class_names=next((c.class_names for c in children if c.class_names), ()),
        feature_shape=next((c.feature_shape for c in children if c.feature_shape), None),
        device=first.device,
        n_models=sum(c.n_models for c in children),
        n_nodes=sum(c.n_nodes for c in children) + 1,
    )


def _stack_trees(trees: list) -> Any:
    """Stack same-structured parameter trees leaf by leaf on a new leading
    (ensemble) axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_trees([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(trees)


class FusedUnit(ModelUnit):
    """A whole pure subtree collapsed into one ModelRuntime."""


def fuse_graph(root: Node, tpu_cfg=None) -> Node:
    """Replace fusable subtrees with single FusedUnit leaves, top-down: the
    largest pure island wins. A no-op when nothing fuses. The fused runtime
    runs on its members' device."""
    sub = _collect(root)
    if sub is not None and sub.n_nodes > 1:
        runtime = ModelRuntime(
            sub.apply_fn,
            sub.params,
            device=sub.device,
            buckets=tuple(getattr(tpu_cfg, "batch_buckets", ()) or ()),
            max_batch=getattr(tpu_cfg, "max_batch", 64),
            dtype=DTYPES.get(getattr(tpu_cfg, "dtype", "float32"), torch.float32),
            class_names=sub.class_names,
            offload_compute=getattr(tpu_cfg, "offload_compute", "auto"),
        )
        runtime.feature_shape = sub.feature_shape
        spec = PredictiveUnit(name=root.name, type=PredictiveUnitType.MODEL)
        unit = FusedUnit(spec, runtime)
        # the members' names survive in requestPath
        members = ",".join(n.name for n in root.walk() if n is not root)
        unit.image = f"fused[{members}]" if len(members) <= 120 else f"fused:{sub.n_models}-models"
        return Node(spec=spec, unit=unit, children=[])

    new_children = [fuse_graph(c, tpu_cfg) for c in root.children]
    if any(a is not b for a, b in zip(new_children, root.children)):
        return Node(spec=root.spec, unit=root.unit, children=new_children)
    return root
