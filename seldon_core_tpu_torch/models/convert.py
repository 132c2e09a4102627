"""Parameter trees between the JAX package's layout and the port's.

The JAX package keeps a model's parameters as a tree of dicts and lists
whose leaves are arrays (``jax.tree.map(np.asarray, params)`` gives the
numpy form). The port keeps the same tree with torch tensors as leaves, so
one numpy draw feeds both packages and the tests compare like with like.

A numpy leaf is in the JAX package's layout; a model whose torch functions
want another (ResNet's convolution kernels: HWIO there, OIHW here) names a
``layout`` function, which ``params_to_torch`` applies to each numpy leaf
once, at load. A tensor leaf is already in the port's layout and is only
moved and cast.

A weight-only int8 leaf (``models/quant.py``) moves as a unit: the layout
applies to its payload and to its scale alike (a convolution's HWIO payload
and (1, 1, 1, O) scale become OIHW and (O, 1, 1, 1) under one transpose),
the payload stays int8 and the scale stays float32 — cast to bf16 it would
lose the per-channel precision the scheme keeps.

``carry_params`` takes the JAX package's parameters of a model in place of
the port's own draw, after checking them leaf for leaf against it: the
models whose JAX init draws with ``jax.random`` (iris, MNIST, and the mesh
models ``moe_mlp`` — its experts stacked [E, ...] — and ``pipe_mlp`` — its
stages stacked [S, ...], one stage per "pipe" position) serve the same
weights in both packages that way.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from seldon_core_tpu_torch.models.quant import is_quantized_leaf


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a dict / list / tuple tree; a quantized
    marker dict is one leaf."""
    if is_quantized_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_to_torch(
    tree: Any,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
    layout: Callable[[np.ndarray], Any] | None = None,
) -> Any:
    """numpy (or tensor) leaves -> tensors on ``device``. Floating leaves
    take ``dtype`` (rounded to nearest even, as ``jnp.asarray(a, dtype)``
    does); integer leaves keep their own dtype, and so do the float32
    scales of quantized leaves. ``layout`` maps each numpy leaf to the
    port's layout first (a tensor or an array; the memory format of a
    tensor it returns is kept)."""

    def place(a):
        if isinstance(a, torch.Tensor):
            return a
        a = np.asarray(a)
        t = layout(a) if layout is not None else a
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t, copy=True))
        return t

    def leaf(a):
        if is_quantized_leaf(a):
            return {k: place(v).to(device=device) for k, v in a.items()}
        t = place(a)
        if t.is_floating_point():
            return t.to(device=device, dtype=dtype)
        return t.to(device=device)

    return tree_map(leaf, tree)


def params_to_numpy(tree: Any) -> Any:
    """Tensor leaves -> host numpy; floating leaves come back as float32
    (numpy has no bfloat16); a quantized leaf keeps its int8 payload and
    float32 scale."""

    def leaf(t):
        if is_quantized_leaf(t):
            return {k: leaf(v) for k, v in t.items()}
        if isinstance(t, torch.Tensor):
            t = t.detach()
            if t.is_floating_point():
                t = t.float()
            return t.cpu().numpy()
        return np.asarray(t)

    return tree_map(leaf, tree)


def carry_params(own: Any, other: Any) -> Any:
    """``other`` (a tree of numpy arrays or tensors, e.g. ``jax.tree.map(
    np.asarray, params)`` of the JAX package's build) as numpy leaves in
    ``own``'s place. Raises ValueError where the two trees differ in
    structure, or a leaf in shape or dtype: a stacked axis that does not
    match (experts, pipe stages) is caught here, not at serving."""

    def walk(a, b, path):
        if isinstance(a, dict):
            if not isinstance(b, dict) or a.keys() != b.keys():
                raise ValueError(f"{path or 'params'}: keys {sorted(b) if isinstance(b, dict) else type(b).__name__} "
                                 f"where the port's build has {sorted(a)}")
            return {k: walk(a[k], b[k], f"{path}/{k}") for k in a}
        if isinstance(a, (list, tuple)):
            if not isinstance(b, (list, tuple)) or len(a) != len(b):
                raise ValueError(f"{path}: a list of another length than the port's build")
            return type(a)(walk(x, y, f"{path}/{i}") for i, (x, y) in enumerate(zip(a, b)))
        b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        a = np.asarray(a)
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"{path}: {b.dtype}{list(b.shape)} where the port's build has {a.dtype}{list(a.shape)}")
        return b

    return walk(own, other, "")
