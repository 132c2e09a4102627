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
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a dict / list / tuple tree."""
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
    does); integer leaves keep their own dtype. ``layout`` maps each numpy
    leaf to the port's layout first (a tensor or an array; the memory format
    of a tensor it returns is kept)."""

    def leaf(a):
        if isinstance(a, torch.Tensor):
            t = a
        else:
            a = np.asarray(a)
            t = layout(a) if layout is not None else a
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.array(t, copy=True))
        if t.is_floating_point():
            return t.to(device=device, dtype=dtype)
        return t.to(device=device)

    return tree_map(leaf, tree)


def params_to_numpy(tree: Any) -> Any:
    """Tensor leaves -> host numpy; floating leaves come back as float32
    (numpy has no bfloat16)."""

    def leaf(t):
        if isinstance(t, torch.Tensor):
            t = t.detach()
            if t.is_floating_point():
                t = t.float()
            return t.cpu().numpy()
        return np.asarray(t)

    return tree_map(leaf, tree)
