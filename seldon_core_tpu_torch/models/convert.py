"""Parameter trees between the JAX package's layout and the port's.

The JAX package keeps a model's parameters as a tree of dicts and lists
whose leaves are arrays (``jax.tree.map(np.asarray, params)`` gives the
numpy form). The port keeps the same tree with torch tensors as leaves, so
one numpy draw feeds both packages and the tests compare like with like.
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


def params_to_torch(tree: Any, device: torch.device, dtype: torch.dtype = torch.float32) -> Any:
    """numpy (or tensor) leaves -> tensors on ``device``. Floating leaves
    take ``dtype`` (rounded to nearest even, as ``jnp.asarray(a, dtype)``
    does); integer leaves keep their own dtype."""

    def leaf(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, copy=True))
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
