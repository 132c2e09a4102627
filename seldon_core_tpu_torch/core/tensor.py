"""Tensor bridge: host numpy <-> torch tensors on a device, batch buckets.

Port of ``seldon_core_tpu/core/tensor.py``. Requests arrive as host numpy
arrays and are padded to a batch bucket on the host, so every forward runs
at one of a few fixed batch sizes; ``to_device`` / ``to_host`` move them
across an explicit ``torch.device``.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when the card is asked for and none is visible — the
    port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device`` (dtype kept)."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def to_host(array: Any) -> np.ndarray:
    """Tensor on any device (or array-like) -> host numpy. Blocks until the
    device has produced the value."""
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def pad_batch(array: np.ndarray, target_batch: int, axis: int = 0) -> tuple[np.ndarray, int]:
    """Pad ``axis`` up to ``target_batch`` with zeros; returns (padded, valid_n)."""
    n = array.shape[axis]
    if n > target_batch:
        raise ValueError(f"batch {n} exceeds bucket {target_batch}")
    if n == target_batch:
        return array, n
    shape = list(array.shape)
    shape[axis] = target_batch
    out = np.zeros(shape, dtype=array.dtype)
    sl = [slice(None)] * array.ndim
    sl[axis] = slice(0, n)
    out[tuple(sl)] = array
    return out, n


def bucket_for(n: int, buckets: Sequence[int]) -> int | None:
    """Smallest bucket >= n, or None if n exceeds the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    return None


def default_buckets(max_batch: int) -> tuple[int, ...]:
    """Power-of-two buckets up to max_batch: 1, 2, 4, ..., max_batch."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)
