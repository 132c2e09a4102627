"""Weight-only int8 quantization for serving (opt-in, per-channel).

Port of ``seldon_core_tpu/models/quant.py``. Scheme, as there: symmetric
per-channel (last axis) int8, ``w ~= q * scale`` with ``scale = max|w| /
127`` per output column. Quantized: floating leaves with ndim >= 2 and a
leading dim <= 8192 (matmul and convolution kernels). Exact: biases and
norm vectors (ndim 1) and big gathered tables (vocab embeddings).

``quantize_params`` is the JAX package's numpy code, so its int8 payloads
and float32 scales are bit-identical to the reference's. A quantized leaf
is the marker dict ``{"__int8_weight__": int8[...], "scale": f32[1.., N]}``
in both packages.

Where the JAX package dequantizes inside ``jit`` and lets XLA fuse
``q * scale`` into the matmul's operand read, the port hands a quantized
matmul operand to the hand-written W8A16 kernel (``ops/int8_matmul.py``),
which dequantizes in registers. ``dequantize`` here is for the operands
that are not matmuls: embedding rows (``embed`` dequantizes only the rows
it gathers) and convolution kernels.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_QKEY = "__int8_weight__"

_MAX_LEAD_DIM = 8192  # above this the leaf is a gathered table, not a kernel


def _eligible(a: np.ndarray) -> bool:
    a = np.asarray(a)
    return a.ndim >= 2 and a.dtype.kind == "f" and a.shape[0] <= _MAX_LEAD_DIM


def is_quantized_leaf(x: Any) -> bool:
    return isinstance(x, dict) and _QKEY in x


def quantize_params(params: Any) -> Any:
    """float tree -> tree where eligible leaves become
    {_QKEY: int8[...], "scale": f32[1.., out]} marker dicts (everything else
    unchanged). Idempotent: quantized leaves pass through."""

    def quant(a):
        if is_quantized_leaf(a):
            return a
        a = np.asarray(a)
        if not _eligible(a):
            return a
        amax = np.max(np.abs(a), axis=tuple(range(a.ndim - 1)), keepdims=True)
        scale = (amax / 127.0 + 1e-30).astype(np.float32)
        q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
        return {_QKEY: q, "scale": scale.astype(np.float32)}

    from seldon_core_tpu_torch.models.convert import tree_map  # late import: convert imports this module

    return tree_map(quant, params)


def payload(leaf: dict) -> torch.Tensor:
    """The int8 payload of a quantized leaf."""
    return leaf[_QKEY]


def dequantize(leaf: Any, dtype: torch.dtype) -> Any:
    """A quantized leaf as a ``dtype`` tensor: multiply in float32, THEN
    cast (rounding the float32 scale to bf16 first would add error of the
    int8 step's size). Anything else passes through."""
    if not is_quantized_leaf(leaf):
        return leaf
    return (leaf[_QKEY].float() * leaf["scale"]).to(dtype)


def embed(table: Any, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows ``ids`` of an embedding table as ``dtype``. A quantized table
    gathers its int8 rows and dequantizes only those (the same values as
    gathering from the dequantized table, without materializing it)."""
    if is_quantized_leaf(table):
        return (table[_QKEY][ids].float() * table["scale"]).to(dtype)
    return table[ids].to(dtype)


def quantized_pspecs(pspecs: Any, params: Any) -> Any:
    """Mirror a partition-spec tree (``parallel/mesh.py::P``) onto the
    quantized structure: a leaf's spec applies to its int8 payload, and its
    per-channel scale goes with the payload's columns. The JAX package
    replicates every scale and lets GSPMD slice it where the dequant meets
    a column shard; the port hands each position's W8A16 call the scales of
    its own columns, so a scale splits where the payload's last axis splits
    (a column-parallel leaf) and replicates otherwise (a row-parallel one)."""
    from seldon_core_tpu_torch.parallel.mesh import P

    def expand(spec, leaf):
        if is_quantized_leaf(leaf):
            return quantized_leaf_spec(spec, leaf)
        if isinstance(leaf, dict):
            return {k: expand(spec.get(k) if isinstance(spec, dict) else None, v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            subs = spec if isinstance(spec, (list, tuple)) and not isinstance(spec, P) else [None] * len(leaf)
            return [expand(sp, v) for sp, v in zip(subs, leaf)]
        return spec

    return expand(pspecs, params)


def quantized_leaf_spec(spec: Any, leaf: dict) -> dict:
    """One quantized leaf's ``{payload spec, scale spec}`` from the spec of
    the float leaf it replaced (None replicates)."""
    from seldon_core_tpu_torch.parallel.mesh import P

    spec = spec if isinstance(spec, P) else P()
    ndim = len(leaf[_QKEY].shape)
    last = spec[ndim - 1] if len(spec) >= ndim else None
    scale_ndim = len(leaf["scale"].shape)
    return {_QKEY: spec, "scale": P(*([None] * (scale_ndim - 1)), last) if last is not None else P()}


def quantized_nbytes(leaf: Any, nonquant_factor: float = 1.0) -> int:
    """Residency of one param leaf under this scheme: eligible kernels store
    int8 payload + per-channel f32 scales; other leaves follow the compute
    dtype (``nonquant_factor``, e.g. 0.5 for bf16)."""
    a = np.asarray(leaf)
    if _eligible(a):
        return int(a.size + a.shape[-1] * 4)
    return int(a.nbytes * nonquant_factor)
