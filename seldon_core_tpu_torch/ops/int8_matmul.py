"""W8A16 matmul: the hand-written CUDA kernel and its plain version.

``int8_matmul(x, q, scale, bias)`` computes ``x @ W + bias`` with ``W[k, n]
= cast(float32(q[k, n]) * scale[n])`` in ``x``'s dtype: the JAX package's
``quant.dequantize`` followed by the matmul, element by element (every body
of the kernel forms the same W bit for bit). That pair has no Pallas
kernel: in ``seldon_core_tpu/models/base.py:137-168`` the
dequantize runs inside ``jit`` and XLA fuses ``q * scale`` into the
matmul's operand read, so the full-precision weight never reaches device
memory. Eager PyTorch has no such fusion (``x @ dequantize(q)`` would read 1
byte, write 2 and read 2 again per weight, against 2 for plain bf16), so
the port's counterpart of that fusion is ``csrc/int8_matmul.cu``.

On a CUDA tensor the wrapper launches the kernel (built for sm_90a at first
use) or raises; it never falls back to dequantize-then-matmul. On a CPU
tensor it computes ``int8_matmul_reference``, the plain version, which the
CPU tests hold against the JAX package and ``chip_smoke.py`` holds the
kernel against on the card.

The kernel has six bodies, and ``select_body`` names the one a call
takes before the launch, from the shape, dtype, strides and base addresses
alone: ``splitk`` (narrow outputs, N <= ``NARROW_MAX_N``, or up to
``NARROW_FEW_ROWS_MAX_N`` for at most ``FEW_ROWS`` rows, every dtype: the
BERT head, iris), ``fewrows`` (at most ``FEW_ROWS_WIDE`` rows past the
narrow cut, every dtype and stride: a decode step's projections, BERT's
pooler), ``wgmma`` (TMA and wgmma, bf16/f16 operands that TMA can
address: every bf16 projection of BERT-base), ``tf32x2`` (the same for
float32: two tf32 wgmma passes over the split x, q exact), ``mma``
(mma.sync, bf16/f16 of any shape: misaligned views) and ``fma`` (float32
of any shape). A body that cannot take the call makes the launch fail,
and the wrapper raises: no call is retried on another body.

Under ``vmap`` the wrapper goes through a ``torch.library`` custom op with
a vmap rule, so a fused ensemble of quantized members (``engine/fused.py``
vmaps the members' apply) launches the kernel once for all members: the
rule maps the stacked member axis onto the kernel's member dimension (grid
z), and an input shared by every member goes in once, with a member stride
of 0. Outside any functorch transform it calls the launch directly, which
saves the op's dispatch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from seldon_core_tpu_torch.ops.flash_attention import LaunchCounter, refuse_autograd

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BODY_CODES = {"fma": 0, "mma": 1, "wgmma": 2, "splitk": 3, "tf32x2": 4, "fewrows": 5}
# launches of the kernel, in all and by body (compare-only launches
# included; callers reset the counters around the run they want to read)
LAUNCHES = LaunchCounter()
LAUNCHES_BY_BODY = {body: LaunchCounter() for body in _BODY_CODES}
# The narrow body takes outputs up to one column group of its CTA at any
# row count, and up to four groups for a few rows; the tiled bodies' 128-
# row tiles win past that (PERF.md, the W8A16 table, has the times).
NARROW_MAX_N = 8
NARROW_FEW_ROWS_MAX_N, FEW_ROWS = 32, 128
# Past the narrow cut, calls of at most this many rows take the few-rows
# body: a cluster of CTAs along K shares q's bytes, where the tiled bodies'
# 128-row tiles leave the card a few CTAs (PERF.md, the sweep of M).
FEW_ROWS_WIDE = 32


def reset_launches() -> None:
    LAUNCHES.reset()
    for counter in LAUNCHES_BY_BODY.values():
        counter.reset()


def select_body(m: int, n: int, k: int, dtype: torch.dtype, x_strides: tuple, q_member_stride: int,
                x_ptr: int, q_ptr: int) -> str:
    """The kernel body for one launch over x [E, M, K] and q [E, K, N]:
    ``x_strides`` are x's member and row strides in elements as the kernel
    takes them (a member stride of 0 shares one x), ``q_member_stride`` q's
    (0 shares one q), the pointers the operands' first bytes.

    Outputs of at most NARROW_MAX_N columns, or NARROW_FEW_ROWS_MAX_N for
    at most FEW_ROWS rows, take ``splitk`` in every dtype; wider ones of at
    most FEW_ROWS_WIDE rows ``fewrows``, whatever their strides. Otherwise
    ``wgmma`` (bf16/f16) and ``tf32x2`` (float32) read x and q through
    TMA, which needs 16-byte-aligned bases and global strides that are
    multiples of 16 bytes: K and x's strides in multiples of 16 bytes (8
    bf16/f16 elements, 4 floats), rows at least K apart, N and q's member
    stride in multiples of 16 bytes. Other bf16/f16 calls take ``mma``,
    other float32 calls ``fma``."""
    if n <= NARROW_MAX_N or (n <= NARROW_FEW_ROWS_MAX_N and m <= FEW_ROWS):
        return "splitk"
    if m <= FEW_ROWS_WIDE:
        return "fewrows"
    x_member, x_row = x_strides
    per16 = 4 if dtype == torch.float32 else 8  # elements in 16 bytes
    if (k > 0 and k % per16 == 0 and x_row % per16 == 0 and x_row >= k and x_member % per16 == 0
            and x_ptr % 16 == 0 and n % 16 == 0 and q_member_stride % 16 == 0 and q_ptr % 16 == 0):
        return "tf32x2" if dtype == torch.float32 else "wgmma"
    return "fma" if dtype == torch.float32 else "mma"


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch: ``x @ dequantize(q, scale, x.dtype) + bias`` with x
    [..., K], q int8 [K, N], scale float32 with N elements, bias [N]."""
    w = (q.float() * scale.reshape(1, -1)).to(x.dtype)
    y = x @ w
    return y if bias is None else y + bias.to(x.dtype)


def _batched_reference(x, q, scale, bias):
    """The plain version over a member axis: x [E, M, K], q [E, K, N],
    scale [E, N], bias [E, N] or None."""
    w = (q.float() * scale[:, None, :]).to(x.dtype)
    y = torch.matmul(x, w)
    return y if bias is None else y + bias[:, None, :].to(x.dtype)


def _lib() -> ctypes.CDLL:
    from seldon_core_tpu_torch.ops import kernel_build

    lib = kernel_build.load("int8_matmul")
    fn = lib.int8_matmul
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # x
            ctypes.c_void_p,  # q
            ctypes.c_void_p,  # scale
            ctypes.c_void_p,  # bias (NULL: none)
            ctypes.c_void_p,  # y
            ctypes.c_int,  # E
            ctypes.c_int,  # M
            ctypes.c_int,  # N
            ctypes.c_int,  # K
            ctypes.c_longlong,  # x member stride (0: shared)
            ctypes.c_longlong,  # x row stride
            ctypes.c_longlong,  # q member stride
            ctypes.c_longlong,  # scale member stride
            ctypes.c_longlong,  # bias member stride
            ctypes.c_int,  # dtype code
            ctypes.c_int,  # body code
            ctypes.c_void_p,  # cudaStream_t
        ]
    return lib


def _member_stride(t: torch.Tensor) -> int:
    return t.stride(0) if t.shape[0] > 1 else 0


def _kernel_strides(x: torch.Tensor, q: torch.Tensor) -> tuple:
    """x's member and row strides and q's member stride, in elements, as
    the kernel takes them for x [E, M, K] and q [E, K, N]."""
    m, k = x.shape[1], x.shape[2]
    return (_member_stride(x), x.stride(1) if m > 1 else k), _member_stride(q)


def body_for(x: torch.Tensor, q: torch.Tensor) -> str:
    """``select_body`` for x [E, M, K] and q [E, K, N] as the wrapper hands
    them to the kernel."""
    x_strides, q_es = _kernel_strides(x, q)
    return select_body(x.shape[1], q.shape[2], x.shape[2], x.dtype, x_strides, q_es, x.data_ptr(), q.data_ptr())


def _launch(x, q, scale, bias, body: Optional[str] = None) -> torch.Tensor:
    """One launch; ``body`` None takes ``select_body``'s choice, a name
    forces that body (chip_smoke.py times one body against the other) and
    raises where it cannot take the call."""
    e, m, k = x.shape
    n = q.shape[2]
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_matmul kernel takes {list(_DTYPE_CODES)} activations, got {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"int8_matmul kernel needs an int8 payload and float32 scales, got {q.dtype}, {scale.dtype}")
    if bias is not None and bias.dtype != x.dtype:
        raise ValueError(f"int8_matmul kernel needs the bias in {x.dtype}, got {bias.dtype}")
    for name, t in (("q", q), ("scale", scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.stride(2) != 1 and k > 1:
        raise ValueError(f"int8_matmul kernel needs x with a last-dimension stride of 1, got {x.stride()}")
    if q.stride(2) != 1 or (k > 1 and q.stride(1) != n):
        raise ValueError(f"int8_matmul kernel needs q rows contiguous [K, N], got strides {q.stride()}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and n > 1 and t.stride(1) != 1:
            raise ValueError(f"int8_matmul kernel needs a contiguous {name} row, got strides {t.stride()}")
    if m > 65535 * 64:
        raise ValueError(f"int8_matmul kernel takes at most {65535 * 64} rows, got {m}")
    y = torch.empty(e, m, n, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    x_strides, q_es = _kernel_strides(x, q)
    if body is None:
        body = select_body(m, n, k, x.dtype, x_strides, q_es, x.data_ptr(), q.data_ptr())
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int8_matmul(
            x.data_ptr(),
            q.data_ptr(),
            scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            y.data_ptr(),
            e,
            m,
            n,
            k,
            *x_strides,
            q_es,
            _member_stride(scale),
            0 if bias is None else _member_stride(bias),
            _DTYPE_CODES[x.dtype],
            _BODY_CODES[body],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed ({body} body, x {tuple(x.shape)} strides "
                           f"{x.stride()}, q {tuple(q.shape)}, {x.dtype}): cudaError {err}")
    LAUNCHES.add()
    LAUNCHES_BY_BODY[body].add()
    return y


def _batched(x, q, scale, bias):
    """x [E, M, K] (a member stride of 0 shares one x), q [E, K, N], scale
    [E, N], bias [E, N] or None -> y [E, M, N]."""
    if x.device.type == "cpu":
        return _batched_reference(x, q, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu tensors, got {x.device}")
    return _launch(x, q, scale, bias)


def _one_member(x, q, scale, bias):
    k = x.shape[-1]
    y = _batched(
        x.reshape(1, -1, k),
        q.unsqueeze(0),
        scale.reshape(1, -1),
        None if bias is None else bias.reshape(1, -1),
    )
    return y.reshape(*x.shape[:-1], y.shape[-1])


# the op's namespace stays out of the ``seldon_tpu_*`` metric namespace that
# ``metrics/registry.py`` owns (lint RD002)
@torch.library.custom_op("seldon_torch::int8_matmul", mutates_args=())
def _int8_matmul_op(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor]
) -> torch.Tensor:
    return _one_member(x, q, scale, bias)


@_int8_matmul_op.register_fake
def _(x, q, scale, bias):
    return x.new_empty(*x.shape[:-1], q.shape[-1])


def _vmap_rule(info, in_dims, x, q, scale, bias):
    """The stacked member axis becomes the kernel's member dimension. An
    unbatched operand is expanded to it with stride 0, never copied: in a
    fused ensemble the input is shared by every member."""
    e = info.batch_size
    xd, qd, sd, bd = in_dims

    def members(t, dim):
        return t.movedim(dim, 0) if dim is not None else t.unsqueeze(0).expand(e, *t.shape)

    x = members(x, xd)
    lead = x.shape[1:-1]
    y = _batched(
        x.reshape(e, -1, x.shape[-1]),
        members(q, qd),
        members(scale, sd).reshape(e, -1),
        None if bias is None else members(bias, bd).reshape(e, -1),
    )
    return y.reshape(e, *lead, y.shape[-1]), 0


torch.library.register_vmap("seldon_torch::int8_matmul", _vmap_rule)


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., K] in float32 / bfloat16 / float16, q int8 [K, N], scale
    float32 with N elements (the quantized leaf's [1, N]), bias [N] or None
    -> [..., N] in x's dtype, accumulated in float32. Raises under
    autograd (``refuse_autograd``): the kernel has no backward."""
    refuse_autograd("int8_matmul", x, scale, bias)
    if q.dim() != 2 or x.shape[-1] != q.shape[0] or scale.numel() != q.shape[1]:
        raise ValueError(
            f"int8_matmul: x {tuple(x.shape)}, q {tuple(q.shape)} and scale {tuple(scale.shape)} disagree"
        )
    if bias is not None:
        bias = bias.to(x.dtype)
    if torch._C._are_functorch_transforms_active():
        return _int8_matmul_op(x, q, scale, bias)  # vmap reaches the kernel through the op's rule
    # the op's dispatch costs tens of microseconds of host time a call, and
    # a served BERT-base forward makes 49 of them
    return _one_member(x, q, scale, bias)
