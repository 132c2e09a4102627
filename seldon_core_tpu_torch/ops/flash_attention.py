"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

Port of ``seldon_core_tpu/ops/pallas_flash.py::flash_attention``. On a CUDA
tensor the wrapper launches ``csrc/flash_attention.cu`` (built for sm_90a at
first use) or raises; it never falls back. On a CPU tensor it computes
``flash_attention_reference``, the plain PyTorch version with the kernel's
rounding points, which the tests hold against the JAX kernel in interpret
mode and ``chip_smoke.py`` holds the kernel against on the card.

The kernel reads q, k and v through their strides, so the head-split views
of a fused QKV projection go in without a copy (``check_kernel_layout``
says what it takes), and it writes its output as [batch, seq, heads,
head_dim] in memory, returned as the [batch, heads, seq, head_dim] view: the
caller's merge of the heads is then a view too.

The keyword surface is the JAX wrapper's. ``block_q`` and ``block_k`` keep
only their contract: ``block_k`` decides which KV lengths are rejected as
ragged (``_kv_block``), exactly as on the TPU. The CUDA kernel tiles by its
own fixed sizes (64 or 128 q rows x 128 keys for bf16/f16), masks ragged
edges itself, and ignores both.

The kernel has three bodies, and ``select_body`` names the one a call
takes before the launch, from the shape, dtype and causal flag alone:
``f32`` (float32), ``onetile`` (bf16/f16 at head_dim 64 whose keys fit
one 128-key tile, not causal, with at least ``ONETILE_MIN_ITEMS`` (batch x
head, 128-row q block) items: the BERT DAG's seq-128 buckets past the cut)
and ``wgmma`` (every other bf16/f16 call). A body that cannot take the
call makes the launch fail, and the wrapper raises: no call is retried on
another body.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

NEG_INF = -1e30
# the JAX wrapper's default KV block; the bert routing policy reuses it as
# the single-block-fit bound for KV lengths that are not 128-multiples
DEFAULT_BLOCK_K = 2048
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BODY_CODES = {"wgmma": 0, "f32": 1, "onetile": 2}
Q_BLOCK = 128  # q rows of the bf16/f16 bodies' largest block: an item of the one-tile body
# The one-tile body takes keys that fit one tile, from this many items up;
# below, the two bodies time within 1% of each other (csrc/flash_attention.cu's
# OT_MAX_KEYS and OT_MIN_ITEMS; PERF.md, the flash_onetile_probe.py sweep,
# has the times that set the cut).
ONETILE_MAX_KEYS = 128
ONETILE_MIN_ITEMS = 64


class LaunchCounter:
    """How many times a wrapper launched its kernel (compare-only launches
    included; callers reset it around the run they want to read). A replayed
    CUDA graph adds the launches it holds (``ops/graphs.py``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.count += n

    def reset(self) -> None:
        with self._lock:
            self.count = 0


# launches of the kernel, in all and by body (compare-only launches
# included; callers reset the counters around the run they want to read)
LAUNCHES = LaunchCounter()
LAUNCHES_BY_BODY = {body: LaunchCounter() for body in _BODY_CODES}


def reset_launches() -> None:
    LAUNCHES.reset()
    for counter in LAUNCHES_BY_BODY.values():
        counter.reset()


def select_body(b: int, h: int, sq: int, sk: int, d: int, dtype: torch.dtype, causal: bool) -> str:
    """The kernel body for q [b, h, sq, d] over sk keys: ``f32`` for
    float32; ``onetile`` for bf16/f16 at head_dim 64 with at most
    ONETILE_MAX_KEYS keys, not causal, and at least ONETILE_MIN_ITEMS
    (batch x head, Q_BLOCK-row q block) items; ``wgmma`` otherwise."""
    if dtype == torch.float32:
        return "f32"
    items = b * h * -(-sq // Q_BLOCK)
    if d == 64 and sk <= ONETILE_MAX_KEYS and not causal and items >= ONETILE_MIN_ITEMS:
        return "onetile"
    return "wgmma"


def body_for(q: torch.Tensor, k: torch.Tensor, causal: bool = False) -> str:
    """``select_body`` for q [b, h, sq, d] and k [b, h, sk, d]."""
    b, h, sq, d = q.shape
    return select_body(b, h, sq, k.shape[2], d, q.dtype, causal)


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when autograd would have to pass through a kernel that has no
    backward: grad mode on and an input that requires grad. The kernel's
    output would carry no ``grad_fn`` and the gradient would stop there
    without a word, so the call fails by name on every route, the CPU's
    plain version included (the JAX package's Pallas kernel has no backward
    either, and a gradient through it fails there too)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward kernel (nor has the kernel it ports): it cannot run under autograd on "
            "inputs that require grad; call it under torch.no_grad(), or train a model whose forward does "
            "not reach it"
        )


def _kv_block(sk: int, requested: int) -> int:
    """Largest power-of-two block <= requested that divides sk (any
    128-multiple sk admits 128) — the JAX kernel's tiling rule, kept as the
    port's shape contract."""
    if sk <= 0:
        raise ValueError(f"kv seq must be positive, got {sk}")
    b = min(requested, sk)
    while b > 128 and sk % b:
        b //= 2
    if sk % b:
        raise ValueError(
            f"kv seq {sk} must be a multiple of 128 (pad inputs before "
            "calling, or use blockwise_attention)"
        )
    return b


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False
) -> torch.Tensor:
    """Plain PyTorch attention with the kernel's rounding points: q scaled
    in f32 and rounded to its dtype, products of input-dtype values summed in
    f32, softmax statistics in f32, p rounded to v's dtype before PV, rows
    with l == 0 divided by 1, output rounded to q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = (q.float() * scale).to(q.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l).to(q.dtype)


def check_kernel_layout(name: str, t: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernel can read ``t`` where it lies:
    a last dimension of stride 1, every other stride a multiple of 8
    elements, and a 16-byte aligned base (TMA's rules: its global strides
    are multiples of 16 bytes). The stride of a dimension of size 1 is never
    used and not checked. Plain Python, so it runs on CPU tensors too."""
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention kernel needs {name} with a last-dimension stride of 1, got {t.stride()}")
    for size, stride in zip(t.shape[:-1], t.stride()[:-1]):
        if size > 1 and stride % 8:
            raise ValueError(f"flash_attention kernel needs {name} strides that are multiples of 8 elements, got {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention kernel needs a 16-byte aligned {name}")


def _kernel_strides(t: torch.Tensor) -> list[int]:
    """(batch, head, seq) element strides of a [b, h, s, d] view; a
    dimension of size 1 gets d, a legal stride that is never stepped."""
    return [st if size > 1 else t.shape[-1] for size, st in zip(t.shape[:3], t.stride()[:3])]


def _lib() -> ctypes.CDLL:
    from seldon_core_tpu_torch.ops import kernel_build

    lib = kernel_build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # q
            ctypes.c_void_p,  # k
            ctypes.c_void_p,  # v
            ctypes.c_void_p,  # o
            ctypes.c_int,  # batch
            ctypes.c_int,  # heads
            ctypes.c_int,  # sq
            ctypes.c_int,  # sk
            ctypes.c_int,  # head_dim
            ctypes.c_int,  # dtype code
            ctypes.c_float,  # scale
            ctypes.c_int,  # causal
            ctypes.POINTER(ctypes.c_longlong),  # 12 strides: (b, h, s) of q, k, v, o
            ctypes.c_int,  # body code
            ctypes.c_void_p,  # cudaStream_t
        ]
    return lib


def _launch(q, k, v, causal: bool, body: str | None = None) -> torch.Tensor:
    """One launch; ``body`` None takes ``select_body``'s choice, a name
    forces that body (chip_smoke.py times one body against the other) and
    raises where it cannot take the call."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head_dim {HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel supports {list(_DTYPE_CODES)}, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} differs from q dtype {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_kernel_layout(name, t)
    out = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in _kernel_strides(t)))
    if body is None:
        body = select_body(b, h, sq, sk, d, q.dtype, causal)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            b,
            h,
            sq,
            sk,
            d,
            _DTYPE_CODES[q.dtype],
            1.0 / math.sqrt(d),
            int(causal),
            strides,
            _BODY_CODES[body],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({body} body, q {tuple(q.shape)}, sk {sk}, "
                           f"{q.dtype}, causal {causal}): cudaError {err}")
    LAUNCHES.add()
    LAUNCHES_BY_BODY[body].add()
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    block_q: int = 512,
    block_k: int = DEFAULT_BLOCK_K,
    causal: bool = False,
) -> torch.Tensor:
    """q,k,v: [batch, heads, seq, head_dim] -> [batch, heads, sq, head_dim]
    (on the card, a view of a [batch, sq, heads, head_dim] tensor).

    ``causal=True`` masks columns past each row (top-left aligned) and the
    kernel skips KV tiles wholly above the diagonal. Raises ``ValueError``
    on KV lengths the JAX kernel rejects as ragged, and ``RuntimeError``
    under autograd (``refuse_autograd``): there is no backward."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected 4-D q and equal-shape k/v, got {q.shape}, {k.shape}, {v.shape}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch/heads/head_dim")
    if block_q <= 0:
        raise ValueError(f"block_q must be positive, got {block_q}")
    refuse_autograd("flash_attention", q, k, v)
    _kv_block(k.shape[2], block_k)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    return _launch(q, k, v, causal)
