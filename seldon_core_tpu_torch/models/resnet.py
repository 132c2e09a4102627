"""ResNet (18/34/50/101) as PyTorch functions on a parameter tree.

Port of ``seldon_core_tpu/models/resnet.py``. ``init_resnet``,
``fold_batchnorm`` and ``space_to_depth_stem`` are the JAX package's numpy
code, so a seed gives bit-identical parameters in the JAX layout (HWIO
convolution kernels). ``conv_layout`` turns each kernel into OIHW in
channels_last memory once, at load (``models/convert.py``).

Serving contract, as in the JAX package: ``apply_resnet(params, x)`` with x
images [batch, H, W, 3] (NHWC) -> [batch, num_classes] probabilities. The
image becomes an NCHW view by ``permute`` (channels_last strides, no copy),
and every activation stays channels_last. Convolutions are ``F.conv2d``
(cuDNN on the card): the JAX package computes them with XLA's
``conv_general_dilated``, not in a Pallas kernel, so a library call is the
faithful port.

Padding is XLA's SAME, which is asymmetric: ``total = max((out - 1) *
stride + k - in, 0)`` split as ``(total // 2, total - total // 2)``. The
7x7/2 stem on 224 pads (2, 3), a 3x3/2 conv or the 3x3/2 max-pool on an even
input (0, 1). ``F.conv2d(padding=3)`` gives the same output shape shifted by
a pixel, so asymmetric padding goes through ``F.pad`` (``-inf`` for the
pool); symmetric padding stays inside the convolution.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.models.zoo import ModelSpec, register_model, softmax_f32

# stage depths for the resnet family
_DEPTHS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
_BOTTLENECK = {50: True, 101: True, 18: False, 34: False}


def _conv_init(rng: np.random.Generator, h, w, c_in, c_out):
    fan_in = h * w * c_in
    scale = (2.0 / fan_in) ** 0.5
    return (rng.standard_normal((h, w, c_in, c_out)) * scale).astype(np.float32)


def _bn_init(c):
    return {
        "scale": np.ones((c,), np.float32),
        "bias": np.zeros((c,), np.float32),
        "mean": np.zeros((c,), np.float32),
        "var": np.ones((c,), np.float32),
    }


# (conv key, unfolded bn key, folded bias key) triples for one block
_FOLD_KEYS = (
    ("conv1", "bn1", "bias1"),
    ("conv2", "bn2", "bias2"),
    ("conv3", "bn3", "bias3"),
    ("proj", "bn_proj", "bias_proj"),
)


def fold_batchnorm(params: dict, eps: float = 1e-5) -> dict:
    """Fold inference-mode BN into the preceding conv's weights (host-side,
    in float64): conv(x, W)*s + t == conv(x, W*s) + t for the per-channel
    affine s = scale/sqrt(var+eps), t = bias - mean*s. Idempotent."""

    def fold(kernel, bn):
        inv = np.asarray(bn["scale"], np.float64) / np.sqrt(np.asarray(bn["var"], np.float64) + eps)
        w = (np.asarray(kernel, np.float64) * inv).astype(np.float32)
        b = (np.asarray(bn["bias"], np.float64) - np.asarray(bn["mean"], np.float64) * inv).astype(np.float32)
        return w, b

    out: dict[str, Any] = {"head": params["head"]}
    stem = params["stem"]
    if "bn" in stem:
        w, b = fold(stem["conv"], stem["bn"])
        out["stem"] = {"conv": w, "bias": b}
    else:
        out["stem"] = stem
    stage = 0
    while f"stage{stage}" in params:
        blocks = []
        for bp in params[f"stage{stage}"]:
            nb: dict[str, Any] = {}
            for conv_key, bn_key, bias_key in _FOLD_KEYS:
                if conv_key not in bp:
                    continue
                if bn_key in bp:
                    nb[conv_key], nb[bias_key] = fold(bp[conv_key], bp[bn_key])
                else:  # already folded
                    nb[conv_key] = bp[conv_key]
                    nb[bias_key] = bp[bias_key]
            blocks.append(nb)
        out[f"stage{stage}"] = blocks
        stage += 1
    return out


def _bottleneck_init(rng, c_in, c_mid, stride):
    c_out = c_mid * 4
    p = {
        "conv1": _conv_init(rng, 1, 1, c_in, c_mid),
        "bn1": _bn_init(c_mid),
        "conv2": _conv_init(rng, 3, 3, c_mid, c_mid),
        "bn2": _bn_init(c_mid),
        "conv3": _conv_init(rng, 1, 1, c_mid, c_out),
        "bn3": _bn_init(c_out),
    }
    if stride != 1 or c_in != c_out:
        p["proj"] = _conv_init(rng, 1, 1, c_in, c_out)
        p["bn_proj"] = _bn_init(c_out)
    return p


def _basic_init(rng, c_in, c_out, stride):
    p = {
        "conv1": _conv_init(rng, 3, 3, c_in, c_out),
        "bn1": _bn_init(c_out),
        "conv2": _conv_init(rng, 3, 3, c_out, c_out),
        "bn2": _bn_init(c_out),
    }
    if stride != 1 or c_in != c_out:
        p["proj"] = _conv_init(rng, 1, 1, c_in, c_out)
        p["bn_proj"] = _bn_init(c_out)
    return p


def init_resnet(
    seed: int = 0,
    depth: int = 50,
    num_classes: int = 1000,
    width: int = 64,
    image_size: int = 224,
) -> dict:
    rng = np.random.default_rng(seed)
    depths = _DEPTHS[depth]
    bottleneck = _BOTTLENECK[depth]
    expansion = 4 if bottleneck else 1
    block_init = _bottleneck_init if bottleneck else _basic_init

    params: dict[str, Any] = {
        "stem": {"conv": _conv_init(rng, 7, 7, 3, width), "bn": _bn_init(width)},
    }
    c_in = width
    for stage, n_blocks in enumerate(depths):
        c_mid = width * (2**stage)
        stride = 1 if stage == 0 else 2
        blocks = []
        for b in range(n_blocks):
            blocks.append(block_init(rng, c_in, c_mid, stride if b == 0 else 1))
            c_in = c_mid * expansion
        params[f"stage{stage}"] = blocks
    scale = (1.0 / c_in) ** 0.5
    params["head"] = {
        "w": (rng.standard_normal((c_in, num_classes)) * scale).astype(np.float32),
        "b": np.zeros((num_classes,), np.float32),
    }
    return params


def space_to_depth_stem(params: dict) -> dict:
    """Re-express the 7x7/stride-2 stem conv as 4x4/stride-1 on a 2x2
    space-to-depth input (host-side, exact): w'[P,Q,(a,b,c),o] =
    w[2P+a, 2Q+b, c, o] (zero where 2P+a > 6), and explicit padding (1, 2)
    replaces SAME's pixel-space (2, 3). Requires a folded stem; no-op if
    already transformed."""
    stem = params["stem"]
    if "bn" in stem:
        raise ValueError("space_to_depth_stem requires fold_batchnorm first")
    w = np.asarray(stem["conv"], np.float32)
    if w.shape[:3] == (4, 4, 12):  # already transformed
        return params
    if w.shape[:3] != (7, 7, 3):
        raise ValueError(f"unexpected stem kernel shape {w.shape}")
    c_out = w.shape[3]
    w2 = np.zeros((4, 4, 12, c_out), np.float32)
    for big_p in range(4):
        for big_q in range(4):
            for a in range(2):
                for b in range(2):
                    p, q = 2 * big_p + a, 2 * big_q + b
                    if p > 6 or q > 6:
                        continue
                    for c in range(3):
                        w2[big_p, big_q, a * 6 + b * 3 + c] = w[p, q, c]
    out = dict(params)
    out["stem"] = {"conv": w2, "bias": stem["bias"]}
    return out


def conv_layout(a: np.ndarray):
    """The port's layout of one numpy leaf: an HWIO convolution kernel
    becomes an OIHW tensor in channels_last memory; anything else is kept."""
    if a.ndim != 4:
        return a
    return torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1))).contiguous(
        memory_format=torch.channels_last
    )


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dimension (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1, bias=None, pads=None):
    """x [N, C, H, W] (channels_last), w OIHW; SAME padding unless ``pads``
    gives ((top, bottom), (left, right))."""
    if pads is None:
        pads = (_same_pads(x.shape[2], w.shape[2], stride), _same_pads(x.shape[3], w.shape[3], stride))
    (top, bottom), (left, right) = pads
    b = None if bias is None else bias.to(x.dtype)
    if top == bottom and left == right:
        return F.conv2d(x, w.to(x.dtype), b, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w.to(x.dtype), b, stride=stride)


def _channel(v, x):
    """A per-channel vector [C] broadcast over [N, C, H, W]."""
    return v.to(x.dtype)[:, None, None]


def _conv_norm(x, p, conv_key, bn_key, bias_key, stride=1, pads=None, eps=1e-5):
    """Conv then its normalisation: BN when unfolded, the folded bias (added
    inside the convolution) when folded. The tree's keys decide."""
    if bn_key not in p:
        return _conv(x, p[conv_key], stride, bias=p[bias_key], pads=pads)
    y = _conv(x, p[conv_key], stride, pads=pads)
    bn = p[bn_key]
    inv = torch.rsqrt(_channel(bn["var"], y) + eps)
    scale = _channel(bn["scale"], y) * inv
    return y * scale + (_channel(bn["bias"], y) - _channel(bn["mean"], y) * scale)


def _bottleneck_apply(p, x, stride):
    y = torch.relu(_conv_norm(x, p, "conv1", "bn1", "bias1"))
    y = torch.relu(_conv_norm(y, p, "conv2", "bn2", "bias2", stride))
    y = _conv_norm(y, p, "conv3", "bn3", "bias3")
    if "proj" in p:
        x = _conv_norm(x, p, "proj", "bn_proj", "bias_proj", stride)
    return torch.relu(x + y)


def _basic_apply(p, x, stride):
    y = torch.relu(_conv_norm(x, p, "conv1", "bn1", "bias1", stride))
    y = _conv_norm(y, p, "conv2", "bn2", "bias2")
    if "proj" in p:
        x = _conv_norm(x, p, "proj", "bn_proj", "bias_proj", stride)
    return torch.relu(x + y)


def _space_to_depth(x):
    """[N, 2H, 2W, C] -> [N, H, W, 4C] in space_to_depth_stem's (a, b, c)
    channel order; even H and W required (the transformed stem's (1, 2)
    block padding equals SAME's (2, 3) pixel padding only then)."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(
            f"space-to-depth stem requires even spatial dims, got {h}x{w}; "
            "build the model with space_to_depth=False for odd image sizes"
        )
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def _max_pool_same(h):
    """3x3/2 max-pool with SAME padding by -inf (XLA's reduce_window)."""
    (top, bottom), (left, right) = _same_pads(h.shape[2], 3, 2), _same_pads(h.shape[3], 3, 2)
    return F.max_pool2d(F.pad(h, (left, right, top, bottom), value=float("-inf")), 3, 2)


def resnet_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [batch, H, W, 3] float -> logits [batch, num_classes]."""
    bottleneck = "conv3" in params["stage0"][0]
    block_apply = _bottleneck_apply if bottleneck else _basic_apply
    stem = params["stem"]
    if stem["conv"].shape[1] == 12:  # space-to-depth stem (OIHW: I is dim 1)
        h = _conv_norm(_space_to_depth(x).permute(0, 3, 1, 2), stem, "conv", "bn", "bias",
                       pads=((1, 2), (1, 2)))
    else:
        h = _conv_norm(x.permute(0, 3, 1, 2), stem, "conv", "bn", "bias", stride=2)
    h = _max_pool_same(torch.relu(h))
    stage = 0
    while f"stage{stage}" in params:
        for b, bp in enumerate(params[f"stage{stage}"]):
            h = block_apply(bp, h, 2 if (stage > 0 and b == 0) else 1)
        stage += 1
    h = h.mean(dim=(2, 3))  # global average pool
    return h @ params["head"]["w"].to(h.dtype) + params["head"]["b"].to(h.dtype)


def apply_resnet(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Serving entrypoint: softmax probabilities (float32)."""
    return softmax_f32(resnet_logits(params, x))


def _resnet_spec(params, image_size, num_classes) -> ModelSpec:
    return ModelSpec(
        apply_resnet,
        params,
        (image_size, image_size, 3),
        tuple(f"class_{i}" for i in range(num_classes)),
        layout=conv_layout,
    )


@register_model("resnet50")
def build_resnet50(
    seed: int = 0,
    num_classes: int = 1000,
    depth: int = 50,
    width: int = 64,
    image_size: int = 224,
    fold_bn: bool = True,
    space_to_depth: bool = False,
    **_,
) -> ModelSpec:
    params = init_resnet(seed, depth=depth, num_classes=num_classes, width=width)
    if fold_bn:
        params = fold_batchnorm(params)
    if space_to_depth:
        params = space_to_depth_stem(params)
    return _resnet_spec(params, image_size, num_classes)


@register_model("resnet_tiny")
def build_resnet_tiny(
    seed: int = 0,
    num_classes: int = 10,
    fold_bn: bool = True,
    space_to_depth: bool = False,
    **_,
) -> ModelSpec:
    """Small resnet (depth-18, width-16, 32x32) for tests."""
    params = init_resnet(seed, depth=18, num_classes=num_classes, width=16)
    if fold_bn:
        params = fold_batchnorm(params)
    if space_to_depth:
        params = space_to_depth_stem(params)
    return _resnet_spec(params, 32, num_classes)
