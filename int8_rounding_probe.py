#!/usr/bin/env python3
"""What the W8A16 kernel's rounding point costs, on one card.

    python3 int8_rounding_probe.py        # from the root of a checkout

``csrc/int8_matmul.cu``'s wgmma body rounds every weight W = T(q * scale)
before the product, as the plain version and the JAX package do: one FMUL
per weight while it builds its fragments. The alternative scales the
float32 sums in the epilogue, one FMUL per output. This builds that
alternative from the committed source (two substitutions), then, in one
process on one card:

- times both at BERT-base's four bucket-32 projections, in turns (kept,
  scaled, scaled, kept; CUDA events, median of 25 calls each, as
  ``chip_smoke.py`` times a kernel);
- holds both against the plain version at the same shapes under
  ``chip_smoke.py``'s KERNEL_TOL, and on unit-scale weights (the case of
  ``tests/test_torch_int8_gpu.py``) under that test's elementwise bound.

Prints one JSON line per measurement and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "seldon_core_tpu_torch" / "csrc" / "int8_matmul.cu"
# the fragments take the weights unscaled (an exact integer in T) ...
KEPT_BUILD = "dequant4<T>(__byte_perm(lo, hi, 0x5140), s0, s1, af[kk][2 * half], af[kk][2 * half + 1]);"
SCALED_BUILD = "dequant4<T>(__byte_perm(lo, hi, 0x5140), 1.f, 1.f, af[kk][2 * half], af[kk][2 * half + 1]);"
# ... and the epilogue scales the sums
KEPT_STORES = ("pack2(acc[4 * j] + b0, acc[4 * j + 2] + b1,", "pack2(acc[4 * j + 1] + b0, acc[4 * j + 3] + b1,")
SCALED_STORES = ("pack2(fmaf(acc[4 * j], s0, b0), fmaf(acc[4 * j + 2], s1, b1),",
                 "pack2(fmaf(acc[4 * j + 1], s0, b0), fmaf(acc[4 * j + 3], s1, b1),")
SHAPES = {"qkv": (4096, 768, 2304), "attn_out": (4096, 768, 768), "mlp_in": (4096, 768, 3072),
          "mlp_out": (4096, 3072, 768)}
UNIT_CASE = (64, 768, 2304)  # tests/test_torch_int8_gpu.py's bf16 case
UNIT_TOL = 2e-2  # its BF16_ATOL, as rtol and atol


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the kernel source no longer holds exactly one of:\n{old}")
    return src.replace(old, new)


def scaled_in_epilogue(src: str) -> str:
    """The wgmma body with the scale moved from the weights to the sums."""
    src = _sub(src, KEPT_BUILD, SCALED_BUILD)
    for old, new in zip(KEPT_STORES, SCALED_STORES):
        src = _sub(src, old, new)
    return src


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("int8_rounding_probe: this probe needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import int8_matmul as i8
    from seldon_core_tpu_torch.ops import kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False  # the plain version sums in f32
    card = cs.card_line()
    print(card, flush=True)
    out = ROOT / "build" / "int8_rounding"
    out.mkdir(parents=True, exist_ok=True)
    for header in SRC.parent.glob("*.cuh"):
        (out / header.name).write_bytes(header.read_bytes())
    cu, so = out / "int8_scaled_in_epilogue.cu", out / "libint8_scaled_in_epilogue.so"
    cu.write_text(scaled_in_epilogue(SRC.read_text()))
    proc = subprocess.Popen([kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    kernel_build.build(("int8_matmul",))
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"the variant did not build:\n{log}")
    libs = {"kept": i8._lib(), "scaled": ctypes.CDLL(str(so))}

    rng = np.random.default_rng(0)
    cases = {}
    for name, (m, k, n) in SHAPES.items():
        qw, sc = cs.int8_weights(k, n, rng)
        cases[name] = (torch.from_numpy(rng.standard_normal((1, m, k)).astype(np.float32)).cuda().bfloat16(),
                       torch.from_numpy(qw)[None].cuda(), torch.from_numpy(sc).reshape(1, n).cuda(),
                       (torch.randn(1, n, device="cuda") * 0.1).bfloat16())
    m, k, n = UNIT_CASE  # unit-scale weights, as tests/test_torch_int8_gpu.py draws them
    from seldon_core_tpu_torch.models import quant

    leaf = quant.quantize_params({"w": rng.standard_normal((k, n)).astype(np.float32)})["w"]
    unit = (torch.randn(1, m, k, device="cuda").bfloat16(), torch.from_numpy(quant.payload(leaf))[None].cuda(),
            torch.from_numpy(leaf["scale"]).reshape(1, n).cuda(), torch.randn(1, n, device="cuda").bfloat16())

    times = {side: {name: [] for name in SHAPES} for side in libs}
    for side in ("kept", "scaled", "scaled", "kept"):
        kernel_build._LIBS["int8_matmul"] = libs[side]
        i8._lib()  # binds the argument types on this handle
        for name, (x, q, s, b) in cases.items():
            times[side][name].append(cs.device_ms(lambda: i8._launch(x, q, s, b, body="wgmma")))
    for side, lib in libs.items():
        kernel_build._LIBS["int8_matmul"] = lib
        i8._lib()
        for name, (x, q, s, b) in cases.items():
            agree = cs.agreement(i8._launch(x, q, s, b, body="wgmma"), i8._batched_reference(x, q, s, b), "bfloat16")
            print(json.dumps({"side": side, "case": name, "ms": times[side][name],
                              "max_abs_err": agree["max_abs_err"], "rel_l2": agree["rel_l2"],
                              "within_kernel_tol": agree["ok"]}), flush=True)
        x, q, s, b = unit
        got, want = i8._launch(x, q, s, b, body="wgmma").float(), i8._batched_reference(x, q, s, b).float()
        outside = (got - want).abs() > UNIT_TOL + UNIT_TOL * want.abs()
        print(json.dumps({"side": side, "case": "unit_scale_weights", "shape": [1, m, k, n],
                          "max_abs_err": (got - want).abs().max().item(),
                          "share_outside_test_bound": outside.float().mean().item()}), flush=True)
    kernel_build._LIBS.pop("int8_matmul")
    return 0


if __name__ == "__main__":
    sys.exit(main())
