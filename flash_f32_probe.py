#!/usr/bin/env python3
"""How the float32 flash body accumulates its 3xTF32 products, on one
NVIDIA Hopper card.

    python3 flash_f32_probe.py [--out DIR]   # from the root of a checkout

``flash_fwd_f32`` (``seldon_core_tpu_torch/csrc/flash_attention.cu``) forms
q·Kᵀ and P·V as three tf32 mma.sync passes each. The tensor cores add into
the accumulator they are given with truncation, so where the partial sums
go decides how far the result drifts from the float32 plain version. This
builds variants of the committed kernel, all started together:

  committed       each 8-wide d step of S in a fresh accumulator folded
                  into S by an f32 add; P·V per tile and n-tile pair in a
                  fresh accumulator added to O once per tile
  s_chained       S's passes chained over all of d into S itself
  s_o_chained     that, and P·V chained into the running O over every key

For each it prints ptxas's register and spill report of each float32 body,
the kernel against its plain version (TF32 off) under
``chip_smoke.KERNEL_TOL["float32"]`` at the serving and edge shapes, and
the kernel's time at the serving shapes in turns (v1 ... vn, vn ... v1),
beside sdpa's and both of ``chip_smoke.attention_bounds``'s bounds.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "seldon_core_tpu_torch" / "csrc" / "flash_attention.cu"

S_FRESH = """          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(part, qsml, kb0, kb1);
          mma_tf32(part, qbig, ks0, ks1);
          mma_tf32(part, qbig, kb0, kb1);
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] += part[e];
"""
S_CHAINED = """          mma_tf32(sc[nt], qsml, kb0, kb1);
          mma_tf32(sc[nt], qbig, ks0, ks1);
          mma_tf32(sc[nt], qbig, kb0, kb1);
"""
O_FRESH = "        float pe[4] = {0.f, 0.f, 0.f, 0.f}, po[4] = {0.f, 0.f, 0.f, 0.f};\n"
O_CHAINED = "        float(&pe)[4] = acc[2 * i];\n        float(&po)[4] = acc[2 * i + 1];\n"
O_ADD = """#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[2 * i][e] += pe[e];
          acc[2 * i + 1][e] += po[e];
        }
"""

# (name, (b, h, sq, sk, d), causal): the soak's buckets, the decoder's
# prefill, d = 128, and the ragged and causal edges
CHECKS = [
    ("soak_b64", (64, 12, 512, 512, 64), False),
    ("soak_b16", (16, 12, 512, 512, 64), False),
    ("soak_b1", (1, 12, 512, 512, 64), False),
    ("prefill_4096_causal", (1, 12, 4096, 4096, 64), True),
    ("d128_b2", (2, 12, 512, 512, 128), False),
    ("d128_b8", (8, 12, 512, 512, 128), False),
    ("ragged_sk200_causal", (2, 3, 256, 200, 64), True),
    ("below_tile_sk48", (2, 3, 77, 48, 128), True),
    ("causal_sk_gt_sq", (2, 3, 300, 1024, 64), True),
]
TIMED = CHECKS[:6]


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"expected one occurrence in the kernel source of:\n{old}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    s_chained = _sub(src, S_FRESH, S_CHAINED)
    return {
        "committed": src,
        "s_chained": s_chained,
        "s_o_chained": _sub(_sub(s_chained, O_FRESH, O_CHAINED), O_ADD, ""),
    }


def build(out: Path) -> dict[str, Path]:
    from flash_q_probe import ptxas_report_f32
    from seldon_core_tpu_torch.ops import kernel_build

    nvcc = kernel_build._nvcc()
    for header in SRC.parent.glob("*.cuh"):  # the variants include them from beside themselves
        shutil.copy(header, out / header.name)
    procs = {}
    for name, src in variants(SRC.read_text()).items():
        cu, so = out / f"flash_{name}.cu", out / f"libflash_{name}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen([nvcc, *kernel_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        for (d, warps), line in ptxas_report_f32(log).items():
            print(f"variant {name} f32 d={d} warps={warps}: ptxas: {line}", flush=True)
        sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump", "--dump-sass", str(so)],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        tf32 = sorted(set(re.findall(r"HMMA\.[\w.]*TF32", sass)))
        print(f"variant {name} tf32 mma in SASS: {tf32}, {sum(sass.count(m) for m in tf32)} instructions", flush=True)
        libs[name] = so
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(ROOT / "build" / "flash_f32_probe"), help="where the builds go")
    args = parser.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_f32_probe: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.ops import kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(cs.card_line(), flush=True)
    libs = build(out)
    for name, so in libs.items():
        kernel_build._LIBS["flash_attention"] = ctypes.CDLL(str(so))
        g = torch.Generator(device="cuda").manual_seed(1)
        for case, (b, h, sq, sk, d), causal in CHECKS:
            q, k, v = (torch.randn(b, h, s, d, generator=g, device="cuda") for s in (sq, sk, sk))
            a = cs.agreement(fa.flash_attention(q, k, v, causal=causal),
                             fa.flash_attention_reference(q, k, v, causal=causal), "float32")
            print(f"{name} {case}: ok={a['ok']} max_abs_err={a['max_abs_err']:.3g} (atol {a['atol']:.3g}) "
                  f"rel_l2={a['rel_l2']:.3g}", flush=True)
    order = list(libs)
    times: dict[str, list[float]] = {}
    for name in order + order[::-1]:
        kernel_build._LIBS["flash_attention"] = ctypes.CDLL(str(libs[name]))
        g = torch.Generator(device="cuda").manual_seed(2)
        for case, (b, h, sq, sk, d), causal in TIMED:
            q, k, v = cs.qkv_views(b, h, sq, d, torch.float32, g)
            times.setdefault(f"{case} {name}", []).append(cs.device_ms(lambda: fa.flash_attention(q, k, v, causal=causal)))
    g = torch.Generator(device="cuda").manual_seed(2)
    for case, (b, h, sq, sk, d), causal in TIMED:
        q, k, v = cs.qkv_views(b, h, sq, d, torch.float32, g)
        times[f"{case} sdpa"] = [cs.device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))]
        bounds = {r: round(ms, 4) for r, (ms, _) in cs.attention_bounds(b, h, sq, sk, d, "float32", causal).items()}
        print(f"bounds {case} (QKV views): {bounds}", flush=True)
    for key, ms in times.items():
        print(f"ms {key} (QKV views, warm L2; first and second pass): {[round(t, 4) for t in ms]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
