#!/usr/bin/env python3
"""Why the flash kernel re-reads its q fragments from shared memory at every
KV tile, on one NVIDIA Hopper card.

    python3 flash_q_probe.py [--out DIR]   # from the root of a checkout

The natural design holds each thread's Q·Kᵀ A fragments (q scaled and
rounded) in registers across the tile loop. Built by nvcc 12.9 for sm_90a
that design is wrong at head_dim 128 from the second KV tile on: in the
SASS, ptxas gives the loop-carried q fragments the same registers as the
P fragments of P·V and reloads nothing, so from the second tile on the
Q·Kᵀ ``HGMMA`` reads last tile's p. The PTX is right (q and p are distinct
virtual registers, q defined once before the loop and read only by the
``wgmma``), so the fault is ptxas's.

This builds variants of ``seldon_core_tpu_torch/csrc/flash_attention.cu``,
all started together:

  reread       the kernel as committed: q scaled in place in shared memory
               once, its fragments re-read at every tile
  held         fragments scaled into registers once and held across the loop
  held_fenced  held, plus a register fence on them before ``wgmma.fence``
  held_mov     held, copied at every tile by an inline-asm ``mov``
  held_xor     held, copied at every tile through an xor with a zero that
               the compiler cannot prove (``sq >> 31``)

For each bf16 function of each variant's library it prints ptxas's
register and spill report and how many Q·Kᵀ A-fragment registers are
carried around the tile loop and overwritten inside it without a reload
(``clobbered``; the fault when not 0); the kernel against its plain version
on multi-tile d=128 shapes (one and two consumer warpgroups) and d=64, with
random q and with q = 0 (whose scores must all be 0); and, for the variants
right at every case, the kernel's time at the main-path shapes (order
v1 ... vn, vn ... v1 in one process). SASS and PTX go to ``--out``.
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

SCALE_IN_PLACE = """  mbar_wait(q_full, 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 f = Pack<T>::unpack(*q_word(kk, r));
      *q_word(kk, r) = Pack<T>::pack(f.x * scale, f.y * scale);
    }
"""
SCALE_IN_REGS = """  mbar_wait(q_full, 0);
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 f = Pack<T>::unpack(*q_word(kk, r));
      qa[kk][r] = Pack<T>::pack(f.x * scale, f.y * scale);
    }
"""
REREAD = """    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[kk][r] = *q_word(kk, r);
"""
FENCE = "    reg_fence(sc);\n    wgmma_fence();\n"
FENCE_QA = "    reg_fence(sc);\n    reg_fence(qa);\n    wgmma_fence();\n"
COPY_MOV = """    uint32_t qc[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("mov.b32 %0, %1;" : "=r"(qc[kk][r]) : "r"(qa[kk][r]));
"""
COPY_XOR = """    uint32_t qc[D / 16][4];
    const uint32_t opaque_zero = static_cast<uint32_t>(sq) >> 31;  // sq > 0
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) qc[kk][r] = qa[kk][r] ^ opaque_zero;
"""
USE_QA = "wgmma_rs<T, BK, 0>(sc, qa[kk]"
USE_QC = "wgmma_rs<T, BK, 0>(sc, qc[kk]"

CHECKS = [  # name, (b, h, sq, sk, d), causal
    ("d128_2wg_2tiles", (1, 12, 2048, 256, 128), False),
    ("d128_1wg_4tiles", (1, 2, 256, 512, 128), False),
    ("d128_causal_2wg", (1, 12, 2048, 2048, 128), True),
    ("d128_ragged_causal_1wg", (2, 3, 200, 256, 128), True),
    ("d64_2wg", (8, 12, 512, 512, 64), False),
    ("d64_1wg", (1, 12, 512, 512, 64), False),
]
TIMED = [
    ("bucket8", (8, 12, 512, 512, 64), False),
    ("bucket1", (1, 12, 512, 512, 64), False),
    ("seq4096", (1, 12, 4096, 4096, 64), False),
    ("causal_d128", (1, 12, 2048, 2048, 128), True),
]


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the kernel source no longer holds exactly one of:\n{old}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    held = _sub(_sub(src, SCALE_IN_PLACE, SCALE_IN_REGS), REREAD, "")
    held_copy = lambda copy: _sub(  # noqa: E731
        _sub(_sub(src, SCALE_IN_PLACE, SCALE_IN_REGS), REREAD, copy), USE_QA, USE_QC)
    return {
        "reread": src,
        "held": held,
        "held_fenced": _sub(held, FENCE, FENCE_QA),
        "held_mov": held_copy(COPY_MOV),
        "held_xor": held_copy(COPY_XOR),
    }


# ------------------------------------------------------------ SASS reading
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_NO_DEST = ("ST", "STS", "STG", "STL", "BRA", "SYNCS", "BAR", "WARPGROUP", "EXIT", "RET", "CALL", "NOP",
            "YIELD", "BSSY", "BSYNC", "WARPSYNC", "UTMALDG", "DEPBAR", "RED", "MEMBAR", "FENCE", "ERRBAR")


def _written(op: str, operands: list[str]) -> set[int]:
    """Registers an instruction writes: its first operand, widened by the
    opcode's .64 / .128 / WIDE suffix."""
    if op.split(".")[0] in _NO_DEST or op.startswith("HGMMA") or not operands:
        return set()
    m = re.fullmatch(r"R(\d+)", operands[0].split(".")[0])
    if not m:
        return set()
    width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
    return set(range(int(m.group(1)), int(m.group(1)) + width))


def sass_functions(sass: str) -> dict[str, list[tuple[int, str, list[str]]]]:
    """Each function of a ``cuobjdump --dump-sass`` listing as (address,
    opcode, operands) rows, predicates dropped."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, body = part.partition("\n")
        rows = []
        for addr, text in _INSN.findall(body):
            text = re.sub(r"^@!?U?P\w+\s+", "", text)
            op, _, rest = text.partition(" ")
            rows.append((int(addr, 16), op, [o.strip() for o in rest.split(",")] if rest else []))
        out[name.strip()] = rows
    return out


def clobbered_q_registers(rows) -> int | None:
    """Q·Kᵀ A-fragment registers that the tile loop carries into the next
    tile's HGMMA although the loop body overwrites them after it and never
    rewrites them before it. None when the function has no such loop."""
    qk = [(a, ops) for a, op, ops in rows if op.startswith("HGMMA") and "tnspB" not in " ".join(ops)
          and re.fullmatch(r"R\d+", ops[1] if len(ops) > 1 else "")]
    pv = [a for a, op, ops in rows if op.startswith("HGMMA") and "tnspB" in " ".join(ops)]
    if not qk or not pv:
        return None
    loops = [(int(ops[0], 16), a) for a, op, ops in rows
             if op.startswith("BRA") and ops and ops[0].startswith("0x") and int(ops[0], 16) <= qk[0][0]
             and a >= pv[-1]]
    if not loops:
        return None
    start, end = min(loops, key=lambda se: se[1] - se[0])
    bad = set()
    for at, ops in qk:
        regs = set(range(int(ops[1][1:]), int(ops[1][1:]) + 4))
        before = set().union(*[_written(op, o) for a, op, o in rows if start <= a < at])
        after = set().union(*[_written(op, o) for a, op, o in rows if at < a <= end])
        bad |= (regs & after) - before
    return len(bad)


_BF16_BODY = re.compile(r"flash_fwd_wgmmaI13__nv_bfloat16Li(\d+)ELi(\d)E")


def ptxas_report(log: str) -> dict[tuple[str, str], str]:
    """The register and spill lines ptxas -v prints for each bf16 body,
    keyed by (head_dim, warpgroups)."""
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = _BF16_BODY.search(line)
            key = m.groups() if m else None
        elif key and ("spill" in line or "Used" in line):
            out[key] = (out.get(key, "") + " " + line.split(":")[-1].strip()).strip()
    return out


# ------------------------------------------------------------------ driver
def build(out: Path) -> dict[str, Path]:
    from seldon_core_tpu_torch.ops import kernel_build

    nvcc = kernel_build._nvcc()
    procs = {}
    for name, src in variants(SRC.read_text()).items():
        cu, so = out / f"flash_{name}.cu", out / f"libflash_{name}.so"
        cu.write_text(src)
        procs[name] = (
            subprocess.Popen([nvcc, *kernel_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            subprocess.Popen([nvcc, *kernel_build.NVCC_FLAGS[:3], "-ptx", "-o", str(out / f"flash_{name}.ptx"),
                              str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            so,
        )
    libs = {}
    for name, (proc, ptx, so) in procs.items():
        log, _ = proc.communicate()
        ptx.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump", "--dump-sass", str(so)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        (out / f"flash_{name}.sass").write_text(sass)
        report = ptxas_report(log)
        print(f"variant {name}:", flush=True)
        for fn, rows in sass_functions(sass).items():
            m = _BF16_BODY.search(fn)
            if m:
                print(f"    bf16 d={m.group(1)} warpgroups={m.group(2)}: clobbered={clobbered_q_registers(rows)}; "
                      f"ptxas: {report.get(m.groups(), 'no report')}", flush=True)
        libs[name] = so
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(ROOT / "build" / "flash_q_probe"), help="where builds, SASS and PTX go")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_q_probe: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.ops import kernel_build

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(cs.card_line(), flush=True)
    libs = build(out)
    bf16 = torch.bfloat16
    right = {}
    for name, so in libs.items():
        kernel_build._LIBS["flash_attention"] = ctypes.CDLL(str(so))
        g = torch.Generator(device="cuda").manual_seed(1)
        right[name] = True
        for case, (b, h, sq, sk, d), causal in CHECKS:
            q = torch.randn(b, h, sq, d, generator=g, device="cuda").to(bf16)
            k = torch.randn(b, h, sk, d, generator=g, device="cuda").to(bf16)
            v = torch.randn(b, h, sk, d, generator=g, device="cuda").to(bf16)
            for q_kind, qq in (("random_q", q), ("zero_q", torch.zeros_like(q))):
                a = cs.agreement(fa.flash_attention(qq, k, v, causal=causal),
                                 fa.flash_attention_reference(qq, k, v, causal=causal), "bfloat16")
                right[name] &= a["ok"]
                print(f"{name} {case} {q_kind}: ok={a['ok']} max_abs_err={a['max_abs_err']} "
                      f"rel_l2={a['rel_l2']}", flush=True)
    order = [n for n in libs if right[n]]
    times: dict[str, list[float]] = {}
    for name in order + order[::-1]:
        kernel_build._LIBS["flash_attention"] = ctypes.CDLL(str(libs[name]))
        g = torch.Generator(device="cuda").manual_seed(2)
        for case, (b, h, sq, sk, d), causal in TIMED:
            q, k, v = cs.qkv_views(b, h, sq, d, bf16, g)
            ms = cs.device_ms(lambda: fa.flash_attention(q, k, v, causal=causal), reps=50)
            times.setdefault(f"{name} {case}", []).append(ms)
    for key, ms in times.items():
        print(f"ms {key} (QKV views, warm L2; first and second pass): {ms}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
