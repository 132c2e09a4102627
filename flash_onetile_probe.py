#!/usr/bin/env python3
"""The flash kernel's one-tile body on one NVIDIA Hopper card: is it right,
how many stages its ring wants, and where its cut against the wgmma body lies.

    python3 flash_onetile_probe.py [--out DIR] [--quick]   # from the root of a checkout

``csrc/flash_attention.cu``'s ``flash_fwd_onetile`` takes the bf16/f16
calls at head_dim 64 whose keys fit one 128-key tile, not causal, from
``OT_MIN_ITEMS`` (batch x head, q block) items up: the BERT DAG's seq-128
buckets. This builds variants of the committed source, all started
together:

  committed   as committed (a ring of OT_STAGES = 3 stages of 48 KB)
  cut1        the body's rule lowered to one item, so that the sweep can
              time it below the cut
  stages2     a ring of two stages (one item's loads in flight)
  stages4     a ring of four stages (three items' loads in flight)
  divide      o = acc / l by the compiler's division in place of div_rn's
              reciprocal and residual (the same bits, more instructions)
  traced      as committed, plus clock64() marks at the phases of each
              item in CTA 0's two warpgroup leaders and the producer

and prints, in one process on one card: ptxas's report of every
``flash_fwd_onetile`` instance of each variant (the committed ones must
not spill) and how many of its CTAs one SM holds; each variant against the
plain version under ``chip_smoke.KERNEL_TOL`` at the DAG's shapes (QKV
views), fewer keys than a tile (16, 48, 64, 112), ragged and longer q (77
and 300 rows), in bf16 and f16, with two runs' bits compared, its bits
against the wgmma body's, and the call captured in a CUDA graph and
replayed; the refusals (more keys than a tile, causal, head_dim 128,
float32, fewer items than the cut); the variants' times at the DAG's
bucket 64 in turns (committed, stages2, stages4, divide, divide, stages4,
stages2, committed) beside wgmma's and sdpa's; where an item's cycles go
(``traced``, at bucket 64 and at 16 keys: the wait for the stage, q's
fragments, Q·Kᵀ, the softmax, P·V and the store of o, each in SM cycles,
and when the producer started each item's loads); and the sweep: (b, 12, 128, 128, 64)
QKV views for b in 1, 2, 4, 6, 8, 11, 16, 32, 64, and keys 16, 64, 128 at
b = 64, the one-tile body (cut1) against wgmma, sdpa (the yardstick, never
called by the port) and ``chip_smoke.attention_bounds``. CUDA events,
median of 25 calls, as ``chip_smoke.py`` times a kernel. One JSON line per
measurement, the card's name and power limit first. ``--quick`` stops
after the checks. Exits 1 when a check fails (after printing every row).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "seldon_core_tpu_torch" / "csrc" / "flash_attention.cu"

DIV_RN = """  const float q = x * r;
  return fmaf(fmaf(-d, q, x), r, q);
"""

# appended to every variant's build (not to its source): CTAs of the body
# that one SM holds at once
RESIDENT = r"""
extern "C" int onetile_resident_ctas() {
  auto kernel = flash_fwd_onetile<__nv_bfloat16>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, OtCfg::SMEM) != cudaSuccess)
    return -1;
  int n = -1;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, OtCfg::THREADS, OtCfg::SMEM) == cudaSuccess ? n
                                                                                                          : -1;
}
"""
# traced: a clock64() mark before (k) or after each phase of an item, for
# the first TRACE_ITEMS items of CTA 0, in each warpgroup leader
TRACE_ITEMS = 8
TRACE_DEF = """__device__ long long ot_trace[2][8][8], ot_load[8];
#define OT_MARK(k) \\
  do { if (blockIdx.x == 0 && (threadIdx.x & 127) == 0 && n < 8) ot_trace[wg][n][k] = clock64(); } while (0)

"""
TRACE_MARKS = [  # (anchor in the kernel, the anchor with its mark)
    ("template <typename T>\n__global__ void __launch_bounds__(OtCfg::THREADS, 1)",
     TRACE_DEF + "template <typename T>\n__global__ void __launch_bounds__(OtCfg::THREADS, 1)"),
    ("        mbar_expect_tx(bar, C::STAGE_BYTES);\n",
     "        if (blockIdx.x == 0 && n < 8) ot_load[n] = clock64();\n        mbar_expect_tx(bar, C::STAGE_BYTES);\n"),
    ("    mbar_wait(full0 + 8 * s, (n / NS) & 1);\n\n    // this thread's A fragments",
     "    OT_MARK(0);\n    mbar_wait(full0 + 8 * s, (n / NS) & 1);\n    OT_MARK(1);\n\n    // this thread's A fragments"),
    ("    reg_fence(qf);\n    reg_fence(st);\n", "    reg_fence(qf);\n    reg_fence(st);\n    OT_MARK(2);\n"),
    ("    wgmma_wait0();\n    reg_fence(st);\n    reg_fence(qf);\n",
     "    wgmma_wait0();\n    reg_fence(st);\n    reg_fence(qf);\n    OT_MARK(3);\n"),
    ("    reg_fence(pf);\n    reg_fence(acc);\n", "    reg_fence(pf);\n    reg_fence(acc);\n    OT_MARK(4);\n"),
    ("    mbar_arrive(empty0 + 8 * s);  // q, K and V of this stage are read\n",
     "    OT_MARK(5);\n    mbar_arrive(empty0 + 8 * s);  // q, K and V of this stage are read\n"),
    ("      bulk_commit();\n    }\n  }\n  if (leader) bulk_wait_all();",
     "      bulk_commit();\n    }\n    OT_MARK(6);\n  }\n  if (leader) bulk_wait_all();"),
]
TRACE_READ = """
extern "C" int onetile_read_trace(long long* out) {
  if (cudaMemcpyFromSymbol(out, ot_trace, sizeof(ot_trace)) != cudaSuccess) return 1;
  return cudaMemcpyFromSymbol(out + 2 * 8 * 8, ot_load, sizeof(ot_load)) != cudaSuccess;
}
"""
PHASES = ("wait_stage", "q_fragments", "qk", "softmax", "pv", "store")

# name: (b, h, sq, sk, QKV views)
CHECKS = {
    "dag_b64_views": (64, 12, 128, 128, True),
    "dag_b16_views": (16, 12, 128, 128, True),
    "sk16": (64, 12, 128, 16, False),
    "sk48_sq77": (64, 12, 77, 48, False),
    "sk64": (64, 12, 128, 64, False),
    "sk112_sq300": (32, 12, 300, 112, False),
    "dag_b1_views": (1, 12, 128, 128, True),  # below the cut: cut1 takes it, the committed rule refuses
}
SWEEP_BATCH = (1, 2, 4, 6, 8, 11, 16, 32, 64)
SWEEP_KEYS = (16, 64, 128)


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the kernel source no longer holds exactly one occurrence of:\n{old}")
    return src.replace(old, new)


def _set(src: str, name: str, value: int) -> str:
    """``src`` with the constant ``name`` set to ``value``."""
    pattern = rf"constexpr int {name} = \d+;"
    if len(re.findall(pattern, src)) != 1:
        raise ValueError(f"the kernel source no longer holds exactly one occurrence of {pattern}")
    return re.sub(pattern, f"constexpr int {name} = {value};", src)


def variants(src: str) -> dict[str, str]:
    """The committed source and its five variants."""
    traced = src
    for old, new in TRACE_MARKS:
        traced = _sub(traced, old, new)
    return {"committed": src,
            "cut1": _set(src, "OT_MIN_ITEMS", 1),
            "stages2": _set(src, "OT_STAGES", 2),
            "stages4": _set(src, "OT_STAGES", 4),
            "divide": _sub(src, DIV_RN, "  return x / d;\n"),
            "traced": traced + TRACE_READ}


def build(out: Path) -> tuple[dict[str, Path], dict[str, dict]]:
    """Every variant's library, built in parallel; ptxas's report of each
    variant's one-tile bodies."""
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import kernel_build

    for header in SRC.parent.glob("*.cuh"):  # the variants include them from beside themselves
        (out / header.name).write_bytes(header.read_bytes())
    procs = {}
    for name, src in variants(SRC.read_text()).items():
        cu, so = out / f"flash_{name}.cu", out / f"libflash_{name}.so"
        cu.write_text(src + RESIDENT)
        procs[name] = (subprocess.Popen([kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, reports = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = so
        reports[name] = cs.ptxas_report(log, ("flash_fwd_onetile",))
    return libs, reports


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(ROOT / "build" / "flash_onetile_probe"))
    parser.add_argument("--quick", action="store_true", help="stop after the checks")
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_onetile_probe: this probe needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.ops import kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    paths, reports = build(out)
    failed = []
    libs = {name: ctypes.CDLL(str(path)) for name, path in paths.items()}
    for name, report in reports.items():  # the committed body must not spill; a variant may
        fn = libs[name].onetile_resident_ctas
        fn.restype, fn.argtypes = ctypes.c_int, []
        print(json.dumps({"ptxas": name, "resident_ctas_per_sm": fn(), **report}), flush=True)
        if name == "committed" and (len(report) != 2 or any("0 bytes spill stores" not in r
                                                             for r in report.values())):
            failed.append(f"ptxas {name}")

    def use(name):
        kernel_build._LIBS["flash_attention"] = libs[name]
        fa._lib()

    def inputs(b, h, sq, sk, views, dtype, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        if views:
            return cs.qkv_views(b, h, sq, 64, dtype, g)
        return tuple(torch.randn(b, h, s, 64, generator=g, device="cuda").to(dtype) for s in (sq, sk, sk))

    def onetile(q, k, v):
        return fa._launch(q, k, v, False, body="onetile")

    for variant in ("committed", "cut1", "stages2", "stages4", "divide", "traced"):
        use(variant)
        for dtype in (torch.bfloat16, torch.float16):
            dtype_name = str(dtype).removeprefix("torch.")
            for name, (b, h, sq, sk, views) in CHECKS.items():
                q, k, v = inputs(b, h, sq, sk, views, dtype, b + sq + sk)
                row = {"check": name, "variant": variant, "shape": [b, h, sq, sk, 64], "dtype": dtype_name,
                       "select_body": fa.body_for(q, k)}
                below_cut = b * h * -(-sq // fa.Q_BLOCK) < fa.ONETILE_MIN_ITEMS
                try:
                    y = onetile(q, k, v)
                    again = onetile(q, k, v)
                    torch.cuda.synchronize()
                    agree = cs.agreement(y, fa.flash_attention_reference(q, k, v), dtype_name)
                    row.update(ok=agree["ok"], max_abs_err=agree["max_abs_err"], atol=agree["atol"],
                               rel_l2=agree["rel_l2"], same_bits=bool(torch.equal(y, again)),
                               same_bits_as_wgmma=bool(torch.equal(y, fa._launch(q, k, v, False, body="wgmma"))))
                    if name == "dag_b64_views":  # a captured launch replays the eager bits
                        graph, static = torch.cuda.CUDAGraph(), {}
                        with torch.cuda.graph(graph):
                            static["y"] = onetile(q, k, v)
                        graph.replay()
                        torch.cuda.synchronize()
                        row["graph_same_bits"] = bool(torch.equal(static["y"], y))
                except RuntimeError as err:
                    row.update(ok=False, error=str(err)[:300])
                print(json.dumps(row), flush=True)
                if below_cut and variant != "cut1":  # the rule refuses it
                    if "error" not in row:
                        failed.append(f"{variant} {name} {dtype_name} below the cut was not refused")
                elif not (row["ok"] and row.get("same_bits") and row.get("graph_same_bits", True)):
                    failed.append(f"{variant} {name} {dtype_name}")
        # past the rule: more keys than a tile, causal, head_dim 128, float32
        refused = {}
        g = torch.Generator(device="cuda").manual_seed(3)
        calls = {
            "sk256": lambda: onetile(*inputs(64, 12, 128, 256, False, torch.bfloat16, 1)),
            "causal": lambda: fa._launch(*inputs(64, 12, 128, 128, False, torch.bfloat16, 2), True, body="onetile"),
            "d128": lambda: onetile(*(torch.randn(64, 12, 128, 128, generator=g, device="cuda").to(torch.bfloat16)
                                      for _ in range(3))),
            "float32": lambda: onetile(*inputs(64, 12, 128, 128, False, torch.float32, 4)),
        }
        for label, call in calls.items():
            try:
                call()
                refused[label] = False
            except RuntimeError:
                refused[label] = True
        print(json.dumps({"refusals": variant, **refused}), flush=True)
        if not all(refused.values()):
            failed.append(f"{variant} refusals {refused}")
    if args.quick:
        print(json.dumps({"failed": failed}), flush=True)
        return 1 if failed else 0

    use("traced")
    read = libs["traced"].onetile_read_trace
    read.restype, read.argtypes = ctypes.c_int, [ctypes.POINTER(ctypes.c_longlong)]
    for name, (b, h, sq, sk, views) in (("dag_b64_views", CHECKS["dag_b64_views"]), ("sk16", CHECKS["sk16"])):
        q, k, v = inputs(b, h, sq, sk, views, torch.bfloat16, 11)
        for _ in range(5):  # the marks of the last call stay
            onetile(q, k, v)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (2 * 8 * 8 + 8))()
        if read(buf) != 0:
            failed.append("trace readback")
            continue
        marks, loads = list(buf[:2 * 8 * 8]), list(buf[2 * 8 * 8:])
        n_items = -(-b * h * -(-sq // fa.Q_BLOCK) // min(b * h * -(-sq // fa.Q_BLOCK), 132))
        for wg in range(2):
            per_item = []
            for n in range(min(n_items, TRACE_ITEMS)):
                m = marks[(wg * 8 + n) * 8:(wg * 8 + n) * 8 + 7]
                per_item.append({phase: m[i + 1] - m[i] for i, phase in enumerate(PHASES)})
            print(json.dumps({"trace": name, "shape": [b, h, sq, sk, 64], "warpgroup": wg, "cycles_by_item": per_item,
                              "first_mark_after_first_load": marks[wg * 64] - loads[0],
                              "last_mark_after_first_load": marks[(wg * 8 + min(n_items, TRACE_ITEMS) - 1) * 8 + 6]
                              - loads[0]}), flush=True)
        print(json.dumps({"trace": name, "producer_load_after_first": [t - loads[0] for t in loads[:n_items]]}),
              flush=True)

    def timed(q, k, v):
        b, h, sq, d = q.shape
        bound, by = cs.attention_bounds(b, h, sq, k.shape[2], d, "bfloat16", False)["bfloat16"]
        return {"wgmma_ms": cs.device_ms(lambda: fa._launch(q, k, v, False, body="wgmma")),
                "library_ms": cs.device_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                "bound_ms": bound, "bound_by": by}

    order = ("committed", "stages2", "stages4", "divide")
    q, k, v = inputs(64, 12, 128, 128, True, torch.bfloat16, 7)
    row = {"case": "dag_b64_views", "shape": [64, 12, 128, 128, 64], "dtype": "bfloat16", "ms": {}}
    for variant in (*order, *reversed(order)):
        use(variant)
        row["ms"].setdefault(variant, []).append(cs.device_ms(lambda: onetile(q, k, v)))
    use("committed")
    print(json.dumps({**row, **timed(q, k, v)}), flush=True)

    use("cut1")
    for b in SWEEP_BATCH:
        q, k, v = inputs(b, 12, 128, 128, True, torch.bfloat16, b)
        print(json.dumps({"sweep": "batch", "shape": [b, 12, 128, 128, 64], "layout": "qkv_views",
                          "items": b * 12, "onetile_ms": cs.device_ms(lambda: onetile(q, k, v)), **timed(q, k, v)}),
              flush=True)
    for sk in SWEEP_KEYS:
        q, k, v = inputs(64, 12, 128, sk, False, torch.bfloat16, sk)
        print(json.dumps({"sweep": "keys", "shape": [64, 12, 128, sk, 64], "layout": "contiguous",
                          "items": 64 * 12, "onetile_ms": cs.device_ms(lambda: onetile(q, k, v)),
                          **timed(q, k, v)}), flush=True)
    fill = torch.empty(1, device="cuda")
    print(json.dumps({"launch_floor_ms": cs.device_ms(lambda: fill.fill_(1.0)), "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
