#!/usr/bin/env python3
"""The W8A16 kernel's few-rows body on one NVIDIA Hopper card: is it right,
how wide its channel tile, and where its cut against the tiled bodies lies.

    python3 int8_fewrows_probe.py [--out DIR] [--quick]   # from the root of a checkout

``csrc/int8_matmul.cu``'s ``fewrows_body`` takes the calls of at most
``FEW_ROWS_WIDE`` rows past the narrow cut (a decode step's projections,
BERT's pooler). This builds variants of the committed source, all started
together:

  committed   as committed (32 output channels per CTA, 4-byte q loads, two
              k16 steps a warp)
  rows128     the body's rule raised to 128 rows (row groups of 32 past 32
              rows), so that the sweep can time it past the cut
  ch64        64 channels per CTA (8-byte q loads): half the CTAs
  steps1      one k16 step a warp: twice the warps a CTA

and prints, in one process on one card: ptxas's report of every
``fewrows_body`` instance of each variant (the committed ones must not
spill); each
variant against the plain version under ``chip_smoke.KERNEL_TOL`` at the
decode step's shapes, the pooler's, ragged N and K, three stacked members
(shared and per-member x), no bias, x rows off 8 bytes, in bf16, f16 and
float32, with two runs' bits compared and the call captured in a CUDA
graph and replayed; how many clusters of each variant can be active at
once (``cudaOccupancyMaxActiveClusters`` at the launcher's CTA for K 768
and 3072, 8 and 32 rows); the variants' times at GPT-2-small's four projections
on 8 and 32 rows and the pooler's, in turns (committed, ch64, steps1, steps1,
ch64, committed); and the sweep: M over 1, 2, 4, 8, 16, 24, 32, 48, 64, 128 at the four
projections (BERT-base's widths are GPT-2-small's), bf16, the few-rows body
(rows128) against ``wgmma``, ``torch.addmm`` on the dequantized weight and
``chip_smoke.int8_bounds``. CUDA events, median of 25 calls, as
``chip_smoke.py`` times a kernel. One JSON line per measurement, the card's
name and power limit first. ``--quick`` stops after the checks. Exits 1
when a check fails (after printing every row).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "seldon_core_tpu_torch" / "csrc" / "int8_matmul.cu"

MAX_ROWS = "constexpr int FR_MAX_ROWS = 32;"
JB = "constexpr int FR_JB = 2;"
# appended to every variant's build (not to its source): how many clusters
# of the body can be active at once, at the launcher's CTA for K 768 / 3072
OCCUPANCY = r"""
extern "C" int fewrows_active_clusters(int k, int nt) {
  const int slice = ((k + 15) / 16 + FR_CLUSTER - 1) / FR_CLUSTER;
  const int per_warp = (slice + FR_WARP_STEPS - 1) / FR_WARP_STEPS;
  const int warps = per_warp < FR_WARPS ? per_warp : FR_WARPS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(FR_CLUSTER, 1, 1);
  cfg.blockDim = dim3(warps * 32, 1, 1);
  cfg.dynamicSmemBytes = ((warps + 1) * 8 * nt + 2) * FR_CH * sizeof(float);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = FR_CLUSTER, attr.val.clusterDim.y = 1, attr.val.clusterDim.z = 1;
  cfg.attrs = &attr, cfg.numAttrs = 1;
  int n = -1;
  const void* fn = nt == 1 ? (const void*)fewrows_body<__nv_bfloat16, 1> : (const void*)fewrows_body<__nv_bfloat16, 4>;
  return cudaOccupancyMaxActiveClusters(&n, fn, &cfg) == cudaSuccess ? n : -1;
}
"""
STEPS = "constexpr int FR_WARP_STEPS = 2;"

# GPT-2-small's projections (BERT-base's are the same widths): (K, N)
PROJECTIONS = {"qkv": (768, 2304), "attn_out": (768, 768), "mlp_in": (768, 3072), "mlp_out": (3072, 768)}
SWEEP_ROWS = (1, 2, 4, 8, 16, 24, 32, 48, 64, 128)
# name: (E, M, K, N), x shared by the members, bias
CHECKS = {
    **{f"{name}_m8": (1, 8, k, n, False, True) for name, (k, n) in PROJECTIONS.items()},
    **{f"{name}_m1": (1, 1, k, n, False, True) for name, (k, n) in PROJECTIONS.items()},
    "pooler_m32": (1, 32, 768, 768, False, True),
    "m13_k770": (1, 13, 770, 776, False, True),
    "ragged_n_m3": (1, 3, 776, 2312, False, True),
    "ragged_n_k": (1, 8, 3072, 760, False, True),
    "m24_n40": (1, 24, 64, 40, False, True),
    "no_bias": (1, 8, 768, 768, False, False),
    "stacked_e3_shared_x": (3, 8, 768, 768, True, True),
    "stacked_e3": (3, 8, 776, 768, False, True),
}


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the kernel source no longer holds exactly one occurrence of:\n{old}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    """The committed source and its three variants."""
    return {"committed": src,
            "rows128": _sub(src, MAX_ROWS, MAX_ROWS.replace("32", "128")),
            "ch64": _sub(src, JB, JB.replace("2", "4")),
            "steps1": _sub(src, STEPS, STEPS.replace("2", "1"))}


def build(out: Path) -> tuple[dict[str, Path], dict[str, dict]]:
    """Every variant's library, built in parallel; ptxas's report of each
    variant's few-rows bodies."""
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import kernel_build

    for header in SRC.parent.glob("*.cuh"):  # the variants include them from beside themselves
        (out / header.name).write_bytes(header.read_bytes())
    procs = {}
    for name, src in variants(SRC.read_text()).items():
        cu, so = out / f"int8_{name}.cu", out / f"libint8_{name}.so"
        cu.write_text(src + OCCUPANCY)
        procs[name] = (subprocess.Popen([kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, reports = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = so
        reports[name] = cs.ptxas_report(log, ("fewrows_body",))
    return libs, reports


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(ROOT / "build" / "int8_fewrows_probe"))
    parser.add_argument("--quick", action="store_true", help="stop after the checks")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("int8_fewrows_probe: this probe needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import int8_matmul as i8
    from seldon_core_tpu_torch.ops import kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False  # the plain version sums in f32
    card = cs.card_line()
    print(card, flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    paths, reports = build(out)
    failed = []
    for name, report in reports.items():  # the committed body must not spill; a variant may
        print(json.dumps({"ptxas": name, **report}), flush=True)
        if name == "committed" and (len(report) != 9 or any("0 bytes spill stores" not in r
                                                             for r in report.values())):
            failed.append(f"ptxas {name}")
    i8._lib()  # the wrapper's argtypes, set on the committed build
    libs = {name: ctypes.CDLL(str(path)) for name, path in paths.items()}

    def use(name):
        kernel_build._LIBS["int8_matmul"] = libs[name]
        i8._lib()

    def case(e, m, k, n, dtype, seed, shared=False, bias=True):
        rng = np.random.default_rng(seed)
        weights = [cs.int8_weights(k, n, rng) for _ in range(e)]
        q = torch.from_numpy(np.stack([w for w, _ in weights])).cuda()
        s = torch.from_numpy(np.stack([sc for _, sc in weights])).reshape(e, n).cuda()
        b = torch.from_numpy(rng.standard_normal((e, n)).astype(np.float32) * 0.1).cuda().to(dtype)
        x1 = torch.from_numpy(rng.standard_normal((1 if shared else e, m, k)).astype(np.float32)).cuda().to(dtype)
        return x1.expand(e, m, k), q, s, b if bias else None

    def fewrows(x, q, s, b):
        return i8._launch(x, q, s, b, body="fewrows")

    for variant in ("committed", "rows128", "ch64", "steps1"):
        use(variant)
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            dtype_name = str(dtype).removeprefix("torch.")
            for name, (e, m, k, n, shared, bias) in CHECKS.items():
                x, q, s, b = case(e, m, k, n, dtype, e + m + k + n, shared, bias)
                row = {"check": name, "variant": variant, "shape": [e, m, k, n], "dtype": dtype_name,
                       "select_body": i8.body_for(x, q)}
                try:
                    y = fewrows(x, q, s, b)
                    again = fewrows(x, q, s, b)
                    torch.cuda.synchronize()
                    ref = i8._batched_reference(x, q, s, b)
                    agree = cs.agreement(y, ref, dtype_name)
                    row.update(ok=agree["ok"], max_abs_err=agree["max_abs_err"], atol=agree["atol"],
                               rel_l2=agree["rel_l2"], same_bits=bool(torch.equal(y, again)))
                    if name == "qkv_m8":  # a captured launch replays the eager bits
                        graph, static = torch.cuda.CUDAGraph(), {}
                        with torch.cuda.graph(graph):
                            static["y"] = fewrows(x, q, s, b)
                        graph.replay()
                        torch.cuda.synchronize()
                        row["graph_same_bits"] = bool(torch.equal(static["y"], y))
                except RuntimeError as err:
                    row.update(ok=False, error=str(err)[:300])
                print(json.dumps(row), flush=True)
                if not (row["ok"] and row.get("same_bits") and row.get("graph_same_bits", True)):
                    failed.append(f"{variant} {name} {dtype_name}")
        # past the rule: the committed body refuses 33 rows and a narrow N
        x, q, s, b = case(1, 33, 768, 768, torch.bfloat16, 1)
        xn, qn, sn, bn = case(1, 8, 768, 16, torch.bfloat16, 2)
        refused = {}
        for label, call in (("m33", lambda: fewrows(x, q, s, b)), ("n16", lambda: fewrows(xn, qn, sn, bn))):
            try:
                call()
                refused[label] = False
            except RuntimeError:
                refused[label] = True
        print(json.dumps({"refusals": variant, **refused}), flush=True)
        if not refused["n16"] or refused["m33"] != (variant != "rows128"):
            failed.append(f"{variant} refusals {refused}")
    for variant, lib in libs.items():  # after the checks: each variant's bodies have launched once
        fn = lib.fewrows_active_clusters
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int]
        print(json.dumps({"active_clusters": variant, **{f"k{k}_m{8 * nt}": fn(k, nt) for k in (768, 3072)
                                                          for nt in (1, 4)}}), flush=True)
    if args.quick:
        print(json.dumps({"failed": failed}), flush=True)
        return 1 if failed else 0

    def library_ms(x, q, s, b):
        w = (q.float() * s[:, None, :]).to(x.dtype)
        return cs.device_ms(lambda: torch.addmm(b[0], x[0], w[0]))

    order = ("committed", "ch64", "steps1")
    tiles = {**{f"{name}_m{m}": (m, k, n) for m in (8, 32) for name, (k, n) in PROJECTIONS.items()},
             "pooler_m32": (32, 768, 768)}
    for name, (m, k, n) in tiles.items():
        x, q, s, b = case(1, m, k, n, torch.bfloat16, m + k + n)
        row = {"case": name, "shape": [1, m, k, n], "dtype": "bfloat16", "ms": {}}
        for variant in (*order, *reversed(order)):
            use(variant)
            row["ms"].setdefault(variant, []).append(cs.device_ms(lambda: fewrows(x, q, s, b)))
        use("committed")
        row["wgmma_ms"] = cs.device_ms(lambda: i8._launch(x, q, s, b, body="wgmma"))
        row["library_ms"] = library_ms(x, q, s, b)
        row["bound_ms"] = cs.int8_bounds(1, m, k, n, "bfloat16", False)["bfloat16"][0]
        print(json.dumps(row), flush=True)

    use("rows128")
    for name, (k, n) in PROJECTIONS.items():
        for m in SWEEP_ROWS:
            x, q, s, b = case(1, m, k, n, torch.bfloat16, m + k + n)
            bound, by = cs.int8_bounds(1, m, k, n, "bfloat16", False)["bfloat16"]
            row = {"sweep": name, "shape": [1, m, k, n], "dtype": "bfloat16",
                   "fewrows_ms": cs.device_ms(lambda: fewrows(x, q, s, b)),
                   "wgmma_ms": cs.device_ms(lambda: i8._launch(x, q, s, b, body="wgmma")),
                   "library_ms": library_ms(x, q, s, b), "bound_ms": bound, "bound_by": by}
            print(json.dumps(row), flush=True)
    fill = torch.empty(1, device="cuda")
    print(json.dumps({"launch_floor_ms": cs.device_ms(lambda: fill.fill_(1.0)), "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
