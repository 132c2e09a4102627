#!/usr/bin/env python3
"""Why the float32 W8A16 body is built as it is, and the narrow body's
chunk size, on one NVIDIA Hopper card.

    python3 int8_f32_probe.py [--out DIR]   # from the root of a checkout

``csrc/int8_matmul.cu``'s ``tf32x2_body`` forms float32 x @ q as two tf32
passes (x split into hi and lo, q exact) on wgmma, x the K-major B operand
split in shared memory one stage ahead of the products. This builds
variants of the committed source, all started together:

  committed       as committed
  split_before    each stage split just before its own products (no
                  overlap of the split with the tensor cores)
  mma_sync        the float32 route on mma.sync m16n8k8 instead: x as A,
                  split in registers, q as B from a cp.async ring, 64- or
                  128-row tiles (the route of flash_attention.cu's float32
                  body; its source is kept here, not in csrc/)
  splitk_16byte   the narrow body reading 16 bytes of a bf16 x at once
                  (8 values) instead of 8 bytes

and prints, in one process on one card: ptxas's report of each variant's
float32 bodies; each float32 variant against the plain version (TF32 off)
under ``chip_smoke.KERNEL_TOL["float32"]`` and its time at BERT-base's
projections and at 128-300 rows, in turns (committed, split_before,
mma_sync, mma_sync, split_before, committed), beside ``torch.addmm`` and
``chip_smoke.int8_bounds``; the narrow body at its served shapes and
beyond, 8-byte against 16-byte chunks in turns, beside ``addmm``; and
across the narrow cut (N 16 and 32 at 512 and 4096 rows) the narrow body
against wgmma. CUDA events, median of 25 calls, as ``chip_smoke.py`` times
a kernel. One JSON line per measurement, and the card's name and power
limit first.
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

# split_before: the committed loop splits stage kt + 1 under stage kt's
# products and hands it over at the loop's end
AHEAD_PROLOGUE = """  split(0);
  named_sync(1, 256);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % TW_STAGES;
"""
BEFORE_PROLOGUE = """  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % TW_STAGES;
    split(kt);
    named_sync(1, 256);
"""
AHEAD_SPLIT = "    if (kt + 1 < nk) split(kt + 1);  // under this stage's products\n"
AHEAD_HANDOVER = "    named_sync(1, 256);  // both warpgroups' splits of stage kt + 1 are in\n"
# mma_sync: the route-(b) body goes in before the host code, and its
# launcher replaces the committed launch_tf32x2
HOST_MARK = "// ------------------------------------------------------------------ host\n"
LAUNCH_START = "cudaError_t launch_tf32x2(const Args& a, int E, cudaStream_t stream) {\n"
# splitk_16byte
SPLITK_CH = "  constexpr int CH = SK_CH;           // k values per chunk of x\n"
SPLITK_CH_16 = "  constexpr int CH = 16 / sizeof(T);  // k values per chunk of x\n"
SPLITK_CHUNKS = "  const long long chunks = (K + SK_CH - 1) / SK_CH;\n"
SPLITK_CHUNKS_16 = "  const long long chunks = (K + 7) / 8;  // bf16 / f16: 8 values in 16 bytes\n"

MMA_BODY = r"""// ------------------------------------------------- tf32x2_mma_body
// Route (b) of the float32 body: the same split on mma.sync m16n8k8,
// x as A split in registers, q as B from a cp.async ring (PR 22's
// first design; int8_f32_probe.py builds it beside the committed one).
constexpr int TF_BN = 128;
constexpr int TF_BK = 32;
constexpr int TF_STAGES = 4;
constexpr int TF_THREADS = 256;
constexpr int TF_XS = TF_BK + 8;   // floats per x row in shared memory (160 bytes)
constexpr int TF_QS = TF_BN + 16;  // bytes per q row in shared memory

template <int BM>
struct TfCfg {
  static constexpr int MT = BM / 32;  // m16 tiles per warp
  static constexpr int X_BYTES = BM * TF_XS * 4;
  static constexpr int STAGE_BYTES = X_BYTES + TF_BK * TF_QS;
  static constexpr int SMEM = TF_STAGES * STAGE_BYTES;
  static_assert((BM == 128 || BM == 64) && STAGE_BYTES % 16 == 0 && SMEM <= 232448, "tf32x2 tile");
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t tf32_trunc(float v) { return __float_as_uint(v) & 0xffffe000u; }

template <int BM>
__global__ void __launch_bounds__(TF_THREADS, BM == 128 ? 1 : 2) tf32x2_mma_body(Args a) {
  using C = TfCfg<BM>;
  constexpr int MT = C::MT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int e = blockIdx.z, n_tile = blockIdx.x * TF_BN, m0 = blockIdx.y * BM;
  const float* xg = static_cast<const float*>(a.x) + e * a.x_es;
  const int8_t* qg = a.q + e * a.q_es;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * (BM / 2), wn = (warp & 3) * 32;
  const int nk = (a.K + TF_BK - 1) / TF_BK;

  // stage s: x rows of 32 floats (8 chunks of 16 bytes), then q rows of 128
  // bytes (8 chunks); K % 4 == 0 and N % 16 == 0, so a chunk that starts
  // inside K (N) ends inside it; chunks outside are zero-filled
  auto load = [&](int kt, int s) {
    const int k0 = kt * TF_BK;
    float* xs = reinterpret_cast<float*>(smem_raw + s * C::STAGE_BYTES);
    int8_t* qs = reinterpret_cast<int8_t*>(smem_raw + s * C::STAGE_BYTES + C::X_BYTES);
#pragma unroll
    for (int i = 0; i < BM * TF_BK / 4 / TF_THREADS; ++i) {
      const int c = tid + i * TF_THREADS, r = c >> 3, kc = (c & 7) * 4;
      const bool in = m0 + r < a.M && k0 + kc < a.K;
      cp_async16(xs + r * TF_XS + kc, in ? xg + (long long)(m0 + r) * a.x_rs + k0 + kc : xg, in);
    }
    const int r = tid >> 3, nc = (tid & 7) * 16;
    const bool in = k0 + r < a.K && n_tile + nc < a.N;
    cp_async16(qs + r * TF_QS + nc, in ? qg + (long long)(k0 + r) * a.N + n_tile + nc : qg, in);
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < TF_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TF_STAGES - 2>();  // this thread's copies of stage kt have landed
    __syncthreads();                 // everyone's, and stage kt - 1 is free again
    if (kt + TF_STAGES - 1 < nk) load(kt + TF_STAGES - 1, (kt + TF_STAGES - 1) % TF_STAGES);
    cp_async_commit();

    const int s = kt % TF_STAGES;
    const float* xs = reinterpret_cast<const float*>(smem_raw + s * C::STAGE_BYTES) + (wm + g) * TF_XS + 2 * t;
    const uint8_t* qs = smem_raw + s * C::STAGE_BYTES + C::X_BYTES + 2 * t * TF_QS + wn + 4 * g;
    float part[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // B: b[nt] = q[8kk + 2t (+1)][wn + 4g + nt], exact as tf32
      uint32_t b[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t u = *reinterpret_cast<const uint32_t*>(qs + (kk * 8 + h) * TF_QS) ^ 0x80808080u;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          b[nt][h] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + nt)) - 8388736.f);
      }
      // A: rows 16mt + g and + 8, k = 8kk + 2t and + 1, split in registers
      uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float2 v0 = *reinterpret_cast<const float2*>(xs + mt * 16 * TF_XS + kk * 8);
        const float2 v1 = *reinterpret_cast<const float2*>(xs + (mt * 16 + 8) * TF_XS + kk * 8);
        const float av[4] = {v0.x, v1.x, v0.y, v1.y};  // A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[mt][i] = tf32_trunc(av[i]);
          lo[mt][i] = tf32_trunc(av[i] - __uint_as_float(hi[mt][i]));
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(part[mt][nt], lo[mt], b[nt][0], b[nt][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(part[mt][nt], hi[mt], b[nt][0], b[nt][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
  }

  // acc[mt][nt][0] is row 16mt + g, channel 8t + nt; [1] channel 8t + 4 + nt;
  // [2], [3] the same at row + 8 (rows and channels relative to the warp's)
  const int c0 = n_tile + wn + 8 * t;
  if (c0 >= a.N) return;  // N % 16 == 0, so c0 + 7 < N too
  const float* sg = a.scale + e * a.s_es + c0;
  const float* bg = a.bias ? static_cast<const float*>(a.bias) + e * a.b_es + c0 : nullptr;
  float sc[8], bi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = sg[j];
    bi[j] = bg ? bg[j] : 0.f;
  }
  float* yg = static_cast<float*>(a.y) + (long long)e * a.M * a.N + c0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + mt * 16 + g + 8 * h;
      if (r >= a.M) continue;
      float4* out = reinterpret_cast<float4*>(yg + (long long)r * a.N);
      out[0] = make_float4(fmaf(acc[mt][0][2 * h], sc[0], bi[0]), fmaf(acc[mt][1][2 * h], sc[1], bi[1]),
                           fmaf(acc[mt][2][2 * h], sc[2], bi[2]), fmaf(acc[mt][3][2 * h], sc[3], bi[3]));
      out[1] = make_float4(fmaf(acc[mt][0][2 * h + 1], sc[4], bi[4]), fmaf(acc[mt][1][2 * h + 1], sc[5], bi[5]),
                           fmaf(acc[mt][2][2 * h + 1], sc[6], bi[6]), fmaf(acc[mt][3][2 * h + 1], sc[7], bi[7]));
    }
}

"""

MMA_LAUNCH = r"""// the tile height whose grid needs the fewest wave-heights, as pick_bm
int tf32x2_mma_bm(int E, int M, int N, int sms) {
  const long long cols = static_cast<long long>(E) * ((N + TF_BN - 1) / TF_BN);
  const long long tall = cols * ((M + 127) / 128), short_ = cols * ((M + 63) / 64);
  return (short_ + sms - 1) / sms * 64 < (tall + sms - 1) / sms * 128 ? 64 : 128;
}

template <int BM>
cudaError_t launch_tf32x2_mma_tile(const Args& a, int E, int dev, cudaStream_t stream) {
  using C = TfCfg<BM>;
  static std::atomic<bool> smem_raised[MAX_DEVICES];
  if (dev >= MAX_DEVICES || !smem_raised[dev].load(std::memory_order_relaxed)) {
    const cudaError_t err =
        cudaFuncSetAttribute(tf32x2_mma_body<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) smem_raised[dev].store(true, std::memory_order_relaxed);
  }
  tf32x2_mma_body<BM><<<dim3((a.N + TF_BN - 1) / TF_BN, (a.M + BM - 1) / BM, E), TF_THREADS, C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_tf32x2(const Args& a, int E, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err != cudaSuccess) return err;
  return tf32x2_mma_bm(E, a.M, a.N, sms) == 64 ? launch_tf32x2_mma_tile<64>(a, E, dev, stream)
                                               : launch_tf32x2_mma_tile<128>(a, E, dev, stream);
}
"""

F32_SHAPES = {  # name: (M, K, N)
    "qkv_b32": (4096, 768, 2304), "attn_out_b32": (4096, 768, 768), "mlp_in_b32": (4096, 768, 3072),
    "mlp_out_b32": (4096, 3072, 768), "qkv_b1": (128, 768, 2304), "ragged_300": (300, 776, 400),
}
NARROW_SHAPES = {  # name: (M, K, N), bf16
    "head_b32": (32, 768, 2), "head_b1": (1, 768, 2), "iris": (5, 4, 3), "n8_b32": (32, 768, 8),
    "k3072_n3": (32, 3072, 3), "n8_m4096": (4096, 768, 8), "n2_m4096": (4096, 768, 2),
}
CUT_SHAPES = {"n16_m512": (512, 768, 16), "n32_m512": (512, 768, 32), "n16_m4096": (4096, 768, 16),
              "n32_m4096": (4096, 768, 32)}


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the kernel source no longer holds exactly one occurrence of:\n{old}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    """The committed source and its three variants."""
    before = _sub(_sub(_sub(src, AHEAD_PROLOGUE, BEFORE_PROLOGUE), AHEAD_SPLIT, ""), AHEAD_HANDOVER, "")
    mma = _sub(src, HOST_MARK, MMA_BODY + "\n" + HOST_MARK)
    start = mma.index(LAUNCH_START) if mma.count(LAUNCH_START) == 1 else -1
    if start < 0:
        raise ValueError(f"the kernel source no longer holds exactly one occurrence of:\n{LAUNCH_START}")
    end = mma.index("\n}\n", start) + 3
    mma = mma[:start] + MMA_LAUNCH + mma[end:]
    splitk16 = _sub(_sub(src, SPLITK_CH, SPLITK_CH_16), SPLITK_CHUNKS, SPLITK_CHUNKS_16)
    return {"committed": src, "split_before": before, "mma_sync": mma, "splitk_16byte": splitk16}


def build(out: Path) -> tuple[dict[str, Path], dict[str, dict]]:
    """Every variant's library, built in parallel; ptxas's report of each
    variant's float32 bodies."""
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import kernel_build

    for header in SRC.parent.glob("*.cuh"):  # the variants include them from beside themselves
        (out / header.name).write_bytes(header.read_bytes())
    procs = {}
    for name, src in variants(SRC.read_text()).items():
        cu, so = out / f"int8_{name}.cu", out / f"libint8_{name}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen([kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, reports = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = so
        reports[name] = cs.ptxas_report(log, ("tf32x2_body", "tf32x2_mma_body"))
    return libs, reports


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(ROOT / "build" / "int8_f32_probe"))
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("int8_f32_probe: this probe needs a CUDA card", file=sys.stderr)
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
    for name, report in reports.items():
        print(json.dumps({"ptxas": name, **report}), flush=True)
    i8._lib()  # the wrapper's argtypes, set on the committed build
    libs = {name: ctypes.CDLL(str(path)) for name, path in paths.items()}

    def use(name):
        kernel_build._LIBS["int8_matmul"] = libs[name]
        i8._lib()

    def case(m, k, n, dtype, seed):
        rng = np.random.default_rng(seed)
        qw, sc = cs.int8_weights(k, n, rng)
        q = torch.from_numpy(qw)[None].cuda()
        s = torch.from_numpy(sc).reshape(1, n).cuda()
        b = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32) * 0.1).cuda().to(dtype)
        x = torch.from_numpy(rng.standard_normal((1, m, k)).astype(np.float32)).cuda().to(dtype)
        return x, q, s, b

    def library_ms(x, q, s, b):
        w = (q.float() * s[:, None, :]).to(x.dtype)
        return cs.device_ms(lambda: torch.addmm(b[0], x[0], w[0]))

    f32 = ("committed", "split_before", "mma_sync")
    for name, (m, k, n) in F32_SHAPES.items():
        x, q, s, b = case(m, k, n, torch.float32, m + k + n)
        ref = i8._batched_reference(x, q, s, b)
        row = {"case": name, "shape": [m, k, n], "dtype": "float32"}
        for variant in (*f32, *reversed(f32)):
            use(variant)
            y = i8._launch(x, q, s, b, body="tf32x2")
            torch.cuda.synchronize()
            agree = cs.agreement(y, ref, "float32")
            row.setdefault("ok", {})[variant] = [agree["ok"], agree["rel_l2"]]
            row.setdefault("ms", {}).setdefault(variant, []).append(
                cs.device_ms(lambda: i8._launch(x, q, s, b, body="tf32x2")))
        row["library_ms"] = library_ms(x, q, s, b)
        row["bounds_ms"] = {r: ms for r, (ms, _) in cs.int8_bounds(1, m, k, n, "float32", False).items()}
        print(json.dumps(row), flush=True)

    for name, (m, k, n) in NARROW_SHAPES.items():
        x, q, s, b = case(m, k, n, torch.bfloat16, m + k + n)
        ref = i8._batched_reference(x, q, s, b)
        row = {"case": name, "shape": [m, k, n], "dtype": "bfloat16"}
        for variant in ("committed", "splitk_16byte", "splitk_16byte", "committed"):
            use(variant)
            y = i8._launch(x, q, s, b, body="splitk")
            torch.cuda.synchronize()
            row.setdefault("ok", {})[variant] = cs.agreement(y, ref, "bfloat16")["ok"]
            row.setdefault("ms", {}).setdefault(variant, []).append(
                cs.device_ms(lambda: i8._launch(x, q, s, b, body="splitk")))
        row["library_ms"] = library_ms(x, q, s, b)
        print(json.dumps(row), flush=True)

    use("committed")
    for name, (m, k, n) in CUT_SHAPES.items():
        x, q, s, b = case(m, k, n, torch.bfloat16, m + k + n)
        row = {"case": name, "shape": [m, k, n], "dtype": "bfloat16", "select_body": i8.body_for(x, q),
               "ms": {body: cs.device_ms(lambda: i8._launch(x, q, s, b, body=body)) for body in ("splitk", "wgmma")},
               "library_ms": library_ms(x, q, s, b)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
