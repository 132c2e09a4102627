// W8A16 matmul for Hopper (sm_90a): y[e] = x[e] @ W[e] (+ bias[e]) with
// W[k, n] = q[k, n] * scale[n], accumulated in float32 and rounded once to T.
//
// Replaces no Pallas kernel: it replaces XLA's fusion of the JAX package's
// quant.dequantize into the consuming matmul (seldon_core_tpu/models/base.py
// :137-168, seldon_core_tpu/models/quant.py:64-76), where the dequantized
// weight never reaches HBM. Here it never leaves the SM: q crosses shared
// memory (or registers) as int8 and is dequantized in registers.
//
// Layouts: x [E, M, K] through a member stride (0: one x shared by every
// member, as a fused ensemble's input is) and a row stride, K contiguous;
// q [E, K, N], N contiguous (the JAX layout quantize_params produces, last
// axis = output channel; a member stride of 0 shares one q); scale and
// bias [E, N]; y [E, M, N] contiguous. E is 1 except in a fused ensemble,
// where grid z walks the members.
//
// Six bodies. The caller names the body (ops/int8_matmul.py::select_body
// decides before the launch; wgmma_takes, tf32x2_takes and fewrows_takes
// below hold the same rules); a body asked for a shape or dtype it cannot
// take returns cudaErrorInvalidValue and launches nothing.
//   splitk_body  narrow outputs (select_body: N <= 8, or N <= 32 at up to
//                128 rows), every dtype, any shape and strides: the BERT
//                head (N = 2), iris (N = 3).
//                Bound: a launch and one round trip to device memory (the
//                head reads 51 KB for 49 K multiply-adds). A 64x64 tile
//                there would be 3% used, on one SM, with 12 serial K
//                tiles. Here every load is issued at once: K is cut into
//                chunks of 4 values of x (8 bytes in bf16 / f16, which at
//                the head's K = 768 measured faster than 16-byte chunks:
//                int8_f32_probe.py), spread over the lanes of 1-8 warps
//                per row, rows over CTAs; q's rows are read as the
//                contiguous bytes they are (N = 2: one 8-byte load covers
//                4 k rows); W = T(q * scale) is formed in registers (the
//                plain version's rounding point) and multiplied in float32
//                FMA; warp shuffles, then the row's warps through shared
//                memory, reduce in a fixed order (no atomics: a rerun
//                gives the same bits). An output-column group of 8 per CTA.
//   fewrows_body few rows past the narrow cut (select_body: M <=
//                FEW_ROWS_WIDE), every dtype, any strides: a decode step's
//                8 rows of GPT-2-small's projections, BERT's pooler (32).
//                Bound: the int8 weight bytes and a launch (qkv at 8 rows:
//                14 M multiply-adds against 1.77 MB, 0.00055 ms at 3.35
//                TB/s; the event floor of a launch is 0.0050 ms). wgmma_body
//                gave such a call 6-24 CTAs of 128 rows, 8 of them used,
//                each walking all of K in series. Here a cluster of 8 CTAs
//                splits K for every 32 output channels (192-768 CTAs at
//                GPT-2-small's widths), each lane reads its q bytes once,
//                every load of a warp in flight at once, and the slices are
//                summed through distributed shared memory in rank order.
//                What is left at 8 rows is mostly fixed cost: a launch, one
//                round trip, one cluster barrier, the store (PERF.md).
//                Products on mma.sync (weights as A, x's rows as one n8
//                tile per 8 rows), not float32 FMA: the tensor cores sum
//                over k, so a lane holds 4 sums per block of 16 channels
//                and 8 rows instead of FMA's channels x M rows of partials
//                over its own k rows (64 registers for 4 channels at M =
//                16, 128 for 16 channels at M = 8), and the dequantize, 16
//                instructions per 4 weights, is then the only per-byte
//                work at any M. Design above the body.
//   tf32x2_body  float32 activations whose operands TMA can address (the
//                wgmma body's rule with K, x's strides % 4 == 0). Bound:
//                the CUDA cores' 67 TFLOP/s caps a float32 FMA body (qkv
//                at bucket 32: 0.2164 ms); the tensor cores take tf32 at
//                495. An int8 q (|q| <= 127) is exact in tf32, so only x is
//                split, x = hi + lo (hi = x with its low 13 bits cleared,
//                lo = x - hi likewise cleared): lo*q + hi*q, two tf32
//                passes of wgmma (2 x 14.5 GFLOP at qkv: 0.0586 ms), each
//                term to about 2^-20. The scale moves to the float32
//                epilogue: in float32 T(q * scale) rounds once at 2^-24,
//                far inside the float32 tolerance (the rounding-point
//                argument below concerns bf16 and f16). The same split on
//                mma.sync m16n8k8 (a cp.async ring, x as A split in
//                registers) measured 1.47x slower at qkv
//                (int8_f32_probe.py builds it). Design above the body.
//   wgmma_body   bf16 / f16 activations whose operands TMA can address:
//                K > 0, K % 8 == 0, x's row and member strides % 8 == 0,
//                N % 16 == 0, q's member stride % 16 == 0, x and q bases
//                16-byte aligned (TMA's 16-byte rule for bases and global
//                strides). Every bf16 projection of BERT-base.
//   mma_body     bf16 / f16, any shape (views whose strides TMA cannot
//                take, wide outputs that are not N % 16). One CTA of 128
//                threads per 64x64 tile, a two-stage cp.async ring over
//                64-deep K tiles, mma.sync m16n8k16 with B fragments built
//                by hand from the staged int8 rows, the scale multiplied in
//                float32 and rounded to T before the product (the plain
//                version's rounding point). Ragged edges take a scalar copy
//                that zero-fills.
//   fma_body     float32 activations, any shape (views tf32x2 cannot
//                address). BK = 32. Plain FMA, no TF32: each K tile of q is
//                dequantized once into a float32 shared tile, then every
//                thread accumulates an 8x4 block of y.
//
// wgmma_body is warp-specialised, in the shape of flash_attention.cu's
// flash_fwd_wgmma, and computes y^T = W^T x^T: the weights are wgmma's A
// operand, built in registers, and x is its B operand, read from shared
// memory (flash's Q K^T with q in registers). One CTA = two consumer
// warpgroups (64 output channels each: 128 per CTA) and one producer warp,
// for a [BM rows][128 channels] tile of y:
//   - producer (one lane): TMA loads of the x tile [BM rows][64 k] (bf16)
//     and of the q tile [64 k][128 n] (int8), both with the 128-byte
//     swizzle, into a ring of 4 stages, each with a full and an empty
//     mbarrier. Members have 3-D maps (columns, rows, member), so a K or M
//     tile zero-fills at a member's edge instead of reading the next one.
//   - consumers: per K tile, each thread builds its A fragments for the
//     four k16 steps straight from the int8 stage: row r of a warpgroup's
//     A (and r + 8) is output channel n0 (n0 + 1), a permutation that puts
//     a thread's two channels side by side, so one 16-bit shared load of a
//     q row serves both, conflict-free under the swizzle; a PRMT pairs two
//     k rows' bytes and dequant4 gives the packed fragments. Then
//     wgmma.mma_async m64nBMk16 (A in registers, B = the x stage K-major by
//     descriptor, as flash's K operand), commit, wait, release the stage.
//     The two warpgroups share the tensor cores, so one builds while the
//     other's products run. Fragments are rebuilt at every K tile, never
//     held across the loop (ptxas miscompiles loop-carried ones,
//     flash_q_probe.py).
//   - dequant4 uses no I2F: four int8 bytes, biased by 128 with one XOR,
//     are permuted (PRMT) into the low byte of the float 2^23, and one FADD
//     of -(2^23 + 128) each leaves q exactly. A thread's rows are two
//     channels, so it holds two scales: one FMUL each, then one rounding
//     pack to T per pair.
//   - epilogue: y = acc + bias[n] in float32, rounded once to T, stored as
//     channel pairs (a warp's store covers 32 contiguous bytes of each of 4
//     rows).
// Why not convert q into a bf16 B tile in shared memory (W as wgmma's B
// operand, the layout of flash's V): on an H100 that design's convert
// traffic (q in, bf16 out), on top of both warpgroups' reads of the B
// tile, kept it well behind cuBLAS at BERT-base's projections (PERF.md,
// section 6). Here the weight tile crosses shared memory once, as int8.
// Rounding point: the plain version's (and the JAX package's). W = T(q *
// scale) is formed in float32 and rounded once before the product, bit for
// bit the plain version's weights. Scaling the float32 sums in the epilogue
// instead would skip that rounding and cost one FMUL per output instead of
// one per weight, but it parts from the plain version by up to 2^-9 of
// each weight: about 0.25 absolute on near-zero outputs of a K = 768 sum of
// unit-scale terms, far outside tests/test_torch_int8_gpu.py's elementwise
// bound. PERF.md has the measured cost of keeping the rounding point.
//
// Tiles and grid: BM (rows of x per tile, wgmma's N) is 192 or 128, the
// one whose grid needs the fewest wave-heights, ceil(tiles / SMs) * BM (a
// tie keeps 192); grid (ceil(N / 128), ceil(M / BM), E). On 132 SMs,
// BERT-base at bucket 32 (M = 4096) takes BM 192 everywhere: qkv (N =
// 2304) 396 tiles (3.0 waves), attn_out and mlp_out (N = 768) 132 tiles
// (1.0 wave), mlp_in (N = 3072) 528 tiles (4.0 waves). At bucket 1 (M =
// 128) BM 128: 18, 6, 24 and 6 tiles, a fraction of the card. A 256-row
// tile needs more registers than 288 threads leave (ptxas serialises its
// wgmmas). Shared memory: 4 x (BM x 128 B of x + 8 KB of q), 96 or 128 KB:
// one CTA per SM.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
// BERT-base's projections at M = 4096 are operations-bound (qkv 14.5
// GFLOP against 12.6 MB: 0.0147 ms; attn_out 0.0049 ms; mlp_in and mlp_out
// 0.0195 ms). At M = 128 the int8 weight bytes bound them (qkv 0.0008 ms).
// Per 64-deep K tile a CTA's shared memory serves each warpgroup's wgmma
// the whole x stage (BM x 128 B) and its 64 channels' int8 rows once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int THREADS = 128;
constexpr int BK_MMA = 64;
constexpr int BK_FMA = 32;
constexpr int QS_STRIDE = BN + 16;  // bytes per q row in shared memory

struct Args {
  const void* x;
  const int8_t* q;
  const float* scale;
  const void* bias;
  void* y;
  int M, N, K;
  long long x_es, x_rs, q_es, s_es, b_es;
  int vec_x, vec_q;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// two values rounded to T, lo in the low half (the smaller k)
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16*) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half*) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in_bounds) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = in_bounds ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// x rows m0.. m0+BM, columns k0.. k0+BK into xs (row stride XS elements)
template <typename T, int BK, int XS>
__device__ __forceinline__ void load_x(T* xs, const T* xg, int m0, int k0, const Args& a) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int PER_ROW = BK / CH;
  for (int c = threadIdx.x; c < BM * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int kc = (c % PER_ROW) * CH;
    const int gm = m0 + r;
    const int gk = k0 + kc;
    T* dst = xs + r * XS + kc;
    if (a.vec_x) {
      // K % CH == 0, so a chunk that starts inside K ends inside it
      const bool in = gm < a.M && gk < a.K;
      cp_async16(dst, in ? xg + gm * a.x_rs + gk : xg, in);
    } else {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        dst[i] = (gm < a.M && gk + i < a.K) ? xg[gm * a.x_rs + gk + i] : from_f32<T>(0.f);
      }
    }
  }
}

// q rows k0.. k0+BK, columns n0.. n0+BN into qs (row stride QS_STRIDE bytes)
template <int BK>
__device__ __forceinline__ void load_q(int8_t* qs, const int8_t* qg, int k0, int n0, const Args& a) {
  constexpr int PER_ROW = BN / 16;
  for (int c = threadIdx.x; c < BK * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int nc = (c % PER_ROW) * 16;
    const int gk = k0 + r;
    const int gn = n0 + nc;
    int8_t* dst = qs + r * QS_STRIDE + nc;
    if (a.vec_q) {
      // N % 16 == 0, so a chunk that starts inside N ends inside it
      const bool in = gk < a.K && gn < a.N;
      cp_async16(dst, in ? qg + (long long)gk * a.N + gn : qg, in);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        dst[i] = (gk < a.K && gn + i < a.N) ? qg[(long long)gk * a.N + gn + i] : int8_t(0);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b);

template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma_16816<__half>(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) mma_body(Args a) {
  constexpr int XS = BK_MMA + 8;  // 144-byte rows
  __shared__ __align__(16) T xs[2][BM * XS];
  __shared__ __align__(16) int8_t qs[2][BK_MMA * QS_STRIDE];

  const int e = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const T* xg = static_cast<const T*>(a.x) + e * a.x_es;
  const int8_t* qg = a.q + e * a.q_es;
  const float* sg = a.scale + e * a.s_es;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // group: the fragment row (A, C) / column (B)
  const int t = lane & 3;   // thread in group
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  // this thread's B columns: wn + j*8 + g, scale 0 past N
  float sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + j * 8 + g;
    sc[j] = n < a.N ? sg[n] : 0.f;
  }
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int nk = (a.K + BK_MMA - 1) / BK_MMA;
  if (nk > 0) {
    load_x<T, BK_MMA, XS>(xs[0], xg, m0, 0, a);
    load_q<BK_MMA>(qs[0], qg, 0, n0, a);
  }
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_x<T, BK_MMA, XS>(xs[cur ^ 1], xg, m0, (kt + 1) * BK_MMA, a);
      load_q<BK_MMA>(qs[cur ^ 1], qg, (kt + 1) * BK_MMA, n0, a);
    }
    cp_async_commit();
    cp_async_wait_1();  // this tile's copies are done, the next one's may fly
    __syncthreads();
    const T* xt = xs[cur];
    const int8_t* qt = qs[cur];
#pragma unroll
    for (int kk = 0; kk < BK_MMA; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* r0 = xt + (wm + i * 16 + g) * XS + kk + 2 * t;
        const T* r8 = r0 + 8 * XS;
        af[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[i][1] = *reinterpret_cast<const uint32_t*>(r8);
        af[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* qc = qt + (kk + 2 * t) * QS_STRIDE + wn + j * 8 + g;
        const float w0 = float(qc[0]) * sc[j];
        const float w1 = float(qc[QS_STRIDE]) * sc[j];
        const float w8 = float(qc[8 * QS_STRIDE]) * sc[j];
        const float w9 = float(qc[9 * QS_STRIDE]) * sc[j];
        uint32_t bf[2] = {pack2(w0, w1, static_cast<T*>(nullptr)), pack2(w8, w9, static_cast<T*>(nullptr))};
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_16816<T>(acc[i][j], af[i], bf);
      }
    }
    __syncthreads();  // the next iteration overwrites the other stage
  }

  T* yg = static_cast<T*>(a.y) + (long long)e * a.M * a.N;
  const T* bg = a.bias ? static_cast<const T*>(a.bias) + e * a.b_es : nullptr;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c0 = n0 + wn + j * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + h;
      if (c >= a.N) continue;
      const float b = bg ? to_f32(bg[c]) : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = m0 + wm + i * 16 + g;
        if (r < a.M) yg[(long long)r * a.N + c] = from_f32<T>(acc[i][j][h] + b);
        if (r + 8 < a.M) yg[(long long)(r + 8) * a.N + c] = from_f32<T>(acc[i][j][2 + h] + b);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) fma_body(Args a) {
  constexpr int XS = BK_FMA + 4;  // 144-byte rows
  __shared__ __align__(16) float xs[2][BM * XS];
  __shared__ __align__(16) int8_t qs[2][BK_FMA * QS_STRIDE];
  __shared__ __align__(16) float ws[BK_FMA * BN];
  __shared__ float ss[BN];

  const int e = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const float* xg = static_cast<const float*>(a.x) + e * a.x_es;
  const int8_t* qg = a.q + e * a.q_es;
  const float* sg = a.scale + e * a.s_es;
  for (int c = threadIdx.x; c < BN; c += THREADS) ss[c] = n0 + c < a.N ? sg[n0 + c] : 0.f;

  const int ty = threadIdx.x >> 4;  // rows ty*8 .. ty*8+7
  const int tx = threadIdx.x & 15;  // columns tx*4 .. tx*4+3
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nk = (a.K + BK_FMA - 1) / BK_FMA;
  if (nk > 0) {
    load_x<float, BK_FMA, XS>(xs[0], xg, m0, 0, a);
    load_q<BK_FMA>(qs[0], qg, 0, n0, a);
  }
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_x<float, BK_FMA, XS>(xs[cur ^ 1], xg, m0, (kt + 1) * BK_FMA, a);
      load_q<BK_FMA>(qs[cur ^ 1], qg, (kt + 1) * BK_FMA, n0, a);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    for (int c = threadIdx.x; c < BK_FMA * BN; c += THREADS) {
      const int r = c / BN;
      const int n = c % BN;
      ws[c] = float(qs[cur][r * QS_STRIDE + n]) * ss[n];
    }
    __syncthreads();
    const float* xt = xs[cur];
#pragma unroll 4
    for (int kk = 0; kk < BK_FMA; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(ws + kk * BN + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xv = xt[(ty * 8 + i) * XS + kk];
        acc[i][0] = fmaf(xv, w.x, acc[i][0]);
        acc[i][1] = fmaf(xv, w.y, acc[i][1]);
        acc[i][2] = fmaf(xv, w.z, acc[i][2]);
        acc[i][3] = fmaf(xv, w.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  float* yg = static_cast<float*>(a.y) + (long long)e * a.M * a.N;
  const float* bg = a.bias ? static_cast<const float*>(a.bias) + e * a.b_es : nullptr;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n0 + tx * 4 + j;
    if (c >= a.N) continue;
    const float b = bg ? bg[c] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + ty * 8 + i;
      if (r < a.M) yg[(long long)r * a.N + c] = acc[i][j] + b;
    }
  }
}

// ----------------------------------------------------------- splitk_body
constexpr int SK_THREADS = 256;  // 8 warps: `split` of them per row of x
constexpr int SK_NB = 8;         // output columns per CTA (the narrow cut)
constexpr int SK_CH = 4;         // k values of x a lane reads at once (8 or 16 bytes)

// BYTES bytes from p (BYTES % 4 == 0) into 32-bit words, lowest address in
// the low byte, with the widest load the address allows
template <int BYTES>
__device__ __forceinline__ void load_words(const int8_t* p, uint32_t* w) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  if constexpr (BYTES % 16 == 0) {
    if ((addr & 15) == 0) {
#pragma unroll
      for (int i = 0; i < BYTES / 16; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z, w[4 * i + 3] = v.w;
      }
      return;
    }
  }
  if constexpr (BYTES % 8 == 0) {
    if ((addr & 7) == 0) {
#pragma unroll
      for (int i = 0; i < BYTES / 8; ++i) {
        const uint2 v = reinterpret_cast<const uint2*>(p)[i];
        w[2 * i] = v.x, w[2 * i + 1] = v.y;
      }
      return;
    }
  }
  if ((addr & 3) == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
    return;
  }
  const uint8_t* b = reinterpret_cast<const uint8_t*>(p);
#pragma unroll
  for (int i = 0; i < BYTES / 4; ++i)
    w[i] = b[4 * i] | (uint32_t(b[4 * i + 1]) << 8) | (uint32_t(b[4 * i + 2]) << 16) | (uint32_t(b[4 * i + 3]) << 24);
}

// Rows of x go to groups of `split` warps (rows per CTA = 8 / split); the
// warps of a row take its 4-value chunks of K in turn, a lane a chunk. A
// CTA owns NB output columns (columns n0 .. n0 + NB of y; NB = N when N <=
// 8, so q's rows k0 .. k0 + CH are one contiguous span of CH * N bytes).
template <typename T, int NB>
__global__ void __launch_bounds__(SK_THREADS) splitk_body(Args a, int split) {
  constexpr int CH = SK_CH;           // k values per chunk of x
  constexpr int CB = CH * sizeof(T);  // its bytes
  using Vec = typename std::conditional<CB == 16, uint4, uint2>::type;
  constexpr int QW = CH * NB / 4;     // words of q per chunk (CH * NB % 4 == 0)
  __shared__ float red[SK_THREADS / 32][NB];

  const int e = blockIdx.z, n0 = blockIdx.y * NB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = (SK_THREADS / 32) / split;
  const int m = blockIdx.x * rows + warp / split, slice = warp % split;
  const int nb = min(NB, a.N - n0);  // live columns of this CTA
  const T* xr = static_cast<const T*>(a.x) + e * a.x_es + (long long)m * a.x_rs;
  const int8_t* qg = a.q + e * a.q_es + n0;
  const float* sg = a.scale + e * a.s_es + n0;

  // the thread that writes y[mm][n0 + j] reads its bias now, beside the
  // loads of x and q, not after the reduction
  const int r = threadIdx.x / NB, j = threadIdx.x % NB, mm = blockIdx.x * rows + r;
  const bool writes = r < rows && mm < a.M && j < nb;
  const float bias = writes && a.bias ? to_f32(static_cast<const T*>(a.bias)[e * a.b_es + n0 + j]) : 0.f;
  float s[NB], acc[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    s[i] = i < nb ? sg[i] : 0.f;
    acc[i] = 0.f;
  }
  if (m < a.M) {
    const int nch = (a.K + CH - 1) / CH;
#pragma unroll 2
    for (int c = slice * 32 + lane; c < nch; c += split * 32) {
      const int k0 = c * CH;
      const bool full = k0 + CH <= a.K;
      float xv[CH];
      const T* xp = xr + k0;
      if (full && (reinterpret_cast<uintptr_t>(xp) & (CB - 1)) == 0) {
        const Vec v = *reinterpret_cast<const Vec*>(xp);
        const T* tv = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int i = 0; i < CH; ++i) xv[i] = to_f32(tv[i]);
      } else {
#pragma unroll
        for (int i = 0; i < CH; ++i) xv[i] = k0 + i < a.K ? to_f32(xp[i]) : 0.f;
      }
      uint32_t qw[QW];
      const int8_t* qp = qg + (long long)k0 * a.N;
      bool loaded = false;
      if (full && nb == NB) {
        if (a.N == NB) {
          load_words<CH * NB>(qp, qw);  // the chunk's q rows are one span
          loaded = true;
        } else if constexpr (NB % 4 == 0) {  // a column group of a wider q: NB bytes a row
#pragma unroll
          for (int k = 0; k < CH; ++k) load_words<NB>(qp + (long long)k * a.N, qw + k * NB / 4);
          loaded = true;
        }
      }
      if (!loaded) {  // K's tail or a ragged column group, byte by byte
#pragma unroll
        for (int i = 0; i < QW; ++i) {
          uint32_t word = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int k = (4 * i + b) / NB, n = (4 * i + b) % NB;
            if (k0 + k < a.K && n < nb) word |= uint32_t(uint8_t(qp[(long long)k * a.N + n])) << (8 * b);
          }
          qw[i] = word;
        }
      }
#pragma unroll
      for (int k = 0; k < CH; ++k)
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int b = k * NB + i;
          const float qf = float(static_cast<int8_t>(qw[b / 4] >> (8 * (b % 4))));
          acc[i] = fmaf(xv[k], to_f32(from_f32<T>(qf * s[i])), acc[i]);  // W = T(q * scale)
        }
    }
  }
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < NB; ++i) red[warp][i] = acc[i];
  __syncthreads();
  if (writes) {
    float sum = 0.f;
    for (int sl = 0; sl < split; ++sl) sum += red[r * split + sl][j];  // in a fixed order
    static_cast<T*>(a.y)[((long long)e * a.M + mm) * a.N + n0 + j] = from_f32<T>(sum + bias);
  }
}

// ------------------------------------------------------------ wgmma_body
constexpr int WG_BN = 128;  // output channels per CTA: two consumer warpgroups of 64
constexpr int WG_BK = 64;   // K per stage: one 128-byte swizzled row of x
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 2 * 128 + 32;  // two consumer warpgroups, then the producer warp

template <int BM>
struct WgCfg {
  static constexpr int X_BYTES = BM * WG_BK * 2;    // x stage [BM rows][64 k], 128-byte swizzle
  static constexpr int Q_BYTES = WG_BK * WG_BN;     // q stage [64 k][128 n] int8, 128-byte swizzle
  static constexpr int SMEM = 1024 + WG_STAGES * (X_BYTES + Q_BYTES) + 16 * WG_STAGES;
  static_assert(BM == 128 || BM == 192, "wgmma width");
};
static_assert(WgCfg<192>::SMEM <= 232448, "BM = 192 exceeds shared memory");

struct WgArgs {
  const float* scale;
  const void* bias;
  void* y;
  int M, N, K;
  long long s_es, b_es;
  int x_3d, q_3d;  // the map walks members (else one x or q serves them all)
};

// one box of a 2-D or 3-D tensor map into shared memory (c2: the member)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                         int c2, int three_d) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (three_d)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
        "l"(m), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"(m), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Four int8 values (one 32-bit word, the lowest address in the low byte)
// to two packed pairs of T: bytes 0 and 1 times s_lo into lo, bytes 2 and 3
// times s_hi into hi. The bytes, biased by 128 with one XOR, are permuted
// into the low byte of the float 2^23 (0x4B0000bb = 2^23 + bb), and one
// FADD of -(2^23 + 128) leaves q exactly: no I2F. The scale is multiplied
// in float32 and each product rounded once to T, as the plain version
// rounds W = T(float(q) * scale).
template <typename T>
__device__ __forceinline__ void dequant4(uint32_t w, float s_lo, float s_hi, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = pack2(f0 * s_lo, f1 * s_lo, static_cast<T*>(nullptr));
  hi = pack2(f2 * s_hi, f3 * s_hi, static_cast<T*>(nullptr));
}

#define I8_ACC8(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define I8_ACC32(i) I8_ACC8(i), I8_ACC8(i + 8), I8_ACC8(i + 16), I8_ACC8(i + 24)
#define I8_R64                                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define I8_R96                                                                              \
  I8_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
         "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define I8_AIN "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
// d[0..N/2) += A(64x16, registers) * B(16xN, shared, K-major). A fragment
// of warp w of the warpgroup, lane 4g + t: a[0] = A[16w + g][2t, 2t + 1],
// a[1] = A[16w + g + 8][2t, 2t + 1], a[2], a[3] the same at columns 2t + 8,
// 2t + 9. Accumulator, chunk j = 0..N/8-1: d[4j], d[4j+1] at (row 16w + g,
// cols 8j + 2t, +1) and d[4j+2], d[4j+3] at row 16w + g + 8.
#define I8_WGMMA_N128(TY)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
               "{" I8_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"  \
               : I8_ACC32(0), I8_ACC32(32) : I8_AIN)
#define I8_WGMMA_N192(TY)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " " \
               "{" I8_R96 "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n" \
               : I8_ACC32(0), I8_ACC32(32), I8_ACC32(64) : I8_AIN)
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (N == 128) {
    if constexpr (BF) I8_WGMMA_N128("bf16");
    else I8_WGMMA_N128("f16");
  } else {
    static_assert(N == 192, "wgmma width");
    if constexpr (BF) I8_WGMMA_N192("bf16");
    else I8_WGMMA_N192("f16");
  }
}

// y^T tile [128 n][BM m] of one member: A = the dequantized W^T in
// registers, B = the x stage, so wgmma's N is BM rows of x and its M is
// 64 output channels per warpgroup.
template <typename T, int BM>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wgmma_body(__grid_constant__ const CUtensorMap tm_x, __grid_constant__ const CUtensorMap tm_q, WgArgs a) {
  using C = WgCfg<BM>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
  uint8_t* x_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = x_s + WG_STAGES * C::X_BYTES;
  const uint32_t full0 = smem_u32(q_s + WG_STAGES * C::Q_BYTES), empty0 = full0 + 8 * WG_STAGES;

  const int e = blockIdx.z, n_tile = blockIdx.x * WG_BN, m0 = blockIdx.y * BM;
  const int nk = (a.K + WG_BK - 1) / WG_BK;  // >= 1: the body needs K > 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      prefetch_map(&tm_x);
      prefetch_map(&tm_q);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG_STAGES;
        if (kt >= WG_STAGES) mbar_wait(empty0 + 8 * s, ((kt / WG_STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, C::X_BYTES + C::Q_BYTES);
        tma_load(smem_u32(x_s + s * C::X_BYTES), &tm_x, full, kt * WG_BK, m0, e, a.x_3d);
        tma_load(smem_u32(q_s + s * C::Q_BYTES), &tm_q, full, n_tile, kt * WG_BK, e, a.q_3d);
      }
    }
    return;
  }

  // Consumers. Row r of warpgroup wg's A (r = 16w + g, and r + 8) is output
  // channel n0 (n0 + 1) with n0 = n_tile + wg*64 + 16w + 2g: a permutation
  // of the 64 channels that puts a thread's two channels side by side, so
  // one 16-bit load of a q row gives both. In the swizzled q stage, channel
  // n of k row k sits in 16-byte chunk (n / 16) ^ (k % 8); the rows a thread
  // reads are k = 16kk + 2t (+ 8) and the next, so k % 8 is 2t or 2t + 1.
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int chunk = wg * 4 + w;
  const uint32_t col_even = ((chunk ^ (2 * t)) << 4) + 2 * g, col_odd = ((chunk ^ (2 * t + 1)) << 4) + 2 * g;
  const int n0 = n_tile + wg * 64 + 16 * w + 2 * g;
  const bool live = n0 < a.N;  // N % 16 == 0, so n0 + 1 < N too
  const float* sg = a.scale + e * a.s_es;
  const float s0 = live ? sg[n0] : 0.f, s1 = live ? sg[n0 + 1] : 0.f;
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  const uint32_t xa0 = smem_u32(x_s);

  // Per K tile: wait for the stage, build the A fragments of its four k16
  // steps from the int8 rows, issue the products, wait for them, release
  // the stage. Fragment rows: k = 2t, 2t + 1 (half 0) and 2t + 8, 2t + 9
  // (half 1); a PRMT interleaves the two rows' bytes as (k, n0), (k + 1,
  // n0), (k, n0 + 1), (k + 1, n0 + 1), which dequant4 turns into the pair
  // of row r (scale s0) and the pair of row r + 8 (scale s1). The two
  // warpgroups share the tensor cores: one builds while the other's
  // products run.
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % WG_STAGES;
    mbar_wait(full0 + 8 * s, (kt / WG_STAGES) & 1);
    const uint8_t* qt = q_s + s * C::Q_BYTES + 2 * t * 128;
    uint32_t af[WG_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint8_t* row = qt + (kk * 16 + half * 8) * 128;
        const uint32_t lo = *reinterpret_cast<const uint16_t*>(row + col_even);
        const uint32_t hi = *reinterpret_cast<const uint16_t*>(row + 128 + col_odd);
        dequant4<T>(__byte_perm(lo, hi, 0x5140), s0, s1, af[kk][2 * half], af[kk][2 * half + 1]);
      }
    // x stage s as B: 8 rows are one 1024-byte swizzle atom (SBO), a k16
    // step is 32 bytes along the row
    const uint32_t xa = xa0 + s * C::X_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) wgmma_rs<T, BM>(acc, af[kk], sw128_desc(xa + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait0();
    reg_fence(acc);
    reg_fence(af);
    mbar_arrive(empty0 + 8 * s);
  }

  // epilogue: y[m][n0], y[m][n0 + 1] = acc + bias in float32, one rounding
  // to T, stored as pairs: a warp's store covers 32 contiguous bytes of
  // each of 4 rows of y
  if (!live) return;
  float b0 = 0.f, b1 = 0.f;
  if (a.bias) {
    const T* bg = static_cast<const T*>(a.bias) + e * a.b_es;
    b0 = to_f32(bg[n0]);
    b1 = to_f32(bg[n0 + 1]);
  }
  T* yg = static_cast<T*>(a.y) + (long long)e * a.M * a.N + n0;
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    const int m = m0 + 8 * j + 2 * t;
    if (m < a.M)
      *reinterpret_cast<uint32_t*>(yg + (long long)m * a.N) =
          pack2(acc[4 * j] + b0, acc[4 * j + 2] + b1, static_cast<T*>(nullptr));
    if (m + 1 < a.M)
      *reinterpret_cast<uint32_t*>(yg + (long long)(m + 1) * a.N) =
          pack2(acc[4 * j + 1] + b0, acc[4 * j + 3] + b1, static_cast<T*>(nullptr));
  }
}


// ----------------------------------------------------------- tf32x2_body
// Float32 x on the tensor cores in tf32, in wgmma_body's orientation: y^T
// = W^T x^T, the int8 q as wgmma's A in registers (exact as tf32, and
// unscaled), x as its B from shared memory, K-major (the one layout tf32
// wgmma takes for B). One CTA = two consumer warpgroups (64 output
// channels each) and one producer warp, for a [128 rows][128 channels]
// tile of y; K walks in 32-deep stages (one 128-byte swizzled row of
// float32 x) through a 4-stage TMA ring, with full and empty mbarriers.
//   - Split: once a stage lands, the 256 consumer threads rewrite its x in
//     place as hi = x & ~0x1fff and write lo = (x - hi) & ~0x1fff at the
//     same offset of a lo stage (an elementwise pass keeps the swizzle),
//     then fence.proxy.async: the stage's products are lo * q, then hi * q
//     for each k8 step, 8 wgmma m64n128k8 a warpgroup. The split of stage
//     k + 1 runs while stage k's products are in flight; a named barrier
//     of the two warpgroups then hands it over.
//   - A fragments per k8 step: row r = 16w + g of a warpgroup is channel
//     n0 and r + 8 is n0 + 1 (wgmma_body's permutation), k index t is k row
//     8kk + t and t + 4 is 8kk + t + 4; one 16-bit load of a swizzled q row
//     gives both channels, and PRMT into the float 2^23 and one FADD give
//     exact floats (no I2F).
//   - The tensor cores truncate what they add into the accumulator they
//     are given: each stage's 8 products go into a fresh accumulator
//     (wgmma's scale-d 0 on the first) that an FADD folds into the running
//     float32 sum.
//   - Epilogue: y = acc * scale[n] + bias[n], one FMA in float32.
// The running and the fresh accumulators take 128 registers a thread (ptxas:
// 168 in all, no spill): one CTA an SM, with 145 KB of shared memory (4 x
// (16 KB x + 16 KB lo + 4 KB q)).
constexpr int TW_BM = 128;  // rows of x per CTA: wgmma's N
constexpr int TW_BK = 32;   // K per stage: one 128-byte swizzled row of float32 x
constexpr int TW_STAGES = 4;
constexpr int TW_X_BYTES = TW_BM * TW_BK * 4;
constexpr int TW_Q_BYTES = TW_BK * WG_BN;
constexpr int TW_SMEM = 1024 + TW_STAGES * (2 * TW_X_BYTES + TW_Q_BYTES) + 16 * TW_STAGES;
static_assert(TW_SMEM <= 232448, "tf32x2 stages");

#define TW_AIN(SD) "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SD)
__device__ __forceinline__ void wgmma_tf32_n128(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
               "{" I8_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
               : I8_ACC32(0), I8_ACC32(32) : TW_AIN(scale_d));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__global__ void __launch_bounds__(WG_THREADS, 1)
    tf32x2_body(__grid_constant__ const CUtensorMap tm_x, __grid_constant__ const CUtensorMap tm_q, WgArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* x_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* lo_s = x_s + TW_STAGES * TW_X_BYTES;
  uint8_t* q_s = lo_s + TW_STAGES * TW_X_BYTES;
  const uint32_t full0 = smem_u32(q_s + TW_STAGES * TW_Q_BYTES), empty0 = full0 + 8 * TW_STAGES;

  const int e = blockIdx.z, n_tile = blockIdx.x * WG_BN, m0 = blockIdx.y * TW_BM;
  const int nk = (a.K + TW_BK - 1) / TW_BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TW_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      prefetch_map(&tm_x);
      prefetch_map(&tm_q);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % TW_STAGES;
        if (kt >= TW_STAGES) mbar_wait(empty0 + 8 * s, ((kt / TW_STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, TW_X_BYTES + TW_Q_BYTES);
        tma_load(smem_u32(x_s + s * TW_X_BYTES), &tm_x, full, kt * TW_BK, m0, e, a.x_3d);
        tma_load(smem_u32(q_s + s * TW_Q_BYTES), &tm_q, full, n_tile, kt * TW_BK, e, a.q_3d);
      }
    }
    return;
  }

  const int tid = threadIdx.x, wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int chunk = wg * 4 + w;
  const uint32_t col_t = ((chunk ^ t) << 4) + 2 * g, col_t4 = ((chunk ^ (t + 4)) << 4) + 2 * g;
  const int n0 = n_tile + wg * 64 + 16 * w + 2 * g;
  const bool live = n0 < a.N;
  float acc[TW_BM / 2], part[TW_BM / 2];
#pragma unroll
  for (int i = 0; i < TW_BM / 2; ++i) acc[i] = part[i] = 0.f;

  // split stage kt in place once it has landed: hi = x & ~0x1fff where it
  // lies, lo = (x - hi) & ~0x1fff at the same offset of the lo stage
  auto split = [&](int kt) {
    const int s = kt % TW_STAGES;
    mbar_wait(full0 + 8 * s, (kt / TW_STAGES) & 1);
    float4* xv = reinterpret_cast<float4*>(x_s + s * TW_X_BYTES);
    float4* lv = reinterpret_cast<float4*>(lo_s + s * TW_X_BYTES);
#pragma unroll
    for (int i = 0; i < TW_X_BYTES / 16 / 256; ++i) {
      const float4 v = xv[tid + i * 256];
      const float vv[4] = {v.x, v.y, v.z, v.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hi[j] = __float_as_uint(vv[j]) & 0xffffe000u;
        lo[j] = __float_as_uint(vv[j] - __uint_as_float(hi[j])) & 0xffffe000u;
      }
      xv[tid + i * 256] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]), __uint_as_float(hi[2]),
                                      __uint_as_float(hi[3]));
      lv[tid + i * 256] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]), __uint_as_float(lo[2]),
                                      __uint_as_float(lo[3]));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  };
  split(0);
  named_sync(1, 256);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % TW_STAGES;
    const uint8_t* qt = q_s + s * TW_Q_BYTES;  // A fragments, as set out above
    uint32_t af[TW_BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < TW_BK / 8; ++kk) {
      const uint32_t r0 = *reinterpret_cast<const uint16_t*>(qt + (kk * 8 + t) * 128 + col_t);
      const uint32_t r4 = *reinterpret_cast<const uint16_t*>(qt + (kk * 8 + t + 4) * 128 + col_t4);
      const uint32_t u = (r0 | (r4 << 16)) ^ 0x80808080u;
      af[kk][0] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f);
      af[kk][1] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f);
      af[kk][2] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f);
      af[kk][3] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f);
    }
    const uint32_t xa = smem_u32(x_s + s * TW_X_BYTES), la = smem_u32(lo_s + s * TW_X_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TW_BK / 8; ++kk) {
      wgmma_tf32_n128(part, af[kk], sw128_desc(la + kk * 32, 16, 1024), kk > 0);
      wgmma_tf32_n128(part, af[kk], sw128_desc(xa + kk * 32, 16, 1024), 1);
    }
    wgmma_commit();
    if (kt + 1 < nk) split(kt + 1);  // under this stage's products
    wgmma_wait0();
    reg_fence(part);
    reg_fence(af);
    mbar_arrive(empty0 + 8 * s);
#pragma unroll
    for (int i = 0; i < TW_BM / 2; ++i) acc[i] += part[i];
    named_sync(1, 256);  // both warpgroups' splits of stage kt + 1 are in
  }

  if (!live) return;
  const float* sg = a.scale + e * a.s_es;
  const float s0 = sg[n0], s1 = sg[n0 + 1];
  float b0 = 0.f, b1 = 0.f;
  if (a.bias) {
    const float* bg = static_cast<const float*>(a.bias) + e * a.b_es;
    b0 = bg[n0];
    b1 = bg[n0 + 1];
  }
  float* yg = static_cast<float*>(a.y) + (long long)e * a.M * a.N + n0;
#pragma unroll
  for (int j = 0; j < TW_BM / 8; ++j) {
    const int m = m0 + 8 * j + 2 * t;
    if (m < a.M)
      *reinterpret_cast<float2*>(yg + (long long)m * a.N) =
          make_float2(fmaf(acc[4 * j], s0, b0), fmaf(acc[4 * j + 2], s1, b1));
    if (m + 1 < a.M)
      *reinterpret_cast<float2*>(yg + (long long)(m + 1) * a.N) =
          make_float2(fmaf(acc[4 * j + 1], s0, b0), fmaf(acc[4 * j + 3], s1, b1));
  }
}

// ---------------------------------------------------------- fewrows_body
// Few rows of x (a decode step's 8, a pooler's 32) against a wide q. The
// tiled bodies' 128-row tiles leave such a call a few CTAs and serial K
// tiles; here the card's SMs share q's bytes, each read once, and the
// products are mma.sync m16n8k16 with the weights as A: a warp step is 16
// k rows x 32 output channels (one 4-byte load of q per lane and k row: a
// warp's load covers 4 rows of 32 contiguous bytes), built in registers as
// wgmma_body builds its A (PRMT, dequant4: W = T(q * scale) rounded once,
// the plain version's rounding point); x's rows are B, k16 x n8: 8 rows are
// one n8 tile, read straight from device memory (8 bytes a lane, in
// fragment order). Both are permuted so that each lane's bytes are
// contiguous: fragment row g of block j is channel FR_CPT g + 2j (row g + 8
// is FR_CPT g + 2j + 1), and the fragment's k index 2t, 2t + 1, 2t + 8,
// 2t + 9 is the step's k row 4t .. 4t + 3. Float32 x takes the same A
// exact (q as tf32, unscaled; the scale moves to the epilogue as in
// tf32x2_body) on mma.sync m16n8k8 in two passes over x = hi + lo; each
// k16 step's four products go into a fresh accumulator folded in by an
// FADD (the tensor cores truncate what they add into one).
// Grid (FR_CLUSTER, ceil(N / FR_CH), E x row groups of 8 NT rows), one
// thread-block cluster along K: the cluster's FR_CLUSTER CTAs take K
// slices of whole k16 steps, a CTA's warps FR_WARP_STEPS steps each, all
// their loads in flight at once (FR_DEPTH deep); the bias (and float32's
// scale) is read beside them. Sums: the warps' partials meet in shared
// memory and are summed in warp order; each row goes by a remote store to
// the rank that stores it (row r NT .. r NT + NT - 1: rank r); one cluster
// barrier; each rank sums its rows over the ranks in rank order, adds the
// bias, rounds once to T and stores: no atomics, no workspace, one launch;
// a rerun gives the same bits. The tile (32 channels, 2 steps a warp, up
// to 12 warps) is the one that measured fastest at GPT-2-small's decode
// shapes (PERF.md, int8_fewrows_probe.py): the registers a thread holds
// decide how many clusters are active at once, and with 64 channels and a
// step a warp qkv's 36 clusters ran in two waves. At 32 rows a warp's
// steps load one at a time (FR_DEPTH_32): with both in flight mlp_in lost
// to wgmma_body.
constexpr int FR_CLUSTER = 8;                // CTAs along K: one portable cluster
constexpr int FR_JB = 2;                     // 16-channel mma blocks per warp
constexpr int FR_CPT = 2 * FR_JB;            // output channels (bytes of a q row) per lane
constexpr int FR_CH = 8 * FR_CPT;            // output channels per CTA
constexpr int FR_WARPS = 12;                 // warps per CTA at most
constexpr int FR_WARP_STEPS = 2;             // k16 steps of the slice per warp (fewer warps: more CTAs an SM)
constexpr int FR_DEPTH = 2;                  // warp steps whose loads are in flight together
constexpr int FR_DEPTH_32 = 1;               // at 32 rows (NT = 4): fewer registers, more CTAs an SM
constexpr int FR_MAX_ROWS = 32;              // select_body's FEW_ROWS_WIDE
constexpr int FR_NARROW_N = 32;              // splitk keeps N <= 8, and N <= 32 ...
constexpr int FR_NARROW_ROWS = 128;          // ... at up to 128 rows

// what fewrows_body takes: every dtype, stride and offset, past the
// narrow cut and up to FR_MAX_ROWS rows (select_body holds the same rule)
bool fewrows_takes(int M, int N) {
  return M <= FR_MAX_ROWS && N > SK_NB && (N > FR_NARROW_N || M > FR_NARROW_ROWS);
}

// four values of x from k (k % 4 == 0) as raw words in fragment order
// (bf16 / f16: two packed pairs, float32: four floats); zero past K
template <typename T>
__device__ __forceinline__ void fr_load_x(const T* row, int k, int K, bool vec, uint32_t* w) {
  constexpr int XW = sizeof(T);  // words per four values
  if (vec && k + 4 <= K) {
    if constexpr (XW == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + k);
      w[0] = v.x, w[1] = v.y;
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(row + k);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < XW; ++i) w[i] = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (k + i >= K) break;
    if constexpr (XW == 2)
      w[i / 2] |= uint32_t(reinterpret_cast<const uint16_t*>(row)[k + i]) << (16 * (i % 2));
    else
      w[i] = reinterpret_cast<const uint32_t*>(row)[k + i];
  }
}

// FR_CPT bytes of q's row k from channel c (zero past K and N)
__device__ __forceinline__ void fr_load_q(const int8_t* qg, int k, int c, const Args& a, bool vec, uint32_t* w) {
  const int8_t* p = qg + (long long)k * a.N + c;
  if (vec && k < a.K && c + FR_CPT <= a.N) {
    if constexpr (FR_CPT == 8) {  // 64 channels a CTA (int8_fewrows_probe.py's ch64)
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    } else {
      static_assert(FR_CPT == 4, "a lane's q bytes: one 4- or 8-byte load");
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < FR_CPT / 4; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (k < a.K && c + 4 * i + b < a.N) word |= uint32_t(uint8_t(p[4 * i + b])) << (8 * b);
    w[i] = word;
  }
}

// the two halves of a cluster barrier: a CTA may touch another's shared
// memory only once every CTA of the cluster has arrived (has started)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// q's four bytes in a word as exact floats (tf32 operands): no I2F
__device__ __forceinline__ void exact4(uint32_t u, uint32_t* f) {
  u ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f);
}

template <typename T, int NT>
__global__ void __launch_bounds__(FR_WARPS * 32) __cluster_dims__(FR_CLUSTER, 1, 1)
    fewrows_body(Args a, int slice_steps, int row_groups) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int XW = sizeof(T);
  constexpr int TO = 8 * NT * FR_CH;  // a CTA's partial: [8 NT rows][FR_CH channels] floats
  constexpr int RPR = 8 * NT / FR_CLUSTER;  // rows of the tile each rank stores
  static_assert(RPR * FR_CLUSTER == 8 * NT, "the ranks split the tile's rows");
  constexpr int depth = NT >= 4 ? FR_DEPTH_32 : FR_DEPTH;
  extern __shared__ float fr_red[];  // [warps][TO], the bias and scale of the CTA's channels, recv [TO]
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = static_cast<int>(cluster.block_rank());
  cluster_arrive_relaxed();  // waited for before the first remote store
  const int n0 = blockIdx.y * FR_CH, e = blockIdx.z / row_groups, r0 = (blockIdx.z % row_groups) * 8 * NT;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, c0 = n0 + FR_CPT * g;
  const int ksteps = (a.K + 15) / 16;
  const int s_begin = rank * slice_steps, s_end = min(ksteps, s_begin + slice_steps);
  const T* xg = static_cast<const T*>(a.x) + e * a.x_es;
  const int8_t* qg = a.q + e * a.q_es;
  const bool vec_x = a.vec_x, vec_q = a.vec_q;

  float sc[FR_CPT];  // bf16 / f16: the scales of this lane's channels (float32 scales in the epilogue)
#pragma unroll
  for (int i = 0; i < FR_CPT; ++i) sc[i] = !F32 && c0 + i < a.N ? a.scale[e * a.s_es + c0 + i] : 0.f;
  // the epilogue's bias (and float32's scale) of the CTA's channels, read
  // beside q and put in shared memory after the K loop: no second round
  // trip to device memory before the store
  const T* bg = a.bias ? static_cast<const T*>(a.bias) + e * a.b_es : nullptr;
  float edge[2][FR_CH / 32];
#pragma unroll
  for (int i = 0; i < FR_CH / 32; ++i) {
    const int n = n0 + threadIdx.x + i * blockDim.x;
    const bool in = threadIdx.x + i * blockDim.x < FR_CH && n < a.N;
    edge[0][i] = in && bg ? to_f32(bg[n]) : 0.f;
    edge[1][i] = in && F32 ? a.scale[e * a.s_es + n] : 0.f;
  }
  float acc[FR_JB][NT][4];
#pragma unroll
  for (int j = 0; j < FR_JB; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0.f;

  for (int s0 = s_begin + warp; s0 < s_end; s0 += warps * depth) {  // warp w: steps w, w + warps, ...
    uint32_t qw[depth][4][FR_CPT / 4], xw[depth][NT][XW];
#pragma unroll
    for (int d = 0; d < depth; ++d) {  // every load of the chunk first
      const int k = (s0 + d * warps) * 16 + 4 * t;
      const bool live = s0 + d * warps < s_end;
#pragma unroll
      for (int i = 0; i < 4; ++i) fr_load_q(qg, live ? k + i : a.K, c0, a, vec_q, qw[d][i]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = r0 + nt * 8 + g;
        fr_load_x<T>(xg + (long long)min(m, a.M - 1) * a.x_rs, k, live && m < a.M ? a.K : 0, vec_x, xw[d][nt]);
      }
    }
#pragma unroll
    for (int d = 0; d < depth; ++d) {
      if (s0 + d * warps >= s_end) break;
#pragma unroll
      for (int j = 0; j < FR_JB; ++j) {
        // bytes 2j, 2j + 1 of rows (4t, 4t + 1) and (4t + 2, 4t + 3), interleaved
        const int wi = j / 2, o = 2 * (j % 2);
        const uint32_t sel = o | (o + 4) << 4 | (o + 1) << 8 | (o + 5) << 12;
        const uint32_t u01 = __byte_perm(qw[d][0][wi], qw[d][1][wi], sel);
        const uint32_t u23 = __byte_perm(qw[d][2][wi], qw[d][3][wi], sel);
        if constexpr (F32) {
          // k8 pass A: rows 4t (k t) and 4t + 1 (k t + 4); pass B: 4t + 2, 4t + 3
          uint32_t fa[4], fb[4];
          exact4(u01, fa);
          exact4(u23, fb);
          const uint32_t pa[4] = {fa[0], fa[2], fa[1], fa[3]}, pb[4] = {fb[0], fb[2], fb[1], fb[3]};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              hi[i] = xw[d][nt][i] & 0xffffe000u;
              lo[i] = __float_as_uint(__uint_as_float(xw[d][nt][i]) - __uint_as_float(hi[i])) & 0xffffe000u;
            }
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(part, pa, lo[0], lo[1]);
            mma_tf32(part, pa, hi[0], hi[1]);
            mma_tf32(part, pb, lo[2], lo[3]);
            mma_tf32(part, pb, hi[2], hi[3]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][nt][i] += part[i];
          }
        } else {
          uint32_t af[4];
          dequant4<T>(u01, sc[2 * j], sc[2 * j + 1], af[0], af[1]);
          dequant4<T>(u23, sc[2 * j], sc[2 * j + 1], af[2], af[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_16816<T>(acc[j][nt], af, xw[d][nt]);
        }
      }
    }
  }

  // the warps' partials in shared memory, [warp][row][channel]
  float* red = fr_red + warp * TO;
#pragma unroll
  for (int j = 0; j < FR_JB; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = FR_CPT * g + 2 * j, m = nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(red + m * FR_CH + c) = make_float2(acc[j][nt][0], acc[j][nt][2]);
      *reinterpret_cast<float2*>(red + (m + 1) * FR_CH + c) = make_float2(acc[j][nt][1], acc[j][nt][3]);
    }
  float* edge_s = fr_red + warps * TO;  // [2][FR_CH]: bias, scale
  float* recv = edge_s + 2 * FR_CH;     // [FR_CLUSTER ranks][RPR rows][FR_CH]: the rows this rank stores
#pragma unroll
  for (int i = 0; i < FR_CH / 32; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < FR_CH) edge_s[c] = edge[0][i], edge_s[FR_CH + c] = edge[1][i];
  }
  __syncthreads();
  // each partial row, summed over the warps in warp order, goes to the
  // rank that stores it (row ml: rank ml / RPR), into this rank's slot of
  // its recv: remote stores, then one cluster barrier (release / acquire)
  cluster_wait();  // every rank has started: its shared memory is there
  for (int o = threadIdx.x; o < TO; o += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += fr_red[w * TO + o];
    const int ml = o / FR_CH;
    cluster.map_shared_rank(recv, ml / RPR)[(rank * RPR + ml % RPR) * FR_CH + o % FR_CH] = s;
  }
  cluster.sync();

  // rank r: rows r RPR .. r RPR + RPR - 1 of the tile, summed over the
  // ranks in rank order from its own shared memory
  for (int o = threadIdx.x; o < RPR * FR_CH; o += blockDim.x) {
    const int c = o % FR_CH, m = r0 + rank * RPR + o / FR_CH, n = n0 + c;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < FR_CLUSTER; ++r) v += recv[r * RPR * FR_CH + o];
    if (m < a.M && n < a.N) {
      const float b = edge_s[c];
      const float out = F32 ? fmaf(v, edge_s[FR_CH + c], b) : v + b;
      static_cast<T*>(a.y)[((long long)e * a.M + m) * a.N + n] = from_f32<T>(out);
    }
  }
}

// ------------------------------------------------------------------ host
// A map of rank 2 or 3 (columns, rows, member); strides in bytes of rows
// and members; out-of-bounds boxes read as zeros.
bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q's map depends on the weight's address, shape and member stride and the
// device alone. Weights are resident, so each is encoded once and every
// later call copies it from here.
struct QKey {
  const void* q;
  long long q_es;
  int E, K, N, dev, rows;
  bool operator==(const QKey& o) const {
    return q == o.q && q_es == o.q_es && E == o.E && K == o.K && N == o.N && dev == o.dev && rows == o.rows;
  }
};
struct QKeyHash {
  size_t operator()(const QKey& k) const {
    size_t h = std::hash<const void*>()(k.q);
    for (long long v : {k.q_es, (long long)k.E, (long long)k.K, (long long)k.N, (long long)k.dev, (long long)k.rows})
      h = h * 1000003u ^ std::hash<long long>()(v);
    return h;
  }
};

bool q_map(CUtensorMap* map, const void* q, int E, int K, int N, long long q_es, int dev, int rows = WG_BK) {
  static std::mutex mu;
  static std::unordered_map<QKey, CUtensorMap, QKeyHash> cache;
  const QKey key{q, q_es, E, K, N, dev, rows};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(q_es)};
  const cuuint32_t box[3] = {WG_BN, static_cast<cuuint32_t>(rows), 1};
  if (!encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, E > 1 && q_es != 0 ? 3 : 2, q, dims, strides, box,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  if (cache.size() >= 4096) cache.clear();  // bounded: weights come and go only with deployments
  cache.emplace(key, *map);
  return true;
}

// the tile height (rows of x) whose grid needs the fewest wave-heights,
// ceil(tiles / SMs) * BM; a tie keeps the taller tile (fewer re-reads of q)
int pick_bm(int E, int M, int N, int sms) {
  const long long cols = static_cast<long long>(E) * ((N + WG_BN - 1) / WG_BN);
  int best = 0;
  long long best_cost = 0;
  for (int bm : {192, 128}) {
    const long long tiles = cols * ((M + bm - 1) / bm);
    const long long cost = (tiles + sms - 1) / sms * bm;
    if (best == 0 || cost < best_cost) {
      best = bm;
      best_cost = cost;
    }
  }
  return best;
}

// what wgmma_body can address through TMA (ops/int8_matmul.py::select_body
// holds the same rule)
bool wgmma_takes(const void* x, const void* q, int M, int N, int K, long long x_es, long long x_rs, long long q_es,
                 int dtype) {
  return (dtype == 1 || dtype == 2) && K > 0 && K % 8 == 0 && x_rs % 8 == 0 && x_es % 8 == 0 && x_rs >= K &&
         x_es >= 0 && N % 16 == 0 && q_es % 16 == 0 && q_es >= 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(q) % 16 == 0 && (M + 127) / 128 <= 65535;
}

// what tf32x2_body can address through TMA: wgmma_takes for float32 x
// (select_body holds the same rule)
bool tf32x2_takes(const void* x, const void* q, int M, int N, int K, long long x_es, long long x_rs,
                  long long q_es, int dtype) {
  return dtype == 0 && K > 0 && K % 4 == 0 && x_rs % 4 == 0 && x_es % 4 == 0 && x_rs >= K && x_es >= 0 &&
         N % 16 == 0 && q_es % 16 == 0 && q_es >= 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(q) % 16 == 0 && (M + TW_BM - 1) / TW_BM <= 65535;
}

// warps per row of x: the fewest whose lanes hold every chunk of K at once
// (at most 8, a CTA)
int splitk_split(int K) {
  const long long chunks = (K + SK_CH - 1) / SK_CH;
  int split = 1;
  while (split < SK_THREADS / 32 && split * 32LL < chunks) split *= 2;
  return split;
}

template <typename T>
cudaError_t launch_splitk(const Args& a, int E, cudaStream_t stream) {
  const int split = splitk_split(a.K);
  const int rows = SK_THREADS / 32 / split;
  const int nb = a.N < SK_NB ? a.N : SK_NB;
  const dim3 grid((a.M + rows - 1) / rows, (a.N + nb - 1) / nb, E);
  switch (nb) {
    case 1: splitk_body<T, 1><<<grid, SK_THREADS, 0, stream>>>(a, split); break;
    case 2: splitk_body<T, 2><<<grid, SK_THREADS, 0, stream>>>(a, split); break;
    case 3: splitk_body<T, 3><<<grid, SK_THREADS, 0, stream>>>(a, split); break;
    case 4: splitk_body<T, 4><<<grid, SK_THREADS, 0, stream>>>(a, split); break;
    case 5: splitk_body<T, 5><<<grid, SK_THREADS, 0, stream>>>(a, split); break;
    case 6: splitk_body<T, 6><<<grid, SK_THREADS, 0, stream>>>(a, split); break;
    case 7: splitk_body<T, 7><<<grid, SK_THREADS, 0, stream>>>(a, split); break;
    default: splitk_body<T, SK_NB><<<grid, SK_THREADS, 0, stream>>>(a, split); break;
  }
  return cudaGetLastError();
}

cudaError_t launch_tf32x2(const Args& a, int E, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const WgArgs w{a.scale, a.bias, a.y, a.M, a.N, a.K, a.s_es, a.b_es, E > 1 && a.x_es != 0, E > 1 && a.q_es != 0};
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.K), static_cast<cuuint64_t>(a.M),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(a.x_rs) * 4, static_cast<cuuint64_t>(a.x_es) * 4};
  const cuuint32_t box[3] = {TW_BK, TW_BM, 1};
  CUtensorMap tx, tq;
  if (!encode(&tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w.x_3d ? 3 : 2, a.x, dims, strides, box,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !q_map(&tq, a.q, E, a.K, a.N, a.q_es, dev, TW_BK))
    return cudaErrorInvalidValue;
  static std::atomic<bool> smem_raised[MAX_DEVICES];
  if (dev >= MAX_DEVICES || !smem_raised[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(tf32x2_body, cudaFuncAttributeMaxDynamicSharedMemorySize, TW_SMEM);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) smem_raised[dev].store(true, std::memory_order_relaxed);
  }
  const dim3 grid((a.N + WG_BN - 1) / WG_BN, (a.M + TW_BM - 1) / TW_BM, E);
  tf32x2_body<<<grid, WG_THREADS, TW_SMEM, stream>>>(tx, tq, w);
  return cudaGetLastError();
}

template <typename T, int BM>
cudaError_t launch_wgmma(const void* x, const void* q, const float* scale, const void* bias, void* y, int E, int M,
                         int N, int K, long long x_es, long long x_rs, long long q_es, long long s_es,
                         long long b_es, int dev, cudaStream_t stream) {
  using C = WgCfg<BM>;
  const WgArgs a{scale, bias, y, M, N, K, s_es, b_es, E > 1 && x_es != 0, E > 1 && q_es != 0};
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M), static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(x_rs) * 2, static_cast<cuuint64_t>(x_es) * 2};
  const cuuint32_t box[3] = {WG_BK, BM, 1};
  const CUtensorMapDataType type =
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tx, tq;
  if (!encode(&tx, type, a.x_3d ? 3 : 2, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !q_map(&tq, q, E, K, N, q_es, dev))
    return cudaErrorInvalidValue;
  auto kernel = wgmma_body<T, BM>;
  static std::atomic<bool> smem_raised[MAX_DEVICES];
  if (dev >= MAX_DEVICES || !smem_raised[dev].load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) smem_raised[dev].store(true, std::memory_order_relaxed);
  }
  kernel<<<dim3((N + WG_BN - 1) / WG_BN, (M + BM - 1) / BM, E), WG_THREADS, C::SMEM, stream>>>(tx, tq, a);
  return cudaGetLastError();
}

// fewrows_body at NT row tiles of 8: K cut into FR_CLUSTER slices of whole
// k16 steps, a warp per step of the slice (at most FR_WARPS), row groups of
// 8 NT rows in grid z beside the members
template <typename T, int NT>
cudaError_t launch_fewrows_nt(Args a, int E, cudaStream_t stream) {
  const int ksteps = (a.K + 15) / 16;
  const int slice = (ksteps + FR_CLUSTER - 1) / FR_CLUSTER;
  const int per_warp = (slice + FR_WARP_STEPS - 1) / FR_WARP_STEPS;
  const int warps = per_warp < 1 ? 1 : per_warp < FR_WARPS ? per_warp : FR_WARPS;
  const int row_groups = (a.M + 8 * NT - 1) / (8 * NT);
  constexpr int most = ((FR_WARPS + 1) * 8 * NT + 2) * FR_CH * static_cast<int>(sizeof(float));
  auto kernel = fewrows_body<T, NT>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::atomic<bool> smem_raised[MAX_DEVICES];
  if (dev >= MAX_DEVICES || !smem_raised[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    // the L1 / shared split at its most shared: the default split held
    // this body to 2 CTAs an SM (30 active clusters: two waves at qkv's 36)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) smem_raised[dev].store(true, std::memory_order_relaxed);
  }
  const dim3 grid(FR_CLUSTER, (a.N + FR_CH - 1) / FR_CH, E * row_groups);
  kernel<<<grid, warps * 32, ((warps + 1) * 8 * NT + 2) * FR_CH * sizeof(float), stream>>>(a, slice, row_groups);
  return cudaGetLastError();
}

// the row tiles by M (row groups of 32 past 32 rows); the vector loads'
// rules: x rows of whole 4-value groups from an aligned base, q rows of
// whole FR_CPT-byte groups
template <typename T>
cudaError_t launch_fewrows(Args a, int E, cudaStream_t stream) {
  const long long x4 = 4;
  a.vec_x = a.x_rs % x4 == 0 && a.x_es % x4 == 0 && reinterpret_cast<uintptr_t>(a.x) % (4 * sizeof(T)) == 0;
  a.vec_q = a.N % FR_CPT == 0 && a.q_es % FR_CPT == 0 && reinterpret_cast<uintptr_t>(a.q) % FR_CPT == 0;
  if (a.M <= 8) return launch_fewrows_nt<T, 1>(a, E, stream);
  if (a.M <= 16) return launch_fewrows_nt<T, 2>(a, E, stream);
  return launch_fewrows_nt<T, 4>(a, E, stream);
}

template <typename T>
cudaError_t launch_wgmma_tiled(const void* x, const void* q, const float* scale, const void* bias, void* y, int E,
                               int M, int N, int K, long long x_es, long long x_rs, long long q_es, long long s_es,
                               long long b_es, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err != cudaSuccess) return err;
  switch (pick_bm(E, M, N, sms)) {
    case 192:
      return launch_wgmma<T, 192>(x, q, scale, bias, y, E, M, N, K, x_es, x_rs, q_es, s_es, b_es, dev, stream);
    default:
      return launch_wgmma<T, 128>(x, q, scale, bias, y, E, M, N, K, x_es, x_rs, q_es, s_es, b_es, dev, stream);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (activations, bias and y).
// body: 0 fma_body (float32, any shape), 1 mma_body (bf16 / f16, any
// shape), 2 wgmma_body (bf16 / f16, the shapes wgmma_takes), 3 splitk_body
// (every dtype, any shape), 4 tf32x2_body (float32, the shapes
// tf32x2_takes), 5 fewrows_body (every dtype, the calls fewrows_takes).
// Returns the launch's cudaError_t (0 on success); a body
// that cannot take the dtype or the shape returns cudaErrorInvalidValue
// without launching.
extern "C" int int8_matmul(const void* x, const void* q, const void* scale, const void* bias, void* y, int E,
                           int M, int N, int K, long long x_es, long long x_rs, long long q_es, long long s_es,
                           long long b_es, int dtype, int body, void* stream) {
  if (dtype < 0 || dtype > 2 || E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool takes = body == 0   ? dtype == 0
                     : body == 1 ? dtype != 0
                     : body == 2 ? wgmma_takes(x, q, M, N, K, x_es, x_rs, q_es, dtype)
                     : body == 3 ? (N + SK_NB - 1) / SK_NB <= 65535
                     : body == 4 ? tf32x2_takes(x, q, M, N, K, x_es, x_rs, q_es, dtype)
                     : body == 5 ? fewrows_takes(M, N) && (N + FR_CH - 1) / FR_CH <= 65535 &&
                                       static_cast<long long>(E) * ((M + 31) / 32) <= 65535
                                 : false;
  if (!takes) return static_cast<int>(cudaErrorInvalidValue);
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (body == 2) {
    const auto launch = dtype == 1 ? launch_wgmma_tiled<__nv_bfloat16> : launch_wgmma_tiled<__half>;
    return static_cast<int>(launch(x, q, sc, bias, y, E, M, N, K, x_es, x_rs, q_es, s_es, b_es, s));
  }
  Args a;
  a.x = x;
  a.q = static_cast<const int8_t*>(q);
  a.scale = sc;
  a.bias = bias;
  a.y = y;
  a.M = M;
  a.N = N;
  a.K = K;
  a.x_es = x_es;
  a.x_rs = x_rs;
  a.q_es = q_es;
  a.s_es = s_es;
  a.b_es = b_es;
  const long long ch = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  a.vec_x = K % ch == 0 && x_rs % ch == 0 && x_es % ch == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_q = N % 16 == 0 && q_es % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (body == 3) {
    const cudaError_t err = dtype == 0   ? launch_splitk<float>(a, E, s)
                            : dtype == 1 ? launch_splitk<__nv_bfloat16>(a, E, s)
                                         : launch_splitk<__half>(a, E, s);
    return static_cast<int>(err);
  }
  if (body == 4) return static_cast<int>(launch_tf32x2(a, E, s));
  if (body == 5) {
    const cudaError_t err = dtype == 0   ? launch_fewrows<float>(a, E, s)
                            : dtype == 1 ? launch_fewrows<__nv_bfloat16>(a, E, s)
                                         : launch_fewrows<__half>(a, E, s);
    return static_cast<int>(err);
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  if (dtype == 0) {
    fma_body<<<grid, THREADS, 0, s>>>(a);
  } else if (dtype == 1) {
    mma_body<__nv_bfloat16><<<grid, THREADS, 0, s>>>(a);
  } else {
    mma_body<__half><<<grid, THREADS, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
