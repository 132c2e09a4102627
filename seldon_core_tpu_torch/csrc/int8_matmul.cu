// W8A16 matmul for Hopper (sm_90a): y[e] = x[e] @ W[e] (+ bias[e]) with
// W[k, n] = q[k, n] * scale[n], accumulated in float32 and rounded once to T.
//
// Replaces no Pallas kernel: it replaces XLA's fusion of the JAX package's
// quant.dequantize into the consuming matmul (seldon_core_tpu/models/base.py
// :137-168, seldon_core_tpu/models/quant.py:64-76), where the dequantized
// weight never reaches HBM. Here it never leaves the SM: q crosses shared
// memory as int8 and is dequantized in registers.
//
// Layouts: x [E, M, K] through a member stride (0: one x shared by every
// member, as a fused ensemble's input is) and a row stride, K contiguous;
// q [E, K, N], N contiguous (the JAX layout quantize_params produces, last
// axis = output channel; a member stride of 0 shares one q); scale and
// bias [E, N]; y [E, M, N] contiguous. E is 1 except in a fused ensemble,
// where grid z walks the members.
//
// Three bodies. The caller names the body (ops/int8_matmul.py::select_body
// decides before the launch, and wgmma_takes below holds the same rule); a
// body asked for a shape or dtype it cannot take returns
// cudaErrorInvalidValue and launches nothing.
//   wgmma_body  bf16 / f16 activations whose operands TMA can address:
//               K > 0, K % 8 == 0, x's row and member strides % 8 == 0,
//               N % 16 == 0, q's member stride % 16 == 0, x and q bases
//               16-byte aligned (TMA's 16-byte rule for bases and global
//               strides). Every bf16 projection of BERT-base but the head.
//   mma_body    bf16 / f16, any shape (the BERT head, N = 2; iris, K = 4,
//               N = 3; views whose strides TMA cannot take). One CTA of 128
//               threads per 64x64 tile, a two-stage cp.async ring over
//               64-deep K tiles, mma.sync m16n8k16 with B fragments built
//               by hand from the staged int8 rows, the scale multiplied in
//               float32 and rounded to T before the product (the plain
//               version's rounding point). Ragged edges take a scalar copy
//               that zero-fills.
//   fma_body    float32 activations. BK = 32. Plain FMA, no TF32 (the
//               float32 contract holds): each K tile of q is dequantized
//               once into a float32 shared tile, then every thread
//               accumulates an 8x4 block of y.
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
  int E, K, N, dev;
  bool operator==(const QKey& o) const {
    return q == o.q && q_es == o.q_es && E == o.E && K == o.K && N == o.N && dev == o.dev;
  }
};
struct QKeyHash {
  size_t operator()(const QKey& k) const {
    size_t h = std::hash<const void*>()(k.q);
    for (long long v : {k.q_es, (long long)k.E, (long long)k.K, (long long)k.N, (long long)k.dev})
      h = h * 1000003u ^ std::hash<long long>()(v);
    return h;
  }
};

bool q_map(CUtensorMap* map, const void* q, int E, int K, int N, long long q_es, int dev) {
  static std::mutex mu;
  static std::unordered_map<QKey, CUtensorMap, QKeyHash> cache;
  const QKey key{q, q_es, E, K, N, dev};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(q_es)};
  const cuuint32_t box[3] = {WG_BN, WG_BK, 1};
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
// body: 0 fma_body (float32), 1 mma_body (bf16 / f16, any shape), 2
// wgmma_body (bf16 / f16, the shapes wgmma_takes). Returns the launch's
// cudaError_t (0 on success); a body that cannot take the dtype or the
// shape returns cudaErrorInvalidValue without launching.
extern "C" int int8_matmul(const void* x, const void* q, const void* scale, const void* bias, void* y, int E,
                           int M, int N, int K, long long x_es, long long x_rs, long long q_es, long long s_es,
                           long long b_es, int dtype, int body, void* stream) {
  if (dtype < 0 || dtype > 2 || E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool takes = body == 0   ? dtype == 0
                     : body == 1 ? dtype != 0
                     : body == 2 ? wgmma_takes(x, q, M, N, K, x_es, x_rs, q_es, dtype)
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
