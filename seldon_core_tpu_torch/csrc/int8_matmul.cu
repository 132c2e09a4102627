// W8A16 matmul for Hopper (sm_90a): y[e] = x[e] @ W[e] (+ bias[e]) with
// W[k, n] = cast_T(float(q[k, n]) * scale[n]), accumulated in float32.
//
// Replaces no Pallas kernel: it replaces XLA's fusion of the JAX package's
// quant.dequantize into the consuming matmul (seldon_core_tpu/models/base.py
// :137-168, seldon_core_tpu/models/quant.py:64-76), where the dequantized
// weight never reaches HBM. Here it never leaves registers: int8 tiles of q
// are staged in shared memory and turned into the matmul's B operand as the
// fragments are built, with the float32 scale multiplied in float32 before
// the one rounding to T (the reference's rounding point, element by
// element).
//
// Layouts: x [E, M, K] through a member stride (0: one x shared by every
// member, as a fused ensemble's input is) and a row stride, K contiguous;
// q [E, K, N], N contiguous (the JAX layout quantize_params produces, last
// axis = output channel); scale and bias [E, N]; y [E, M, N] contiguous.
// E is 1 except in a fused ensemble, where grid z walks the members.
//
// Two bodies, one CTA of 128 threads per 64x64 tile of y, a two-stage
// cp.async pipeline over K tiles:
//   mma_body   bf16 / f16 activations. BK = 64. mma.sync.m16n8k16 with
//              f32 accumulators, each warp a 32x32 quarter of the tile. A
//              fragments come from the x tile by 32-bit shared loads (rows
//              padded to 144 bytes: conflict-free). ldmatrix has no
//              int8-to-bf16 path, so each thread builds its B fragments by
//              hand: the four int8 values of q[k][n] it owns (k = 2t, 2t+1,
//              2t+8, 2t+9, n = lane / 4) are read from shared memory (rows
//              padded to 80 bytes: conflict-free), scaled in float32 and
//              packed to two bf16x2 registers.
//   fma_body   float32 activations. BK = 32. Plain FMA, no TF32 (the
//              float32 contract holds): each K tile of q is dequantized
//              once into a float32 shared tile, then every thread
//              accumulates an 8x4 block of y.
// The int8 rows are copied by 16-byte cp.async (a 64x64 int8 tile is 4 KB)
// and so are the x rows, when the strides and the base allow it; ragged M,
// N and K (the BERT head has N = 2, iris K = 4 and N = 3) take a scalar
// copy of the edge that zero-fills what lies outside. Bias is an optional
// float32 epilogue before the one rounding of y to T.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
// BERT-base's projections at M = 32 x 128 = 4096 rows are operations-bound
// (qkv: 14.5 GFLOP, 0.015 ms at peak, against 12.6 MB of x, q and y);
// at small M the int8 weight bytes bound it. This design is the simple
// and right one: mma.sync reaches a fraction of the wgmma rate, and the
// B fragments cost shared loads and conversions per mma. A fast design
// (wgmma with a register-resident dequantized operand, TMA) is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (activations, bias and y).
// Returns the launch's cudaError_t (0 on success).
extern "C" int int8_matmul(const void* x, const void* q, const void* scale, const void* bias, void* y,
                           int E, int M, int N, int K, long long x_es, long long x_rs, long long q_es,
                           long long s_es, long long b_es, int dtype, void* stream) {
  if (dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  Args a;
  a.x = x;
  a.q = static_cast<const int8_t*>(q);
  a.scale = static_cast<const float*>(scale);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fma_body<<<grid, THREADS, 0, s>>>(a);
  } else if (dtype == 1) {
    mma_body<__nv_bfloat16><<<grid, THREADS, 0, s>>>(a);
  } else {
    mma_body<__half><<<grid, THREADS, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
