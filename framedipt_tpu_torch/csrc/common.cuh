// Shared pieces of the edge-stack kernels: element-type conversion, a
// shared-memory-tiled float32 product for 64-row tiles with a double-buffered
// weight stream, the pair MLP's epilogues, and the fused LayerNorm +
// edge-mask epilogue.
//
// Thread layout (256 threads): tx = tid % 16 picks columns, ty = tid / 16
// picks rows; each thread owns a 4-row x (NC/16)-column micro-tile of the
// 64-row output tile. Column j of the micro-tile is (j/4)*64 + tx*4 + j%4, so
// a warp reads 16 consecutive float4 of a staged weight row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fdk {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // pairs per block
constexpr int kKc = 32;    // depth of one staged weight slice

template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};

// Round a float to T's precision (the compute dtype's rounding point).
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> __device__ __forceinline__ float ld(const T* p) {
  return Elem<T>::load(p);
}
template <typename T> __device__ __forceinline__ T st(float x) {
  return Elem<T>::from_f(x);
}

__device__ __forceinline__ int tile_col(int j, int tx) {
  return (j >> 2) * 64 + tx * 4 + (j & 3);
}

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Rows [k0, k0 + kKc) x columns [col0, col0 + NC) of W into registers, one
// column per thread and row group, so a warp reads 32 consecutive elements.
template <typename T, int NC>
__device__ __forceinline__ void fetch_slice(const T* __restrict__ W, int ldw, int col0, int k0,
                                            float (&r)[kKc * NC / kThreads]) {
#pragma unroll
  for (int m = 0; m < kKc * NC / kThreads; ++m) {
    const int idx = threadIdx.x + m * kThreads, kk = idx / NC, cc = idx - kk * NC;
    r[m] = ld<T>(W + (size_t)(k0 + kk) * ldw + col0 + cc);
  }
}

template <int NC>
__device__ __forceinline__ void stash_slice(float* __restrict__ Ws,
                                            const float (&r)[kKc * NC / kThreads]) {
#pragma unroll
  for (int m = 0; m < kKc * NC / kThreads; ++m) Ws[threadIdx.x + m * kThreads] = r[m];
}

// acc[TM][NC/16] += A[16 TM x K] @ W[K x NC] (TM = 4: a 64-row tile, TM = 2:
// a 32-row one; thread ty owns rows ty * TM ..): A is float in shared memory with
// row stride lda (a multiple of 4, K a multiple of kKc); W is row-major T in
// global memory with row stride ldw, read from column col0. Ws is a shared
// staging buffer of 2 * kKc * NC floats: while the block multiplies one
// slice, each thread holds its share of the next in registers, so the L2
// latency of the weight stream hides behind the products. A is read as
// float4 along k (four k steps per load). The sum over k runs in order.
// Every thread of the block must call it (it synchronizes, first and last).
template <typename T, int NC, int TM = 4>
__device__ __forceinline__ void tile_gemm(const float* __restrict__ A, int lda, int K,
                                          const T* __restrict__ W, int ldw, int col0,
                                          float* __restrict__ Ws,
                                          float (&acc)[TM][NC / 16]) {
  constexpr int TN = NC / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int slices = K / kKc;
  float next[kKc * NC / kThreads];
  fetch_slice<T, NC>(W, ldw, col0, 0, next);
  stash_slice<NC>(Ws, next);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const float* Wc = Ws + (s & 1) * (kKc * NC);
    if (s + 1 < slices) fetch_slice<T, NC>(W, ldw, col0, (s + 1) * kKc, next);
    const float* Ar = A + ty * TM * lda + s * kKc;
#pragma unroll 2
    for (int kk = 0; kk < kKc; kk += 4) {
      float4 a4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a4[i] = *reinterpret_cast<const float4*>(Ar + i * lda + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float w[TN];
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 v =
              *reinterpret_cast<const float4*>(Wc + (kk + u) * NC + q * 64 + tx * 4);
          w[q * 4 + 0] = v.x;
          w[q * 4 + 1] = v.y;
          w[q * 4 + 2] = v.z;
          w[q * 4 + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = lane4(a4[i], u);
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
        }
      }
    }
    // The other buffer was last read in step s - 1, which every thread has
    // left (the barrier at its end).
    if (s + 1 < slices) stash_slice<NC>(Ws + ((s + 1) & 1) * (kKc * NC), next);
    __syncthreads();
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// The pair MLP's epilogues, in the one addition order that its forward
// kernel (pair_mlp.cu), its backward kernel's recompute (pair_mlp_bwd.cu)
// and the plain version share: b0 and bf are not folded, and each sum rounds
// to T, so in bf16 another order could flip a relu mask. acc is the float32
// accumulator of the epilogue's product.
// y0 = relu(pair @ W0 + i_term + j_term + b0)
template <typename T>
__device__ __forceinline__ float pair_y0(float acc, float i_term, float j_term, float b0) {
  float v = rnd<T>(acc);
  v = rnd<T>(v + i_term);
  v = rnd<T>(v + j_term);
  v = rnd<T>(v + b0);
  return fmaxf(v, 0.f);
}

// y1 = relu(y0 @ W1 + b1)
template <typename T>
__device__ __forceinline__ float pair_y1(float acc, float b1) {
  return fmaxf(rnd<T>(rnd<T>(acc) + b1), 0.f);
}

// Pre-norm output: y1 @ Wf (+ pair @ Wfe, whose accumulator is res, + fi + fj)
// + bf, for output channel c of row prow and column pcol (fi, fj: [.., 128]).
template <typename T, bool RESIDUAL>
__device__ __forceinline__ float pair_out(float acc, float res, const T* __restrict__ fi,
                                          const T* __restrict__ fj, int prow, int pcol, int c,
                                          float bf) {
  float v = rnd<T>(acc);
  if (RESIDUAL) {
    v = rnd<T>(v + rnd<T>(res));
    v = rnd<T>(v + ld<T>(fi + (size_t)prow * 128 + c));
    v = rnd<T>(v + ld<T>(fj + (size_t)pcol * 128 + c));
  }
  return rnd<T>(v + bf);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-pair bookkeeping of a 64-pair tile of the flat [B, Nr, Nc] grid.
struct PairTile {
  int row[kRows];   // b * Nr + i, or -1 past the end
  int col[kRows];   // b * Nc + j
  float mask[kRows];
};

// Fill the tile's rows (threads 0..63); the caller synchronizes.
template <typename T>
__device__ __forceinline__ void load_pair_tile(PairTile& pt, long long p0, long long total,
                                               int Nr, int Nc, const T* __restrict__ row_mask,
                                               const T* __restrict__ col_mask) {
  const int r = threadIdx.x;
  if (r < kRows) {
    const long long p = p0 + r;
    if (p < total) {
      const long long per_b = (long long)Nr * Nc;
      const int b = (int)(p / per_b);
      const long long rem = p - (long long)b * per_b;
      const int i = (int)(rem / Nc), j = (int)(rem - (long long)i * Nc);
      pt.row[r] = b * Nr + i;
      pt.col[r] = b * Nc + j;
      // Edge mask: the product in the compute dtype, then float32.
      pt.mask[r] = rnd<T>(ld<T>(row_mask + b * Nr + i) * ld<T>(col_mask + b * Nc + j));
    } else {
      pt.row[r] = -1;
      pt.col[r] = 0;
      pt.mask[r] = 0.f;
    }
  }
}

// LayerNorm over the C = 128 channels of each tile row of O (float, row
// stride ldo; float32 statistics, eps 1e-6), times ln scale/bias and the
// edge mask, stored as T to out[p0 + r]. Each warp takes 8 rows.
template <typename T>
__device__ __forceinline__ void layer_norm_store(const float* __restrict__ O, int ldo,
                                                 const PairTile& pt, long long p0,
                                                 const float* __restrict__ ln_scale,
                                                 const float* __restrict__ ln_bias,
                                                 T* __restrict__ out) {
  constexpr int C = 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = 0; rr < kRows / (kThreads / 32); ++rr) {
    const int r = warp * (kRows / (kThreads / 32)) + rr;
    if (pt.row[r] < 0) continue;  // warp-uniform
    float x[C / 32];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < C / 32; ++q) {
      x[q] = O[r * ldo + lane + 32 * q];
      s += x[q];
    }
    const float mean = warp_sum(s) / C;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < C / 32; ++q) {
      x[q] -= mean;
      v += x[q] * x[q];
    }
    const float rstd = 1.f / sqrtf(warp_sum(v) / C + 1e-6f);
    T* dst = out + (size_t)(p0 + r) * C;
#pragma unroll
    for (int q = 0; q < C / 32; ++q) {
      const int c = lane + 32 * q;
      const float y = (x[q] * rstd * __ldg(ln_scale + c) + __ldg(ln_bias + c)) * pt.mask[r];
      dst[c] = st<T>(y);
    }
  }
}

}  // namespace fdk
