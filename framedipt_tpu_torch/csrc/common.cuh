// Shared pieces of the edge-stack kernels: element-type conversion, the pair
// MLP's and the edge embedder's epilogues, the distance bin, the 64-pair
// tile's bookkeeping, the fused LayerNorm + edge-mask epilogue, and the
// backward kernels' ordered partial sums and grid-stride launch size.
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

// The pair MLP's epilogues, in the one addition order that its forward
// kernels, its backward kernels' recompute and the plain version share: b0 and bf are not folded, and each sum rounds
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
// + bf, on the values of fi and fj (unread without RESIDUAL).
template <typename T, bool RESIDUAL>
__device__ __forceinline__ float pair_out_v(float acc, float res, float fi, float fj, float bf) {
  float v = rnd<T>(acc);
  if (RESIDUAL) {
    v = rnd<T>(v + rnd<T>(res));
    v = rnd<T>(v + fi);
    v = rnd<T>(v + fj);
  }
  return rnd<T>(v + bf);
}

// The same for output channel c of row prow and column pcol (fi, fj: [.., 128]).
template <typename T, bool RESIDUAL>
__device__ __forceinline__ float pair_out(float acc, float res, const T* __restrict__ fi,
                                          const T* __restrict__ fj, int prow, int pcol, int c,
                                          float bf) {
  return pair_out_v<T, RESIDUAL>(acc, res, RESIDUAL ? ld<T>(fi + (size_t)prow * 128 + c) : 0.f,
                                 RESIDUAL ? ld<T>(fj + (size_t)pcol * 128 + c) : 0.f, bf);
}

// The edge embedder's epilogues, shared by its forward kernel
// (edge_embedder.cu) and its backward kernel's recompute
// (edge_embedder_bwd.cu), in the plain version's addition order.
// y0 = relu(m @ W_rel + W_dist[bin] + i_term + j_term + b0): w_dist is the
// pair's W_dist element, added only if the pair has a bin.
template <typename T>
__device__ __forceinline__ float emb_y0(float acc, bool has_bin, float w_dist, float i_term,
                                        float j_term, float b0) {
  float v = rnd<T>(acc);
  if (has_bin) v = rnd<T>(v + w_dist);
  v = rnd<T>(v + i_term);
  v = rnd<T>(v + j_term);
  v = rnd<T>(v + b0);
  return fmaxf(v, 0.f);
}

// Pre-norm output of the last layer: y1 @ W2 + b2.
template <typename T>
__device__ __forceinline__ float emb_out(float acc, float b2) {
  return rnd<T>(rnd<T>(acc) + b2);
}

// Distance bin of one pair: the n with lower[n] < d < upper[n] (open
// intervals), or -1. Products and sums unfused, so d is the correctly rounded
// sqrt((dx^2 + dy^2) + dz^2) of the plain version.
__device__ __forceinline__ int pair_bin(const float* __restrict__ a, const float* __restrict__ c,
                                        const float* lo, const float* hi, int n_bins) {
  const float dx = __fsub_rn(a[0], c[0]), dy = __fsub_rn(a[1], c[1]), dz = __fsub_rn(a[2], c[2]);
  const float d = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
  int bin = -1;
  for (int n = 0; n < n_bins; ++n)
    if (d > lo[n] && d < hi[n]) bin = n;
  return bin;
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

// Fill the tile's rows, row r by the thread that passes r (r < kRows; the
// others pass r >= kRows and do nothing); the caller synchronizes.
template <typename T>
__device__ __forceinline__ void load_pair_tile(PairTile& pt, long long p0, long long total,
                                               int Nr, int Nc, const T* __restrict__ row_mask,
                                               const T* __restrict__ col_mask, int r) {
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

// The same, row r by thread r (threads 0..63).
template <typename T>
__device__ __forceinline__ void load_pair_tile(PairTile& pt, long long p0, long long total,
                                               int Nr, int Nc, const T* __restrict__ row_mask,
                                               const T* __restrict__ col_mask) {
  load_pair_tile<T>(pt, p0, total, Nr, Nc, row_mask, col_mask, (int)threadIdx.x);
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

// ---- pieces of the backward kernels ----------------------------------------
//
// The split backwards (pair_mlp_split.cuh, edge_embedder_split.cuh) write partial
// sums of each gradient to scratch; reduce_partials adds them in a fixed
// order. No float atomics, so two launches give the same bits.

namespace {

// out[m, c] = sum over s = 0 .. S-1, in order, of part[(m * S + s) * ld + c],
// for c < C <= ld; with accumulate, out[m, c] + that sum.
__global__ void sum_partials(const float* __restrict__ part, float* __restrict__ out,
                             long long M, int S, int C, int ld, bool accumulate) {
  const long long total = M * C;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long m = idx / C, c = idx - m * C;
    const float* p = part + (size_t)m * S * ld + c;
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += p[(size_t)k * ld];
    out[m * ld + c] = accumulate ? out[m * ld + c] + s : s;
  }
}

// Blocks of kThreads for a grid-stride loop over `total` items (at most 4096).
int grid_of(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  return (int)(want < 4096 ? (want > 0 ? want : 1) : 4096);
}

cudaError_t reduce_partials(const float* part, float* out, long long M, int S, int C, int ld,
                            cudaStream_t stream, bool accumulate = false) {
  const long long total = M * C;
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  if (blocks > 0) sum_partials<<<blocks, 256, 0, stream>>>(part, out, M, S, C, ld, accumulate);
  return cudaGetLastError();
}

}  // namespace

}  // namespace fdk
