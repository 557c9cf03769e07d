// Fused embedder edge branch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/edge_embedder.py
// (_edge_embedder_kernel, reached through fused_edge_embedder). Per pair
// (i, j), from O(N) inputs only:
//
//   m  = G_i * H_j                                   [64]  rel-offset CP factors
//   x  = m @ W_rel + W_dist[bin(|ca_i - ca_j|)] + i_term_i + j_term_j
//   x  = relu(x + b0); x = relu(x @ W1 + b1); x = x @ W2 + b2      [128]
//   out = LayerNorm(x) * row_mask_i * col_mask_j
//
// bin(d) is the n with lower[n] < d < upper[n] (open intervals), or none, so
// the d = 0 diagonal and a distance exactly on an edge add nothing: a row
// gather instead of the TPU kernel's one-hot product, with the same result.
// Each product accumulates in float32 and is rounded to T; every elementwise
// add rounds to T as the plain version does (the epilogues and the distance
// bin live in common.cuh, shared with the backward kernel's recompute);
// LayerNorm statistics float32.
//
// Bound on an H100 SXM at N=256, B=1: 2*(64*128 + 128*128 + 128*128) =
// 81,920 FLOP per pair (5.4 GFLOP per launch; 5.7 counting the TPU kernel's
// 22-bin one-hot product, which the gather replaces), against 16.8 MB of bf16
// output: compute bound (~5.4 us at 989 TFLOP/s bf16, ~80 us at 67 TFLOP/s
// float32), with the output write (~5 us at 3.35 TB/s) close behind.
//
// Design: 64-pair tiles of the flat [B*Nr*Nc] grid, one 256-thread block
// each. No [N, N, .] feature exists in device memory: the block forms the CP
// product and the distance bin per pair in shared memory, runs the three
// products with weights streamed through L2 in double-buffered 32-row
// slices (common.cuh tile_gemm), and fuses LayerNorm and the mask; the only
// N^2 traffic is the output write. The layer-2 output reuses the CP
// product's space, which keeps a block at 100 KB of shared memory: two
// blocks (16 warps) per SM. Products run on the CUDA cores in float32
// (fmaf), for both element types.
#include "common.cuh"

namespace fdk {
namespace {

constexpr int CP = 64, C = 128, MAX_BINS = 64;
constexpr int LDM = CP + 4, LDX = C + 4;
static_assert(LDM <= LDX, "the CP product lives in a layer-output buffer");
constexpr size_t kSmemFloats = 2 * (size_t)kRows * LDX + 2 * (size_t)kKc * C + 2 * MAX_BINS;
constexpr size_t kSmemBytes =
    kSmemFloats * sizeof(float) + sizeof(PairTile) + kRows * sizeof(int);

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
edge_embedder_kernel(const T* __restrict__ g, const T* __restrict__ h,
                     const float* __restrict__ pos_r, const float* __restrict__ pos_c,
                     const T* __restrict__ i_term, const T* __restrict__ j_term,
                     const T* __restrict__ row_mask, const T* __restrict__ col_mask,
                     const T* __restrict__ w_rel, const T* __restrict__ w_dist,
                     const float* __restrict__ lower, const float* __restrict__ upper,
                     const T* __restrict__ b0, const T* __restrict__ w1,
                     const T* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ b2, const float* __restrict__ ln_scale,
                     const float* __restrict__ ln_bias, T* __restrict__ out, int n_bins,
                     int Nr, int Nc, long long total) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;                       // [64][LDX]  layer-1 output, later layer-3 output
  float* M = X + kRows * LDX;            // [64][LDM]  CP product G_i * H_j (layer-1 input)
  float* Hd = M;                         // [64][LDX]  layer-2 output, once M is consumed
  float* Ws = Hd + kRows * LDX;          // [2][kKc][C] weight staging
  float* lo = Ws + 2 * kKc * C;          // [MAX_BINS] bin edges
  float* hi = lo + MAX_BINS;
  PairTile& pt = *reinterpret_cast<PairTile*>(hi + MAX_BINS);
  int* bin = reinterpret_cast<int*>(&pt + 1);  // [64] distance bin or -1

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long p0 = (long long)blockIdx.x * kRows;
  load_pair_tile<T>(pt, p0, total, Nr, Nc, row_mask, col_mask);
  if (tid < n_bins) {
    lo[tid] = lower[tid];
    hi[tid] = upper[tid];
  }
  __syncthreads();

  // CP product of the rel-offset factors, rounded to T as a T multiply.
  for (int idx = tid; idx < kRows * CP; idx += kThreads) {
    const int r = idx / CP, k = idx - r * CP;
    const int prow = pt.row[r];
    M[r * LDM + k] = prow < 0 ? 0.f
                              : rnd<T>(ld<T>(g + (size_t)prow * CP + k) *
                                       ld<T>(h + (size_t)pt.col[r] * CP + k));
  }
  // Distance bin per pair (common.cuh pair_bin).
  if (tid < kRows) {
    const int prow = pt.row[tid];
    bin[tid] = prow < 0 ? -1
                        : pair_bin(pos_r + (size_t)prow * 3, pos_c + (size_t)pt.col[tid] * 3, lo,
                                   hi, n_bins);
  }
  __syncthreads();

  // Layer 1: x = relu(m @ W_rel + W_dist[bin] + i_term + j_term + b0).
  {
    float acc[4][8];
    zero(acc);
    tile_gemm<T, C>(M, LDM, CP, w_rel, C, 0, Ws, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int prow = max(pt.row[r], 0), pcol = pt.col[r], bn = bin[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(j, tx);
        X[r * LDX + c] = emb_y0<T>(acc[i][j], bn, w_dist, c, ld<T>(i_term + (size_t)prow * C + c),
                                   ld<T>(j_term + (size_t)pcol * C + c), ld<T>(b0 + c));
      }
    }
  }
  __syncthreads();
  // Layer 2: relu(x @ W1 + b1).
  {
    float acc[4][8];
    zero(acc);
    tile_gemm<T, C>(X, LDX, C, w1, C, 0, Ws, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(j, tx);
        Hd[(ty * 4 + i) * LDX + c] = pair_y1<T>(acc[i][j], ld<T>(b1 + c));
      }
  }
  __syncthreads();
  // Layer 3: x @ W2 + b2, into X (every thread is done reading X).
  {
    float acc[4][8];
    zero(acc);
    tile_gemm<T, C>(Hd, LDX, C, w2, C, 0, Ws, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(j, tx);
        X[(ty * 4 + i) * LDX + c] = emb_out<T>(acc[i][j], ld<T>(b2 + c));
      }
  }
  __syncthreads();
  layer_norm_store<T>(X, LDX, pt, p0, ln_scale, ln_bias, out);
}

template <typename T>
cudaError_t launch(const void* g, const void* h, const float* pos_r, const float* pos_c,
                   const void* i_term, const void* j_term, const void* row_mask,
                   const void* col_mask, const void* w_rel, const void* w_dist,
                   const float* lower, const float* upper, const void* b0, const void* w1,
                   const void* b1, const void* w2, const void* b2, const float* ln_scale,
                   const float* ln_bias, void* out, int n_bins, int B, int Nr, int Nc,
                   cudaStream_t stream) {
  // n_bins == 0: no distogram (every pair gets bin -1).
  if (n_bins < 0 || n_bins > MAX_BINS) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(edge_embedder_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long total = (long long)B * Nr * Nc;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kRows - 1) / kRows;
  edge_embedder_kernel<T><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      (const T*)g, (const T*)h, pos_r, pos_c, (const T*)i_term, (const T*)j_term,
      (const T*)row_mask, (const T*)col_mask, (const T*)w_rel, (const T*)w_dist, lower,
      upper, (const T*)b0, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, ln_scale,
      ln_bias, (T*)out, n_bins, Nr, Nc, total);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fdk

// C interface. dtype: 0 = float32, 1 = bfloat16. Coordinates, bin edges and
// LayerNorm parameters are float32; weights are row-major [in, out].
// Returns a cudaError_t (0 on success).
extern "C" int fdk_edge_embedder(int dtype, const void* g, const void* h, const float* pos_r,
                                 const float* pos_c, const void* i_term, const void* j_term,
                                 const void* row_mask, const void* col_mask, const void* w_rel,
                                 const void* w_dist, const float* lower, const float* upper,
                                 const void* b0, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const float* ln_scale,
                                 const float* ln_bias, void* out, int n_bins, int B, int Nr,
                                 int Nc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDK_ARGS                                                                      \
  g, h, pos_r, pos_c, i_term, j_term, row_mask, col_mask, w_rel, w_dist, lower, upper, \
      b0, w1, b1, w2, b2, ln_scale, ln_bias, out, n_bins, B, Nr, Nc, s
  if (dtype == 0) return fdk::launch<float>(FDK_ARGS);
  if (dtype == 1) return fdk::launch<__nv_bfloat16>(FDK_ARGS);
#undef FDK_ARGS
  return (int)cudaErrorInvalidValue;
}
