// Fused embedder edge branch, for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/edge_embedder.py:76
// (_edge_embedder_kernel, reached through fused_edge_embedder) in bf16;
// every float32 forward runs edge_embedder_wg.cu (wgmma and TMA), so the
// float32 code below is reached by no entry (the C entry refuses it). Per
// pair (i, j), from O(N) inputs only:
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
// Bounds on an H100 SXM at B=2 N=256: 2 * (64*128 + 128*128 + 128*128) =
// 81,920 FLOP a pair, 10.74 GFLOP a launch (the TPU kernel's 22-bin one-hot
// product is a row gather here), against 67.1 MB of float32 output (0.020 ms
// at 3.35 TB/s; bf16 33.6 MB, 0.010 ms).
// - float32: float32-accurate products on the tensor cores take three TF32
//   products each (3xTF32): 3 x 10.74 GFLOP / 495 TFLOP/s = 0.065 ms, the
//   bound this kernel is held against. On the CUDA cores the same work takes
//   10.74 GFLOP / 67 TFLOP/s = 0.160 ms (the bound of the earlier kernel,
//   which ran every product there with fmaf, in both element types).
// - bf16: one bf16 product each, 10.74 GFLOP / 989 TFLOP/s = 0.011 ms.
//
// Design: 64-pair tiles of the flat [B*Nr*Nc] grid, one block of 8 warps
// each; the tile's forward is edge_embedder_tc.cuh's emb_forward_tile, which
// the backward's recompute runs too. No [N, N, .] feature exists in device memory: the block forms the CP
// product and the distance bin per pair in shared memory and fuses LayerNorm
// and the mask; the only N^2 traffic is the output write. What the earlier
// CUDA-core kernel lost time to, and what this one does instead:
// - Products on the CUDA cores (39% of their float32 peak, bf16 no faster).
//   The three products (m @ W_rel, K = 64; y0 @ W1 and y1 @ W2, K = 128) run
//   on mma.sync through tc_product.cuh, the pair MLP's product code: 3xTF32
//   in float32, each 32-deep slice summed into a zeroed fragment and added
//   with round-to-nearest; bf16 MMA in bf16. The epilogues take the
//   accumulator fragments in place.
// - Weights through registers (each thread held its share of the next slice,
//   which cost occupancy). The weights stream by cp.async, 16 bytes a
//   thread, into a shared-memory ring that runs across product boundaries:
//   10 slices of 32 rows a tile (W_rel 2, W1 4, W2 4), so W1's first slices
//   load during layer 1's epilogue.
// - Block barriers idle the block while a slice is staged: with the ring,
//   one barrier a slice and the copies already in flight. Shared memory
//   decides the blocks an SM holds: the layer-2 output reuses the CP
//   product's space (layer 1's input is consumed before layer 2's epilogue
//   writes) and the pre-norm output reuses y0's, so a float32 block is two
//   64 x 132 float tiles and the ring: 104 KB with two stages (two blocks an
//   SM), 121 KB with three (one). bf16 keeps float tiles (values rounded to
//   bf16) and a bf16 ring of three stages: 96 KB, two blocks an SM.
// - The per-pair gathers (G_i and H_j for the CP product; i_term, j_term and
//   the W_dist row in layer 1's epilogue) are loads from L2 whose latency
//   the block waits out: each thread issues all of its loads before it uses
//   any (in the epilogue, half of its elements at a time, for registers).
// No atomics: two launches give the same bits. chip_variants.py times this
// kernel beside variants of it (stages, 128-pair tiles, parts removed).
#include "edge_embedder_tc.cuh"

namespace fdk {
namespace {

template <typename T>
__global__ void __launch_bounds__(kBlock, EmbSmem<T>::kBlocksPerSm)
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
  using L = EmbSmem<T>;
  extern __shared__ __align__(16) float smem[];
  const EmbTile<T> et(smem);
  const EmbStream<T> ws{{w_rel, w1, w2}, et.stages, EmbSlices<T>::kTile};
  for (int s = 0; s < L::STAGES - 1; ++s) ws.start(s);

  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * kRows;
  load_pair_tile<T>(*et.pt, p0, total, Nr, Nc, row_mask, col_mask);
  if (tid < n_bins) {
    et.lo[tid] = lower[tid];
    et.hi[tid] = upper[tid];
  }
  __syncthreads();
  emb_forward_tile<T, false>(et, ws, g, h, pos_r, pos_c, i_term, j_term, w_dist, b0, b1, b2,
                             n_bins, EmbKeep<T>{});
  __syncthreads();
  layer_norm_store<T>(et.X, L::LDX, *et.pt, p0, ln_scale, ln_bias, out);
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
  constexpr size_t kBytes = EmbSmem<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(edge_embedder_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kBytes);
  if (err != cudaSuccess) return err;
  const long long total = (long long)B * Nr * Nc;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kRows - 1) / kRows;
  edge_embedder_kernel<T><<<(unsigned)blocks, kBlock, kBytes, stream>>>(
      (const T*)g, (const T*)h, pos_r, pos_c, (const T*)i_term, (const T*)j_term,
      (const T*)row_mask, (const T*)col_mask, (const T*)w_rel, (const T*)w_dist, lower,
      upper, (const T*)b0, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, ln_scale,
      ln_bias, (T*)out, n_bins, Nr, Nc, total);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fdk

// C interface. dtype: 1 = bfloat16; 0 (float32) is refused: every float32
// forward is fdk_edge_embedder_wg's (edge_embedder_wg.cu). Coordinates, bin
// edges and LayerNorm parameters are float32; weights are row-major [in,
// out], 16-byte aligned. Returns a cudaError_t (0 on success).
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
  // float32 is edge_embedder_wg.cu's (wgmma and TMA).
  if (dtype == 1) return fdk::launch<__nv_bfloat16>(FDK_ARGS);
#undef FDK_ARGS
  return (int)cudaErrorInvalidValue;
}
