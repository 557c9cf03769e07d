// Fused embedder edge branch, for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/edge_embedder.py:76
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
// each. No [N, N, .] feature exists in device memory: the block forms the CP
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
#include "tc_product.cuh"

namespace fdk {
namespace {

constexpr int CP = 64, C = 128, MAX_BINS = 64;
static_assert(C == NC && CP % kKc == 0, "the products' widths");

// Weight slices of a tile, in the order the products read them.
template <typename T>
struct EmbSlices {
  static constexpr int kRel = CP / kKc, kLayer = C / kKc;
  static constexpr int kTile = kRel + 2 * kLayer;  // 10
  const T* w_rel;
  const T* w1;
  const T* w2;

  __device__ __forceinline__ const T* slice(int s, int& ldw) const {
    ldw = C;
    if (s < kRel) return w_rel + (size_t)s * kKc * C;
    if (s < kRel + kLayer) return w1 + (size_t)(s - kRel) * kKc * C;
    return w2 + (size_t)(s - kRel - kLayer) * kKc * C;
  }
};

// Weight stages of the ring: float32 two (two blocks an SM), bf16 three.
template <typename T> constexpr int kEmbStages = sizeof(T) == 4 ? 2 : 3;

template <typename T>
struct EmbSmem {
  static constexpr int STAGES = kEmbStages<T>;
  // Tile row strides in floats: 4 (mod 32) for ldmatrix (TF32 A), 8 (mod
  // 32) for the bf16 A fragments' 64-bit loads.
  static constexpr int PAD = sizeof(T) == 4 ? 4 : 8;
  static constexpr int LDX = C + PAD, LDM = CP + PAD;
  static constexpr size_t kBytes = sizeof(float) * (2 * kRows * LDX + 2 * MAX_BINS) +
                                   sizeof(T) * STAGES * kStageElems + sizeof(PairTile) +
                                   sizeof(int) * kRows;
  // An SM's 228 KB of shared memory, 1 KB of it reserved per block.
  static constexpr int kBlocksPerSm = 2 * (kBytes + 1024) <= 233472 ? 2 : 1;
};
static_assert(EmbSmem<float>::LDM <= EmbSmem<float>::LDX, "M lives in y1's space");

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
  float* X = smem;                   // [64][LDX]  y0, later the pre-norm output
  float* Y1 = X + kRows * L::LDX;    // [64][LDX]  y1
  float* M = Y1;                     // [64][LDM]  CP product G_i * H_j, until layer 1 is done
  float* lo = Y1 + kRows * L::LDX;   // [MAX_BINS] bin edges
  float* hi = lo + MAX_BINS;
  T* stages = reinterpret_cast<T*>(hi + MAX_BINS);  // [STAGES][kKc][kLdw] weight ring
  PairTile& pt = *reinterpret_cast<PairTile*>(stages + L::STAGES * kStageElems);
  int* bin = reinterpret_cast<int*>(&pt + 1);  // [64] distance bin or -1

  const WeightStream<T, EmbSlices<T>, L::STAGES> ws{
      {w_rel, w1, w2}, stages, EmbSlices<T>::kTile};
  for (int s = 0; s < L::STAGES - 1; ++s) ws.start(s);

  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * kRows;
  load_pair_tile<T>(pt, p0, total, Nr, Nc, row_mask, col_mask);
  if (tid < n_bins) {
    lo[tid] = lower[tid];
    hi[tid] = upper[tid];
  }
  __syncthreads();

  // CP product of the rel-offset factors, rounded to T as a T multiply. All
  // of a thread's loads go out before the first product, so their latencies
  // overlap.
  {
    constexpr int kFill = kRows * CP / kBlock;
    float gv[kFill], hv[kFill];
#pragma unroll
    for (int u = 0; u < kFill; ++u) {
      const int idx = tid + u * kBlock, r = idx / CP, k = idx - r * CP;
      gv[u] = ld<T>(g + (size_t)max(pt.row[r], 0) * CP + k);
      hv[u] = ld<T>(h + (size_t)pt.col[r] * CP + k);
    }
#pragma unroll
    for (int u = 0; u < kFill; ++u) {
      const int idx = tid + u * kBlock, r = idx / CP, k = idx - r * CP;
      M[r * L::LDM + k] = pt.row[r] < 0 ? 0.f : rnd<T>(gv[u] * hv[u]);
    }
  }
  // Distance bin per pair (common.cuh pair_bin).
  if (tid < kRows) {
    const int prow = pt.row[tid];
    bin[tid] = prow < 0 ? -1
                        : pair_bin(pos_r + (size_t)prow * 3, pos_c + (size_t)pt.col[tid] * 3, lo,
                                   hi, n_bins);
  }
  // The first product's first wait() synchronizes the block before any
  // warp reads M or bin. Each later product's first wait() comes after
  // every warp has finished the product before it, so an epilogue may
  // overwrite that product's input: layer 2's y1 goes over M, layer 3's
  // output over y0.
  int s = 0;
  // Layer 1: y0 = relu(m @ W_rel + W_dist[bin] + i_term + j_term + b0).
  // The terms of half of a lane's elements load before any is added, so
  // their latencies overlap (elements q and q + 1 are neighbours in a row:
  // the terms load as pairs).
  {
    float acc[2][kNi][4] = {};
    product(M, L::LDM, CP, ws, s, acc);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 it[kNi][2], jt[kNi][2], wd[kNi][2];
      for_each_elem([&](int r, int c, int mi, int ni, int q) {
        if (mi != half || (q & 1)) return;
        const int prow = max(pt.row[r], 0), bn = bin[r];
        it[ni][q >> 1] = ld2(i_term + (size_t)prow * C + c);
        jt[ni][q >> 1] = ld2(j_term + (size_t)pt.col[r] * C + c);
        wd[ni][q >> 1] = bn >= 0 ? ld2(w_dist + (size_t)bn * C + c) : make_float2(0.f, 0.f);
      });
      for_each_elem([&](int r, int c, int mi, int ni, int q) {
        if (mi != half || (q & 1)) return;
        const bool has_bin = bin[r] >= 0;
        const float2 a = it[ni][q >> 1], b = jt[ni][q >> 1], w = wd[ni][q >> 1], bb = ld2(b0 + c);
        X[r * L::LDX + c] = emb_y0<T>(acc[mi][ni][q], has_bin, w.x, a.x, b.x, bb.x);
        X[r * L::LDX + c + 1] = emb_y0<T>(acc[mi][ni][q + 1], has_bin, w.y, a.y, b.y, bb.y);
      });
    }
  }
  // Layer 2: y1 = relu(y0 @ W1 + b1).
  {
    float acc[2][kNi][4] = {};
    product(X, L::LDX, C, ws, s, acc);
    for_each_elem([&](int r, int c, int mi, int ni, int q) {
      if (q & 1) return;
      const float2 bb = ld2(b1 + c);
      Y1[r * L::LDX + c] = pair_y1<T>(acc[mi][ni][q], bb.x);
      Y1[r * L::LDX + c + 1] = pair_y1<T>(acc[mi][ni][q + 1], bb.y);
    });
  }
  // Layer 3: y1 @ W2 + b2, into X.
  {
    float acc[2][kNi][4] = {};
    product(Y1, L::LDX, C, ws, s, acc);
    for_each_elem([&](int r, int c, int mi, int ni, int q) {
      if (q & 1) return;
      const float2 bb = ld2(b2 + c);
      X[r * L::LDX + c] = emb_out<T>(acc[mi][ni][q], bb.x);
      X[r * L::LDX + c + 1] = emb_out<T>(acc[mi][ni][q + 1], bb.y);
    });
  }
  __syncthreads();
  layer_norm_store<T>(X, L::LDX, pt, p0, ln_scale, ln_bias, out);
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

// C interface. dtype: 0 = float32, 1 = bfloat16. Coordinates, bin edges and
// LayerNorm parameters are float32; weights are row-major [in, out], 16-byte
// aligned. Returns a cudaError_t (0 on success).
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
