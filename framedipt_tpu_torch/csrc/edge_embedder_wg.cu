// Fused embedder edge branch in float32, for Hopper (sm_90a), on wgmma and
// TMA: every float32 forward, differentiated or not (the samplers, the
// service, the CLIs, the train step's forwards).
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/edge_embedder.py:76
// (_edge_embedder_kernel, reached through fused_edge_embedder), as
// edge_embedder.cu does, and computes what edge_embedder.cu computes in
// float32: per pair (i, j)
//
//   m  = G_i * H_j                                   [64]  rel-offset CP factors
//   x  = m @ W_rel + W_dist[bin(|ca_i - ca_j|)] + i_term_i + j_term_j
//   x  = relu(x + b0); x = relu(x @ W1 + b1); x = x @ W2 + b2      [128]
//   out = LayerNorm(x) * row_mask_i * col_mask_j
//
// at the plain version's rounding points: m rounded to float32 before the
// product, common.cuh's epilogues (emb_y0, pair_y1, emb_out) and distance bin
// (pair_bin), LayerNorm statistics in float32. Only the order of each k-sum
// (and of the LayerNorm's sums) differs from edge_embedder.cu, which keeps
// bf16. The unit's code is edge_embedder_wg.cuh, which the float32
// backward's kernel A (edge_embedder_bwd_wg.cu) runs for its recompute, so
// that recompute equals this kernel's output bit for bit
// (model/kernels/edge_embedder.py's forward_route).
//
// Bound on an H100 SXM: 2 * (64*128 + 128*128 + 128*128) = 81,920 FLOP a pair,
// 10.74 GFLOP a launch at B=2 N=256; 3xTF32 takes three TF32 products for each
// float32 one: 3 x 10.74 GFLOP / 495 TFLOP/s = 0.0651 ms (0.7972 ms at B=2
// N=896, 131.5 GFLOP). The output (67.1 MB at N=256, 822 MB at N=896) takes
// 0.020 / 0.245 ms at 3.35 TB/s, a third of the bound at most.
//
// Design. What held edge_embedder.cu back, and what this kernel does instead:
// - Products on mma.sync with both operands split into TF32 hi and lo in
//   registers for every 64-pair tile. Here the products are wgmma (m64n128k8,
//   TF32, A from registers): warpgroup w multiplies its own 64 pairs by all
//   128 output columns of each weight slice. The launch's first kernel
//   (prepare_weights) writes each weight's TF32 hi and lo parts, K-major
//   ([out, in], as TF32 wgmma takes B), into scratch the wrapper hands in
//   (W_rel expanded, W1, W2: 81,920 floats, 320 KB); only A is split in
//   registers. Each k step of 8 adds a_lo b_hi, then a_hi b_lo, then a_hi
//   b_hi; each 32-deep slice sums into a fresh accumulator (scale-d 0 on its
//   first wgmma) that is then added to the running sum with round to nearest,
//   as tc_product.cuh and pair_mlp_wg.cu do (the tensor cores truncate their
//   sums).
// - Weights by cp.async, issued by the warps that multiply, two stages and a
//   block barrier a slice. Here a producer warpgroup (one lane) brings every
//   weight slice (32 in x 128 out, hi + lo, 128-byte swizzle, 32 KB) by TMA
//   into a ring of three stages (two when n_bins > 54: shared memory) guarded
//   by full and empty mbarriers, running across tiles, so two slices are in
//   flight while a warpgroup multiplies or runs an epilogue. The block is
//   persistent, one on each SM: two consumer warpgroups (232 registers a
//   thread under setmaxnreg) and the producer warpgroup (40).
// - L2 stream. A 128-pair tile (two units of 64 pairs, one a warpgroup)
//   reads each slice once for both warpgroups: 10 slices x 32 KB = 320 KB a
//   tile, 0.33 GB a launch at B=2 N=256 and 4.1 GB at N=896 (half of what
//   64-pair tiles would stream).
// - Registers: edge_embedder.cu's 128-register cap spilled. Here the
//   consumers hold the running sum (64), a slice's sum (64; the first slice
//   of a product sums into the running sum itself) and one k block of A
//   fragments (32); the activations stay in shared memory, each warp reading
//   and writing only its own 16 rows. ptxas has no room for more: a second
//   block of fragments loaded during the products, the output staged in
//   shared memory for a TMA store, or a second running sum (to overlap the
//   epilogues with the next layer's first slices) each made it spill and
//   serialize the wgmmas, and run slower (PERF.md, PR 22).
// - Per-pair gathers from L2 (G_i, H_j, i_term, j_term, W_dist rows) whose
//   latency the block waited out. Here a unit is one row i and 64
//   consecutive columns j0 .. j0 + 63 (ragged at the row's end: its empty
//   columns are computed and not stored; at N=100 a row's two units hold 28
//   empty columns, 22% of its work; none at N=128, 256, 896; 2.3% at N=500).
//   So G_i and i_term_i are one row each (bulk copies), H[j0:] and
//   j_term[j0:] are boxes TMA brings (rows past the grid read as zeros; past
//   a batch's Nc they are the next batch's, computed and not stored), all
//   loaded while the previous tile runs. W_dist ([n_bins][128], padded rows)
//   and the bin edges stay in shared memory for the block's life. Two warps
//   of the producer warpgroup compute each pair's distance bin and edge mask
//   from the coordinates (12-byte rows, not a TMA box) ahead of the tile.
//   The layer-1 A fragment is formed as m = G_i * H_j (__fmul_rn: m is
//   rounded before it is split) while it is loaded from the H tile.
// - The output store: the LayerNorm runs on the last product's accumulators
//   in registers (a row's 128 values lie in one quad of lanes; float32 sums
//   and shuffles), and each thread stores its values with streaming stores
//   that drain while the next tile's products run.
// What still holds it back (chip_variants.py, H100, B=2 N=896): the CUDA-core
// work (A's split, the slices' sums, the epilogues, the LayerNorm) and the
// barriers alone take about as long as the bound, and the two warpgroups,
// which read the same slices, reach their epilogues together, so little of it
// overlaps the products (taking turns to issue the products was slower).
// Shared memory (227 KB a block; the TMA tiles swizzled, no padding): the
// ring 3 x 32 KB, H 2 x 16 KB, the activations 2 x 32 KB (j_term by TMA,
// then y0, then y1, in place), G, i_term, biases, bin edges, bins and masks
// 6 KB, W_dist n_bins x 528 bytes (11.6 KB at 22 bins), 1 KB of alignment
// slack: 210 KB at 22 bins. The block aligns it
// by adding to the shared array itself (edge_embedder_wg.cuh's emb_smem), so
// every access through it compiles to LDS/STS.
// No atomics: two launches give the same bits. chip_variants.py times this
// kernel beside patched copies of it.
#include "edge_embedder_wg.cuh"

namespace fdk {
namespace {

// The forward's hooks into forward_unit: it keeps nothing, and hands the
// activations' space to the producer (the next tile's j_term) as soon as
// layer 3's products have read y1 (the generic proxy's writes ordered before
// the TMA's).
template <int STAGES>
struct FwdHooks {
  EmbWgSmem<STAGES>& sm;
  __device__ __forceinline__ void y0(int, float, float) {}
  __device__ __forceinline__ void y0_done() {}
  __device__ __forceinline__ void y1_before() {}
  __device__ __forceinline__ void y1(int, float, float) {}
  __device__ __forceinline__ void y1_done() {}
  __device__ __forceinline__ void act_read() {
    wg::fence_proxy_async();
    __syncwarp();
    if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&sm.jempty[threadIdx.x >> 7]);
  }
};

// The two consumer warpgroups: warpgroup w takes unit 2 t + w of tile t.
template <int STAGES>
__device__ __forceinline__ void consume(EmbWgSmem<STAGES>& sm, const float* __restrict__ wdist,
                                        float* __restrict__ out, const Grid& gr, long long tiles) {
  const int w = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int Nc = gr.Nc;
  Consumer<STAGES> ring{sm, 0};
  FwdHooks<STAGES> hk{sm};
  uint32_t k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const long long u = 2 * t + w;
    const Unit un(min(u, gr.units - 1), gr);
    float acc[64], rstd[2], mask[2];
    forward_unit(sm, ring, wdist, k, acc, rstd, mask, hk);
    // Streaming stores: they drain while the next tile's products run.
    const bool valid = u < gr.units;
    const int j[2] = {un.j0 + r0, un.j0 + r0 + 8};
    for_each_pair([&](int c, int i, int) {
      const int e = (i >> 1) & 1;
      if (!valid || j[e] >= Nc) return;
      const float2 s = *reinterpret_cast<const float2*>(sm.vec[3] + c);
      const float2 b = *reinterpret_cast<const float2*>(sm.vec[4] + c);
      __stcs(reinterpret_cast<float2*>(out + ((size_t)un.prow * Nc + j[e]) * C + c),
             make_float2(ln_out(acc[i], rstd[e], s.x, b.x, mask[e]),
                         ln_out(acc[i + 1], rstd[e], s.y, b.y, mask[e])));
    });
  }
}

template <int STAGES>
__global__ void __launch_bounds__(kBlockWG, 1)
edge_embedder_wg_kernel(const __grid_constant__ Maps maps, const float* __restrict__ g,
                        const float* __restrict__ pos_r, const float* __restrict__ pos_c,
                        const float* __restrict__ i_term, const float* __restrict__ row_mask,
                        const float* __restrict__ col_mask, const float* __restrict__ w_dist,
                        const float* __restrict__ lower, const float* __restrict__ upper,
                        const float* __restrict__ b0, const float* __restrict__ b1,
                        const float* __restrict__ b2, const float* __restrict__ ln_scale,
                        const float* __restrict__ ln_bias, float* __restrict__ out, int n_bins,
                        const Grid gr) {
  extern __shared__ uint8_t smem_raw[];
  EmbWgSmem<STAGES>& sm = emb_smem<STAGES>(smem_raw);
  float* wdist = reinterpret_cast<float*>(&sm + 1);
  const long long tiles = (gr.units + 1) / 2;
  const int tid = threadIdx.x;
  init_block(sm, nullptr, wdist, w_dist, lower, upper, b0, b1, b2, ln_scale, ln_bias, n_bins);
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer warpgroup: it gives its registers to the consumers (they are
    // granted by warpgroup, so the producer is a whole warpgroup).
    wg::setmaxnreg_dec<40>();
    if (tid == kConsumers)
      produce<STAGES, false>(sm, maps, g, i_term, gr, tiles);
    else if (tid >= kHelper0 && tid < kHelper0 + kHelpers)
      bins_and_masks(sm, tid - kHelper0, pos_r, pos_c, row_mask, col_mask, n_bins, gr, tiles);
  } else {
    wg::setmaxnreg_inc<232>();
    consume(sm, wdist, out, gr, tiles);
  }
}

template <int STAGES>
cudaError_t launch_kernel(const Maps& maps, const float* g, const float* pos_r,
                          const float* pos_c, const float* i_term, const float* row_mask,
                          const float* col_mask, const float* w_dist, const float* lower,
                          const float* upper, const float* b0, const float* b1, const float* b2,
                          const float* ln_scale, const float* ln_bias, float* out, int n_bins,
                          const Grid& gr, int blocks, cudaStream_t stream) {
  const size_t bytes = smem_bytes<STAGES, false>(n_bins);
  cudaError_t err = cudaFuncSetAttribute(edge_embedder_wg_kernel<STAGES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  edge_embedder_wg_kernel<STAGES><<<blocks, kBlockWG, bytes, stream>>>(
      maps, g, pos_r, pos_c, i_term, row_mask, col_mask, w_dist, lower, upper, b0, b1, b2,
      ln_scale, ln_bias, out, n_bins, gr);
  return cudaGetLastError();
}

cudaError_t launch(const float* g, const float* h, const float* pos_r, const float* pos_c,
                   const float* i_term, const float* j_term, const float* row_mask,
                   const float* col_mask, const float* w_rel, const float* w_dist,
                   const float* lower, const float* upper, const float* b0, const float* w1,
                   const float* b1, const float* w2, const float* b2, const float* ln_scale,
                   const float* ln_bias, float* out, float* split, int n_bins, int B, int Nr,
                   int Nc, cudaStream_t stream) {
  // n_bins == 0: no distogram (every pair gets bin -1).
  if (n_bins < 0 || n_bins > MAX_BINS) return cudaErrorInvalidValue;
  if ((long long)B * Nr * Nc == 0) return cudaSuccess;
  prepare_weights<true><<<80, 256, 0, stream>>>(w_rel, w1, w2, split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Maps maps;
  if (!wg::f32_sw128_map(&maps.w_rel, split + WRS, 2 * C, CP, C) ||
      !wg::f32_sw128_map(&maps.w1, split + W1S, 2 * C, C, C) ||
      !wg::f32_sw128_map(&maps.w2, split + W2S, 2 * C, C, C) ||
      !wg::f32_sw128_map(&maps.h, h, (uint64_t)B * Nc, CP, kUnit) ||
      !wg::f32_sw128_map(&maps.j_term, j_term, (uint64_t)B * Nc, C, kUnit))
    return cudaErrorInvalidValue;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int n_jb = (Nc + kUnit - 1) / kUnit;
  const Grid gr{Nr, Nc, n_jb, 0, (long long)B * Nr * n_jb};
  const long long tiles = (gr.units + 1) / 2;
  const int blocks = (int)(tiles < sms ? tiles : sms);
#define FDK_ARGS                                                                          \
  maps, g, pos_r, pos_c, i_term, row_mask, col_mask, w_dist, lower, upper, b0, b1, b2, \
      ln_scale, ln_bias, out, n_bins, gr, blocks, stream
  if (smem_bytes<3, false>(n_bins) <= kSmemLimit) return launch_kernel<3>(FDK_ARGS);
  return launch_kernel<2>(FDK_ARGS);
#undef FDK_ARGS
}

}  // namespace
}  // namespace fdk

// C interface: fdk_edge_embedder's arguments (float32 only, no dtype), then
// split: 81,920 floats of device scratch, 16-byte aligned, for the weights'
// TF32 parts. Weights are row-major [in, out], as edge_embedder.cu takes
// them; g, h, i_term and j_term 16-byte aligned (bulk copies and TMA), the
// biases 8-byte aligned. Returns a cudaError_t (0 on success).
extern "C" int fdk_edge_embedder_wg(const void* g, const void* h, const float* pos_r,
                                    const float* pos_c, const void* i_term, const void* j_term,
                                    const void* row_mask, const void* col_mask,
                                    const void* w_rel, const void* w_dist, const float* lower,
                                    const float* upper, const void* b0, const void* w1,
                                    const void* b1, const void* w2, const void* b2,
                                    const float* ln_scale, const float* ln_bias, void* out,
                                    void* split, int n_bins, int B, int Nr, int Nc,
                                    void* stream) {
  using F = const float*;
  return (int)fdk::launch(
      (F)g, (F)h, pos_r, pos_c, (F)i_term, (F)j_term, (F)row_mask, (F)col_mask, (F)w_rel,
      (F)w_dist, lower, upper, (F)b0, (F)w1, (F)b1, (F)w2, (F)b2, ln_scale, ln_bias,
      static_cast<float*>(out), static_cast<float*>(split), n_bins, B, Nr, Nc,
      static_cast<cudaStream_t>(stream));
}
