// Fused embedder edge branch in float32, for Hopper (sm_90a), on wgmma and
// TMA: the forward that takes no gradient (every sampler, the service, the
// CLIs, a train step's self-conditioning forward).
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
// (and of the LayerNorm's sums) differs from edge_embedder.cu. A forward that
// autograd will differentiate takes edge_embedder.cu instead, whose tile code
// the backward's recompute shares bit for bit (model/kernels/edge_embedder.py;
// the route is pair_mlp.forward_route).
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
// slack: 210 KB at 22 bins.
// No atomics: two launches give the same bits. chip_variants.py times this
// kernel beside patched copies of it.
#include "common.cuh"
#include "wgmma_tma.cuh"

namespace fdk {
namespace {

constexpr int CP = 64, C = 128, kMaxBins = 64;
constexpr int kUnit = 64;  // pairs of a unit: one row, 64 consecutive columns
constexpr int kConsumers = 256, kBlockWG = kConsumers + 128;  // + the producer warpgroup
constexpr int kSliceFloats = 32 * C, kSliceBytes = kSliceFloats * 4;
constexpr int kRelSlices = CP / 32, kLayerSlices = C / 32;
constexpr int kTileSlices = kRelSlices + 2 * kLayerSlices;  // 10
constexpr int LDD = C + 4;  // W_dist's row stride in shared memory (floats)
// The producer warpgroup's warps 1 and 2 compute the bins and masks.
constexpr int kHelper0 = kConsumers + 32, kHelpers = 64;

// The split weights (prepare_weights): for each of W_rel, W1, W2 its hi rows
// [out][in], then its lo rows [out][in].
constexpr int WRS = 0, W1S = WRS + 2 * C * CP, W2S = W1S + 2 * C * C,
              kSplitFloats = W2S + 2 * C * C;
static_assert(kSplitFloats == 81920, "the wrapper's scratch (WG_SPLIT_FLOATS)");

template <int STAGES>
struct __align__(1024) EmbWgSmem {
  float hi[STAGES][kSliceFloats];  // weight slices' hi parts, [128 out][32 in] swizzled
  float lo[STAGES][kSliceFloats];  // and their lo parts
  float h[2][kUnit * CP];          // each warpgroup's unit: H rows (swizzled), by TMA
  float act[2][kUnit * C];         // j_term rows (swizzled) by TMA, then y0, then y1
  float g[2][CP];                  // the unit's G row, by bulk copy
  float it[2][C];                  // the unit's i_term row
  float vec[5][C];                 // b0, b1, b2, ln_scale, ln_bias
  float lower[kMaxBins], upper[kMaxBins];
  int bin[2][kUnit];               // each pair's distance bin or -1
  float mask[2][kUnit];            // each pair's edge mask
  uint64_t full[STAGES], empty[STAGES], hfull[2], hempty[2], jfull[2], jempty[2];
  // W_dist rows [n_bins][LDD] follow the struct.
};

template <int STAGES>
constexpr size_t smem_bytes(int n_bins) {
  return sizeof(EmbWgSmem<STAGES>) + (size_t)n_bins * LDD * 4 + 1024;
}
constexpr size_t kSmemLimit = 232448;
static_assert(smem_bytes<3>(54) <= kSmemLimit && smem_bytes<2>(kMaxBins) <= kSmemLimit,
              "shared memory of one block");

struct Maps {
  CUtensorMap w_rel, w1, w2;  // split weights, [2 out][in]
  CUtensorMap h;              // [B * Nc][CP]
  CUtensorMap j_term;         // [B * Nc][C]
};

// A unit of the [B, Nr, ceil(Nc / 64)] grid: its row (b * Nr + i), its
// first column j0 and its first column row (b * Nc + j0).
struct Unit {
  int prow, j0, pcol0;
  __device__ __forceinline__ Unit(long long u, int Nr, int Nc, int n_jb) {
    prow = (int)(u / n_jb);
    j0 = (int)(u - (long long)prow * n_jb) * kUnit;
    pcol0 = (prow / Nr) * Nc + j0;
  }
};

// Each weight w [in][out] to hi = tf32(w^T), lo = tf32(w^T - hi), K-major
// ([out][in]) into split (layout above): the operands the products read.
__global__ void prepare_weights(const float* __restrict__ w_rel, const float* __restrict__ w1,
                                const float* __restrict__ w2, float* __restrict__ split) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < kSplitFloats / 2;
       e += gridDim.x * blockDim.x) {
    const float* w;
    int in, base, k = e;
    if (k < C * CP) {
      w = w_rel, in = CP, base = WRS;
    } else if ((k -= C * CP) < C * C) {
      w = w1, in = C, base = W1S;
    } else {
      k -= C * C;
      w = w2, in = C, base = W2S;
    }
    const int o = k / in, i = k - o * in;
    uint32_t h, l;
    split_tf32(__ldg(w + (size_t)i * C + o), h, l);
    split[base + k] = __uint_as_float(h);
    split[base + C * in + k] = __uint_as_float(l);
  }
}

// The tensor map and input column of slice s of a tile.
__device__ __forceinline__ const CUtensorMap* slice_map(const Maps& m, int s, int& c_in) {
  if (s < kRelSlices) {
    c_in = 32 * s;
    return &m.w_rel;
  }
  if (s < kRelSlices + kLayerSlices) {
    c_in = 32 * (s - kRelSlices);
    return &m.w1;
  }
  c_in = 32 * (s - kRelSlices - kLayerSlices);
  return &m.w2;
}

// This warp's A fragments of 32-deep block ks of a swizzled 64-row tile
// (ldmatrix: lanes 0-15 give rows 0-15 of the warp's 16 at chunk 2 kk,
// lanes 16-31 the same rows at chunk 2 kk + 1), as float32 values: r[0] (g,
// t), r[1] (g + 8, t), r[2] (g, t + 4), r[3] (g + 8, t + 4) of k step kk.
__device__ __forceinline__ void load_rows(const float* A, int ks, int kk, uint32_t (&r)[4]) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int row = 16 * wq + (lane & 15), half = lane >> 4;
  ldmatrix_x4(r, A + ks * (kUnit * 32) + row * 32 + (((2 * kk + half) ^ (row & 7)) << 2));
}

// Layers 2 and 3: the activations' fragments, split into TF32 hi and lo.
__device__ __forceinline__ void load_act(const float* A, int ks, uint32_t (&hi)[4][4],
                                         uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t r[4];
    load_rows(A, ks, kk, r);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), hi[kk][i], lo[kk][i]);
  }
}

// Layer 1: m = G_i * H_j (rounded to float32, as the plain version's product
// is), split into TF32 hi and lo.
__device__ __forceinline__ void load_cp(const float* H, const float* G, int ks,
                                        uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t r[4];
    load_rows(H, ks, kk, r);
    const float ga = G[32 * ks + 8 * kk + t], gb = G[32 * ks + 8 * kk + 4 + t];
    split_tf32(__fmul_rn(ga, __uint_as_float(r[0])), hi[kk][0], lo[kk][0]);
    split_tf32(__fmul_rn(ga, __uint_as_float(r[1])), hi[kk][1], lo[kk][1]);
    split_tf32(__fmul_rn(gb, __uint_as_float(r[2])), hi[kk][2], lo[kk][2]);
    split_tf32(__fmul_rn(gb, __uint_as_float(r[3])), hi[kk][3], lo[kk][3]);
  }
}

// The consumer side of the weight ring: slices counted across the block's
// tiles (n); both warpgroups read every slice whole.
template <int STAGES>
struct Consumer {
  EmbWgSmem<STAGES>& sm;
  uint32_t n;  // slices consumed so far, counted across the block's tiles

  // acc (+)= (A's block with fragments hi, lo) @ the ring's next slice:
  // each k step adds a_lo b_hi, a_hi b_lo, a_hi b_hi into a fresh
  // accumulator, which is added to acc (round to nearest) once the slice is
  // complete; the first slice of a product sums into acc itself.
  template <bool FIRST>
  __device__ __forceinline__ void slice(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                        float (&acc)[64]) {
    const int st = n % STAGES;
    float part[64];
    float(&d)[64] = FIRST ? acc : part;
    wg::mbar_wait(&sm.full[st], (n / STAGES) & 1);
#pragma unroll
    for (int i = 0; i < 64; ++i) wg::fence_operand(d[i]);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bh = wg::desc_sw128(sm.hi[st] + 8 * kk);
      const uint64_t bl = wg::desc_sw128(sm.lo[st] + 8 * kk);
      wg::wgmma_m64n128k8_tf32(d, lo[kk], bh, kk > 0);
      wg::wgmma_m64n128k8_tf32(d, hi[kk], bl, 1);
      wg::wgmma_m64n128k8_tf32(d, hi[kk], bh, 1);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wg::fence_operand(hi[kk][i]);
        wg::fence_operand(lo[kk][i]);
      }
#pragma unroll
    for (int i = 0; i < 64; ++i) wg::fence_operand(d[i]);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&sm.empty[st]);
    if (!FIRST) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    ++n;
  }

  // acc = A[64 x 32 KS] @ (the ring's next KS slices), A's block ks loaded
  // by load(ks, hi, lo) once the previous block's products are done (a
  // second set of fragments, loaded during them, made ptxas spill and
  // serialize the wgmmas: chip_variants.py's wg_double_buffer).
  template <int KS, typename Load>
  __device__ __forceinline__ void product(Load load, float (&acc)[64]) {
    uint32_t hi[4][4], lo[4][4];
    load(0, hi, lo);
    slice<true>(hi, lo, acc);
#pragma unroll 1
    for (int ks = 1; ks < KS; ++ks) {
      load(ks, hi, lo);
      slice<false>(hi, lo, acc);
    }
  }
};

// f(c, i, o) for each of this thread's accumulator elements i (even i only;
// i + 1 is column c + 1): output column c, and o, the float offset of the
// element in a swizzled 64-row tile (wg::swz, written out so that the
// per-thread part is two registers: r = r0 + 8 h, c = 8 jj + 2 t, and
// ((c >> 2) & 7) ^ (r & 7) = 2 (jj & 3) ^ ((t >> 1) ^ (r0 & 7))).
template <typename F>
__device__ __forceinline__ void for_each_pair(F f) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int sw = r0 * 32 + 2 * (t & 1), q4 = ((t >> 1) ^ (r0 & 7)) << 2;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int jj = i >> 2, h = (i >> 1) & 1;
    f(8 * jj + 2 * t, i, (jj >> 2) * (kUnit * 32) + 256 * h + sw + ((8 * (jj & 3)) ^ q4));
  }
}

// The producer: one lane keeps the ring full, tile after tile, and brings
// each unit's H rows, G row and i_term row (before the tile's first slices)
// and its j_term rows (before the tile's layer-2 slices).
template <int STAGES>
__device__ __forceinline__ void produce(EmbWgSmem<STAGES>& sm, const Maps& maps,
                                        const float* __restrict__ g,
                                        const float* __restrict__ i_term, int Nr, int Nc,
                                        int n_jb, long long units, long long tiles) {
  wg::prefetch_tensor_map(&maps.w_rel);
  wg::prefetch_tensor_map(&maps.w1);
  wg::prefetch_tensor_map(&maps.w2);
  wg::prefetch_tensor_map(&maps.h);
  wg::prefetch_tensor_map(&maps.j_term);
  uint32_t n = 0, k = 0;
  auto slices = [&](int s0, int s1) {
    for (int s = s0; s < s1; ++s, ++n) {
      const int st = n % STAGES;
      wg::mbar_wait(&sm.empty[st], ((n / STAGES) & 1) ^ 1);
      int c_in;
      const CUtensorMap* map = slice_map(maps, s, c_in);
      wg::mbar_arrive_expect_tx(&sm.full[st], 2 * kSliceBytes);
      wg::tma_load_2d(sm.hi[st], map, &sm.full[st], c_in, 0);
      wg::tma_load_2d(sm.lo[st], map, &sm.full[st], c_in, C);
    }
  };
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    // A unit past the grid (the last tile's second, when the units are odd)
    // loads the last unit again; its outputs are not stored.
    for (int w = 0; w < 2; ++w) {
      const Unit un(min(2 * t + w, units - 1), Nr, Nc, n_jb);
      wg::mbar_wait(&sm.hempty[w], (k & 1) ^ 1);
      wg::mbar_arrive_expect_tx(&sm.hfull[w], (kUnit * CP + CP + C) * 4);
      for (int b = 0; b < CP / 32; ++b)
        wg::tma_load_2d(sm.h[w] + b * kUnit * 32, &maps.h, &sm.hfull[w], 32 * b, un.pcol0);
      wg::bulk_load(sm.g[w], g + (size_t)un.prow * CP, CP * 4, &sm.hfull[w]);
      wg::bulk_load(sm.it[w], i_term + (size_t)un.prow * C, C * 4, &sm.hfull[w]);
    }
    slices(0, kRelSlices);
    for (int w = 0; w < 2; ++w) {
      const Unit un(min(2 * t + w, units - 1), Nr, Nc, n_jb);
      wg::mbar_wait(&sm.jempty[w], (k & 1) ^ 1);
      wg::mbar_arrive_expect_tx(&sm.jfull[w], kUnit * C * 4);
      for (int b = 0; b < C / 32; ++b)
        wg::tma_load_2d(sm.act[w] + b * kUnit * 32, &maps.j_term, &sm.jfull[w], 32 * b,
                        un.pcol0);
    }
    slices(kRelSlices, kTileSlices);
  }
}

// Two warps of the producer warpgroup: each unit's distance bins (common.cuh
// pair_bin) and edge masks, one pair a thread, once the unit's previous
// tile has read them; they complete the unit's hfull phase with the loads.
template <int STAGES>
__device__ __forceinline__ void bins_and_masks(EmbWgSmem<STAGES>& sm,
                                               const float* __restrict__ pos_r,
                                               const float* __restrict__ pos_c,
                                               const float* __restrict__ row_mask,
                                               const float* __restrict__ col_mask, int n_bins,
                                               int Nr, int Nc, int n_jb, long long units,
                                               long long tiles) {
  const int r = threadIdx.x - kHelper0;
  uint32_t k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    for (int w = 0; w < 2; ++w) {
      const long long u = 2 * t + w;
      const Unit un(min(u, units - 1), Nr, Nc, n_jb);
      const int j = un.j0 + r;
      int bin = -1;
      float mask = 0.f;
      if (u < units && j < Nc) {
        // Edge mask: the product in float32, as load_pair_tile forms it.
        mask = __ldg(row_mask + un.prow) * __ldg(col_mask + un.pcol0 + r);
        bin = pair_bin(pos_r + (size_t)un.prow * 3, pos_c + (size_t)(un.pcol0 + r) * 3,
                       sm.lower, sm.upper, n_bins);
      }
      wg::mbar_wait(&sm.hempty[w], (k & 1) ^ 1);
      sm.bin[w][r] = bin;
      sm.mask[w][r] = mask;
      __syncwarp();
      if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&sm.hfull[w]);
    }
  }
}

// The two consumer warpgroups: warpgroup w takes unit 2 t + w of tile t.
template <int STAGES>
__device__ __forceinline__ void consume(EmbWgSmem<STAGES>& sm, const float* __restrict__ wdist,
                                        float* __restrict__ out, int Nr, int Nc, int n_jb,
                                        long long units, long long tiles) {
  const int w = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  Consumer<STAGES> ring{sm, 0};
  const float* H = sm.h[w];
  const float* G = sm.g[w];
  const float* it = sm.it[w];
  float* A = sm.act[w];
  uint32_t k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const long long u = 2 * t + w;
    const Unit un(min(u, units - 1), Nr, Nc, n_jb);
    float acc[64];

    // Layer 1: y0 = relu(m @ W_rel + W_dist[bin] + i_term + j_term + b0).
    wg::mbar_wait(&sm.hfull[w], k & 1);
    ring.template product<kRelSlices>(
        [&](int ks, uint32_t(&hi)[4][4], uint32_t(&lo)[4][4]) { load_cp(H, G, ks, hi, lo); },
        acc);
    const int bins[2] = {sm.bin[w][r0], sm.bin[w][r0 + 8]};
    const float mask[2] = {sm.mask[w][r0], sm.mask[w][r0 + 8]};
    wg::mbar_wait(&sm.jfull[w], k & 1);
    for_each_pair([&](int c, int i, int o) {
      const int bn = bins[(i >> 1) & 1];
      float2* y = reinterpret_cast<float2*>(A + o);
      const float2 jt = *y;
      const float2 iv = *reinterpret_cast<const float2*>(it + c);
      const float2 bb = *reinterpret_cast<const float2*>(sm.vec[0] + c);
      const float2 wd = bn >= 0 ? *reinterpret_cast<const float2*>(wdist + bn * LDD + c)
                                : make_float2(0.f, 0.f);
      *y = make_float2(emb_y0<float>(acc[i], bn >= 0, wd.x, iv.x, jt.x, bb.x),
                       emb_y0<float>(acc[i + 1], bn >= 0, wd.y, iv.y, jt.y, bb.y));
    });
    // This warp is done with the unit's H, G, i_term, bins and masks.
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&sm.hempty[w]);

    // Layer 2: y1 = relu(y0 @ W1 + b1), over y0 (each warp's own rows).
    ring.template product<kLayerSlices>(
        [&](int ks, uint32_t(&hi)[4][4], uint32_t(&lo)[4][4]) { load_act(A, ks, hi, lo); },
        acc);
    for_each_pair([&](int c, int i, int o) {
      const float2 bb = *reinterpret_cast<const float2*>(sm.vec[1] + c);
      *reinterpret_cast<float2*>(A + o) =
          make_float2(pair_y1<float>(acc[i], bb.x), pair_y1<float>(acc[i + 1], bb.y));
    });
    __syncwarp();

    // Layer 3: y1 @ W2 + b2, in registers; the producer may then bring the
    // next tile's j_term rows over the activations (the generic proxy's
    // writes ordered before the TMA's).
    ring.template product<kLayerSlices>(
        [&](int ks, uint32_t(&hi)[4][4], uint32_t(&lo)[4][4]) { load_act(A, ks, hi, lo); },
        acc);
    wg::fence_proxy_async();
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&sm.jempty[w]);

    // LayerNorm over each row's 128 channels (float32 statistics, eps 1e-6)
    // times the edge mask: a row's values lie in the four lanes of a quad.
    float sum[2] = {0.f, 0.f};
    for_each_pair([&](int c, int i, int) {
      const float2 bb = *reinterpret_cast<const float2*>(sm.vec[2] + c);
      acc[i] = emb_out<float>(acc[i], bb.x);
      acc[i + 1] = emb_out<float>(acc[i + 1], bb.y);
      sum[(i >> 1) & 1] += acc[i] + acc[i + 1];
    });
    float mean[2], var[2] = {0.f, 0.f}, rstd[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 1);
      sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 2);
      mean[e] = sum[e] / C;
    }
    for_each_pair([&](int, int i, int) {
      const int e = (i >> 1) & 1;
      acc[i] -= mean[e];
      acc[i + 1] -= mean[e];
      var[e] += acc[i] * acc[i] + acc[i + 1] * acc[i + 1];
    });
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      var[e] += __shfl_xor_sync(0xffffffffu, var[e], 1);
      var[e] += __shfl_xor_sync(0xffffffffu, var[e], 2);
      rstd[e] = 1.f / sqrtf(var[e] / C + 1e-6f);
    }
    // Streaming stores: they drain while the next tile's products run.
    const bool valid = u < units;
    const int j[2] = {un.j0 + r0, un.j0 + r0 + 8};
    for_each_pair([&](int c, int i, int) {
      const int e = (i >> 1) & 1;
      if (!valid || j[e] >= Nc) return;
      const float2 s = *reinterpret_cast<const float2*>(sm.vec[3] + c);
      const float2 b = *reinterpret_cast<const float2*>(sm.vec[4] + c);
      __stcs(reinterpret_cast<float2*>(out + ((size_t)un.prow * Nc + j[e]) * C + c),
             make_float2((acc[i] * rstd[e] * s.x + b.x) * mask[e],
                         (acc[i + 1] * rstd[e] * s.y + b.y) * mask[e]));
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
                        int Nr, int Nc, int n_jb, long long units) {
  extern __shared__ uint8_t smem_raw[];
  EmbWgSmem<STAGES>& sm = *reinterpret_cast<EmbWgSmem<STAGES>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* wdist = reinterpret_cast<float*>(&sm + 1);
  const long long tiles = (units + 1) / 2;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&sm.full[s], 1);
      wg::mbar_init(&sm.empty[s], kConsumers / 32);
    }
    for (int w = 0; w < 2; ++w) {
      wg::mbar_init(&sm.hfull[w], 1 + kHelpers / 32);  // the loads and the helper warps
      wg::mbar_init(&sm.hempty[w], 4);                 // the warpgroup's warps
      wg::mbar_init(&sm.jfull[w], 1);
      wg::mbar_init(&sm.jempty[w], 4);
    }
    wg::fence_barrier_init();
  }
  // The block's constants: W_dist, the biases and LayerNorm parameters, the
  // bin edges.
  for (int idx = tid; idx < n_bins * C; idx += kBlockWG)
    wdist[(idx / C) * LDD + idx % C] = __ldg(w_dist + idx);
  for (int idx = tid; idx < C; idx += kBlockWG) {
    sm.vec[0][idx] = __ldg(b0 + idx);
    sm.vec[1][idx] = __ldg(b1 + idx);
    sm.vec[2][idx] = __ldg(b2 + idx);
    sm.vec[3][idx] = __ldg(ln_scale + idx);
    sm.vec[4][idx] = __ldg(ln_bias + idx);
  }
  if (tid < n_bins) {
    sm.lower[tid] = __ldg(lower + tid);
    sm.upper[tid] = __ldg(upper + tid);
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer warpgroup: it gives its registers to the consumers (they are
    // granted by warpgroup, so the producer is a whole warpgroup).
    wg::setmaxnreg_dec<40>();
    if (tid == kConsumers)
      produce(sm, maps, g, i_term, Nr, Nc, n_jb, units, tiles);
    else if (tid >= kHelper0 && tid < kHelper0 + kHelpers)
      bins_and_masks(sm, pos_r, pos_c, row_mask, col_mask, n_bins, Nr, Nc, n_jb, units, tiles);
  } else {
    wg::setmaxnreg_inc<232>();
    consume(sm, wdist, out, Nr, Nc, n_jb, units, tiles);
  }
}

template <int STAGES>
cudaError_t launch_kernel(const Maps& maps, const float* g, const float* pos_r,
                          const float* pos_c, const float* i_term, const float* row_mask,
                          const float* col_mask, const float* w_dist, const float* lower,
                          const float* upper, const float* b0, const float* b1, const float* b2,
                          const float* ln_scale, const float* ln_bias, float* out, int n_bins,
                          int Nr, int Nc, int n_jb, long long units, int blocks,
                          cudaStream_t stream) {
  const size_t bytes = smem_bytes<STAGES>(n_bins);
  cudaError_t err = cudaFuncSetAttribute(edge_embedder_wg_kernel<STAGES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  edge_embedder_wg_kernel<STAGES><<<blocks, kBlockWG, bytes, stream>>>(
      maps, g, pos_r, pos_c, i_term, row_mask, col_mask, w_dist, lower, upper, b0, b1, b2,
      ln_scale, ln_bias, out, n_bins, Nr, Nc, n_jb, units);
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
  if (n_bins < 0 || n_bins > kMaxBins) return cudaErrorInvalidValue;
  if ((long long)B * Nr * Nc == 0) return cudaSuccess;
  prepare_weights<<<80, 256, 0, stream>>>(w_rel, w1, w2, split);
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
  const long long units = (long long)B * Nr * n_jb, tiles = (units + 1) / 2;
  const int blocks = (int)(tiles < sms ? tiles : sms);
#define FDK_ARGS                                                                          \
  maps, g, pos_r, pos_c, i_term, row_mask, col_mask, w_dist, lower, upper, b0, b1, b2, \
      ln_scale, ln_bias, out, n_bins, Nr, Nc, n_jb, units, blocks, stream
  if (smem_bytes<3>(n_bins) <= kSmemLimit) return launch_kernel<3>(FDK_ARGS);
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
