// The float32 edge embedder's unit on wgmma and TMA, for Hopper (sm_90a),
// shared by the forward (edge_embedder_wg.cu) and the backward's kernel A
// (edge_embedder_bwd_wg.cu): the block's shared-memory layout and set-up,
// the weights' TF32 split (prepare_weights), the weight ring's producer
// (produce) and consumer (Consumer) sides, the bins and masks of the
// producer warpgroup's helper warps, and the forward of a unit up to its
// LayerNorm statistics (forward_unit). Both kernels run this code, so the
// backward's recompute equals the forward's output bit for bit and its relu
// decisions are the forward's. edge_embedder_wg.cu's header describes the
// design. Kernel A adds the input-gradient chain's weight slices after the
// forward's in the ring (produce's BWD), each unit's pairs sorted by
// distance bin, and the state of its store warps (EmbWgBwdSmem).
#pragma once

#include "common.cuh"
#include "wgmma_tma.cuh"

namespace fdk {
namespace {

constexpr int CP = 64, C = 128, MAX_BINS = 64;
constexpr int kUnit = 64;  // pairs of a unit: one row, 64 consecutive columns
constexpr int kConsumers = 256, kBlockWG = kConsumers + 128;  // + the producer warpgroup
constexpr int kSliceFloats = 32 * C, kSliceBytes = kSliceFloats * 4;
constexpr int kRelSlices = CP / 32, kLayerSlices = C / 32;
constexpr int kTileSlices = kRelSlices + 2 * kLayerSlices;  // 10: the forward's
constexpr int kChainSlices = 3 * kLayerSlices;  // 12: the backward's W2^T, W1^T, W_rel^T (K = 128)
constexpr int LDD = C + 4;  // W_dist's row stride in shared memory (floats)
// The producer warpgroup's warps 1 and 2 compute the bins and masks; in
// kernel A, its warps 1-3 also store the workspace (one warp alone made
// kernel A 0.17 ms slower on an H100: chip_variants.py).
constexpr int kHelper0 = kConsumers + 32, kHelpers = 64, kStoreWarps = 3;

// The split weights (prepare_weights): for each of W_rel, W1, W2 its hi rows,
// then its lo rows; the forward's [out][in] (W^T), kernel A's chain's [in]
// [out] (W as stored: K-major for the chain's W^T).
constexpr int WRS = 0, W1S = WRS + 2 * C * CP, W2S = W1S + 2 * C * C,
              kSplitFloats = W2S + 2 * C * C;
static_assert(kSplitFloats == 81920, "the wrapper's scratch (WG_SPLIT_FLOATS)");

template <int STAGES>
struct __align__(1024) EmbWgSmem {
  float hi[STAGES][kSliceFloats];  // weight slices' hi parts, [128 out][32 in] swizzled
  float lo[STAGES][kSliceFloats];  // and their lo parts
  float h[2][kUnit * CP];          // each warpgroup's unit: H rows (swizzled), by TMA
  float act[2][kUnit * C];         // j_term rows (swizzled) by TMA, then y0, then y1 (kernel A:
                                   // then dx, dy1, dy0)
  float g[2][CP];                  // the unit's G row, by bulk copy
  float it[2][C];                  // the unit's i_term row
  float vec[5][C];                 // b0, b1, b2, ln_scale, ln_bias
  float lower[MAX_BINS], upper[MAX_BINS];
  int bin[2][kUnit];               // each pair's distance bin or -1
  float mask[2][kUnit];            // each pair's edge mask
  uint64_t full[STAGES], empty[STAGES], hfull[2], hempty[2], jfull[2], jempty[2];
  // W_dist rows [n_bins][LDD] follow the struct (then kernel A's
  // EmbWgBwdSmem).
};

// Kernel A's own shared state, after W_dist's rows.
struct EmbWgBwdSmem {
  uint64_t sfull[2], sempty[2];  // a workspace region whole in act / copied out
  uint32_t relu[2][2][2][128];   // [warpgroup][y0, y1][word][thread]: the recompute's relus
  float red[2][4][2][C];         // [warpgroup][warp][d_ln_scale, d_ln_bias][channel]
  float colsum[2][3][C];          // [warpgroup][store warp]: the store warps' column sums
  uint8_t order[2][2][kUnit];    // [unit parity][warpgroup]: the pairs by bin, each bin's in order
  uint8_t bstart[2][2][MAX_BINS + 1];  // each bin's first position in order; the binned pairs
};

template <int STAGES, bool BWD>
constexpr size_t smem_bytes(int n_bins) {
  return sizeof(EmbWgSmem<STAGES>) + (size_t)n_bins * LDD * 4 + (BWD ? sizeof(EmbWgBwdSmem) : 0) +
         1024;
}
constexpr size_t kSmemLimit = 232448;
static_assert(smem_bytes<3, false>(54) <= kSmemLimit && smem_bytes<2, false>(MAX_BINS) <= kSmemLimit &&
                  smem_bytes<2, true>(MAX_BINS) <= kSmemLimit,
              "shared memory of one block");

// The block's shared memory, 1024-byte aligned. The offset is added to the
// shared array itself, not to an integer made of its address, so that the
// compiler knows every access through it is to shared memory (LDS and STS,
// not generic LD and ST with 64-bit addresses: pair_mlp_wg.cuh).
template <int STAGES>
__device__ __forceinline__ EmbWgSmem<STAGES>& emb_smem(uint8_t* raw) {
  return *reinterpret_cast<EmbWgSmem<STAGES>*>(raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u));
}

struct Maps {
  CUtensorMap w_rel, w1, w2;       // the forward's split weights, [2 out][in]
  CUtensorMap h;                   // [B * Nc][CP]
  CUtensorMap j_term;              // [B * Nc][C]
  CUtensorMap w2c, w1c, w_relc;    // kernel A's chain split, [2 n][k] (W as stored)
};

// The walk: [rows, ceil(Nc / 64)] units over grid rows m0 .. (the forward's
// m0 is 0; kernel A's, its chunk's first row).
struct Grid {
  int Nr, Nc, n_jb, m0;
  long long units;
};

// A unit: its row (b * Nr + i), its first column j0 and its first column
// row (b * Nc + j0).
struct Unit {
  int prow, j0, pcol0;
  __device__ __forceinline__ Unit(long long u, const Grid& gr) {
    const int r = (int)(u / gr.n_jb);
    prow = gr.m0 + r;
    j0 = (int)(u - (long long)r * gr.n_jb) * kUnit;
    pcol0 = (prow / gr.Nr) * gr.Nc + j0;
  }
};

// Each weight w [in][out] to hi = tf32(w^T), lo = tf32(w^T - hi) ([out][in]:
// the forward's operands), or with TRANSPOSE false to the split of w as
// stored ([in][out]: the chain's), into split (layout above).
template <bool TRANSPOSE>
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
    split_tf32(__ldg(w + (TRANSPOSE ? (size_t)i * C + o : (size_t)k)), h, l);
    split[base + k] = __uint_as_float(h);
    split[base + C * in + k] = __uint_as_float(l);
  }
}

// The tensor map, input column and lo part's first row of slice s of a
// unit's stream: the forward's ten (W_rel, W1, W2), then kernel A's chain's
// twelve (W2^T, W1^T; W_rel^T, whose slices are 64 rows of n).
__device__ __forceinline__ const CUtensorMap* slice_map(const Maps& m, int s, int& c_in,
                                                        int& lo_row) {
  lo_row = C;
  if (s < kRelSlices) {
    c_in = 32 * s;
    return &m.w_rel;
  }
  if (s < kRelSlices + kLayerSlices) {
    c_in = 32 * (s - kRelSlices);
    return &m.w1;
  }
  if (s < kTileSlices) {
    c_in = 32 * (s - kRelSlices - kLayerSlices);
    return &m.w2;
  }
  const int v = s - kTileSlices;
  c_in = 32 * (v % kLayerSlices);
  if (v < kLayerSlices) return &m.w2c;
  if (v < 2 * kLayerSlices) return &m.w1c;
  lo_row = CP;
  return &m.w_relc;
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

// Layers 2 and 3 (and kernel A's chain): the activations' fragments, split
// into TF32 hi and lo.
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

  // acc (+)= (A's block with fragments hi, lo) @ the ring's next slice, NA
  // accumulators a thread (64: 128 output columns, m64n128k8; 32: 64
  // columns, m64n64k8, the slice's first 64 rows): each k step adds a_lo
  // b_hi, a_hi b_lo, a_hi b_hi into a fresh accumulator, which is added to
  // acc (round to nearest) once the slice is complete; the first slice of a
  // product sums into acc itself.
  template <bool FIRST, int NA>
  __device__ __forceinline__ void slice(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                        float (&acc)[NA]) {
    const int st = n % STAGES;
    float part[NA];
    float(&d)[NA] = FIRST ? acc : part;
    wg::mbar_wait(&sm.full[st], (n / STAGES) & 1);
#pragma unroll
    for (int i = 0; i < NA; ++i) wg::fence_operand(d[i]);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bh = wg::desc_sw128(sm.hi[st] + 8 * kk);
      const uint64_t bl = wg::desc_sw128(sm.lo[st] + 8 * kk);
      if constexpr (NA == 64) {
        wg::wgmma_m64n128k8_tf32(d, lo[kk], bh, kk > 0);
        wg::wgmma_m64n128k8_tf32(d, hi[kk], bl, 1);
        wg::wgmma_m64n128k8_tf32(d, hi[kk], bh, 1);
      } else {
        wg::wgmma_m64n64k8_tf32(d, lo[kk], bh, kk > 0);
        wg::wgmma_m64n64k8_tf32(d, hi[kk], bl, 1);
        wg::wgmma_m64n64k8_tf32(d, hi[kk], bh, 1);
      }
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
    for (int i = 0; i < NA; ++i) wg::fence_operand(d[i]);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&sm.empty[st]);
    if (!FIRST) {
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += part[i];
    }
    ++n;
  }

  // acc = A[64 x 32 KS] @ (the ring's next KS slices), A's block ks loaded
  // by load(ks, hi, lo) once the previous block's products are done (a
  // second set of fragments, loaded during them, made ptxas spill and
  // serialize the wgmmas: chip_variants.py's wg_double_buffer).
  template <int KS, typename Load, int NA>
  __device__ __forceinline__ void product(Load load, float (&acc)[NA]) {
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
// ((c >> 2) & 7) ^ (r & 7) = 2 (jj & 3) ^ ((t >> 1) ^ (r0 & 7))). Elements
// i and i + 2 (i % 4 = 0) are one column's two rows r0 and r0 + 8.
template <int NA = 64, typename F>
__device__ __forceinline__ void for_each_pair(F f) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int sw = r0 * 32 + 2 * (t & 1), q4 = ((t >> 1) ^ (r0 & 7)) << 2;
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int jj = i >> 2, h = (i >> 1) & 1;
    f(8 * jj + 2 * t, i, (jj >> 2) * (kUnit * 32) + 256 * h + sw + ((8 * (jj & 3)) ^ q4));
  }
}

// The block's barriers (bw: kernel A's, or null) and constants: W_dist
// (into wdist), the biases and LayerNorm parameters, the bin edges. The
// caller synchronizes.
template <int STAGES>
__device__ __forceinline__ void init_block(EmbWgSmem<STAGES>& sm, EmbWgBwdSmem* bw, float* wdist,
                                           const float* __restrict__ w_dist,
                                           const float* __restrict__ lower,
                                           const float* __restrict__ upper,
                                           const float* __restrict__ b0,
                                           const float* __restrict__ b1,
                                           const float* __restrict__ b2,
                                           const float* __restrict__ ln_scale,
                                           const float* __restrict__ ln_bias, int n_bins) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&sm.full[s], 1);
      wg::mbar_init(&sm.empty[s], kConsumers / 32);
    }
    for (int w = 0; w < 2; ++w) {
      wg::mbar_init(&sm.hfull[w], 1 + kHelpers / 32);  // the loads and the helper warps
      // The warpgroup's warps (and kernel A's store warps: m from H, y0 ..
      // dy0 from act).
      wg::mbar_init(&sm.hempty[w], bw ? 4 + kStoreWarps : 4);
      wg::mbar_init(&sm.jfull[w], 1);
      wg::mbar_init(&sm.jempty[w], bw ? 4 + kStoreWarps : 4);
      if (bw) {
        wg::mbar_init(&bw->sfull[w], 4);
        wg::mbar_init(&bw->sempty[w], kStoreWarps);
      }
    }
    wg::fence_barrier_init();
  }
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
}

// The producer: one lane keeps the ring full, tile after tile, and brings
// each unit's H rows, G row and i_term row (before the tile's first slices)
// and its j_term rows (before the tile's layer-2 slices); kernel A's (BWD)
// the chain's slices after the forward's.
template <int STAGES, bool BWD>
__device__ __forceinline__ void produce(EmbWgSmem<STAGES>& sm, const Maps& maps,
                                        const float* __restrict__ g,
                                        const float* __restrict__ i_term, const Grid& gr,
                                        long long tiles) {
  wg::prefetch_tensor_map(&maps.w_rel);
  wg::prefetch_tensor_map(&maps.w1);
  wg::prefetch_tensor_map(&maps.w2);
  wg::prefetch_tensor_map(&maps.h);
  wg::prefetch_tensor_map(&maps.j_term);
  if constexpr (BWD) {
    wg::prefetch_tensor_map(&maps.w2c);
    wg::prefetch_tensor_map(&maps.w1c);
    wg::prefetch_tensor_map(&maps.w_relc);
  }
  uint32_t n = 0, k = 0;
  auto slices = [&](int s0, int s1) {
    for (int s = s0; s < s1; ++s, ++n) {
      const int st = n % STAGES;
      wg::mbar_wait(&sm.empty[st], ((n / STAGES) & 1) ^ 1);
      int c_in, lo_row;
      const CUtensorMap* map = slice_map(maps, s, c_in, lo_row);
      wg::mbar_arrive_expect_tx(&sm.full[st], 2 * lo_row * 32 * 4);
      wg::tma_load_2d(sm.hi[st], map, &sm.full[st], c_in, 0);
      wg::tma_load_2d(sm.lo[st], map, &sm.full[st], c_in, lo_row);
    }
  };
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    // A unit past the grid (the last tile's second, when the units are odd)
    // loads the last unit again; its outputs are not stored.
    for (int w = 0; w < 2; ++w) {
      const Unit un(min(2 * t + w, gr.units - 1), gr);
      wg::mbar_wait(&sm.hempty[w], (k & 1) ^ 1);
      wg::mbar_arrive_expect_tx(&sm.hfull[w], (kUnit * CP + CP + C) * 4);
      for (int b = 0; b < CP / 32; ++b)
        wg::tma_load_2d(sm.h[w] + b * kUnit * 32, &maps.h, &sm.hfull[w], 32 * b, un.pcol0);
      wg::bulk_load(sm.g[w], g + (size_t)un.prow * CP, CP * 4, &sm.hfull[w]);
      wg::bulk_load(sm.it[w], i_term + (size_t)un.prow * C, C * 4, &sm.hfull[w]);
    }
    slices(0, kRelSlices);
    for (int w = 0; w < 2; ++w) {
      const Unit un(min(2 * t + w, gr.units - 1), gr);
      wg::mbar_wait(&sm.jempty[w], (k & 1) ^ 1);
      wg::mbar_arrive_expect_tx(&sm.jfull[w], kUnit * C * 4);
      for (int b = 0; b < C / 32; ++b)
        wg::tma_load_2d(sm.act[w] + b * kUnit * 32, &maps.j_term, &sm.jfull[w], 32 * b,
                        un.pcol0);
    }
    slices(kRelSlices, kTileSlices);
    if (BWD) slices(kTileSlices, kTileSlices + kChainSlices);
  }
}

// The distance bins (common.cuh pair_bin) and edge masks of warpgroup w's
// unit u, the block's k-th tile's, one pair a thread r < kHelpers, once the
// unit's previous tile has read them (hempty). With kernel A's state (bw)
// the threads also sort the unit's pairs by bin (pairs with no bin last,
// each bin's in column order) for its d_w_dist partial, into the buffers of
// the unit's parity (kernel A reads them at the unit's end, after the next
// unit's bins are written). The caller's warps then arrive on hfull.
template <int STAGES>
__device__ __forceinline__ void unit_bins(EmbWgSmem<STAGES>& sm, EmbWgBwdSmem* bw, int r,
                                          const float* __restrict__ pos_r,
                                          const float* __restrict__ pos_c,
                                          const float* __restrict__ row_mask,
                                          const float* __restrict__ col_mask, int n_bins,
                                          const Grid& gr, long long u, int w, uint32_t k) {
  const Unit un(min(u, gr.units - 1), gr);
  const int j = un.j0 + r;
  int bin = -1;
  float mask = 0.f;
  if (u < gr.units && j < gr.Nc) {
    // Edge mask: the product in float32, as load_pair_tile forms it.
    mask = __ldg(row_mask + un.prow) * __ldg(col_mask + un.pcol0 + r);
    bin = pair_bin(pos_r + (size_t)un.prow * 3, pos_c + (size_t)(un.pcol0 + r) * 3, sm.lower,
                   sm.upper, n_bins);
  }
  wg::mbar_wait(&sm.hempty[w], (k & 1) ^ 1);
  sm.bin[w][r] = bin;
  sm.mask[w][r] = mask;
  if (bw) {
    wg::bar_sync(3, kHelpers);  // the unit's bins written
    const int* bins = sm.bin[w];
    const int key = bin < 0 ? n_bins : bin, par = k & 1;
    int rank = 0;
    for (int q = 0; q < kUnit; ++q) {
      const int kq = bins[q] < 0 ? n_bins : bins[q];
      rank += kq < key || (kq == key && q < r);
    }
    bw->order[par][w][rank] = (uint8_t)r;
    for (int b = r; b <= n_bins; b += kHelpers) {
      int s = 0;
      for (int q = 0; q < kUnit; ++q) s += (bins[q] < 0 ? n_bins : bins[q]) < b;
      bw->bstart[par][w][b] = (uint8_t)s;
    }
  }
}

// Two warps of the forward's producer warpgroup (threads r < kHelpers):
// each unit's bins and masks (unit_bins), completing the unit's hfull phase
// with the loads.
template <int STAGES>
__device__ __forceinline__ void bins_and_masks(EmbWgSmem<STAGES>& sm, int r,
                                               const float* __restrict__ pos_r,
                                               const float* __restrict__ pos_c,
                                               const float* __restrict__ row_mask,
                                               const float* __restrict__ col_mask, int n_bins,
                                               const Grid& gr, long long tiles) {
  uint32_t k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    for (int w = 0; w < 2; ++w) {
      unit_bins(sm, nullptr, r, pos_r, pos_c, row_mask, col_mask, n_bins, gr, 2 * t + w, w, k);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&sm.hfull[w]);
    }
  }
}

// The forward's output element: the LayerNorm of a centered pre-norm value
// x with its row's rstd, times the scale, plus the bias, times the edge
// mask.
__device__ __forceinline__ float ln_out(float x, float rstd, float scale, float bias,
                                        float mask) {
  return (x * rstd * scale + bias) * mask;
}

// The forward of warpgroup w's unit of the block's k-th tile (its H, G,
// i_term, bins and masks in the hfull phase, its j_term rows in act),
// through the ring's next ten slices, up to the LayerNorm's statistics:
// acc[i] the pre-norm output minus its row's mean, rstd[e] the row's
// 1 / sqrt(var + 1e-6), mask[e] its edge mask, for the thread's rows r0 and
// r0 + 8 (e = (i >> 1) & 1). Hooks h (kernel A's recompute keeps what the
// forward drops):
//   y0(i, v0, v1)  y0's elements i, i + 1 as layer 1's epilogue forms them;
//   y0_done()      y0 in act (this warp's rows; after __syncwarp);
//   y1_before()    ahead of layer 2's epilogue, which writes y1 over y0;
//   y1(i, v0, v1)  y1's elements i, i + 1;
//   y1_done()      y1 in act (this warp's rows; after __syncwarp);
//   act_read()     layer 3's products have read y1 from act.
template <int STAGES, typename Hooks>
__device__ __forceinline__ void forward_unit(EmbWgSmem<STAGES>& sm, Consumer<STAGES>& ring,
                                             const float* wdist,
                                             uint32_t k, float (&acc)[64], float (&rstd)[2],
                                             float (&mask)[2], Hooks& hk) {
  const int w = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const float* H = sm.h[w];
  const float* G = sm.g[w];
  const float* it = sm.it[w];
  float* A = sm.act[w];

  // Layer 1: y0 = relu(m @ W_rel + W_dist[bin] + i_term + j_term + b0).
  wg::mbar_wait(&sm.hfull[w], k & 1);
  ring.template product<kRelSlices>(
      [&](int ks, uint32_t(&hi)[4][4], uint32_t(&lo)[4][4]) { load_cp(H, G, ks, hi, lo); },
      acc);
  const int bins[2] = {sm.bin[w][r0], sm.bin[w][r0 + 8]};
  mask[0] = sm.mask[w][r0];
  mask[1] = sm.mask[w][r0 + 8];
  wg::mbar_wait(&sm.jfull[w], k & 1);
  for_each_pair([&](int c, int i, int o) {
    const int bn = bins[(i >> 1) & 1];
    float2* y = reinterpret_cast<float2*>(A + o);
    const float2 jt = *y;
    const float2 iv = *reinterpret_cast<const float2*>(it + c);
    const float2 bb = *reinterpret_cast<const float2*>(sm.vec[0] + c);
    const float2 wd = bn >= 0 ? *reinterpret_cast<const float2*>(wdist + bn * LDD + c)
                              : make_float2(0.f, 0.f);
    const float v0 = emb_y0<float>(acc[i], bn >= 0, wd.x, iv.x, jt.x, bb.x);
    const float v1 = emb_y0<float>(acc[i + 1], bn >= 0, wd.y, iv.y, jt.y, bb.y);
    *y = make_float2(v0, v1);
    hk.y0(i, v0, v1);
  });
  // This warp is done with the unit's H, G, i_term, bins and masks.
  __syncwarp();
  if (lane == 0) wg::mbar_arrive(&sm.hempty[w]);
  hk.y0_done();

  // Layer 2: y1 = relu(y0 @ W1 + b1), over y0 (each warp's own rows).
  ring.template product<kLayerSlices>(
      [&](int ks, uint32_t(&hi)[4][4], uint32_t(&lo)[4][4]) { load_act(A, ks, hi, lo); }, acc);
  hk.y1_before();
  for_each_pair([&](int c, int i, int o) {
    const float2 bb = *reinterpret_cast<const float2*>(sm.vec[1] + c);
    const float v0 = pair_y1<float>(acc[i], bb.x), v1 = pair_y1<float>(acc[i + 1], bb.y);
    *reinterpret_cast<float2*>(A + o) = make_float2(v0, v1);
    hk.y1(i, v0, v1);
  });
  __syncwarp();
  hk.y1_done();

  // Layer 3: y1 @ W2 + b2, in registers.
  ring.template product<kLayerSlices>(
      [&](int ks, uint32_t(&hi)[4][4], uint32_t(&lo)[4][4]) { load_act(A, ks, hi, lo); }, acc);
  hk.act_read();

  // LayerNorm statistics over each row's 128 channels (float32, eps 1e-6):
  // a row's values lie in the four lanes of a quad.
  float sum[2] = {0.f, 0.f};
  for_each_pair([&](int c, int i, int) {
    const float2 bb = *reinterpret_cast<const float2*>(sm.vec[2] + c);
    acc[i] = emb_out<float>(acc[i], bb.x);
    acc[i + 1] = emb_out<float>(acc[i + 1], bb.y);
    sum[(i >> 1) & 1] += acc[i] + acc[i + 1];
  });
  float mean[2], var[2] = {0.f, 0.f};
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
}

}  // namespace
}  // namespace fdk
