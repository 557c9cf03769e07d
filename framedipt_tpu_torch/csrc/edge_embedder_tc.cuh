// The edge embedder's tensor-core pieces for Hopper (sm_90a), shared by the
// forward kernel (edge_embedder.cu) and the backward's kernel A
// (edge_embedder_bwd.cu), both in float32 and bf16: the weight stream's slice maps, the 64-pair
// tile's shared-memory layout and the forward of a tile up to its pre-norm
// output (emb_forward_tile). Both kernels run this code, so the backward's
// recompute equals the forward kernel's output bit for bit and its relu
// decisions are the forward's.
//
// Products and weight stream: tc_product.cuh (mma.sync, 3xTF32 in float32,
// bf16 MMA in bf16; weight slices by cp.async through a shared-memory ring).
#pragma once

#include "tc_product.cuh"

namespace fdk {
namespace {

constexpr int CP = 64, C = 128, MAX_BINS = 64;
static_assert(C == NC && CP % kKc == 0, "the products' widths");

// Weight slices of a tile, in the order the forward's products read them.
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
using EmbStream = WeightStream<T, EmbSlices<T>, EmbSmem<T>::STAGES>;

// A tile's shared memory, carved from the block's dynamic shared memory.
template <typename T>
struct EmbTile {
  float* X;      // [64][LDX]  y0, later the pre-norm output
  float* Y1;     // [64][LDX]  y1; the CP product [64][LDM] until layer 1 is done
  float* lo;     // [MAX_BINS] bin edges
  float* hi;
  T* stages;     // [STAGES][kKc][kLdw] weight ring
  PairTile* pt;
  int* bin;      // [64] distance bin or -1; EmbSmem<T>::kBytes end here

  __device__ __forceinline__ explicit EmbTile(float* smem) {
    using L = EmbSmem<T>;
    X = smem;
    Y1 = X + kRows * L::LDX;
    lo = Y1 + kRows * L::LDX;
    hi = lo + MAX_BINS;
    stages = reinterpret_cast<T*>(hi + MAX_BINS);
    pt = reinterpret_cast<PairTile*>(stages + L::STAGES * kStageElems);
    bin = reinterpret_cast<int*>(pt + 1);
  }
};

// What a backward's recompute keeps (STORE): each valid row's CP product,
// y0 and y1 (row r at r * CP, r * C) as the workspace's element type W
// (exact: each is a T value), and the relus' decisions (y > 0) of y0 and
// y1 (mask_word order, one chunk each).
template <typename W>
struct EmbKeep {
  W* m;
  W* y0;
  W* y1;
  uint32_t* m0;
  uint32_t* m1;
};

// The forward of a 64-pair tile up to its pre-norm output, which it leaves
// in et.X (rows past the grid hold no pair). The caller has started the
// stream's first slices, filled *et.pt and the bin edges, and synchronized.
// With STORE, also `keep`.
template <typename T, bool STORE, typename W = T>
__device__ __forceinline__ void emb_forward_tile(
    const EmbTile<T>& et, const EmbStream<T>& ws, const T* __restrict__ g,
    const T* __restrict__ h, const float* __restrict__ pos_r, const float* __restrict__ pos_c,
    const T* __restrict__ i_term, const T* __restrict__ j_term, const T* __restrict__ w_dist,
    const T* __restrict__ b0, const T* __restrict__ b1, const T* __restrict__ b2, int n_bins,
    const EmbKeep<W>& keep) {
  using L = EmbSmem<T>;
  float* X = et.X;
  float* Y1 = et.Y1;
  float* M = Y1;
  const PairTile& pt = *et.pt;
  int* bin = et.bin;
  const int tid = threadIdx.x;

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
                        : pair_bin(pos_r + (size_t)prow * 3, pos_c + (size_t)pt.col[tid] * 3,
                                   et.lo, et.hi, n_bins);
  }
  // The first product's first wait() synchronizes the block before any
  // warp reads M or bin. Each later product's first wait() comes after
  // every warp has finished the product before it, so an epilogue may
  // overwrite that product's input: layer 2's y1 goes over M, layer 3's
  // output over y0. A row store of a product's input comes right after that
  // product, before the next product's barriers.
  int s = 0;
  // Layer 1: y0 = relu(m @ W_rel + W_dist[bin] + i_term + j_term + b0).
  // The terms of half of a lane's elements load before any is added, so
  // their latencies overlap (elements q and q + 1 are neighbours in a row:
  // the terms load as pairs).
  {
    float acc[2][kNi][4] = {};
    product(M, L::LDM, CP, ws, s, acc);
    if (STORE) store_rows(M, L::LDM, CP, pt, keep.m, CP);
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
        const float v0 = emb_y0<T>(acc[mi][ni][q], has_bin, w.x, a.x, b.x, bb.x);
        const float v1 = emb_y0<T>(acc[mi][ni][q + 1], has_bin, w.y, a.y, b.y, bb.y);
        X[r * L::LDX + c] = v0;
        X[r * L::LDX + c + 1] = v1;
        if (STORE) store_relu_bits(keep.m0, 0, mi, ni, q, v0, v1);
      });
    }
  }
  // Layer 2: y1 = relu(y0 @ W1 + b1).
  {
    float acc[2][kNi][4] = {};
    product(X, L::LDX, C, ws, s, acc);
    if (STORE) store_rows(X, L::LDX, C, pt, keep.y0, C);
    for_each_elem([&](int r, int c, int mi, int ni, int q) {
      if (q & 1) return;
      const float2 bb = ld2(b1 + c);
      const float v0 = pair_y1<T>(acc[mi][ni][q], bb.x);
      const float v1 = pair_y1<T>(acc[mi][ni][q + 1], bb.y);
      Y1[r * L::LDX + c] = v0;
      Y1[r * L::LDX + c + 1] = v1;
      if (STORE) store_relu_bits(keep.m1, 0, mi, ni, q, v0, v1);
    });
  }
  // Layer 3: y1 @ W2 + b2, into X.
  {
    float acc[2][kNi][4] = {};
    product(Y1, L::LDX, C, ws, s, acc);
    if (STORE) store_rows(Y1, L::LDX, C, pt, keep.y1, C);
    for_each_elem([&](int r, int c, int mi, int ni, int q) {
      if (q & 1) return;
      const float2 bb = ld2(b2 + c);
      X[r * L::LDX + c] = emb_out<T>(acc[mi][ni][q], bb.x);
      X[r * L::LDX + c + 1] = emb_out<T>(acc[mi][ni][q + 1], bb.y);
    });
  }
}

}  // namespace
}  // namespace fdk
