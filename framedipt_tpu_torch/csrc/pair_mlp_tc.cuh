// The pair MLP's tensor-core pieces for Hopper (sm_90a), for the bf16
// backward's kernel A (pair_mlp_bwd.cu): the 64-pair tile's shared-memory layout, the weight
// stream's slice map, the walk of one tile through the MLP's five products (mlp_products) and the
// forward of a tile up to its pre-norm output (forward_tile). Its sums run
// in the bf16 forward's order (pair_mlp_wg_bf16.cu: each product's whole K
// in one float32 accumulator by 16-deep steps), so the backward's recompute
// equals the forward bit for bit.
//
// - Products and weight stream: tc_product.cuh (mma.sync, 3xTF32 in
//   float32, bf16 MMA in bf16; weight slices by cp.async through a ring of
//   three shared-memory stages). This file gives the stream its slice map:
//   the MLP's weights in the order its products read them, 60 slices a
//   tile, 64 with the residual.
#pragma once

#include "tc_product.cuh"

namespace fdk {
namespace {

constexpr int C_IN = 128, HID = 384, C_OUT = 128;
static_assert(C_IN == NC && C_OUT == NC && HID % NC == 0 && NC % kKc == 0, "tile widths");

// The weight slices of a tile (kKc rows x NC columns each), in the order the
// products read them: W0 by output chunk (12), then for each y1 chunk W1's
// column chunk (12) and Wf's row chunk (4), then Wfe (4, RESIDUAL only).
// The backward's input-gradient chain streams Wf^T, W1^T, W0^T and Wfe^T,
// of the same shapes, in the same order.
constexpr int kKSlices = C_IN / kKc;                // slices of a K = 128 product
constexpr int kW0Slices = (HID / NC) * kKSlices;    // 12
constexpr int kChunkSlices = HID / kKc + kKSlices;  // 16
constexpr int kResSlice = kW0Slices + (HID / NC) * kChunkSlices;  // 60

template <typename T>
struct Smem {
  // Tile row strides in floats: 4 (mod 32) for ldmatrix's eight 16-byte rows
  // (TF32 A), 8 (mod 32) for the bf16 A fragments' 64-bit loads.
  static constexpr int PAD = sizeof(T) == 4 ? 4 : 8;
  static constexpr int LDX = C_IN + PAD, LDY0 = HID + PAD, LDY1 = NC + PAD;
  static constexpr int kStage = kStageElems;  // one staged weight slice
  static constexpr size_t kBytes = sizeof(float) * kRows * (LDX + LDY0 + LDY1) +
                                   sizeof(T) * kStages * kStage + sizeof(PairTile);
};
static_assert(Smem<float>::kBytes <= 232448, "shared memory of one block");

template <typename T>
struct MlpSlices {
  const T* w0;
  const T* w1;
  const T* wf;
  const T* wfe;

  // First element of slice s, and its row stride.
  __device__ __forceinline__ const T* slice(int s, int& ldw) const {
    if (s < kW0Slices) {
      ldw = HID;
      return w0 + (size_t)(s % kKSlices) * kKc * HID + (s / kKSlices) * NC;
    }
    if (s < kResSlice) {
      const int hc = (s - kW0Slices) / kChunkSlices, v = (s - kW0Slices) % kChunkSlices;
      if (v < HID / kKc) {
        ldw = HID;
        return w1 + (size_t)v * kKc * HID + hc * NC;
      }
      ldw = C_OUT;
      return wf + (size_t)(hc * NC + (v - HID / kKc) * kKc) * C_OUT;
    }
    ldw = C_OUT;
    return wfe + (size_t)(s - kResSlice) * kKc * C_OUT;
  }
};

template <typename T>
using MlpStream = WeightStream<T, MlpSlices<T>>;

// acc_out (+)= the MLP's products over a tile, in the weight stream's order:
// acc = A0 @ W0[:, chunk cb] for cb = 0, 1, 2, each handed to epi0(cb, acc),
// which fills Y0's chunk cb; then for each 128-column chunk hc,
// acc1 = Y0 @ W1[:, hc], handed to epi1(hc, acc1), which fills Y1 (one
// chunk), acc_out += Y1 @ Wf[hc, :], then chunk_done(hc); then res += A0 @
// Wfe (RESIDUAL). A0, Y0, Y1 are float tiles with the Smem<T> strides. Y0 and
// Y1 are written before the next product's first acquire(), whose barrier
// makes them visible (to chunk_done too); Y1 is rewritten only after the
// first barrier of the next W1 product, which every warp reaches after the
// last Wf product and chunk_done.
template <typename T, bool RESIDUAL, typename Epi0, typename Epi1, typename Done>
__device__ __forceinline__ void mlp_products(const float* __restrict__ A0, const float* Y0,
                                             const float* Y1, const MlpStream<T>& ws,
                                             Epi0 epi0, Epi1 epi1, Done chunk_done,
                                             float (&acc_out)[2][kNi][4],
                                             float (&res)[2][kNi][4]) {
  using L = Smem<T>;
  int s = 0;
  for (int cb = 0; cb < HID / NC; ++cb) {
    float acc[2][kNi][4] = {};
    product(A0, L::LDX, C_IN, ws, s, acc);
    epi0(cb, acc);
  }
  for (int hc = 0; hc < HID / NC; ++hc) {
    float acc1[2][kNi][4] = {};
    product(Y0, L::LDY0, HID, ws, s, acc1);
    epi1(hc, acc1);
    product(Y1, L::LDY1, NC, ws, s, acc_out);
    chunk_done(hc);
  }
  if (RESIDUAL) product(A0, L::LDX, C_IN, ws, s, res);
}

// The backward's recompute of a 64-pair tile, pair tile in X, up to the
// pre-norm output, which it leaves in X (every row; rows past the grid hold
// no pair). Each valid row's y0 and y1 also go to y0s and y1s (T's values
// already; row r at r * HID, whole rows from shared memory once a tile or
// chunk is complete), and their relu decisions (y > 0) to m0s and m1s
// (mask_word order, HID / NC chunks each).
template <typename T, bool RESIDUAL>
__device__ __forceinline__ void forward_tile(float* X, float* Y0, float* Y1, const PairTile& pt,
                                             const MlpStream<T>& ws,
                                             const T* __restrict__ i_term,
                                             const T* __restrict__ j_term,
                                             const T* __restrict__ fi, const T* __restrict__ fj,
                                             const T* __restrict__ b0, const T* __restrict__ b1,
                                             const T* __restrict__ bf, T* y0s, T* y1s,
                                             uint32_t* m0s, uint32_t* m1s) {
  using L = Smem<T>;
  float acc_out[2][kNi][4] = {}, res[2][kNi][4] = {};
  mlp_products<T, RESIDUAL>(
      X, Y0, Y1, ws,
      // y0 = relu(pair @ W0 + i_term + j_term + b0). Elements q and q + 1
      // are neighbours in a row: their terms load as pairs.
      [&](int cb, float (&acc)[2][kNi][4]) {
        for_each_elem([&](int r, int c, int mi, int ni, int q) {
          if (q & 1) return;
          const int prow = max(pt.row[r], 0), pcol = pt.col[r];
          c += cb * NC;
          const float2 it = ld2(i_term + (size_t)prow * HID + c);
          const float2 jt = ld2(j_term + (size_t)pcol * HID + c);
          const float2 bb = ld2(b0 + c);
          const float v0 = pair_y0<T>(acc[mi][ni][q], it.x, jt.x, bb.x);
          const float v1 = pair_y0<T>(acc[mi][ni][q + 1], it.y, jt.y, bb.y);
          Y0[r * L::LDY0 + c] = v0;
          Y0[r * L::LDY0 + c + 1] = v1;
          store_relu_bits(m0s, cb, mi, ni, q, v0, v1);
        });
      },
      // y1_c = relu(y0 @ W1[:, c] + b1[c])
      [&](int hc, float (&acc1)[2][kNi][4]) {
        for_each_elem([&](int r, int c, int mi, int ni, int q) {
          if (q & 1) return;
          const float v0 = pair_y1<T>(acc1[mi][ni][q], ld<T>(b1 + hc * NC + c));
          const float v1 = pair_y1<T>(acc1[mi][ni][q + 1], ld<T>(b1 + hc * NC + c + 1));
          Y1[r * L::LDY1 + c] = v0;
          Y1[r * L::LDY1 + c + 1] = v1;
          store_relu_bits(m1s, hc, mi, ni, q, v0, v1);
        });
      },
      [&](int hc) { store_rows(Y1, L::LDY1, NC, pt, y1s + hc * NC, HID); },
      acc_out, res);
  __syncthreads();  // every warp has finished reading X: it takes the pre-norm output
  store_rows(Y0, L::LDY0, HID, pt, y0s, HID);
  for_each_elem([&](int r, int c, int mi, int ni, int q) {
    const int prow = max(pt.row[r], 0), pcol = pt.col[r];
    X[r * L::LDX + c] = pair_out<T, RESIDUAL>(acc_out[mi][ni][q], res[mi][ni][q], fi, fj, prow,
                                              pcol, c, ld<T>(bf + c));
  });
}

}  // namespace
}  // namespace fdk
