// The pair MLP's tensor-core pieces for Hopper (sm_90a), shared by the
// forward kernel (pair_mlp.cu) and the float32 backward's kernel A
// (pair_mlp_bwd.cu): the 64-pair tile's shared-memory layout, the weight
// stream, the mma.sync products (3xTF32 in float32, bf16 MMA in bf16), the
// walk of one tile through the MLP's five products (mlp_products) and the
// forward of a tile up to its pre-norm output (forward_tile). Both kernels
// run this code, so the backward's recompute equals the forward bit for bit.
//
// - Products: mma.sync on fragments loaded from those tiles (mma.cuh). Warp w
//   owns rows 32 (w % 2) .. and columns 32 (w / 2) .. of each 64 x 128 output
//   chunk, 2 x 4 MMA tiles of 16 x 8. Tile rows are padded so a warp's
//   fragment loads hit 32 distinct banks. (16 warps of 32 x 16 each were
//   slower in float32 on the H100: the products are bound by the rate of
//   mma.sync, not by the warps in flight.)
//   float32 (3xTF32, m16n8k8): A comes by ldmatrix (its 8 x 4 blocks of
//   32-bit values are the A fragment), B by 32-bit loads; each operand is
//   split in registers into TF32 hi + lo, and each k step adds a_lo b_hi,
//   then a_hi b_lo, then a_hi b_hi; a_lo b_lo (~2^-22 relative) is left out.
//   The tensor cores round their float32 sums toward zero, so each 32-deep
//   slice sums into a zeroed fragment that is then added to the running sum
//   with round-to-nearest: summed in place (144 truncations at K = 384) the
//   error after the LayerNorm was 1.3e-5, this way 3e-6 (H100, B=2 N=200).
//   So the products keep float32 accuracy. The weights are split in the
//   kernel, not once per call by the wrapper: a split copy would double the
//   L2 weight stream below and add a launch and 2 MB of workspace per call.
//   bf16 (m16n8k16): the tiles hold values already rounded to bf16, so
//   packing them is exact and one MMA gives the product up to the order of
//   summation.
// - Weight stream: W1 alone is 576 KB in float32, so the weights stream
//   through L2 in slices of 32 rows x 128 columns, by cp.async (16 bytes a
//   thread) into a ring of three shared-memory stages: two slices are in
//   flight while the block multiplies the third. The stream runs across
//   product boundaries (60 slices a tile, 64 with the residual, in a fixed
//   order), so the next product's first slices load during an epilogue.
//   Stage rows are padded by 8 elements, so the B fragments (32-bit loads in
//   float32, ldmatrix.trans in bf16) do not conflict in banks. The slices
//   arrive before they are waited for; starting the copies is what costs
//   (each thread's 16-byte copies queue behind the fragment loads), so bf16,
//   whose products are short, spreads them over the k steps.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace fdk {
namespace {

constexpr int C_IN = 128, HID = 384, C_OUT = 128;
constexpr int NC = 128;     // columns of every product's output chunk (a y1 chunk too)
constexpr int kStages = 3;  // weight slices in the ring
// Warp layout: two warps down the 64 rows of a tile, kColWarps across the
// NC columns of an output chunk; a warp owns 32 x kWarpCols of it, 2 x kNi
// MMA tiles of 16 x 8.
constexpr int kColWarps = 4;
constexpr int kBlock = 2 * kColWarps * 32;  // threads
constexpr int kWarpCols = NC / kColWarps, kNi = kWarpCols / 8;
static_assert(kNi % 2 == 0, "bf16 B fragments come two n-tiles at a time");
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
  static constexpr int LDW = NC + 8;  // staged weight row, in elements of T
  static constexpr int kStage = kKc * LDW;
  static constexpr size_t kBytes = sizeof(float) * kRows * (LDX + LDY0 + LDY1) +
                                   sizeof(T) * kStages * kStage + sizeof(PairTile);
};
static_assert(Smem<float>::kBytes <= 232448, "shared memory of one block");

template <typename T>
struct WeightStream {
  const T* w0;
  const T* w1;
  const T* wf;
  const T* wfe;
  T* stages;
  int total;  // slices of the tile

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

  static constexpr int kVec = 16 / sizeof(T), kPerRow = NC / kVec;
  static constexpr int kCopies = kKc * kPerRow / kBlock;  // 16-byte copies a thread

  // This thread's copy `part` (< kCopies) of slice s into its stage; nothing
  // past the last slice.
  __device__ __forceinline__ void copy(int s, int part) const {
    if (s >= total) return;
    int ldw;
    const T* src = slice(s, ldw);
    const int idx = threadIdx.x + part * kBlock, r = idx / kPerRow, c = (idx - r * kPerRow) * kVec;
    cp_async16(stages + (s % kStages) * Smem<T>::kStage + r * Smem<T>::LDW + c,
               src + (size_t)r * ldw + c);
  }

  // All of this thread's copies of slice s, then one commit group (empty
  // past the last slice), so every thread's group count is the slice index.
  __device__ __forceinline__ void start(int s) const {
#pragma unroll
    for (int part = 0; part < kCopies; ++part) copy(s, part);
    cp_async_commit();
  }

  // Slice s in shared memory, visible to the whole block. Every thread calls
  // it for s = 0, 1, 2, ... in order. Past the barrier every thread has also
  // finished with slice s - 1, so its stage may take slice s + 2: the caller
  // starts that next, at once (acquire) or spread over slice s's k steps.
  __device__ __forceinline__ const T* wait(int s) const {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    return stages + (s % kStages) * Smem<T>::kStage;
  }

  __device__ __forceinline__ const T* acquire(int s) const {
    const T* stage = wait(s);
    start(s + kStages - 1);
    return stage;
  }
};

// acc += A[64 x K] @ (the stream's next K / kKc slices, slices s ..), where A
// is float in shared memory with row stride lda. 3xTF32.
__device__ __forceinline__ void product(const float* __restrict__ A, int lda, int K,
                                        const WeightStream<float>& ws, int& s,
                                        float (&acc)[2][kNi][4]) {
  constexpr int LDW = Smem<float>::LDW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  // A by ldmatrix: lanes 0-15 give rows 0-15 at k, lanes 16-31 the same rows
  // at k + 4, so r[0..3] are a0..a3.
  const float* Al = A + ((warp & 1) * 32 + (lane & 15)) * lda + (lane >> 4) * 4;
  const int boff = t * LDW + (warp >> 1) * kWarpCols + g;
  for (int k0 = 0; k0 < K; k0 += kKc, ++s) {
    const float* W = ws.acquire(s) + boff;
    float part[2][kNi][4] = {};  // this slice's sum
#pragma unroll
    for (int kk = 0; kk < kKc; kk += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t r[4];
        ldmatrix_x4(r, Al + mi * 16 * lda + k0 + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), ahi[mi][i], alo[mi][i]);
      }
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) {
        const float* b = W + kk * LDW + ni * 8;
        uint32_t bhi[2], blo[2];
        split_tf32(b[0], bhi[0], blo[0]);
        split_tf32(b[4 * LDW], bhi[1], blo[1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_tf32(part[mi][ni], alo[mi], bhi);
          mma_tf32(part[mi][ni], ahi[mi], blo);
          mma_tf32(part[mi][ni], ahi[mi], bhi);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] += part[mi][ni][q];
  }
}

// The same in bf16: A's values are bf16 already; B comes by ldmatrix.trans.
// The products are short here, so the next slice's copies go out one a k
// step, between the MMAs, rather than all at the barrier (faster in bf16,
// slower in float32, on the H100).
__device__ __forceinline__ void product(const float* __restrict__ A, int lda, int K,
                                        const WeightStream<__nv_bfloat16>& ws, int& s,
                                        float (&acc)[2][kNi][4]) {
  constexpr int LDW = Smem<__nv_bfloat16>::LDW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const float* Aw = A + ((warp & 1) * 32 + g) * lda + 2 * t;
  // This lane's ldmatrix row: k row lane % 16; lanes 16-31 the next 8 columns.
  const int boff = (lane & 15) * LDW + (warp >> 1) * kWarpCols + (lane >> 4) * 8;
  static_assert(WeightStream<__nv_bfloat16>::kCopies == kKc / 16, "one copy a k step");
  for (int k0 = 0; k0 < K; k0 += kKc, ++s) {
    const __nv_bfloat16* W = ws.wait(s) + boff;
#pragma unroll
    for (int kk = 0; kk < kKc; kk += 16) {
      ws.copy(s + kStages - 1, kk / 16);
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* p = Aw + mi * 16 * lda + k0 + kk;
        const float2 v0 = *reinterpret_cast<const float2*>(p);
        const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * lda);
        const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
        const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * lda + 8);
        a[mi][0] = pack_bf16(v0.x, v0.y);
        a[mi][1] = pack_bf16(v1.x, v1.y);
        a[mi][2] = pack_bf16(v2.x, v2.y);
        a[mi][3] = pack_bf16(v3.x, v3.y);
      }
#pragma unroll
      for (int np = 0; np < kNi / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, W + kk * LDW + np * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    cp_async_commit();
  }
}

// f(r, c, mi, ni, q) for each accumulator element of this warp: tile row r,
// column c of the 128-column chunk, and the element's index in acc.
template <typename F>
__device__ __forceinline__ void for_each_elem(F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (warp & 1) * 32 + (lane >> 2), c0 = (warp >> 1) * kWarpCols + 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) f(r0 + mi * 16 + (q >> 1) * 8, c0 + ni * 8 + (q & 1), mi, ni, q);
}

// Two neighbouring elements (p 4- or 8-byte aligned) as floats.
__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

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
                                             const float* Y1, const WeightStream<T>& ws,
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

// Rows r < kRows with pt.row[r] >= 0 of a shared-memory tile (row stride
// lds, `cols` columns, a multiple of 4) to dst + r * ldd, 16 bytes a thread,
// a row's copies side by side. Evict-first stores (st.global.cs): the float32
// backward streams 0.87 GB of activations through L2 this way, and with
// plain stores they pushed out the weights every tile streams from L2
// (kernel A 4.47-4.49 ms, 4.11-4.17 with these, H100 at B=2 N=256).
__device__ __forceinline__ void store_rows(const float* S, int lds, int cols, const PairTile& pt,
                                           float* dst, int ldd) {
  const int per_row = cols / 4;
  for (int idx = threadIdx.x; idx < kRows * per_row; idx += kBlock) {
    const int r = idx / per_row, c = (idx - r * per_row) * 4;
    if (pt.row[r] >= 0)
      __stcs(reinterpret_cast<float4*>(dst + (size_t)r * ldd + c),
             *reinterpret_cast<const float4*>(S + r * lds + c));
  }
}

// Relu decisions of a tile's 128-column chunk in fragment order: one 32-bit
// ballot (bit = lane) per warp, MMA tile (mi, ni) and accumulator element q,
// 256 words a chunk. A product's epilogue that walks the same fragments
// (for_each_elem) reads its lane's bit back.
constexpr int kMaskWords = (kBlock / 32) * 2 * kNi * 4;
__device__ __forceinline__ int mask_word(int chunk, int mi, int ni, int q) {
  return chunk * kMaskWords + (((threadIdx.x >> 5) * 2 + mi) * kNi + ni) * 4 + q;
}

// Elements q and q + 1 of a chunk's fragments: their relu decisions. Every
// lane of the warp calls it.
__device__ __forceinline__ void store_relu_bits(uint32_t* m, int chunk, int mi, int ni, int q,
                                                float v0, float v1) {
  const uint32_t b0 = __ballot_sync(0xffffffffu, v0 > 0.f);
  const uint32_t b1 = __ballot_sync(0xffffffffu, v1 > 0.f);
  if ((threadIdx.x & 31) == 0) {
    m[mask_word(chunk, mi, ni, q)] = b0;
    m[mask_word(chunk, mi, ni, q + 1)] = b1;
  }
}

// The forward of a 64-pair tile, pair tile in X, up to the pre-norm output,
// which it leaves in X (every row; rows past the grid hold no pair). With
// STORE (float32 only), each valid row's y0 and y1 also go to y0s and y1s
// (row r at r * HID, whole rows from shared memory once a tile or chunk is
// complete), and their relu decisions (y > 0) to m0s and m1s (mask_word
// order, HID / NC chunks each).
template <typename T, bool RESIDUAL, bool STORE>
__device__ __forceinline__ void forward_tile(float* X, float* Y0, float* Y1, const PairTile& pt,
                                             const WeightStream<T>& ws,
                                             const T* __restrict__ i_term,
                                             const T* __restrict__ j_term,
                                             const T* __restrict__ fi, const T* __restrict__ fj,
                                             const T* __restrict__ b0, const T* __restrict__ b1,
                                             const T* __restrict__ bf, float* y0s, float* y1s,
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
          if (STORE) store_relu_bits(m0s, cb, mi, ni, q, v0, v1);
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
          if (STORE) store_relu_bits(m1s, hc, mi, ni, q, v0, v1);
        });
      },
      [&](int hc) {
        if (STORE) store_rows(Y1, L::LDY1, NC, pt, y1s + hc * NC, HID);
      },
      acc_out, res);
  __syncthreads();  // every warp has finished reading X: it takes the pre-norm output
  if (STORE) store_rows(Y0, L::LDY0, HID, pt, y0s, HID);
  for_each_elem([&](int r, int c, int mi, int ni, int q) {
    const int prow = max(pt.row[r], 0), pcol = pt.col[r];
    X[r * L::LDX + c] = pair_out<T, RESIDUAL>(acc_out[mi][ni][q], res[mi][ni][q], fi, fj, prow,
                                              pcol, c, ld<T>(bf + c));
  });
}

}  // namespace
}  // namespace fdk
