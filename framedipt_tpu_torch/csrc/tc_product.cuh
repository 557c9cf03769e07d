// Tensor-core products of a 64-row tile for Hopper (sm_90a), fed by a
// stream of weight slices, shared by the edge-stack kernels that run on the
// tensor cores on mma.sync: the bf16 edge embedder's forward and its
// backward's kernel A (edge_embedder_tc.cuh); with the backward kernels'
// row stores and relu decisions (store_rows, store_relu_bits, relu_grad).
//
// - Products: mma.sync on fragments loaded from shared-memory tiles
//   (mma.cuh). A block has 8 warps; warp w owns rows 32 (w % 2) .. and
//   columns 32 (w / 2) .. of each 64 x 128 output chunk, 2 x 4 MMA tiles of
//   16 x 8. Tile rows are padded so a warp's fragment loads hit 32 distinct
//   banks (the callers' strides: 4 (mod 32) floats in float32, 8 in bf16).
//   float32 (3xTF32, m16n8k8): A comes by ldmatrix (its 8 x 4 blocks of
//   32-bit values are the A fragment), B by 32-bit loads; each operand is
//   split in registers into TF32 hi + lo, and each k step adds a_lo b_hi,
//   then a_hi b_lo, then a_hi b_hi; a_lo b_lo (~2^-22 relative) is left out.
//   The tensor cores round their float32 sums toward zero, so each 32-deep
//   slice sums into a zeroed fragment that is then added to the running sum
//   with round-to-nearest: summed in place (144 truncations at K = 384) the
//   pair MLP's error after the LayerNorm was 1.3e-5, this way 3e-6 (H100,
//   B=2 N=200). So the products keep float32 accuracy. The weights are split
//   in the kernel, not once per call by the wrapper: a split copy would
//   double the L2 weight stream and add a launch and workspace per call.
//   bf16 (m16n8k16): the tiles hold values already rounded to bf16, so
//   packing them is exact and one MMA gives the product up to the order of
//   summation.
// - Weight stream: the weights stream through L2 in slices of 32 rows x 128
//   columns, by cp.async (16 bytes a thread) into a ring of STAGES
//   shared-memory stages: STAGES - 1 slices are in flight while the block
//   multiplies one. Which rows of which weight make slice s is the caller's
//   slice map (Map::slice); the stream runs across product boundaries, so
//   the next product's first slices load during an epilogue. Stage rows are
//   padded by 8 elements, so the B fragments (32-bit loads in float32,
//   ldmatrix.trans in bf16) do not conflict in banks. The slices arrive
//   before they are waited for; starting the copies is what costs (each
//   thread's 16-byte copies queue behind the fragment loads), so bf16, whose
//   products are short, spreads them over the k steps.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace fdk {
namespace {

constexpr int NC = 128;     // columns of every product's output chunk
constexpr int kStages = 3;  // weight slices in the ring, unless a kernel asks for another count
// Warp layout: two warps down the 64 rows of a tile, kColWarps across the
// NC columns of an output chunk; a warp owns 32 x kWarpCols of it, 2 x kNi
// MMA tiles of 16 x 8.
constexpr int kColWarps = 4;
constexpr int kBlock = 2 * kColWarps * 32;  // threads
constexpr int kWarpCols = NC / kColWarps, kNi = kWarpCols / 8;
static_assert(kNi % 2 == 0, "bf16 B fragments come two n-tiles at a time");
static_assert(kBlock == kThreads, "common.cuh's tile helpers take the same block");

// One staged weight slice: kKc rows of NC elements, rows padded by 8.
constexpr int kLdw = NC + 8, kStageElems = kKc * kLdw;

// The weight slices of a tile, in the order the products read them: slice s
// is Map::slice(s, ldw), kKc rows x NC columns of a row-major weight with
// row stride ldw (a multiple of 16 bytes), from the returned element.
template <typename T, typename Map, int STAGES = kStages>
struct WeightStream {
  static_assert(STAGES >= 2, "a slice in flight while one is multiplied");
  Map map;
  T* stages;  // [STAGES][kKc][kLdw]
  int total;  // slices of the tile

  static constexpr int kVec = 16 / sizeof(T), kPerRow = NC / kVec;
  static constexpr int kCopies = kKc * kPerRow / kBlock;  // 16-byte copies a thread

  // This thread's copy `part` (< kCopies) of slice s into its stage; nothing
  // past the last slice.
  __device__ __forceinline__ void copy(int s, int part) const {
    if (s >= total) return;
    int ldw;
    const T* src = map.slice(s, ldw);
    const int idx = threadIdx.x + part * kBlock, r = idx / kPerRow, c = (idx - r * kPerRow) * kVec;
    cp_async16(stages + (s % STAGES) * kStageElems + r * kLdw + c,
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
  // finished with slice s - 1, so its stage may take slice s + STAGES - 1:
  // the caller starts that next, at once (acquire) or spread over slice s's
  // k steps.
  __device__ __forceinline__ const T* wait(int s) const {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    return stages + (s % STAGES) * kStageElems;
  }

  __device__ __forceinline__ const T* acquire(int s) const {
    const T* stage = wait(s);
    start(s + STAGES - 1);
    return stage;
  }
};

// acc += A[64 x K] @ (the stream's next K / kKc slices, slices s ..), where A
// is float in shared memory with row stride lda. 3xTF32.
template <typename Map, int STAGES>
__device__ __forceinline__ void product(const float* __restrict__ A, int lda, int K,
                                        const WeightStream<float, Map, STAGES>& ws, int& s,
                                        float (&acc)[2][kNi][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  // A by ldmatrix: lanes 0-15 give rows 0-15 at k, lanes 16-31 the same rows
  // at k + 4, so r[0..3] are a0..a3.
  const float* Al = A + ((warp & 1) * 32 + (lane & 15)) * lda + (lane >> 4) * 4;
  const int boff = t * kLdw + (warp >> 1) * kWarpCols + g;
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
        const float* b = W + kk * kLdw + ni * 8;
        uint32_t bhi[2], blo[2];
        split_tf32(b[0], bhi[0], blo[0]);
        split_tf32(b[4 * kLdw], bhi[1], blo[1]);
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
template <typename Map, int STAGES>
__device__ __forceinline__ void product(const float* __restrict__ A, int lda, int K,
                                        const WeightStream<__nv_bfloat16, Map, STAGES>& ws,
                                        int& s, float (&acc)[2][kNi][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const float* Aw = A + ((warp & 1) * 32 + g) * lda + 2 * t;
  // This lane's ldmatrix row: k row lane % 16; lanes 16-31 the next 8 columns.
  const int boff = (lane & 15) * kLdw + (warp >> 1) * kWarpCols + (lane >> 4) * 8;
  static_assert(WeightStream<__nv_bfloat16, Map, STAGES>::kCopies == kKc / 16,
                "one copy a k step");
  for (int k0 = 0; k0 < K; k0 += kKc, ++s) {
    const __nv_bfloat16* W = ws.wait(s) + boff;
#pragma unroll
    for (int kk = 0; kk < kKc; kk += 16) {
      ws.copy(s + STAGES - 1, kk / 16);
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
        ldmatrix_x4_trans(b, W + kk * kLdw + np * 16);
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

// Rows r < kRows with pt.row[r] >= 0 of a shared-memory tile (row stride
// lds, `cols` columns, a multiple of 4) to dst + r * ldd, 16 bytes a thread,
// a row's copies side by side. Evict-first stores (st.global.cs): the pair
// MLP's float32 backward streams 0.87 GB of activations through L2 this
// way, and with plain stores they pushed out the weights every tile streams
// from L2 (kernel A 4.47-4.49 ms, 4.11-4.17 with these, H100 at B=2 N=256).
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

// The same into bf16 rows (cols a multiple of 8), each value rounded to
// nearest even (exact for values that are bf16 already).
__device__ __forceinline__ void store_rows(const float* S, int lds, int cols, const PairTile& pt,
                                           __nv_bfloat16* dst, int ldd) {
  const int per_row = cols / 8;
  for (int idx = threadIdx.x; idx < kRows * per_row; idx += kBlock) {
    const int r = idx / per_row, c = (idx - r * per_row) * 8;
    if (pt.row[r] >= 0) {
      const float4 a = *reinterpret_cast<const float4*>(S + r * lds + c);
      const float4 b = *reinterpret_cast<const float4*>(S + r * lds + c + 4);
      __stcs(reinterpret_cast<uint4*>(dst + (size_t)r * ldd + c),
             make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                        pack_bf16(b.z, b.w)));
    }
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

// (a0, a1) where this lane's bits of the mask words of elements q and q + 1
// are set, else 0.
__device__ __forceinline__ float2 relu_grad(const uint32_t* m, int chunk, int mi, int ni, int q,
                                            float a0, float a1) {
  const int lane = threadIdx.x & 31;
  return make_float2((m[mask_word(chunk, mi, ni, q)] >> lane) & 1u ? a0 : 0.f,
                     (m[mask_word(chunk, mi, ni, q + 1)] >> lane) & 1u ? a1 : 0.f);
}

}  // namespace
}  // namespace fdk
