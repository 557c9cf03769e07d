// The bf16 pair MLP's 128-pair tile on wgmma and TMA, for Hopper (sm_90a):
// the block's shared-memory layout, the weight ring's producer (produce) and
// consumer (Ring) sides, and the forward of a warpgroup's 64 pairs up to
// their pre-norm output (forward_tile), with the hooks a backward's
// recompute needs to keep what the forward drops (those of
// pair_mlp_wg.cuh's forward_tile). pair_mlp_wg_bf16.cu's header describes
// the design. The bf16 backward's kernel A (pair_mlp_bwd_wg_bf16.cu) runs
// forward_tile for its recompute and then its input-gradient chain through
// the same ring: the chain's slices (chain_coords) are the stored weights
// read K-major, each a 128 (n) x 64 (k) block of W [in, out] (Ring::product
// with KMAJOR_B).
//
// Layout of every activation tile (X, Y0, the Y1 chunk): bf16, column blocks
// of 64 (one 128-byte row a pair), each block kTile rows, as TMA writes a
// box of 64 columns with the 128-byte swizzle: inside a row the 16-byte
// chunk c sits at chunk c ^ (row % 8). Warpgroup g owns rows 64 g .. 64 g +
// 63 of every tile, 8 KB into each block (a 1024-byte boundary).
#pragma once

#include "common.cuh"
#include "wgmma_tma.cuh"

namespace fdk {
namespace {
namespace wgb {

constexpr int C_IN = 128, HID = 384, C_OUT = 128, NC = 128;
constexpr int kTile = 128;                     // pairs a tile
constexpr int kHalf = 64;                      // pairs a consumer warpgroup
constexpr int kStages = 3;                     // weight slices in the ring
constexpr int kConsumers = 256, kBlockThreads = kConsumers + 128;
constexpr int kSliceK = 64;                    // depth of a weight slice
constexpr int kBox = 64 * 64;                  // bf16 elements of one box: 64 rows x 64 columns
constexpr uint32_t kBoxBytes = kBox * 2;       // Bm's leading byte offset (columns 64 .. 127)
constexpr int kBlock = kTile * 64;             // elements of one column block of a tile
constexpr int kKSlices = C_IN / kSliceK;       // slices of a K = 128 product: 2
constexpr int kW0Slices = (HID / NC) * kKSlices;          // 6
constexpr int kChunkSlices = HID / kSliceK + kKSlices;    // 8: W1's 6, then Wf's 2
constexpr int kResSlice = kW0Slices + (HID / NC) * kChunkSlices;  // 30; Wfe's 2 follow
constexpr int kB1 = HID, kBf = 2 * HID;        // b1's and bf's offsets in Smem::bias
static_assert(kBoxBytes % 1024 == 0 && (kHalf * 128) % 1024 == 0, "swizzle patterns start whole");

typedef __nv_bfloat16 bf16;

struct __align__(1024) Smem {
  bf16 w[kStages][2][kBox];     // weight slices: 64 (k) rows x 128 (n), two boxes of 64 columns
  bf16 x[C_IN / 64][kBlock];    // pair tile, by TMA
  bf16 y0[HID / 64][kBlock];    // first hidden layer
  bf16 y1[NC / 64][kBlock];     // one 128-column chunk of y1, then the pre-norm output
  bf16 bias[HID + HID + C_OUT]; // b0, b1, bf
  PairTile pt[2];               // each warpgroup's 64 rows
  uint64_t full[kStages], empty[kStages], xfull, xempty;
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;
static_assert(kSmemBytes <= 232448, "shared memory of one block");

// Element offset of (r, c) of a tile (r < kTile).
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * kBlock + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// The kernel's tensor maps: the weights as stored ([in, out] row-major,
// boxes of 64 rows x 64 columns) and the pair input ([pairs, C_IN], boxes of
// kTile rows x 64 columns).
struct Maps {
  CUtensorMap w0, w1, wf, wfe, pair;
};

// The tensor map and coordinates of slice s of a tile: its first output
// column (the first box's; the second is 64 further) and first input row.
__device__ __forceinline__ const CUtensorMap* slice_coords(const Maps& m, int s, int& col,
                                                           int& row) {
  if (s < kW0Slices) {
    col = (s / kKSlices) * NC;
    row = (s % kKSlices) * kSliceK;
    return &m.w0;
  }
  if (s < kResSlice) {
    const int hc = (s - kW0Slices) / kChunkSlices, v = (s - kW0Slices) % kChunkSlices;
    if (v < HID / kSliceK) {
      col = hc * NC;
      row = v * kSliceK;
      return &m.w1;
    }
    col = 0;
    row = hc * NC + (v - HID / kSliceK) * kSliceK;
    return &m.wf;
  }
  col = 0;
  row = (s - kResSlice) * kSliceK;
  return &m.wfe;
}

// Slice s of a tile's input-gradient chain, the forward's products on the
// transposed weights: dy1 = dxd @ Wf^T by output chunk, then for each
// 128-column chunk of dy0 W1^T's slices and W0^T's, then Wfe^T's. W^T's k
// runs along a stored row of W ([in, out]), so each slice is the 128 stored
// rows row .. row + 127 (n) by the 64 stored columns col .. col + 63 (k),
// staged K-major as two boxes of 64 rows (the second at row + 64).
__device__ __forceinline__ const CUtensorMap* chain_coords(const Maps& m, int s, int& col,
                                                           int& row) {
  if (s < kW0Slices) {
    row = (s / kKSlices) * NC;
    col = (s % kKSlices) * kSliceK;
    return &m.wf;
  }
  if (s < kResSlice) {
    const int hc = (s - kW0Slices) / kChunkSlices, v = (s - kW0Slices) % kChunkSlices;
    if (v < HID / kSliceK) {
      row = hc * NC;
      col = v * kSliceK;
      return &m.w1;
    }
    row = 0;
    col = hc * NC + (v - HID / kSliceK) * kSliceK;
    return &m.w0;
  }
  row = 0;
  col = (s - kResSlice) * kSliceK;
  return &m.wfe;
}

// d (+)= a @ b: m64n128k16, bf16 inputs, float32 accumulators; a a K-major
// descriptor (rows of 128 bytes, transpose flag 0), b an MN-major one
// (transpose flag 1); d as wg::wgmma_m64n128k8_tf32's. accumulate = 0
// ignores d's old values.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same with b K-major too (transpose flag 0): b a descriptor of 128 (n)
// rows of 128 bytes (64 k each), the k16 step 32 bytes into them.
__device__ __forceinline__ void wgmma_m64n128k16_kb(float (&d)[64], uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Two bf16 values (columns c, c + 1) from device memory, 4-byte aligned.
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }
// Two floats that are bf16 values already, packed (exact).
__device__ __forceinline__ uint32_t pack(float v0, float v1) {
  return (__float_as_uint(v0) >> 16) | (__float_as_uint(v1) & 0xFFFF0000u);
}

// The consumer side of the weight ring: slices counted across the block's
// tiles (n); both warpgroups read every slice, each with its own rows of A.
struct Ring {
  Smem& sm;
  int group;   // warpgroup 0 or 1: tile rows 64 group .. + 63
  uint32_t n;  // slices consumed so far, counted across the block's tiles

  __device__ __forceinline__ void release(uint32_t slice) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&sm.empty[slice % kStages]);
  }

  // acc (+)= A @ (the ring's next K / 64 slices), A this warpgroup's rows of
  // a tile (column blocks of 64, K-major); the whole K sums in the
  // accumulators (fresh: the first product ignores acc's old values). Each
  // slice's products are in flight while the next slice's are issued, and
  // its stage goes back to the producer once they are done; during() (the
  // epilogue's loads from device memory) runs while the last slice's do.
  // The forward's slices are MN-major (the weight's 64 k rows x 128 n as two
  // boxes of 64 columns); KMAJOR_B: the chain's, 128 n rows x 64 k.
  template <int K, bool KMAJOR_B = false, typename During>
  __device__ __forceinline__ void product(const bf16* A, float (&acc)[64], bool fresh,
                                          During during) {
    constexpr int S = K / kSliceK;
    const bf16* a0 = A + group * (kHalf * 64);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint32_t it = n + s;
      const int st = it % kStages;
      wg::mbar_wait(&sm.full[st], (it / kStages) & 1);
      const bf16* a = a0 + s * kBlock;
      const bf16* b = sm.w[st][0];
#pragma unroll
      for (int i = 0; i < 64; ++i) wg::fence_operand(acc[i]);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSliceK / 16; ++kk) {
        const int accumulate = (s > 0 || kk > 0 || !fresh) ? 1 : 0;
        if constexpr (KMAJOR_B)
          wgmma_m64n128k16_kb(acc, wg::desc_sw128(a + 16 * kk), wg::desc_sw128(b + 16 * kk),
                              accumulate);
        else
          wgmma_m64n128k16(acc, wg::desc_sw128(a + 16 * kk),
                           wg::desc_mn_sw128(b + kk * 16 * 64, kBoxBytes), accumulate);
      }
      wg::wgmma_commit();
      if (s > 0) {
        wg::wgmma_wait<1>();
        release(it - 1);
      }
    }
    during();
    wg::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) wg::fence_operand(acc[i]);
    release(n + S - 1);
    n += S;
  }
  template <int K, bool KMAJOR_B = false>
  __device__ __forceinline__ void product(const bf16* A, float (&acc)[64], bool fresh) {
    product<K, KMAJOR_B>(A, acc, fresh, [] {});
  }
};

// f(r, c, i) for each of this thread's accumulator elements i (even i
// only; i + 1 is column c + 1): row r of the warpgroup's 64, column c of the
// 128-column chunk.
template <typename F>
__device__ __forceinline__ void for_each_pair(F f) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int r0 = 16 * wq + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 64; i += 2) f(r0 + 8 * ((i >> 1) & 1), c0 + 8 * (i >> 2), i);
}

// Two bf16 values at (row r of the warpgroup's, column c) of a tile.
__device__ __forceinline__ void store_pair(bf16* tile, int group, int r, int c, float v0,
                                           float v1) {
  *reinterpret_cast<uint32_t*>(tile + swz(kHalf * group + r, c)) = pack(v0, v1);
}
__device__ __forceinline__ uint32_t load_pair(const bf16* tile, int group, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(tile + swz(kHalf * group + r, c));
}

// Bias elements o, o + 1 (o even) of Smem::bias.
__device__ __forceinline__ uint32_t bias_pair(const Smem& sm, int o) {
  return *reinterpret_cast<const uint32_t*>(sm.bias + o);
}

// b0, b1 and bf into Smem::bias, by the kConsumers consumer threads, which
// the caller synchronizes.
__device__ __forceinline__ void load_biases(Smem& sm, const bf16* __restrict__ b0,
                                            const bf16* __restrict__ b1,
                                            const bf16* __restrict__ bf) {
  for (int e = threadIdx.x; e < HID + HID + C_OUT; e += kConsumers)
    sm.bias[e] = e < kB1 ? b0[e] : e < kBf ? b1[e - kB1] : bf[e - kBf];
}

// common.cuh's layer_norm_store over this warpgroup's 64 rows of the
// pre-norm output O (a tile, bf16): the same arithmetic, each warp on 16
// rows; rows past the grid are not stored.
__device__ __forceinline__ void layer_norm_rows(const bf16* __restrict__ O, int group,
                                                const PairTile& pt, long long p0,
                                                const float* __restrict__ ln_scale,
                                                const float* __restrict__ ln_bias,
                                                bf16* __restrict__ out) {
  const int wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  for (int rr = 0; rr < kHalf / 4; ++rr) {
    const int r = wq * (kHalf / 4) + rr;
    if (pt.row[r] < 0) continue;  // warp-uniform
    float x[C_OUT / 32];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < C_OUT / 32; ++q) {
      x[q] = __bfloat162float(O[swz(kHalf * group + r, lane + 32 * q)]);
      s += x[q];
    }
    const float mean = warp_sum(s) / C_OUT;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < C_OUT / 32; ++q) {
      x[q] -= mean;
      v += x[q] * x[q];
    }
    const float rstd = 1.f / sqrtf(warp_sum(v) / C_OUT + 1e-6f);
    bf16* dst = out + (size_t)(p0 + r) * C_OUT;
#pragma unroll
    for (int q = 0; q < C_OUT / 32; ++q) {
      const int c = lane + 32 * q;
      dst[c] = st<bf16>((x[q] * rstd * __ldg(ln_scale + c) + __ldg(ln_bias + c)) * pt.mask[r]);
    }
  }
}

// The producer: for each of the block's tiles, its pair rows (X, once both
// warpgroups have released the last tile's), then the tile's weight slices
// through the ring: W0 by output chunk, then for each 128-column chunk of y1
// W1's and Wf's slices, then Wfe's (RESIDUAL); with CHAIN (the backward's
// kernel A) then the chain's slices (chain_coords) in their order.
template <bool RESIDUAL, bool CHAIN = false>
__device__ __forceinline__ void produce(Smem& sm, const Maps& maps, long long tiles) {
  constexpr int kSlices = RESIDUAL ? kResSlice + kKSlices : kResSlice;
  wg::prefetch_tensor_map(&maps.w0);
  wg::prefetch_tensor_map(&maps.w1);
  wg::prefetch_tensor_map(&maps.wf);
  if (RESIDUAL) wg::prefetch_tensor_map(&maps.wfe);
  wg::prefetch_tensor_map(&maps.pair);
  uint32_t n = 0, k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    // Rows past the grid read as zeros.
    wg::mbar_wait(&sm.xempty, (k & 1) ^ 1);
    wg::mbar_arrive_expect_tx(&sm.xfull, kTile * C_IN * 2);
    for (int b = 0; b < C_IN / 64; ++b)
      wg::tma_load_2d(sm.x[b], &maps.pair, &sm.xfull, 64 * b, (int)(t * kTile));
    for (int s = 0; s < kSlices; ++s, ++n) {
      const int st = n % kStages;
      wg::mbar_wait(&sm.empty[st], ((n / kStages) & 1) ^ 1);
      int col, row;
      const CUtensorMap* map = slice_coords(maps, s, col, row);
      wg::mbar_arrive_expect_tx(&sm.full[st], 2 * kBoxBytes);
      wg::tma_load_2d(sm.w[st][0], map, &sm.full[st], col, row);
      wg::tma_load_2d(sm.w[st][1], map, &sm.full[st], col + 64, row);
    }
    for (int s = 0; CHAIN && s < kSlices; ++s, ++n) {
      const int st = n % kStages;
      wg::mbar_wait(&sm.empty[st], ((n / kStages) & 1) ^ 1);
      int col, row;
      const CUtensorMap* map = chain_coords(maps, s, col, row);
      wg::mbar_arrive_expect_tx(&sm.full[st], 2 * kBoxBytes);
      wg::tma_load_2d(sm.w[st][0], map, &sm.full[st], col, row);
      wg::tma_load_2d(sm.w[st][1], map, &sm.full[st], col, row + 64);
    }
  }
}

// The barriers' initial state, by thread 0; the caller synchronizes.
__device__ __forceinline__ void init_barriers(Smem& sm) {
  for (int s = 0; s < kStages; ++s) {
    wg::mbar_init(&sm.full[s], 1);
    wg::mbar_init(&sm.empty[s], kConsumers / 32);
  }
  wg::mbar_init(&sm.xfull, 1);
  wg::mbar_init(&sm.xempty, kConsumers / 32);
  wg::fence_barrier_init();
}

// This warpgroup's rows of y0 or y1 written by its threads: visible to its
// wgmma (the async proxy) and to its other threads.
__device__ __forceinline__ void tile_written(int group) {
  wg::fence_proxy_async();
  wg::bar_sync(1 + group, 128);
}

// The forward of this warpgroup's 64 pairs of the tile whose pair rows are
// in X and bookkeeping in pt (its own), the biases in sm.bias, up to their
// pre-norm output, which it leaves in its rows of sm.y1 (every thread of the
// warpgroup past the final barrier). The two warpgroups share nothing but the ring and X, so
// one's epilogues run under the other's products. Common.cuh's epilogues in
// their order (pair_y0, pair_y1, pair_out_v; b0 and bf not folded); every
// product sums its whole K in float32 in the accumulators. Hooks h (those of
// pair_mlp_wg.cuh's forward_tile; a backward's recompute keeps what the
// forward drops):
//   x_done()              X read for the last time by this warpgroup;
//   y0(cb, i, v0, v1)     y0's elements i, i + 1 (for_each_pair) of chunk cb;
//   y0_whole()            the warpgroup's y0 whole in sm.y0, before the W1
//                         products;
//   y1(hc, i, v0, v1)     y1's elements i, i + 1 of chunk hc;
//   y1_whole(hc)          chunk hc whole in the warpgroup's rows of sm.y1,
//                         before its Wf product;
//   y1_free()             before y1's space is rewritten (each chunk, the
//                         rounded y1 @ Wf, then the pre-norm output).
template <bool RESIDUAL, typename Hooks>
__device__ __forceinline__ void forward_tile(Smem& sm, Ring& ring, const PairTile& pt,
                                             const bf16* __restrict__ i_term,
                                             const bf16* __restrict__ j_term,
                                             const bf16* __restrict__ fi,
                                             const bf16* __restrict__ fj, Hooks& h) {
  const int group = ring.group;
  // y0 = relu(pair @ W0 + i_term + j_term + b0), by 128-column chunk; the
  // terms load while the chunk's last products run.
#pragma unroll 1
  for (int cb = 0; cb < HID / NC; ++cb) {
    float acc[64];
    uint32_t it[32], jt[32];  // by element pair i / 2
    ring.product<C_IN>(sm.x[0], acc, true, [&] {
      for_each_pair([&](int r, int c, int i) {
        c += cb * NC;
        it[i / 2] = ld_pair(i_term + (size_t)max(pt.row[r], 0) * HID + c);
        jt[i / 2] = ld_pair(j_term + (size_t)pt.col[r] * HID + c);
      });
    });
    if (!RESIDUAL && cb == HID / NC - 1) h.x_done();
    for_each_pair([&](int r, int c, int i) {
      const int k2 = i / 2;
      const uint32_t bb = bias_pair(sm, cb * NC + c);
      const float v0 = pair_y0<bf16>(acc[i], lo(it[k2]), lo(jt[k2]), lo(bb));
      const float v1 = pair_y0<bf16>(acc[i + 1], hi(it[k2]), hi(jt[k2]), hi(bb));
      store_pair(sm.y0[0], group, r, cb * NC + c, v0, v1);
      h.y0(cb, i, v0, v1);
    });
  }
  tile_written(group);  // the warpgroup's y0 whole
  h.y0_whole();

  float acc_out[64];
// Rolled without the residual product, the loop spilled 48 bytes.
#pragma unroll (RESIDUAL ? 1 : HID / NC)
  for (int hc = 0; hc < HID / NC; ++hc) {
    // y1_c = relu(y0 @ W1[:, c] + b1[c]); acc_out += y1_c @ Wf[c, :]
    float acc1[64];
    ring.product<HID>(sm.y0[0], acc1, true);
    // The last chunk's Wf products, the only readers of y1's space, are done.
    h.y1_free();
    for_each_pair([&](int r, int c, int i) {
      const uint32_t bb = bias_pair(sm, kB1 + hc * NC + c);
      const float v0 = pair_y1<bf16>(acc1[i], lo(bb));
      const float v1 = pair_y1<bf16>(acc1[i + 1], hi(bb));
      store_pair(sm.y1[0], group, r, c, v0, v1);
      h.y1(hc, i, v0, v1);
    });
    tile_written(group);  // this chunk of y1 whole
    h.y1_whole(hc);
    ring.product<NC>(sm.y1[0], acc_out, hc == 0);
  }

  // y1 @ Wf rounded to bf16 (pair_out's first step), each thread's own
  // elements into y1's space (read back by the same thread only); the
  // residual terms load while the residual product runs.
  h.y1_free();
  for_each_pair([&](int r, int c, int i) {
    store_pair(sm.y1[0], group, r, c, rnd<bf16>(acc_out[i]), rnd<bf16>(acc_out[i + 1]));
  });
  if (RESIDUAL) {
    float res[64];
    uint32_t fiv[32], fjv[32];  // by element pair i / 2
    ring.product<C_IN>(sm.x[0], res, true, [&] {
      for_each_pair([&](int r, int c, int i) {
        fiv[i / 2] = ld_pair(fi + (size_t)max(pt.row[r], 0) * C_OUT + c);
        fjv[i / 2] = ld_pair(fj + (size_t)pt.col[r] * C_OUT + c);
      });
    });
    h.x_done();
    // The pre-norm output (common.cuh's pair_out_v) over y1 @ Wf's elements.
    for_each_pair([&](int r, int c, int i) {
      const int k2 = i / 2;
      const uint32_t ov = load_pair(sm.y1[0], group, r, c), bb = bias_pair(sm, kBf + c);
      store_pair(sm.y1[0], group, r, c,
                 pair_out_v<bf16, true>(lo(ov), res[i], lo(fiv[k2]), lo(fjv[k2]), lo(bb)),
                 pair_out_v<bf16, true>(hi(ov), res[i + 1], hi(fiv[k2]), hi(fjv[k2]), hi(bb)));
    });
  } else {
    for_each_pair([&](int r, int c, int i) {
      const uint32_t ov = load_pair(sm.y1[0], group, r, c), bb = bias_pair(sm, kBf + c);
      store_pair(sm.y1[0], group, r, c, pair_out_v<bf16, false>(lo(ov), 0.f, 0.f, 0.f, lo(bb)),
                 pair_out_v<bf16, false>(hi(ov), 0.f, 0.f, 0.f, hi(bb)));
    });
  }
  wg::bar_sync(1 + group, 128);  // the warpgroup's output whole
}

// The block's shared memory, 1024-byte aligned (the offset added to the
// shared array itself, so every access through it stays a shared-memory
// access).
__device__ __forceinline__ Smem& smem_of(uint8_t* raw) {
  return *reinterpret_cast<Smem*>(raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u));
}

}  // namespace wgb
}  // namespace
}  // namespace fdk
