// Backward of the fused pair MLP in bf16, for Hopper (sm_90a): kernel A (the
// recompute and the input-gradient chain) on wgmma and TMA, then the split
// backward's row and column sums, kernel B (wgrad_bf16.cuh) and ordered sums
// (pair_mlp_split.cuh), per chunk of grid rows.
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/pair_mlp.py:349
// (_pair_mlp_bwd_kernel, reached through fused_pair_mlp_bwd) in bf16, as
// pair_mlp_bwd_wg.cu does in float32. For a [B, Nr, Nc, 128] pair tensor and
// its cotangent g it recomputes the forward per pair and back-propagates
// through the edge mask, the LayerNorm, the three products and the relus
// (relu'(0) = 0):
//
//   d_pair [B,Nr,Nc,128] (bf16), and in float32
//   d_i_term, d_fi, d_row_mask: sums over a row's pairs;
//   d_j_term, d_fj, d_col_mask: sums over a column's pairs;
//   d_w0, d_w1, d_b1, d_wf, d_bf, d_wfe, d_ln_scale, d_ln_bias: sums over
//   the whole grid.
//
// The JAX kernel's rounding points (pair_mlp.py:483-516):
// - the recompute is the bf16 forward kernel's own code (pair_mlp_wg_bf16.cuh,
//   forward_tile), so y0, y1 and the pre-norm output are pair_mlp_wg_bf16.cu's
//   bits and the relu decisions the forward's;
// - dx stays float32: d_bf, d_fi and d_fj sum it unrounded;
// - dxd = bf16(dx) is the operand of d_wf, d_wfe and the chain;
// - dy1 = bf16(dxd Wf^T) . [y1 > 0], rounded before the relu mask, and dy0 =
//   bf16(dy1 W1^T) . [y0 > 0] likewise; d_b1, d_i_term and d_j_term sum these
//   bf16 values in float32;
// - d_pair = bf16(bf16(dy0 W0^T) + bf16(dxd Wfe^T)); without the residual
//   terms bf16(dy0 W0^T);
// - every product sums its whole K in float32 (wgmma), kernel B's too.
//
// Kernel A, per 128-pair tile of the chunk's flat pairs, writes y0, y1, dy1,
// dy0, dxd ([pairs, 384] / [pairs, 128] bf16), dx (float32) and dem (the mask
// gradients' yln . g) to the workspace (pair_mlp_split.cuh's layout), d_pair,
// and one partial of d_b1 | d_bf | d_ln_scale | d_ln_bias per 64-pair split
// tile. Work: 1,048,576 FLOP a pair, 137 GFLOP at B=2 N=256, 0.139 ms at 989
// TFLOP/s on an H100 SXM; bytes: 3,844 of workspace a pair written, d_pair's
// 256, pair's and g's 512 read, 4,612 a pair, 0.605 GB, 0.1805 ms at 3.35
// TB/s. Set by bytes.
//
// Design (pair_mlp_bwd_wg.cu's plan for float32, on the bf16 forward's tile):
// - The forward kernel's block: a persistent block on each SM walking the
//   chunk's 128-pair tiles; two consumer warpgroups each own 64 pairs of a
//   tile across all 128 columns (m64n128k16, bf16), with setmaxnreg's 232
//   registers; the producer warpgroup's lane 0 keeps a three-stage ring of
//   weight slices full by TMA. Warpgroup g of tile t is 64-pair split tile
//   2 t + g: it writes that tile's vector partial (vpart), so the sums after
//   kernel A run as for 64-pair tiles.
// - The recompute: forward_tile with this kernel's hooks (BwdHooks): y0 and
//   y1 recorded as relu decisions, each whole region handed to the store
//   warps, y1's space rewritten only once they have copied it. X stays with
//   the tile: it takes dxd.
// - The chain has the forward's shape: X := dxd, W0 := Wf^T, Y0 := dy1,
//   W1 := W1^T, Wf := W0^T, Wfe := Wfe^T, the relus replaced by the recorded
//   decisions, no i/j terms, no LayerNorm. It runs through the same ring: a
//   tile's slices are the forward's 30 (32 with the residual terms), then the
//   chain's. W^T's k runs along a stored row of W, so each chain slice is
//   128 stored rows (n) by 64 columns (k), read by wgmma K-major (transpose
//   flag 0) through the forward's own tensor maps: no transposed copies.
// - Shared memory is the forward's (212 KB) and 12 KB of relu decisions:
//   after the recompute the group's rows of X take dxd, of Y0 first the
//   LayerNorm's channel sums and then dy1, of the Y1 chunk each 128-column
//   chunk of dy0.
// - Relu decisions (Masks): 2 words a 128-column chunk a consumer thread, a
//   bit for each of its accumulator elements, taken from the packed bf16
//   value with two integer operations (relu_pair); the chain's epilogues walk
//   the recompute's fragments (dy1's chunk cb those of y1's chunk cb, dy0's
//   chunk hc those of y0's chunk hc). Kept in shared memory: in registers (12
//   a thread) the consumers spilled more and ran slower; read back from the
//   workspace, slower still (PERF.md).
// - Stores: each whole region (y0, y1's three chunks, dxd, dy1, dy0's three
//   chunks) is copied out by the producer warpgroup's three idle warps
//   (mbarriers sfull, sempty a consumer warpgroup, both groups' queues polled
//   in turn; 16 bytes a thread in device memory's order, evict-first; TMA
//   bulk stores were slower, PERF.md). dx and dem are written by the
//   LayerNorm backward, d_pair from the accumulators.
// - The tensor map of pair covers the chunk's rows only: rows past the chunk
//   read as zeros and are never stored; every g load and store is guarded.
// - No atomics: the sums across tiles go through per-tile partials summed in
//   order, so two launches give the same bits.
#include "pair_mlp_wg_bf16.cuh"

namespace fdk {
namespace {
using wgb::C_IN;
using wgb::C_OUT;
using wgb::HID;
}  // namespace
}  // namespace fdk

#include "pair_mlp_split.cuh"

namespace fdk {
namespace {
namespace wgb {

static_assert(kHalf == kRows, "a warpgroup's rows are one 64-pair split tile");

constexpr int kMaskWords = 2 * (HID / NC) * 2;  // y0's and y1's chunks, 2 words each
constexpr int kRegions = 9;                     // a warpgroup's workspace regions a tile
constexpr int kStoreWarps = 3;                  // the producer warpgroup's warps 1-3

// The backward's state beside the forward's shared memory.
struct BwdSmem {
  uint64_t sfull[2], sempty[2];  // each consumer warpgroup's hand-over to the store warps
  uint32_t masks[kMaskWords][kConsumers];  // the relu decisions (Masks)
};
constexpr size_t kBwdSmemBytes = sizeof(Smem) + sizeof(BwdSmem) + 1024;
static_assert(kBwdSmemBytes <= 232448, "shared memory of one block");

struct BwdArgs {
  const bf16 *g, *i_term, *j_term, *fi, *fj, *row_mask, *col_mask, *b0, *b1, *bf;
  const float *ln_scale, *ln_bias;
  bf16 *d_pair, *fwd_out;
  SplitWs<bf16> ws;
  long long q0, P, tiles;  // the chunk's first pair, its pairs, its 128-pair tiles
  int Nr, Nc;
};

// The relu decisions of two relu outputs (>= 0) from their bf16 bits
// packed as pack packs them: bit 15 set where the first is above 0, bit 31
// where the second is (a half's magnitude plus 0x7FFF carries into its top
// bit exactly when it is not 0).
__device__ __forceinline__ uint32_t relu_pair(uint32_t w) {
  return ((w & 0x7FFF7FFFu) + 0x7FFF7FFFu) & 0x80008000u;
}

// A consumer thread's relu decisions of y0 (which 0) and y1 (which 1): 2
// words a 128-column chunk; the element pair i, i + 1 (for_each_pair's
// order, k = i / 2) sits in word k / 16, bits k % 16 and 16 + k % 16.
struct Masks {
  BwdSmem& bs;
  uint32_t cur0 = 0u, cur1 = 0u;

  // Elements i, i + 1 of chunk `chunk` (i runs 0, 2, .. 62 in order).
  __device__ __forceinline__ void record(int which, int chunk, int i, float v0, float v1) {
    const int k = i >> 1;
    const uint32_t bits = relu_pair(pack(v0, v1)) >> (15 - (k & 15));
    if (i == 0) cur0 = cur1 = 0u;
    if (k < 16)
      cur0 |= bits;
    else
      cur1 |= bits;
    if (i != 62) return;
    bs.masks[(which * (HID / NC) + chunk) * 2][threadIdx.x] = cur0;
    bs.masks[(which * (HID / NC) + chunk) * 2 + 1][threadIdx.x] = cur1;
  }

  // Chunk `chunk`'s words.
  __device__ __forceinline__ void get(int which, int chunk, uint32_t (&m)[2]) const {
#pragma unroll
    for (int w = 0; w < 2; ++w) m[w] = bs.masks[(which * (HID / NC) + chunk) * 2 + w][threadIdx.x];
  }
};

// A warpgroup's hand-over of its workspace regions to the store warps: one
// region at a time, in copy_regions' order (ev counts them).
struct Handover {
  BwdSmem& bs;
  int group;
  uint32_t ev;

  // The region just made whole (the warpgroup past the barrier after its
  // writes): the store warps may copy it, once they have copied the last one.
  __device__ __forceinline__ void hand() {
    if ((threadIdx.x & 127) == 0) {
      if (ev) wg::mbar_wait(&bs.sempty[group], (ev - 1) & 1);
      wg::mbar_arrive(&bs.sfull[group]);
    }
    ++ev;
  }
  // Every thread: the region handed last has been copied (its space may be
  // rewritten).
  __device__ __forceinline__ void copied() {
    if (ev) wg::mbar_wait(&bs.sempty[group], (ev - 1) & 1);
  }
};

// Region e of warpgroup `group`'s hand-overs (the block's tiles in turn, nine
// a tile: y0, y1's three chunks, dxd, dy1, dy0's three chunks): the group's
// rows of a tile (Y0, the Y1 chunk, X) to columns c0 .. of a workspace array,
// rows past the chunk not stored. Store warp w of kStoreWarps takes the
// region's 16-byte chunks me = 32 w + lane, me + 32 kStoreWarps, .. in device
// memory's order (evict-first).
__device__ __forceinline__ void copy_region(Smem& sm, const BwdArgs& a, int group, uint32_t e,
                                            int me) {
  const int i = (int)(e % kRegions);
  const long long t = blockIdx.x + (long long)(e / kRegions) * gridDim.x;
  const long long lp0 = t * kTile + kHalf * group;
  const int rows = (int)max(0LL, min((long long)kHalf, a.P - lp0));
  // The workspace array: 0 y0, 1 y1, 2 dy1, 3 dy0, 4 dxd.
  const int arr = i == 0 ? 0 : i < 4 ? 1 : i == 4 ? 4 : i == 5 ? 2 : 3;
  const int blocks = i == 0 || i == 5 ? HID / 64 : 2;  // 64-column blocks
  const int c0 = i > 0 && i < 4 ? (i - 1) * NC : i > 5 ? (i - 6) * NC : 0;
  const bf16* S = (arr == 4 ? sm.x[0] : arr == 0 || arr == 2 ? sm.y0[0] : sm.y1[0]) +
                  kHalf * group * 64;
  // A row's 16-byte chunks lie side by side in device memory.
  const int ld = arr == 4 ? C_OUT : HID, per_row = 8 * blocks, n = rows * per_row;
  bf16* dst = (arr == 0 ? a.ws.y0 : arr == 1 ? a.ws.y1 : arr == 2 ? a.ws.dy1
               : arr == 3 ? a.ws.dy0 : a.ws.dxd) + lp0 * ld + c0;
#pragma unroll 2
  for (int idx = me; idx < n; idx += 32 * kStoreWarps) {
    const int r = idx / per_row, c = 8 * (idx - r * per_row);
    __stcs(reinterpret_cast<uint4*>(dst + (size_t)r * ld + c),
           *reinterpret_cast<const uint4*>(S + swz(r, c)));
  }
}

// Store warp w (0 .. kStoreWarps - 1): each region of each consumer
// warpgroup, as its warpgroup hands it over (sfull; the two groups' queues
// polled in turn, so one group's wait never holds the other's regions), its
// part of the copy; then sempty, which completes once every store warp has
// arrived.
__device__ __forceinline__ void copy_regions(Smem& sm, BwdSmem& bs, const BwdArgs& a, int w) {
  const int lane = threadIdx.x & 31;
  const long long tiles =
      blockIdx.x < a.tiles ? (a.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const uint32_t total = (uint32_t)tiles * kRegions;
  uint32_t e[2] = {0u, 0u};
  uint64_t t0 = 0;
  for (uint32_t polls = 1; e[0] < total || e[1] < total; ++polls) {
    bool copied = false;
#pragma unroll
    for (int group = 0; group < 2; ++group) {
      if (e[group] >= total || !wg::mbar_test(&bs.sfull[group], e[group] & 1)) continue;
      copy_region(sm, a, group, e[group], 32 * w + lane);
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(&bs.sempty[group]);
      ++e[group];
      copied = true;
    }
    if (!copied) __nanosleep(64);  // leave the issue slots to the consumers
    if (!copied && polls % 1024 == 0) {  // mbar_wait's 2 s limit
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 2000000000ull) __trap();
    } else if (copied) {
      t0 = 0;
    }
  }
}

// The recompute's hooks into forward_tile: y0 and y1 handed to the store
// warps, their relu decisions recorded; X stays with the tile (it takes dxd).
struct BwdHooks {
  Handover& ho;
  Masks& m;
  int frees = 0;

  __device__ __forceinline__ void x_done() {}
  __device__ __forceinline__ void y0(int cb, int i, float v0, float v1) {
    m.record(0, cb, i, v0, v1);
  }
  __device__ __forceinline__ void y0_whole() { ho.hand(); }
  __device__ __forceinline__ void y1(int hc, int i, float v0, float v1) {
    m.record(1, hc, i, v0, v1);
  }
  __device__ __forceinline__ void y1_whole(int) { ho.hand(); }
  // Before each y1 chunk and the output: the last y1 chunk copied. The first
  // chunk's space was copied before y0 was handed over.
  __device__ __forceinline__ void y1_free() {
    if (frees++ > 0) ho.copied();
  }
};

// The LayerNorm backward's channel sums of run w (rows 8 w .. 8 w + 7 of the
// warpgroup's, as the 64-pair tile's warp w summed them): [3][C_OUT] floats
// in the group's rows of Y0, which the store warp has copied.
__device__ __forceinline__ float* red_run(Smem& sm, int group, int w) {
  return reinterpret_cast<float*>(sm.y0[w / 4] + kHalf * group * 64) + (w % 4) * 3 * C_OUT;
}

// The mask and LayerNorm backward of a warpgroup's 64 rows, each warp on 16
// in two runs of 8: from the pre-norm output (the group's rows of sm.y1) and
// the cotangent g (the rows' own, from g), dx to the workspace (float32,
// evict-first; its rows from dx_out), dem (from dem_out), dxd = bf16(dx) into
// the group's rows of X (0 past the chunk), and each run's channel sums of g
// em xhat (d_ln_scale), g em (d_ln_bias) and dx (d_bf) to red_run. A row's
// arithmetic is common.cuh's, in the 64-pair kernel's order; a pair past
// the chunk (g 0, mask 0) adds nothing and stores nothing.
__device__ __forceinline__ void layer_norm_backward(Smem& sm, int group, const PairTile& pt,
                                                    const bf16* __restrict__ g,
                                                    const float* __restrict__ ln_scale,
                                                    const float* __restrict__ ln_bias,
                                                    float* __restrict__ dx_out,
                                                    float* __restrict__ dem_out) {
  const int wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  constexpr int Q = C_OUT / 32;
  float sc[Q], lb[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    sc[q] = __ldg(ln_scale + lane + 32 * q);
    lb[q] = __ldg(ln_bias + lane + 32 * q);
  }
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const int r0 = 16 * wq + 8 * h;
    // The run's cotangent first: one wait on device memory, not eight.
    float gv[8][Q];
#pragma unroll
    for (int rr = 0; rr < 8; ++rr)
#pragma unroll
      for (int q = 0; q < Q; ++q)
        gv[rr][q] = pt.row[r0 + rr] < 0
                        ? 0.f
                        : __bfloat162float(__ldg(g + (size_t)(r0 + rr) * C_OUT + lane + 32 * q));
    float sl[Q] = {}, sb[Q] = {}, sf[Q] = {};
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int r = r0 + rr, tr = kHalf * group + r;
      const bool inside = pt.row[r] >= 0;  // warp-uniform
      float xc[Q], s = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        xc[q] = __bfloat162float(sm.y1[0][swz(tr, lane + 32 * q)]);
        s += xc[q];
      }
      const float mean = warp_sum(s) / C_OUT;
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        xc[q] -= mean;
        var += xc[q] * xc[q];
      }
      const float inv = 1.f / sqrtf(warp_sum(var) / C_OUT + 1e-6f);
      const float em = pt.mask[r];
      float xh[Q], dxh[Q], dem = 0.f, m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        xh[q] = xc[q] * inv;
        dem += (xh[q] * sc[q] + lb[q]) * gv[rr][q];
        const float gm = gv[rr][q] * em;
        sl[q] += gm * xh[q];
        sb[q] += gm;
        dxh[q] = gm * sc[q];
        m1 += dxh[q];
        m2 += dxh[q] * xh[q];
      }
      dem = warp_sum(dem);
      m1 = warp_sum(m1) / C_OUT;
      m2 = warp_sum(m2) / C_OUT;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float dx = (dxh[q] - m1 - xh[q] * m2) * inv;
        if (inside) {
          sf[q] += dx;
          __stcs(dx_out + (size_t)r * C_OUT + lane + 32 * q, dx);
        }
        sm.x[0][swz(tr, lane + 32 * q)] = __float2bfloat16_rn(inside ? dx : 0.f);
      }
      if (inside && lane == 0) dem_out[r] = dem;
    }
    float* red = red_run(sm, group, 2 * wq + h);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      red[0 * C_OUT + lane + 32 * q] = sl[q];
      red[1 * C_OUT + lane + 32 * q] = sb[q];
      red[2 * C_OUT + lane + 32 * q] = sf[q];
    }
  }
}

template <bool RESIDUAL>
__device__ __forceinline__ void consume(Smem& sm, BwdSmem& bs, const BwdArgs& a) {
  const int group = threadIdx.x >> 7, tid = threadIdx.x & 127;
  Ring ring{sm, group, 0};
  Handover ho{bs, group, 0};
  PairTile& pt = sm.pt[group];
  load_biases(sm, a.b0, a.b1, a.bf);
  wg::bar_sync(3, kConsumers);  // the biases
  // X's last reader this tile is done: the producer may load the next
  // tile's pair rows over dxd (written here, hence the proxy fence).
  auto release_x = [&] {
    wg::fence_proxy_async();
    __syncwarp();
    if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&sm.xempty);
  };
  uint32_t k = 0;
  for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x, ++k) {
    const long long lp0 = t * kTile + kHalf * group, p0 = a.q0 + lp0;
    load_pair_tile<bf16>(pt, p0, a.q0 + a.P, a.Nr, a.Nc, a.row_mask, a.col_mask, tid);
    wg::bar_sync(1 + group, 128);  // the warpgroup's bookkeeping
    wg::mbar_wait(&sm.xfull, k & 1);

    // ---- the forward's recompute; y0 and y1 to the workspace ------------
    Masks m{bs};
    BwdHooks h{ho, m};
    forward_tile<RESIDUAL>(sm, ring, pt, a.i_term, a.j_term, a.fi, a.fj, h);
    if (a.fwd_out) layer_norm_rows(sm.y1[0], group, pt, p0, a.ln_scale, a.ln_bias, a.fwd_out);

    // ---- mask and LayerNorm backward: dxd into X -------------------------
    layer_norm_backward(sm, group, pt, a.g + p0 * C_OUT, a.ln_scale, a.ln_bias,
                        a.ws.dx + lp0 * C_OUT, a.ws.dem + lp0);
    tile_written(group);  // dxd and the channel sums whole
    ho.hand();            // dxd
    float* vp = a.ws.vpart + (2 * t + group) * kVec;
    const bool inside = lp0 < a.P;  // a split tile of the chunk (else its partial stays 0)
    if (inside) {  // the split tile's d_bf, d_ln_scale, d_ln_bias, over the runs in order
      const int from[3] = {2, 0, 1};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float s = 0.f;
        for (int w = 0; w < 8; ++w) s += red_run(sm, group, w)[from[j] * C_OUT + tid];
        vp[HID + j * C_OUT + tid] = s;
      }
    }
    wg::bar_sync(1 + group, 128);  // the channel sums read: Y0 takes dy1

    // ---- the chain, on the forward's products over the stored weights ----
    // dy1 = bf16(dxd @ Wf^T) . [y1 > 0] by 128-column chunk, into Y0.
#pragma unroll 1
    for (int cb = 0; cb < HID / NC; ++cb) {
      float acc[64];
      ring.product<C_OUT, true>(sm.x[0], acc, true);
      uint32_t mw[2];
      m.get(1, cb, mw);
      for_each_pair([&](int r, int c, int i) {
        const uint32_t w = mw[i >> 5] >> ((i >> 1) & 15);
        store_pair(sm.y0[0], group, r, cb * NC + c, w & 1u ? rnd<bf16>(acc[i]) : 0.f,
                   w & 0x10000u ? rnd<bf16>(acc[i + 1]) : 0.f);
      });
    }
    tile_written(group);  // dy1 whole
    ho.hand();            // dy1 (dxd copied first)
    if (!RESIDUAL) release_x();
    // The split tile's d_b1: dy1's column sums over the rows in order, four
    // columns a thread (8-byte loads), eight rows' loads ahead of their adds.
    if (inside && tid < HID / 4) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
      for (int r0 = 0; r0 < kHalf; r0 += 8) {
        uint2 v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          v[r] = *reinterpret_cast<const uint2*>(sm.y0[0] + swz(kHalf * group + r0 + r, 4 * tid));
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          s[0] += lo(v[r].x);
          s[1] += hi(v[r].x);
          s[2] += lo(v[r].y);
          s[3] += hi(v[r].y);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) vp[4 * tid + j] = s[j];
    }

    // dy0_c = bf16(dy1 @ W1^T[:, c]) . [y0_c > 0] into Y1's space; acc_dp +=
    // dy0_c @ W0^T[c, :].
    float acc_dp[64];
#pragma unroll 1
    for (int hc = 0; hc < HID / NC; ++hc) {
      float acc1[64];
      ring.product<HID, true>(sm.y0[0], acc1, true);
      if (hc > 0) ho.copied();  // the last dy0 chunk (before it, y1's were copied)
      uint32_t mw[2];
      m.get(0, hc, mw);
      for_each_pair([&](int r, int c, int i) {
        const uint32_t w = mw[i >> 5] >> ((i >> 1) & 15);
        store_pair(sm.y1[0], group, r, c, w & 1u ? rnd<bf16>(acc1[i]) : 0.f,
                   w & 0x10000u ? rnd<bf16>(acc1[i + 1]) : 0.f);
      });
      tile_written(group);  // this chunk of dy0 whole
      ho.hand();
      ring.product<NC, true>(sm.y1[0], acc_dp, hc == 0);
    }

    // d_pair = bf16(bf16(dy0 @ W0^T) + bf16(dxd @ Wfe^T)), from the
    // accumulators.
    float res[64];
    if (RESIDUAL) {
      ring.product<C_IN, true>(sm.x[0], res, true);
      release_x();
    }
    // A thread's elements lie in two rows (for_each_pair's r0, r0 + 8).
    const int r0 = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
    const bool in0 = pt.row[r0] >= 0, in8 = pt.row[r0 + 8] >= 0;
    bf16* const dp0 = a.d_pair + (size_t)(p0 + r0) * C_IN;
    for_each_pair([&](int r, int c, int i) {
      if (!(r == r0 ? in0 : in8)) return;
      float v0 = rnd<bf16>(acc_dp[i]), v1 = rnd<bf16>(acc_dp[i + 1]);
      if (RESIDUAL) {
        v0 = rnd<bf16>(v0 + rnd<bf16>(res[i]));
        v1 = rnd<bf16>(v1 + rnd<bf16>(res[i + 1]));
      }
      *reinterpret_cast<uint32_t*>(dp0 + (size_t)(r - r0) * C_IN + c) = pack(v0, v1);
    });
    wg::bar_sync(1 + group, 128);  // the tile's bookkeeping read
  }
}

template <bool RESIDUAL>
__global__ void __launch_bounds__(kBlockThreads, 1)
bf16_bwd_tile_kernel(const __grid_constant__ Maps maps, const __grid_constant__ BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = smem_of(smem_raw);
  BwdSmem& bs = *reinterpret_cast<BwdSmem*>(&sm + 1);
  if (threadIdx.x == 0) {
    for (int g = 0; g < 2; ++g) {
      wg::mbar_init(&bs.sfull[g], 1);
      wg::mbar_init(&bs.sempty[g], kStoreWarps);
    }
    init_barriers(sm);  // fences every barrier's initialization
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    // The producer warpgroup: lane 0 keeps the ring full (each tile's
    // forward slices, then its chain's); warps 1-3 copy the workspace
    // regions of both consumer warpgroups.
    wg::setmaxnreg_dec<40>();
    const int warp = (threadIdx.x - kConsumers) >> 5;
    if (threadIdx.x == kConsumers) produce<RESIDUAL, true>(sm, maps, a.tiles);
    if (warp > 0) copy_regions(sm, bs, a, warp - 1);
  } else {
    wg::setmaxnreg_inc<232>();
    consume<RESIDUAL>(sm, bs, a);
  }
}

// One chunk, rows m0 .. m1 - 1 of the flat [B * Nr] grid.
template <bool RESIDUAL>
cudaError_t launch(const bf16* g, const bf16* pair, const bf16* i_term, const bf16* j_term,
                   const bf16* fi, const bf16* fj, const bf16* row_mask, const bf16* col_mask,
                   const bf16* w0, const bf16* b0, const bf16* w1, const bf16* b1, const bf16* wf,
                   const bf16* bf, const bf16* wfe, const float* ln_scale, const float* ln_bias,
                   bf16* d_pair, float* wsp, long long ws_floats, float* wred, float* rowred,
                   float* colred, int B, int Nr, int Nc, int m0, int m1, bf16* fwd_out,
                   cudaStream_t stream) {
  if (m0 < 0 || m1 <= m0 || m1 > B * Nr || Nc <= 0) return cudaErrorInvalidValue;
  const long long q0 = (long long)m0 * Nc, P = (long long)(m1 - m0) * Nc;
  if (split_ws_floats<bf16>(P) > ws_floats) return cudaErrorInvalidValue;
  const SplitWs<bf16> ws = split_ws<bf16>(wsp, P);
  const long long split = split_tiles(P), groups = split_groups(P), tiles = (P + kTile - 1) / kTile;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bf16_bwd_tile_kernel<RESIDUAL>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kBwdSmemBytes)) != cudaSuccess)
    return err;

  // The weights as stored (the forward's maps serve the chain too), and the
  // chunk's pair rows: TMA fills zeros past the chunk.
  Maps maps;
  if (!wg::bf16_sw128_map(&maps.w0, w0, C_IN, HID, 64) ||
      !wg::bf16_sw128_map(&maps.w1, w1, HID, HID, 64) ||
      !wg::bf16_sw128_map(&maps.wf, wf, HID, C_OUT, 64) ||
      (RESIDUAL && !wg::bf16_sw128_map(&maps.wfe, wfe, C_IN, C_OUT, 64)) ||
      !wg::bf16_sw128_map(&maps.pair, pair + q0 * C_IN, P, C_IN, kTile))
    return cudaErrorInvalidValue;
  if (!RESIDUAL) maps.wfe = maps.wf;  // never read

  // Kernel A; the split tiles' partials past the last one are zero.
  if ((err = cudaMemsetAsync(ws.vpart + split * kVec, 0,
                             sizeof(float) * (groups * kGroup - split) * kVec, stream)) !=
      cudaSuccess)
    return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const BwdArgs a{g,       i_term,  j_term,  fi, fj, row_mask, col_mask, b0,    b1, bf,
                  ln_scale, ln_bias, d_pair, fwd_out, ws, q0,       P,        tiles, Nr, Nc};
  bf16_bwd_tile_kernel<RESIDUAL>
      <<<(int)(tiles < sms ? tiles : sms), kBlockThreads, kBwdSmemBytes, stream>>>(maps, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  return finish_split<bf16, RESIDUAL>(pair, row_mask, col_mask, ws, wred, rowred, colred, Nr, Nc,
                                      m0, m1, stream);
}

}  // namespace wgb
}  // namespace
}  // namespace fdk

// C interface, for one chunk: rows m0 .. m1 - 1 of the flat [B * Nr] grid
// (pairs m0 * Nc ..), every tensor bf16 but ln_scale and ln_bias (float32;
// the float32 backward is fdk_pair_mlp_bwd_wg's, pair_mlp_bwd_wg.cu).
// residual: 1 for the edge transition (fi, fj, wfe given), 0 for the plain
// MLP. Weights are row-major [in, out], 16-byte aligned; pair 16-byte
// aligned; i_term, j_term, fi and fj 4-byte aligned.
// ws: the chunk's workspace of ws_floats floats (split_ws_floats of its
// pairs at least). Adds the chunk's weight, bias and LayerNorm gradients to
// wred [262912] and
// its column sums to colred [B, Nc, 513] (float32, both zeroed before the
// first chunk), writes its rows of rowred [B, Nr, 513] and of d_pair [B, Nr,
// Nc, 128]. fwd_out (or null): [B, Nr, Nc, 128], receives the recompute's
// LayerNorm output of the chunk's pairs, as pair_mlp_wg_bf16.cu writes it.
// Returns a cudaError_t (0 on success).
extern "C" int fdk_pair_mlp_bwd_wg_bf16(int residual, const void* g, const void* pair,
                                        const void* i_term, const void* j_term, const void* fi,
                                        const void* fj, const void* row_mask,
                                        const void* col_mask, const void* w0, const void* b0,
                                        const void* w1, const void* b1, const void* wf,
                                        const void* bf, const void* wfe, const float* ln_scale,
                                        const float* ln_bias, void* d_pair, float* ws,
                                        long long ws_floats, float* wred, float* rowred,
                                        float* colred, int B, int Nr, int Nc, int m0, int m1,
                                        void* fwd_out, void* stream) {
  using fdk::wgb::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDK_ARGS                                                                              \
  (const bf16*)g, (const bf16*)pair, (const bf16*)i_term, (const bf16*)j_term, (const bf16*)fi, \
      (const bf16*)fj, (const bf16*)row_mask, (const bf16*)col_mask, (const bf16*)w0,           \
      (const bf16*)b0, (const bf16*)w1, (const bf16*)b1, (const bf16*)wf, (const bf16*)bf,      \
      (const bf16*)wfe, ln_scale, ln_bias, (bf16*)d_pair, ws, ws_floats, wred, rowred, colred,  \
      B, Nr, Nc, m0, m1, (bf16*)fwd_out, s
  return residual ? fdk::wgb::launch<true>(FDK_ARGS) : fdk::wgb::launch<false>(FDK_ARGS);
#undef FDK_ARGS
}

// C interface of bf16 kernel B alone (wgrad_bf16.cuh), for its tests: out
// [M, Nb] = A^T Bm over P pairs, A [P, M] and Bm [P, Nb] row-major bf16
// (16-byte aligned), M = 64 or a multiple of 128, Nb a multiple of 128, at
// most 16 output tiles; `slices` K slices, their float32 partials in wpart
// [slices, M * Nb], then summed in slice order into out (float32). Returns a
// cudaError_t.
extern "C" int fdk_wgrad_bf16(const void* a, int M, const void* b, int Nb, long long P,
                              int slices, float* wpart, float* out, void* stream) {
  using namespace fdk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WgradJobs jobs;
  const int n = wgrad_alone_jobs(jobs, M, Nb);
  if (n == 0 || P < 1 || slices < 1 ||
      !wgrad_map(jobs, 0, static_cast<const __nv_bfloat16*>(a), P, M) ||
      !wgrad_map(jobs, 1, static_cast<const __nv_bfloat16*>(b), P, Nb))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      launch_wgrad_bf16<__nv_bfloat16>(jobs, n, slices, wpart, (long long)M * Nb, P, s);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(wpart, out, 1, slices, M * Nb, M * Nb, s);
}
