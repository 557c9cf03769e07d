// Backward of the fused pair MLP in float32, for Hopper (sm_90a): kernel A
// (the recompute and the input-gradient chain) on wgmma and TMA, then the
// split backward's row and column sums, kernel B and ordered sums
// (pair_mlp_split.cuh), per chunk of grid rows.
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/pair_mlp.py:349
// (_pair_mlp_bwd_kernel, reached through fused_pair_mlp_bwd) in float32, as
// pair_mlp_bwd.cu does in bf16; pair_mlp_bwd.cu's header gives the outputs,
// the workspace and the whole call's bound. Kernel A, per 64-pair tile of
// the chunk's flat pairs:
//
//   recompute   y0, y1, the pre-norm output (pair_mlp_wg.cuh's forward_tile,
//               the forward kernel's own code: its output equals
//               pair_mlp_wg.cu's bit for bit, its relu decisions are the
//               forward's);
//   LayerNorm   dx and dem from the cotangent g through the edge mask and
//               the LayerNorm;
//   chain       dy1 = (dx Wf^T) . [y1 > 0], dy0 = (dy1 W1^T) . [y0 > 0],
//               d_pair = dy0 W0^T (+ dx Wfe^T);
//
// writing y0, y1, dy1, dy0, dx and dem to the workspace, d_pair, and one
// partial of d_b1 | d_bf | d_ln_scale | d_ln_bias per tile. 1,048,576 FLOP a
// pair, 137 GFLOP at B=2 N=256: as 3xTF32, 3 x 137 GFLOP / 495 TFLOP/s =
// 0.83 ms on an H100 SXM, the bound kernel A is held against (its bytes,
// 0.87 GB of workspace written and 134 MB of pair and g read, take 0.30 ms).
//
// Design.
// - The forward kernel's block (pair_mlp_wg.cuh): a persistent block on each
//   SM walking the chunk's tiles, two consumer warpgroups on wgmma
//   (m64n64k8, 3xTF32 with each 32-deep slice summed apart) and a producer
//   lane keeping a two-stage ring of weight slices full by TMA, 226 KB of
//   shared memory. A tile takes 2 x 64 slices (2 x 60 without the residual
//   terms): the forward's, then the chain's.
// - The chain has the forward's shape: X := dx, W0 := Wf^T, Y0 := dy1,
//   W1 := W1^T, Wf := W0^T, Wfe := Wfe^T, the relus replaced by the
//   recompute's decisions, no i/j terms and no LayerNorm. So it runs through
//   the same ring and products. TF32 wgmma takes B K-major ([out, in]); for
//   W^T that is W as the model stores it ([in, out]), so the chain's TF32
//   split (prepare_weights<false>) is taken from the stored weights with no
//   transpose. Both splits (4 MB) go to scratch the wrapper hands in.
// - Shared memory is the forward's: after the recompute X's 32 KB takes dx
//   (formed from the pre-norm output in Y1's space and g, read from device
//   memory), Y0's 96 KB first the LayerNorm's per-warp channel sums and then
//   dy1, the Y1 chunk each 128-column chunk of dy0.
// - Relu decisions: 6 registers a consumer thread (kMasksInRegisters): bit i
//   of a chunk's word is the thread's fragment element i, and the chain's
//   epilogues walk the recompute's fragments (dy1's chunk cb those of y1's
//   chunk cb, dy0's chunk hc those of y0's chunk hc). Otherwise each chain
//   epilogue reads its signs back from the y0 or y1 the tile wrote to the
//   workspace (chip_variants.py times both).
// - Stores: y0, each y1 chunk, dx, dy1 and each dy0 chunk leave shared
//   memory as soon as they are whole there: the producer warpgroup's three
//   idle warps copy them (16 bytes a thread, a row's bytes side by side,
//   evict-first) while the consumers run on. The consumers hand over one
//   region at a time (mbarriers sfull, sempty) and wait, ahead of the
//   barrier before a region is overwritten, until it is copied. Issued by
//   the consumer threads themselves, between the products (kStoreWarps
//   false), they cost kernel A ~0.4 ms more at B=2 N=256 on an H100
//   (PERF.md). d_pair leaves from the accumulators (32 bytes a row of four
//   lanes).
// - No atomics: the sums across tiles go through per-tile partials summed
//   in order, so two launches give the same bits.
#include "pair_mlp_wg.cuh"
#include "pair_mlp_split.cuh"

namespace fdk {
namespace {

// The relu decisions in registers (false: read back from the workspace).
constexpr bool kMasksInRegisters = true;
// The workspace rows copied out of shared memory by the producer
// warpgroup's three idle warps while the consumers run on (false: by every
// consumer thread, between the products).
constexpr bool kStoreWarps = true;

struct BwdArgs {
  const float *g, *i_term, *j_term, *fi, *fj, *row_mask, *col_mask, *b0, *b1, *bf, *ln_scale,
      *ln_bias;
  float *d_pair, *fwd_out;
  SplitWs<float> ws;
  long long q0, P, tiles;
  int Nr, Nc;
};

// Bits i and i + 1: the relu decisions of elements i, i + 1.
__device__ __forceinline__ uint32_t relu_bits(int i, float v0, float v1) {
  return (v0 > 0.f ? 1u << i : 0u) | (v1 > 0.f ? 2u << i : 0u);
}

// Chunk c's word of three, by selects (c is not known at compile time).
__device__ __forceinline__ uint32_t pick(const uint32_t (&m)[HID / NC], int c) {
  return c == 0 ? m[0] : c == 1 ? m[1] : m[2];
}
__device__ __forceinline__ void put(uint32_t (&m)[HID / NC], int c, uint32_t bits) {
  m[0] |= c == 0 ? bits : 0u;
  m[1] |= c == 1 ? bits : 0u;
  m[2] |= c == 2 ? bits : 0u;
}

// This thread's relu decisions of 128-column chunk ch of a [pairs, HID]
// activation the tile wrote to the workspace (its rows from `rows`), in
// for_each_pair's order. Plain loads: the block wrote them.
__device__ __forceinline__ uint32_t reload_bits(const float* rows, int group, int ch) {
  uint32_t m = 0;
  for_each_pair(group, [&](int r, int c, int i) {
    const float2 v = *reinterpret_cast<const float2*>(rows + (size_t)r * HID + ch * NC + c);
    m |= relu_bits(i, v.x, v.y);
  });
  return m;
}

// Column block blk (32 columns, 64 rows) of a swizzled tile S to dst + r *
// ld + 32 blk for the rows r of the chunk: 16 bytes a consumer thread, a
// row's 128 bytes side by side, evict-first (the workspace is read back by
// the next kernels, not by this tile).
__device__ __forceinline__ void store_block(const float* S, int blk, const PairTile& pt, float* dst,
                                            int ld) {
  for (int idx = threadIdx.x; idx < kRows * 8; idx += kConsumers) {
    const int r = idx >> 3, q = idx & 7;
    if (pt.row[r] < 0) continue;
    const float4 v =
        *reinterpret_cast<const float4*>(S + blk * (kRows * 32) + r * 32 + ((q ^ (r & 7)) << 2));
    __stcs(reinterpret_cast<float4*>(dst + (size_t)r * ld + blk * 32 + q * 4), v);
  }
}

// The swizzled tile S (`cols` columns) to columns c0 .. of the tile's rows
// (from lp0) of a workspace array (dst, row stride ld), once S is whole
// (every consumer past the barrier after its writes): handed to the store
// warps as the next region (thread 0, once they have copied the last one;
// ev counts the regions), or stored by every consumer thread.
__device__ __forceinline__ void store_ws(WgSmem& sm, uint32_t& ev, float* dst, int ld,
                                         const float* S, int cols, int c0, long long lp0,
                                         const PairTile& pt) {
  if (kStoreWarps) {
    if (threadIdx.x == 0) {
      if (ev) wg::mbar_wait(&sm.sempty, (ev - 1) & 1);
      wg::mbar_arrive(&sm.sfull);
    }
    ++ev;
  } else {
    for (int blk = 0; blk < cols / 32; ++blk)
      store_block(S, blk, pt, dst + lp0 * ld + c0, ld);
  }
}

// The regions handed over so far have been copied: their shared memory may
// be overwritten (thread 0, just ahead of the barrier after which it is).
__device__ __forceinline__ void stores_read(WgSmem& sm, uint32_t ev) {
  if (kStoreWarps && threadIdx.x == 0 && ev) wg::mbar_wait(&sm.sempty, (ev - 1) & 1);
}

// A tile's regions in the order the consumers hand them to the store warps
// (store_ws): y0, y1's three chunks, dx, dy1, dy0's three chunks. Region i:
// its shared-memory tile S of `cols` columns, to columns c0 .. of the
// workspace array dst (row stride ld).
constexpr int kRegions = 9;
__device__ __forceinline__ void region(int i, WgSmem& sm, const SplitWs<float>& ws,
                                       const float*& S, int& cols, float*& dst, int& ld,
                                       int& c0) {
  ld = HID, c0 = 0;
  if (i == 0) {
    S = sm.y0, cols = HID, dst = ws.y0;
  } else if (i < 4) {
    S = sm.y1, cols = NC, dst = ws.y1, c0 = (i - 1) * NC;
  } else if (i == 4) {
    S = sm.x, cols = C_OUT, dst = ws.dx, ld = C_OUT;
  } else if (i == 5) {
    S = sm.y0, cols = HID, dst = ws.dy1;
  } else {
    S = sm.y1, cols = NC, dst = ws.dy0, c0 = (i - 6) * NC;
  }
}

// The store warps (the producer warpgroup's warps 1-3, `lane` 0 .. 95 of
// them): each region of each of the block's tiles, once the consumers hand
// it over (sfull), to the workspace rows of the chunk, 16 bytes a thread, a
// row's bytes side by side, evict-first; then sempty.
__device__ __forceinline__ void copy_regions(WgSmem& sm, const SplitWs<float>& ws, long long P,
                                             long long tiles, int lane) {
  uint32_t e = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long lp0 = t * kRows;
    const int rows = (int)min((long long)kRows, P - lp0);
    for (int i = 0; i < kRegions; ++i, ++e) {
      const float* S;
      float* dst;
      int cols, ld, c0;
      region(i, sm, ws, S, cols, dst, ld, c0);
      wg::mbar_wait(&sm.sfull, e & 1);
      const int per_row = cols / 4;
      for (int idx = lane; idx < rows * per_row; idx += 96) {
        const int r = idx / per_row, c = (idx - r * per_row) * 4;
        __stcs(reinterpret_cast<float4*>(dst + (size_t)(lp0 + r) * ld + c0 + c),
               *reinterpret_cast<const float4*>(S + wg::swz<kRows>(r, c)));
      }
      __syncwarp();
      if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&sm.sempty);
    }
  }
}

// The recompute's hooks into forward_tile: y0 and y1 to the workspace, and
// their relu decisions; X stays with the tile (it takes dx).
struct BwdHooks {
  WgSmem& sm;
  const PairTile& pt;
  const SplitWs<float>& ws;
  long long lp0;  // the tile's first row of the chunk
  uint32_t& ev;   // regions handed to the store warps
  uint32_t m0[HID / NC] = {0u, 0u, 0u}, m1[HID / NC] = {0u, 0u, 0u};

  __device__ __forceinline__ void x_done() {}
  __device__ __forceinline__ void y0(int cb, int i, float v0, float v1) {
    if (kMasksInRegisters) put(m0, cb, relu_bits(i, v0, v1));
  }
  __device__ __forceinline__ void y0_whole() {
    store_ws(sm, ev, ws.y0, HID, sm.y0, HID, 0, lp0, pt);
  }
  __device__ __forceinline__ void y1(int hc, int i, float v0, float v1) {
    if (kMasksInRegisters) put(m1, hc, relu_bits(i, v0, v1));
  }
  __device__ __forceinline__ void y1_whole(int hc) {
    store_ws(sm, ev, ws.y1, HID, sm.y1, NC, hc * NC, lp0, pt);
  }
  __device__ __forceinline__ void y1_free() { stores_read(sm, ev); }  // the last y1 chunk's
};

// The mask and LayerNorm backward of a tile, each warp on its 8 rows: from
// the pre-norm output (sm.y1) and the cotangent g (the tile's rows from g),
// dx into X (swizzled; 0 on rows past the chunk), dem to the workspace
// (the tile's from dem), and the warp's channel sums of g em xhat
// (d_ln_scale), g em (d_ln_bias) and dx (d_bf) into red[warp][3][C_OUT].
__device__ __forceinline__ void layer_norm_backward(WgSmem& sm, const PairTile& pt,
                                                    const float* __restrict__ g,
                                                    const float* __restrict__ ln_scale,
                                                    const float* __restrict__ ln_bias,
                                                    float* dem_out, float* red) {
  constexpr int R = kRows / (kConsumers / 32);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Every row's cotangent first: one wait on device memory, not eight.
  float gv[R][C_OUT / 32];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int r = warp * R + rr;
#pragma unroll
    for (int q = 0; q < C_OUT / 32; ++q)
      gv[rr][q] = pt.row[r] < 0 ? 0.f : __ldg(g + (size_t)r * C_OUT + lane + 32 * q);
  }
  float sc[C_OUT / 32], lb[C_OUT / 32];
#pragma unroll
  for (int q = 0; q < C_OUT / 32; ++q) {
    sc[q] = __ldg(ln_scale + lane + 32 * q);
    lb[q] = __ldg(ln_bias + lane + 32 * q);
  }
  float sl[C_OUT / 32] = {}, sb[C_OUT / 32] = {}, sf[C_OUT / 32] = {};
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int r = warp * R + rr;
    if (pt.row[r] < 0) {  // warp-uniform: a pair past the chunk contributes 0
#pragma unroll
      for (int q = 0; q < C_OUT / 32; ++q) sm.x[wg::swz<kRows>(r, lane + 32 * q)] = 0.f;
      continue;
    }
    float xc[C_OUT / 32], s = 0.f;
#pragma unroll
    for (int q = 0; q < C_OUT / 32; ++q) {
      xc[q] = sm.y1[wg::swz<kRows>(r, lane + 32 * q)];
      s += xc[q];
    }
    const float mean = warp_sum(s) / C_OUT;
    float var = 0.f;
#pragma unroll
    for (int q = 0; q < C_OUT / 32; ++q) {
      xc[q] -= mean;
      var += xc[q] * xc[q];
    }
    const float inv = 1.f / sqrtf(warp_sum(var) / C_OUT + 1e-6f);
    const float em = pt.mask[r];
    float xh[C_OUT / 32], dxh[C_OUT / 32], dem = 0.f, m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int q = 0; q < C_OUT / 32; ++q) {
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
    for (int q = 0; q < C_OUT / 32; ++q) {
      const float dx = (dxh[q] - m1 - xh[q] * m2) * inv;
      sf[q] += dx;
      sm.x[wg::swz<kRows>(r, lane + 32 * q)] = dx;
    }
    if (lane == 0) dem_out[r] = dem;
  }
#pragma unroll
  for (int q = 0; q < C_OUT / 32; ++q) {
    red[(warp * 3 + 0) * C_OUT + lane + 32 * q] = sl[q];
    red[(warp * 3 + 1) * C_OUT + lane + 32 * q] = sb[q];
    red[(warp * 3 + 2) * C_OUT + lane + 32 * q] = sf[q];
  }
}

template <bool RESIDUAL>
__device__ __forceinline__ void consume(WgSmem& sm, const BwdArgs& a) {
  const int wg_id = threadIdx.x >> 7, tid = threadIdx.x;
  Consumer ring{sm, wg_id, 0};
  // X's last reader this tile is done: the producer may load the next
  // tile's pair rows over dx (written here, hence the proxy fence).
  auto release_x = [&] {
    wg::fence_proxy_async();
    __syncwarp();
    if ((tid & 31) == 0) wg::mbar_arrive(&sm.xempty);
  };
  uint32_t k = 0, ev = 0;
  for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x, ++k) {
    const long long lp0 = t * kRows, p0 = a.q0 + lp0;
    PairTile& pt = sm.pt;
    load_pair_tile<float>(pt, p0, a.q0 + a.P, a.Nr, a.Nc, a.row_mask, a.col_mask);
    wg::bar_sync(1, kConsumers);  // the tile's bookkeeping
    wg::mbar_wait(&sm.xfull, k & 1);

    // ---- the forward's recompute; y0 and y1 to the workspace ------------
    BwdHooks h{sm, pt, a.ws, lp0, ev};
    forward_tile<RESIDUAL>(sm, ring, pt, a.i_term, a.j_term, a.fi, a.fj, a.b0, a.b1, a.bf, h);
    if (a.fwd_out) layer_norm_rows(sm.y1, pt, p0, a.ln_scale, a.ln_bias, a.fwd_out);

    // ---- mask and LayerNorm backward: dx into X --------------------------
    float* vp = a.ws.vpart + t * kVec;
    float* const red = sm.y0;  // the recompute is done with y0
    layer_norm_backward(sm, pt, a.g + p0 * C_OUT, a.ln_scale, a.ln_bias, a.ws.dem + lp0, red);
    wg::bar_sync(1, kConsumers);  // dx and the channel sums whole
    store_ws(sm, ev, a.ws.dx, C_OUT, sm.x, C_OUT, 0, lp0, pt);
    if (tid < C_OUT) {  // the tile's d_bf, d_ln_scale, d_ln_bias, over the warps in order
      const int from[3] = {2, 0, 1};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float s = 0.f;
        for (int w = 0; w < kConsumers / 32; ++w) s += red[(w * 3 + from[j]) * C_OUT + tid];
        vp[HID + j * C_OUT + tid] = s;
      }
    }
    wg::bar_sync(1, kConsumers);  // the channel sums read: Y0 takes dy1

    // ---- the chain, on the forward's products over the stored weights ----
    // dy1 = (dx @ Wf^T) . [y1 > 0] by 128-column chunk, into Y0.
    const float* const y0_ws = a.ws.y0 + lp0 * HID;
    const float* const y1_ws = a.ws.y1 + lp0 * HID;
    for (int cb = 0; cb < HID / NC; ++cb) {
      float acc[32] = {};
      uint32_t m = kMasksInRegisters ? pick(h.m1, cb) : 0u;
      ring.product<C_OUT>(sm.x, acc, [&](int ks) {
        if (!kMasksInRegisters && ks == C_OUT / 32 - 1) m = reload_bits(y1_ws, wg_id, cb);
      });
      for_each_pair(wg_id, [&](int r, int c, int i) {
        *reinterpret_cast<float2*>(sm.y0 + wg::swz<kRows>(r, cb * NC + c)) =
            make_float2((m >> i) & 1u ? acc[i] : 0.f, (m >> (i + 1)) & 1u ? acc[i + 1] : 0.f);
      });
    }
    if (!RESIDUAL) {
      stores_read(sm, ev);  // dx's (with the residual terms, dy1's hand-over waits for it)
      release_x();
    }
    wg::bar_sync(1, kConsumers);  // dy1 whole
    store_ws(sm, ev, a.ws.dy1, HID, sm.y0, HID, 0, lp0, pt);
    // The tile's d_b1: dy1's column sums over the rows in order.
    for (int c = tid; c < HID; c += kConsumers) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += sm.y0[wg::swz<kRows>(r, c)];
      vp[c] = s;
    }

    // dy0_c = (dy1 @ W1^T[:, c]) . [y0_c > 0] into Y1's space; acc_dp +=
    // dy0_c @ W0^T[c, :].
    float acc_dp[32] = {};
    for (int hc = 0; hc < HID / NC; ++hc) {
      float acc1[32] = {};
      uint32_t m = kMasksInRegisters ? pick(h.m0, hc) : 0u;
      ring.product<HID>(sm.y0, acc1, [&](int ks) {
        if (!kMasksInRegisters && ks == HID / 32 - 1) m = reload_bits(y0_ws, wg_id, hc);
      });
      stores_read(sm, ev);  // the last dy0 chunk's
      wg::bar_sync(1, kConsumers);  // every warp has read the last chunk of dy0
      for_each_pair(wg_id, [&](int r, int c, int i) {
        *reinterpret_cast<float2*>(sm.y1 + wg::swz<kRows>(r, c)) =
            make_float2((m >> i) & 1u ? acc1[i] : 0.f, (m >> (i + 1)) & 1u ? acc1[i + 1] : 0.f);
      });
      wg::bar_sync(1, kConsumers);  // this chunk of dy0 whole
      store_ws(sm, ev, a.ws.dy0, HID, sm.y1, NC, hc * NC, lp0, pt);
      ring.product<NC>(sm.y1, acc_dp);
    }

    // d_pair = dy0 @ W0^T (+ dx @ Wfe^T): float32 adds the two sums.
    float res[32] = {};
    if (RESIDUAL) {
      ring.product<C_OUT>(sm.x, res);
      release_x();
    }
    for_each_pair(wg_id, [&](int r, int c, int i) {
      if (pt.row[r] < 0) return;
      const float2 v = RESIDUAL ? make_float2(acc_dp[i] + res[i], acc_dp[i + 1] + res[i + 1])
                                : make_float2(acc_dp[i], acc_dp[i + 1]);
      *reinterpret_cast<float2*>(a.d_pair + (size_t)(p0 + r) * C_IN + c) = v;
    });
    wg::bar_sync(1, kConsumers);  // the tile's bookkeeping read
  }
}

template <bool RESIDUAL>
__global__ void __launch_bounds__(kBlockWG, 1)
bwd_tile_kernel(const __grid_constant__ Maps<2> maps, const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  WgSmem& sm = wg_smem(smem_raw);
  if (threadIdx.x == 0) init_barriers(sm);
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    // The producer warpgroup: one lane keeps the ring full, as in the
    // forward (the forward's slices of a tile, then the chain's); its other
    // three warps copy the workspace regions.
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) produce<RESIDUAL>(sm, maps, a.tiles);
    if (kStoreWarps && threadIdx.x >= kConsumers + 32)
      copy_regions(sm, a.ws, a.P, a.tiles, threadIdx.x - (kConsumers + 32));
  } else {
    wg::setmaxnreg_inc<232>();
    consume<RESIDUAL>(sm, a);
  }
}

// One chunk, rows m0 .. m1 - 1 of the flat [B * Nr] grid.
template <bool RESIDUAL>
cudaError_t launch(const float* g, const float* pair, const float* i_term, const float* j_term,
                   const float* fi, const float* fj, const float* row_mask, const float* col_mask,
                   const float* w0, const float* b0, const float* w1, const float* b1,
                   const float* wf, const float* bf, const float* wfe, const float* ln_scale,
                   const float* ln_bias, float* d_pair, float* wsp, long long ws_floats,
                   float* split, float* wred, float* rowred, float* colred, int B, int Nr, int Nc,
                   int m0, int m1, float* fwd_out, cudaStream_t stream) {
  if (m0 < 0 || m1 <= m0 || m1 > B * Nr || Nc <= 0) return cudaErrorInvalidValue;
  const long long q0 = (long long)m0 * Nc, P = (long long)(m1 - m0) * Nc;
  if (split_ws_floats<float>(P) > ws_floats) return cudaErrorInvalidValue;
  const SplitWs<float> ws = split_ws<float>(wsp, P);
  const long long tiles = split_tiles(P), groups = split_groups(P);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_tile_kernel<RESIDUAL>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kSmemBytes)) != cudaSuccess)
    return err;

  // The two weight splits: the forward's, then the chain's (Wf, W1, W0, Wfe
  // as stored are K-major for their transposes).
  const float* wfe_r = RESIDUAL ? wfe : nullptr;
  prepare_weights<true><<<256, 256, 0, stream>>>(w0, w1, wf, wfe_r, split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  prepare_weights<false><<<256, 256, 0, stream>>>(wf, w1, w0, wfe_r, split + kSplitFloats);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  Maps<2> maps;
  if (!weight_maps(&maps.w[0], split) || !weight_maps(&maps.w[1], split + kSplitFloats) ||
      !wg::f32_sw128_map(&maps.pair, pair + q0 * C_IN, P, C_IN, kRows))
    return cudaErrorInvalidValue;

  // Kernel A; the tile partials past the last tile are zero.
  if ((err = cudaMemsetAsync(ws.vpart + tiles * kVec, 0,
                             sizeof(float) * (groups * kGroup - tiles) * kVec, stream)) !=
      cudaSuccess)
    return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const BwdArgs a{g, i_term, j_term, fi, fj, row_mask, col_mask, b0, b1, bf, ln_scale, ln_bias,
                  d_pair, fwd_out, ws, q0, P, tiles, Nr, Nc};
  bwd_tile_kernel<RESIDUAL><<<(int)(tiles < sms ? tiles : sms), kBlockWG, kSmemBytes, stream>>>(
      maps, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  return finish_split<float, RESIDUAL>(pair, row_mask, col_mask, ws, wred, rowred, colred, Nr, Nc,
                                       m0, m1, stream);
}

}  // namespace
}  // namespace fdk

// C interface, for one chunk: rows m0 .. m1 - 1 of the flat [B * Nr] grid
// (pairs m0 * Nc ..), every tensor float32. residual: 1 for the edge
// transition (fi, fj, wfe given), 0 for the plain MLP. Weights are
// row-major [in, out], 16-byte aligned; pair 16-byte aligned, i_term, j_term
// and b0 8-byte aligned. ws: the chunk's workspace of ws_floats floats
// (split_ws_floats of its pairs at least); split: 1,048,576 floats of
// device scratch, 16-byte aligned, for the weights' TF32 parts (the
// forward's, then the chain's). Adds the chunk's weight, bias and LayerNorm
// gradients to wred [262912] and its column sums to colred [B, Nc, 513]
// (both zeroed before the first chunk), writes its rows of rowred [B, Nr,
// 513] and of d_pair [B, Nr, Nc, 128]. fwd_out (or null): [B, Nr, Nc, 128],
// receives the recompute's LayerNorm output of the chunk's pairs, as
// pair_mlp_wg.cu writes it. Returns a cudaError_t (0 on success).
extern "C" int fdk_pair_mlp_bwd_wg(int residual, const void* g, const void* pair,
                                   const void* i_term, const void* j_term, const void* fi,
                                   const void* fj, const void* row_mask, const void* col_mask,
                                   const void* w0, const void* b0, const void* w1, const void* b1,
                                   const void* wf, const void* bf, const void* wfe,
                                   const float* ln_scale, const float* ln_bias, void* d_pair,
                                   float* ws, long long ws_floats, void* split, float* wred,
                                   float* rowred, float* colred, int B, int Nr, int Nc, int m0,
                                   int m1, void* fwd_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDK_ARGS                                                                               \
  (const float*)g, (const float*)pair, (const float*)i_term, (const float*)j_term,             \
      (const float*)fi, (const float*)fj, (const float*)row_mask, (const float*)col_mask,      \
      (const float*)w0, (const float*)b0, (const float*)w1, (const float*)b1, (const float*)wf, \
      (const float*)bf, (const float*)wfe, ln_scale, ln_bias, (float*)d_pair, ws, ws_floats,   \
      (float*)split, wred, rowred, colred, B, Nr, Nc, m0, m1, (float*)fwd_out, s
  return residual ? fdk::launch<true>(FDK_ARGS) : fdk::launch<false>(FDK_ARGS);
#undef FDK_ARGS
}

// C interface of float32 kernel B alone (wgrad_wg.cuh), for its tests: out
// [M, Nb] = A^T Bm over P pairs, A [P, M] and Bm [P, Nb] row-major float32
// (16-byte aligned), M = 64 or a multiple of 128, Nb a multiple of 128, at
// most 16 output tiles; `slices` K slices, their partials in wpart [slices,
// M * Nb], then summed in slice order into out. Returns a cudaError_t.
extern "C" int fdk_wgrad_f32(const float* a, int M, const float* b, int Nb, long long P,
                             int slices, float* wpart, float* out, void* stream) {
  using namespace fdk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WgradJobs jobs;
  const int n = wgrad_alone_jobs(jobs, M, Nb);
  if (n == 0 || P < 1 || slices < 1 || !wgrad_map(jobs, 0, a, P, M) ||
      !wgrad_map(jobs, 1, b, P, Nb))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_wgrad_wg(jobs, n, slices, wpart, (long long)M * Nb, P, s);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(wpart, out, 1, slices, M * Nb, M * Nb, s);
}
