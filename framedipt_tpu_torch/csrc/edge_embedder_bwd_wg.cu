// Backward of the fused embedder edge branch in float32, for Hopper
// (sm_90a): kernel A (the recompute and the input-gradient chain) on wgmma
// and TMA, then the split backward's row and column sums, kernel B and
// ordered sums (edge_embedder_split.cuh), per chunk of grid rows.
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/edge_embedder.py:366
// (_edge_embedder_bwd_kernel, reached through fused_edge_embedder_bwd) in
// float32, as edge_embedder_bwd.cu does in bf16; edge_embedder_bwd.cu's
// header gives the outputs, the workspace and the whole call's work. Kernel
// A, per unit of the chunk (one grid row i and 64 consecutive columns j):
//
//   recompute   m, y0, y1, the pre-norm output and its LayerNorm statistics
//               (edge_embedder_wg.cuh's forward_unit, the forward kernel's
//               own code: its output equals edge_embedder_wg.cu's bit for
//               bit, its relu decisions are the forward's);
//   LayerNorm   dem = sum_c yln g (the mask gradients) and dx, from the
//               cotangent g through the edge mask and the LayerNorm;
//   chain       dy1 = (dx W2^T) . [y1 > 0], dy0 = (dy1 W1^T) . [y0 > 0],
//               dm = dy0 W_rel^T;
//
// writing m, y0, y1, dx, dy1, dy0, dm and dem to the workspace in the layout
// kernel B and the sums read, and one partial a unit of d_b1 | d_b2 |
// d_ln_scale | d_ln_bias | d_w_dist. 163,840 FLOP a pair (81,920 each for
// the recompute and the chain), 21.5 GFLOP at B=2 N=256: as 3xTF32,
// 3 x 21.5 / 495 TFLOP/s = 0.130 ms on an H100 SXM; its bytes (769 floats a
// pair of workspace written, 0.40 GB, and the cotangent read, 67 MB) take
// 0.140 ms at 3.35 TB/s, the bound kernel A is held against.
//
// Design.
// - The forward kernel's block (edge_embedder_wg.cuh): a persistent block on
//   each SM walking the chunk's units two at a time (a tile), two consumer
//   warpgroups on wgmma (3xTF32, each 32-deep slice summed apart), a
//   producer lane keeping the weight ring full by TMA (two stages), two
//   helper warps for the bins and masks. A tile takes 22 slices: the forward's 10, then the chain's 12.
// - The chain has the forward's shape over the transposed weights, the relus
//   replaced by the recompute's decisions. TF32 wgmma takes B K-major ([n,
//   k]); for W^T that is W as the model stores it, so the chain's TF32 split
//   (prepare_weights<false>) is taken from the stored weights with no
//   transpose. The
//   forward's and the chain's splits (640 KB) go to scratch the wrapper
//   hands in. dm is 64 wide: m64n64k8 over W_rel^T's 64-row slices (16 KB a
//   slice), no padding.
// - Relu decisions: the recompute's epilogues record them as bit words in
//   shared memory (two words a thread for y0 and two for y1, 4 KB), which
//   the chain's epilogues read back walking the same fragments.
// - The LayerNorm backward runs on the last product's accumulators, where a
//   row's 128 values lie in one quad of lanes, as the forward's LayerNorm
//   does: dem and the row means are quad shuffles, and the cotangent is read
//   from device memory straight into that layout as soon as layer 3's
//   products have run, its latency behind the LayerNorm's statistics (a bulk
//   prefetch of the unit's rows to L2 when its H loads made kernel A 0.05 ms
//   slower on an H100). d_ln_scale and d_ln_bias: each warp's column sums
//   by shuffles, then the four warps' in order.
// - The other partials leave the consumers' path: the store warps sum d_b2
//   and d_b1 as they copy dx and dy1 (each thread a column quad of every
//   third row in order, then the three warps' sums in order), and d_w_dist
//   from dy0, each bin's rows in order (the rows sorted by bin by the
//   helper warps), the bins shared out over the store warps. By the
//   consumers, between the chain's products, they cost kernel A 0.04 ms
//   (chip_variants.py).
// - Shared memory is the forward's layout with two ring stages and 16 KB
//   more after W_dist's rows (the relu words, the warps' and the store
//   warps' column sums, the sorted rows): after the recompute each
//   warpgroup's 32 KB of activations take dx, then dy1, then dy0, each over
//   the last in place. 194 KB at 22 bins, 216 KB at 64.
// - Stores: m (formed from the unit's H and G rows as the forward's products
//   form it), y0, y1, dx, dy1 and dy0 leave shared memory through the
//   producer warpgroup's three idle warps (kStoreWarps; two of them also
//   compute the bins), 16 bytes a lane, a row's 512 bytes a warp
//   instruction, evict-first, while the consumers run on. Each region is
//   handed over (sfull) once the warpgroup's four warps have written it, and
//   the consumers wait, ahead of the epilogue that overwrites it, until it
//   is copied (sempty). dm and dem leave from the registers.
// - Ragged units: a unit's columns past the row's end (and the unit past the
//   grid when the units are odd) run with a zero cotangent, so they add
//   nothing to any partial, and are not stored.
// - No atomics: the sums across units go through per-unit partials summed in
//   order, so two launches give the same bits.
#include "edge_embedder_wg.cuh"
#include "edge_embedder_split.cuh"

namespace fdk {
namespace {

// Kernel A's weight ring has two stages at every n_bins (three, where they
// fit, read no faster on an H100: chip_variants.py).
constexpr int kStages = 2;
using Smem = EmbWgSmem<kStages>;

struct BwdArgs {
  const float *grad, *g, *pos_r, *pos_c, *i_term, *row_mask, *col_mask, *w_dist, *lower, *upper,
      *b0, *b1, *b2, *ln_scale, *ln_bias;
  float* fwd_out;
  SplitWs<float> ws;
  Grid gr;
  long long tiles;
  int n_bins;
};

// The recompute's hooks into forward_unit: the relu decisions of y0 and y1
// as bit words (bit i % 32 of word i / 32: the thread's element i), y0 and
// y1 handed to the store warps, and the thread's cotangent values (0 where
// not ok: past the row's end or the grid) loaded as soon as layer 3's
// products have run, so that their latency hides behind the LayerNorm's
// statistics.
struct BwdHooks {
  EmbWgBwdSmem& bw;
  const float* grad;
  const size_t (&pair)[2];
  const bool (&ok)[2];
  float (&gv)[64];
  uint32_t m0[2] = {0u, 0u}, m1[2] = {0u, 0u};

  __device__ __forceinline__ static uint32_t bits(int i, float v0, float v1) {
    return (v0 > 0.f ? 1u << (i & 31) : 0u) | (v1 > 0.f ? 2u << (i & 31) : 0u);
  }
  __device__ __forceinline__ void keep(int which, const uint32_t (&m)[2]) {
    bw.relu[threadIdx.x >> 7][which][0][threadIdx.x & 127] = m[0];
    bw.relu[threadIdx.x >> 7][which][1][threadIdx.x & 127] = m[1];
    if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&bw.sfull[threadIdx.x >> 7]);
  }
  __device__ __forceinline__ void y0(int i, float v0, float v1) { m0[i >> 5] |= bits(i, v0, v1); }
  __device__ __forceinline__ void y0_done() { keep(0, m0); }
  // The store warp has copied y0 (the unit's first sempty phase of four).
  __device__ __forceinline__ void y1_before() { wg::mbar_wait(&bw.sempty[threadIdx.x >> 7], 0); }
  __device__ __forceinline__ void y1(int i, float v0, float v1) { m1[i >> 5] |= bits(i, v0, v1); }
  __device__ __forceinline__ void y1_done() { keep(1, m1); }
  __device__ __forceinline__ void act_read() {
    for_each_pair([&](int c, int i, int) {
      const int e = (i >> 1) & 1;
      const float2 v = ok[e] ? __ldg(reinterpret_cast<const float2*>(grad + pair[e] * C + c))
                             : make_float2(0.f, 0.f);
      gv[i] = v.x;
      gv[i + 1] = v.y;
    });
  }
};

// A chain product's accumulators masked by the recompute's relu decisions
// (words mk), into the swizzled tile A.
__device__ __forceinline__ void masked_store(float* A, const float (&acc)[64],
                                             const uint32_t (&mk)[2]) {
  for_each_pair([&](int, int i, int o) {
    const uint32_t m = mk[i >> 5] >> (i & 31);
    *reinterpret_cast<float2*>(A + o) =
        make_float2(m & 1u ? acc[i] : 0.f, m & 2u ? acc[i + 1] : 0.f);
  });
}

// This warp's column sums of v(i) over its 16 rows, to dst[c] (lanes 0-3):
// the thread's two rows (elements i and i + 2 of a column), then the warp's
// eight row groups (lanes 4, 8 and 16 apart).
template <typename V>
__device__ __forceinline__ void warp_columns(V v, float* dst) {
  float s[32];
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    s[i / 2] = v(i) + v(i + 2);
    s[i / 2 + 1] = v(i + 1) + v(i + 3);
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int q = 0; q < 32; ++q) s[q] += __shfl_xor_sync(0xffffffffu, s[q], o);
  const int lane = threadIdx.x & 31;
  if (lane < 4)
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
      *reinterpret_cast<float2*>(dst + 8 * jj + 2 * lane) = make_float2(s[2 * jj], s[2 * jj + 1]);
}

// The store warps (the producer warpgroup's warps 1-3; thread h of 96): for
// each unit of the block's tiles, m from the unit's H
// and G rows (then hempty: the producer may bring the next unit's), then
// each region the consumers hand over (sfull), y0, y1, dx, dy1, dy0, from
// act to the workspace rows of the unit's columns, 16 bytes a thread, a
// row's 512 bytes a warp instruction, evict-first; then sempty (after dy0,
// jempty: the producer may bring the next unit's j_term rows). Warps 1 and
// 2 also compute the bins and masks (unit_bins): the first tile's first,
// each later tile's once the tile before has handed y0 over (its hempty
// phase is then complete).
__device__ __forceinline__ void store_regions(Smem& sm, EmbWgBwdSmem& bw,
                                              const BwdArgs& a, int h) {
  const Grid& gr = a.gr;
  const int lane = threadIdx.x & 31;
  const SplitWs<float>& ws = a.ws;
  auto bins = [&](int t, uint32_t k) {
    if (h >= kHelpers) return;
    for (int w = 0; w < 2; ++w) {
      unit_bins(sm, &bw, h, a.pos_r, a.pos_c, a.row_mask, a.col_mask, a.n_bins, gr, 2 * t + w, w,
                k);
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(&sm.hfull[w]);
    }
  };
  // A chunk's pairs and tiles fit in int (its workspace is at most 1 GiB).
  const int tiles = (int)a.tiles;
  if ((int)blockIdx.x < tiles) bins(blockIdx.x, 0);
  uint32_t k = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    int lp0[2];   // the unit's first pair in the chunk
    int cols[2];  // its columns inside the row (0 past the grid)
    for (int w = 0; w < 2; ++w) {
      const long long u = 2 * t + w;
      const Unit un(min(u, gr.units - 1), gr);
      lp0[w] = (un.prow - gr.m0) * gr.Nc + un.j0;
      cols[w] = u < gr.units ? min(kUnit, gr.Nc - un.j0) : 0;
      wg::mbar_wait(&sm.hfull[w], k & 1);
      const float* H = sm.h[w];
      const float* G = sm.g[w];
      float* const m_rows = ws.m + (size_t)lp0[w] * CP;
      for (int idx = h; idx < cols[w] * (CP / 4); idx += 32 * kStoreWarps) {
        const int r = idx / (CP / 4), c = (idx % (CP / 4)) * 4;
        const float4 hv = *reinterpret_cast<const float4*>(H + wg::swz<kUnit>(r, c));
        const float4 gv = *reinterpret_cast<const float4*>(G + c);
        __stcs(reinterpret_cast<float4*>(m_rows + r * CP + c),
               make_float4(__fmul_rn(gv.x, hv.x), __fmul_rn(gv.y, hv.y), __fmul_rn(gv.z, hv.z),
                           __fmul_rn(gv.w, hv.w)));
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(&sm.hempty[w]);
    }
    for (int i = 0; i < 5; ++i) {
      float* dst = i == 0 ? ws.y0 : i == 1 ? ws.y1 : i == 2 ? ws.dx : i == 3 ? ws.dy1 : ws.dy0;
      for (int w = 0; w < 2; ++w) {
        wg::mbar_wait(&bw.sfull[w], (5 * k + i) & 1);
        const float* S = sm.act[w];
        // Thread h copies column quad q of rows h / 32, + kStoreWarps, ..
        // in order, and sums them (dx: d_b2; dy1: d_b1).
        const int q = 4 * lane;
        float* const rows = dst + (size_t)lp0[w] * C + q;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int r = h >> 5; r < cols[w]; r += kStoreWarps) {
          const float4 v = *reinterpret_cast<const float4*>(S + wg::swz<kUnit>(r, q));
          __stcs(reinterpret_cast<float4*>(rows + r * C), v);
          sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
        }
        float* vp = ws.vpart + (size_t)(2 * t + w) * vec_floats(a.n_bins);
        if (i == 2 || i == 3) {
          // The store warps' sums of each column, added in warp order.
          *reinterpret_cast<float4*>(bw.colsum[w][h >> 5] + q) = sum;
          wg::bar_sync(4, 32 * kStoreWarps);
          if (h < 32 && cols[w]) {
            float4 s = *reinterpret_cast<const float4*>(bw.colsum[w][0] + q);
            for (int sw = 1; sw < kStoreWarps; ++sw) {
              const float4 o = *reinterpret_cast<const float4*>(bw.colsum[w][sw] + q);
              s.x += o.x, s.y += o.y, s.z += o.z, s.w += o.w;
            }
            *reinterpret_cast<float4*>(vp + (i == 2 ? C : 0) + q) = s;
          }
        }
        if (i == 4 && cols[w]) {
          // d_w_dist: each bin's rows in order, the bins shared out over the
          // store warps.
          const uint8_t* ord = bw.order[k & 1][w];
          const uint8_t* bs = bw.bstart[k & 1][w];
          for (int b = h >> 5; b < a.n_bins; b += kStoreWarps) {
            float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int p = bs[b]; p < bs[b + 1]; ++p) {
              const float4 v = *reinterpret_cast<const float4*>(S + wg::swz<kUnit>(ord[p], q));
              s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
            }
            *reinterpret_cast<float4*>(vp + (4 + b) * C + q) = s;
          }
        }
        if (i == 4) wg::fence_proxy_async();  // act's reads before the TMA's writes
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(i == 4 ? &sm.jempty[w] : &bw.sempty[w]);
      }
      if (i == 0 && t + (int)gridDim.x < tiles) bins(t + gridDim.x, k + 1);
    }
  }
}

// The two consumer warpgroups: warpgroup w takes unit 2 t + w of tile t.
__device__ __forceinline__ void consume(Smem& sm, EmbWgBwdSmem& bw,
                                        const float* wdist, const BwdArgs& a) {
  const int w = threadIdx.x >> 7, tc = threadIdx.x & 127, warp = tc >> 5;
  const int lane = threadIdx.x & 31, r0 = 16 * warp + (lane >> 2);
  const Grid& gr = a.gr;
  const int Nc = gr.Nc;
  float* A = sm.act[w];
  Consumer<kStages> ring{sm, 0};
  const auto act = [&](int ks, uint32_t(&hi)[4][4], uint32_t(&lo)[4][4]) {
    load_act(A, ks, hi, lo);
  };
  uint32_t k = 0;
  for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x, ++k) {
    const long long u = 2 * t + w;
    const bool valid = u < gr.units;
    const Unit un(min(u, gr.units - 1), gr);
    const int j[2] = {un.j0 + r0, un.j0 + r0 + 8};
    const bool ok[2] = {valid && j[0] < Nc, valid && j[1] < Nc};
    // The thread's two pairs in the grid and in the chunk.
    const size_t pair[2] = {(size_t)un.prow * Nc + j[0], (size_t)un.prow * Nc + j[1]};
    const long long lp[2] = {(long long)(un.prow - gr.m0) * Nc + j[0],
                             (long long)(un.prow - gr.m0) * Nc + j[1]};

    // ---- the forward's recompute; m, y0, y1 to the workspace --------------
    float acc[64], rstd[2], mask[2];
    float gv[64];  // the cotangent, then gm = g * emask
    BwdHooks hk{bw, a.grad, pair, ok, gv};
    forward_unit(sm, ring, wdist, k, acc, rstd, mask, hk);
    if (a.fwd_out)
      for_each_pair([&](int c, int i, int) {
        const int e = (i >> 1) & 1;
        if (!ok[e]) return;
        const float2 s = *reinterpret_cast<const float2*>(sm.vec[3] + c);
        const float2 b = *reinterpret_cast<const float2*>(sm.vec[4] + c);
        __stcs(reinterpret_cast<float2*>(a.fwd_out + pair[e] * C + c),
               make_float2(ln_out(acc[i], rstd[e], s.x, b.x, mask[e]),
                           ln_out(acc[i + 1], rstd[e], s.y, b.y, mask[e])));
      });

    // ---- mask and LayerNorm backward on the accumulators: dx into act ----
    float dem[2] = {0.f, 0.f}, m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
    for_each_pair([&](int c, int i, int) {
      const int e = (i >> 1) & 1;
      const float2 s = *reinterpret_cast<const float2*>(sm.vec[3] + c);
      const float2 b = *reinterpret_cast<const float2*>(sm.vec[4] + c);
      const float x0 = acc[i] * rstd[e], x1 = acc[i + 1] * rstd[e];  // xhat
      dem[e] += (x0 * s.x + b.x) * gv[i] + (x1 * s.y + b.y) * gv[i + 1];
      const float g0 = gv[i] * mask[e], g1 = gv[i + 1] * mask[e];
      m1[e] += g0 * s.x + g1 * s.y;
      m2[e] += g0 * s.x * x0 + g1 * s.y * x1;
      acc[i] = x0;
      acc[i + 1] = x1;
      gv[i] = g0;
      gv[i + 1] = g1;
    });
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        dem[e] += __shfl_xor_sync(0xffffffffu, dem[e], o);
        m1[e] += __shfl_xor_sync(0xffffffffu, m1[e], o);
        m2[e] += __shfl_xor_sync(0xffffffffu, m2[e], o);
      }
      m1[e] /= C;
      m2[e] /= C;
      if ((lane & 3) == 0 && ok[e]) a.ws.dem[lp[e]] = dem[e];
    }
    warp_columns([&](int i) { return gv[i] * acc[i]; }, bw.red[w][warp][0]);  // d_ln_scale
    warp_columns([&](int i) { return gv[i]; }, bw.red[w][warp][1]);           // d_ln_bias
    wg::mbar_wait(&bw.sempty[w], 1);  // y1 copied
    for_each_pair([&](int c, int i, int o) {
      const int e = (i >> 1) & 1;
      const float2 s = *reinterpret_cast<const float2*>(sm.vec[3] + c);
      *reinterpret_cast<float2*>(A + o) =
          make_float2((gv[i] * s.x - m1[e] - acc[i] * m2[e]) * rstd[e],
                      (gv[i + 1] * s.y - m1[e] - acc[i + 1] * m2[e]) * rstd[e]);
    });
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&bw.sfull[w]);
    wg::bar_sync(1 + w, 128);  // the warps' column sums whole
    if (valid) {
      float* vp = a.ws.vpart + u * vec_floats(a.n_bins);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float s = 0.f;
#pragma unroll
        for (int wp = 0; wp < 4; ++wp) s += bw.red[w][wp][q][tc];
        vp[(2 + q) * C + tc] = s;
      }
    }

    // ---- the chain, on the forward's products over the stored weights ----
    // dy1 = (dx @ W2^T) . [y1 > 0], over dx in act.
    ring.template product<kLayerSlices>(act, acc);
    wg::mbar_wait(&bw.sempty[w], 0);  // the store warps have copied dx
    masked_store(A, acc, {bw.relu[w][1][0][tc], bw.relu[w][1][1][tc]});
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&bw.sfull[w]);

    // dy0 = (dy1 @ W1^T) . [y0 > 0].
    ring.template product<kLayerSlices>(act, acc);
    wg::mbar_wait(&bw.sempty[w], 1);  // the store warps have copied dy1
    masked_store(A, acc, {bw.relu[w][0][0][tc], bw.relu[w][0][1][tc]});
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&bw.sfull[w]);

    // dm = dy0 @ W_rel^T, 64 columns; act is then free for the next unit.
    float dm[32];
    ring.template product<kLayerSlices>(act, dm);
    wg::fence_proxy_async();
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&sm.jempty[w]);
    for_each_pair<32>([&](int c, int i, int) {
      const int e = (i >> 1) & 1;
      if (ok[e])
        __stcs(reinterpret_cast<float2*>(a.ws.dm + lp[e] * CP + c), make_float2(dm[i], dm[i + 1]));
    });
  }
}

__global__ void __launch_bounds__(kBlockWG, 1)
emb_bwd_tile_kernel(const __grid_constant__ Maps maps, const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = emb_smem<kStages>(smem_raw);
  float* wdist = reinterpret_cast<float*>(&sm + 1);
  EmbWgBwdSmem& bw = *reinterpret_cast<EmbWgBwdSmem*>(wdist + a.n_bins * LDD);
  init_block(sm, &bw, wdist, a.w_dist, a.lower, a.upper, a.b0, a.b1, a.b2, a.ln_scale, a.ln_bias,
             a.n_bins);
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid >= kConsumers) {
    // The producer warpgroup: one lane keeps the ring full (the forward's
    // slices of a tile, then the chain's), warps 1-3 the bins and masks and
    // the workspace stores.
    wg::setmaxnreg_dec<40>();
    if (tid == kConsumers)
      produce<kStages, true>(sm, maps, a.g, a.i_term, a.gr, a.tiles);
    else if (tid >= kHelper0)
      store_regions(sm, bw, a, tid - kHelper0);
  } else {
    wg::setmaxnreg_inc<232>();
    consume(sm, bw, wdist, a);
  }
}

// One chunk, rows m0 .. m1 - 1 of the flat [B * Nr] grid.
cudaError_t launch(const float* grad, const float* g, const float* h, const float* pos_r,
                   const float* pos_c, const float* i_term, const float* j_term,
                   const float* row_mask, const float* col_mask, const float* w_rel,
                   const float* w_dist, const float* lower, const float* upper, const float* b0,
                   const float* w1, const float* b1, const float* w2, const float* b2,
                   const float* ln_scale, const float* ln_bias, float* wsp, long long ws_floats,
                   float* split, float* wred, float* rowred, float* colred, int n_bins, int B,
                   int Nr, int Nc, int m0, int m1, float* fwd_out, cudaStream_t stream) {
  if (n_bins < 0 || n_bins > MAX_BINS) return cudaErrorInvalidValue;
  if (m0 < 0 || m1 <= m0 || m1 > B * Nr || Nc <= 0) return cudaErrorInvalidValue;
  const int n_jb = (Nc + kUnit - 1) / kUnit;
  const long long P = (long long)(m1 - m0) * Nc, units = (long long)(m1 - m0) * n_jb;
  if (split_ws_floats<float>(P, units, n_bins) > ws_floats) return cudaErrorInvalidValue;
  const SplitWs<float> ws = split_ws<float>(wsp, P, units, n_bins);
  const long long groups = split_groups(units), tiles = (units + 1) / 2;
  const int vec = vec_floats(n_bins);
  cudaError_t err;

  // The two weight splits: the forward's (W^T), then the chain's (W).
  prepare_weights<true><<<80, 256, 0, stream>>>(w_rel, w1, w2, split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  prepare_weights<false><<<80, 256, 0, stream>>>(w_rel, w1, w2, split + kSplitFloats);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  float* chain = split + kSplitFloats;
  Maps maps;
  if (!wg::f32_sw128_map(&maps.w_rel, split + WRS, 2 * C, CP, C) ||
      !wg::f32_sw128_map(&maps.w1, split + W1S, 2 * C, C, C) ||
      !wg::f32_sw128_map(&maps.w2, split + W2S, 2 * C, C, C) ||
      !wg::f32_sw128_map(&maps.h, h, (uint64_t)B * Nc, CP, kUnit) ||
      !wg::f32_sw128_map(&maps.j_term, j_term, (uint64_t)B * Nc, C, kUnit) ||
      !wg::f32_sw128_map(&maps.w2c, chain + W2S, 2 * C, C, C) ||
      !wg::f32_sw128_map(&maps.w1c, chain + W1S, 2 * C, C, C) ||
      !wg::f32_sw128_map(&maps.w_relc, chain + WRS, 2 * CP, C, CP))
    return cudaErrorInvalidValue;

  // Kernel A; the unit partials past the last unit are zero.
  if ((err = cudaMemsetAsync(ws.vpart + units * vec, 0,
                             sizeof(float) * (groups * kGroup - units) * vec, stream)) !=
      cudaSuccess)
    return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const BwdArgs a{grad, g, pos_r, pos_c, i_term, row_mask, col_mask, w_dist, lower, upper, b0, b1,
                  b2, ln_scale, ln_bias, fwd_out, ws, Grid{Nr, Nc, n_jb, m0, units}, tiles,
                  n_bins};
  const int blocks = (int)(tiles < sms ? tiles : sms);
  const size_t bytes = smem_bytes<kStages, true>(n_bins);
  if ((err = cudaFuncSetAttribute(emb_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes)) != cudaSuccess)
    return err;
  emb_bwd_tile_kernel<<<blocks, kBlockWG, bytes, stream>>>(maps, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return finish_split<float>(g, h, row_mask, col_mask, ws, units, wred, rowred, colred, n_bins,
                             Nr, Nc, m0, m1, stream);
}

}  // namespace
}  // namespace fdk

// C interface, for one chunk: rows m0 .. m1 - 1 of the flat [B * Nr] grid
// (pairs m0 * Nc ..), every tensor float32: fdk_edge_embedder_bwd_split's
// arguments without the dtype and the transposed weights, and split:
// 163,840 floats of device scratch, 16-byte aligned, for the weights' TF32
// parts (the forward's, then the chain's). Weights are row-major [in, out],
// 16-byte aligned; g, h, i_term and j_term 16-byte aligned (bulk copies and
// TMA), the biases 8-byte aligned. ws: the chunk's workspace of ws_floats
// floats (split_ws_floats of its pairs and units at least). Adds the chunk's
// weight, bias and LayerNorm gradients to wred [49664] and its column sums to
// colred [B, Nc, 193] (both zeroed before the first chunk), writes its rows
// of rowred [B, Nr, 193]. fwd_out (or null): [B, Nr, Nc, 128], receives the
// recompute's LayerNorm output of the chunk's pairs, as edge_embedder_wg.cu
// writes it. Returns a cudaError_t (0 on success).
extern "C" int fdk_edge_embedder_bwd_wg(
    const void* grad, const void* g, const void* h, const float* pos_r, const float* pos_c,
    const void* i_term, const void* j_term, const void* row_mask, const void* col_mask,
    const void* w_rel, const void* w_dist, const float* lower, const float* upper, const void* b0,
    const void* w1, const void* b1, const void* w2, const void* b2, const float* ln_scale,
    const float* ln_bias, float* ws, long long ws_floats, void* split, float* wred,
    float* rowred, float* colred, int n_bins, int B, int Nr, int Nc, int m0, int m1,
    void* fwd_out, void* stream) {
  using F = const float*;
  return (int)fdk::launch((F)grad, (F)g, (F)h, pos_r, pos_c, (F)i_term, (F)j_term, (F)row_mask,
                          (F)col_mask, (F)w_rel, (F)w_dist, lower, upper, (F)b0, (F)w1, (F)b1,
                          (F)w2, (F)b2, ln_scale, ln_bias, ws, ws_floats,
                          static_cast<float*>(split), wred, rowred, colred, n_bins, B, Nr, Nc, m0,
                          m1, static_cast<float*>(fwd_out), static_cast<cudaStream_t>(stream));
}
