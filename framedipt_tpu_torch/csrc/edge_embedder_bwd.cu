// Backward of the fused embedder edge branch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/edge_embedder.py:366
// (_edge_embedder_bwd_kernel, reached through fused_edge_embedder_bwd). For
// the cotangent g [B, Nr, Nc, 128] of csrc/edge_embedder.cu's output it
// recomputes that kernel's forward per pair and back-propagates, with
// m = G_i * H_j (64 wide) and relu'(0) = 0:
//
//   dem = sum_c yln g                 mask gradients (through yln * emask)
//   gm = g * emask                    LayerNorm backward (float32 statistics)
//   dW2 += y1^T dx, dy1 = dx W2^T * [y1 > 0]
//   dW1 += y0^T dy1, dy0 = dy1 W1^T * [y0 > 0]
//   dW_rel += m^T dy0, dW_dist[bin] += dy0 (at most one bin a pair)
//   dm = dy0 W_rel^T; d_G_i += sum_j dm * H_j; d_H_j += sum_i dm * G_i
//   d_i_term_i += sum_j dy0, d_j_term_j += sum_i dy0
//
// There is no gradient of the N^2 pair input (it is synthesized per pair from
// O(N) inputs) and none of the coordinates (the distogram is a step function).
// Outputs, all float32: d_g, d_h, d_i_term, d_j_term and the mask gradients
// as row or column sums, and d_w_rel, d_w_dist, d_w1, d_b1, d_w2, d_b2,
// d_ln_scale, d_ln_bias as grid sums. d_b0 is the wrapper's sum of d_i_term.
// No gradient is summed across blocks in place and no float atomic is used:
// two launches give the same bits.
//
// Work at B=2 N=256 (131,072 pairs): 81,920 FLOP a pair for the recompute
// and 163,840 for the backward products (dW2, dy1, dW1, dy0: 2 x 128 x 128
// each; dW_rel, dm: 2 x 64 x 128), 245,760 FLOP a pair, 32.2 GFLOP a call,
// against 67.1 MB of float32 cotangent (bf16 33.6 MB). On an H100 SXM that is
// 3 x 32.2 GFLOP / 495 TFLOP/s = 0.195 ms on the tensor cores as 3xTF32, or
// 0.48 ms on the CUDA cores (67 TFLOP/s); bf16, 32.2 GFLOP / 989 TFLOP/s =
// 0.033 ms. Set by operations.
//
// Both element types: two kernels and fixed-order sums, per chunk of grid
// rows (the wrapper plans the chunks so that the workspace stays under its
// cap), as pair_mlp_bwd.cu. This file holds bf16's kernel A and entry;
// float32's kernel A runs on wgmma and TMA (edge_embedder_bwd_wg.cu), and
// the rest of the split backward (the workspace, the row and column sums,
// kernel B, the ordered sums) is edge_embedder_split.cuh, shared by both.
// - Kernel A (emb_split_tile_kernel), one block per 64-pair tile of the
//   chunk's flat pairs, in the forward kernel's shared-memory layout (bf16
//   95 KB and 2 KB of relu decisions; two blocks an SM). It recomputes the
//   forward through the forward kernel's own code (edge_embedder_tc.cuh:
//   emb_forward_tile; tc_product.cuh: bf16 MMA on mma.sync), so the
//   recompute equals edge_embedder.cu's output bit for bit and the relu
//   decisions are the forward's; it keeps them as ballot words in shared
//   memory. Then the mask
//   and LayerNorm backward (one warp per 8 pairs), and the input-gradient
//   chain through the same products on the transposed weights the wrapper
//   lays out: dy1 = (dx W2^T) . [y1 > 0], dy0 = (dy1 W1^T) . [y0 > 0],
//   dm = dy0 W_rel^T. W_rel^T is [128, 64]; the wrapper pads it with zero
//   columns to [128, 128], so dm runs through the same 128-column product as
//   the others (its upper 64 columns are dropped: a tenth more products in
//   kernel A, no second product code). It writes y0, y1, m, dx, dy1, dy0,
//   dm and dem (the mask gradients' yln . g) to the workspace (evict-first
//   stores) and one partial a tile of d_b1 | d_b2 | d_ln_scale | d_ln_bias |
//   d_w_dist (each pair adds dy0 to its bin's row, the tile's rows in order).
// - Row and column sums (emb_row_sums, emb_col_sums): d_g | d_i_term |
//   d_row_mask and the column ones, summed from the workspace in index order
//   (dm * H_j and dm * G_i formed there).
// - Kernel B, shared with the pair MLP: d_w_rel = m^T dy0 (a 64-row job),
//   d_w1 = y0^T dy1, d_w2 = y1^T dx as one split-K GEMM, the chunk's pairs
//   in kSlices = 44 slices: 3 x 44 = 132 blocks, one wave on 132 SMs. In
//   float32 wgrad_wg.cuh's kernel (wgmma and TMA, 3xTF32), in bf16
//   wgrad_bf16.cuh's (bf16 wgmma on the TMA-staged rows, both operands
//   MN-major); in both the 64-row job runs one m64 half and loads m's 64
//   columns only.
// - Then common.cuh's sum_partials adds the slices' partials in slice order,
//   and the tiles' vector partials in tile order (32 at a time, then the
//   groups), to the outputs, chunk after chunk.
// The float32 workspace round trip at B=2 N=256 (one chunk; 0.40 GB
// written, 0.40 GB read back by kernel B and 0.20 GB by the sums) takes
// 0.30 ms at the HBM rate. Measured on an H100 (NVIDIA H100 80GB HBM3,
// 700 W, chip_smoke.py), before float32's kernel A moved to wgmma: the
// float32 call 1.11 ms; kernel A 0.68, kernel B 0.15, the sums 0.18, the
// reductions 0.05.
//
// bf16 follows the JAX kernel's rounding points (edge_embedder.py:433-530):
// - the recompute is the bf16 forward kernel's: m = bf16(G_i * H_j), each
//   product and add rounded to bf16 where it rounds them (common.cuh's
//   epilogues);
// - the LayerNorm backward is float32 (dem, d_ln_scale, d_ln_bias, dx), and
//   d_b2 sums the unrounded dx;
// - dxd = bf16(dx) is the operand of d_w2 and the chain (nothing else reads
//   float32 dx, so the workspace keeps dxd only);
// - dy1 = bf16(dxd W2^T), rounded before the relu mask, and dy0 =
//   bf16(dy1 W1^T) likewise; d_b1, d_i_term, d_j_term and d_w_dist sum
//   these bf16 values in float32;
// - dm = dy0 W_rel^T stays float32 (unrounded); d_g and d_h sum dm * H_j
//   and dm * G_i with G and H widened from bf16;
// - the products are bf16 MMA with float32 accumulation, kernel B's too.
// Its workspace holds y0, y1, m, dxd, dy1 and dy0 as bf16 (exact: each is
// a bf16 value) and dm and dem as float32: 417 floats a pair against
// float32's 769, 0.25 GB at B=2 N=256 in one chunk against 0.44 GB.
// Measured (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py): the bf16 call
// 0.70 ms against the earlier persistent CUDA-core kernel's 2.07; kernel A
// 0.35, kernel B 0.08, the sums 0.18, the reductions 0.05.
//
// Padded pairs (past the chunk) contribute nothing. Masked pairs keep theirs
// for the mask gradients and pass zero into the LayerNorm backward
// (gm = g * emask).
#include "edge_embedder_tc.cuh"
#include "edge_embedder_split.cuh"

namespace fdk {
namespace {

constexpr int kWarps = kThreads / 32;

// The input-gradient chain's weights in the order its products read them:
// W2^T, W1^T, then W_rel^T padded to [128, 128] (4 slices each).
template <typename T>
struct EmbBwdSlices {
  static constexpr int kLayer = C / kKc, kTile = 3 * kLayer;
  const T* w2t;
  const T* w1t;
  const T* w_relt;

  __device__ __forceinline__ const T* slice(int s, int& ldw) const {
    ldw = C;
    const T* w = s < kLayer ? w2t : s < 2 * kLayer ? w1t : w_relt;
    return w + (size_t)(s % kLayer) * kKc * C;
  }
};

template <typename T>
constexpr size_t kASmemBytes = EmbSmem<T>::kBytes + sizeof(uint32_t) * 2 * kMaskWords;
static_assert(kASmemBytes<float> + 1024 <= 233472 / 2 &&
              kASmemBytes<__nv_bfloat16> + 1024 <= 233472 / 2, "two blocks an SM");
// The LayerNorm backward's channel sums go to the weight ring's memory, the
// tile's d_w_dist to y1's tile.
static_assert(sizeof(float) * kWarps * 3 * C <= sizeof(__nv_bfloat16) * 3 * kStageElems &&
              sizeof(float) * kWarps * 3 * C <= sizeof(float) * 2 * kStageElems,
              "channel sums in the ring");
static_assert(MAX_BINS * C <= kRows * EmbSmem<float>::LDX, "d_w_dist in y1's tile");

// Kernel A over pairs q0 .. q0 + P - 1 of the flat [B * Nr * Nc] grid, one
// 64-pair tile a block. With fwd_out, also the recompute's LayerNorm output,
// as the forward kernel writes it.
template <typename T>
__global__ void __launch_bounds__(kBlock, 2)
emb_split_tile_kernel(const T* __restrict__ gout, const T* __restrict__ gf,
                      const T* __restrict__ hf, const float* __restrict__ pos_r,
                      const float* __restrict__ pos_c, const T* __restrict__ i_term,
                      const T* __restrict__ j_term, const T* __restrict__ row_mask,
                      const T* __restrict__ col_mask, const T* __restrict__ w_rel,
                      const T* __restrict__ w_dist, const float* __restrict__ lower,
                      const float* __restrict__ upper, const T* __restrict__ b0,
                      const T* __restrict__ w1, const T* __restrict__ b1,
                      const T* __restrict__ w2, const T* __restrict__ b2,
                      const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                      const T* __restrict__ w_relt, const T* __restrict__ w1t,
                      const T* __restrict__ w2t, SplitWs<T> ws, long long q0, long long P,
                      int n_bins, int Nr, int Nc, T* __restrict__ fwd_out) {
  using L = EmbSmem<T>;
  extern __shared__ __align__(16) float smem[];
  const EmbTile<T> et(smem);
  float* X = et.X;    // y0, the pre-norm output, dxd, then dy0
  float* Y1 = et.Y1;  // m, y1, dy1, dm (64 columns), then the tile's d_w_dist
  const PairTile& pt = *et.pt;
  uint32_t* M0 = reinterpret_cast<uint32_t*>(et.bin + kRows);  // relu decisions of y0
  uint32_t* M1 = M0 + kMaskWords;                               // and of y1

  const EmbStream<T> fwd{{w_rel, w1, w2}, et.stages, EmbSlices<T>::kTile};
  for (int s = 0; s < L::STAGES - 1; ++s) fwd.start(s);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long lp0 = (long long)blockIdx.x * kRows, p0 = q0 + lp0;
  load_pair_tile<T>(*et.pt, p0, q0 + P, Nr, Nc, row_mask, col_mask);
  if (tid < n_bins) {
    et.lo[tid] = lower[tid];
    et.hi[tid] = upper[tid];
  }
  __syncthreads();

  // ---- the forward kernel's recompute; m, y0, y1 to the workspace --------
  emb_forward_tile<T, true>(
      et, fwd, gf, hf, pos_r, pos_c, i_term, j_term, w_dist, b0, b1, b2, n_bins,
      EmbKeep<T>{ws.m + lp0 * CP, ws.y0 + lp0 * C, ws.y1 + lp0 * C, M0, M1});
  __syncthreads();
  if (fwd_out) {
    layer_norm_store<T>(X, L::LDX, pt, p0, ln_scale, ln_bias, fwd_out);
    __syncthreads();
  }

  // ---- mask and LayerNorm backward, one warp per 8 pairs: X becomes dxd ---
  // The channel sums go to the weight ring's memory: the first stream has
  // ended and the second has not started.
  float* Red = reinterpret_cast<float*>(et.stages);  // [kWarps][3][C]
  {
    float sl[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
    float sf[4] = {0.f, 0.f, 0.f, 0.f};
    for (int rr = 0; rr < kRows / kWarps; ++rr) {
      const int r = warp * (kRows / kWarps) + rr;
      if (pt.row[r] < 0) {  // warp-uniform: a pair past the chunk contributes 0
#pragma unroll
        for (int q = 0; q < 4; ++q) X[r * L::LDX + lane + 32 * q] = 0.f;
        continue;
      }
      const T* gp = gout + (size_t)(p0 + r) * C;
      float xc[4], s = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xc[q] = X[r * L::LDX + lane + 32 * q];
        s += xc[q];
      }
      const float mean = warp_sum(s) / C;
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xc[q] -= mean;
        var += xc[q] * xc[q];
      }
      const float inv = 1.f / sqrtf(warp_sum(var) / C + 1e-6f);
      const float em = pt.mask[r];
      float xh[4], dxh[4], dem = 0.f, m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q;
        const float sc = __ldg(ln_scale + c);
        xh[q] = xc[q] * inv;
        const float gq = ld<T>(gp + c);
        dem += (xh[q] * sc + __ldg(ln_bias + c)) * gq;
        const float gm = gq * em;
        sl[q] += gm * xh[q];
        sb[q] += gm;
        dxh[q] = gm * sc;
        m1 += dxh[q];
        m2 += dxh[q] * xh[q];
      }
      dem = warp_sum(dem);
      m1 = warp_sum(m1) / C;
      m2 = warp_sum(m2) / C;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float dx = (dxh[q] - m1 - xh[q] * m2) * inv;
        sf[q] += dx;  // d_b2 sums dx unrounded
        X[r * L::LDX + lane + 32 * q] = rnd<T>(dx);
      }
      if (lane == 0) ws.dem[lp0 + r] = dem;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      Red[(warp * 3 + 0) * C + lane + 32 * q] = sl[q];
      Red[(warp * 3 + 1) * C + lane + 32 * q] = sb[q];
      Red[(warp * 3 + 2) * C + lane + 32 * q] = sf[q];
    }
  }
  __syncthreads();

  // The tile's d_b2, d_ln_scale, d_ln_bias; dxd to the workspace.
  float* vp = ws.vpart + (size_t)blockIdx.x * vec_floats(n_bins);
  if (tid < C) {
    const int from[3] = {2, 0, 1};  // d_b2, d_ln_scale, d_ln_bias
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += Red[(w * 3 + from[k]) * C + tid];
      vp[(1 + k) * C + tid] = s;
    }
  }
  store_rows(X, L::LDX, C, pt, ws.dx + lp0 * C, C);
  __syncthreads();  // the channel sums are read: the ring takes the second stream

  // ---- the input-gradient chain, through the same products on W^T ------
  // Each epilogue rounds its product to T (bf16 before the relu mask, as the
  // JAX kernel) and walks the fragments the recompute's did, so a lane's relu
  // decision is its bit of the same mask word. Each product's first barrier
  // orders the previous product's reads of the tile its epilogue overwrites.
  const WeightStream<T, EmbBwdSlices<T>, L::STAGES> bwd{
      {w2t, w1t, w_relt}, et.stages, EmbBwdSlices<T>::kTile};
  for (int s = 0; s < L::STAGES - 1; ++s) bwd.start(s);
  int s = 0;
  {  // dy1 = T(dxd @ W2^T) * relu'(y1), into Y1
    float acc[2][kNi][4] = {};
    product(X, L::LDX, C, bwd, s, acc);
    for_each_elem([&](int r, int c, int mi, int ni, int q) {
      if (q & 1) return;
      const float2 d = relu_grad(M1, 0, mi, ni, q, rnd<T>(acc[mi][ni][q]),
                                 rnd<T>(acc[mi][ni][q + 1]));
      Y1[r * L::LDX + c] = d.x;
      Y1[r * L::LDX + c + 1] = d.y;
    });
  }
  {  // dy0 = T(dy1 @ W1^T) * relu'(y0), into X
    float acc[2][kNi][4] = {};
    product(Y1, L::LDX, C, bwd, s, acc);
    for_each_elem([&](int r, int c, int mi, int ni, int q) {
      if (q & 1) return;
      const float2 d = relu_grad(M0, 0, mi, ni, q, rnd<T>(acc[mi][ni][q]),
                                 rnd<T>(acc[mi][ni][q + 1]));
      X[r * L::LDX + c] = d.x;
      X[r * L::LDX + c + 1] = d.y;
    });
  }
  // dy1 has been whole in Y1 since the first barrier of the W1^T product: to
  // the workspace, and the tile's d_b1 (its rows in order).
  store_rows(Y1, L::LDX, C, pt, ws.dy1 + lp0 * C, C);
  if (tid < C) {
    float sum = 0.f;
    for (int r = 0; r < kRows; ++r) sum += Y1[r * L::LDX + tid];
    vp[tid] = sum;
  }
  {  // dm = dy0 @ W_rel^T (float32, the padded columns dropped), into Y1
    float acc[2][kNi][4] = {};
    product(X, L::LDX, C, bwd, s, acc);
    for_each_elem([&](int r, int c, int mi, int ni, int q) {
      if ((q & 1) || c >= CP) return;
      Y1[r * L::LDX + c] = acc[mi][ni][q];
      Y1[r * L::LDX + c + 1] = acc[mi][ni][q + 1];
    });
  }
  __syncthreads();  // dy0 and dm whole; every warp has left the ring

  store_rows(X, L::LDX, C, pt, ws.dy0 + lp0 * C, C);
  store_rows(Y1, L::LDX, CP, pt, ws.dm + lp0 * CP, CP);
  // The tile's d_w_dist: thread c adds dy0[r][c] to its pair's bin row, the
  // rows in order, in y1's tile once dm is stored.
  if (n_bins > 0) {
    float* acc = Y1;  // [n_bins][C]
    __syncthreads();
    for (int i = tid; i < n_bins * C; i += kBlock) acc[i] = 0.f;
    __syncthreads();
    if (tid < C)
      for (int r = 0; r < kRows; ++r) {
        const int bn = et.bin[r];
        if (bn >= 0) acc[bn * C + tid] += X[r * L::LDX + tid];
      }
    __syncthreads();
    for (int i = tid; i < n_bins * C; i += kBlock) vp[4 * C + i] = acc[i];
  }
}

// One chunk, rows m0 .. m1 - 1 of the flat [B * Nr] grid.
template <typename T>
cudaError_t launch_split(const T* grad, const T* g, const T* h, const float* pos_r,
                         const float* pos_c, const T* i_term, const T* j_term,
                         const T* row_mask, const T* col_mask, const T* w_rel, const T* w_dist,
                         const float* lower, const float* upper, const T* b0, const T* w1,
                         const T* b1, const T* w2, const T* b2, const float* ln_scale,
                         const float* ln_bias, const T* w_relt, const T* w1t, const T* w2t,
                         float* wsp, long long ws_floats, float* wred, float* rowred,
                         float* colred, int n_bins, int B, int Nr, int Nc, int m0, int m1,
                         T* fwd_out, cudaStream_t stream) {
  if (n_bins < 0 || n_bins > MAX_BINS) return cudaErrorInvalidValue;
  if (m0 < 0 || m1 <= m0 || m1 > B * Nr || Nc <= 0) return cudaErrorInvalidValue;
  const long long q0 = (long long)m0 * Nc, P = (long long)(m1 - m0) * Nc;
  const long long tiles = split_tiles(P), groups = split_groups(tiles);
  if (split_ws_floats<T>(P, tiles, n_bins) > ws_floats) return cudaErrorInvalidValue;
  const SplitWs<T> ws = split_ws<T>(wsp, P, tiles, n_bins);
  const int vec = vec_floats(n_bins);
  cudaError_t err;

  // Kernel A; the tile partials past the last tile are zero.
  if ((err = cudaFuncSetAttribute(emb_split_tile_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kASmemBytes<T>)) != cudaSuccess)
    return err;
  if ((err = cudaMemsetAsync(ws.vpart + tiles * vec, 0,
                             sizeof(float) * (groups * kGroup - tiles) * vec, stream)) !=
      cudaSuccess)
    return err;
  emb_split_tile_kernel<T><<<(unsigned)tiles, kBlock, kASmemBytes<T>, stream>>>(
      grad, g, h, pos_r, pos_c, i_term, j_term, row_mask, col_mask, w_rel, w_dist, lower,
      upper, b0, w1, b1, w2, b2, ln_scale, ln_bias, w_relt, w1t, w2t, ws, q0, P, n_bins, Nr, Nc,
      fwd_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return finish_split<T>(g, h, row_mask, col_mask, ws, tiles, wred, rowred, colred, n_bins, Nr,
                         Nc, m0, m1, stream);
}

}  // namespace
}  // namespace fdk

// C interface, for one chunk: rows m0 .. m1 - 1 of the flat [B * Nr] grid
// (pairs m0 * Nc ..). dtype: 1 = bfloat16, the type of every tensor but the
// coordinates, the bin edges and the LayerNorm parameters (float32); 0
// (float32) is refused: it is fdk_edge_embedder_bwd_wg's
// (edge_embedder_bwd_wg.cu). Weights are row-major [in, out], 16-byte aligned; w1t / w2t
// their transposes, w_relt W_rel^T padded with zero columns to [128, 128].
// ws: the chunk's workspace of ws_floats floats (split_ws_floats of its
// pairs at least). Adds the chunk's weight, bias and LayerNorm gradients to
// wred [49664] and its column sums to colred [B, Nc, 193] (float32, both
// zeroed before the first chunk), writes its rows of rowred [B, Nr, 193].
// fwd_out (or null): [B, Nr, Nc, 128] in the dtype, receives the
// recompute's LayerNorm output of the chunk's pairs, as edge_embedder.cu
// writes it. Returns a cudaError_t (0 on success).
extern "C" int fdk_edge_embedder_bwd_split(
    int dtype, const void* grad, const void* g, const void* h, const float* pos_r,
    const float* pos_c, const void* i_term, const void* j_term, const void* row_mask,
    const void* col_mask, const void* w_rel, const void* w_dist, const float* lower,
    const float* upper, const void* b0, const void* w1, const void* b1, const void* w2,
    const void* b2, const float* ln_scale, const float* ln_bias, const void* w_relt,
    const void* w1t, const void* w2t, float* ws, long long ws_floats, float* wred,
    float* rowred, float* colred, int n_bins, int B, int Nr, int Nc, int m0, int m1,
    void* fwd_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDK_ARGS(T)                                                                            \
  (const T*)grad, (const T*)g, (const T*)h, pos_r, pos_c, (const T*)i_term, (const T*)j_term, \
      (const T*)row_mask, (const T*)col_mask, (const T*)w_rel, (const T*)w_dist, lower, upper, \
      (const T*)b0, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, ln_scale, ln_bias, \
      (const T*)w_relt, (const T*)w1t, (const T*)w2t, ws, ws_floats, wred, rowred, colred,     \
      n_bins, B, Nr, Nc, m0, m1, (T*)fwd_out, s
  // float32 is edge_embedder_bwd_wg.cu's (kernel A on wgmma).
  if (dtype == 1) return fdk::launch_split<__nv_bfloat16>(FDK_ARGS(__nv_bfloat16));
#undef FDK_ARGS
  return (int)cudaErrorInvalidValue;
}
