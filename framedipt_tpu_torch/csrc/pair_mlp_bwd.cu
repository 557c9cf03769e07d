// Backward of the fused pair MLP of the edge transition, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/pair_mlp.py:349
// (_pair_mlp_bwd_kernel, reached through fused_pair_mlp_bwd). For a
// [B, Nr, Nc, 128] pair tensor and its cotangent g it recomputes the forward
// per pair and back-propagates through the edge mask, the
// LayerNorm, the three products and the relus (relu'(0) = 0):
//
//   d_pair [B,Nr,Nc,128] (element type T), and in float32
//   d_i_term, d_fi, d_row_mask: sums over a row's pairs;
//   d_j_term, d_fj, d_col_mask: sums over a column's pairs;
//   d_w0, d_w1, d_b1, d_wf, d_bf, d_wfe, d_ln_scale, d_ln_bias: sums over
//   the whole grid.
//
// Work at B=2 N=256 (131,072 pairs): the recompute and the input-gradient
// chain (dx Wf^T, dy1 W1^T, dy0 W0^T + dx Wfe^T) are 1,048,576 FLOP a pair,
// 137 GFLOP; the weight gradients (pair^T dy0, y0^T dy1, y1^T dx, pair^T dx)
// are 524,288 FLOP a pair, 68.7 GFLOP; against 201 MB of float32 pair,
// cotangent and d_pair (100 MB in bf16). Bound on an H100 SXM: float32 as
// 3xTF32, 3 x 206 GFLOP / 495 TFLOP/s = 1.25 ms; bf16, 206 GFLOP / 989
// TFLOP/s = 0.21 ms. Set by operations. No gradient is summed across blocks
// in place and no float atomic is used: two launches give the same bits.
//
// Both element types: two kernels and fixed-order sums, per chunk of grid
// rows (the wrapper plans the chunks so that the workspace stays under its
// cap). This file holds bf16's kernel A and entry; float32's kernel A runs
// on wgmma and TMA in pair_mlp_bwd_wg.cu, and both share the rest
// (pair_mlp_split.cuh: the workspace, the sums, kernel B).
// - Kernel A, per 64-pair tile of the chunk's flat pairs, recomputes the
//   forward through the forward kernel's own tile code, so the recompute
//   equals the forward's output bit for bit and the relu masks are the
//   forward's; then the mask and LayerNorm backward, and the input-gradient
//   chain dy1 = (dx Wf^T) . [y1 > 0], dy0 = (dy1 W1^T) . [y0 > 0] by
//   128-column chunk, d_pair = dy0 W0^T (+ dx Wfe^T), through the same
//   products on the transposed weights, which have the forward weights'
//   shapes. It writes y0, y1, dy1, dy0 and dx ([pairs, 384] / [pairs, 128])
//   and dem (the mask gradients' yln . g) to the workspace, and one partial
//   of d_b1 | d_bf | d_ln_scale | d_ln_bias per tile. Bound: 3 x 137 GFLOP /
//   495 TFLOP/s = 0.83 ms (3xTF32); 137 GFLOP / 989 TFLOP/s = 0.14 ms
//   (bf16). In bf16 (split_tile_kernel) one block a tile, in the forward
//   kernel's shared-memory layout (192 KB, and 6 KB of relu decisions as
//   ballot words: the chain's epilogues walk the same fragments), on
//   pair_mlp_tc.cuh's forward_tile and mlp_products (mma.sync, bf16 MMA;
//   the weight ring), the transposed weights laid out by the wrapper.
// - Row and column sums (row_sums, col_sums): d_i_term | d_fi | d_row_mask
//   and the column ones, summed from the workspace in index order.
// - Kernel B, shared with the embedder's backward: the four weight
//   gradients as one split-K GEMM on the tensor cores, in float32
//   wgrad_wg.cuh's wgmma kernel (3xTF32, operands by TMA, Bm turned K-major
//   in shared memory), in bf16 wgrad_bf16.cuh's (bf16 wgmma reading both
//   operands MN-major from the TMA-staged rows). The
//   outputs are cut into 128 x 128 tiles (3 of d_w0, 9 of d_w1, 3 of d_wf,
//   1 of d_wfe) and the chunk's pairs into kSlices contiguous slices: 16 x
//   8 = 128 blocks, one wave on 132 SMs. Bound: 3 x 68.7 GFLOP / 495
//   TFLOP/s = 0.42 ms (3xTF32); 68.7 GFLOP / 989 TFLOP/s = 0.07 ms (bf16).
// - A second pass (common.cuh's sum_partials) adds the slices' partials in
//   slice order, and the tiles' vector partials in tile order (32 at a
//   time, then the groups), to the outputs, chunk after chunk.
// The whole float32 call: 206 GFLOP, 1.25 ms at the 3xTF32 rate; the
// workspace traffic (~1.9 GB written and read back) takes 0.57 ms at the
// HBM rate.
//
// bf16 follows the JAX kernel's rounding points (pair_mlp.py:483-516):
// - the recompute is the bf16 forward kernel's, products and adds rounded
//   to bf16 where it rounds them;
// - dx stays float32: d_bf, d_fi and d_fj sum it unrounded;
// - dxd = bf16(dx) is the operand of d_wf, d_wfe and the chain;
// - dy1 = bf16(dxd Wf^T), rounded before the relu mask, and dy0 =
//   bf16(dy1 W1^T) likewise; d_b1, d_i_term and d_j_term sum these
//   bf16 values in float32;
// - d_pair = bf16(bf16(dy0 W0^T) + bf16(dxd Wfe^T)) (float32 adds the two
//   sums unrounded); without the residual terms bf16(dy0 W0^T);
// - the products are bf16 MMA with float32 accumulation, kernel B's too.
// Its workspace holds the activations and their gradients as bf16 (exact:
// each is a bf16 value), dxd beside dx, 3,844 bytes a pair against
// float32's 6,660: 0.50 GB at B=2 N=256 in one chunk, against 0.87 GB.
//
// Padded pairs (past the chunk) contribute nothing. Masked pairs keep their
// contribution: the mask gradients read yln . g there.
#include "pair_mlp_tc.cuh"
#include "pair_mlp_split.cuh"

namespace fdk {
namespace {

constexpr int kWarps = kThreads / 32;
static_assert(kBlock == kThreads, "kernel A runs common.cuh's LayerNorm with its block");

template <typename T>
constexpr size_t kASmemBytes =
    Smem<T>::kBytes + sizeof(uint32_t) * 2 * (HID / NC) * kMaskWords;
static_assert(kASmemBytes<__nv_bfloat16> <= 232448, "shared memory of one block");
// The LayerNorm backward's channel sums go to the weight ring's memory.
static_assert(sizeof(float) * kWarps * 3 * C_OUT <= sizeof(__nv_bfloat16) * kStages * kStageElems,
              "channel sums in the ring");

// Two neighbouring elements of a row.
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Kernel A over pairs q0 .. q0 + P - 1 of the flat [B * Nr * Nc] grid, one
// 64-pair tile a block, in the forward kernel's shared-memory layout. With
// fwd_out, also the recompute's LayerNorm output, as the forward writes it.
template <typename T, bool RESIDUAL>
__global__ void __launch_bounds__(kBlock, 1)
split_tile_kernel(const T* __restrict__ g, const T* __restrict__ pair,
                  const T* __restrict__ i_term, const T* __restrict__ j_term,
                  const T* __restrict__ fi, const T* __restrict__ fj,
                  const T* __restrict__ row_mask, const T* __restrict__ col_mask,
                  const T* __restrict__ w0, const T* __restrict__ b0,
                  const T* __restrict__ w1, const T* __restrict__ b1,
                  const T* __restrict__ wf, const T* __restrict__ bf,
                  const T* __restrict__ wfe, const float* __restrict__ ln_scale,
                  const float* __restrict__ ln_bias, const T* __restrict__ w0t,
                  const T* __restrict__ w1t, const T* __restrict__ wft,
                  const T* __restrict__ wfet, T* __restrict__ d_pair, SplitWs<T> ws,
                  long long q0, long long P, int Nr, int Nc, T* __restrict__ fwd_out) {
  using L = Smem<T>;
  extern __shared__ __align__(16) float smem[];
  float* X = smem;                   // [64][LDX]  pair tile, then the pre-norm output, then dx
  float* Y0 = X + kRows * L::LDX;    // [64][LDY0] y0, then dy1
  float* Y1 = Y0 + kRows * L::LDY0;  // [64][LDY1] a chunk of y1, then of dy0
  T* stages = reinterpret_cast<T*>(Y1 + kRows * L::LDY1);  // [kStages][kKc][kLdw] weight ring
  PairTile& pt = *reinterpret_cast<PairTile*>(stages + kStages * L::kStage);
  uint32_t* M0 = reinterpret_cast<uint32_t*>(&pt + 1);  // relu decisions of y0 (mask_word)
  uint32_t* M1 = M0 + (HID / NC) * kMaskWords;           // and of y1
  constexpr int kTileSlices = RESIDUAL ? kResSlice + kKSlices : kResSlice;

  const MlpStream<T> fwd{{w0, w1, wf, wfe}, stages, kTileSlices};
  for (int s = 0; s < kStages - 1; ++s) fwd.start(s);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long lp0 = (long long)blockIdx.x * kRows, p0 = q0 + lp0, end = q0 + P;
  load_pair_tile<T>(pt, p0, end, Nr, Nc, row_mask, col_mask);
  for (int idx = tid; idx < kRows * C_IN; idx += kBlock) {
    const int r = idx / C_IN, c = idx - r * C_IN;
    X[r * L::LDX + c] = p0 + r < end ? ld<T>(pair + (size_t)(p0 + r) * C_IN + c) : 0.f;
  }

  // ---- the forward kernel's recompute; y0 and y1 to the workspace -------
  forward_tile<T, RESIDUAL, true, T>(X, Y0, Y1, pt, fwd, i_term, j_term, fi, fj, b0, b1, bf,
                                     ws.y0 + lp0 * HID, ws.y1 + lp0 * HID, M0, M1);
  __syncthreads();
  if (fwd_out) {
    layer_norm_store<T>(X, L::LDX, pt, p0, ln_scale, ln_bias, fwd_out);
    __syncthreads();
  }

  // ---- mask and LayerNorm backward, one warp per 8 pairs: X becomes dxd ---
  // The channel sums go to the weight ring's memory: the first stream has
  // ended and the second has not started.
  float* Red = reinterpret_cast<float*>(stages);  // [kWarps][3][C_OUT]
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
      const T* gp = g + (size_t)(p0 + r) * C_OUT;
      float xc[4], s = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xc[q] = X[r * L::LDX + lane + 32 * q];
        s += xc[q];
      }
      const float mean = warp_sum(s) / C_OUT;
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xc[q] -= mean;
        var += xc[q] * xc[q];
      }
      const float inv = 1.f / sqrtf(warp_sum(var) / C_OUT + 1e-6f);
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
      m1 = warp_sum(m1) / C_OUT;
      m2 = warp_sum(m2) / C_OUT;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float dx = (dxh[q] - m1 - xh[q] * m2) * inv;
        sf[q] += dx;
        // bf16: dx itself (float32) for the sums, dxd in X.
        if (kBf16<T>) __stcs(ws.dx + (size_t)(lp0 + r) * C_OUT + lane + 32 * q, dx);
        X[r * L::LDX + lane + 32 * q] = rnd<T>(dx);
      }
      if (lane == 0) ws.dem[lp0 + r] = dem;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      Red[(warp * 3 + 0) * C_OUT + lane + 32 * q] = sl[q];
      Red[(warp * 3 + 1) * C_OUT + lane + 32 * q] = sb[q];
      Red[(warp * 3 + 2) * C_OUT + lane + 32 * q] = sf[q];
    }
  }
  __syncthreads();

  // The tile's d_bf, d_ln_scale, d_ln_bias; dxd (float32: dx) to the workspace.
  float* vp = ws.vpart + (size_t)blockIdx.x * kVec;
  if (tid < C_OUT) {
    const int from[3] = {2, 0, 1};  // d_bf, d_ln_scale, d_ln_bias
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += Red[(w * 3 + from[k]) * C_OUT + tid];
      vp[HID + k * C_OUT + tid] = s;
    }
  }
  store_rows(X, L::LDX, C_OUT, pt, ws.dxd + lp0 * C_OUT, C_OUT);
  __syncthreads();  // the channel sums are read: the ring takes the second stream

  // ---- the input-gradient chain, through the same products on W^T ------
  // dy1 = T(dxd @ Wf^T) * relu'(y1) into Y0, dy0 = T(dy1 @ W1^T) * relu'(y0)
  // by chunk into Y1, d_pair = dy0 @ W0^T (+ dxd @ Wfe^T); each epilogue
  // walks the fragments the recompute's did, so a lane's relu decision is
  // its bit of the same mask word.
  const MlpStream<T> bwd{{wft, w1t, w0t, wfet}, stages, kTileSlices};
  for (int s = 0; s < kStages - 1; ++s) bwd.start(s);
  float acc_dp[2][kNi][4] = {}, res[2][kNi][4] = {};
  mlp_products<T, RESIDUAL>(
      X, Y0, Y1, bwd,
      [&](int cb, float (&acc)[2][kNi][4]) {
        for_each_elem([&](int r, int c, int mi, int ni, int q) {
          if (q & 1) return;
          c += cb * NC;
          const float2 d = relu_grad(M1, cb, mi, ni, q, rnd<T>(acc[mi][ni][q]),
                                     rnd<T>(acc[mi][ni][q + 1]));
          Y0[r * L::LDY0 + c] = d.x;
          Y0[r * L::LDY0 + c + 1] = d.y;
        });
      },
      [&](int hc, float (&acc1)[2][kNi][4]) {
        for_each_elem([&](int r, int c, int mi, int ni, int q) {
          if (q & 1) return;
          const float2 d = relu_grad(M0, hc, mi, ni, q, rnd<T>(acc1[mi][ni][q]),
                                     rnd<T>(acc1[mi][ni][q + 1]));
          Y1[r * L::LDY1 + c] = d.x;
          Y1[r * L::LDY1 + c + 1] = d.y;
        });
      },
      [&](int hc) { store_rows(Y1, L::LDY1, NC, pt, ws.dy0 + lp0 * HID + hc * NC, HID); },
      acc_dp, res);
  // d_pair: float32 adds the two sums unrounded; bf16 rounds each, then
  // their sum.
  for_each_elem([&](int r, int c, int mi, int ni, int q) {
    if ((q & 1) || pt.row[r] < 0) return;
    float v0 = rnd<T>(acc_dp[mi][ni][q]), v1 = rnd<T>(acc_dp[mi][ni][q + 1]);
    if (RESIDUAL) {
      v0 = rnd<T>(v0 + rnd<T>(res[mi][ni][q]));
      v1 = rnd<T>(v1 + rnd<T>(res[mi][ni][q + 1]));
    }
    store2(d_pair + (size_t)(p0 + r) * C_IN + c, v0, v1);
  });
  // dy1 has been whole in Y0 since the first barrier of the first W1^T
  // product: to the workspace, and the tile's d_b1.
  store_rows(Y0, L::LDY0, HID, pt, ws.dy1 + lp0 * HID, HID);
  for (int c = tid; c < HID; c += kBlock) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += Y0[r * L::LDY0 + c];
    vp[c] = s;
  }
}

// One chunk, rows m0 .. m1 - 1 of the flat [B * Nr] grid.
template <typename T, bool RESIDUAL>
cudaError_t launch_split(const T* g, const T* pair, const T* i_term, const T* j_term,
                         const T* fi, const T* fj, const T* row_mask, const T* col_mask,
                         const T* w0, const T* b0, const T* w1, const T* b1, const T* wf,
                         const T* bf, const T* wfe, const float* ln_scale, const float* ln_bias,
                         const T* w0t, const T* w1t, const T* wft, const T* wfet, T* d_pair,
                         float* wsp, long long ws_floats, float* wred, float* rowred,
                         float* colred, int B, int Nr, int Nc, int m0, int m1, T* fwd_out,
                         cudaStream_t stream) {
  if (m0 < 0 || m1 <= m0 || m1 > B * Nr || Nc <= 0) return cudaErrorInvalidValue;
  const long long q0 = (long long)m0 * Nc, P = (long long)(m1 - m0) * Nc;
  if (split_ws_floats<T>(P) > ws_floats) return cudaErrorInvalidValue;
  const SplitWs<T> ws = split_ws<T>(wsp, P);
  const long long tiles = split_tiles(P), groups = split_groups(P);
  cudaError_t err;

  // Kernel A; the tile partials past the last tile are zero.
  if ((err = cudaFuncSetAttribute(split_tile_kernel<T, RESIDUAL>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kASmemBytes<T>)) != cudaSuccess)
    return err;
  if ((err = cudaMemsetAsync(ws.vpart + tiles * kVec, 0,
                             sizeof(float) * (groups * kGroup - tiles) * kVec, stream)) !=
      cudaSuccess)
    return err;
  split_tile_kernel<T, RESIDUAL><<<(unsigned)tiles, kBlock, kASmemBytes<T>, stream>>>(
      g, pair, i_term, j_term, fi, fj, row_mask, col_mask, w0, b0, w1, b1, wf, bf, wfe,
      ln_scale, ln_bias, w0t, w1t, wft, wfet, d_pair, ws, q0, P, Nr, Nc, fwd_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  return finish_split<T, RESIDUAL>(pair, row_mask, col_mask, ws, wred, rowred, colred, Nr, Nc,
                                   m0, m1, stream);
}

}  // namespace
}  // namespace fdk

// C interface, for one chunk: rows m0 .. m1 - 1 of the flat [B * Nr] grid
// (pairs m0 * Nc ..). dtype: 1 = bfloat16, the type of every tensor but
// ln_scale and ln_bias (float32); 0 (float32) is refused: it is
// fdk_pair_mlp_bwd_wg's (pair_mlp_bwd_wg.cu). residual: 1 for the edge
// transition (fi, fj, wfe, wfet given), 0 for the plain MLP. Weights are
// row-major [in, out], 16-byte aligned, w0t/w1t/wft/wfet their transposes;
// pair 16-byte aligned. ws: the chunk's workspace of ws_floats floats
// (split_ws_floats of its pairs at least). Adds the chunk's weight, bias and
// LayerNorm gradients to wred [262912] and its column sums to colred [B, Nc,
// 513] (float32, both zeroed before the first chunk), writes its rows of
// rowred [B, Nr, 513] and of d_pair [B, Nr, Nc, 128]. fwd_out (or null):
// [B, Nr, Nc, 128], receives the recompute's LayerNorm output of the chunk's
// pairs, as pair_mlp.cu writes it. Returns a cudaError_t (0 on success).
extern "C" int fdk_pair_mlp_bwd_split(int dtype, int residual, const void* g, const void* pair,
                                      const void* i_term, const void* j_term, const void* fi,
                                      const void* fj, const void* row_mask,
                                      const void* col_mask, const void* w0, const void* b0,
                                      const void* w1, const void* b1, const void* wf,
                                      const void* bf, const void* wfe, const float* ln_scale,
                                      const float* ln_bias, const void* w0t, const void* w1t,
                                      const void* wft, const void* wfet, void* d_pair,
                                      float* ws, long long ws_floats, float* wred,
                                      float* rowred, float* colred, int B, int Nr, int Nc,
                                      int m0, int m1, void* fwd_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDK_ARGS(T)                                                                            \
  (const T*)g, (const T*)pair, (const T*)i_term, (const T*)j_term, (const T*)fi, (const T*)fj, \
      (const T*)row_mask, (const T*)col_mask, (const T*)w0, (const T*)b0, (const T*)w1,        \
      (const T*)b1, (const T*)wf, (const T*)bf, (const T*)wfe, ln_scale, ln_bias,              \
      (const T*)w0t, (const T*)w1t, (const T*)wft, (const T*)wfet, (T*)d_pair, ws, ws_floats,  \
      wred, rowred, colred, B, Nr, Nc, m0, m1, (T*)fwd_out, s
  // float32 is pair_mlp_bwd_wg.cu's (kernel A on wgmma).
  if (dtype == 1)
    return residual ? fdk::launch_split<__nv_bfloat16, true>(FDK_ARGS(__nv_bfloat16))
                    : fdk::launch_split<__nv_bfloat16, false>(FDK_ARGS(__nv_bfloat16));
#undef FDK_ARGS
  return (int)cudaErrorInvalidValue;
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
