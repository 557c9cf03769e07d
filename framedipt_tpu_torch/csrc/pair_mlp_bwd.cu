// Backward of the fused pair MLP of the edge transition, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/pair_mlp.py:349
// (_pair_mlp_bwd_kernel, reached through fused_pair_mlp_bwd). For a
// [B, Nr, Nc, 128] pair tensor and its cotangent g it recomputes the forward
// of csrc/pair_mlp.cu per pair and back-propagates through the edge mask, the
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
// are 524,288 FLOP a pair, 68.7 GFLOP; against 201 MB of pair, cotangent and
// d_pair. No gradient is summed across blocks
// in place and no float atomic is used: two launches give the same bits.
//
// float32: two kernels and fixed-order sums, per chunk of grid rows (the
// wrapper plans the chunks so that the workspace stays under its cap).
// - Kernel A (split_tile_kernel), one block per 64-pair tile of the chunk's
//   flat pairs, in the forward kernel's shared-memory layout (215 KB, and
//   6 KB of relu decisions). It recomputes the forward through the forward
//   kernel's own code (pair_mlp_tc.cuh: forward_tile; tc_product.cuh: 3xTF32
//   mma.sync, the weight ring; common.cuh's epilogues), so the recompute equals pair_mlp.cu's output
//   bit for bit and the relu masks are the forward's. Then the mask and
//   LayerNorm backward (one warp per 8 pairs), and the input-gradient chain
//   through the same products (mlp_products) on the transposed weights the
//   wrapper lays out, which have the forward weights' shapes:
//   dy1 = (dx Wf^T) . [y1 > 0], dy0 = (dy1 W1^T) . [y0 > 0] by 128-column
//   chunk, d_pair = dy0 W0^T (+ dx Wfe^T). It writes y0, y1, dy1, dy0 and dx
//   ([pairs, 384] / [pairs, 128]) and dem (the mask gradients' yln . g) to
//   the workspace, keeps the recompute's relu decisions as ballot words in
//   shared memory (the chain's epilogues walk the same fragments), and
//   writes one partial of d_b1 | d_bf | d_ln_scale | d_ln_bias per tile.
//   Bound:
//   3 x 137 GFLOP / 495 TFLOP/s = 0.83 ms (3xTF32).
// - Row and column sums (row_sums, col_sums): d_i_term | d_fi | d_row_mask
//   and the column ones, summed from the workspace in index order.
// - Kernel B (wgrad_tc.cuh's wgrad_kernel, shared with the embedder's
//   backward): the four weight gradients as one split-K GEMM on the tensor
//   cores. The outputs are cut into 128 x 128 tiles (3 of
//   d_w0, 9 of d_w1, 3 of d_wf, 1 of d_wfe) and the chunk's pairs into
//   kSlices contiguous slices: 16 x 8 = 128 blocks, one wave on 132 SMs.
//   Each block sums its slice with 3xTF32 mma.sync (mma.cuh: operands split
//   into TF32 hi + lo in registers, each 32-deep step summed into a zeroed
//   fragment and added with round-to-nearest, since the tensor cores
//   truncate), its operands staged by cp.async through a four-stage ring in
//   shared memory ([pairs, 128] row blocks; A enters transposed, read as
//   scalars, conflict-free), and writes its partial. Bound: 3 x 68.7 GFLOP /
//   495 TFLOP/s = 0.42 ms.
// - A second pass (common.cuh's sum_partials) adds the slices' partials in
//   slice order, and the tiles' vector partials in tile order (32 at a
//   time, then the groups), to the outputs, chunk after chunk.
// The whole float32 call: 206 GFLOP, 1.25 ms at the 3xTF32 rate; the
// workspace traffic (~1.9 GB written and read back) takes 0.57 ms at the
// HBM rate.
//
// bf16: the persistent kernel below (pair_mlp_bwd_kernel), products on the
// CUDA cores in float32.
// - Persistent blocks, one per SM (gridDim.x, chosen by the wrapper), walk
//   the tiles of 4 rows x 8 columns of pairs in a fixed order. Each block
//   owns one float32 partial set of the weight, bias and LayerNorm
//   gradients in global memory (262,912 floats); each thread owns fixed
//   elements of it and adds each tile's contribution to them
//   (read-modify-write, first tile: write).
// - Each tile writes its partial sums over its 8 columns to a row-partial
//   buffer [B, Nr, Nc/8, 513] (d_i_term | d_fi | d_row_mask) and over its 4
//   rows to a column-partial buffer [B, Nc, Nr/4, 513].
// - A second kernel sums every partial buffer over its partial index in
//   order.
// - Per tile, shared memory holds the pair tile X, y0 and y1 (each
//   32 x 384), the pre-norm output (later dx in float32) and dx rounded to
//   T: 196 KB, one block per SM. dy1 overwrites y1 and dy0 overwrites y0
//   once the weight gradients that read them are taken.
// - It recomputes the forward on the CUDA cores in its own k order, so the
//   recompute and the forward kernel differ by rounding (a bf16 sum can
//   round to the other side, one bf16 step). The gradients are those of the
//   recompute.
//
// Padded pairs (past the grid) contribute nothing. Masked pairs keep their
// contribution: the mask gradients read yln . g there.
#include "pair_mlp_tc.cuh"
#include "wgrad_tc.cuh"

namespace fdk {
namespace {

constexpr int kTI = 4, kTJ = 8, kP = kTI * kTJ;  // pairs of a tile
constexpr int LDX = C_IN + 4, LDH = HID + 4;
constexpr int kWarps = kThreads / 32;
// Offsets of the per-block partial set (floats); mirrored in
// model/kernels/pair_mlp.py (_W_PARTS).
constexpr int OFF_W0 = 0, OFF_W1 = OFF_W0 + C_IN * HID, OFF_WF = OFF_W1 + HID * HID,
              OFF_B1 = OFF_WF + HID * C_OUT, OFF_BF = OFF_B1 + HID, OFF_LNS = OFF_BF + C_OUT,
              OFF_LNB = OFF_LNS + C_OUT, OFF_WFE = OFF_LNB + C_OUT,
              kWParts = OFF_WFE + C_IN * C_OUT;
constexpr int kRowPart = HID + C_OUT + 1;  // d_i_term | d_fi | d_mask

struct BwdTile {
  int row[kP];  // b * Nr + i (clamped in range)
  int col[kP];  // b * Nc + j (clamped in range)
  int valid[kP];
  float rmask[kP], cmask[kP], emask[kP], dem[kP];
};

constexpr size_t kSmemFloats = (size_t)kP * (3 * LDX + 2 * LDH) + 2 * (size_t)kKc * 128 +
                               (size_t)kWarps * 3 * C_OUT;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float) + sizeof(BwdTile);

template <typename T, bool RESIDUAL>
__global__ void __launch_bounds__(kThreads, 1)
pair_mlp_bwd_kernel(const T* __restrict__ g, const T* __restrict__ pair,
                    const T* __restrict__ i_term, const T* __restrict__ j_term,
                    const T* __restrict__ fi, const T* __restrict__ fj,
                    const T* __restrict__ row_mask, const T* __restrict__ col_mask,
                    const T* __restrict__ w0, const T* __restrict__ b0,
                    const T* __restrict__ w1, const T* __restrict__ b1,
                    const T* __restrict__ wf, const T* __restrict__ bf,
                    const T* __restrict__ wfe, const float* __restrict__ ln_scale,
                    const float* __restrict__ ln_bias, const T* __restrict__ w0t,
                    const T* __restrict__ w1t, const T* __restrict__ wft,
                    const T* __restrict__ wfet, T* __restrict__ d_pair,
                    float* __restrict__ wpart, float* __restrict__ rowpart,
                    float* __restrict__ colpart, int B, int Nr, int Nc, int n_ti, int n_tj) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;              // [kP][LDX] pair tile
  float* Y0 = X + kP * LDX;     // [kP][LDH] y0, later dy0
  float* Y1 = Y0 + kP * LDH;    // [kP][LDH] y1, later dy1
  float* O = Y1 + kP * LDH;     // [kP][LDX] pre-norm output, later dx (float32)
  float* DX = O + kP * LDX;     // [kP][LDX] dx rounded to T
  float* Ws = DX + kP * LDX;    // [2][kKc][128] weight staging
  float* Red = Ws + 2 * kKc * 128;  // [kWarps][3][C_OUT] channel sums
  BwdTile& bt = *reinterpret_cast<BwdTile*>(Red + kWarps * 3 * C_OUT);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  float* wp = wpart + (size_t)blockIdx.x * kWParts;
  const long long per_b = (long long)n_ti * n_tj;
  const long long n_tiles = (long long)B * per_b;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == blockIdx.x;
    const int b = (int)(tile / per_b);
    const int ti = (int)((tile - b * per_b) / n_tj), tj = (int)(tile - b * per_b - (long long)ti * n_tj);
    const int i0 = ti * kTI, j0 = tj * kTJ;
    if (tid < kP) {
      const int i = i0 + tid / kTJ, j = j0 + tid % kTJ;
      const bool v = i < Nr && j < Nc;
      bt.valid[tid] = v;
      bt.row[tid] = b * Nr + min(i, Nr - 1);
      bt.col[tid] = b * Nc + min(j, Nc - 1);
      const float rm = v ? ld<T>(row_mask + b * Nr + i) : 0.f;
      const float cm = v ? ld<T>(col_mask + b * Nc + j) : 0.f;
      bt.rmask[tid] = rm;
      bt.cmask[tid] = cm;
      bt.emask[tid] = rnd<T>(rm * cm);  // the edge mask in T, as the forward
    }
    for (int idx = tid; idx < kP * C_IN; idx += kThreads) {
      const int r = idx / C_IN, c = idx - r * C_IN;
      const int i = i0 + r / kTJ, j = j0 + r % kTJ;
      X[r * LDX + c] =
          (i < Nr && j < Nc) ? ld<T>(pair + ((size_t)(b * Nr + i) * Nc + j) * C_IN + c) : 0.f;
    }
    __syncthreads();

    // ---- forward recompute, through csrc/pair_mlp.cu's epilogues -------
    for (int cb = 0; cb < HID / 128; ++cb) {
      float acc[2][8];
      zero(acc);
      tile_gemm<T, 128, 2>(X, LDX, C_IN, w0, HID, cb * 128, Ws, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ty * 2 + i, prow = bt.row[r], pcol = bt.col[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = cb * 128 + tile_col(j, tx);
          Y0[r * LDH + c] = pair_y0<T>(acc[i][j], ld<T>(i_term + (size_t)prow * HID + c),
                                       ld<T>(j_term + (size_t)pcol * HID + c), ld<T>(b0 + c));
        }
      }
    }
    for (int hc = 0; hc < HID / 128; ++hc) {
      float acc[2][8];
      zero(acc);
      tile_gemm<T, 128, 2>(Y0, LDH, HID, w1, HID, hc * 128, Ws, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = hc * 128 + tile_col(j, tx);
          Y1[(ty * 2 + i) * LDH + c] = pair_y1<T>(acc[i][j], ld<T>(b1 + c));
        }
    }
    {
      float acc[2][8], res[2][8];
      zero(acc);
      zero(res);
      tile_gemm<T, 128, 2>(Y1, LDH, HID, wf, C_OUT, 0, Ws, acc);
      if (RESIDUAL) tile_gemm<T, 128, 2>(X, LDX, C_IN, wfe, C_OUT, 0, Ws, res);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ty * 2 + i, prow = bt.row[r], pcol = bt.col[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tile_col(j, tx);
          O[r * LDX + c] =
              pair_out<T, RESIDUAL>(acc[i][j], res[i][j], fi, fj, prow, pcol, c, ld<T>(bf + c));
        }
      }
    }
    __syncthreads();

    // ---- mask and LayerNorm backward, one warp per 4 pairs ---------------
    {
      float sl[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
      float sf[4] = {0.f, 0.f, 0.f, 0.f};
      for (int rr = 0; rr < kP / kWarps; ++rr) {
        const int r = warp * (kP / kWarps) + rr;
        if (!bt.valid[r]) {  // warp-uniform: a padded pair contributes 0
#pragma unroll
          for (int q = 0; q < 4; ++q) O[r * LDX + lane + 32 * q] = DX[r * LDX + lane + 32 * q] = 0.f;
          if (lane == 0) bt.dem[r] = 0.f;
          continue;
        }
        const int i = i0 + r / kTJ, j = j0 + r % kTJ;
        const T* gp = g + ((size_t)(b * Nr + i) * Nc + j) * C_OUT;
        float xc[4], s = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xc[q] = O[r * LDX + lane + 32 * q];
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
        const float em = bt.emask[r];
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
          O[r * LDX + lane + 32 * q] = dx;
          DX[r * LDX + lane + 32 * q] = rnd<T>(dx);
        }
        if (lane == 0) bt.dem[r] = dem;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        Red[(warp * 3 + 0) * C_OUT + lane + 32 * q] = sl[q];
        Red[(warp * 3 + 1) * C_OUT + lane + 32 * q] = sb[q];
        Red[(warp * 3 + 2) * C_OUT + lane + 32 * q] = sf[q];
      }
    }
    __syncthreads();

    // Grid sums of d_ln_scale, d_ln_bias, d_bf; row and column partials of
    // d_fi, d_fj and the mask gradients.
    if (tid < C_OUT) {
      const int offs[3] = {OFF_LNS, OFF_LNB, OFF_BF};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += Red[(w * 3 + k) * C_OUT + tid];
        add_part(wp + offs[k] + tid, s, first);
      }
    }
    for (int idx = tid; idx < kTI * C_OUT; idx += kThreads) {
      const int ri = idx / C_OUT, c = idx - ri * C_OUT, i = i0 + ri;
      if (i >= Nr) continue;
      float s = 0.f;
      for (int rj = 0; rj < kTJ; ++rj) s += O[(ri * kTJ + rj) * LDX + c];
      rowpart[((size_t)(b * Nr + i) * n_tj + tj) * kRowPart + HID + c] = s;
    }
    for (int idx = tid; idx < kTJ * C_OUT; idx += kThreads) {
      const int rj = idx / C_OUT, c = idx - rj * C_OUT, j = j0 + rj;
      if (j >= Nc) continue;
      float s = 0.f;
      for (int ri = 0; ri < kTI; ++ri) s += O[(ri * kTJ + rj) * LDX + c];
      colpart[((size_t)(b * Nc + j) * n_ti + ti) * kRowPart + HID + c] = s;
    }
    if (tid < kTI && i0 + tid < Nr) {
      float s = 0.f;
      for (int rj = 0; rj < kTJ; ++rj) s += bt.dem[tid * kTJ + rj] * bt.cmask[tid * kTJ + rj];
      rowpart[((size_t)(b * Nr + i0 + tid) * n_tj + tj) * kRowPart + HID + C_OUT] = s;
    }
    if (tid >= 32 && tid < 32 + kTJ && j0 + tid - 32 < Nc) {
      const int rj = tid - 32;
      float s = 0.f;
      for (int ri = 0; ri < kTI; ++ri) s += bt.dem[ri * kTJ + rj] * bt.rmask[ri * kTJ + rj];
      colpart[((size_t)(b * Nc + j0 + rj) * n_ti + ti) * kRowPart + HID + C_OUT] = s;
    }

    // ---- final projection: d_wf, d_wfe; dy1 = (dx @ Wf^T) * relu'(y1) ----
    wgrad<8, kP>(Y1, LDH, HID, DX, LDX, C_OUT, wp + OFF_WF, first);
    if (RESIDUAL) wgrad<8, kP>(X, LDX, C_IN, DX, LDX, C_OUT, wp + OFF_WFE, first);
    for (int hc = 0; hc < HID / 128; ++hc) {
      float acc[2][8];
      zero(acc);
      // Its first barrier also orders every wgrad read of y1 before the
      // overwrite below.
      tile_gemm<T, 128, 2>(DX, LDX, C_OUT, wft, HID, hc * 128, Ws, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* y = Y1 + (ty * 2 + i) * LDH + hc * 128 + tile_col(j, tx);
          *y = *y > 0.f ? rnd<T>(acc[i][j]) : 0.f;
        }
    }
    __syncthreads();

    // ---- second layer: d_b1, d_w1; dy0 = (dy1 @ W1^T) * relu'(y0) -------
    for (int c = tid; c < HID; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < kP; ++r) s += Y1[r * LDH + c];
      add_part(wp + OFF_B1 + c, s, first);
    }
    wgrad<8, kP>(Y0, LDH, HID, Y1, LDH, HID, wp + OFF_W1, first);
    for (int hc = 0; hc < HID / 128; ++hc) {
      float acc[2][8];
      zero(acc);
      tile_gemm<T, 128, 2>(Y1, LDH, HID, w1t, HID, hc * 128, Ws, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* y = Y0 + (ty * 2 + i) * LDH + hc * 128 + tile_col(j, tx);
          *y = *y > 0.f ? rnd<T>(acc[i][j]) : 0.f;
        }
    }
    __syncthreads();

    // ---- first layer: d_i_term / d_j_term partials, d_w0, d_pair --------
    for (int idx = tid; idx < kTI * HID; idx += kThreads) {
      const int ri = idx / HID, h = idx - ri * HID, i = i0 + ri;
      if (i >= Nr) continue;
      float s = 0.f;
      for (int rj = 0; rj < kTJ; ++rj) s += Y0[(ri * kTJ + rj) * LDH + h];
      rowpart[((size_t)(b * Nr + i) * n_tj + tj) * kRowPart + h] = s;
    }
    for (int idx = tid; idx < kTJ * HID; idx += kThreads) {
      const int rj = idx / HID, h = idx - rj * HID, j = j0 + rj;
      if (j >= Nc) continue;
      float s = 0.f;
      for (int ri = 0; ri < kTI; ++ri) s += Y0[(ri * kTJ + rj) * LDH + h];
      colpart[((size_t)(b * Nc + j) * n_ti + ti) * kRowPart + h] = s;
    }
    wgrad<8, kP>(X, LDX, C_IN, Y0, LDH, HID, wp + OFF_W0, first);
    {
      float acc[2][8], res[2][8];
      zero(acc);
      tile_gemm<T, 128, 2>(Y0, LDH, HID, w0t, C_IN, 0, Ws, acc);
      if (RESIDUAL) {
        zero(res);
        tile_gemm<T, 128, 2>(DX, LDX, C_OUT, wfet, C_IN, 0, Ws, res);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ty * 2 + i;
        if (!bt.valid[r]) continue;
        T* dst = d_pair + ((size_t)(b * Nr + i0 + r / kTJ) * Nc + j0 + r % kTJ) * C_IN;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = rnd<T>(acc[i][j]);
          if (RESIDUAL) v = rnd<T>(v + rnd<T>(res[i][j]));
          dst[tile_col(j, tx)] = st<T>(v);
        }
      }
    }
    __syncthreads();  // the next tile overwrites X and the tile record
  }
}

template <typename T, bool RESIDUAL>
cudaError_t launch(const void* g, const void* pair, const void* i_term, const void* j_term,
                   const void* fi, const void* fj, const void* row_mask, const void* col_mask,
                   const void* w0, const void* b0, const void* w1, const void* b1,
                   const void* wf, const void* bf, const void* wfe, const float* ln_scale,
                   const float* ln_bias, const void* w0t, const void* w1t, const void* wft,
                   const void* wfet, void* d_pair, float* wpart, float* rowpart,
                   float* colpart, float* wred, float* rowred, float* colred, int B, int Nr,
                   int Nc, int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(pair_mlp_bwd_kernel<T, RESIDUAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  if ((long long)B * Nr * Nc == 0 || blocks <= 0) return cudaErrorInvalidValue;
  const int n_ti = (Nr + kTI - 1) / kTI, n_tj = (Nc + kTJ - 1) / kTJ;
  pair_mlp_bwd_kernel<T, RESIDUAL><<<blocks, kThreads, kSmemBytes, stream>>>(
      (const T*)g, (const T*)pair, (const T*)i_term, (const T*)j_term, (const T*)fi,
      (const T*)fj, (const T*)row_mask, (const T*)col_mask, (const T*)w0, (const T*)b0,
      (const T*)w1, (const T*)b1, (const T*)wf, (const T*)bf, (const T*)wfe, ln_scale, ln_bias,
      (const T*)w0t, (const T*)w1t, (const T*)wft, (const T*)wfet, (T*)d_pair, wpart, rowpart,
      colpart, B, Nr, Nc, n_ti, n_tj);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // Without the residual terms the d_wfe partials are never written: not summed.
  err = reduce_partials(wpart, wred, 1, blocks, RESIDUAL ? kWParts : OFF_WFE, kWParts, stream);
  if (err != cudaSuccess) return err;
  err = reduce_partials(rowpart, rowred, (long long)B * Nr, n_tj, kRowPart, kRowPart, stream);
  if (err != cudaSuccess) return err;
  return reduce_partials(colpart, colred, (long long)B * Nc, n_ti, kRowPart, kRowPart, stream);
}


// ---- float32: kernel A, the row and column sums, kernel B ----------------

constexpr int kVec = HID + 3 * C_OUT;     // d_b1 | d_bf | d_ln_scale | d_ln_bias
constexpr int kGroup = 32;                // tile partials summed 32 at a time
constexpr int kSlices = 8;                // K slices of kernel B
static_assert(OFF_B1 + kVec == OFF_WFE, "the vector sums sit between d_wf and d_wfe");
static_assert(kBlock == kThreads, "kernel A runs common.cuh's LayerNorm with its block");

// A chunk's workspace (float32), in this order: y0, y1, dy1, dy0 [P, 384],
// dx [P, 128], kernel B's partials [kSlices, kWParts], the tiles' vector
// partials [groups * kGroup, kVec], their group sums [groups, kVec], dem [P].
// Mirrored in model/kernels/pair_mlp.py (split_workspace_floats).
struct SplitWs {
  float *y0, *y1, *dy1, *dy0, *dx, *wpart, *vpart, *vmid, *dem;
};

inline long long split_tiles(long long P) { return (P + kRows - 1) / kRows; }
inline long long split_groups(long long P) { return (split_tiles(P) + kGroup - 1) / kGroup; }

inline long long split_ws_floats(long long P) {
  return P * (4 * HID + C_OUT + 1) + (long long)kSlices * kWParts +
         (split_groups(P) * kGroup + split_groups(P)) * kVec;
}

inline SplitWs split_ws(float* ws, long long P) {
  SplitWs w;
  w.y0 = ws;
  w.y1 = w.y0 + P * HID;
  w.dy1 = w.y1 + P * HID;
  w.dy0 = w.dy1 + P * HID;
  w.dx = w.dy0 + P * HID;
  w.wpart = w.dx + P * C_OUT;
  w.vpart = w.wpart + (long long)kSlices * kWParts;
  w.vmid = w.vpart + split_groups(P) * kGroup * kVec;
  w.dem = w.vmid + split_groups(P) * kVec;
  return w;
}

constexpr size_t kASmemBytes = Smem<float>::kBytes + sizeof(uint32_t) * 2 * (HID / NC) * kMaskWords;
static_assert(kASmemBytes <= 232448, "shared memory of one block");

// Kernel A over pairs q0 .. q0 + P - 1 of the flat [B * Nr * Nc] grid, one
// 64-pair tile a block, in the forward kernel's shared-memory layout. With
// fwd_out, also the recompute's LayerNorm output, as the forward writes it.
template <bool RESIDUAL>
__global__ void __launch_bounds__(kBlock, 1)
split_tile_kernel(const float* __restrict__ g, const float* __restrict__ pair,
                  const float* __restrict__ i_term, const float* __restrict__ j_term,
                  const float* __restrict__ fi, const float* __restrict__ fj,
                  const float* __restrict__ row_mask, const float* __restrict__ col_mask,
                  const float* __restrict__ w0, const float* __restrict__ b0,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ wf, const float* __restrict__ bf,
                  const float* __restrict__ wfe, const float* __restrict__ ln_scale,
                  const float* __restrict__ ln_bias, const float* __restrict__ w0t,
                  const float* __restrict__ w1t, const float* __restrict__ wft,
                  const float* __restrict__ wfet, float* __restrict__ d_pair, SplitWs ws,
                  long long q0, long long P, int Nr, int Nc, float* __restrict__ fwd_out) {
  using L = Smem<float>;
  extern __shared__ __align__(16) float smem[];
  float* X = smem;                   // [64][LDX]  pair tile, then the pre-norm output, then dx
  float* Y0 = X + kRows * L::LDX;    // [64][LDY0] y0, then dy1
  float* Y1 = Y0 + kRows * L::LDY0;  // [64][LDY1] a chunk of y1, then of dy0
  float* stages = Y1 + kRows * L::LDY1;  // [kStages][kKc][kLdw] weight ring
  PairTile& pt = *reinterpret_cast<PairTile*>(stages + kStages * L::kStage);
  uint32_t* M0 = reinterpret_cast<uint32_t*>(&pt + 1);  // relu decisions of y0 (mask_word)
  uint32_t* M1 = M0 + (HID / NC) * kMaskWords;           // and of y1
  constexpr int kTileSlices = RESIDUAL ? kResSlice + kKSlices : kResSlice;

  const MlpStream<float> fwd{{w0, w1, wf, wfe}, stages, kTileSlices};
  for (int s = 0; s < kStages - 1; ++s) fwd.start(s);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long lp0 = (long long)blockIdx.x * kRows, p0 = q0 + lp0, end = q0 + P;
  load_pair_tile<float>(pt, p0, end, Nr, Nc, row_mask, col_mask);
  for (int idx = tid; idx < kRows * C_IN; idx += kBlock) {
    const int r = idx / C_IN, c = idx - r * C_IN;
    X[r * L::LDX + c] = p0 + r < end ? __ldg(pair + (size_t)(p0 + r) * C_IN + c) : 0.f;
  }

  // ---- the forward kernel's recompute; y0 and y1 to the workspace -------
  forward_tile<float, RESIDUAL, true>(X, Y0, Y1, pt, fwd, i_term, j_term, fi, fj, b0, b1, bf,
                                      ws.y0 + lp0 * HID, ws.y1 + lp0 * HID, M0, M1);
  __syncthreads();
  if (fwd_out) {
    layer_norm_store<float>(X, L::LDX, pt, p0, ln_scale, ln_bias, fwd_out);
    __syncthreads();
  }

  // ---- mask and LayerNorm backward, one warp per 8 pairs: X becomes dx ---
  // The channel sums go to the weight ring's memory: the first stream has
  // ended and the second has not started.
  float* Red = stages;  // [kWarps][3][C_OUT]
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
      const float* gp = g + (size_t)(p0 + r) * C_OUT;
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
        const float gq = __ldg(gp + c);
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
        X[r * L::LDX + lane + 32 * q] = dx;
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

  // The tile's d_bf, d_ln_scale, d_ln_bias; dx to the workspace.
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
  store_rows(X, L::LDX, C_OUT, pt, ws.dx + lp0 * C_OUT, C_OUT);
  __syncthreads();  // the channel sums are read: the ring takes the second stream

  // ---- the input-gradient chain, through the same products on W^T ------
  // dy1 = (dx @ Wf^T) * relu'(y1) into Y0, dy0 = (dy1 @ W1^T) * relu'(y0)
  // by chunk into Y1, d_pair = dy0 @ W0^T (+ dx @ Wfe^T); each epilogue
  // walks the fragments the recompute's did, so a lane's relu decision is
  // its bit of the same mask word.
  const MlpStream<float> bwd{{wft, w1t, w0t, wfet}, stages, kTileSlices};
  for (int s = 0; s < kStages - 1; ++s) bwd.start(s);
  float acc_dp[2][kNi][4] = {}, res[2][kNi][4] = {};
  mlp_products<float, RESIDUAL>(
      X, Y0, Y1, bwd,
      [&](int cb, float (&acc)[2][kNi][4]) {
        for_each_elem([&](int r, int c, int mi, int ni, int q) {
          if (q & 1) return;
          c += cb * NC;
          const float2 d = relu_grad(M1, cb, mi, ni, q, acc[mi][ni][q], acc[mi][ni][q + 1]);
          Y0[r * L::LDY0 + c] = d.x;
          Y0[r * L::LDY0 + c + 1] = d.y;
        });
      },
      [&](int hc, float (&acc1)[2][kNi][4]) {
        for_each_elem([&](int r, int c, int mi, int ni, int q) {
          if (q & 1) return;
          const float2 d = relu_grad(M0, hc, mi, ni, q, acc1[mi][ni][q], acc1[mi][ni][q + 1]);
          Y1[r * L::LDY1 + c] = d.x;
          Y1[r * L::LDY1 + c + 1] = d.y;
        });
      },
      [&](int hc) { store_rows(Y1, L::LDY1, NC, pt, ws.dy0 + lp0 * HID + hc * NC, HID); },
      acc_dp, res);
  for_each_elem([&](int r, int c, int mi, int ni, int q) {
    if ((q & 1) || pt.row[r] < 0) return;
    const float v0 = RESIDUAL ? acc_dp[mi][ni][q] + res[mi][ni][q] : acc_dp[mi][ni][q];
    const float v1 = RESIDUAL ? acc_dp[mi][ni][q + 1] + res[mi][ni][q + 1] : acc_dp[mi][ni][q + 1];
    *reinterpret_cast<float2*>(d_pair + (size_t)(p0 + r) * C_IN + c) = make_float2(v0, v1);
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

// d_i_term | d_fi | d_row_mask of the chunk's rows m0 .. m0 + rows - 1 (a
// row lies in one chunk), each a sum over j in order.
__global__ void row_sums(const float* __restrict__ dy0, const float* __restrict__ dx,
                         const float* __restrict__ dem, const float* __restrict__ col_mask,
                         float* __restrict__ rowred, int m0, int rows, int Nr, int Nc) {
  const long long total = (long long)rows * kRowPart;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int lr = (int)(idx / kRowPart), c = (int)(idx - (long long)lr * kRowPart);
    const int m = m0 + lr, b = m / Nr;
    const size_t base = (size_t)lr * Nc;
    // Unrolled so that several loads are in flight; the adds stay in order.
    float s = 0.f;
    if (c < HID) {
#pragma unroll 8
      for (int j = 0; j < Nc; ++j) s += dy0[(base + j) * HID + c];
    } else if (c < HID + C_OUT) {
#pragma unroll 8
      for (int j = 0; j < Nc; ++j) s += dx[(base + j) * C_OUT + c - HID];
    } else {
      for (int j = 0; j < Nc; ++j) s += dem[base + j] * __ldg(col_mask + (size_t)b * Nc + j);
    }
    rowred[(size_t)m * kRowPart + c] = s;
  }
}

// d_j_term | d_fj | d_col_mask over the chunk's rows m0 .. m1 - 1 of the
// batches b_lo .. b_lo + nb - 1, each a sum over i in order, added to
// colred (the chunks run in order).
__global__ void col_sums(const float* __restrict__ dy0, const float* __restrict__ dx,
                         const float* __restrict__ dem, const float* __restrict__ row_mask,
                         float* __restrict__ colred, int m0, int m1, int b_lo, int nb, int Nr,
                         int Nc) {
  const long long total = (long long)nb * Nc * kRowPart;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int bj = (int)(idx / kRowPart), c = (int)(idx - (long long)bj * kRowPart);
    const int b = b_lo + bj / Nc, j = bj % Nc;
    const int lo = max(m0, b * Nr), hi = min(m1, (b + 1) * Nr);
    float s = 0.f;
    const size_t p0 = (size_t)(lo - m0) * Nc + j;
    if (c < HID) {
#pragma unroll 8
      for (int m = lo; m < hi; ++m) s += dy0[(p0 + (size_t)(m - lo) * Nc) * HID + c];
    } else if (c < HID + C_OUT) {
#pragma unroll 8
      for (int m = lo; m < hi; ++m) s += dx[(p0 + (size_t)(m - lo) * Nc) * C_OUT + c - HID];
    } else {
      for (int m = lo; m < hi; ++m) s += dem[p0 + (size_t)(m - lo) * Nc] * __ldg(row_mask + m);
    }
    float* dst = colred + ((size_t)b * Nc + j) * kRowPart + c;
    *dst += s;
  }
}

// One chunk, rows m0 .. m1 - 1 of the flat [B * Nr] grid.
template <bool RESIDUAL>
cudaError_t launch_split(const float* g, const float* pair, const float* i_term,
                         const float* j_term, const float* fi, const float* fj,
                         const float* row_mask, const float* col_mask, const float* w0,
                         const float* b0, const float* w1, const float* b1, const float* wf,
                         const float* bf, const float* wfe, const float* ln_scale,
                         const float* ln_bias, const float* w0t, const float* w1t,
                         const float* wft, const float* wfet, float* d_pair, float* wsp,
                         long long ws_floats, float* wred, float* rowred, float* colred, int B,
                         int Nr, int Nc, int m0, int m1, float* fwd_out, cudaStream_t stream) {
  if (m0 < 0 || m1 <= m0 || m1 > B * Nr || Nc <= 0) return cudaErrorInvalidValue;
  const long long q0 = (long long)m0 * Nc, P = (long long)(m1 - m0) * Nc;
  if (split_ws_floats(P) > ws_floats) return cudaErrorInvalidValue;
  const SplitWs ws = split_ws(wsp, P);
  const long long tiles = split_tiles(P), groups = split_groups(P);
  cudaError_t err;

  // Kernel A; the tile partials past the last tile are zero.
  if ((err = cudaFuncSetAttribute(split_tile_kernel<RESIDUAL>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kASmemBytes)) != cudaSuccess)
    return err;
  if ((err = cudaMemsetAsync(ws.vpart + tiles * kVec, 0,
                             sizeof(float) * (groups * kGroup - tiles) * kVec, stream)) !=
      cudaSuccess)
    return err;
  split_tile_kernel<RESIDUAL><<<(unsigned)tiles, kBlock, kASmemBytes, stream>>>(
      g, pair, i_term, j_term, fi, fj, row_mask, col_mask, w0, b0, w1, b1, wf, bf, wfe,
      ln_scale, ln_bias, w0t, w1t, wft, wfet, d_pair, ws, q0, P, Nr, Nc, fwd_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // Row and column sums.
  row_sums<<<grid_of((long long)(m1 - m0) * kRowPart), kThreads, 0, stream>>>(
      ws.dy0, ws.dx, ws.dem, col_mask, rowred, m0, m1 - m0, Nr, Nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int b_lo = m0 / Nr, nb = (m1 - 1) / Nr - b_lo + 1;
  col_sums<<<grid_of((long long)nb * Nc * kRowPart), kThreads, 0, stream>>>(
      ws.dy0, ws.dx, ws.dem, row_mask, colred, m0, m1, b_lo, nb, Nr, Nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // Kernel B.
  WJobs jobs;
  int n = 0;
  const float* pc = pair + q0 * C_IN;
  for (int c = 0; c < HID / 128; ++c)  // d_w0 = pair^T dy0
    jobs.job[n++] = {pc, ws.dy0 + c * 128, C_IN, HID, OFF_W0 + c * 128, HID};
  for (int r = 0; r < HID / 128; ++r)  // d_w1 = y0^T dy1
    for (int c = 0; c < HID / 128; ++c)
      jobs.job[n++] = {ws.y0 + r * 128, ws.dy1 + c * 128, HID, HID,
                       OFF_W1 + r * 128 * HID + c * 128, HID};
  for (int r = 0; r < HID / 128; ++r)  // d_wf = y1^T dx
    jobs.job[n++] = {ws.y1 + r * 128, ws.dx, HID, C_OUT, OFF_WF + r * 128 * C_OUT, C_OUT};
  if (RESIDUAL) jobs.job[n++] = {pc, ws.dx, C_IN, C_OUT, OFF_WFE, C_OUT};  // d_wfe = pair^T dx
  if ((err = launch_wgrad(jobs, n, kSlices, ws.wpart, kWParts, P, stream)) != cudaSuccess)
    return err;

  // Fixed-order sums into the outputs.
  if ((err = reduce_partials(ws.wpart, wred, 1, kSlices, OFF_B1, kWParts, stream, true)) !=
      cudaSuccess)
    return err;
  if (RESIDUAL &&
      (err = reduce_partials(ws.wpart + OFF_WFE, wred + OFF_WFE, 1, kSlices, C_IN * C_OUT,
                             kWParts, stream, true)) != cudaSuccess)
    return err;
  if ((err = reduce_partials(ws.vpart, ws.vmid, groups, kGroup, kVec, kVec, stream)) !=
      cudaSuccess)
    return err;
  return reduce_partials(ws.vmid, wred + OFF_B1, 1, (int)groups, kVec, kVec, stream, true);
}

}  // namespace
}  // namespace fdk

// C interface of the bf16 kernel. residual: 1 for the edge transition (fi,
// fj, wfe, wfet given), 0 for the plain MLP. Weights are row-major [in, out],
// w0t/w1t/wft/wfet their transposes. Scratch (float32, from the wrapper):
// wpart [blocks, 262912], rowpart [B, Nr, ceil(Nc/8), 513], colpart [B, Nc,
// ceil(Nr/4), 513]; outputs wred [262912], rowred [B, Nr, 513], colred [B,
// Nc, 513], d_pair [B, Nr, Nc, 128]. blocks: persistent blocks (one per SM).
// Returns a cudaError_t (0 on success).
extern "C" int fdk_pair_mlp_bwd(int residual, const void* g, const void* pair,
                                const void* i_term, const void* j_term, const void* fi,
                                const void* fj, const void* row_mask, const void* col_mask,
                                const void* w0, const void* b0, const void* w1, const void* b1,
                                const void* wf, const void* bf, const void* wfe,
                                const float* ln_scale, const float* ln_bias, const void* w0t,
                                const void* w1t, const void* wft, const void* wfet,
                                void* d_pair, float* wpart, float* rowpart, float* colpart,
                                float* wred, float* rowred, float* colred, int B, int Nr,
                                int Nc, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDK_ARGS                                                                            \
  g, pair, i_term, j_term, fi, fj, row_mask, col_mask, w0, b0, w1, b1, wf, bf, wfe,         \
      ln_scale, ln_bias, w0t, w1t, wft, wfet, d_pair, wpart, rowpart, colpart, wred, rowred, \
      colred, B, Nr, Nc, blocks, s
  return residual ? fdk::launch<__nv_bfloat16, true>(FDK_ARGS)
                  : fdk::launch<__nv_bfloat16, false>(FDK_ARGS);
#undef FDK_ARGS
}

// C interface of the float32 path, for one chunk: rows m0 .. m1 - 1 of the
// flat [B * Nr] grid (pairs m0 * Nc ..). Pointers as above, all float32;
// ws: the chunk's workspace of ws_floats floats (split_ws_floats of its
// pairs at least). Adds the chunk's weight, bias and LayerNorm gradients to
// wred [262912] and its column sums to colred [B, Nc, 513] (both zeroed
// before the first chunk), writes its rows of rowred [B, Nr, 513] and of
// d_pair. fwd_out (or null): [B, Nr, Nc, 128] float32, receives the
// recompute's LayerNorm output of the chunk's pairs, as pair_mlp.cu writes
// it. Returns a cudaError_t (0 on success).
extern "C" int fdk_pair_mlp_bwd_split(int residual, const float* g, const float* pair,
                                      const float* i_term, const float* j_term,
                                      const float* fi, const float* fj,
                                      const float* row_mask, const float* col_mask,
                                      const float* w0, const float* b0, const float* w1,
                                      const float* b1, const float* wf, const float* bf,
                                      const float* wfe, const float* ln_scale,
                                      const float* ln_bias, const float* w0t,
                                      const float* w1t, const float* wft, const float* wfet,
                                      float* d_pair, float* ws, long long ws_floats,
                                      float* wred, float* rowred, float* colred, int B,
                                      int Nr, int Nc, int m0, int m1, float* fwd_out,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDK_ARGS                                                                          \
  g, pair, i_term, j_term, fi, fj, row_mask, col_mask, w0, b0, w1, b1, wf, bf, wfe,       \
      ln_scale, ln_bias, w0t, w1t, wft, wfet, d_pair, ws, ws_floats, wred, rowred, colred, \
      B, Nr, Nc, m0, m1, fwd_out, s
  return residual ? fdk::launch_split<true>(FDK_ARGS) : fdk::launch_split<false>(FDK_ARGS);
#undef FDK_ARGS
}
