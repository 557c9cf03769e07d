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
// 0.48 ms on the CUDA cores (67 TFLOP/s). Set by operations.
//
// float32: two kernels and fixed-order sums, per chunk of grid rows (the
// wrapper plans the chunks so that the workspace stays under its cap), as
// pair_mlp_bwd.cu's float32 path.
// - Kernel A (emb_split_tile_kernel), one block per 64-pair tile of the
//   chunk's flat pairs, in the forward kernel's shared-memory layout (104 KB,
//   and 2 KB of relu decisions; two blocks an SM). It recomputes the forward
//   through the forward kernel's own code (edge_embedder_tc.cuh:
//   emb_forward_tile; 3xTF32 mma.sync through tc_product.cuh), so the
//   recompute equals edge_embedder.cu's output bit for bit and the relu
//   decisions are the forward's; it keeps them as ballot words in shared
//   memory. Then the mask and LayerNorm backward (one warp per 8 pairs), and
//   the input-gradient chain through the same products on the transposed
//   weights the wrapper lays out: dy1 = (dx W2^T) . [y1 > 0],
//   dy0 = (dy1 W1^T) . [y0 > 0], dm = dy0 W_rel^T. W_rel^T is [128, 64]; the
//   wrapper pads it with zero columns to [128, 128], so dm runs through the
//   same 128-column product as the others (its upper 64 columns are dropped:
//   a tenth more products in kernel A, no second product code). It writes
//   y0, y1, m, dx, dy1, dy0, dm and dem (the mask gradients' yln . g) to the
//   workspace (769 floats a pair, evict-first stores) and one partial a tile
//   of d_b1 | d_b2 | d_ln_scale | d_ln_bias | d_w_dist (each pair adds dy0
//   to its bin's row, the tile's rows in order).
// - Row and column sums (emb_row_sums, emb_col_sums): d_g | d_i_term |
//   d_row_mask and the column ones, summed from the workspace in index order
//   (dm * H_j and dm * G_i formed there).
// - Kernel B (wgrad_tc.cuh's wgrad_kernel, shared with the pair MLP):
//   d_w_rel = m^T dy0 (a 64-row job), d_w1 = y0^T dy1, d_w2 = y1^T dx as one
//   split-K 3xTF32 GEMM, the chunk's pairs in kSlices = 44 slices: 3 x 44 =
//   132 blocks, one wave on 132 SMs.
// - Then common.cuh's sum_partials adds the slices' partials in slice order,
//   and the tiles' vector partials in tile order (32 at a time, then the
//   groups), to the outputs, chunk after chunk.
// The workspace round trip at B=2 N=256 (one chunk; 0.40 GB written, 0.40 GB
// read back by kernel B and 0.20 GB by the sums) takes 0.30 ms at the HBM
// rate. Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py):
// the call 1.22 ms against the CUDA-core kernel's 1.90; kernel A 0.68,
// kernel B 0.26, the sums 0.20, the reductions 0.04.
//
// bf16: the persistent kernel below (edge_embedder_bwd_kernel), products on
// the CUDA cores in float32. Persistent blocks (one per SM) walk tiles of 4
// rows x 8 columns of pairs in a fixed order, each block adds its tiles'
// weight gradients to its own float32 partial set (49,664 floats), each tile
// writes its sums over its 8 columns to a row-partial buffer
// [B, Nr, Nc/8, 193] (d_g | d_i_term | d_row_mask) and over its 4 rows to a
// column-partial buffer [B, Nc, Nr/4, 193] (d_h | d_j_term | d_col_mask), and
// a second kernel sums the partials in order. Per tile, shared memory holds
// the CP product, y0, y1, the pre-norm output (later dm) and dx rounded to
// bf16 (121 KB). dy1 overwrites y1 and dy0 overwrites y0 once the weight
// gradients that read them are taken. It recomputes the forward with fmaf
// in its own k order (common.cuh's epilogues), so its recompute and the
// forward kernel's output differ by rounding; the transposed products read
// W^T, which the wrapper lays out row-major.
//
// Padded pairs (past Nr or Nc) take a zero cotangent, so every contribution
// from them is exactly zero. Masked pairs keep theirs for the mask gradients
// and pass zero into the LayerNorm backward (gm = g * emask).
#include "edge_embedder_tc.cuh"
#include "wgrad_tc.cuh"

namespace fdk {
namespace {

constexpr int kTI = 4, kTJ = 8, kP = kTI * kTJ;  // pairs of a bf16 tile
constexpr int LDM = CP + 4, LDX = C + 4;
constexpr int kWarps = kThreads / 32;
// Offsets of the per-block partial set (floats), and of the gradient sums of
// both paths; mirrored in model/kernels/edge_embedder.py (_W_PARTS).
constexpr int OFF_WREL = 0, OFF_WDIST = OFF_WREL + CP * C, OFF_W1 = OFF_WDIST + MAX_BINS * C,
              OFF_W2 = OFF_W1 + C * C, OFF_B1 = OFF_W2 + C * C, OFF_B2 = OFF_B1 + C,
              OFF_LNS = OFF_B2 + C, OFF_LNB = OFF_LNS + C, kWParts = OFF_LNB + C;
constexpr int kRowPart = CP + C + 1;  // d_g | d_i_term | d_mask (d_h | d_j_term | d_mask)

struct BwdTile {
  int row[kP];  // b * Nr + i (clamped in range)
  int col[kP];  // b * Nc + j (clamped in range)
  int valid[kP];
  int bin[kP];
  float rmask[kP], cmask[kP], emask[kP], dem[kP];
};

constexpr size_t kSmemFloats = (size_t)kP * (LDM + 4 * LDX) + 2 * (size_t)kKc * C +
                               (size_t)kWarps * 3 * C + 2 * MAX_BINS;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float) + sizeof(BwdTile);

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
edge_embedder_bwd_kernel(const T* __restrict__ gout, const T* __restrict__ gf,
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
                         const T* __restrict__ w2t, float* __restrict__ wpart,
                         float* __restrict__ rowpart, float* __restrict__ colpart, int n_bins,
                         int B, int Nr, int Nc, int n_ti, int n_tj) {
  extern __shared__ __align__(16) float smem[];
  float* M = smem;               // [kP][LDM] CP product
  float* Y0 = M + kP * LDM;      // [kP][LDX] y0, later dy0
  float* Y1 = Y0 + kP * LDX;     // [kP][LDX] y1, later dy1
  float* O = Y1 + kP * LDX;      // [kP][LDX] pre-norm output, later dm ([kP][LDM], float32)
  float* DX = O + kP * LDX;      // [kP][LDX] dx rounded to T
  float* Ws = DX + kP * LDX;     // [2][kKc][C] weight staging
  float* Red = Ws + 2 * kKc * C;  // [kWarps][3][C] channel sums
  float* lo = Red + kWarps * 3 * C;  // [MAX_BINS] bin edges
  float* hi = lo + MAX_BINS;
  BwdTile& bt = *reinterpret_cast<BwdTile*>(hi + MAX_BINS);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  float* wp = wpart + (size_t)blockIdx.x * kWParts;
  const long long per_b = (long long)n_ti * n_tj;
  const long long n_tiles = (long long)B * per_b;
  if (tid < n_bins) {
    lo[tid] = lower[tid];
    hi[tid] = upper[tid];
  }

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == blockIdx.x;
    const int b = (int)(tile / per_b);
    const int ti = (int)((tile - b * per_b) / n_tj), tj = (int)(tile - b * per_b - (long long)ti * n_tj);
    const int i0 = ti * kTI, j0 = tj * kTJ;
    if (tid < kP) {
      const int i = i0 + tid / kTJ, j = j0 + tid % kTJ;
      const bool v = i < Nr && j < Nc;
      const int prow = b * Nr + min(i, Nr - 1), pcol = b * Nc + min(j, Nc - 1);
      bt.valid[tid] = v;
      bt.row[tid] = prow;
      bt.col[tid] = pcol;
      const float rm = v ? ld<T>(row_mask + prow) : 0.f;
      const float cm = v ? ld<T>(col_mask + pcol) : 0.f;
      bt.rmask[tid] = rm;
      bt.cmask[tid] = cm;
      bt.emask[tid] = rnd<T>(rm * cm);  // the edge mask in T, as the forward
    }
    __syncthreads();  // also orders the bin edges, on the first tile
    for (int idx = tid; idx < kP * CP; idx += kThreads) {
      const int r = idx / CP, k = idx - r * CP;
      M[r * LDM + k] = bt.valid[r] ? rnd<T>(ld<T>(gf + (size_t)bt.row[r] * CP + k) *
                                            ld<T>(hf + (size_t)bt.col[r] * CP + k))
                                   : 0.f;
    }
    if (tid < kP)
      bt.bin[tid] = bt.valid[tid] ? pair_bin(pos_r + (size_t)bt.row[tid] * 3,
                                             pos_c + (size_t)bt.col[tid] * 3, lo, hi, n_bins)
                                  : -1;
    __syncthreads();

    // ---- forward recompute, in csrc/edge_embedder.cu's order --------------
    {
      float acc[2][8];
      zero(acc);
      tile_gemm<T, C, 2>(M, LDM, CP, w_rel, C, 0, Ws, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ty * 2 + i, prow = bt.row[r], pcol = bt.col[r], bn = bt.bin[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tile_col(j, tx);
          Y0[r * LDX + c] = emb_y0<T>(acc[i][j], bn, w_dist, c, ld<T>(i_term + (size_t)prow * C + c),
                                      ld<T>(j_term + (size_t)pcol * C + c), ld<T>(b0 + c));
        }
      }
    }
    {
      float acc[2][8];
      zero(acc);
      tile_gemm<T, C, 2>(Y0, LDX, C, w1, C, 0, Ws, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tile_col(j, tx);
          Y1[(ty * 2 + i) * LDX + c] = pair_y1<T>(acc[i][j], ld<T>(b1 + c));
        }
    }
    {
      float acc[2][8];
      zero(acc);
      tile_gemm<T, C, 2>(Y1, LDX, C, w2, C, 0, Ws, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tile_col(j, tx);
          O[(ty * 2 + i) * LDX + c] = emb_out<T>(acc[i][j], ld<T>(b2 + c));
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
          for (int q = 0; q < 4; ++q) DX[r * LDX + lane + 32 * q] = 0.f;
          if (lane == 0) bt.dem[r] = 0.f;
          continue;
        }
        const int i = i0 + r / kTJ, j = j0 + r % kTJ;
        const T* gp = gout + ((size_t)(b * Nr + i) * Nc + j) * C;
        float xc[4], s = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xc[q] = O[r * LDX + lane + 32 * q];
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
        m1 = warp_sum(m1) / C;
        m2 = warp_sum(m2) / C;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float dx = (dxh[q] - m1 - xh[q] * m2) * inv;
          sf[q] += dx;
          DX[r * LDX + lane + 32 * q] = rnd<T>(dx);
        }
        if (lane == 0) bt.dem[r] = dem;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        Red[(warp * 3 + 0) * C + lane + 32 * q] = sl[q];
        Red[(warp * 3 + 1) * C + lane + 32 * q] = sb[q];
        Red[(warp * 3 + 2) * C + lane + 32 * q] = sf[q];
      }
    }
    __syncthreads();

    // Grid sums of d_ln_scale, d_ln_bias, d_b2; row and column partials of
    // the mask gradients.
    if (tid < C) {
      const int offs[3] = {OFF_LNS, OFF_LNB, OFF_B2};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += Red[(w * 3 + k) * C + tid];
        add_part(wp + offs[k] + tid, s, first);
      }
    }
    if (tid < kTI && i0 + tid < Nr) {
      float s = 0.f;
      for (int rj = 0; rj < kTJ; ++rj) s += bt.dem[tid * kTJ + rj] * bt.cmask[tid * kTJ + rj];
      rowpart[((size_t)(b * Nr + i0 + tid) * n_tj + tj) * kRowPart + CP + C] = s;
    }
    if (tid >= 32 && tid < 32 + kTJ && j0 + tid - 32 < Nc) {
      const int rj = tid - 32;
      float s = 0.f;
      for (int ri = 0; ri < kTI; ++ri) s += bt.dem[ri * kTJ + rj] * bt.rmask[ri * kTJ + rj];
      colpart[((size_t)(b * Nc + j0 + rj) * n_ti + ti) * kRowPart + CP + C] = s;
    }

    // ---- third layer: d_w2; dy1 = (dx @ W2^T) * relu'(y1) ---------------
    wgrad<8, kP>(Y1, LDX, C, DX, LDX, C, wp + OFF_W2, first);
    {
      float acc[2][8];
      zero(acc);
      // Its first barrier also orders every wgrad read of y1 before the
      // overwrite below.
      tile_gemm<T, C, 2>(DX, LDX, C, w2t, C, 0, Ws, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* y = Y1 + (ty * 2 + i) * LDX + tile_col(j, tx);
          *y = *y > 0.f ? rnd<T>(acc[i][j]) : 0.f;
        }
    }
    __syncthreads();

    // ---- second layer: d_b1, d_w1; dy0 = (dy1 @ W1^T) * relu'(y0) -------
    if (tid < C) {
      float s = 0.f;
      for (int r = 0; r < kP; ++r) s += Y1[r * LDX + tid];
      add_part(wp + OFF_B1 + tid, s, first);
    }
    wgrad<8, kP>(Y0, LDX, C, Y1, LDX, C, wp + OFF_W1, first);
    {
      float acc[2][8];
      zero(acc);
      tile_gemm<T, C, 2>(Y1, LDX, C, w1t, C, 0, Ws, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* y = Y0 + (ty * 2 + i) * LDX + tile_col(j, tx);
          *y = *y > 0.f ? rnd<T>(acc[i][j]) : 0.f;
        }
    }
    __syncthreads();

    // ---- first layer: d_i_term / d_j_term partials, d_w_rel, d_w_dist, dm --
    for (int idx = tid; idx < kTI * C; idx += kThreads) {
      const int ri = idx / C, c = idx - ri * C, i = i0 + ri;
      if (i >= Nr) continue;
      float s = 0.f;
      for (int rj = 0; rj < kTJ; ++rj) s += Y0[(ri * kTJ + rj) * LDX + c];
      rowpart[((size_t)(b * Nr + i) * n_tj + tj) * kRowPart + CP + c] = s;
    }
    for (int idx = tid; idx < kTJ * C; idx += kThreads) {
      const int rj = idx / C, c = idx - rj * C, j = j0 + rj;
      if (j >= Nc) continue;
      float s = 0.f;
      for (int ri = 0; ri < kTI; ++ri) s += Y0[(ri * kTJ + rj) * LDX + c];
      colpart[((size_t)(b * Nc + j) * n_ti + ti) * kRowPart + CP + c] = s;
    }
    wgrad<4, kP>(M, LDM, CP, Y0, LDX, C, wp + OFF_WREL, first);
    // d_w_dist: each thread owns fixed (bin, channel) elements and adds the
    // tile's pairs in that bin in order (a warp's elements share one bin).
    for (int e = tid; e < n_bins * C; e += kThreads) {
      const int n = e / C, c = e - n * C;
      float s = first ? 0.f : wp[OFF_WDIST + e];
      for (int p = 0; p < kP; ++p)
        if (bt.bin[p] == n) s += Y0[p * LDX + c];
      wp[OFF_WDIST + e] = s;
    }
    {
      float acc[2][4];
      zero(acc);
      tile_gemm<T, CP, 2>(Y0, LDX, C, w_relt, CP, 0, Ws, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) O[(ty * 2 + i) * LDM + tile_col(j, tx)] = acc[i][j];
    }
    __syncthreads();

    // ---- CP factors: d_g / d_h partials ------------------------------------
    for (int idx = tid; idx < kTI * CP; idx += kThreads) {
      const int ri = idx / CP, k = idx - ri * CP, i = i0 + ri;
      if (i >= Nr) continue;
      float s = 0.f;
      for (int rj = 0; rj < kTJ; ++rj) {
        const int r = ri * kTJ + rj;
        s += O[r * LDM + k] * ld<T>(hf + (size_t)bt.col[r] * CP + k);
      }
      rowpart[((size_t)(b * Nr + i) * n_tj + tj) * kRowPart + k] = s;
    }
    for (int idx = tid; idx < kTJ * CP; idx += kThreads) {
      const int rj = idx / CP, k = idx - rj * CP, j = j0 + rj;
      if (j >= Nc) continue;
      float s = 0.f;
      for (int ri = 0; ri < kTI; ++ri) {
        const int r = ri * kTJ + rj;
        s += O[r * LDM + k] * ld<T>(gf + (size_t)bt.row[r] * CP + k);
      }
      colpart[((size_t)(b * Nc + j) * n_ti + ti) * kRowPart + k] = s;
    }
    __syncthreads();  // the next tile overwrites the tile record and M
  }
}

template <typename T>
cudaError_t launch(const void* grad, const void* g, const void* h, const float* pos_r,
                   const float* pos_c, const void* i_term, const void* j_term,
                   const void* row_mask, const void* col_mask, const void* w_rel,
                   const void* w_dist, const float* lower, const float* upper, const void* b0,
                   const void* w1, const void* b1, const void* w2, const void* b2,
                   const float* ln_scale, const float* ln_bias, const void* w_relt,
                   const void* w1t, const void* w2t, float* wpart, float* rowpart,
                   float* colpart, float* wred, float* rowred, float* colred, int n_bins, int B,
                   int Nr, int Nc, int blocks, cudaStream_t stream) {
  if (n_bins < 0 || n_bins > MAX_BINS) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(edge_embedder_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  if ((long long)B * Nr * Nc == 0 || blocks <= 0) return cudaErrorInvalidValue;
  const int n_ti = (Nr + kTI - 1) / kTI, n_tj = (Nc + kTJ - 1) / kTJ;
  edge_embedder_bwd_kernel<T><<<blocks, kThreads, kSmemBytes, stream>>>(
      (const T*)grad, (const T*)g, (const T*)h, pos_r, pos_c, (const T*)i_term,
      (const T*)j_term, (const T*)row_mask, (const T*)col_mask, (const T*)w_rel,
      (const T*)w_dist, lower, upper, (const T*)b0, (const T*)w1, (const T*)b1, (const T*)w2,
      (const T*)b2, ln_scale, ln_bias, (const T*)w_relt, (const T*)w1t, (const T*)w2t, wpart,
      rowpart, colpart, n_bins, B, Nr, Nc, n_ti, n_tj);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // d_w_rel and the written d_w_dist rows, then d_w1 .. d_ln_bias.
  err = reduce_partials(wpart, wred, 1, blocks, OFF_WDIST + n_bins * C, kWParts, stream);
  if (err != cudaSuccess) return err;
  err = reduce_partials(wpart + OFF_W1, wred + OFF_W1, 1, blocks, kWParts - OFF_W1, kWParts,
                        stream);
  if (err != cudaSuccess) return err;
  err = reduce_partials(rowpart, rowred, (long long)B * Nr, n_tj, kRowPart, kRowPart, stream);
  if (err != cudaSuccess) return err;
  return reduce_partials(colpart, colred, (long long)B * Nc, n_ti, kRowPart, kRowPart, stream);
}

// ---- float32: kernel A, the row and column sums, kernel B ----------------

constexpr int kGroup = 32;   // tile partials summed 32 at a time
constexpr int kSlices = 44;  // K slices of kernel B: 3 jobs x 44 = 132 blocks
constexpr int kPairFloats = 5 * C + 2 * CP + 1;  // y0 y1 dx dy1 dy0 | m dm | dem
constexpr int kBParts = CP * C + 2 * C * C;      // kernel B's partial set: d_w_rel | d_w1 | d_w2
static_assert(OFF_W2 == OFF_W1 + C * C && OFF_LNB == OFF_B1 + 3 * C, "contiguous sums");

// A tile's vector partial: d_b1 | d_b2 | d_ln_scale | d_ln_bias | d_w_dist.
__host__ __device__ inline int vec_floats(int n_bins) { return (4 + n_bins) * C; }

// A chunk's workspace (float32), in this order: y0, y1 [P, 128], m [P, 64],
// dx, dy1, dy0 [P, 128], dm [P, 64], kernel B's partials [kSlices, kBParts],
// the tiles' vector partials [groups * kGroup, vec], their group sums
// [groups, vec], dem [P]. Mirrored in model/kernels/edge_embedder.py
// (split_workspace_floats).
struct SplitWs {
  float *y0, *y1, *m, *dx, *dy1, *dy0, *dm, *wpart, *vpart, *vmid, *dem;
};

inline long long split_tiles(long long P) { return (P + kRows - 1) / kRows; }
inline long long split_groups(long long P) { return (split_tiles(P) + kGroup - 1) / kGroup; }

inline long long split_ws_floats(long long P, int n_bins) {
  return P * kPairFloats + (long long)kSlices * kBParts +
         (split_groups(P) * kGroup + split_groups(P)) * vec_floats(n_bins);
}

inline SplitWs split_ws(float* ws, long long P, int n_bins) {
  SplitWs w;
  w.y0 = ws;
  w.y1 = w.y0 + P * C;
  w.m = w.y1 + P * C;
  w.dx = w.m + P * CP;
  w.dy1 = w.dx + P * C;
  w.dy0 = w.dy1 + P * C;
  w.dm = w.dy0 + P * C;
  w.wpart = w.dm + P * CP;
  w.vpart = w.wpart + (long long)kSlices * kBParts;
  w.vmid = w.vpart + split_groups(P) * kGroup * vec_floats(n_bins);
  w.dem = w.vmid + split_groups(P) * vec_floats(n_bins);
  return w;
}

// The input-gradient chain's weights in the order its products read them:
// W2^T, W1^T, then W_rel^T padded to [128, 128] (4 slices each).
struct EmbBwdSlices {
  static constexpr int kLayer = C / kKc, kTile = 3 * kLayer;
  const float* w2t;
  const float* w1t;
  const float* w_relt;

  __device__ __forceinline__ const float* slice(int s, int& ldw) const {
    ldw = C;
    const float* w = s < kLayer ? w2t : s < 2 * kLayer ? w1t : w_relt;
    return w + (size_t)(s % kLayer) * kKc * C;
  }
};

using L32 = EmbSmem<float>;
constexpr size_t kASmemBytes = L32::kBytes + sizeof(uint32_t) * 2 * kMaskWords;
static_assert(kASmemBytes + 1024 <= 233472 / 2, "two blocks an SM");
static_assert(kWarps * 3 * C <= L32::STAGES * kStageElems &&
              MAX_BINS * C <= L32::STAGES * kStageElems, "sums in the ring's memory");

// Kernel A over pairs q0 .. q0 + P - 1 of the flat [B * Nr * Nc] grid, one
// 64-pair tile a block. With fwd_out, also the recompute's LayerNorm output,
// as the forward kernel writes it.
__global__ void __launch_bounds__(kBlock, 2)
emb_split_tile_kernel(const float* __restrict__ gout, const float* __restrict__ gf,
                      const float* __restrict__ hf, const float* __restrict__ pos_r,
                      const float* __restrict__ pos_c, const float* __restrict__ i_term,
                      const float* __restrict__ j_term, const float* __restrict__ row_mask,
                      const float* __restrict__ col_mask, const float* __restrict__ w_rel,
                      const float* __restrict__ w_dist, const float* __restrict__ lower,
                      const float* __restrict__ upper, const float* __restrict__ b0,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, const float* __restrict__ b2,
                      const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                      const float* __restrict__ w_relt, const float* __restrict__ w1t,
                      const float* __restrict__ w2t, SplitWs ws, long long q0, long long P,
                      int n_bins, int Nr, int Nc, float* __restrict__ fwd_out) {
  extern __shared__ __align__(16) float smem[];
  const EmbTile<float> et(smem);
  float* X = et.X;    // y0, the pre-norm output, dx, then dy0
  float* Y1 = et.Y1;  // m, y1, dy1, then dm (64 columns)
  const PairTile& pt = *et.pt;
  uint32_t* M0 = reinterpret_cast<uint32_t*>(et.bin + kRows);  // relu decisions of y0
  uint32_t* M1 = M0 + kMaskWords;                               // and of y1

  const EmbStream<float> fwd{{w_rel, w1, w2}, et.stages, EmbSlices<float>::kTile};
  for (int s = 0; s < L32::STAGES - 1; ++s) fwd.start(s);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long lp0 = (long long)blockIdx.x * kRows, p0 = q0 + lp0;
  load_pair_tile<float>(*et.pt, p0, q0 + P, Nr, Nc, row_mask, col_mask);
  if (tid < n_bins) {
    et.lo[tid] = lower[tid];
    et.hi[tid] = upper[tid];
  }
  __syncthreads();

  // ---- the forward kernel's recompute; m, y0, y1 to the workspace --------
  emb_forward_tile<float, true>(
      et, fwd, gf, hf, pos_r, pos_c, i_term, j_term, w_dist, b0, b1, b2, n_bins,
      EmbKeep{ws.m + lp0 * CP, ws.y0 + lp0 * C, ws.y1 + lp0 * C, M0, M1});
  __syncthreads();
  if (fwd_out) {
    layer_norm_store<float>(X, L32::LDX, pt, p0, ln_scale, ln_bias, fwd_out);
    __syncthreads();
  }

  // ---- mask and LayerNorm backward, one warp per 8 pairs: X becomes dx ---
  // The channel sums go to the weight ring's memory: the first stream has
  // ended and the second has not started.
  float* Red = et.stages;  // [kWarps][3][C]
  {
    float sl[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
    float sf[4] = {0.f, 0.f, 0.f, 0.f};
    for (int rr = 0; rr < kRows / kWarps; ++rr) {
      const int r = warp * (kRows / kWarps) + rr;
      if (pt.row[r] < 0) {  // warp-uniform: a pair past the chunk contributes 0
#pragma unroll
        for (int q = 0; q < 4; ++q) X[r * L32::LDX + lane + 32 * q] = 0.f;
        continue;
      }
      const float* gp = gout + (size_t)(p0 + r) * C;
      float xc[4], s = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xc[q] = X[r * L32::LDX + lane + 32 * q];
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
      m1 = warp_sum(m1) / C;
      m2 = warp_sum(m2) / C;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float dx = (dxh[q] - m1 - xh[q] * m2) * inv;
        sf[q] += dx;
        X[r * L32::LDX + lane + 32 * q] = dx;
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

  // The tile's d_b2, d_ln_scale, d_ln_bias; dx to the workspace.
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
  store_rows(X, L32::LDX, C, pt, ws.dx + lp0 * C, C);
  __syncthreads();  // the channel sums are read: the ring takes the second stream

  // ---- the input-gradient chain, through the same products on W^T ------
  // Each epilogue walks the fragments the recompute's did, so a lane's relu
  // decision is its bit of the same mask word. Each product's first barrier
  // orders the previous product's reads of the tile its epilogue overwrites.
  const WeightStream<float, EmbBwdSlices, L32::STAGES> bwd{
      {w2t, w1t, w_relt}, et.stages, EmbBwdSlices::kTile};
  for (int s = 0; s < L32::STAGES - 1; ++s) bwd.start(s);
  int s = 0;
  {  // dy1 = (dx @ W2^T) * relu'(y1), into Y1
    float acc[2][kNi][4] = {};
    product(X, L32::LDX, C, bwd, s, acc);
    for_each_elem([&](int r, int c, int mi, int ni, int q) {
      if (q & 1) return;
      const float2 d = relu_grad(M1, 0, mi, ni, q, acc[mi][ni][q], acc[mi][ni][q + 1]);
      Y1[r * L32::LDX + c] = d.x;
      Y1[r * L32::LDX + c + 1] = d.y;
    });
  }
  {  // dy0 = (dy1 @ W1^T) * relu'(y0), into X
    float acc[2][kNi][4] = {};
    product(Y1, L32::LDX, C, bwd, s, acc);
    for_each_elem([&](int r, int c, int mi, int ni, int q) {
      if (q & 1) return;
      const float2 d = relu_grad(M0, 0, mi, ni, q, acc[mi][ni][q], acc[mi][ni][q + 1]);
      X[r * L32::LDX + c] = d.x;
      X[r * L32::LDX + c + 1] = d.y;
    });
  }
  // dy1 has been whole in Y1 since the first barrier of the W1^T product: to
  // the workspace, and the tile's d_b1 (its rows in order).
  store_rows(Y1, L32::LDX, C, pt, ws.dy1 + lp0 * C, C);
  if (tid < C) {
    float sum = 0.f;
    for (int r = 0; r < kRows; ++r) sum += Y1[r * L32::LDX + tid];
    vp[tid] = sum;
  }
  {  // dm = dy0 @ W_rel^T (the padded columns dropped), into Y1
    float acc[2][kNi][4] = {};
    product(X, L32::LDX, C, bwd, s, acc);
    for_each_elem([&](int r, int c, int mi, int ni, int q) {
      if ((q & 1) || c >= CP) return;
      Y1[r * L32::LDX + c] = acc[mi][ni][q];
      Y1[r * L32::LDX + c + 1] = acc[mi][ni][q + 1];
    });
  }
  __syncthreads();  // dy0 and dm whole; every warp has left the ring

  store_rows(X, L32::LDX, C, pt, ws.dy0 + lp0 * C, C);
  store_rows(Y1, L32::LDX, CP, pt, ws.dm + lp0 * CP, CP);
  // The tile's d_w_dist: thread c adds dy0[r][c] to its pair's bin row, the
  // rows in order, in the ring's memory.
  if (n_bins > 0) {
    float* acc = et.stages;  // [n_bins][C]
    for (int i = tid; i < n_bins * C; i += kBlock) acc[i] = 0.f;
    __syncthreads();
    if (tid < C)
      for (int r = 0; r < kRows; ++r) {
        const int bn = et.bin[r];
        if (bn >= 0) acc[bn * C + tid] += X[r * L32::LDX + tid];
      }
    __syncthreads();
    for (int i = tid; i < n_bins * C; i += kBlock) vp[4 * C + i] = acc[i];
  }
}

// d_g | d_i_term | d_row_mask of the chunk's rows m0 .. m0 + rows - 1 (a row
// lies in one chunk), each a sum over j in order.
__global__ void emb_row_sums(const float* __restrict__ dy0, const float* __restrict__ dm,
                             const float* __restrict__ dem, const float* __restrict__ hf,
                             const float* __restrict__ col_mask, float* __restrict__ rowred,
                             int m0, int rows, int Nr, int Nc) {
  const long long total = (long long)rows * kRowPart;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int lr = (int)(idx / kRowPart), c = (int)(idx - (long long)lr * kRowPart);
    const int m = m0 + lr, b = m / Nr;
    const size_t base = (size_t)lr * Nc;
    // Unrolled so that several loads are in flight; the adds stay in order.
    // Products unfused (__fmul_rn): the plain version rounds them.
    float s = 0.f;
    if (c < CP) {
      const float* hb = hf + (size_t)b * Nc * CP + c;
#pragma unroll 32
      for (int j = 0; j < Nc; ++j) s += __fmul_rn(dm[(base + j) * CP + c], __ldg(hb + (size_t)j * CP));
    } else if (c < CP + C) {
#pragma unroll 32
      for (int j = 0; j < Nc; ++j) s += dy0[(base + j) * C + c - CP];
    } else {
      for (int j = 0; j < Nc; ++j) s += __fmul_rn(dem[base + j], __ldg(col_mask + (size_t)b * Nc + j));
    }
    rowred[(size_t)m * kRowPart + c] = s;
  }
}

// d_h | d_j_term | d_col_mask over the chunk's rows m0 .. m1 - 1 of the
// batches b_lo .. b_lo + nb - 1, each a sum over i in order, added to colred
// (the chunks run in order).
__global__ void emb_col_sums(const float* __restrict__ dy0, const float* __restrict__ dm,
                             const float* __restrict__ dem, const float* __restrict__ gf,
                             const float* __restrict__ row_mask, float* __restrict__ colred,
                             int m0, int m1, int b_lo, int nb, int Nr, int Nc) {
  const long long total = (long long)nb * Nc * kRowPart;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int bj = (int)(idx / kRowPart), c = (int)(idx - (long long)bj * kRowPart);
    const int b = b_lo + bj / Nc, j = bj % Nc;
    const int lo = max(m0, b * Nr), hi = min(m1, (b + 1) * Nr);
    float s = 0.f;
    const size_t p0 = (size_t)(lo - m0) * Nc + j;
    if (c < CP) {
#pragma unroll 32
      for (int m = lo; m < hi; ++m)
        s += __fmul_rn(dm[(p0 + (size_t)(m - lo) * Nc) * CP + c], __ldg(gf + (size_t)m * CP + c));
    } else if (c < CP + C) {
#pragma unroll 32
      for (int m = lo; m < hi; ++m) s += dy0[(p0 + (size_t)(m - lo) * Nc) * C + c - CP];
    } else {
      for (int m = lo; m < hi; ++m)
        s += __fmul_rn(dem[p0 + (size_t)(m - lo) * Nc], __ldg(row_mask + m));
    }
    float* dst = colred + ((size_t)b * Nc + j) * kRowPart + c;
    *dst += s;
  }
}

// One chunk, rows m0 .. m1 - 1 of the flat [B * Nr] grid.
cudaError_t launch_split(const float* grad, const float* g, const float* h, const float* pos_r,
                         const float* pos_c, const float* i_term, const float* j_term,
                         const float* row_mask, const float* col_mask, const float* w_rel,
                         const float* w_dist, const float* lower, const float* upper,
                         const float* b0, const float* w1, const float* b1, const float* w2,
                         const float* b2, const float* ln_scale, const float* ln_bias,
                         const float* w_relt, const float* w1t, const float* w2t, float* wsp,
                         long long ws_floats, float* wred, float* rowred, float* colred,
                         int n_bins, int B, int Nr, int Nc, int m0, int m1, float* fwd_out,
                         cudaStream_t stream) {
  if (n_bins < 0 || n_bins > MAX_BINS) return cudaErrorInvalidValue;
  if (m0 < 0 || m1 <= m0 || m1 > B * Nr || Nc <= 0) return cudaErrorInvalidValue;
  const long long q0 = (long long)m0 * Nc, P = (long long)(m1 - m0) * Nc;
  if (split_ws_floats(P, n_bins) > ws_floats) return cudaErrorInvalidValue;
  const SplitWs ws = split_ws(wsp, P, n_bins);
  const long long tiles = split_tiles(P), groups = split_groups(P);
  const int vec = vec_floats(n_bins);
  cudaError_t err;

  // Kernel A; the tile partials past the last tile are zero.
  if ((err = cudaFuncSetAttribute(emb_split_tile_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kASmemBytes)) != cudaSuccess)
    return err;
  if ((err = cudaMemsetAsync(ws.vpart + tiles * vec, 0,
                             sizeof(float) * (groups * kGroup - tiles) * vec, stream)) !=
      cudaSuccess)
    return err;
  emb_split_tile_kernel<<<(unsigned)tiles, kBlock, kASmemBytes, stream>>>(
      grad, g, h, pos_r, pos_c, i_term, j_term, row_mask, col_mask, w_rel, w_dist, lower,
      upper, b0, w1, b1, w2, b2, ln_scale, ln_bias, w_relt, w1t, w2t, ws, q0, P, n_bins, Nr, Nc,
      fwd_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // Row and column sums.
  emb_row_sums<<<grid_of((long long)(m1 - m0) * kRowPart), kThreads, 0, stream>>>(
      ws.dy0, ws.dm, ws.dem, h, col_mask, rowred, m0, m1 - m0, Nr, Nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int b_lo = m0 / Nr, nb = (m1 - 1) / Nr - b_lo + 1;
  emb_col_sums<<<grid_of((long long)nb * Nc * kRowPart), kThreads, 0, stream>>>(
      ws.dy0, ws.dm, ws.dem, g, row_mask, colred, m0, m1, b_lo, nb, Nr, Nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // Kernel B: d_w_rel = m^T dy0 (64 rows), d_w1 = y0^T dy1, d_w2 = y1^T dx.
  WJobs<float> jobs;
  jobs.job[0] = {ws.m, ws.dy0, CP, C, 0, C, CP};
  jobs.job[1] = {ws.y0, ws.dy1, C, C, CP * C, C};
  jobs.job[2] = {ws.y1, ws.dx, C, C, CP * C + C * C, C};
  if ((err = launch_wgrad(jobs, 3, kSlices, ws.wpart, kBParts, P, stream)) != cudaSuccess)
    return err;

  // Fixed-order sums into the outputs.
  if ((err = reduce_partials(ws.wpart, wred + OFF_WREL, 1, kSlices, CP * C, kBParts, stream,
                             true)) != cudaSuccess)
    return err;
  if ((err = reduce_partials(ws.wpart + CP * C, wred + OFF_W1, 1, kSlices, 2 * C * C, kBParts,
                             stream, true)) != cudaSuccess)
    return err;
  if ((err = reduce_partials(ws.vpart, ws.vmid, groups, kGroup, vec, vec, stream)) != cudaSuccess)
    return err;
  if ((err = reduce_partials(ws.vmid, wred + OFF_B1, 1, (int)groups, 4 * C, vec, stream, true)) !=
      cudaSuccess)
    return err;
  if (n_bins == 0) return cudaSuccess;
  return reduce_partials(ws.vmid + 4 * C, wred + OFF_WDIST, 1, (int)groups, n_bins * C, vec,
                         stream, true);
}

}  // namespace
}  // namespace fdk

// C interface of the bf16 kernel. Coordinates, bin edges and LayerNorm
// parameters are float32, everything else bf16; weights are row-major
// [in, out], w_relt / w1t / w2t their transposes. Scratch (float32, from the
// wrapper): wpart [blocks, 49664], rowpart [B, Nr, ceil(Nc/8), 193], colpart
// [B, Nc, ceil(Nr/4), 193]; outputs wred [49664], rowred [B, Nr, 193],
// colred [B, Nc, 193]. blocks: persistent blocks (one per SM). Returns a
// cudaError_t (0 on success).
extern "C" int fdk_edge_embedder_bwd(
    const void* grad, const void* g, const void* h, const float* pos_r, const float* pos_c,
    const void* i_term, const void* j_term, const void* row_mask, const void* col_mask,
    const void* w_rel, const void* w_dist, const float* lower, const float* upper,
    const void* b0, const void* w1, const void* b1, const void* w2, const void* b2,
    const float* ln_scale, const float* ln_bias, const void* w_relt, const void* w1t,
    const void* w2t, float* wpart, float* rowpart, float* colpart, float* wred, float* rowred,
    float* colred, int n_bins, int B, int Nr, int Nc, int blocks, void* stream) {
  return fdk::launch<__nv_bfloat16>(
      grad, g, h, pos_r, pos_c, i_term, j_term, row_mask, col_mask, w_rel, w_dist, lower, upper,
      b0, w1, b1, w2, b2, ln_scale, ln_bias, w_relt, w1t, w2t, wpart, rowpart, colpart, wred,
      rowred, colred, n_bins, B, Nr, Nc, blocks, static_cast<cudaStream_t>(stream));
}

// C interface of the float32 path, for one chunk: rows m0 .. m1 - 1 of the
// flat [B * Nr] grid (pairs m0 * Nc ..). Pointers as above, all float32, but
// w_relt is W_rel^T padded with zero columns to [128, 128]; weights 16-byte
// aligned. ws: the chunk's workspace of ws_floats floats (split_ws_floats of
// its pairs at least). Adds the chunk's weight, bias and LayerNorm gradients
// to wred [49664] and its column sums to colred [B, Nc, 193] (both zeroed
// before the first chunk), writes its rows of rowred [B, Nr, 193]. fwd_out
// (or null): [B, Nr, Nc, 128] float32, receives the recompute's LayerNorm
// output of the chunk's pairs, as edge_embedder.cu writes it. Returns a
// cudaError_t (0 on success).
extern "C" int fdk_edge_embedder_bwd_split(
    const float* grad, const float* g, const float* h, const float* pos_r, const float* pos_c,
    const float* i_term, const float* j_term, const float* row_mask, const float* col_mask,
    const float* w_rel, const float* w_dist, const float* lower, const float* upper,
    const float* b0, const float* w1, const float* b1, const float* w2, const float* b2,
    const float* ln_scale, const float* ln_bias, const float* w_relt, const float* w1t,
    const float* w2t, float* ws, long long ws_floats, float* wred, float* rowred, float* colred,
    int n_bins, int B, int Nr, int Nc, int m0, int m1, float* fwd_out, void* stream) {
  return fdk::launch_split(grad, g, h, pos_r, pos_c, i_term, j_term, row_mask, col_mask, w_rel,
                           w_dist, lower, upper, b0, w1, b1, w2, b2, ln_scale, ln_bias, w_relt,
                           w1t, w2t, ws, ws_floats, wred, rowred, colred, n_bins, B, Nr, Nc, m0,
                           m1, fwd_out, static_cast<cudaStream_t>(stream));
}
