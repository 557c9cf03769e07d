// Backward of the fused embedder edge branch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/edge_embedder.py
// (_edge_embedder_bwd_kernel, reached through fused_edge_embedder_bwd). For
// the cotangent g [B, Nr, Nc, 128] of csrc/edge_embedder.cu's output it
// recomputes that kernel's forward per pair, through the same epilogues
// (common.cuh, so every relu takes the same side in float32), and
// back-propagates, with m = G_i * H_j (64 wide):
//
//   dem = sum_c yln g                 mask gradients (through yln * emask)
//   gm = g * emask                    LayerNorm backward (float32 statistics)
//   dW2 += y1^T dx2, dy1 = dx2 W2^T * [y1 > 0]
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
//
// Bound on an H100 SXM at B=2 N=256: 81,920 FLOP a pair for the recompute
// and 163,840 for the backward products (dW2, dy1, dW1, dy0: 2 x 128 x 128
// each; dW_rel, dm: 2 x 64 x 128), 245,760 FLOP a pair, 32.2 GFLOP a launch:
// 0.48 ms in float32 on the CUDA cores (67 TFLOP/s), against 33.6 MB of
// float32 cotangent. Set by operations.
//
// Design, as csrc/pair_mlp_bwd.cu: persistent blocks (one per SM) walk tiles
// of 4 rows x 8 columns of pairs in a fixed order, each block adds its tiles'
// weight gradients to its own float32 partial set (49,664 floats), each tile
// writes its sums over its 8 columns to a row-partial buffer
// [B, Nr, Nc/8, 193] (d_g | d_i_term | d_row_mask) and over its 4 rows to a
// column-partial buffer [B, Nc, Nr/4, 193] (d_h | d_j_term | d_col_mask), and
// a second kernel sums the partials in order: no float atomics, two launches
// give the same bits. Per tile, shared memory holds the CP product, y0, y1,
// the pre-norm output (later dm) and dx rounded to T (121 KB). dy1 overwrites
// y1 and dy0 overwrites y0 once the weight gradients that read them are
// taken. Products run on the CUDA cores in float32 (fmaf) for both element
// types; the transposed products read W^T, which the wrapper lays out
// row-major.
// Padded pairs (past Nr or Nc) take a zero cotangent, so every contribution
// from them is exactly zero. Masked pairs keep theirs for the mask gradients
// and pass zero into the LayerNorm backward (gm = g * emask).
#include "common.cuh"

namespace fdk {
namespace {

constexpr int CP = 64, C = 128, MAX_BINS = 64;
constexpr int kTI = 4, kTJ = 8, kP = kTI * kTJ;  // pairs of a tile
constexpr int LDM = CP + 4, LDX = C + 4;
constexpr int kWarps = kThreads / 32;
// Offsets of the per-block partial set (floats); mirrored in
// model/kernels/edge_embedder.py (_W_PARTS).
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

}  // namespace
}  // namespace fdk

// C interface. dtype: 0 = float32, 1 = bfloat16. Coordinates, bin edges and
// LayerNorm parameters are float32; weights are row-major [in, out], w_relt
// / w1t / w2t their transposes. Scratch (float32, from the wrapper): wpart
// [blocks, 49664], rowpart [B, Nr, ceil(Nc/8), 193], colpart
// [B, Nc, ceil(Nr/4), 193]; outputs wred [49664], rowred [B, Nr, 193],
// colred [B, Nc, 193]. blocks: persistent blocks (one per SM). Returns a
// cudaError_t (0 on success).
extern "C" int fdk_edge_embedder_bwd(
    int dtype, const void* grad, const void* g, const void* h, const float* pos_r,
    const float* pos_c, const void* i_term, const void* j_term, const void* row_mask,
    const void* col_mask, const void* w_rel, const void* w_dist, const float* lower,
    const float* upper, const void* b0, const void* w1, const void* b1, const void* w2,
    const void* b2, const float* ln_scale, const float* ln_bias, const void* w_relt,
    const void* w1t, const void* w2t, float* wpart, float* rowpart, float* colpart, float* wred,
    float* rowred, float* colred, int n_bins, int B, int Nr, int Nc, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDK_ARGS                                                                             \
  grad, g, h, pos_r, pos_c, i_term, j_term, row_mask, col_mask, w_rel, w_dist, lower, upper, \
      b0, w1, b1, w2, b2, ln_scale, ln_bias, w_relt, w1t, w2t, wpart, rowpart, colpart, wred, \
      rowred, colred, n_bins, B, Nr, Nc, blocks, s
  if (dtype == 0) return fdk::launch<float>(FDK_ARGS);
  if (dtype == 1) return fdk::launch<__nv_bfloat16>(FDK_ARGS);
#undef FDK_ARGS
  return (int)cudaErrorInvalidValue;
}
