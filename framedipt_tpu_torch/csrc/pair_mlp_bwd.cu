// Backward of the fused pair MLP of the edge transition, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/pair_mlp.py
// (_pair_mlp_bwd_kernel, reached through fused_pair_mlp_bwd). For a
// [B, Nr, Nc, 128] pair tensor and its cotangent g it recomputes the forward
// of csrc/pair_mlp.cu per pair, through that kernel's epilogues (common.cuh,
// the same addition order), and back-propagates through the edge mask, the
// LayerNorm, the three products and the relus (relu'(0) = 0):
//
//   d_pair [B,Nr,Nc,128] (element type T), and in float32
//   d_i_term, d_fi, d_row_mask: sums over a row's pairs;
//   d_j_term, d_fj, d_col_mask: sums over a column's pairs;
//   d_w0, d_w1, d_b1, d_wf, d_bf, d_wfe, d_ln_scale, d_ln_bias: sums over
//   the whole grid.
//
// Bound on an H100 SXM at B=2 N=256: the recompute (524,288 FLOP a pair)
// plus two products per forward product (the d-input and the d-weight
// ones), 1,572,864 FLOP a pair, 206 GFLOP a launch: 3.08 ms in float32 on
// the CUDA cores (67 TFLOP/s), against 201 MB of float32 pair, cotangent and
// d_pair. Set by operations.
//
// Design. The TPU kernel accumulates the grid-reduced gradients in output
// blocks that stay in VMEM across a sequential grid; here blocks run in
// parallel, so nothing is summed across blocks in place and no float atomic
// is used: two launches give the same bits.
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
//   once the weight gradients that read them are taken. Products run on the
//   CUDA cores in float32 (fmaf), for both element types; the transposed
//   products read W^T, which the wrapper lays out row-major. The forward
//   kernel (pair_mlp.cu) runs its products on the tensor cores (3xTF32 in
//   float32) in another order, so this recompute and that forward differ by
//   float32 rounding (in bf16 a sum can round to the other side, one bf16
//   step). The gradients are those of this recompute, which matches the
//   plain version to float32 rounding; the train step's gradients stay
//   within 1e-4 of the plain-version step (chip_smoke.py phase 6).
// - Padded pairs (past Nr or Nc) take a zero cotangent: every gradient
//   contribution from them is exactly zero. Masked pairs keep theirs: the
//   mask gradients read yln . g there.
#include "common.cuh"

namespace fdk {
namespace {

constexpr int C_IN = 128, HID = 384, C_OUT = 128;
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

}  // namespace
}  // namespace fdk

// C interface. dtype: 0 = float32, 1 = bfloat16. residual: 1 for the edge
// transition (fi, fj, wfe, wfet given), 0 for the plain MLP. Weights are
// row-major [in, out], w0t/w1t/wft/wfet their transposes. Scratch (float32,
// from the wrapper): wpart [blocks, 262912], rowpart [B, Nr, ceil(Nc/8), 513],
// colpart [B, Nc, ceil(Nr/4), 513]; outputs wred [262912], rowred [B, Nr, 513],
// colred [B, Nc, 513], d_pair [B, Nr, Nc, 128]. blocks: persistent blocks
// (one per SM). Returns a cudaError_t (0 on success).
extern "C" int fdk_pair_mlp_bwd(int dtype, int residual, const void* g, const void* pair,
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
  if (dtype == 0)
    return residual ? fdk::launch<float, true>(FDK_ARGS) : fdk::launch<float, false>(FDK_ARGS);
  if (dtype == 1)
    return residual ? fdk::launch<__nv_bfloat16, true>(FDK_ARGS)
                    : fdk::launch<__nv_bfloat16, false>(FDK_ARGS);
#undef FDK_ARGS
  return (int)cudaErrorInvalidValue;
}
