// Fused pair MLP of the edge transition, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/pair_mlp.py
// (_pair_mlp_kernel, reached through fused_pair_mlp). Per pair (i, j):
//
//   y0  = relu(pair @ W0 + i_term_i + j_term_j + b0)          [384]
//   y1  = relu(y0 @ W1 + b1)                                  [384]
//   out = y1 @ Wf + pair @ Wfe + fi_i + fj_j + bf             [128]  (RESIDUAL)
//   out = y1 @ Wf + bf                                               (!RESIDUAL)
//   out = LayerNorm(out) * row_mask_i * col_mask_j
//
// Each product accumulates in float32 and is rounded to the element type T
// (float or bf16); every elementwise add rounds to T as the plain version
// does; LayerNorm statistics are float32.
//
// Bound on an H100 SXM at N=256, B=1: 2*(128*384 + 384*384 + 384*128 +
// 128*128) = 524,288 FLOP per pair, 34.4 GFLOP per launch, against 33.5 MB of
// bf16 traffic (pair in, out). In bf16 that is compute bound on the tensor
// cores (~35 us at 989 TFLOP/s); in float32 on the CUDA cores (~0.51 ms at
// 67 TFLOP/s).
//
// Design: the [B*Nr*Nc] pair grid is cut into 64-pair tiles, one block of
// 256 threads each. The weights (W1 alone is 576 KB in float32) do not fit in
// shared memory, so they stream through L2 in 32-row slices, double-buffered
// (the next slice is in flight while the block multiplies the current one).
// The block keeps the pair tile (64x128) and y0 (64x384) in shared memory,
// walks the hidden dimension of y1 in 128-column chunks --
// y1_c = relu(y0 @ W1[:, c] + b1[c]), acc += y1_c @ Wf[c, :] -- so y1 never
// exists whole, then adds the residual terms, and runs LayerNorm and the mask
// from shared memory (196 KB of it: one block per SM). Nothing but the pair
// input and the output touches device memory per pair. Each thread owns a
// 4x8 micro-tile and reads its four activation rows as float4 along k, so a
// step of 32 FMAs costs five shared-memory wavefronts. The products run on
// the CUDA cores in float32 (fmaf), for both element types: this is the
// simple first kernel, not yet the tensor-core (wgmma) one.
#include "common.cuh"

namespace fdk {
namespace {

constexpr int C_IN = 128, HID = 384, C_OUT = 128;
constexpr int HC = 128;  // columns of y1 per chunk
constexpr int LDX = C_IN + 4, LDY0 = HID + 4, LDY1 = HC + 4;
constexpr size_t kSmemFloats = (size_t)kRows * LDX + (size_t)kRows * LDY0 +
                               (size_t)kRows * LDY1 + 2 * (size_t)kKc * 128;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float) + sizeof(PairTile);

template <typename T, bool RESIDUAL>
__global__ void __launch_bounds__(kThreads)
pair_mlp_kernel(const T* __restrict__ pair, const T* __restrict__ i_term,
                const T* __restrict__ j_term, const T* __restrict__ fi,
                const T* __restrict__ fj, const T* __restrict__ row_mask,
                const T* __restrict__ col_mask, const T* __restrict__ w0,
                const T* __restrict__ b0, const T* __restrict__ w1,
                const T* __restrict__ b1, const T* __restrict__ wf,
                const T* __restrict__ bf, const T* __restrict__ wfe,
                const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                T* __restrict__ out, int Nr, int Nc, long long total) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;                       // [64][LDX]   pair tile, later the output
  float* Y0 = X + kRows * LDX;           // [64][LDY0]  first hidden layer
  float* Y1 = Y0 + kRows * LDY0;         // [64][LDY1]  HC-column chunk of y1
  float* Ws = Y1 + kRows * LDY1;         // [2][kKc][128] weight staging
  PairTile& pt = *reinterpret_cast<PairTile*>(Ws + 2 * kKc * 128);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long p0 = (long long)blockIdx.x * kRows;
  load_pair_tile<T>(pt, p0, total, Nr, Nc, row_mask, col_mask);
  for (int idx = tid; idx < kRows * C_IN; idx += kThreads) {
    const int r = idx / C_IN, c = idx - r * C_IN;
    const long long p = p0 + r;
    X[r * LDX + c] = p < total ? ld<T>(pair + (size_t)p * C_IN + c) : 0.f;
  }
  __syncthreads();

  // y0 = relu(pair @ W0 + i_term + j_term + b0), in three 128-column chunks.
  for (int cb = 0; cb < HID / 128; ++cb) {
    float acc[4][8];
    zero(acc);
    tile_gemm<T, 128>(X, LDX, C_IN, w0, HID, cb * 128, Ws, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int prow = max(pt.row[r], 0), pcol = pt.col[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cb * 128 + tile_col(j, tx);
        Y0[r * LDY0 + c] = pair_y0<T>(acc[i][j], ld<T>(i_term + (size_t)prow * HID + c),
                                      ld<T>(j_term + (size_t)pcol * HID + c), ld<T>(b0 + c));
      }
    }
  }
  __syncthreads();

  // Walk the hidden dimension of y1 in HC-column chunks:
  // y1_c = relu(y0 @ W1[:, c] + b1[c]); acc_out += y1_c @ Wf[c, :].
  float acc_out[4][8];
  zero(acc_out);
  for (int hc = 0; hc < HID / HC; ++hc) {
    float acc1[4][HC / 16];
    zero(acc1);
    tile_gemm<T, HC>(Y0, LDY0, HID, w1, HID, hc * HC, Ws, acc1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < HC / 16; ++j) {
        const int c = tile_col(j, tx);
        Y1[(ty * 4 + i) * LDY1 + c] = pair_y1<T>(acc1[i][j], ld<T>(b1 + hc * HC + c));
      }
    __syncthreads();
    tile_gemm<T, 128>(Y1, LDY1, HC, wf + (size_t)hc * HC * C_OUT, C_OUT, 0, Ws, acc_out);
  }

  float res[4][8];
  zero(res);
  if (RESIDUAL) tile_gemm<T, 128>(X, LDX, C_IN, wfe, C_OUT, 0, Ws, res);
  // Every thread has finished reading X: reuse it for the pre-norm output.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int prow = max(pt.row[r], 0), pcol = pt.col[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(j, tx);
      X[r * LDX + c] =
          pair_out<T, RESIDUAL>(acc_out[i][j], res[i][j], fi, fj, prow, pcol, c, ld<T>(bf + c));
    }
  }
  __syncthreads();
  layer_norm_store<T>(X, LDX, pt, p0, ln_scale, ln_bias, out);
}

template <typename T, bool RESIDUAL>
cudaError_t launch(const void* pair, const void* i_term, const void* j_term, const void* fi,
                   const void* fj, const void* row_mask, const void* col_mask,
                   const void* w0, const void* b0, const void* w1, const void* b1,
                   const void* wf, const void* bf, const void* wfe, const float* ln_scale,
                   const float* ln_bias, void* out, int B, int Nr, int Nc,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(pair_mlp_kernel<T, RESIDUAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long total = (long long)B * Nr * Nc;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kRows - 1) / kRows;
  pair_mlp_kernel<T, RESIDUAL><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      (const T*)pair, (const T*)i_term, (const T*)j_term, (const T*)fi, (const T*)fj,
      (const T*)row_mask, (const T*)col_mask, (const T*)w0, (const T*)b0, (const T*)w1,
      (const T*)b1, (const T*)wf, (const T*)bf, (const T*)wfe, ln_scale, ln_bias, (T*)out,
      Nr, Nc, total);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fdk

// C interface. dtype: 0 = float32, 1 = bfloat16. residual: 1 for the edge
// transition (fi, fj, wfe given), 0 for the plain MLP (they are ignored).
// Weights are row-major [in, out]. Returns a cudaError_t (0 on success).
extern "C" int fdk_pair_mlp(int dtype, int residual, const void* pair, const void* i_term,
                            const void* j_term, const void* fi, const void* fj,
                            const void* row_mask, const void* col_mask, const void* w0,
                            const void* b0, const void* w1, const void* b1, const void* wf,
                            const void* bf, const void* wfe, const float* ln_scale,
                            const float* ln_bias, void* out, int B, int Nr, int Nc,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDK_ARGS                                                                     \
  pair, i_term, j_term, fi, fj, row_mask, col_mask, w0, b0, w1, b1, wf, bf, wfe,     \
      ln_scale, ln_bias, out, B, Nr, Nc, s
  if (dtype == 0)
    return residual ? fdk::launch<float, true>(FDK_ARGS) : fdk::launch<float, false>(FDK_ARGS);
  if (dtype == 1)
    return residual ? fdk::launch<__nv_bfloat16, true>(FDK_ARGS)
                    : fdk::launch<__nv_bfloat16, false>(FDK_ARGS);
#undef FDK_ARGS
  return (int)cudaErrorInvalidValue;
}
