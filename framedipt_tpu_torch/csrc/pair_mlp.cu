// Fused pair MLP of the edge transition, for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/pair_mlp.py:78
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
// Bounds on an H100 SXM at B=2 N=256: 2 * (128*384 + 384*384 + 384*128 +
// 128*128) = 524,288 FLOP a pair, 68.7 GFLOP a launch, against 67 MB of
// float32 pair in and out (bytes: 0.02 ms).
// - float32: float32-accurate products on the tensor cores take three TF32
//   products each (3xTF32): 3 x 68.7 GFLOP / 495 TFLOP/s = 0.416 ms. That is
//   the bound this kernel is held against. On the CUDA cores the same work
//   takes 68.7 GFLOP / 67 TFLOP/s = 1.026 ms (the bound of the earlier,
//   CUDA-core kernel).
// - bf16: one bf16 product each, 68.7 GFLOP / 989 TFLOP/s = 0.069 ms.
//
// Design.
// - The [B*Nr*Nc] pair grid is cut into 64-pair tiles, one block of 8 warps
//   each. The block keeps the pair tile X (64 x 128), y0 (64 x 384) and one
//   128-column chunk of y1 in shared memory as float32 values of T. It walks
//   the hidden dimension of y1 in 128-column chunks --
//   y1_c = relu(y0 @ W1[:, c] + b1[c]), acc += y1_c @ Wf[c, :] -- so y1 never
//   exists whole, then adds the residual terms, and runs LayerNorm and the
//   mask from shared memory. Nothing but the pair input and the output
//   touches device memory per pair.
// - Products and weight stream: tc_product.cuh, with pair_mlp_tc.cuh's slice
//   map (mma.sync, 3xTF32 in float32, bf16 MMA in bf16; weight slices by
//   cp.async through a ring of three stages in shared memory).
// - L2 weight reads: every tile reads every weight once, 262,144 values, 1.05
//   MB in float32; at B=2 N=256 a launch has 2,048 tiles, so 2.15 GB of L2
//   reads a launch (1.07 GB in bf16), in as many 16-byte copies.
//   That traffic falls with the tile's pair count. The tile stays at 64
//   pairs for both element types: with float32 tiles it fills 215 KB of the
//   227 KB of shared memory, and bf16 keeps the float32 tiles so both types
//   share one layout. A larger tile (bf16 tiles, or wgmma with the
//   activations in registers and TMA for the stream) is the next step.
// - One block per SM and no overlap between a tile's phases: the products,
//   the copies, the epilogues (the first layer's i/j terms load as pairs)
//   and the LayerNorm run one after the other.
// - Epilogues and LayerNorm are common.cuh's, applied to the accumulator
//   fragments, in the plain version's addition order; only the order of the
//   k-sum differs from the plain version.
// - The bf16 backward's kernel A (pair_mlp_bwd.cu) recomputes this forward
//   through the same code (forward_tile), so its recompute equals this
//   kernel's output bit for bit.
// - Its C entry takes bf16 only: every float32 forward, differentiated or
//   not, is pair_mlp_wg.cu's, whose tile the float32 backward recomputes
//   through. The float32 arithmetic stays in the templates (tc_product.cuh),
//   which the edge embedder's float32 kernels share.
#include "pair_mlp_tc.cuh"

namespace fdk {
namespace {

template <typename T, bool RESIDUAL>
__global__ void __launch_bounds__(kBlock, 1)
pair_mlp_kernel(const T* __restrict__ pair, const T* __restrict__ i_term,
                const T* __restrict__ j_term, const T* __restrict__ fi,
                const T* __restrict__ fj, const T* __restrict__ row_mask,
                const T* __restrict__ col_mask, const T* __restrict__ w0,
                const T* __restrict__ b0, const T* __restrict__ w1,
                const T* __restrict__ b1, const T* __restrict__ wf,
                const T* __restrict__ bf, const T* __restrict__ wfe,
                const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                T* __restrict__ out, int Nr, int Nc, long long total) {
  using L = Smem<T>;
  extern __shared__ __align__(16) float smem[];
  float* X = smem;                     // [64][LDX]   pair tile, later the output
  float* Y0 = X + kRows * L::LDX;      // [64][LDY0]  first hidden layer
  float* Y1 = Y0 + kRows * L::LDY0;    // [64][LDY1]  NC-column chunk of y1
  T* stages = reinterpret_cast<T*>(Y1 + kRows * L::LDY1);  // [kStages][kKc][kLdw]
  PairTile& pt = *reinterpret_cast<PairTile*>(stages + kStages * L::kStage);

  const MlpStream<T> ws{{w0, w1, wf, wfe}, stages, RESIDUAL ? kResSlice + kKSlices : kResSlice};
  for (int s = 0; s < kStages - 1; ++s) ws.start(s);

  const long long p0 = (long long)blockIdx.x * kRows;
  load_pair_tile<T>(pt, p0, total, Nr, Nc, row_mask, col_mask);
  for (int idx = threadIdx.x; idx < kRows * C_IN; idx += kBlock) {
    const int r = idx / C_IN, c = idx - r * C_IN;
    const long long p = p0 + r;
    X[r * L::LDX + c] = p < total ? ld<T>(pair + (size_t)p * C_IN + c) : 0.f;
  }
  // The first acquire() synchronizes the block before any product reads X.
  forward_tile<T, RESIDUAL, false, float>(X, Y0, Y1, pt, ws, i_term, j_term, fi, fj, b0, b1, bf,
                                   nullptr, nullptr, nullptr, nullptr);
  __syncthreads();
  // common.cuh's LayerNorm takes 8 warps, 8 rows each.
  if (threadIdx.x < kThreads) layer_norm_store<T>(X, L::LDX, pt, p0, ln_scale, ln_bias, out);
}

template <typename T, bool RESIDUAL>
cudaError_t launch(const void* pair, const void* i_term, const void* j_term, const void* fi,
                   const void* fj, const void* row_mask, const void* col_mask,
                   const void* w0, const void* b0, const void* w1, const void* b1,
                   const void* wf, const void* bf, const void* wfe, const float* ln_scale,
                   const float* ln_bias, void* out, int B, int Nr, int Nc,
                   cudaStream_t stream) {
  constexpr size_t kBytes = Smem<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(pair_mlp_kernel<T, RESIDUAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kBytes);
  if (err != cudaSuccess) return err;
  const long long total = (long long)B * Nr * Nc;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kRows - 1) / kRows;
  pair_mlp_kernel<T, RESIDUAL><<<(unsigned)blocks, kBlock, kBytes, stream>>>(
      (const T*)pair, (const T*)i_term, (const T*)j_term, (const T*)fi, (const T*)fj,
      (const T*)row_mask, (const T*)col_mask, (const T*)w0, (const T*)b0, (const T*)w1,
      (const T*)b1, (const T*)wf, (const T*)bf, (const T*)wfe, ln_scale, ln_bias, (T*)out,
      Nr, Nc, total);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fdk

// C interface. dtype: 1 = bfloat16; 0 (float32) is refused: every float32
// forward is fdk_pair_mlp_wg's (pair_mlp_wg.cu). residual: 1 for the edge
// transition (fi, fj, wfe given), 0 for the plain MLP (they are ignored).
// Weights are row-major [in, out], 16-byte aligned. Returns a cudaError_t (0
// on success).
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
  // float32 is pair_mlp_wg.cu's (wgmma and TMA).
  if (dtype == 1)
    return residual ? fdk::launch<__nv_bfloat16, true>(FDK_ARGS)
                    : fdk::launch<__nv_bfloat16, false>(FDK_ARGS);
#undef FDK_ARGS
  return (int)cudaErrorInvalidValue;
}
