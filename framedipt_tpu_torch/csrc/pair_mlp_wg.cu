// Fused pair MLP of the edge transition in float32, for Hopper (sm_90a), on
// wgmma and TMA: every float32 forward, differentiated or not (the samplers,
// the service, the CLIs, a train step's forwards).
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/pair_mlp.py:78
// (_pair_mlp_kernel, reached through fused_pair_mlp) in float32: per pair
// (i, j)
//
//   y0  = relu(pair @ W0 + i_term_i + j_term_j + b0)          [384]
//   y1  = relu(y0 @ W1 + b1)                                  [384]
//   out = y1 @ Wf + pair @ Wfe + fi_i + fj_j + bf             [128]  (RESIDUAL)
//   out = y1 @ Wf + bf                                               (!RESIDUAL)
//   out = LayerNorm(out) * row_mask_i * col_mask_j
//
// with common.cuh's epilogues and LayerNorm, in the plain version's addition
// order; only the order of each k-sum differs from the plain version. The
// tile's code is pair_mlp_wg.cuh's, which the float32 backward's
// kernel A (pair_mlp_bwd_wg.cu) recomputes through, so a differentiated
// forward's relu decisions are the backward's (model/kernels/pair_mlp.py,
// forward_route).
//
// Bound on an H100 SXM at B=2 N=256: 2 * (128*384 + 384*384 + 384*128 +
// 128*128) = 524,288 FLOP a pair, 68.7 GFLOP a launch; float32-accurate
// products on the tensor cores take three TF32 products each (3xTF32):
// 3 x 68.7 GFLOP / 495 TFLOP/s = 0.416 ms (the bytes, 67 MB of pair in and
// out, take 0.02 ms). That is the bound this kernel is held against.
//
// Design.
// - A persistent block on each SM walks 64-pair tiles of the [B*Nr*Nc] grid.
//   Warps 0-7 are two consumer warpgroups that multiply; warpgroup 2 gives
//   its registers to them (setmaxnreg: 232 a consumer thread) and one of its
//   lanes is the producer.
// - Weights by TMA. The launch's first kernel (prepare_weights) writes each
//   weight's TF32 hi and lo parts, K-major ([out, in], the layout TF32 wgmma
//   takes B in), to scratch the wrapper hands in (2 MB); the host encodes
//   tensor maps over them and over the pair input each launch. The producer
//   brings each tile's pair rows (X) and then its weight slices, 32 (in) x
//   128 (out) hi + lo (128-byte swizzle, 32 KB), through a ring of two
//   stages guarded by full and empty mbarriers, in the products' order:
//   W0 by output chunk, then for each 128-column chunk of y1 W1's and Wf's
//   slices, then Wfe. The ring runs across tiles. Bringing lo by TMA doubles
//   the weights' L2 stream (4.3 GB a launch at B=2 N=256); splitting each
//   stage in shared memory instead cost more (H100, B=2 N=256: the split was
//   0.42 of 1.62 ms, the TMA loads 0.07; with lo by TMA and no split the
//   loads cost 0.01 of 0.93 ms).
// - Products on wgmma (m64n64k8, TF32): warpgroup w takes output columns
//   64 w .. 64 w + 63 of every 128-column chunk, all 64 rows. A comes from
//   registers: each warp loads its 16 rows of the activation tile (X, Y0 or
//   the Y1 chunk, float32 in shared memory, swizzled as TMA writes them) by
//   ldmatrix and splits them into TF32 hi + lo (cvt.rna). Each k step of 8
//   adds a_lo b_hi, then a_hi b_lo, then a_hi b_hi; each 32-deep slice sums
//   into a fresh accumulator (scale-d 0 on its first wgmma) that is then
//   added to the running sum with round to nearest, as tc_product.cuh does,
//   since the tensor cores truncate their sums. Both operands' parts are
//   TF32 values already, so the products do not depend on how the tensor
//   cores read a raw float32 (they truncate it: chip_smoke.py's probe).
// - Overlap: the next block's fragments load, and an epilogue's operands
//   (i_term, j_term, the biases) load from device memory, while a slice's
//   products run; the ring loads the next slice meanwhile. One slice is in
//   flight a warpgroup: a second would need a third stage, which shared
//   memory has no room for. The epilogues and the LayerNorm run between the
//   products, both warpgroups at once.
// - Shared memory (227 KB a block; no padding, the tiles are swizzled): the
//   ring 2 x 32 KB, X 32 KB, Y0 96 KB, the Y1 chunk 32 KB (later the pre-norm
//   output), the tile's bookkeeping 0.8 KB, six mbarriers and 1 KB of
//   alignment slack: 226 KB.
#include "pair_mlp_wg.cuh"

namespace fdk {
namespace {

// The forward's hooks into forward_tile: X is released to the producer for
// the next tile's pair rows as soon as the products are done with it.
struct FwdHooks {
  WgSmem& sm;
  __device__ __forceinline__ void x_done() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&sm.xempty);
  }
  __device__ __forceinline__ void y0(int, int, float, float) {}
  __device__ __forceinline__ void y0_whole() {}
  __device__ __forceinline__ void y1(int, int, float, float) {}
  __device__ __forceinline__ void y1_whole(int) {}
  __device__ __forceinline__ void y1_free() {}
};

template <bool RESIDUAL>
__device__ __forceinline__ void consume(WgSmem& sm, const float* __restrict__ i_term,
                                        const float* __restrict__ j_term,
                                        const float* __restrict__ fi, const float* __restrict__ fj,
                                        const float* __restrict__ row_mask,
                                        const float* __restrict__ col_mask,
                                        const float* __restrict__ b0, const float* __restrict__ b1,
                                        const float* __restrict__ bf,
                                        const float* __restrict__ ln_scale,
                                        const float* __restrict__ ln_bias, float* __restrict__ out,
                                        int Nr, int Nc, long long total, long long tiles) {
  Consumer ring{sm, (int)(threadIdx.x >> 7), 0};
  FwdHooks hooks{sm};
  uint32_t k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const long long p0 = t * kRows;
    PairTile& pt = sm.pt;
    load_pair_tile<float>(pt, p0, total, Nr, Nc, row_mask, col_mask);
    wg::bar_sync(1, kConsumers);  // the tile's bookkeeping
    wg::mbar_wait(&sm.xfull, k & 1);
    forward_tile<RESIDUAL>(sm, ring, pt, i_term, j_term, fi, fj, b0, b1, bf, hooks);
    // common.cuh's LayerNorm and mask.
    layer_norm_rows(sm.y1, pt, p0, ln_scale, ln_bias, out);
    wg::bar_sync(1, kConsumers);  // the tile's bookkeeping and output read
  }
}

template <bool RESIDUAL>
__global__ void __launch_bounds__(kBlockWG, 1)
pair_mlp_wg_kernel(const __grid_constant__ Maps<1> maps, const float* __restrict__ i_term,
                   const float* __restrict__ j_term,
                   const float* __restrict__ fi, const float* __restrict__ fj,
                   const float* __restrict__ row_mask, const float* __restrict__ col_mask,
                   const float* __restrict__ b0, const float* __restrict__ b1,
                   const float* __restrict__ bf, const float* __restrict__ ln_scale,
                   const float* __restrict__ ln_bias, float* __restrict__ out, int Nr, int Nc,
                   long long total) {
  extern __shared__ uint8_t smem_raw[];
  WgSmem& sm = wg_smem(smem_raw);
  const long long tiles = (total + kRows - 1) / kRows;

  if (threadIdx.x == 0) init_barriers(sm);
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warpgroup: it gives its registers to the consumers, and one
    // lane keeps the ring full, tile after tile, each tile's pair rows first.
    // (Registers are granted by warpgroup: with a lone producer warp the
    // consumers' raise would wait forever for the missing warps' share.)
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) produce<RESIDUAL>(sm, maps, tiles);
  } else {
    // Consumers: two warpgroups.
    wg::setmaxnreg_inc<232>();
    consume<RESIDUAL>(sm, i_term, j_term, fi, fj, row_mask, col_mask, b0, b1, bf, ln_scale,
                      ln_bias, out, Nr, Nc, total, tiles);
  }
}

template <bool RESIDUAL>
cudaError_t launch(const void* pair, const void* i_term, const void* j_term, const void* fi,
                   const void* fj, const void* row_mask, const void* col_mask, const void* w0,
                   const void* b0, const void* w1, const void* b1, const void* wf,
                   const void* bf, const void* wfe, const float* ln_scale,
                   const float* ln_bias, void* out, float* split, int B, int Nr, int Nc,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(pair_mlp_wg_kernel<RESIDUAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long total = (long long)B * Nr * Nc;
  if (total == 0) return cudaSuccess;
  prepare_weights<true><<<256, 256, 0, stream>>>((const float*)w0, (const float*)w1,
                                                 (const float*)wf,
                                                 RESIDUAL ? (const float*)wfe : nullptr, split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  Maps<1> maps;
  if (!weight_maps(&maps.w[0], split) || !wg::f32_sw128_map(&maps.pair, pair, total, C_IN, kRows))
    return cudaErrorInvalidValue;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const long long tiles = (total + kRows - 1) / kRows;
  const int blocks = (int)(tiles < sms ? tiles : sms);
  pair_mlp_wg_kernel<RESIDUAL><<<blocks, kBlockWG, kSmemBytes, stream>>>(
      maps, (const float*)i_term, (const float*)j_term, (const float*)fi,
      (const float*)fj, (const float*)row_mask, (const float*)col_mask, (const float*)b0,
      (const float*)b1, (const float*)bf, ln_scale, ln_bias, (float*)out, Nr, Nc, total);
  return cudaGetLastError();
}

// One m64n64k8 TF32 wgmma, d = a @ b, with b's raw float32 values in shared
// memory (K-major, swizzled as the kernel keeps its stages) and a's values
// TF32 already: shows how the tensor cores read a float32 operand that is
// not a TF32 value. a [64][8], b [64 n][8 k], d [64][64], row-major.
__global__ void __launch_bounds__(128) tf32_probe_kernel(const float* __restrict__ a,
                                                         const float* __restrict__ b,
                                                         float* __restrict__ d) {
  extern __shared__ uint8_t probe_raw[];
  float* tile = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(probe_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5, g = lane >> 2, t = lane & 3;
  for (int idx = tid; idx < 64 * 32; idx += 128) tile[idx] = 0.f;
  __syncthreads();
  for (int idx = tid; idx < 64 * 8; idx += 128) {
    const int nn = idx / 8, k = idx % 8;
    tile[wg::swz<64>(nn, k)] = b[idx];
  }
  wg::fence_proxy_async();
  __syncthreads();
  const int r = 16 * wq + g;
  const uint32_t af[4] = {__float_as_uint(a[r * 8 + t]), __float_as_uint(a[(r + 8) * 8 + t]),
                          __float_as_uint(a[r * 8 + t + 4]),
                          __float_as_uint(a[(r + 8) * 8 + t + 4])};
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) wg::fence_operand(acc[i]);
  wg::wgmma_fence();
  wg::wgmma_m64n64k8_tf32(acc, af, wg::desc_sw128(tile), 0);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    wg::fence_operand(acc[i]);
    d[(r + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * t + (i & 1)] = acc[i];
  }
}

}  // namespace
}  // namespace fdk

// C interface. residual: 1 for the edge transition (fi, fj, wfe given), 0
// for the plain MLP (they are ignored). Float32 only. Weights are row-major
// [in, out]; pair 16-byte aligned, i_term,
// j_term and b0 8-byte aligned. split: 524,288 floats of device scratch,
// 16-byte aligned, for the weights' TF32 parts.
// Returns a cudaError_t (0 on success).
extern "C" int fdk_pair_mlp_wg(int residual, const void* pair, const void* i_term,
                               const void* j_term, const void* fi, const void* fj,
                               const void* row_mask, const void* col_mask, const void* w0,
                               const void* b0, const void* w1, const void* b1, const void* wf,
                               const void* bf, const void* wfe, const float* ln_scale,
                               const float* ln_bias, void* out, void* split, int B, int Nr,
                               int Nc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDK_ARGS                                                                 \
  pair, i_term, j_term, fi, fj, row_mask, col_mask, w0, b0, w1, b1, wf, bf, wfe, \
      ln_scale, ln_bias, out, static_cast<float*>(split), B, Nr, Nc, s
  return residual ? fdk::launch<true>(FDK_ARGS) : fdk::launch<false>(FDK_ARGS);
#undef FDK_ARGS
}

// The probe above: a [64][8], b [64][8], d [64][64] float32 on the device.
extern "C" int fdk_wgmma_tf32_probe(const float* a, const float* b, float* d, void* stream) {
  fdk::tf32_probe_kernel<<<1, 128, 64 * 32 * 4 + 1024, static_cast<cudaStream_t>(stream)>>>(a, b, d);
  return (int)cudaGetLastError();
}
