// Fused pair MLP of the edge transition in bf16, for Hopper (sm_90a), on
// wgmma and TMA: every bf16 forward, differentiated or not (the samplers,
// the service, the CLIs, a train step's forwards, the sequence-parallel row
// blocks).
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/pair_mlp.py:78
// (_pair_mlp_kernel, reached through fused_pair_mlp) in bf16: per pair
// (i, j)
//
//   y0  = relu(pair @ W0 + i_term_i + j_term_j + b0)          [384]
//   y1  = relu(y0 @ W1 + b1)                                  [384]
//   out = y1 @ Wf + pair @ Wfe + fi_i + fj_j + bf             [128]  (RESIDUAL)
//   out = y1 @ Wf + bf                                               (!RESIDUAL)
//   out = LayerNorm(out) * row_mask_i * col_mask_j
//
// with common.cuh's epilogues (every product rounded to bf16, every add
// rounded to bf16, b0 and bf not folded) and LayerNorm (float32 statistics,
// eps 1e-6). The bf16 backward's kernel A (pair_mlp_bwd_wg_bf16.cu)
// recomputes the forward through this tile's code (pair_mlp_wg_bf16.cuh,
// forward_tile, with its own hooks), so its recompute has this kernel's bits
// and the relu decisions of forward and backward agree (chip_smoke.py holds
// the two equal).
//
// Bound on an H100 SXM at B=2 N=256: 2 * (128*384 + 384*384 + 384*128 +
// 128*128) = 524,288 FLOP a pair, 68.7 GFLOP a launch, at 989 TFLOP/s bf16:
// 0.069 ms (the bytes, 33.5 MB of pair in and out, take 0.01 ms).
//
// Design.
// - A persistent block on each SM walks 128-pair tiles of the [B*Nr*Nc]
//   grid. Warps 0-7 are two consumer warpgroups; warpgroup 2 gives its
//   registers to them (setmaxnreg: 232 a consumer thread) and one of its
//   lanes is the producer.
// - Each consumer warpgroup owns 64 pairs of the tile across all 128 output
//   columns of every chunk (wgmma m64n128k16, bf16): the two share only the
//   weight ring and X, so one's epilogues run under the other's products.
// - Operands from shared memory, no ldmatrix and no split: A (X, Y0, the Y1
//   chunk) through K-major descriptors over bf16 tiles in TMA's 128-byte
//   swizzle (the epilogues write y0 and y1, bf16 values already, into the
//   same layout); B is each weight as stored ([in, out], MN-major for
//   wgmma) through MN-major descriptors (transpose flag 1), so there is no
//   weight preparation and no scratch.
// - Weights by TMA: the producer brings each tile's pair rows (two boxes of
//   64 columns x 128 pairs) and then its weight slices, 64 (k) x 128 (n)
//   (two 8 KB boxes), through a ring of three stages guarded by full and
//   empty mbarriers, in the products' order: W0 by output chunk, then for
//   each 128-column chunk of y1 W1's and Wf's slices, then Wfe. The ring runs
//   across tiles. 512 KB of L2 reads a tile, 0.54 GB a launch at B=2 N=256
//   (64-pair tiles would read 1.07 GB).
// - Registers: the consumers get setmaxnreg's 232 and hold one or two
//   64-float accumulator sets and the next epilogue's operands; the biases
//   wait in shared memory, and so does y1 @ Wf, rounded, under the residual
//   product. Each product's slices are unrolled: with the slice loop rolled,
//   ptxas kept a second accumulator set by copying it through local memory
//   around every slice (chip_variants.py --only bf16_fwd times that build).
// - Sums: each product's whole K in the wgmma accumulators (float32, the
//   tensor cores truncating: about 2^-14 relative at K = 384, under the bf16
//   rounding that follows, 2^-9). One slice's products stay in flight while
//   the next slice's issue; a stage returns to the producer once its
//   products are done. The epilogue's operands from device memory (i_term,
//   j_term, fi, fj) load while the chunk's last slice multiplies.
// - Rows past the grid come in as TMA's zero fill and are never stored.
// - Shared memory (227 KB a block): the ring 3 x 16 KB, X 32 KB, Y0 96 KB,
//   the Y1 chunk 32 KB (later the pre-norm output), the biases 1.75 KB, the
//   bookkeeping 1.5 KB, eight mbarriers and 1 KB of alignment slack: 212 KB.
#include "pair_mlp_wg_bf16.cuh"

namespace fdk {
namespace {
namespace wgb {

// The forward's hooks into forward_tile: X is released to the producer for
// the next tile's pair rows as soon as the products are done with it.
struct FwdHooks {
  Smem& sm;
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
__device__ __forceinline__ void consume(Smem& sm, const bf16* __restrict__ i_term,
                                        const bf16* __restrict__ j_term,
                                        const bf16* __restrict__ fi, const bf16* __restrict__ fj,
                                        const bf16* __restrict__ row_mask,
                                        const bf16* __restrict__ col_mask,
                                        const bf16* __restrict__ b0, const bf16* __restrict__ b1,
                                        const bf16* __restrict__ bf,
                                        const float* __restrict__ ln_scale,
                                        const float* __restrict__ ln_bias, bf16* __restrict__ out,
                                        int Nr, int Nc, long long total, long long tiles) {
  const int group = threadIdx.x >> 7;
  Ring ring{sm, group, 0};
  FwdHooks hooks{sm};
  PairTile& pt = sm.pt[group];
  load_biases(sm, b0, b1, bf);
  wg::bar_sync(3, kConsumers);  // the biases
  uint32_t k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const long long p0 = t * kTile + kHalf * group;
    load_pair_tile<bf16>(pt, p0, total, Nr, Nc, row_mask, col_mask, threadIdx.x & 127);
    wg::bar_sync(1 + group, 128);  // the warpgroup's bookkeeping
    wg::mbar_wait(&sm.xfull, k & 1);
    forward_tile<RESIDUAL>(sm, ring, pt, i_term, j_term, fi, fj, hooks);
    layer_norm_rows(sm.y1[0], group, pt, p0, ln_scale, ln_bias, out);
    wg::bar_sync(1 + group, 128);  // the bookkeeping and the output read
  }
}

template <bool RESIDUAL>
__global__ void __launch_bounds__(kBlockThreads, 1)
pair_mlp_wg_bf16_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ i_term,
                        const bf16* __restrict__ j_term, const bf16* __restrict__ fi,
                        const bf16* __restrict__ fj, const bf16* __restrict__ row_mask,
                        const bf16* __restrict__ col_mask, const bf16* __restrict__ b0,
                        const bf16* __restrict__ b1, const bf16* __restrict__ bf,
                        const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                        bf16* __restrict__ out, int Nr, int Nc, long long total) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = smem_of(smem_raw);
  const long long tiles = (total + kTile - 1) / kTile;

  if (threadIdx.x == 0) init_barriers(sm);
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warpgroup: it gives its registers to the consumers (granted
    // by warpgroup), and one lane keeps the ring full, tile after tile.
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) produce<RESIDUAL>(sm, maps, tiles);
  } else {
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
                   const float* ln_bias, void* out, int B, int Nr, int Nc,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(pair_mlp_wg_bf16_kernel<RESIDUAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long total = (long long)B * Nr * Nc;
  if (total == 0) return cudaSuccess;
  Maps maps;
  if (!wg::bf16_sw128_map(&maps.w0, w0, C_IN, HID, 64) ||
      !wg::bf16_sw128_map(&maps.w1, w1, HID, HID, 64) ||
      !wg::bf16_sw128_map(&maps.wf, wf, HID, C_OUT, 64) ||
      (RESIDUAL && !wg::bf16_sw128_map(&maps.wfe, wfe, C_IN, C_OUT, 64)) ||
      !wg::bf16_sw128_map(&maps.pair, pair, total, C_IN, kTile))
    return cudaErrorInvalidValue;
  if (!RESIDUAL) maps.wfe = maps.wf;  // never read
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const long long tiles = (total + kTile - 1) / kTile;
  const int blocks = (int)(tiles < sms ? tiles : sms);
  pair_mlp_wg_bf16_kernel<RESIDUAL><<<blocks, kBlockThreads, kSmemBytes, stream>>>(
      maps, (const bf16*)i_term, (const bf16*)j_term, (const bf16*)fi, (const bf16*)fj,
      (const bf16*)row_mask, (const bf16*)col_mask, (const bf16*)b0, (const bf16*)b1,
      (const bf16*)bf, ln_scale, ln_bias, (bf16*)out, Nr, Nc, total);
  return cudaGetLastError();
}

}  // namespace wgb
}  // namespace
}  // namespace fdk

// C interface. bf16 only (every float32 forward is fdk_pair_mlp_wg's).
// residual: 1 for the edge transition (fi, fj, wfe given), 0 for the plain
// MLP (they are ignored). Weights are row-major [in, out], 16-byte
// aligned; pair 16-byte aligned; i_term, j_term, fi
// and fj 4-byte aligned. Returns a cudaError_t (0 on success).
extern "C" int fdk_pair_mlp_wg_bf16(int residual, const void* pair, const void* i_term,
                                    const void* j_term, const void* fi, const void* fj,
                                    const void* row_mask, const void* col_mask, const void* w0,
                                    const void* b0, const void* w1, const void* b1,
                                    const void* wf, const void* bf, const void* wfe,
                                    const float* ln_scale, const float* ln_bias, void* out,
                                    int B, int Nr, int Nc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDK_ARGS                                                                 \
  pair, i_term, j_term, fi, fj, row_mask, col_mask, w0, b0, w1, b1, wf, bf, wfe, \
      ln_scale, ln_bias, out, B, Nr, Nc, s
  return residual ? fdk::wgb::launch<true>(FDK_ARGS) : fdk::wgb::launch<false>(FDK_ARGS);
#undef FDK_ARGS
}
