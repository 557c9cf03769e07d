// Kernel B of the bf16 split backwards on wgmma and TMA, for Hopper
// (sm_90a): the weight gradients G = A^T Bm summed over the pairs of a
// chunk, as one split-K GEMM of bf16 operands with float32 sums. Launched by
// the pair MLP's bf16 backward (pair_mlp_split.cuh's finish_split, from
// pair_mlp_bwd.cu) and the edge embedder's (edge_embedder_split.cuh, from
// edge_embedder_bwd.cu); their float32 backwards run wgrad_wg.cuh's kernel,
// whose jobs, tensor-map table and epilogue this one shares. It replaces the
// weight-gradient products inside the Pallas TPU kernels
// framedipt_tpu/model/pallas/pair_mlp.py:349 (_pair_mlp_bwd_kernel: lines
// 491, 494, 504, 509) and edge_embedder.py:366 (_edge_embedder_bwd_kernel:
// lines 507, 513, 524), which sum them tile by tile on the TPU's grid.
//
// Work: 2 x rows x 128 FLOP a pair a job. At B=2 N=256 (131,072 pairs) the
// pair MLP's 16 jobs are 68.7 GFLOP, 0.07 ms at 989 TFLOP/s on an H100 SXM,
// against 0.47 GB of distinct workspace rows, 0.14 ms at the HBM rate: set
// by bytes. Each job reads its own 256 columns, so the blocks read 1.07 GB
// in all, and L2 serves the repeats. The embedder's 3 jobs: 10.7 GFLOP
// against 0.18 GB of rows, 0.055 ms: set by bytes.
//
// - Jobs and slices as wgrad_wg.cuh's: each job one output tile of 128 (or
//   64) rows x 128 columns of one gradient, A and Bm whole workspace arrays
//   ([P, width] row-major bf16) behind TMA tensor maps; the chunk's pairs in
//   `slices` contiguous K slices of whole kWbStep-pair steps; block (job,
//   slice) writes its partial to wpart[slice * part_ld + out_off ..], and
//   the caller adds the slices' partials in slice order (common.cuh's
//   reduce_partials): no float atomics, two launches give the same bits.
// - One producer lane loads each step's rows of A and Bm by TMA into a ring
//   of kWbStages stages: boxes of 64 columns (128-byte rows) x kWbStep pairs,
//   128-byte swizzled, rows past P read as zeros (only the chunk's last
//   slice reads past its end). A 64-row job (the embedder's d_w_rel = m^T
//   dy0, A = m [P, 64]) loads one box of A: nothing is read past m's rows.
// - No transform: K (the pair) runs down the staged rows, so A^T (M x K) and
//   Bm (K x N) are both MN-major there, and bf16 wgmma reads MN-major
//   operands from shared memory through its transpose flags. Descriptors
//   (wgmma_tma.cuh's desc_mn_sw128): rows of 128 bytes, 8-row groups 1024
//   bytes apart, Bm's second 64 columns one box further (the leading byte
//   offset); k step kk starts 16 kk rows (2 KB) into the boxes.
// - Two consumer warpgroups, warpgroup w owning rows 64 w .. 64 w + 63 of
//   the tile (a 64-row job runs warpgroup 0 alone; warpgroup 1 only hands
//   each stage back): wgmma m64n128k16 with both operands from shared memory,
//   kWbStep / 16 a step. Each step sums into a zeroed accumulator (the first
//   product ignores its old value) that is then added to the running sum with
//   round-to-nearest, since the tensor cores truncate their sums.
// - Barriers a stage: full (the TMA bytes landed), empty (the eight consumer
//   warps' products are done).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, chip_variants.py --only wgrad, B=2
// N=256, kernel B's device ms over six placements of the call's memory): the
// pair MLP's median 0.158 (0.156-0.160; the mma.sync kernel it replaced
// 0.413-0.430, the same products as torch.mm in bf16 0.224-0.229), 1.13x its
// byte bound; the embedder's 0.065 (0.081; torch.mm 0.086-0.092). One part
// removed at a time (the pair MLP's / the embedder's): no products
// 0.155-0.163 / 0.064-0.065, no TMA loads 0.123-0.125 / 0.026, every block
// on rows held in L2 0.127-0.128 / 0.026-0.027: HBM feeds it, and the
// consumers' own path (a wait, four products and the step's sum a step)
// takes 0.12 ms. 32-pair steps 0.201-0.204; five stages 0.174-0.179, six
// 0.181-0.205.
#pragma once

#include "wgrad_wg.cuh"

namespace fdk {
namespace {

constexpr int kWbStep = 64;                     // pairs a step
constexpr int kWbStages = 4;                    // steps in the ring
constexpr int kWbBox = kWbStep * 64;            // elements of one box: kWbStep rows x 64
constexpr uint32_t kWbBoxBytes = kWbBox * 2;    // the leading byte offset of Bm's descriptors
static_assert(kWbBoxBytes % 1024 == 0, "every box starts the swizzle's 1024-byte pattern");

struct __align__(1024) WgradBf16Smem {
  __nv_bfloat16 a[kWbStages][2][kWbBox];  // A's columns a_col .. + 63, a_col + 64 .. + 127
  __nv_bfloat16 b[kWbStages][2][kWbBox];  // Bm's columns b_col .. + 63, b_col + 64 .. + 127
  uint64_t full[kWbStages], empty[kWbStages];
};
constexpr size_t kWbSmemBytes = sizeof(WgradBf16Smem) + 1024;
static_assert(kWbSmemBytes <= 232448, "shared memory of one block");

// d (+)= a @ b: m64n128k16, bf16 inputs, float32 accumulators, both
// operands MN-major in shared memory (descriptors a, b; transpose flags 1);
// d as wgmma_m64n128k8_tf32's. accumulate = 0 ignores d's old values.
__device__ __forceinline__ void wgmma_m64n128k16_bf16_mn(float (&d)[64], uint64_t a, uint64_t b,
                                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// part = warpgroup `group`'s products of stage st (its 64 rows of the tile):
// per k step of 16 pairs, A^T's 64 x 16 from the group's box of A and Bm's
// 16 x 128 from both boxes of Bm, into a zeroed accumulator.
__device__ __forceinline__ void wgrad_bf16_step(const WgradBf16Smem& sm, int st, int group,
                                                float (&part)[64]) {
  const __nv_bfloat16* as = sm.a[st][group];
  const __nv_bfloat16* bs = sm.b[st][0];
#pragma unroll
  for (int i = 0; i < 64; ++i) wg::fence_operand(part[i]);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWbStep / 16; ++kk)
    wgmma_m64n128k16_bf16_mn(part, wg::desc_mn_sw128(as + kk * 16 * 64, kWbBoxBytes),
                             wg::desc_mn_sw128(bs + kk * 16 * 64, kWbBoxBytes), kk > 0);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) wg::fence_operand(part[i]);
}

// A template so that only the bf16 libraries compile it.
template <typename T>
__global__ void __launch_bounds__(kWgradThreads, 1)
wgrad_bf16_kernel(const __grid_constant__ WgradJobs jobs, float* __restrict__ wpart,
                  long long part_ld, long long P, long long k_slice) {
  static_assert(sizeof(T) == 2, "bf16 only: float32 runs wgrad_wg.cuh");
  extern __shared__ uint8_t wgrad_bf16_smem_raw[];
  // 1024-byte aligned by adding to the shared array itself (so every access
  // through it stays a shared-memory access).
  WgradBf16Smem& sm = *reinterpret_cast<WgradBf16Smem*>(
      wgrad_bf16_smem_raw + ((1024u - (smem_addr(wgrad_bf16_smem_raw) & 1023u)) & 1023u));
  const WgradJob jb = jobs.job[blockIdx.x];
  const long long k_begin = (long long)blockIdx.y * k_slice;
  const long long k_end = min(P, k_begin + k_slice);
  const int n_steps = k_end > k_begin ? (int)((k_end - k_begin + kWbStep - 1) / kWbStep) : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWbStages; ++s) {
      wg::mbar_init(&sm.full[s], 1);
      wg::mbar_init(&sm.empty[s], kWgradConsumers / 32);
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWgradConsumers) {
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x == kWgradConsumers) {
      // The producer lane: each step's rows of A and Bm, once the stage is free.
      const CUtensorMap* am = &jobs.map[jb.a_map];
      const CUtensorMap* bm = &jobs.map[jb.b_map];
      wg::prefetch_tensor_map(am);
      wg::prefetch_tensor_map(bm);
      const uint32_t bytes = (jb.rows + 128) * kWbStep * 2;
      for (int it = 0; it < n_steps; ++it) {
        const int st = it % kWbStages;
        wg::mbar_wait(&sm.empty[st], ((it / kWbStages) & 1) ^ 1);
        const int row = (int)(k_begin + (long long)it * kWbStep);
        wg::mbar_arrive_expect_tx(&sm.full[st], bytes);
        for (int b = 0; b < jb.rows / 64; ++b)
          wg::tma_load_2d(sm.a[st][b], am, &sm.full[st], jb.a_col + 64 * b, row);
        for (int b = 0; b < 2; ++b)
          wg::tma_load_2d(sm.b[st][b], bm, &sm.full[st], jb.b_col + 64 * b, row);
      }
    }
    return;
  }

  wg::setmaxnreg_inc<232>();
  const int group = threadIdx.x >> 7;
  const bool active = 64 * group < jb.rows;  // warpgroup-uniform
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_steps; ++it) {
    const int st = it % kWbStages;
    wg::mbar_wait(&sm.full[st], (it / kWbStages) & 1);
    float part[64];
    if (active) wgrad_bf16_step(sm, st, group, part);  // else only hand the stage back
    __syncwarp();
    if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&sm.empty[st]);
    if (active) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
  }
  if (!active) return;
  wgrad_store(acc, jb, wpart + (size_t)blockIdx.y * part_ld, group);
}

// Jobs 0 .. n - 1 over P pairs in `slices` K slices of whole steps; partial
// sets of part_ld floats at wpart. Returns a cudaError_t.
template <typename T>
cudaError_t launch_wgrad_bf16(const WgradJobs& jobs, int n, int slices, float* wpart,
                              long long part_ld, long long P, cudaStream_t stream) {
  if (n < 1 || n > kWgradMaxJobs || slices < 1 || P < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_bf16_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWbSmemBytes);
  if (err != cudaSuccess) return err;
  const long long k_slice = ((P + slices - 1) / slices + kWbStep - 1) / kWbStep * kWbStep;
  wgrad_bf16_kernel<T><<<dim3(n, slices), kWgradThreads, kWbSmemBytes, stream>>>(
      jobs, wpart, part_ld, P, k_slice);
  return cudaGetLastError();
}

// Tensor map `i` of jobs: the [rows, cols] bf16 array at base.
inline bool wgrad_map(WgradJobs& jobs, int i, const __nv_bfloat16* base, long long rows,
                      int cols) {
  return wg::bf16_sw128_map(&jobs.map[i], base, (uint64_t)rows, (uint64_t)cols, kWbStep);
}

}  // namespace
}  // namespace fdk
