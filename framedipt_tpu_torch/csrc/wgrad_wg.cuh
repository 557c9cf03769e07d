// Kernel B of the float32 split backwards on wgmma and TMA, for Hopper
// (sm_90a): the weight gradients G = A^T Bm summed over the pairs of a
// chunk, as one split-K GEMM, 3xTF32. Launched by the pair MLP's float32
// backward (pair_mlp_split.cuh's finish_split, from pair_mlp_bwd_wg.cu) and
// the edge embedder's (edge_embedder_bwd_wg.cu); bf16 runs wgrad_bf16.cuh's
// kernel, which shares the jobs, their tensor maps and the epilogue.
// It replaces the weight-gradient products inside the Pallas TPU kernels
// framedipt_tpu/model/pallas/pair_mlp.py:349 (_pair_mlp_bwd_kernel: lines
// 491, 494, 504, 509) and edge_embedder.py:366 (_edge_embedder_bwd_kernel:
// lines 507, 513, 524), which sum them tile by tile on the TPU's grid.
//
// Work: 2 x rows x 128 FLOP a pair a job. At B=2 N=256 (131,072 pairs) the
// pair MLP's 16 jobs are 68.7 GFLOP, as 3xTF32 3 x 68.7 / 495 TFLOP/s =
// 0.42 ms on an H100 SXM, set by operations (its 0.94 GB of distinct
// workspace rows take 0.28 ms at the HBM rate); the embedder's 3 jobs are
// 10.7 GFLOP, 0.065 ms, against its 0.37 GB of rows, 0.11 ms: set by bytes.
//
// - Jobs: each job is one output tile of 128 (or 64) rows x 128 columns of
//   one gradient: A's columns a_col .. a_col + rows - 1 and Bm's b_col ..
//   b_col + 127, A and Bm whole workspace arrays ([P, width] row-major)
//   behind TMA tensor maps. The chunk's pairs are cut into `slices`
//   contiguous K slices of whole 32-pair steps; block (job, slice) sums its
//   slice and writes its partial to wpart[slice * part_ld + out_off ..]. The
//   caller adds the slices' partials in slice order (common.cuh's
//   reduce_partials): no float atomics, two launches give the same bits.
// - The block: a producer warpgroup and two consumer warpgroups (384
//   threads, setmaxnreg 40 / 232). One producer lane loads each step's rows
//   of A and Bm by TMA into a ring of kWgradStages stages: 32-float column
//   boxes of 32 rows, 128-byte swizzled (wgmma_tma.cuh's layout), rows past
//   P read as zeros. That is the only out-of-bounds read: every slice but
//   the chunk's last is whole steps.
// - TF32 wgmma reads both operands K-major only, and K (the pair) runs down
//   the staged rows, so the producer warpgroup's other three warps turn each
//   step of Bm over: they write Bm^T's TF32 hi and lo parts (mma.cuh's
//   split_tf32) as two [128 n][32 k] K-major tiles in the same swizzled
//   layout, which the consumers read through wgmma descriptors. Each thread
//   moves a 4 x 4 block: four 16-byte reads down k, four 16-byte writes of
//   hi and of lo along k.
// - The consumers take A from registers: warpgroup w owns rows 64 w .. 64 w
//   + 63 of the tile (a 64-row job runs warpgroup 0 alone), reads its A^T
//   fragments straight from the staged rows (element (m, k) is As[k][m]),
//   splits them into hi and lo, and issues wgmma m64n128k8 three times a k
//   step: lo hi, hi lo, hi hi. Each 32-pair step sums into a zeroed
//   accumulator that is then added to the running sum with round-to-nearest,
//   since the tensor cores truncate their sums.
// - Bank conflicts: a step's 32 pairs take the k positions of the tiles in
//   step_pair's order (position 4 c + r holds pair 8 r + (c ^ 2 r)), the
//   same for both operands. Then the A^T fragment reads (eight m of one
//   warp-quarter at four k) and the transform's 16-byte reads and writes
//   (eight lanes on eight chunks of one row) each hit 32 distinct banks.
// - Barriers a stage: full (the TMA bytes landed), ready (the three
//   transform warps wrote Bm^T and fenced it for the async proxy), empty
//   (the eight consumer warps' products are done).
//
// kWgradATransform (chip_variants.py times it): A goes through the
// transform too, as A^T hi and lo tiles that wgmma reads from shared memory
// (two stages then fit, not three).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, chip_variants.py --only wgrad, B=2
// N=256, kernel B's device ms): the pair MLP's 0.76-0.78 (the mma.sync
// kernel B it replaced 1.33-1.36, torch.mm in float32 1.34), the
// embedder's 0.15 (0.25-0.26). What holds it back, one part removed at a
// time: no transform 0.59-0.61, no products 0.40-0.42, neither 0.30 (the
// TMA loads and the A^T fragments alone), one TF32 product a k step in
// place of three 0.56-0.66, no TMA loads 0.75-0.78; A through the
// transform 0.96, two stages 0.85. The products stay at 1.4x their bound
// and the transform adds to them rather than hiding behind them. Tried and
// dropped: the next step's fragments loaded during the products (ptxas
// gave the kernel 168 registers a thread and it spilled 648 bytes: twice
// the time), and a second ring for the transform's tiles with five TMA
// stages (no faster).
#pragma once

#include "common.cuh"
#include "wgmma_tma.cuh"

namespace fdk {
namespace {

constexpr bool kWgradATransform = false;
constexpr int kWgradStages = kWgradATransform ? 2 : 3;
constexpr int kWgradStep = 32;                   // pairs a step
constexpr int kWgradTile = kWgradStep * 128;     // floats of one operand tile of a step
constexpr int kWgradConsumers = 256, kWgradThreads = kWgradConsumers + 128;
constexpr int kWgradMaxJobs = 16, kWgradMaxMaps = 6;
// A stage's tiles: A and Bm as TMA stages them, Bm^T's hi and lo (and A^T's).
constexpr int kTA = 0, kTB = 1, kTBhi = 2, kTBlo = 3, kTAhi = 4, kTAlo = 5;
constexpr int kWgradStageTiles = kWgradATransform ? 6 : 4;

// One output tile: G[rows, 128] = A[:, a_col ..]^T Bm[:, b_col ..] with A
// and Bm behind tensor maps a_map and b_map; written at out_off with row
// stride out_ld.
struct WgradJob {
  int a_map, a_col, b_map, b_col, out_off, out_ld, rows;
};
struct WgradJobs {
  CUtensorMap map[kWgradMaxMaps];  // [P, width]: float32 32 x 32 boxes, bf16 64 x 64
  WgradJob job[kWgradMaxJobs];
};

struct __align__(1024) WgradSmem {
  float tile[kWgradStages][kWgradStageTiles][kWgradTile];
  uint64_t full[kWgradStages], ready[kWgradStages], empty[kWgradStages];
};
constexpr size_t kWgradSmemBytes = sizeof(WgradSmem) + 1024;
static_assert(kWgradSmemBytes <= 232448, "shared memory of one block");

// Float offset of staged element (pair k, column c) of a step's rows: 32
// column boxes of [32 pairs][32 floats], swizzled.
__device__ __forceinline__ int staged(int k, int c) {
  return (c >> 5) * (kWgradStep * 32) + k * 32 + ((((c >> 2) & 7) ^ (k & 7)) << 2) + (c & 3);
}

// The pair at k position 4 c + r of a step.
__device__ __forceinline__ int step_pair(int c, int r) { return 8 * r + (c ^ (2 * r)); }

// The transform of one staged operand of a step (`cols` columns) into its
// K-major TF32 hi and lo tiles ([cols][32] swizzled, k positions in
// step_pair's order), by the 96 threads `idx` of the producer warpgroup's warps
// 1-3: 4 x 4 blocks, lanes 8 j .. 8 j + 7 on the eight position chunks of
// one column quad.
__device__ __forceinline__ void transpose_split(const float* S, float* hi, float* lo, int cols,
                                                int idx) {
  for (int u = idx; u < cols * 2; u += 96) {
    const int c = u & 7, q = u >> 3;  // position chunk, column quad
    float4 v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      v[r] = *reinterpret_cast<const float4*>(S + staged(step_pair(c, r), 4 * q));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e[4] = {i == 0 ? v[0].x : i == 1 ? v[0].y : i == 2 ? v[0].z : v[0].w,
                          i == 0 ? v[1].x : i == 1 ? v[1].y : i == 2 ? v[1].z : v[1].w,
                          i == 0 ? v[2].x : i == 1 ? v[2].y : i == 2 ? v[2].z : v[2].w,
                          i == 0 ? v[3].x : i == 1 ? v[3].y : i == 2 ? v[3].z : v[3].w};
      uint32_t h[4], l[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(e[r], h[r], l[r]);
      const int n = 4 * q + i, off = n * 32 + ((c ^ (n & 7)) << 2);
      *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// d (+)= a @ b: m64n128k8, TF32, both operands K-major in shared memory
// (descriptors a, b); as wgmma_m64n128k8_tf32 otherwise.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                        int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}"
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

// This thread's A^T fragments of stage st, split into TF32 hi and lo: k
// steps kk = 0..3 of the warpgroup's m64 x k8 A (per warp as
// mma.m16n8k8's A): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4), at k positions 8 kk + t = 4 (2 kk) + t and 8 kk + 4 + t = 4 (2 kk
// + 1) + t. Element (m, k) is the staged As[k][m].
__device__ __forceinline__ void load_frags(const WgradSmem& sm, int st, int group,
                                           uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
  const float* As = sm.tile[st][kTA];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m = 64 * group + 16 * ((threadIdx.x >> 5) & 3) + g;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_tf32(As[staged(step_pair(2 * kk + (i >> 1), t), m + 8 * (i & 1))], hi[kk][i],
                 lo[kk][i]);
}

// part = this warpgroup's (`group`: its 64 rows of the tile) products of
// stage st: per k step a_lo b_hi, a_hi b_lo, a_hi b_hi into a zeroed
// accumulator, A from the fragments hi, lo (with A through the transform,
// from its tiles).
__device__ __forceinline__ void wgrad_step(const WgradSmem& sm, int st, int group,
                                           uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                           float (&part)[64]) {
  const float* bhi = sm.tile[st][kTBhi];
  const float* blo = sm.tile[st][kTBlo];
#pragma unroll
  for (int i = 0; i < 64; ++i) wg::fence_operand(part[i]);
  wg::wgmma_fence();
  if constexpr (kWgradATransform) {
    const float* ahi = sm.tile[st][kTAhi] + group * 64 * 32;
    const float* alo = sm.tile[st][kTAlo] + group * 64 * 32;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bh = wg::desc_sw128(bhi + 8 * kk), bl = wg::desc_sw128(blo + 8 * kk);
      const uint64_t ah = wg::desc_sw128(ahi + 8 * kk), al = wg::desc_sw128(alo + 8 * kk);
      wgmma_m64n128k8_tf32_ss(part, al, bh, kk > 0);
      wgmma_m64n128k8_tf32_ss(part, ah, bl, 1);
      wgmma_m64n128k8_tf32_ss(part, ah, bh, 1);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bh = wg::desc_sw128(bhi + 8 * kk), bl = wg::desc_sw128(blo + 8 * kk);
      wg::wgmma_m64n128k8_tf32(part, lo[kk], bh, kk > 0);
      wg::wgmma_m64n128k8_tf32(part, hi[kk], bl, 1);
      wg::wgmma_m64n128k8_tf32(part, hi[kk], bh, 1);
    }
  }
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wg::fence_operand(hi[kk][i]);
      wg::fence_operand(lo[kk][i]);
    }
#pragma unroll
  for (int i = 0; i < 64; ++i) wg::fence_operand(part[i]);
}

// Consumer warpgroup `group`'s 64 rows of job jb's tile from its m64n128
// accumulators (rows g, g + 8 of the warp's 16, columns 8 j + 2 t, + 1) into
// its slice's partial set at part.
__device__ __forceinline__ void wgrad_store(const float (&acc)[64], const WgradJob& jb,
                                            float* part, int group) {
  const int lane = threadIdx.x & 31;
  const int r = 64 * group + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float* out = part + jb.out_off + (size_t)r * jb.out_ld;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<float2*>(out + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (size_t)8 * jb.out_ld + c) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(kWgradThreads, 1)
wgrad_wg_kernel(const __grid_constant__ WgradJobs jobs, float* __restrict__ wpart,
                long long part_ld, long long P, long long k_slice) {
  extern __shared__ uint8_t wgrad_smem_raw[];
  // 1024-byte aligned by adding to the shared array itself (so every access
  // through it stays a shared-memory access).
  WgradSmem& sm = *reinterpret_cast<WgradSmem*>(
      wgrad_smem_raw + ((1024u - (smem_addr(wgrad_smem_raw) & 1023u)) & 1023u));
  const WgradJob jb = jobs.job[blockIdx.x];
  const long long k_begin = (long long)blockIdx.y * k_slice;
  const long long k_end = min(P, k_begin + k_slice);
  const int n_steps =
      k_end > k_begin ? (int)((k_end - k_begin + kWgradStep - 1) / kWgradStep) : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgradStages; ++s) {
      wg::mbar_init(&sm.full[s], 1);
      wg::mbar_init(&sm.ready[s], 3);
      wg::mbar_init(&sm.empty[s], kWgradConsumers / 32);
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWgradConsumers) {
    wg::setmaxnreg_dec<40>();
    const int idx = threadIdx.x - kWgradConsumers;
    if (idx == 0) {
      // The producer lane: each step's rows of A and Bm, once the stage is free.
      const CUtensorMap* am = &jobs.map[jb.a_map];
      const CUtensorMap* bm = &jobs.map[jb.b_map];
      wg::prefetch_tensor_map(am);
      wg::prefetch_tensor_map(bm);
      const uint32_t bytes = (jb.rows + 128) * kWgradStep * 4;
      for (int it = 0; it < n_steps; ++it) {
        const int st = it % kWgradStages;
        wg::mbar_wait(&sm.empty[st], ((it / kWgradStages) & 1) ^ 1);
        const int row = (int)(k_begin + (long long)it * kWgradStep);
        wg::mbar_arrive_expect_tx(&sm.full[st], bytes);
        for (int b = 0; b < jb.rows / 32; ++b)
          wg::tma_load_2d(sm.tile[st][kTA] + b * (kWgradStep * 32), am, &sm.full[st],
                          jb.a_col + 32 * b, row);
        for (int b = 0; b < 4; ++b)
          wg::tma_load_2d(sm.tile[st][kTB] + b * (kWgradStep * 32), bm, &sm.full[st],
                          jb.b_col + 32 * b, row);
      }
    } else if (idx >= 32) {
      // The transform warps: Bm^T's (and A^T's) hi and lo tiles of each step.
      for (int it = 0; it < n_steps; ++it) {
        const int st = it % kWgradStages;
        wg::mbar_wait(&sm.full[st], (it / kWgradStages) & 1);
        float(&tl)[kWgradStageTiles][kWgradTile] = sm.tile[st];
        transpose_split(tl[kTB], tl[kTBhi], tl[kTBlo], 128, idx - 32);
        if constexpr (kWgradATransform)
          transpose_split(tl[kTA], tl[kTAhi], tl[kTAlo], jb.rows, idx - 32);
        wg::fence_proxy_async();  // the tiles' generic writes before wgmma reads them
        __syncwarp();
        if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&sm.ready[st]);
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
    const int st = it % kWgradStages;
    const uint32_t parity = (it / kWgradStages) & 1;
    wg::mbar_wait(&sm.full[st], parity);
    wg::mbar_wait(&sm.ready[st], parity);
    float part[64];
    if (active) {  // a 64-row job's second warpgroup only hands the stage back
      uint32_t hi[4][4], lo[4][4];
      if (!kWgradATransform) load_frags(sm, st, group, hi, lo);
      wgrad_step(sm, st, group, hi, lo, part);
    }
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
inline cudaError_t launch_wgrad_wg(const WgradJobs& jobs, int n, int slices, float* wpart,
                                   long long part_ld, long long P, cudaStream_t stream) {
  if (n < 1 || n > kWgradMaxJobs || slices < 1 || P < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWgradSmemBytes);
  if (err != cudaSuccess) return err;
  const long long k_slice =
      ((P + slices - 1) / slices + kWgradStep - 1) / kWgradStep * kWgradStep;
  wgrad_wg_kernel<<<dim3(n, slices), kWgradThreads, kWgradSmemBytes, stream>>>(
      jobs, wpart, part_ld, P, k_slice);
  return cudaGetLastError();
}

// The jobs of kernel B alone (its tests' C entries): G [M, Nb] = A^T Bm, A
// behind tensor map 0 and Bm behind map 1, M = 64 or a multiple of 128, Nb
// a multiple of 128, at most kWgradMaxJobs tiles. Returns their number, 0
// for widths it refuses.
inline int wgrad_alone_jobs(WgradJobs& jobs, int M, int Nb) {
  if (Nb < 128 || Nb % 128 || (M != 64 && (M < 128 || M % 128)) ||
      (M == 64 ? 1 : M / 128) * (Nb / 128) > kWgradMaxJobs)
    return 0;
  int n = 0;
  for (int r = 0; r < M; r += 128)
    for (int c = 0; c < Nb; c += 128)
      jobs.job[n++] = {0, r, 1, c, r * Nb + c, Nb, M - r < 128 ? M - r : 128};
  return n;
}

// Tensor map `i` of jobs: the [rows, cols] float32 array at base.
inline bool wgrad_map(WgradJobs& jobs, int i, const float* base, long long rows, int cols) {
  return wg::f32_sw128_map(&jobs.map[i], base, (uint64_t)rows, (uint64_t)cols, kWgradStep);
}

}  // namespace
}  // namespace fdk
