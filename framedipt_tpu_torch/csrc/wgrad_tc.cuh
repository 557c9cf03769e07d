// Kernel B of the bf16 split backwards, for Hopper (sm_90a): weight
// gradients G = A^T Bm summed over the pairs of a chunk, as one split-K GEMM
// on the tensor cores. Shared by the pair MLP's bf16 backward
// (pair_mlp_bwd.cu) and the edge embedder's (edge_embedder_bwd.cu); their
// float32 backwards run wgrad_wg.cuh's kernel on wgmma and TMA.
//
// - Jobs: each job is one output tile of at most 128 x 128 (WJob.rows rows
//   of A's columns, 128 of Bm's) of one gradient; A and Bm are [pairs, .]
//   row-major in the workspace. The chunk's pairs are cut into `slices`
//   contiguous K slices of whole 32-pair steps; block (job, slice) sums its
//   slice and writes its partial to wpart[slice * part_ld + out_off ..]. The
//   caller adds the slices' partials in slice order (common.cuh's
//   reduce_partials): no float atomics, two launches give the same bits.
// - Operands, bf16, staged by cp.async through a four-stage ring in shared
//   memory ([32 pairs, 128] row blocks of A then of Bm, rows padded by 8
//   elements). Each 32-pair step sums into a zeroed fragment that is then
//   added to the running sum with round-to-nearest, since the tensor cores
//   round their sums toward zero.
// - One bf16 mma.sync (m16n8k16) a k step, the products exact in float32.
//   Both operands need pairs of k-neighbours in a register, and k runs down
//   the staged rows: ldmatrix.trans gives them, for B as tc_product.cuh's
//   bf16 product takes its weights, and for A^T the same four 8 x 8
//   matrices in another order. Row stride 272 bytes: the eight rows of an
//   8 x 8 matrix fall in distinct banks.
// - A job of 64 rows (the embedder's d_w_rel = m^T dy0, [64, 128]) runs the
//   whole 128-row tile and stores rows 0-63 only: A's row stride is 64, so
//   its staged columns 64-127 are the next pair's m (the caller keeps
//   readable memory past A's last row). In the float32 mma.sync kernel B
//   that wgrad_wg.cuh replaced, a skip of those products in the upper warps
//   cost registers (255 with spills, against 230) and 0.3 ms at B=2 N=256
//   (H100), while the 64-row job's blocks wait for the 128-row jobs' in
//   any case.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace fdk {
namespace {

constexpr int kMaxJobs = 16;  // output tiles of one launch

// One output tile: G[rows, 128] = A^T Bm, A and Bm from their first column
// a, b with row strides lda, ldb (elements); written at out_off with row
// stride out_ld.
template <typename T>
struct WJob {
  const T* a;
  const T* b;
  int lda, ldb, out_off, out_ld;
  int rows = 128;  // rows stored: 128 or 64
};
template <typename T>
struct WJobs {
  WJob<T> job[kMaxJobs];
};

constexpr int kBK = kKc;          // pairs of one staged step
constexpr int kBStages = 4;       // steps in the ring
constexpr int LDB = 128 + 8;      // staged row stride (elements)
constexpr int kBStage = 2 * kBK * LDB;  // A block then B block
template <typename T>
constexpr size_t kBSmemBytes = sizeof(T) * kBStages * kBStage;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_kernel(const WJobs<T> jobs, float* __restrict__ wpart, long long part_ld, long long P,
             long long k_slice) {
  static_assert(sizeof(T) == 2, "bf16 only: float32 runs wgrad_wg.cuh");
  extern __shared__ __align__(16) float smem_f[];
  T* smem = reinterpret_cast<T*>(smem_f);
  const WJob<T> jb = jobs.job[blockIdx.x];
  const long long k_begin = (long long)blockIdx.y * k_slice;
  const long long k_end = min(P, k_begin + k_slice);
  const int n_steps = k_end > k_begin ? (int)((k_end - k_begin + kBK - 1) / kBK) : 0;

  // Step `it`'s rows of A and Bm into its stage (16 bytes a copy, 4 a
  // thread; rows past the slice zero), then one commit
  // group (empty past the last step), so every thread's group count is the
  // step index.
  constexpr int kVec = 16 / sizeof(T), kPerRow = 128 / kVec;
  auto start = [&](int it) {
    if (it < n_steps) {
      T* stage = smem + (it % kBStages) * kBStage;
#pragma unroll
      for (int part = 0; part < 2 * kBK * kPerRow / kThreads; ++part) {
        const int idx = threadIdx.x + part * kThreads;
        const int op = idx / (kBK * kPerRow), r = (idx / kPerRow) % kBK;
        const int c = (idx % kPerRow) * kVec;
        const long long k = k_begin + (long long)it * kBK + r;
        const bool v = k < k_end;
        const long long kr = v ? k : k_begin;
        const T* src = op ? jb.b + kr * jb.ldb + c : jb.a + kr * jb.lda + c;
        cp_async16_zfill(stage + (op * kBK + r) * LDB + c, src, v);
      }
    }
    cp_async_commit();
  };
  for (int it = 0; it < kBStages - 1; ++it) start(it);

  // Warp w owns rows 64 (w % 2) .. and columns 32 (w / 2) .. of the tile:
  // 4 x 4 MMA tiles of 16 x 8.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 64 + g, n0 = (warp >> 1) * 32 + g;
  float acc[4][4][4] = {};
  for (int it = 0; it < n_steps; ++it) {
    cp_async_wait<kBStages - 2>();
    __syncthreads();  // step it landed; every warp has left step it - 1
    start(it + kBStages - 1);
    const T* As = smem + (it % kBStages) * kBStage;
    const T* Bs = As + kBK * LDB;
    float part[4][4][4] = {};  // this step's sum
    // This lane's ldmatrix row: k row lane % 16; lanes 16-31 the next 8
    // columns. B's matrices are b0, b1 of two n-tiles; A^T's (As[k][m])
    // are a0, a2, a1, a3.
    const int off = (lane & 15) * LDB + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(b[np], Bs + kk * LDB + off + n0 - g + np * 16);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, As + kk * LDB + off + m0 - g + mi * 16);
        const uint32_t a[4] = {r[0], r[2], r[1], r[3]};
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16(part[mi][2 * np], a, b[np][0], b[np][1]);
          mma_bf16(part[mi][2 * np + 1], a, b[np][2], b[np][3]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] += part[mi][ni][q];
  }
  cp_async_wait<0>();
  if ((warp & 1) * 64 >= jb.rows) return;  // warp-uniform

  float* out = wpart + (size_t)blockIdx.y * part_ld + jb.out_off;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = m0 + mi * 16, c = n0 - g + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + (size_t)r * jb.out_ld + c) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(out + (size_t)(r + 8) * jb.out_ld + c) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// Jobs 0 .. n - 1 over P pairs in `slices` K slices of whole steps; partial
// sets of part_ld floats at wpart. Returns a cudaError_t.
template <typename T>
cudaError_t launch_wgrad(const WJobs<T>& jobs, int n, int slices, float* wpart,
                         long long part_ld, long long P, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBSmemBytes<T>);
  if (err != cudaSuccess) return err;
  const long long k_slice = ((P + slices - 1) / slices + kBK - 1) / kBK * kBK;
  wgrad_kernel<T><<<dim3(n, slices), kThreads, kBSmemBytes<T>, stream>>>(jobs, wpart, part_ld,
                                                                           P, k_slice);
  return cudaGetLastError();
}

// Blocks of kThreads for a grid-stride loop over `total` items (at most 4096).
int grid_of(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  return (int)(want < 4096 ? (want > 0 ? want : 1) : 4096);
}

}  // namespace
}  // namespace fdk
