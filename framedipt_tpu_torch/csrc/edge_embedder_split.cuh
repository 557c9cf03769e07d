// The edge embedder's split backward around its kernel A, for Hopper
// (sm_90a), shared by the float32 backward (edge_embedder_bwd_wg.cu, kernel
// A on wgmma) and the bf16 one (edge_embedder_bwd.cu, kernel A on mma.sync):
// the chunk's workspace layout that kernel A fills, the row and column sums,
// kernel B's jobs (on wgmma and TMA; float32: wgrad_wg.cuh, bf16:
// wgrad_bf16.cuh) and the ordered sums into the outputs (finish_split).
// Include it after the tile header (edge_embedder_wg.cuh or
// edge_embedder_tc.cuh), which gives CP, C and MAX_BINS.
// edge_embedder_bwd.cu's header describes the whole backward.
#pragma once

#include "wgrad_bf16.cuh"

namespace fdk {
namespace {

static_assert(CP == 64 && C == 128 && MAX_BINS == 64, "the embedder's widths");

// Offsets of the grid-summed gradients (floats); mirrored in
// model/kernels/edge_embedder.py (_W_PARTS).
constexpr int OFF_WREL = 0, OFF_WDIST = OFF_WREL + CP * C, OFF_W1 = OFF_WDIST + MAX_BINS * C,
              OFF_W2 = OFF_W1 + C * C, OFF_B1 = OFF_W2 + C * C, OFF_B2 = OFF_B1 + C,
              OFF_LNS = OFF_B2 + C, OFF_LNB = OFF_LNS + C, kWParts = OFF_LNB + C;
constexpr int kRowPart = CP + C + 1;  // d_g | d_i_term | d_mask (d_h | d_j_term | d_mask)
constexpr int kGroup = 32;   // kernel A's partials summed 32 at a time
constexpr int kSlices = 44;  // K slices of kernel B: 3 jobs x 44 = 132 blocks
constexpr int kBParts = CP * C + 2 * C * C;  // kernel B's partial set: d_w_rel | d_w1 | d_w2
static_assert(OFF_W2 == OFF_W1 + C * C && OFF_LNB == OFF_B1 + 3 * C, "contiguous sums");

// One vector partial of kernel A: d_b1 | d_b2 | d_ln_scale | d_ln_bias |
// d_w_dist.
__host__ __device__ inline int vec_floats(int n_bins) { return (4 + n_bins) * C; }

// A chunk's workspace, in this order: y0, y1 [P, 128], m [P, 64], dx (bf16:
// dxd), dy1, dy0 [P, 128] as T; then float32: dm [P, 64], kernel B's
// partials [kSlices, kBParts], kernel A's `parts` vector partials (float32:
// one a unit of one grid row and 64 columns; bf16: one a 64-pair tile of the
// chunk's flat pairs) as [groups * kGroup, vec], their group sums [groups,
// vec], dem [P]. Every array starts 16-byte aligned (kernel B's tensor maps
// need it). Mirrored in model/kernels/edge_embedder.py
// (split_workspace_floats).
template <typename T>
struct SplitWs {
  T *y0, *y1, *m, *dx, *dy1, *dy0;
  float *dm, *wpart, *vpart, *vmid, *dem;
};

inline long long split_tiles(long long P) { return (P + kRows - 1) / kRows; }
inline long long split_groups(long long parts) { return (parts + kGroup - 1) / kGroup; }

constexpr int kActs = 5 * C + CP;  // T elements a pair
static_assert(kActs * sizeof(__nv_bfloat16) % 16 == 0, "16-byte aligned float32 arrays after the T ones");

template <typename T>
long long split_ws_floats(long long P, long long parts, int n_bins) {
  return P * kActs * (long long)sizeof(T) / 4 + P * (CP + 1) + (long long)kSlices * kBParts +
         (split_groups(parts) * kGroup + split_groups(parts)) * vec_floats(n_bins);
}

template <typename T>
SplitWs<T> split_ws(float* ws, long long P, long long parts, int n_bins) {
  SplitWs<T> w;
  w.y0 = reinterpret_cast<T*>(ws);
  w.y1 = w.y0 + P * C;
  w.m = w.y1 + P * C;
  w.dx = w.m + P * CP;
  w.dy1 = w.dx + P * C;
  w.dy0 = w.dy1 + P * C;
  w.dm = reinterpret_cast<float*>(w.dy0 + P * C);
  w.wpart = w.dm + P * CP;
  w.vpart = w.wpart + (long long)kSlices * kBParts;
  w.vmid = w.vpart + split_groups(parts) * kGroup * vec_floats(n_bins);
  w.dem = w.vmid + split_groups(parts) * vec_floats(n_bins);
  return w;
}

// A workspace value as float.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// d_g | d_i_term | d_row_mask of the chunk's rows m0 .. m0 + rows - 1 (a row
// lies in one chunk), each a sum over j in order.
template <typename T>
__global__ void emb_row_sums(const T* __restrict__ dy0, const float* __restrict__ dm,
                             const float* __restrict__ dem, const T* __restrict__ hf,
                             const T* __restrict__ col_mask, float* __restrict__ rowred,
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
      const T* hb = hf + (size_t)b * Nc * CP + c;
#pragma unroll 32
      for (int j = 0; j < Nc; ++j) s += __fmul_rn(dm[(base + j) * CP + c], ld<T>(hb + (size_t)j * CP));
    } else if (c < CP + C) {
#pragma unroll 32
      for (int j = 0; j < Nc; ++j) s += to_f(dy0[(base + j) * C + c - CP]);
    } else {
      for (int j = 0; j < Nc; ++j)
        s += __fmul_rn(dem[base + j], ld<T>(col_mask + (size_t)b * Nc + j));
    }
    rowred[(size_t)m * kRowPart + c] = s;
  }
}

// d_h | d_j_term | d_col_mask over the chunk's rows m0 .. m1 - 1 of the
// batches b_lo .. b_lo + nb - 1, each a sum over i in order, added to colred
// (the chunks run in order).
template <typename T>
__global__ void emb_col_sums(const T* __restrict__ dy0, const float* __restrict__ dm,
                             const float* __restrict__ dem, const T* __restrict__ gf,
                             const T* __restrict__ row_mask, float* __restrict__ colred,
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
        s += __fmul_rn(dm[(p0 + (size_t)(m - lo) * Nc) * CP + c], ld<T>(gf + (size_t)m * CP + c));
    } else if (c < CP + C) {
#pragma unroll 32
      for (int m = lo; m < hi; ++m) s += to_f(dy0[(p0 + (size_t)(m - lo) * Nc) * C + c - CP]);
    } else {
      for (int m = lo; m < hi; ++m)
        s += __fmul_rn(dem[p0 + (size_t)(m - lo) * Nc], ld<T>(row_mask + m));
    }
    float* dst = colred + ((size_t)b * Nc + j) * kRowPart + c;
    *dst += s;
  }
}

// Everything of one chunk (rows m0 .. m1 - 1 of the flat [B * Nr] grid) but
// kernel A, once kernel A has filled the workspace ws with its `parts`
// vector partials: the row and column sums, kernel B, then the fixed-order
// sums into the outputs.
template <typename T>
cudaError_t finish_split(const T* g, const T* h, const T* row_mask, const T* col_mask,
                         const SplitWs<T>& ws, long long parts, float* wred, float* rowred,
                         float* colred, int n_bins, int Nr, int Nc, int m0, int m1,
                         cudaStream_t stream) {
  const long long P = (long long)(m1 - m0) * Nc, groups = split_groups(parts);
  const int vec = vec_floats(n_bins);
  cudaError_t err;

  // Row and column sums.
  emb_row_sums<T><<<grid_of((long long)(m1 - m0) * kRowPart), kThreads, 0, stream>>>(
      ws.dy0, ws.dm, ws.dem, h, col_mask, rowred, m0, m1 - m0, Nr, Nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int b_lo = m0 / Nr, nb = (m1 - 1) / Nr - b_lo + 1;
  emb_col_sums<T><<<grid_of((long long)nb * Nc * kRowPart), kThreads, 0, stream>>>(
      ws.dy0, ws.dm, ws.dem, g, row_mask, colred, m0, m1, b_lo, nb, Nr, Nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // Kernel B: d_w_rel = m^T dy0 (64 rows), d_w1 = y0^T dy1, d_w2 = y1^T dx,
  // over tensor maps of m, y0, y1, dy0, dy1 and dx (bf16: dxd), in T
  // (wgrad_map's overloads).
  enum { kM, kY0, kY1, kDy0, kDy1, kDx };
  WgradJobs jobs;
  if (!wgrad_map(jobs, kM, ws.m, P, CP) || !wgrad_map(jobs, kY0, ws.y0, P, C) ||
      !wgrad_map(jobs, kY1, ws.y1, P, C) || !wgrad_map(jobs, kDy0, ws.dy0, P, C) ||
      !wgrad_map(jobs, kDy1, ws.dy1, P, C) || !wgrad_map(jobs, kDx, ws.dx, P, C))
    return cudaErrorInvalidValue;
  jobs.job[0] = {kM, 0, kDy0, 0, 0, C, CP};
  jobs.job[1] = {kY0, 0, kDy1, 0, CP * C, C, 128};
  jobs.job[2] = {kY1, 0, kDx, 0, CP * C + C * C, C, 128};
  if constexpr (sizeof(T) == 2)
    err = launch_wgrad_bf16<T>(jobs, 3, kSlices, ws.wpart, kBParts, P, stream);
  else
    err = launch_wgrad_wg(jobs, 3, kSlices, ws.wpart, kBParts, P, stream);
  if (err != cudaSuccess) return err;

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
