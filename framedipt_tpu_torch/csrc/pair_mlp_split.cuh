// The pair MLP's split backward around its kernel A, for Hopper (sm_90a),
// shared by the float32 backward (pair_mlp_bwd_wg.cu) and the bf16 one
// (pair_mlp_bwd_wg_bf16.cu), both with kernel A on wgmma: the chunk's
// workspace layout that kernel A fills, the row and column sums, kernel B's
// jobs (on wgmma and TMA; float32: wgrad_wg.cuh, bf16: wgrad_bf16.cuh) and
// the ordered sums into the outputs (finish_split).
// Include it after the tile header (pair_mlp_wg.cuh, or pair_mlp_wg_bf16.cuh
// with its widths brought into fdk), which gives C_IN, HID and C_OUT.
// pair_mlp_bwd_wg_bf16.cu's header describes the whole backward.
#pragma once

#include "wgrad_bf16.cuh"

namespace fdk {
namespace {

static_assert(C_IN == 128 && HID == 384 && C_OUT == 128, "the pair MLP's widths");

// Offsets of the grid-summed gradients (floats); mirrored in
// model/kernels/pair_mlp.py (_W_PARTS).
constexpr int OFF_W0 = 0, OFF_W1 = OFF_W0 + C_IN * HID, OFF_WF = OFF_W1 + HID * HID,
              OFF_B1 = OFF_WF + HID * C_OUT, OFF_BF = OFF_B1 + HID, OFF_LNS = OFF_BF + C_OUT,
              OFF_LNB = OFF_LNS + C_OUT, OFF_WFE = OFF_LNB + C_OUT,
              kWParts = OFF_WFE + C_IN * C_OUT;
constexpr int kRowPart = HID + C_OUT + 1;  // d_i_term | d_fi | d_mask
constexpr int kVec = HID + 3 * C_OUT;      // d_b1 | d_bf | d_ln_scale | d_ln_bias
constexpr int kGroup = 32;                 // tile partials summed 32 at a time
constexpr int kSlices = 8;                 // K slices of kernel B
static_assert(OFF_B1 + kVec == OFF_WFE, "the vector sums sit between d_wf and d_wfe");

// bf16 keeps dxd = bf16(dx) beside dx.
template <typename T>
constexpr bool kBf16 = sizeof(T) == 2;

// A chunk's workspace, in this order: y0, y1, dy1, dy0 [P, 384] and (bf16)
// dxd [P, 128] as T; then float32: dx [P, 128], kernel B's partials
// [kSlices, kWParts], the tiles' vector partials [groups * kGroup, kVec],
// their group sums [groups, kVec], dem [P]. In float32 dxd is dx. Every
// array starts 16-byte aligned. Mirrored in model/kernels/pair_mlp.py
// (split_workspace_floats).
template <typename T>
struct SplitWs {
  T *y0, *y1, *dy1, *dy0, *dxd;
  float *dx, *wpart, *vpart, *vmid, *dem;
};

inline long long split_tiles(long long P) { return (P + kRows - 1) / kRows; }
inline long long split_groups(long long P) { return (split_tiles(P) + kGroup - 1) / kGroup; }

template <typename T>
constexpr int kActs = 4 * HID + (kBf16<T> ? C_OUT : 0);  // T elements a pair
static_assert(kActs<__nv_bfloat16> % 8 == 0, "16-byte aligned float32 arrays after the T ones");

template <typename T>
long long split_ws_floats(long long P) {
  return P * kActs<T> * (long long)sizeof(T) / 4 + P * (C_OUT + 1) +
         (long long)kSlices * kWParts + (split_groups(P) * kGroup + split_groups(P)) * kVec;
}

template <typename T>
SplitWs<T> split_ws(float* ws, long long P) {
  SplitWs<T> w;
  w.y0 = reinterpret_cast<T*>(ws);
  w.y1 = w.y0 + P * HID;
  w.dy1 = w.y1 + P * HID;
  w.dy0 = w.dy1 + P * HID;
  T* next = w.dy0 + P * HID;
  if constexpr (kBf16<T>) {
    w.dxd = next;
    next += P * C_OUT;
  }
  w.dx = reinterpret_cast<float*>(next);
  if constexpr (!kBf16<T>) w.dxd = w.dx;
  w.wpart = w.dx + P * C_OUT;
  w.vpart = w.wpart + (long long)kSlices * kWParts;
  w.vmid = w.vpart + split_groups(P) * kGroup * kVec;
  w.dem = w.vmid + split_groups(P) * kVec;
  return w;
}

// A workspace value as float.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// d_i_term | d_fi | d_row_mask of the chunk's rows m0 .. m0 + rows - 1 (a
// row lies in one chunk), each a sum over j in order.
template <typename T>
__global__ void row_sums(const T* __restrict__ dy0, const float* __restrict__ dx,
                         const float* __restrict__ dem, const T* __restrict__ col_mask,
                         float* __restrict__ rowred, int m0, int rows, int Nr, int Nc) {
  const long long total = (long long)rows * kRowPart;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int lr = (int)(idx / kRowPart), c = (int)(idx - (long long)lr * kRowPart);
    const int m = m0 + lr, b = m / Nr;
    const size_t base = (size_t)lr * Nc;
    // Unrolled so that several loads are in flight; the adds stay in order.
    float s = 0.f;
    if (c < HID) {
#pragma unroll 8
      for (int j = 0; j < Nc; ++j) s += to_f(dy0[(base + j) * HID + c]);
    } else if (c < HID + C_OUT) {
#pragma unroll 8
      for (int j = 0; j < Nc; ++j) s += dx[(base + j) * C_OUT + c - HID];
    } else {
      for (int j = 0; j < Nc; ++j) s += dem[base + j] * ld<T>(col_mask + (size_t)b * Nc + j);
    }
    rowred[(size_t)m * kRowPart + c] = s;
  }
}

// d_j_term | d_fj | d_col_mask over the chunk's rows m0 .. m1 - 1 of the
// batches b_lo .. b_lo + nb - 1, each a sum over i in order, added to
// colred (the chunks run in order).
template <typename T>
__global__ void col_sums(const T* __restrict__ dy0, const float* __restrict__ dx,
                         const float* __restrict__ dem, const T* __restrict__ row_mask,
                         float* __restrict__ colred, int m0, int m1, int b_lo, int nb, int Nr,
                         int Nc) {
  const long long total = (long long)nb * Nc * kRowPart;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int bj = (int)(idx / kRowPart), c = (int)(idx - (long long)bj * kRowPart);
    const int b = b_lo + bj / Nc, j = bj % Nc;
    const int lo = max(m0, b * Nr), hi = min(m1, (b + 1) * Nr);
    float s = 0.f;
    const size_t p0 = (size_t)(lo - m0) * Nc + j;
    if (c < HID) {
#pragma unroll 8
      for (int m = lo; m < hi; ++m) s += to_f(dy0[(p0 + (size_t)(m - lo) * Nc) * HID + c]);
    } else if (c < HID + C_OUT) {
#pragma unroll 8
      for (int m = lo; m < hi; ++m) s += dx[(p0 + (size_t)(m - lo) * Nc) * C_OUT + c - HID];
    } else {
      for (int m = lo; m < hi; ++m) s += dem[p0 + (size_t)(m - lo) * Nc] * ld<T>(row_mask + m);
    }
    float* dst = colred + ((size_t)b * Nc + j) * kRowPart + c;
    *dst += s;
  }
}

// Everything of one chunk (rows m0 .. m1 - 1 of the flat [B * Nr] grid) but
// kernel A, once kernel A has filled the workspace ws: the row and column
// sums, kernel B, then the fixed-order sums into the outputs.
template <typename T, bool RESIDUAL>
cudaError_t finish_split(const T* pair, const T* row_mask, const T* col_mask,
                         const SplitWs<T>& ws, float* wred, float* rowred, float* colred,
                         int Nr, int Nc, int m0, int m1, cudaStream_t stream) {
  const long long q0 = (long long)m0 * Nc, P = (long long)(m1 - m0) * Nc;
  const long long groups = split_groups(P);
  cudaError_t err;

  // Row and column sums.
  row_sums<<<grid_of((long long)(m1 - m0) * kRowPart), kThreads, 0, stream>>>(
      ws.dy0, ws.dx, ws.dem, col_mask, rowred, m0, m1 - m0, Nr, Nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int b_lo = m0 / Nr, nb = (m1 - 1) / Nr - b_lo + 1;
  col_sums<<<grid_of((long long)nb * Nc * kRowPart), kThreads, 0, stream>>>(
      ws.dy0, ws.dx, ws.dem, row_mask, colred, m0, m1, b_lo, nb, Nr, Nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // Kernel B: d_w0 = pair^T dy0, d_w1 = y0^T dy1, d_wf = y1^T dxd, d_wfe =
  // pair^T dxd, as 128 x 128 tiles over tensor maps of pair, y0, y1, dy0,
  // dy1 and dxd (float32: dx), in T (wgrad_map's overloads).
  const T* pc = pair + q0 * C_IN;
  enum { kPair, kY0, kY1, kDy0, kDy1, kDxd };
  WgradJobs jobs;
  if (!wgrad_map(jobs, kPair, pc, P, C_IN) || !wgrad_map(jobs, kY0, ws.y0, P, HID) ||
      !wgrad_map(jobs, kY1, ws.y1, P, HID) || !wgrad_map(jobs, kDy0, ws.dy0, P, HID) ||
      !wgrad_map(jobs, kDy1, ws.dy1, P, HID) || !wgrad_map(jobs, kDxd, ws.dxd, P, C_OUT))
    return cudaErrorInvalidValue;
  int n = 0;
  for (int c = 0; c < HID / 128; ++c)
    jobs.job[n++] = {kPair, 0, kDy0, c * 128, OFF_W0 + c * 128, HID, 128};
  for (int r = 0; r < HID / 128; ++r)
    for (int c = 0; c < HID / 128; ++c)
      jobs.job[n++] = {kY0, r * 128, kDy1, c * 128, OFF_W1 + r * 128 * HID + c * 128, HID, 128};
  for (int r = 0; r < HID / 128; ++r)
    jobs.job[n++] = {kY1, r * 128, kDxd, 0, OFF_WF + r * 128 * C_OUT, C_OUT, 128};
  if (RESIDUAL) jobs.job[n++] = {kPair, 0, kDxd, 0, OFF_WFE, C_OUT, 128};
  if constexpr (kBf16<T>)
    err = launch_wgrad_bf16<T>(jobs, n, kSlices, ws.wpart, kWParts, P, stream);
  else
    err = launch_wgrad_wg(jobs, n, kSlices, ws.wpart, kWParts, P, stream);
  if (err != cudaSuccess) return err;

  // Fixed-order sums into the outputs.
  if ((err = reduce_partials(ws.wpart, wred, 1, kSlices, OFF_B1, kWParts, stream, true)) !=
      cudaSuccess)
    return err;
  if (RESIDUAL &&
      (err = reduce_partials(ws.wpart + OFF_WFE, wred + OFF_WFE, 1, kSlices, C_IN * C_OUT,
                             kWParts, stream, true)) != cudaSuccess)
    return err;
  if ((err = reduce_partials(ws.vpart, ws.vmid, groups, kGroup, kVec, kVec, stream)) !=
      cudaSuccess)
    return err;
  return reduce_partials(ws.vmid, wred + OFF_B1, 1, (int)groups, kVec, kVec, stream, true);
}

}  // namespace
}  // namespace fdk
