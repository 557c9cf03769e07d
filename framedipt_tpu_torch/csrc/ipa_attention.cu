// Fused Invariant Point Attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/ipa_attention.py
// (_ipa_attention_kernel, reached through fused_ipa_attention). Per query
// row i and head h, over all keys j of the sample:
//
//   s_hij = q_ih . k_jh + qhat_ih . khat_jh + (z_ij @ Wb)_h + inf * (m_i m_j - 1)
//   p_hij = softmax_j(s_hij)                                   float32
//   o_ih      = sum_j rnd(p_hij) v_jh                          [C]
//   o_pt_ih   = sum_j p_hij vpt_jh                             [PVW], float32 p
//   o_pair_ih = sum_j rnd(p_hij) rnd(z_ij @ Wdz)               [DZ]
//   each output times m_i (a fully masked row gives exactly 0)
//
// rnd() rounds to the element type T (float or bf16); every product
// accumulates in float32. q arrives pre-scaled by sqrt(1/(3C)), Wb by
// sqrt(1/3), the points augmented so qhat . khat = -0.5 w_h |q_pts - k_pts|^2.
//
// Bound on an H100 SXM at B=2, N=256, float32: 2*B*N^2*(H*(2C + PQW + PVW)
// + CZ*(H + DZ) + H*DZ) = 2.6 GFLOP against 67 MB of z: ~39 us at 67 TFLOP/s
// on the CUDA cores (operations); in bf16 ~10 us, set by the bytes of z.
//
// Design: one block of 512 threads per (sample, TI = 4 query rows), all
// heads, so z is read once and projected once for all heads (the TPU
// kernel's round-2 lesson). Keys do not fit in shared memory whole (one
// head's k and v at N=256 are 512 KB in float32), so they stream in tiles of
// TJ = 32 with an online softmax: a running max and sum per (row, head) and
// accumulators for o (registers: a thread owns one channel of every row of
// its heads), o_pt and o_pair (shared memory), rescaled when the max moves.
// Per key tile the block (1) stages the [TI x TJ x CZ] z tile and projects
// it onto [Wb | Wdz] into zb [TI*TJ][H] (float32) and pz [TI*TJ][DZ]
// (rounded) in shared memory; then two groups of 8 warps walk heads 0-3 and
// 4-7 side by side, each head in three steps: (2) the logits, eight threads
// per (key, all TI rows) splitting the C-long dot product, with the v loads
// issued as soon as k's registers are free; (3) the softmax update, one warp
// per row; (4) p.v (thread per channel), p.vpt and p.pz. The rounding of p
// differs from the plain version's only in that the kernel rounds
// exp(s - running max) before dividing by the sum: in float32 that is the
// same number, in bf16 the same relative error. The TPU kernel's
// block-diagonal p_band product, one-hot head reduce and 128-lane padding
// have no counterpart: on a GPU o_pair is a per-row sum.
// What bounds it (PERF.md, measured versions v1-v5): not the FLOPs, nor the
// card's L2 bandwidth, but each SM's waiting, on L2 and on three barriers
// per head and key tile, with one block per SM at the serving shapes.
// Twice the warps (the two head groups) took 1.38x; rows per block (TI = 8)
// did not help. Shared memory is 155 KB, registers are capped at 128 (a
// few hundred bytes spill). The products run on the CUDA cores in float32
// for both element types.
#include "common.cuh"

namespace fdk {
namespace {

constexpr int H = 8, C = 256, PQW = 28, PVW = 36, CZ = 128, DZ = 32;
constexpr int NP = H + DZ;       // pair projection outputs: bias lanes, then pair values
constexpr int NT = 512;          // threads per block
constexpr int GT = 256;          // threads per head group
constexpr int HG = NT / GT;      // head groups: group g walks heads g*HPG .. g*HPG + HPG - 1
constexpr int HPG = H / HG;
constexpr int TI = 4, TJ = 32;   // query rows per block, keys per tile
constexpr int NPAIR = TI * TJ;   // pairs per tile
constexpr int LDZ = CZ + 4;      // padded z row: conflict-free float4 reads
constexpr int HC = H * C;
constexpr int PT = NT / NPAIR;   // threads per pair in the projection
constexpr int NOUT = NP / PT;    // projection outputs per thread
constexpr int KP = GT / TJ;      // threads per key in the logits
static_assert(C == GT, "one thread of a group per channel of o");
static_assert(NP % PT == 0 && NOUT % 2 == 0, "projection outputs split evenly, float2 aligned");
static_assert(TJ <= 32 && TI <= GT / 32, "one warp per row, one lane per key in the softmax");
static_assert(KP >= TI && C % (4 * KP) == 0, "logit threads cover the rows and channels");

constexpr int kSmemFloats = TI * HC + TI * H * PQW + CZ * NP + NPAIR * LDZ + NPAIR * H +
                            NPAIR * DZ + HG * (2 * TI * TJ + TI) + 2 * TI * H + TI * H * PVW +
                            TI * H * DZ + TI + TJ;
constexpr size_t kSmemBytes = (size_t)kSmemFloats * sizeof(float);

// Four consecutive elements of T as floats (the address is 4-element aligned).
template <typename T> __device__ __forceinline__ float4 ld4(const T* p);
template <> __device__ __forceinline__ float4 ld4<float>(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
template <> __device__ __forceinline__ float4 ld4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
ipa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ qhat,
                     const float* __restrict__ khat, const float* __restrict__ vpt,
                     const T* __restrict__ z, const float* __restrict__ mask,
                     const T* __restrict__ wb, const T* __restrict__ wdz,
                     float* __restrict__ o, float* __restrict__ o_pt,
                     float* __restrict__ o_pair, int N, float inf) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [TI][H*C]       query rows
  float* QH = Qs + TI * HC;           // [TI][H*PQW]     augmented query points
  float* W = QH + TI * H * PQW;       // [CZ][NP]        Wb | Wdz
  float* ZS = W + CZ * NP;            // [NPAIR][LDZ]    staged z tile
  float* ZB = ZS + NPAIR * LDZ;       // [NPAIR][H]      pair bias, float32
  float* PZ = ZB + NPAIR * H;         // [NPAIR][DZ]     down-projected pair, rounded
  float* M = PZ + NPAIR * DZ;         // [TI][H]         running max
  float* L = M + TI * H;              // [TI][H]         running sum
  float* OPT = L + TI * H;            // [TI][H][PVW]    o_pt accumulators
  float* OPR = OPT + TI * H * PVW;    // [TI][H][DZ]     o_pair accumulators
  float* RM = OPR + TI * H * DZ;      // [TI]            row mask
  float* CM = RM + TI;                // [TJ]            column mask of the key tile
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = tid / GT, lt = tid % GT, gwarp = lt >> 5;  // head group, thread and warp in it
  float* P = CM + TJ + g * (2 * TI * TJ + TI);  // [TI][TJ] this group's logits, then weights
  float* PC = P + TI * TJ;                      // [TI][TJ] weights rounded to T
  float* CORR = PC + TI * TJ;                   // [TI]     rescale of the running sums

  const int b = blockIdx.y, i0 = blockIdx.x * TI;
  const int rows = min(TI, N - i0);
  const size_t row0 = (size_t)b * N + i0;  // flat index of query row 0
  const size_t key0 = (size_t)b * N;       // flat index of key 0

  for (int idx = tid; idx < TI * HC / 4; idx += NT) {
    const int r = idx / (HC / 4), c = (idx - r * (HC / 4)) * 4;
    const float4 x = r < rows ? ld4<T>(q + (row0 + r) * HC + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(Qs + r * HC + c) = x;
  }
  for (int idx = tid; idx < TI * H * PQW; idx += NT) {
    const int r = idx / (H * PQW);
    QH[idx] = r < rows ? __ldg(qhat + (row0 + r) * (H * PQW) + idx - r * (H * PQW)) : 0.f;
  }
  for (int idx = tid; idx < CZ * NP; idx += NT) {
    const int kk = idx / NP, n = idx - kk * NP;
    W[idx] = n < H ? ld<T>(wb + kk * H + n) : ld<T>(wdz + kk * DZ + n - H);
  }
  for (int idx = tid; idx < TI * H; idx += NT) {
    M[idx] = -INFINITY;
    L[idx] = 0.f;
  }
  for (int idx = tid; idx < TI * H * PVW; idx += NT) OPT[idx] = 0.f;
  for (int idx = tid; idx < TI * H * DZ; idx += NT) OPR[idx] = 0.f;
  if (tid < TI) RM[tid] = tid < rows ? __ldg(mask + row0 + tid) : 0.f;

  float oacc[HPG][TI];
#pragma unroll
  for (int hh = 0; hh < HPG; ++hh)
#pragma unroll
    for (int r = 0; r < TI; ++r) oacc[hh][r] = 0.f;

  for (int j0 = 0; j0 < N; j0 += TJ) {
    const int cols = min(TJ, N - j0);

    // (1) Project the z tile onto [Wb | Wdz], once for all heads: stage the
    // whole tile (all loads in flight at once), then thread (pair p, part
    // qp) computes NOUT of the NP outputs of pair p. The barrier that ends
    // the previous tile's head loop frees ZS, ZB, PZ and CM.
#pragma unroll
    for (int idx = tid; idx < NPAIR * CZ / 4; idx += NT) {
      const int pp = idx / (CZ / 4), c = (idx - pp * (CZ / 4)) * 4;
      const int r = pp / TJ, j = pp - r * TJ;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && j < cols) x = ld4<T>(z + ((row0 + r) * N + j0 + j) * CZ + c);
      *reinterpret_cast<float4*>(ZS + pp * LDZ + c) = x;
    }
    if (tid < TJ) CM[tid] = tid < cols ? __ldg(mask + key0 + j0 + tid) : 0.f;
    __syncthreads();
    {
      const int p = tid % NPAIR, qp = tid / NPAIR;
      float acc[NOUT];
#pragma unroll
      for (int n = 0; n < NOUT; ++n) acc[n] = 0.f;
      const float* zr = ZS + p * LDZ;
      const float* wr = W + qp * NOUT;
#pragma unroll 2
      for (int kk = 0; kk < CZ; kk += 4) {
        const float4 zv = *reinterpret_cast<const float4*>(zr + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float zu = lane4(zv, u);
#pragma unroll
          for (int n = 0; n < NOUT; n += 2) {
            const float2 w = *reinterpret_cast<const float2*>(wr + (kk + u) * NP + n);
            acc[n] = fmaf(zu, w.x, acc[n]);
            acc[n + 1] = fmaf(zu, w.y, acc[n + 1]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NOUT; ++n) {
        const int col = qp * NOUT + n;
        if (col < H)
          ZB[p * H + col] = acc[n];
        else
          PZ[p * DZ + col - H] = rnd<T>(acc[n]);
      }
    }
    __syncthreads();

    // The two head groups walk their heads side by side, in step with the
    // block's barriers.
#pragma unroll
    for (int hh = 0; hh < HPG; ++hh) {
      const int h = g * HPG + hh;
      // (2) Logits of key j for all TI rows: KP threads split the C-long dot
      // product (thread part takes the float4 at channels 4 KP s + 4 part,
      // so they cover 16 KP contiguous bytes of k), then reduce. Keys past
      // N read nothing and count as 0. The v loads of step (4) go out as
      // soon as k's registers are free, and wait through the reduction,
      // the softmax and two barriers.
      const int j = lt / KP, part = lt % KP;
      const bool key = j < cols;
      float vv[TJ];
      {
        float acc[TI];
        {
          float4 kv[C / (4 * KP)];
          const T* kr = k + (key0 + j0 + j) * HC + h * C + part * 4;
#pragma unroll
          for (int s = 0; s < C / (4 * KP); ++s)
            kv[s] = key ? ld4<T>(kr + s * 4 * KP) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int r = 0; r < TI; ++r) {
            acc[r] = 0.f;
#pragma unroll
            for (int s = 0; s < C / (4 * KP); ++s)
              acc[r] = dot4(*reinterpret_cast<const float4*>(Qs + r * HC + h * C + s * 4 * KP + part * 4),
                            kv[s], acc[r]);
          }
        }
        const T* vr = v + (key0 + j0) * HC + h * C + lt;
#pragma unroll
        for (int jj = 0; jj < TJ; ++jj) vv[jj] = jj < cols ? ld<T>(vr + (size_t)jj * HC) : 0.f;
#pragma unroll
        for (int r = 0; r < TI; ++r)
#pragma unroll
          for (int o = KP / 2; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
        if (part < TI) {
          const int r = part;
          float logit = -INFINITY;  // keys past N take no weight
          if (key) {
            const float* kh = khat + (key0 + j0 + j) * (H * PQW) + h * PQW;
            const float* qh = QH + r * (H * PQW) + h * PQW;
            float pt = 0.f;
#pragma unroll
            for (int e = 0; e < PQW; e += 4)
              pt = dot4(*reinterpret_cast<const float4*>(qh + e),
                        __ldg(reinterpret_cast<const float4*>(kh + e)), pt);
            float sacc = 0.f;
#pragma unroll
            for (int rr = 0; rr < TI; ++rr) sacc = rr == r ? acc[rr] : sacc;
            logit = sacc + pt + ZB[(r * TJ + j) * H + h] + inf * (RM[r] * CM[j] - 1.f);
          }
          P[r * TJ + j] = logit;
        }
      }
      __syncthreads();

      // (3) Online softmax update, one warp per row, one lane per key.
      if (gwarp < TI) {
        const int r = gwarp;
        const float s = lane < TJ ? P[r * TJ + lane] : -INFINITY;
        const float m_old = M[r * H + h];
        const float m_new = fmaxf(m_old, warp_max(s));
        const float e = expf(s - m_new);
        if (lane < TJ) {
          P[r * TJ + lane] = e;
          PC[r * TJ + lane] = rnd<T>(e);
        }
        const float sum = warp_sum(e);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);  // 0 on the first tile
          CORR[r] = corr;
          M[r * H + h] = m_new;
          L[r * H + h] = L[r * H + h] * corr + sum;
        }
      }
      __syncthreads();

      // (4) Accumulate: o (thread = channel, registers), then o_pt and o_pair
      // (one thread per output lane, shared memory). Keys past N have
      // weight 0 and read nothing.
      {
        float acc[TI];
#pragma unroll
        for (int r = 0; r < TI; ++r) {
          acc[r] = 0.f;
#pragma unroll
          for (int jj = 0; jj < TJ; jj += 4)
            acc[r] = dot4(*reinterpret_cast<const float4*>(PC + r * TJ + jj),
                          make_float4(vv[jj], vv[jj + 1], vv[jj + 2], vv[jj + 3]), acc[r]);
        }
#pragma unroll
        for (int r = 0; r < TI; ++r) oacc[hh][r] = oacc[hh][r] * CORR[r] + acc[r];
      }
      for (int idx = lt; idx < TI * (PVW + DZ); idx += GT) {
        if (idx < TI * PVW) {
          const int r = idx / PVW, e = idx - r * PVW;
          const float* vp = vpt + (key0 + j0) * (H * PVW) + h * PVW + e;
          float a = 0.f;
#pragma unroll
          for (int jj = 0; jj < TJ; ++jj)
            a = fmaf(P[r * TJ + jj], jj < cols ? __ldg(vp + (size_t)jj * (H * PVW)) : 0.f, a);
          float& dst = OPT[(r * H + h) * PVW + e];
          dst = dst * CORR[r] + a;
        } else {
          const int r = (idx - TI * PVW) / DZ, d = (idx - TI * PVW) - r * DZ;
          float a = 0.f;
#pragma unroll
          for (int jj = 0; jj < TJ; ++jj) a = fmaf(PC[r * TJ + jj], PZ[(r * TJ + jj) * DZ + d], a);
          float& dst = OPR[(r * H + h) * DZ + d];
          dst = dst * CORR[r] + a;
        }
      }
      __syncthreads();
    }
  }

  // Normalize, zero the masked rows, store.
#pragma unroll
  for (int hh = 0; hh < HPG; ++hh) {
    const int h = g * HPG + hh;
#pragma unroll
    for (int r = 0; r < TI; ++r)
      if (r < rows) o[(row0 + r) * HC + h * C + lt] = oacc[hh][r] / L[r * H + h] * RM[r];
  }
  for (int idx = tid; idx < TI * H * PVW; idx += NT) {
    const int r = idx / (H * PVW), h = (idx - r * H * PVW) / PVW;
    if (r < rows) o_pt[(row0 + r) * (H * PVW) + idx - r * H * PVW] = OPT[idx] / L[r * H + h] * RM[r];
  }
  for (int idx = tid; idx < TI * H * DZ; idx += NT) {
    const int r = idx / (H * DZ), h = (idx - r * H * DZ) / DZ;
    if (r < rows) o_pair[(row0 + r) * (H * DZ) + idx - r * H * DZ] = OPR[idx] / L[r * H + h] * RM[r];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* qhat,
                   const float* khat, const float* vpt, const void* z, const float* mask,
                   const void* wb, const void* wdz, float* o, float* o_pt, float* o_pair,
                   int B, int N, float inf, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ipa_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  if (B == 0 || N == 0) return cudaSuccess;
  const dim3 grid((unsigned)((N + TI - 1) / TI), (unsigned)B);
  ipa_attention_kernel<T><<<grid, NT, kSmemBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, qhat, khat, vpt, (const T*)z, mask,
      (const T*)wb, (const T*)wdz, o, o_pt, o_pair, N, inf);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fdk

// C interface. dtype: 0 = float32, 1 = bfloat16 (q, k, v, z, wb, wdz); the
// point inputs, the mask and the three outputs are float32. Layouts:
// q, k, v [B,N,H*C]; qhat, khat [B,N,H*28]; vpt [B,N,H*36]; z [B,N,N,128];
// mask [B,N]; wb [128,H]; wdz [128,32]; o [B,N,H*C]; o_pt [B,N,H*36];
// o_pair [B,N,H*32]. Returns a cudaError_t (0 on success).
extern "C" int fdk_ipa_attention(int dtype, const void* q, const void* k, const void* v,
                                 const float* qhat, const float* khat, const float* vpt,
                                 const void* z, const float* mask, const void* wb,
                                 const void* wdz, float* o, float* o_pt, float* o_pair, int B,
                                 int N, float inf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDK_ARGS q, k, v, qhat, khat, vpt, z, mask, wb, wdz, o, o_pt, o_pair, B, N, inf, s
  if (dtype == 0) return fdk::launch<float>(FDK_ARGS);
  if (dtype == 1) return fdk::launch<__nv_bfloat16>(FDK_ARGS);
#undef FDK_ARGS
  return (int)cudaErrorInvalidValue;
}
