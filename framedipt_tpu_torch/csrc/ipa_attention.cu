// Invariant Point Attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/ipa_attention.py:65
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
// One call runs three kernels, on mma.sync (3xTF32 in float32: each operand
// split into TF32 high and low parts, three products a k step, each 32-deep
// slice summed into zeroed fragments and added with round-to-nearest, as
// the tensor cores truncate their float32 sums; bf16 MMA in bf16):
//
// - Kernel P (pair_proj_kernel) projects every pair onto [Wb | Wdz] once for
//   all heads, [B N N, 128] x [128, 40], reading z once: persistent blocks
//   of 16 warps, 128-pair tiles, the next tile's z in flight while one is
//   multiplied (warp w: 16 pairs, output n-tiles 0-2 or 3-4), the weights
//   split into TF32 halves once a block. It writes the pair bias zb as
//   float32 [B, H, N, N] (a head's keys of a query row contiguous, as kernel
//   S reads them) and the pair values pz = rnd(z @ Wdz) as T [B, N, N, 32].
// - Kernel S (attend_kernel) walks the keys flash-style for one (query tile
//   of TI = 64 rows, head, sample, key split) in tiles of TJ = 32 keys: k
//   and the key points by cp.async into shared memory, the values in
//   flight behind the logits. 8 warps: a pair of warps owns 16 query rows
//   (the online softmax stays inside the four lanes that hold a row's
//   logits), each warp half of the channels: q . k^T over its half, the
//   two partial logits exchanged through shared memory, then o += rnd(p) v
//   over its half of o. The point term runs in float32 on the CUDA cores: it
//   is a sum of large terms that cancel, where 3xTF32 leaves ~2e-4 in a
//   logit at points 10 A from the origin. o_pt += p vpt runs on the tensor
//   cores with float32 p (3xTF32 in both element types). Blocks run
//   head-fastest. S leaves each split's unnormalized sums, running max and
//   row sum, and overwrites zb with the weights p~ = exp(s - m_t) (m_t the
//   running max after key tile t, also kept).
// - Kernel F (finish_kernel) merges the splits in a fixed order and sums
//   o_pair_i = sum_t f_t sum_j rnd(p~_ij) pz_ij for all heads of a row in
//   one pass over the row's pz: a per-row sum, which no MMA across rows
//   computes; inside S, where eight head blocks read pz from L2, that loop
//   took 40% of S's time.
//
// Against the earlier design (one block per 4 query rows and all heads, on
// the CUDA cores), a block re-reads k and v for 64 query rows, not 4: 16x
// fewer L2 bytes, and the products run on the tensor cores. The split count
// (ipa_attention.plan_ipa_splits) keeps the waves of one-block-an-SM
// launches short: at B=2 N=256, 64 row-tile blocks x 2 splits. A key tile or
// split wholly past N keeps a running max of -inf; the rescale and the merge
// weigh it 0 instead of exp(-inf - -inf). No atomics: two launches give the
// same bits. The workspace (zb, pz, the maxima and the split sums: 31 MB at
// B=2 N=256 in float32) is allocated and freed by the caller.
//
// Bound on an H100 SXM at B=2, N=256, float32: 2.6 GFLOP, 2.5 of it on the
// tensor cores (3xTF32: 495/3 TFLOP/s, 0.016 ms), and ~87 MB of inputs and
// outputs (z 67 MB): 0.026 ms, set by the bytes. What bounds it (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md): latency, with one block an SM. P
// moves z, zb and pz at ~1.7 TB/s; with its products removed, its z stream
// alone takes two thirds of its time. No part of S dominates: with q . k,
// p . v, the k and v loads, or zb's reads and the weights' stores removed,
// it takes 13-23% less each. F reads pz and the weights at ~0.75 TB/s.
#include "common.cuh"
#include "mma.cuh"

namespace fdk {
namespace {

constexpr int H = 8, C = 256, PQW = 28, PVW = 36, CZ = 128, DZ = 32;
constexpr int NP = H + DZ;  // pair projection outputs: bias lanes, then pair values
constexpr int HC = H * C;

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

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Four consecutive elements of T from src (4-element aligned) into float
// shared memory at dst, or zeros where !ok: float by cp.async (the caller
// commits and waits), bf16 by a plain load, widened.
template <typename T> __device__ __forceinline__ void stage4(float* dst, const T* src, bool ok);
template <> __device__ __forceinline__ void stage4<float>(float* dst, const float* src, bool ok) {
  cp_async16_zfill(dst, src, ok);
}
template <>
__device__ __forceinline__ void stage4<__nv_bfloat16>(float* dst, const __nv_bfloat16* src,
                                                      bool ok) {
  *reinterpret_cast<float4*>(dst) = ok ? ld4<__nv_bfloat16>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Four floats stored as T (rounded to nearest even for bf16).
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  uint2 u;
  u.x = pack_bf16(x.x, x.y);
  u.y = pack_bf16(x.z, x.w);
  *reinterpret_cast<uint2*>(dst) = u;
}

// acc[NT][4] += A @ B for one warp's 16 rows over k in [0, K), K a multiple
// of 32. A is float in shared memory (row r at A + r * lda, lda = 4 mod 32);
// B(k, n) is Bs[n * ldb + k] (KN false: k's rows, keys by channels) or
// Bs[k * ldb + n] (KN true). Output n-tile n holds columns 8n .. 8n + 7.
// float: 3xTF32 (a_lo b_hi, a_hi b_lo, a_hi b_hi each k step of 8); the
// tensor cores truncate their float32 sums, so each 32-deep slice sums into
// zeroed fragments that are added to acc with round-to-nearest. bf16: the
// tiles hold bf16 values, so packing them is exact; one bf16 MMA a k step
// of 16 (an A tile of float values, such as p, is rounded to bf16 by the
// packing, to nearest even). A float B may come split already: Bs then
// holds tf32(b) and Blo tf32(b - tf32(b)).
template <typename T, int NT, bool KN>
__device__ __forceinline__ void warp_product(float (&acc)[NT][4], const float* __restrict__ A,
                                             int lda, const float* __restrict__ Bs, int ldb,
                                             int K, const float* __restrict__ Blo = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 32) {
    float part[NT][4] = {};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int kk = 0; kk < 32; kk += 8) {
        // ldmatrix: lanes 0-15 give rows 0-15 at k, lanes 16-31 the same
        // rows at k + 4, so r[0..3] are the TF32 fragments a0..a3.
        uint32_t r[4], ahi[4], alo[4];
        ldmatrix_x4(r, A + (lane & 15) * lda + (lane >> 4) * 4 + k0 + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), ahi[i], alo[i]);
        uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float b0, b1;
          if (KN && Blo) {  // B split already: Bs its TF32 high parts, Blo the low
            const int o0 = (k0 + kk + t) * ldb + 8 * n + g, o1 = o0 + 4 * ldb;
            bhi[n][0] = __float_as_uint(Bs[o0]);
            bhi[n][1] = __float_as_uint(Bs[o1]);
            blo[n][0] = __float_as_uint(Blo[o0]);
            blo[n][1] = __float_as_uint(Blo[o1]);
            continue;
          }
          if constexpr (KN) {
            b0 = Bs[(k0 + kk + t) * ldb + 8 * n + g];
            b1 = Bs[(k0 + kk + t + 4) * ldb + 8 * n + g];
          } else {
            const float* p = Bs + (8 * n + g) * ldb + k0 + kk + t;
            b0 = p[0];
            b1 = p[4];
          }
          split_tf32(b0, bhi[n][0], blo[n][0]);
          split_tf32(b1, bhi[n][1], blo[n][1]);
        }
        // The n-tiles' products interleaved: NT independent chains in flight.
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(part[n], alo, bhi[n]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(part[n], ahi, blo[n]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(part[n], ahi, bhi[n]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 32; kk += 16) {
        const float* a = A + g * lda + k0 + kk + 2 * t;
        const float2 v0 = *reinterpret_cast<const float2*>(a);
        const float2 v1 = *reinterpret_cast<const float2*>(a + 8 * lda);
        const float2 v2 = *reinterpret_cast<const float2*>(a + 8);
        const float2 v3 = *reinterpret_cast<const float2*>(a + 8 * lda + 8);
        const uint32_t af[4] = {pack_bf16(v0.x, v0.y), pack_bf16(v1.x, v1.y),
                                pack_bf16(v2.x, v2.y), pack_bf16(v3.x, v3.y)};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b0, b1;
          if constexpr (KN) {
            const float* p = Bs + (k0 + kk + 2 * t) * ldb + 8 * n + g;
            b0 = pack_bf16(p[0], p[ldb]);
            b1 = pack_bf16(p[8 * ldb], p[9 * ldb]);
          } else {
            const float* p = Bs + (8 * n + g) * ldb + k0 + kk + 2 * t;
            const float2 u0 = *reinterpret_cast<const float2*>(p);
            const float2 u1 = *reinterpret_cast<const float2*>(p + 8);
            b0 = pack_bf16(u0.x, u0.y);
            b1 = pack_bf16(u1.x, u1.y);
          }
          mma_bf16(part[n], af, b0, b1);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n][q] += part[n][q];
  }
}

// acc[NT][4] += A[16 x 32] @ B[32 x 8 NT], B(k, n) = Bs[k * ldb + n]: the
// same arithmetic as warp_product<T, NT, true> over one 32-deep slice, with
// A's fragments loaded once and the n-tiles taken G at a time (G chains of
// products in flight), so a wide output (o: 32 n-tiles) needs partial
// fragments for G n-tiles only.
template <typename T, int NT>
__device__ __forceinline__ void pv_product(float (&acc)[NT][4], const float* __restrict__ A,
                                           int lda, const float* __restrict__ Bs, int ldb) {
  constexpr int G = NT % 4 ? NT : 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 4) {
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t r[4];
      ldmatrix_x4(r, A + (lane & 15) * lda + (lane >> 4) * 4 + 8 * ks);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), ahi[ks][i], alo[ks][i]);
    }
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += G) {
      float part[G][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t bhi[G][2], blo[G][2];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          split_tf32(Bs[(8 * ks + t) * ldb + 8 * (n0 + u) + g], bhi[u][0], blo[u][0]);
          split_tf32(Bs[(8 * ks + t + 4) * ldb + 8 * (n0 + u) + g], bhi[u][1], blo[u][1]);
        }
#pragma unroll
        for (int u = 0; u < G; ++u) mma_tf32(part[u], alo[ks], bhi[u]);
#pragma unroll
        for (int u = 0; u < G; ++u) mma_tf32(part[u], ahi[ks], blo[u]);
#pragma unroll
        for (int u = 0; u < G; ++u) mma_tf32(part[u], ahi[ks], bhi[u]);
      }
#pragma unroll
      for (int u = 0; u < G; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[n0 + u][q] += part[u][q];
    }
  } else {
    uint32_t af[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float* a = A + g * lda + 16 * ks + 2 * t;
      const float2 v0 = *reinterpret_cast<const float2*>(a);
      const float2 v1 = *reinterpret_cast<const float2*>(a + 8 * lda);
      const float2 v2 = *reinterpret_cast<const float2*>(a + 8);
      const float2 v3 = *reinterpret_cast<const float2*>(a + 8 * lda + 8);
      af[ks][0] = pack_bf16(v0.x, v0.y);
      af[ks][1] = pack_bf16(v1.x, v1.y);
      af[ks][2] = pack_bf16(v2.x, v2.y);
      af[ks][3] = pack_bf16(v3.x, v3.y);
    }
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += G) {
      float part[G][4] = {};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const float* p = Bs + (16 * ks + 2 * t) * ldb + 8 * (n0 + u) + g;
          mma_bf16(part[u], af[ks], pack_bf16(p[0], p[ldb]), pack_bf16(p[8 * ldb], p[9 * ldb]));
        }
#pragma unroll
      for (int u = 0; u < G; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[n0 + u][q] += part[u][q];
    }
  }
}

// Kernel P: [zb | pz] = z @ [Wb | Wdz], kPRows pairs a tile; warp w takes 16
// pairs and output n-tiles 0-2 (w < 8) or 3-4 (the bias and pz 0-15, or pz
// 16-31), so 16 warps hide the latency of the fragment loads and products.
// Persistent blocks, one an SM, walk the tiles with the next kPStages - 1
// tiles' z in flight (cp.async) while the current one is multiplied and
// stored; the weights are staged once a block.
constexpr int kPRows = 128, kPStages = 2, kPThreads = 4 * kPRows;
constexpr int kPNt0 = 3;  // n-tiles of the first eight warps
constexpr int LDZ = CZ + 4;   // staged z row (4 mod 32: conflict-free ldmatrix)
constexpr int LDWP = NP;      // staged weight row (8 mod 32: conflict-free B loads)
constexpr int LDOUT = NP + 4; // staged output row
constexpr int kPSmemFloats = kPStages * kPRows * LDZ + 2 * CZ * LDWP + kPRows * LDOUT;
constexpr size_t kPSmemBytes = (size_t)kPSmemFloats * sizeof(float);
static_assert(LDWP % 32 == 8 && kPSmemBytes <= 232448, "kernel P layout");

template <typename T>
__global__ void __launch_bounds__(kPThreads, 1)
pair_proj_kernel(const T* __restrict__ z, const T* __restrict__ wb, const T* __restrict__ wdz,
                 float* __restrict__ zb, T* __restrict__ pz, long long pairs, int N) {
  extern __shared__ __align__(16) float smem[];
  float* Zs = smem;                          // [kPStages][kPRows][LDZ] z tiles
  float* Ws = Zs + kPStages * kPRows * LDZ;  // [CZ][LDWP] Wb | Wdz (float: TF32 high parts)
  float* Wlo = Ws + CZ * LDWP;               // [CZ][LDWP] float: the TF32 low parts
  float* Os = Wlo + CZ * LDWP;               // [kPRows][LDOUT] outputs of a tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long n_tiles = (pairs + kPRows - 1) / kPRows, nn = (long long)N * N;
  const auto load = [&](long long tile, float* dst) {
    const long long p0 = tile * kPRows;
    for (int idx = tid; idx < kPRows * CZ / 4; idx += kPThreads) {
      const int r = idx / (CZ / 4), c = (idx % (CZ / 4)) * 4;
      const bool ok = p0 + r < pairs;
      stage4<T>(dst + r * LDZ + c, z + (ok ? (p0 + r) * CZ + c : 0), ok);
    }
  };
  long long tile = blockIdx.x;
  for (int st = 0; st < kPStages - 1; ++st) {
    if (tile + (long long)st * gridDim.x < n_tiles)
      load(tile + (long long)st * gridDim.x, Zs + st * kPRows * LDZ);
    cp_async_commit();
  }
  for (int idx = tid; idx < CZ * NP; idx += kPThreads) {
    const int kk = idx / NP, n = idx - kk * NP;
    const float x = n < H ? ld<T>(wb + kk * H + n) : ld<T>(wdz + kk * DZ + n - H);
    if constexpr (sizeof(T) == 4) {  // split once a block, not once a tile and warp
      uint32_t hi, lo;
      split_tf32(x, hi, lo);
      Ws[kk * LDWP + n] = __uint_as_float(hi);
      Wlo[kk * LDWP + n] = __uint_as_float(lo);
    } else {
      Ws[kk * LDWP + n] = x;
    }
  }
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const float* cur = Zs + (it % kPStages) * kPRows * LDZ;
    const long long ahead = tile + (long long)(kPStages - 1) * gridDim.x;
    if (ahead < n_tiles) load(ahead, Zs + ((it + kPStages - 1) % kPStages) * kPRows * LDZ);
    cp_async_commit();
    cp_async_wait<kPStages - 1>();
    __syncthreads();  // this tile (and the weights) landed; the last tile's stores are done

    const int rw = warp % (kPRows / 16), n0 = warp < kPRows / 16 ? 0 : kPNt0;
    const float* A = cur + rw * 16 * LDZ;
    const float* lo = sizeof(T) == 4 ? Wlo + 8 * n0 : nullptr;
    float acc[kPNt0][4] = {};
    if (n0 == 0) {
      warp_product<T, kPNt0, true>(acc, A, LDZ, Ws, LDWP, CZ, lo);
    } else {
      float(&acc2)[NP / 8 - kPNt0][4] = *reinterpret_cast<float(*)[NP / 8 - kPNt0][4]>(&acc[0]);
      warp_product<T, NP / 8 - kPNt0, true>(acc2, A, LDZ, Ws + 8 * n0, LDWP, CZ, lo);
    }
#pragma unroll
    for (int n = 0; n < kPNt0; ++n) {
      if (n0 + n >= NP / 8) break;
      float* row = Os + (rw * 16 + g) * LDOUT + 8 * (n0 + n) + 2 * t;
      *reinterpret_cast<float2*>(row) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(row + 8 * LDOUT) = make_float2(acc[n][2], acc[n][3]);
    }
    __syncthreads();  // the outputs are staged; every warp is done with this z tile
    const long long p0 = tile * kPRows;
    // zb [B, H, N, N]: a head's pair biases lie in the order of the pairs.
    for (int idx = tid; idx < H * kPRows; idx += kPThreads) {
      const int h = idx / kPRows, r = idx - h * kPRows;
      const long long p = p0 + r;
      if (p < pairs) {
        const long long bb = p / nn;
        zb[(bb * H + h) * nn + (p - bb * nn)] = Os[r * LDOUT + h];
      }
    }
    // pz [B, N, N, DZ], rounded to T.
    for (int idx = tid; idx < kPRows * DZ / 4; idx += kPThreads) {
      const int r = idx / (DZ / 4), c = (idx % (DZ / 4)) * 4;
      if (p0 + r < pairs)
        store4(pz + (p0 + r) * DZ + c, *reinterpret_cast<const float4*>(Os + r * LDOUT + H + c));
    }
  }
  cp_async_wait<0>();
}

// Kernel S: one block per (query tile of TI rows, head, sample, key split),
// 8 warps: warp w owns query rows 16 (w % 4) .. of the tile and channels
// 128 (w / 4) .. of o. The two warps of a row group each take the q . k
// product over their half of the channels and exchange the partial logits
// through shared memory, then both run the same softmax on the same sums;
// so each holds half of o's accumulators (64 registers, not 128), and two
// warps share each scheduler to hide the latency of the fragment loads.
constexpr int TI = 64, TJ = 32;  // query rows per block, keys per tile
constexpr int kSGroups = TI / 16, kSWarps = 2 * kSGroups, kSThreads = 32 * kSWarps;
constexpr int CH = C / 2;                // channels of o a warp owns
constexpr int LDQ = C + 4, LDK = C + 4;  // 4 mod 32: ldmatrix rows, k's B loads
constexpr int LDV = C + 8;               // 8 mod 32: v's B loads
constexpr int LDVP = 40;                 // vpt lanes padded to 5 n-tiles, 8 mod 32
constexpr int LDP = TJ + 4;
constexpr int NTO = CH / 8, NTPT = LDVP / 8;
constexpr int kMaxSplits = 16;
constexpr int kSQH = TI * LDQ, kSKs = kSQH + TI * PQW, kSKH = kSKs + TJ * LDK,
              kSVs = kSKH + TJ * PQW, kSVP = kSVs + TJ * LDV, kSPs = kSVP + TJ * LDVP,
              kSSx = kSPs + kSWarps * 16 * LDP, kSSmemFloats = kSSx + kSWarps * 16 * TJ;
constexpr size_t kSSmemBytes = (size_t)kSSmemFloats * sizeof(float);
static_assert(kSSmemBytes <= 232448, "shared memory of one block");
static_assert(TJ == 32 && TI % 16 == 0 && LDVP >= PVW && PQW % 4 == 0 && PVW % 4 == 0 &&
              CH % 32 == 0, "tile widths");

// The workspace of kernels S and F for split s and flat row R = (s B + b) N
// + i: po [R][H C] and ppt [R][H PVW], the unnormalized sums; pml [R][H][2],
// the split's final running max and row sum.
struct SplitSums {
  float* po;
  float* ppt;
  float* pml;
  __device__ SplitSums(float* part, size_t rows)
      : po(part), ppt(part + rows * HC), pml(part + rows * (HC + H * PVW)) {}
};

template <typename T>
__global__ void __launch_bounds__(kSThreads, 1)
attend_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ qhat, const float* __restrict__ khat,
              const float* __restrict__ vpt, const float* __restrict__ mask,
              float* __restrict__ zbp, float* __restrict__ mt, float* __restrict__ part, int B,
              int N, int tiles_per_split, float inf) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;           // [TI][LDQ]  query rows of head h
  float* QH = smem + kSQH;    // [TI][PQW]  augmented query points
  float* Ks = smem + kSKs;    // [TJ][LDK]  key tile
  float* KH = smem + kSKH;    // [TJ][PQW]  augmented key points
  float* Vs = smem + kSVs;    // [TJ][LDV]  value tile
  float* VP = smem + kSVP;    // [TJ][LDVP] value points, lanes past PVW zero
  float* Ps = smem + kSPs;    // [warp][16][LDP] weights of the key tile
  float* Sx = smem + kSSx;    // [warp][16][TJ]  partial logits, exchanged
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp % kSGroups, half = warp / kSGroups;  // row group, channel half
  const int h = blockIdx.x % H, i0 = (blockIdx.x / H) * TI, b = blockIdx.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const int n_tiles = (N + TJ - 1) / TJ;
  const int t_begin = split * tiles_per_split, t_end = min(t_begin + tiles_per_split, n_tiles);
  const size_t key0 = (size_t)b * N;  // flat index of the sample's first row

  for (int idx = tid; idx < TJ * (LDVP - PVW); idx += kSThreads)
    VP[(idx / (LDVP - PVW)) * LDVP + PVW + idx % (LDVP - PVW)] = 0.f;
  for (int idx = tid; idx < TI * C / 4; idx += kSThreads) {
    const int r = idx / (C / 4), c = (idx % (C / 4)) * 4;
    const bool ok = i0 + r < N;
    stage4<T>(Qs + r * LDQ + c, q + (ok ? (key0 + i0 + r) * HC + h * C + c : 0), ok);
  }
  for (int idx = tid; idx < TI * PQW / 4; idx += kSThreads) {
    const int r = idx / (PQW / 4), c = (idx % (PQW / 4)) * 4;
    const bool ok = i0 + r < N;
    cp_async16_zfill(QH + r * PQW + c, qhat + (ok ? (key0 + i0 + r) * (H * PQW) + h * PQW + c : 0),
                     ok);
  }
  cp_async_commit();
  const auto load_keys = [&](int tile) {
    const int j0 = tile * TJ;
    for (int idx = tid; idx < TJ * C / 4; idx += kSThreads) {
      const int j = idx / (C / 4), c = (idx % (C / 4)) * 4;
      const bool ok = j0 + j < N;
      stage4<T>(Ks + j * LDK + c, k + (ok ? (key0 + j0 + j) * HC + h * C + c : 0), ok);
    }
    for (int idx = tid; idx < TJ * PQW / 4; idx += kSThreads) {
      const int j = idx / (PQW / 4), c = (idx % (PQW / 4)) * 4;
      const bool ok = j0 + j < N;
      cp_async16_zfill(KH + j * PQW + c,
                       khat + (ok ? (key0 + j0 + j) * (H * PQW) + h * PQW + c : 0), ok);
    }
  };
  const auto load_values = [&](int tile) {
    const int j0 = tile * TJ;
    for (int idx = tid; idx < TJ * C / 4; idx += kSThreads) {
      const int j = idx / (C / 4), c = (idx % (C / 4)) * 4;
      const bool ok = j0 + j < N;
      stage4<T>(Vs + j * LDV + c, v + (ok ? (key0 + j0 + j) * HC + h * C + c : 0), ok);
    }
    for (int idx = tid; idx < TJ * PVW / 4; idx += kSThreads) {
      const int j = idx / (PVW / 4), c = (idx % (PVW / 4)) * 4;
      const bool ok = j0 + j < N;
      cp_async16_zfill(VP + j * LDVP + c,
                       vpt + (ok ? (key0 + j0 + j) * (H * PVW) + h * PVW + c : 0), ok);
    }
  };
  if (t_begin < t_end) load_keys(t_begin);
  cp_async_commit();

  // This lane's rows of the C fragments: rg and rg + 8 of the tile.
  const int rg = grp * 16 + g;
  float rmask[2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = i0 + rg + 8 * e;
    rmask[e] = i < N ? __ldg(mask + key0 + i) : 0.f;
  }
  float oacc[NTO][4] = {}, pacc[NTPT][4] = {};  // pacc: the second half's warps
  float* Pw = Ps + warp * 16 * LDP;
  float* Sown = Sx + warp * 16 * TJ;
  const float* Sother = Sx + ((warp + kSGroups) % kSWarps) * 16 * TJ;
  float* zbh = zbp + (size_t)(b * H + h) * N * N;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int j0 = tile * TJ;
    load_values(tile);  // in flight while the logits are computed
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the key tile has landed

    // (1) q . k over this warp's half of the channels, on the tensor cores;
    // the first half's warps add the point term, in float32 on the CUDA
    // cores (its augmented form is a sum of large terms that cancel, which
    // TF32 would not resolve).
    float s[4][4] = {};
    warp_product<T, 4, false>(s, Qs + grp * 16 * LDQ + half * CH, LDQ, Ks + half * CH, LDK, CH);
    if (half == 0) {
      const float* qa = QH + rg * PQW;
      const float* qb = qa + 8 * PQW;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float* ka = KH + (8 * n + 2 * t) * PQW;
        float pt[4] = {};
#pragma unroll
        for (int e = 0; e < PQW; e += 4) {
          const float4 x0 = *reinterpret_cast<const float4*>(qa + e);
          const float4 x1 = *reinterpret_cast<const float4*>(qb + e);
          const float4 y0 = *reinterpret_cast<const float4*>(ka + e);
          const float4 y1 = *reinterpret_cast<const float4*>(ka + PQW + e);
          pt[0] = dot4(x0, y0, pt[0]);
          pt[1] = dot4(x0, y1, pt[1]);
          pt[2] = dot4(x1, y0, pt[2]);
          pt[3] = dot4(x1, y1, pt[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += pt[e];
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<float2*>(Sown + g * TJ + 8 * n + 2 * t) = make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(Sown + (g + 8) * TJ + 8 * n + 2 * t) =
          make_float2(s[n][2], s[n][3]);
    }
    __syncthreads();  // the partial logits are out; every warp is done with the key tile
    if (tile + 1 < t_end) load_keys(tile + 1);
    cp_async_commit();

    // (2) Both warps of a row group: the same sum (first half + second
    // half), the pair bias, the mask term; keys past N take no weight.
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), jj = 8 * n + 2 * t + (e & 1);
        const int j = j0 + jj, i = i0 + grp * 16 + r;
        const float other = Sother[r * TJ + jj];
        float logit = -INFINITY;
        if (j < N) {
          const float bias = i < N ? zbh[(size_t)i * N + j] : 0.f;
          logit = (half == 0 ? s[n][e] + other : other + s[n][e]) + bias +
                  inf * (rmask[e >> 1] * __ldg(mask + key0 + j) - 1.f);
        }
        s[n][e] = logit;
      }
    // (3) Online softmax, inside the four lanes that own each row.
    float corr[2];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 4; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * e2], s[n][2 * e2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[e2], mx);
      // A tile with no key yet (all past N) keeps the max at -inf; measure
      // from 0 then, so exp gives 0 and not exp(-inf - -inf) = NaN.
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      corr[e2] = expf(m[e2] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float p = expf(s[n][2 * e2 + u] - m_use);
          s[n][2 * e2 + u] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[e2] = l[e2] * corr[e2] + sum;
      m[e2] = m_new;
    }
    // The weights, for this warp's products and (the first half's warps:
    // over zb, which only that lane reads, and the tile's running max) for
    // o_pair in kernel F.
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int i = i0 + rg + 8 * e2;
      if (half == 0 && i < N && t == 0)
        mt[((size_t)(b * H + h) * N + i) * n_tiles + tile] = m[e2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int r = g + 8 * e2, jj = 8 * n + 2 * t;
        *reinterpret_cast<float2*>(Pw + r * LDP + jj) = make_float2(s[n][2 * e2], s[n][2 * e2 + 1]);
        if (half == 0 && i < N) {
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (j0 + jj + u < N) zbh[(size_t)i * N + j0 + jj + u] = s[n][2 * e2 + u];
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NTO; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) oacc[n][q] *= corr[q >> 1];
#pragma unroll
    for (int n = 0; n < NTPT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) pacc[n][q] *= corr[q >> 1];
    cp_async_wait<1>();
    __syncthreads();  // the value tile has landed

    // (4) o += rnd(p) v over this warp's channels on the tensor cores; the
    // second half's warps also o_pt += p vpt (3xTF32 with float32 p in both
    // element types).
    pv_product<T, NTO>(oacc, Pw, LDP, Vs + half * CH, LDV);
    if (half == 1) pv_product<float, NTPT>(pacc, Pw, LDP, VP, LDVP);
    __syncthreads();  // every warp is done with the value tile and the partial logits
  }
  cp_async_wait<0>();

  // The split's unnormalized sums, running max and row sum, for kernel F.
  const SplitSums w(part, (size_t)splits * B * N);
  const size_t rbase = ((size_t)split * B + b) * N;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int i = i0 + rg + 8 * e2;
    if (i >= N) continue;
    const size_t R = rbase + i;
    float* orow = w.po + R * HC + h * C + half * CH + 2 * t;
#pragma unroll
    for (int n = 0; n < NTO; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(oacc[n][2 * e2], oacc[n][2 * e2 + 1]);
    if (half == 1) {
      float* prow = w.ppt + R * (H * PVW) + h * PVW + 2 * t;
#pragma unroll
      for (int n = 0; n < NTPT; ++n)
        if (8 * n + 2 * t < PVW)
          *reinterpret_cast<float2*>(prow + 8 * n) =
              make_float2(pacc[n][2 * e2], pacc[n][2 * e2 + 1]);
    } else if (t == 0) {
      *reinterpret_cast<float2*>(w.pml + (R * H + h) * 2) = make_float2(m[e2], l[e2]);
    }
  }
}

// Kernel F: the outputs of one row (block = (row, sample)). Split s of head
// h weighs exp(m_s - max_s m_s) (0 for a split with no key: its max is
// -inf), summed in split order into the row sum L; each of o and o_pt is
// the sum over the splits, in order, of weight / L * row mask times the
// split's sum (a masked row: exactly 0, no NaN before the mask). o_pair =
// sum over key tiles t of f_t * sum_{j in t} rnd(p~_ij) pz_ij, p~ the
// weights kernel S left over zb (exp(s - m_t), m_t the running max after
// tile t) and f_t = exp(m_t - m_s) * weight / L * row mask for t in split
// s: one pass over the row's pz for all heads (a thread per head and
// channel), where a per-head block would read it 8 times. No atomics.
constexpr int kFThreads = H * DZ;  // a thread per head and pair channel

template <typename T>
__global__ void __launch_bounds__(kFThreads)
finish_kernel(const float* __restrict__ part, const float* __restrict__ pw,
              const float* __restrict__ mt, const T* __restrict__ pz,
              const float* __restrict__ mask, float* __restrict__ o, float* __restrict__ o_pt,
              float* __restrict__ o_pair, int B, int N, int splits, int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* coef = smem;               // [kMaxSplits][H]
  float* ftile = smem + kMaxSplits * H;  // [H][n_tiles]
  const int tid = threadIdx.x, i = blockIdx.x, b = blockIdx.y;
  const int n_tiles = (N + TJ - 1) / TJ;
  const size_t rows = (size_t)splits * B * N, row = (size_t)b * N + i;
  const SplitSums w(const_cast<float*>(part), rows);
  if (tid < H) {
    const int h = tid;
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, w.pml[((((size_t)s * B + b) * N + i) * H + h) * 2]);
    float lsum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* ml = w.pml + ((((size_t)s * B + b) * N + i) * H + h) * 2;
      const float wt = ml[0] == -INFINITY ? 0.f : expf(ml[0] - mx);
      coef[s * H + h] = wt;
      lsum += wt * ml[1];
    }
    const float rm = __ldg(mask + row);
    for (int s = 0; s < splits; ++s) coef[s * H + h] = lsum > 0.f ? coef[s * H + h] / lsum * rm : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < H * n_tiles; idx += kFThreads) {
    const int h = idx / n_tiles, tile = idx - h * n_tiles, s = tile / tiles_per_split;
    const float m_s = w.pml[((((size_t)s * B + b) * N + i) * H + h) * 2];
    const float m_t = mt[((size_t)(b * H + h) * N + i) * n_tiles + tile];
    ftile[idx] = m_t == -INFINITY ? 0.f : expf(m_t - m_s) * coef[s * H + h];
  }
  for (int e = tid; e < HC; e += kFThreads) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s)
      a = fmaf(coef[s * H + e / C], w.po[(((size_t)s * B + b) * N + i) * HC + e], a);
    o[row * HC + e] = a;
  }
  for (int e = tid; e < H * PVW; e += kFThreads) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s)
      a = fmaf(coef[s * H + e / PVW], w.ppt[(((size_t)s * B + b) * N + i) * (H * PVW) + e], a);
    o_pt[row * (H * PVW) + e] = a;
  }
  __syncthreads();
  const int h = tid / DZ, d = tid % DZ;
  const float* prow = pw + ((size_t)(b * H + h) * N + i) * N;
  const T* zrow = pz + row * N * DZ + d;
  float acc = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int j0 = tile * TJ;
    float a = 0.f;
    if (j0 + TJ <= N) {
      float pj[TJ], zj[TJ];  // all of a tile's loads in flight at once
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) {
        pj[jj] = __ldg(prow + j0 + jj);
        zj[jj] = ld<T>(zrow + (size_t)(j0 + jj) * DZ);
      }
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) a = fmaf(rnd<T>(pj[jj]), zj[jj], a);
    } else {
      for (int j = j0; j < N; ++j) a = fmaf(rnd<T>(__ldg(prow + j)), ld<T>(zrow + (size_t)j * DZ), a);
    }
    acc = fmaf(ftile[h * n_tiles + tile], a, acc);
  }
  o_pair[row * (H * DZ) + tid] = acc;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* qhat,
                      const float* khat, const float* vpt, const void* z, const float* mask,
                      const void* wb, const void* wdz, float* o, float* o_pt, float* o_pair,
                      float* zb, void* pz, float* mt, float* part, int B, int N, int splits,
                      int tiles_per_split, float inf, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(pair_proj_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kPSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attend_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSSmemBytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + TJ - 1) / TJ;
  if (splits < 1 || splits > kMaxSplits || tiles_per_split < 1 ||
      (long long)splits * tiles_per_split < n_tiles)
    return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long pairs = (long long)B * N * N, p_tiles = (pairs + kPRows - 1) / kPRows;
  pair_proj_kernel<T><<<(unsigned)(p_tiles < sms ? p_tiles : sms), kPThreads, kPSmemBytes,
                        stream>>>((const T*)z, (const T*)wb, (const T*)wdz, zb, (T*)pz, pairs, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(H * ((N + TI - 1) / TI)), (unsigned)B, (unsigned)splits);
  attend_kernel<T><<<grid, kSThreads, kSSmemBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, qhat, khat, vpt, mask, zb, mt, part, B, N,
      tiles_per_split, inf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_kernel<T><<<dim3((unsigned)N, (unsigned)B), kFThreads,
                     (kMaxSplits + n_tiles) * H * sizeof(float), stream>>>(
      part, zb, mt, (const T*)pz, mask, o, o_pt, o_pair, B, N, splits, tiles_per_split);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fdk

// C interface. dtype: 0 = float32, 1 = bfloat16 (q, k, v, z, wb, wdz); the
// point inputs, the mask and the three outputs are float32. Layouts: q, k,
// v [B,N,H*C]; qhat, khat [B,N,H*28]; vpt [B,N,H*36]; z [B,N,N,128]; mask
// [B,N]; wb [128,H]; wdz [128,32]; o [B,N,H*C]; o_pt [B,N,H*36]; o_pair
// [B,N,H*32]. Workspace: zb float32 [B,H,N,N] (the pair bias, then the
// weights), pz [B,N,N,32] in the element type, mt float32
// [B,H,N,ceil(N/32)] (each key tile's running max), part float32
// [splits*B*N*H*(C+36+2)] (each split's sums). The keys split into `splits`
// ranges of `tiles_per_split` tiles of 32 (splits <= 16, covering every
// tile). Returns a cudaError_t (0 on success).
extern "C" int fdk_ipa_attention(int dtype, const void* q, const void* k, const void* v,
                                 const float* qhat, const float* khat, const float* vpt,
                                 const void* z, const float* mask, const void* wb,
                                 const void* wdz, float* o, float* o_pt, float* o_pair,
                                 float* zb, void* pz, float* mt, float* part, int B, int N,
                                 int splits, int tiles_per_split, float inf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDK_ARGS                                                                             \
  q, k, v, qhat, khat, vpt, z, mask, wb, wdz, o, o_pt, o_pair, zb, pz, mt, part, B, N, splits, \
      tiles_per_split, inf, s
  if (dtype == 0) return fdk::launch<float>(FDK_ARGS);
  if (dtype == 1) return fdk::launch<__nv_bfloat16>(FDK_ARGS);
#undef FDK_ARGS
  return (int)cudaErrorInvalidValue;
}
