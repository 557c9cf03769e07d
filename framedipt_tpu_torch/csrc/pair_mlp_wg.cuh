// The float32 pair MLP's 64-pair tile on wgmma and TMA, for Hopper (sm_90a),
// shared by the forward (pair_mlp_wg.cu) and the backward's kernel A
// (pair_mlp_bwd_wg.cu): the block's shared-memory layout, the weights' TF32
// split (prepare_weights), the weight ring's producer (produce) and consumer
// (Consumer) sides, and the forward of a tile up to its pre-norm output
// (forward_tile). Both kernels run this code, so the backward's recompute
// equals the forward's output bit for bit and its relu decisions are the
// forward's. pair_mlp_wg.cu's header describes the design.
#pragma once

#include "common.cuh"
#include "wgmma_tma.cuh"

namespace fdk {
namespace {

constexpr int C_IN = 128, HID = 384, C_OUT = 128, NC = 128;
constexpr int kStages = 2;
constexpr int kConsumers = 256, kBlockWG = kConsumers + 128;  // + the producer warpgroup
constexpr int kSliceFloats = 32 * NC, kSliceBytes = kSliceFloats * 4;
constexpr int kKSlices = C_IN / 32;                       // slices of a K = 128 product
constexpr int kW0Slices = (HID / NC) * kKSlices;          // 12
constexpr int kChunkSlices = HID / 32 + kKSlices;         // 16
constexpr int kResSlice = kW0Slices + (HID / NC) * kChunkSlices;  // 60

// A weight split (prepare_weights): for each of the four weight slots W0,
// W1, Wf, Wfe its hi rows [out][in], then its lo rows [out][in].
constexpr int W0S = 0, W1S = W0S + 2 * HID * C_IN, WFS = W1S + 2 * HID * HID,
              WFES = WFS + 2 * C_OUT * HID, kSplitFloats = WFES + 2 * C_OUT * C_IN;
static_assert(kSplitFloats == 524288, "the wrapper's scratch (WG_SPLIT_FLOATS)");

struct __align__(1024) WgSmem {
  float hi[kStages][kSliceFloats];  // weight slices' hi parts, [128 out][32 in] swizzled
  float lo[kStages][kSliceFloats];  // and their lo parts
  float x[kRows * C_IN];            // pair tile (swizzled), by TMA
  float y0[kRows * HID];            // first hidden layer (swizzled)
  float y1[kRows * NC];             // one 128-column chunk of y1, then the pre-norm output
  PairTile pt;
  uint64_t full[kStages], empty[kStages], xfull, xempty;
  // The backward's: a workspace region whole for its store warps, and
  // copied by them.
  uint64_t sfull, sempty;
};
constexpr size_t kSmemBytes = sizeof(WgSmem) + 1024;
static_assert(kSmemBytes <= 232448, "shared memory of one block");

// Tensor maps over one weight split, [2 out][in] each.
struct WeightMaps {
  CUtensorMap w0, w1, wf, wfe;
};

// The kernel's tensor maps: S weight streams, each a tile's slices in the
// forward's order (the forward one; the backward also the chain's), and the
// pair input.
template <int S>
struct Maps {
  WeightMaps w[S];
  CUtensorMap pair;  // [pairs][C_IN]
};

// The tensor maps of the weight split at `split` (device memory); false if
// cuTensorMapEncodeTiled refuses one.
inline bool weight_maps(WeightMaps* m, float* split) {
  return wg::f32_sw128_map(&m->w0, split + W0S, 2 * HID, C_IN, NC) &&
         wg::f32_sw128_map(&m->w1, split + W1S, 2 * HID, HID, NC) &&
         wg::f32_sw128_map(&m->wf, split + WFS, 2 * C_OUT, HID, NC) &&
         wg::f32_sw128_map(&m->wfe, split + WFES, 2 * C_OUT, C_IN, NC);
}

// The tensor map and coordinates of slice s of a tile: its first input
// row, its first output row (hi part), and the lo part's output row.
__device__ __forceinline__ const CUtensorMap* slice_coords(const WeightMaps& m, int s, int& c_in,
                                                           int& c_out, int& c_lo) {
  if (s < kW0Slices) {
    c_in = (s % kKSlices) * 32;
    c_out = (s / kKSlices) * NC;
    c_lo = c_out + HID;
    return &m.w0;
  }
  if (s < kResSlice) {
    const int hc = (s - kW0Slices) / kChunkSlices, v = (s - kW0Slices) % kChunkSlices;
    if (v < HID / 32) {
      c_in = v * 32;
      c_out = hc * NC;
      c_lo = c_out + HID;
      return &m.w1;
    }
    c_in = hc * NC + (v - HID / 32) * 32;
    c_out = 0;
    c_lo = C_OUT;
    return &m.wf;
  }
  c_in = (s - kResSlice) * 32;
  c_out = 0;
  c_lo = C_OUT;
  return &m.wfe;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// The weight split the products read: for each slot, hi = tf32(v) and lo =
// tf32(v - hi) of its K-major values v ([out][in]; layout above). With
// TRANSPOSE (the forward) the slots take W0, W1, Wf, Wfe ([in][out] each)
// and v = w^T; without (the backward's chain, whose products are the
// forward's on the transposed weights) they take Wf, W1, W0, Wfe and v = w
// as stored, which is K-major for w^T.
template <bool TRANSPOSE>
__global__ void prepare_weights(const float* __restrict__ w0, const float* __restrict__ w1,
                                const float* __restrict__ wf, const float* __restrict__ wfe,
                                float* __restrict__ split) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < kSplitFloats / 2;
       e += gridDim.x * blockDim.x) {
    const float* w;
    int in, out, base, k = e;
    if (k < HID * C_IN) {
      w = w0, in = C_IN, out = HID, base = W0S;
    } else if ((k -= HID * C_IN) < HID * HID) {
      w = w1, in = HID, out = HID, base = W1S;
    } else if ((k -= HID * HID) < C_OUT * HID) {
      w = wf, in = HID, out = C_OUT, base = WFS;
    } else {
      k -= C_OUT * HID;
      w = wfe, in = C_IN, out = C_OUT, base = WFES;
      if (w == nullptr) continue;
    }
    uint32_t h, l;
    if (TRANSPOSE) {
      const int o = k / in, i = k - o * in;
      split_tf32(__ldg(w + (size_t)i * out + o), h, l);
    } else {
      split_tf32(__ldg(w + k), h, l);
    }
    split[base + k] = __uint_as_float(h);
    split[base + out * in + k] = __uint_as_float(l);
  }
}

// The consumer side of the weight ring: slices counted across the block's
// tiles (n), this warpgroup's half (output rows) of each stage.
struct Consumer {
  WgSmem& sm;
  int group;    // warpgroup 0 or 1: output columns 64 group .. + 63 of each chunk
  uint32_t n;   // slices consumed so far, counted across the block's tiles

  // This warp's A fragments of 32-deep block ks of a swizzled tile, split
  // into TF32 hi and lo: k steps kk = 0..3 of 8.
  __device__ __forceinline__ static void load_a(const float* A, int ks, uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    // ldmatrix rows: lanes 0-15 give rows 0-15 of the warp's 16 at chunk
    // 2 kk, lanes 16-31 the same rows at chunk 2 kk + 1.
    const int row = 16 * wq + (lane & 15), half = lane >> 4;
    const float* blk = A + ks * (kRows * 32) + row * 32;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, blk + (((2 * kk + half) ^ (row & 7)) << 2));
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), hi[kk][i], lo[kk][i]);
    }
  }

  // acc += (A's block with fragments hi, lo) @ the ring's next slice: each
  // k step adds a_lo b_hi, a_hi b_lo, a_hi b_hi into a fresh accumulator,
  // which is added to acc (round to nearest) once the slice is complete.
  // next() runs while the slice's products do (it loads the next block's
  // fragments).
  template <typename Next>
  __device__ __forceinline__ void slice(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                        float (&acc)[32], Next next) {
    const int st = n % kStages;
    wg::mbar_wait(&sm.full[st], (n / kStages) & 1);
    const float* bhi = sm.hi[st] + group * (kSliceFloats / 2);
    const float* blo = sm.lo[st] + group * (kSliceFloats / 2);
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) wg::fence_operand(part[i]);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bh = wg::desc_sw128(bhi + 8 * kk), bl = wg::desc_sw128(blo + 8 * kk);
      wg::wgmma_m64n64k8_tf32(part, lo[kk], bh, kk > 0);
      wg::wgmma_m64n64k8_tf32(part, hi[kk], bl, 1);
      wg::wgmma_m64n64k8_tf32(part, hi[kk], bh, 1);
    }
    wg::wgmma_commit();
    next();
    wg::wgmma_wait<0>();
    // The fragments stay allocated (not reused by next()) until here.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wg::fence_operand(hi[kk][i]);
        wg::fence_operand(lo[kk][i]);
      }
#pragma unroll
    for (int i = 0; i < 32; ++i) wg::fence_operand(part[i]);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&sm.empty[st]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
    ++n;
  }

  // acc += A[64 x K] @ (the ring's next K / 32 slices), A a swizzled tile;
  // each block's fragments load while the previous block's products run,
  // and during(ks) (the epilogue's loads from device memory, a backward's
  // stores) while block ks's do.
  template <int K, typename During>
  __device__ __forceinline__ void product(const float* A, float (&acc)[32], During during) {
    static_assert(K % 64 == 0, "blocks go in pairs");
    uint32_t xh[4][4], xl[4][4], yh[4][4], yl[4][4];
    load_a(A, 0, xh, xl);
#pragma unroll 1
    for (int ks = 0; ks < K / 32 - 2; ks += 2) {
      slice(xh, xl, acc, [&] {
        load_a(A, ks + 1, yh, yl);
        during(ks);
      });
      slice(yh, yl, acc, [&] {
        load_a(A, ks + 2, xh, xl);
        during(ks + 1);
      });
    }
    slice(xh, xl, acc, [&] {
      load_a(A, K / 32 - 1, yh, yl);
      during(K / 32 - 2);
    });
    slice(yh, yl, acc, [&] { during(K / 32 - 1); });
  }
  template <int K>
  __device__ __forceinline__ void product(const float* A, float (&acc)[32]) {
    product<K>(A, acc, [](int) {});
  }
};

// f(r, c, i) for each of this thread's accumulator elements i (even i
// only; i + 1 is column c + 1): tile row r, column c of the 128-column chunk.
template <typename F>
__device__ __forceinline__ void for_each_pair(int group, F f) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int r0 = 16 * wq + (lane >> 2), c0 = 64 * group + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 32; i += 2) f(r0 + 8 * ((i >> 1) & 1), c0 + 8 * (i >> 2), i);
}

// common.cuh's layer_norm_store, from the swizzled pre-norm output O: the
// same arithmetic, each warp on its eight rows.
__device__ __forceinline__ void layer_norm_rows(const float* __restrict__ O, const PairTile& pt,
                                                long long p0, const float* __restrict__ ln_scale,
                                                const float* __restrict__ ln_bias,
                                                float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = 0; rr < kRows / (kConsumers / 32); ++rr) {
    const int r = warp * (kRows / (kConsumers / 32)) + rr;
    if (pt.row[r] < 0) continue;  // warp-uniform
    float x[C_OUT / 32];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < C_OUT / 32; ++q) {
      x[q] = O[wg::swz<kRows>(r, lane + 32 * q)];
      s += x[q];
    }
    const float mean = warp_sum(s) / C_OUT;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < C_OUT / 32; ++q) {
      x[q] -= mean;
      v += x[q] * x[q];
    }
    const float rstd = 1.f / sqrtf(warp_sum(v) / C_OUT + 1e-6f);
    float* dst = out + (size_t)(p0 + r) * C_OUT;
#pragma unroll
    for (int q = 0; q < C_OUT / 32; ++q) {
      const int c = lane + 32 * q;
      dst[c] = (x[q] * rstd * __ldg(ln_scale + c) + __ldg(ln_bias + c)) * pt.mask[r];
    }
  }
}

// The producer: for each of the block's tiles, its pair rows (X, once the
// consumers have released the last tile's), then the tile's slices of each
// of the S weight streams in turn, through the ring.
template <bool RESIDUAL, int S>
__device__ __forceinline__ void produce(WgSmem& sm, const Maps<S>& maps, long long tiles) {
  constexpr int kSlices = RESIDUAL ? kResSlice + kKSlices : kResSlice;
#pragma unroll
  for (int w = 0; w < S; ++w) {
    wg::prefetch_tensor_map(&maps.w[w].w0);
    wg::prefetch_tensor_map(&maps.w[w].w1);
    wg::prefetch_tensor_map(&maps.w[w].wf);
    wg::prefetch_tensor_map(&maps.w[w].wfe);
  }
  wg::prefetch_tensor_map(&maps.pair);
  uint32_t n = 0, k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    // Rows past the grid read as zeros.
    wg::mbar_wait(&sm.xempty, (k & 1) ^ 1);
    wg::mbar_arrive_expect_tx(&sm.xfull, kRows * C_IN * 4);
    for (int b = 0; b < C_IN / 32; ++b)
      wg::tma_load_2d(sm.x + b * kRows * 32, &maps.pair, &sm.xfull, 32 * b, (int)(t * kRows));
#pragma unroll
    for (int w = 0; w < S; ++w) {
      for (int s = 0; s < kSlices; ++s, ++n) {
        const int st = n % kStages;
        wg::mbar_wait(&sm.empty[st], ((n / kStages) & 1) ^ 1);
        int c_in, c_out, c_lo;
        const CUtensorMap* map = slice_coords(maps.w[w], s, c_in, c_out, c_lo);
        wg::mbar_arrive_expect_tx(&sm.full[st], 2 * kSliceBytes);
        wg::tma_load_2d(sm.hi[st], map, &sm.full[st], c_in, c_out);
        wg::tma_load_2d(sm.lo[st], map, &sm.full[st], c_in, c_lo);
      }
    }
  }
}

// The barriers' initial state, by thread 0; the caller synchronizes.
__device__ __forceinline__ void init_barriers(WgSmem& sm) {
  for (int s = 0; s < kStages; ++s) {
    wg::mbar_init(&sm.full[s], 1);
    wg::mbar_init(&sm.empty[s], kConsumers / 32);
  }
  wg::mbar_init(&sm.xfull, 1);
  wg::mbar_init(&sm.xempty, kConsumers / 32);
  wg::mbar_init(&sm.sfull, 1);
  wg::mbar_init(&sm.sempty, 3);  // the producer warpgroup's other warps
  wg::fence_barrier_init();
}

// The forward of the tile whose pair rows are in X and bookkeeping in pt,
// up to its pre-norm output, which it leaves in sm.y1 (swizzled; every
// consumer thread past the final barrier). Hooks h (a backward's
// recompute keeps what the forward drops):
//   x_done()              X read for the last time by the forward's products;
//   y0(cb, i, v0, v1)     y0's elements i, i + 1 (for_each_pair) of chunk cb;
//   y0_whole()            y0 whole in sm.y0, before the W1 products;
//   y1(hc, i, v0, v1)     y1's elements i, i + 1 of chunk hc;
//   y1_whole(hc)          chunk hc whole in sm.y1, before its Wf product;
//   y1_free()             before each barrier after which y1's space is
//                         rewritten.
template <bool RESIDUAL, typename Hooks>
__device__ __forceinline__ void forward_tile(WgSmem& sm, Consumer& ring, const PairTile& pt,
                                             const float* __restrict__ i_term,
                                             const float* __restrict__ j_term,
                                             const float* __restrict__ fi,
                                             const float* __restrict__ fj,
                                             const float* __restrict__ b0,
                                             const float* __restrict__ b1,
                                             const float* __restrict__ bf, Hooks& h) {
  const int wg_id = ring.group;
  // y0 = relu(pair @ W0 + i_term + j_term + b0), by 128-column chunk; the
  // terms load while the chunk's last products run.
  for (int cb = 0; cb < HID / NC; ++cb) {
    float acc[32] = {};
    float2 it[16], jt[16], bb[8];  // by element pair i / 2; b0 by column block i / 4
    ring.product<C_IN>(sm.x, acc, [&](int ks) {
      if (ks == C_IN / 32 - 1)
        for_each_pair(wg_id, [&](int r, int c, int i) {
          c += cb * NC;
          it[i / 2] = ld2(i_term + (size_t)max(pt.row[r], 0) * HID + c);
          jt[i / 2] = ld2(j_term + (size_t)pt.col[r] * HID + c);
          bb[i / 4] = ld2(b0 + c);
        });
    });
    if (!RESIDUAL && cb == HID / NC - 1) h.x_done();
    for_each_pair(wg_id, [&](int r, int c, int i) {
      const int k2 = i / 2;
      const float v0 = pair_y0<float>(acc[i], it[k2].x, jt[k2].x, bb[i / 4].x);
      const float v1 = pair_y0<float>(acc[i + 1], it[k2].y, jt[k2].y, bb[i / 4].y);
      *reinterpret_cast<float2*>(sm.y0 + wg::swz<kRows>(r, cb * NC + c)) = make_float2(v0, v1);
      h.y0(cb, i, v0, v1);
    });
  }
  wg::bar_sync(1, kConsumers);  // y0 whole
  h.y0_whole();

  float acc_out[32] = {};
  for (int hc = 0; hc < HID / NC; ++hc) {
    // y1_c = relu(y0 @ W1[:, c] + b1[c]); acc_out += y1_c @ Wf[c, :]
    float acc1[32] = {};
    float2 bb[8];  // b1 by column block i / 4
    ring.product<HID>(sm.y0, acc1, [&](int ks) {
      if (ks == HID / 32 - 1)
        for_each_pair(wg_id, [&](int, int c, int i) {
          bb[i / 4] = make_float2(__ldg(b1 + hc * NC + c), __ldg(b1 + hc * NC + c + 1));
        });
    });
    h.y1_free();
    wg::bar_sync(1, kConsumers);  // every warp has read the last chunk of y1
    for_each_pair(wg_id, [&](int r, int c, int i) {
      const float v0 = pair_y1<float>(acc1[i], bb[i / 4].x);
      const float v1 = pair_y1<float>(acc1[i + 1], bb[i / 4].y);
      *reinterpret_cast<float2*>(sm.y1 + wg::swz<kRows>(r, c)) = make_float2(v0, v1);
      h.y1(hc, i, v0, v1);
    });
    wg::bar_sync(1, kConsumers);  // this chunk of y1 whole
    h.y1_whole(hc);
    ring.product<NC>(sm.y1, acc_out);
  }

  // The residual terms load while the residual product runs.
  float res[32] = {}, fiv[32], fjv[32];
  float2 bb[8];  // bf by column block i / 4
  auto fetch = [&] {
    for_each_pair(wg_id, [&](int r, int c, int i) {
      bb[i / 4] = make_float2(__ldg(bf + c), __ldg(bf + c + 1));
      if (RESIDUAL) {
        const float* pi = fi + (size_t)max(pt.row[r], 0) * C_OUT + c;
        const float* pj = fj + (size_t)pt.col[r] * C_OUT + c;
        fiv[i] = __ldg(pi);
        fiv[i + 1] = __ldg(pi + 1);
        fjv[i] = __ldg(pj);
        fjv[i + 1] = __ldg(pj + 1);
      }
    });
  };
  if (RESIDUAL) {
    ring.product<C_IN>(sm.x, res, [&](int ks) {
      if (ks == C_IN / 32 - 1) fetch();
    });
    h.x_done();
  } else {
    fetch();
  }

  // The pre-norm output (common.cuh's pair_out, in float32) into Y1's
  // space.
  h.y1_free();
  wg::bar_sync(1, kConsumers);  // every warp is done with y1
  for_each_pair(wg_id, [&](int r, int c, int i) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      v[e] = acc_out[i + e];
      if (RESIDUAL) {
        v[e] = v[e] + res[i + e];
        v[e] = v[e] + fiv[i + e];
        v[e] = v[e] + fjv[i + e];
      }
    }
    *reinterpret_cast<float2*>(sm.y1 + wg::swz<kRows>(r, c)) =
        make_float2(v[0] + bb[i / 4].x, v[1] + bb[i / 4].y);
  });
  wg::bar_sync(1, kConsumers);  // the output whole
}

// The block's shared memory, 1024-byte aligned. The offset is added to the
// shared array itself, not to an integer made of its address: so the
// compiler knows every access through it is to shared memory (LDS and STS,
// not generic LD and ST with 64-bit addresses, which cost registers: the
// forward spilled 136 bytes with them, none without).
__device__ __forceinline__ WgSmem& wg_smem(uint8_t* raw) {
  return *reinterpret_cast<WgSmem*>(raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u));
}

}  // namespace
}  // namespace fdk
