// Fused pair MLP of the edge transition in float32, for Hopper (sm_90a), on
// wgmma and TMA: the forward that takes no gradient (every sampler, the
// service, the CLIs, a train step's self-conditioning forward).
//
// Replaces the Pallas TPU kernel framedipt_tpu/model/pallas/pair_mlp.py:78
// (_pair_mlp_kernel, reached through fused_pair_mlp), as pair_mlp.cu does,
// and computes what pair_mlp.cu computes in float32: per pair (i, j)
//
//   y0  = relu(pair @ W0 + i_term_i + j_term_j + b0)          [384]
//   y1  = relu(y0 @ W1 + b1)                                  [384]
//   out = y1 @ Wf + pair @ Wfe + fi_i + fj_j + bf             [128]  (RESIDUAL)
//   out = y1 @ Wf + bf                                               (!RESIDUAL)
//   out = LayerNorm(out) * row_mask_i * col_mask_j
//
// with common.cuh's epilogues and LayerNorm, in the plain version's addition
// order; only the order of each k-sum differs from pair_mlp.cu. A forward
// that autograd will differentiate takes pair_mlp.cu instead, whose code the
// backward's recompute shares bit for bit (model/kernels/pair_mlp.py,
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
//   stages guarded by full and empty mbarriers, in pair_mlp_tc.cuh's order:
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

// The split weights (prepare_weights): for each of W0, W1, Wf, Wfe its hi
// rows [out][in], then its lo rows [out][in].
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
};
constexpr size_t kSmemBytes = sizeof(WgSmem) + 1024;
static_assert(kSmemBytes <= 232448, "shared memory of one block");

struct Maps {
  CUtensorMap w0, w1, wf, wfe;  // split weights, [2 out][in]
  CUtensorMap pair;             // [B * Nr * Nc][C_IN]
};

// The tensor map and coordinates of slice s of a tile: its first input
// row, its first output row (hi part), and the lo part's output row.
__device__ __forceinline__ const CUtensorMap* slice_coords(const Maps& m, int s, int& c_in,
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

// Each weight w [in][out] to hi = tf32(w^T), lo = tf32(w^T - hi), K-major
// ([out][in]) into split (layout above): the operands the products read.
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
    const int o = k / in, i = k - o * in;
    uint32_t h, l;
    split_tf32(__ldg(w + (size_t)i * out + o), h, l);
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
  // and during(ks) (the epilogue's loads from device memory) while block
  // ks's do.
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

template <bool RESIDUAL>
__device__ __forceinline__ void produce(WgSmem& sm, const Maps& maps, long long tiles) {
  constexpr int kSlices = RESIDUAL ? kResSlice + kKSlices : kResSlice;
  wg::prefetch_tensor_map(&maps.w0);
  wg::prefetch_tensor_map(&maps.w1);
  wg::prefetch_tensor_map(&maps.wf);
  wg::prefetch_tensor_map(&maps.wfe);
  wg::prefetch_tensor_map(&maps.pair);
  uint32_t n = 0, k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    // Rows past the grid read as zeros.
    wg::mbar_wait(&sm.xempty, (k & 1) ^ 1);
    wg::mbar_arrive_expect_tx(&sm.xfull, kRows * C_IN * 4);
    for (int b = 0; b < C_IN / 32; ++b)
      wg::tma_load_2d(sm.x + b * kRows * 32, &maps.pair, &sm.xfull, 32 * b, (int)(t * kRows));
    for (int s = 0; s < kSlices; ++s, ++n) {
      const int st = n % kStages;
      wg::mbar_wait(&sm.empty[st], ((n / kStages) & 1) ^ 1);
      int c_in, c_out, c_lo;
      const CUtensorMap* map = slice_coords(maps, s, c_in, c_out, c_lo);
      wg::mbar_arrive_expect_tx(&sm.full[st], 2 * kSliceBytes);
      wg::tma_load_2d(sm.hi[st], map, &sm.full[st], c_in, c_out);
      wg::tma_load_2d(sm.lo[st], map, &sm.full[st], c_in, c_lo);
    }
  }
}

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
  const int wg_id = threadIdx.x >> 7;
  Consumer ring{sm, wg_id, 0};
  // This warp is done reading X: the producer may load the next tile's.
  auto release_x = [&] {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&sm.xempty);
  };
  uint32_t k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const long long p0 = t * kRows;
    PairTile& pt = sm.pt;
    load_pair_tile<float>(pt, p0, total, Nr, Nc, row_mask, col_mask);
    wg::bar_sync(1, kConsumers);  // the tile's bookkeeping
    wg::mbar_wait(&sm.xfull, k & 1);

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
      if (!RESIDUAL && cb == HID / NC - 1) release_x();
      for_each_pair(wg_id, [&](int r, int c, int i) {
        const int k2 = i / 2;
        *reinterpret_cast<float2*>(sm.y0 + wg::swz<kRows>(r, cb * NC + c)) =
            make_float2(pair_y0<float>(acc[i], it[k2].x, jt[k2].x, bb[i / 4].x),
                        pair_y0<float>(acc[i + 1], it[k2].y, jt[k2].y, bb[i / 4].y));
      });
    }
    wg::bar_sync(1, kConsumers);  // y0 whole

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
      wg::bar_sync(1, kConsumers);  // every warp has read the last chunk of y1
      for_each_pair(wg_id, [&](int r, int c, int i) {
        *reinterpret_cast<float2*>(sm.y1 + wg::swz<kRows>(r, c)) =
            make_float2(pair_y1<float>(acc1[i], bb[i / 4].x), pair_y1<float>(acc1[i + 1], bb[i / 4].y));
      });
      wg::bar_sync(1, kConsumers);  // this chunk of y1 whole
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
      release_x();
    } else {
      fetch();
    }

    // The pre-norm output (common.cuh's pair_out, in float32) into Y1's
    // space, then common.cuh's LayerNorm and mask.
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
    layer_norm_rows(sm.y1, pt, p0, ln_scale, ln_bias, out);
    wg::bar_sync(1, kConsumers);  // the tile's bookkeeping and output read
  }
}

template <bool RESIDUAL>
__global__ void __launch_bounds__(kBlockWG, 1)
pair_mlp_wg_kernel(const __grid_constant__ Maps maps, const float* __restrict__ i_term, const float* __restrict__ j_term,
                   const float* __restrict__ fi, const float* __restrict__ fj,
                   const float* __restrict__ row_mask, const float* __restrict__ col_mask,
                   const float* __restrict__ b0, const float* __restrict__ b1,
                   const float* __restrict__ bf, const float* __restrict__ ln_scale,
                   const float* __restrict__ ln_bias, float* __restrict__ out, int Nr, int Nc,
                   long long total) {
  extern __shared__ uint8_t smem_raw[];
  WgSmem& sm = *reinterpret_cast<WgSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const long long tiles = (total + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&sm.full[s], 1);
      wg::mbar_init(&sm.empty[s], kConsumers / 32);
    }
    wg::mbar_init(&sm.xfull, 1);
    wg::mbar_init(&sm.xempty, kConsumers / 32);
    wg::fence_barrier_init();
  }
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
  prepare_weights<<<256, 256, 0, stream>>>((const float*)w0, (const float*)w1, (const float*)wf,
                                           RESIDUAL ? (const float*)wfe : nullptr, split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  Maps maps;
  if (!wg::f32_sw128_map(&maps.w0, split + W0S, 2 * HID, C_IN, NC) ||
      !wg::f32_sw128_map(&maps.w1, split + W1S, 2 * HID, HID, NC) ||
      !wg::f32_sw128_map(&maps.wf, split + WFS, 2 * C_OUT, HID, NC) ||
      !wg::f32_sw128_map(&maps.wfe, split + WFES, 2 * C_OUT, C_IN, NC) ||
      !wg::f32_sw128_map(&maps.pair, pair, total, C_IN, kRows))
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
// [in, out], as pair_mlp.cu takes them; pair 16-byte aligned, i_term,
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
