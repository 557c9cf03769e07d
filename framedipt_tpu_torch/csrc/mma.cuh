// Warp-level tensor-core pieces for Hopper (sm_90a): mma.sync products in
// TF32 (m16n8k8) and bf16 (m16n8k16) with float32 accumulators, the split of
// a float32 operand into two TF32 halves (3xTF32), bf16 packing, ldmatrix
// and cp.async.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8 / m16n8k16"),
// with g = lane / 4 and t = lane % 4:
//   TF32 A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//     a3 (g + 8, t + 4); B (8 x 8): b0 (k = t, n = g), b1 (k = t + 4, n = g).
//   bf16 A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..),
//     a3 (g + 8, 2t+8..); B (16 x 8): b0 (k = 2t..2t+1, n = g),
//     b1 (k = 2t+8..2t+9, n = g); the lower k in the lower 16 bits.
//   C (16 x 8, float32): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//     c3 (g + 8, 2t + 1).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fdk {

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact), so hi + lo
// holds about 21 of float32's 24 significant bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a @ b, one 16 x 8 x 8 TF32 product.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a @ b, one 16 x 8 x 16 bf16 product.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16 (round to nearest even; exact for values that are
// bf16 already), the first in the lower 16 bits.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices: lanes 8m .. 8m + 7 give the row addresses (16
// bytes each) of matrix m, and r[m] holds 32 bits of it: row lane / 4, bits
// 32 (lane % 4) .. For 32-bit elements (8 x 4 blocks) that is the TF32
// A-fragment layout above.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Four 8 x 8 b16 matrices, transposed: lanes 8m .. 8m + 7 give the row
// addresses (16 bytes each) of matrix m, and r[m] holds the lane's part of
// it in the B-fragment layout above.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, asynchronously, cached in L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// The same, or 16 zero bytes (nothing read from src) where !valid.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace fdk
