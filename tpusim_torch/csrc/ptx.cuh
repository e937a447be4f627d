// PTX building blocks shared by the port's kernels (sm_90a): asynchronous
// global -> shared copies, shared-memory fragment loads and warp-level
// tensor-core products (mma.sync), with the TF32 split that keeps float32
// accuracy on the tensor cores.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tpusim {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy from global to shared memory, cached in L2
// only.  src_bytes = 0 reads nothing and writes 16 zero bytes (rows past
// the end, columns past the head dim).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 8-byte asynchronous copy from global to shared memory (one float64; the
// 16-byte form needs both addresses 16-byte aligned)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 matrices of 16-bit elements; lane l gives the address of row
// l % 8 of matrix l / 8, and register i of every lane holds its part of
// matrix i in the mma fragment layout (row lane / 4, columns 2 (lane % 4)
// and 2 (lane % 4) + 1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, transposed: lane l holds rows 2 (l % 4), 2 (l % 4) + 1 of
// column l / 4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero, as cvt.rna.tf32.f32 rounds), lo = x - hi exactly.  The
// tensor core reads only the top 19 bits of a register, so hi must be
// rounded here (raw x would give lo = 0); lo, as the tensor core reads it,
// leaves hi + lo within 2^-21 |x| of x.  Then hi*hi + hi*lo + lo*hi carries
// float32 accuracy (lo*lo is below 2^-22 of the product).  The rounding is
// two integer operations on the bits: cvt.rna.tf32.f32 runs at about a
// tenth of their rate on an NVIDIA H100 80GB HBM3 (700 W power limit) and
// slowed the attention kernel there by 13%.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b over a 16x8x8 tile, TF32 operands, float32 accumulator.
// Fragments (g = lane / 4, t = lane % 4):
//   a = {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)}   [row, k]
//   b = {(t, g), (t + 4, g)}                               [k, col]
//   d = {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)} [row, col]
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in float32 with the split: the two small terms first
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b0_hi, uint32_t b1_hi,
                                           uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(d, a_lo, b0_hi, b1_hi);
  mma_tf32(d, a_hi, b0_lo, b1_lo);
  mma_tf32(d, a_hi, b0_hi, b1_hi);
}

// d += a b over a 16x8x16 tile, bf16 operands (two per register, the lower
// column in the low half), float32 accumulator.  Fragments:
//   a = {(g, 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)}
//   b = {(2t..2t+1, g), (2t + 8..2t + 9, g)}
//   d as for mma_tf32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one register of bf16 (x in the low half), rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace tpusim
