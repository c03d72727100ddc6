// Warp-level tensor-core and async-copy instructions of sm_80+ (sm_90a on
// an H100), as small device functions: the kernels name no PTX themselves.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16" and "ldmatrix"); lane l of a
// warp has g = l / 4 and t = l % 4, a 32-bit register holds two bf16, the
// lower column (or k) in the low half:
//   A, 16 x 16 row-major, 4 registers: a0 (row g, k 2t..2t+1), a1 (row
//     g + 8, k 2t..), a2 (row g, k 2t + 8..), a3 (row g + 8, k 2t + 8..);
//   B, 16 x 8 (k x n), 2 registers: b0 (k 2t..2t+1, col g), b1 (k 2t + 8..,
//     col g);
//   C and D, 16 x 8 fp32, 4 floats: c0, c1 (row g, cols 2t, 2t + 1), c2, c3
//     (row g + 8, cols 2t, 2t + 1).
// So the C fragments of two neighbouring n8 tiles, packed to bf16 pairs,
// are the A fragment of the next product over those 16 columns.
// m16n8k8 with tf32 operands (one value a 32-bit register): A, 16 x 8,
//   a0 (row g, k t), a1 (row g + 8, k t), a2 (row g, k t + 4), a3 (row
//   g + 8, k t + 4); B, 8 x 8, b0 (k t, col g), b1 (k t + 4, col g); C and
//   D as above.
//
// The host build of the kernels' source (tests/_cuda_emu.py) takes its
// stand-ins for these functions from tests/cuda_emu/warp_mma.cuh: keep the
// two files' signatures alike.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16 contiguous bytes). Register i of lane l: row l / 4, elements
// 2 (l % 4) and 2 (l % 4) + 1 of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed: register i of lane l holds elements
// (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of matrix i.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b: m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one register of bf16 (round to nearest even), `lo` in the
// low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes from global to shared memory, asynchronously (L2 only); zeros
// where `valid` is false (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, likewise.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

// Close the group of copies this thread has issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until this thread's copies have landed (a __syncthreads after it
// makes every thread's visible to the block).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until all but this thread's N most recent groups have landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo for the tensor cores' tf32 operands: hi is x cut to tf32 (its
// low 13 mantissa bits cleared: one integer op, where cvt.rna.tf32 is a
// conversion that measured slower in the WKV6 kernels), lo = x - hi
// exactly. An mma reads the top 19 bits of each 32-bit operand, so lo
// enters cut to tf32 as well, and hi + lo keeps about 21 of x's 24 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b: m16n8k8, tf32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx.ftz: about 2 ulp; results
// below fp32's normal range flush to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
