// fp32-accurate products on the tensor cores: 3xTF32. Each operand x is
// split into tf32 parts x = hi + lo (split_tf32) and
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi,
// three mma.sync m16n8k8 tf32 products accumulated in fp32 (the small
// terms first). Plain TF32 keeps about three decimal digits; this keeps
// about 21 of fp32's 24 bits of each operand, and fp32 accumulation.
//
// Include after warp_mma.cuh, whose split_tf32 and mma_tf32 these call: the
// host build of the kernels (tests/_cuda_emu.py) puts its own stand-in for
// that header in its place, so this one does not include it.
#pragma once
#include <stdint.h>

// d += a b at fp32 accuracy; a is split by the caller (split4), once for
// all the n tiles it meets, b here.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// An A fragment (four fp32 values) as its tf32 parts.
__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
}
