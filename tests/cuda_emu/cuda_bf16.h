// bfloat16 for the host stand-in (tests/cuda_emu/cuda_runtime.h):
// round-to-nearest-even conversion from float, as __float2bfloat16 does.
#pragma once
#include <cstdint>
#include <cstring>

#include "cuda_runtime.h"
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 x) {
  const uint32_t u = uint32_t(x.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return {uint16_t(u >> 16)};
}
