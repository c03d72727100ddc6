// Host stand-ins for src/repro_torch/kernels/csrc/warp_mma.cuh, for the
// host build of the kernels (tests/_cuda_emu.py puts this directory ahead
// of the source's own on the include path). Same signatures; each warp
// collective works like __shfl_xor_sync in cuda_runtime.h: every lane puts
// its operands in a per-warp buffer, the warp meets at a barrier, and each
// lane reads what the instruction gives it under the PTX fragment layouts
// described in the original header. The copies are deferred: a cp.async
// lands only at the issuing thread's next cp_async_wait_all, so a read
// that does not wait sees the tile's old contents (or the NaN fill).
#pragma once
#include <cstdint>
#include <cstring>
#include <vector>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

inline uint32_t emu_frag[32][32][8];        // [warp][lane][register]
inline const unsigned char* emu_addr[32][32];
inline long emu_mma_count = 0;      // mma_bf16 and mma_tf32 calls of thread 0

// lane: write n words, meet, then read what `get` picks, and meet again
template <int N, class Get>
inline void emu_exchange(const uint32_t* mine, Get get) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int i = 0; i < N; ++i) emu_frag[w][l][i] = mine[i];
  emu_warp[w]->arrive_and_wait();
  get(emu_frag[w]);
  emu_warp[w]->arrive_and_wait();
}

inline float emu_lo(uint32_t r) { return __bfloat162float({uint16_t(r)}); }
inline float emu_hi(uint32_t r) {
  return __bfloat162float({uint16_t(r >> 16)});
}

inline uint32_t pack_bf16x2(float lo, float hi) {
  return uint32_t(__float2bfloat16(lo).bits) |
         (uint32_t(__float2bfloat16(hi).bits) << 16);
}

// element (row, col) of 8 x 8 b16 matrix i, rows at the lanes' addresses
inline uint32_t emu_elem(const unsigned char* (&addr)[32], int i, int row,
                         int col) {
  uint16_t v;
  std::memcpy(&v, addr[i * 8 + row] + 2 * col, 2);
  return v;
}

inline void emu_ldsm(uint32_t (&r)[4], const void* p, bool trans) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_addr[w][l] = static_cast<const unsigned char*>(p);
  emu_warp[w]->arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const int a = l / 4, b = 2 * (l % 4);
    const uint32_t lo = trans ? emu_elem(emu_addr[w], i, b, a)
                              : emu_elem(emu_addr[w], i, a, b);
    const uint32_t hi = trans ? emu_elem(emu_addr[w], i, b + 1, a)
                              : emu_elem(emu_addr[w], i, a, b + 1);
    r[i] = lo | (hi << 16);
  }
  emu_warp[w]->arrive_and_wait();
}

inline void ldsm_x4(uint32_t (&r)[4], const void* p) { emu_ldsm(r, p, false); }
inline void ldsm_x4_t(uint32_t (&r)[4], const void* p) { emu_ldsm(r, p, true); }

// A[row][k] and B[k][col] read back from the lanes' fragments
inline float emu_a(uint32_t (&f)[32][8], int row, int k) {
  const uint32_t r = f[(row % 8) * 4 + (k % 8) / 2][row / 8 + 2 * (k / 8)];
  return k % 2 ? emu_hi(r) : emu_lo(r);
}
inline float emu_b(uint32_t (&f)[32][8], int k, int col) {
  const uint32_t r = f[col * 4 + (k % 8) / 2][4 + k / 8];
  return k % 2 ? emu_hi(r) : emu_lo(r);
}

inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                     uint32_t b1) {
  const uint32_t mine[6] = {a[0], a[1], a[2], a[3], b0, b1};
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  if (threadIdx.x == 0) ++emu_mma_count;
  emu_exchange<6>(mine, [&](uint32_t (&f)[32][8]) {
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i / 2), col = 2 * t + i % 2;
      float acc = 0.f;
      for (int k = 0; k < 16; ++k) acc += emu_a(f, row, k) * emu_b(f, k, col);
      d[i] += acc;
    }
  });
}

// hi: x with its low 13 mantissa bits cleared, lo = x - hi, as on the card
inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// an operand as the tensor core reads it: its top 19 bits (sign, exponent,
// 10 mantissa bits), the low 13 ignored, so the stand-in is no more exact
// than the card
inline float emu_tf32(uint32_t r) { return __uint_as_float(r & 0xffffe000u); }

inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                     uint32_t b1) {
  const uint32_t mine[6] = {a[0], a[1], a[2], a[3], b0, b1};
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  if (threadIdx.x == 0) ++emu_mma_count;
  emu_exchange<6>(mine, [&](uint32_t (&f)[32][8]) {
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i / 2), col = 2 * t + i % 2;
      float acc = 0.f;
      for (int k = 0; k < 8; ++k)
        acc += emu_tf32(f[(row % 8) * 4 + k % 4][row / 8 + 2 * (k / 4)]) *
               emu_tf32(f[col * 4 + k % 4][4 + k / 4]);
      d[i] += acc;
    }
  });
}

inline float ex2(float x) { return std::exp2(x); }

struct EmuCopy {
  void* dst;
  const void* src;
  int bytes;
  bool valid;
  int group;
};
inline thread_local std::vector<EmuCopy> emu_pending;
inline thread_local int emu_group = 0;     // groups committed by this thread

inline void cp_async16(void* dst, const void* src, bool valid) {
  emu_pending.push_back({dst, src, 16, valid, emu_group});
}
inline void cp_async4(void* dst, const void* src, bool valid) {
  emu_pending.push_back({dst, src, 4, valid, emu_group});
}
inline void cp_async_commit() { ++emu_group; }
// land the copies of every committed group but the newest n ones (n < 0:
// every copy issued)
inline void emu_land(int n) {
  std::vector<EmuCopy> keep;
  for (const EmuCopy& c : emu_pending) {
    if (n >= 0 && c.group >= emu_group - n) {
      keep.push_back(c);
    } else if (c.valid) {
      std::memcpy(c.dst, c.src, c.bytes);
    } else {
      std::memset(c.dst, 0, c.bytes);
    }
  }
  emu_pending.swap(keep);
}
inline void cp_async_wait_all() { emu_land(-1); }
template <int N>
inline void cp_async_wait() { emu_land(N); }

extern "C" long emu_mma_calls() { return emu_mma_count; }
