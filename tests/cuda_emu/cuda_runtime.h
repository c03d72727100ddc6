// A CPU stand-in for the CUDA runtime features that the kernels of
// src/repro_torch/kernels/csrc/ use, so that they run on the host in
// tests/test_torch_flash_emulated.py and tests/test_torch_rwkv_emulated.py
// (built by tests/_cuda_emu.py): one std::thread per
// CUDA thread, the blocks of a launch one after another, __syncthreads a
// barrier of the block, warp shuffles through a per-warp buffer (the
// tensor-core and async-copy instructions: warp_mma.cuh). It checks the
// kernels' indexing and arithmetic, not their speed or their use of the
// card's memory model.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim;
typedef int cudaError_t;
const int cudaSuccess = 0;
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
// the card's limit on a block's shared memory (232,448 bytes on Hopper)
template <class T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int bytes) {
  return bytes <= 232448 ? 0 : 1;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float fmaxf(float a, float b) { return a > b ? a : b; }
inline float __expf(float x) { return std::exp(x); }
inline float __log2f(float x) { return std::log2(x); }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}

inline float* emu_smem = nullptr;
inline int emu_threads = 0;       // threads per block of the last launch
inline std::barrier<>* emu_block = nullptr;
inline std::vector<std::barrier<>*> emu_warp;
inline float emu_lanes[32][32];

inline void __syncthreads() { emu_block->arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float x, int off) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_lanes[w][l] = x;
  emu_warp[w]->arrive_and_wait();
  const float y = emu_lanes[w][l ^ off];
  emu_warp[w]->arrive_and_wait();
  return y;
}

// lane l gets lane l - off's x (its own below off)
inline float __shfl_up_sync(unsigned, float x, int off) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_lanes[w][l] = x;
  emu_warp[w]->arrive_and_wait();
  const float y = emu_lanes[w][l >= off ? l - off : l];
  emu_warp[w]->arrive_and_wait();
  return y;
}

// lane l gets lane l + off's x (its own past the end)
inline float __shfl_down_sync(unsigned, float x, int off) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_lanes[w][l] = x;
  emu_warp[w]->arrive_and_wait();
  const float y = emu_lanes[w][l + off < 32 ? l + off : l];
  emu_warp[w]->arrive_and_wait();
  return y;
}

inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp[threadIdx.x / 32]->arrive_and_wait();
}

// kernel<<<grid, threads, bytes, stream>>>(args...) on the host; shared
// memory starts as all-ones bytes (NaN as fp32 and as bf16) so that a read
// before a write shows up
template <class F, class... A>
void emu_launch(F kernel, dim3 grid, int threads, int bytes, cudaStream_t,
                A... args) {
  gridDim = grid;
  emu_threads = threads;
  std::vector<float> smem(bytes / 4 + 4);
  for (unsigned b = 0; b < grid.x * grid.y * grid.z; ++b) {
    const unsigned bx = b % grid.x, by = b / grid.x % grid.y,
                   bz = b / (grid.x * grid.y);
    std::memset(smem.data(), 0xff, smem.size() * sizeof(float));
    emu_smem = smem.data();
    std::barrier<> block(threads);
    emu_block = &block;
    std::vector<std::barrier<>*> warps;
    for (int w = 0; w < threads / 32; ++w)
      warps.push_back(new std::barrier<>(32));
    emu_warp = warps;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(bx, by, bz);
        kernel(args...);
      });
    for (auto& th : pool) th.join();
    for (auto* w : warps) delete w;
  }
}

extern "C" int emu_block_threads() { return emu_threads; }
