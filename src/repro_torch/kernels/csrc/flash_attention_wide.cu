// Flash attention for Hopper (sm_90a) at fp32 head dims above 256: the
// wide-head route, forward and backward, CUDA C++.
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention -> _kernel
// (the pallas_call at :76) where the head dim passes the 256 that
// flash_attention.cu's tiles hold: the LM sweep's 4 heads of lm_d_model / 4
// give D = 288 at lm_d_model 1152 and 512 at 2048, where the reference's
// kernel runs. It computes what flash_attention.cu's fp32 kernels compute
// (the same score, masks, online softmax, lse, delta and flash-attention-2
// backward, through the same device functions of flash_common.cuh), for
// self-attention (q, k, v, o [BH, T, ld] row-major fp32).
//
// Design. The wrapper (kernels/flash_attention.py) zero-pads D up to ld, a
// multiple of WC = 128, and passes the true D^-1/2 as the score scale (zero
// columns of q and k leave the scores unchanged, zero columns of v add
// output columns that are dropped). Softmax needs the whole of each score,
// so the head dim cannot be split at the wrapper: each block forms its
// scores S = Q K^T (and in the backward dP = dO V^T, or their transposes)
// over all of ld, one 128-column chunk of both operands at a time staged
// through shared memory by cp.async, accumulating in the 3xTF32 tensor-core
// products of flash_common.cuh (mma3_abt at D = 128: fp32-accurate
// operands, fp32 sums; no flash kernel runs on the CUDA cores). The grid's
// z axis walks 128-column output slices: block z writes only columns
// [128 z, 128 z + 128) of its output (O in the forward, dQ in dq, dK and
// dV in dkdv) from the slice of V (K; Q and dO) that it loads beside its
// first chunk, so a thread's accumulators stay those of flash_attention.cu
// at D = 128. lse (forward) and delta (dq: rowsum(dO * O) over all of ld)
// span the whole head dim and are written by block z = 0; every block of a
// row recomputes the same scores in the same order, so all its slices see
// the same probabilities. No atomics: each output element has one owner.
//
// Tiles: 64 resident rows (4 warps, 16 rows each), loop tiles of 64 keys
// in the forward and 16 rows in the backward (flash_attention.cu's fp32
// widths at D = 128). Each chunk is staged, waited for and multiplied in
// turn (no ring), and the resident rows' chunks are reloaded for every
// loop tile: a simple design first; it moves each operand chunk (ld / 128)
// x (loop tiles) times through L2 where flash_attention.cu keeps its
// resident rows. Dynamic shared memory, [rows][WC + 4] fp32 tiles (the
// bank-conflict-free stride of flash_attention.cu): forward 3 tiles of 64
// rows, 101,376 bytes; dq 2 of 64 and 3 of 16 plus 2 x 64 statistics,
// 93,440; dkdv 2 of 64 and 4 of 16 plus 2 x 16 statistics, 101,504 bytes.
//
// What bounds it: operations, counted at the true D (causal pairs x D x 4
// flops in the forward, x 8 in the backward, plus the exponentials), as
// flash_attention.cu's; at the LM sweep's [256, 32, 288] every call is a
// few microseconds of launch and prologue (chip_smoke.py phase 26a times
// it beside its bound, the plain version and SDPA's math backend).
//
// Not covered (the wrapper raises, naming the gap): bf16 inputs and the
// causal-offset route above D = 256; no path reaches them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"
#include "flash_common.cuh"

namespace {

constexpr int WC = 128;          // columns of a chunk and of an output slice
constexpr int WS = WC + 4;       // row stride (floats) of a tile
constexpr int W_FWD_BN = 64;     // the forward's loop tile: keys
constexpr int W_BWD_BN = 16;     // the backward's loop tile: keys or queries

// Rows [row0, row0 + ROWS) and columns [c0, c0 + WC) of a [T, ld] fp32
// matrix into a [ROWS][WS] tile by cp.async, 16 bytes a copy, consecutive
// threads along a row; rows >= T are zero.
template <int ROWS>
__device__ __forceinline__ void cp_chunk(float* dst, const float* src,
                                         int row0, int t_len, int ld,
                                         int c0) {
  constexpr int CH = WC / 4;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += TC_NT) {
    const int r = idx / CH, c = idx % CH, row = row0 + r;
    const bool in = row < t_len;
    cp_async16(dst + r * WS + c * 4,
               src + (size_t)(in ? row : 0) * ld + c0 + c * 4, in);
  }
}

// A 16 x WC strip of accumulators, times `mul`, into rows [row0, row0 + 16)
// of a [T, ld] fp32 matrix (`out` at the strip's first column; rows >= T
// dropped).
__device__ __forceinline__ void store_slice(float* out,
                                            const float (&acc)[WC / 8][4],
                                            int row0, int t_len, int ld,
                                            float mul) {
  const int l = threadIdx.x % 32, g = l / 4, t4 = l % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= t_len) continue;
#pragma unroll
    for (int j = 0; j < WC / 8; ++j)
      *reinterpret_cast<float2*>(out + (size_t)row * ld + j * 8 + 2 * t4) =
          make_float2(acc[j][2 * h] * mul, acc[j][2 * h + 1] * mul);
  }
}

constexpr int fwd_wide_smem_bytes() {
  return (TC_ROWS + 2 * W_FWD_BN) * WS * 4;
}

// Grid (BH, row tiles, ld / WC).
__global__ void __launch_bounds__(TC_NT)
flash_wide_fwd(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int t_len, int ld, Mask<false> mask,
               float scale, float cap) {
  constexpr int BN = W_FWD_BN;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [TC_ROWS][WS]: a chunk of Q
  float* ks = qs + TC_ROWS * WS;    // [BN][WS]: the same chunk of K
  float* vs = ks + BN * WS;         // [BN][WS]: V's output slice
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;  // heaviest first
  const int c0 = blockIdx.z * WC;
  const int w = threadIdx.x / 32;
  const size_t base = (size_t)bh * t_len * ld;
  const int n_k = (t_len + BN - 1) / BN;
  const int lo = mask.key_tile_lo(q0, BN);
  const int hi = mask.key_tile_hi(q0, TC_ROWS, BN, n_k);
  float acc[WC / 8][4] = {};
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  for (int ik = lo; ik <= hi; ++ik) {
    const int k0 = ik * BN;
    float s[BN / 8][4] = {};
    for (int c = 0; c < ld; c += WC) {
      __syncthreads();   // everyone is done with the last chunk and slice
      cp_chunk<TC_ROWS>(qs, q + base, q0, t_len, ld, c);
      cp_chunk<BN>(ks, k + base, k0, t_len, ld, c);
      if (c == 0) cp_chunk<BN>(vs, v + base, k0, t_len, ld, c0);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();   // the chunk landed
      mma3_abt<WC, BN>(s, qs + w * 16 * WS, ks);              // S = Q K^T
    }
    float corr[2];
    softmax_tile<BN>(s, m_r, l_r, corr, q0 + w * 16, k0,
                     mask.partial(q0, TC_ROWS, k0, BN), mask, scale, cap);
#pragma unroll
    for (int j = 0; j < WC / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] *= corr[i / 2];
    }
    mma3_px<WC, BN, WC>(acc, s, vs);                          // O += P V
  }
  const int l = threadIdx.x % 32, g = l / 4, t4 = l % 4;
#pragma unroll
  for (int j = 0; j < WC / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] /= fmaxf(l_r[i / 2], 1e-30f);
  }
  store_slice(o + base + c0, acc, q0 + w * 16, t_len, ld, 1.f);
  if (blockIdx.z == 0 && t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + w * 16 + g + 8 * h;
      if (row < t_len)
        lse[(size_t)bh * t_len + row] = m_r[h] + logf(l_r[h]);
    }
  }
}

constexpr int dq_wide_smem_bytes() {
  return (2 * TC_ROWS + 3 * W_BWD_BN) * WS * 4 + 2 * TC_ROWS * 4;
}

// Grid (BH, row tiles, ld / WC): block z accumulates dQ's columns [z WC,
// (z + 1) WC); every block computes delta = rowsum(dO * O) of its rows over
// all of ld (two lanes a row, 16-byte loads) and block z = 0 writes it.
__global__ void __launch_bounds__(TC_NT)
flash_wide_dq(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, float* __restrict__ dq, int t_len,
              int ld, Mask<false> mask, float scale, float cap) {
  constexpr int BN = W_BWD_BN;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [TC_ROWS][WS]: a chunk of Q
  float* dos = qs + TC_ROWS * WS;      // [TC_ROWS][WS]: of dO
  float* ks = dos + TC_ROWS * WS;      // [BN][WS]: of K
  float* vs = ks + BN * WS;            // [BN][WS]: of V
  float* kx = vs + BN * WS;            // [BN][WS]: K's output slice
  float* lse_s = kx + BN * WS;         // [TC_ROWS]
  float* dl_s = lse_s + TC_ROWS;       // [TC_ROWS]
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;  // heaviest first
  const int c0 = blockIdx.z * WC;
  const int w = threadIdx.x / 32;
  const size_t base = (size_t)bh * t_len * ld;
  const int n_k = (t_len + BN - 1) / BN;
  const int lo = mask.key_tile_lo(q0, BN);
  const int hi = mask.key_tile_hi(q0, TC_ROWS, BN, n_k);

  static_assert(2 * TC_ROWS == TC_NT, "two lanes a row");
  {
    const int r = threadIdx.x / 2, part = threadIdx.x % 2, row = q0 + r;
    float a = 0.f;
    if (row < t_len) {
      const float* pd = dout + base + (size_t)row * ld;
      const float* po = o + base + (size_t)row * ld;
      for (int c = 4 * part; c < ld; c += 8) {
        const float4 x = *reinterpret_cast<const float4*>(pd + c);
        const float4 y = *reinterpret_cast<const float4*>(po + c);
        a += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    if (part == 0) {
      dl_s[r] = a;
      lse_s[r] = row < t_len ? lse[(size_t)bh * t_len + row] : 0.f;
      if (row < t_len && blockIdx.z == 0) delta[(size_t)bh * t_len + row] = a;
    }
  }

  float acc[WC / 8][4] = {};
  for (int ik = lo; ik <= hi; ++ik) {
    const int k0 = ik * BN;
    float s[BN / 8][4] = {}, dp[BN / 8][4] = {};
    for (int c = 0; c < ld; c += WC) {
      __syncthreads();   // everyone is done with the last chunk and slice
      cp_chunk<TC_ROWS>(qs, q + base, q0, t_len, ld, c);
      cp_chunk<TC_ROWS>(dos, dout + base, q0, t_len, ld, c);
      cp_chunk<BN>(ks, k + base, k0, t_len, ld, c);
      cp_chunk<BN>(vs, v + base, k0, t_len, ld, c);
      if (c == 0) cp_chunk<BN>(kx, k + base, k0, t_len, ld, c0);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();   // the chunk landed (and, first, the statistics)
      mma3_abt<WC, BN>(s, qs + w * 16 * WS, ks);              // S = Q K^T
      mma3_abt<WC, BN>(dp, dos + w * 16 * WS, vs);            // dP = dO V^T
    }
    grad_tile<BN, false>(s, dp, q0 + w * 16, k0, lse_s + w * 16,
                         dl_s + w * 16, mask.partial(q0, TC_ROWS, k0, BN),
                         mask, scale, cap);
    mma3_px<WC, BN, WC>(acc, s, kx);                          // dQ += dS K
  }
  store_slice(dq + base + c0, acc, q0 + w * 16, t_len, ld, scale);
}

constexpr int dkdv_wide_smem_bytes() {
  return (2 * TC_ROWS + 4 * W_BWD_BN) * WS * 4 + 2 * W_BWD_BN * 4;
}

// Grid (BH, key tiles, ld / WC): block z accumulates dK's and dV's
// columns [z WC, (z + 1) WC) over the query tiles that see its keys.
__global__ void __launch_bounds__(TC_NT)
flash_wide_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int t_len, int ld, Mask<false> mask,
                float scale, float cap) {
  constexpr int BN = W_BWD_BN;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [TC_ROWS][WS]: a chunk of K
  float* vs = ks + TC_ROWS * WS;       // [TC_ROWS][WS]: of V
  float* qs = vs + TC_ROWS * WS;       // [BN][WS]: of Q
  float* dos = qs + BN * WS;           // [BN][WS]: of dO
  float* qx = dos + BN * WS;           // [BN][WS]: Q's output slice
  float* dox = qx + BN * WS;           // [BN][WS]: dO's output slice
  float* lse_s = dox + BN * WS;        // [BN]
  float* dl_s = lse_s + BN;            // [BN]
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * TC_ROWS;        // causal: low keys are heaviest
  const int c0 = blockIdx.z * WC;
  const int w = threadIdx.x / 32;
  const size_t base = (size_t)bh * t_len * ld;
  const float* lse_bh = lse + (size_t)bh * t_len;
  const float* dl_bh = delta + (size_t)bh * t_len;
  const int n_q = (t_len + BN - 1) / BN;
  const int lo = mask.query_tile_lo(k0, BN);
  const int hi = mask.query_tile_hi(k0, TC_ROWS, BN, n_q);
  float acc_k[WC / 8][4] = {}, acc_v[WC / 8][4] = {};
  for (int iq = lo; iq <= hi; ++iq) {
    const int q0 = iq * BN;
    // transposed scores: rows keys k0 + w * 16 + ..., columns queries
    float st[BN / 8][4] = {}, dpt[BN / 8][4] = {};
    for (int c = 0; c < ld; c += WC) {
      __syncthreads();   // everyone is done with the last chunk and slices
      cp_chunk<TC_ROWS>(ks, k + base, k0, t_len, ld, c);
      cp_chunk<TC_ROWS>(vs, v + base, k0, t_len, ld, c);
      cp_chunk<BN>(qs, q + base, q0, t_len, ld, c);
      cp_chunk<BN>(dos, dout + base, q0, t_len, ld, c);
      if (c == 0) {
        cp_chunk<BN>(qx, q + base, q0, t_len, ld, c0);
        cp_chunk<BN>(dox, dout + base, q0, t_len, ld, c0);
        // lse and delta of the tile's queries (4 bytes a copy: a row
        // offset need not be 16-byte aligned)
        for (int idx = threadIdx.x; idx < 2 * BN; idx += TC_NT) {
          const int r = idx % BN, row = q0 + r;
          const bool in = row < t_len;
          cp_async4((idx < BN ? lse_s : dl_s) + r,
                    (idx < BN ? lse_bh : dl_bh) + (in ? row : 0), in);
        }
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();   // the chunk landed
      mma3_abt<WC, BN>(st, ks + w * 16 * WS, qs);             // S^T = K Q^T
      mma3_abt<WC, BN>(dpt, vs + w * 16 * WS, dos);           // dP^T = V dO^T
    }
    grad_tile<BN, true>(st, dpt, q0, k0 + w * 16, lse_s, dl_s,
                        mask.partial(q0, BN, k0, TC_ROWS), mask, scale, cap);
    mma3_px<WC, BN, WC>(acc_v, st, dox);                      // dV += P^T dO
    mma3_px<WC, BN, WC>(acc_k, dpt, qx);                      // dK += dS^T Q
  }
  store_slice(dk + base + c0, acc_k, k0 + w * 16, t_len, ld, scale);
  store_slice(dv + base + c0, acc_v, k0 + w * 16, t_len, ld, 1.f);
}

// Opt the kernel into more than 48 KB of dynamic shared memory (once: each
// instantiation has its own `ready`) and launch it: NT threads a block,
// one block per (head, ROWS of its t_len resident rows, WC output columns
// of ld).
template <auto Kernel, int NT, typename... Args>
int launch(int bytes, int bh, int t_len, int ld, cudaStream_t stream,
           Args... args) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid(bh, (t_len + TC_ROWS - 1) / TC_ROWS, ld / WC);
  Kernel<<<grid, NT, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

constexpr int UNSUPPORTED = -1;

bool wide_ok(int ld) { return ld > 0 && ld % WC == 0; }

Mask<false> wide_mask(int t_len, int causal, int window) {
  return {{t_len, causal, window}};
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers of
// contiguous fp32 tensors: q, k, v, o, dout, dq, dk and dv [BH, t, ld], lse
// and delta [BH, t]; `ld` is the padded head dim, a multiple of 128, and
// `scale` the score scale, the caller's true head dim ** -0.5. Each returns
// the launch's cudaError_t, or -1 for an ld that is not a positive
// multiple of 128.
extern "C" {

int flash_attention_wide_fwd(const float* q, const float* k, const float* v,
                             float* o, float* lse, int bh, int t, int ld,
                             int causal, int window, float cap, float scale,
                             void* stream) {
  if (!wide_ok(ld)) return UNSUPPORTED;
  return launch<flash_wide_fwd, TC_NT>(
      fwd_wide_smem_bytes(), bh, t, ld, (cudaStream_t)stream, q, k, v, o,
      lse, t, ld, wide_mask(t, causal, window), scale, cap);
}

int flash_attention_wide_bwd_dq(const float* q, const float* k,
                                const float* v, const float* o,
                                const float* dout, const float* lse,
                                float* delta, float* dq, int bh, int t,
                                int ld, int causal, int window, float cap,
                                float scale, void* stream) {
  if (!wide_ok(ld)) return UNSUPPORTED;
  return launch<flash_wide_dq, TC_NT>(
      dq_wide_smem_bytes(), bh, t, ld, (cudaStream_t)stream, q, k, v, o,
      dout, lse, delta, dq, t, ld, wide_mask(t, causal, window), scale, cap);
}

int flash_attention_wide_bwd_dkdv(const float* q, const float* k,
                                  const float* v, const float* dout,
                                  const float* lse, const float* delta,
                                  float* dk, float* dv, int bh, int t,
                                  int ld, int causal, int window, float cap,
                                  float scale, void* stream) {
  if (!wide_ok(ld)) return UNSUPPORTED;
  return launch<flash_wide_dkdv, TC_NT>(
      dkdv_wide_smem_bytes(), bh, t, ld, (cudaStream_t)stream, q, k, v,
      dout, lse, delta, dk, dv, t, ld, wide_mask(t, causal, window), scale,
      cap);
}

}  // extern "C"
