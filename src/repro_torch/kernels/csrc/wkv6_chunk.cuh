// Pieces of the WKV6 chunked route that its forward (rwkv6_chunk.cu) and
// backward (rwkv6_chunk_bwd.cu) share: the chunk, the per-chunk scans of
// the decays, and the state pass, which walks the chunks of one (batch *
// head) in order (forward) or from the last (backward) with a 32 x 32 tile
// of its state in the tensor cores' accumulators.
//
// Include after warp_mma.cuh and mma3.cuh (see mma3.cuh for why neither is
// included here).
#pragma once
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int C = 64;              // time steps per chunk
constexpr int TILE = 32;           // state pass: tiles of the state, 32 x 32
constexpr int T_LD = TILE + 8;     // row stride of its [C][TILE] tiles
constexpr int STAGE = 3 * C * T_LD;  // one stage of its ring: x, w (-> P), y
constexpr int STATE_FLOATS = 2 * STAGE + TILE;   // two, and the decays
constexpr int STATE_NT = 128;      // 4 warps, 16 x 16 of the tile each

// In place over one chunk, for G groups of 8 channels of q [C][ld], group
// j at channels ch0 + j * stride + [0, 8): w <- q[t] = sum_{t' <= t}
// log2 w[t'] (base 2, for ex2), with log2 w = 0 at steps >= n. One warp:
// lane (segment lane / 8, channel lane % 8) takes the logs of its 16 steps
// (independent of each other), sums them in order, and the segments'
// running totals pass up by __shfl_up_sync, each segment taking the
// previous one's last value as it is; so q never increases, also as
// rounded, and every exponent the kernels take stays <= 0.
template <int G>
__device__ __forceinline__ void log_cumsum(float* q, int ld, int n, int ch0,
                                           int stride, int lane) {
  const int seg = lane / 8;
  float* col = q + seg * 16 * ld + ch0 + lane % 8;
  float part[G][16];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      part[j][i] = seg * 16 + i < n
                       ? __log2f(fmaxf(col[j * stride + i * ld], 1e-12f))
                       : 0.f;
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 1; i < 16; ++i) part[j][i] += part[j][i - 1];
  float before[G];
#pragma unroll
  for (int j = 0; j < G; ++j) before[j] = 0.f;
#pragma unroll
  for (int s = 1; s < 4; ++s)
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float prev = __shfl_up_sync(FULL, part[j][15] + before[j], 8);
      if (seg == s) before[j] = prev;
    }
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      col[j * stride + i * ld] = part[j][i] + before[j];
}

// In place over one chunk, for channels ch0 .. ch0 + 7 of p [C][ld]: w <-
// P[t], the product of w over the steps after t (SUFFIX) or before t (else),
// and decay[ch] <- prod_t w[t], with w = 1 at steps >= n. Products of
// factors in (0, 1): nothing overflows, and no logarithm or exponential is
// taken. One warp: lane (segment lane / 8, channel lane % 8) multiplies its
// 16 steps; the products of the other segments pass by __shfl_down_sync
// (SUFFIX: from the later ones) or __shfl_up_sync.
template <bool SUFFIX>
__device__ __forceinline__ void scan_prod8(float* p, float* decay, int ld,
                                           int n, int ch0, int lane) {
  const int seg = lane / 8;
  float* col = p + seg * 16 * ld + ch0 + lane % 8;
  float x[16], part[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = seg * 16 + i < n ? col[i * ld] : 1.f;
  if constexpr (SUFFIX) {
    part[15] = 1.f;
#pragma unroll
    for (int i = 14; i >= 0; --i) part[i] = part[i + 1] * x[i + 1];
  } else {
    part[0] = 1.f;
#pragma unroll
    for (int i = 1; i < 16; ++i) part[i] = part[i - 1] * x[i - 1];
  }
  const float mine = SUFFIX ? part[0] * x[0] : part[15] * x[15];
  float other = 1.f;                 // the product over the other segments
#pragma unroll
  for (int s = 1; s < 4; ++s) {
    const float next = SUFFIX ? __shfl_down_sync(FULL, other * mine, 8)
                              : __shfl_up_sync(FULL, other * mine, 8);
    if (seg == (SUFFIX ? 3 - s : s)) other = next;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) col[i * ld] = part[i] * other;
  if (seg == (SUFFIX ? 0 : 3)) decay[ch0 + lane % 8] = other * mine;
}

// The state pass. Block (tile, batch * head): rows d0 .. d0 + 31 and
// columns j0 .. j0 + 31 of the [D, D] state, from s0; for each chunk c it
// writes the tile to ws[c], then
//   S <- diag(prod_t w_t) S + sum_t (x_t * P_t)^T y_t,
// one tensor-core product (3xTF32) over the chunk's 64 steps, while the
// next chunk's x, w and y arrive through a two-stage cp.async ring; the
// last tile goes to s_out. The forward (REVERSE false) takes x = k, y = v,
// P_t = prod_{t' > t} w_t' and walks the chunks in order: ws[c] = S_c. The
// backward takes x = r, y = do, P_t = prod_{t' < t} w_t' = e^{b_t} and
// walks from the last chunk: the tile is dS, ws[c] = dS_{c+1}, s_out = dS_0.
// Warp w owns rows d0 + 16 (w % 2) .., the A operand's 16 rows, and
// columns j0 + 16 (w / 2) .. (2 n tiles): element i of its n tile nt is
// S[d0 + 16 (w % 2) + g + 8 (i / 2)][j0 + 16 (w / 2) + 8 nt + 2 t4 + i % 2].
template <int D, bool REVERSE>
__device__ __forceinline__ void state_pass(float* smem,
                                           const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           const float* __restrict__ w,
                                           const float* __restrict__ s0,
                                           float* __restrict__ ws,
                                           float* __restrict__ s_out,
                                           int t_len) {
  float* decS = smem + 2 * STAGE;            // prod_t w_t by channel
  constexpr int TILES = D / TILE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row = 16 * (warp % 2), cols = 16 * (warp / 2);
  const int d0 = (blockIdx.x / TILES) * TILE, j0 = (blockIdx.x % TILES) * TILE;
  const int bh = blockIdx.y;
  const int n_chunks = (t_len + C - 1) / C;
  const size_t base = (size_t)bh * t_len * D;
  const size_t sbase = (size_t)bh * D * D;

  // chunk c's x and w (channels d0 ..) and y (columns j0 ..) into stage
  // `st`, rows [C][T_LD], 16 bytes a copy; missing steps are zeros.
  // Thread tid copies piece tid % 8 of rows tid / 8 + 16 j.
  static_assert(STATE_NT == 128 && TILE == 32, "8 threads a row of 8 pieces");
  auto load = [&](int c, int st) {
    float* dst = smem + st * STAGE + 4 * (tid % 8);
    const int t0 = c * C, n = min(C, t_len - t0);
#pragma unroll
    for (int j = 0; j < C / 16; ++j) {
      const int t = tid / 8 + 16 * j;
      const bool in = t < n;
      const size_t at = base + (size_t)(t0 + (in ? t : 0)) * D + 4 * (tid % 8);
      cp_async16(dst + t * T_LD, x + at + d0, in);
      cp_async16(dst + C * T_LD + t * T_LD, w + at + d0, in);
      cp_async16(dst + 2 * C * T_LD + t * T_LD, y + at + j0, in);
    }
    cp_async_commit();
  };
  // the offset in a [D, D] state of this warp's element pair (h, nt)
  auto at = [&](int h, int nt) {
    return (size_t)(d0 + row + g + 8 * h) * D + j0 + cols + 8 * nt + 2 * t4;
  };

  float acc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = s0[sbase + at(i / 2, nt) + i % 2];
  load(REVERSE ? n_chunks - 1 : 0, 0);
  for (int idx = 0; idx < n_chunks; ++idx) {
    const int c = REVERSE ? n_chunks - 1 - idx : idx;
    cp_async_wait_all();
    __syncthreads();              // chunk c has landed; the previous one is
    if (idx + 1 < n_chunks)       // done with the other stage
      load(REVERSE ? c - 1 : c + 1, (idx + 1) % 2);
    float* xS = smem + (idx % 2) * STAGE;
    float* pS = xS + C * T_LD;
    const float* yS = xS + 2 * C * T_LD;

    float* dst = ws + ((size_t)bh * n_chunks + c) * D * D;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(dst + at(h, nt)) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);

    // the decays, 8 channels a warp
    scan_prod8<!REVERSE>(pS, decS, T_LD, min(C, t_len - c * C), 8 * warp,
                         lane);
    __syncthreads();
    const float decay[2] = {decS[row + g], decS[row + g + 8]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] *= decay[i / 2];
    // S += A y, A[d][s] = x[s][d] P[s][d], K = the steps; odd k steps go to
    // a second accumulator, halving the chain of mma
    float odd[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < C; kk += 8) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = (kk + t4 + 4 * (i / 2)) * T_LD + row + g + 8 * (i % 2);
        a[i] = xS[e] * pS[e];
      }
      uint32_t ah[4], al[4];
      split4(a, ah, al);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        mma3(kk % 16 ? odd[nt] : acc[nt], ah, al,
             yS[(kk + t4) * T_LD + cols + 8 * nt + g],
             yS[(kk + t4 + 4) * T_LD + cols + 8 * nt + g]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] += odd[nt][i];
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(s_out + sbase + at(h, nt)) =
          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
}

}  // namespace
