// The pieces of the fp32 flash kernels that the self-attention and
// causal-offset routes (flash_attention.cu) share with the wide-head route
// (flash_attention_wide.cu): the block shape, the masks, the score, the
// backward's per-tile gradient, the forward's online softmax and the
// 3xTF32 products over fp32 tiles in shared memory. flash_attention.cu's
// header says what each computes and how the tiles are laid out.
//
// Include after warp_mma.cuh (mma3.cuh's note says why this header does not
// include it itself).
#pragma once
#include <stdint.h>

#include "mma3.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TC_NT = 128;       // 4 warps
constexpr int TC_ROWS = 64;      // resident rows of a block, 16 a warp

// The masks of tq queries against tk keys, query i at absolute position
// q_off + i (the causal-offset route, OFF: a rank's chunk of a sequence
// against the prefix of its keys, tk = q_off + tq). Self-attention is the
// same code with OFF false, where q_off = 0 and tk = tq are known at
// compile time and each expression reduces to the one the kernels had
// before the offset route: on an H100 the aligned instantiations give the
// same bits as those kernels and, timed in turns with them, the same times
// within the runs' spread (scripts/flash_aligned_bitwise.py), where a
// runtime q_off = 0 had made the fp32 forward at [256, 256, 128] 11 %
// slower. Query and key arguments are indices into their own rows.
template <bool OFF>
struct MaskFields {         // the offset route: tq, tk, q_off apart
  int tq, tk_, q_off_, causal, window;
  __device__ __forceinline__ int tk() const { return tk_; }
  __device__ __forceinline__ int q_off() const { return q_off_; }
};
template <>
struct MaskFields<false> {  // self-attention: one length, no offset
  int tq, causal, window;
  __device__ __forceinline__ int tk() const { return tq; }
  __device__ __forceinline__ int q_off() const { return 0; }
};
template <bool OFF>
struct Mask : MaskFields<OFF> {
  using MaskFields<OFF>::tq;
  using MaskFields<OFF>::causal;
  using MaskFields<OFF>::window;
  using MaskFields<OFF>::tk;
  using MaskFields<OFF>::q_off;
  __device__ __forceinline__ bool allow(int q, int k) const {
    return q < tq && k < tk() && (!causal || q + q_off() >= k) &&
           (window <= 0 || q + q_off() - k < window);
  }
  // For a block of `rows` resident rows and loop tiles of `bn` (n of
  // them): the key tiles that queries [q0, q0 + rows) see, and the query
  // tiles that keys [k0, k0 + rows) are seen by, as [lo, hi] (empty when
  // lo > hi; keys below the offset are seen from the first query on).
  __device__ __forceinline__ int key_tile_lo(int q0, int bn) const {
    return window > 0 ? max(0, q0 + q_off() - window + 1) / bn : 0;
  }
  __device__ __forceinline__ int key_tile_hi(int q0, int rows, int bn,
                                             int n) const {
    return causal ? min(n - 1, (q0 + q_off() + rows - 1) / bn) : n - 1;
  }
  __device__ __forceinline__ int query_tile_lo(int k0, int bn) const {
    return causal ? (OFF ? max(0, k0 - q_off()) : k0) / bn : 0;
  }
  __device__ __forceinline__ int query_tile_hi(int k0, int rows, int bn,
                                               int n) const {
    const int last = k0 + rows - 1 + window - 1;
    return window > 0
               ? min(n - 1, (OFF ? max(0, last - q_off()) : last) / bn)
               : n - 1;
  }
  // whether some pair of queries [q0, q0 + nq) and keys [k0, k0 + nk) is
  // masked (else the tile needs no per-element test)
  __device__ __forceinline__ bool partial(int q0, int nq, int k0,
                                          int nk) const {
    return q0 + nq > tq || k0 + nk > tk() ||
           (causal && q0 + q_off() < k0 + nk - 1) ||
           (window > 0 && q0 + q_off() + nq - 1 - k0 >= window);
  }
};

// The score of one element: scale, then the optional softcap; `th` keeps
// tanh for the backward's 1 - tanh^2 factor.
__device__ __forceinline__ float score(float dot, float scale, float cap,
                                       float* th) {
  float x = dot * scale;
  if (cap > 0.f) {
    const float t = tanhf(x / cap);
    *th = t;
    return cap * t;
  }
  *th = 0.f;
  return x;
}

// The backward of one tile, in the accumulator layout of the warp's 16
// rows (the thread's rows g and g + 8, columns 2t and 2t + 1 of each n8
// tile), in place: P = exp(score - lse) and dS = P (dP - delta), times
// 1 - tanh^2 under a softcap, from the raw scores s and dp; a pair that
// the masks drop (tested only on an `edge` tile) gives 0. Rows are queries
// (dq: S = Q K^T; s becomes dS, P is not kept) or, with KEY_ROWS, keys
// (dkdv: S^T = K Q^T; s becomes P^T, dp dS^T); q_0 and k_0 are the strip's
// or tile's first query and key, and `lse` and `dl` hold the statistics of
// the queries from q_0 on. (The bf16 dq ran 14 % slower with dS in dp.)
template <int BN, bool KEY_ROWS, bool OFF>
__device__ __forceinline__ void grad_tile(float (&s)[BN / 8][4],
                                          float (&dp)[BN / 8][4], int q_0,
                                          int k_0, const float* lse,
                                          const float* dl, bool edge,
                                          const Mask<OFF>& mask, float scale,
                                          float cap) {
  const int l = threadIdx.x % 32, g = l / 4, t4 = l % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + 8 * (i / 2), c = j * 8 + 2 * t4 + i % 2;
      const int qi = KEY_ROWS ? c : r, ki = KEY_ROWS ? r : c;
      float th, p = 0.f, gr = 0.f;
      const float x = score(s[j][i], scale, cap, &th);
      if (!edge || mask.allow(q_0 + qi, k_0 + ki)) {
        p = __expf(x - lse[qi]);
        gr = p * (dp[j][i] - dl[qi]);
        if (cap > 0.f) gr *= 1.f - th * th;
      }
      if constexpr (KEY_ROWS) {
        s[j][i] = p;
        dp[j][i] = gr;
      } else {
        s[j][i] = gr;
      }
    }
  }
}

// The forward's online softmax over one key tile, in the accumulator
// layout of the warp's 16 rows (row0 the first; the thread's rows g and
// g + 8): the scores S = Q K^T of keys [k0, k0 + BN) become probabilities
// in place (scale, softcap, the masks on an `edge` tile), the rows' (m, l)
// are updated, and `corr` says by how much to rescale O. The 4 lanes of a
// quad hold one row's columns and reduce its max and sum by two shuffles.
template <int BN, bool OFF>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 8][4],
                                             float (&m_r)[2], float (&l_r)[2],
                                             float (&corr)[2], int row0,
                                             int k0, bool edge,
                                             const Mask<OFF>& mask,
                                             float scale, float cap) {
  const int l = threadIdx.x % 32, g = l / 4, t4 = l % 4;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + 8 * (i / 2);
      const int c = k0 + j * 8 + 2 * t4 + i % 2;
      float th;
      const float x = score(s[j][i], scale, cap, &th);
      s[j][i] = !edge || mask.allow(r, c) ? x : NEG_INF;
      mx[i / 2] = fmaxf(mx[i / 2], s[j][i]);
    }
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_r[h], mx[h]);
    corr[h] = __expf(m_r[h] - m_new);
    m_r[h] = m_new;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = __expf(s[j][i] - m_r[i / 2]);
      rs[i / 2] += s[j][i];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    l_r[h] = l_r[h] * corr[h] + rs[h];
  }
}

// acc (a 16 x N strip as N/8 n8 tiles) += A B^T over k < D in 3xTF32: A
// the warp's 16 rows at `a`, B the N rows at `b`, both [rows][D + 4] fp32
// in shared memory. Each k step reads and splits the A fragment (a0 row
// g, k t; a1 8 rows below; a2 and a3 4 columns right) once for the N/8 n
// tiles; b0 = B[row g][k t], b1 = B[row g][k t + 4]. The loop stays rolled
// (unrolled twice, the forward spilled at D = 16).
template <int D, int N>
__device__ __forceinline__ void mma3_abt(float (&acc)[N / 8][4],
                                         const float* a, const float* b) {
  constexpr int S = D + 4;
  const int l = threadIdx.x % 32, g = l / 4, t4 = l % 4;
  const float* pa = a + g * S + t4;
  const float* pb = b + g * S + t4;
#pragma unroll 1
  for (int kk = 0; kk < D; kk += 8) {
    const float af[4] = {pa[kk], pa[8 * S + kk], pa[kk + 4],
                         pa[8 * S + kk + 4]};
    uint32_t ah[4], al[4];
    split4(af, ah, al);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      mma3(acc[j], ah, al, pb[j * 8 * S + kk], pb[j * 8 * S + kk + 4]);
  }
}

// acc (a 16 x DC strip) += P X over k < N in 3xTF32: P in the accumulator
// layout of a 16 x N strip, X the N rows at `x` ([rows][D + 4] fp32 in
// shared memory, `x` at the strip's first column). Each 8-step takes its
// rows of X in the order 2t (k = t), 2t + 1 (k = t + 4): P's accumulators
// c0 c2 c1 c3 are then its A fragment as they are, b0 = X[row 2t][col g]
// and b1 = X[row 2t + 1][col g].
template <int D, int N, int DC>
__device__ __forceinline__ void mma3_px(float (&acc)[DC / 8][4],
                                        const float (&p)[N / 8][4],
                                        const float* x) {
  constexpr int S = D + 4;
  const int l = threadIdx.x % 32, g = l / 4, t4 = l % 4;
  const float* xb = x + 2 * t4 * S + g;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float a[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
      mma3(acc[n], ah, al, xb[j * 8 * S + n * 8],
           xb[(j * 8 + 1) * S + n * 8]);
  }
}

}  // namespace
