// Flash attention for Hopper (sm_90a): forward and backward, CUDA C++.
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention -> _kernel
// (the pallas_call at :76), which has no backward; the backward here is the
// flash-attention-2 split.
//
// Inputs are [BH, T, D] row-major (fp32 or bf16; the client, batch and head
// axes folded into BH by the wrapper, GQA's KV heads already repeated); q
// may be a shorter chunk at an offset (the causal-offset route, below).
// Every kernel computes
//   s = (q k^T) D^-1/2, optionally cap * tanh(s / cap);
//   causal mask q >= k and sliding window q - k < window, applied as
//   where(allow, s, -1e30) exactly as the reference does;
//   online softmax with fp32 (m, l, acc); out = acc / max(l, 1e-30) in the
//   input dtype, and the row log-sum-exp m + log(l) in fp32 for the backward.
// Backward: flash_bwd_dq computes delta = rowsum(dO * O) for its query rows
// (stored for flash_bwd_dkdv) and dQ, looping over key tiles; flash_bwd_dkdv
// computes dK and dV per key tile, looping over query tiles. No atomics: each
// output tile has one owner, so the result is deterministic. The C interface
// picks the kernel by dtype alone (the BY_D switches below).
//
// What bounds it: operations. At the LM's shape [144, 2048, 64] the forward
// is 7.7e10 flops and the backward 2.7e11 against ~1e8 bytes of inputs and
// outputs.
//
// fp32 inputs (flash_fwd, flash_bwd_dq, flash_bwd_dkdv): the tensor-core
// designs of the bf16 kernels below (4 warps, 64 resident rows, the loop
// operand through a two-stage cp.async ring, the softmax or the gradient in
// the accumulator layout, P and dS fed from registers into the next
// product), with fp32 tiles and 3xTF32 products (mma3.cuh: each product
// three mma.sync m16n8k8 tf32, fp32-accurate operands and fp32 sums); P
// and dS stay fp32. Tiles are [rows][D + 4] fp32: D + 4 is 4 (mod 8)
// floats, so the A-type reads X[g][t] of the resident rows and the B-type
// reads Y[g][t] (S = Q K^T, dP = dO V^T and their transposes) and Y[2t][g]
// (O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q) of a loop tile hit 32
// distinct banks (mma3_abt, mma3_px). The resident rows stay in shared
// memory and each k step loads and splits its A fragment (split in
// registers for the whole loop it would take D registers). A C fragment
// holds columns 2t and 2t + 1 of an n8 tile, where a tf32 A fragment
// wants k = t and t + 4: within each 8-step of a product over the loop
// tile's rows those rows are taken in the order 2t -> k = t, 2t + 1 -> k =
// t + 4, so the accumulators of P (P^T, dS, dS^T) are its A fragment as
// they are (c0 c2 c1 c3: no shuffle, no shared memory), and the B fragment
// is read in the same order (b0 from row 2t, b1 from 2t + 1).
// The forward: key tiles 64 wide up to D = 128, 32 above. On an H100 it
// takes 96 / 125 / 127 / 180 / 167 / 220 registers at D = 16 / 32 / 64 /
// 128 / 144 / 256 and spills nowhere (the S = Q K^T k loop is kept
// rolled: unrolled twice, D = 16 spilled); dynamic shared memory 1
// resident and 2 x 2 ring tiles of [rows][D + 4] fp32: 87,040 bytes at D =
// 64 (two blocks an SM), 168,960 at D = 128, 113,664 at D = 144 and
// 199,680 at D = 256.
// The backward (bwd_f32_cols, dkdv_f32_cols): loop tiles 64 wide up to D
// = 32, 32 at D = 64 and 16 from D = 128; dq accumulates all D columns in
// one block, dkdv one slice of them up to D = 144 and two of 128 at D =
// 256 (each slice's block recomputes S^T and dP^T). A thread of dkdv
// holds dK and dV (2 x DC / 2 fp32) and S^T and dP^T (2 x BN / 2): at D =
// 144 three slices of 48 ran 2.4x slower than one of 144. On an H100 dq
// takes 125 / 149 / 109 / 125 / 126 / 222 registers at D = 16 / 32 / 64
// / 128 / 144 / 256 and dkdv 125 / 158 / 162 / 214 / 230 / 214; neither
// spills. Dynamic shared memory 2 resident and 2 x 2 ring tiles of
// [rows][D + 4] fp32 and the row statistics: dq 31,232 / 55,808 / 70,144
// / 101,888 / 114,176 / 200,192 bytes, dkdv 31,744 / 56,320 / 70,144 /
// 101,632 / 113,920 / 199,936; three blocks an SM at D = 64, two at 128
// and 144 (with 32-wide loop tiles one, and 1.2 to 1.3x slower), one at
// 256.
//
// bf16 inputs (flash_fwd_tc, flash_bwd_dq_tc, flash_bwd_dkdv_tc): tensor
// cores, mma.sync m16n8k16 bf16 -> fp32 (warp_mma.cuh). 4 warps; a block
// owns 64 rows of its resident operand (16 a warp), kept in shared memory as
// bf16 for the whole loop: Q in the forward, Q and dO in dq, K and V in
// dkdv. The loop operand (K, V in the forward and dq; Q, dO, lse, delta in
// dkdv) streams through a ring of two stages by cp.async, the next tile's
// copy in flight while the current one is multiplied. Tiles are
// [rows][D + 8] bf16: the 16-byte pad puts the 8 rows of every ldmatrix
// 8 x 8 matrix on distinct bank groups. The forward keeps its warp's Q
// fragments in registers for the whole loop, computes S = Q K^T, and runs
// the online softmax in the accumulator layout: a thread holds rows g and
// g + 8 of its strip, and the 4 lanes of a quad reduce a row's max and sum
// by two shuffles; m, l and the correction stay fp32. P then becomes the A
// operand of O += P V in registers, packed to bf16 pairs; the epilogue
// divides by max(l, 1e-30) and writes lse = m + log l. dkdv works on
// transposed scores S^T = K Q^T (rows = keys), so P^T and dS^T come out in
// the accumulator layout of a 16-row strip and become the A operand of
// dV += P^T dO and dK += dS^T Q; dq does the same with dS for dQ += dS K.
// Neither P nor dS touches shared memory, and one __syncthreads a loop step
// guards the ring. P and dS are rounded to bf16 before their products, as
// flash-attention-2 does. delta comes from 16-byte loads of dO and O, D/8
// lanes to a row.
//
// Tiles: 64 resident rows (one m16 strip a warp). Loop tiles: the forward
// 64 keys wide up to D = 128 (a thread holds O, D/2 fp32, S, 32 fp32, and
// Q's fragments, D/4 registers, for the whole loop) and 32 wide above,
// where Q is reloaded from shared memory by ldmatrix at each k step (O
// alone is 128 fp32 at D = 256); the backward 64 wide at D <= 32, 32 wide
// at D >= 64. Registers bound the design. On an H100 (sm_90a, `nvcc
// -Xptxas -v` as chip_smoke.py phase 4 prints it) the forward takes 95 /
// 124 / 127 / 178 / 129 / 224 registers at D = 16 / 32 / 64 / 128 / 144 /
// 256. A thread of dkdv holds dK and dV (2 x D/2 fp32) plus S^T and dP^T
// (2 x BN/2 fp32): 64-wide tiles at D = 64 took dkdv to 200 registers, two
// blocks an SM, and ran slower than 32-wide tiles at 160 registers, three
// blocks an SM; dq ran alike at both widths (138 and 103 registers).
// Capping dkdv at three 64-wide blocks an SM spilled. At D = 128 dkdv takes
// 238 registers, dq 130. Above D = 128 the backward splits its output
// columns over grid z (dq_tc_cols, dkdv_tc_cols): each block recomputes the
// full S and dP (S^T and dP^T) and accumulates only its DC columns of dQ
// (dK and dV), so a thread's accumulators stay DC / 2 (2 x DC / 2) fp32: dq
// one slice of 144 at D = 144 (162 registers) and two of 128 at D = 256
// (130), dkdv three of 48 at D = 144 (137) and two of 128 at D = 256
// (232). No bf16 instantiation spills. Dynamic shared memory: the forward
// 1 resident tile and 2 x 2 ring tiles of [rows][D + 8] bf16, 46,080 bytes
// at D = 64, 87,040 at D = 128 and 101,376 at D = 256; the backward 2
// resident and 2 x 2 ring tiles plus the fp32 row statistics, 37,376
// bytes at D = 64, 70,144 at D = 128 and 135,680 at D = 256 (over 48 KB
// only after the cudaFuncSetAttribute of launch, once per instantiation).
//
// Head dims: the C interface instantiates D = 16, 32, 64, 128, 144 and 256
// (BY_D) and takes the score scale from the caller, who zero-pads any
// other D <= 256 up to the next of these and passes its own D^-1/2
// (kernels/flash_attention.py). fp32 self-attention above D = 256 takes
// the wide-head route of flash_attention_wide.cu, a library of its own;
// the fp32 pieces both use (the masks, the score, the softmax and gradient
// of a tile, the 3xTF32 products) are in flash_common.cuh.
//
// Both designs skip tiles that the causal mask or the window masks
// completely (a skipped tile adds exp(-1e30 - m) = 0 in the reference). A
// partially masked row gives exp(0) junk while its running max is still
// -1e30; the correction exp(-1e30 - m) = 0 of its first allowed key wipes
// it, as in the reference. Ragged T is handled by zero-filled loads and
// masking keys and rows >= T.
//
// The causal-offset route: q [BH, tq, D] against k, v [BH, tk, D] with
// query i at absolute position q_off + i (tk = q_off + tq: a rank of a
// sequence-parallel split holds queries [q_off, q_off + tq) and the
// all-gathered prefix of keys). The mask (Mask) carries tq, tk and q_off,
// and its tile ranges and `partial` shift by the offset; nothing else
// changes. The forward and dq run their grids over tq's 64-row tiles, dkdv
// over tk's (low keys stay the heaviest: a key below q_off is seen by every
// query); lse and delta are [BH, tq], dK and dV [BH, tk, D]. Self-attention
// is the aligned case, q_off = 0 and tq = tk, through the same code: every
// kernel is a template on OFF (Mask<OFF>); self-attention runs OFF = false,
// where the offset is a compile-time 0 and tk is tq, so no instruction
// tests for it, and the two routes build as two libraries (the C interface
// below).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"
#include "flash_common.cuh"

namespace {

// ---- tensor cores: bf16 (mma.sync m16n8k16) and fp32 (3xTF32) ----

typedef __nv_bfloat16 bf16;

// width of the backward's loop tiles
template <int D>
__host__ __device__ constexpr int tc_cols() { return D >= 64 ? 32 : 64; }
// row stride (bf16) of a [rows][D] tile in shared memory
template <int D>
__host__ __device__ constexpr int tc_stride() { return D + 8; }
// The largest multiple of 16 that divides D and is at most MAX: the output
// columns a block of the backward accumulates (a grid z step each), so
// that a thread's accumulators stay in registers at D = 144 and 256.
template <int D, int MAX>
__host__ __device__ constexpr int tc_split() {
  int best = 16;
  for (int c = 16; c <= MAX && c <= D; c += 16)
    if (D % c == 0) best = c;
  return best;
}
// dq: 16 x DC accumulators a warp (DC / 2 a thread), up to 144 columns
template <int D>
__host__ __device__ constexpr int dq_tc_cols() { return tc_split<D, 144>(); }
// dkdv: two such strips (dK and dV), up to 128 columns each
template <int D>
__host__ __device__ constexpr int dkdv_tc_cols() { return tc_split<D, 128>(); }
// The fp32 backward's loop tiles: as the bf16 one's up to D = 64, 16 wide
// from D = 128 (at D = 128 and 144 the smaller ring lets two blocks share
// an SM, at 256 32-wide tiles would pass 227 KB); its output columns: dq
// all D in one block (two slices of 128 at D = 256, each recomputing S
// and dP, ran slower), dkdv slices of up to 144 (one at D = 144, where
// three of 48 each recomputed S^T and dP^T)
template <int D>
__host__ __device__ constexpr int bwd_f32_cols() {
  return D >= 128 ? 16 : tc_cols<D>();
}
template <int D>
__host__ __device__ constexpr int dkdv_f32_cols() { return tc_split<D, 144>(); }

// row stride (elements) of a [rows][D] tile of T in shared memory: bf16
// tc_stride, fp32 D + 4
template <typename T, int D>
__host__ __device__ constexpr int tile_stride() {
  return sizeof(T) == 2 ? tc_stride<D>() : D + 4;
}

// Rows [row0, row0 + ROWS) of a [T, D] matrix (bf16 or fp32) into a [ROWS]
// [tile_stride] tile by cp.async, 16 bytes a copy, consecutive threads
// along a row; rows >= T are zero.
template <int ROWS, int D, typename T>
__device__ __forceinline__ void cp_tile(T* dst, const T* src, int row0,
                                        int t_len) {
  constexpr int V = 16 / sizeof(T), CH = D / V;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += TC_NT) {
    const int r = idx / CH, c = idx % CH, row = row0 + r;
    const bool in = row < t_len;
    cp_async16(dst + r * tile_stride<T, D>() + c * V,
               src + (size_t)(in ? row : 0) * D + c * V, in);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// The row statistics of dq's rows [q0, q0 + TC_ROWS) (`dout` and `o` at
// this head's [T, D], `lse` and `delta` at its [T]): delta = rowsum(dO * O)
// into dl_s and, from block z = 0, into `delta`; lse into lse_s. 16-byte
// loads, LPR lanes to a row (the largest power of two up to 32 that
// divides the row's 16-byte chunks), reduced by shuffles; every thread
// takes part in every step.
template <int D, typename T>
__device__ __forceinline__ void row_stats(const T* dout, const T* o,
                                          const float* lse, float* delta,
                                          float* lse_s, float* dl_s, int q0,
                                          int t_len) {
  constexpr int V = 16 / sizeof(T), CH = D / V;
  constexpr int LPR = CH % 32 == 0 ? 32 : CH % 16 == 0 ? 16
                      : CH % 8 == 0 ? 8 : CH % 4 == 0 ? 4 : 2;
  static_assert(CH % LPR == 0 && TC_ROWS * LPR % TC_NT == 0, "delta lanes");
  for (int idx = threadIdx.x; idx < TC_ROWS * LPR; idx += TC_NT) {
    const int r = idx / LPR, part = idx % LPR, row = q0 + r;
    float acc = 0.f;
    if (row < t_len) {
      for (int c = part; c < CH; c += LPR) {
        const uint4 a = *reinterpret_cast<const uint4*>(
            dout + (size_t)row * D + c * V);
        const uint4 b = *reinterpret_cast<const uint4*>(
            o + (size_t)row * D + c * V);
        const T* ea = reinterpret_cast<const T*>(&a);
        const T* eb = reinterpret_cast<const T*>(&b);
#pragma unroll
        for (int j = 0; j < V; ++j) acc += to_f32(ea[j]) * to_f32(eb[j]);
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (part == 0) {
      dl_s[r] = acc;
      lse_s[r] = row < t_len ? lse[row] : 0.f;
      if (row < t_len && blockIdx.z == 0) delta[row] = acc;
    }
  }
}

// acc (a 16 x N strip as N/8 n8 tiles) += A B^T over k in [kk, kk + 16):
// A the warp's fragment of that k step, B the N rows at `b`, [rows][D + 8]
// in shared memory.
template <int D, int N>
__device__ __forceinline__ void mma_abt_k(float (&acc)[N / 8][4],
                                          const uint32_t (&af)[4],
                                          const bf16* b, int kk) {
  constexpr int S = tc_stride<D>();
  const int l = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    uint32_t bf[4];
    ldsm_x4(bf, b + (j * 16 + (l / 16) * 8 + l % 8) * S + kk +
                    ((l / 8) % 2) * 8);
    mma_bf16(acc[2 * j], af, bf[0], bf[1]);
    mma_bf16(acc[2 * j + 1], af, bf[2], bf[3]);
  }
}

// A warp's 16 rows at `a` ([rows][D + 8] in shared memory) as the A
// fragments of a product over k < D.
template <int D>
__device__ __forceinline__ void ldsm_a(uint32_t (&af)[D / 16][4],
                                       const bf16* a) {
  const int l = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(af[kk], a + (l % 16) * tc_stride<D>() + kk * 16 + (l / 16) * 8);
}

// acc += A B^T over k < D: A the warp's 16 rows at `a` in shared memory,
// loaded one k step at a time ...
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const bf16* a,
                                        const bf16* b) {
  const int l = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + (l % 16) * tc_stride<D>() + kk + (l / 16) * 8);
    mma_abt_k<D, N>(acc, af, b, kk);
  }
}

// ... or already in registers (ldsm_a).
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4],
                                        const uint32_t (&af)[D / 16][4],
                                        const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) mma_abt_k<D, N>(acc, af[kk], b, kk * 16);
}

// acc (a 16 x DC strip) += P X over k < N: P in registers as N/16 A
// fragments, X the N rows at `x` (DC columns of a [rows][D + 8] tile in
// shared memory, `x` at the first of them).
template <int D, int N, int DC>
__device__ __forceinline__ void mma_px(float (&acc)[DC / 8][4],
                                       const uint32_t (&p)[N / 16][4],
                                       const bf16* x) {
  constexpr int S = tc_stride<D>();
  const int l = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < DC / 16; ++j) {
      uint32_t bf[4];
      ldsm_x4_t(bf, x + (kk * 16 + l % 8 + ((l / 8) % 2) * 8) * S + j * 16 +
                        (l / 16) * 8);
      mma_bf16(acc[2 * j], p[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * j + 1], p[kk], bf[2], bf[3]);
    }
  }
}

// The accumulators of a 16 x N strip as the A fragments of a product over
// those N columns, in bf16.
template <int N>
__device__ __forceinline__ void to_a_frags(uint32_t (&f)[N / 16][4],
                                           const float (&c)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    f[kk][0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
    f[kk][1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
    f[kk][2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    f[kk][3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// A 16 x DC strip of accumulators, times `mul`, into rows [row0, row0 + 16)
// of a [T, D] bf16 or fp32 matrix (`out` at the strip's first column; rows
// >= T dropped).
template <int D, int DC, typename T>
__device__ __forceinline__ void store_strip(T* out,
                                            const float (&acc)[DC / 8][4],
                                            int row0, int t_len, float mul) {
  const int l = threadIdx.x % 32, g = l / 4, t4 = l % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= t_len) continue;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      T* at = out + (size_t)row * D + j * 8 + 2 * t4;
      const float lo = acc[j][2 * h] * mul, hi = acc[j][2 * h + 1] * mul;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint32_t*>(at) = pack_bf16x2(lo, hi);
      else
        *reinterpret_cast<float2*>(at) = make_float2(lo, hi);
    }
  }
}

// The forward's epilogue: O / max(l, 1e-30) into rows [row0, row0 + 16) of
// `o` and lse = m + log l into `lse` (the [BH, T] row of this head).
template <int D, typename T>
__device__ __forceinline__ void finish_rows(T* o, float* lse,
                                            float (&acc)[D / 8][4],
                                            const float (&m_r)[2],
                                            const float (&l_r)[2], int row0,
                                            int t_len) {
  const int l = threadIdx.x % 32, g = l / 4, t4 = l % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] /= fmaxf(l_r[i / 2], 1e-30f);
  }
  store_strip<D, D>(o, acc, row0, t_len, 1.f);
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row < t_len) lse[row] = m_r[h] + logf(l_r[h]);
    }
  }
}

// The forward's loop tiles: 64 keys wide up to D = 128, where a thread
// holds O (D/2 fp32), S (32 fp32) and its Q fragments (D/4 registers) for
// the whole loop; above, 32 wide, with Q reloaded from shared memory by
// ldmatrix at every k step (O alone is D/2 = 128 fp32 at D = 256).
template <int D>
__host__ __device__ constexpr int fwd_tc_cols() { return D > 128 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr bool fwd_q_in_regs() { return D <= 128; }

template <int D>
constexpr int fwd_tc_smem_bytes() {
  return (TC_ROWS + 4 * fwd_tc_cols<D>()) * tc_stride<D>() * 2;
}

template <int D, bool OFF>
__global__ void __launch_bounds__(TC_NT)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, int t_len, Mask<OFF> mask,
             float scale, float cap) {
  constexpr int BN = fwd_tc_cols<D>(), S = tc_stride<D>();
  extern __shared__ __align__(16) float smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [TC_ROWS][S]
  bf16* ks = qs + TC_ROWS * S;                // [2][BN][S]: the K ring
  bf16* vs = ks + 2 * BN * S;                 // [2][BN][S]: the V ring
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;  // heaviest first
  const int w = threadIdx.x / 32;
  // t_len: the queries' length (tq); self-attention's keys too
  const int tq = t_len, tk = OFF ? mask.tk() : t_len;
  const size_t qbase = (size_t)bh * t_len * D;
  const size_t kbase = OFF ? (size_t)bh * tk * D : qbase;
  const int n_k = (tk + BN - 1) / BN;
  const int lo = mask.key_tile_lo(q0, BN);
  const int hi = mask.key_tile_hi(q0, TC_ROWS, BN, n_k);

  cp_tile<TC_ROWS, D>(qs, q + qbase, q0, tq);
  cp_tile<BN, D>(ks, k + kbase, lo * BN, tk);
  cp_tile<BN, D>(vs, v + kbase, lo * BN, tk);
  cp_async_commit();
  // the warp's 16 query rows, for the whole loop (up to D = 128)
  uint32_t qf[fwd_q_in_regs<D>() ? D / 16 : 1][4];
  float acc[D / 8][4] = {};
  // online softmax of the thread's rows g and g + 8 of its strip; the 4
  // lanes of a quad hold one row's columns
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  for (int ik = lo; ik <= hi; ++ik) {
    const int buf = (ik - lo) & 1, k0 = ik * BN;
    cp_async_wait_all();
    __syncthreads();   // tile ik landed; everyone is done with tile ik - 1
    if (ik < hi) {
      cp_tile<BN, D>(ks + (buf ^ 1) * BN * S, k + kbase, k0 + BN, tk);
      cp_tile<BN, D>(vs + (buf ^ 1) * BN * S, v + kbase, k0 + BN, tk);
    }
    cp_async_commit();
    float s[BN / 8][4] = {};
    if constexpr (fwd_q_in_regs<D>()) {
      if (ik == lo) ldsm_a<D>(qf, qs + w * 16 * S);
      mma_abt<D, BN>(s, qf, ks + buf * BN * S);     // S = Q K^T
    } else {
      mma_abt<D, BN>(s, qs + w * 16 * S, ks + buf * BN * S);
    }
    float corr[2];
    softmax_tile<BN>(s, m_r, l_r, corr, q0 + w * 16, k0,
                     mask.partial(q0, TC_ROWS, k0, BN), mask, scale, cap);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] *= corr[i / 2];
    }
    uint32_t pf[BN / 16][4];
    to_a_frags<BN>(pf, s);
    mma_px<D, BN, D>(acc, pf, vs + buf * BN * S);   // O += P V
  }
  finish_rows<D>(o + qbase, lse + (size_t)bh * tq, acc, m_r, l_r,
                 q0 + w * 16, tq);
}

// The fp32 forward: flash_fwd_tc's design with fp32 tiles [rows][D + 4]
// and 3xTF32 products (mma3), Q read and split at each k step.
template <int D>
constexpr int fwd_f32_smem_bytes() {
  return (TC_ROWS + 4 * fwd_tc_cols<D>()) * (D + 4) * 4;
}

template <int D, bool OFF>
__global__ void __launch_bounds__(TC_NT)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int t_len, Mask<OFF> mask,
          float scale, float cap) {
  constexpr int BN = fwd_tc_cols<D>(), S = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [TC_ROWS][S]
  float* ks = qs + TC_ROWS * S;     // [2][BN][S]: the K ring
  float* vs = ks + 2 * BN * S;      // [2][BN][S]: the V ring
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;  // heaviest first
  const int w = threadIdx.x / 32;
  // t_len: the queries' length (tq); self-attention's keys too
  const int tq = t_len, tk = OFF ? mask.tk() : t_len;
  const size_t qbase = (size_t)bh * t_len * D;
  const size_t kbase = OFF ? (size_t)bh * tk * D : qbase;
  const int n_k = (tk + BN - 1) / BN;
  const int lo = mask.key_tile_lo(q0, BN);
  const int hi = mask.key_tile_hi(q0, TC_ROWS, BN, n_k);

  cp_tile<TC_ROWS, D>(qs, q + qbase, q0, tq);
  cp_tile<BN, D>(ks, k + kbase, lo * BN, tk);
  cp_tile<BN, D>(vs, v + kbase, lo * BN, tk);
  cp_async_commit();
  float acc[D / 8][4] = {};
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  for (int ik = lo; ik <= hi; ++ik) {
    const int buf = (ik - lo) & 1, k0 = ik * BN;
    cp_async_wait_all();
    __syncthreads();   // tile ik landed; everyone is done with tile ik - 1
    if (ik < hi) {
      cp_tile<BN, D>(ks + (buf ^ 1) * BN * S, k + kbase, k0 + BN, tk);
      cp_tile<BN, D>(vs + (buf ^ 1) * BN * S, v + kbase, k0 + BN, tk);
    }
    cp_async_commit();
    float s[BN / 8][4] = {};
    mma3_abt<D, BN>(s, qs + w * 16 * S, ks + buf * BN * S);   // S = Q K^T
    float corr[2];
    softmax_tile<BN>(s, m_r, l_r, corr, q0 + w * 16, k0,
                     mask.partial(q0, TC_ROWS, k0, BN), mask, scale, cap);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] *= corr[i / 2];
    }
    mma3_px<D, BN, D>(acc, s, vs + buf * BN * S);             // O += P V
  }
  finish_rows<D>(o + qbase, lse + (size_t)bh * tq, acc, m_r, l_r,
                 q0 + w * 16, tq);
}

template <int D>
constexpr int dq_tc_smem_bytes() {
  return (2 * TC_ROWS + 4 * tc_cols<D>()) * tc_stride<D>() * 2 +
         2 * TC_ROWS * 4;
}

// Grid (BH, row tiles, D / dq_tc_cols): block z accumulates dQ's columns
// [z DC, (z + 1) DC); every block computes the full S and dP, and block
// z = 0 writes delta.
template <int D, bool OFF>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ o,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ delta, bf16* __restrict__ dq, int t_len,
                Mask<OFF> mask, float scale, float cap) {
  constexpr int BN = tc_cols<D>(), S = tc_stride<D>();
  constexpr int DC = dq_tc_cols<D>();
  extern __shared__ __align__(16) float smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [TC_ROWS][S]
  bf16* dos = qs + TC_ROWS * S;               // [TC_ROWS][S]
  bf16* ks = dos + TC_ROWS * S;               // [2][BN][S]: the K ring
  bf16* vs = ks + 2 * BN * S;                 // [2][BN][S]: the V ring
  float* lse_s = reinterpret_cast<float*>(vs + 2 * BN * S);  // [TC_ROWS]
  float* dl_s = lse_s + TC_ROWS;                              // [TC_ROWS]
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;  // heaviest first
  const int c0 = blockIdx.z * DC;
  const int w = threadIdx.x / 32;
  // t_len: the queries' length (tq); self-attention's keys too
  const int tq = t_len, tk = OFF ? mask.tk() : t_len;
  const size_t qbase = (size_t)bh * t_len * D;
  const size_t kbase = OFF ? (size_t)bh * tk * D : qbase;
  const int n_k = (tk + BN - 1) / BN;
  const int lo = mask.key_tile_lo(q0, BN);
  const int hi = mask.key_tile_hi(q0, TC_ROWS, BN, n_k);

  cp_tile<TC_ROWS, D>(qs, q + qbase, q0, tq);
  cp_tile<TC_ROWS, D>(dos, dout + qbase, q0, tq);
  cp_tile<BN, D>(ks, k + kbase, lo * BN, tk);
  cp_tile<BN, D>(vs, v + kbase, lo * BN, tk);
  cp_async_commit();
  row_stats<D>(dout + qbase, o + qbase, lse + (size_t)bh * tq,
               delta + (size_t)bh * tq, lse_s, dl_s, q0, tq);

  float acc[DC / 8][4] = {};
  for (int ik = lo; ik <= hi; ++ik) {
    const int buf = (ik - lo) & 1, k0 = ik * BN;
    cp_async_wait_all();
    __syncthreads();   // tile ik landed; everyone is done with tile ik - 1
    if (ik < hi) {
      cp_tile<BN, D>(ks + (buf ^ 1) * BN * S, k + kbase, k0 + BN, tk);
      cp_tile<BN, D>(vs + (buf ^ 1) * BN * S, v + kbase, k0 + BN, tk);
    }
    cp_async_commit();
    const bf16* kt = ks + buf * BN * S;
    float s[BN / 8][4] = {}, dp[BN / 8][4] = {};
    mma_abt<D, BN>(s, qs + w * 16 * S, kt);         // S = Q K^T
    mma_abt<D, BN>(dp, dos + w * 16 * S, vs + buf * BN * S);  // dP = dO V^T
    grad_tile<BN, false>(s, dp, q0 + w * 16, k0, lse_s + w * 16,
                         dl_s + w * 16, mask.partial(q0, TC_ROWS, k0, BN),
                         mask, scale, cap);
    uint32_t df[BN / 16][4];
    to_a_frags<BN>(df, s);
    mma_px<D, BN, DC>(acc, df, kt + c0);            // dQ += dS K
  }
  store_strip<D, DC>(dq + qbase + c0, acc, q0 + w * 16, tq, scale);
}

template <int D>
constexpr int dkdv_tc_smem_bytes() {
  return (2 * TC_ROWS + 4 * tc_cols<D>()) * tc_stride<D>() * 2 +
         4 * tc_cols<D>() * 4;
}

// Grid (BH, key tiles, D / dkdv_tc_cols): block z accumulates dK's and
// dV's columns [z DC, (z + 1) DC); every block computes the full S^T and
// dP^T.
template <int D, bool OFF>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int t_len, Mask<OFF> mask,
                  float scale, float cap) {
  constexpr int BN = tc_cols<D>(), S = tc_stride<D>();
  constexpr int DC = dkdv_tc_cols<D>();
  extern __shared__ __align__(16) float smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [TC_ROWS][S]
  bf16* vs = ks + TC_ROWS * S;                // [TC_ROWS][S]
  bf16* qs = vs + TC_ROWS * S;                // [2][BN][S]: the Q ring
  bf16* dos = qs + 2 * BN * S;                // [2][BN][S]: the dO ring
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BN * S);  // [2][BN]
  float* dl_s = lse_s + 2 * BN;                               // [2][BN]
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * TC_ROWS;        // causal: low keys are heaviest
  const int c0 = blockIdx.z * DC;
  const int w = threadIdx.x / 32;
  // t_len: the queries' length (tq); self-attention's keys too
  const int tq = t_len, tk = OFF ? mask.tk() : t_len;
  const size_t qbase = (size_t)bh * t_len * D;
  const size_t kbase = OFF ? (size_t)bh * tk * D : qbase;
  const float* lse_bh = lse + (size_t)bh * tq;
  const float* dl_bh = delta + (size_t)bh * tq;
  const int n_q = (tq + BN - 1) / BN;
  const int lo = mask.query_tile_lo(k0, BN);
  const int hi = mask.query_tile_hi(k0, TC_ROWS, BN, n_q);
  // query tile iq into ring slot `buf`: Q, dO, and lse and delta (4 bytes a
  // copy: a row offset need not be 16-byte aligned)
  auto load = [&](int iq, int buf) {
    const int q0 = iq * BN;
    cp_tile<BN, D>(qs + buf * BN * S, q + qbase, q0, tq);
    cp_tile<BN, D>(dos + buf * BN * S, dout + qbase, q0, tq);
    for (int idx = threadIdx.x; idx < 2 * BN; idx += TC_NT) {
      const int r = idx % BN, row = q0 + r;
      const bool in = row < tq;
      cp_async4((idx < BN ? lse_s : dl_s) + buf * BN + r,
                (idx < BN ? lse_bh : dl_bh) + (in ? row : 0), in);
    }
  };

  cp_tile<TC_ROWS, D>(ks, k + kbase, k0, tk);
  cp_tile<TC_ROWS, D>(vs, v + kbase, k0, tk);
  load(lo, 0);
  cp_async_commit();
  float acc_k[DC / 8][4] = {}, acc_v[DC / 8][4] = {};
  for (int iq = lo; iq <= hi; ++iq) {
    const int buf = (iq - lo) & 1, q0 = iq * BN;
    cp_async_wait_all();
    __syncthreads();   // tile iq landed; everyone is done with tile iq - 1
    if (iq < hi) load(iq + 1, buf ^ 1);
    cp_async_commit();
    const bf16* qt = qs + buf * BN * S;
    const bf16* dot_ = dos + buf * BN * S;
    // transposed scores: rows keys k0 + w * 16 + ..., columns queries
    float st[BN / 8][4] = {}, dpt[BN / 8][4] = {};
    mma_abt<D, BN>(st, ks + w * 16 * S, qt);         // S^T = K Q^T
    mma_abt<D, BN>(dpt, vs + w * 16 * S, dot_);      // dP^T = V dO^T
    grad_tile<BN, true>(st, dpt, q0, k0 + w * 16, lse_s + buf * BN,
                        dl_s + buf * BN, mask.partial(q0, BN, k0, TC_ROWS),
                        mask, scale, cap);
    uint32_t f[BN / 16][4];
    to_a_frags<BN>(f, st);
    mma_px<D, BN, DC>(acc_v, f, dot_ + c0);         // dV += P^T dO
    to_a_frags<BN>(f, dpt);
    mma_px<D, BN, DC>(acc_k, f, qt + c0);           // dK += dS^T Q
  }
  store_strip<D, DC>(dk + kbase + c0, acc_k, k0 + w * 16, tk, scale);
  store_strip<D, DC>(dv + kbase + c0, acc_v, k0 + w * 16, tk, 1.f);
}

// The fp32 backward: the designs of flash_bwd_dq_tc and flash_bwd_dkdv_tc
// with fp32 tiles [rows][D + 4] and 3xTF32 products (mma3_abt, mma3_px);
// P and dS stay fp32.
template <int D>
constexpr int dq_f32_smem_bytes() {
  return (2 * TC_ROWS + 4 * bwd_f32_cols<D>()) * (D + 4) * 4 +
         2 * TC_ROWS * 4;
}

// Grid (BH, row tiles): as flash_bwd_dq_tc, but every block accumulates
// all D columns of dQ.
template <int D, bool OFF>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ o,
             const float* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ delta, float* __restrict__ dq, int t_len,
             Mask<OFF> mask, float scale, float cap) {
  constexpr int BN = bwd_f32_cols<D>(), S = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [TC_ROWS][S]
  float* dos = qs + TC_ROWS * S;       // [TC_ROWS][S]
  float* ks = dos + TC_ROWS * S;       // [2][BN][S]: the K ring
  float* vs = ks + 2 * BN * S;         // [2][BN][S]: the V ring
  float* lse_s = vs + 2 * BN * S;      // [TC_ROWS]
  float* dl_s = lse_s + TC_ROWS;       // [TC_ROWS]
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;  // heaviest first
  const int w = threadIdx.x / 32;
  // t_len: the queries' length (tq); self-attention's keys too
  const int tq = t_len, tk = OFF ? mask.tk() : t_len;
  const size_t qbase = (size_t)bh * t_len * D;
  const size_t kbase = OFF ? (size_t)bh * tk * D : qbase;
  const int n_k = (tk + BN - 1) / BN;
  const int lo = mask.key_tile_lo(q0, BN);
  const int hi = mask.key_tile_hi(q0, TC_ROWS, BN, n_k);

  cp_tile<TC_ROWS, D>(qs, q + qbase, q0, tq);
  cp_tile<TC_ROWS, D>(dos, dout + qbase, q0, tq);
  cp_tile<BN, D>(ks, k + kbase, lo * BN, tk);
  cp_tile<BN, D>(vs, v + kbase, lo * BN, tk);
  cp_async_commit();
  row_stats<D>(dout + qbase, o + qbase, lse + (size_t)bh * tq,
               delta + (size_t)bh * tq, lse_s, dl_s, q0, tq);

  float acc[D / 8][4] = {};
  for (int ik = lo; ik <= hi; ++ik) {
    const int buf = (ik - lo) & 1, k0 = ik * BN;
    cp_async_wait_all();
    __syncthreads();   // tile ik landed; everyone is done with tile ik - 1
    if (ik < hi) {
      cp_tile<BN, D>(ks + (buf ^ 1) * BN * S, k + kbase, k0 + BN, tk);
      cp_tile<BN, D>(vs + (buf ^ 1) * BN * S, v + kbase, k0 + BN, tk);
    }
    cp_async_commit();
    const float* kt = ks + buf * BN * S;
    float s[BN / 8][4] = {}, dp[BN / 8][4] = {};
    mma3_abt<D, BN>(s, qs + w * 16 * S, kt);                  // S = Q K^T
    mma3_abt<D, BN>(dp, dos + w * 16 * S, vs + buf * BN * S); // dP = dO V^T
    grad_tile<BN, false>(s, dp, q0 + w * 16, k0, lse_s + w * 16,
                         dl_s + w * 16, mask.partial(q0, TC_ROWS, k0, BN),
                         mask, scale, cap);
    mma3_px<D, BN, D>(acc, s, kt);                            // dQ += dS K
  }
  store_strip<D, D>(dq + qbase, acc, q0 + w * 16, tq, scale);
}

template <int D>
constexpr int dkdv_f32_smem_bytes() {
  return (2 * TC_ROWS + 4 * bwd_f32_cols<D>()) * (D + 4) * 4 +
         4 * bwd_f32_cols<D>() * 4;
}

// Grid (BH, key tiles, D / dkdv_f32_cols): as flash_bwd_dkdv_tc.
template <int D, bool OFF>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int t_len,
               Mask<OFF> mask, float scale, float cap) {
  constexpr int BN = bwd_f32_cols<D>(), S = D + 4;
  constexpr int DC = dkdv_f32_cols<D>();
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [TC_ROWS][S]
  float* vs = ks + TC_ROWS * S;        // [TC_ROWS][S]
  float* qs = vs + TC_ROWS * S;        // [2][BN][S]: the Q ring
  float* dos = qs + 2 * BN * S;        // [2][BN][S]: the dO ring
  float* lse_s = dos + 2 * BN * S;     // [2][BN]
  float* dl_s = lse_s + 2 * BN;        // [2][BN]
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * TC_ROWS;        // causal: low keys are heaviest
  const int c0 = blockIdx.z * DC;
  const int w = threadIdx.x / 32;
  // t_len: the queries' length (tq); self-attention's keys too
  const int tq = t_len, tk = OFF ? mask.tk() : t_len;
  const size_t qbase = (size_t)bh * t_len * D;
  const size_t kbase = OFF ? (size_t)bh * tk * D : qbase;
  const float* lse_bh = lse + (size_t)bh * tq;
  const float* dl_bh = delta + (size_t)bh * tq;
  const int n_q = (tq + BN - 1) / BN;
  const int lo = mask.query_tile_lo(k0, BN);
  const int hi = mask.query_tile_hi(k0, TC_ROWS, BN, n_q);
  // query tile iq into ring slot `buf`, as flash_bwd_dkdv_tc's
  auto load = [&](int iq, int buf) {
    const int q0 = iq * BN;
    cp_tile<BN, D>(qs + buf * BN * S, q + qbase, q0, tq);
    cp_tile<BN, D>(dos + buf * BN * S, dout + qbase, q0, tq);
    for (int idx = threadIdx.x; idx < 2 * BN; idx += TC_NT) {
      const int r = idx % BN, row = q0 + r;
      const bool in = row < tq;
      cp_async4((idx < BN ? lse_s : dl_s) + buf * BN + r,
                (idx < BN ? lse_bh : dl_bh) + (in ? row : 0), in);
    }
  };

  cp_tile<TC_ROWS, D>(ks, k + kbase, k0, tk);
  cp_tile<TC_ROWS, D>(vs, v + kbase, k0, tk);
  load(lo, 0);
  cp_async_commit();
  float acc_k[DC / 8][4] = {}, acc_v[DC / 8][4] = {};
  for (int iq = lo; iq <= hi; ++iq) {
    const int buf = (iq - lo) & 1, q0 = iq * BN;
    cp_async_wait_all();
    __syncthreads();   // tile iq landed; everyone is done with tile iq - 1
    if (iq < hi) load(iq + 1, buf ^ 1);
    cp_async_commit();
    const float* qt = qs + buf * BN * S;
    const float* dot_ = dos + buf * BN * S;
    // transposed scores: rows keys k0 + w * 16 + ..., columns queries
    float st[BN / 8][4] = {}, dpt[BN / 8][4] = {};
    mma3_abt<D, BN>(st, ks + w * 16 * S, qt);          // S^T = K Q^T
    mma3_abt<D, BN>(dpt, vs + w * 16 * S, dot_);       // dP^T = V dO^T
    grad_tile<BN, true>(st, dpt, q0, k0 + w * 16, lse_s + buf * BN,
                        dl_s + buf * BN, mask.partial(q0, BN, k0, TC_ROWS),
                        mask, scale, cap);
    mma3_px<D, BN, DC>(acc_v, st, dot_ + c0);           // dV += P^T dO
    mma3_px<D, BN, DC>(acc_k, dpt, qt + c0);            // dK += dS^T Q
  }
  store_strip<D, DC>(dk + kbase + c0, acc_k, k0 + w * 16, tk, scale);
  store_strip<D, DC>(dv + kbase + c0, acc_v, k0 + w * 16, tk, 1.f);
}

// Opt the kernel into more than 48 KB of dynamic shared memory (once per
// kernel instantiation: each instantiation of launch has its own `ready`)
// and launch it: NT threads a block, one block per (head, ROWS of its
// `rows` resident rows, column slice of SPLIT).
template <auto Kernel, int NT, int ROWS, int SPLIT = 1, typename... Args>
int launch(int bytes, int bh, int rows, cudaStream_t stream, Args... args) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid(bh, (rows + ROWS - 1) / ROWS, SPLIT);
  Kernel<<<grid, NT, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

constexpr int UNSUPPORTED = -1;
constexpr int WRONG_ROUTE = -2;

// This file builds two libraries (kernels/build.py, one nvcc each, started
// together): its own holds self-attention (OFF false, flash_attention_*);
// csrc/flash_attention_offset.cu defines FLASH_OFFSET_ROUTE and includes
// this file, and its library holds the causal-offset route (OFF true,
// flash_attention_offset_*). Each compiles one instantiation of each
// kernel, so the two builds take the time one took before the route.
#ifndef FLASH_OFFSET_ROUTE
#define FLASH_OFFSET_ROUTE 0
#endif
constexpr bool OFFSET_ROUTE = FLASH_OFFSET_ROUTE;

template <bool OFF>
Mask<OFF> make_mask(int tq, int tk, int q_off, int causal, int window);
template <>
Mask<true> make_mask<true>(int tq, int tk, int q_off, int causal,
                           int window) {
  return {{tq, tk, q_off, causal, window}};
}
template <>
Mask<false> make_mask<false>(int tq, int, int, int causal, int window) {
  return {{tq, causal, window}};
}

}  // namespace

#if FLASH_OFFSET_ROUTE
#define FLASH_FN(name) flash_attention_offset_##name
#else
#define FLASH_FN(name) flash_attention_##name
#endif

// C interface, loaded with ctypes. Pointers are device pointers of
// contiguous tensors: q, o, dout and dq [BH, tq, D], k, v, dk and dv [BH,
// tk, D], lse and delta [BH, tq] fp32; query i sits at position q_off + i
// (self-attention: tq = tk, q_off = 0; a sequence-parallel rank's chunk
// against its key prefix: tk = q_off + tq). `bf16` selects
// bfloat16 over float32, and with it the tensor-core kernels; `d` selects
// the instantiation and `scale` is the score scale, the caller's true
// head dim ** -0.5 (the wrapper zero-pads other head dims up to an
// instantiated one). Each returns the launch's cudaError_t, -1 for a
// head dim without an instantiation, or -2 for an offset call to the
// self-attention library.
extern "C" {

int FLASH_FN(fwd)(const void* q, const void* k, const void* v, void* o,
                  float* lse, int bh, int tq, int tk, int q_off, int d,
                  int bf16, int causal, int window, float cap, float scale,
                  void* stream) {
  if (!OFFSET_ROUTE && (q_off != 0 || tk != tq)) return WRONG_ROUTE;
  const auto mask = make_mask<OFFSET_ROUTE>(tq, tk, q_off, causal, window);
  cudaStream_t st = (cudaStream_t)stream;
#define FWD(T, D)                                                           \
  return launch<flash_fwd<D, OFFSET_ROUTE>, TC_NT, TC_ROWS>(                \
      fwd_f32_smem_bytes<D>(), bh, tq, st, (const T*)q, (const T*)k,        \
      (const T*)v, (T*)o, lse, tq, mask, scale, cap)
#define FWD_TC(T, D)                                                        \
  return launch<flash_fwd_tc<D, OFFSET_ROUTE>, TC_NT, TC_ROWS>(             \
      fwd_tc_smem_bytes<D>(), bh, tq, st, (const T*)q, (const T*)k,         \
      (const T*)v, (T*)o, lse, tq, mask, scale, cap)
// the instantiated head dims (kernels/flash_attention.py HEAD_DIMS)
#define BY_D(M, T)        \
  switch (d) {            \
    case 16: M(T, 16);    \
    case 32: M(T, 32);    \
    case 64: M(T, 64);    \
    case 128: M(T, 128);  \
    case 144: M(T, 144);  \
    case 256: M(T, 256);  \
    default: return UNSUPPORTED; \
  }
  if (bf16) { BY_D(FWD_TC, __nv_bfloat16) } else { BY_D(FWD, float) }
#undef FWD
#undef FWD_TC
}

int FLASH_FN(bwd_dq)(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, void* dq, int bh, int tq, int tk,
                     int q_off, int d, int bf16, int causal, int window,
                     float cap, float scale, void* stream) {
  if (!OFFSET_ROUTE && (q_off != 0 || tk != tq)) return WRONG_ROUTE;
  const auto mask = make_mask<OFFSET_ROUTE>(tq, tk, q_off, causal, window);
  cudaStream_t st = (cudaStream_t)stream;
#define DQ(T, D)                                                            \
  return launch<flash_bwd_dq<D, OFFSET_ROUTE>, TC_NT, TC_ROWS>(             \
      dq_f32_smem_bytes<D>(), bh, tq, st, (const T*)q, (const T*)k,         \
      (const T*)v, (const T*)o, (const T*)dout, lse, delta, (T*)dq, tq,     \
      mask, scale, cap)
#define DQ_TC(T, D)                                                         \
  return launch<flash_bwd_dq_tc<D, OFFSET_ROUTE>, TC_NT, TC_ROWS,           \
                D / dq_tc_cols<D>()>(                                       \
      dq_tc_smem_bytes<D>(), bh, tq, st, (const T*)q, (const T*)k,          \
      (const T*)v, (const T*)o, (const T*)dout, lse, delta, (T*)dq, tq,     \
      mask, scale, cap)
  if (bf16) { BY_D(DQ_TC, __nv_bfloat16) } else { BY_D(DQ, float) }
#undef DQ
#undef DQ_TC
}

int FLASH_FN(bwd_dkdv)(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int bh,
                       int tq, int tk, int q_off, int d, int bf16,
                       int causal, int window, float cap, float scale,
                       void* stream) {
  if (!OFFSET_ROUTE && (q_off != 0 || tk != tq)) return WRONG_ROUTE;
  const auto mask = make_mask<OFFSET_ROUTE>(tq, tk, q_off, causal, window);
  cudaStream_t st = (cudaStream_t)stream;
#define DKDV(T, D)                                                            \
  return launch<flash_bwd_dkdv<D, OFFSET_ROUTE>, TC_NT, TC_ROWS,              \
                D / dkdv_f32_cols<D>()>(                                      \
      dkdv_f32_smem_bytes<D>(), bh, tk, st, (const T*)q, (const T*)k,         \
      (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, tq, mask,      \
      scale, cap)
#define DKDV_TC(T, D)                                                         \
  return launch<flash_bwd_dkdv_tc<D, OFFSET_ROUTE>, TC_NT, TC_ROWS,           \
                D / dkdv_tc_cols<D>()>(                                       \
      dkdv_tc_smem_bytes<D>(), bh, tk, st, (const T*)q, (const T*)k,          \
      (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, tq, mask,      \
      scale, cap)
  if (bf16) { BY_D(DKDV_TC, __nv_bfloat16) } else { BY_D(DKDV, float) }
#undef DKDV
#undef DKDV_TC
#undef BY_D
}

}  // extern "C"
#undef FLASH_FN
