// Flash attention for Hopper (sm_90a): forward and backward, CUDA C++.
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention -> _kernel
// (the pallas_call at :76), which has no backward; the backward here is the
// flash-attention-2 split.
//
// Inputs are [BH, T, D] row-major (fp32 or bf16; the client, batch and head
// axes folded into BH by the wrapper, GQA's KV heads already repeated).
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
// fp32 inputs (flash_fwd, flash_bwd_dq, flash_bwd_dkdv): products as fp32
// FMAs on the CUDA cores from fp32 copies of the tiles in shared memory
// (tensor cores would round fp32 operands to TF32 or bf16): 64-row tiles
// up to D = 128, 32-row tiles above (f32_rows: at 64 rows dq and dkdv would
// pass 227 KB of shared memory at D = 144 and 256), 256 threads as a
// 16 x 16 grid, each thread an R x R register micro-tile of the score tile
// (R = rows / 16) and an R x (D/16) micro-tile of the output, operands read
// as float4 (float2 at R = 2) from shared memory laid out so the inner
// product's index runs along rows.
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
// (kernels/flash_attention.py).
//
// Both designs skip tiles that the causal mask or the window masks
// completely (a skipped tile adds exp(-1e30 - m) = 0 in the reference). A
// partially masked row gives exp(0) junk while its running max is still
// -1e30; the correction exp(-1e30 - m) = 0 of its first allowed key wipes
// it, as in the reference. Ragged T is handled by zero-filled loads and
// masking keys and rows >= T.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int NT = 256;          // threads per block, a 16 x 16 grid
constexpr float NEG_INF = -1e30f;

// rows per tile (queries and keys alike) of the fp32 kernels: 64, or 32
// above D = 128, where 64-row tiles of dq and dkdv pass 227 KB of shared
// memory
template <int D>
__host__ __device__ constexpr int f32_rows() { return D > 128 ? 32 : 64; }
// padded row stride of a [BT][BT] score tile
template <int BT>
__host__ __device__ constexpr int pt() { return BT + 4; }

// N consecutive floats from shared memory (16-byte aligned for N % 4 == 0,
// 8-byte for N % 2 == 0).
template <int N>
__device__ __forceinline__ void lds(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + i);
      dst[i] = t.x; dst[i + 1] = t.y; dst[i + 2] = t.z; dst[i + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 t = *reinterpret_cast<const float2*>(src + i);
      dst[i] = t.x; dst[i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

// R consecutive floats into shared memory (as lds aligns them).
template <int R>
__device__ __forceinline__ void sts(float* dst, const float (&v)[R]) {
  if constexpr (R == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(R == 2, "micro-tiles are 4 or 2 wide");
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  }
}

// Rows [row0, row0 + BT) of a [T, D] matrix into shared memory as fp32:
// row-major with stride D + 4 (`rm`) and/or transposed [D][BT] (`tr`).
// One 16-byte global load per thread and step; consecutive threads take
// consecutive rows, so the transposed stores hit consecutive banks. Rows
// >= T are zero.
template <int D, int BT>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int row0, int t_len, float* rm,
                                          float* tr) {
  constexpr int VEC = 4;
  constexpr int GROUPS = D / VEC;
  for (int idx = threadIdx.x; idx < BT * GROUPS; idx += NT) {
    const int r = idx % BT, g = idx / BT, row = row0 + r;
    float vals[VEC];
    if (row < t_len) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (size_t)row * D + g * VEC);
      const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) vals[j] = e[j];
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) vals[j] = 0.f;
    }
    if (rm) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) rm[r * (D + 4) + g * VEC + j] = vals[j];
    }
    if (tr) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) tr[(g * VEC + j) * BT + r] = vals[j];
    }
  }
}

// acc[i][j] += sum_k A[k][ra + i] * B[k][cb + j] over k < K, with A and B
// stored k-major ([K][BT], the transposed tiles): an R x R micro-tile.
template <int K, int BT, int R>
__device__ __forceinline__ void mm_kmajor(float (&acc)[R][R], const float* a,
                                          const float* b, int ra, int cb) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float av[R], bv[R];
    lds(av, a + k * BT + ra);
    lds(bv, b + k * BT + cb);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// acc[i][j] += sum_k P[ra + i][k] * X[k][cb + j] over the BT keys k: P a
// [BT][BT + 4] row-major score tile, X a [BT][D + 4] row-major value tile.
template <int D, int DC, int BT, int R>
__device__ __forceinline__ void mm_rows(float (&acc)[R][DC], const float* p,
                                        const float* x, int ra, int cb) {
#pragma unroll 2
  for (int k = 0; k < BT; k += 4) {
    float pv[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) lds(pv[i], p + (ra + i) * pt<BT>() + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float xv[DC];
      lds(xv, x + (k + kk) * (D + 4) + cb);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] += pv[i][kk] * xv[j];
    }
  }
}

// Sum / max over the 16 threads of a half warp that share a row group.
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

struct Mask {
  int t_len, causal, window;
  __device__ __forceinline__ bool allow(int q, int k) const {
    return q < t_len && k < t_len && (!causal || q >= k) &&
           (window <= 0 || q - k < window);
  }
  // For a block of `rows` resident rows and loop tiles of `bn` (n of
  // them): the key tiles that queries [q0, q0 + rows) see, and the query
  // tiles that keys [k0, k0 + rows) are seen by, as [lo, hi].
  __device__ __forceinline__ int key_tile_lo(int q0, int bn) const {
    return window > 0 ? max(0, q0 - window + 1) / bn : 0;
  }
  __device__ __forceinline__ int key_tile_hi(int q0, int rows, int bn,
                                             int n) const {
    return causal ? min(n - 1, (q0 + rows - 1) / bn) : n - 1;
  }
  __device__ __forceinline__ int query_tile_lo(int k0, int bn) const {
    return causal ? k0 / bn : 0;
  }
  __device__ __forceinline__ int query_tile_hi(int k0, int rows, int bn,
                                               int n) const {
    return window > 0 ? min(n - 1, (k0 + rows - 1 + window - 1) / bn)
                      : n - 1;
  }
  // whether some pair of queries [q0, q0 + nq) and keys [k0, k0 + nk) is
  // masked (else the tile needs no per-element test)
  __device__ __forceinline__ bool partial(int q0, int nq, int k0,
                                          int nk) const {
    return q0 + nq > t_len || k0 + nk > t_len ||
           (causal && q0 < k0 + nk - 1) ||
           (window > 0 && q0 + nq - 1 - k0 >= window);
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

template <int D>
constexpr int fwd_smem_floats() {
  constexpr int BT = f32_rows<D>();
  return 2 * D * BT + BT * (D + 4) + BT * pt<BT>();
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int t_len, Mask mask, float scale,
          float cap) {
  constexpr int BT = f32_rows<D>(), R = BT / 16, PT = pt<BT>(), DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // [D][BT]
  float* kt = qt + D * BT;          // [D][BT]
  float* vs = kt + D * BT;          // [BT][D + 4]
  float* ps = vs + BT * (D + 4);    // [BT][PT]: probabilities p[q][k]
  const int bh = blockIdx.x;
  const int n_tiles = gridDim.y;
  const int iq = n_tiles - 1 - blockIdx.y;   // the heaviest tiles first
  const int q0 = iq * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ra = ty * R, cb = tx * R;
  const size_t base = (size_t)bh * t_len * D;

  load_tile<D, BT>(q + base, q0, t_len, nullptr, qt);
  float m_i[R], l_i[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }
  const int lo = mask.key_tile_lo(q0, BT);
  const int hi = mask.key_tile_hi(q0, BT, BT, n_tiles);
  for (int ik = lo; ik <= hi; ++ik) {
    const int k0 = ik * BT;
    __syncthreads();
    load_tile<D, BT>(k + base, k0, t_len, nullptr, kt);
    load_tile<D, BT>(v + base, k0, t_len, vs, nullptr);
    __syncthreads();
    float s[R][R] = {};
    mm_kmajor<D, BT>(s, qt, kt, ra, cb);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float th, mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float x = score(s[i][j], scale, cap, &th);
        s[i][j] = mask.allow(q0 + ra + i, k0 + cb + j) ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max(mx));
      const float corr = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l_i[i] = l_i[i] * corr + row_sum(rs);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
      sts(ps + (ra + i) * PT + cb, s[i]);
    }
    __syncthreads();
    mm_rows<D, DC, BT>(acc, ps, vs, ra, tx * DC);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ra + i;
    if (r >= t_len) continue;
    const float den = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      o[base + (size_t)r * D + tx * DC + j] = acc[i][j] / den;
    if (tx == 0) lse[(size_t)bh * t_len + r] = m_i[i] + logf(l_i[i]);
  }
}

template <int D>
constexpr int dq_smem_floats() {
  constexpr int BT = f32_rows<D>();
  return 4 * D * BT + BT * (D + 4) + BT * pt<BT>() + 2 * BT;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ o,
             const float* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ delta, float* __restrict__ dq, int t_len,
             Mask mask, float scale, float cap) {
  constexpr int BT = f32_rows<D>(), R = BT / 16, PT = pt<BT>(), DC = D / 16;
  constexpr int TPR = NT / BT;       // threads to a row of delta
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                  // [D][BT]
  float* dot_ = qt + D * BT;         // [D][BT]  dO transposed
  float* kt = dot_ + D * BT;         // [D][BT]
  float* vt = kt + D * BT;           // [D][BT]
  float* ks = vt + D * BT;           // [BT][D + 4]
  float* ds = ks + BT * (D + 4);     // [BT][PT]: dS[q][k]
  float* lse_s = ds + BT * PT;       // [BT]
  float* dl_s = lse_s + BT;          // [BT]
  const int bh = blockIdx.x;
  const int n_tiles = gridDim.y;
  const int iq = n_tiles - 1 - blockIdx.y;
  const int q0 = iq * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ra = ty * R, cb = tx * R;
  const size_t base = (size_t)bh * t_len * D;

  load_tile<D, BT>(q + base, q0, t_len, nullptr, qt);
  load_tile<D, BT>(dout + base, q0, t_len, nullptr, dot_);
  {  // delta = rowsum(dO * O): TPR threads per row
    const int r = threadIdx.x / TPR, part = threadIdx.x % TPR, row = q0 + r;
    float acc = 0.f;
    if (row < t_len) {
      for (int d = part * (D / TPR); d < (part + 1) * (D / TPR); ++d)
        acc += dout[base + (size_t)row * D + d] *
               o[base + (size_t)row * D + d];
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (part == 0) {
      dl_s[r] = acc;
      lse_s[r] = row < t_len ? lse[(size_t)bh * t_len + row] : 0.f;
      if (row < t_len) delta[(size_t)bh * t_len + row] = acc;
    }
  }
  float acc[R][DC] = {};
  const int lo = mask.key_tile_lo(q0, BT);
  const int hi = mask.key_tile_hi(q0, BT, BT, n_tiles);
  for (int ik = lo; ik <= hi; ++ik) {
    const int k0 = ik * BT;
    __syncthreads();
    load_tile<D, BT>(k + base, k0, t_len, ks, kt);
    load_tile<D, BT>(v + base, k0, t_len, nullptr, vt);
    __syncthreads();
    float s[R][R] = {}, dp[R][R] = {};
    mm_kmajor<D, BT>(s, qt, kt, ra, cb);
    mm_kmajor<D, BT>(dp, dot_, vt, ra, cb);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ra + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float th;
        const float x = score(s[i][j], scale, cap, &th);
        float g = 0.f;
        if (mask.allow(q0 + r, k0 + cb + j)) {
          g = expf(x - lse_s[r]) * (dp[i][j] - dl_s[r]);
          if (cap > 0.f) g *= 1.f - th * th;
        }
        s[i][j] = g;
      }
      sts(ds + r * PT + cb, s[i]);
    }
    __syncthreads();
    mm_rows<D, DC, BT>(acc, ds, ks, ra, tx * DC);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ra + i;
    if (r >= t_len) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dq[base + (size_t)r * D + tx * DC + j] = acc[i][j] * scale;
  }
}

template <int D>
constexpr int dkdv_smem_floats() {
  constexpr int BT = f32_rows<D>();
  return 4 * D * BT + 2 * BT * (D + 4) + BT * pt<BT>() + 2 * BT;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int t_len,
               Mask mask, float scale, float cap) {
  constexpr int BT = f32_rows<D>(), R = BT / 16, PT = pt<BT>(), DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                  // [D][BT]
  float* vt = kt + D * BT;           // [D][BT]
  float* qt = vt + D * BT;           // [D][BT]
  float* dot_ = qt + D * BT;         // [D][BT]  dO transposed
  float* qs = dot_ + D * BT;         // [BT][D + 4]
  float* dos = qs + BT * (D + 4);    // [BT][D + 4]
  float* pt_ = dos + BT * (D + 4);   // [BT][PT]: P^T, then dS^T ([k][q])
  float* lse_s = pt_ + BT * PT;      // [BT]
  float* dl_s = lse_s + BT;          // [BT]
  const int bh = blockIdx.x;
  const int n_tiles = gridDim.y;
  const int ik = blockIdx.y;          // causal: low key tiles are heaviest
  const int k0 = ik * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ra = ty * R, cb = tx * R;   // ra: key rows, cb: query columns
  const size_t base = (size_t)bh * t_len * D;

  load_tile<D, BT>(k + base, k0, t_len, nullptr, kt);
  load_tile<D, BT>(v + base, k0, t_len, nullptr, vt);
  float acc_k[R][DC] = {}, acc_v[R][DC] = {};
  const int lo = mask.query_tile_lo(k0, BT);
  const int hi = mask.query_tile_hi(k0, BT, BT, n_tiles);
  for (int iq = lo; iq <= hi; ++iq) {
    const int q0 = iq * BT;
    __syncthreads();
    load_tile<D, BT>(q + base, q0, t_len, qs, qt);
    load_tile<D, BT>(dout + base, q0, t_len, dos, dot_);
    if (threadIdx.x < BT) {
      const int row = q0 + threadIdx.x;
      const bool in = row < t_len;
      lse_s[threadIdx.x] = in ? lse[(size_t)bh * t_len + row] : 0.f;
      dl_s[threadIdx.x] = in ? delta[(size_t)bh * t_len + row] : 0.f;
    }
    __syncthreads();
    // transposed scores: st[i][j] for key ra + i, query cb + j
    float st[R][R] = {}, dpt[R][R] = {};
    mm_kmajor<D, BT>(st, kt, qt, ra, cb);
    mm_kmajor<D, BT>(dpt, vt, dot_, ra, cb);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = cb + j;
        float th, p = 0.f, g = 0.f;
        const float x = score(st[i][j], scale, cap, &th);
        if (mask.allow(q0 + c, k0 + ra + i)) {
          p = expf(x - lse_s[c]);
          g = p * (dpt[i][j] - dl_s[c]);
          if (cap > 0.f) g *= 1.f - th * th;
        }
        st[i][j] = p;
        dpt[i][j] = g;
      }
      sts(pt_ + (ra + i) * PT + cb, st[i]);
    }
    __syncthreads();
    mm_rows<D, DC, BT>(acc_v, pt_, dos, ra, tx * DC);   // dV += P^T dO
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; ++i) sts(pt_ + (ra + i) * PT + cb, dpt[i]);
    __syncthreads();
    mm_rows<D, DC, BT>(acc_k, pt_, qs, ra, tx * DC);    // dK += dS^T Q
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = k0 + ra + i;
    if (r >= t_len) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      dk[base + (size_t)r * D + tx * DC + j] = acc_k[i][j] * scale;
      dv[base + (size_t)r * D + tx * DC + j] = acc_v[i][j];
    }
  }
}

// ---- bf16 on the tensor cores ----

typedef __nv_bfloat16 bf16;
constexpr int TC_NT = 128;       // 4 warps
constexpr int TC_ROWS = 64;      // resident rows of a block, 16 a warp

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

// Rows [row0, row0 + ROWS) of a [T, D] bf16 matrix into a [ROWS][D + 8]
// tile by cp.async, 16 bytes a copy, consecutive threads along a row; rows
// >= T are zero.
template <int ROWS, int D>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, int row0,
                                        int t_len) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += TC_NT) {
    const int r = idx / CH, c = idx % CH, row = row0 + r;
    const bool in = row < t_len;
    cp_async16(dst + r * tc_stride<D>() + c * 8,
               src + (size_t)(in ? row : 0) * D + c * 8, in);
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
// of a [T, D] bf16 matrix (`out` at the strip's first column; rows >= T
// dropped).
template <int D, int DC>
__device__ __forceinline__ void store_strip(bf16* out,
                                            const float (&acc)[DC / 8][4],
                                            int row0, int t_len, float mul) {
  const int l = threadIdx.x % 32, g = l / 4, t4 = l % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= t_len) continue;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + (size_t)row * D + j * 8 + 2 * t4) =
          pack_bf16x2(acc[j][2 * h] * mul, acc[j][2 * h + 1] * mul);
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

template <int D>
__global__ void __launch_bounds__(TC_NT)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, int t_len, Mask mask, float scale,
             float cap) {
  constexpr int BN = fwd_tc_cols<D>(), S = tc_stride<D>();
  extern __shared__ __align__(16) float smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [TC_ROWS][S]
  bf16* ks = qs + TC_ROWS * S;                // [2][BN][S]: the K ring
  bf16* vs = ks + 2 * BN * S;                 // [2][BN][S]: the V ring
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;  // heaviest first
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, g = l / 4, t4 = l % 4;
  const size_t base = (size_t)bh * t_len * D;
  const int n_k = (t_len + BN - 1) / BN;
  const int lo = mask.key_tile_lo(q0, BN);
  const int hi = mask.key_tile_hi(q0, TC_ROWS, BN, n_k);

  cp_tile<TC_ROWS, D>(qs, q + base, q0, t_len);
  cp_tile<BN, D>(ks, k + base, lo * BN, t_len);
  cp_tile<BN, D>(vs, v + base, lo * BN, t_len);
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
      cp_tile<BN, D>(ks + (buf ^ 1) * BN * S, k + base, k0 + BN, t_len);
      cp_tile<BN, D>(vs + (buf ^ 1) * BN * S, v + base, k0 + BN, t_len);
    }
    cp_async_commit();
    float s[BN / 8][4] = {};
    if constexpr (fwd_q_in_regs<D>()) {
      if (ik == lo) ldsm_a<D>(qf, qs + w * 16 * S);
      mma_abt<D, BN>(s, qf, ks + buf * BN * S);     // S = Q K^T
    } else {
      mma_abt<D, BN>(s, qs + w * 16 * S, ks + buf * BN * S);
    }
    const bool edge = mask.partial(q0, TC_ROWS, k0, BN);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + w * 16 + g + 8 * (i / 2);
        const int c = k0 + j * 8 + 2 * t4 + i % 2;
        float th;
        const float x = score(s[j][i], scale, cap, &th);
        s[j][i] = !edge || mask.allow(r, c) ? x : NEG_INF;
        mx[i / 2] = fmaxf(mx[i / 2], s[j][i]);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
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
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] *= corr[i / 2];
    }
    uint32_t pf[BN / 16][4];
    to_a_frags<BN>(pf, s);
    mma_px<D, BN, D>(acc, pf, vs + buf * BN * S);   // O += P V
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] /= fmaxf(l_r[i / 2], 1e-30f);
  }
  store_strip<D, D>(o + base, acc, q0 + w * 16, t_len, 1.f);
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + w * 16 + g + 8 * h;
      if (row < t_len) lse[(size_t)bh * t_len + row] = m_r[h] + logf(l_r[h]);
    }
  }
}

template <int D>
constexpr int dq_tc_smem_bytes() {
  return (2 * TC_ROWS + 4 * tc_cols<D>()) * tc_stride<D>() * 2 +
         2 * TC_ROWS * 4;
}

// Grid (BH, row tiles, D / dq_tc_cols): block z accumulates dQ's columns
// [z DC, (z + 1) DC); every block computes the full S and dP, and block
// z = 0 writes delta.
template <int D>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ o,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ delta, bf16* __restrict__ dq, int t_len,
                Mask mask, float scale, float cap) {
  constexpr int BN = tc_cols<D>(), S = tc_stride<D>(), CH = D / 8;
  constexpr int DC = dq_tc_cols<D>();
  // delta's lanes to a row: CH where that is a power of two (one 16-byte
  // load each), else 2, each looping over its row's 16-byte chunks
  constexpr int LPR = (CH & (CH - 1)) == 0 && CH <= 32 ? CH : 2;
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
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, g = l / 4, t4 = l % 4;
  const size_t base = (size_t)bh * t_len * D;
  const int n_k = (t_len + BN - 1) / BN;
  const int lo = mask.key_tile_lo(q0, BN);
  const int hi = mask.key_tile_hi(q0, TC_ROWS, BN, n_k);

  cp_tile<TC_ROWS, D>(qs, q + base, q0, t_len);
  cp_tile<TC_ROWS, D>(dos, dout + base, q0, t_len);
  cp_tile<BN, D>(ks, k + base, lo * BN, t_len);
  cp_tile<BN, D>(vs, v + base, lo * BN, t_len);
  cp_async_commit();
  // delta = rowsum(dO * O): 16-byte loads, the LPR lanes of a row reduce
  // by shuffles (every thread takes part in every step)
  for (int idx = threadIdx.x; idx < TC_ROWS * LPR; idx += TC_NT) {
    const int r = idx / LPR, part = idx % LPR, row = q0 + r;
    float acc = 0.f;
    if (row < t_len) {
      for (int c = part; c < CH; c += LPR) {
        const uint4 a = *reinterpret_cast<const uint4*>(
            dout + base + (size_t)row * D + c * 8);
        const uint4 b = *reinterpret_cast<const uint4*>(
            o + base + (size_t)row * D + c * 8);
        const bf16* ea = reinterpret_cast<const bf16*>(&a);
        const bf16* eb = reinterpret_cast<const bf16*>(&b);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc += __bfloat162float(ea[j]) * __bfloat162float(eb[j]);
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (part == 0) {
      dl_s[r] = acc;
      lse_s[r] = row < t_len ? lse[(size_t)bh * t_len + row] : 0.f;
      if (row < t_len && blockIdx.z == 0)
        delta[(size_t)bh * t_len + row] = acc;
    }
  }

  float acc[DC / 8][4] = {};
  for (int ik = lo; ik <= hi; ++ik) {
    const int buf = (ik - lo) & 1, k0 = ik * BN;
    cp_async_wait_all();
    __syncthreads();   // tile ik landed; everyone is done with tile ik - 1
    if (ik < hi) {
      cp_tile<BN, D>(ks + (buf ^ 1) * BN * S, k + base, k0 + BN, t_len);
      cp_tile<BN, D>(vs + (buf ^ 1) * BN * S, v + base, k0 + BN, t_len);
    }
    cp_async_commit();
    const bf16* kt = ks + buf * BN * S;
    float s[BN / 8][4] = {}, dp[BN / 8][4] = {};
    mma_abt<D, BN>(s, qs + w * 16 * S, kt);         // S = Q K^T
    mma_abt<D, BN>(dp, dos + w * 16 * S, vs + buf * BN * S);  // dP = dO V^T
    const bool edge = mask.partial(q0, TC_ROWS, k0, BN);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = w * 16 + g + 8 * (i / 2);
        const int c = k0 + j * 8 + 2 * t4 + i % 2;
        float th, gr = 0.f;
        const float x = score(s[j][i], scale, cap, &th);
        if (!edge || mask.allow(q0 + r, c)) {
          gr = __expf(x - lse_s[r]) * (dp[j][i] - dl_s[r]);
          if (cap > 0.f) gr *= 1.f - th * th;
        }
        s[j][i] = gr;
      }
    }
    uint32_t df[BN / 16][4];
    to_a_frags<BN>(df, s);
    mma_px<D, BN, DC>(acc, df, kt + c0);            // dQ += dS K
  }
  store_strip<D, DC>(dq + base + c0, acc, q0 + w * 16, t_len, scale);
}

template <int D>
constexpr int dkdv_tc_smem_bytes() {
  return (2 * TC_ROWS + 4 * tc_cols<D>()) * tc_stride<D>() * 2 +
         4 * tc_cols<D>() * 4;
}

// Grid (BH, key tiles, D / dkdv_tc_cols): block z accumulates dK's and
// dV's columns [z DC, (z + 1) DC); every block computes the full S^T and
// dP^T.
template <int D>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int t_len, Mask mask, float scale,
                  float cap) {
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
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, g = l / 4, t4 = l % 4;
  const size_t base = (size_t)bh * t_len * D;
  const float* lse_bh = lse + (size_t)bh * t_len;
  const float* dl_bh = delta + (size_t)bh * t_len;
  const int n_q = (t_len + BN - 1) / BN;
  const int lo = mask.query_tile_lo(k0, BN);
  const int hi = mask.query_tile_hi(k0, TC_ROWS, BN, n_q);
  // query tile iq into ring slot `buf`: Q, dO, and lse and delta (4 bytes a
  // copy: a row offset need not be 16-byte aligned)
  auto load = [&](int iq, int buf) {
    const int q0 = iq * BN;
    cp_tile<BN, D>(qs + buf * BN * S, q + base, q0, t_len);
    cp_tile<BN, D>(dos + buf * BN * S, dout + base, q0, t_len);
    for (int idx = threadIdx.x; idx < 2 * BN; idx += TC_NT) {
      const int r = idx % BN, row = q0 + r;
      const bool in = row < t_len;
      cp_async4((idx < BN ? lse_s : dl_s) + buf * BN + r,
                (idx < BN ? lse_bh : dl_bh) + (in ? row : 0), in);
    }
  };

  cp_tile<TC_ROWS, D>(ks, k + base, k0, t_len);
  cp_tile<TC_ROWS, D>(vs, v + base, k0, t_len);
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
    const float* lse_t = lse_s + buf * BN;
    const float* dl_t = dl_s + buf * BN;
    // transposed scores: rows keys k0 + w * 16 + ..., columns queries
    float st[BN / 8][4] = {}, dpt[BN / 8][4] = {};
    mma_abt<D, BN>(st, ks + w * 16 * S, qt);         // S^T = K Q^T
    mma_abt<D, BN>(dpt, vs + w * 16 * S, dot_);      // dP^T = V dO^T
    const bool edge = mask.partial(q0, BN, k0, TC_ROWS);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = k0 + w * 16 + g + 8 * (i / 2);
        const int c = j * 8 + 2 * t4 + i % 2;
        float th, p = 0.f, gr = 0.f;
        const float x = score(st[j][i], scale, cap, &th);
        if (!edge || mask.allow(q0 + c, r)) {
          p = __expf(x - lse_t[c]);
          gr = p * (dpt[j][i] - dl_t[c]);
          if (cap > 0.f) gr *= 1.f - th * th;
        }
        st[j][i] = p;
        dpt[j][i] = gr;
      }
    }
    uint32_t f[BN / 16][4];
    to_a_frags<BN>(f, st);
    mma_px<D, BN, DC>(acc_v, f, dot_ + c0);         // dV += P^T dO
    to_a_frags<BN>(f, dpt);
    mma_px<D, BN, DC>(acc_k, f, qt + c0);           // dK += dS^T Q
  }
  store_strip<D, DC>(dk + base + c0, acc_k, k0 + w * 16, t_len, scale);
  store_strip<D, DC>(dv + base + c0, acc_v, k0 + w * 16, t_len, 1.f);
}

// Opt the kernel into more than 48 KB of dynamic shared memory (once per
// kernel instantiation: each instantiation of launch has its own `ready`)
// and launch it: NT threads a block, one block per (head, ROWS rows,
// column slice of SPLIT).
template <auto Kernel, int NT, int ROWS, int SPLIT = 1, typename... Args>
int launch(int bytes, int bh, int t_len, cudaStream_t stream, Args... args) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid(bh, (t_len + ROWS - 1) / ROWS, SPLIT);
  Kernel<<<grid, NT, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

constexpr int F32 = sizeof(float);
constexpr int UNSUPPORTED = -1;

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers of
// contiguous [BH, T, D] tensors (lse and delta [BH, T] fp32); `bf16` selects
// bfloat16 over float32, and with it the tensor-core kernels; `d` selects
// the instantiation and `scale` is the score scale, the caller's true
// head dim ** -0.5 (the wrapper zero-pads other head dims up to an
// instantiated one). Each returns the launch's cudaError_t, or -1 for a
// head dim without an instantiation.
extern "C" {

int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int t_len, int d, int bf16,
                        int causal, int window, float cap, float scale,
                        void* stream) {
  const Mask mask{t_len, causal, window};
  cudaStream_t st = (cudaStream_t)stream;
#define FWD(T, D)                                                          \
  return launch<flash_fwd<D>, NT, f32_rows<D>()>(fwd_smem_floats<D>() * F32, \
                bh, t_len, st,                                             \
                (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, t_len,  \
                mask, scale, cap)
#define FWD_TC(T, D)                                                       \
  return launch<flash_fwd_tc<D>, TC_NT, TC_ROWS>(fwd_tc_smem_bytes<D>(),   \
                bh, t_len, st, (const T*)q, (const T*)k, (const T*)v,      \
                (T*)o, lse, t_len, mask, scale, cap)
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

int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* delta, void* dq, int bh, int t_len, int d,
                           int bf16, int causal, int window, float cap,
                           float scale, void* stream) {
  const Mask mask{t_len, causal, window};
  cudaStream_t st = (cudaStream_t)stream;
#define DQ(T, D)                                                            \
  return launch<flash_bwd_dq<D>, NT, f32_rows<D>()>(                        \
                dq_smem_floats<D>() * F32, bh, t_len, st, (const T*)q,      \
                (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse, \
                delta, (T*)dq, t_len, mask, scale, cap)
#define DQ_TC(T, D)                                                         \
  return launch<flash_bwd_dq_tc<D>, TC_NT, TC_ROWS, D / dq_tc_cols<D>()>(   \
                dq_tc_smem_bytes<D>(), bh, t_len, st, (const T*)q,          \
                (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse, \
                delta, (T*)dq, t_len, mask, scale, cap)
  if (bf16) { BY_D(DQ_TC, __nv_bfloat16) } else { BY_D(DQ, float) }
#undef DQ
#undef DQ_TC
}

int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int bh,
                             int t_len, int d, int bf16, int causal,
                             int window, float cap, float scale,
                             void* stream) {
  const Mask mask{t_len, causal, window};
  cudaStream_t st = (cudaStream_t)stream;
#define DKDV(T, D)                                                            \
  return launch<flash_bwd_dkdv<D>, NT, f32_rows<D>()>(                        \
                dkdv_smem_floats<D>() * F32, bh, t_len, st, (const T*)q,      \
                (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, \
                (T*)dv, t_len, mask, scale, cap)
#define DKDV_TC(T, D)                                                         \
  return launch<flash_bwd_dkdv_tc<D>, TC_NT, TC_ROWS,                         \
                D / dkdv_tc_cols<D>()>(                                       \
                dkdv_tc_smem_bytes<D>(), bh, t_len, st, (const T*)q,          \
                (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, \
                (T*)dv, t_len, mask, scale, cap)
  if (bf16) { BY_D(DKDV_TC, __nv_bfloat16) } else { BY_D(DKDV, float) }
#undef DKDV
#undef DKDV_TC
#undef BY_D
}

}  // extern "C"
