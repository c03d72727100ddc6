// WKV6 backward for Hopper (sm_90a), CUDA C++: the gradients of the chunked
// route's forward (csrc/rwkv6_chunk.cu) from the chunk-start states that the
// forward already wrote to its workspace.
//
// The TPU kernel (src/repro/kernels/rwkv6_chunk.py: _kernel, the pallas_call
// at :73) has no backward; the reference trains RWKV6 by autodiff of its
// jnp chunk scan. This is the VJP of the same function:
//   o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
// Given do [BH, T, D] and dS_T [BH, D, D] (zeros when S_T is unused), it
// returns dr, dk, dv, dw [BH, T, D], du as [BH, n_chunks, D] partials (the
// host sums them: no atomics, so a run repeats bit for bit) and ds0
// [BH, D, D]. All fp32, head dims 64 and 128, any T >= 1.
//
// Per chunk of C = 64 steps (the last may be short; missing steps zero r,
// k, v, do and w = 1), with a = cumsum(log w) over the chunk per channel,
// b_t = a_{t-1} (b_0 = 0), L = a_last, S = S_c (the state entering the
// chunk) and dS' = dS_{c+1} (the gradient reaching its end state),
// P_ts = v_s . do_t and A_ts = sum_d r_t k_s e^{b_t - a_s} (s < t),
// A_tt = r_t . (u * k_t):
//   dr_t = e^{b_t} (S do_t) + sum_{s<t} k_s e^{b_t - a_s} P_ts + u k_t P_tt
//   dk_s = sum_{t>s} r_t e^{b_t - a_s} P_ts + u r_s P_ss
//          + e^{L - a_s} (dS' v_s)
//   dv_s = sum_{t>=s} A_ts do_t + (k_s e^{L - a_s})^T dS'
//   du   = sum_t r_t k_t P_tt
//   dS_c = diag(e^L) dS' + sum_t (r_t e^{b_t})^T do_t
// and the log-decay gradient, which stays inside the chunk:
//   db_t = r_t (dr_t - u k_t P_tt),  da_s = -k_s (dk_s - u r_s P_ss),
//   dL   = e^L rowsum(S . dS') + sum_s k_s e^{L - a_s} (dS' v_s),
//   dlog w_t = sum_{t' >= t} da_t' + sum_{t' > t} db_t' + dL,
//   dw_t = dlog w_t / w_t.
// Every exponent is <= 0 (a does not increase, also as rounded), so nothing
// overflows at strong decay, as in the forward.
//
// Two launches, every product on the tensor cores as 3xTF32 (mma3.cuh:
// fp32-accurate operands, fp32 sums):
// (1) wkv6_bwd_state: the forward's state pass run backwards
//     (wkv6_chunk.cuh: state_pass<D, true>): a block of 4 warps per (batch *
//     head, 32 x 32 tile of dS) walks the chunks from the last, its tile in
//     the mma accumulators. For each chunk it writes dS_{c+1} to the
//     workspace [BH, n_chunks, D, D], then applies the update above as one
//     product over the chunk's 64 steps, with e^{b_t} and e^L as prefix
//     products of w (no logarithm or exponential), while the previous
//     chunk's r, w and do arrive through a two-stage cp.async ring; its last
//     tile is ds0.
// (2) wkv6_bwd_chunk: a block of 8 warps per (chunk, batch * head), all in
//     parallel. Warp w owns row block i = w % 4 (16 steps) and column half
//     h = w / 4 (D / 2 channels) of dr, dk and dv, held in the mma
//     accumulators. It stages r, k, v, do and a (log2 w, then its
//     cumulative sum) as [C][D + 4] tiles, and S_c and dS' pass through in
//     slabs of 16 rows (8 of each column half). The steps:
//     (a) P = do v^T (tiles above the diagonal skipped).
//     (b) For each slab, the warp's n tile of columns d in it:
//         dr <- e^{b_t} (do S^T), dk <- e^{L - a_s} (v dS'^T); the k e^{L - a}
//         share of dL and a quarter of rowsum(S . dS') into per-row-block
//         partials; dv += (k e^{L - a}) dS' over the slab's 16 rows.
//     (c) The pairwise decays, factored as the forward's output pass does:
//         left of the diagonal 16 x 16 block of row block i, about e =
//         16 i - 1, e^{b_t - a_s} = e^{b_t - a_e} e^{a_e - a_s}, both
//         exponents <= 0; so A's part there is one product of r~ (r e^{b -
//         a_e}) and k^ (k e^{a_e - a}), dr's is e^{b_t - a_e} (P k^), and,
//         about the block's last step e = 16 i + 15, dk's part from later
//         steps is e^{a_e - a_s} (P^T r~). The diagonal block's lower-left
//         8 x 8 quarter is one more product of each about e = 16 i + 7. Its
//         two 8 x 8 triangles take one exponential per (t, s, d), computed
//         once by the thread that holds dr[t][d] and shared: dr[t][d] +=
//         P_ts k_s e, dk[s][d] += P_ts r_t e (to the lane holding row s by
//         __shfl_down_sync), A_ts += r_t k_s e (summed over the quad, then
//         over the two column halves in a fixed order).
//     (d) dv += A^T do, with A in v's place.
//     (e) dr, dk (with the bonus terms), du partials, and the decay
//         gradient's terms g_t = r_t db'_t - k_t dk'_t into v's place; the
//         suffix sum of dlog w over the chunk, a segment of steps a thread;
//         dw = (dlog w - db_t) / w.
//     Shared memory 114,176 bytes at D = 64 and 205,312 at D = 128; on an
//     H100 126 and 240 registers, no spill, so two blocks (16 warps) reside
//     on an SM at D = 64. The triangles' loop over dl stays rolled: fully
//     unrolled, its hoisted loads spilled even at 255 registers.
//
// What bounds it on this card: at [4, 40, 4096, 64] the function must read
// r, k, v, w, do (and S_c, written by the forward) and write dr, dk, dv, dw:
// about 1.7 GB with this design's dS workspace, half a millisecond at 3.35
// TB/s. Its tensor-core work, about 3 C^2 D + 3 C D^2 multiply-adds a chunk
// at three tf32 products each (~1e11 flops at [4, 40, 4096, 64]), is about
// 0.2 ms at the 495 TFLOP/s TF32 peak; the exponentials, splits and
// shared-memory loads around the products are not negligible beside it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"
#include "mma3.cuh"
#include "wkv6_chunk.cuh"

namespace {

constexpr int SUB = 16;           // a row block: the rows of a warp
constexpr int CHUNK_NT = 256;     // chunk pass: 8 warps
constexpr int PLD = C + 4;        // row stride of P and A [C][C]
constexpr int SLAB = 16;          // rows of S_c and dS' a slab step stages
static_assert(C == 4 * SUB, "four row blocks of 16 steps");

// The chunk pass's shared memory, in floats: r, k, v (then A [C][PLD],
// then the decay gradient's terms), do and a [C][LD]; P [C][PLD]; a slab of
// S_c and one of dS' [SLAB][LD] (then scratch: the triangles' A partials
// [2][C][8], the du partials [4][D], the segment totals [4][D]); the dL
// partials [4][D]. LD = D + 4 and PLD are 4 (mod 32) floats, so the A-type
// fragment reads X[g][t] hit 32 banks (B-type reads X[t][g] take two ways).
template <int D>
struct Chunk {
  static constexpr int LD = D + 4;
  static constexpr int R_OFF = 0;
  static constexpr int K_OFF = R_OFF + C * LD;
  static constexpr int V_OFF = K_OFF + C * LD;
  static constexpr int DO_OFF = V_OFF + C * LD;
  static constexpr int LOGW_OFF = DO_OFF + C * LD;
  static constexpr int P_OFF = LOGW_OFF + C * LD;
  static constexpr int SL_OFF = P_OFF + C * PLD;
  static constexpr int RED_OFF = SL_OFF + 2 * SLAB * LD;
  static constexpr int FLOATS = RED_OFF + 4 * D;
  // blocks an SM: two at D = 64 (registers capped at 128 a thread)
  static constexpr int MIN_BLOCKS = D == 64 ? 2 : 1;
};
static_assert(2 * C * 8 + 8 * 64 <= 2 * SLAB * (64 + 4),
              "the scratch fits the slabs' place");

// The state pass: ws = dws, dws[c] = dS_{c+1}; ds0 = dS_0.
template <int D>
__global__ void __launch_bounds__(STATE_NT)
wkv6_bwd_state(const float* __restrict__ r, const float* __restrict__ w,
               const float* __restrict__ dout, const float* __restrict__ ds_t,
               float* __restrict__ dws, float* __restrict__ ds0, int t_len) {
  extern __shared__ __align__(16) float smem[];
  state_pass<D, true>(smem, r, dout, w, ds_t, dws, ds0, t_len);
}

// The chunk pass. Block (chunk, batch * head). In a warp's accumulators
// (n tile nt, element e) stand row r0 + g + 8 (e / 2) and column c0 + 8 nt
// + 2 t4 + e % 2 of dr, dk and dv.
template <int D>
__global__ void __launch_bounds__(CHUNK_NT, Chunk<D>::MIN_BLOCKS)
wkv6_bwd_chunk(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ ws,
               const float* __restrict__ dout, const float* __restrict__ dws,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dw,
               float* __restrict__ du_part, int t_len, int heads) {
  using L = Chunk<D>;
  constexpr int LD = L::LD;
  constexpr int NTL = D / 16;        // n tiles of a warp's D / 2 columns
  extern __shared__ __align__(16) float smem[];
  float* rS = smem + L::R_OFF;
  float* kS = smem + L::K_OFF;
  float* vS = smem + L::V_OFF;
  float* doS = smem + L::DO_OFF;
  float* aS = smem + L::LOGW_OFF;    // log2 w, then a (base 2)
  float* pS = smem + L::P_OFF;
  float* sS = smem + L::SL_OFF;      // a slab of S_c [SLAB][LD]
  float* gsS = sS + SLAB * LD;       // and of dS'
  float* red = smem + L::RED_OFF;    // dL partials [4][D]
  float* amS = vS;                   // A [C][PLD], once v is done with
  float* gS = vS;                    // then the decay gradient's terms
  float* tri = sS;                   // then scratch: [2][C][8]
  float* du_red = tri + 2 * C * 8;   // [4][D]
  float* tot = du_red + 4 * D;       // [4][D]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rb = warp % 4, h = warp / 4;
  const int r0 = SUB * rb, c0 = h * (D / 2);
  const int c = blockIdx.x, bh = blockIdx.y;
  const int n_chunks = (t_len + C - 1) / C, t0 = c * C;
  const int n = min(C, t_len - t0);
  const size_t base = (size_t)bh * t_len * D;
  const float* sc = ws + ((size_t)bh * n_chunks + c) * D * D;
  const float* gc = dws + ((size_t)bh * n_chunks + c) * D * D;
  const float* uh = u + (size_t)(bh % heads) * D;
  const float* lastA = aS + (C - 1) * LD;     // L by channel

  // ---- loads: w (for the scan), then r, k, v, do, then slab 0 ----
  auto rows = [&](float* dst, const float* src) {
    for (int e = tid; e < C * (D / 4); e += CHUNK_NT) {
      const int t = e / (D / 4), q4 = e % (D / 4);
      const bool in = t < n;
      cp_async16(dst + t * LD + 4 * q4,
                 src + base + (size_t)(t0 + (in ? t : 0)) * D + 4 * q4, in);
    }
  };
  // slab sg: rows d = 8 sg + [0, 8) of each column half of S_c and dS',
  // slab row 8 h' + x for d = h' D / 2 + 8 sg + x
  auto slab = [&](int sg) {
    for (int e = tid; e < SLAB * (D / 4); e += CHUNK_NT) {
      const int sr = e / (D / 4), q4 = e % (D / 4);
      const int d = (sr / 8) * (D / 2) + 8 * sg + sr % 8;
      cp_async16(sS + sr * LD + 4 * q4, sc + (size_t)d * D + 4 * q4, true);
      cp_async16(gsS + sr * LD + 4 * q4, gc + (size_t)d * D + 4 * q4, true);
    }
  };
  rows(aS, w);
  cp_async_commit();
  rows(rS, r);
  rows(kS, k);
  rows(vS, v);
  rows(doS, dout);
  cp_async_commit();
  slab(0);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();
  log_cumsum<D / 64>(aS, LD, n, 8 * warp, 64, lane);   // 8 warps, D / 8 each
  cp_async_wait<1>();
  __syncthreads();

  // A fragment of rows [m0, m0 + 16) and k [k0, k0 + 8) of X [.][ld]
  auto frag = [&](const float* x, int ld, int m0, int k0, float (&a)[4]) {
    const float* p = x + (m0 + g) * ld + k0 + t4;
    a[0] = p[0];
    a[1] = p[8 * ld];
    a[2] = p[4];
    a[3] = p[8 * ld + 4];
  };
  // ... and of its transpose: A[m][k] = X[k][m]
  auto frag_t = [&](const float* x, int ld, int m0, int k0, float (&a)[4]) {
    const float* p = x + (k0 + t4) * ld + m0 + g;
    a[0] = p[0];
    a[1] = p[8];
    a[2] = p[4 * ld];
    a[3] = p[4 * ld + 8];
  };

  float DR[NTL][4] = {}, DK[NTL][4] = {}, DV[NTL][4] = {};

  // ---- (a) P = do v^T: rows r0 .., columns 32 h .. (4 n tiles) ----
  {
    float acc[4][4] = {};
    for (int kk = 0; kk < D; kk += 8) {
      float a[4];
      frag(doS, LD, r0, kk, a);
      uint32_t ah[4], al[4];
      split4(a, ah, al);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int s = 32 * h + 8 * nt;
        if (s > r0 + 15) break;           // above the diagonal: unused
        mma3(acc[nt], ah, al, vS[(s + g) * LD + kk + t4],
             vS[(s + g) * LD + kk + t4 + 4]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int s = 32 * h + 8 * nt;
      if (s > r0 + 15) break;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(pS + (r0 + g + 8 * hf) * PLD + s +
                                   2 * t4) =
            make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
    }
  }

  // ---- (b) the slabs of S_c and dS' ----
  for (int sg = 0; sg < D / 16; ++sg) {
    cp_async_wait_all();
    __syncthreads();                  // slab sg landed (and P is whole)
    const int d0 = c0 + 8 * sg;       // the warp's n tile sg: columns d0 ..
    const float* sb = sS + (8 * h + g) * LD + t4;   // B: S[d0 + g][j]
    const float* gb = gsS + (8 * h + g) * LD + t4;  // B: dS'[d0 + g][j]
    float y[4] = {}, z[4] = {};
    for (int kk = 0; kk < D; kk += 8) {
      float a[4];
      uint32_t ah[4], al[4];
      frag(doS, LD, r0, kk, a);
      split4(a, ah, al);
      mma3(y, ah, al, sb[kk], sb[kk + 4]);          // do S^T
      frag(vS, LD, r0, kk, a);
      split4(a, ah, al);
      mma3(z, ah, al, gb[kk], gb[kk + 4]);          // v dS'^T
    }
    float dlz[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = r0 + g + 8 * (e / 2), d = d0 + 2 * t4 + e % 2;
      const float bt = t > 0 ? aS[(t - 1) * LD + d] : 0.f;
      y[e] *= ex2(bt);
      z[e] *= ex2(lastA[d] - aS[t * LD + d]);
      dlz[e % 2] += kS[t * LD + d] * z[e];
    }
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)   // constant indices: registers
      if (nt == sg)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          DR[nt][e] = y[e];
          DK[nt][e] = z[e];
        }
    // rowsum(S_c . dS') of rows d0 + g over columns rb D / 4 + t4 + 4 m
    float rs = 0.f;
#pragma unroll
    for (int m = 0; m < D / 16; ++m) {
      const int j = rb * (D / 4) + t4 + 4 * m;
      rs += sb[j - t4] * gb[j - t4];
    }
#pragma unroll
    for (int off = 4; off < 32; off *= 2) {
      dlz[0] += __shfl_xor_sync(FULL, dlz[0], off);
      dlz[1] += __shfl_xor_sync(FULL, dlz[1], off);
    }
    rs += __shfl_xor_sync(FULL, rs, 1);
    rs += __shfl_xor_sync(FULL, rs, 2);
    if (g == 0) {
      red[rb * D + d0 + 2 * t4] = dlz[0];
      red[rb * D + d0 + 2 * t4 + 1] = dlz[1];
    }
    __syncwarp();
    if (t4 == 0) red[rb * D + d0 + g] += ex2(lastA[d0 + g]) * rs;
    // dv += (k e^{L - a}) dS' over the slab's rows: a k step per column half
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const int db = kh * (D / 2) + 8 * sg;
      float a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = r0 + g + 8 * (e % 2), d = db + t4 + 4 * (e / 2);
        a[e] = kS[s * LD + d] * ex2(lastA[d] - aS[s * LD + d]);
      }
      uint32_t ah[4], al[4];
      split4(a, ah, al);
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        const int j = c0 + 8 * nt + g;
        mma3(DV[nt], ah, al, gsS[(8 * kh + t4) * LD + j],
             gsS[(8 * kh + t4 + 4) * LD + j]);
      }
    }
    __syncthreads();                  // everyone is done with slab sg
    if (sg + 1 < D / 16) slab(sg + 1);
    cp_async_commit();
  }

  // ---- (c) A, and the pairwise decayed sums of dr and dk ----
  if (rb > 0) {
    // left of the diagonal block, about e = r0 - 1: A's n tiles nt = h,
    // h + 2, .. below 2 rb, and dr's part from all steps s < r0
    const float* qe = aS + (r0 - 1) * LD;
    float accA[3][4] = {};
    for (int kk = 0; kk < D; kk += 8) {
      float a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + g + 8 * (e % 2), d = kk + t4 + 4 * (e / 2);
        a[e] = rS[t * LD + d] * ex2(aS[(t - 1) * LD + d] - qe[d]);
      }
      uint32_t ah[4], al[4];
      split4(a, ah, al);
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int s = 8 * (2 * m + h) + g, d1 = kk + t4, d2 = d1 + 4;
        if (2 * m + h >= 2 * rb) break;
        mma3(accA[m], ah, al, kS[s * LD + d1] * ex2(qe[d1] - aS[s * LD + d1]),
             kS[s * LD + d2] * ex2(qe[d2] - aS[s * LD + d2]));
      }
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      if (2 * m + h >= 2 * rb) break;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(amS + (r0 + g + 8 * hf) * PLD +
                                   8 * (2 * m + h) + 2 * t4) =
            make_float2(accA[m][2 * hf], accA[m][2 * hf + 1]);
    }
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const int d = c0 + 8 * nt + g;
      float tmp[4] = {};
      for (int kk = 0; kk < r0; kk += 8) {
        float a[4];
        frag(pS, PLD, r0, kk, a);
        uint32_t ah[4], al[4];
        split4(a, ah, al);
        const int s1 = kk + t4, s2 = s1 + 4;
        mma3(tmp, ah, al, kS[s1 * LD + d] * ex2(qe[d] - aS[s1 * LD + d]),
             kS[s2 * LD + d] * ex2(qe[d] - aS[s2 * LD + d]));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + g + 8 * (e / 2), dd = c0 + 8 * nt + 2 * t4 + e % 2;
        DR[nt][e] += ex2(aS[(t - 1) * LD + dd] - qe[dd]) * tmp[e];
      }
    }
  }
  if (rb < 3) {
    // dk's part from the later row blocks, about e = r0 + 15
    const float* qe = aS + (r0 + 15) * LD;
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const int d = c0 + 8 * nt + g;
      float tmp[4] = {};
      for (int kk = r0 + SUB; kk < C; kk += 8) {
        float a[4];
        frag_t(pS, PLD, r0, kk, a);
        uint32_t ah[4], al[4];
        split4(a, ah, al);
        const int t1 = kk + t4, t2 = t1 + 4;
        mma3(tmp, ah, al,
             rS[t1 * LD + d] * ex2(aS[(t1 - 1) * LD + d] - qe[d]),
             rS[t2 * LD + d] * ex2(aS[(t2 - 1) * LD + d] - qe[d]));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = r0 + g + 8 * (e / 2), dd = c0 + 8 * nt + 2 * t4 + e % 2;
        DK[nt][e] += ex2(qe[dd] - aS[s * LD + dd]) * tmp[e];
      }
    }
  }
  {
    // the diagonal block's lower-left quarter (rows t = r0 + 8 .., steps
    // s = r0 .. r0 + 7), about e = r0 + 7: A (warp h = 1), and dr's and
    // dk's parts (rows s of dk: the A operand P^T's rows 0-7; rows t of dr:
    // P's rows 8-15; the other rows zeros)
    const float* qe = aS + (r0 + 7) * LD;
    const float pa[4] = {0.f, pS[(r0 + 8 + g) * PLD + r0 + t4], 0.f,
                         pS[(r0 + 8 + g) * PLD + r0 + t4 + 4]};
    const float pb[4] = {pS[(r0 + 8 + t4) * PLD + r0 + g], 0.f,
                         pS[(r0 + 12 + t4) * PLD + r0 + g], 0.f};
    uint32_t pah[4], pal[4], pbh[4], pbl[4];
    split4(pa, pah, pal);
    split4(pb, pbh, pbl);
    const int s1 = r0 + t4, s2 = s1 + 4, t1 = r0 + 8 + t4, t2 = t1 + 4;
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const int d = c0 + 8 * nt + g;
      float qr[4] = {}, qk[4] = {};
      mma3(qr, pah, pal, kS[s1 * LD + d] * ex2(qe[d] - aS[s1 * LD + d]),
           kS[s2 * LD + d] * ex2(qe[d] - aS[s2 * LD + d]));
      mma3(qk, pbh, pbl, rS[t1 * LD + d] * ex2(aS[(t1 - 1) * LD + d] - qe[d]),
           rS[t2 * LD + d] * ex2(aS[(t2 - 1) * LD + d] - qe[d]));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int dd = c0 + 8 * nt + 2 * t4 + e;
        const int t = r0 + 8 + g, s = r0 + g;
        DR[nt][2 + e] += ex2(aS[(t - 1) * LD + dd] - qe[dd]) * qr[2 + e];
        DK[nt][e] += ex2(qe[dd] - aS[s * LD + dd]) * qk[e];
      }
    }
    if (h == 1) {
      float quarter[4] = {};
      for (int kk = 0; kk < D; kk += 8) {
        const int t = r0 + 8 + g, s = r0 + g, d1 = kk + t4, d2 = d1 + 4;
        const float a[4] = {
            0.f, rS[t * LD + d1] * ex2(aS[(t - 1) * LD + d1] - qe[d1]), 0.f,
            rS[t * LD + d2] * ex2(aS[(t - 1) * LD + d2] - qe[d2])};
        uint32_t ah[4], al[4];
        split4(a, ah, al);
        mma3(quarter, ah, al, kS[s * LD + d1] * ex2(qe[d1] - aS[s * LD + d1]),
             kS[s * LD + d2] * ex2(qe[d2] - aS[s * LD + d2]));
      }
      *reinterpret_cast<float2*>(amS + (r0 + 8 + g) * PLD + r0 + 2 * t4) =
          make_float2(quarter[2], quarter[3]);
    } else {
      // above the diagonal of the block, zeros
      for (int e = lane; e < SUB * SUB; e += 32)
        if (e % SUB > e / SUB)
          amS[(r0 + e / SUB) * PLD + r0 + e % SUB] = 0.f;
    }
  }
  // the two 8 x 8 triangles (and the diagonal, dl = 0: the bonus), one
  // exponential per (t, s = t - dl, d) for the thread's row t and columns;
  // A's share of each pair is summed over the quad, then kept in `tri`
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = r0 + 8 * hf + g;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = c0 + 8 * nt + 2 * t4 + e;
        sum += rS[t * LD + d] * uh[d] * kS[t * LD + d];
      }
#pragma unroll 1
    for (int dl = 0; dl < 8; ++dl) {
      if (dl > 0) {
        const bool on = g >= dl;        // (t, t - dl) lies in the triangle
        const int s = on ? t - dl : t;
        const float pts = on ? pS[t * PLD + s] : 0.f;
        sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = c0 + 8 * nt + 2 * t4 + e;
            const float rt = rS[t * LD + d];
            const float ex = on ? ex2(aS[(t - 1) * LD + d] - aS[s * LD + d])
                                : 0.f;
            const float ks = on ? kS[s * LD + d] : 0.f;
            const float pe = pts * ex;
            DR[nt][2 * hf + e] += pe * ks;
            sum += rt * ks * ex;
            // dk[s][d] is held by the lane dl rows up (g - dl, same t4)
            const float got = __shfl_down_sync(FULL, pe * rt, 4 * dl);
            if (g + dl < 8) DK[nt][2 * hf + e] += got;
          }
      }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      if (t4 == 0) tri[(h * C + t) * 8 + dl] = sum;
    }
  }
  __syncthreads();
  // A on the triangles: the two column halves' sums, in that order
  for (int e = tid; e < C * 8; e += CHUNK_NT) {
    const int t = e / 8, dl = e % 8;
    if (t % 8 >= dl)
      amS[t * PLD + t - dl] = tri[t * 8 + dl] + tri[(C + t) * 8 + dl];
  }
  __syncthreads();

  // ---- (d) dv += A^T do over the steps t >= r0 ----
  for (int kk = r0; kk < C; kk += 8) {
    float a[4];
    frag_t(amS, PLD, r0, kk, a);
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const int j = c0 + 8 * nt + g;
      mma3(DV[nt], ah, al, doS[(kk + t4) * LD + j],
           doS[(kk + t4 + 4) * LD + j]);
    }
  }
  __syncthreads();                    // A is done with: v's place is free

  // ---- (e) dr, dk, du, dw ----
  float dus[NTL][2];
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
    dus[nt][0] = dus[nt][1] = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = r0 + g + 8 * hf, d = c0 + 8 * nt + 2 * t4;
      const float ptt = pS[t * PLD + t];
      float o_r[2], o_k[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * hf + e;
        const float rt = rS[t * LD + d + e], kt = kS[t * LD + d + e];
        o_r[e] = DR[nt][i] + uh[d + e] * kt * ptt;
        o_k[e] = DK[nt][i] + uh[d + e] * rt * ptt;
        dus[nt][e] += rt * kt * ptt;
        DR[nt][i] *= rt;                       // db_t
        gS[t * LD + d + e] = DR[nt][i] - kt * DK[nt][i];
      }
      if (t < n) {
        const size_t o = base + (size_t)(t0 + t) * D + d;
        *reinterpret_cast<float2*>(dr + o) = make_float2(o_r[0], o_r[1]);
        *reinterpret_cast<float2*>(dk + o) = make_float2(o_k[0], o_k[1]);
        *reinterpret_cast<float2*>(dv + o) =
            make_float2(DV[nt][2 * hf], DV[nt][2 * hf + 1]);
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off *= 2) {
      dus[nt][0] += __shfl_xor_sync(FULL, dus[nt][0], off);
      dus[nt][1] += __shfl_xor_sync(FULL, dus[nt][1], off);
    }
    if (g == 0) {
      du_red[rb * D + c0 + 8 * nt + 2 * t4] = dus[nt][0];
      du_red[rb * D + c0 + 8 * nt + 2 * t4 + 1] = dus[nt][1];
    }
  }
  __syncthreads();
  {
    // dlog w = the suffix sum of the terms over the chunk, plus dL: thread
    // (segment seg, channel ch) takes LEN steps, the later segments' totals
    // and dL first
    constexpr int SEGS = CHUNK_NT / D, LEN = C / SEGS;
    const int ch = tid % D, seg = tid / D;
    float sum = 0.f;
    for (int t = seg * LEN; t < (seg + 1) * LEN; ++t) sum += gS[t * LD + ch];
    tot[seg * D + ch] = sum;
    if (seg == 0)
      du_part[((size_t)bh * n_chunks + c) * D + ch] =
          du_red[ch] + du_red[D + ch] + du_red[2 * D + ch] +
          du_red[3 * D + ch];
    __syncthreads();
    float suf = red[ch] + red[D + ch] + red[2 * D + ch] + red[3 * D + ch];
    for (int s = SEGS - 1; s > seg; --s) suf += tot[s * D + ch];
    for (int t = (seg + 1) * LEN - 1; t >= seg * LEN; --t) {
      suf += gS[t * LD + ch];
      gS[t * LD + ch] = suf;
    }
  }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = r0 + g + 8 * hf, d = c0 + 8 * nt + 2 * t4;
      if (t >= n) continue;
      const size_t o = base + (size_t)(t0 + t) * D + d;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float wt = w[o + e];
        x[e] = wt >= 1e-12f ? (gS[t * LD + d + e] - DR[nt][2 * hf + e]) / wt
                            : 0.f;
      }
      *reinterpret_cast<float2*>(dw + o) = make_float2(x[0], x[1]);
    }
}

// Opt a kernel into its dynamic shared memory (once per instantiation; above
// 48 KB it must) and launch it with NT threads a block.
template <auto Kernel, int NT, typename... Args>
int launch(int floats, dim3 grid, cudaStream_t stream, Args... args) {
  static bool ready = false;
  const int bytes = floats * (int)sizeof(float);
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  Kernel<<<grid, NT, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int D>
int backward(const float* r, const float* k, const float* v, const float* w,
             const float* u, const float* ws, const float* dout,
             const float* ds_t, float* dws, float* dr, float* dk, float* dv,
             float* dw, float* du_part, float* ds0, int bh, int heads,
             int t_len, cudaStream_t st) {
  const int n_chunks = (t_len + C - 1) / C;
  const int err = launch<wkv6_bwd_state<D>, STATE_NT>(
      STATE_FLOATS, dim3((D / TILE) * (D / TILE), bh), st, r, w, dout, ds_t,
      dws, ds0, t_len);
  if (err != 0) return err;
  return launch<wkv6_bwd_chunk<D>, CHUNK_NT>(
      Chunk<D>::FLOATS, dim3(n_chunks, bh), st, r, k, v, w, u, ws, dout,
      (const float*)dws, dr, dk, dv, dw, du_part, t_len, heads);
}

constexpr int UNSUPPORTED = -1;

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers of
// contiguous fp32 tensors: r, k, v, w, dout (do) and the gradients dr, dk,
// dv, dw [BH, T, D], u [heads, D], ds_t and ds0 [BH, D, D], where BH = batch
// * heads, head-major within a batch row; ws, the forward's chunk-start
// states, and dws, the gradients reaching each chunk's end state,
// [BH, ceil(T / 64), D, D]; du_part [BH, ceil(T / 64), D]. Returns the first
// launch's failing cudaError_t (0 when both launched), or -1 for a head dim
// without an instantiation.
extern "C" {

// Two launches, wkv6_bwd_state then wkv6_bwd_chunk.
int rwkv6_chunk_bwd(const float* r, const float* k, const float* v,
                    const float* w, const float* u, const float* ws,
                    const float* dout, const float* ds_t, float* dws,
                    float* dr, float* dk, float* dv, float* dw,
                    float* du_part, float* ds0, int bh, int heads, int t_len,
                    int d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return backward<64>(r, k, v, w, u, ws, dout, ds_t, dws, dr, dk, dv, dw,
                          du_part, ds0, bh, heads, t_len, st);
    case 128:
      return backward<128>(r, k, v, w, u, ws, dout, ds_t, dws, dr, dk, dv,
                           dw, du_part, ds0, bh, heads, t_len, st);
    default:
      return UNSUPPORTED;
  }
}

// Dynamic shared memory, in bytes, of a kernel at head dim d: which 0 is
// wkv6_bwd_state, 1 wkv6_bwd_chunk; -1 for another d or which.
int rwkv6_bwd_shared_bytes(int which, int d) {
  if (d != 64 && d != 128) return UNSUPPORTED;
  const int chunk = d == 64 ? Chunk<64>::FLOATS : Chunk<128>::FLOATS;
  switch (which) {
    case 0: return STATE_FLOATS * (int)sizeof(float);
    case 1: return chunk * (int)sizeof(float);
    default: return UNSUPPORTED;
  }
}

}  // extern "C"
