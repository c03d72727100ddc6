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
// Two launches, CUDA cores, fp32:
// (1) wkv6_bwd_state: a block of 4 warps per (batch * head, 32 x 32 tile of
//     dS) walks the chunks from the last, its tile in registers (lane j of
//     warp w holds column j, rows w + 4 m). For each chunk it writes dS_{c+1}
//     to the workspace [BH, n_chunks, D, D], then applies the update above;
//     after the first chunk its tile is ds0.
// (2) wkv6_bwd_chunk: a block of 4 D threads per (chunk, batch * head), all
//     in parallel. Thread (q, d) = (tid / D, tid % D) owns channel d at rows
//     q + 4 m of the chunk. It stages r, k, v, do and a in shared memory,
//     computes P and A (one thread a pair), then S do_t and dS' v_s from the
//     two D x D matrices in slabs of 32 rows, dv, and last dr, dk and the
//     decay gradient of its channel, the suffix sum of dlog w by one thread a
//     channel.
//
// What bounds it on this card: at [4, 40, 4096, 64] the function must read
// r, k, v, w, do (and S_c, written by the forward) and write dr, dk, dv, dw:
// about 1.7 GB with this design's dS workspace, half a millisecond at 3.35
// TB/s. This simple design spends its time on the exponentials and the
// shared-memory loads of the pairwise terms (about 3 C^2 D / 2 a chunk), not
// on the bytes; the tensor cores and TMA are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int C = 64;             // time steps per chunk (the forward's)
constexpr int TILE = 32;          // state pass: tiles of dS, 32 x 32
constexpr int T_LD = TILE + 1;    // row stride of its [C][TILE] tiles
constexpr int STATE_NT = 128;     // 4 warps
constexpr int STATE_FLOATS = 3 * C * T_LD + TILE;  // r~, w, do; the decays
constexpr int SLAB = 32;          // chunk pass: rows of S_c / dS' staged
constexpr int ROWS = C / 4;       // rows of the chunk a thread owns
constexpr int NPAIR = C * (C + 1) / 2;

// The chunk pass's shared memory, in floats: a, r, k, v (then k e^{L - a},
// then partial sums), do (then the decay gradient) [C][LD]; P and A
// [C][PLD]; a slab of S_c and one of dS' [SLAB][LD]; u [D]. Strides D + 1
// and C + 1 put a warp's column reads of 32 rows in 32 banks.
template <int D>
struct Chunk {
  static constexpr int NT = 4 * D;
  static constexpr int LD = D + 1;
  static constexpr int PLD = C + 1;
  static constexpr int A_OFF = 0;
  static constexpr int R_OFF = A_OFF + C * LD;
  static constexpr int K_OFF = R_OFF + C * LD;
  static constexpr int V_OFF = K_OFF + C * LD;
  static constexpr int DO_OFF = V_OFF + C * LD;
  static constexpr int P_OFF = DO_OFF + C * LD;
  static constexpr int AM_OFF = P_OFF + C * PLD;
  static constexpr int X1_OFF = AM_OFF + C * PLD;
  static constexpr int X2_OFF = X1_OFF + SLAB * LD;
  static constexpr int U_OFF = X2_OFF + SLAB * LD;
  static constexpr int FLOATS = U_OFF + D;
};

// The state pass. Block (tile, batch * head): rows i0 .. i0 + 31 (key
// channels) and columns j0 .. j0 + 31 of dS; thread (warp, lane) holds
// column j0 + lane at rows i0 + warp + 4 m.
template <int D>
__global__ void __launch_bounds__(STATE_NT)
wkv6_bwd_state(const float* __restrict__ r, const float* __restrict__ w,
               const float* __restrict__ dout, const float* __restrict__ ds_t,
               float* __restrict__ dws, float* __restrict__ ds0, int t_len) {
  extern __shared__ __align__(16) float smem[];
  float* rS = smem;                  // r_t e^{b_t} [C][T_LD]
  float* wS = rS + C * T_LD;         // w [C][T_LD]
  float* dS = wS + C * T_LD;         // do [C][T_LD]
  float* decS = dS + C * T_LD;       // e^L by row
  constexpr int TILES = D / TILE;
  constexpr int M = TILE / 4;        // rows a thread holds
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i0 = (blockIdx.x / TILES) * TILE, j0 = (blockIdx.x % TILES) * TILE;
  const int bh = blockIdx.y;
  const int n_chunks = (t_len + C - 1) / C;
  const size_t base = (size_t)bh * t_len * D;
  const size_t sbase = (size_t)bh * D * D;

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m)
    acc[m] = ds_t[sbase + (size_t)(i0 + warp + 4 * m) * D + j0 + lane];
  for (int c = n_chunks - 1; c >= 0; --c) {
    float* dst = dws + ((size_t)bh * n_chunks + c) * D * D;
#pragma unroll
    for (int m = 0; m < M; ++m)
      dst[(size_t)(i0 + warp + 4 * m) * D + j0 + lane] = acc[m];
    const int t0 = c * C, n = min(C, t_len - t0);
    for (int e = tid; e < C * TILE; e += STATE_NT) {
      const int t = e / TILE, x = e % TILE;
      const bool in = t < n;
      const size_t at = base + (size_t)(t0 + (in ? t : 0)) * D;
      rS[t * T_LD + x] = in ? r[at + i0 + x] : 0.f;
      wS[t * T_LD + x] = in ? w[at + i0 + x] : 1.f;
      dS[t * T_LD + x] = in ? dout[at + j0 + x] : 0.f;
    }
    __syncthreads();
    if (tid < TILE) {                // r~_t = r_t e^{b_t}, in place
      float b = 0.f;
      for (int t = 0; t < C; ++t) {
        rS[t * T_LD + tid] *= ex2(b);
        b += __log2f(fmaxf(wS[t * T_LD + tid], 1e-12f));
      }
      decS[tid] = ex2(b);
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = warp + 4 * m;
      float s = acc[m] * decS[i];
      for (int t = 0; t < n; ++t) s += rS[t * T_LD + i] * dS[t * T_LD + lane];
      acc[m] = s;
    }
    __syncthreads();                 // the tiles are free for chunk c - 1
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
    ds0[sbase + (size_t)(i0 + warp + 4 * m) * D + j0 + lane] = acc[m];
}

// The chunk pass. Block (chunk, batch * head).
template <int D>
__global__ void __launch_bounds__(4 * D)
wkv6_bwd_chunk(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ ws,
               const float* __restrict__ dout, const float* __restrict__ dws,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dw,
               float* __restrict__ du_part, int t_len, int heads) {
  using L = Chunk<D>;
  constexpr int NT = L::NT, LD = L::LD, PLD = L::PLD;
  extern __shared__ __align__(16) float smem[];
  float* aS = smem + L::A_OFF;
  float* rS = smem + L::R_OFF;
  float* kS = smem + L::K_OFF;
  float* vS = smem + L::V_OFF;
  float* doS = smem + L::DO_OFF;
  float* pS = smem + L::P_OFF;
  float* amS = smem + L::AM_OFF;
  float* x1 = smem + L::X1_OFF;
  float* x2 = smem + L::X2_OFF;
  float* uS = smem + L::U_OFF;
  const int tid = threadIdx.x, ch = tid % D, q = tid / D;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int n_chunks = (t_len + C - 1) / C, t0 = c * C;
  const int n = min(C, t_len - t0);
  const size_t base = (size_t)bh * t_len * D;
  const float* sc = ws + ((size_t)bh * n_chunks + c) * D * D;
  const float* gc = dws + ((size_t)bh * n_chunks + c) * D * D;

  // (0) the chunk's rows, log2 w in a's place
  for (int e = tid; e < C * D; e += NT) {
    const int t = e / D, d = e % D;
    const bool in = t < n;
    const size_t at = base + (size_t)(t0 + (in ? t : 0)) * D + d;
    rS[t * LD + d] = in ? r[at] : 0.f;
    kS[t * LD + d] = in ? k[at] : 0.f;
    vS[t * LD + d] = in ? v[at] : 0.f;
    doS[t * LD + d] = in ? dout[at] : 0.f;
    aS[t * LD + d] = in ? __log2f(fmaxf(w[at], 1e-12f)) : 0.f;
  }
  if (tid < D) uS[tid] = u[(size_t)(bh % heads) * D + tid];
  __syncthreads();
  // (1) a = the inclusive cumulative sum, one thread a channel
  if (q == 0) {
    float s = 0.f;
    for (int t = 0; t < C; ++t) {
      s += aS[t * LD + ch];
      aS[t * LD + ch] = s;
    }
  }
  __syncthreads();

  // (2) P and A on and below the diagonal, one thread a pair (t, s)
  for (int p = tid; p < NPAIR; p += NT) {
    int t = (int)((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
    while (t * (t + 1) / 2 > p) --t;
    while ((t + 1) * (t + 2) / 2 <= p) ++t;
    const int s = p - t * (t + 1) / 2;
    const float* dot = doS + t * LD;
    const float* vs = vS + s * LD;
    const float* rt = rS + t * LD;
    const float* ks = kS + s * LD;
    float pv = 0.f, av = 0.f;
    for (int j = 0; j < D; ++j) pv += dot[j] * vs[j];
    if (s < t) {
      const float* bt = aS + (t - 1) * LD;
      const float* as = aS + s * LD;
      for (int d = 0; d < D; ++d) av += rt[d] * ks[d] * ex2(bt[d] - as[d]);
    } else {
      for (int d = 0; d < D; ++d) av += rt[d] * uS[d] * ks[d];
    }
    pS[t * PLD + s] = pv;
    amS[t * PLD + s] = av;
  }

  // (3) for the thread's channel and rows: y = S_c do_t and z = dS' v_t,
  // and (q = 0) rowsum(S_c . dS'), over slabs of SLAB rows of both
  float y[ROWS], z[ROWS];
  float rowsum = 0.f;
#pragma unroll
  for (int m = 0; m < ROWS; ++m) y[m] = z[m] = 0.f;
  for (int d0 = 0; d0 < D; d0 += SLAB) {
    __syncthreads();                 // the slabs (and P, A) are free
    for (int e = tid; e < SLAB * D; e += NT) {
      const int i = e / D, j = e % D;
      x1[i * LD + j] = sc[(size_t)(d0 + i) * D + j];
      x2[i * LD + j] = gc[(size_t)(d0 + i) * D + j];
    }
    __syncthreads();
    if (ch >= d0 && ch < d0 + SLAB) {
      const float* srow = x1 + (ch - d0) * LD;
      const float* grow = x2 + (ch - d0) * LD;
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const float* dot = doS + (q + 4 * m) * LD;
        const float* vt = vS + (q + 4 * m) * LD;
        float yy = 0.f, zz = 0.f;
        for (int j = 0; j < D; ++j) {
          yy += dot[j] * srow[j];
          zz += vt[j] * grow[j];
        }
        y[m] = yy;
        z[m] = zz;
      }
      if (q == 0)
        for (int j = 0; j < D; ++j) rowsum += srow[j] * grow[j];
    }
  }
  __syncthreads();                   // v is free: k e^{L - a} in its place
  float* khS = vS;
  for (int e = tid; e < C * D; e += NT) {
    const int t = e / D, d = e % D;
    khS[t * LD + d] = kS[t * LD + d] * ex2(aS[(C - 1) * LD + d] - aS[t * LD + d]);
  }

  // (4) dv for column ch at rows s = q + 4 m: A^T do, then (k e^{L - a}) dS'
  float dvs[ROWS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const int s = q + 4 * m;
    float acc = 0.f;
    for (int t = s; t < n; ++t) acc += amS[t * PLD + s] * doS[t * LD + ch];
    dvs[m] = acc;
  }
  for (int d0 = 0; d0 < D; d0 += SLAB) {
    __syncthreads();
    for (int e = tid; e < SLAB * D; e += NT) {
      const int i = e / D, j = e % D;
      x2[i * LD + j] = gc[(size_t)(d0 + i) * D + j];
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const float* kh = khS + (q + 4 * m) * LD + d0;
      float acc = dvs[m];
      for (int i = 0; i < SLAB; ++i) acc += kh[i] * x2[i * LD + ch];
      dvs[m] = acc;
    }
  }
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const int s = q + 4 * m;
    if (s < n) dv[base + (size_t)(t0 + s) * D + ch] = dvs[m];
  }
  __syncthreads();                   // do and k e^{L - a} are free

  // (5) dr and dk of channel ch at rows t = q + 4 m, and its decay terms
  float* gS = doS;                   // da_t + db_t, then their suffix sums
  float* red = vS;                   // rows 0-3: dL partials, 4-7: du
  const float lc = aS[(C - 1) * LD + ch], uc = uS[ch];
  float db[ROWS];
  float dl = 0.f, dus = 0.f;
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const int t = q + 4 * m;
    const float at = aS[t * LD + ch];
    const float bt = t > 0 ? aS[(t - 1) * LD + ch] : 0.f;
    const float rt = rS[t * LD + ch], kt = kS[t * LD + ch];
    const float ptt = pS[t * PLD + t];
    float intra_r = 0.f, intra_k = 0.f;
    for (int s = 0; s < t; ++s)
      intra_r += kS[s * LD + ch] * ex2(bt - aS[s * LD + ch]) * pS[t * PLD + s];
    for (int tt = t + 1; tt < n; ++tt)
      intra_k += rS[tt * LD + ch] * ex2(aS[(tt - 1) * LD + ch] - at) *
                 pS[tt * PLD + t];
    const float el = ex2(lc - at);
    const float dr_t = ex2(bt) * y[m] + intra_r;      // less the bonus
    const float dk_t = intra_k + el * z[m];           // less the bonus
    if (t < n) {
      const size_t o = base + (size_t)(t0 + t) * D + ch;
      dr[o] = dr_t + uc * kt * ptt;
      dk[o] = dk_t + uc * rt * ptt;
    }
    dus += rt * kt * ptt;
    db[m] = rt * dr_t;
    gS[t * LD + ch] = db[m] - kt * dk_t;
    dl += kt * el * z[m];
  }
  if (q == 0) dl += ex2(lc) * rowsum;
  red[q * LD + ch] = dl;
  red[(4 + q) * LD + ch] = dus;
  __syncthreads();
  if (q == 0) {
    const float dl_all = red[ch] + red[LD + ch] + red[2 * LD + ch] +
                         red[3 * LD + ch];
    du_part[((size_t)bh * n_chunks + c) * D + ch] =
        red[4 * LD + ch] + red[5 * LD + ch] + red[6 * LD + ch] +
        red[7 * LD + ch];
    float suf = dl_all;
    for (int t = n - 1; t >= 0; --t) {
      suf += gS[t * LD + ch];
      gS[t * LD + ch] = suf;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const int t = q + 4 * m;
    if (t >= n) continue;
    const size_t o = base + (size_t)(t0 + t) * D + ch;
    const float wt = w[o];
    dw[o] = wt >= 1e-12f ? (gS[t * LD + ch] - db[m]) / wt : 0.f;
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
  return launch<wkv6_bwd_chunk<D>, Chunk<D>::NT>(
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
