// WKV6 forward for Hopper (sm_90a), CUDA C++: a chunk-parallel route on the
// tensor cores for prefill, and a step route for decode.
//
// Replaces src/repro/kernels/rwkv6_chunk.py: rwkv6_chunk -> _kernel (the
// pallas_call at :73), which has no backward; neither have these kernels.
//
// Computes, for every (batch, head), with an fp32 state S [D_k, D_v]:
//   o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
// Inputs r, k, v, w are [B, H, T, D] fp32 row-major (w in (0, 1)), u [H, D],
// s0 [B, H, D, D]; outputs o [B, H, T, D] and S_T [B, H, D, D], fp32. Head
// dims 64 and 128, any T >= 1 on either route; the host picks the route by
// T (kernels/rwkv6_chunk.py).
//
// Chunked route, rwkv6_chunk_fwd: two launches. The sequence is cut into
// chunks of C = 64 steps; the last may be short, its missing steps taking
// zero r, k, v and w = 1. Per chunk, with q = cumsum(log w) over the chunk
// per channel (q_exc[t] = q[t - 1], q_exc[0] = 0) and S_c the state
// entering it:
//   o_t     = (r_t * exp(q_exc_t)) S_c + sum_{s <= t} A[t][s] v_s
//   A[t][s] = sum_d r_t k_s exp(q_exc_t - q_s)  (s < t),
//   A[t][t] = sum_d r_t u k_t                   (the bonus)
//   S_{c+1} = diag(exp(q_last)) S_c + (k * exp(q_last - q))^T v
// (1) wkv6_state: a block of 4 warps per (batch * head, 32 x 32 tile of S)
//     walks the chunks in order, its tile held in the mma accumulators. For
//     each chunk it writes S_c to the workspace [BH, n_chunks, D, D], then
//     applies the update as one tensor-core product over the chunk's 64
//     steps, while the next chunk's k, w and v arrive through a two-stage
//     cp.async ring. Its decays exp(q_last - q_t) are suffix products of w
//     (scan_prod8): no logarithm or exponential.
// (2) wkv6_output: a block of 8 warps per (batch * head, chunk, 64 value
//     columns), all in parallel; two warps serve each sub-chunk i of 16
//     rows. q is recomputed from w, in base 2 (log_cumsum, ex2). A left of
//     the diagonal 16 x 16 block is one tensor-core product: with e = 16 i
//     - 1, r~_t = r_t exp(q_exc_t - q_e) and k^_s = k_s exp(q_e - q_s)
//     (s <= e), A[t][s] = sum_d r~_t k^_s. The block's lower-left 8 x 8
//     quarter is one more, about e = 16 i + 7; its two 8 x 8 triangles keep
//     one exponential per (t, s, d), 72 D of them a sub-chunk. Then o =
//     r_exc S_c + A v, two more tensor-core products. The loads come in
//     three cp.async groups (w; r, k, u; v, S_c), the later ones landing
//     while q and A are computed.
// Every exponent is <= 0 (q does not increase, also as rounded: see
// log_cumsum), so nothing overflows at strong decay. The TPU kernel (and
// the reference's model path) factor the pairwise decay as (r exp(q_exc))
// (k exp(-q_inc)), which overflows fp32 once a chunk's cumulative
// log-decay passes about -88.
//
// Products at fp32 accuracy on the tensor cores: 3xTF32 (mma3.cuh). The
// state pass, the chunk, log_cumsum and the decay scans are shared with the
// backward (wkv6_chunk.cuh).
//
// Step route, rwkv6_step_fwd: one launch, for short T (decode). A block of
// 4 warps per (batch * head, 32 value columns); lane (row group lane / 8,
// column lane % 8) holds rows lane / 8 + 4 m of its column of S in
// registers across all T steps. Per step, o_j = sum_i r_i S_ij over its
// rows and the bonus sum_i r_i u_i k_i are reduced over the four row groups
// by __shfl_xor_sync; then S_ij <- w_i S_ij + k_i v_j. No prefix sums, no
// tiles, no exponentials.
//
// What bounds it on this card: at the prefill shape [4, 40, 4096, 64] the
// function must move 0.84 GB (0.25 ms at 3.35 TB/s) and needs 1.36e10
// flops (0.20 ms at 67 TFLOP/s fp32): bytes. This design moves about
// 1.7 GB: the state pass reads k, w and v (twice each at D = 64, partly
// from L2) and writes the 0.17 GB workspace, the output pass reads it with
// r, k, v and w and writes o. Its tensor-core work, 3 x ~1.6e10 flops, is
// small beside the 495 TFLOP/s TF32 peak; the instructions around it (the
// exponentials, the splits, the shared-memory loads) are not. At a decode
// step [8, 40, 1, 64] the state is read and written once: 10.5 MB, 3.3 us.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"
#include "mma3.cuh"
#include "wkv6_chunk.cuh"

namespace {

constexpr int SUB = 16;            // a sub-chunk: the rows of o of a warp
constexpr int DV = 64;             // output pass: value columns per block
constexpr int V_LD = DV + 8;       // row stride of v and S_c [.][DV]
constexpr int A_LD = C + 4;        // row stride of A [C][C]
constexpr int OUT_NT = 256;        // 8 warps, two a sub-chunk
constexpr int STEP_NT = 128;       // step route: 4 warps
constexpr int STEP_COLS = 32;      // value columns per step block
static_assert(C == 4 * SUB && C == 4 * 16, "log_cumsum takes 4 x 16 steps");

// Row strides: D + 4 and A_LD are 4 (mod 32) floats, so the 32 lanes'
// a0 = X[g][t] reads of an A fragment hit 32 banks; T_LD and V_LD are
// 8 (mod 32), so the B fragment reads X[t][g] do.
template <int D>
struct Out {
  static constexpr int LD = D + 4;                 // r, k, q [C][LD]
  static constexpr int R_OFF = 0;
  static constexpr int K_OFF = R_OFF + C * LD;
  static constexpr int Q_OFF = K_OFF + C * LD;
  static constexpr int V_OFF = Q_OFF + C * LD;     // v [C][V_LD]
  static constexpr int S_OFF = V_OFF + C * V_LD;   // S_c [D][V_LD]
  static constexpr int A_OFF = S_OFF + D * V_LD;   // A [C][A_LD]
  static constexpr int U_OFF = A_OFF + C * A_LD;   // u [D]
  static constexpr int FLOATS = U_OFF + D;
};

// The state pass (wkv6_chunk.cuh): ws[c] = S_c, s_out = S_T.
template <int D>
__global__ void __launch_bounds__(STATE_NT)
wkv6_state(const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ w, const float* __restrict__ s0,
           float* __restrict__ ws, float* __restrict__ s_out, int t_len) {
  extern __shared__ __align__(16) float smem[];
  state_pass<D, false>(smem, k, v, w, s0, ws, s_out, t_len);
}

// The output pass. Block (chunk * D / DV + value tile, batch * head); warp
// w serves sub-chunk i = w % 4 (rows r0 = 16 i ..) and value columns
// j0 + 32 (w / 4) .. of o. The two warps of a sub-chunk share its rows of A:
// the first computes the part left of the diagonal block and the block's
// lower-left quarter, the second the block's two triangles.
template <int D>
__global__ void __launch_bounds__(OUT_NT)
wkv6_output(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ ws,
            float* __restrict__ o, int t_len, int heads) {
  using L = Out<D>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) float smem[];
  float* rS = smem + L::R_OFF;
  float* kS = smem + L::K_OFF;
  float* qS = smem + L::Q_OFF;
  float* vS = smem + L::V_OFF;
  float* sS = smem + L::S_OFF;
  float* aS = smem + L::A_OFF;
  float* uS = smem + L::U_OFF;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int c = blockIdx.x / (D / DV), j0 = (blockIdx.x % (D / DV)) * DV;
  const int bh = blockIdx.y;
  const int n_chunks = (t_len + C - 1) / C, t0 = c * C;
  const int n = min(C, t_len - t0);
  const size_t base = (size_t)bh * t_len * D;

  // three groups of copies, waited for in turn: w (for the scan), then r,
  // k and u (for A), then v and S_c (for the products), which land while A
  // is computed
  auto rows = [&](float* dst, const float* src) {
    for (int e = tid; e < C * (D / 4); e += OUT_NT) {
      const int t = e / (D / 4), q4 = e % (D / 4);
      const bool in = t < n;
      cp_async16(dst + t * LD + 4 * q4,
                 src + base + (size_t)(t0 + (in ? t : 0)) * D + 4 * q4, in);
    }
  };
  rows(qS, w);
  cp_async_commit();
  rows(rS, r);
  rows(kS, k);
  for (int e = tid; e < D / 4; e += OUT_NT)
    cp_async16(uS + 4 * e, u + (size_t)(bh % heads) * D + 4 * e, true);
  cp_async_commit();
  for (int e = tid; e < C * (DV / 4); e += OUT_NT) {
    const int t = e / (DV / 4), q4 = e % (DV / 4);
    const bool in = t < n;
    cp_async16(vS + t * V_LD + 4 * q4,
               v + base + (size_t)(t0 + (in ? t : 0)) * D + j0 + 4 * q4, in);
  }
  const float* sc = ws + ((size_t)bh * n_chunks + c) * D * D;
  for (int e = tid; e < D * (DV / 4); e += OUT_NT) {
    const int dd = e / (DV / 4), q4 = e % (DV / 4);
    cp_async16(sS + dd * V_LD + 4 * q4, sc + (size_t)dd * D + j0 + 4 * q4,
               true);
  }
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();
  log_cumsum<D / 64>(qS, LD, n, 8 * warp, 64, lane);   // 8 warps, D / 8 groups
  cp_async_wait<1>();
  __syncthreads();

  const int r0 = SUB * (warp % 4);  // the warp's rows of the chunk
  const int half = warp / 4;        // its value columns: j0 + 32 half ..
  const bool live = r0 < n;         // warp-uniform
  float* aRow = aS + r0 * A_LD;     // its rows of A

  if (live && half == 0) {
    // (a) A[t][s] for s < r0: r~ (A operand) times k^ (B operand), K = D
    if (r0 > 0) {
      const float* qe = qS + (r0 - 1) * LD;
      float accA[6][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < D; kk += 8) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tt = r0 + g + 8 * (i % 2), dd = kk + t4 + 4 * (i / 2);
          a[i] = rS[tt * LD + dd] * ex2(qS[(tt - 1) * LD + dd] - qe[dd]);
        }
        uint32_t ah[4], al[4];
        split4(a, ah, al);
#pragma unroll
        for (int nt = 0; nt < 6; ++nt) {
          if (8 * nt >= r0) break;
          const int s = 8 * nt + g, d1 = kk + t4, d2 = kk + t4 + 4;
          mma3(accA[nt], ah, al,
               kS[s * LD + d1] * ex2(qe[d1] - qS[s * LD + d1]),
               kS[s * LD + d2] * ex2(qe[d2] - qS[s * LD + d2]));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 6; ++nt) {
        if (8 * nt >= r0) break;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(aRow + (g + 8 * h) * A_LD + 8 * nt +
                                     2 * t4) =
              make_float2(accA[nt][2 * h], accA[nt][2 * h + 1]);
      }
    }
    // (b) the diagonal block's lower-left 8 x 8 quarter (rows r0 + 8 ..,
    // columns r0 .. r0 + 7): one more tensor-core product about e = r0 + 7,
    // the A operand's rows 0-7 zeros
    const float* qe = qS + (r0 + 7) * LD;
    float quarter[4] = {};
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 8) {
      const int tt = r0 + 8 + g, s = r0 + g, d1 = kk + t4, d2 = kk + t4 + 4;
      const float a[4] = {
          0.f, rS[tt * LD + d1] * ex2(qS[(tt - 1) * LD + d1] - qe[d1]),
          0.f, rS[tt * LD + d2] * ex2(qS[(tt - 1) * LD + d2] - qe[d2])};
      uint32_t ah[4], al[4];
      split4(a, ah, al);
      mma3(quarter, ah, al, kS[s * LD + d1] * ex2(qe[d1] - qS[s * LD + d1]),
           kS[s * LD + d2] * ex2(qe[d2] - qS[s * LD + d2]));
    }
    *reinterpret_cast<float2*>(aRow + (8 + g) * A_LD + r0 + 2 * t4) =
        make_float2(quarter[2], quarter[3]);
  } else if (live) {
    // (c) the two 8 x 8 triangles on the diagonal block's diagonal, one
    // exponential per (t, s, d): lane l takes entries l + 32 m of their 72
    // with s <= t (s == t: the bonus), all at once over d in float4 steps,
    // each lane starting at its own d. Above the diagonal, zeros.
    for (int e = lane; e < SUB * SUB; e += 32)
      if (e % SUB > e / SUB) aRow[(e / SUB) * A_LD + r0 + e % SUB] = 0.f;
    constexpr int TRI = 8 * 9 / 2, NP = 2 * TRI, PM = (NP + 31) / 32;
    int at_t[PM], at_s[PM], at_q[PM];
    bool bonus[PM];
    float sum[PM];
#pragma unroll
    for (int m = 0; m < PM; ++m) {
      const int p = min(lane + 32 * m, NP - 1);   // past the end: recomputed
      const int h8 = 8 * (p / TRI), pp = p % TRI;
      int tt = (int)((sqrtf(8.f * pp + 1.f) - 1.f) * 0.5f);
      while (tt * (tt + 1) / 2 > pp) --tt;
      while ((tt + 1) * (tt + 2) / 2 <= pp) ++tt;
      const int ss = pp - tt * (tt + 1) / 2;
      bonus[m] = ss == tt;
      at_t[m] = (r0 + h8 + tt) * LD;
      at_s[m] = (r0 + h8 + ss) * LD;
      at_q[m] = bonus[m] ? at_s[m] : at_t[m] - LD;    // q_exc[t] = q[t - 1]
      sum[m] = 0.f;
    }
#pragma unroll 2
    for (int dd = 0; dd < D; dd += 4) {
      const int d = (dd + 4 * lane) & (D - 1);
      const float4 uu = *reinterpret_cast<const float4*>(uS + d);
#pragma unroll
      for (int m = 0; m < PM; ++m) {
        const float4 rr = *reinterpret_cast<const float4*>(rS + at_t[m] + d);
        const float4 kr = *reinterpret_cast<const float4*>(kS + at_s[m] + d);
        const float4 qt = *reinterpret_cast<const float4*>(qS + at_q[m] + d);
        const float4 qs = *reinterpret_cast<const float4*>(qS + at_s[m] + d);
        sum[m] += rr.x * kr.x * (bonus[m] ? uu.x : ex2(qt.x - qs.x)) +
                  rr.y * kr.y * (bonus[m] ? uu.y : ex2(qt.y - qs.y)) +
                  rr.z * kr.z * (bonus[m] ? uu.z : ex2(qt.z - qs.z)) +
                  rr.w * kr.w * (bonus[m] ? uu.w : ex2(qt.w - qs.w));
      }
    }
#pragma unroll
    for (int m = 0; m < PM; ++m)
      if (lane + 32 * m < NP)
        aRow[(at_t[m] / LD - r0) * A_LD + at_s[m] / LD] = sum[m];
  }
  cp_async_wait_all();
  __syncthreads();                  // the sub-chunk's rows of A are whole
  if (!live) return;

  // (d) o = (r exp(q_exc)) S_c + A v over the warp's 16 rows, 4 n tiles
  const int cols = 32 * half;
  float acc[4][4] = {};
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 8) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tt = r0 + g + 8 * (i % 2), dd = kk + t4 + 4 * (i / 2);
      const float qx = qS[(tt > 0 ? tt - 1 : 0) * LD + dd];
      a[i] = rS[tt * LD + dd] * (tt > 0 ? ex2(qx) : 1.f);
    }
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma3(acc[nt], ah, al, sS[(kk + t4) * V_LD + cols + 8 * nt + g],
           sS[(kk + t4 + 4) * V_LD + cols + 8 * nt + g]);
  }
  for (int kk = 0; kk < r0 + SUB; kk += 8) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = aRow[(g + 8 * (i % 2)) * A_LD + kk + t4 + 4 * (i / 2)];
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma3(acc[nt], ah, al, vS[(kk + t4) * V_LD + cols + 8 * nt + g],
           vS[(kk + t4 + 4) * V_LD + cols + 8 * nt + g]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tt = r0 + g + 8 * h;
    if (tt >= n) continue;
    float* dst = o + base + (size_t)(t0 + tt) * D + j0 + cols + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      *reinterpret_cast<float2*>(dst + 8 * nt) =
          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
  }
}

// The step route. Block (value slab, batch * head).
template <int D>
__global__ void __launch_bounds__(STEP_NT)
wkv6_step(const float* __restrict__ r, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ w,
          const float* __restrict__ u, const float* __restrict__ s0,
          float* __restrict__ o, float* __restrict__ s_out, int t_len,
          int heads) {
  constexpr int M = D / 4;          // rows a thread holds
  const int tid = threadIdx.x, lane = tid % 32, rg = lane / 8;
  const int j = blockIdx.x * STEP_COLS + (tid / 32) * 8 + lane % 8;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * t_len * D;
  const size_t sbase = (size_t)bh * D * D;
  const float* uh = u + (size_t)(bh % heads) * D;
  float s[M];
#pragma unroll
  for (int m = 0; m < M; ++m) s[m] = s0[sbase + (size_t)(rg + 4 * m) * D + j];
  for (int t = 0; t < t_len; ++t) {
    const size_t at = base + (size_t)t * D;
    const float vj = v[at + j];
    float acc = 0.f, bonus = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = rg + 4 * m;
      const float ri = r[at + i], ki = k[at + i];
      acc += ri * s[m];
      bonus += ri * uh[i] * ki;
      s[m] = w[at + i] * s[m] + ki * vj;
    }
#pragma unroll
    for (int off = 8; off < 32; off *= 2) {
      acc += __shfl_xor_sync(FULL, acc, off);
      bonus += __shfl_xor_sync(FULL, bonus, off);
    }
    if (rg == 0) o[at + j] = acc + bonus * vj;
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
    s_out[sbase + (size_t)(rg + 4 * m) * D + j] = s[m];
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
int chunked(const float* r, const float* k, const float* v, const float* w,
            const float* u, const float* s0, float* o, float* s_out,
            float* ws, int bh, int heads, int t_len, cudaStream_t st) {
  const int n_chunks = (t_len + C - 1) / C;
  const int err = launch<wkv6_state<D>, STATE_NT>(
      STATE_FLOATS, dim3((D / TILE) * (D / TILE), bh), st, k, v, w, s0, ws,
      s_out, t_len);
  if (err != 0) return err;
  return launch<wkv6_output<D>, OUT_NT>(
      Out<D>::FLOATS, dim3(n_chunks * (D / DV), bh), st, r, k, v, w, u,
      (const float*)ws, o, t_len, heads);
}

constexpr int UNSUPPORTED = -1;

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers of
// contiguous fp32 tensors: r, k, v, w, o [BH, T, D], u [heads, D], s0 and
// s_out [BH, D, D], where BH = batch * heads, head-major within a batch row;
// ws, the chunked route's workspace, [BH, ceil(T / 64), D, D]. Each returns
// the first launch's failing cudaError_t (0 when both launched), or -1 for a
// head dim without an instantiation.
extern "C" {

// The chunked route: two launches, wkv6_state then wkv6_output.
int rwkv6_chunk_fwd(const float* r, const float* k, const float* v,
                    const float* w, const float* u, const float* s0,
                    float* o, float* s_out, float* ws, int bh, int heads,
                    int t_len, int d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return chunked<64>(r, k, v, w, u, s0, o, s_out, ws, bh, heads, t_len,
                         st);
    case 128:
      return chunked<128>(r, k, v, w, u, s0, o, s_out, ws, bh, heads, t_len,
                          st);
    default:
      return UNSUPPORTED;
  }
}

// The step route: one launch of wkv6_step.
int rwkv6_step_fwd(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* o,
                   float* s_out, int bh, int heads, int t_len, int d,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define STEP(D)                                                          \
  return launch<wkv6_step<D>, STEP_NT>(0, dim3(D / STEP_COLS, bh), st,  \
                                       r, k, v, w, u, s0, o, s_out,     \
                                       t_len, heads)
  switch (d) {
    case 64: STEP(64);
    case 128: STEP(128);
    default: return UNSUPPORTED;
  }
#undef STEP
}

// Dynamic shared memory, in bytes, of a kernel at head dim d: which 0 is
// wkv6_state, 1 wkv6_output, 2 wkv6_step; -1 for another d or which.
int rwkv6_shared_bytes(int which, int d) {
  if (d != 64 && d != 128) return UNSUPPORTED;
  const int out = d == 64 ? Out<64>::FLOATS : Out<128>::FLOATS;
  switch (which) {
    case 0: return STATE_FLOATS * (int)sizeof(float);
    case 1: return out * (int)sizeof(float);
    case 2: return 0;
    default: return UNSUPPORTED;
  }
}

}  // extern "C"
