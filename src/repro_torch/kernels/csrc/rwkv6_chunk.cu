// WKV6 chunk forward for Hopper (sm_90a), CUDA C++.
//
// Replaces src/repro/kernels/rwkv6_chunk.py: rwkv6_chunk -> _kernel (the
// pallas_call at :73), which has no backward; neither has this kernel.
//
// Computes, for every (batch, head), with an fp32 state S [D_k, D_v]:
//   o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
// Inputs r, k, v, w are [B, H, T, D] fp32 row-major (w in (0, 1)), u [H, D],
// s0 [B, H, D, D]; outputs o [B, H, T, D] and S_T [B, H, D, D], fp32.
//
// The sequence is walked in chunks of C = 64 steps (the last may be short:
// any T >= 1, nothing padded). Per chunk, with q_inc = cumsum(log w) and
// q_exc[t] = q_inc[t - 1] (q_exc[0] = 0) per channel:
//   A[t][s] = sum_d r_t k_s exp(q_exc_t - q_inc_s)     for s < t
//   A[t][t] = sum_d r_t u k_t                           (the bonus)
//   o_t     = (r_t * exp(q_exc_t)) S + sum_{s<=t} A[t][s] v_s
//   S      <- diag(exp(q_inc_last)) S + (k * exp(q_inc_last - q_inc))^T v
// Every exponent is <= 0, so nothing overflows at strong decay. The TPU
// kernel (and the reference's model path) factor the pairwise decay as
// (r exp(q_exc)) (k exp(-q_inc)), which overflows fp32 once a chunk's
// cumulative log-decay passes about -88; here each pair takes its own
// exponential, C^2 D / 2 of them per chunk.
//
// Head dims 64 and 128. Layout: one block of 256 threads per
// (batch * head, 64 value columns): the state's value columns split across
// blocks (D = 128 takes two), each block keeping its [D, 64] slice of S in
// shared memory for the whole sequence and recomputing A, which needs all
// D key channels. r, k and
// q_inc are held transposed ([D][C], so a thread reads four time steps as
// one float4), v and A^T row-major. A thread owns a 4 x 4 tile of A, a
// 4 x 4 tile of o, and a D/16-row by 4-column tile of S.
//
// What bounds it on this card: at the prefill shape [4, 40, 4096, 64] the
// call must move 0.84 GB (0.25 ms at 3.35 TB/s), while the recurrence
// needs 5 D^2 + 5 D flops a step, 1.36e10 (0.20 ms at 67 TFLOP/s fp32):
// bytes bound it. This chunked form does more, 1.76e10 flops and 1.3e9
// exponentials (0.36 ms at the 16 a clock per SM of the special-function
// units); this first version, one block walking its 64 chunks in sequence
// with six barriers each, runs fp32 FMAs and __expf on the CUDA cores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block, a 16 x 16 grid
constexpr int C = 64;            // time steps per chunk
constexpr int CP = C + 4;        // padded row stride of a [.][C] tile
constexpr int DV = 64;           // value columns per block
constexpr int VP = DV + 4;       // padded row stride of a [.][DV] tile
constexpr int VC = DV / 16;      // o and S columns per thread

template <int D>
struct Tiles {
  static constexpr int KR = D / 16;            // S rows per thread
  // shared memory, in floats: S [D][VP], r^T, k^T, q_inc^T [D][CP],
  // v [C][VP], A^T [C][CP], u [D]
  static constexpr int S_OFF = 0;
  static constexpr int R_OFF = S_OFF + D * VP;
  static constexpr int K_OFF = R_OFF + D * CP;
  static constexpr int Q_OFF = K_OFF + D * CP;
  static constexpr int V_OFF = Q_OFF + D * CP;
  static constexpr int A_OFF = V_OFF + C * VP;
  static constexpr int U_OFF = A_OFF + C * CP;
  static constexpr int FLOATS = U_OFF + D;
};

// Four consecutive floats from shared memory, 16-byte aligned.
__device__ __forceinline__ void lds4(float (&dst)[4], const float* src) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
wkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, const float* __restrict__ s0,
         float* __restrict__ o, float* __restrict__ s_out, int t_len,
         int heads) {
  using G = Tiles<D>;
  extern __shared__ __align__(16) float smem[];
  float* S = smem + G::S_OFF;
  float* rT = smem + G::R_OFF;
  float* kT = smem + G::K_OFF;
  float* qT = smem + G::Q_OFF;
  float* vS = smem + G::V_OFF;
  float* AT = smem + G::A_OFF;
  float* uS = smem + G::U_OFF;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x, v0 = blockIdx.y * DV;
  const size_t base = (size_t)bh * t_len * D;
  const size_t sbase = (size_t)bh * D * D;
  const int t_lo = 4 * ty;       // this thread's rows of A and o

  for (int e = tid; e < D * DV; e += NT) {
    const int kk = e / DV, j = e % DV;
    S[kk * VP + j] = s0[sbase + (size_t)kk * D + v0 + j];
  }
  for (int e = tid; e < D; e += NT) uS[e] = u[(size_t)(bh % heads) * D + e];

  for (int t0 = 0; t0 < t_len; t0 += C) {
    const int n = min(C, t_len - t0);
    // (a) the chunk's tiles; consecutive threads read consecutive
    // channels. Steps >= n are zero (log w = 0).
    for (int e = tid; e < C * D; e += NT) {
      const int t = e / D, d = e % D;
      const bool in = t < n;
      const size_t g = base + (size_t)(t0 + t) * D + d;
      rT[d * CP + t] = in ? r[g] : 0.f;
      kT[d * CP + t] = in ? k[g] : 0.f;
      qT[d * CP + t] = in ? logf(fmaxf(w[g], 1e-12f)) : 0.f;
    }
    for (int e = tid; e < C * DV; e += NT) {
      const int t = e / DV, j = e % DV;
      vS[t * VP + j] =
          t < n ? v[base + (size_t)(t0 + t) * D + v0 + j] : 0.f;
    }
    __syncthreads();

    // (b) q_inc: prefix sums of log w along the chunk, one channel a
    // thread (steps >= n repeat the last, so every exponent stays <= 0)
    if (tid < D) {
      float acc = 0.f;
      float* q = qT + tid * CP;
      for (int t = 0; t < C; ++t) {
        acc += q[t];
        q[t] = acc;
      }
    }
    __syncthreads();

    // (c) A, lower triangle and diagonal, stored transposed: A^T[s][t]
    const int s_lo = 4 * tx;
    if (tx <= ty && t_lo < n) {
      float a[4][4] = {};
      const bool diag = tx == ty;
      for (int d = 0; d < D; ++d) {
        const float* qd = qT + d * CP;
        float rt[4], ks[4], qi[4], qe[4];
        lds4(rt, rT + d * CP + t_lo);
        lds4(ks, kT + d * CP + s_lo);
        lds4(qi, qd + s_lo);
        qe[0] = t_lo ? qd[t_lo - 1] : 0.f;
        qe[1] = qd[t_lo];
        qe[2] = qd[t_lo + 1];
        qe[3] = qd[t_lo + 2];
        if (!diag) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              a[i][j] += rt[i] * ks[j] * __expf(qe[i] - qi[j]);
        } else {
          const float ud = uS[d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j < i) a[i][j] += rt[i] * ks[j] * __expf(qe[i] - qi[j]);
              else if (j == i) a[i][j] += rt[i] * ud * ks[j];
            }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(AT + (s_lo + j) * CP + t_lo) =
            make_float4(a[0][j], a[1][j], a[2][j], a[3][j]);
    }
    __syncthreads();

    // (d) in place: r <- r exp(q_exc), k <- k exp(q_inc_last - q_inc)
    for (int e = tid; e < D * n; e += NT) {
      const int d = e / n, t = e % n;
      const float* qd = qT + d * CP;
      rT[d * CP + t] *= __expf(t ? qd[t - 1] : 0.f);
      kT[d * CP + t] *= __expf(qd[n - 1] - qd[t]);
    }
    __syncthreads();

    // (e) o rows [t_lo, t_lo + 4), columns v0 + tx * VC + [0, VC)
    if (t_lo < n) {
      float acc[4][VC] = {};
      for (int kk = 0; kk < D; ++kk) {
        float rd[4], sv[VC];
        lds4(rd, rT + kk * CP + t_lo);
        lds4(sv, S + kk * VP + tx * VC);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < VC; ++j) acc[i][j] += rd[i] * sv[j];
      }
      const int s_end = min(n, t_lo + 4);
      for (int s = 0; s < s_end; ++s) {
        float a[4], vv[VC];
        lds4(a, AT + s * CP + t_lo);
        lds4(vv, vS + s * VP + tx * VC);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < VC; ++j) acc[i][j] += a[i] * vv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (t_lo + i >= n) break;
        float* dst = o + base + (size_t)(t0 + t_lo + i) * D + v0 + tx * VC;
#pragma unroll
        for (int j = 0; j < VC; ++j) dst[j] = acc[i][j];
      }
    }
    __syncthreads();              // S is read above and written below

    // (f) S rows ty * KR + [0, KR), the same columns as o
    {
      float acc[G::KR][VC];
#pragma unroll
      for (int i = 0; i < G::KR; ++i) {
        const int kk = ty * G::KR + i;
        const float decay = __expf(qT[kk * CP + n - 1]);
        float sv[VC];
        lds4(sv, S + kk * VP + tx * VC);
#pragma unroll
        for (int j = 0; j < VC; ++j) acc[i][j] = decay * sv[j];
      }
      for (int s = 0; s < n; ++s) {
        float vv[VC];
        lds4(vv, vS + s * VP + tx * VC);
#pragma unroll
        for (int i = 0; i < G::KR; ++i) {
          const float kd = kT[(ty * G::KR + i) * CP + s];
#pragma unroll
          for (int j = 0; j < VC; ++j) acc[i][j] += kd * vv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < G::KR; ++i)
#pragma unroll
        for (int j = 0; j < VC; ++j)
          S[(ty * G::KR + i) * VP + tx * VC + j] = acc[i][j];
    }
    __syncthreads();              // before the next chunk's tiles
  }

  for (int e = tid; e < D * DV; e += NT) {
    const int kk = e / DV, j = e % DV;
    s_out[sbase + (size_t)kk * D + v0 + j] = S[kk * VP + j];
  }
}

// Opt the kernel into more than 48 KB of dynamic shared memory (once per
// kernel instantiation) and launch it.
template <auto Kernel, typename... Args>
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

constexpr int UNSUPPORTED = -1;

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers of
// contiguous fp32 tensors: r, k, v, w, o [BH, T, D], u [heads, D], s0 and
// s_out [BH, D, D], where BH = batch * heads, head-major within a batch row.
// Returns the launch's cudaError_t, or -1 for a head dim without an
// instantiation.
extern "C" {

int rwkv6_chunk_fwd(const float* r, const float* k, const float* v,
                    const float* w, const float* u, const float* s0,
                    float* o, float* s_out, int bh, int heads, int t_len,
                    int d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define WKV(D)                                                            \
  return launch<wkv6_fwd<D>>(Tiles<D>::FLOATS,                            \
                dim3(bh, D / DV), st, r, k, v, w, u, s0, o,               \
                s_out, t_len, heads)
  switch (d) {
    case 64: WKV(64);
    case 128: WKV(128);
    default: return UNSUPPORTED;
  }
#undef WKV
}

}  // extern "C"
