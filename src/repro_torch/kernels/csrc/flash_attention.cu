// Flash attention for Hopper (sm_90a): forward and backward, CUDA C++.
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention -> _kernel
// (the pallas_call at :76), which has no backward; the backward here is the
// flash-attention-2 split.
//
// Inputs are [BH, T, D] row-major (fp32 or bf16; the client, batch and head
// axes folded into BH by the wrapper, GQA's KV heads already repeated).
// Every kernel computes in fp32 from fp32 copies of its tiles in shared
// memory:
//   s = (q k^T) D^-1/2, optionally cap * tanh(s / cap);
//   causal mask q >= k and sliding window q - k < window, applied as
//   where(allow, s, -1e30) exactly as the reference does;
//   online softmax with fp32 (m, l, acc); out = acc / max(l, 1e-30) in the
//   input dtype, and the row log-sum-exp m + log(l) in fp32 for the backward.
// Backward: flash_bwd_dq computes delta = rowsum(dO * O) for its query rows
// (stored for flash_bwd_dkdv) and dQ, looping over key tiles; flash_bwd_dkdv
// computes dK and dV per key tile, looping over query tiles. No atomics: each
// output tile has one owner, so the result is deterministic.
//
// What bounds it: operations. At the LM's shape [144, 2048, 64] the forward
// is 7.7e10 flops against 7.5e7 bytes of inputs and outputs. This first
// version runs the products as fp32 FMAs on the CUDA cores (no tensor
// cores): 64-row tiles, 256 threads as a 16 x 16 grid, each thread a 4 x 4
// register micro-tile of the score tile and a 4 x (D/16) micro-tile of the
// output, operands read as float4 from shared memory laid out so the inner
// product's index runs along rows. Tiles that the causal mask or the window
// masks completely are skipped (a skipped tile adds exp(-1e30 - m) = 0 in the
// reference). A partially masked row gives exp(0) junk while its running max
// is still -1e30; the correction exp(-1e30 - m) = 0 of its first allowed key
// wipes it, as in the reference. Ragged T is handled by zero-filled loads
// and masking keys and rows >= T.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block, a 16 x 16 grid
constexpr int BT = 64;           // rows per tile (queries and keys alike)
constexpr int PT = BT + 4;       // padded row stride of a [BT][BT] tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N consecutive floats from shared memory (16-byte aligned for N % 4 == 0).
template <int N>
__device__ __forceinline__ void lds(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + i);
      dst[i] = t.x; dst[i + 1] = t.y; dst[i + 2] = t.z; dst[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

// Rows [row0, row0 + BT) of a [T, D] matrix into shared memory as fp32:
// row-major with stride D + 4 (`rm`) and/or transposed [D][BT] (`tr`).
// One 16-byte global load per thread and step; consecutive threads take
// consecutive rows, so the transposed stores hit consecutive banks. Rows
// >= T are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0,
                                          int t_len, float* rm, float* tr) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int GROUPS = D / VEC;
  for (int idx = threadIdx.x; idx < BT * GROUPS; idx += NT) {
    const int r = idx % BT, g = idx / BT, row = row0 + r;
    float vals[VEC];
    if (row < t_len) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (size_t)row * D + g * VEC);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) vals[j] = to_f(e[j]);
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
// stored k-major ([K][BT], the transposed tiles): a 4 x 4 micro-tile.
template <int K>
__device__ __forceinline__ void mm_kmajor(float (&acc)[4][4], const float* a,
                                          const float* b, int ra, int cb) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
    lds(av, a + k * BT + ra);
    lds(bv, b + k * BT + cb);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// acc[i][j] += sum_k P[ra + i][k] * X[k][cb + j] over the BT keys k: P a
// [BT][PT] row-major score tile, X a [BT][D + 4] row-major value tile.
template <int D, int DC>
__device__ __forceinline__ void mm_rows(float (&acc)[4][DC], const float* p,
                                        const float* x, int ra, int cb) {
#pragma unroll 2
  for (int k = 0; k < BT; k += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lds(pv[i], p + (ra + i) * PT + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float xv[DC];
      lds(xv, x + (k + kk) * (D + 4) + cb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
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
  // key tiles a query tile can see: [lo, hi]
  __device__ __forceinline__ int k_lo(int q0) const {
    return window > 0 ? max(0, q0 - window + 1) / BT : 0;
  }
  __device__ __forceinline__ int k_hi(int q0, int n_tiles) const {
    return causal ? min(n_tiles - 1, (q0 + BT - 1) / BT) : n_tiles - 1;
  }
  // query tiles a key tile is seen by: [lo, hi]
  __device__ __forceinline__ int q_lo(int k0) const {
    return causal ? k0 / BT : 0;
  }
  __device__ __forceinline__ int q_hi(int k0, int n_tiles) const {
    return window > 0 ? min(n_tiles - 1, (k0 + BT - 1 + window - 1) / BT)
                      : n_tiles - 1;
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
constexpr int fwd_smem_floats() { return 2 * D * BT + BT * (D + 4) + BT * PT; }

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          int t_len, Mask mask, float scale, float cap) {
  constexpr int DC = D / 16;
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
  const int ra = ty * 4, cb = tx * 4;
  const size_t base = (size_t)bh * t_len * D;

  load_tile<T, D>(q + base, q0, t_len, nullptr, qt);
  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }
  const int lo = mask.k_lo(q0), hi = mask.k_hi(q0, n_tiles);
  for (int ik = lo; ik <= hi; ++ik) {
    const int k0 = ik * BT;
    __syncthreads();
    load_tile<T, D>(k + base, k0, t_len, nullptr, kt);
    load_tile<T, D>(v + base, k0, t_len, vs, nullptr);
    __syncthreads();
    float s[4][4] = {};
    mm_kmajor<D>(s, qt, kt, ra, cb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float th, mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = score(s[i][j], scale, cap, &th);
        s[i][j] = mask.allow(q0 + ra + i, k0 + cb + j) ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max(mx));
      const float corr = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l_i[i] = l_i[i] * corr + row_sum(rs);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
      *reinterpret_cast<float4*>(ps + (ra + i) * PT + cb) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();
    mm_rows<D, DC>(acc, ps, vs, ra, tx * DC);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ra + i;
    if (r >= t_len) continue;
    const float den = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      o[base + (size_t)r * D + tx * DC + j] = from_f<T>(acc[i][j] / den);
    if (tx == 0) lse[(size_t)bh * t_len + r] = m_i[i] + logf(l_i[i]);
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 4 * D * BT + BT * (D + 4) + BT * PT + 2 * BT;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ delta, T* __restrict__ dq, int t_len,
             Mask mask, float scale, float cap) {
  constexpr int DC = D / 16;
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
  const int ra = ty * 4, cb = tx * 4;
  const size_t base = (size_t)bh * t_len * D;

  load_tile<T, D>(q + base, q0, t_len, nullptr, qt);
  load_tile<T, D>(dout + base, q0, t_len, nullptr, dot_);
  {  // delta = rowsum(dO * O): 4 threads per row
    const int r = threadIdx.x / 4, part = threadIdx.x % 4, row = q0 + r;
    float acc = 0.f;
    if (row < t_len) {
      for (int d = part * (D / 4); d < (part + 1) * (D / 4); ++d)
        acc += to_f(dout[base + (size_t)row * D + d]) *
               to_f(o[base + (size_t)row * D + d]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      dl_s[r] = acc;
      lse_s[r] = row < t_len ? lse[(size_t)bh * t_len + row] : 0.f;
      if (row < t_len) delta[(size_t)bh * t_len + row] = acc;
    }
  }
  float acc[4][DC] = {};
  const int lo = mask.k_lo(q0), hi = mask.k_hi(q0, n_tiles);
  for (int ik = lo; ik <= hi; ++ik) {
    const int k0 = ik * BT;
    __syncthreads();
    load_tile<T, D>(k + base, k0, t_len, ks, kt);
    load_tile<T, D>(v + base, k0, t_len, nullptr, vt);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_kmajor<D>(s, qt, kt, ra, cb);
    mm_kmajor<D>(dp, dot_, vt, ra, cb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ra + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float th;
        const float x = score(s[i][j], scale, cap, &th);
        float g = 0.f;
        if (mask.allow(q0 + r, k0 + cb + j)) {
          g = expf(x - lse_s[r]) * (dp[i][j] - dl_s[r]);
          if (cap > 0.f) g *= 1.f - th * th;
        }
        s[i][j] = g;
      }
      *reinterpret_cast<float4*>(ds + r * PT + cb) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();
    mm_rows<D, DC>(acc, ds, ks, ra, tx * DC);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ra + i;
    if (r >= t_len) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dq[base + (size_t)r * D + tx * DC + j] = from_f<T>(acc[i][j] * scale);
  }
}

template <int D>
constexpr int dkdv_smem_floats() {
  return 4 * D * BT + 2 * BT * (D + 4) + BT * PT + 2 * BT;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int t_len, Mask mask,
               float scale, float cap) {
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                  // [D][BT]
  float* vt = kt + D * BT;           // [D][BT]
  float* qt = vt + D * BT;           // [D][BT]
  float* dot_ = qt + D * BT;         // [D][BT]  dO transposed
  float* qs = dot_ + D * BT;         // [BT][D + 4]
  float* dos = qs + BT * (D + 4);    // [BT][D + 4]
  float* pt = dos + BT * (D + 4);    // [BT][PT]: P^T, then dS^T ([k][q])
  float* lse_s = pt + BT * PT;       // [BT]
  float* dl_s = lse_s + BT;          // [BT]
  const int bh = blockIdx.x;
  const int n_tiles = gridDim.y;
  const int ik = blockIdx.y;          // causal: low key tiles are heaviest
  const int k0 = ik * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ra = ty * 4, cb = tx * 4;   // ra: key rows, cb: query columns
  const size_t base = (size_t)bh * t_len * D;

  load_tile<T, D>(k + base, k0, t_len, nullptr, kt);
  load_tile<T, D>(v + base, k0, t_len, nullptr, vt);
  float acc_k[4][DC] = {}, acc_v[4][DC] = {};
  const int lo = mask.q_lo(k0), hi = mask.q_hi(k0, n_tiles);
  for (int iq = lo; iq <= hi; ++iq) {
    const int q0 = iq * BT;
    __syncthreads();
    load_tile<T, D>(q + base, q0, t_len, qs, qt);
    load_tile<T, D>(dout + base, q0, t_len, dos, dot_);
    if (threadIdx.x < BT) {
      const int row = q0 + threadIdx.x;
      const bool in = row < t_len;
      lse_s[threadIdx.x] = in ? lse[(size_t)bh * t_len + row] : 0.f;
      dl_s[threadIdx.x] = in ? delta[(size_t)bh * t_len + row] : 0.f;
    }
    __syncthreads();
    // transposed scores: st[i][j] for key ra + i, query cb + j
    float st[4][4] = {}, dpt[4][4] = {};
    mm_kmajor<D>(st, kt, qt, ra, cb);
    mm_kmajor<D>(dpt, vt, dot_, ra, cb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
      *reinterpret_cast<float4*>(pt + (ra + i) * PT + cb) =
          make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
    }
    __syncthreads();
    mm_rows<D, DC>(acc_v, pt, dos, ra, tx * DC);     // dV += P^T dO
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(pt + (ra + i) * PT + cb) =
          make_float4(dpt[i][0], dpt[i][1], dpt[i][2], dpt[i][3]);
    __syncthreads();
    mm_rows<D, DC>(acc_k, pt, qs, ra, tx * DC);      // dK += dS^T Q
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ra + i;
    if (r >= t_len) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      dk[base + (size_t)r * D + tx * DC + j] = from_f<T>(acc_k[i][j] * scale);
      dv[base + (size_t)r * D + tx * DC + j] = from_f<T>(acc_v[i][j]);
    }
  }
}

// Opt the kernel into more than 48 KB of dynamic shared memory (once per
// kernel instantiation) and launch it.
template <auto Kernel, typename... Args>
int launch(int floats, int bh, int t_len, cudaStream_t stream, Args... args) {
  static bool ready = false;
  const int bytes = floats * (int)sizeof(float);
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid(bh, (t_len + BT - 1) / BT);
  Kernel<<<grid, NT, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

constexpr int UNSUPPORTED = -1;

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers of
// contiguous [BH, T, D] tensors (lse and delta [BH, T] fp32); `bf16` selects
// bfloat16 over float32. Each returns the launch's cudaError_t, or -1 for a
// head dim without an instantiation.
extern "C" {

int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int t_len, int d, int bf16,
                        int causal, int window, float cap, void* stream) {
  const Mask mask{t_len, causal, window};
  const float scale = 1.f / sqrtf((float)d);
  cudaStream_t st = (cudaStream_t)stream;
#define FWD(T, D)                                                          \
  return launch<flash_fwd<T, D>>(fwd_smem_floats<D>(), bh, t_len, st,      \
                (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, t_len,  \
                mask, scale, cap)
#define BY_D(M, T)        \
  switch (d) {            \
    case 16: M(T, 16);    \
    case 32: M(T, 32);    \
    case 64: M(T, 64);    \
    case 128: M(T, 128);  \
    default: return UNSUPPORTED; \
  }
  if (bf16) { BY_D(FWD, __nv_bfloat16) } else { BY_D(FWD, float) }
#undef FWD
}

int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* delta, void* dq, int bh, int t_len, int d,
                           int bf16, int causal, int window, float cap,
                           void* stream) {
  const Mask mask{t_len, causal, window};
  const float scale = 1.f / sqrtf((float)d);
  cudaStream_t st = (cudaStream_t)stream;
#define DQ(T, D)                                                            \
  return launch<flash_bwd_dq<T, D>>(dq_smem_floats<D>(), bh, t_len, st,     \
                (const T*)q, (const T*)k, (const T*)v, (const T*)o,         \
                (const T*)dout, lse, delta, (T*)dq, t_len, mask, scale, cap)
  if (bf16) { BY_D(DQ, __nv_bfloat16) } else { BY_D(DQ, float) }
#undef DQ
}

int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int bh,
                             int t_len, int d, int bf16, int causal,
                             int window, float cap, void* stream) {
  const Mask mask{t_len, causal, window};
  const float scale = 1.f / sqrtf((float)d);
  cudaStream_t st = (cudaStream_t)stream;
#define DKDV(T, D)                                                            \
  return launch<flash_bwd_dkdv<T, D>>(dkdv_smem_floats<D>(), bh, t_len, st,   \
                (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,   \
                delta, (T*)dk, (T*)dv, t_len, mask, scale, cap)
  if (bf16) { BY_D(DKDV, __nv_bfloat16) } else { BY_D(DKDV, float) }
#undef DKDV
}

}  // extern "C"
