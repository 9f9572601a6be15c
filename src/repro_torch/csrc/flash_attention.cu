// Causal flash-attention forward (online softmax), optional sliding window.
//
//   o[b, q] = sum_k softmax_k(s[b, q, k]) v[b, k],
//   s[b, q, k] = (q[b, q] . k[b, k]) / sqrt(d)  for k <= q (and q - k < window),
//                -1e30 otherwise.
//
// Replaces the Pallas kernel _flash_kernel of
// src/repro/kernels/flash_attention.py (launched by flash_attention_pallas):
// (BH, S, d) layout, heads flattened into the batch by the caller, f32
// running max m, sum l and accumulator per query row, p rounded to the
// input type before the p.V product, and the final divide by max(l, 1e-30).
//
// The Pallas grid walks (bh, q-block, kv-block) in order on one core and
// keeps m, l and acc in VMEM scratch across the kv blocks.  Here one CTA
// owns one (bh, 64-query tile) and loops over the 64-key tiles itself, so
// the state stays in registers: 256 threads as 16 x 16, each thread holds
// a 4 x 4 block of scores (rows ty*4.., keys tx*4..) and 4 rows x DV/16
// columns of the accumulator.  Q (transposed), K (transposed), V and the
// tile's P live in shared memory as f32, padded so that the float4 reads
// of the inner loops are conflict-free.  The 16 threads of a row are 16
// lanes of one warp, so the row max and row sum are 4 shuffles each.
// Key tiles wholly above the diagonal, or wholly outside the window, are
// skipped; the q tiles with the most key tiles are scheduled first.  Any
// S works: keys and queries past S are masked and never stored.
//
// Bound on the H100: at the serve path's (BH = 56, S = 1024, d = 64) bf16
// the work is 2 * BH * S^2 * d flops (causal half of QK^T and PV) against
// ~29 MB of traffic, so the tensor-core bound is operations.  This kernel
// runs on the CUDA cores in f32 (no mma/wgmma, no TMA yet), so it sits
// far above that bound; the shared-memory reads per FMA (0.5 in QK^T,
// 0.5 in PV) set its pace.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 256;
constexpr int LQ = BQ + 4;   // padded row of the transposed Q and of P
constexpr int LK = BK + 4;   // padded row of the transposed K
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ float max16(float v) {
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float sum16(float v) {
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__host__ __device__ constexpr size_t smem_floats(int d, int dv) {
  return (size_t)d * LQ + (size_t)d * LK + (size_t)BK * dv + (size_t)BK * LQ;
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int s,
                     int window, float scale) {
  // columns of the accumulator per thread: DV/16, as float4 groups of
  // 64 columns apart when DV >= 64, else one run of DV/16
  constexpr int CPT = DV / 16;
  constexpr int VEC = CPT >= 4 ? 4 : CPT;
  constexpr int NG = CPT / VEC;
  constexpr int GSTRIDE = 16 * VEC;

  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // [D][LQ]   Q tile, transposed
  float* kt = qt + D * LQ;      // [D][LK]   K tile, transposed
  float* vs = kt + D * LK;      // [BK][DV]  V tile
  float* pt = vs + BK * DV;     // [BK][LQ]  P tile, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n_qt = (s + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BQ;  // heaviest tiles first
  const size_t bh = blockIdx.x;
  const T* qb = q + bh * s * D;
  const T* kb = k + bh * s * D;
  const T* vb = v + bh * s * DV;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, row = q0 + r;
    qt[c * LQ + r] = row < s ? to_f(qb[(size_t)row * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, s) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t = k_begin / BK; t <= q_last / BK; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D, key = k0 + r;
      kt[c * LK + r] = key < s ? to_f(kb[(size_t)key * D + c]) : 0.f;
    }
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int r = i / DV, c = i % DV, key = k0 + r;
      vs[r * DV + c] = key < s ? to_f(vb[(size_t)key * DV + c]) : 0.f;
    }
    __syncthreads();

    // ---- scores: 4 rows x 4 keys per thread ----
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(&qt[c * LQ + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&kt[c * LK + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // ---- online softmax over this tile ----
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[4];
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        ok[j] = kp <= qp && kp < s && (window <= 0 || qp - kp < window);
        sc[i][j] = ok[j] ? sc[i][j] * scale : NEG_INF;
        rmax = fmaxf(rmax, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(rmax));
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        rsum += e;
        p[i][j] = to_f(from_f<T>(e));  // p in the input type for p.V
      }
      l[i] = l[i] * alpha + sum16(rsum);
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[(tx * 4 + j) * LQ + ty * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // ---- acc += P V over the tile's keys ----
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(&pt[kk * LQ + ty * 4]);
      const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
      float vv[CPT];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float* src = &vs[kk * DV + g * GSTRIDE + tx * VEC];
        if constexpr (VEC == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          vv[g * 4 + 0] = x.x;
          vv[g * 4 + 1] = x.y;
          vv[g * 4 + 2] = x.z;
          vv[g * 4 + 3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) vv[g * VEC + e] = src[e];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }

  T* ob = o + bh * s * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        ob[(size_t)row * DV + g * GSTRIDE + tx * VEC + e] =
            from_f<T>(acc[i][g * VEC + e] / den);
  }
}

template <typename T, int D, int DV>
int launch_t(const void* q, const void* k, const void* v, void* o,
             int64_t bh, int64_t s, int64_t window, cudaStream_t stream) {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_floats(D, DV) * sizeof(float);
  if (dev < 64 && !ready[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const dim3 grid((unsigned)bh, (unsigned)((s + BQ - 1) / BQ));
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_kernel<T, D, DV><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (int)s,
      window > 0 ? (int)window : -1, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dv(const void* q, const void* k, const void* v, void* o,
              int64_t bh, int64_t s, int64_t dv, int64_t window,
              cudaStream_t st) {
  switch (dv) {
    case 32: return launch_t<T, D, 32>(q, k, v, o, bh, s, window, st);
    case 64: return launch_t<T, D, 64>(q, k, v, o, bh, s, window, st);
    case 128: return launch_t<T, D, 128>(q, k, v, o, bh, s, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             int64_t bh, int64_t s, int64_t d, int64_t dv, int64_t window,
             cudaStream_t st) {
  switch (d) {
    case 32: return launch_dv<T, 32>(q, k, v, o, bh, s, dv, window, st);
    case 64: return launch_dv<T, 64>(q, k, v, o, bh, s, dv, window, st);
    case 128: return launch_dv<T, 128>(q, k, v, o, bh, s, dv, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k: (bh, s, d); v: (bh, s, dv); o: (bh, s, dv), all contiguous, of
// one type (dtype 0: float32, 1: bfloat16).  window <= 0: none.
// Returns cudaGetLastError() (or the error of the attribute call).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t bh,
                                      int64_t s, int64_t d, int64_t dv,
                                      int64_t window, int64_t dtype,
                                      void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(q, k, v, o, bh, s, d, dv, window, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, bh, s, d, dv, window, st);
  return (int)cudaErrorInvalidValue;
}
