// Mamba2 SSD chunked scan (state-space duality), float32.
//
// Per row bh (batch and head flattened), state N, head dim P, chunk L:
//
//   intra:  y_l += sum_{m<=l} exp(seg_l - seg_m) (C_l . B_m) x_m
//   inter:  y_l += exp(seg_l) C_l . S_{c-1}
//   state:  S_c  = exp(seg_last) S_{c-1}
//                  + sum_m exp(seg_last - seg_m) B_m x_m^T
//
// with seg the inclusive cumsum of dA within the chunk and x = x * dt.
//
// Replaces the Pallas kernel _ssd_kernel of src/repro/kernels/ssd_scan.py
// (launched by ssd_scan_pallas), whose grid walks (bh, chunk) in order on
// one core and carries the (N, P) state in VMEM scratch from one chunk to
// the next.  Here one CTA owns one row bh and loops over its chunks
// itself, the float32 state in shared memory (32 KB at N = 128, P = 64).
// B and C are read through a head-to-group index (row bh reads row
// bh / heads_per_group), so the model's grouped B and C are never repeated
// to every head.  Optionally the state starts from `init` and is written,
// after the last chunk, to `final_state` (null: zeros / not written): the
// model's cache-building prefill hands it to decode.
//
// A chunk of 256 does not fit as one tile (its L x L scores alone would be
// 256 KB), so each chunk is cut into 64-row sub-tiles.  For every query
// sub-tile: y = exp(seg) * (C . S_prev), then for each key sub-tile at or
// below the diagonal the 64 x 64 scores C . B^T, masked before the exp
// (the exponent seg_l - seg_m is positive above the diagonal and could
// overflow), decayed and multiplied into x.  During the last query
// sub-tile, which visits every key sub-tile, each thread also accumulates
// its share of the chunk's state update in registers; the state is
// rewritten once every read of S_prev is done.  256 threads; the scores
// are 4 x 4 per thread (16 x 16 threads), y and the state are RM x RC and
// RN x RC per thread.  C and B sub-tiles are staged transposed and padded
// so that the inner loops read float4.
//
// Bound on the H100: at the serve path's (BH 128, S 1024, P 64, N 128,
// chunk 256) the work is 10.8 GFLOP in its causal half against 202 MB of
// traffic, so the bound is operations (0.161 ms at 67 TFLOP/s float32).
// This kernel runs on the CUDA cores (no mma/wgmma, no TMA): its inner
// loops do 8 to 16 FMAs per shared-memory load, and with one CTA per SM
// the global loads of each sub-tile are not overlapped with compute.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int T = 64;           // rows of a query or a key sub-tile
constexpr int LT = T + 4;       // padded row of the transposed C, B and P
constexpr int MAX_CHUNK = 256;
constexpr unsigned FULL = 0xffffffffu;

template <int P, int N>
struct Layout {
  // y (T x P) and the state (N x P): TC threads across the P columns,
  // RC columns each; TR thread rows, RM rows of y and RN of the state each
  static constexpr int TC = P < 16 ? P : 16;
  static constexpr int RC = P / TC;
  static constexpr int TR = THREADS / TC;
  static constexpr int RM = T / TR;
  static constexpr int RN = (N + TR - 1) / TR;
  static constexpr size_t smem_floats =
      (size_t)N * P + 2 * (size_t)N * LT + (size_t)T * P + (size_t)T * LT +
      3 * MAX_CHUNK;
};

template <int R>
__device__ __forceinline__ void load_row(const float* p, float (&v)[R]) {
  if constexpr (R == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (R == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = p[r];
  }
}

template <int P, int N>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ B,
                    const float* __restrict__ C, const float* __restrict__ dA,
                    const float* __restrict__ init, float* __restrict__ y,
                    float* __restrict__ final_state, int s, int chunk,
                    int heads_per_group) {
  using Lay = Layout<P, N>;
  constexpr int RM = Lay::RM, RC = Lay::RC, RN = Lay::RN, TR = Lay::TR;

  extern __shared__ __align__(16) float smem[];
  float* st = smem;             // [N][P]   the state entering the chunk
  float* ct = st + N * P;       // [N][LT]  C sub-tile, transposed
  float* bt = ct + N * LT;      // [N][LT]  B sub-tile, transposed
  float* xs = bt + N * LT;      // [T][P]   x sub-tile
  float* pt = xs + T * P;       // [T][LT]  decayed scores, [key][query]
  float* seg = pt + T * LT;     // [MAX_CHUNK] cumsum of dA in the chunk
  float* eseg = seg + MAX_CHUNK;  // exp(seg), 0 past the chunk
  float* wl = eseg + MAX_CHUNK;   // exp(seg_last - seg), 0 past the chunk
  __shared__ float warp_sum[THREADS / 32];

  const int tid = threadIdx.x;
  const int yr = tid / Lay::TC, yc = tid % Lay::TC;
  const int sr = tid >> 4, sc = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const size_t grow = row / heads_per_group;
  const float* xb = x + row * s * P;
  const float* Bb = B + grow * s * N;
  const float* Cb = C + grow * s * N;
  const float* ab = dA + row * s;
  float* yb = y + row * s * P;

  for (int i = tid; i < N * P; i += THREADS)
    st[i] = init ? init[row * N * P + i] : 0.f;

  const int n_sub = (chunk + T - 1) / T;
  for (int c0 = 0; c0 < s; c0 += chunk) {
    // ---- seg: block-wide inclusive cumsum of dA over the chunk ----
    __syncthreads();  // the previous chunk's seg, wl and state are done
    float v = tid < chunk ? ab[c0 + tid] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += warp_sum[w];
    if (tid < chunk) seg[tid] = v;
    __syncthreads();
    const float seg_last = seg[chunk - 1];
    eseg[tid] = tid < chunk ? expf(v) : 0.f;
    wl[tid] = tid < chunk ? expf(seg_last - v) : 0.f;

    float sacc[RN][RC];  // this thread's share of the chunk's state update
#pragma unroll
    for (int i = 0; i < RN; ++i)
#pragma unroll
      for (int c = 0; c < RC; ++c) sacc[i][c] = 0.f;

    for (int qi = 0; qi < n_sub; ++qi) {
      const int q0 = qi * T;
      __syncthreads();  // eseg and wl written; the last C tile consumed
      for (int i = tid; i < T * N; i += THREADS) {
        const int r = i / N, k = i % N, l = q0 + r;
        ct[k * LT + r] = l < chunk ? Cb[(size_t)(c0 + l) * N + k] : 0.f;
      }
      __syncthreads();

      // ---- inter: y = exp(seg_l) C_l . S_prev ----
      float acc[RM][RC];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < RC; ++c) acc[i][c] = 0.f;
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        float cv[RM], sv[RC];
        load_row<RM>(&ct[k * LT + yr * RM], cv);
        load_row<RC>(&st[k * P + yc * RC], sv);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int c = 0; c < RC; ++c)
            acc[i][c] = fmaf(cv[i], sv[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float e = eseg[q0 + yr * RM + i];
#pragma unroll
        for (int c = 0; c < RC; ++c) acc[i][c] *= e;
      }

      // ---- intra: the key sub-tiles at or below the diagonal ----
      for (int kj = 0; kj <= qi; ++kj) {
        const int k0 = kj * T;
        __syncthreads();  // the last B, x and P tiles consumed
        for (int i = tid; i < T * N; i += THREADS) {
          const int r = i / N, k = i % N, m = k0 + r;
          bt[k * LT + r] = m < chunk ? Bb[(size_t)(c0 + m) * N + k] : 0.f;
        }
        for (int i = tid; i < T * P; i += THREADS) {
          const int m = k0 + i / P;
          xs[i] = m < chunk ? xb[(size_t)c0 * P + (size_t)k0 * P + i] : 0.f;
        }
        __syncthreads();

        float sco[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sco[i][j] = 0.f;
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
          load_row<4>(&ct[k * LT + sr * 4], cv);
          load_row<4>(&bt[k * LT + sc * 4], bv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              sco[i][j] = fmaf(cv[i], bv[j], sco[i][j]);
        }
        // mask, then decay: the exponent is <= 0 wherever it is taken
        float pv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = q0 + sr * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int m = k0 + sc * 4 + j;
            pv[i][j] = (m <= l && l < chunk)
                           ? sco[i][j] * expf(seg[l] - seg[m]) : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(&pt[(sc * 4 + j) * LT + sr * 4]) =
              make_float4(pv[0][j], pv[1][j], pv[2][j], pv[3][j]);
        __syncthreads();

        // ---- y += P x ----
#pragma unroll 4
        for (int m = 0; m < T; ++m) {
          float p[RM], xv[RC];
          load_row<RM>(&pt[m * LT + yr * RM], p);
          load_row<RC>(&xs[m * P + yc * RC], xv);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int c = 0; c < RC; ++c)
              acc[i][c] = fmaf(p[i], xv[c], acc[i][c]);
        }

        // ---- the chunk's state update, while the last query tile
        // visits every key tile: rows n = yr + TR * i ----
        if (qi == n_sub - 1) {
#pragma unroll 2
          for (int m = 0; m < T; ++m) {
            const float w = wl[k0 + m];
            float xv[RC];
            load_row<RC>(&xs[m * P + yc * RC], xv);
#pragma unroll
            for (int i = 0; i < RN; ++i) {
              const int n = yr + TR * i;
              if (n < N) {
                const float b = bt[n * LT + m] * w;
#pragma unroll
                for (int c = 0; c < RC; ++c)
                  sacc[i][c] = fmaf(b, xv[c], sacc[i][c]);
              }
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int l = q0 + yr * RM + i;
        if (l >= chunk) continue;
#pragma unroll
        for (int c = 0; c < RC; ++c)
          yb[(size_t)(c0 + l) * P + yc * RC + c] = acc[i][c];
      }
    }

    // ---- S_c = exp(seg_last) S_{c-1} + update, once S_{c-1} is read ----
    __syncthreads();
    const float decay = expf(seg_last);
    const bool last_chunk = c0 + chunk >= s;
#pragma unroll
    for (int i = 0; i < RN; ++i) {
      const int n = yr + TR * i;
      if (n >= N) continue;
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const int e = n * P + yc * RC + c;
        const float next = fmaf(decay, st[e], sacc[i][c]);
        st[e] = next;
        if (last_chunk && final_state) final_state[row * N * P + e] = next;
      }
    }
  }
}

template <int P, int N>
int launch_t(const float* x, const float* B, const float* C, const float* dA,
             const float* init, float* y, float* final_state, int64_t bh,
             int64_t s, int64_t chunk, int64_t heads_per_group,
             cudaStream_t stream) {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = Layout<P, N>::smem_floats * sizeof(float);
  if (dev < 64 && !ready[dev]) {
    err = cudaFuncSetAttribute(ssd_scan_kernel<P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  ssd_scan_kernel<P, N><<<(unsigned)bh, THREADS, smem, stream>>>(
      x, B, C, dA, init, y, final_state, (int)s, (int)chunk,
      (int)heads_per_group);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (bh, s, p); B, C: (bh / heads_per_group, s, n); dA: (bh, s);
// init, final_state: (bh, n, p) or null; all float32 and contiguous.
// s % chunk == 0, 1 <= chunk <= 256, (p, n) one of the pairs below.
// Returns cudaGetLastError() (or the error of the attribute call).
extern "C" int ssd_scan_launch(const void* x, const void* B, const void* C,
                               const void* dA, const void* init, void* y,
                               void* final_state, int64_t bh, int64_t s,
                               int64_t p, int64_t n, int64_t chunk,
                               int64_t heads_per_group, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  if (chunk < 1 || chunk > MAX_CHUNK || s % chunk != 0 ||
      heads_per_group < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *xf = (const float*)x, *Bf = (const float*)B,
              *Cf = (const float*)C, *af = (const float*)dA,
              *initf = (const float*)init;
  float *yf = (float*)y, *ff = (float*)final_state;
#define SSD_CASE(PP, NN)                                                    \
  if (p == PP && n == NN)                                                   \
    return launch_t<PP, NN>(xf, Bf, Cf, af, initf, yf, ff, bh, s, chunk,      \
                            heads_per_group, st);
  SSD_CASE(8, 4)
  SSD_CASE(16, 8)
  SSD_CASE(32, 16)
  SSD_CASE(64, 32)
  SSD_CASE(64, 128)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}
