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
// The Pallas grid walks (bh, q-block, kv-block) in order on one core and
// keeps m, l and acc in VMEM scratch across the kv blocks; here one CTA
// owns a query tile and loops over the key tiles itself, keeping the state
// in registers.  Any S works: keys and queries past S are masked and never
// stored.  Key tiles wholly above the diagonal, or wholly outside the
// window, are skipped, and the q tiles with the most key tiles run first.
//
// Two routes, chosen by dtype in flash_attention_launch:
//
// * bfloat16: the tensor-core kernel (namespace tc).  At the serve path's
//   (BH = 56, S = 1024, d = 64) the call moves 29 MB (q, k, v read once,
//   o written once: 0.0088 ms at 3.35 TB/s) and does 7.5 GFLOP on the
//   causal half (QK^T and PV: 0.0076 ms at 989 TFLOP/s bf16), so bytes
//   and operations bound it about equally.  What costs time above that
//   is keeping the tensor cores fed while each 128 x 128 score tile goes
//   through the softmax on the CUDA cores (max, exp, sum, rounding:
//   hundreds of instructions a thread per tile, about as long as the
//   CTA's ~1000 tensor-core cycles of products for it).  So:
//   - one CTA takes 128 query rows: one producer warp and two consumer
//     warpgroups of 64 rows.  The producer loads Q once and keeps a ring
//     of 128-key K/V stages (up to four, as shared memory allows) in
//     flight with TMA (cp.async.bulk.tensor, 128- or 64-byte swizzle,
//     rows past S zero-filled), signalled by full/empty mbarriers;
//   - S = Q K^T is wgmma m64n128k16 with both operands in shared memory;
//     O += P V is wgmma with P in registers (rounded to bf16, the A
//     fragments of the accumulator's own layout) and V read MN-major;
//   - only tiles that cross the diagonal, the window edge or S are
//     masked, from each row's first and last key (two compares a score);
//     the online softmax runs on the accumulator fragments (a row lives
//     in one quad: two shuffles; exp2 with scale * log2(e) folded in; l
//     sums the unrounded exponentials);
//   - at dv <= 64 each warpgroup issues S_i with P_{i-1} V_{i-1} and runs
//     the softmax of tile i while that product is on the tensor cores,
//     and the two warpgroups take turns to issue (named barriers), so
//     one's softmax overlaps the other's products.  At dv = 128 the
//     accumulator, S and P together exceed the 168 registers a thread
//     has, so the products are issued one after the other;
//   - the epilogue scales by 1 / max(l, 1e-30) (one division a row),
//     rounds to bf16 into shared memory in TMA's swizzled layout and
//     writes each warpgroup's rows with one bulk tensor store (rows past
//     S are dropped).
// * float32: the CUDA-core kernel (first namespace below, unchanged from
//   the first port): 64 x 64 tiles in f32 shared memory, 256 threads, FMA
//   on the CUDA cores.  It stays for float32 because a TF32 tensor-core
//   product keeps ~3 decimal digits, and the float32 smoke configs hold
//   the card's logits to the CPU's within ~1e-6.  It is a documented
//   dtype route, not a fallback: a bfloat16 call of a supported shape
//   always takes the tensor-core kernel, and nothing retries on failure.
//
// The tensor maps are encoded on the host in flash_attention_launch with
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint (the
// library links no libcuda), and passed by value as __grid_constant__
// parameters, so a CUDA-graph capture records them with the launch.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------
//
// One CTA owns one (bh, 64-query tile) and loops over the 64-key tiles:
// 256 threads as 16 x 16, each thread holds a 4 x 4 block of scores (rows
// ty*4.., keys tx*4..) and 4 rows x DV/16 columns of the accumulator.  Q
// (transposed), K (transposed), V and the tile's P live in shared memory
// as f32, padded so that the float4 reads of the inner loops are
// conflict-free.  The 16 threads of a row are 16 lanes of one warp, so
// the row max and row sum are 4 shuffles each.

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
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel (wgmma + TMA)
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int BQ = 128;                  // query rows per CTA, 64 per warpgroup
constexpr int BK = 128;                  // keys per K/V tile
constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int MAX_STAGES = 4;            // K/V ring depth, as shared memory allows
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// An operand tile [rows][width] bf16 is stored as width / CW chunks of
// [rows][CW], CW = 64 columns (128-byte rows, 128-byte swizzle) or, at
// width 32, 32 columns (64-byte rows, 64-byte swizzle), as TMA writes them.
__host__ __device__ constexpr int chunk_cols(int width) {
  return width >= 64 ? 64 : width;
}

// Shared memory: Q, the O staging tile, the K/V ring, the mbarriers.
template <int D, int DV>
struct Layout {
  static constexpr int CQ = chunk_cols(D), CV = chunk_cols(DV);
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int O_BYTES = BQ * DV * 2;
  static constexpr int K_BYTES = BK * D * 2;
  static constexpr int V_BYTES = BK * DV * 2;
  // 232448 bytes: the most dynamic shared memory a CTA may have on
  // sm_90; 1024 of alignment slack and room for the barriers
  static constexpr int FIT =
      (232448 - Q_BYTES - O_BYTES - 1024 - 8 * 64) / (K_BYTES + V_BYTES);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int O_OFF = Q_BYTES;  // every offset a multiple of 1024
  static constexpr int K_OFF = O_OFF + O_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_BYTES;
  // barriers: q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

// K-major operand [rows][width] in chunks of `cols`: the 16 columns of
// k-step kk.  Within a chunk the swizzle is applied to the absolute
// address, so a k-step is a 32-byte advance of the start address.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kk,
                                                int rows, int cols) {
  const int chunk = kk * 16 / cols, within = kk * 16 % cols;
  return make_desc(base + chunk * rows * cols * 2 + within * 2, 16,
                   8 * cols * 2, cols * 2);
}
// MN-major operand [keys][width] (V: keys are the k dimension): keys
// 16kk..16kk+15, 8-key groups 8 rows apart (SBO), column chunks a chunk
// apart (LBO).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int kk,
                                                 int rows, int cols) {
  return make_desc(base + kk * 16 * cols * 2, rows * cols * 2, 8 * cols * 2,
                   cols * 2);
}

// d[0..64) (+)= A(64x16, smem desc) . B(128x16, smem desc)^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..16) += A(64x16, registers) . B(16x32, smem desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..32) += A(64x16, registers) . B(16x64, smem desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..64) += A(64x16, registers) . B(16x128, smem desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DV>
__device__ __forceinline__ void wgmma_rs(float (&d)[DV / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DV == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (DV == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t sq,
                                        uint32_t sk) {
  constexpr int CQ = chunk_cols(D);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128(sc, kmajor_desc(sq, kk, BQ, CQ), kmajor_desc(sk, kk, BK, CQ),
                  kk > 0);
}

template <int DV>
__device__ __forceinline__ void issue_pv(float (&acc)[DV / 2],
                                        const uint32_t (&pa)[BK / 4],
                                        uint32_t sv) {
  constexpr int CV = chunk_cols(DV);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                           pa[4 * kk + 3]};
    wgmma_rs<DV>(acc, a, mnmajor_desc(sv, kk, BK, CV));
  }
}

// The softmax of one 128-key tile, in two passes.  The first masks (only
// a tile that crosses the diagonal, the window edge or s), finds the new
// row max, and overwrites the scores with exp(s - m), adding them
// unrounded to l.  The second rounds them to bf16 as the A fragments of
// P V (register i holds columns 2i, 2i + 1 of the thread's fragment) and
// rescales the accumulator by alpha = exp(m_old - m_new).  Fragment
// element 4j + 2h + c is row row0 + 8h, key k0 + col0 + 8j + c.
__device__ __forceinline__ void softmax_exp(float (&sc)[BK / 2],
                                            float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], int k0,
                                            int r_wg, int row0, int col0,
                                            int s, int window,
                                            float scale_log2) {
  if (k0 + BK - 1 > r_wg || k0 + BK > s ||
      (window > 0 && r_wg + 63 - k0 >= window)) {
    // row r keeps keys max(0, r - window + 1) .. min(r, s - 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const int hi = min(row, s - 1) - k0 - col0;
      const int lo = (window > 0 ? row - window + 1 : 0) - k0 - col0;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (8 * j + c > hi || 8 * j + c < lo)
            sc[4 * j + 2 * h + c] = -INFINITY;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float part[BK / 8];  // the row max as a tree, not a chain
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      part[j] = fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) part[j] = fmaxf(part[j], part[j + 8]);
#pragma unroll
    for (int j = 0; j < 4; ++j) part[j] = fmaxf(part[j], part[j + 4]);
    float mx = fmaxf(m[h], fmaxf(fmaxf(part[0], part[2]),
                                 fmaxf(part[1], part[3])));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));  // a row lives in a quad
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    alpha[h] = exp2_approx((m[h] - mx) * scale_log2);
    m[h] = mx;
    const float mc = mx * scale_log2;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};  // this thread's columns; the
#pragma unroll                            // quad's sums add at the end
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = sc[4 * j + 2 * h + c];
        x = exp2_approx(fmaf(x, scale_log2, -mc));
        sum[(2 * j + c) & 3] += x;
      }
    l[h] = l[h] * alpha[h] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
  }
}

template <int DV>
__device__ __forceinline__ void pack_rescale(const float (&sc)[BK / 2],
                                             float (&acc)[DV / 2],
                                             uint32_t (&pa)[BK / 4],
                                             const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    acc[4 * j + 0] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to, int s, int window,
                 float scale_log2) {
  using L = Layout<D, DV>;
  constexpr int CQ = L::CQ, CV = L::CV, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int n_qt = (s + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BQ;  // heaviest tiles first
  const int bh = blockIdx.x;
  const int t_first = (window > 0 ? max(0, q0 - window + 1) : 0) / BK;
  const int n_tiles = (min(q0 + BQ, s) - 1) / BK - t_first + 1;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      bar_init(k_full + i, 1);
      bar_init(v_full + i, 1);
      bar_init(empty + i, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread issues
    if (threadIdx.x == CONSUMERS) {
      bar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < D / CQ; ++c)
        tma_load(smem + c * BQ * CQ * 2, &tq, q_full, c * CQ, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES, k0 = (t_first + i) * BK;
        bar_wait(empty + st, ((i / STAGES) & 1) ^ 1);
        bar_expect_tx(k_full + st, L::K_BYTES);
        for (int c = 0; c < D / CQ; ++c)
          tma_load(smem + L::K_OFF + st * L::K_BYTES + c * BK * CQ * 2, &tk,
                   k_full + st, c * CQ, k0, bh);
        bar_expect_tx(v_full + st, L::V_BYTES);
        for (int c = 0; c < DV / CV; ++c)
          tma_load(smem + L::V_OFF + st * L::V_BYTES + c * BK * CV * 2, &tv,
                   v_full + st, c * CV, k0, bh);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows r_wg .. r_wg + 63 ----
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r_wg = q0 + wg * 64;
  // accumulator fragments: this thread holds rows row0 and row0 + 8 and,
  // in every 8-column block j, columns 8j + col0 and 8j + col0 + 1
  const int row0 = r_wg + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const uint32_t sq = smem_u32(smem) + wg * 64 * CQ * 2;
  const uint32_t sk0 = smem_u32(smem + L::K_OFF);
  const uint32_t sv0 = smem_u32(smem + L::V_OFF);

  float acc[DV / 2], sc[BK / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float alpha[2];
  uint32_t pa[BK / 4];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  bar_wait(q_full, 0);
  __syncwarp();  // reconverge before the warpgroup-wide instructions

  if constexpr (DV <= 64) {
    // Overlapped: S_i = Q K_i^T and P_{i-1} V_{i-1} are issued together,
    // and the softmax of tile i runs while P_{i-1} V_{i-1} is on the
    // tensor cores.  Named barriers 1 and 2 hand the turn to issue between
    // the warpgroups, so that one's softmax overlaps the other's products
    // (each warpgroup takes n_tiles turns and passes each on, but for
    // warpgroup 1's last; warpgroup 1 passes first, so 0 starts).
    const auto turn_wait = [&] {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
    };
    const auto turn_pass = [&] {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
    };
    if (wg == 1) turn_pass();
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
    bar_wait(k_full, 0);
    __syncwarp();
    turn_wait();
    pin(sc);
    wg_fence();
    issue_qk<D>(sc, sq, sk0);
    wg_commit();
    if (wg == 0 || n_tiles > 1) turn_pass();
    wg_wait_all();
    pin(sc);
    softmax_exp(sc, m, l, alpha, t_first * BK, r_wg, row0, col0, s, window,
                scale_log2);
    pack_rescale<DV>(sc, acc, pa, alpha);
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % STAGES, prev = (i - 1) % STAGES;
      bar_wait(k_full + st, (i / STAGES) & 1);
      bar_wait(v_full + prev, ((i - 1) / STAGES) & 1);
      __syncwarp();
      turn_wait();
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      pin(sc);
      pin(acc);
      pin(pa);
      wg_fence();
      issue_qk<D>(sc, sq, sk0 + st * L::K_BYTES);
      wg_commit();
      issue_pv<DV>(acc, pa, sv0 + prev * L::V_BYTES);
      wg_commit();
      if (wg == 0 || i + 1 < n_tiles) turn_pass();
      wg_wait_one();  // S_i is in; P_{i-1} V_{i-1} may still run
      pin(sc);
      softmax_exp(sc, m, l, alpha, (t_first + i) * BK, r_wg, row0, col0, s,
                  window, scale_log2);
      wg_wait_all();
      pin(acc);
      pin(pa);
      bar_arrive(empty + prev);  // stage i-1's K and V are consumed
      pack_rescale<DV>(sc, acc, pa, alpha);
    }
    const int last = (n_tiles - 1) % STAGES;
    bar_wait(v_full + last, ((n_tiles - 1) / STAGES) & 1);
    __syncwarp();
    pin(acc);
    pin(pa);
    wg_fence();
    issue_pv<DV>(acc, pa, sv0 + last * L::V_BYTES);
    wg_commit();
    wg_wait_all();
    pin(acc);
    pin(pa);
    bar_arrive(empty + last);
  } else {
    // Serial: at DV 128 the accumulator, S and P of the overlapped
    // schedule do not fit in the 168 registers a thread has here.
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      bar_wait(k_full + st, parity);
      __syncwarp();
      pin(sc);
      wg_fence();
      issue_qk<D>(sc, sq, sk0 + st * L::K_BYTES);
      wg_commit();
      wg_wait_all();
      pin(sc);
      softmax_exp(sc, m, l, alpha, (t_first + i) * BK, r_wg, row0, col0, s,
                  window, scale_log2);
      pack_rescale<DV>(sc, acc, pa, alpha);
      bar_wait(v_full + st, parity);
      __syncwarp();
      pin(acc);
      pin(pa);
      wg_fence();
      issue_pv<DV>(acc, pa, sv0 + st * L::V_BYTES);
      wg_commit();
      wg_wait_all();
      pin(acc);
      pin(pa);
      bar_arrive(empty + st);  // this stage's K and V are consumed
    }
  }

  // ---- epilogue: o = acc / max(l, 1e-30), bf16, into shared memory in
  // the layout (and swizzle) TMA reads, then one bulk store per column
  // chunk; TMA drops the rows past s ----
  uint8_t* so = smem + L::O_OFF;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int r = row0 + 8 * h - q0;  // row within the CTA's tile
    const int swz = CV == 64 ? (r & 7) : ((r >> 1) & 3);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int chunk = 8 * j / CV, group = (8 * j % CV) / 8;
      *reinterpret_cast<uint32_t*>(so + chunk * BQ * CV * 2 + r * CV * 2 +
                                   (group ^ swz) * 16 + col0 * 2) =
          pack_bf16(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
  if ((threadIdx.x & 127) == 0) {
    for (int c = 0; c < DV / CV; ++c)
      tma_store(&to, so + c * BQ * CV * 2 + wg * 64 * CV * 2, c * CV, r_wg,
                bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// The (bh, s, cols) bf16 tensor at ptr, in boxes of `rows` x one swizzle
// chunk; rows past s read as zeros and are not written.
int encode(CUtensorMap* map, const void* ptr, int cols, int64_t s,
           int64_t bh, int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int cw = chunk_cols(cols);
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)s,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)s * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cw, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, int DV>
int launch_t(const void* q, const void* k, const void* v, void* o,
             int64_t bh, int64_t s, int64_t window, cudaStream_t stream) {
  using L = Layout<D, DV>;
  CUtensorMap tq, tk, tv, to;
  int err = encode(&tq, q, D, s, bh, BQ);
  if (err == 0) err = encode(&tk, k, D, s, bh, BK);
  if (err == 0) err = encode(&tv, v, DV, s, bh, BK);
  if (err == 0) err = encode(&to, o, DV, s, bh, 64);
  if (err != 0) return err;
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && !ready[dev]) {
    e = cudaFuncSetAttribute(flash_fwd_tc<D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  const dim3 grid((unsigned)bh, (unsigned)((s + BQ - 1) / BQ));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  // a window of at least s masks nothing
  const int win = window > 0 && window < s ? (int)window : -1;
  flash_fwd_tc<D, DV><<<grid, THREADS, L::SMEM, stream>>>(
      tq, tk, tv, to, (int)s, win, scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dv(const void* q, const void* k, const void* v, void* o,
              int64_t bh, int64_t s, int64_t dv, int64_t window,
              cudaStream_t st) {
  switch (dv) {
    case 32: return launch_t<D, 32>(q, k, v, o, bh, s, window, st);
    case 64: return launch_t<D, 64>(q, k, v, o, bh, s, window, st);
    case 128: return launch_t<D, 128>(q, k, v, o, bh, s, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_d(const void* q, const void* k, const void* v, void* o,
             int64_t bh, int64_t s, int64_t d, int64_t dv, int64_t window,
             cudaStream_t st) {
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;  // TMA reads 16-byte aligned
  switch (d) {
    case 32: return launch_dv<32>(q, k, v, o, bh, s, dv, window, st);
    case 64: return launch_dv<64>(q, k, v, o, bh, s, dv, window, st);
    case 128: return launch_dv<128>(q, k, v, o, bh, s, dv, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int D>
int64_t layout_dv(int64_t dv, int64_t* stages) {
  switch (dv) {
    case 32: *stages = Layout<D, 32>::STAGES; return Layout<D, 32>::SMEM;
    case 64: *stages = Layout<D, 64>::STAGES; return Layout<D, 64>::SMEM;
    case 128: *stages = Layout<D, 128>::STAGES; return Layout<D, 128>::SMEM;
  }
  return 0;
}

}  // namespace tc
}  // namespace

// The bfloat16 kernel's dynamic shared memory per CTA at (d, dv), in
// bytes, and its K/V ring depth in *stages (0: not a supported pair).
extern "C" int64_t flash_attention_layout(int64_t d, int64_t dv,
                                          int64_t* stages) {
  *stages = 0;
  switch (d) {
    case 32: return tc::layout_dv<32>(dv, stages);
    case 64: return tc::layout_dv<64>(dv, stages);
    case 128: return tc::layout_dv<128>(dv, stages);
  }
  return 0;
}

// q, k: (bh, s, d); v: (bh, s, dv); o: (bh, s, dv), all contiguous, of
// one type (dtype 0: float32 on the CUDA cores, 1: bfloat16 on the tensor
// cores).  window <= 0: none.  Returns cudaGetLastError() (or the error of
// the attribute call, of the tensor-map encoding, or of a misaligned
// bfloat16 operand).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t bh,
                                      int64_t s, int64_t d, int64_t dv,
                                      int64_t window, int64_t dtype,
                                      void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(q, k, v, o, bh, s, d, dv, window, st);
  if (dtype == 1) return tc::launch_d(q, k, v, o, bh, s, d, dv, window, st);
  return (int)cudaErrorInvalidValue;
}
