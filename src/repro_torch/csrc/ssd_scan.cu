// Mamba2 SSD chunked scan (state-space duality), float32 in and out, on
// Hopper's tensor cores.
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
// (launched by ssd_scan_pallas, line 66), whose grid walks (bh, chunk) in
// order on one core and carries the (N, P) state in VMEM scratch from one
// chunk to the next.  B and C are read through a head-to-group index (row
// bh reads row bh / heads_per_group), never repeated to every head.
// Optionally the state starts from `init` and the state after the last
// chunk is written to `final_state` (null: zeros / not written).
//
// Bound on the H100 at the serve path's (BH 128, S 1024, P 64, N 128,
// chunk 256, 32 heads per group): 10.76 GFLOP in the causal half, done as
// three TF32 products each (below): 32.3 GFLOP at 495 TFLOP/s = 0.065 ms;
// 76 MB of traffic (x and y 33.5 MB each, B and C 2.1 MB each, dA, the
// final state) at 3.35 TB/s = 0.023 ms.  So operations bound it.  The
// CUDA-core kernel this replaces was bound at 0.161 ms (float32 FMA at
// 67 TFLOP/s) and took 0.726.
// At zamba2-2.7b's prefill (BH 320, S 1024, P 64, N 64, chunk 256, 80
// heads a group): 16.1 GFLOP, 48.4 as 3xTF32, 0.098 ms; 176 MB, 0.053
// ms.  A third of those operations is C . B^T, which every head of a
// group recomputes.
//
// What the design does about it:
//
// * Precision: 3xTF32.  A single TF32 product keeps ~3 decimal digits and
//   misses the reference's tolerance (atol 2e-4 + rtol 1e-3) by ~25x at
//   the serve shape.  Each operand a is split into big = a, which the
//   tensor core reads truncated to TF32, and small = a - trunc(a), which
//   is exact in float32; big.big + big.small + small.big go into the
//   same float32 accumulators (wgmma m64nNk8 .tf32, A from registers).
// * Parallel chunks.  Three launches on the caller's stream:
//   (a) chunk_states, one CTA per (row, chunk): the chunk's own end state
//       E_c = (B o exp(seg_last - seg))^T x, written with exp(seg_last)
//       to a scratch the wrapper allocates, (BH, S / L, P, N) + (BH, S / L);
//   (b) state_pass, per row and 32 x 32 state elements: S_c = exp(seg_last)
//       S_{c-1} + E_c, leaving in the scratch the state that enters each
//       chunk and writing final_state (a few steps per row: negligible);
//   (c) chunk_scan, one CTA per (row, chunk, 128-query tile), heaviest
//       tiles first, two warpgroups of 64 query rows: y = exp(seg)
//       (C . S_prev) + sum over the 64-key tiles at or below the diagonal
//       of (C . B^T o decay) . x, masked before the exp (above the
//       diagonal the exponent is positive).
//   At the serve shape that is 512 (row, chunk) units and 1024 query
//   tiles where the CUDA-core kernel had 128 rows.
// * Layouts.  TF32 wgmma reads its shared-memory operand K-major only.
//   C and B lie K-major (state contiguous) and are loaded as they are;
//   the state pass writes S_prev transposed, (P, N); x is loaded as it
//   lies, (keys, P), and transposed in shared memory into x^T (P, keys)
//   while its small part is split off.  The A operands (C, the decayed
//   scores P, (B o w)^T) sit in registers.  A TF32 A fragment holds
//   columns t and t + 4 of each 8, the score accumulator columns 2t and
//   2t + 1, so x^T stores the keys of each group of 8 in the order
//   0 2 4 6 1 3 5 7 and P goes from accumulator to A fragment in place.
// * Loads by TMA (128-byte swizzle, rows past S zero-filled, columns past
//   P or N zero-filled) into a ring of two B/x stages signalled by
//   mbarriers; C and S_prev once per CTA.  Thread 0 issues them: the
//   first two stages at the start, each later one as soon as every warp
//   is past the tile that held its stage (a barrier the CTA passes
//   anyway).  A separate producer warp would make the CTA 288 threads,
//   which ptxas caps at 168 registers a thread, and at that cap it
//   serialises the wgmma (C7511).
// * Overlap: the splitting and transposing of key tile i + 1 runs on the
//   CUDA cores while tile i's products run on the tensor cores (x^T
//   during C . B^T, B small during P . x), into a second x^T buffer.
//   Shared memory per CTA of chunk_scan at P 64, N 128: C 64 KB (held in
//   registers once read; the odd tiles' x^T then takes its place), S_prev
//   big and small 64 KB (then B small and the even tiles' x^T), the ring
//   2 x 48 KB: 226 KB of the 227.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int T = 64;          // rows of a query tile, keys of a key tile
constexpr int MAX_CHUNK = 256;
constexpr int STAGES = 2;      // depth of the B/x ring
constexpr unsigned FULL = 0xffffffffu;

constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int NC>
__device__ __forceinline__ void consumer_sync() {  // the consumers only
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// seg[i] = scale (a[0] + ... + a[i]) for i < chunk, by the NC consumer
// threads.
template <int NC>
__device__ void chunk_cumsum(const float* a, int chunk, float scale,
                             float* seg, float* warp_sum, int tid) {
  constexpr int E = MAX_CHUNK / NC;
  float v[E], run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = tid * E + e;
    run += i < chunk ? a[i] : 0.f;
    v[e] = run;
  }
  const int lane = tid & 31;
  float x = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += u;
  }
  if (lane == 31) warp_sum[tid >> 5] = x;
  consumer_sync<NC>();
  float off = x - run;
  for (int w = 0; w < (tid >> 5); ++w) off += warp_sum[w];
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (tid * E + e < chunk) seg[tid * E + e] = (v[e] + off) * scale;
  consumer_sync<NC>();
}

// ---------------------------------------------------------------------------
// (a) chunk_states: E_c = (B o w)^T x per (row, chunk), w = exp(seg_last -
// seg); NWG warpgroups of 64 state rows each.
// ---------------------------------------------------------------------------

template <int PP, int NP>
struct LayoutA {
  static constexpr int NWG = NP > 64 ? NP / 64 : 1;
  static constexpr int NC = 128 * NWG;
  static constexpr int B_BYTES = T * NP * 4, X_BYTES = T * PP * 4;
  static constexpr int XT_BYTES = PP * T * 4;
  static constexpr int STAGE = B_BYTES + X_BYTES;
  // x^T of even and of odd key tiles, each big then small
  static constexpr int XT_OFF = STAGES * STAGE;
  static constexpr int SEG_OFF = XT_OFF + 4 * XT_BYTES;  // seg, w, sums
  static constexpr int BAR_OFF = SEG_OFF + (2 * MAX_CHUNK + 8) * 4;
  static constexpr int SMEM = BAR_OFF + 8 * STAGES + 1024;
};

template <int PP, int NP>
__global__ void __launch_bounds__(LayoutA<PP, NP>::NC, 1)
    chunk_states(const __grid_constant__ CUtensorMap tB,
                 const __grid_constant__ CUtensorMap tX,
                 const float* __restrict__ dA, float* __restrict__ states,
                 float* __restrict__ decay, int s, int chunk, int nc, int n,
                 int p, int heads_per_group) {
  using L = LayoutA<PP, NP>;
  constexpr int NC = L::NC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* seg = reinterpret_cast<float*>(smem + L::SEG_OFF);
  float* wl = seg + MAX_CHUNK;
  float* warp_sum = wl + MAX_CHUNK;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  const int tid = threadIdx.x;
  const int c = blockIdx.x, row = blockIdx.y, c0 = c * chunk;
  const int grp = row / heads_per_group;
  const int n_kt = (chunk + T - 1) / T;
  const auto stage_of = [&](int i) { return smem + (i % STAGES) * L::STAGE; };
  // thread 0 issues every load: B and x of key tile i into its stage
  const auto load_tile = [&](int i) {
    uint64_t* bar = full + i % STAGES;
    bar_expect_tx(bar, L::STAGE);
    for (int j = 0; j < NP / 32; ++j)
      tma_load(stage_of(i) + j * T * 128, &tB, bar, 32 * j, c0 + T * i, grp);
    for (int j = 0; j < PP / 32; ++j)
      tma_load(stage_of(i) + L::B_BYTES + j * T * 128, &tX, bar, 32 * j,
               c0 + T * i, row);
  };

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) bar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < STAGES && i < n_kt; ++i) load_tile(i);
  }
  __syncthreads();

  chunk_cumsum<NC>(dA + (size_t)row * s + c0, chunk, 1.f, seg, warp_sum,
                   tid);
  const float seg_last = seg[chunk - 1];
  for (int i = tid; i < n_kt * T; i += NC)
    wl[i] = i < chunk ? expf(seg_last - seg[i]) : 0.f;
  if (tid == 0) decay[(size_t)row * nc + c] = expf(seg_last);
  consumer_sync<NC>();

  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + g;  // state row
  float acc[PP / 2];
#pragma unroll
  for (int i = 0; i < PP / 2; ++i) acc[i] = 0.f;

  // tile i's x^T at xt_of(i); tile i + 1 is transposed while tile i's
  // products run
  const auto xt_of = [&](int i) {
    return smem + L::XT_OFF + (i & 1) * 2 * L::XT_BYTES;
  };
  const auto split_x = [&](int i) {
    transpose_split<PP, T, NC>(stage_of(i) + L::B_BYTES, xt_of(i),
                        xt_of(i) + L::XT_BYTES, tid);
  };
  bar_wait(full, 0);
  split_x(0);
  fence_async();
  consumer_sync<NC>();
  for (int i = 0; i < n_kt; ++i) {
    const uint8_t* stage = stage_of(i);
    // A = (B o w)^T: state rows n0, n0 + 8; keys 8j + 2t, 8j + 2t + 1 (the
    // x^T order)
    float a[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int key = 8 * j + 2 * t + cc;
        const float w = wl[T * i + key];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nn = n0 + 8 * h;
          a[j][2 * cc + h] =
              nn < NP ? *reinterpret_cast<const float*>(stage +
                                                        swz(key, nn, T)) * w
                      : 0.f;
        }
      }
    float al[8][4];
    split(a, al);
    const uint32_t xt = smem_u32(xt_of(i));
    wg_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma3(acc, a[j], al[j], kdesc(xt, j, PP), kdesc(xt + L::XT_BYTES, j, PP));
    wg_commit();
    if (i + 1 < n_kt) {
      bar_wait(full + (i + 1) % STAGES, ((i + 1) / STAGES) & 1);
      split_x(i + 1);
      fence_async();
    }
    wg_wait_all();
    pin(acc);
    pin(a);
    pin(al);
    consumer_sync<NC>();  // tile i is consumed by every warp
    if (tid == 0 && i + STAGES < n_kt) load_tile(i + STAGES);
  }

  // E_c into the scratch, (P, N) layout: element (n, p) of the fragment
  float* out = states + ((size_t)row * nc + c) * n * p;
#pragma unroll
  for (int j = 0; j < PP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int nn = n0 + 8 * h, pp = 8 * j + 2 * t + cc;
        if (nn < n && pp < p) out[pp * n + nn] = acc[4 * j + 2 * h + cc];
      }
}

// ---------------------------------------------------------------------------
// (b) state_pass: the state entering each chunk, per row and 32 x 32 state
// elements; init and final_state, (N, P), go through a shared-memory
// transpose so that both layouts are read and written 128 bytes a warp.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
    state_pass(float* __restrict__ states, const float* __restrict__ decay,
               const float* __restrict__ init, float* __restrict__ final_state,
               int nc, int n, int p) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = 32 * blockIdx.x, p0 = 32 * blockIdx.y;
  const size_t row = blockIdx.z, np = (size_t)n * p;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int nn = n0 + ty + 8 * i, pp = p0 + tx;
    tile[ty + 8 * i][tx] = init && nn < n && pp < p
                               ? init[row * np + (size_t)nn * p + pp] : 0.f;
  }
  __syncthreads();
  float st[4];  // elements (n0 + tx, p0 + ty + 8i)
#pragma unroll
  for (int i = 0; i < 4; ++i) st[i] = tile[tx][ty + 8 * i];
  const bool in_n = n0 + tx < n;
  float* sc = states + row * nc * np + n0 + tx;
  // four chunks at a time: their 16 loads are issued together
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float end[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pp = p0 + ty + 8 * i;
        end[k][i] = c0 + k < nc && in_n && pp < p
                        ? sc[(c0 + k) * np + (size_t)pp * n] : 0.f;
      }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k >= nc) break;
      const float d = decay[row * nc + c0 + k];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pp = p0 + ty + 8 * i;
        if (in_n && pp < p) sc[(c0 + k) * np + (size_t)pp * n] = st[i];
        st[i] = fmaf(d, st[i], end[k][i]);
      }
    }
  }
  if (final_state == nullptr) return;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) tile[tx][ty + 8 * i] = st[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int nn = n0 + ty + 8 * i, pp = p0 + tx;
    if (nn < n && pp < p)
      final_state[row * np + (size_t)nn * p + pp] = tile[ty + 8 * i][tx];
  }
}

// ---------------------------------------------------------------------------
// (c) chunk_scan: y for one (row, chunk, 128-query tile); two consumer
// warpgroups of 64 query rows, which share the splitting of every B and
// x tile.
// ---------------------------------------------------------------------------

constexpr int QT = 2 * T;  // query rows per CTA

template <int PP, int NP>
struct LayoutC {
  static constexpr int C_BYTES = QT * NP * 4, S_BYTES = PP * NP * 4;
  static constexpr int B_BYTES = T * NP * 4, X_BYTES = T * PP * 4;
  static constexpr int XT_BYTES = PP * T * 4;
  // region 0: C, then (C in registers) the x^T of the odd key tiles
  static constexpr int R0_BYTES =
      C_BYTES > 2 * XT_BYTES ? C_BYTES : 2 * XT_BYTES;
  // u: S_prev big and small, then B small and the even tiles' x^T
  static constexpr int U_BYTES = 2 * S_BYTES > B_BYTES + 2 * XT_BYTES
                                     ? 2 * S_BYTES
                                     : B_BYTES + 2 * XT_BYTES;
  static constexpr int U_OFF = R0_BYTES;
  static constexpr int STAGE = B_BYTES + X_BYTES;
  static constexpr int RING_OFF = U_OFF + U_BYTES;
  static constexpr int SEG_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int BAR_OFF = SEG_OFF + (MAX_CHUNK + 8) * 4;
  // barriers: c_full, s_full, full[STAGES]
  static constexpr int SMEM = BAR_OFF + 8 * (2 + STAGES) + 1024;
};

template <int PP, int NP>
__global__ void __launch_bounds__(256, 1)
    chunk_scan(const __grid_constant__ CUtensorMap tC,
               const __grid_constant__ CUtensorMap tB,
               const __grid_constant__ CUtensorMap tX,
               const __grid_constant__ CUtensorMap tS,
               const float* __restrict__ dA, float* __restrict__ y, int s,
               int chunk, int nc, int p, int heads_per_group,
               int zero_start) {
  using L = LayoutC<PP, NP>;
  constexpr int NC = 256;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* seg = reinterpret_cast<float*>(smem + L::SEG_OFF);
  float* warp_sum = seg + MAX_CHUNK;
  uint64_t* c_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* s_full = c_full + 1;
  uint64_t* full = c_full + 2;
  const int tid = threadIdx.x;
  const int c = blockIdx.x, row = blockIdx.y, c0 = c * chunk;
  const int grp = row / heads_per_group;
  const int q0 = (int)(gridDim.z - 1 - blockIdx.z) * QT;  // heaviest first
  const int n_kt = min(q0 / T + 2, (chunk + T - 1) / T);  // key tiles
  const bool inter = !(zero_start && c == 0);  // S_prev = 0: no C . S_prev

  uint8_t* u = smem + L::U_OFF;
  const auto stage_of = [&](int i) {
    return smem + L::RING_OFF + (i % STAGES) * L::STAGE;
  };
  // thread 0 issues every load: B and x of key tile i into its stage
  const auto load_tile = [&](int i) {
    uint64_t* bar = full + i % STAGES;
    bar_expect_tx(bar, L::STAGE);
    for (int j = 0; j < NP / 32; ++j)
      tma_load(stage_of(i) + j * T * 128, &tB, bar, 32 * j, c0 + T * i, grp);
    for (int j = 0; j < PP / 32; ++j)
      tma_load(stage_of(i) + L::B_BYTES + j * T * 128, &tX, bar, 32 * j,
               c0 + T * i, row);
  };
  if (tid == 0) {
    bar_init(c_full, 1);
    bar_init(s_full, 1);
    for (int i = 0; i < STAGES; ++i) bar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bar_expect_tx(c_full, L::C_BYTES);
    for (int j = 0; j < NP / 32; ++j)
      for (int h = 0; h < 2; ++h)
        tma_load(smem + j * QT * 128 + h * T * 128, &tC, c_full, 32 * j,
                 c0 + q0 + h * T, grp);
    if (inter) {
      bar_expect_tx(s_full, L::S_BYTES);
      for (int j = 0; j < NP / 32; ++j)
        tma_load(u + j * PP * 128, &tS, s_full, 32 * j, 0, row * nc + c);
    }
    for (int i = 0; i < STAGES && i < n_kt; ++i) load_tile(i);
  }
  __syncthreads();

  // seg in log2 units: every exponential below is one ex2
  chunk_cumsum<NC>(dA + (size_t)row * s + c0, chunk, LOG2E, seg, warp_sum,
                   tid);
  const int wg = tid >> 7, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * ((tid >> 5) & 3) + g;  // rows r0, r0 + 8
  const int l0 = q0 + r0;  // chunk-local query rows l0, l0 + 8

  // C's A fragments, all k-steps of the state, kept for the whole CTA
  bar_wait(c_full, 0);
  float cf[NP / 8][4];
#pragma unroll
  for (int kk = 0; kk < NP / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cf[kk][i] = *reinterpret_cast<const float*>(
          smem + swz(r0 + 8 * (i & 1), 8 * kk + t + 4 * (i >> 1), QT));

  const uint32_t u_addr = smem_u32(u);
  float acc[PP / 2];
#pragma unroll
  for (int i = 0; i < PP / 2; ++i) acc[i] = 0.f;

  // ---- inter: acc = exp(seg_l) C_l . S_prev ----
  if (inter) {
    bar_wait(s_full, 0);
    for (int i = tid; i < L::S_BYTES / 16; i += NC)
      reinterpret_cast<float4*>(u + L::S_BYTES)[i] =
          tf32_rest(reinterpret_cast<const float4*>(u)[i]);
    fence_async();
    consumer_sync<NC>();
    float cl[NP / 8][4];
    split(cf, cl);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 8; ++kk)
      mma3(acc, cf[kk], cl[kk], kdesc(u_addr, kk, PP),
           kdesc(u_addr + L::S_BYTES, kk, PP));
    wg_commit();
    wg_wait_all();
    pin(acc);
    pin(cf);
    pin(cl);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = l0 + 8 * h;
      const float e = l < chunk ? exp2_approx(seg[l]) : 0.f;
#pragma unroll
      for (int j = 0; j < PP / 8; ++j) {
        acc[4 * j + 2 * h] *= e;
        acc[4 * j + 2 * h + 1] *= e;
      }
    }
  }
  consumer_sync<NC>();  // C and S_prev are read: regions 0 and u are free

  // ---- intra: the key tiles at or below the diagonal.  The splitting
  // and transposing of tile i + 1 runs while tile i's products do: x^T
  // during C . B^T, B small during P . x ----
  uint8_t* b_small = u;
  const uint32_t bs_addr = u_addr;
  const auto xt_of = [&](int i) {  // x^T big, then small
    return (i & 1) ? smem : u + L::B_BYTES;
  };
  const auto split_b = [&](int i) {
    const float4* big = reinterpret_cast<const float4*>(stage_of(i));
    for (int j = tid; j < L::B_BYTES / 16; j += NC)
      reinterpret_cast<float4*>(b_small)[j] = tf32_rest(big[j]);
  };
  const auto split_x = [&](int i) {
    transpose_split<PP, T, NC>(stage_of(i) + L::B_BYTES, xt_of(i),
                        xt_of(i) + L::XT_BYTES, tid);
  };
  bar_wait(full, 0);
  split_b(0);
  split_x(0);
  fence_async();
  consumer_sync<NC>();
  for (int i = 0; i < n_kt; ++i) {
    const int k0 = T * i;
    const bool next = i + 1 < n_kt;
    // Both warpgroups take every tile: where a tile lies wholly above a
    // warpgroup's rows the mask zeroes it.  (Products under a condition
    // that differs between the warpgroups make ptxas serialise them.)
    float sc[T / 2];  // scores C . B^T: rows r0, r0 + 8; keys 8j + 2t + cc
#pragma unroll
    for (int j = 0; j < T / 2; ++j) sc[j] = 0.f;
    float cl[NP / 8][4];
    split(cf, cl);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 8; ++kk)
      mma3(sc, cf[kk], cl[kk], kdesc(smem_u32(stage_of(i)), kk, T),
           kdesc(bs_addr, kk, T));
    wg_commit();
    if (next) {
      bar_wait(full + (i + 1) % STAGES, ((i + 1) / STAGES) & 1);
      split_x(i + 1);
    }
    wg_wait_all();
    pin(sc);
    pin(cf);
    pin(cl);
    consumer_sync<NC>();  // every C . B^T is done: B small is free
    // B and x of tile i are consumed: its stage takes tile i + STAGES
    if (tid == 0 && i + STAGES < n_kt) load_tile(i + STAGES);

    // mask, then decay: the exponent is <= 0 wherever it is taken
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = l0 + 8 * h;
      const float sl = seg[l < chunk ? l : chunk - 1];
#pragma unroll
      for (int j = 0; j < T / 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int m = k0 + 8 * j + 2 * t + cc;
          float& v = sc[4 * j + 2 * h + cc];
          v = (m <= l && l < chunk) ? v * exp2_approx(sl - seg[m]) : 0.f;
        }
    }
    // ---- acc += P . x: P's A fragment is the accumulator's own
    // columns
    float pa[T / 8][4], pl[T / 8][4];
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
      pa[j][0] = sc[4 * j];
      pa[j][1] = sc[4 * j + 2];
      pa[j][2] = sc[4 * j + 1];
      pa[j][3] = sc[4 * j + 3];
    }
    split(pa, pl);
    const uint32_t xt = smem_u32(xt_of(i));
    wg_fence();
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
      mma3(acc, pa[j], pl[j], kdesc(xt, j, PP),
           kdesc(xt + L::XT_BYTES, j, PP));
    wg_commit();
    if (next) split_b(i + 1);
    fence_async();
    wg_wait_all();
    pin(acc);
    pin(pa);
    pin(pl);
    consumer_sync<NC>();  // x^T of tile i is free; tile i + 1 is split
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = l0 + 8 * h;
    if (l >= chunk) continue;
    float* yr = y + ((size_t)row * s + c0 + l) * p;
#pragma unroll
    for (int j = 0; j < PP / 8; ++j) {
      const int pp = 8 * j + 2 * t;
      if (pp < p)
        *reinterpret_cast<float2*>(yr + pp) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// The float32 tensor (d2, d1, d0) at ptr, in boxes of [rows][32] (128-byte
// swizzle); what lies past d0 or d1 reads as zeros.
int encode(CUtensorMap* map, const void* ptr, int64_t d0, int64_t d1,
           int64_t d2, int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 4,
                                 (cuuint64_t)d0 * d1 * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || ready[dev]) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) ready[dev] = true;
  return err;
}

template <int PP, int NP>
int launch_t(const void* x, const void* B, const void* C, const float* dA,
             const float* init, float* y, float* final_state, float* scratch,
             int64_t bh, int64_t s, int64_t p, int64_t n, int64_t chunk,
             int64_t hpg, cudaStream_t stream) {
  using LA = LayoutA<PP, NP>;
  using LC = LayoutC<PP, NP>;
  const int64_t nc = s / chunk, groups = bh / hpg;
  float* states = scratch;
  float* decay = scratch + bh * nc * n * p;
  CUtensorMap tC, tB, tX, tS;
  int err = encode(&tC, C, n, s, groups, T);
  if (err == 0) err = encode(&tB, B, n, s, groups, T);
  if (err == 0) err = encode(&tX, x, p, s, bh, T);
  if (err == 0) err = encode(&tS, states, n, p, bh * nc, PP);
  if (err != 0) return err;
  static bool ready_a[64] = {}, ready_c[64] = {};
  cudaError_t e = allow_smem(chunk_states<PP, NP>, LA::SMEM, ready_a);
  if (e == cudaSuccess)
    e = allow_smem(chunk_scan<PP, NP>, LC::SMEM, ready_c);
  if (e != cudaSuccess) return (int)e;

  chunk_states<PP, NP><<<dim3((unsigned)nc, (unsigned)bh), LA::NC,
                         LA::SMEM, stream>>>(
      tB, tX, dA, states, decay, (int)s, (int)chunk, (int)nc, (int)n,
      (int)p, (int)hpg);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  state_pass<<<dim3((unsigned)((n + 31) / 32), (unsigned)((p + 31) / 32),
                   (unsigned)bh),
               dim3(32, 8), 0, stream>>>(states, decay, init, final_state,
                                         (int)nc, (int)n, (int)p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  chunk_scan<PP, NP><<<dim3((unsigned)nc, (unsigned)bh,
                            (unsigned)((chunk + QT - 1) / QT)),
                       256, LC::SMEM, stream>>>(
      tC, tB, tX, tS, dA, y, (int)s, (int)chunk, (int)nc, (int)p, (int)hpg,
      init == nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory per CTA of chunk_scan and (in *states_smem) of
// chunk_states, in bytes, at (p, n); 0 if the pair is not supported.
extern "C" int64_t ssd_scan_layout(int64_t p, int64_t n,
                                   int64_t* states_smem) {
  *states_smem = 0;
#define SSD_LAYOUT(P_, N_, PP, NP)                                          \
  if (p == P_ && n == N_) {                                                 \
    *states_smem = LayoutA<PP, NP>::SMEM;                                   \
    return LayoutC<PP, NP>::SMEM;                                           \
  }
  SSD_LAYOUT(8, 4, 32, 32)
  SSD_LAYOUT(16, 8, 32, 32)
  SSD_LAYOUT(32, 16, 32, 32)
  SSD_LAYOUT(64, 32, 64, 32)
  SSD_LAYOUT(64, 64, 64, 64)
  SSD_LAYOUT(64, 128, 64, 128)
#undef SSD_LAYOUT
  return 0;
}

// x, y: (bh, s, p); B, C: (bh / heads_per_group, s, n); dA: (bh, s);
// init, final_state: (bh, n, p) or null; scratch: bh * (s / chunk) *
// (n * p + 1) floats; all float32 and contiguous, x, B, C and scratch
// 16-byte aligned.  s % chunk == 0, 1 <= chunk <= 256, (p, n) one of the
// pairs below.  Launches chunk_states, state_pass and chunk_scan on the
// stream.  Returns cudaGetLastError() (or the error of the attribute call
// or of the tensor-map encoding).
extern "C" int ssd_scan_launch(const void* x, const void* B, const void* C,
                               const void* dA, const void* init, void* y,
                               void* final_state, void* scratch, int64_t bh,
                               int64_t s, int64_t p, int64_t n, int64_t chunk,
                               int64_t heads_per_group, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  if (chunk < 1 || chunk > MAX_CHUNK || s % chunk != 0 ||
      heads_per_group < 1 || bh % heads_per_group != 0)
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)x | (uintptr_t)B | (uintptr_t)C | (uintptr_t)scratch) &
       15) != 0)
    return (int)cudaErrorMisalignedAddress;  // TMA reads 16-byte aligned
  cudaStream_t st = (cudaStream_t)stream;
  const float *af = (const float*)dA, *initf = (const float*)init;
  float *yf = (float*)y, *ff = (float*)final_state, *sf = (float*)scratch;
#define SSD_CASE(P_, N_, PP, NP)                                            \
  if (p == P_ && n == N_)                                                   \
    return launch_t<PP, NP>(x, B, C, af, initf, yf, ff, sf, bh, s, p, n,    \
                            chunk, heads_per_group, st);
  SSD_CASE(8, 4, 32, 32)
  SSD_CASE(16, 8, 32, 32)
  SSD_CASE(32, 16, 32, 32)
  SSD_CASE(64, 32, 64, 32)
  SSD_CASE(64, 64, 64, 64)
  SSD_CASE(64, 128, 64, 128)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}
