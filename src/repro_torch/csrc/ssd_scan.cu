// Mamba2 SSD chunked scan (state-space duality), float32 in and out, on
// Hopper's tensor cores.
//
// Per row bh (batch and head flattened), state N, head dim P, chunk L:
//
//   intra:  y_l += sum_{m<=l} exp(seg_l - seg_m) dt_m (C_l . B_m) x_m
//   inter:  y_l += exp(seg_l) C_l . S_{c-1}
//   state:  S_c  = exp(seg_last) S_{c-1}
//                  + sum_m exp(seg_last - seg_m) dt_m B_m x_m^T
//
// with seg the inclusive cumsum of dA = dt A_h within the chunk.  Two
// entry points: ssd_scan_heads_launch takes the models' layout, x (B, S,
// H, P), dt (B, S, H), A (H), B and C (B, S, G, N) with head h reading
// group h / (H / G), each in its own strides, and writes y (B, S, H, P)
// in place; dt is folded into the per-key scales (the decay of each key's
// score in chunk_scan, the state weight w in chunk_states), so no x * dt
// tensor exists, and dA = dt A_h is formed where the cumsum reads it (the
// float32 product torch forms).  Given dA (BH, S) and no dt, it scans x
// as it is (x = x * dt, the reference's contract): ssd_scan_launch's (BH,
// S, P) rows are the B = 1, H = BH case, bit for bit what they were.
//
// Replaces the Pallas kernel _ssd_kernel of src/repro/kernels/ssd_scan.py
// (launched by ssd_scan_pallas, its pl.pallas_call at line 77), whose grid
// walks (bh, chunk) in order on one core and carries the (N, P) state in
// VMEM scratch from one chunk to the next.  B and C are read through a
// head-to-group index, never repeated to every head.
// Optionally the state starts from `init` and the state after the last
// chunk is written to `final_state` (null: zeros / not written).
//
// Bounds on the H100 (3xTF32 products at 495 TFLOP/s, 3.35 TB/s), with
// C . B^T counted once a B/C group, as chip_smoke.py's ssd_flops does:
//   mamba2-370m's prefill (BH 128, S 1024, P 64, N 128, chunk 256, 32
//   heads a group): 6.59 GFLOP, 19.8 as 3xTF32: 0.0399 ms; 76 MB: 0.0227
//   ms.  zamba2-2.7b's (BH 320, S 1024, P 64, N 64, chunk 256, 80 heads a
//   group): 10.8 GFLOP, 32.5 as 3xTF32: 0.0656 ms; 176 MB: 0.0527 ms.
//   So operations bound both.  Measured on an NVIDIA H100 80GB HBM3 at
//   700 W (tools/ssd_ab.py): 0.141 ms at mamba2's call and 0.239 ms at
//   zamba2's, 28% and 27% of those bounds; chunk_scan's consumers spend a
//   third of their cycles on each query tile's own work (C . S_prev, the
//   pair's cumsum, y: tools/ssd_phases.py).  In the models' layout with
//   dt folded: 0.145 and 0.257 ms; on (B, H, S, P) storage 0.143 and
//   0.256, so the strided rows cost ~1% and dt's folding (its strided
//   reads and copy in chunk_states, its tile in chunk_scan's G stages)
//   3-5%, against the x-sized passes around the call that it removes
//   (~0.1 ms a call at mamba2, ~0.22 at zamba2).
//
// What the design does about it:
//
// * Precision: 3xTF32.  A single TF32 product keeps ~3 decimal digits and
//   misses the reference's tolerance (atol 2e-4 + rtol 1e-3) by ~25x at
//   the serve shape.  Each operand a is split into big = a, which the
//   tensor core reads truncated to TF32, and small = a - trunc(a), which
//   is exact in float32; big.big + big.small + small.big go into the
//   same float32 accumulators (wgmma m64nNk8 .tf32, A from registers).
// * Four launches on the caller's stream:
//   (0) chunk_scores, one CTA per (B/C group, chunk, causal 64 x 64 tile):
//       G = C . B^T into a scratch, each thread's 32 floats in the order
//       of the P . x product's A fragments, thread-contiguous.  B and C
//       are per group, so this is computed once for the group's heads:
//       at zamba2's 80 heads a group that is 20.1 GFLOP of 3xTF32 a
//       per-head kernel recomputes, at mamba2's 32 heads 16.1.  The 10
//       causal tiles of every (group row, chunk) at chunk 256 take 2.5
//       MiB at both serve shapes and stay in L2 for chunk_scan.  The
//       k-steps run in the per-head order, so a call with heads_per_group
//       h gives, bit for bit, the y and state of the call with B and C
//       repeated to every head and heads_per_group 1.  At heads_per_group
//       1 (the reference's shapes) the tiles are per row, 2.5x x's bytes:
//       those calls are small;
//   (a) chunk_states, one CTA per (row, chunk, 64 state rows): the chunk's
//       own end state E_c = (B o exp(seg_last - seg))^T x, written with
//       exp(seg_last) to the scratch, (BH, S / L, P, N) + (BH, S / L).  One
//       stage of B and x and one x^T buffer (x^T is its B operand: TF32
//       wgmma reads shared memory K-major only), the stage released once
//       read, so that the next tile's loads overlap this tile's products:
//       68 KB, three CTAs an SM.  At N 128 the state's two halves are two
//       CTAs side by side, which read x once from device memory and once
//       from L2.  Its loads hold it (taking its products or its transpose
//       out saves 11-14% each);
//   (b) state_pass, per row and 32 x 32 state elements: S_c = exp(seg_last)
//       S_{c-1} + E_c, leaving in the scratch the state that enters each
//       chunk and writing final_state (a few steps a row).  Folded into
//       chunk_states' last CTA of each row it saved 3% at zamba2's shape
//       and cost 7% at mamba2's (the row's tail runs after its chunks);
//   (c) chunk_scan: y of every (row, chunk) and query tile of 128 rows.
// * chunk_scan is persistent: one CTA an SM walks the (row, chunk) pairs,
//   each pair's query tiles heaviest first (the pair's key tiles then
//   come from L2 for its lighter tile).  Three warpgroups, 384 threads,
//   the register file split with setmaxnreg as flash_attention.cu's bf16
//   kernel does: two consumers of 64 query rows each and a producer: its
//   thread 0 keeps the TMA loads in flight (S_prev once a pair, 128-byte
//   swizzle; x tiles; the G tiles by bulk copy), its other three warps
//   split S_prev and transpose and split each x tile into x^T (the P . x
//   product's B operand, the keys of each 8 in the order 0 2 4 6 1 3 5 7
//   so that P goes from its G fragment to an A fragment in place).
//   mbarriers hand every buffer on: rings of two x stages, two to four G
//   stages (as shared memory allows) and two x^T buffers, each with a
//   full and an empty barrier; S_prev has its own region, so the next
//   pair's S_prev loads while this pair's last tiles run.  At (64, 128):
//   S_prev 64 KB, x^T 64 KB, x 32 KB, G 64 KB.  A consumer releases a G
//   stage only after the values it loaded from it are used: an arrive
//   right after the loads let the refill overwrite the stage before the
//   slower warpgroup's loads had read it.
// * A consumer: for each query tile, acc = exp(seg) (C . S_prev), C's A
//   fragments read from device memory (L2: C is per group), in parts of
//   32 state columns; then for each key tile at or below its rows: the G
//   tile's fragments from shared memory, masked before the exp (above the
//   diagonal the exponent is positive) and decayed, split, and acc += P .
//   x^T.  The next key tile's P is prepared while this one's product runs
//   (two register sets); the tile above warpgroup 0's rows is released
//   unread.
// * Registers: setmaxnreg gives the consumers 240 a thread and the
//   producer 24 (of 168 at launch, 65,536 / 384).  ptxas serialises every
//   wgmma of a kernel whose consumers it cannot fit (C7512, one wait a
//   wgmma): at 224 or 232 it did, and so it does when C's A fragments are
//   loaded whole or ahead of the key tiles (64 registers more).  The
//   producer warpgroup spills a few registers at 24 (ptxas: 72 B of
//   stores, 96 B with dt's loads and head coordinates).  After the
//   setmaxnreg.inc a wait that times out traps through an out-of-line
//   call (hopper.cuh's bar_wait<true>).
// * The models' layout: x, B and C through 4-D tensor maps in their own
//   strides, (P, S, H, B) and (N, S, G, B); row bh = b H + h reads group
//   (b, h / hpg), so no operand is copied into rows.  dt (B, S, H) is
//   read H floats apart once a (row, chunk) by chunk_states, into shared
//   memory beside seg; its CTAs of the first state rows copy it, chunk by
//   chunk and contiguous, into the scratch (dtT), where chunk_scan's
//   cumsum reads it and its loader brings each key tile's 64 values into
//   the G stage with the tile's scores.  y is stored at (b, t, h) in its
//   strides.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int T = 64;          // rows of a query tile, keys of a key tile
constexpr int MAX_CHUNK = 256;
constexpr int G_TILE = T * T * 4;  // bytes of one 64 x 64 score tile
constexpr unsigned FULL = 0xffffffffu;

constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// causal 64 x 64 tiles of a chunk of n_qt query tiles: (qi, ki), ki <= qi,
// at index qi (qi + 1) / 2 + ki
__host__ __device__ constexpr int causal_tiles(int n_qt) {
  return n_qt * (n_qt + 1) / 2;
}

// Where row bh = b H + h of the scan reads and writes, beside the tensor
// maps: the element strides (t, head or group, batch) of C, dt and y; the
// heads H of a batch row, of which hpg share a B/C group (head h reads
// group h / hpg); cp, the floats a chunk takes in dtT, chunk_states' copy
// of dt for chunk_scan ((row, chunk) blocks of 64-key tiles).
struct Geom {
  int64_t c_t, c_g, c_b, dt_t, dt_h, dt_b, y_t, y_h, y_b;
  int heads, hpg, cp;
};

template <int NC>
__device__ __forceinline__ void consumer_sync() {  // the consumers only
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// A wait without the timeout, for the producer warpgroup's few
// registers.  It cannot wait forever on its own: a consumer whose wait
// times out traps the grid.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
}

// seg[i] = scale (d[0] + ... + d[i]) for i < chunk, by the NC consumer
// threads, with d = a or, MUL, the product a * mul rounded on its own (no
// contraction into the sum: the dA = dt A of the reference).
template <int NC, bool MUL = false>
__device__ void chunk_cumsum(const float* a, int chunk, float mul,
                             float scale, float* seg, float* warp_sum,
                             int tid) {
  constexpr int E = MAX_CHUNK / NC;
  float v[E], run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = tid * E + e;
    run += i < chunk ? (MUL ? __fmul_rn(a[i], mul) : a[i]) : 0.f;
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
// (0) chunk_scores: G = C . B^T for one (group, chunk, causal tile), one
// warpgroup, in 3xTF32 with the k-steps in the per-head kernel's order.
// Group grp = b G + g of a batch row b's G groups.
// ---------------------------------------------------------------------------

template <int NP>
struct LayoutG {
  static constexpr int TILE_BYTES = T * NP * 4;  // 64 rows of C or of B
  static constexpr int BS_OFF = 2 * TILE_BYTES;  // B's small part
  static constexpr int BAR_OFF = 3 * TILE_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 + 1024;
};

template <int NP>
__global__ void __launch_bounds__(128)
    chunk_scores(const __grid_constant__ CUtensorMap tC,
                 const __grid_constant__ CUtensorMap tB,
                 float* __restrict__ scores, int chunk, int groups) {
  using L = LayoutG<NP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  const int tid = threadIdx.x, tile = blockIdx.x;
  const int c = blockIdx.y, grp = blockIdx.z, c0 = c * chunk;
  const int bi = grp / groups, gi = grp - bi * groups;
  int qi = 0;
  while (causal_tiles(qi + 1) <= tile) ++qi;
  const int ki = tile - causal_tiles(qi);
  if (tid == 0) {
    bar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bar_expect_tx(full, 2 * L::TILE_BYTES);
    for (int j = 0; j < NP / 32; ++j) {
      tma_load(smem + j * T * 128, &tC, full, 32 * j, c0 + T * qi, gi, bi);
      tma_load(smem + L::TILE_BYTES + j * T * 128, &tB, full, 32 * j,
               c0 + T * ki, gi, bi);
    }
  }
  __syncthreads();
  bar_wait(full, 0);
  const float4* b_big = reinterpret_cast<const float4*>(smem + L::TILE_BYTES);
  float4* b_small = reinterpret_cast<float4*>(smem + L::BS_OFF);
  for (int j = tid; j < L::TILE_BYTES / 16; j += 128)
    b_small[j] = tf32_rest(b_big[j]);
  fence_async();
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (tid >> 5) + g;
  float cf[NP / 8][4], cl[NP / 8][4];
#pragma unroll
  for (int kk = 0; kk < NP / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cf[kk][i] = *reinterpret_cast<const float*>(
          smem + swz(r0 + 8 * (i & 1), 8 * kk + t + 4 * (i >> 1), T));
  split(cf, cl);
  __syncthreads();  // B's small part is written
  float sc[T / 2];
#pragma unroll
  for (int j = 0; j < T / 2; ++j) sc[j] = 0.f;
  const uint32_t bb = smem_u32(smem + L::TILE_BYTES);
  const uint32_t bs = smem_u32(smem + L::BS_OFF);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NP / 8; ++kk)
    mma3(sc, cf[kk], cl[kk], kdesc(bb, kk, T), kdesc(bs, kk, T));
  wg_commit();
  wg_wait_all();
  pin(sc);
  pin(cf);
  pin(cl);
  // rows r0, r0 + 8; keys 8j + 2t + cc: as P's A fragment of k-step j,
  // (r0, 2t), (r0 + 8, 2t), (r0, 2t + 1), (r0 + 8, 2t + 1)
  float4* out = reinterpret_cast<float4*>(scores) +
                ((size_t)(grp * gridDim.y + c) * gridDim.x + tile) *
                    (T * T / 4);
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
    out[j * 128 + tid] =
        make_float4(sc[4 * j], sc[4 * j + 2], sc[4 * j + 1], sc[4 * j + 3]);
}

// ---------------------------------------------------------------------------
// (a) chunk_states: E_c = (B o w)^T x per (row, chunk, 64 state rows),
// w = exp(seg_last - seg) dt (without dt: exp(seg_last - seg)); one
// warpgroup.  With dt, the CTAs of the first 64 state rows also copy the
// chunk's dt to dtT.
// ---------------------------------------------------------------------------

template <int PP, int NP>
struct LayoutA {
  static constexpr int NH = NP < 64 ? NP : 64;  // state rows of a CTA
  static constexpr int B_BYTES = T * NH * 4, X_BYTES = T * PP * 4;
  static constexpr int XT_BYTES = PP * T * 4;
  static constexpr int STAGE = B_BYTES + X_BYTES;  // B, then x
  static constexpr int XT_OFF = STAGE;             // x^T big, then small
  static constexpr int SEG_OFF = XT_OFF + 2 * XT_BYTES;  // seg, w, sums
  static constexpr int BAR_OFF = SEG_OFF + (2 * MAX_CHUNK + 8) * 4;
  static constexpr int SMEM = BAR_OFF + 8 + 1024;
};

template <int PP, int NP>
__global__ void __launch_bounds__(128, 3)
    chunk_states(const __grid_constant__ CUtensorMap tB,
                 const __grid_constant__ CUtensorMap tX,
                 const float* __restrict__ dA, const float* __restrict__ dt,
                 const float* __restrict__ A, float* __restrict__ dtT,
                 float* __restrict__ states, float* __restrict__ decay, int s,
                 int chunk, int nc, int n, int p, const Geom geo) {
  using L = LayoutA<PP, NP>;
  constexpr int NC = 128, NH = L::NH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* seg = reinterpret_cast<float*>(smem + L::SEG_OFF);
  float* wl = seg + MAX_CHUNK;
  float* warp_sum = wl + MAX_CHUNK;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint8_t* xt = smem + L::XT_OFF;
  const int tid = threadIdx.x, half = blockIdx.x;
  const int c = blockIdx.y, row = blockIdx.z, c0 = c * chunk;
  const int bi = row / geo.heads, hi = row - bi * geo.heads;
  const int gi = hi / geo.hpg;
  const int n_kt = (chunk + T - 1) / T;
  // thread 0 issues every load: this CTA's state columns of B and x, key
  // tile i
  const auto load_tile = [&](int i) {
    bar_expect_tx(full, L::STAGE);
    for (int j = 0; j < NH / 32; ++j)
      tma_load(smem + j * T * 128, &tB, full, NH * half + 32 * j,
               c0 + T * i, gi, bi);
    for (int j = 0; j < PP / 32; ++j)
      tma_load(smem + L::B_BYTES + j * T * 128, &tX, full, 32 * j,
               c0 + T * i, hi, bi);
  };
  if (tid == 0) {
    bar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_tile(0);
  }
  __syncthreads();

  if (dt != nullptr) {  // the chunk's dt, staged in wl
    const float* dtr = dt + bi * geo.dt_b + hi * geo.dt_h + c0 * geo.dt_t;
    float* copy = dtT + ((size_t)row * nc + c) * geo.cp;
    for (int i = tid; i < chunk; i += NC) {
      const float v = dtr[i * geo.dt_t];
      wl[i] = v;
      if (half == 0) copy[i] = v;
    }
    consumer_sync<NC>();
    chunk_cumsum<NC, true>(wl, chunk, A[hi], 1.f, seg, warp_sum, tid);
  } else {
    chunk_cumsum<NC>(dA + (size_t)row * s + c0, chunk, 0.f, 1.f, seg,
                     warp_sum, tid);
  }
  const float seg_last = seg[chunk - 1];
  // each thread reads back only the dt it staged
  for (int i = tid; i < n_kt * T; i += NC)
    wl[i] = i >= chunk       ? 0.f
            : dt != nullptr ? expf(seg_last - seg[i]) * wl[i]
                            : expf(seg_last - seg[i]);
  if (tid == 0 && half == 0) decay[(size_t)row * nc + c] = expf(seg_last);
  consumer_sync<NC>();

  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = 16 * (tid >> 5) + g;  // state rows n0, n0 + 8 of the CTA's
  float acc[PP / 2];
#pragma unroll
  for (int i = 0; i < PP / 2; ++i) acc[i] = 0.f;
  const uint32_t xt_addr = smem_u32(xt);
  for (int i = 0; i < n_kt; ++i) {
    bar_wait(full, i & 1);
    transpose_split<PP, T, NC>(smem + L::B_BYTES, xt, xt + L::XT_BYTES, tid);
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
              nn < NH ? *reinterpret_cast<const float*>(smem +
                                                        swz(key, nn, T)) * w
                      : 0.f;
        }
      }
    float al[8][4];
    split(a, al);
    fence_async();
    __syncthreads();  // the stage is read and x^T written: load tile i + 1
    if (tid == 0 && i + 1 < n_kt) load_tile(i + 1);
    pin(acc);
    pin(a);
    pin(al);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma3(acc, a[j], al[j], kdesc(xt_addr, j, PP),
           kdesc(xt_addr + L::XT_BYTES, j, PP));
    wg_commit();
    wg_wait_all();
    pin(acc);
    pin(a);
    pin(al);
    __syncthreads();  // x^T is consumed
  }

  // E_c into the scratch, (P, N) layout: element (n, p) of the fragment
  float* out = states + ((size_t)row * nc + c) * n * p;
#pragma unroll
  for (int j = 0; j < PP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int nl = n0 + 8 * h, nn = NH * half + nl, pp = 8 * j + 2 * t + cc;
        if (nl < NH && nn < n && pp < p)
          out[pp * n + nn] = acc[4 * j + 2 * h + cc];
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
// (c) chunk_scan: y, persistent; two consumer warpgroups of 64 query rows
// and a producer warpgroup (a loading thread and three splitting warps).
// ---------------------------------------------------------------------------

constexpr int QT = 2 * T;  // query rows of a query tile (both consumers)
constexpr int SCAN_THREADS = 384;
constexpr int SPLITTERS = 96;  // the producer warpgroup's warps 1-3
// setmaxnreg's split of the CTA's registers: the 168 a thread that
// __launch_bounds__(SCAN_THREADS, 1) gives at launch; an increase takes
// only what a decrease gave
constexpr int ENTRY_REGS = 65536 / SCAN_THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <=
                  ENTRY_REGS * SCAN_THREADS,
              "the register split exceeds the CTA's registers");
constexpr int SMEM_MAX = 232448;  // a CTA's shared memory on the H100

template <int PP, int NP>
struct LayoutC {
  static constexpr int S_BYTES = PP * NP * 4;
  static constexpr int X_BYTES = T * PP * 4, XT_BYTES = PP * T * 4;
  static constexpr int XS = 2;  // x stages
  // S_prev big and small, two x^T buffers (big, small), the x ring, then
  // the G ring: as many stages (each both consumers' tiles, and the key
  // tile's dt, DT_BYTES) as fit, <= 4
  static constexpr int XT_OFF = 2 * S_BYTES;
  static constexpr int X_OFF = XT_OFF + 4 * XT_BYTES;
  static constexpr int G_OFF = X_OFF + XS * X_BYTES;
  static constexpr int DT_BYTES = T * 4;
  static constexpr int BARS = 160;  // room for N_BARS at 4 G stages
  static constexpr int TAIL = (MAX_CHUNK + 8) * 4 + BARS + 1024;
  static constexpr int GS_FIT =
      (SMEM_MAX - G_OFF - TAIL) / (2 * G_TILE + DT_BYTES);
  static constexpr int GS = GS_FIT > 4 ? 4 : GS_FIT;
  static_assert(GS >= 2, "no room for two G stages");
  static constexpr int DT_OFF = G_OFF + GS * 2 * G_TILE;
  static constexpr int SEG_OFF = DT_OFF + GS * DT_BYTES;
  static constexpr int BAR_OFF = SEG_OFF + (MAX_CHUNK + 8) * 4;
  // mbarriers
  static constexpr int S_FULL = 0, S_READY = 1, S_EMPTY = 2, X_FULL = 3;
  static constexpr int X_EMPTY = X_FULL + XS, G_FULL = X_EMPTY + XS;
  static constexpr int G_EMPTY = G_FULL + GS, XT_FULL = G_EMPTY + GS;
  static constexpr int XT_EMPTY = XT_FULL + 2, N_BARS = XT_EMPTY + 2;
  static_assert(8 * N_BARS <= BARS, "barriers");
  static constexpr int SMEM = BAR_OFF + BARS + 1024;
};

template <int B>
struct Buf {
  static constexpr int value = B;
};

// The loading thread: per (row, chunk) pair S_prev (unless it is zero),
// then per query tile, heaviest first, and key tile the x tile and the
// consumers' G tiles (a consumer's only if the key tile reaches its rows)
// with, DT, the key tile's dt from dtT, each into its ring stage once the
// stage's last tile is released.  A wait on an empty barrier's first
// phase (parity 1) passes.
template <int PP, int NP, bool DT>
__device__ __forceinline__ void scan_load(uint8_t* smem,
                                          const CUtensorMap* tX,
                                          const CUtensorMap* tS,
                                          const float* scores,
                                          const float* dtT, int chunk,
                                          int nc, int heads, int hpg, int cp,
                                          int units, int zero_start) {
  using L = LayoutC<PP, NP>;
  constexpr int XS = L::XS, GS = L::GS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  const int n_qt = (chunk + T - 1) / T, nz = (chunk + QT - 1) / QT;
  const int nt = causal_tiles(n_qt);
  uint32_t ks = 0;  // S_prev loads so far
  int k = 0;        // key tiles so far
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int row = u / nc, c = u % nc, c0 = c * chunk;
    const int bi = row / heads, hi = row - bi * heads;
    const float* g_tiles =
        scores + (size_t)((row / hpg) * nc + c) * nt * (T * T);
    if (!(zero_start && c == 0)) {
      wait_phase(bars + L::S_EMPTY, (ks & 1) ^ 1);
      bar_expect_tx(bars + L::S_FULL, L::S_BYTES);
      for (int j = 0; j < NP / 32; ++j)
        tma_load(smem + j * PP * 128, tS, bars + L::S_FULL, 32 * j, 0,
                 row * nc + c, 0);
      ++ks;
    }
    for (int z = nz - 1; z >= 0; --z) {
      const int q0 = z * QT, n_kt = min(q0 / T + 2, n_qt);
      for (int i = 0; i < n_kt; ++i, ++k) {
        const int xs = k % XS, gs = k % GS;
        wait_phase(bars + L::X_EMPTY + xs, ((k / XS) & 1) ^ 1);
        bar_expect_tx(bars + L::X_FULL + xs, L::X_BYTES);
        for (int j = 0; j < PP / 32; ++j)
          tma_load(smem + L::X_OFF + xs * L::X_BYTES + j * T * 128, tX,
                   bars + L::X_FULL + xs, 32 * j, c0 + T * i, hi, bi);
        wait_phase(bars + L::G_EMPTY + gs, ((k / GS) & 1) ^ 1);
        uint32_t bytes = DT ? L::DT_BYTES : 0;
        for (int w = 0; w < 2; ++w) {
          const int qi = q0 / T + w;
          if (qi < n_qt && i <= qi) bytes += G_TILE;
        }
        bar_expect_tx(bars + L::G_FULL + gs, bytes);
        for (int w = 0; w < 2; ++w) {
          const int qi = q0 / T + w;
          if (qi < n_qt && i <= qi)
            bulk_load(smem + L::G_OFF + (gs * 2 + w) * G_TILE,
                      g_tiles + (size_t)(causal_tiles(qi) + i) * (T * T),
                      G_TILE, bars + L::G_FULL + gs);
        }
        if (DT)
          bulk_load(smem + L::DT_OFF + gs * L::DT_BYTES,
                    dtT + (size_t)u * cp + T * i, L::DT_BYTES,
                    bars + L::G_FULL + gs);
      }
    }
  }
}

// The splitting warps (tid 0..95): per pair S_prev's small part, then
// every x tile in the loader's order into x^T buffer k % 2, big and small
// parts.  Each warp signals for itself (the barriers count 3).
template <int PP, int NP>
__device__ __forceinline__ void scan_split(uint8_t* smem, int chunk, int nc,
                                           int units, int zero_start,
                                           int tid) {
  using L = LayoutC<PP, NP>;
  constexpr int XS = L::XS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  const int lane = tid & 31;
  const int n_qt = (chunk + T - 1) / T, nz = (chunk + QT - 1) / QT;
  uint32_t ks = 0;
  int k = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    if (!(zero_start && u % nc == 0)) {
      wait_phase(bars + L::S_FULL, ks & 1);
      const float4* big = reinterpret_cast<const float4*>(smem);
      float4* small = reinterpret_cast<float4*>(smem + L::S_BYTES);
      for (int j = tid; j < L::S_BYTES / 16; j += SPLITTERS)
        small[j] = tf32_rest(big[j]);
      fence_async();
      __syncwarp();
      if (lane == 0) bar_arrive(bars + L::S_READY);
      ++ks;
    }
    for (int z = nz - 1; z >= 0; --z) {
      const int n_kt = min(z * QT / T + 2, n_qt);
      for (int i = 0; i < n_kt; ++i, ++k) {
        const int xs = k % XS, b = k & 1;
        wait_phase(bars + L::X_FULL + xs, (k / XS) & 1);
        if (k >= 2) wait_phase(bars + L::XT_EMPTY + b, ((k - 2) >> 1) & 1);
        uint8_t* xt = smem + L::XT_OFF + b * 2 * L::XT_BYTES;
        transpose_split<PP, T, SPLITTERS>(smem + L::X_OFF + xs * L::X_BYTES,
                                          xt, xt + L::XT_BYTES, tid);
        fence_async();
        __syncwarp();
        if (lane == 0) {
          bar_arrive(bars + L::X_EMPTY + xs);
          bar_arrive(bars + L::XT_FULL + b);
        }
      }
    }
  }
}

// A consumer warpgroup (ctid 0..255, rows 64 wg ..).  Per pair the seg
// cumsum (both consumers; the pair's first barrier also keeps the last
// pair's readers of seg behind) of dA, or DT of dt A_h from dtT, then per
// query tile the inter product and the key tiles at or below its rows,
// then y.
template <int PP, int NP, bool DT>
__device__ __forceinline__ void scan_consume(
    uint8_t* smem, const float* __restrict__ C,
    const float* __restrict__ a, const float* __restrict__ A,
    float* __restrict__ y, const Geom& geo, int s, int chunk, int nc, int n,
    int p, int units, int zero_start) {
  using L = LayoutC<PP, NP>;
  constexpr int GS = L::GS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  float* seg = reinterpret_cast<float*>(smem + L::SEG_OFF);
  float* warp_sum = seg + MAX_CHUNK;
  const int ctid = threadIdx.x, wg = ctid >> 7, lane = ctid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (chunk + T - 1) / T, nz = (chunk + QT - 1) / QT;
  const uint32_t s_addr = smem_u32(smem);
  uint32_t ks = 0;  // S_prev loads so far
  int k = 0;        // key tiles so far
  float acc[PP / 2];
  float pa[2][T / 8][4], pl[2][T / 8][4];  // P big and small, two sets
  const int r0 = 64 * wg + 16 * ((ctid >> 5) & 3) + g;  // rows r0, r0 + 8
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int row = u / nc, c = u % nc, c0 = c * chunk;
    const int bi = row / geo.heads, hi = row - bi * geo.heads;
    const bool inter = !(zero_start && c == 0);
    // seg in log2 units: every exponential below is one ex2
    if (DT)
      chunk_cumsum<256, true>(a + (size_t)u * geo.cp, chunk, A[hi], LOG2E,
                              seg, warp_sum, ctid);
    else
      chunk_cumsum<256>(a + (size_t)row * s + c0, chunk, 0.f, LOG2E, seg,
                        warp_sum, ctid);
    for (int z = nz - 1; z >= 0; --z) {
      const int q0 = z * QT, n_kt = min(q0 / T + 2, n_qt);
      const int qi = q0 / T + wg;
      const int n_mine = qi < n_qt ? qi + 1 : 0;  // key tiles it reaches
      const int l0 = q0 + r0;  // chunk-local query rows l0, l0 + 8

      // ---- inter: acc = exp(seg_l) C_l . S_prev ----
#pragma unroll
      for (int i = 0; i < PP / 2; ++i) acc[i] = 0.f;
      if (inter) {
        // in parts of 32 state columns, C's A fragments of the next part
        // loaded while this part's products run: two rows of C a thread,
        // at constant offsets
        const float* c_base = C + bi * geo.c_b + hi / geo.hpg * geo.c_g;
        const float* c_rows[2] = {c_base + (c0 + l0) * geo.c_t,
                                  c_base + (c0 + l0 + 8) * geo.c_t};
        const bool row_in[2] = {l0 < chunk, l0 + 8 < chunk};
        float cf[2][4][4], cl[2][4][4];
        const auto load_c = [&](int part, float (&f)[4][4]) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int col = 32 * part + 8 * kk + t + 4 * (i >> 1);
              f[kk][i] = row_in[i & 1] && col < n ? c_rows[i & 1][col] : 0.f;
            }
        };
        load_c(0, cf[0]);
        bar_wait<true>(bars + L::S_READY, ks & 1);
#pragma unroll
        for (int part = 0; part < NP / 32; ++part) {
          const int b = part & 1;
          split(cf[b], cl[b]);
          uint32_t sb = s_addr, ss = s_addr + L::S_BYTES;
          asm volatile("" : "+r"(sb), "+r"(ss));
          pin(acc);
          pin(cf[b]);
          pin(cl[b]);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma3(acc, cf[b][kk], cl[b][kk], kdesc(sb, 4 * part + kk, PP),
                 kdesc(ss, 4 * part + kk, PP));
          wg_commit();
          if (part + 1 < NP / 32) load_c(part + 1, cf[b ^ 1]);
          wg_wait_all();
          pin(acc);
          pin(cf[b]);
          pin(cl[b]);
        }
        // the pair's last query tile has read S_prev: the next may load
        if (z == 0 && lane == 0) bar_arrive(bars + L::S_EMPTY);
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

      // ---- intra: P of key tile i from its G tile, masked before the
      // exp (the exponent is <= 0 wherever it is taken) and decayed ----
      const auto prep = [&](int i, auto buf) {
        constexpr int b = decltype(buf)::value;
        const int kg = k + i, gs = kg % GS;
        bar_wait<true>(bars + L::G_FULL + gs, (kg / GS) & 1);
        const float4* gt =
            reinterpret_cast<const float4*>(smem + L::G_OFF +
                                            (gs * 2 + wg) * G_TILE) +
            (ctid & 127);
        const float* dts = reinterpret_cast<const float*>(
            smem + L::DT_OFF + gs * L::DT_BYTES);
#pragma unroll
        for (int j = 0; j < T / 8; ++j) {
          const float4 v = gt[128 * j];
          pa[b][j][0] = v.x;
          pa[b][j][1] = v.y;
          pa[b][j][2] = v.z;
          pa[b][j][3] = v.w;
        }
        // element e of a fragment: row l0 + 8 (e & 1), key 8j + 2t + (e >> 1)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = l0 + 8 * (e & 1);
          const float sl = seg[l < chunk ? l : chunk - 1];
#pragma unroll
          for (int j = 0; j < T / 8; ++j) {
            const int m = T * i + 8 * j + 2 * t + (e >> 1);
            float& v = pa[b][j][e];
            if (DT)   // the key's dt, with its G tile in the stage
              v = (m <= l && l < chunk)
                      ? v * exp2_approx(sl - seg[m]) *
                            dts[8 * j + 2 * t + (e >> 1)]
                      : 0.f;
            else
              v = (m <= l && l < chunk) ? v * exp2_approx(sl - seg[m]) : 0.f;
          }
        }
        split(pa[b], pl[b]);
        // the stage is read (its values are used): the loader may refill it
        __syncwarp();
        if (lane == 0) bar_arrive(bars + L::G_EMPTY + gs);
      };
      // acc += P . x^T for key tile i while tile i + 1's P is prepared
      const auto step = [&](int i, auto cur, auto nxt) {
        constexpr int b = decltype(cur)::value;
        const int kg = k + i;
        bar_wait<true>(bars + L::XT_FULL + (kg & 1), (kg >> 1) & 1);
        uint32_t xt = smem_u32(smem + L::XT_OFF + (kg & 1) * 2 * L::XT_BYTES);
        asm volatile("" : "+r"(xt));
        pin(acc);
        pin(pa[b]);
        pin(pl[b]);
        wg_fence();
#pragma unroll
        for (int j = 0; j < T / 8; ++j)
          mma3(acc, pa[b][j], pl[b][j], kdesc(xt, j, PP),
               kdesc(xt + L::XT_BYTES, j, PP));
        wg_commit();
        if (i + 1 < n_mine) prep(i + 1, nxt);
        wg_wait_all();
        pin(acc);
        pin(pa[b]);
        pin(pl[b]);
        if (lane == 0) bar_arrive(bars + L::XT_EMPTY + (kg & 1));
      };
      if (n_mine > 0) prep(0, Buf<0>());
      for (int i = 0; i < n_mine; i += 2) {
        step(i, Buf<0>(), Buf<1>());
        if (i + 1 < n_mine) step(i + 1, Buf<1>(), Buf<0>());
      }
      // key tiles above this warpgroup's rows: released unread
      for (int i = n_mine; i < n_kt; ++i) {
        const int kg = k + i;
        bar_wait<true>(bars + L::G_FULL + kg % GS, (kg / GS) & 1);
        if (lane == 0) bar_arrive(bars + L::G_EMPTY + kg % GS);
        bar_wait<true>(bars + L::XT_FULL + (kg & 1), (kg >> 1) & 1);
        if (lane == 0) bar_arrive(bars + L::XT_EMPTY + (kg & 1));
      }
      k += n_kt;

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = l0 + 8 * h;
        if (l >= chunk) continue;
        float* yr = y + bi * geo.y_b + hi * geo.y_h + (c0 + l) * geo.y_t;
#pragma unroll
        for (int j = 0; j < PP / 8; ++j) {
          const int pp = 8 * j + 2 * t;
          if (pp < p)
            *reinterpret_cast<float2*>(yr + pp) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
    if (inter) ++ks;
  }
}

// Warp specialisation in one top-level branch on the warpgroup, so that
// ptxas knows the register count at each setmaxnreg (168 at entry): the
// producer warpgroup drops to PRODUCER_REGS, the consumers rise to
// CONSUMER_REGS.  Named barrier 1 counts the consumer threads only.
template <int PP, int NP, bool DT>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
    chunk_scan(const __grid_constant__ CUtensorMap tX,
               const __grid_constant__ CUtensorMap tS,
               const float* __restrict__ C, const float* __restrict__ scores,
               const float* __restrict__ a, const float* __restrict__ A,
               float* __restrict__ y, const __grid_constant__ Geom geo,
               int s, int chunk, int nc, int n, int p, int units,
               int zero_start) {
  using L = LayoutC<PP, NP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
    constexpr int CONSUMER_WARPS = 8, SPLIT_WARPS = SPLITTERS / 32;
    bar_init(bars + L::S_FULL, 1);
    bar_init(bars + L::S_READY, SPLIT_WARPS);
    bar_init(bars + L::S_EMPTY, CONSUMER_WARPS);
    for (int i = 0; i < L::XS; ++i) {
      bar_init(bars + L::X_FULL + i, 1);
      bar_init(bars + L::X_EMPTY + i, SPLIT_WARPS);
    }
    for (int i = 0; i < L::GS; ++i) {
      bar_init(bars + L::G_FULL + i, 1);
      bar_init(bars + L::G_EMPTY + i, CONSUMER_WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      bar_init(bars + L::XT_FULL + i, SPLIT_WARPS);
      bar_init(bars + L::XT_EMPTY + i, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // 0 and 1: consumers; 2: the producer.  Read from lane 0, so that ptxas
  // sees a warp-uniform branch
  const int wg = __shfl_sync(FULL, (int)threadIdx.x >> 7, 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int tid = threadIdx.x - 256;
    if (tid >= 32)
      scan_split<PP, NP>(smem, chunk, nc, units, zero_start, tid - 32);
    else if (tid == 0)
      scan_load<PP, NP, DT>(smem, &tX, &tS, scores, a, chunk, nc,
                            geo.heads, geo.hpg, geo.cp, units, zero_start);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    scan_consume<PP, NP, DT>(smem, C, a, A, y, geo, s, chunk, nc, n, p,
                             units, zero_start);
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// The float32 tensor (d3, d2, d1, d0) at ptr with element strides (st1,
// st2, st3) (each a multiple of 4: 16 bytes; d0's is 1), in boxes of
// [rows][32] (128-byte swizzle); what lies past d0 or d1 reads as zeros.
int encode(CUtensorMap* map, const void* ptr, int64_t d0, int64_t d1,
           int64_t d2, int64_t d3, int64_t st1, int64_t st2, int64_t st3,
           int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2,
                              (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)st1 * 4, (cuuint64_t)st2 * 4,
                                 (cuuint64_t)st3 * 4};
  const cuuint32_t box[4] = {32, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
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

int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 0;
  return sms[dev];
}

// The element strides of a launch, (t, head or group, batch) each: x, B,
// C, dt, y
enum { X_ST = 0, B_ST = 3, C_ST = 6, DT_ST = 9, Y_ST = 12, N_ST = 15 };

template <int PP, int NP, bool DT>
cudaError_t scan_t(const CUtensorMap& tX, const CUtensorMap& tS,
                   const float* C, const float* scores, const float* a,
                   const float* A, float* y, const Geom& geo, int64_t s,
                   int64_t chunk, int64_t nc, int64_t n, int64_t p,
                   int64_t units, bool zero_start, int sms,
                   cudaStream_t stream) {
  using LC = LayoutC<PP, NP>;
  static bool ready[64] = {};
  const cudaError_t e = allow_smem(chunk_scan<PP, NP, DT>, LC::SMEM, ready);
  if (e != cudaSuccess) return e;
  chunk_scan<PP, NP, DT><<<(unsigned)(units < sms ? units : sms),
                           SCAN_THREADS, LC::SMEM, stream>>>(
      tX, tS, C, scores, a, A, y, geo, (int)s, (int)chunk, (int)nc, (int)n,
      (int)p, (int)units, zero_start);
  return cudaGetLastError();
}

template <int PP, int NP>
int launch_t(const void* x, const void* B, const void* C, const float* dt,
             const float* A, const float* dA, const float* init, float* y,
             float* final_state, float* scratch, const int64_t* st,
             int64_t batch, int64_t s, int64_t heads, int64_t groups,
             int64_t p, int64_t n, int64_t chunk, cudaStream_t stream) {
  using LG = LayoutG<NP>;
  using LA = LayoutA<PP, NP>;
  const int64_t bh = batch * heads, nc = s / chunk, ngroups = batch * groups;
  const int n_qt = (int)((chunk + T - 1) / T), nt = causal_tiles(n_qt);
  const int64_t cp = (int64_t)n_qt * T;
  float* states = scratch;
  float* scores = states + bh * nc * n * p;
  float* dtT = scores + ngroups * nc * nt * (T * T);  // with dt only
  float* decay = dtT + (dt != nullptr ? bh * nc * cp : 0);
  const Geom geo{st[C_ST],     st[C_ST + 1],  st[C_ST + 2],
                 st[DT_ST],    st[DT_ST + 1], st[DT_ST + 2],
                 st[Y_ST],     st[Y_ST + 1],  st[Y_ST + 2],
                 (int)heads,   (int)(heads / groups), (int)cp};
  CUtensorMap tC, tB, tX, tS;
  int err = encode(&tC, C, n, s, groups, batch, st[C_ST], st[C_ST + 1],
                   st[C_ST + 2], T);
  if (err == 0)
    err = encode(&tB, B, n, s, groups, batch, st[B_ST], st[B_ST + 1],
                 st[B_ST + 2], T);
  if (err == 0)
    err = encode(&tX, x, p, s, heads, batch, st[X_ST], st[X_ST + 1],
                 st[X_ST + 2], T);
  if (err == 0)
    err = encode(&tS, states, n, p, bh * nc, 1, n, n * p, n * p, PP);
  if (err != 0) return err;
  static bool ready_g[64] = {}, ready_a[64] = {};
  cudaError_t e = allow_smem(chunk_scores<NP>, LG::SMEM, ready_g);
  if (e == cudaSuccess)
    e = allow_smem(chunk_states<PP, NP>, LA::SMEM, ready_a);
  if (e != cudaSuccess) return (int)e;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;

  chunk_scores<NP><<<dim3((unsigned)nt, (unsigned)nc, (unsigned)ngroups),
                     128, LG::SMEM, stream>>>(tC, tB, scores, (int)chunk,
                                              (int)groups);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  chunk_states<PP, NP><<<dim3((unsigned)(NP / LA::NH), (unsigned)nc,
                              (unsigned)bh),
                         128, LA::SMEM, stream>>>(
      tB, tX, dA, dt, A, dtT, states, decay, (int)s, (int)chunk, (int)nc,
      (int)n, (int)p, geo);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  state_pass<<<dim3((unsigned)((n + 31) / 32), (unsigned)((p + 31) / 32),
                   (unsigned)bh),
               dim3(32, 8), 0, stream>>>(states, decay, init, final_state,
                                         (int)nc, (int)n, (int)p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int64_t units = bh * nc;
  e = dt != nullptr
          ? scan_t<PP, NP, true>(tX, tS, (const float*)C, scores, dtT, A, y,
                                 geo, s, chunk, nc, n, p, units,
                                 init == nullptr, sms, stream)
          : scan_t<PP, NP, false>(tX, tS, (const float*)C, scores, dA,
                                  nullptr, y, geo, s, chunk, nc, n, p, units,
                                  init == nullptr, sms, stream);
  return (int)e;
}

}  // namespace

// Dynamic shared memory per CTA of chunk_scan, and in *states_smem of
// chunk_states, in *scores_smem of chunk_scores, in bytes, and in
// *g_stages chunk_scan's G ring depth, at (p, n); 0 if the pair is not
// supported.
extern "C" int64_t ssd_scan_layout(int64_t p, int64_t n,
                                   int64_t* states_smem,
                                   int64_t* scores_smem,
                                   int64_t* g_stages) {
  *states_smem = *scores_smem = *g_stages = 0;
#define SSD_LAYOUT(P_, N_, PP, NP)                                          \
  if (p == P_ && n == N_) {                                                 \
    *states_smem = LayoutA<PP, NP>::SMEM;                                   \
    *scores_smem = LayoutG<NP>::SMEM;                                       \
    *g_stages = LayoutC<PP, NP>::GS;                                        \
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

// chunk_scan's threads, and the registers a thread that setmaxnreg gives
// its producer warpgroup (*producer_regs) and each consumer warpgroup
// (*consumer_regs).
extern "C" int64_t ssd_scan_threads(int64_t* producer_regs,
                                    int64_t* consumer_regs) {
  *producer_regs = PRODUCER_REGS;
  *consumer_regs = CONSUMER_REGS;
  return SCAN_THREADS;
}

// The models' layout: x (batch, s, heads, p); B, C (batch, s, groups,
// n), heads a multiple of groups, head h reading group h / (heads /
// groups); y (batch, s, heads, p), written; with `strides` (15 int64:
// N_ST above) their element strides (t, head or group, batch), each of x,
// B and C a multiple of 4 (16 bytes; the last dim's stride is 1), dt's
// any.  Either dt (batch, s, heads) and A (heads) (dA = dt A, and dt
// folded into the per-key scales) or dA (batch * heads, s) contiguous and
// no dt (x taken as x * dt); init, final_state: (batch, heads, n, p)
// contiguous or null; scratch: ssd_scan.py's scratch_floats, with dt's
// part when dt is given.  x, B, C and scratch 16-byte aligned; s % chunk
// == 0, 1 <= chunk <= 256, (p, n) one of the pairs below.  Launches
// chunk_scores, chunk_states, state_pass and chunk_scan on the stream.
// Returns cudaGetLastError() (or the error of the attribute call or of
// the tensor-map encoding).
extern "C" int ssd_scan_heads_launch(
    const void* x, const void* B, const void* C, const void* dt,
    const void* A, const void* dA, const void* init, void* y,
    void* final_state, void* scratch, const int64_t* strides, int64_t batch,
    int64_t s, int64_t heads, int64_t groups, int64_t p, int64_t n,
    int64_t chunk, void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0) return 0;
  if (chunk < 1 || chunk > MAX_CHUNK || s % chunk != 0 || groups < 1 ||
      heads % groups != 0 || (dt == nullptr) == (dA == nullptr) ||
      (dt != nullptr && A == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)x | (uintptr_t)B | (uintptr_t)C | (uintptr_t)scratch) &
       15) != 0)
    return (int)cudaErrorMisalignedAddress;  // TMA reads 16-byte aligned
  cudaStream_t st = (cudaStream_t)stream;
  const float *dtf = (const float*)dt, *af = (const float*)A,
              *daf = (const float*)dA, *initf = (const float*)init;
  float *yf = (float*)y, *ff = (float*)final_state, *sf = (float*)scratch;
#define SSD_CASE(P_, N_, PP, NP)                                            \
  if (p == P_ && n == N_)                                                   \
    return launch_t<PP, NP>(x, B, C, dtf, af, daf, initf, yf, ff, sf,       \
                            strides, batch, s, heads, groups, p, n, chunk,  \
                            st);
  SSD_CASE(8, 4, 32, 32)
  SSD_CASE(16, 8, 32, 32)
  SSD_CASE(32, 16, 32, 32)
  SSD_CASE(64, 32, 64, 32)
  SSD_CASE(64, 64, 64, 64)
  SSD_CASE(64, 128, 64, 128)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

// The reference's (BH, S, P) contract, as before the models' layout: x,
// y: (bh, s, p); B, C: (bh / heads_per_group, s, n); dA: (bh, s); init,
// final_state: (bh, n, p) or null; all contiguous; scratch:
// scratch_floats without dt's part.  The batch-1, heads-bh case of
// ssd_scan_heads_launch.
extern "C" int ssd_scan_launch(const void* x, const void* B, const void* C,
                               const void* dA, const void* init, void* y,
                               void* final_state, void* scratch, int64_t bh,
                               int64_t s, int64_t p, int64_t n, int64_t chunk,
                               int64_t heads_per_group, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  if (heads_per_group < 1 || bh % heads_per_group != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t strides[N_ST] = {p, s * p, 4, n, s * n, 4, n, s * n, 4,
                                 0, 0, 0, p, s * p, 4};
  return ssd_scan_heads_launch(x, B, C, nullptr, nullptr, dA, init, y,
                               final_state, scratch, strides, 1, s, bh,
                               bh / heads_per_group, p, n, chunk, stream);
}
