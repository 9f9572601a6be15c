// Causal flash-attention forward (online softmax), optional sliding window.
//
//   o[b, q] = sum_k softmax_k(s[b, q, k]) v[b, k],
//   s[b, q, k] = (q[b, q] . k[b, k]) / sqrt(d)  for k <= q (and q - k < window),
//                -1e30 otherwise.
//
// Replaces the Pallas kernel _flash_kernel of
// src/repro/kernels/flash_attention.py (launched by flash_attention_pallas):
// f32 running max m, sum l and accumulator per query row, p rounded to the
// input type before the p.V product, and the final divide by max(l, 1e-30).
// The Pallas kernel takes (BH, S, d) operands, heads flattened into the
// batch and K/V repeated to every query head by the caller; this one takes
// the models' layout as it is: q (batch, S, heads, d), k and v at their
// own kv heads (query head h reads kv head h / (heads / kv_heads), as the
// reference's grouped attention does), each operand in its own strides
// (tensor maps of rank 4, the last dim unit-stride), o written as (batch,
// S, heads, dv).  MLA's rope key, one for every head of a position, comes
// from a map of its own (batch, S, rope) as K's last columns.  (BH, S, d)
// is the case batch = BH, heads = kv_heads = 1.
// The Pallas grid walks (bh, q-block, kv-block) in order on one core and
// keeps m, l and acc in VMEM scratch across the kv blocks; here one CTA
// owns a query tile and loops over the key tiles itself, keeping the state
// in registers.  Any S works: keys and queries past S are masked and never
// stored.  Key tiles wholly above the diagonal, or wholly outside the
// window, are skipped, and the q tiles with the most key tiles run first
// (on the bfloat16 route, within each group of heads).
//
// Two routes on the tensor cores, chosen by dtype in
// flash_attention_launch:
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
//   - a query tile is 128 rows: one producer warpgroup and two
//     consumer warpgroups of 64 rows (384 threads).  The producer loads Q
//     and keeps a ring of 128-key K/V stages (up to four, as shared
//     memory allows) in flight with TMA (cp.async.bulk.tensor, 128- or
//     64-byte swizzle, rows past S zero-filled), signalled by full and
//     empty mbarriers, K's apart from V's: K_{i+1} is loaded before V_i,
//     and a K stage is refilled as soon as its Q K^T is done, not after
//     the P V of its tile;
//   - the register file is split with setmaxnreg: the producer gives its
//     warpgroup's registers up (24 a thread) and the consumers take them
//     (240 a thread; 168 each without the split).  A consumer at dv 128
//     holds the accumulator (64 floats), a score tile (64) and P (32
//     bf16 pairs) at once: ~160 registers before m, l and the addresses;
//   - S = Q K^T is wgmma m64n128k16 with both operands in shared memory;
//     O += P V is wgmma with P in registers (rounded to bf16, the A
//     fragments of the accumulator's own layout) and V read MN-major;
//   - only tiles that cross the diagonal, the window edge or S are
//     masked, from each row's first and last key (two compares a score);
//     the online softmax runs on the accumulator fragments (a row lives
//     in one quad: two shuffles; exp2 with scale * log2(e) folded in; l
//     sums the unrounded exponentials);
//   - at every (d, dv) each warpgroup issues S_i with P_{i-1} V_{i-1}
//     and runs the softmax of tile i while that product is on the tensor
//     cores, and the two warpgroups take turns to issue (named barriers),
//     so one's softmax overlaps the other's products.  The accumulator of
//     tile i is acc * alpha_i + P_i V_i either way: the overlap changes
//     when a product is issued, not what is summed;
//   - the epilogue scales by 1 / max(l, 1e-30) (one division a row),
//     rounds to bf16 into shared memory in TMA's swizzled layout and
//     writes each warpgroup's rows with one bulk tensor store (rows past
//     S are dropped).
//   - head dims 80 (zamba2-2.7b, whose prefill calls this at (BH 128,
//     S 1024, d 80): 84 MB, 0.025 ms at 3.35 TB/s, bytes-bound), 96
//     (phi3-mini) and 120 (h2o-danube3) run in the 128-column tile: the
//     tensor maps span the tensor's d columns, so TMA fills columns
//     d-127 of Q, K and V with zeros and the bulk store of O drops them;
//     the scale stays 1/sqrt(d).  That costs 1.6x, 1.33x and 1.07x the
//     products of an exact tile (at d 80: 64 + 16-column chunks, k 5 x
//     16, n 80), which would need a second swizzle mode and tensor map
//     per operand.
//   - a window skips the key tiles wholly before the first query row's
//     window (t_first): at h2o-danube3's window of 4096 and S 8192 a
//     128-row query tile reads 33 key tiles, 1.03x the keys its rows
//     attend, not the 64 of the causal triangle.
//   - for a causal call one CTA an SM walks pairs of query tiles of a
//     head (the heaviest and the lightest left: every pair walks as many
//     key tiles), Q double-buffered: a query tile's Q and first K/V
//     tiles load while the one before runs.  A window's call, d 192 (a
//     second Q buffer leaves one K/V stage) and a call whose pairs would
//     balance worse than single tiles run a CTA a query tile, with a
//     deeper K/V ring;
//   - the CTAs run in groups of heads whose K and V fit in a third of
//     L2 (GROUP_BYTES), the heaviest query tiles of a group first: in
//     plain heaviest-first order, 132 CTAs at once read 132 heads' K
//     and V (67 MB at qwen3-14b's (160, 1024, 128)), more than L2 holds,
//     so each query tile read its keys from device memory again.  The
//     query heads of one kv head are neighbours in that order and count
//     its K and V once, so a group of grouped-query heads reads each kv
//     head's K and V from device memory once, not once a query head.
//   - MLA (deepseek-v2) attends with q.k 192 wide (nope 128 + rope 64)
//     and values 128 wide.  Its prefill calls this at (BH 512, S 1024,
//     d 192, dv 128): 671 MB (0.200 ms at 3.35 TB/s) and 172 GFLOP on
//     the causal half (0.174 ms at 989 TFLOP/s), so bytes bound it.
//     (192, 128) is an instantiation of its own: Q and K in three
//     64-column chunks (128-byte swizzle), 12 k-steps a Q K^T tile.  A
//     separate O tile would leave room for one 80 KB K/V stage, no
//     prefetch; O is staged in Q's bytes instead (Layout), which leaves
//     two.  Every head reads the one rope key of a position: K's third
//     chunk comes from the shared key's map, (rope, S, batch), not from
//     a copy in each head's K.
// * float32: 3xTF32 on the tensor cores (namespace f32).  One TF32
//   product keeps ~3 decimal digits, and the float32 smoke configs hold
//   the card's logits to the CPU's within ~1e-6.  So every product is
//   three TF32 wgmmas into the same float32 accumulators: each operand a
//   is split into big = a, which the tensor core reads truncated to
//   TF32, and small = a - trunc(a), exact in float32, and small.big +
//   big.small + big.big are summed (hopper.cuh's mma3, as ssd_scan.cu
//   does it).  What bounds each float32 call on the H100:
//   - the 25m preset's favg at --seq 1024, (BH 32, S 1024, d 64): 4.30
//     GFLOP on the causal half, three products each: 0.026 ms at 495
//     TFLOP/s (33.5 MB: 0.010 ms at 3.35 TB/s), so operations;
//   - every other caller's call is small and latency-bound: MLA's smoke
//     calls (8, 40, 192 -> 128) and (8, 40, 48 -> 32) run 8 CTAs, the
//     transformer classifier's (400, 16, 16) 400 CTAs of 16 rows, the
//     float32 presets' favg calls (32 and 48, 128, 64) 64 and 96 CTAs of
//     one or two key tiles; their bytes take 0.06-1.9 us.  What a CTA
//     waits for (a TMA round trip, each key tile's chain of splits,
//     products and softmax, the launch) bounds them; no persistent
//     schedule, which would only lengthen that chain.
//   The design:
//   - TMA loads Q once and K/V tiles into a ring of up to four stages,
//     in 32-column chunks (128-byte swizzle; rows past S and columns past
//     d zero-filled), one thread issuing, mbarriers signalling;
//   - TF32 wgmma reads a shared-memory operand K-major only.  K lies so
//     as loaded; its small part is split into a buffer of the same
//     layout.  V is transposed in shared memory into V^T (dv, keys), big
//     and small, the keys of each group of 8 in the order 0 2 4 6 1 3 5
//     7, so that P goes from the score accumulator to the A fragment in
//     place.  Q K^T reads Q big and small from shared memory;
//   - every d is a multiple of 8: d / 8 k-steps, no padded column
//     multiplied; P V takes n = dv rounded up to 32; a key tile is 64 keys
//     (32 where shared memory is short, and for d, dv <= 32);
//   - the online softmax runs on the accumulator fragments as the bf16
//     route's does (masks only on tiles that cross the diagonal, the
//     window edge or S; key tiles wholly outside the window skipped);
//   - a warp cannot queue a product's 3 x d / 8 wgmmas ahead of its other
//     work: issuing them takes most of the product's time.  So the
//     CUDA-core work of a key tile (K's split, V's transpose, the
//     softmax) overlaps the tensor cores only in other warps.  Rows of
//     one key tile (the smoke and classifier calls) take flash_fwd_f32,
//     one warpgroup and 64 query rows a CTA, which splits and transposes
//     while its products run; at d, dv <= 64 longer rows take
//     flash_fwd_f32_ws: a splitter warpgroup fills double-buffered Ks and
//     V^T, and one multiplier warpgroup (rows of two key tiles: the favg
//     calls) or two (longer rows, 128 query rows a CTA), taking turns to
//     issue their products, multiply (tools/flash_phases.py shows each
//     warpgroup's phases).
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

#include <algorithm>

#include "hopper.cuh"

namespace {

// A launch's operands, as flash_attention_launch takes them: q (batch, s,
// heads, d), k (batch, s, kv_heads, dk), v (batch, s, kv_heads, dv), the
// shared key ks (batch, s, d - dk) or none (dk == d), o (batch, s, heads,
// dv), each with its strides in elements between positions, heads and
// batch rows (the last dim unit-stride).
struct Call {
  const void *q, *k, *v, *ks;
  void* o;
  const int64_t* strides;  // (row, head, batch) of q, k, v, ks, o
  int64_t batch, heads, kv_heads, s, d, dk, dv, window;
};
enum Operand { OP_Q, OP_K, OP_V, OP_KS, OP_O };

// What a CTA needs to find its operands: the (batch row, query head)
// pairs, the query heads a batch row and a kv head, and K's own columns
// (past them, K's columns come from the shared key's map; d: none).
struct Heads {
  int n_bh, heads, g, dk;
};
// (batch row, query head) pair bh: its batch row, query head and kv head
struct Head {
  int batch, head, kv_head;
  __device__ __forceinline__ Head(int bh, const Heads& hd) {
    batch = bh / hd.heads;
    head = bh - batch * hd.heads;
    kv_head = head / hd.g;
  }
};

// Operand `op` of a call as a tensor map: (cols, s, heads, batch), or
// (cols, s, batch) for the shared key, in its own strides; boxes of
// box_cols x rows; rows past s and columns past cols read as zeros and
// are not written.  TMA takes strides that are multiples of 16 bytes
// (the wrapper checks them).
int encode(CUtensorMap* map, const Call& c, Operand op, int64_t cols,
           CUtensorMapDataType type, int elt, int box_cols, int rows,
           CUtensorMapSwizzle swizzle) {
  const hopper::EncodeTiled fn = hopper::encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const void* ptrs[5] = {c.q, c.k, c.v, c.ks, c.o};
  const int64_t* st = c.strides + 3 * op;
  const bool shared = op == OP_KS;
  const int64_t heads = op == OP_Q || op == OP_O ? c.heads : c.kv_heads;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)c.s,
                              (cuuint64_t)(shared ? c.batch : heads),
                              (cuuint64_t)c.batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(st[0] * elt),
                                 (cuuint64_t)(st[shared ? 2 : 1] * elt),
                                 (cuuint64_t)(st[2] * elt)};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, type, shared ? 3 : 4, const_cast<void*>(ptrs[op]), dims,
         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

Heads heads_of(const Call& c) {
  return {(int)(c.batch * c.heads), (int)c.heads,
          (int)(c.heads / c.kv_heads), (int)c.dk};
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores (wgmma + TMA)
// ---------------------------------------------------------------------------

namespace f32 {

using namespace hopper;

constexpr int BQ = 64;        // query rows of a warpgroup
constexpr int THREADS = 128;
constexpr int MAX_STAGES = 4;  // K/V ring depth, as shared memory allows
// Probes at the ends of the kernels' phases: tools/flash_phases.py
// defines them to sum clock64() intervals; here they are empty
#ifndef F32_PROBE
#define F32_PROBE_START
#define F32_PROBE(k)
#define F32_PROBE_END(group, adder)
#endif
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int pad32(int x) { return (x + 31) / 32 * 32; }
__host__ __device__ constexpr int min_c(int a, int b) { return a < b ? a : b; }

// Shared memory of a CTA, every tile in 32-column chunks of [rows][32]
// (128-byte swizzle, each chunk 1024-byte aligned), head dims padded to
// 32 columns (TMA zero-fills the rest): the mbarriers (the first 1024
// bytes); Q (the CTA's QROWS rows) as TMA wrote it and its small part;
// BUFS buffers of K's small part and V^T's big and small parts; then the
// ring of K/V stages as TMA writes them.  BUFS is 1 for flash_fwd_f32,
// whose one warpgroup splits, transposes and multiplies, and 2, where
// they fit, for flash_fwd_f32_ws, whose splitter fills one buffer while
// its multipliers read the other.  A key
// tile is 64 keys where two stages fit beside the rest, else 32, and 32
// for the narrow heads (d, dv <= 32: at 64 keys the classifier's 400
// CTAs of 16 rows did not all fit on the card at once).  MAX_ST stages
// fit; a launch takes no more than its key tiles need.
__host__ __device__ constexpr int q_bytes(int d, int rows) {
  return 2 * rows * pad32(d) * 4;
}
__host__ __device__ constexpr int buf_bytes(int d, int dvp, int bk) {
  return bk * pad32(d) * 4 + 2 * dvp * bk * 4;
}
__host__ __device__ constexpr int stage_bytes(int d, int dvp, int bk) {
  return bk * (pad32(d) + dvp) * 4;
}
// 232448 bytes: the most dynamic shared memory a CTA may have on sm_90;
// 1024 of alignment slack and the barriers' 1024
constexpr int ROOM = 232448 - 2 * 1024;
__host__ __device__ constexpr bool fits(int d, int dvp, int rows, int bk,
                                        int bufs, int stages) {
  return q_bytes(d, rows) + bufs * buf_bytes(d, dvp, bk) +
             stages * stage_bytes(d, dvp, bk) <= ROOM;
}

// MULT: 0 for flash_fwd_f32, else flash_fwd_f32_ws's multiplier
// warpgroups (1 or 2)
template <int D, int DVP, int MULT>
struct Layout {
  static constexpr int DP = pad32(D);
  // query rows of a CTA: 64 a warpgroup that multiplies
  static constexpr int QROWS = (MULT > 1 ? MULT : 1) * BQ;
  static constexpr int WANT_BUFS = MULT > 0 ? 2 : 1;
  static constexpr int BK =
      DP + DVP <= 64 ? 32 : fits(D, DVP, QROWS, 64, WANT_BUFS, 2) ? 64 : 32;
  static constexpr int BUFS =
      fits(D, DVP, QROWS, BK, WANT_BUFS, 1) ? WANT_BUFS : 1;
  static constexpr int Q_BYTES = QROWS * DP * 4;
  static constexpr int K_BYTES = BK * DP * 4, V_BYTES = BK * DVP * 4;
  static constexpr int BUF = K_BYTES + 2 * V_BYTES;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int FIXED = 2 * Q_BYTES + BUFS * BUF;
  static constexpr int MAX_ST = min_c((ROOM - FIXED) / STAGE, MAX_STAGES);
  static_assert(MAX_ST >= 1, "a K/V stage does not fit");
  // offsets after the barriers; buffer b: Ks, V^T big, V^T small
  static constexpr int QB = 1024, QS = QB + Q_BYTES, BUF0 = QS + Q_BYTES;
  static constexpr int RING = BUF0 + BUFS * BUF;
  __host__ __device__ static constexpr int ks(int b) { return BUF0 + b * BUF; }
  __host__ __device__ static constexpr int vtb(int b) {
    return ks(b) + K_BYTES;
  }
  __host__ __device__ static constexpr int vts(int b) {
    return vtb(b) + V_BYTES;
  }
  __host__ __device__ static constexpr int smem(int stages) {
    return RING + stages * STAGE + 1024;
  }
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The small part of a float32 tile of BYTES bytes into another (the
// same layout: the split is per element), by a warpgroup.
template <int BYTES>
__device__ __forceinline__ void split_tile(const uint8_t* big,
                                           uint8_t* small, int tid) {
#pragma unroll 4
  for (int i = tid; i < BYTES / 16; i += THREADS)
    reinterpret_cast<float4*>(small)[i] =
        tf32_rest(reinterpret_cast<const float4*>(big)[i]);
}

// The splitter's work on key tile i: K's small part into Ks and V
// transposed and split into V^T (as split_tile and hopper.cuh's
// transpose_split do it), every load issued before `wait` (for the
// buffer to be free) and the first store: in a loop, each load waits for
// the store before it, and the splitter's 4 warps, one an SM quarter,
// cannot hide that.  NC threads; a thread's share is whole.
template <int K_BYTES, int DVP, int BK, int NC, typename Wait>
__device__ __forceinline__ void split_key_tile(const uint8_t* st,
                                               uint8_t* ks, uint8_t* vtb,
                                               uint8_t* vts, int tid,
                                               Wait wait) {
  constexpr int NK = K_BYTES / 16 / NC, NV = DVP * (BK / 4) / NC;
  static_assert(K_BYTES / 16 % NC == 0 && DVP * (BK / 4) % NC == 0,
                "a thread's share is not whole");
  const uint8_t* xs = st + K_BYTES;  // V as TMA wrote it
  float4 k[NK], v[NV];
#pragma unroll
  for (int j = 0; j < NK; ++j)
    k[j] = reinterpret_cast<const float4*>(st)[tid + NC * j];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int it = tid + NC * j, p = it % DVP, grp = it / DVP;
    const int key0 = 8 * (grp >> 1) + (grp & 1);
    v[j].x = *reinterpret_cast<const float*>(xs + swz(key0, p, BK));
    v[j].y = *reinterpret_cast<const float*>(xs + swz(key0 + 2, p, BK));
    v[j].z = *reinterpret_cast<const float*>(xs + swz(key0 + 4, p, BK));
    v[j].w = *reinterpret_cast<const float*>(xs + swz(key0 + 6, p, BK));
  }
  wait();
#pragma unroll
  for (int j = 0; j < NK; ++j)
    reinterpret_cast<float4*>(ks)[tid + NC * j] = tf32_rest(k[j]);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int it = tid + NC * j, p = it % DVP, kk = 4 * (it / DVP);
    *reinterpret_cast<float4*>(vtb + swz(p, kk, DVP)) = v[j];
    *reinterpret_cast<float4*>(vts + swz(p, kk, DVP)) = tf32_rest(v[j]);
  }
}

// S = Q K^T, 3xTF32, both operands in shared memory (Q: the warpgroup's
// 64 rows of a QROWS-row tile): D / 8 k-steps (every head dim is a
// multiple of 8: no padded column is multiplied).
template <int D, int BK, int QROWS>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t qb,
                                        uint32_t qs, uint32_t kb,
                                        uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    mma3(sc, kdesc(qb, kk, QROWS), kdesc(qs, kk, QROWS), kdesc(kb, kk, BK),
         kdesc(ks, kk, BK));
}

// acc += P V, 3xTF32: P's A fragments are the score accumulator's own
// registers (V^T's keys in the order 0 2 4 6 1 3 5 7 in each 8), its
// small part beside them; V^T big and small in shared memory.
template <int BK, int DVP>
__device__ __forceinline__ void issue_pv(float (&acc)[DVP / 2],
                                        const float (&p)[BK / 2],
                                        const float (&ps)[BK / 2],
                                        uint32_t vb, uint32_t vs) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float a[4] = {p[4 * j], p[4 * j + 2], p[4 * j + 1], p[4 * j + 3]};
    const float r[4] = {ps[4 * j], ps[4 * j + 2], ps[4 * j + 1],
                        ps[4 * j + 3]};
    mma3(acc, a, r, kdesc(vb, j, DVP), kdesc(vs, j, DVP));
  }
}

// The online softmax of one key tile on the score fragments (element
// 4j + 2h + c: row row0 + 8h, key k0 + col0 + 8j + c; a row lives in one
// quad).  Only a tile that crosses the diagonal, the window edge or s is
// masked.  The scores become p = exp(s - m) (exp2, scale * log2(e)
// folded in), l takes their unrounded sum (this thread's columns; the
// quad's add at the end) and alpha = exp(m_old - m_new).
template <int BK>
__device__ __forceinline__ void softmax(float (&sc)[BK / 2], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        int k0, int q0, int row0, int col0,
                                        int s, int window,
                                        float scale_log2) {
  if (k0 + BK - 1 > q0 || k0 + BK > s ||
      (window > 0 && q0 + BQ - 1 - k0 >= window)) {
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
    for (int w = BK / 16; w >= 1; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) part[j] = fmaxf(part[j], part[j + w]);
    float mx = fmaxf(m[h], part[0]);
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    alpha[h] = exp2_approx((m[h] - mx) * scale_log2);
    m[h] = mx;
    const float mc = mx * scale_log2;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
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

// What both kernels share: a CTA's (batch row, query head) and query tile
// (heaviest first), its key tiles (from the first that the first row's
// window reaches), and the TMA loads of Q and of key tile i into its stage
// of the ring.
struct Tiles : Head {
  int q0, t_first, n_tiles, dk;
  __device__ __forceinline__ Tiles(int s, int window, const Heads& hd, int bk,
                                   int rows)
      : Head((int)blockIdx.x % hd.n_bh, hd), dk(hd.dk) {
    const int n_qt = (s + rows - 1) / rows;
    q0 = (n_qt - 1 - (int)blockIdx.x / hd.n_bh) * rows;
    t_first = (window > 0 ? max(0, q0 - window + 1) : 0) / bk;
    n_tiles = (min(q0 + rows, s) - 1) / bk - t_first + 1;
  }
};

template <typename L>
__device__ __forceinline__ uint8_t* stage_of(uint8_t* smem, int i,
                                             int stages) {
  return smem + L::RING + (i % stages) * L::STAGE;
}

// Q's QROWS rows: a [QROWS][32] chunk a 32 columns, 64 rows a box
template <typename L>
__device__ __forceinline__ void load_q(uint8_t* smem, uint64_t* bar,
                                       const CUtensorMap* tq,
                                       const Tiles& w) {
  bar_expect_tx(bar, L::Q_BYTES);
  for (int c = 0; c < L::DP / 32; ++c)
    for (int h = 0; h < L::QROWS / BQ; ++h)
      tma_load(smem + L::QB + c * L::QROWS * 128 + h * BQ * 128, tq, bar,
               32 * c, w.q0 + h * BQ, w.head, w.batch);
}

// K's chunks past its own dk columns from the shared key's map
template <typename L, int DVP>
__device__ __forceinline__ void load_tile(uint8_t* smem, uint64_t* full,
                                          const CUtensorMap* tk,
                                          const CUtensorMap* tks,
                                          const CUtensorMap* tv,
                                          const Tiles& w, int i,
                                          int stages) {
  uint64_t* bar = full + i % stages;
  uint8_t* st = stage_of<L>(smem, i, stages);
  const int k0 = (w.t_first + i) * L::BK;
  bar_expect_tx(bar, L::STAGE);
  for (int c = 0; c < L::DP / 32; ++c) {
    if (32 * c < w.dk)
      tma_load(st + c * L::BK * 128, tk, bar, 32 * c, k0, w.kv_head, w.batch);
    else
      tma_load(st + c * L::BK * 128, tks, bar, 32 * c - w.dk, k0, w.batch);
  }
  for (int c = 0; c < DVP / 32; ++c)
    tma_load(st + L::K_BYTES + c * L::BK * 128, tv, bar, 32 * c, k0,
             w.kv_head, w.batch);
}

// The products and the softmax of a key tile for a warpgroup of 64 query
// rows (the first q0; Q big and small at qb, qs, a QROWS-row tile), the
// tile's K at st and Ks and V^T at buffer b: S = Q K^T, then the online
// softmax, the rescale of acc, and P V (P's A fragments the score
// accumulator's own registers, V^T's keys in the order 0 2 4 6 1 3 5 7
// in each 8).  Hooks: `before_s` and `before_pv` run before a product is
// issued, `between` while S is on the tensor cores, `after_s` once it is
// done and `beside` while P V is.
template <int D, int DVP, typename L, typename BeforeS, typename Between,
          typename AfterS, typename BeforePV, typename Beside>
__device__ __forceinline__ void key_tile(
    uint8_t* smem, uint8_t* st, int b, uint32_t qb, uint32_t qs, int k0,
    int q0, int row0, int col0, int s, int window, float scale_log2,
    float (&acc)[DVP / 2], float (&m)[2], float (&l)[2], BeforeS before_s,
    Between between, AfterS after_s, BeforePV before_pv, Beside beside) {
  constexpr int BK = L::BK;
  float sc[BK / 2], ps[BK / 2], alpha[2];
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
  before_s();
  wg_fence();
  issue_qk<D, BK, L::QROWS>(sc, qb, qs, smem_u32(st),
                            smem_u32(smem + L::ks(b)));
  wg_commit();
  between();
  wg_wait_all();
  pin(sc);
  after_s();
  softmax<BK>(sc, m, l, alpha, k0, q0, row0, col0, s, window, scale_log2);
#pragma unroll
  for (int j = 0; j < DVP / 8; ++j) {
    acc[4 * j + 0] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) ps[j] = tf32_rest(sc[j]);
  before_pv();
  wg_fence();
  issue_pv<BK, DVP>(acc, sc, ps, smem_u32(smem + L::vtb(b)),
                    smem_u32(smem + L::vts(b)));
  wg_commit();
  beside();
  wg_wait_all();
  pin(acc);
  pin(sc);
  pin(ps);
}

// o's strides in elements between positions, heads and batch rows
struct OStrides {
  int64_t row, head, batch;
};

// o = acc / max(l, 1e-30): the rows below s, the columns below dv
template <int DVP>
__device__ __forceinline__ void store_o(float* o, const OStrides& os,
                                        const float (&acc)[DVP / 2],
                                        const float (&l)[2], const Tiles& w,
                                        int row0, int col0, int s, int dv) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = row0 + 8 * h;
    if (row >= s) continue;
    float* orow = o + w.batch * os.batch + w.head * os.head +
                  row * os.row + col0;
#pragma unroll
    for (int j = 0; j < DVP / 8; ++j)
      if (8 * j < dv)
        *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(
            acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
  }
}

// One warpgroup a CTA: it loads (thread 0), splits and transposes, and
// multiplies.  Thread 0 issues Q and the first `stages` K/V tiles at the
// start, each later tile as soon as the tile `stages` before it is
// consumed (its Q K^T done and its V transposed).  A key tile: S_i
// issued, V_i transposed and split into V^T while it runs; the softmax;
// P_i V_i issued, K_{i+1}'s small part split off while it runs.  Two
// CTA-wide barriers a tile hand Ks and V^T from the CUDA cores to the
// tensor cores and back.  For rows of one key tile (no hand-off to wait
// for, more CTAs an SM) and the pairs that have no split kernel.
template <int D, int DVP>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_f32(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tks,
                  const __grid_constant__ CUtensorMap tv,
                  float* __restrict__ o, OStrides os, int s, int dv,
                  int window, float scale_log2, Heads hd, int stages) {
  using L = Layout<D, DVP, 0>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = q_full + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Tiles w(s, window, hd, L::BK, BQ);
  if (tid == 0) {
    bar_init(q_full, 1);
    for (int i = 0; i < stages; ++i) bar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_q<L>(smem, q_full, &tq, w);
    for (int i = 0; i < stages && i < w.n_tiles; ++i)
      load_tile<L, DVP>(smem, full, &tk, &tks, &tv, w, i, stages);
  }
  __syncthreads();

  // accumulator fragments: this thread holds rows row0 and row0 + 8 and,
  // in every 8-column block j, columns 8j + col0 and 8j + col0 + 1
  F32_PROBE_START
  const int row0 = w.q0 + 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  float acc[DVP / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) acc[i] = 0.f;
  bar_wait(q_full, 0);
  split_tile<L::Q_BYTES>(smem + L::QB, smem + L::QS, tid);
  bar_wait(full, 0);
  split_tile<L::K_BYTES>(stage_of<L>(smem, 0, stages), smem + L::ks(0), tid);
  fence_async();
  __syncthreads();
  F32_PROBE(0);
  for (int i = 0; i < w.n_tiles; ++i) {
    // here K_i's small part is in Ks and V^T is free
    uint8_t* st = stage_of<L>(smem, i, stages);
    key_tile<D, DVP, L>(
        smem, st, 0, smem_u32(smem + L::QB), smem_u32(smem + L::QS),
        (w.t_first + i) * L::BK, w.q0, row0, col0, s, window, scale_log2, acc,
        m, l, [] {},
        [&] {
          F32_PROBE(1);
          transpose_split<DVP, L::BK, THREADS>(
              st + L::K_BYTES, smem + L::vtb(0), smem + L::vts(0), tid);
          fence_async();
          F32_PROBE(2);
        },
        [&] {
          F32_PROBE(3);
          __syncthreads();  // V^T is written; K_i and V_i are consumed
          if (tid == 0 && i + stages < w.n_tiles)
            load_tile<L, DVP>(smem, full, &tk, &tks, &tv, w, i + stages,
                              stages);
          __syncwarp();
          F32_PROBE(4);
        },
        [] {},
        [&] {
          F32_PROBE(5);
          if (i + 1 < w.n_tiles) {  // S_i is done everywhere: Ks is free
            bar_wait(full + (i + 1) % stages, ((i + 1) / stages) & 1);
            split_tile<L::K_BYTES>(stage_of<L>(smem, i + 1, stages),
                                   smem + L::ks(0), tid);
            fence_async();
          }
          F32_PROBE(6);
        });
    F32_PROBE(7);
    __syncthreads();  // Ks is written; P_i V_i is done: V^T is free
    F32_PROBE(8);
  }
  store_o<DVP>(o, os, acc, l, w, row0, col0, s, dv);
  F32_PROBE(9);
  F32_PROBE_END(0, tid == 32)
}

// MULT + 1 warpgroups a CTA, for the rows of two key tiles or more: a
// splitter (warpgroup MULT) splits K_i and transposes V_i into buffer
// i % BUFS, and MULT multipliers (64 query rows each) run the products and
// the softmax of key tile i from that buffer while the splitter fills the
// other.  Two multipliers take turns to issue their products (named
// barriers 2 and 3), so that one's softmax runs while the other's
// products are on the tensor cores: a warp cannot queue a product's
// wgmmas ahead of its other work, so one warpgroup alone leaves the
// tensor cores idle through its softmax, and through any splitting and
// transposing, which 4 warps an SM leave latency-bound.  The splitter's
// thread 0 loads Q and the first `stages` K/V tiles; the multiplier that
// finishes Q K_i^T last refills its stage (V_i was transposed before the
// buffer was ready).  mbarriers: full (TMA), ready (a buffer is written:
// the splitter's thread 0, after a barrier of its warpgroup) and freed
// (its P V is done: the multipliers' warps).
template <int D, int DVP, int MULT>
__global__ void __launch_bounds__((MULT + 1) * THREADS, 1)
    flash_fwd_f32_ws(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tks,
                     const __grid_constant__ CUtensorMap tv,
                     float* __restrict__ o, OStrides os, int s, int dv,
                     int window, float scale_log2, Heads hd, int stages) {
  using L = Layout<D, DVP, MULT>;
  constexpr int BUFS = L::BUFS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = q_full + 1;
  uint64_t* ready = full + MAX_STAGES;
  uint64_t* freed = ready + 2;
  int* taken = reinterpret_cast<int*>(freed + 2);  // Q K^T done, a stage
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  // 0, 1: the multipliers; 2: the splitter (read from lane 0: a
  // warp-uniform branch)
  const int wg = __shfl_sync(FULL, (int)threadIdx.x >> 7, 0);
  const Tiles w(s, window, hd, L::BK, L::QROWS);
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int i = 0; i < stages; ++i) {
      bar_init(full + i, 1);
      taken[i] = 0;
    }
    for (int b = 0; b < BUFS; ++b) {
      bar_init(ready + b, 1);
      bar_init(freed + b, 4 * MULT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == MULT) {  // the splitter
    F32_PROBE_START
    if (tid == 0) {
      load_q<L>(smem, q_full, &tq, w);
      for (int i = 0; i < stages && i < w.n_tiles; ++i)
        load_tile<L, DVP>(smem, full, &tk, &tks, &tv, w, i, stages);
    }
    bar_wait(q_full, 0);
    split_tile<L::Q_BYTES>(smem + L::QB, smem + L::QS, tid);
    F32_PROBE(0);
    for (int i = 0; i < w.n_tiles; ++i) {
      const int b = i % BUFS;
      bar_wait(full + i % stages, (i / stages) & 1);
      F32_PROBE(1);
      split_key_tile<L::K_BYTES, DVP, L::BK, THREADS>(
          stage_of<L>(smem, i, stages), smem + L::ks(b), smem + L::vtb(b),
          smem + L::vts(b), tid, [&] {
            F32_PROBE(2);
            if (i >= BUFS) bar_wait(freed + b, ((i - BUFS) / BUFS) & 1);
            F32_PROBE(3);
          });
      fence_async();
      F32_PROBE(4);
      // the buffer is written, and V_i read
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (tid == 0) bar_arrive(ready + b);
      __syncwarp();
      F32_PROBE(5);
    }
    F32_PROBE_END(2, tid == 32)
    return;
  }

  // a multiplier: rows q0 + 64 wg ..; the turns: wait on barrier 2 + wg,
  // pass on 3 - wg (256 threads: both multipliers); its own barrier 4 + wg
  F32_PROBE_START
  const auto turn_wait = [wg] {
    asm volatile("bar.sync %0, 256;\n" ::"r"(2 + wg) : "memory");
  };
  const auto turn_pass = [wg] {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - wg) : "memory");
  };
  const int q0 = w.q0 + BQ * wg;
  const int row0 = q0 + 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  const uint32_t qb = smem_u32(smem + L::QB) + wg * BQ * 128;
  const uint32_t qs = smem_u32(smem + L::QS) + wg * BQ * 128;
  float acc[DVP / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) acc[i] = 0.f;
  bar_wait(q_full, 0);
  if (MULT == 2 && wg == 1) turn_pass();  // multiplier 0 issues first
  F32_PROBE(0);
  for (int i = 0; i < w.n_tiles; ++i) {
    const int b = i % BUFS;
    bar_wait(ready + b, (i / BUFS) & 1);  // and, for i = 0, Q's small part
    __syncwarp();
    F32_PROBE(1);
    key_tile<D, DVP, L>(
        smem, stage_of<L>(smem, i, stages), b, qb, qs,
        (w.t_first + i) * L::BK, q0, row0, col0, s, window, scale_log2, acc,
        m, l,
        [&] {
          if constexpr (MULT == 2) turn_wait();
        },
        [&] {
          if constexpr (MULT == 2) turn_pass();
          F32_PROBE(2);
        },
        [&] {
          F32_PROBE(3);
          asm volatile("bar.sync %0, 128;\n" ::"r"(4 + wg) : "memory");
          // K_i is read by this multiplier; the second to get here
          // refills the stage
          if (tid == 0 && atomicAdd(taken + i % stages, 1) == MULT - 1) {
            atomicExch(taken + i % stages, 0);
            if (i + stages < w.n_tiles)
              load_tile<L, DVP>(smem, full, &tk, &tks, &tv, w, i + stages,
                                stages);
          }
          __syncwarp();
          F32_PROBE(4);
        },
        [&] {
          if constexpr (MULT == 2) turn_wait();
        },
        [&] {
          // multiplier 1 passes no turn after its last product
          if (MULT == 2 && (wg == 0 || i + 1 < w.n_tiles)) turn_pass();
          F32_PROBE(5);
        });
    F32_PROBE(6);
    if (lane == 0) bar_arrive(freed + b);
    __syncwarp();
  }
  store_o<DVP>(o, os, acc, l, w, row0, col0, s, dv);
  F32_PROBE(7);
  F32_PROBE_END(wg == 0 ? 1 : 3, tid == 32)
}

// Operand `op` as a float32 tensor map in boxes of [rows][32] (128-byte
// swizzle)
int encode_f32(CUtensorMap* map, const Call& c, Operand op, int64_t cols,
               int rows) {
  return encode(map, c, op, cols, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 32,
                rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Head dim D, value dims up to DVP (a multiple of 32; V's columns past dv
// load as zeros and are not stored), one kernel (MULT: Layout's): a CTA a
// query tile, the ring as deep as the key tiles need and the layout
// allows.
template <int D, int DVP, int MULT>
int launch_k(const Call& c, cudaStream_t stream) {
  using L = Layout<D, DVP, MULT>;
  CUtensorMap tq, tk, tks, tv;
  int err = encode_f32(&tq, c, OP_Q, D, BQ);
  if (err == 0) err = encode_f32(&tk, c, OP_K, c.dk, L::BK);
  if (err == 0)
    err = c.ks ? encode_f32(&tks, c, OP_KS, c.d - c.dk, L::BK)
               : encode_f32(&tks, c, OP_K, c.dk, L::BK);  // never read
  if (err == 0) err = encode_f32(&tv, c, OP_V, c.dv, L::BK);
  if (err != 0) return err;
  decltype(&flash_fwd_f32<D, DVP>) kernel;
  if constexpr (MULT > 0) kernel = flash_fwd_f32_ws<D, DVP, MULT>;
  else kernel = flash_fwd_f32<D, DVP>;
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && !ready[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::smem(L::MAX_ST));
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  const int64_t n_kt = (c.s + L::BK - 1) / L::BK;
  const int64_t n_qt = (c.s + L::QROWS - 1) / L::QROWS;
  const int stages = (int)std::min<int64_t>(L::MAX_ST, n_kt);
  // a window of at least s masks nothing
  const int win = c.window > 0 && c.window < c.s ? (int)c.window : -1;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const int64_t* so = c.strides + 3 * OP_O;
  const OStrides os{so[0], so[1], so[2]};
  const Heads hd = heads_of(c);
  kernel<<<(unsigned)(hd.n_bh * n_qt), (MULT + 1) * THREADS, L::smem(stages),
           stream>>>(tq, tk, tks, tv, (float*)c.o, os, (int)c.s, (int)c.dv,
                     win, scale_log2, hd, stages);
  return (int)cudaGetLastError();
}

// Where the split kernels are built (d and dv <= 64: the presets' favg
// calls), rows of two key tiles take one multiplier (64-row CTAs: twice
// as many CTAs as 128-row ones, for calls of few heads) and longer rows
// two; rows of one key tile, and the other pairs, the one-warpgroup
// kernel (more CTAs an SM, no hand-off).
template <int D, int DVP>
int launch_t(const Call& c, cudaStream_t st) {
  if constexpr (D <= 64 && DVP <= 64) {
    constexpr int BK = Layout<D, DVP, 1>::BK;
    static_assert(BK == Layout<D, DVP, 2>::BK, "the split kernels' tiles");
    const int64_t n_kt = (c.s + BK - 1) / BK;
    if (n_kt == 2) return launch_k<D, DVP, 1>(c, st);
    if (n_kt > 2) return launch_k<D, DVP, 2>(c, st);
  }
  return launch_k<D, DVP, 0>(c, st);
}

// dv 16 and 32 share the 32-column V tile, 80 takes 96
template <int D>
int launch_dv(const Call& c, cudaStream_t st) {
  switch (c.dv) {
    case 16:
    case 32: return launch_t<D, 32>(c, st);
    case 64: return launch_t<D, 64>(c, st);
    case 80: return launch_t<D, 96>(c, st);
    case 128: return launch_t<D, 128>(c, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Head dims 96 (phi3-mini) and 120 (h2o-danube3) take dv == d only; MLA's
// (deepseek-v2) q.k widths take one value width each: d 48 (its smoke
// config: nope 32 + rope 16) dv 32, and d 192 (nope 128 + rope 64) dv 128.
// A shared key starts at a 32-column chunk of K.
int launch_d(const Call& c, cudaStream_t st) {
  if (c.dk % 32 != 0 && c.ks != nullptr) return (int)cudaErrorInvalidValue;
  switch (c.d) {
    case 16: return launch_dv<16>(c, st);
    case 32: return launch_dv<32>(c, st);
    case 48:
      if (c.dv == 32) return launch_t<48, 32>(c, st);
      break;
    case 64: return launch_dv<64>(c, st);
    case 80: return launch_dv<80>(c, st);
    case 96:
      if (c.dv == 96) return launch_t<96, 96>(c, st);
      break;
    case 120:
      if (c.dv == 120) return launch_t<120, 128>(c, st);
      break;
    case 128: return launch_dv<128>(c, st);
    case 192:
      if (c.dv == 128) return launch_t<192, 128>(c, st);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

// A pair's layout: its key tile, its deepest ring, and the bytes a CTA
// asks for with that ring
template <int D, int DVP>
int64_t layout_of(int64_t* bk, int64_t* stages) {
  using L = Layout<D, DVP, 0>;
  *bk = L::BK;
  *stages = L::MAX_ST;
  return L::smem(L::MAX_ST);
}

template <int D>
int64_t layout_dv(int64_t dv, int64_t* bk, int64_t* stages) {
  switch (dv) {
    case 16:
    case 32: return layout_of<D, 32>(bk, stages);
    case 64: return layout_of<D, 64>(bk, stages);
    case 80: return layout_of<D, 96>(bk, stages);
    case 128: return layout_of<D, 128>(bk, stages);
  }
  return 0;
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel (wgmma + TMA)
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int BQ = 128;                   // rows of a query tile, 64 a warpgroup
constexpr int BK = 128;                   // keys per K/V tile
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
constexpr int MAX_STAGES = 4;             // K/V ring depth, as shared memory allows
// setmaxnreg's split of the CTA's registers: the 168 a thread that
// __launch_bounds__(THREADS, 1) gives at launch (65,536 / 384, rounded
// down to a multiple of 8); an increase takes only what a decrease gave
constexpr int ENTRY_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS <=
                  ENTRY_REGS * THREADS,
              "the register split exceeds the CTA's registers");
// A third of the card's 50 MB L2: the K and V bytes of a group of heads
// whose query tiles run together (flash_fwd_tc's launch order)
constexpr int64_t GROUP_BYTES = 16 << 20;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// An operand tile [rows][width] bf16 is stored as width / CW chunks of
// [rows][CW], CW = 64 columns (128-byte rows, 128-byte swizzle) or, at
// width 32, 32 columns (64-byte rows, 64-byte swizzle), as TMA writes them.
__host__ __device__ constexpr int chunk_cols(int width) {
  return width >= 64 ? 64 : width;
}

__host__ __device__ constexpr int cap_stages(int n) {
  return n < MAX_STAGES ? n : MAX_STAGES;
}

// Shared memory: the mbarriers (the first 1024 bytes), Q (a buffer for
// each query tile of the CTA), the O staging tile and the K/V ring, a
// stage a K tile and then its V tile.  Where each warpgroup's O rows lie
// inside its own Q rows (64-column chunks, dv <= d), O is staged in its
// query tile's Q bytes: a warpgroup writes O only after its last product
// has read Q, and the other warpgroup never reads those rows.  Q may be
// double-buffered (PAIRS) where a second buffer still leaves two K/V
// stages: the ring then has STAGES2 stages, else STAGES1.  At d 192, dv
// 128 it may not (2 x 48 KB of Q and one 80 KB stage).
template <int D, int DV>
struct Layout {
  static constexpr int CQ = chunk_cols(D), CV = chunk_cols(DV);
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int O_BYTES = BQ * DV * 2;
  static constexpr int K_BYTES = BK * D * 2;
  static constexpr int V_BYTES = BK * DV * 2;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr bool O_IN_Q = CQ == 64 && CV == 64 && DV <= D;
  static constexpr int Q_OFF = 1024;  // after the barriers
  // 232448 bytes: the most dynamic shared memory a CTA may have on
  // sm_90; 1024 of alignment slack, the barriers, one Q buffer and,
  // unless it is staged in Q, O
  static constexpr int ROOM =
      232448 - 1024 - Q_OFF - Q_BYTES - (O_IN_Q ? 0 : O_BYTES);
  static constexpr int STAGES1 = cap_stages(ROOM / STAGE_BYTES);
  static constexpr int STAGES2 = cap_stages((ROOM - Q_BYTES) / STAGE_BYTES);
  static constexpr bool PAIRS = STAGES2 >= 2;
  static_assert(STAGES1 >= 2, "the K/V ring needs two stages to prefetch");
  // with q_bufs Q buffers: the ring's depth and offset, the O staging
  // tile of query tile n, and the bytes a CTA asks for (every offset a
  // multiple of 1024)
  __host__ __device__ static constexpr int stages(int q_bufs) {
    return q_bufs == 2 ? STAGES2 : STAGES1;
  }
  __host__ __device__ static constexpr int ring_off(int q_bufs) {
    return Q_OFF + q_bufs * Q_BYTES + (O_IN_Q ? 0 : O_BYTES);
  }
  __host__ __device__ static constexpr int o_off(int q_bufs, int n) {
    return Q_OFF + (O_IN_Q ? n : q_bufs) * Q_BYTES;
  }
  __host__ __device__ static constexpr int smem(int q_bufs) {
    return ring_off(q_bufs) + stages(q_bufs) * STAGE_BYTES + 1024;
  }
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

// The mbarriers, at the start of shared memory.  A full barrier
// completes when TMA has written its stage; an empty one when the eight
// consumer warps have read theirs (each warp's lane 0 arrives after its
// products' wait), or, for a Q buffer, when both consumer warpgroups'
// output stores have read the query tile's O (staged in Q's bytes or
// not) and its last Q K^T is done.
struct Barriers {
  uint64_t q_full[2], q_empty[2];
  uint64_t k_full[MAX_STAGES], v_full[MAX_STAGES];
  uint64_t k_empty[MAX_STAGES], v_empty[MAX_STAGES];
};
static_assert(sizeof(Barriers) <= 1024, "the barriers outgrow their bytes");

// A position in a K/V ring of STAGES stages: its stage and the parity of
// that stage's phase.  It runs on from one query tile to the next.
template <int STAGES>
struct Ring {
  int st = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next() {
    if (++st == STAGES) {
      st = 0;
      ph ^= 1;
    }
  }
};

// The query tiles of slot `id`, heaviest first.  Paired: two of one
// head, the heaviest and the lightest left (n_qt - 1 - p and p), or the
// middle one alone, so that every slot of a causal call walks n_qt + 1
// key tiles; else one (n_qt - 1 - p).  The slots run through the heads
// in groups of `group`, and in each group through p from the heaviest
// (every head of the group at one p before the next): a group's K and V
// stay in L2 while its query tiles read them again.  In plain
// heaviest-first order, 132 CTAs at once read 132 heads' K and V (67 MB
// at qwen3-14b's (160, 1024, 128)), more than L2 holds.  A CTA walks the
// slots blockIdx.x, + gridDim.x, ...: one a CTA unpaired; paired, one
// CTA an SM walks its share of the slots, all of one cost.  A slot's
// (batch row, query head) pair is its bh = batch * heads + head, so the
// query heads of a kv head are neighbours.
template <bool PAIRED>
struct Work {
  int batch, head, kv_head, p, n_qt;
  __device__ __forceinline__ static int slots(int s, int n_bh) {
    const int n_qt = (s + BQ - 1) / BQ;
    return n_bh * (PAIRED ? (n_qt + 1) / 2 : n_qt);
  }
  __device__ __forceinline__ Work(int id, int s, const Heads& hd,
                                  int group) {
    n_qt = (s + BQ - 1) / BQ;
    const int per_head = PAIRED ? (n_qt + 1) / 2 : n_qt;
    const int g0 = id / (group * per_head) * group;
    const int in_group = min(group, hd.n_bh - g0);
    const int i = id - g0 * per_head;
    const Head at(g0 + i % in_group, hd);
    batch = at.batch;
    head = at.head;
    kv_head = at.kv_head;
    p = PAIRED ? per_head - 1 - i / in_group : i / in_group;
  }
  __device__ __forceinline__ int tiles() const {
    return PAIRED && p != n_qt - 1 - p ? 2 : 1;
  }
  __device__ __forceinline__ int q0(int n) const {
    return (n == 0 ? n_qt - 1 - p : p) * BQ;
  }
};
// The first key tile a query tile at q0 reads (t_first: a window skips
// the tiles wholly before its first row's window) and how many it reads.
__device__ __forceinline__ int first_tile(int q0, int window) {
  return (window > 0 ? max(0, q0 - window + 1) : 0) / BK;
}
__device__ __forceinline__ int tile_count(int q0, int s, int window) {
  return (min(q0 + BQ, s) - 1) / BK - first_tile(q0, window) + 1;
}

// The producer's wait for a ring stage to empty: no timeout, which the
// 24 registers of its warpgroup do not hold.  It cannot wait forever on
// its own: the consumers release every stage they fill, and a consumer
// whose wait times out traps the grid.
__device__ __forceinline__ void wait_empty(uint64_t* bar, uint32_t parity) {
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

// The producer (one thread), query tile after query tile: the K and V
// tiles in the order the consumers read them, K_0, K_1, V_0, K_2, V_1,
// ..., each into its ring stage once both consumer warpgroups have
// released that stage's last tile, and Q after K_0, into the buffer
// (query tile j of the CTA: buffer j % Q_BUFS) that query tile j - 2
// has left.  A wait on an empty barrier's first phase (parity 1) passes.
template <int D, int DV, bool PAIRED>
__device__ __forceinline__ void produce(uint8_t* smem, Barriers& b,
                                        const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tks,
                                        const CUtensorMap* tv, int s,
                                        int window, const Heads& hd,
                                        int group) {
  using L = Layout<D, DV>;
  constexpr int CQ = L::CQ, CV = L::CV, Q_BUFS = PAIRED ? 2 : 1;
  uint8_t* ring = smem + L::ring_off(Q_BUFS);
  Ring<L::stages(Q_BUFS)> kr, vr;
  Ring<Q_BUFS> qr;  // the Q buffer of the next query tile
  for (int id = blockIdx.x; id < Work<PAIRED>::slots(s, hd.n_bh);
       id += gridDim.x) {
    const Work<PAIRED> w(id, s, hd, group);
    for (int n = 0; n < w.tiles(); ++n) {
      const int q0 = w.q0(n), t_first = first_tile(q0, window);
      const int n_tiles = tile_count(q0, s, window);
      for (int i = 0; i <= n_tiles; ++i) {
        if (i < n_tiles) {
          wait_empty(&b.k_empty[kr.st], kr.ph ^ 1);
          bar_expect_tx(&b.k_full[kr.st], L::K_BYTES);
          // K's chunks past its own dk columns: the shared key's
          for (int c = 0; c < D / CQ; ++c) {
            uint8_t* dst = ring + kr.st * L::STAGE_BYTES + c * BK * CQ * 2;
            if (c * CQ < hd.dk)
              tma_load(dst, tk, &b.k_full[kr.st], c * CQ, (t_first + i) * BK,
                       w.kv_head, w.batch);
            else
              tma_load(dst, tks, &b.k_full[kr.st], c * CQ - hd.dk,
                       (t_first + i) * BK, w.batch);
          }
          kr.next();
        }
        if (i == 0) {
          wait_empty(&b.q_empty[qr.st], qr.ph ^ 1);
          bar_expect_tx(&b.q_full[qr.st], L::Q_BYTES);
          for (int c = 0; c < D / CQ; ++c)
            tma_load(smem + L::Q_OFF + qr.st * L::Q_BYTES + c * BQ * CQ * 2,
                     tq, &b.q_full[qr.st], c * CQ, q0, w.head, w.batch);
          qr.next();
        } else {
          wait_empty(&b.v_empty[vr.st], vr.ph ^ 1);
          bar_expect_tx(&b.v_full[vr.st], L::V_BYTES);
          for (int c = 0; c < DV / CV; ++c)
            tma_load(ring + vr.st * L::STAGE_BYTES + L::K_BYTES +
                         c * BK * CV * 2,
                     tv, &b.v_full[vr.st], c * CV, (t_first + i - 1) * BK,
                     w.kv_head, w.batch);
          vr.next();
        }
      }
    }
  }
}

// A consumer warpgroup: for each of the CTA's query tiles, rows r_wg ..
// r_wg + 63 over its key tiles, then the epilogue.  S_i = Q K_i^T and
// P_{i-1} V_{i-1} are issued together, and the softmax of tile i runs
// while P_{i-1} V_{i-1} is on the tensor cores; the rescale by alpha_i
// follows that product, so the accumulator sums what the serial order
// sums, in its order.  Named barriers 1 and 2 hand the turn to issue
// between the warpgroups, so that one's softmax overlaps the other's
// products (each warpgroup takes n_tiles turns a query tile and passes
// each on, but for warpgroup 1's last; warpgroup 1 passes first, so 0
// starts).  Both warpgroups walk the query tile's n_tiles, also one whose
// rows all lie past s.
template <int D, int DV, bool PAIRED>
__device__ __forceinline__ void consume(uint8_t* smem, Barriers& b,
                                        const CUtensorMap* to, int wg, int s,
                                        int window, float scale_log2,
                                        const Heads& hd, int group) {
  using L = Layout<D, DV>;
  constexpr int CQ = L::CQ, CV = L::CV, Q_BUFS = PAIRED ? 2 : 1;
  // at dv 128 a timed-out wait traps through a call (hopper.cuh)
  constexpr bool OUT_OF_LINE = DV > 64;
  const uint32_t ring = smem_u32(smem + L::ring_off(Q_BUFS));
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int col0 = 2 * (lane & 3);
  const auto turn_wait = [&] {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  };
  const auto turn_pass = [&] {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
  };
  const auto release = [&](uint64_t* bar) {
    if (lane == 0) bar_arrive(bar);
    __syncwarp();
  };

  Ring<L::stages(Q_BUFS)> cur;  // the K (and V) tile of the next Q K^T
  Ring<Q_BUFS> qr;                // the Q buffer of the next query tile
  for (int id = blockIdx.x; id < Work<PAIRED>::slots(s, hd.n_bh);
       id += gridDim.x) {
    const Work<PAIRED> w(id, s, hd, group);
    for (int n = 0; n < w.tiles(); ++n) {
      const int q0 = w.q0(n), t_first = first_tile(q0, window);
      const int n_tiles = tile_count(q0, s, window);
      const int r_wg = q0 + wg * 64;
      // accumulator fragments: this thread holds rows row0 and row0 + 8
      // and, in every 8-column block j, columns 8j + col0 and 8j + col0 + 1
      const int row0 = r_wg + warp * 16 + (lane >> 2);
      const int qb = qr.st;
      const uint32_t sq =
          smem_u32(smem + L::Q_OFF + qb * L::Q_BYTES) + wg * 64 * CQ * 2;
      float acc[DV / 2], sc[BK / 2], m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f}, alpha[2];
      uint32_t pa[BK / 4];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
      bar_wait<OUT_OF_LINE>(&b.q_full[qb], qr.ph);
      qr.next();
      __syncwarp();  // reconverge before the warpgroup-wide instructions

      if (wg == 1) turn_pass();
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      bar_wait<OUT_OF_LINE>(&b.k_full[cur.st], cur.ph);
      __syncwarp();
      turn_wait();
      pin(sc);
      wg_fence();
      issue_qk<D>(sc, sq, ring + cur.st * L::STAGE_BYTES);
      wg_commit();
      if (wg == 0 || n_tiles > 1) turn_pass();
      wg_wait_all();
      pin(sc);
      release(&b.k_empty[cur.st]);
      softmax_exp(sc, m, l, alpha, t_first * BK, r_wg, row0, col0, s, window,
                  scale_log2);
      pack_rescale<DV>(sc, acc, pa, alpha);
      auto prv = cur;  // the V tile of the next P V
      cur.next();
      for (int i = 1; i < n_tiles; ++i) {
        bar_wait<OUT_OF_LINE>(&b.k_full[cur.st], cur.ph);
        bar_wait<OUT_OF_LINE>(&b.v_full[prv.st], prv.ph);
        __syncwarp();
        turn_wait();
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
        pin(sc);
        pin(acc);
        pin(pa);
        // the operands' addresses anew at each issue, so that their
        // descriptors are not kept live through the softmax
        uint32_t q_at = sq, k_at = ring + cur.st * L::STAGE_BYTES,
                 v_at = ring + prv.st * L::STAGE_BYTES + L::K_BYTES;
        asm volatile("" : "+r"(q_at), "+r"(k_at), "+r"(v_at));
        wg_fence();
        issue_qk<D>(sc, q_at, k_at);
        wg_commit();
        issue_pv<DV>(acc, pa, v_at);
        wg_commit();
        if (wg == 0 || i + 1 < n_tiles) turn_pass();
        wg_wait_one();  // S_i is in; P_{i-1} V_{i-1} may still run
        pin(sc);
        release(&b.k_empty[cur.st]);
        softmax_exp(sc, m, l, alpha, (t_first + i) * BK, r_wg, row0, col0, s,
                    window, scale_log2);
        wg_wait_all();
        pin(acc);
        pin(pa);
        release(&b.v_empty[prv.st]);
        pack_rescale<DV>(sc, acc, pa, alpha);
        prv = cur;
        cur.next();
      }
      bar_wait<OUT_OF_LINE>(&b.v_full[prv.st], prv.ph);
      __syncwarp();
      pin(acc);
      pin(pa);
      wg_fence();
      issue_pv<DV>(acc, pa, ring + prv.st * L::STAGE_BYTES + L::K_BYTES);
      wg_commit();
      wg_wait_all();
      pin(acc);
      pin(pa);
      release(&b.v_empty[prv.st]);

      // ---- epilogue: o = acc / max(l, 1e-30), bf16, into shared memory
      // in the layout (and swizzle) TMA reads, then one bulk store per
      // column chunk; TMA drops the rows past s ----
      uint8_t* so = smem + L::o_off(Q_BUFS, qb);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sum = l[h];
        sum += __shfl_xor_sync(FULL, sum, 1);
        sum += __shfl_xor_sync(FULL, sum, 2);
        const float inv = 1.f / fmaxf(sum, 1e-30f);
        const int r = row0 + 8 * h - q0;  // row within the query tile
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
          tma_store(to, so + c * BQ * CV * 2 + wg * 64 * CV * 2, c * CV, r_wg,
                    w.head, w.batch);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        bar_arrive(&b.q_empty[qb]);  // a later query tile may take them
      }
    }
  }
}

// Warp specialisation in one top-level branch on the warpgroup, so that
// ptxas knows the register count at each setmaxnreg (168 at entry, from
// __launch_bounds__(384, 1)): the producer warpgroup's four warps drop to
// PRODUCER_REGS and one thread loads; the consumer warpgroups rise to
// CONSUMER_REGS.  The named barriers (turns 1 and 2, epilogue 3 and 4)
// count consumer threads only.
template <int D, int DV, bool PAIRED>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tks,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to, int s, int window,
                 float scale_log2, Heads hd, int group) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Barriers& b = *reinterpret_cast<Barriers*>(smem);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      bar_init(&b.q_full[i], 1);
      bar_init(&b.q_empty[i], CONSUMERS / 128);
    }
    for (int i = 0; i < MAX_STAGES; ++i) {
      bar_init(&b.k_full[i], 1);
      bar_init(&b.v_full[i], 1);
      bar_init(&b.k_empty[i], CONSUMERS / 32);
      bar_init(&b.v_empty[i], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // 0 and 1: consumers; 2: the producer.  Read from lane 0, so that
  // ptxas sees a warp-uniform branch
  const int wg = __shfl_sync(FULL, (int)threadIdx.x >> 7, 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS)
      produce<D, DV, PAIRED>(smem, b, &tq, &tk, &tks, &tv, s, window, hd,
                             group);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume<D, DV, PAIRED>(smem, b, &to, wg, s, window, scale_log2, hd,
                           group);
  }
}

// Operand `op` as a bf16 tensor map in boxes of `rows` x one swizzle
// chunk of a tile `width` columns wide (width >= cols)
int encode_bf16(CUtensorMap* map, const Call& c, Operand op, int64_t cols,
                int width, int rows) {
  const int cw = chunk_cols(width);
  return encode(map, c, op, cols, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, cw,
                rows,
                cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B);
}

// One query tile a CTA (PAIRED false) or two: the kernel for the
// layout, its shared memory set once a device, launched on the grid.
template <int D, int DV, bool PAIRED>
int launch_grid(const CUtensorMap& tq, const CUtensorMap& tk,
                const CUtensorMap& tks, const CUtensorMap& tv,
                const CUtensorMap& to, int64_t n_cta, int64_t s, int win,
                float scale_log2, const Heads& hd, int64_t group,
                cudaStream_t stream) {
  constexpr int SMEM = Layout<D, DV>::smem(PAIRED ? 2 : 1);
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && !ready[dev]) {
    e = cudaFuncSetAttribute(flash_fwd_tc<D, DV, PAIRED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  flash_fwd_tc<D, DV, PAIRED><<<(unsigned)n_cta, THREADS, SMEM, stream>>>(
      tq, tk, tks, tv, to, (int)s, win, scale_log2, hd, (int)group);
  return (int)cudaGetLastError();
}

// Tiles D and DV wide for head dims d <= D and dv <= DV: the columns past
// d and dv load as zeros (adding nothing to q.k or to p.v) and the bulk
// store drops them.  A shared key starts at a chunk of K.
template <int D, int DV>
int launch_t(const Call& c, cudaStream_t stream) {
  using L = Layout<D, DV>;
  if (c.ks != nullptr && c.dk % L::CQ != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tks, tv, to;
  int err = encode_bf16(&tq, c, OP_Q, c.d, D, BQ);
  if (err == 0) err = encode_bf16(&tk, c, OP_K, c.dk, D, BK);
  if (err == 0)
    err = c.ks ? encode_bf16(&tks, c, OP_KS, c.d - c.dk, D, BK)
               : encode_bf16(&tks, c, OP_K, c.dk, D, BK);  // never read
  if (err == 0) err = encode_bf16(&tv, c, OP_V, c.dv, DV, BK);
  if (err == 0) err = encode_bf16(&to, c, OP_O, c.dv, DV, 64);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const Heads hd = heads_of(c);
  const int64_t s = c.s, bh = hd.n_bh;
  // a window of at least s masks nothing
  const int win = c.window > 0 && c.window < s ? (int)c.window : -1;
  // Pairs of query tiles, one CTA an SM, where the layout holds two Q
  // buffers and the call is causal (every pair walks n_qt + 1 key tiles;
  // under a window pairs differ), unless the pairs walk over 5% more key
  // tiles an SM than single tiles spread evenly: there heaviest-first
  // single tiles, a CTA each, balance better (tools/flash_ab.py, NVIDIA
  // H100 80GB HBM3: pairs 2.6% slower at (56, 1024, 64), 224 pairs on
  // 132 SMs, 18 tiles an SM against 16; faster at qwen3-14b's,
  // qwen2-vl-72b's, phi3-mini's, zamba2's, qwen2-moe's and whisper's)
  const int64_t n_qt = (s + BQ - 1) / BQ, n_pairs = bh * ((n_qt + 1) / 2);
  const int64_t pair_tiles = (n_pairs + sms - 1) / sms * (n_qt + 1);
  const int64_t single_tiles = (bh * n_qt * (n_qt + 1) / 2 + sms - 1) / sms;
  const bool paired =
      L::PAIRS && win < 0 && pair_tiles * 20 <= single_tiles * 21;
  // the query heads of the kv heads whose K and V (s * (d + dv) bf16
  // each) fit in GROUP_BYTES
  const int64_t group = std::min<int64_t>(
      bh, std::max<int64_t>(1, GROUP_BYTES / (s * (c.d + c.dv) * 2)) * hd.g);
  // the scale of the real head dim, not of the tile
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)c.d));
  if constexpr (L::PAIRS) {   // one CTA an SM walks its share of pairs
    if (paired)
      return launch_grid<D, DV, true>(tq, tk, tks, tv, to,
                                      std::min<int64_t>(n_pairs, sms), s,
                                      win, scale_log2, hd, group, stream);
  }
  return launch_grid<D, DV, false>(tq, tk, tks, tv, to, bh * n_qt, s, win,
                                   scale_log2, hd, group, stream);
}

// Head dims 80, 96 and 120 run in the 128-column tile (two 64-column
// chunks, 128-byte swizzle), their columns d-127 zero-filled by TMA: 1.6x,
// 1.33x and 1.07x the products of an exact tile, and no new kernel
// instantiation.  The tensor maps' row strides, 160, 192 and 240 bytes
// in a contiguous (BH, S, d) operand, are multiples of 16, as TMA
// requires.
template <int D>
int launch_dv(const Call& c, cudaStream_t st) {
  switch (c.dv) {
    case 32: return launch_t<D, 32>(c, st);
    case 64: return launch_t<D, 64>(c, st);
    case 80:
    case 96:
    case 120:
    case 128: return launch_t<D, 128>(c, st);
  }
  return (int)cudaErrorInvalidValue;
}

// MLA's (192, 128) (deepseek-v2) is its own instantiation: Q and K in
// three 64-column chunks, 12 k-steps of Q K^T, 384-byte tensor-map rows
// in a contiguous (BH, S, d) operand (a multiple of 16, as TMA
// requires), O staged in Q's bytes (Layout).
int launch_d(const Call& c, cudaStream_t st) {
  switch (c.d) {
    case 32: return launch_dv<32>(c, st);
    case 64: return launch_dv<64>(c, st);
    case 80:
    case 96:
    case 120:
    case 128: return launch_dv<128>(c, st);
    case 192:
      if (c.dv == 128) return launch_t<192, 128>(c, st);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

// A pair's layout with one query tile a CTA (its deepest ring)
template <int D, int DV>
int64_t layout_of(int64_t* stages) {
  *stages = Layout<D, DV>::STAGES1;
  return Layout<D, DV>::smem(1);
}

template <int D>
int64_t layout_dv(int64_t dv, int64_t* stages) {
  switch (dv) {
    case 32: return layout_of<D, 32>(stages);
    case 64: return layout_of<D, 64>(stages);
    case 80:
    case 96:
    case 120:
    case 128: return layout_of<D, 128>(stages);
  }
  return 0;
}

}  // namespace tc
}  // namespace

// The bfloat16 kernel's dynamic shared memory per CTA at (d, dv), in
// bytes, and its K/V ring depth in *stages (0: not a supported pair),
// with one query tile a CTA.
extern "C" int64_t flash_attention_layout(int64_t d, int64_t dv,
                                          int64_t* stages) {
  *stages = 0;
  switch (d) {
    case 32: return tc::layout_dv<32>(dv, stages);
    case 64: return tc::layout_dv<64>(dv, stages);
    case 80:
    case 96:
    case 120:
    case 128: return tc::layout_dv<128>(dv, stages);
    case 192:
      return dv == 128 ? tc::layout_of<192, 128>(stages) : 0;
  }
  return 0;
}

// The bfloat16 kernel's threads a CTA, as the <128, 128> instantiation
// (pairs of query tiles) was compiled (cudaFuncGetAttributes; 0 on an
// error), and in *producer_regs, *consumer_regs the registers a thread
// that setmaxnreg gives the producer warpgroup and each consumer
// warpgroup; in *entry_regs the registers a thread at launch.
extern "C" int64_t flash_attention_threads(int64_t* producer_regs,
                                           int64_t* consumer_regs,
                                           int64_t* entry_regs) {
  *producer_regs = tc::PRODUCER_REGS;
  *consumer_regs = tc::CONSUMER_REGS;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, tc::flash_fwd_tc<128, 128, true>) !=
      cudaSuccess)
    return 0;
  *entry_regs = attr.numRegs;
  return attr.maxThreadsPerBlock;
}

// The float32 kernel at (d, dv): its key tile in *bk, its deepest K/V
// ring in *stages, and the dynamic shared memory per CTA with that ring,
// in bytes (0: not a supported pair).
extern "C" int64_t flash_attention_f32_layout(int64_t d, int64_t dv,
                                              int64_t* bk, int64_t* stages) {
  *bk = *stages = 0;
  switch (d) {
    case 16: return f32::layout_dv<16>(dv, bk, stages);
    case 32: return f32::layout_dv<32>(dv, bk, stages);
    case 48: return dv == 32 ? f32::layout_of<48, 32>(bk, stages) : 0;
    case 64: return f32::layout_dv<64>(dv, bk, stages);
    case 80: return f32::layout_dv<80>(dv, bk, stages);
    case 96: return dv == 96 ? f32::layout_of<96, 96>(bk, stages) : 0;
    case 120: return dv == 120 ? f32::layout_of<120, 128>(bk, stages) : 0;
    case 128: return f32::layout_dv<128>(dv, bk, stages);
    case 192: return dv == 128 ? f32::layout_of<192, 128>(bk, stages) : 0;
  }
  return 0;
}

// q (batch, s, heads, d), k (batch, s, kv_heads, dk), v (batch, s,
// kv_heads, dv), ks (batch, s, d - dk) or null (dk == d), o (batch, s,
// heads, dv), each 16-byte aligned with a unit last stride and its
// strides (row, head, batch of q, k, v, ks, o; 15 values, in elements) in
// `strides`, multiples of 16 bytes; of one type (dtype 0: float32,
// 3xTF32; 1: bfloat16), both on the tensor cores; heads a multiple of
// kv_heads.  window <= 0: none.  Returns cudaGetLastError() (or the error
// of the attribute call, of the tensor-map encoding, or of an operand it
// does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* ks,
                                      void* o, const int64_t* strides,
                                      int64_t batch, int64_t heads,
                                      int64_t kv_heads, int64_t s, int64_t d,
                                      int64_t dk, int64_t dv, int64_t window,
                                      int64_t dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || (ks == nullptr) != (dk == d))
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)ks |
        (uintptr_t)o) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;  // TMA reads 16-byte aligned
  const Call c{q, k, v, ks, o, strides, batch, heads, kv_heads,
               s, d, dk, dv, window};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return f32::launch_d(c, st);
  if (dtype == 1) return tc::launch_d(c, st);
  return (int)cudaErrorInvalidValue;
}
