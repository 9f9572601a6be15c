// Hopper building blocks shared by the port's tensor-core kernels
// (flash_attention.cu, ssd_scan.cu): mbarriers, TMA tensor copies, wgmma
// shared-memory descriptors and fences, the float32 tiles and 3xTF32
// products of both kernels' float32 routes, and cuTensorMapEncodeTiled,
// fetched through cudaGetDriverEntryPoint (the libraries link no
// libcuda).  runtime.py hashes every header of csrc/ into each library's
// build key, so an edit here rebuilds both.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers ----
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// The timeout's trap, out of line.  Inlined into code after a
// setmaxnreg.inc, a trap keeps ptxas from allocating more registers than
// a thread has at launch (flash_attention.cu's consumer warpgroups
// spilled and had every wgmma serialised at dv 128); called, it does not.
__device__ __noinline__ void wait_timed_out() { __trap(); }

// Wait for the phase of the given parity to complete.  A wait that has
// not completed after ~2^34 cycles (seconds) traps instead of hanging;
// OUT_OF_LINE: through wait_timed_out, for code after a setmaxnreg.inc.
template <bool OUT_OF_LINE = false>
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    else if (now - start > (1ll << 34)) {
      if constexpr (OUT_OF_LINE) wait_timed_out();
      else __trap();
    }
  }
}

// ---- TMA: boxes of a (bh, s, cols) tensor to shared memory ----
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(bh)
      : "memory");
}
// ... and of a (batch, heads, s, cols) tensor (flash_attention.cu's
// operands in their own strides)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(head),
      "r"(batch)
      : "memory");
}
// A bulk copy of `bytes` contiguous bytes (a multiple of 16, both ends
// 16-byte aligned) to shared memory, completing on bar's transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// A box of a (batch, heads, s, cols) tensor from shared memory
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int row,
                                          int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"((uint64_t)map),
      "r"(smem_u32(src)), "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// ---- wgmma ----
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle, in bytes (128: layout 1, 64:
// layout 2).  The tiles are 1024-byte aligned, so
// the base offset is 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : 2;
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_one() {  // all but the newest group
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Pin registers at this point of the program: the compiler may neither
// move their reads or writes across an asynchronous wgmma's issue or wait
// nor give them to other values while a wgmma still reads them.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ---- float32 operands of TF32 wgmma (ssd_scan.cu; flash_attention.cu's
// float32 route) ----
// Byte offset of element (r, k) of a [rows][width] float32 tile stored
// as width / 32 chunks of [rows][32] in TMA's 128-byte swizzle (chunks
// 1024-byte aligned).
__device__ __forceinline__ int swz(int r, int k, int rows) {
  return (k >> 5) * rows * 128 + r * 128 +
         ((((k & 31) >> 2) ^ (r & 7)) << 4) + ((k & 3) << 2);
}
// K-major TF32 operand of `rows` rows in those chunks: k-step kk (8
// columns, 32 bytes).
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int kk, int rows) {
  return make_desc(base + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024,
                   128);
}

// The part of v that a TF32 read of v drops (exact in float32).
__device__ __forceinline__ float tf32_rest(float v) {
  return v - __uint_as_float(__float_as_uint(v) & 0xffffe000u);
}
__device__ __forceinline__ float4 tf32_rest(float4 v) {
  return make_float4(tf32_rest(v.x), tf32_rest(v.y), tf32_rest(v.z),
                     tf32_rest(v.w));
}

__device__ __forceinline__ void fence_async() {  // generic writes -> wgmma
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// d (+)= A(64x8, registers) . B(Nx8, smem desc)^T, TF32, N = 2 x d's size
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
__device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
__device__ __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4],
                                    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, "
      "{%48, %49, %50, %51}, %52, 1, 1, 1;\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
// d (+)= A(64x8, smem desc) . B(Nx8, smem desc)^T, TF32, both K-major
__device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "%16, %17, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b));
}

// 3xTF32: d += a.b as small.big + big.small + big.big, A's two parts
// given (a, and its tf32_rest).  A fragment: a[0] (row g, k t), a[1]
// (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4), rows 16 warp + g,
// g = lane / 4, t = lane % 4.  The caller splits every A operand of a
// batch of products before the first is issued and pins both parts
// after the wait: registers that an issued wgmma still reads must not be
// reused, or ptxas waits for it before the reuse.
template <int NH>
__device__ __forceinline__ void mma3(float (&d)[NH], const float (&a)[4],
                                     const float (&rest)[4], uint64_t b_big,
                                     uint64_t b_small) {
  const uint32_t hi[4] = {__float_as_uint(a[0]), __float_as_uint(a[1]),
                          __float_as_uint(a[2]), __float_as_uint(a[3])};
  const uint32_t lo[4] = {__float_as_uint(rest[0]), __float_as_uint(rest[1]),
                          __float_as_uint(rest[2]), __float_as_uint(rest[3])};
  mma(d, lo, b_big);
  mma(d, hi, b_small);
  mma(d, hi, b_big);
}
// The same with A in shared memory too: its big and small parts' tiles.
template <int NH>
__device__ __forceinline__ void mma3(float (&d)[NH], uint64_t a_big,
                                     uint64_t a_small, uint64_t b_big,
                                     uint64_t b_small) {
  mma(d, a_small, b_big);
  mma(d, a_big, b_small);
  mma(d, a_big, b_big);
}
template <int M>
__device__ __forceinline__ void split(const float (&a)[M][4],
                                      float (&rest)[M][4]) {
#pragma unroll
  for (int j = 0; j < M; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) rest[j][i] = tf32_rest(a[j][i]);
}
template <int M>
__device__ __forceinline__ void pin(float (&r)[M][4]) {
#pragma unroll
  for (int j = 0; j < M; ++j) pin(r[j]);
}

// A [KEYS][ROWS] float32 tile (as TMA wrote it) -> its transpose [ROWS]
// [KEYS], big and small parts, by NC threads, the keys of each group of
// 8 in the order 0 2 4 6 1 3 5 7: a TF32 A fragment holds columns t and
// t + 4 of each 8, a score accumulator columns 2t and 2t + 1, so a
// product with the transpose as its B operand takes the accumulator as
// its A fragment in place.
template <int ROWS, int KEYS, int NC>
__device__ __forceinline__ void transpose_split(const uint8_t* xs,
                                                uint8_t* big, uint8_t* small,
                                                int tid) {
  for (int it = tid; it < ROWS * (KEYS / 4); it += NC) {
    const int p = it % ROWS, grp = it / ROWS;  // grp: 8-key group and half
    const int k = 4 * grp;                     // = 8 (grp / 2) + 4 (grp % 2)
    const int key0 = 8 * (grp >> 1) + (grp & 1);
    float4 v;
    v.x = *reinterpret_cast<const float*>(xs + swz(key0, p, KEYS));
    v.y = *reinterpret_cast<const float*>(xs + swz(key0 + 2, p, KEYS));
    v.z = *reinterpret_cast<const float*>(xs + swz(key0 + 4, p, KEYS));
    v.w = *reinterpret_cast<const float*>(xs + swz(key0 + 6, p, KEYS));
    *reinterpret_cast<float4*>(big + swz(p, k, ROWS)) = v;
    *reinterpret_cast<float4*>(small + swz(p, k, ROWS)) = tf32_rest(v);
  }
}

// ---- host ----
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace hopper
