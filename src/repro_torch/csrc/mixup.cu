// Two-way Mixup batch transform (eq. 6 / 7 of Mix2FLD):
//
//   out[i, :] = lam_a[i] * a[i, :] + lam_b[i] * b[i, :]
//
// Replaces the Pallas kernel src/repro/kernels/mixup_kernel.py
// (_mixup_kernel, launched by mixup_pallas).  That kernel pads the
// operands to 256 x 512 VMEM tiles; here each CTA takes whole rows and
// masks nothing: the ragged end of a row is a scalar tail.
//
// Bound on the H100: bytes.  Each element reads a and b and writes out
// (3 elements moved for 3 flops), far below the card's ridge point; at
// the round loop's (100, 784) float32 the 0.9 MB take 0.28 us at
// 3.35 TB/s, so the call sits at the launch floor and the kernel only
// has to keep each thread's work short.  A CTA loads its row's two
// ratios once into registers, and each thread moves 16 bytes of a, b and
// out (a float4, or eight bfloat16) with no index arithmetic beyond the
// row's base.  A row longer than one CTA's 16-byte slots (the cifar rows
// of 3072 float32, the speech rows of 1280) is split over several CTAs
// (blockIdx.y), so that a thread moves one vector, not a chain of them.
// Where a row's three bases are not at the same offset within 16 bytes
// (an odd F, or a view that starts mid-row), the row is done element by
// element; where they are, only the elements before the first 16-byte
// boundary and after the last one are, by the row's first CTA.
//
// The ratios are float32 and the math runs in float32; bfloat16 operands
// are widened and the result rounded to nearest even.  __fmul_rn /
// __fadd_rn keep nvcc from contracting the two products into an FMA, so
// the result is bit-equal to the reference's mul-then-add.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mix(float la, float x, float lb, float y) {
  return __fadd_rn(__fmul_rn(la, x), __fmul_rn(lb, y));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of a and b at p, q into 16 bytes at r.
__device__ __forceinline__ void mix16(const float* p, const float* q,
                                      float* r, float la, float lb) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const float4 y = *reinterpret_cast<const float4*>(q);
  *reinterpret_cast<float4*>(r) =
      make_float4(mix(la, x.x, lb, y.x), mix(la, x.y, lb, y.y),
                  mix(la, x.z, lb, y.z), mix(la, x.w, lb, y.w));
}
__device__ __forceinline__ void mix16(const __nv_bfloat16* p,
                                      const __nv_bfloat16* q,
                                      __nv_bfloat16* r, float la, float lb) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint4 y = *reinterpret_cast<const uint4*>(q);
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
  uint4 z;
  __nv_bfloat162* z2 = reinterpret_cast<__nv_bfloat162*>(&z);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(x2[i]);
    const float2 yf = __bfloat1622float2(y2[i]);
    z2[i] = __floats2bfloat162_rn(mix(la, xf.x, lb, yf.x),
                                  mix(la, xf.y, lb, yf.y));
  }
  *reinterpret_cast<uint4*>(r) = z;
}

template <typename T>
__global__ void mixup_rows_kernel(const T* __restrict__ a,
                                  const T* __restrict__ b,
                                  const float* __restrict__ lam_a,
                                  const float* __restrict__ lam_b,
                                  T* __restrict__ out, int64_t n, int64_t f) {
  constexpr int VEC = 16 / sizeof(T);
  for (int64_t row = blockIdx.x; row < n; row += gridDim.x) {
    const float la = lam_a[row], lb = lam_b[row];
    const T* ar = a + row * f;
    const T* br = b + row * f;
    T* orow = out + row * f;
    const uintptr_t off = (uintptr_t)ar & 15;
    const bool vec =
        ((uintptr_t)br & 15) == off && ((uintptr_t)orow & 15) == off;
    // [0, head): before the first 16-byte boundary; [tail, f): after the last
    const int64_t lead = (int64_t)(((16 - off) & 15) / sizeof(T));
    const int64_t head = !vec ? f : lead < f ? lead : f;
    const int64_t tail = head + (f - head) / VEC * VEC;
    const int64_t part = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
    for (int64_t i = head + part * VEC; i < tail;
         i += (int64_t)gridDim.y * blockDim.x * VEC)
      mix16(ar + i, br + i, orow + i, la, lb);
    if (blockIdx.y != 0) continue;
    for (int64_t i = threadIdx.x; i < head; i += blockDim.x)
      store(orow + i, mix(la, to_f(ar[i]), lb, to_f(br[i])));
    for (int64_t i = tail + threadIdx.x; i < f; i += blockDim.x)
      store(orow + i, mix(la, to_f(ar[i]), lb, to_f(br[i])));
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* lam_a,
           const void* lam_b, void* out, int64_t n, int64_t f,
           cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  // one thread per 16 bytes of a row (and one for its ends), in whole
  // warps; a row past 256 threads' vectors takes several CTAs
  int64_t threads = (f / VEC + 2 + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  int64_t parts = (f / VEC + threads - 1) / threads;
  if (parts > 16) parts = 16;
  if (parts < 1) parts = 1;
  const int64_t blocks = n < 132 * 16 ? n : 132 * 16;  // rows loop beyond this
  mixup_rows_kernel<T><<<dim3((unsigned)blocks, (unsigned)parts),
                         (unsigned)threads, 0, s>>>(
      (const T*)a, (const T*)b, (const float*)lam_a, (const float*)lam_b,
      (T*)out, n, f);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int mixup_launch(const void* a, const void* b, const void* lam_a,
                            const void* lam_b, void* out, int64_t n,
                            int64_t f, int64_t dtype, void* stream) {
  if (n <= 0 || f <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(a, b, lam_a, lam_b, out, n, f, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, lam_a, lam_b, out, n, f, s);
  return (int)cudaErrorInvalidValue;
}
