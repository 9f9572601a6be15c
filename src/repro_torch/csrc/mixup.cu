// Two-way Mixup batch transform (eq. 6 / 7 of Mix2FLD):
//
//   out[i, :] = lam_a[i] * a[i, :] + lam_b[i] * b[i, :]
//
// Replaces the Pallas kernel src/repro/kernels/mixup_kernel.py
// (_mixup_kernel, launched by mixup_pallas).  That kernel pads the
// operands to 256 x 512 VMEM tiles; here one grid-stride loop runs over
// the N * F elements and the ragged tail is simply out of the loop.
//
// Bound on the H100: bytes.  Each element reads a and b and writes out
// (3 elements moved for 3 flops), far below the card's ridge point, so
// the kernel keeps every load coalesced and does nothing else.  The
// ratios are float32 and the math runs in float32; bfloat16 operands are
// widened and the result rounded with the intrinsics.  __fmul_rn /
// __fadd_rn keep nvcc from contracting the two products into an FMA, so
// the result rounds exactly as the reference's mul-then-add.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i,
                                        float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void mixup_kernel(const T* __restrict__ a, const T* __restrict__ b,
                             const float* __restrict__ lam_a,
                             const float* __restrict__ lam_b,
                             T* __restrict__ out, int64_t n, int64_t f) {
  const int64_t total = n * f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t row = i / f;
    const float v = __fadd_rn(__fmul_rn(lam_a[row], load_f(a, i)),
                              __fmul_rn(lam_b[row], load_f(b, i)));
    store_f(out, i, v);
  }
}

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int mixup_launch(const void* a, const void* b, const void* lam_a,
                            const void* lam_b, void* out, int64_t n,
                            int64_t f, int64_t dtype, void* stream) {
  const int threads = 256;
  const int64_t total = n * f;
  if (total <= 0) return 0;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond this
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    mixup_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)a, (const float*)b, (const float*)lam_a,
        (const float*)lam_b, (float*)out, n, f);
  } else if (dtype == 1) {
    mixup_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
        (const float*)lam_a, (const float*)lam_b, (__nv_bfloat16*)out, n,
        f);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
