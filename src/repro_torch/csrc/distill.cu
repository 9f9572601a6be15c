// Per-sample distillation terms of eq. (3) of Mix2FLD, their backward,
// and the fused forward-only loss.
//
// Row i has logits z (C classes), label y and KD target row g:
//
//   phi = lse(z) - z[y]                 psi = sum(g) * lse(z) - g . z
//   dz  = dphi * (softmax(z) - onehot(y)) + dpsi * (sum(g) * softmax(z) - g)
//   dg  = dpsi * (lse(z) - z)
//   loss = phi + beta * (lse(z) - g . z)    (rows of g assumed to sum to 1)
//
// Replaces the Pallas kernels of src/repro/kernels/distill_loss.py:
// _phi_psi_kernel (launched by _phi_psi_fwd_call),
// _phi_psi_bwd_kernel (launched by _phi_psi_bwd_call) and
// _distill_kernel (launched by distill_loss_pallas).  Those run
// 128-row VMEM blocks over the whole class dim; here one warp owns one
// row, its 32 lanes stride over the C classes (any C works, the tail
// lanes just hold the identity of each reduction), and warp shuffles
// reduce the max, the exp-sum, sum(g), g . z and z[y] without shared
// memory.  The backward recomputes the softmax from z instead of saving
// it, as the Pallas backward does.
//
// Bound on the H100: bytes.  The forward reads z and g (2 N C floats)
// and y, and writes 2 N floats; the backward also reads dphi, dpsi and
// writes dz and dg.  At C = 10 most lanes of a warp idle, which costs
// issue slots but no extra bytes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct RowStats {
  float m, s;  // max and sum(exp(z - m)) of the row
};

__device__ __forceinline__ RowStats row_stats(const float* z, int c,
                                              int lane) {
  float m = -INFINITY;
  for (int j = lane; j < c; j += 32) m = fmaxf(m, z[j]);
  m = warp_max(m);
  float s = 0.f;
  for (int j = lane; j < c; j += 32) s += expf(z[j] - m);
  return {m, warp_sum(s)};
}

__global__ void phi_psi_fwd_kernel(const float* __restrict__ z,
                                   const int64_t* __restrict__ y,
                                   const float* __restrict__ g,
                                   float* __restrict__ phi,
                                   float* __restrict__ psi, int64_t n,
                                   int c) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // the whole warp leaves together
  const float* zr = z + row * c;
  const float* gr = g + row * c;
  const int64_t label = y[row];
  const RowStats st = row_stats(zr, c, lane);
  float zy = 0.f, sg = 0.f, gz = 0.f;
  for (int j = lane; j < c; j += 32) {
    const float zj = zr[j], gj = gr[j];
    if (j == label) zy = zj;
    sg += gj;
    gz += gj * zj;
  }
  zy = warp_sum(zy);
  sg = warp_sum(sg);
  gz = warp_sum(gz);
  if (lane == 0) {
    const float lse = logf(st.s) + st.m;
    phi[row] = lse - zy;
    psi[row] = sg * lse - gz;
  }
}

__global__ void phi_psi_bwd_kernel(const float* __restrict__ z,
                                   const int64_t* __restrict__ y,
                                   const float* __restrict__ g,
                                   const float* __restrict__ dphi,
                                   const float* __restrict__ dpsi,
                                   float* __restrict__ dz,
                                   float* __restrict__ dg, int64_t n,
                                   int c) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* zr = z + row * c;
  const float* gr = g + row * c;
  const int64_t label = y[row];
  const RowStats st = row_stats(zr, c, lane);
  float sg = 0.f;
  for (int j = lane; j < c; j += 32) sg += gr[j];
  sg = warp_sum(sg);
  const float lse = logf(st.s) + st.m;
  const float a = dphi[row], b = dpsi[row];
  for (int j = lane; j < c; j += 32) {
    const float zj = zr[j], gj = gr[j];
    const float p = expf(zj - st.m) / st.s;
    const float oh = (j == label) ? 1.f : 0.f;
    dz[row * c + j] = a * (p - oh) + b * (sg * p - gj);
    dg[row * c + j] = b * (lse - zj);
  }
}

__global__ void distill_loss_kernel(const float* __restrict__ z,
                                    const int64_t* __restrict__ y,
                                    const float* __restrict__ g,
                                    float* __restrict__ out, int64_t n,
                                    int c, float beta) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* zr = z + row * c;
  const float* gr = g + row * c;
  const int64_t label = y[row];
  const RowStats st = row_stats(zr, c, lane);
  float zy = 0.f, gz = 0.f;
  for (int j = lane; j < c; j += 32) {
    const float zj = zr[j];
    if (j == label) zy = zj;
    gz += gr[j] * zj;
  }
  zy = warp_sum(zy);
  gz = warp_sum(gz);
  if (lane == 0) {
    const float lse = logf(st.s) + st.m;
    out[row] = (lse - zy) + beta * (lse - gz);
  }
}

static unsigned grid_for(int64_t n, int threads) {
  const int64_t rows_per_block = threads / 32;
  return (unsigned)((n + rows_per_block - 1) / rows_per_block);
}

// Returns cudaGetLastError().
extern "C" int phi_psi_fwd_launch(const void* z, const void* y,
                                  const void* g, void* phi, void* psi,
                                  int64_t n, int64_t c, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  phi_psi_fwd_kernel<<<grid_for(n, threads), threads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)z, (const int64_t*)y, (const float*)g, (float*)phi,
      (float*)psi, n, (int)c);
  return (int)cudaGetLastError();
}

extern "C" int phi_psi_bwd_launch(const void* z, const void* y,
                                  const void* g, const void* dphi,
                                  const void* dpsi, void* dz, void* dg,
                                  int64_t n, int64_t c, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  phi_psi_bwd_kernel<<<grid_for(n, threads), threads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)z, (const int64_t*)y, (const float*)g,
      (const float*)dphi, (const float*)dpsi, (float*)dz, (float*)dg, n,
      (int)c);
  return (int)cudaGetLastError();
}

extern "C" int distill_loss_launch(const void* z, const void* y,
                                   const void* g, void* out, int64_t n,
                                   int64_t c, float beta, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  distill_loss_kernel<<<grid_for(n, threads), threads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)z, (const int64_t*)y, (const float*)g, (float*)out, n,
      (int)c, beta);
  return (int)cudaGetLastError();
}
