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
// and, for one local SGD step of D devices with B rows each, the step's
// whole distill work in one launch (distill_step_launch, below).
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

// One local SGD step of eq. (3) for D devices of B rows each (row
// r = d * B + i), in one launch: the redesign of the pair above for the
// step, where B2 forward, B2 backward, the G_out row gather, the loss
// means and the eq. (2) sums took about fifteen launches.  The step
// always passes the cotangents dphi = 1/B and dpsi = beta/B (the
// gradient of sum_d [mean_B phi + beta mean_B psi]) and never
// differentiates G_out, so the kernel writes dz only.  Per device d:
//
//   dz[r]          = (softmax(z_r) - onehot(y_r)) / B
//                    + (beta / B) (sum(g_r) softmax(z_r) - g_r)
//   losses[d, k]   = mean_i phi_i + beta mean_i psi_i
//   out_sum[d]    += sum_i onehot(y_i)^T softmax(z_i)        (eq. 2)
//   cnt[d]        += sum_i onehot(y_i)
//
// with g_r = gout[d, y_r].  beta and the step index k are read from
// device memory, so one captured CUDA graph of the step serves the
// KD-off first round and the KD rounds, and its replays walk k.
//
// One CTA per device, one warp per row (warps stride over the rows when
// B exceeds them).  The rows' phi, psi, labels and softmax go to shared
// memory; the per-device sums are then taken by one thread per output
// entry over the rows in order, so each sum has one fixed order and no
// atomics.  Bound: bytes, ~27 KB at (D, B, C) = (10, 16, 10), as for
// the pair; its worth is the launches it removes from every step.
__global__ void distill_step_kernel(const float* __restrict__ z,
                                    const int64_t* __restrict__ y,
                                    const float* __restrict__ gout,
                                    const float* __restrict__ beta_p,
                                    const int64_t* __restrict__ k_p,
                                    float* __restrict__ dz,
                                    float* __restrict__ losses,
                                    float* __restrict__ out_sum,
                                    float* __restrict__ cnt, int b, int c,
                                    int64_t iters) {
  extern __shared__ float smem[];
  float* s_phi = smem;              // (B,)
  float* s_psi = s_phi + b;         // (B,)
  float* s_p = s_psi + b;           // (B, C) softmax rows
  int* s_y = (int*)(s_p + b * c);   // (B,)
  const int d = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x / 32;
  const float beta = *beta_p;
  const float a = 1.f / (float)b, bb = beta / (float)b;
  for (int i = warp; i < b; i += nwarps) {
    const int64_t row = (int64_t)d * b + i;
    const float* zr = z + row * c;
    const int label = (int)y[row];
    const float* gr = gout + ((int64_t)d * c + label) * c;
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
    const float lse = logf(st.s) + st.m;
    for (int j = lane; j < c; j += 32) {
      const float zj = zr[j], gj = gr[j];
      const float p = expf(zj - st.m) / st.s;
      const float oh = (j == label) ? 1.f : 0.f;
      dz[row * c + j] = a * (p - oh) + bb * (sg * p - gj);
      s_p[i * c + j] = p;
    }
    if (lane == 0) {
      s_phi[i] = lse - zy;
      s_psi[i] = sg * lse - gz;
      s_y[i] = label;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int64_t k = *k_p;
    float sphi = 0.f, spsi = 0.f;
    for (int i = 0; i < b; ++i) {
      sphi += s_phi[i];
      spsi += s_psi[i];
    }
    if (k >= 0 && k < iters)
      losses[(int64_t)d * iters + k] = sphi / (float)b
                                       + beta * (spsi / (float)b);
  }
  for (int e = threadIdx.x; e < c * c; e += blockDim.x) {
    const int m = e / c, j = e % c;
    float s = 0.f;
    for (int i = 0; i < b; ++i)
      if (s_y[i] == m) s += s_p[i * c + j];
    out_sum[(int64_t)d * c * c + e] += s;
  }
  for (int m = threadIdx.x; m < c; m += blockDim.x) {
    float n = 0.f;
    for (int i = 0; i < b; ++i) n += (s_y[i] == m) ? 1.f : 0.f;
    cnt[(int64_t)d * c + m] += n;
  }
}

// Shared memory of one distill_step CTA: B (C + 3) words (the wrapper
// keeps it within the 48 KB a launch may take without an attribute).
static size_t distill_step_smem(int64_t b, int64_t c) {
  return (size_t)(b * (c + 3)) * 4;
}

extern "C" int distill_step_launch(const void* z, const void* y,
                                   const void* gout, const void* beta,
                                   const void* k, void* dz, void* losses,
                                   void* out_sum, void* cnt, int64_t d,
                                   int64_t b, int64_t c, int64_t iters,
                                   void* stream) {
  if (d <= 0 || b <= 0) return 0;
  const int warps = b < 4 ? 4 : (b > 16 ? 16 : (int)b);
  distill_step_kernel<<<(unsigned)d, warps * 32,
                        distill_step_smem(b, c),
                        (cudaStream_t)stream>>>(
      (const float*)z, (const int64_t*)y, (const float*)gout,
      (const float*)beta, (const int64_t*)k, (float*)dz, (float*)losses,
      (float*)out_sum, (float*)cnt, (int)b, (int)c, iters);
  return (int)cudaGetLastError();
}
