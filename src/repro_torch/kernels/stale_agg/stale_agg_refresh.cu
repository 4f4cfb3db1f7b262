// Fused Eq. 18 delta + stale-store refresh for the MMFL stale family.
//
// Replaces the TPU kernel repro/kernels/stale_agg/stale_agg.py:98
// (stale_agg_refresh).  For every parameter element p:
//
//   delta[p] = stale_sum[p] + sum_c coeff[c] * (G[c,p] - beta[c] * h[idx[c],p])
//   h[idx[c],p] = G[c,p]   where act[c] > 0
//
// Each thread owns one p and walks the cohort c = 0..C-1 in order, so the
// sum has one fixed order on every run.  The store row is read before it
// is rewritten (Algorithm 2 order), and the idx rows are distinct, so no
// two threads write one element.  Rows outside idx are never touched: the
// kernel writes into the live [N, P] store.  A slot with coeff == 0 and
// act == 0 (cohort padding) is skipped, not multiplied by zero, so a NaN in
// its G row adds nothing.
//
// Bound: device-memory bytes.  The kernel reads G and the C store rows
// once, writes the active rows and delta once: (2C + n_active + 2) P * 4 B
// for a handful of flops per element.  Consecutive threads touch
// consecutive p of one row, so every load and store is coalesced; the
// per-slot scalars are uniform across a warp.  No shared memory: there is
// nothing to reuse across threads.
#include <cuda_runtime.h>

__global__ void stale_agg_refresh_kernel(
    const float* __restrict__ coeff, const float* __restrict__ beta,
    const float* __restrict__ act, const int* __restrict__ idx,
    const float* __restrict__ G, float* __restrict__ h,
    const float* __restrict__ stale_sum, float* __restrict__ delta,
    int C, long long P) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float acc = stale_sum[p];
  for (int c = 0; c < C; ++c) {
    const float cf = coeff[c];
    const float a = act[c];
    if (cf == 0.0f && a == 0.0f) continue;
    float* row = h + (long long)idx[c] * P;
    const float g = G[(long long)c * P + p];
    const float hv = row[p];
    acc += cf * (g - beta[c] * hv);
    if (a > 0.0f) row[p] = g;
  }
  delta[p] = acc;
}

extern "C" int stale_agg_refresh_launch(
    const float* coeff, const float* beta, const float* act, const int* idx,
    const float* G, float* h, const float* stale_sum, float* delta, int C,
    long long P, void* stream) {
  if (C < 0 || P < 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const int threads = 256;
  const long long blocks = (P + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  stale_agg_refresh_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      coeff, beta, act, idx, G, h, stale_sum, delta, C, P);
  return (int)cudaGetLastError();
}
