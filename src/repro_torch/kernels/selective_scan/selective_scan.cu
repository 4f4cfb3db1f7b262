// Mamba-1 selective scan (the recurrent path) in f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/selective_scan/selective_scan.py:50
// (selective_scan).  For every batch row b, channel d and time t:
//
//   h_t = exp(dt_t * A_d) * h_{t-1} + (dt_t * u_t) * B_t      (h: N floats)
//   y_t = <h_t, C_t> + D_d * u_t
//
// with u, dt, y of shape [Bsz, S, di], B and C of shape [Bsz, S, N], and A
// of shape [G, di, N], D of shape [G, di]: batch row b reads group
// b / (Bsz / G).  G = 1 is the model's own call; G > 1 is a cohort of
// clients folded into the batch axis, each with its own A and D.
//
// Design.  The recurrence is sequential in t and independent across
// (b, d), so one thread owns one (b, d) channel for the whole sequence: it
// keeps its N state entries and its A row in registers and walks t in
// order (the TPU kernel's sequential time grid becomes this loop).  A
// block holds 128 consecutive channels of one batch row, so the u and dt
// loads and the y stores of a step are coalesced over d.  B_t and C_t are
// shared by every channel of the row: a block stages 32 steps of them in
// shared memory at a time.  IEEE f32 (expf, no fast math).
//
// Bound.  Each input element is read once and each output written once:
// (3 * Bsz * S * di + 2 * Bsz * S * N + G * di * (N + 1)) * 4 bytes, for
// 7 * N + 3 operations per (b, t, d), an expf counted as one: at N = 16
// that is 115 operations per 20 bytes, under the card's 67 TFLOP/s f32 to
// 3.35 TB/s ratio of 20 per byte, so device memory bounds it.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int T_CHUNK = 32;

template <int MAXN>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ A,
                      const float* __restrict__ Dv, float* __restrict__ y,
                      int S, int di, int N, int rows_per_group) {
  __shared__ float b_s[T_CHUNK * MAXN];
  __shared__ float c_s[T_CHUNK * MAXN];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < di;
  const long long grow = (long long)(b / rows_per_group) * di + d;

  float a[MAXN], h[MAXN];
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    a[n] = (live && n < N) ? A[grow * N + n] : 0.0f;
    h[n] = 0.0f;
  }
  const float dv = live ? Dv[grow] : 0.0f;
  const long long row = (long long)b * S;

  for (int t0 = 0; t0 < S; t0 += T_CHUNK) {
    const int tn = min(T_CHUNK, S - t0);
    __syncthreads();  // the previous chunk of B/C is consumed
    for (int i = threadIdx.x; i < tn * N; i += THREADS) {
      const int tt = i / N, n = i - tt * N;
      const long long off = (row + t0 + tt) * N + n;
      b_s[tt * MAXN + n] = Bm[off];
      c_s[tt * MAXN + n] = Cm[off];
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < tn; ++tt) {
      const long long off = (row + t0 + tt) * di + d;
      const float ut = u[off];
      const float dtt = dt[off];
      const float dbu = dtt * ut;
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < MAXN; ++n) {
        if (n < N) {
          h[n] = h[n] * expf(dtt * a[n]) + dbu * b_s[tt * MAXN + n];
          acc = fmaf(h[n], c_s[tt * MAXN + n], acc);
        }
      }
      y[off] = acc + dv * ut;
    }
  }
}

template <int MAXN>
int launch(const float* u, const float* dt, const float* B, const float* C,
           const float* A, const float* D, float* y, int Bsz, int S, int di,
           int N, int G, cudaStream_t stream) {
  const dim3 grid((di + THREADS - 1) / THREADS, Bsz);
  selective_scan_kernel<MAXN><<<grid, THREADS, 0, stream>>>(
      u, dt, B, C, A, D, y, S, di, N, Bsz / G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int selective_scan_launch(const float* u, const float* dt,
                                     const float* B, const float* C,
                                     const float* A, const float* D,
                                     float* y, int Bsz, int S, int di, int N,
                                     int G, void* stream) {
  if (Bsz < 0 || S < 0 || di < 0 || N <= 0 || N > 64 || G <= 0 ||
      (Bsz % G))
    return (int)cudaErrorInvalidValue;
  if (Bsz > 65535) return (int)cudaErrorInvalidConfiguration;
  if (Bsz == 0 || S == 0 || di == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 16) return launch<16>(u, dt, B, C, A, D, y, Bsz, S, di, N, G, s);
  return launch<64>(u, dt, B, C, A, D, y, Bsz, S, di, N, G, s);
}
