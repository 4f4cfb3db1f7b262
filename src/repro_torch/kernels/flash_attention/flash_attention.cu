// Causal (optionally sliding-window) attention with an online softmax in
// f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py:74
// (flash_attention).  q is [B, H, S, D]; k and v are [B, Hk, S, D] with
// H % Hk == 0, and query head h reads KV head h / (H / Hk): the grouped KV
// heads are indexed, never repeated in memory.  For every query row i:
//
//   out[i] = sum_j softmax_j(scale * <q_i, k_j>) v_j
//
// over the keys j < S with j <= i (causal) and j > i - window (window > 0);
// scale = 1/sqrt(D) of the unpadded head dim.
//
// Design.  One block of 8 warps per (b*h, 64-query tile), b*h on the
// grid's x.  The scaled q tile and one 64-key K/V tile at a time are
// staged in shared memory with a padded row stride (D + 1 floats), so
// the column reads of the score loop fall on 32 distinct banks; at D = 128
// that is 99 KB, above the 48 KB default, so the launch opts in to dynamic
// shared memory.  Each warp owns 8 query rows.  For one row, lane l
// scores keys l and l + 32 of the tile (a full dot over D, q broadcast
// from shared memory); the row's max and the sum of its probabilities
// are warp-shuffle reductions; the 64 probabilities go through a per-warp
// shared buffer, and for P.V the lanes split D (lane l holds columns l,
// l + 32, ...).  The running max m, the denominator l and the accumulator
// stay in registers for the whole pass over the keys.  Masked keys get probability exactly 0 (not exp of a
// large negative number), and KV tiles that lie wholly above the diagonal
// or wholly below the window are never loaded.  IEEE f32 throughout (expf,
// no fast math): the reference computes in f32.
//
// Bound.  Causal attention does 2*B*H*S^2*D useful flops (half of the S^2
// score and P.V products) against (2*B*H + 2*B*Hk)*S*D*4 bytes of input
// and output: at the real-model world's shapes (S = 256, D = 128) the f32
// operations bound it, not device memory.  This kernel runs its products
// on the CUDA cores from shared memory, not on the tensor cores (wgmma):
// a later PR's work.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = BLOCK_Q / WARPS;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// NPL: columns of a row per lane (D <= 32 * NPL)
template <int NPL>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int H, int Hk, int S, int D, int causal, int window,
                       float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;                       // [BLOCK_Q][ld], scaled q
  float* k_s = q_s + BLOCK_Q * ld;         // [BLOCK_K][ld]
  float* v_s = k_s + BLOCK_K * ld;         // [BLOCK_K][ld]
  float* p_s = v_s + BLOCK_K * ld;         // [WARPS][BLOCK_K]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hk);
  const int q0 = blockIdx.y * BLOCK_Q;
  const long long q_base = (long long)bh * S * D;
  const long long kv_base = ((long long)b * Hk + hk) * S * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < BLOCK_Q * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    const int qp = q0 + r;
    q_s[r * ld + c] = qp < S ? q[q_base + (long long)qp * D + c] * scale
                             : 0.0f;
  }

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][NPL];
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.0f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc[rr][i] = 0.0f;
  }

  // the keys any row of this tile can see: [kv_begin, kv_end)
  const int q_last = min(q0 + BLOCK_Q, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_end = (kv_end + BLOCK_K - 1) / BLOCK_K;

  for (int t = kv_begin / BLOCK_K; t < t_end; ++t) {
    const int k0 = t * BLOCK_K;
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    for (int i = tid; i < BLOCK_K * D; i += blockDim.x) {
      const int r = i / D, c = i - r * D;
      const int kp = k0 + r;
      const bool in = kp < S;
      const long long off = kv_base + (long long)kp * D + c;
      k_s[r * ld + c] = in ? k[off] : 0.0f;
      v_s[r * ld + c] = in ? v[off] : 0.0f;
    }
    __syncthreads();

    float* pw = p_s + warp * BLOCK_K;
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      const int qp = q0 + r;
      if (qp >= S) continue;  // uniform across the warp
      const float* qrow = q_s + r * ld;
      const float* krow0 = k_s + lane * ld;
      const float* krow1 = k_s + (lane + 32) * ld;
      float s0 = 0.0f, s1 = 0.0f;
      for (int c = 0; c < D; ++c) {
        const float qc = qrow[c];
        s0 = fmaf(qc, krow0[c], s0);
        s1 = fmaf(qc, krow1[c], s1);
      }
      const int kp0 = k0 + lane, kp1 = kp0 + 32;
      const bool ok0 = kp0 < S && (!causal || kp0 <= qp) &&
                       (window <= 0 || kp0 > qp - window);
      const bool ok1 = kp1 < S && (!causal || kp1 <= qp) &&
                       (window <= 0 || kp1 > qp - window);
      const float mx = warp_max(fmaxf(ok0 ? s0 : NEG_INF, ok1 ? s1 : NEG_INF));
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = expf(m[rr] - m_new);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.0f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.0f;
      l[rr] = l[rr] * alpha + warp_sum(p0 + p1);
      m[rr] = m_new;
      pw[lane] = p0;
      pw[lane + 32] = p1;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < NPL; ++i) acc[rr][i] *= alpha;
#pragma unroll 4
      for (int j = 0; j < BLOCK_K; ++j) {
        const float pj = pw[j];
        const float* vrow = v_s + j * ld;
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          const int c = lane + 32 * i;
          if (c < D) acc[rr][i] = fmaf(pj, vrow[c], acc[rr][i]);
        }
      }
      __syncwarp();  // pw is rewritten by the next row
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int qp = q0 + warp * ROWS_PER_WARP + rr;
    if (qp >= S) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) o[q_base + (long long)qp * D + c] = acc[rr][i] / denom;
    }
  }
}

template <int NPL>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int H, int Hk, int S, int D, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem =
      ((size_t)(BLOCK_Q + 2 * BLOCK_K) * (D + 1) + WARPS * BLOCK_K) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + BLOCK_Q - 1) / BLOCK_Q);
  flash_attention_kernel<NPL><<<grid, WARPS * 32, smem, stream>>>(
      q, k, v, o, H, Hk, S, D, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(const float* q, const float* k,
                                      const float* v, float* o, int B, int H,
                                      int Hk, int S, int D, int causal,
                                      int window, float scale, void* stream) {
  if (B < 0 || H <= 0 || Hk <= 0 || H % Hk || S < 0 || D <= 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 0x7fffffffLL || (S + BLOCK_Q - 1) / BLOCK_Q > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32) return launch<1>(q, k, v, o, B, H, Hk, S, D, causal, window, scale, s);
  if (D <= 64) return launch<2>(q, k, v, o, B, H, Hk, S, D, causal, window, scale, s);
  if (D <= 128) return launch<4>(q, k, v, o, B, H, Hk, S, D, causal, window, scale, s);
  return launch<8>(q, k, v, o, B, H, Hk, S, D, causal, window, scale, s);
}
