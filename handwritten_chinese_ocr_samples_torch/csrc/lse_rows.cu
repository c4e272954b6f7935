// Log-sum-exp over the LM vocabulary of x @ emb.T, for Hopper (sm_90a),
// without writing the (rows, V) logits.
//
// Replaces the Pallas TPU kernel `lse_rows` of the JAX package
// (handwritten_chinese_ocr_samples_tpu/ops/logits_lse.py:74, body
// `_lse_kernel` at :34). out[r] = log(sum_v exp(x[r] . emb[v])) in f32, for
// the LM-fused search's peek positions scored against the tied embedding.
//
// Bound on this card: operations. The product is 2 * rows * V * d flops; at
// the search's shape (2520 rows, V = 7377, d = 512, bf16) that is 19.0
// GFLOP, about 19 us at the tensor cores' bf16 rate, against about 10 MB of
// inputs (3 us). This first version multiplies on the f32 SIMT units, far
// from that bound; tensor cores are later work.
//
// Design: the TPU kernel carried its online max/sum across a sequential grid
// axis over the vocabulary. Hopper's blocks run unordered, so the vocabulary
// is cut into `n_split` ranges, one block per (64-row tile, range) keeps the
// online max m and sum l of its range for its rows, and a second small kernel
// combines the ranges' (m, l) pairs into m + log(l). Inside a block, 64 x 32
// tiles of x and of emb are staged in shared memory as f32 (padded by one
// word against bank conflicts), each of 256 threads accumulates a 4 x 4 tile
// of logits in f32, and the 64 x 64 logits of a vocabulary tile pass through
// shared memory once for the online update: 4 threads per row, their partial
// max and sum joined by warp shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int TR = 64;  // rows per block
constexpr int TV = 64;  // vocabulary entries per tile
constexpr int TK = 32;  // depth per staged chunk

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
lse_partial_kernel(const T* __restrict__ x, const T* __restrict__ emb,
                   float* __restrict__ pm, float* __restrict__ pl, int rows,
                   int V, int d, int v_per_split, int n_split) {
  __shared__ float xs[TK][TR + 1];
  __shared__ float es[TK][TV + 1];
  __shared__ float S[TR][TV + 1];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // 4 x 4 logits at (ty*4, tx*4)
  const int rr = tid / 4, qq = tid % 4;     // online update: row rr, quarter qq
  const int r0 = blockIdx.x * TR;
  const int split = blockIdx.y;
  const int vbeg = split * v_per_split;
  const int vend = min(V, vbeg + v_per_split);

  float m_run = -INFINITY, l_run = 0.f;
  for (int v0 = vbeg; v0 < vend; v0 += TV) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < d; k0 += TK) {
      for (int e = tid; e < TR * TK; e += kThreads) {
        const int r = e / TK, c = e % TK;
        const int row = r0 + r, kk = k0 + c;
        xs[c][r] = (row < rows && kk < d) ? to_f(x[(size_t)row * d + kk]) : 0.f;
      }
      for (int e = tid; e < TV * TK; e += kThreads) {
        const int j = e / TK, c = e % TK;
        const int col = v0 + j, kk = k0 + c;
        es[c][j] = (col < vend && kk < d) ? to_f(emb[(size_t)col * d + kk]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < TK; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[c][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = es[c][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) S[ty * 4 + i][tx * 4 + j] = acc[i][j];
    __syncthreads();

    const int n_valid = min(TV, vend - v0);
    float tmax = -INFINITY;
    for (int j = qq * 16; j < qq * 16 + 16; ++j)
      if (j < n_valid) tmax = fmaxf(tmax, S[rr][j]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_run, tmax);
    float psum = 0.f;
    for (int j = qq * 16; j < qq * 16 + 16; ++j)
      if (j < n_valid) psum += expf(S[rr][j] - m_new);
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * expf(m_run - m_new) + psum;
    m_run = m_new;
    __syncthreads();  // S is rewritten by the next tile
  }
  if (qq == 0 && r0 + rr < rows) {
    pm[(size_t)(r0 + rr) * n_split + split] = m_run;
    pl[(size_t)(r0 + rr) * n_split + split] = l_run;
  }
}

__global__ void lse_combine_kernel(const float* __restrict__ pm,
                                   const float* __restrict__ pl,
                                   float* __restrict__ out, int rows,
                                   int n_split) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float m = -INFINITY;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, pm[(size_t)r * n_split + s]);
  float l = 0.f;
  for (int s = 0; s < n_split; ++s)
    l += pl[(size_t)r * n_split + s] * expf(pm[(size_t)r * n_split + s] - m);
  out[r] = m + logf(l);
}

template <typename T>
int launch(const void* x, const void* emb, float* pm, float* pl, float* out,
           int rows, int V, int d, int v_per_split, int n_split,
           cudaStream_t stream) {
  const dim3 grid((rows + TR - 1) / TR, n_split);
  lse_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)emb, pm, pl, rows, V, d, v_per_split, n_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lse_combine_kernel<<<(rows + 255) / 256, 256, 0, stream>>>(pm, pl, out, rows,
                                                            n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (rows, d), emb: (V, d), one dtype (bf16 when is_bf16, else f32); out:
// (rows,) f32; pm, pl: (rows, n_split) f32 workspace. The vocabulary range of
// split s is [s * v_per_split, min(V, (s + 1) * v_per_split)); the wrapper
// picks v_per_split as a multiple of 64 with every range non-empty.
// Returns cudaGetLastError() after the launches.
extern "C" int hctr_lse_rows(const void* x, const void* emb, float* pm,
                             float* pl, float* out, int rows, int V, int d,
                             int v_per_split, int n_split, int is_bf16,
                             cudaStream_t stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(x, emb, pm, pl, out, rows, V, d, v_per_split,
                                 n_split, stream);
  return launch<float>(x, emb, pm, pl, out, rows, V, d, v_per_split, n_split,
                       stream);
}
