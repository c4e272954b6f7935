// Fused row-wise log-softmax + top-K over the class axis, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `topk_logsoftmax` of the JAX package
// (handwritten_chinese_ocr_samples_tpu/ops/topk_logsoftmax.py:67, body
// `_kernel` at :33). Per frame row of raw logits it writes only:
//   vals[K]   the top-K log-probs, descending (ties to the lower class index),
//   idx[K]    their class indices (int32),
//   blank     the log-prob of class 0,
//   n_above   the number of classes whose log-prob is > prune,
// so the (rows, D) log-softmax is never written to device memory.
//
// Bound on this card: memory. Each logit is read once and the outputs are
// tiny, so the least time is rows * D * 4 bytes over the HBM rate; at the
// smoke shape (B=8, T=1024, D=7375) that is 241.7 MB, about 72 us at
// 3.35 TB/s. The arithmetic (one exp and a few compares per logit) is far
// below the card's f32 rate.
//
// Design, correctness first: one block of 256 threads per row. The row is
// staged in shared memory (D * 4 bytes, 29.5 KB at D = 7375), so device
// memory is read exactly once; block reductions then give the max, the sum
// of exp(x - max) and the n_above count. For the top-K, each thread keeps the
// best (value, index) of the elements it owns (j = tid, tid + 256, ...); K
// rounds of a block arg-max pick the winner, and only the owning thread masks
// it and rescans its own elements, so the K rounds cost K block reductions
// and one rescan each instead of K passes over the row.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (v, i) beats (bv, bi): larger value, or the lower index on equal values.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_sum_int(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

// Block arg-max of (v, i) pairs; every thread gets the winner.
__device__ __forceinline__ void block_argmax(float& v, int& i, float* redv, int* redi) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { redv[warp] = v; redi[warp] = i; }
  __syncthreads();
  v = redv[0];
  i = redi[0];
  for (int w = 1; w < kWarps; ++w)
    if (better(redv[w], redi[w], v, i)) { v = redv[w]; i = redi[w]; }
  __syncthreads();
}

// Best (value, index) among the elements this thread owns. A thread that owns
// none (D < kThreads) keeps index INT_MAX, which loses to every real element.
__device__ __forceinline__ void local_best(const float* row, int D, float& bv, int& bi) {
  bv = -INFINITY;
  bi = 0x7fffffff;
  for (int j = threadIdx.x; j < D; j += kThreads)
    if (better(row[j], j, bv, bi)) { bv = row[j]; bi = j; }
}

__global__ void __launch_bounds__(kThreads)
topk_logsoftmax_kernel(const float* __restrict__ x, float* __restrict__ vals,
                       int* __restrict__ idx, float* __restrict__ blank,
                       int* __restrict__ n_above, int D, int K, float prune) {
  extern __shared__ float row[];
  __shared__ float redf[kWarps];
  __shared__ int redi[kWarps];

  const long long r = blockIdx.x;
  const float* xr = x + r * D;

  float m = -INFINITY;
  for (int j = threadIdx.x; j < D; j += kThreads) {
    const float v = xr[j];
    row[j] = v;
    m = fmaxf(m, v);
  }
  m = block_max(m, redf);  // its first barrier also publishes `row`

  float s = 0.f;
  for (int j = threadIdx.x; j < D; j += kThreads) s += expf(row[j] - m);
  const float logz = m + logf(block_sum(s, redf));

  int c = 0;
  for (int j = threadIdx.x; j < D; j += kThreads) c += (row[j] - logz) > prune;
  c = block_sum_int(c, redi);
  if (threadIdx.x == 0) {
    blank[r] = row[0] - logz;
    n_above[r] = c;
  }

  float bv;
  int bi;
  local_best(row, D, bv, bi);
  for (int k = 0; k < K; ++k) {
    float wv = bv;
    int wi = bi;
    block_argmax(wv, wi, redf, redi);
    if (threadIdx.x == 0) {
      vals[r * K + k] = wv - logz;
      idx[r * K + k] = wi;
    }
    if (wi % kThreads == (int)threadIdx.x) {  // the owner masks and rescans
      row[wi] = -INFINITY;
      local_best(row, D, bv, bi);
    }
  }
}

}  // namespace

// x: (rows, D) f32 raw logits; vals, idx: (rows, K); blank, n_above: (rows,).
// Requires 1 <= K <= D (the wrapper checks it).
// Returns cudaGetLastError() after the launch.
extern "C" int hctr_topk_logsoftmax(const float* x, float* vals, int* idx,
                                    float* blank, int* n_above, int rows,
                                    int D, int K, float prune,
                                    cudaStream_t stream) {
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        topk_logsoftmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  topk_logsoftmax_kernel<<<rows, kThreads, smem, stream>>>(
      x, vals, idx, blank, n_above, D, K, prune);
  return (int)cudaGetLastError();
}
