// Peek attention of grouped queries against each beam's KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `peek_cache_attention` of the JAX package
// (handwritten_chinese_ocr_samples_tpu/ops/peek_attention.py:70, body
// `_kernel` at :38). For beam b, head h and query n (N = rows * positions of
// the LM-fused search's peek, pre-scaled by 1/sqrt(Dh)) it writes the
// unnormalised flash-attention partials over the valid cache positions
// t < lengths[b]:
//
//   s_t = q . k_t          m = max_t s_t          l = sum_t exp(s_t - m)
//   o   = sum_t round_T(exp(s_t - m)) * v_t       (the weights are rounded to
//                                                  the cache dtype, as the
//                                                  JAX oracle does)
//
// with m = -1e30, l = 0 and o = 0 for an empty cache. The caller merges them
// with the own-row causal part. The (B, N, H, L) score tensor never reaches
// device memory.
//
// Bound on this card: memory. Each query, key and value element is read once
// and the partials written once, about 4 * Dh flops per (query, key) pair;
// at the search's shape (40 beams, N = 84, L = 160, H = 8, Dh = 64, bf16)
// the bytes are up to 23.6 MB (the cache rows past lengths[b] are not read),
// about 7 us, and the flops about 1.1 GFLOP.
//
// Design, correctness first: one block of 8 warps per (beam, head). The
// block stages that beam's valid k and v rows for the head in shared memory
// once (k rows padded by one 4-byte word so that 32 lanes reading 32
// different keys hit 32 banks); each warp then takes one query at a time:
// lanes split the keys for the scores, a warp max and sum give m and l, and
// lanes split the head dimension for the weighted sum of v. Everything is
// accumulated in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T and back (the JAX oracle casts the weights to the cache dtype)
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// padded row stride of staged keys, in elements: one extra 4-byte word
template <typename T> __host__ __device__ constexpr int kpad(int dh) {
  return dh + (int)(4 / sizeof(T));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
peek_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ lengths,
            float* __restrict__ o, float* __restrict__ m_out,
            float* __restrict__ l_out, int N, int L, int H, int Dh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kp = kpad<T>(Dh);
  T* ks = reinterpret_cast<T*>(smem_raw);                  // [L][kp]
  T* vs = ks + (size_t)L * kp;                             // [L][Dh]
  float* fs = reinterpret_cast<float*>(
      smem_raw + (((size_t)L * (kp + Dh) * sizeof(T) + 15) / 16) * 16);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qs = fs + warp * Dh;                              // [kWarps][Dh]
  float* ps = fs + kWarps * Dh + warp * L;                 // [kWarps][L]

  int len = lengths[b];
  len = len < 0 ? 0 : (len > L ? L : len);
  for (int e = threadIdx.x; e < len * Dh; e += kThreads) {
    const int t = e / Dh;
    const int d = e - t * Dh;
    const size_t g = (((size_t)b * L + t) * H + h) * Dh + d;
    ks[t * kp + d] = k[g];
    vs[t * Dh + d] = v[g];
  }
  __syncthreads();

  for (int n = warp; n < N; n += kWarps) {
    const size_t row = (((size_t)b * N + n) * H + h);
    for (int d = lane; d < Dh; d += 32) qs[d] = to_f(q[row * Dh + d]);
    __syncwarp();
    float mx = kNeg;
    for (int t = lane; t < len; t += 32) {
      const T* kr = ks + t * kp;
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s = fmaf(qs[d], to_f(kr[d]), s);
      ps[t] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int t = lane; t < len; t += 32) {
      const float p = expf(ps[t] - mx);
      lsum += p;
      ps[t] = round_to<T>(p);
    }
    lsum = warp_sum(lsum);
    __syncwarp();
    for (int d = lane; d < Dh; d += 32) {
      float acc = 0.f;
      for (int t = 0; t < len; ++t) acc = fmaf(ps[t], to_f(vs[t * Dh + d]), acc);
      o[row * Dh + d] = acc;
    }
    if (lane == 0) {
      m_out[row] = len > 0 ? mx : kNeg;
      l_out[row] = lsum;
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* o, float* m, float* l, int B, int N, int L, int H, int Dh,
           cudaStream_t stream) {
  const size_t staged = (((size_t)L * (kpad<T>(Dh) + Dh) * sizeof(T) + 15) / 16) * 16;
  const size_t smem = staged + (size_t)kWarps * (Dh + L) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        peek_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  peek_kernel<T><<<B * H, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, o, m, l, N, L, H, Dh);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, N, H, Dh); k, v: (B, L, H, Dh), all of one dtype (bf16 when
// is_bf16, else f32); lengths: (B,) int32; o: (B, N, H, Dh) f32; m, l:
// (B, N, H) f32. Returns cudaGetLastError() after the launch (or the error
// of raising the shared-memory limit when L is too long to stage).
extern "C" int hctr_peek_cache_attention(const void* q, const void* k,
                                         const void* v, const int* lengths,
                                         float* o, float* m, float* l, int B,
                                         int N, int L, int H, int Dh,
                                         int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, lengths, o, m, l, B, N, L, H, Dh, stream);
  return launch<float>(q, k, v, lengths, o, m, l, B, N, L, H, Dh, stream);
}
