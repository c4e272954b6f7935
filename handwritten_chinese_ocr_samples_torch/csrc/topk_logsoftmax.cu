// Fused row-wise log-softmax + top-K over the class axis, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `topk_logsoftmax` of the JAX package
// (handwritten_chinese_ocr_samples_tpu/ops/topk_logsoftmax.py:67, body
// `_kernel` at :33). Per frame row of raw logits (f32 or bf16, computed in
// f32) it writes only:
//   vals[K]   the top-K log-probs, descending (ties to the lower class index),
//   idx[K]    their class indices (int32),
//   blank     the log-prob of class 0,
//   n_above   the number of classes whose log-prob is > prune,
// so the (rows, D) log-softmax is never written to device memory.
//
// Bound on this card: memory. Each logit is read once and the outputs are
// tiny, so the least time is rows * D * 4 bytes (f32) over the HBM rate: at
// (B, T, D) = (8, 1024, 7375) that is 241.7 MB, about 72 us at 3.35 TB/s.
// The arithmetic (an exp and a few compares a logit) is far below the card's
// f32 rate.
//
// Design: one row per block of 4 warps. A block holds nothing but its row
// (29.5 KB of shared memory at D = 7375 f32), so 7 rows are resident on each
// SM and their loads overlap the other rows' reductions; the block scheduler
// starts the next row's block as soon as one ends.
//   * Load. Thread 0 issues the row's 16-byte-aligned body as 1-D TMA copies
//     (`cp.async.bulk`, four pieces, each completing on its own `mbarrier`)
//     into shared memory; the row is placed at the same offset mod 16 as in
//     device memory, so the body lands on 16-byte boundaries. A row of
//     D = 7375 f32 starts 16-byte-aligned only every fourth row, and a view
//     such as x[1:] may start anywhere, so the head and tail elements outside
//     the aligned body (fewer than 16 bytes each) are loaded by single
//     threads with scalar loads. Nothing is read outside the row.
//   * Pass 1 over shared memory, piece by piece as the pieces land: each
//     thread keeps an online max with a rescaled sum of exp (exp2 on the SFU)
//     over its 16-byte chunks; the warps combine them into logZ. theta, the
//     K-th largest of the 128 thread maxima (each warp sorts its 32 by
//     shuffles, then each of the warps' K largest is ranked among all of
//     them), bounds the row's K-th value from below: the K largest thread
//     maxima are K elements of the row.
//   * Pass 2 over shared memory: n_above, and (K <= kFastK) the candidates
//     x >= theta, appended to a list of up to kCands in shared memory. A
//     chunk whose max is below both thresholds costs one test; random logits
//     give a few dozen candidates a row. Each candidate's rank is the number
//     of candidates that beat it, and the candidates ranked below K are
//     written at their rank. No round per rank, and no index can be returned
//     twice.
//   * K > kFastK, or more than kCands candidates (rows of ties): the block
//     takes the top K in K rounds of an arg-max (shuffles and one barrier a
//     round); each thread keeps a list of its kList best elements that come
//     after the last winner it gave, and rescans its own elements when the
//     list runs out. Exact for every 1 <= K <= D, slower.
// The order everywhere is value descending, then lower index: `-inf` logits
// are ranked by index like any other value.
//
// Measured (chip_smoke.py --kernels, H100 80GB HBM3 at 700 W, f32, K = 10):
// 0.102-0.104 ms at (8, 1024, 7375), 70% of the bound, about the time of a
// torch `amax` over the same logits (0.097-0.101 ms); the one-block-per-row
// kernel it replaces took 0.237 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFastK = 32;         // fast path: K <= kFastK
constexpr int kCands = 128;        // fast path: candidates kept a row
constexpr int kList = 4;           // general path: next-best list a thread
constexpr int kWarps = 4;          // a row's warps
constexpr int kThreads = 32 * kWarps;
constexpr int kPieces = 4;         // TMA pieces of a row, one mbarrier each
constexpr int kHeader = 64;        // the mbarriers, before the row buffer
// shared memory a block may use (227 KB), less 2 KB for the static arrays
constexpr int kMaxSmem = 232448 - 2048;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNoIndex = 0x7fffffff;

// (v, i) beats (bv, bi): larger value, or the lower index on equal values.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f(uint32_t raw) { return __uint_as_float(raw); }
__device__ __forceinline__ float to_f(uint16_t raw) {
  return __uint_as_float((uint32_t)raw << 16);  // bf16 -> f32 is exact
}

// A 16-byte chunk of raw elements as f32: 4 f32 or 8 bf16 (little-endian,
// the lower address in the low half of each word).
__device__ __forceinline__ void unpack(uint4 u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x); x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z); x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// waits for phase 0 of `bar`; a wait that never ends traps instead of
// hanging the card
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
  }
}

// 1-D TMA: `bytes` (a multiple of 16) from 16-byte-aligned global `src` to
// 16-byte-aligned shared `dst`, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Where a row lies in its block's buffer: the buffer starts at the 16-byte
// boundary at or before the row's first element, so element j sits at
// element offset sh + j, and chunk c (16 bytes) holds elements
// c * EPC - sh ... c * EPC - sh + EPC - 1.
template <typename Raw>
struct RowLayout {
  static constexpr int ES = sizeof(Raw);
  static constexpr int EPC = 16 / ES;
  int D, sh, nc;
  __device__ RowLayout(const Raw* row, int D_) : D(D_) {
    sh = (int)((reinterpret_cast<uintptr_t>(row) & 15) / ES);
    nc = (sh + D + EPC - 1) / EPC;
  }
  // chunk c as f32, elements outside the row as -inf (`ok` false)
  __device__ __forceinline__ void chunk(const unsigned char* buf, int c,
                                        float (&x)[EPC], bool (&ok)[EPC]) const {
    unpack(*reinterpret_cast<const uint4*>(buf + 16 * c), x);
    const int j0 = c * EPC - sh;
    if (j0 < 0 || j0 + EPC > D) {  // the row's first or last chunk
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        ok[e] = j0 + e >= 0 && j0 + e < D;
        if (!ok[e]) x[e] = -INFINITY;
      }
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) ok[e] = true;
    }
  }
};

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The 32 lanes' values sorted descending across the warp (bitonic).
__device__ __forceinline__ float warp_sort_desc(float v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(kFull, v, stride);
      const bool desc = (lane & size) == 0;
      const bool lower = (lane & stride) == 0;
      v = (lower == desc) ? fmaxf(v, o) : fminf(v, o);
    }
  }
  return v;
}

// This thread's kList best elements after (wv, wi) in the order, best
// first, among its chunks (tid, tid + kThreads, ...); (-inf, kNoIndex) pad.
template <typename Raw>
__device__ void next_best(const RowLayout<Raw>& L, const unsigned char* buf,
                          int tid, float wv, int wi, float (&lv)[kList],
                          int (&li)[kList]) {
  constexpr int EPC = RowLayout<Raw>::EPC;
#pragma unroll
  for (int k = 0; k < kList; ++k) { lv[k] = -INFINITY; li[k] = kNoIndex; }
  for (int c = tid; c < L.nc; c += kThreads) {
    float x[EPC];
    bool ok[EPC];
    L.chunk(buf, c, x, ok);
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      const int j = c * EPC + e - L.sh;
      if (!ok[e] || !better(wv, wi, x[e], j) ||
          !better(x[e], j, lv[kList - 1], li[kList - 1]))
        continue;
      // insert (x[e], j) before the first entry it beats
      bool b[kList];
#pragma unroll
      for (int k = 0; k < kList; ++k) b[k] = better(x[e], j, lv[k], li[k]);
#pragma unroll
      for (int k = kList - 1; k > 0; --k) {
        if (b[k - 1]) { lv[k] = lv[k - 1]; li[k] = li[k - 1]; }
        else if (b[k]) { lv[k] = x[e]; li[k] = j; }
      }
      if (b[0]) { lv[0] = x[e]; li[0] = j; }
    }
  }
}

// The top K of the row in K rounds: each thread offers the head of its list
// of next-best elements, the block takes the best of them (shuffles, then
// one barrier over the warps' winners, kept in two slots by round parity),
// and the winner's thread pops its head, refilling the list from its own
// chunks when it runs out.
template <typename Raw>
__device__ void topk_by_rounds(const RowLayout<Raw>& L, const unsigned char* buf,
                               int K, float logz, float* vr, int* ir,
                               float (&slot_v)[2][kWarps],
                               int (&slot_i)[2][kWarps]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float lv[kList];
  int li[kList];
  next_best(L, buf, tid, INFINITY, -1, lv, li);
  for (int k = 0; k < K; ++k) {
    float wv = lv[0];
    int wi = li[0];
    warp_best(wv, wi);
    if (lane == 0) {
      slot_v[k & 1][warp] = wv;
      slot_i[k & 1][warp] = wi;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (better(slot_v[k & 1][w], slot_i[k & 1][w], wv, wi)) {
        wv = slot_v[k & 1][w];
        wi = slot_i[k & 1][w];
      }
    if (tid == 0) {
      vr[k] = wv - logz;
      ir[k] = wi;
    }
    if (li[0] == wi) {
#pragma unroll
      for (int j = 0; j < kList - 1; ++j) { lv[j] = lv[j + 1]; li[j] = li[j + 1]; }
      lv[kList - 1] = -INFINITY;
      li[kList - 1] = kNoIndex;
      if (li[0] == kNoIndex) next_best(L, buf, tid, wv, wi, lv, li);
    }
  }
}

template <typename Raw, bool kFast>
__global__ void __launch_bounds__(kThreads)
topk_logsoftmax_kernel(const Raw* __restrict__ x, float* __restrict__ vals,
                       int* __restrict__ idx, float* __restrict__ blank,
                       int* __restrict__ n_above, int D, int K, float prune) {
  constexpr int ES = sizeof(Raw);
  constexpr int EPC = 16 / ES;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* buf = smem + kHeader;
  __shared__ float red_m[kWarps], red_s[kWarps], red_t[kWarps];
  __shared__ int red_c[kWarps];
  __shared__ float top_m[kThreads];  // each warp's thread maxima, sorted
  __shared__ float cand_v[kCands];
  __shared__ int cand_i[kCands];
  __shared__ int n_cand;
  __shared__ float slot_v[2][kWarps];  // the general path's round winners
  __shared__ int slot_i[2][kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r = blockIdx.x;
  const Raw* xr = x + r * D;
  const RowLayout<Raw> L(xr, D);

  // whole chunks [cb, ce) come by TMA in kPieces pieces; the partial first
  // and last chunks' elements by scalar loads
  const int cb = L.sh ? 1 : 0;
  const int ce = max(cb, (L.sh + D) / EPC);
  int q[kPieces + 1];  // pass 1's chunk range of each piece
#pragma unroll
  for (int p = 0; p <= kPieces; ++p) q[p] = cb + (ce - cb) * p / kPieces;
  if (tid == 0) {
    n_cand = 0;
#pragma unroll
    for (int p = 0; p < kPieces; ++p) mbar_init(&bar[p], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const unsigned char* body =
        reinterpret_cast<const unsigned char*>(xr) - L.sh * ES;
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      const uint32_t bytes = 16u * (uint32_t)(q[p + 1] - q[p]);
      mbar_expect_tx(&bar[p], bytes);
      if (bytes) bulk_load(buf + 16 * q[p], body + 16 * q[p], bytes, &bar[p]);
    }
  }
  {
    const int head_end = min(D, cb * EPC - L.sh);
    const int tail_begin = max(head_end, ce * EPC - L.sh);
    if (tid < 2 * EPC) {
      const int j = tid < EPC ? tid : tail_begin + tid - EPC;
      if (tid < EPC ? j < head_end : j < D)
        reinterpret_cast<Raw*>(buf)[L.sh + j] = xr[j];
    }
  }
  q[0] = 0;
  q[kPieces] = L.nc;
  __syncthreads();  // the barriers' init and the scalar elements

  // pass 1: online max and sum of exp per thread, piece by piece
  float m = -INFINITY, s = 0.f;
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    mbar_wait0(&bar[p]);
#pragma unroll 2
    for (int c = q[p] + tid; c < q[p + 1]; c += kThreads) {
      float v[EPC];
      bool ok[EPC];
      L.chunk(buf, c, v, ok);
      float cm = v[0];
#pragma unroll
      for (int e = 1; e < EPC; ++e) cm = fmaxf(cm, v[e]);
      if (cm > m) {
        s *= ex2((m - cm) * kLog2e);
        m = cm;
      }
      if (m > -INFINITY) {
        const float mb = m * kLog2e;
#pragma unroll
        for (int e = 0; e < EPC; ++e) s += ex2(fmaf(v[e], kLog2e, -mb));
      }
    }
  }

  // logZ from the warps' (max, sum)
  float wm;
  if constexpr (kFast) {
    const float sorted = warp_sort_desc(m, lane);
    top_m[tid] = sorted;
    wm = __shfl_sync(kFull, sorted, 0);
  } else {
    wm = m;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) wm = fmaxf(wm, __shfl_xor_sync(kFull, wm, o));
  }
  const float ws = warp_sum(s > 0.f ? s * ex2((m - wm) * kLog2e) : 0.f);
  if (lane == 0) {
    red_m[warp] = wm;
    red_s[warp] = ws;
  }
  __syncthreads();
  float row_max = red_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) row_max = fmaxf(row_max, red_m[w]);
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (red_s[w] > 0.f) sum += red_s[w] * ex2((red_m[w] - row_max) * kLog2e);
  const float logz = row_max + logf(sum);

  // theta, the K-th largest of the kThreads thread maxima: K elements of the
  // row are >= theta, so every one of the top K is. It is the largest of the
  // K largest maxima of each warp whose count among all warps' K largest
  // reaches K.
  float theta = -INFINITY;
  if constexpr (kFast) {
    float t = -INFINITY;
    if (lane < K) {
      const float v = top_m[tid];
      int c = 0;
      for (int w = 0; w < kWarps; ++w)
        for (int k = 0; k < K; ++k) c += top_m[w * 32 + k] >= v;
      if (c >= K) t = v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t = fmaxf(t, __shfl_xor_sync(kFull, t, o));
    if (lane == 0) red_t[warp] = t;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) theta = fmaxf(theta, red_t[w]);
  }

  // pass 2: n_above, and the candidates >= theta appended to a list in
  // shared memory; a chunk whose max is below both thresholds (the count's
  // with a margin for rounding) is passed after one test
  const float gate = fminf(theta, logz + prune - 1e-3f * (1.f + fabsf(logz)));
  int cnt = 0;
#pragma unroll 2
  for (int c = tid; c < L.nc; c += kThreads) {
    float v[EPC];
    bool ok[EPC];
    L.chunk(buf, c, v, ok);
    float cm = v[0];
#pragma unroll
    for (int e = 1; e < EPC; ++e) cm = fmaxf(cm, v[e]);
    if (!(cm >= gate)) continue;
#pragma unroll
    for (int e = 0; e < EPC; ++e) cnt += (v[e] - logz) > prune;
    if constexpr (kFast) {
      if (cm >= theta) {
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          if (ok[e] && v[e] >= theta) {
            const int slot = atomicAdd(&n_cand, 1);
            if (slot < kCands) {
              cand_v[slot] = v[e];
              cand_i[slot] = c * EPC + e - L.sh;
            }
          }
        }
      }
    }
  }
  cnt = warp_sum(cnt);
  if (lane == 0) red_c[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red_c[w];
    blank[r] = to_f(reinterpret_cast<const Raw*>(buf)[L.sh]) - logz;
    n_above[r] = total;
  }

  float* vr = vals + r * K;
  int* ir = idx + r * K;
  const int n = kFast ? n_cand : kCands + 1;
  if (n <= kCands) {
    // each candidate's rank is the number of candidates that beat it
    if (tid < n) {
      const float v = cand_v[tid];
      const int j = cand_i[tid];
      int rank = 0;
      for (int u = 0; u < n; ++u) rank += better(cand_v[u], cand_i[u], v, j);
      if (rank < K) {
        vr[rank] = v - logz;
        ir[rank] = j;
      }
    }
  } else {  // too many candidates (ties), or K > kFastK
    topk_by_rounds(L, buf, K, logz, vr, ir, slot_v, slot_i);
  }
}

template <typename Raw, bool kFast>
int launch(const void* x, float* vals, int* idx, float* blank, int* n_above,
           int rows, int D, int K, float prune, cudaStream_t stream) {
  constexpr int ES = sizeof(Raw);
  // the row and up to 16 - ES bytes before it, in whole chunks
  const size_t smem = kHeader + ((size_t)D * ES + 16 - ES + 15) / 16 * 16;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto* kernel = topk_logsoftmax_kernel<Raw, kFast>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<rows, kThreads, smem, stream>>>(static_cast<const Raw*>(x), vals, idx,
                                     blank, n_above, D, K, prune);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest K of the fast path (candidates above the K-th thread maximum,
// ranked in shared memory); larger K take the general path.
extern "C" int hctr_topk_logsoftmax_fast_k() { return kFastK; }

// x: (rows, D) raw logits, f32 (elem_bytes 4) or bf16 (elem_bytes 2), each
// element aligned to its size; vals, idx: (rows, K); blank, n_above: (rows,).
// Requires 1 <= K <= D (the wrapper checks it) and a row that fits in
// shared memory (D up to about 57,600 f32 or 115,200 bf16;
// cudaErrorInvalidValue otherwise). Returns cudaGetLastError() after the launch.
extern "C" int hctr_topk_logsoftmax(const void* x, float* vals, int* idx,
                                    float* blank, int* n_above, int rows,
                                    int D, int K, float prune, int elem_bytes,
                                    cudaStream_t stream) {
  const bool fast = K <= kFastK;
  if (elem_bytes == 4)
    return fast ? launch<uint32_t, true>(x, vals, idx, blank, n_above, rows, D,
                                         K, prune, stream)
                : launch<uint32_t, false>(x, vals, idx, blank, n_above, rows,
                                          D, K, prune, stream);
  if (elem_bytes == 2)
    return fast ? launch<uint16_t, true>(x, vals, idx, blank, n_above, rows, D,
                                         K, prune, stream)
                : launch<uint16_t, false>(x, vals, idx, blank, n_above, rows,
                                          D, K, prune, stream);
  return (int)cudaErrorInvalidValue;
}
