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
//                                                  the cache dtype with the
//                                                  final row max m, as the
//                                                  JAX kernel does)
//
// with m = -1e30, l = 0 and o = 0 for an empty cache. The caller merges them
// with the own-row causal part. The (B, N, H, L) score tensor never reaches
// device memory.
//
// Bound on this card: bytes. Each query, valid key and value element is read
// once and the partials written once (o in f32 is the largest part), against
// 4 * Dh flops per (query, valid key) pair: at the served frame (40 beams,
// N = 84, H = 8, Dh = 64, bf16) about 10 MB and 0.04 GFLOP, at trained depth
// (caches 40-50 deep) about 14 MB and 0.3 GFLOP, far below the card's ratio
// of flops to bytes. So the design streams q and o at full width, keeps the
// per-query serialisation of the old kernel off the critical path and fills
// the card in one wave of blocks. Shared memory does not depend on the
// cache depth L: the cache is read in tiles of 64 keys.
//
// Two passes over the key tiles, not one online rescale: the weights must be
// rounded to the cache dtype after subtracting the FINAL row max. A one-pass
// flash loop would round exp(s - m_tile) and rescale it by exp(m_tile - m)
// later, which can move a weight by a bf16 step and is not the JAX function.
// Pass 1 finds m; pass 2 sums l in f32 from the unrounded weights and
// multiplies the rounded weights with v. A cache of one tile (64 valid keys
// or fewer: the served frame and trained depth) keeps its scores in
// registers between the passes; a deeper one computes them again.
//
// bf16 caches with Dh = 64 (`peek_tc_kernel`, the search's path): one block
// per (beam, head, group of up to 3 x 16 queries), a warp per 16 queries.
// The scores are the plain version's f32 scores bit for bit (see the note
// at the kernel): S = Q K^T runs on the SIMT units from f32 copies of the
// warp's queries and of the key tile in shared memory, each lane computing
// 2 rows x 16 keys laid out as the m16n8 accumulator, so that the bf16
// weights P go from registers straight into the A fragments of O = P V,
// which runs on `mma.sync.m16n8k16` with f32 accumulation (values arrive
// by `cp.async`, zero-filled past lengths[b]; only valid keys are read, and
// 8-key groups past lengths[b] skipped). o leaves as 16-byte vectors (lane pairs swap halves so each
// lane holds 4 consecutive floats of one row); m and l once per row.
//
// f32 caches (`--lm-f32`), and other head sizes up to 128
// (`peek_simt_kernel`): the same L tiling and two passes on the SIMT units.
// One block per (beam, head, 32 queries), a warp per 4 queries; a lane takes
// keys for the scores and head dimensions for the weighted sum of v.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int KT = 64;  // keys per tile, both paths

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T and back (the JAX kernel casts the weights to the cache dtype)
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ----------------------------------------------------- tensor-core path
constexpr int TC_DH = 64;
// warps (16 queries each) per block: 3 keeps registers (about 128 a
// thread) and shared memory (40 KB) at 5 blocks an SM, so the served
// frame's 640 blocks (40 beams x 8 heads x 84 queries) run in one wave
constexpr int TC_MAX_WARPS = 3;
constexpr int TC_BLOCKS_PER_SM = 5;
constexpr int TC_VSTRIDE = TC_DH + 8;  // bf16 v rows of 144 bytes: 8 ldmatrix rows, 8 bank groups
constexpr int TC_FSTRIDE = TC_DH + 4;  // f32 q and k rows of 272 bytes: float4 reads conflict-free

__host__ __device__ constexpr size_t tc_smem_bytes(int warps) {
  return sizeof(float) * ((size_t)warps * 16 * TC_FSTRIDE + (size_t)KT * TC_FSTRIDE) +
         sizeof(__nv_bfloat16) * (size_t)KT * TC_VSTRIDE;
}

// 16 bytes global -> shared; when !valid, 16 zero bytes (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 bf16 (16 bytes) -> 8 f32 in shared memory; exact
__device__ __forceinline__ void store_f32x8(float* dst, uint4 raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// The scores feed the bf16 rounding of the weights, so they are the plain
// version's f32 scores bit for bit: each one a chain of f32 FMAs over the
// head dimension in order from 0. A tensor-core sum of the same products
// rounds differently, moves a score by an ulp, and flips the rounding of
// some weights by a bf16 step (on the H100 at the served frame's shapes,
// 0.14% of max |o|, over the 0.1% that chip_smoke.py allows). So
// S = Q K^T runs on the SIMT units, laid out
// as the mma accumulator so that the weights go straight into the A
// fragments of O = P V, which runs on the tensor cores (its bf16 x bf16
// products are exact in f32 and only their sum order changes).
__global__ void __launch_bounds__(TC_MAX_WARPS * 32, TC_BLOCKS_PER_SM)
peek_tc_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const int* __restrict__ lengths, float* __restrict__ o,
               float* __restrict__ m_out, float* __restrict__ l_out, int N,
               int L, int H) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int nw = blockDim.x / 32;
  float* qs = reinterpret_cast<float*>(tc_smem);              // [nw][16][FSTRIDE]
  float* ks = qs + (size_t)nw * 16 * TC_FSTRIDE;              // [KT][FSTRIDE]
  __nv_bfloat16* vs =
      reinterpret_cast<__nv_bfloat16*>(ks + KT * TC_FSTRIDE);  // [KT][VSTRIDE]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 4, c = lane % 4;  // fragment row and column pair
  const int n0 = (blockIdx.y * nw + warp) * 16;
  const bool active = n0 < N;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > L ? L : len);
  const int n_t = (len + KT - 1) / KT;
  const size_t rs = (size_t)H * TC_DH;  // elements between rows of q, k, v
  const __nv_bfloat16* kb = k + (size_t)b * L * rs + h * TC_DH;
  const __nv_bfloat16* vb = v + (size_t)b * L * rs + h * TC_DH;
  const __nv_bfloat16* qb = q + (size_t)b * N * rs + h * TC_DH;

  // this warp's 16 queries (16 rows x 8 chunks of 16 bytes, 4 a lane): read
  // now, stored as f32 rows in shared memory once the first key tile's
  // reads are under way too
  float* qw = qs + (size_t)warp * 16 * TC_FSTRIDE;
  uint4 qraw[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = lane + 32 * u, n = n0 + e / 8;
    qraw[u] = n < N ? __ldg(reinterpret_cast<const uint4*>(qb + n * rs + (e % 8) * 8))
                    : make_uint4(0u, 0u, 0u, 0u);
  }

  // tile t of the cache: the valid keys as f32; with_v, the values as bf16
  // for the 16-key chunks the P V product reads, zeros past len (a zero
  // weight times a stale value could be NaN). Keys past len stay stale:
  // their scores are masked
  auto load = [&](int t, bool with_v) {
    __syncthreads();  // nobody reads the previous tile any more
    const int nk = min(KT, len - t * KT);
    if (with_v) {
      const int nv = min(KT, (nk + 15) / 16 * 16);
      for (int e = threadIdx.x; e < nv * 8; e += blockDim.x) {
        const int key = e / 8;
        const bool valid = key < nk;
        cp_async16(vs + key * TC_VSTRIDE + (e % 8) * 8,
                   vb + (valid ? (size_t)(t * KT + key) * rs + (e % 8) * 8 : 0),
                   valid);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    // 4 reads a thread in flight before the first is converted
    for (int base = threadIdx.x; base < nk * 8; base += 4 * blockDim.x) {
      uint4 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = base + u * blockDim.x;
        raw[u] = e < nk * 8 ? __ldg(reinterpret_cast<const uint4*>(
                                  kb + (size_t)(t * KT + e / 8) * rs + (e % 8) * 8))
                            : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = base + u * blockDim.x;
        if (e < nk * 8) store_f32x8(ks + (e / 8) * TC_FSTRIDE + (e % 8) * 8, raw[u]);
      }
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
  };

  // sc[i][2 hh + e]: the score of row r + 8 hh and key t * 64 + 8 i + 2 c + e
  // (the m16n8 accumulator layout); 8-key groups wholly past len are skipped
  float sc[8][4];
  auto scores = [&](int t) {
    const int groups = min(8, (len - t * KT + 7) / 8);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
    const float* q0 = qw + r * TC_FSTRIDE;
    const float* q1 = qw + (r + 8) * TC_FSTRIDE;
#pragma unroll 2
    for (int j = 0; j < TC_DH / 4; ++j) {
      const float4 a0 = reinterpret_cast<const float4*>(q0)[j];
      const float4 a1 = reinterpret_cast<const float4*>(q1)[j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i >= groups) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 kv =
              reinterpret_cast<const float4*>(ks + (8 * i + 2 * c + e) * TC_FSTRIDE)[j];
          sc[i][e] = fmaf(a0.x, kv.x, sc[i][e]);
          sc[i][e] = fmaf(a0.y, kv.y, sc[i][e]);
          sc[i][e] = fmaf(a0.z, kv.z, sc[i][e]);
          sc[i][e] = fmaf(a0.w, kv.w, sc[i][e]);
          sc[i][2 + e] = fmaf(a1.x, kv.x, sc[i][2 + e]);
          sc[i][2 + e] = fmaf(a1.y, kv.y, sc[i][2 + e]);
          sc[i][2 + e] = fmaf(a1.z, kv.z, sc[i][2 + e]);
          sc[i][2 + e] = fmaf(a1.w, kv.w, sc[i][2 + e]);
        }
      }
    }
  };

  float mx[2] = {-INFINITY, -INFINITY};  // rows r and r + 8
  float lsum[2] = {0.f, 0.f};
  float oacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;

  // P = exp(S - m) for tile t: l from the f32 weights, the bf16 weights into
  // A fragments (16 keys each) of O += P V
  auto weigh = [&](int t) {
    const int kbase = t * KT + 2 * c;
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = kbase + 8 * i + (e & 1) < len ? expf(sc[i][e] - mx[e >> 1]) : 0.f;
        lsum[e >> 1] += p[e];
      }
      pa[i / 2][(i % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[i / 2][(i % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      if (16 * kc >= len - t * KT) break;
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vs + (16 * kc + (lane % 8) + ((lane / 8) % 2) * 8) * TC_VSTRIDE +
                          16 * dp + (lane / 16) * 8);
        mma16816(oacc[2 * dp], pa[kc], bv[0], bv[1]);
        mma16816(oacc[2 * dp + 1], pa[kc], bv[2], bv[3]);
      }
    }
  };

  // pass 1: the row max. A cache of one tile keeps its scores and values for
  // pass 2; a deeper one reads each tile again there
  for (int t = 0; t < n_t; ++t) {
    load(t, n_t == 1);
    if (t == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = lane + 32 * u;
        store_f32x8(qw + (e / 8) * TC_FSTRIDE + (e % 8) * 8, qraw[u]);
      }
      __syncwarp();
    }
    if (!active) continue;
    scores(t);
    const int kbase = t * KT + 2 * c;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kbase + 8 * i + (e & 1) < len) mx[e >> 1] = fmaxf(mx[e >> 1], sc[i][e]);
  }
  if (active) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
    if (n_t == 1) weigh(0);
  }
  for (int t = 0; n_t > 1 && t < n_t; ++t) {  // pass 2
    load(t, true);
    if (!active) continue;
    scores(t);
    weigh(t);
  }
  if (!active) return;

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 1);
    lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 2);
  }
  // o: oacc[i][2 hh + e] is row r + 8 hh, dim 8 i + 2 c + e. Lanes 2j and
  // 2j + 1 swap halves: the even lane stores row r, the odd lane row r + 8,
  // 4 consecutive dims each
  const bool even = (c & 1) == 0;
  const int n_st = n0 + r + (even ? 0 : 8);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float s0 = even ? oacc[i][2] : oacc[i][0];
    const float s1 = even ? oacc[i][3] : oacc[i][1];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const float4 val = even ? make_float4(oacc[i][0], oacc[i][1], r0, r1)
                            : make_float4(r0, r1, oacc[i][2], oacc[i][3]);
    const int col = 8 * i + 2 * (c & ~1);
    if (n_st < N)
      *reinterpret_cast<float4*>(o + ((size_t)(b * N + n_st) * H + h) * TC_DH + col) = val;
  }
  if (c == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = n0 + r + 8 * hh;
      if (n < N) {
        const size_t row = (size_t)(b * N + n) * H + h;
        m_out[row] = len > 0 ? mx[hh] : kNeg;
        l_out[row] = lsum[hh];
      }
    }
  }
}

// ------------------------------------------------------------ SIMT path
constexpr int S_THREADS = 256;
constexpr int S_WARPS = S_THREADS / 32;
constexpr int S_QPW = 4;                    // queries per warp
constexpr int S_QUERIES = S_WARPS * S_QPW;  // queries per block
constexpr int S_MAX_DH = 128;               // 4 dims a lane

__host__ __device__ constexpr size_t simt_smem_floats(int dh) {
  return (size_t)KT * (dh + 1) + (size_t)KT * dh + (size_t)S_QUERIES * dh +
         (size_t)S_WARPS * KT;
}

template <typename T>
__global__ void __launch_bounds__(S_THREADS)
peek_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ o, float* __restrict__ m_out,
                 float* __restrict__ l_out, int N, int L, int H, int Dh) {
  extern __shared__ __align__(16) float fsm[];
  const int kp = Dh + 1;         // keys padded by one word against bank conflicts
  float* ks = fsm;               // [KT][kp]
  float* vs = ks + KT * kp;      // [KT][Dh]
  float* qs = vs + KT * Dh;      // [S_QUERIES][Dh]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ps = qs + S_QUERIES * Dh + warp * KT;  // [S_WARPS][KT]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int nb = blockIdx.y * S_QUERIES;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > L ? L : len);
  const int n_t = (len + KT - 1) / KT;

  for (int e = threadIdx.x; e < S_QUERIES * Dh; e += S_THREADS) {
    const int qi = e / Dh, d = e % Dh;
    const int n = nb + qi;
    qs[e] = n < N ? to_f(q[(((size_t)b * N + n) * H + h) * Dh + d]) : 0.f;
  }

  float mq[S_QPW], lq[S_QPW], acc[S_QPW][S_MAX_DH / 32];
#pragma unroll
  for (int i = 0; i < S_QPW; ++i) {
    mq[i] = -INFINITY;
    lq[i] = 0.f;
#pragma unroll
    for (int j = 0; j < S_MAX_DH / 32; ++j) acc[i][j] = 0.f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < n_t; ++t) {
      __syncthreads();  // the previous tile (and the queries) are done with
      for (int e = threadIdx.x; e < KT * Dh; e += S_THREADS) {
        const int key = e / Dh, d = e % Dh;
        const int kk = t * KT + key;
        const size_t g = (((size_t)b * L + kk) * H + h) * Dh + d;
        ks[key * kp + d] = kk < len ? to_f(k[g]) : 0.f;
        if (pass == 1) vs[key * Dh + d] = kk < len ? to_f(v[g]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < S_QPW; ++i) {
        const float* qr = qs + (warp * S_QPW + i) * Dh;
        for (int key = lane; key < KT; key += 32) {
          if (t * KT + key >= len) {
            if (pass == 1) ps[key] = 0.f;
            continue;
          }
          const float* kr = ks + key * kp;
          float s = 0.f;
          for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], kr[d], s);
          if (pass == 0) {
            mq[i] = fmaxf(mq[i], s);
          } else {
            const float p = expf(s - mq[i]);
            lq[i] += p;
            ps[key] = round_to<T>(p);
          }
        }
        if (pass == 1) {
          __syncwarp();
#pragma unroll
          for (int j = 0; j < S_MAX_DH / 32; ++j) {
            const int d = lane + 32 * j;
            if (d < Dh) {
              float a = acc[i][j];
              for (int key = 0; key < KT; ++key) a = fmaf(ps[key], vs[key * Dh + d], a);
              acc[i][j] = a;
            }
          }
          __syncwarp();
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < S_QPW; ++i) mq[i] = warp_max(mq[i]);
    }
  }

#pragma unroll
  for (int i = 0; i < S_QPW; ++i) {
    const int n = nb + warp * S_QPW + i;
    const float l = warp_sum(lq[i]);
    if (n >= N) continue;
    const size_t row = ((size_t)b * N + n) * H + h;
#pragma unroll
    for (int j = 0; j < S_MAX_DH / 32; ++j) {
      const int d = lane + 32 * j;
      if (d < Dh) o[row * Dh + d] = acc[i][j];
    }
    if (lane == 0) {
      m_out[row] = len > 0 ? mq[i] : kNeg;
      l_out[row] = l;
    }
  }
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, const int* lengths,
                float* o, float* m, float* l, int B, int N, int L, int H,
                int Dh, cudaStream_t stream) {
  const size_t smem = simt_smem_floats(Dh) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        peek_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (N + S_QUERIES - 1) / S_QUERIES);
  peek_simt_kernel<T><<<grid, S_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, o, m, l, N, L, H, Dh);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, N, H, Dh); k, v: (B, L, H, Dh), all of one dtype (bf16 when
// is_bf16, else f32); lengths: (B,) int32; o: (B, N, H, Dh) f32; m, l:
// (B, N, H) f32; Dh at most 128. bf16 with Dh = 64 (16-byte aligned rows)
// runs on the tensor cores, the rest on the SIMT units. Returns
// cudaGetLastError() after the launch.
extern "C" int hctr_peek_cache_attention(const void* q, const void* k,
                                         const void* v, const int* lengths,
                                         float* o, float* m, float* l, int B,
                                         int N, int L, int H, int Dh,
                                         int is_bf16, cudaStream_t stream) {
  if (is_bf16 && Dh == TC_DH) {
    const int warps = (N + 15) / 16 < TC_MAX_WARPS ? (N + 15) / 16 : TC_MAX_WARPS;
    static bool smem_set = false;
    if (!smem_set) {
      cudaError_t e = cudaFuncSetAttribute(
          peek_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)tc_smem_bytes(TC_MAX_WARPS));
      if (e != cudaSuccess) return (int)e;
      smem_set = true;
    }
    const dim3 grid(B * H, (N + 16 * warps - 1) / (16 * warps));
    peek_tc_kernel<<<grid, warps * 32, tc_smem_bytes(warps), stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, lengths, o, m, l, N, L, H);
    return (int)cudaGetLastError();
  }
  if (is_bf16)
    return launch_simt<__nv_bfloat16>(q, k, v, lengths, o, m, l, B, N, L, H,
                                      Dh, stream);
  return launch_simt<float>(q, k, v, lengths, o, m, l, B, N, L, H, Dh, stream);
}
