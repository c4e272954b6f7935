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
// inputs (3 us). So the product has to run on the tensor cores, and nothing
// else may stand in their way: not the loads, not the online max/sum.
//
// Blocks run unordered on Hopper, where the TPU kernel carried its online
// max/sum across a sequential grid axis: the vocabulary is cut into
// `n_split` ranges, one block per (row tile, range) keeps the online max m
// and sum l of its range for its rows, and a second small kernel combines
// the ranges' (m, l) pairs into m + log(l).
//
// bf16 inputs (`lse_tc_kernel`, the search's path): `wgmma` on the tensor
// cores. bf16 x bf16 products summed in f32 are the f32 products of the
// plain version; only the order of the sums differs. A block of two
// consumer warpgroups and one producer warp takes 128 rows of x and one
// vocabulary range:
//   - the producer warp: one thread loads the block's x tile once (d / 64
//     chunks of 128 rows x 64, 128 KB at d = 512, resident for the whole
//     range) and streams emb tiles (256 vocabulary entries x 64 depth,
//     32 KB) through a 3-stage ring, all by TMA into 128-byte-swizzled
//     shared memory, each stage guarded by a full and an empty `mbarrier`;
//   - warpgroups 0 and 1 own 64 rows each and issue m64n256k16 `wgmma`s
//     with both operands in shared memory (emb is (V, d), K-contiguous, as
//     the B operand wants), one stage's group in flight while the next is
//     issued. Both operands are read from shared memory by every wgmma:
//     at N = 256 that is 10 KB per 0.5 MFLOP, under the SM's 128 bytes a
//     clock at the tensor cores' rate with the TMA writes added; at N = 128
//     it is not. After the full depth of a vocabulary tile each thread
//     folds its 2 rows x 64 logits into its own running (m, l) straight
//     from the accumulator registers (base-2, no shared-memory round
//     trip); the 4 threads of a row join theirs once at the end.
// Columns past the range end (and past V, which TMA fills with zeros that
// would add exp(0 - m)) are masked to -inf; rows past `rows` are zero-filled
// by TMA and never written.
//
// f32 inputs (`--lm-f32`), and bf16 shapes the TMA path does not take (d not
// a multiple of 8, or above 512), run `lse_partial_kernel` on the f32 SIMT
// units: 64 x 32 chunks of x and emb staged in shared memory as f32, a 4 x 4
// tile of logits a thread, and each 64 x 64 logits tile passed through
// shared memory once for the online update. TF32 would change the function.

#include <cuda.h>  // CUtensorMap and its enums only: no driver symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ SIMT path
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

// ----------------------------------------------------- tensor-core path
constexpr int TC_THREADS = 288;   // warpgroups 0 and 1 consume, warp 8 produces
constexpr int TC_ROWS = 128;      // x rows per block, 64 per consumer
constexpr int TC_V = 256;         // vocabulary entries per tile (wgmma N)
constexpr int TC_K = 64;          // depth per TMA box: one 128-byte swizzle row
constexpr int TC_STAGES = 3;      // emb tiles in flight
constexpr int TC_MAX_KT = 8;      // x resident up to d = 512
constexpr int TC_X_BYTES = TC_ROWS * TC_K * 2;  // an x chunk
constexpr int TC_E_BYTES = TC_V * TC_K * 2;     // an emb tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr size_t tc_smem_bytes(int kt) {
  return 1024 + (size_t)kt * TC_X_BYTES + (size_t)TC_STAGES * TC_E_BYTES +
         sizeof(uint64_t) * (TC_MAX_KT + 2 * TC_STAGES);
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// waits for the phase of `bar` with this parity; a wait that never ends
// (a TMA that was never issued) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// TMA: the box at (column c0, row c1) of `map` into shared memory at dst,
// completing its bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle:
// leading offset 16 bytes (unused for this layout), 1024 bytes between
// groups of 8 rows
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32, in the warpgroup's registers) += A (64 x 16) . B^T
// (256 x 16), both bf16 in shared memory, K-major
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// 2^x on the SFU (relative error about 2^-22, far inside K3's tolerance)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// running base-2 (m, l) of one row folded with (m_o, l_o)
__device__ __forceinline__ void fold(float& m, float& l, float m_o, float l_o) {
  const float m_n = fmaxf(m, m_o);
  if (m_n == -INFINITY) return;  // both empty
  l = (m == -INFINITY ? 0.f : l * exp2f(m - m_n)) +
      (m_o == -INFINITY ? 0.f : l_o * exp2f(m_o - m_n));
  m = m_n;
}

__global__ void __launch_bounds__(TC_THREADS, 1)
lse_tc_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap emap, float* __restrict__ pm,
              float* __restrict__ pl, int rows, int V, int kt, int v_per_split,
              int n_split) {
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries (the swizzle reads address
  // bits 7-9, and the descriptors' base offset is 0)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                                // kt x [128][64]
  unsigned char* es = smem + (size_t)kt * TC_X_BYTES;      // ring [256][64]
  uint64_t* xbar = reinterpret_cast<uint64_t*>(es + TC_STAGES * TC_E_BYTES);
  uint64_t* full = xbar + TC_MAX_KT;
  uint64_t* empty = full + TC_STAGES;

  const int r0 = blockIdx.x * TC_ROWS;
  const int split = blockIdx.y;
  const int vbeg = split * v_per_split;
  const int vend = min(V, vbeg + v_per_split);
  const int n_tiles = (vend - vbeg + TC_V - 1) / TC_V;
  const int wg = threadIdx.x / 128;  // 0, 1: consumers; 2: the producer warp

  if (threadIdx.x == 0) {
    for (int i = 0; i < kt; ++i) mbar_init(&xbar[i], 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    if (threadIdx.x == 256) {
      for (int i = 0; i < kt; ++i) {
        mbar_expect_tx(&xbar[i], TC_X_BYTES);
        tma_load_2d(xs + (size_t)i * TC_X_BYTES, &xmap, &xbar[i], i * TC_K, r0);
      }
      for (int it = 0; it < n_tiles * kt; ++it) {
        const int s = it % TC_STAGES;
        // the first pass over the ring waits on the phase before init,
        // which counts as complete
        mbar_wait(&empty[s], ((it / TC_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], TC_E_BYTES);
        tma_load_2d(es + (size_t)s * TC_E_BYTES, &emap, &full[s],
                    (it % kt) * TC_K, vbeg + (it / kt) * TC_V);
      }
    }
    return;
  }

  const int cw = wg;                      // consumer: rows cw * 64 .. + 63
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  // this thread's accumulator layout (m64nNk16): d[4c + 2h + e] is row
  // 16 * warp + lane / 4 + 8 * h, column 8 * c + 2 * (lane % 4) + e
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[128];
  for (int j = 0; j < n_tiles; ++j) {
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    // one stage's wgmmas stay in flight while the next stage's are issued;
    // a stage goes back to the producer once its group has completed
    for (int kk = 0; kk < kt; ++kk) {
      const int it = j * kt + kk;
      const int s = it % TC_STAGES;
      if (j == 0) mbar_wait(&xbar[kk], 0);
      mbar_wait(&full[s], (it / TC_STAGES) & 1);
      __syncwarp();  // wgmma wants the warp converged
      const uint64_t da =
          smem_desc(xs + (size_t)kk * TC_X_BYTES + cw * 64 * TC_K * 2);
      const uint64_t db = smem_desc(es + (size_t)s * TC_E_BYTES);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k16 = 0; k16 < TC_K / 16; ++k16)  // 32 bytes of depth each
        wgmma_m64n256k16(acc, da + 2 * k16, db + 2 * k16);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_acc(acc);
      if (kk > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (lane == 0) mbar_arrive(&empty[(it - 1) % TC_STAGES]);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[(j * kt + kt - 1) % TC_STAGES]);
    const int cols = vend - (vbeg + j * TC_V);  // valid columns of this tile
    if (cols < TC_V) {  // the range's last tile: mask the columns past it
#pragma unroll
      for (int c = 0; c < TC_V / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * c + 2 * (lane % 4) + e >= cols) {
            acc[4 * c + e] = -INFINITY;
            acc[4 * c + 2 + e] = -INFINITY;
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < TC_V / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) tmax = fmaxf(tmax, acc[4 * c + 2 * h + e]);
      const float m_new = fmaxf(m_run[h], tmax * kLog2e);
      if (m_new == -INFINITY) continue;  // no valid column yet
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < TC_V / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sum += ex2(fmaf(acc[4 * c + 2 * h + e], kLog2e, -m_new));
      l_run[h] = (m_run[h] == -INFINITY ? 0.f : l_run[h] * ex2(m_run[h] - m_new)) + sum;
      m_run[h] = m_new;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      fold(m_run[h], l_run[h], __shfl_xor_sync(0xffffffffu, m_run[h], off),
           __shfl_xor_sync(0xffffffffu, l_run[h], off));
    const int row = r0 + cw * 64 + warp * 16 + lane / 4 + 8 * h;
    if (lane % 4 == 0 && row < rows) {
      pm[(size_t)row * n_split + split] = m_run[h] * kLn2;
      pl[(size_t)row * n_split + split] = l_run[h];
    }
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
  for (int s = 0; s < n_split; ++s) {
    const float ms = pm[(size_t)r * n_split + s];
    if (ms != -INFINITY) l += pl[(size_t)r * n_split + s] * expf(ms - m);
  }
  out[r] = m + logf(l);
}

int combine(const float* pm, const float* pl, float* out, int rows,
            int n_split, cudaStream_t stream) {
  lse_combine_kernel<<<(rows + 255) / 256, 256, 0, stream>>>(pm, pl, out, rows,
                                                            n_split);
  return (int)cudaGetLastError();
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
  return combine(pm, pl, out, rows, n_split, stream);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// a (n, d) bf16 row-major matrix in boxes of box_rows rows x 64 columns,
// 128-byte swizzle; out-of-range rows and columns read as zeros
bool make_map(CUtensorMap* map, const void* base, int n, int d, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {TC_K, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// The tensor-core path: bf16 x (rows, d) and emb (V, d), 16-byte aligned,
// d a multiple of 8 and at most 512; v_per_split a multiple of 256 with
// every range non-empty. Returns -1 when the TMA descriptors cannot be
// made, else cudaGetLastError() after the launches.
extern "C" int hctr_lse_rows_tc(const void* x, const void* emb, float* pm,
                                float* pl, float* out, int rows, int V, int d,
                                int v_per_split, int n_split,
                                cudaStream_t stream) {
  CUtensorMap xmap, emap;
  if (!make_map(&xmap, x, rows, d, TC_ROWS) || !make_map(&emap, emb, V, d, TC_V))
    return -1;
  const int kt = (d + TC_K - 1) / TC_K;
  const size_t smem = tc_smem_bytes(kt);
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        lse_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tc_smem_bytes(TC_MAX_KT));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid((rows + TC_ROWS - 1) / TC_ROWS, n_split);
  lse_tc_kernel<<<grid, TC_THREADS, smem, stream>>>(xmap, emap, pm, pl, rows,
                                                    V, kt, v_per_split, n_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return combine(pm, pl, out, rows, n_split, stream);
}
