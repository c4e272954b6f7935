// int8 quantization and the s8 x s8 -> s32 implicit-GEMM convolution of the
// int8 serving forward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's int8 route
// (handwritten_chinese_ocr_samples_tpu/models/hctr.py:59, QuantizableConv,
// and lm/cached.py:198-231, the LM's `_q_mm`) is XLA's
// `conv_general_dilated(..., preferred_element_type=int32)` and einsum on
// int8 operands. PyTorch has no int8 convolution on CUDA, so this file is
// the route's kernel. Two entry points:
//
//   hctr_int8_quantize: q = clip(rint(x / s_x), -127, 127) as s8, from a
//     (B, C, HW) compute-dtype tensor (NCHW, or (M, K) rows with HW = 1)
//     into (B, HW, C) (NHWC). s_x is read from a device pointer (a
//     calibrated constant for the conv, a device reduction for the LM).
//     rintf rounds half to even, as jnp.round and torch.round do; the
//     division is IEEE (__fdiv_rn), never a multiply by the reciprocal.
//
//   hctr_int8_conv: out[b, n, h, w] = ((float)acc * alpha) * scale[n]
//     + bias[n], each step rounded (__fmul_rn, __fadd_rn: nvcc would
//     contract a * b + c into an FMA), written in the compute dtype, NCHW,
//     where acc is the exact s32 sum over (dy, dx, c) of
//     x[b, h + dy - pad, w + dx - pad, c] * w[n, dy, dx, c] (zero outside
//     the image). Stride 1, (kh, kw) of (3, 3) with pad 1 or (1, 1) with
//     pad 0, any B/H/W, Cin from 1 up. A GEMM (the LM) is (1, 1) with
//     H = W = 1: out (M, N). The conv passes alpha = 1 and scale = s_x * s_w
//     (the f32 product, as JAX forms it); the LM passes alpha = s_x and
//     scale = s_w. Either order is then the plain version's, exactly. The
//     s32 sum is exact in any order, so both conv kernels below give the
//     plain version's bits.
//
// Bounds on this card. The conv is operations-bound: 2 * B*H*W * Cout *
// Cin*9 int8 operations (at the heaviest site of full hctr, b4, 512 -> 512,
// H 16, W 1600: 483 GOP, 0.244 ms at 1979 TOPS) against the s8 activation
// in, the s8 weights and the compute-dtype output (about 80 MB, 0.024 ms at
// 3.35 TB/s). So the product runs on the tensor cores. The quantize is
// bytes-bound: it reads the compute-dtype activation once and writes one s8
// byte an element (157 MB at that site in bf16, 0.047 ms).
//
// Design of the quantize (NCHW -> NHWC): a block of 256 threads moves a
// tile of 128 channels x 128 positions (64 x 256 where C <= 64, so that no
// thread idles at hctr's 64-channel sites), reading 256 or 512 contiguous
// bytes of each row (a tile of half the size took 7% longer at hctr's
// sites on an H100). Each thread reads 16-byte vectors along HW (8 bf16 or
// 4 f32) from 4 neighbouring channels, so 8 lanes read 128 contiguous
// bytes of a row; it quantizes them and writes, for each position, the 4
// channels' bytes as one 32-bit word into a shared tile [positions]
// [channels]. The tile's 16-byte chunks are XOR-swizzled by position, so
// the word stores of a warp hit 32 distinct banks (2 ways at 64 channels,
// whose 64-byte rows pair up) and the 16-byte loads that read a position's
// channels back are free of conflicts. Stores are 16-byte vectors of s8
// along C, 8 (or 4) lanes a run of one position. Where HW is not a
// multiple of the vector (or C of 16) that side falls back to scalar
// accesses. C == 1 or HW == 1 needs no transpose: a flat pass reads 16
// elements a thread and writes them as one 16-byte vector.
//
// Design of the conv. Two kernels; `int8_conv.conv_route` (ops/int8_conv.py)
// picks one by shape and passes the choice in `route`:
//
//   wgmma (route 1), for an NHWC input with Cin a multiple of 64 and a 3x3
//   (pad 1) or 1x1 kernel: 32 of the 33 sites of full hctr.
//   - GEMM view: M = output pixels, N = Cout, K = (dy, dx, c). An M tile is
//     128 consecutive pixels of one image row, (b, h, w0 .. w0 + 127); an N
//     tile is 64, 128 or 256 channels (Cout 64, <= 128, above). W = 1600
//     leaves a last tile of 64 valid pixels: 3.8% of the tiles' work is
//     padding at full width, not worth a second tile shape.
//   - A by TMA, with no im2col arithmetic: each (tap, channel chunk) is one
//     4-D box {BK channels, 128 w, 1 h, 1 b} of the NHWC s8 activation at
//     (c0, w0 + dx - pad, h + dy - pad, b). TMA's zero fill outside the
//     tensor is exactly the convolution's zero padding and the W tail. BK
//     is 128 bytes with 128-byte swizzle where Cin is a multiple of 128,
//     else 64 bytes with 64-byte swizzle. NHWC makes A K-major, as the
//     8-bit wgmma requires.
//   - B by TMA: a 2-D box {BK, N tile} of the packed (N, Kp) weight at
//     (tap * Cin + c0, n0), K-major; rows past Cout read as zeros.
//   - A block is one producer warp and two consumer warpgroups. The
//     producer keeps a ring of stages (as many as fit 192 KB, at most 8: 4
//     at BK 128 and N 256) full, each stage guarded by a full and an empty
//     mbarrier; every wait traps after about 2^26 polls instead of hanging.
//     Each consumer owns 64 rows and issues
//     wgmma.mma_async.m64nNk32.s32.s8.s8 with both operands in shared
//     memory, one stage's group in flight while the next is issued.
//   - Epilogue: each consumer dequantises its accumulators as above (scale
//     and bias staged in shared memory) and writes them into the ring's
//     space transposed to (n, w), its 16-byte chunks XOR-swizzled by n so
//     the fragment stores are free of bank conflicts; then every thread
//     stores 16-byte vectors along W, a contiguous run of W of the NCHW
//     output per channel (scalar where W x the element size is not a
//     multiple of 16, or at the W tail).
//
//   mma (route 0), every other shape: Cin 1 and 8-32 (conv0_1, hctr-tiny's
//   narrow sites) and the LM's GEMMs, and any shape when asked (timing).
//   - A block of 4 warps computes a 128 x 64 tile of (M, N); each warp a
//     64 x 32 tile with mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.
//   - K is tiled by 32 through shared memory in a 3-stage cp.async ring.
//     The A tile is the implicit im2col of 128 pixels: where Cin is a
//     multiple of 16 each 16-byte chunk of a 32-deep slice lies inside one
//     (dy, dx) tap, so it is one 16-byte cp.async, zero-filled outside the
//     image and past K; else (Cin 1 and 8) each byte is gathered on its
//     own. Rows are 48 bytes apart in shared memory, so the fragment loads
//     of a warp hit 32 distinct banks.
//   - The epilogue writes each fragment element where it belongs in NCHW.
//
// The s32 accumulator is exact: |acc| <= 127 * 127 * Kp, 7.4e7 at Cin 512
// x 9.

#include <cuda.h>  // CUtensorMap and its enums only: no driver symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------- quantize
template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int8_t quant1(float v, float sx) {
  float q = rintf(__fdiv_rn(v, sx));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return (int8_t)(int)q;
}

// The 16 / sizeof(T) elements of a 16-byte vector, as floats.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) v[i] = to_f(e[i]);
}

// Elementwise, where the layouts agree (C == 1 or HW == 1): 16 elements a
// thread, one 16-byte store of s8 (vec: x and q 16-byte aligned), the last
// n % 16 elements, or all where unaligned, one at a time.
template <typename T>
__global__ void quantize_flat_kernel(const T* __restrict__ x,
                                     const float* __restrict__ sx_ptr,
                                     int8_t* __restrict__ q, long long n,
                                     int vec) {
  constexpr int V = 16 / sizeof(T);
  const float sx = *sx_ptr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long groups = vec ? n / 16 : 0;
  for (long long g = first; g < groups; g += stride) {
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; i += V) load_vec(x + g * 16 + i, v + i);
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (uint32_t)(uint8_t)quant1(v[4 * j], sx) |
             (uint32_t)(uint8_t)quant1(v[4 * j + 1], sx) << 8 |
             (uint32_t)(uint8_t)quant1(v[4 * j + 2], sx) << 16 |
             (uint32_t)(uint8_t)quant1(v[4 * j + 3], sx) << 24;
    *reinterpret_cast<uint4*>(q + g * 16) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (long long i = groups * 16 + first; i < n; i += stride)
    q[i] = quant1(to_f(x[i]), sx);
}

// (B, C, HW) -> (B, HW, C) through a tile of QC channels x QP positions,
// QC * QP = 16384 elements: 128 x 128, or 64 x 256 where C <= 64.
constexpr int kQuantTile = 16384, kQuantThreads = 256;

// The word column of the shared tile [QP][QC / 4] that holds channel word
// cw of position p: 16-byte chunks XOR-swizzled by the position's vector
// (at QC 64, a row is 64 bytes and two vectors share a chunk pattern).
template <typename T, int QC>
__device__ __forceinline__ int qswz(int p, int cw) {
  return cw ^ (((p / (16 / (int)sizeof(T))) & (QC / 16 - 1)) << 2);
}

template <typename T, int QC>
__global__ void __launch_bounds__(kQuantThreads)
quantize_nhwc_kernel(const T* __restrict__ x, const float* __restrict__ sx_ptr,
                     int8_t* __restrict__ q, int C, int HW, int vec_in,
                     int vec_out) {
  constexpr int QP = kQuantTile / QC;
  constexpr int V = 16 / sizeof(T);  // positions a 16-byte load
  constexpr int JW = QP / V / 8;     // warps a row of channel groups spans
  constexpr int CH = QC / 16;        // 16-byte chunks a position
  __shared__ __align__(16) uint32_t tile[QP][QC / 4];
  const float sx = *sx_ptr;
  const int b = blockIdx.z;
  const int ptiles = (HW + QP - 1) / QP;
  const int p0 = (blockIdx.x % ptiles) * QP, c0 = (blockIdx.x / ptiles) * QC;
  const T* xb = x + (long long)b * C * HW;
  int8_t* qb = q + (long long)b * HW * C;
  const int lane = threadIdx.x % 32;

  // (channel group cg of 4 channels, vector j of V positions): a warp takes
  // 8 vectors x 4 groups, so each of its loads reads 4 rows x 128 bytes
  for (int t = threadIdx.x; t < (QC / 4) * (QP / V); t += kQuantThreads) {
    const int wi = t / 32;
    const int j = lane % 8 + 8 * (wi % JW);
    const int cg = (wi / JW) * 4 + lane / 8;
    const int p = p0 + j * V;
    float v[4][V];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = c0 + 4 * cg + r;
      const T* row = xb + (long long)c * HW + p;
      if (c < C && vec_in && p < HW) {
        load_vec(row, v[r]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          v[r][i] = (c < C && p + i < HW) ? to_f(row[i]) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int pl = j * V + i;
      tile[pl][qswz<T, QC>(pl, cg)] =
          (uint32_t)(uint8_t)quant1(v[0][i], sx) |
          (uint32_t)(uint8_t)quant1(v[1][i], sx) << 8 |
          (uint32_t)(uint8_t)quant1(v[2][i], sx) << 16 |
          (uint32_t)(uint8_t)quant1(v[3][i], sx) << 24;
    }
  }
  __syncthreads();
  // (position pl, 16-byte chunk ch of 16 channels): CH lanes a position
  for (int t = threadIdx.x; t < QP * CH; t += kQuantThreads) {
    const int pl = t / CH, ch = t % CH;
    const int p = p0 + pl, c = c0 + 16 * ch;
    if (p >= HW || c >= C) continue;
    const uint4 w =
        *reinterpret_cast<const uint4*>(&tile[pl][qswz<T, QC>(pl, 4 * ch)]);
    int8_t* dst = qb + (long long)p * C + c;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = w;
    } else {
      const int8_t* bytes = reinterpret_cast<const int8_t*>(&w);
      for (int k = 0; k < 16 && c + k < C; ++k) dst[k] = bytes[k];
    }
  }
}

// ----------------------------------------------------------------- conv
constexpr int BM = 128, BN = 64, BK = 32, kStages = 3;
constexpr int kRow = 48;  // bytes between rows of a tile in shared memory
constexpr int kConvThreads = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = fill ? 16 : 0;  // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct ConvShape {
  int B, H, W, Cin, N, kh, kw, pad, K, Kp;
};

// VEC: Cin % 16 == 0, so each 16-byte chunk of A lies inside one tap.
template <bool VEC, typename OutT>
__global__ void __launch_bounds__(kConvThreads)
conv_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ alpha_ptr,
               const float* __restrict__ scale,
               const float* __restrict__ bias, OutT* __restrict__ out,
               ConvShape s) {
  __shared__ __align__(16) int8_t As[kStages][BM * kRow];
  __shared__ __align__(16) int8_t Bs[kStages][BN * kRow];

  const int tid = threadIdx.x;
  const int HW = s.H * s.W;
  const long long M = (long long)s.B * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // this thread's A row (one pixel) and B row/chunk
  const long long am = m0 + tid;
  const bool a_ok = am < M;
  int ab = 0, ah = 0, aw = 0;
  if (a_ok) {
    ab = (int)(am / HW);
    const int hw = (int)(am - (long long)ab * HW);
    ah = hw / s.W;
    aw = hw - ah * s.W;
  }
  const int brow = tid >> 1, bj = tid & 1;
  const bool b_ok = n0 + brow < s.N;
  const int8_t* wrow = w + (long long)(b_ok ? n0 + brow : 0) * s.Kp + bj * 16;

  auto load_tile = [&](int stage, int kt) {
    int8_t* arow = &As[stage][tid * kRow];
    if (VEC) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k0 = kt * BK + j * 16;
        bool ok = a_ok && k0 < s.K;
        const int8_t* src = x;
        if (ok) {
          const int tap = k0 / s.Cin, c0 = k0 - tap * s.Cin;
          const int dy = tap / s.kw, dx = tap - dy * s.kw;
          const int hh = ah + dy - s.pad, ww = aw + dx - s.pad;
          ok = hh >= 0 && hh < s.H && ww >= 0 && ww < s.W;
          if (ok)
            src = x + (((long long)ab * s.H + hh) * s.W + ww) * s.Cin + c0;
        }
        cp_async16(arow + j * 16, src, ok);
      }
    } else {
      unsigned words[8];
#pragma unroll
      for (int e4 = 0; e4 < 8; ++e4) {
        unsigned word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kt * BK + e4 * 4 + e;
          int v = 0;
          if (a_ok && k < s.K) {
            const int tap = k / s.Cin, c = k - tap * s.Cin;
            const int dy = tap / s.kw, dx = tap - dy * s.kw;
            const int hh = ah + dy - s.pad, ww = aw + dx - s.pad;
            if (hh >= 0 && hh < s.H && ww >= 0 && ww < s.W)
              v = x[(((long long)ab * s.H + hh) * s.W + ww) * s.Cin + c];
          }
          word |= (unsigned)(v & 0xff) << (8 * e);
        }
        words[e4] = word;
      }
      uint4* dst = reinterpret_cast<uint4*>(arow);
      dst[0] = make_uint4(words[0], words[1], words[2], words[3]);
      dst[1] = make_uint4(words[4], words[5], words[6], words[7]);
    }
    cp_async16(&Bs[stage][brow * kRow + bj * 16], wrow + kt * BK, b_ok);
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int KT = s.Kp / BK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_tile(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    const int nk = kt + kStages - 1;
    if (nk < KT) load_tile(nk % kStages, nk);
    cp_async_commit();

    const int8_t* At = As[kt % kStages];
    const int8_t* Bt = Bs[kt % kStages];
    unsigned bf[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* p = Bt + (wn + ni * 8 + g) * kRow + t * 4;
      bf[ni][0] = *reinterpret_cast<const unsigned*>(p);
      bf[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int8_t* p = At + (wm + mi * 16 + g) * kRow + t * 4;
      unsigned af[4];
      af[0] = *reinterpret_cast<const unsigned*>(p);
      af[1] = *reinterpret_cast<const unsigned*>(p + 8 * kRow);
      af[2] = *reinterpret_cast<const unsigned*>(p + 16);
      af[3] = *reinterpret_cast<const unsigned*>(p + 8 * kRow + 16);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af, bf[ni]);
    }
  }
  cp_async_wait<0>();

  const float alpha = *alpha_ptr;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm + mi * 16 + g + half * 8;
      if (m >= M) continue;
      const int b = (int)(m / HW);
      const int hw = (int)(m - (long long)b * HW);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + ni * 8 + t * 2 + e;
          if (n >= s.N) continue;
          float v = __fmul_rn(__fmul_rn((float)acc[mi][ni][half * 2 + e],
                                        alpha),
                              scale[n]);
          if (bias != nullptr) v = __fadd_rn(v, bias[n]);
          store_out(out + ((long long)b * s.N + n) * HW + hw, v);
        }
      }
    }
  }
}

// ------------------------------------------------------- conv on wgmma
constexpr int WG_THREADS = 288;        // warpgroups 0, 1 consume; warp 8 produces
constexpr int WG_M = 128;              // pixels a tile: w0 .. w0 + 127 of a row
constexpr int WG_RING = 192 * 1024;    // bytes of the stage ring at most
constexpr int WG_MAX_STAGES = 8;

struct WgShape {
  int B, H, W, Cin, N, kw, pad, taps, wtiles, ntiles, vec_out;
};

// bytes of one stage; stages in the ring; bytes of the ring, which the
// staging tile of the output reuses; bytes of the block
__host__ __device__ constexpr int wg_stage_bytes(int tn, int bk) {
  return (WG_M + tn) * bk;
}
__host__ __device__ constexpr int wg_stages(int tn, int bk) {
  return WG_RING / wg_stage_bytes(tn, bk) < WG_MAX_STAGES
             ? WG_RING / wg_stage_bytes(tn, bk)
             : WG_MAX_STAGES;
}
__host__ __device__ constexpr int wg_ring_bytes(int tn, int bk,
                                                int out_size) {
  return wg_stages(tn, bk) * wg_stage_bytes(tn, bk) > tn * WG_M * out_size
             ? wg_stages(tn, bk) * wg_stage_bytes(tn, bk)
             : tn * WG_M * out_size;
}
__host__ __device__ constexpr size_t wg_smem_bytes(int tn, int bk,
                                                   int out_size) {
  return 1024 + (size_t)wg_ring_bytes(tn, bk, out_size) +
         2 * sizeof(float) * tn + 2 * sizeof(uint64_t) * WG_MAX_STAGES;
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

// TMA: the box at (c0, c1) of a 2-D map, or (c0, c1, c2, c3) of a 4-D one,
// into shared memory at dst, completing its bytes on `bar`. Coordinates
// outside the tensor (negative ones too) read as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a K-major tile of bk-byte rows with bk-byte swizzle
// (bk 128: layout 1; bk 64: layout 2): leading offset 16 bytes (unused for
// these layouts), 8 * bk bytes between groups of 8 rows
__device__ __forceinline__ uint64_t smem_desc(const void* p, int bk) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)((8 * bk) >> 4) << 32) |
         ((uint64_t)(bk == 128 ? 1 : 2) << 62);
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x N, s32, in the warpgroup's registers: N / 2 a thread) += A (64 x
// 32) . B^T (N x 32), both s8 in shared memory, K-major
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
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
      "%128, %129, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Element (n, m) of the staging tile [tn][WG_M] of the output: the 16-byte
// chunks of row n XOR-swizzled by n, so that the 32 lanes storing one
// accumulator register (4 rows n, 8 pixels m) and the 8 lanes loading 8
// chunks of one row both hit distinct banks.
template <typename OutT>
__device__ __forceinline__ int stage_pos(int n, int m) {
  constexpr int E = 16 / sizeof(OutT);  // elements a chunk
  const int f = sizeof(OutT) == 2 ? (n >> 1) & 7 : ((n >> 1) & 3) << 1;
  return n * WG_M + ((m / E) ^ f) * E + m % E;
}

template <int TN, int BK, typename OutT>
__global__ void __launch_bounds__(WG_THREADS, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ alpha_ptr,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, OutT* __restrict__ out,
                  WgShape s) {
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries (the descriptors' base
  // offset is 0)
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int stage_bytes = wg_stage_bytes(TN, BK);
  constexpr int stages = wg_stages(TN, BK);
  float* sc = reinterpret_cast<float*>(
      ring + wg_ring_bytes(TN, BK, sizeof(OutT)));
  float* bi = sc + TN;
  uint64_t* full = reinterpret_cast<uint64_t*>(bi + TN);
  uint64_t* empty = full + WG_MAX_STAGES;

  // the tile: N fastest, so the blocks that share an A tile run together
  const int nt = blockIdx.x % s.ntiles;
  int mt = blockIdx.x / s.ntiles;
  const int wt = mt % s.wtiles;
  mt /= s.wtiles;
  const int h = mt % s.H, b = mt / s.H;
  const int w0 = wt * WG_M, n0 = nt * TN;
  const int kchunks = s.Cin / BK;
  const int kt = s.taps * kchunks;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < TN; i += WG_THREADS) {
    const int n = n0 + i;
    sc[i] = n < s.N ? scale[n] : 0.f;
    bi[i] = bias != nullptr && n < s.N ? bias[n] : 0.f;
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;  // 0, 1: consumers; 2: the producer warp
  if (wg == 2) {
    if (threadIdx.x == 256) {
      int st = 0;
      uint32_t phase = 0;
      for (int it = 0; it < kt; ++it) {
        const int tap = it / kchunks, c0 = (it - tap * kchunks) * BK;
        const int dy = tap / s.kw, dx = tap - dy * s.kw;
        // the first pass over the ring waits on the phase before init,
        // which counts as complete
        mbar_wait(&empty[st], phase ^ 1);
        mbar_expect_tx(&full[st], stage_bytes);
        unsigned char* a = ring + (size_t)st * stage_bytes;
        tma_load_4d(a, &xmap, &full[st], c0, w0 + dx - s.pad,
                    h + dy - s.pad, b);
        tma_load_2d(a + WG_M * BK, &wmap, &full[st], tap * s.Cin + c0, n0);
        if (++st == stages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // this thread's accumulator layout (m64nNk32): acc[4c + 2h + e] is pixel
  // 16 * warp + lane / 4 + 8 * h of the warpgroup's 64, channel 8 * c + 2 *
  // (lane % 4) + e of the tile's TN
  int acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0;
  int st = 0, prev = 0;
  uint32_t phase = 0;
  for (int it = 0; it < kt; ++it) {
    mbar_wait(&full[st], phase);
    __syncwarp();  // wgmma wants the warp converged
    unsigned char* a = ring + (size_t)st * stage_bytes;
    const uint64_t da = smem_desc(a + wg * 64 * BK, BK);
    const uint64_t db = smem_desc(a + WG_M * BK, BK);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int k = 0; k < BK / 32; ++k)  // 32 bytes of depth each
      wgmma_s8(acc, da + 2 * k, db + 2 * k);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_acc(acc);
    // one stage's group stays in flight; the one before goes back
    if (it > 0) {
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = st;
    if (++st == stages) {
      st = 0;
      phase ^= 1;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);
  // both consumers are done reading the ring, which becomes the staging
  // tile (every TMA into it has completed: each was waited on)
  asm volatile("bar.sync 1, 256;" ::: "memory");

  const float alpha = *alpha_ptr;
  const bool has_bias = bias != nullptr;
  OutT* staged = reinterpret_cast<OutT*>(ring);
#pragma unroll
  for (int c = 0; c < TN / 8; ++c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int nl = 8 * c + 2 * (lane % 4) + e;
        const int ml = wg * 64 + warp * 16 + lane / 4 + 8 * hh;
        float v = __fmul_rn(__fmul_rn((float)acc[4 * c + 2 * hh + e], alpha),
                            sc[nl]);
        if (has_bias) v = __fadd_rn(v, bi[nl]);
        staged[stage_pos<OutT>(nl, ml)] = from_f<OutT>(v);
      }
  asm volatile("bar.sync 1, 256;" ::: "memory");

  // 16-byte chunks of each channel's run of W, consecutive threads along W
  constexpr int E = 16 / sizeof(OutT), CPR = WG_M / E;
  const long long HW = (long long)s.H * s.W;
  for (int t = threadIdx.x; t < TN * CPR; t += 256) {
    const int nl = t / CPR, j = t % CPR;
    const int n = n0 + nl, w = w0 + j * E;
    if (n >= s.N || w >= s.W) continue;
    const OutT* src = staged + stage_pos<OutT>(nl, j * E);
    OutT* dst = out + ((long long)b * s.N + n) * HW + (long long)h * s.W + w;
    if (s.vec_out && w + E <= s.W) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < E && w + i < s.W; ++i) dst[i] = src[i];
    }
  }
}

constexpr size_t WG_SMEM_MAX = 1024 + WG_RING + 2 * sizeof(float) * 256 +
                               2 * sizeof(uint64_t) * WG_MAX_STAGES;

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

// The s8 activation (B, H, W, Cin) in boxes {bk, WG_M, 1, 1} and the packed
// weight (N, Kp) in boxes {bk, tn}, both with a bk-byte swizzle; reads
// outside either tensor give zeros.
bool make_maps(CUtensorMap* xmap, CUtensorMap* wmap, const int8_t* x,
               const int8_t* w, const ConvShape& c, int bk, int tn) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const CUtensorMapSwizzle sw =
      bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const cuuint64_t xdims[4] = {(cuuint64_t)c.Cin, (cuuint64_t)c.W,
                               (cuuint64_t)c.H, (cuuint64_t)c.B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)c.Cin,
                                  (cuuint64_t)c.W * c.Cin,
                                  (cuuint64_t)c.H * c.W * c.Cin};
  const cuuint32_t xbox[4] = {(cuuint32_t)bk, WG_M, 1, 1};
  if (encode(xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(x),
             xdims, xstrides, xbox, step, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  const cuuint64_t wdims[2] = {(cuuint64_t)c.Kp, (cuuint64_t)c.N};
  const cuuint64_t wstrides[1] = {(cuuint64_t)c.Kp};
  const cuuint32_t wbox[2] = {(cuuint32_t)bk, (cuuint32_t)tn};
  return encode(wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<int8_t*>(w), wdims, wstrides, wbox, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TN, int BK, typename OutT>
int launch_wgmma(const int8_t* x, const int8_t* w, const float* alpha,
                 const float* scale, const float* bias, void* out,
                 const ConvShape& c, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  if (!make_maps(&xmap, &wmap, x, w, c, BK, TN)) return -1;
  const int wtiles = (c.W + WG_M - 1) / WG_M, ntiles = (c.N + TN - 1) / TN;
  const int vec_out = (c.W * (int)sizeof(OutT)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const WgShape s{c.B,   c.H,         c.W,    c.Cin,  c.N,    c.kw,
                  c.pad, c.kh * c.kw, wtiles, ntiles, vec_out};
  const long long blocks = (long long)c.B * c.H * wtiles * ntiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_wgmma_kernel<TN, BK, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WG_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  conv_wgmma_kernel<TN, BK, OutT>
      <<<(unsigned)blocks, WG_THREADS,
         wg_smem_bytes(TN, BK, sizeof(OutT)), stream>>>(
          xmap, wmap, alpha, scale, bias, (OutT*)out, s);
  return (int)cudaGetLastError();
}

template <int BK, typename OutT>
int launch_wgmma_tn(const int8_t* x, const int8_t* w, const float* alpha,
                    const float* scale, const float* bias, void* out,
                    const ConvShape& c, cudaStream_t stream) {
  if (c.N <= 64)
    return launch_wgmma<64, BK, OutT>(x, w, alpha, scale, bias, out, c,
                                      stream);
  if (c.N <= 128)
    return launch_wgmma<128, BK, OutT>(x, w, alpha, scale, bias, out, c,
                                       stream);
  return launch_wgmma<256, BK, OutT>(x, w, alpha, scale, bias, out, c,
                                     stream);
}

// BK 128 bytes (128-byte swizzle) where Cin allows it, else 64
template <typename OutT>
int launch_wgmma_bk(const int8_t* x, const int8_t* w, const float* alpha,
                    const float* scale, const float* bias, void* out,
                    const ConvShape& c, cudaStream_t stream) {
  if (c.Cin % 128 == 0)
    return launch_wgmma_tn<128, OutT>(x, w, alpha, scale, bias, out, c,
                                      stream);
  return launch_wgmma_tn<64, OutT>(x, w, alpha, scale, bias, out, c, stream);
}

template <bool VEC, typename OutT>
int launch_conv(const int8_t* x, const int8_t* w, const float* alpha,
                const float* scale, const float* bias, void* out,
                const ConvShape& s, cudaStream_t stream) {
  const long long M = (long long)s.B * s.H * s.W;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (s.N + BN - 1) / BN);
  conv_s8_kernel<VEC, OutT><<<grid, kConvThreads, 0, stream>>>(
      x, w, alpha, scale, bias, (OutT*)out, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_quantize(const T* x, const float* sx, int8_t* q, int B, int C,
                    int HW, cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (C == 1 || HW == 1) {
    const long long n = (long long)B * C * HW;
    const int threads = 256;
    const long long want = (n / 16 + threads) / threads;
    const int blocks = (int)(want < 65536 ? want : 65536);
    quantize_flat_kernel<T><<<blocks, threads, 0, stream>>>(x, sx, q, n,
                                                            aligned);
  } else {
    const int vec_in = aligned && HW % (16 / (int)sizeof(T)) == 0;
    const int vec_out = aligned && C % 16 == 0;
    if (C <= 64) {
      const dim3 grid((HW + kQuantTile / 64 - 1) / (kQuantTile / 64), 1, B);
      quantize_nhwc_kernel<T, 64><<<grid, kQuantThreads, 0, stream>>>(
          x, sx, q, C, HW, vec_in, vec_out);
    } else {
      const dim3 grid((unsigned)((C + 127) / 128) *
                          ((HW + kQuantTile / 128 - 1) / (kQuantTile / 128)),
                      1, B);
      quantize_nhwc_kernel<T, 128><<<grid, kQuantThreads, 0, stream>>>(
          x, sx, q, C, HW, vec_in, vec_out);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, C, HW) contiguous, f32 (is_bf16 = 0) or bf16 (1); q: (B, HW, C)
// s8; sx: one f32 on the device. Returns cudaGetLastError() after the
// launch.
extern "C" int hctr_int8_quantize(const void* x, const float* sx, int8_t* q,
                                  int B, int C, int HW, int is_bf16,
                                  cudaStream_t stream) {
  if (is_bf16)
    return launch_quantize((const __nv_bfloat16*)x, sx, q, B, C, HW, stream);
  return launch_quantize((const float*)x, sx, q, B, C, HW, stream);
}

// x: (B, H, W, Cin) s8; w: (N, Kp) s8, K = kh * kw * Cin ordered (dy, dx,
// c) and zero past K; alpha: one f32 on the device; scale, bias: (N,) f32
// (bias may be null); out: (B, N, H, W) f32 (out_bf16 = 0) or bf16 (1).
// Kp must be a multiple of 32 and x, w 16-byte aligned (the wrapper
// checks). route 1 runs the wgmma kernel, which takes Cin a multiple of 64
// and (kh, kw, pad) of (3, 3, 1) or (1, 1, 0) (else -2); route 0 the
// mma.sync kernel, which takes every shape. Returns -1 when the TMA
// descriptors cannot be made, else cudaGetLastError() after the launch.
extern "C" int hctr_int8_conv(const int8_t* x, const int8_t* w,
                              const float* alpha, const float* scale,
                              const float* bias, void* out, int B, int H,
                              int W, int Cin, int N, int kh, int kw, int pad,
                              int Kp, int out_bf16, int route,
                              cudaStream_t stream) {
  const ConvShape s{B, H, W, Cin, N, kh, kw, pad, kh * kw * Cin, Kp};
  if (route == 1) {
    if (Cin <= 0 || Cin % 64 || kh != kw || (kh != 3 && kh != 1) ||
        pad != kh / 2 || Kp != s.K)
      return -2;
    return out_bf16 ? launch_wgmma_bk<__nv_bfloat16>(x, w, alpha, scale,
                                                     bias, out, s, stream)
                    : launch_wgmma_bk<float>(x, w, alpha, scale, bias, out, s,
                                             stream);
  }
  const bool vec = Cin % 16 == 0;
  if (out_bf16)
    return vec ? launch_conv<true, __nv_bfloat16>(x, w, alpha, scale, bias,
                                                  out, s, stream)
               : launch_conv<false, __nv_bfloat16>(x, w, alpha, scale, bias,
                                                   out, s, stream);
  return vec ? launch_conv<true, float>(x, w, alpha, scale, bias, out, s,
                                        stream)
             : launch_conv<false, float>(x, w, alpha, scale, bias, out, s,
                                         stream);
}
