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
//     scale = s_w. Either order is then the plain version's, exactly.
//
// Bound on this card: at the served shapes the conv is operations-bound:
// 2 * B*H*W * Cout * Cin*9 int8 operations (the block convs of full hctr at
// b4 w1600: 2 * 4*16*1600 * 256 * 2304 = 60 GOP, 30 us at 1979 TOPS) against
// the s8 activation in, the s8 weights and the compute-dtype output (about
// 13 MB, 4 us at 3.35 TB/s). So the product runs on the tensor cores.
//
// Design (a simple kernel that is right; wgmma and TMA are later work):
//   - GEMM view: M = B*H*W output pixels, N = Cout, K = kh*kw*Cin ordered
//     (dy, dx, c), the weight's (N, kh, kw, Cin) layout, padded with zeros
//     to Kp, a multiple of 32, by the wrapper.
//   - A block of 4 warps computes a 128 x 64 tile of (M, N); each warp a
//     64 x 32 tile with mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
//     (16 mma a 32-deep step). The s32 accumulator is exact: |acc| <=
//     127 * 127 * Kp, 7.4e7 at Cin 512 x 9.
//   - K is tiled by 32 through shared memory in a 3-stage cp.async ring.
//     The A tile is the implicit im2col of 128 pixels: where Cin is a
//     multiple of 16 each 16-byte chunk of a 32-deep slice lies inside one
//     (dy, dx) tap, so it is one 16-byte cp.async, zero-filled outside the
//     image and past K; else (Cin 1 and 8: conv0_1 and hctr-tiny's stem)
//     each byte is gathered on its own. Rows are 48 bytes apart in shared
//     memory, so the fragment loads of a warp hit 32 distinct banks.
//   - The epilogue writes each fragment element where it belongs in NCHW;
//     it is not staged for coalescing.

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

// Elementwise: the layouts agree where C == 1 or HW == 1.
template <typename T>
__global__ void quantize_flat_kernel(const T* __restrict__ x,
                                     const float* __restrict__ sx_ptr,
                                     int8_t* __restrict__ q, long long n) {
  const float sx = *sx_ptr;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    q[i] = quant1(to_f(x[i]), sx);
}

// (B, C, HW) -> (B, HW, C) through a 32 x 32 tile in shared memory: reads
// run along hw, writes along c.
constexpr int kTile = 32;
template <typename T>
__global__ void __launch_bounds__(kTile * 8)
quantize_nhwc_kernel(const T* __restrict__ x, const float* __restrict__ sx_ptr,
                     int8_t* __restrict__ q, int C, int HW) {
  __shared__ int8_t tile[kTile][kTile + 4];
  const float sx = *sx_ptr;
  const int b = blockIdx.z;
  const int hw0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const T* xb = x + (long long)b * C * HW;
  int8_t* qb = q + (long long)b * HW * C;
  for (int i = threadIdx.y; i < kTile; i += 8) {
    const int c = c0 + i, hw = hw0 + threadIdx.x;
    if (c < C && hw < HW)
      tile[i][threadIdx.x] = quant1(to_f(xb[(long long)c * HW + hw]), sx);
  }
  __syncthreads();
  for (int i = threadIdx.y; i < kTile; i += 8) {
    const int hw = hw0 + i, c = c0 + threadIdx.x;
    if (c < C && hw < HW) qb[(long long)hw * C + c] = tile[threadIdx.x][i];
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

}  // namespace

// x: (B, C, HW) contiguous, f32 (is_bf16 = 0) or bf16 (1); q: (B, HW, C)
// s8; sx: one f32 on the device. Returns cudaGetLastError() after the
// launch.
extern "C" int hctr_int8_quantize(const void* x, const float* sx, int8_t* q,
                                  int B, int C, int HW, int is_bf16,
                                  cudaStream_t stream) {
  if (C == 1 || HW == 1) {
    const long long n = (long long)B * C * HW;
    const int threads = 256;
    const long long want = (n + threads - 1) / threads;
    const int blocks = (int)(want < 65536 ? want : 65536);
    if (is_bf16)
      quantize_flat_kernel<__nv_bfloat16><<<blocks, threads, 0, stream>>>(
          (const __nv_bfloat16*)x, sx, q, n);
    else
      quantize_flat_kernel<float><<<blocks, threads, 0, stream>>>(
          (const float*)x, sx, q, n);
  } else {
    const dim3 grid((HW + kTile - 1) / kTile, (C + kTile - 1) / kTile, B);
    const dim3 block(kTile, 8);
    if (is_bf16)
      quantize_nhwc_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(
          (const __nv_bfloat16*)x, sx, q, C, HW);
    else
      quantize_nhwc_kernel<float><<<grid, block, 0, stream>>>(
          (const float*)x, sx, q, C, HW);
  }
  return (int)cudaGetLastError();
}

// x: (B, H, W, Cin) s8; w: (N, Kp) s8, K = kh * kw * Cin ordered (dy, dx,
// c) and zero past K; alpha: one f32 on the device; scale, bias: (N,) f32
// (bias may be null); out: (B, N, H, W) f32 (out_bf16 = 0) or bf16 (1).
// Kp must be a multiple of 32 and w 16-byte aligned (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int hctr_int8_conv(const int8_t* x, const int8_t* w,
                              const float* alpha, const float* scale,
                              const float* bias, void* out, int B, int H,
                              int W, int Cin, int N, int kh, int kw, int pad,
                              int Kp, int out_bf16, cudaStream_t stream) {
  const ConvShape s{B, H, W, Cin, N, kh, kw, pad, kh * kw * Cin, Kp};
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
