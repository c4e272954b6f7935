// Beam reorder + one-token write of the LM's KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `gather_write_kv` of the JAX package
// (handwritten_chinese_ocr_samples_tpu/ops/cache_gather.py:109, through
// `_impl` at :50, body `_kernel` at :36). For each layer l and new beam p:
//
//   out[l, p, t] = new[l, p]            if t == wpos[p]
//                  cache[l, idx[p], t]  otherwise        (wpos[p] >= L: no write)
//
// for k and v alike. It is out of place, as the JAX contract is: beams
// permute, so no beam can be updated where it lies.
//
// Bound on this card: memory. It moves bytes and computes nothing: each
// output row is read once (from the parent or from `new`) and written once,
// so the least time is 2 * 2 * layers * B * L * row_bytes over the HBM rate;
// at the LM search's shape (6 layers, 40 beams, L = 160, H * Dh = 512 bf16)
// that is 157 MB, about 47 us at 3.35 TB/s.
//
// Design: one block per (beam, layer, k-or-v) copies that beam's L rows of
// row_bytes with 16-byte vector loads and stores, neighbouring threads on
// neighbouring addresses; the row at wpos comes from `new` instead. The
// parent index is read by the block itself (the TPU kernel prefetched it as a
// scalar to drive its block index map) and clamped to [0, B), as JAX clamps
// an out-of-range gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_write_kernel(const uint4* __restrict__ ck, const uint4* __restrict__ cv,
                    const int* __restrict__ idx, const uint4* __restrict__ kn,
                    const uint4* __restrict__ vn, const int* __restrict__ wpos,
                    uint4* __restrict__ ok, uint4* __restrict__ ov, int B,
                    int L, int n16) {
  const int p = blockIdx.x;
  const int l = blockIdx.y;
  const bool is_v = blockIdx.z == 1;
  const uint4* cache = is_v ? cv : ck;
  const uint4* fresh = is_v ? vn : kn;
  uint4* out = is_v ? ov : ok;

  int src = idx[p];
  src = src < 0 ? 0 : (src >= B ? B - 1 : src);
  const int w = wpos[p];
  const long long per_beam = (long long)L * n16;
  const uint4* from = cache + ((long long)l * B + src) * per_beam;
  const uint4* row_new = fresh + ((long long)l * B + p) * n16;
  uint4* to = out + ((long long)l * B + p) * per_beam;
  for (long long e = threadIdx.x; e < per_beam; e += kThreads) {
    const int t = (int)(e / n16);
    const int c = (int)(e - (long long)t * n16);
    to[e] = (t == w) ? row_new[c] : from[e];
  }
}

}  // namespace

// ck, cv, ok, ov: (layers, B, L, row_bytes) contiguous; kn, vn: (layers, B,
// row_bytes); idx, wpos: (B,) int32. row_bytes must be a multiple of 16 and
// every pointer 16-byte aligned (the wrapper checks both).
// Returns cudaGetLastError() after the launch.
extern "C" int hctr_gather_write_kv(const void* ck, const void* cv,
                                    const int* idx, const void* kn,
                                    const void* vn, const int* wpos, void* ok,
                                    void* ov, int layers, int B, int L,
                                    int row_bytes, cudaStream_t stream) {
  const dim3 grid(B, layers, 2);
  gather_write_kernel<<<grid, kThreads, 0, stream>>>(
      (const uint4*)ck, (const uint4*)cv, idx, (const uint4*)kn,
      (const uint4*)vn, wpos, (uint4*)ok, (uint4*)ov, B, L, row_bytes / 16);
  return (int)cudaGetLastError();
}
