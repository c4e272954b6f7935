"""Beam reorder + one-token write of the LM KV cache (kernel K4).

Every searched frame of the LM-fused beam search permutes the per-beam KV
cache by the survivors' parent indices and writes each extended beam's new
token at its length (``lm/cached.CachedLM.gather_write``). On a CUDA tensor
``gather_write_kv`` launches ``csrc/gather_write_kv.cu``, which replaces the
JAX package's Pallas kernel
(``handwritten_chinese_ocr_samples_tpu/ops/cache_gather.py:109``); on a CPU
tensor it runs ``gather_write_kv_plain``.

The grouped search keeps G lines of BM beams on one batch axis of G * BM
beams, so ``idx`` holds global parents (``g * BM + parent``): the JAX
package's ``custom_vmap`` fold of the lanes into the grid is this flat axis.
"""

from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernel in this process (the plain version adds none).
launches = 0


def _kernel():
    from . import _build
    fn = _build.load("gather_write_kv").hctr_gather_write_kv
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 8 + [ctypes.c_int] * 4 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def gather_write_kv_plain(cache_k, cache_v, idx, k_new, v_new, wpos):
    """Plain PyTorch version: ``out[l, p, t] = new[l, p] if t == wpos[p]
    else cache[l, idx[p], t]`` for k and v; ``wpos[p] >= L`` writes
    nothing."""
    L = cache_k.shape[2]
    hit = (torch.arange(L, device=wpos.device)[None, :]
           == wpos[:, None])[None, :, :, None, None]
    idx = idx.long()
    k = torch.where(hit, k_new.to(cache_k.dtype)[:, :, None], cache_k[:, idx])
    v = torch.where(hit, v_new.to(cache_v.dtype)[:, :, None], cache_v[:, idx])
    return k, v


def gather_write_kv(cache_k, cache_v, idx, k_new, v_new, wpos):
    """``cache_k/v (layers, B, L, H, Dh)``; ``idx/wpos (B,)`` int32;
    ``k/v_new (layers, B, H, Dh)`` indexed by the NEW beam position.
    Returns the new ``(k, v)``; lengths stay with the caller. A CUDA tensor
    goes through the kernel (or raises), a CPU tensor through the plain
    version."""
    if cache_k.dim() != 5 or cache_v.shape != cache_k.shape:
        raise ValueError(f"expected (layers, B, L, H, Dh) caches, got "
                         f"{tuple(cache_k.shape)} / {tuple(cache_v.shape)}")
    layers, B, L, H, Dh = cache_k.shape
    if (k_new.shape != (layers, B, H, Dh) or v_new.shape != k_new.shape
            or idx.shape != (B,) or wpos.shape != (B,)):
        raise ValueError("k_new/v_new must be (layers, B, H, Dh) and "
                         "idx/wpos (B,)")
    if cache_k.device.type == "cpu":
        return gather_write_kv_plain(cache_k, cache_v, idx, k_new, v_new,
                                     wpos)
    if cache_k.device.type != "cuda":
        raise ValueError(f"unsupported device {cache_k.device}")
    tensors = (cache_k, cache_v, k_new, v_new)
    if any(t.dtype != cache_k.dtype for t in tensors):
        raise TypeError("caches and new rows must share one dtype")
    if idx.dtype != torch.int32 or wpos.dtype != torch.int32:
        raise TypeError("idx and wpos must be int32")
    if not all(t.is_contiguous() for t in (*tensors, idx, wpos)):
        raise ValueError("all operands must be contiguous")
    row_bytes = H * Dh * cache_k.element_size()
    if row_bytes % 16 or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"rows of {row_bytes} bytes: the kernel moves "
                         f"16-byte vectors and needs 16-byte aligned rows")
    ok = torch.empty_like(cache_k)
    ov = torch.empty_like(cache_v)
    if ok.numel() == 0:
        return ok, ov
    kernel = _kernel()
    dev = cache_k.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel(cache_k.data_ptr(), cache_v.data_ptr(), idx.data_ptr(),
                    k_new.data_ptr(), v_new.data_ptr(), wpos.data_ptr(),
                    ok.data_ptr(), ov.data_ptr(), layers, B, L, row_bytes,
                    stream)
    if rc != 0:
        raise RuntimeError(f"gather_write_kv kernel launch failed: "
                           f"cudaError {rc}")
    global launches
    launches += 1
    return ok, ov
