"""Peek attention against the per-beam KV cache (kernel K2).

The LM-fused beam search scores candidate continuations with a grouped
teacher-forced peek (``decode/beam_lm_device._grouped_peek``): per beam, R
candidate rows of S tokens attend the beam's cached prefix plus their own
causal row. The cache part is the heavy one; it yields unnormalised
flash-attention partials, which ``merge_partials`` combines with the small
own-row part.

On a CUDA tensor ``peek_cache_attention`` launches
``csrc/peek_attention.cu``, which replaces the JAX package's Pallas kernel
(``handwritten_chinese_ocr_samples_tpu/ops/peek_attention.py:70``): bf16
caches with a head size of 64 on the tensor cores, the rest on the SIMT
units, both reading the cache in 64-key tiles, so any cache depth L
launches. On a CPU tensor it runs ``peek_cache_attention_plain``, the JAX
package's XLA oracle written in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from .launch_tally import counted

NEG = -1e30

# Launches of the CUDA kernel in this process (the plain version adds none;
# a launch into a CUDA graph being captured counts at each replay).
launches = 0

_MAX_DH = 128    # csrc/peek_attention.cu S_MAX_DH


def _kernel():
    from . import _build
    fn = _build.load("peek_attention").hctr_peek_cache_attention
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 7 + [ctypes.c_int] * 6 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def peek_cache_attention_plain(q, k_cache, v_cache, lengths):
    """Plain PyTorch version (materialises the scores): ``q (B, N, H, Dh)``
    pre-scaled queries, ``k/v_cache (B, L, H, Dh)``, ``lengths (B,)`` ->
    ``(o (B, N, H, Dh) f32 unnormalised, m (B, N, H) f32, l (B, N, H) f32)``.
    The weights are rounded to the cache dtype before the product with v,
    the sums are f32."""
    L = k_cache.shape[1]
    s = torch.einsum("bnhk,blhk->bnhl", q.float(), k_cache.float())
    valid = (torch.arange(L, device=q.device)[None, None, None, :]
             < lengths[:, None, None, None])
    s = torch.where(valid, s, NEG)
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bnhl,blhk->bnhk", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o, m, p.sum(-1)


def peek_cache_attention(q, k_cache, v_cache, lengths):
    """Flash partials of ``q`` against the masked cache, as in
    ``peek_cache_attention_plain``. A CUDA tensor goes through the kernel
    (or raises), a CPU tensor through the plain version."""
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"expected q (B, N, H, Dh) and caches (B, L, H, Dh),"
                         f" got {tuple(q.shape)} / {tuple(k_cache.shape)}")
    B, N, H, Dh = q.shape
    L = k_cache.shape[1]
    if (k_cache.shape[0], k_cache.shape[2:]) != (B, (H, Dh)) \
            or lengths.shape != (B,):
        raise ValueError("q, caches and lengths disagree on B, H or Dh")
    if q.device.type == "cpu":
        return peek_cache_attention_plain(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != q.dtype for t in (k_cache, v_cache)):
        raise TypeError("q and caches must all be bfloat16 or all float32")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lengths)):
        raise ValueError("all operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("q and caches must be 16-byte aligned")
    if Dh > _MAX_DH:
        raise ValueError(f"head size {Dh} above {_MAX_DH}")
    dev = q.device
    o = torch.empty((B, N, H, Dh), dtype=torch.float32, device=dev)
    m = torch.empty((B, N, H), dtype=torch.float32, device=dev)
    lsum = torch.empty((B, N, H), dtype=torch.float32, device=dev)
    if o.numel() == 0:
        return o, m, lsum
    kernel = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    lengths.data_ptr(), o.data_ptr(), m.data_ptr(),
                    lsum.data_ptr(), B, N, L, H, Dh,
                    int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"peek_cache_attention kernel launch failed: "
                           f"cudaError {rc}")
    global launches
    if counted(__name__):
        launches += 1
    return o, m, lsum


def merge_partials(o1, m1, l1, o2, m2, l2):
    """Flash combine of two unnormalised partials into the normalised
    attention output ``(..., Dh)`` f32. A partial with ``l == 0`` (fully
    masked, ``m == NEG``) contributes nothing."""
    m = torch.maximum(m1, m2)
    a1 = torch.where(l1 > 0, torch.exp(m1 - m), 0.0)
    a2 = torch.where(l2 > 0, torch.exp(m2 - m), 0.0)
    denom = l1 * a1 + l2 * a2
    out = o1 * a1[..., None] + o2 * a2[..., None]
    return out / torch.clamp(denom, min=1e-30)[..., None]


def combine_partials(o1, m1, l1, o2, m2, l2):
    """Unnormalised flash combine: one partial equivalent to having attended
    both sources, chainable before a final ``merge_partials``."""
    m = torch.maximum(m1, m2)
    a1 = torch.where(l1 > 0, torch.exp(m1 - m), 0.0)
    a2 = torch.where(l2 > 0, torch.exp(m2 - m), 0.0)
    return (o1 * a1[..., None] + o2 * a2[..., None], m, l1 * a1 + l2 * a2)
