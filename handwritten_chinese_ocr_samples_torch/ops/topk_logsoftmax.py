"""Fused row-wise log-softmax + top-K over the class axis (kernel K1).

Beam search consumes only the top-``K`` candidate log-probs per frame (plus
the blank's), so the ``(B, T, D)`` log-softmax need never be written out. On
a CUDA tensor ``topk_logsoftmax`` launches the hand-written kernel
``csrc/topk_logsoftmax.cu``, which replaces the JAX package's Pallas kernel
(``handwritten_chinese_ocr_samples_tpu/ops/topk_logsoftmax.py:67``). On a
CPU tensor it runs ``topk_logsoftmax_plain``, the same function in plain
PyTorch, which the tests hold against the JAX kernel and ``chip_smoke.py``
holds against the CUDA kernel on the card.

Ordering contract (both versions): classes are ranked by their raw logit,
descending, ties to the lower class index (``jnp.argmax``'s rule).
"""

from __future__ import annotations

import ctypes
import math

import torch

PRUNE = math.log(1e-3)  # skip-search ambiguity threshold (log-prob)

# Launches of the CUDA kernel in this process (the plain version adds none).
launches = 0


def _kernel():
    """``hctr_topk_logsoftmax`` from the built library, its C signature
    declared (pointers and the stream as ``c_void_p``)."""
    from . import _build
    fn = _build.load("topk_logsoftmax").hctr_topk_logsoftmax
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    return fn


def topk_logsoftmax_plain(logits: torch.Tensor, k: int = 10,
                          prune: float = PRUNE):
    """Plain PyTorch version: ``(B, T, D)`` raw logits -> ``(vals (B,T,K)
    f32, idx (B,T,K) i32, blank (B,T) f32, n_above (B,T) i32)``.

    The rank comes from a stable descending sort of the raw logits, so ties
    go to the lower index exactly as in the kernel; ``vals`` are the
    log-softmax values at those indices."""
    x = logits.float()
    logp = torch.log_softmax(x, dim=-1)
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    vals = torch.gather(logp, -1, idx)
    n_above = (logp > prune).sum(-1, dtype=torch.int32)
    return vals, idx.to(torch.int32), logp[..., 0], n_above


def topk_logsoftmax(logits: torch.Tensor, k: int = 10, prune: float = PRUNE):
    """``(B, T, D)`` raw f32 logits -> ``(vals, idx, blank, n_above)`` as in
    ``topk_logsoftmax_plain``. A CUDA tensor goes through the kernel (or
    raises); a CPU tensor goes through the plain version."""
    if logits.dim() != 3:
        raise ValueError(f"expected (B, T, D) logits, got {tuple(logits.shape)}")
    B, T, D = logits.shape
    if not 1 <= k <= D:
        raise ValueError(f"k={k} must be in [1, D={D}]")
    if logits.device.type == "cpu":
        return topk_logsoftmax_plain(logits, k, prune)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"expected float32 logits, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    kernel = _kernel()
    dev = logits.device
    vals = torch.empty((B, T, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, T, k), dtype=torch.int32, device=dev)
    blank = torch.empty((B, T), dtype=torch.float32, device=dev)
    n_above = torch.empty((B, T), dtype=torch.int32, device=dev)
    if B * T == 0:
        return vals, idx, blank, n_above
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel(
            logits.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            blank.data_ptr(), n_above.data_ptr(), B * T, D, k, prune, stream)
    if rc != 0:
        raise RuntimeError(f"topk_logsoftmax kernel launch failed: "
                           f"cudaError {rc}")
    global launches
    launches += 1
    return vals, idx, blank, n_above
