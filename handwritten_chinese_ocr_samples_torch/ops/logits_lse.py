"""Log-sum-exp over the LM vocabulary without the logits (kernel K3).

The LM-fused beam search scores teacher-forced continuations as
``logit[target] - logsumexp(logits)`` per peek position
(``decode/beam_lm_device._grouped_peek``). Only position 0 of each peek row
needs the whole next-token distribution; the later positions need one
gathered logit (``target_logit``, a row-wise dot with ``emb[target]``) and
one log-sum-exp (``lse_rows``).

On a CUDA tensor ``lse_rows`` launches ``csrc/lse_rows.cu``, which replaces
the JAX package's Pallas kernel
(``handwritten_chinese_ocr_samples_tpu/ops/logits_lse.py:74``); on a CPU
tensor it runs ``lse_rows_plain``, which materialises the logits as the JAX
package's XLA oracle does. Leading axes fold into rows, which is what the
JAX package's ``custom_vmap`` rule (``logits_lse.py:130``) does for the
grouped search.
"""

from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernel in this process (the plain version adds none).
launches = 0

_ROWS_PER_BLOCK = 64     # csrc/lse_rows.cu TR
_VOCAB_PER_TILE = 64     # csrc/lse_rows.cu TV
_BLOCKS_PER_SM = 4       # vocabulary splits aim at this many blocks per SM


def _kernel():
    from . import _build
    fn = _build.load("lse_rows").hctr_lse_rows
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 5 + [ctypes.c_int] * 6 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def lse_rows_plain(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``logsumexp(x @ emb.T, -1)`` in f32 (the
    products of bf16 inputs are exact in f32)."""
    return torch.logsumexp(x.float() @ emb.float().T, dim=-1)


def _splits(rows: int, V: int, n_sm: int):
    """``(v_per_split, n_split)``: vocabulary ranges of whole tiles, enough
    of them to give about ``_BLOCKS_PER_SM`` blocks per SM, none empty."""
    n_rt = -(-rows // _ROWS_PER_BLOCK)
    n_vt = -(-V // _VOCAB_PER_TILE)
    want = max(1, min(n_vt, -(-_BLOCKS_PER_SM * n_sm // n_rt)))
    v_per_split = -(-n_vt // want) * _VOCAB_PER_TILE
    return v_per_split, -(-V // v_per_split)


def lse_rows(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """``logsumexp(x @ emb.T, -1)`` for ``x (..., d)`` and ``emb (V, d)``,
    f32 ``(...)``. A CUDA tensor goes through the kernel (or raises), a CPU
    tensor through the plain version."""
    if emb.dim() != 2 or x.shape[-1] != emb.shape[1]:
        raise ValueError(f"expected x (..., d) and emb (V, d), got "
                         f"{tuple(x.shape)} / {tuple(emb.shape)}")
    if x.device.type == "cpu":
        return lse_rows_plain(x, emb)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or emb.dtype != x.dtype:
        raise TypeError("x and emb must both be bfloat16 or both float32")
    if not (x.is_contiguous() and emb.is_contiguous()):
        raise ValueError("x and emb must be contiguous")
    lead = x.shape[:-1]
    V, d = emb.shape
    rows = x.numel() // d if d else 0
    dev = x.device
    out = torch.empty(lead, dtype=torch.float32, device=dev)
    if rows == 0 or V == 0:
        return out.fill_(float("-inf") if V == 0 else 0.0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    v_per_split, n_split = _splits(rows, V, n_sm)
    pm = torch.empty((rows, n_split), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    kernel = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel(x.data_ptr(), emb.data_ptr(), pm.data_ptr(),
                    pl.data_ptr(), out.data_ptr(), rows, V, d, v_per_split,
                    n_split, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"lse_rows kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out


def target_logit(x: torch.Tensor, emb: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
    """``(x @ emb.T)[..., targets]`` as a gather and a row-wise dot, f32
    ``(...)``, with no ``(rows, V)`` intermediate."""
    return (x.float() * emb[targets.long()].float()).sum(-1)


def target_lse(x: torch.Tensor, emb: torch.Tensor, targets: torch.Tensor):
    """``(logit[target], logsumexp(logits))`` per row of ``x``."""
    return target_logit(x, emb, targets), lse_rows(x, emb)
