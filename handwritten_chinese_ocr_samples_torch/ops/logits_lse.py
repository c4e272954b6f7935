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

from .launch_tally import counted

# Launches of the CUDA kernel in this process (the plain version adds none;
# a launch into a CUDA graph being captured counts at each replay).
launches = 0

# csrc/lse_rows.cu: the tensor-core path (bf16) takes 128 rows x 256
# vocabulary entries a tile, one block per SM; the SIMT path 64 x 64, about
# 4 blocks per SM
_TC_ROWS = 128
_TC_V = 256
_TC_MAX_D = 512
_SIMT_TILE = 64
_SIMT_BLOCKS_PER_SM = 4


def _kernels():
    from . import _build
    lib = _build.load("lse_rows")
    ptr = ctypes.c_void_p
    simt, tc = lib.hctr_lse_rows, lib.hctr_lse_rows_tc
    simt.argtypes = [ptr] * 5 + [ctypes.c_int] * 6 + [ptr]
    tc.argtypes = [ptr] * 5 + [ctypes.c_int] * 5 + [ptr]
    simt.restype = tc.restype = ctypes.c_int
    return simt, tc


def lse_rows_plain(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``logsumexp(x @ emb.T, -1)`` in f32 (the
    products of bf16 inputs are exact in f32)."""
    return torch.logsumexp(x.float() @ emb.float().T, dim=-1)


def plan_splits(rows: int, V: int, n_sm: int, tile_rows: int, tile_v: int,
                blocks_per_sm: int):
    """``(v_per_split, n_split)``: the vocabulary cut into ranges of whole
    ``tile_v`` tiles, as many as fit ``blocks_per_sm`` blocks on each of
    ``n_sm`` SMs beside the ``rows / tile_rows`` row tiles (at least one),
    none empty. Range ``s`` is ``[s * v_per_split, min(V, (s + 1) *
    v_per_split))``."""
    n_rt = -(-rows // tile_rows)
    n_vt = -(-V // tile_v)
    want = max(1, min(n_vt, blocks_per_sm * n_sm // n_rt))
    v_per_split = -(-n_vt // want) * tile_v
    return v_per_split, -(-V // v_per_split)


def _tensor_core_path(x: torch.Tensor, emb: torch.Tensor) -> bool:
    """bf16 inputs that TMA can read: rows of a multiple of 16 bytes, 16-byte
    aligned, and an x tile that fits shared memory."""
    d = x.shape[-1]
    return (x.dtype == torch.bfloat16 and d % 8 == 0 and d <= _TC_MAX_D
            and x.data_ptr() % 16 == 0 and emb.data_ptr() % 16 == 0)


def lse_rows(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """``logsumexp(x @ emb.T, -1)`` for ``x (..., d)`` and ``emb (V, d)``,
    f32 ``(...)``. A CUDA tensor goes through the kernel (or raises): bf16
    that TMA can read on the tensor cores, the rest on the SIMT units. A
    CPU tensor goes through the plain version."""
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
    tc = _tensor_core_path(x, emb)
    if tc:
        v_per_split, n_split = plan_splits(rows, V, n_sm, _TC_ROWS, _TC_V, 1)
    else:
        v_per_split, n_split = plan_splits(rows, V, n_sm, _SIMT_TILE,
                                           _SIMT_TILE, _SIMT_BLOCKS_PER_SM)
    pm = torch.empty((rows, n_split), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    simt, tc_kernel = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (x.data_ptr(), emb.data_ptr(), pm.data_ptr(), pl.data_ptr(),
                out.data_ptr(), rows, V, d, v_per_split, n_split)
        if tc:
            rc = tc_kernel(*args, stream)
        else:
            rc = simt(*args, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("lse_rows kernel launch failed: "
                           + ("no TMA descriptor" if rc == -1
                              else f"cudaError {rc}"))
    global launches
    if counted(__name__):
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
