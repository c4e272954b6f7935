"""int8 quantization and the s8 x s8 -> s32 convolution of the int8 serving
forward (kernel I1, ``csrc/int8_conv.cu``).

The JAX package's int8 route has no Pallas kernel: ``QuantizableConv``
(``handwritten_chinese_ocr_samples_tpu/models/hctr.py:59``) and the LM's
``_q_mm`` (``lm/cached.py:198``) leave it to XLA. PyTorch has no int8
convolution on CUDA, so on a CUDA tensor ``quantize`` and ``conv_int8``
launch I1's two entry points, and on a CPU tensor they run
``quantize_plain`` and ``conv_int8_plain``, which compute the same bits.

The scheme, as the JAX package has it:

  * ``s_x = max(amax, 1e-8) / 127`` per tensor, ``s_w = max(|w|, 1e-8) /
    127`` per out-channel; ``q = clip(round(v / s), -127, 127)``, rounding
    half to even, a true division;
  * the exact s32 product of the s8 operands, then ``((f32) acc * alpha) *
    scale[n] + bias[n]``, each step rounded, cast to the compute dtype. A
    conv site passes ``alpha = 1`` and ``scale = s_x * s_w`` (JAX's
    ``acc * (s_x * s_w)``); the LM passes ``alpha = s_x`` and ``scale =
    s_w`` (JAX's ``(acc * s_x) * s_w``).

Both entry points are PyTorch custom ops, ``hctr::int8_quantize`` and
``hctr::int8_conv`` (registered when this module is imported): the CPU
kernel of each is its plain version, the CUDA kernel launches I1 through
``ctypes``, and the fake kernel gives the output's shape, so
``torch.export`` traces an int8 forward into a program that calls I1.

Layouts: activations quantize from NCHW (or ``(M, K)`` rows) into NHWC s8;
weights are ``(N, Kp)`` s8, K ordered ``(dy, dx, c)`` and zero-padded to
``Kp``, a multiple of 32 (``pack_weight``). Scales live on the device
(``s_x`` as one f32 element), so nothing here waits for the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

# Launches of I1 in this process: the conv entry point and the quantize
# entry point (the plain versions add none).
launches = 0
quantize_launches = 0

QMAX = 127.0
_K_ALIGN = 32


def _kernels():
    from . import _build
    lib = _build.load("int8_conv")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    q = lib.hctr_int8_quantize
    q.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    q.restype = i32
    c = lib.hctr_int8_conv
    c.argtypes = [ptr] * 6 + [i32] * 10 + [ptr]
    c.restype = i32
    return q, c


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` in f32, divided by a tensor on ``amax``'s
    device: PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, which is not the same f32."""
    a = amax.float().clamp_min(1e-8)
    return a / torch.full((), QMAX, dtype=torch.float32, device=a.device)


def quantize_weight(w: torch.Tensor, dims) -> tuple:
    """``(w_q s8, s_w f32)`` of a weight, ``s_w`` over the contraction
    ``dims`` (kept, for broadcasting), from ``w`` in f32."""
    w32 = w.detach().float()
    s_w = scale_of(w32.abs().amax(dim=dims, keepdim=True))
    return torch.round(w32 / s_w).clamp(-QMAX, QMAX).to(torch.int8), s_w


def pack_weight(w_q: torch.Tensor) -> torch.Tensor:
    """``(N, K)`` s8 -> ``(N, Kp)`` s8, zero past K, Kp a multiple of 32."""
    N, K = w_q.shape
    Kp = -(-K // _K_ALIGN) * _K_ALIGN
    out = torch.zeros((N, Kp), dtype=torch.int8, device=w_q.device)
    out[:, :K] = w_q
    return out


def quantize_plain(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``quantize``: the JAX formula in f32."""
    q = torch.round(x.float() / s_x).clamp(-QMAX, QMAX).to(torch.int8)
    return q.permute(0, 2, 3, 1).contiguous() if q.dim() == 4 else q


def quantize(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / s_x), -127, 127)`` as s8: ``(B, C, H, W)`` in the
    compute dtype (f32 or bf16) -> ``(B, H, W, C)``, ``(M, K)`` ->
    ``(M, K)``. ``s_x`` is one f32 element on ``x``'s device. A CUDA tensor
    goes through I1 (or raises), a CPU tensor through the plain version,
    both as the custom op ``hctr::int8_quantize``."""
    if x.dim() not in (2, 4):
        raise ValueError(f"expected (B, C, H, W) or (M, K), got "
                         f"{tuple(x.shape)}")
    if s_x.numel() != 1 or s_x.dtype != torch.float32:
        raise TypeError("s_x must be one f32 element")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    return torch.ops.hctr.int8_quantize(x, s_x)


@torch.library.custom_op("hctr::int8_quantize", mutates_args=(),
                         device_types="cpu")
def _quantize_op(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    return quantize_plain(x, s_x)


@_quantize_op.register_kernel("cuda")
def _quantize_cuda(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    if s_x.device != x.device:
        raise ValueError(f"unsupported devices {x.device} / {s_x.device}")
    x = x.contiguous()
    if x.dim() == 4:
        B, C, H, W = x.shape
        HW = H * W
        q = torch.empty((B, H, W, C), dtype=torch.int8, device=x.device)
    else:
        (B, C), HW = x.shape, 1
        q = torch.empty((B, C), dtype=torch.int8, device=x.device)
    if q.numel() == 0:
        return q
    kq, _ = _kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = kq(x.data_ptr(), s_x.data_ptr(), q.data_ptr(), B, C, HW,
                int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"int8 quantize kernel launch failed: "
                           f"cudaError {rc}")
    global quantize_launches
    quantize_launches += 1
    return q


@_quantize_op.register_fake
def _quantize_fake(x, s_x):
    shape = (x.shape[0], *x.shape[2:], x.shape[1]) if x.dim() == 4 else x.shape
    return x.new_empty(shape, dtype=torch.int8)


def _dequantize(acc, alpha, scale, bias, out_dtype):
    y = acc.float() * alpha
    y = y * (scale[:, None, None] if y.dim() == 4 else scale)
    if bias is not None:
        y = y + (bias[:, None, None] if y.dim() == 4 else bias)
    return y.to(out_dtype)


def conv_int8_plain(xq, wq, alpha, scale, bias, kh: int, kw: int,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of ``conv_int8``: the exact integer product as
    a convolution in f64 of the integer-valued tensors (|acc| <= 127 * 127
    * Kp < 2^53, so every partial sum is exact; the rounding only undoes an
    algorithm's error far below 0.5), then the dequantisation in f32, each
    step rounded."""
    gemm = xq.dim() == 2
    x = xq[:, None, None, :] if gemm else xq                # (B, H, W, Cin)
    cin = x.shape[-1]
    w = wq[:, :kh * kw * cin].reshape(-1, kh, kw, cin)
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   w.permute(0, 3, 1, 2).double(),
                   padding=(kh // 2, kw // 2)).round().to(torch.int32)
    out = _dequantize(acc, alpha, scale, bias, out_dtype)
    return out[:, :, 0, 0] if gemm else out


def conv_int8(xq, wq, alpha, scale, bias, kh: int, kw: int,
              out_dtype: torch.dtype) -> torch.Tensor:
    """``out[b, n, h, w] = ((f32) acc * alpha) * scale[n] + bias[n]`` in
    ``out_dtype``, ``acc`` the s32 sum over ``(dy, dx, c)`` of ``xq[b, h + dy
    - kh // 2, w + dx - kw // 2, c] * wq[n, (dy, dx, c)]`` (zero outside).

    ``xq (B, H, W, Cin)`` s8 (or ``(M, K)``: a GEMM, out ``(M, N)``);
    ``wq (N, Kp)`` s8 from ``pack_weight``; ``alpha`` one f32 element;
    ``scale``, ``bias`` (or None) ``(N,)`` f32; (kh, kw) is (3, 3) or
    (1, 1). A CUDA tensor goes through I1 (or raises), a CPU tensor through
    the plain version, both as the custom op ``hctr::int8_conv``."""
    if (kh, kw) not in ((3, 3), (1, 1)):
        raise ValueError(f"kernel ({kh}, {kw}): I1 takes (3, 3) and (1, 1)")
    gemm = xq.dim() == 2
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or xq.dim() not in (
            2, 4) or wq.dim() != 2:
        raise TypeError("xq (B, H, W, Cin) or (M, K) and wq (N, Kp) must be "
                        "s8")
    cin = xq.shape[-1]
    N, Kp = wq.shape
    K = kh * kw * cin
    if Kp % _K_ALIGN or not K <= Kp < K + _K_ALIGN:
        raise ValueError(f"wq {tuple(wq.shape)} is not K = {K} padded to a "
                         f"multiple of {_K_ALIGN}")
    if (scale.shape != (N,) or scale.dtype != torch.float32
            or alpha.numel() != 1 or alpha.dtype != torch.float32
            or (bias is not None and (bias.shape != (N,)
                                      or bias.dtype != torch.float32))):
        raise TypeError("alpha (1,), scale and bias (N,) must be f32")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    return torch.ops.hctr.int8_conv(xq, wq, alpha, scale, bias, kh, kw,
                                    out_dtype)


@torch.library.custom_op("hctr::int8_conv", mutates_args=(),
                         device_types="cpu")
def _conv_op(xq: torch.Tensor, wq: torch.Tensor, alpha: torch.Tensor,
             scale: torch.Tensor, bias: Optional[torch.Tensor], kh: int,
             kw: int, out_dtype: torch.dtype) -> torch.Tensor:
    return conv_int8_plain(xq, wq, alpha, scale, bias, kh, kw, out_dtype)


@_conv_op.register_kernel("cuda")
def _conv_cuda(xq, wq, alpha, scale, bias, kh, kw, out_dtype):
    tensors = (xq, wq, alpha, scale) + (() if bias is None else (bias,))
    if any(t.device != xq.device for t in tensors):
        raise ValueError("every operand must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("xq and wq must be 16-byte aligned")
    gemm = xq.dim() == 2
    cin = xq.shape[-1]
    N, Kp = wq.shape
    B, H, W = (xq.shape[0], 1, 1) if gemm else xq.shape[:3]
    out = torch.empty((B, N) if gemm else (B, N, H, W), dtype=out_dtype,
                      device=xq.device)
    if out.numel() == 0:
        return out
    _, kc = _kernels()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        rc = kc(xq.data_ptr(), wq.data_ptr(), alpha.data_ptr(),
                scale.data_ptr(), None if bias is None else bias.data_ptr(),
                out.data_ptr(), B, H, W, cin, N, kh, kw, kh // 2, Kp,
                int(out_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out


@_conv_op.register_fake
def _conv_fake(xq, wq, alpha, scale, bias, kh, kw, out_dtype):
    N = wq.shape[0]
    shape = (xq.shape[0], N) if xq.dim() == 2 else (
        xq.shape[0], N, *xq.shape[1:3])
    return xq.new_empty(shape, dtype=out_dtype)


class QuantConv:
    """The int8 state of one conv site, from its f32 weight ``(N, Cin, kh,
    kw)``, its bias (or None) and the calibrated absmax of its input:
    ``w_q`` (packed), ``s_w``, ``amax``, ``s_x`` and the f32 product
    ``scale = s_x * s_w``, all on the weight's device. Calling it on a
    ``(B, Cin, H, W)`` activation runs the site in int8 (stride 1, zero
    padding ``kh // 2``) and returns the compute dtype."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 amax: float):
        N, cin, self.kh, self.kw = weight.shape
        w_q, s_w = quantize_weight(weight, (1, 2, 3))
        self.w_q = pack_weight(w_q.permute(0, 2, 3, 1).reshape(N, -1))
        self.s_w = s_w.reshape(N)
        dev = weight.device
        # a fill, not a copy from the host: a traced program runs it each call
        self.amax = torch.full((1,), amax, dtype=torch.float32, device=dev)
        self.s_x = scale_of(self.amax)
        self.scale = self.s_x * self.s_w
        self.alpha = torch.ones(1, dtype=torch.float32, device=dev)
        self.bias = None if bias is None else bias.detach().float()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return conv_int8(quantize(x, self.s_x), self.w_q, self.alpha,
                         self.scale, self.bias, self.kh, self.kw, x.dtype)


def linear_int8(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
                bias: Optional[torch.Tensor],
                out_dtype: torch.dtype) -> torch.Tensor:
    """``(x @ W.T)`` with a dynamic per-tensor ``s_x = max(|x|, 1e-8) /
    127`` of the live ``x (M, K)`` (a device reduction), the packed weight
    ``w_q (N, Kp)`` and its ``s_w (N,)``: ``((f32) acc * s_x) * s_w +
    bias`` in ``out_dtype``, the JAX LM's order."""
    s_x = scale_of(x.detach().abs().amax()).reshape(1)
    return conv_int8(quantize(x, s_x), w_q, s_x, s_w, bias, 1, 1, out_dtype)
