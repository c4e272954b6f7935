"""HCTR recognition model: SE-ResNet with asymmetric pooling + CTC head.

PyTorch port of the JAX package's ``models/hctr.py:163-354`` (inference
only). Module and parameter names follow the flax tree, so
``utils/weights.flax_to_torch`` maps one onto the other by path.

  * NCHW inside; the public contract is the JAX one:
    ``(B, 128, W, 1)`` grayscale in ``[-1, 1]`` -> ``(B, W, num_classes)``
    f32 logits (batch-major).
  * ``compute_dtype`` (bf16 on the card) is the dtype of the activations;
    parameters and BatchNorm statistics stay f32 and are cast at use, and
    the logits come out f32.
  * Max-pool kernel (2, 1) stride (2, 1): height 128 -> 4, width kept.
  * BatchNorm uses its running statistics (eps 1e-5); dropout is an
    inference no-op.
  * The head flattens ``(H, C)`` as ``h * C + c``, the flax order, not
    torch's natural ``(C, H)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Conv2d):
    """``nn.Conv2d`` whose f32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class BatchNorm(nn.Module):
    """Inference BatchNorm over NCHW with f32 statistics (flax field names
    ``scale/bias/mean/var`` map to ``weight/bias/running_mean/running_var``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        add = self.bias - self.running_mean * mul
        return x * mul.to(x.dtype)[:, None, None] + add.to(x.dtype)[:, None, None]


class SELayer(nn.Module):
    """Squeeze-and-excitation channel gate: avg-pool -> FC(C/16, no bias)
    -> ReLU -> FC(C, no bias) -> sigmoid -> scale."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction, bias=False)
        self.fc2 = nn.Linear(channels // reduction, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float().mean(dim=(2, 3)).to(x.dtype)
        y = F.relu(F.linear(y, self.fc1.weight.to(x.dtype)))
        y = torch.sigmoid(F.linear(y, self.fc2.weight.to(x.dtype)))
        return x * y[:, :, None, None]


class BasicBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN-SE-(+res)-ReLU (dropout: inference no-op)."""

    def __init__(self, in_planes: int, planes: int):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, padding=1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, padding=1)
        self.bn2 = BatchNorm(planes)
        self.se = SELayer(planes)
        self.use_downsample = in_planes != planes
        if self.use_downsample:
            self.down_conv = Conv(in_planes, planes, 1, bias=False)
            self.down_bn = BatchNorm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.se(self.bn2(self.conv2(out)))
        residual = self.down_bn(self.down_conv(x)) if self.use_downsample else x
        return F.relu(out + residual)


def _maxpool_h2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=(2, 1), stride=(2, 1))


class SEResNetBackbone(nn.Module):
    """1 -> ``out_channels`` SE-ResNet with asymmetric pooling.

    Input ``(B, 1, 128, W)``; output ``(B, C, 4, W)``."""

    def __init__(self, out_channels: int = 512,
                 num_blocks: Sequence[int] = (2, 4, 5, 1)):
        super().__init__()
        c = out_channels
        widths = [c // 8, c // 4, c // 2, c, c]
        self.conv0_1 = Conv(1, widths[0], 3, padding=1)
        self.bn0_1 = BatchNorm(widths[0])
        self.conv0_2 = Conv(widths[0], widths[0], 3, padding=1)
        self.bn0_2 = BatchNorm(widths[0])
        self.num_blocks = tuple(num_blocks)
        in_planes = widths[0]
        for stage in range(4):
            planes = widths[stage + 1]
            for b in range(self.num_blocks[stage]):
                self.add_module(f"block{stage + 1}_{b}",
                                BasicBlock(in_planes, planes))
                in_planes = planes
            self.add_module(f"conv{stage + 1}",
                            Conv(planes, planes, 3, padding=1))
            self.add_module(f"bn{stage + 1}", BatchNorm(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn0_1(self.conv0_1(x)))
        x = F.relu(self.bn0_2(self.conv0_2(x)))
        x = _maxpool_h2(x)
        for stage in range(4):
            for b in range(self.num_blocks[stage]):
                x = getattr(self, f"block{stage + 1}_{b}")(x)
            x = getattr(self, f"conv{stage + 1}")(x)
            x = F.relu(getattr(self, f"bn{stage + 1}")(x))
            x = _maxpool_h2(x)
        return x


class HCTRModel(nn.Module):
    """SE-ResNet backbone + per-column CTC classification head.

    forward: ``(B, 128, W, 1)`` in ``[-1, 1]`` -> ``(B, W, num_classes)`` f32.
    """

    img_height = 128
    pad_mode = "NormalizePAD"

    def __init__(self, num_classes: int = 7375, backbone_channels: int = 512,
                 num_blocks: Sequence[int] = (2, 4, 5, 1),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.cnn = SEResNetBackbone(backbone_channels, num_blocks)
        feat_h = self.img_height // 32
        self.linear = nn.Linear(feat_h * backbone_channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)   # -> (B, 1, H, W)
        feats = self.cnn(x)                                # (B, C, 4, W)
        B, C, H, W = feats.shape
        feats = feats.permute(0, 3, 2, 1).reshape(B, W, H * C)  # h*C + c
        dt = feats.dtype
        logits = F.linear(feats, self.linear.weight.to(dt),
                          self.linear.bias.to(dt))
        return logits.float()


def hctr_model(num_classes: int = 7375,
               compute_dtype: torch.dtype = torch.float32) -> HCTRModel:
    """The full-width recognizer: 512 channels, blocks [2, 4, 5, 1]."""
    return HCTRModel(num_classes=num_classes, compute_dtype=compute_dtype)
