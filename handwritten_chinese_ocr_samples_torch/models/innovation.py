"""The isolated-character classifier, ``-m innovation`` (the JAX package's
``models/innovation.py``; the reference's `innovation.py:13-282`).

The SE-ResNet trunk of ``models/hctr.py`` (widths 64/128/256/512/512,
blocks [2, 4, 5, 1], block dropout 0.1, stage dropout 0.3/0.3/0.3/0.9)
with a 2x2 max pool after the stem and after each stage, so both height
and width halve; then, as options,

  * multi-scale fusion (``feature_fusion``): each stage's output through a
    1x1 conv + BatchNorm + ReLU, resized to the last stage's size, the four
    averaged, then a 3x3 conv + BatchNorm + ReLU;
  * residual spatial attention (``spatial_attn``): ``x * (1 + gamma *
    sigmoid(conv7x7([mean_c(x), max_c(x)])))``, ``gamma`` starting at 0;

and a global mean over H and W in f32, Dropout(0.5) and the ``fc`` head:
``(B, H, H, 1)`` in ``[-1, 1]`` -> ``(B, num_classes)`` f32 logits. Module
and parameter names follow the flax tree (``utils/weights.flax_to_torch``).
BatchNorm, dropout and the compute dtype behave as in ``models/hctr.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .hctr import BatchNorm, Conv, Dropout, SEResNetBackbone


def _maxpool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=2, stride=2)


class InnovationBackbone(SEResNetBackbone):
    """The SE-ResNet trunk with symmetric pooling (`innovation.py:143-191`);
    ``stages`` gives each stage's output for the fusion."""

    pool = staticmethod(_maxpool_2x2)


class SpatialAttention(nn.Module):
    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = Conv(2, 1, kernel_size, padding=kernel_size // 2,
                         bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = torch.cat([x.mean(dim=1, keepdim=True),
                          x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv(attn))


class ResidualSpatialAttention(nn.Module):
    """``x * (1 + gamma * attn)``; with an f32 ``gamma`` the product is f32,
    as in the JAX package."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.spatial = SpatialAttention(kernel_size)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * (1.0 + self.gamma * self.spatial(x))


class MultiScaleFeatureFusion(nn.Module):
    def __init__(self, channels: Sequence[int] = (128, 256, 512, 512),
                 out_channels: int = 512):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"transform{i}_conv", Conv(c, out_channels, 1))
            self.add_module(f"transform{i}_bn", BatchNorm(out_channels))
        self.fusion_conv = Conv(out_channels, out_channels, 3, padding=1)
        self.fusion_bn = BatchNorm(out_channels)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        target = features[-1].shape[-2:]
        transformed = []
        for i, feat in enumerate(features):
            y = getattr(self, f"transform{i}_conv")(feat)
            y = F.relu(getattr(self, f"transform{i}_bn")(y))
            if y.shape[-2:] != target:
                # jax.image.resize's "bilinear" widens its triangle filter
                # when it shrinks (antialias); so does antialias=True. The
                # resize runs in f32 and is cast back: its inputs are a few
                # KiB, and bf16 support of the antialiased kernel is not
                # promised by every PyTorch build
                y = F.interpolate(y.float(), size=tuple(target),
                                  mode="bilinear", align_corners=False,
                                  antialias=True).to(y.dtype)
            transformed.append(y)
        fused = sum(transformed) / len(transformed)
        return F.relu(self.fusion_bn(self.fusion_conv(fused)))


class InnovationModel(nn.Module):
    """Trunk -> (fusion) -> (attention) -> global mean -> Dropout -> ``fc``.

    forward: ``(B, H, W, 1)`` in ``[-1, 1]`` -> ``(B, num_classes)`` f32.
    ``backbone_channels`` and ``num_blocks`` narrow the trunk for tests;
    the registry's ``innovation`` has the JAX package's fixed widths."""

    img_height = 128
    pad_mode = "NormalizePAD"
    optimizer = "Adam"
    pred = "Classification"

    def __init__(self, num_classes: int, use_multiscale: bool = False,
                 use_spatial_attn: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 backbone_channels: int = 512,
                 num_blocks: Sequence[int] = (2, 4, 5, 1),
                 stage_drop: Sequence[float] = (0.3, 0.3, 0.3, 0.9),
                 block_drop: float = 0.1, head_drop: float = 0.5):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.cnn = InnovationBackbone(backbone_channels, num_blocks,
                                      stage_drop, block_drop)
        c = backbone_channels
        width = c
        self.feature_fusion = self.spatial_attn = None
        if use_multiscale:
            self.feature_fusion = MultiScaleFeatureFusion(
                (c // 4, c // 2, c, c), out_channels=512)
            width = 512
        if use_spatial_attn:
            self.spatial_attn = ResidualSpatialAttention()
        self.drop = Dropout(head_drop, sum(num_blocks) + 4)
        self.fc = nn.Linear(width, num_classes)

    def forward(self, x: torch.Tensor,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        """``dropout_seed`` seeds the train-mode dropout sites."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)   # -> (B, 1, H, W)
        features = self.cnn.stages(x, dropout_seed)
        x = features[-1]
        if self.feature_fusion is not None:
            x = self.feature_fusion(features)
        if self.spatial_attn is not None:
            x = self.spatial_attn(x)
        x = x.float().mean(dim=(2, 3)).to(self.compute_dtype)
        x = self.drop(x, dropout_seed)
        dt = x.dtype
        return F.linear(x, self.fc.weight.to(dt), self.fc.bias.to(dt)).float()

    def batch_norms(self):
        return [m for m in self.modules() if isinstance(m, BatchNorm)]


def innovation_model(num_classes: int,
                     compute_dtype: torch.dtype = torch.float32,
                     use_multiscale: bool = False,
                     use_spatial_attn: bool = False,
                     **kwargs) -> InnovationModel:
    """The classifier at the JAX package's widths; ``kwargs`` are the
    train-mode fields (``stage_drop``, ``block_drop``, ``head_drop``)."""
    return InnovationModel(num_classes, use_multiscale, use_spatial_attn,
                           compute_dtype, **kwargs)
