"""HCTR recognition model: SE-ResNet with asymmetric pooling + CTC head.

PyTorch port of the JAX package's ``models/hctr.py:163-354``. Module and
parameter names follow the flax tree, so ``utils/weights.flax_to_torch``
maps one onto the other by path.

  * NCHW inside; the public contract is the JAX one:
    ``(B, 128, W, 1)`` grayscale in ``[-1, 1]`` -> ``(B, W, num_classes)``
    f32 logits (batch-major).
  * ``compute_dtype`` (bf16 on the card) is the dtype of the activations;
    parameters and BatchNorm statistics stay f32 and are cast at use, and
    the logits come out f32.
  * Max-pool kernel (2, 1) stride (2, 1): height 128 -> 4, width kept.
  * Eval mode (``model.eval()``): BatchNorm uses its running statistics
    (eps 1e-5) and dropout is the identity.
  * Train mode (``model.train()``): BatchNorm normalises with the batch's
    f32 statistics and flax's biased variance ``E[x^2] - E[x]^2``, and
    keeps them (``batch_stats``) for the train step, which moves the
    running statistics to ``0.9 * running + 0.1 * batch`` (flax's momentum
    0.9) unless the step is skipped; under a process group of several
    ranks (``parallel/mesh.py``) the batch is the global one. Dropout
    (``ops/dropout.py``) runs after each block (``block_drop``, 0.1) and
    after each stage (``stage_drop``, 0.3/0.3/0.3/0.9), seeded by the
    ``dropout_seed`` of ``forward`` folded with the site's number. ``remat`` recomputes each block in the backward
    pass (``torch.utils.checkpoint``); its dropout masks come from the same
    seeds, and its BatchNorm statistics are the same values again.
  * The head flattens ``(H, C)`` as ``h * C + c``, the flax order, not
    torch's natural ``(C, H)``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.dropout import dropout_recompute, fold_in
from ..ops.int8_conv import QuantConv
from ..parallel import mesh


class Conv(nn.Conv2d):
    """``nn.Conv2d`` whose f32 parameters are cast to the input's dtype.

    A site may carry an int8 state (``int8``, an ``ops/int8_conv.QuantConv``,
    put on by ``set_amax`` with the calibrated absmax of its input): it then
    runs s8 x s8 -> s32 and dequantises into the input's dtype, as the JAX
    package's ``QuantizableConv`` (its ``models/hctr.py:59``) does. Without
    one it is the float path. Inference only."""

    int8: Optional[QuantConv] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8 is not None:
            return self.int8(x)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)

    def set_amax(self, amax: Optional[float]) -> None:
        """Put this site's int8 state on, from the absmax of its input (its
        f32 weight read now), or take it off (``amax`` None)."""
        if amax is None:
            self.int8 = None
            return
        # the int8 path implements the plain-conv subset this model uses;
        # fail loudly if a site strays from it
        if (self.stride != (1, 1) or self.groups != 1
                or self.dilation != (1, 1) or self.padding_mode != "zeros"
                or self.kernel_size not in ((3, 3), (1, 1))
                or self.padding != (self.kernel_size[0] // 2,
                                    self.kernel_size[1] // 2)):
            raise NotImplementedError(
                "Conv int8 path supports stride-1, undilated, ungrouped "
                "convs only (3x3 padded 1, or 1x1)")
        self.int8 = QuantConv(self.weight, self.bias, amax)


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """At least f32, as flax promotes BatchNorm statistics."""
    return torch.promote_types(x.dtype, torch.float32)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm over NCHW in f32, as flax computes it: batch
    mean and biased variance ``max(E[x^2] - E[x]^2, 0)``, then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, cast to ``x``'s
    dtype. Saves ``x`` in its own dtype and the per-channel statistics;
    the backward is the closed form of the same function.

    Under a process group of more than one rank the statistics are the
    global batch's, as the JAX step's are over its sharded batch: the
    forward sums ``x``, ``x^2`` and the count over the group, and the
    backward sums ``dy`` and ``dy * xhat`` for ``dx`` (the parameter
    gradients stay local: the train step averages every gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        x32 = x.to(_stats_dtype(x))
        ctx.sync = mesh.world_size() > 1
        if ctx.sync:
            n = x.numel() // x.shape[1]
            sums = torch.cat([x32.sum(dim=(0, 2, 3)),
                              x32.square().sum(dim=(0, 2, 3)),
                              x32.new_full((1,), n)])
            mesh.all_reduce_sum_(sums)       # no host sync: n stays a tensor
            ctx.n = sums[-1]
            mean, sq = sums[:-1].view(2, -1) / ctx.n
        else:
            ctx.n = x.numel() // x.shape[1]
            mean = x32.mean(dim=(0, 2, 3))
            sq = x32.square().mean(dim=(0, 2, 3))
        var = (sq - mean.square()).clamp_min(0)
        invstd = torch.rsqrt(var + eps)
        y = ((x32 - mean[:, None, None]) * (invstd * weight)[:, None, None]
             + bias[:, None, None])
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        n = ctx.n
        xhat = (x.to(mean.dtype) - mean[:, None, None]) * invstd[:, None, None]
        dy32 = dy.to(mean.dtype)
        dbias = dy32.sum(dim=(0, 2, 3))
        dweight = (dy32 * xhat).sum(dim=(0, 2, 3))
        sum_dy, sum_dyx = dbias, dweight
        if ctx.sync:
            sum_dy, sum_dyx = mesh.all_reduce_sum_(
                torch.stack([dbias, dweight]))
        dx = (weight * invstd / n)[:, None, None] * (
            n * dy32 - sum_dy[:, None, None] - xhat * sum_dyx[:, None, None])
        return (dx.to(x.dtype), dweight.to(weight.dtype),
                dbias.to(weight.dtype), None)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW with f32 statistics (flax field names
    ``scale/bias/mean/var`` map to ``weight/bias/running_mean/running_var``).
    In train mode the last batch's ``(mean, var)`` stay in
    ``batch_stats`` until ``new_running_stats`` folds them in."""

    momentum = 0.9          # flax's: running = m * running + (1 - m) * batch

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.batch_stats: Optional[tuple] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias,
                                                 self.eps)
            self.batch_stats = (mean, var)
            return y
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        if x.dtype != torch.bfloat16:
            # flax's order of operations, so that an int8 site after it
            # rounds the same f32 values as the JAX package's
            return ((x - self.running_mean[:, None, None])
                    * mul[:, None, None] + self.bias[:, None, None])
        add = self.bias - self.running_mean * mul
        return x * mul.to(x.dtype)[:, None, None] + add.to(x.dtype)[:, None, None]

    def new_running_stats(self):
        """``(mean, var)`` running statistics after the last train-mode
        batch; the module's own are left as they are."""
        mean, var = self.batch_stats
        m = self.momentum
        return (m * self.running_mean + (1 - m) * mean,
                m * self.running_var + (1 - m) * var)


class Dropout(nn.Module):
    """Recompute-in-backward dropout at a numbered site. The identity in
    eval mode or at rate 0; zeros at rate 1 or more (``nn.Dropout``)."""

    def __init__(self, rate: float, site: int):
        super().__init__()
        self.rate, self.site = rate, site

    def forward(self, x: torch.Tensor, seed: Optional[int]) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if seed is None:
            raise ValueError("train-mode dropout needs a dropout_seed")
        return dropout_recompute(x, fold_in(seed, self.site), self.rate)


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
    """conv3x3-BN-ReLU-conv3x3-BN-SE-(+res)-ReLU-Dropout."""

    def __init__(self, in_planes: int, planes: int, drop_rate: float = 0.1,
                 site: int = 0):
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
        self.drop = Dropout(drop_rate, site)

    def forward(self, x: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.se(self.bn2(self.conv2(out)))
        residual = self.down_bn(self.down_conv(x)) if self.use_downsample else x
        return self.drop(F.relu(out + residual), seed)


def _maxpool_h2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=(2, 1), stride=(2, 1))


class SEResNetBackbone(nn.Module):
    """1 -> ``out_channels`` SE-ResNet with asymmetric pooling.

    Input ``(B, 1, 128, W)``; output ``(B, C, 4, W)``. ``pool`` follows
    the stem and each stage (``models/innovation.py`` pools 2x2)."""

    pool = staticmethod(_maxpool_h2)

    def __init__(self, out_channels: int = 512,
                 num_blocks: Sequence[int] = (2, 4, 5, 1),
                 stage_drop: Sequence[float] = (0.3, 0.3, 0.3, 0.9),
                 block_drop: float = 0.1, remat: bool = False):
        super().__init__()
        c = out_channels
        widths = [c // 8, c // 4, c // 2, c, c]
        self.conv0_1 = Conv(1, widths[0], 3, padding=1)
        self.bn0_1 = BatchNorm(widths[0])
        self.conv0_2 = Conv(widths[0], widths[0], 3, padding=1)
        self.bn0_2 = BatchNorm(widths[0])
        self.num_blocks = tuple(num_blocks)
        self.remat = remat
        in_planes, site = widths[0], 0
        for stage in range(4):
            planes = widths[stage + 1]
            for b in range(self.num_blocks[stage]):
                self.add_module(f"block{stage + 1}_{b}",
                                BasicBlock(in_planes, planes, block_drop,
                                           site))
                in_planes, site = planes, site + 1
            self.add_module(f"conv{stage + 1}",
                            Conv(planes, planes, 3, padding=1))
            self.add_module(f"bn{stage + 1}", BatchNorm(planes))
            self.add_module(f"drop{stage + 1}",
                            Dropout(stage_drop[stage], site))
            site += 1

    def forward(self, x: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        return self.stages(x, seed)[-1]

    def stages(self, x: torch.Tensor,
               seed: Optional[int] = None) -> List[torch.Tensor]:
        """The output of each of the four stages."""
        x = F.relu(self.bn0_1(self.conv0_1(x)))
        x = F.relu(self.bn0_2(self.conv0_2(x)))
        x = self.pool(x)
        remat = self.remat and self.training and torch.is_grad_enabled()
        features = []
        for stage in range(4):
            for b in range(self.num_blocks[stage]):
                block = getattr(self, f"block{stage + 1}_{b}")
                x = (torch.utils.checkpoint.checkpoint(
                    block, x, seed, use_reentrant=False)
                     if remat else block(x, seed))
            x = getattr(self, f"conv{stage + 1}")(x)
            x = F.relu(getattr(self, f"bn{stage + 1}")(x))
            x = getattr(self, f"drop{stage + 1}")(self.pool(x), seed)
            features.append(x)
        return features


class HCTRModel(nn.Module):
    """SE-ResNet backbone + per-column CTC classification head.

    forward: ``(B, 128, W, 1)`` in ``[-1, 1]`` -> ``(B, W, num_classes)`` f32.
    """

    img_height = 128
    pad_mode = "NormalizePAD"
    optimizer = "SGD"
    pred = "CTC"

    def __init__(self, num_classes: int = 7375, backbone_channels: int = 512,
                 num_blocks: Sequence[int] = (2, 4, 5, 1),
                 compute_dtype: torch.dtype = torch.float32,
                 stage_drop: Sequence[float] = (0.3, 0.3, 0.3, 0.9),
                 block_drop: float = 0.1, remat: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.cnn = SEResNetBackbone(backbone_channels, num_blocks,
                                    stage_drop, block_drop, remat)
        feat_h = self.img_height // 32
        self.linear = nn.Linear(feat_h * backbone_channels, num_classes)

    def forward(self, x: torch.Tensor,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        """``dropout_seed`` seeds the train-mode dropout sites."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)   # -> (B, 1, H, W)
        feats = self.cnn(x, dropout_seed)                  # (B, C, 4, W)
        B, C, H, W = feats.shape
        feats = feats.permute(0, 3, 2, 1).reshape(B, W, H * C)  # h*C + c
        dt = feats.dtype
        logits = F.linear(feats, self.linear.weight.to(dt),
                          self.linear.bias.to(dt))
        return logits.float()

    def batch_norms(self):
        return [m for m in self.modules() if isinstance(m, BatchNorm)]


def hctr_model(num_classes: int = 7375,
               compute_dtype: torch.dtype = torch.float32,
               **kwargs) -> HCTRModel:
    """The full-width recognizer: 512 channels, blocks [2, 4, 5, 1];
    ``kwargs`` are the train-mode fields (``stage_drop``, ``block_drop``,
    ``remat``)."""
    return HCTRModel(num_classes=num_classes, compute_dtype=compute_dtype,
                     **kwargs)
