"""Recompute-in-backward dropout (the JAX package's ``ops/dropout.py``).

The model has sixteen dropout sites over its largest activations. Saving a
keep-mask for each would keep one mask element per activation element alive
until the backward pass. This op saves nothing but an integer seed: the
backward pass draws the same bits again from a ``torch.Generator`` seeded
with it on the tensor's device, and so rebuilds the identical mask.

The bits are 16-bit values in ``[0, 65536)``; an element is kept where
``bits >= min(ceil(rate * 65536), 65535)``, so the realised keep probability
is ``1 - ceil(rate * 65536) / 65536``, the JAX package's. The masks
themselves differ from JAX's (no torch generator reproduces
``jax.random.bits``).

``fold_in`` derives the seed of a step and site from the run's seed, as
``jax.random.fold_in`` derives keys. Under a process group of several ranks
the rank is folded into each site's seed too, so that the ranks' rows draw
independent masks.
"""

from __future__ import annotations

import math

import torch

from ..parallel import mesh

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """SplitMix64's finaliser: a bijection of 64-bit integers."""
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _MASK64
    return z ^ (z >> 31)


def fold_in(seed: int, *data: int) -> int:
    """A new 63-bit seed from ``seed`` and each integer of ``data``."""
    h = _mix64(seed & _MASK64)
    for d in data:
        h = _mix64((h + 0x9E3779B97F4A7C15 + (d & _MASK64)) & _MASK64)
    return h >> 1


def keep_mask(seed: int, shape, rate: float,
              device: torch.device) -> torch.Tensor:
    """The boolean keep-mask of ``seed``: 16-bit draws at or above
    ``min(ceil(rate * 65536), 65535)``."""
    thr = min(math.ceil(rate * 65536), 65535)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    bits = torch.randint(0, 65536, tuple(shape), generator=g, device=device,
                         dtype=torch.int32)
    return bits >= thr


def _apply(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    # the scale is rounded to x's dtype first, as the JAX op does
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype).item()
    return torch.where(keep_mask(seed, x.shape, rate, x.device), x * scale,
                       0.0)


class _DropoutRecompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed: int, rate: float):
        ctx.seed, ctx.rate = seed, rate
        return _apply(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        return _apply(g, ctx.seed, ctx.rate), None, None


def dropout_recompute(x: torch.Tensor, seed: int,
                      rate: float) -> torch.Tensor:
    """``x * keep / (1 - rate)`` with the mask drawn again, not saved, in
    the backward pass. ``rate`` must be in ``[0, 1)``."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} is outside [0, 1)")
    if mesh.world_size() > 1:
        seed = fold_in(seed, mesh.rank())
    return _DropoutRecompute.apply(x, seed, rate)
