"""Greedy CTC decoding on the device (the JAX package's ``ops/decode.py``).

The argmax and the CTC collapse run where the logits are; only a compact
``(B, T)`` index matrix and ``(B,)`` lengths go to the host. Frame ``t`` is
kept iff its argmax is neither blank nor unknown and differs from frame
``t - 1`` (the comparison is against the previous frame, before collapse).
Argmax ties go to the lowest class index.
"""

from __future__ import annotations

import torch


def greedy_decode_device(logits: torch.Tensor,
                         widths: torch.Tensor | None = None, *,
                         unknown_id: int, blank_id: int = 0):
    """``(B, T, D)`` logits (+ optional ``(B,)`` valid frames) ->
    ``(chars (B, T) int32, lengths (B,) int32)``, each row's kept indices
    left-compacted and zero-padded."""
    B, T, _ = logits.shape
    idx = logits.argmax(dim=-1).to(torch.int32)               # (B, T)
    if widths is not None:
        t_pos = torch.arange(T, device=idx.device)[None, :]
        idx = torch.where(t_pos < widths[:, None], idx, blank_id)
    prev = torch.cat([torch.full_like(idx[:, :1], -1), idx[:, :-1]], dim=1)
    keep = (idx != blank_id) & (idx != unknown_id) & (idx != prev)
    # dropped frames go to a spare column T, cut off afterwards
    pos = torch.where(keep, keep.cumsum(dim=1) - 1, T)
    chars = torch.zeros((B, T + 1), dtype=torch.int32, device=idx.device)
    chars.scatter_(1, pos, idx)
    return chars[:, :T], keep.sum(dim=1, dtype=torch.int32)
