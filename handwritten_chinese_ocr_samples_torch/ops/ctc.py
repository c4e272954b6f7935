"""CTC loss of the trainer (the JAX package's ``ops/ctc.py``).

The batch mean of the reference trainer (`main.py:203-206`, `:406-409`):
each sequence's negative log-likelihood of its f32 logits is divided by its
label length (at least 1); non-finite values (an infeasible sequence, NaN
logits) are zeroed; the sum is divided by the batch size.

The input length of every sequence is the full padded width unless
``logit_paddings`` say otherwise (`main.py:388`); all-zero paddings are the
full width. ``F.ctc_loss`` computes the per-sequence loss. It takes its
lengths on the host: paddings given as CPU tensors keep the loss free of a
device-to-host copy (the trainer passes them so).

An infeasible sequence (more labels than its frames can hold) costs
``inf`` here and is zeroed, as ``nn.CTCLoss(zero_infinity=True)`` does;
the JAX package's optax loss approximates log(0) by -1e5 and keeps such a
sequence at about ``1e5 / label_length`` (ROADMAP.md, queue 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ctc_loss_mean(
    logits: torch.Tensor,             # (B, T, K) raw logits
    labels: torch.Tensor,             # (B, L) int, blank = 0
    label_paddings: torch.Tensor,     # (B, L) 1.0 = pad
    logit_paddings: torch.Tensor | None = None,   # (B, T) 1.0 = pad
    blank_id: int = 0,
) -> torch.Tensor:
    """Batch-mean CTC loss (torch ``reduction='mean'`` + ``zero_infinity``)."""
    B, T, _ = logits.shape
    label_lengths = (1.0 - label_paddings.float()).sum(-1)
    if logit_paddings is None:
        input_lengths = torch.full((B,), T, dtype=torch.long)
    else:
        input_lengths = T - logit_paddings.float().sum(-1).long()
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    per_seq = F.ctc_loss(log_probs, labels.long(), input_lengths,
                         label_lengths.long(), blank=blank_id,
                         reduction="none", zero_infinity=True)
    per_seq = per_seq / label_lengths.clamp_min(1.0).to(per_seq.device,
                                                        non_blocking=True)
    per_seq = torch.where(torch.isfinite(per_seq), per_seq, 0.0)
    return per_seq.sum() / B


def widths_to_paddings(widths: torch.Tensor, T: int) -> torch.Tensor:
    """Per-example valid frame counts -> (B, T) logit paddings (1.0 = pad)."""
    t = torch.arange(T, device=widths.device)[None, :]
    return (t >= widths[:, None]).float()
