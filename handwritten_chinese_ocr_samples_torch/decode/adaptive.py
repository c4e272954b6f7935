"""Per-batch sizing of the LM-fused device beam search (the JAX package's
``decode/adaptive.py``, full search only).

``AdaptiveLMBeam`` sizes the search per batch on the host:

* **LM context** from the batch's greedy character count plus a margin,
  rounded up to an entry of ``STABLE_CTX`` and capped at the LM's
  ``max_len``; when the search reports a KV-cache overflow (committed
  tokens can outnumber the greedy estimate) the context **escalates** and
  the batch is decoded again. A pinned context raises instead.
* **Group size**: the largest divisor of the batch up to the request that
  is not in ``FAULTY_GROUPS``.

``STABLE_CTX``, ``CTX_MARGIN`` and ``FAULTY_GROUPS`` are the JAX package's
values. They pick which search is built, never a result; keeping them keeps
the overflow and escalation behaviour identical. The skip search
(``skip_search=True``) is the next slice and raises.
"""

from __future__ import annotations

import torch

from .beam_lm_device import _DENSE, _SKIP_SLICE, make_lm_beam_search

STABLE_CTX = (144, 160, 192, 256, 320, 384, 448, 512)
# margin between the greedy char count and the LM context: beams commit at
# most a handful more chars than greedy on peaky posteriors, plus <s>
CTX_MARGIN = 24
FAULTY_GROUPS = {16}


def pick_group_size(batch: int, requested: int) -> int:
    """Largest divisor of ``batch`` that is <= ``requested`` and not in
    ``FAULTY_GROUPS``."""
    g = max(1, min(requested, batch))
    while g > 1 and (batch % g != 0 or g in FAULTY_GROUPS):
        g -= 1
    return g


class AdaptiveLMBeam:
    """Decode batches through the LM-fused search with per-batch sizing
    and overflow escalation.

    ``lm_ctx=0`` means auto; an explicit value is honoured exactly and an
    error is raised instead of truncating. The skip-search knobs of the JAX
    package's ``AdaptiveLMBeam`` (segment budget, run length, ladder, fused
    commit, prune) have no use in the full search and are not taken. The
    search is synchronous, so ``decode`` returns the result and there is no
    deferred ``PendingDecode``."""

    def __init__(self, clm, codec2lm, lm2codec, *, beam_size: int = 10,
                 depth: int = 10, unknown_id: int, lm_panelty: float,
                 len_bonus: float, use_lm_pred: bool = True,
                 skip_search: bool = False, group_size: int = 8,
                 lm_ctx: int = 0, dense_merge: bool = False):
        if skip_search:
            raise NotImplementedError(_SKIP_SLICE)
        if dense_merge:
            raise NotImplementedError(_DENSE)
        self._clm = clm
        self._c2l = codec2lm
        self._l2c = lm2codec
        self._kw = dict(beam_size=beam_size, depth=depth,
                        unknown_id=unknown_id, lm_panelty=lm_panelty,
                        len_bonus=len_bonus, use_lm_pred=use_lm_pred,
                        return_overflow=True)
        self.unknown_id = unknown_id
        self.group_size = group_size
        self._ctx_pinned = int(lm_ctx) > 0
        self._ctx = int(lm_ctx) if self._ctx_pinned else 0
        self._max_ctx = int(clm.model.max_len)
        if self._ctx_pinned and self._ctx > self._max_ctx:
            raise ValueError(
                f"lm_ctx={self._ctx} exceeds the LM's trained max_len "
                f"{self._max_ctx}: positions past it would silently reuse "
                f"the last positional embedding; lower --lm-ctx or use 0 "
                f"(auto)")
        self.last_group = 0  # group size of the last search run

    # ------------------------------------------------------------ sizing
    def _auto_ctx(self, chars_max: int) -> int:
        need = chars_max + CTX_MARGIN
        for c in STABLE_CTX:
            if c >= need and c <= self._max_ctx:
                return max(c, self._ctx)
        # the margin is best effort: a line that fits max_len (chars + <s>
        # + slack) is served at max_len; overflow escalation guards the rest
        if chars_max + 2 <= self._max_ctx:
            return max(self._max_ctx, self._ctx)
        raise ValueError(
            f"line has ~{chars_max} greedy chars; LM max_len "
            f"{self._max_ctx} cannot hold it: train/export the LM with a "
            f"longer context")

    def _escalated_ctx(self) -> int:
        for c in STABLE_CTX:
            if c > self._ctx and c <= self._max_ctx:
                return c
        if self._max_ctx > self._ctx:   # past the last stable entry
            return self._max_ctx
        raise RuntimeError(
            f"LM KV cache overflowed even at ctx={self._ctx} (LM max_len "
            f"{self._max_ctx}): the decoded line exceeds the LM's trained "
            f"context")

    def _greedy_chars(self, cand_idx) -> int:
        """The batch's largest greedy character count (one scalar
        fetched from the device)."""
        arg = cand_idx[:, :, 0]
        prev = torch.cat([torch.full_like(arg[:, :1], -1), arg[:, :-1]], 1)
        keep = (arg != 0) & (arg != self.unknown_id) & (arg != prev)
        return int(keep.sum(1).max()) if arg.numel() else 0

    # ------------------------------------------------------------ decode
    def decode(self, cand_vals, cand_idx, logits, logz):
        """Size the context and group from the batch, run the search and
        check its overflow flag, escalating the context and decoding again
        if it fired. Device tensors in, ``(prefixes, lengths)`` out."""
        chars_max = self._greedy_chars(cand_idx)
        if not self._ctx_pinned:
            self._ctx = self._auto_ctx(chars_max)
        elif chars_max + 2 > self._ctx:
            raise RuntimeError(
                f"lm_ctx={self._ctx} cannot hold a ~{chars_max}-char line; "
                f"raise --lm-ctx or use 0 (auto)")
        self.last_group = pick_group_size(cand_vals.shape[0],
                                          self.group_size)
        while True:
            prefixes, lengths, ovf = make_lm_beam_search(
                self._clm, self._c2l, self._l2c, skip_search=False,
                lm_ctx=self._ctx, group_size=self.last_group,
                **self._kw)(cand_vals, cand_idx, logits, logz)
            if not bool(ovf.any()):
                return prefixes, lengths
            if self._ctx_pinned:
                raise RuntimeError(
                    f"LM KV cache overflowed at pinned lm_ctx={self._ctx}; "
                    f"raise --lm-ctx or use 0 (auto)")
            self._ctx = self._escalated_ctx()
