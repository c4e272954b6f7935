"""Per-batch sizing of the LM-fused device beam search (the JAX package's
``decode/adaptive.py``).

``AdaptiveLMBeam`` sizes the search per batch on the host, from a few
scalars that device reductions return in one copy
(``beam_lm_device.make_count_stats`` / ``make_count_sizing``):

* **LM context** from the batch's greedy character count plus a margin,
  rounded up to an entry of ``STABLE_CTX`` and capped at the LM's
  ``max_len``; when the search reports a KV-cache overflow (committed
  tokens can outnumber the greedy estimate) the context **escalates** and
  the batch is decoded again. A pinned context raises instead.
* **Segment budget** (skip search) from the batch's segment count, grow
  only, in multiples of 4 and at least 16; a pinned budget that a batch
  exceeds raises.
* **Peek rows** (skip search) from ``count_peek_rows``, grow only: the
  ambiguous frame's peek scores only the candidates that can be used.
* **KV-context ladder** (skip search, on by default with a first rung of
  ``ctx_ladder=112`` positions): the first segments run on a shallower
  cache. The rung's length is a running minimum of each batch's sound
  bound (``make_count_ladder``), rounded down to a multiple of 8, so the
  ladder never changes a result.
* **Group size**: the largest divisor of the batch up to the request that
  is not in ``FAULTY_GROUPS``.

``STABLE_CTX``, ``CTX_MARGIN`` and ``FAULTY_GROUPS`` are the JAX package's
values. They pick which search is built, never a result; keeping them keeps
the overflow and escalation behaviour identical. The search is synchronous,
so ``decode`` returns the result and there is no deferred
``PendingDecode``.
"""

from __future__ import annotations

import torch

from ..ops.topk_logsoftmax import PRUNE
from .beam_lm_device import (_DENSE, count_peek_rows, make_count_sizing,
                             make_count_stats, make_lm_beam_search)

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

    ``lm_ctx=0`` and ``seg_budget=0`` mean auto; explicit values are
    honoured exactly and an error is raised instead of truncating.
    ``skip_search=True`` (the default, as in the JAX package) runs the skip
    search, which needs K1's ``blank_lp`` and ``n_above`` computed at the
    same ``prune`` (a log-probability); ``skip_search=False`` the full
    per-frame search, where the segment knobs are unused."""

    def __init__(self, clm, codec2lm, lm2codec, *, beam_size: int = 10,
                 depth: int = 10, unknown_id: int, lm_panelty: float,
                 len_bonus: float, use_lm_pred: bool = True,
                 skip_search: bool = True, group_size: int = 8,
                 lm_ctx: int = 0, seg_budget: int = 0, run_max: int = 8,
                 ctx_ladder: int = 112, fused_commit: bool = False,
                 dense_merge: bool = False, prune: float = PRUNE):
        if dense_merge:
            raise NotImplementedError(_DENSE)
        self._clm = clm
        self._c2l = codec2lm
        self._l2c = lm2codec
        self._kw = dict(beam_size=beam_size, depth=depth,
                        unknown_id=unknown_id, lm_panelty=lm_panelty,
                        len_bonus=len_bonus, use_lm_pred=use_lm_pred,
                        run_max=run_max, prune=float(prune),
                        return_overflow=True)
        self.unknown_id = unknown_id
        self.skip = bool(skip_search)
        self.group_size = group_size
        self.run_max = run_max
        self._ctx_pinned = int(lm_ctx) > 0
        self._budget_pinned = int(seg_budget) > 0
        self._ctx = int(lm_ctx) if self._ctx_pinned else 0
        self._budget = int(seg_budget) if self._budget_pinned else 0
        self._max_ctx = int(clm.model.max_len)
        if self._ctx_pinned and self._ctx > self._max_ctx:
            raise ValueError(
                f"lm_ctx={self._ctx} exceeds the LM's trained max_len "
                f"{self._max_ctx}: positions past it would silently reuse "
                f"the last positional embedding; lower --lm-ctx or use 0 "
                f"(auto)")
        if int(ctx_ladder) < 0:
            raise ValueError(f"ctx_ladder={ctx_ladder} must be >= 0 "
                             f"(0 = off; otherwise the first-rung depth)")
        self._peek = 0                  # peek-row budget (grow-only)
        self._ladder_ctx = int(ctx_ladder)
        self._ladder_bound = 1 << 30    # running min of the sound bounds
        self._ladder_k = 0
        self._fused = bool(fused_commit) and self.skip
        self._sizing = None
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

    def _size(self, cand_idx, n_above, T: int) -> None:
        """Size the context, and for the skip search the segment budget,
        the peek rows and the ladder, from one copy of the batch's
        maxima."""
        if not self.skip:
            chars_max = self._greedy_chars(cand_idx)
        else:
            if self._sizing is None:
                kw = dict(unknown_id=self.unknown_id, run_max=self.run_max)
                self._sizing = (make_count_sizing(**kw) if self._ladder_ctx
                                else make_count_stats(**kw))
            args = ((cand_idx, n_above, self._ladder_ctx)
                    if self._ladder_ctx else (cand_idx, n_above))
            chars_max, _, seg_max, na_max, *ladder_raw = (
                self._sizing(*args).tolist())
        if not self._ctx_pinned:
            self._ctx = self._auto_ctx(chars_max)
        elif chars_max + 2 > self._ctx:
            raise RuntimeError(
                f"lm_ctx={self._ctx} cannot hold a ~{chars_max}-char line; "
                f"raise --lm-ctx or use 0 (auto)")
        if not self.skip:
            return
        pr = count_peek_rows([na_max], depth=self._kw["depth"],
                             use_lm_pred=self._kw["use_lm_pred"])
        if pr > self._peek:
            self._peek = -(-pr // 4) * 4
        if self._budget_pinned:
            if seg_max > self._budget:
                raise RuntimeError(
                    f"segment budget {self._budget} < data maximum "
                    f"{seg_max}; raise --seg-budget or use 0 (auto)")
        elif seg_max > self._budget:
            self._budget = -(-max(seg_max + 1, 16) // 4) * 4
        if self._ladder_ctx and self._ladder_ctx < self._ctx:
            # rounded down to a multiple of 8 (a shorter rung stays sound)
            # and inside the search's own segment count, so that the
            # search keeps it; rungs under 8 segments are not used
            self._ladder_bound = min(self._ladder_bound, ladder_raw[0])
            k = min(self._ladder_bound // 8 * 8, min(self._budget, T) - 1)
            self._ladder_k = k if k >= 8 else 0
        else:
            self._ladder_k = 0

    def search(self, group: int, **extra):
        """The search at the current sizing (``extra``: e.g. a selection
        hook)."""
        if not self.skip:
            return make_lm_beam_search(
                self._clm, self._c2l, self._l2c, skip_search=False,
                lm_ctx=self._ctx, group_size=group, **self._kw, **extra)
        return make_lm_beam_search(
            self._clm, self._c2l, self._l2c, skip_search=True,
            lm_ctx=self._ctx, seg_budget=self._budget, group_size=group,
            peek_rows=self._peek or None,
            ctx_ladder=((self._ladder_k, self._ladder_ctx)
                        if self._ladder_k else None),
            fused_commit=self._fused, **self._kw, **extra)

    # ------------------------------------------------------------ decode
    def decode(self, cand_vals, cand_idx, logits, logz, blank_lp=None,
               n_above=None):
        """Size the search from the batch, run it and check its overflow
        flag, escalating the context and decoding again if it fired.
        Device tensors in, ``(prefixes, lengths)`` out."""
        B, T = cand_vals.shape[:2]
        self._size(cand_idx, n_above, int(T))
        self.last_group = pick_group_size(B, self.group_size)
        args = (cand_vals, cand_idx, logits, logz)
        if self.skip:
            args += (blank_lp, n_above)
        while True:
            prefixes, lengths, ovf = self.search(self.last_group)(*args)
            if not bool(ovf.any()):
                return prefixes, lengths
            if self._ctx_pinned:
                raise RuntimeError(
                    f"LM KV cache overflowed at pinned lm_ctx={self._ctx}; "
                    f"raise --lm-ctx or use 0 (auto)")
            self._ctx = self._escalated_ctx()
