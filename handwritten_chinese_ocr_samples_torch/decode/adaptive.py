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

**Data shards** (``shards=[device, ...]``, the JAX package's ``mesh=``;
``cli/test.py -dp``): lines are independent, so a batch splits into
``len(shards)`` row shards, each searched on its own device with its own
LM replica from its own host thread, so that the host-bound searches
overlap. The sizing is the whole batch's (each shard's maxima combined),
groups form within each shard, and an overflow on any shard decodes every
shard again at the escalated context. A batch that the shard count does
not divide raises.

``dense_merge`` picks the search's merge (``beam_lm_device``); None reads
``HCTR_LM_DENSE_MERGE`` (``1``: the dense merge; else the sort merge), as
the JAX driver does.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import torch

from ..ops.topk_logsoftmax import PRUNE
from ..parallel.mesh import canonical, on_shard, shard_rows
from .beam_lm_device import (count_peek_rows, make_count_sizing,
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
                 dense_merge: Optional[bool] = None, prune: float = PRUNE,
                 shards: Optional[Sequence[torch.device]] = None):
        if dense_merge is None:
            dense_merge = os.environ.get("HCTR_LM_DENSE_MERGE", "") == "1"
        self._dense = bool(dense_merge)
        self._clm = clm
        # one LM replica a shard, copied once (shards on one device share)
        self.shards = (None if shards is None
                       else [canonical(d) for d in shards])
        self._clms = ([clm.replica(d) for d in self.shards]
                      if self.shards else [clm])
        self._pool = None
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

    def _maxima(self, cand_idx, n_above) -> List[int]:
        """The batch's sizing scalars, from one copy: the largest greedy
        character count, and for the skip search the largest end step,
        segment count and count above prune, then the ladder's bound
        (a minimum)."""
        if not self.skip:
            return [self._greedy_chars(cand_idx)]
        if self._sizing is None:
            kw = dict(unknown_id=self.unknown_id, run_max=self.run_max)
            self._sizing = (make_count_sizing(**kw) if self._ladder_ctx
                            else make_count_stats(**kw))
        args = ((cand_idx, n_above, self._ladder_ctx)
                if self._ladder_ctx else (cand_idx, n_above))
        return [int(v) for v in self._sizing(*args).tolist()]

    def _size(self, maxima: List[int], T: int) -> None:
        """Size the context, and for the skip search the segment budget,
        the peek rows and the ladder, from ``_maxima``."""
        chars_max = maxima[0]
        if not self._ctx_pinned:
            self._ctx = self._auto_ctx(chars_max)
        elif chars_max + 2 > self._ctx:
            raise RuntimeError(
                f"lm_ctx={self._ctx} cannot hold a ~{chars_max}-char line; "
                f"raise --lm-ctx or use 0 (auto)")
        if not self.skip:
            return
        _, _, seg_max, na_max, *ladder_raw = maxima
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

    def search(self, group: int, clm=None, **extra):
        """The search at the current sizing, over ``clm`` (default: the
        LM given; ``extra``: e.g. a selection hook)."""
        clm = self._clm if clm is None else clm
        kw = dict(lm_ctx=self._ctx, group_size=group,
                  dense_merge=self._dense, **self._kw, **extra)
        if not self.skip:
            return make_lm_beam_search(clm, self._c2l, self._l2c,
                                       skip_search=False, **kw)
        return make_lm_beam_search(
            clm, self._c2l, self._l2c, skip_search=True,
            seg_budget=self._budget, peek_rows=self._peek or None,
            ctx_ladder=((self._ladder_k, self._ladder_ctx)
                        if self._ladder_k else None),
            fused_commit=self._fused, **kw)

    # ------------------------------------------------------------ decode
    def decode(self, cand_vals, cand_idx, logits, logz, blank_lp=None,
               n_above=None):
        """Size the search from the batch, run it and check its overflow
        flag, escalating the context and decoding again if it fired.
        Device tensors in, ``(prefixes, lengths)`` out. With shards the
        batch's rows go to the shards (each moved to its device) and the
        results come back in row order on the batch's device."""
        args = (cand_vals, cand_idx, logits, logz, blank_lp, n_above)
        if self.shards is None:
            return self.decode_shards([args])[0]
        B, n = cand_vals.shape[0], len(self.shards)
        if B % n:
            raise ValueError(
                f"batch {B} not divisible by the {n} data shards: pad the "
                f"batch or drop the shards")
        parts = [tuple(None if a is None else
                       shard_rows(a, n, i).to(self.shards[i])
                       for a in args) for i in range(n)]
        outs = self.decode_shards(parts)
        return tuple(torch.cat([o[j].to(cand_vals.device) for o in outs])
                     for j in range(2))

    def decode_shards(self, parts: list) -> list:
        """Decode row shards already on their shards' devices (``parts[i]``
        the ``decode`` arguments of shard ``i``, every shard as many rows):
        sized as their whole batch, searched from one thread a shard.
        Returns each shard's ``(prefixes, lengths)``."""
        maxima = [self._maxima(p[1], p[5]) for p in parts]
        whole = [max(col) for col in zip(*maxima)]
        if len(whole) > 4:                   # the ladder bound is a minimum
            whole[4] = min(m[4] for m in maxima)
        B, T = parts[0][0].shape[:2]
        self._size(whole, int(T))
        self.last_group = pick_group_size(B, self.group_size)
        while True:
            outs = self._map(self._search_shard, list(enumerate(parts)))
            if not any(ovf for _, _, ovf in outs):
                return [(p, l) for p, l, _ in outs]
            if self._ctx_pinned:
                raise RuntimeError(
                    f"LM KV cache overflowed at pinned lm_ctx={self._ctx}; "
                    f"raise --lm-ctx or use 0 (auto)")
            self._ctx = self._escalated_ctx()

    def _search_shard(self, item):
        i, (cand_vals, cand_idx, logits, logz, blank_lp, n_above) = item
        args = (cand_vals, cand_idx, logits, logz)
        if self.skip:
            args += (blank_lp, n_above)
        clm = self._clms[i]
        shard = (on_shard(i, clm.device) if self.shards is not None
                 else contextlib.nullcontext())
        with shard, torch.inference_mode():
            prefixes, lengths, ovf = self.search(self.last_group, clm)(*args)
            return prefixes, lengths, bool(ovf.any())

    def _map(self, fn, items: list) -> list:
        """``fn`` over ``items``, one host thread each when there are
        several."""
        if len(items) == 1:
            return [fn(items[0])]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(len(items),
                                            thread_name_prefix="lm-shard")
        return list(self._pool.map(fn, items))
