"""Batched CTC prefix beam search on the device (no LM).

PyTorch port of the JAX package's ``decode/beam_device.py:91-345``:

  * beams are fixed-size tensors: prefixes ``(B, BM, L)``, lengths, blank
    and non-blank log-masses ``pb/pnb`` and a two-lane int32 rolling prefix
    hash ``h1/h2`` ``(B, BM)``; the hash arithmetic wraps at 32 bits as
    XLA's int32 does;
  * each frame enumerates ``BM * K`` extend/stay rows plus ``BM`` repeat
    rows, merges rows of equal hash and keeps the best ``BM`` groups. The
    merge (``merge_rows``, which the LM search shares) is the dense one
    by default, as ``dense_merge_default()`` is in the JAX package: an
    all-pairs equality matrix, group representative = lowest row index,
    group log-sum-exp by max + exp-sum. ``HCTR_DENSE_MERGE=0`` picks the
    sort merge: a stable sort on the key pair, payloads by gather, segment
    starts and a segmented logaddexp; the two differ only in the low bits
    of the merged masses;
  * the best-``BM`` selection orders as ``lax.top_k`` does: descending,
    ties to the lower index (a stable descending sort, not ``torch.topk``);
  * each sample searches up to its last greedy character + 4 frames; the
    frame loop stops at the batch's largest such end, which leaves results
    unchanged since later frames are masked anyway.
"""

from __future__ import annotations

import os

import torch

from ..ops.topk_logsoftmax import topk_logsoftmax

NEG_INF = -1e30          # avoids -inf - -inf = nan in masked math
_DEAD = NEG_INF * 0.5

# Rolling-hash constants (two independent 32-bit lanes ~ one 64-bit key).
_H1_MUL, _H2_MUL = 1000003, 998244353
_H2_CMUL = 2654435761 % 2147483647
_H1_SEED, _H2_SEED = 17, 29
_DEAD_KEY = 0x7FFFFFF0


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _hash_extend(h1, h2, c):
    c = c.long()
    return (_wrap32(h1.long() * _H1_MUL + c + 1),
            _wrap32(h2.long() * _H2_MUL + c * _H2_CMUL + 7))


def _logaddexp(a, b):
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    out = mx + torch.log1p(torch.exp(mn - mx))
    return torch.where(mx <= _DEAD, NEG_INF, out)


def _sort_rows(kh1: torch.Tensor, kh2: torch.Tensor) -> torch.Tensor:
    """Per line (last axis), the row order of a stable sort by the key pair
    ``(kh1, kh2)``, ties in row order: the JAX package's ``lax.sort`` of
    ``(kh1, kh2, iota)`` with two keys, as one int64 key."""
    key = kh1.long() * 2 ** 32 + (kh2.long() + 2 ** 31)
    return torch.sort(key, dim=-1, stable=True).indices


def _segment_logaddexp_sorted(vals: torch.Tensor,
                              seg_start: torch.Tensor) -> torch.Tensor:
    """Segmented logaddexp over key-sorted rows (last axis; ``seg_start``
    marks each segment's first row). Every row gets its whole segment's
    total, so segment-start rows carry what the JAX package's reverse
    associative scan gives them (``decode/beam_device.py:66``); other rows
    are never read.

    Deterministic: the segment max and the prefix-sum bounds are order-free
    reductions, and the exp-sums are f64 prefix sums whose differences lose
    nothing at these row counts (no float atomics)."""
    seg = seg_start.long().cumsum(-1) - 1
    mx = torch.full_like(vals, NEG_INF).scatter_reduce(
        -1, seg, vals, "amax").gather(-1, seg)
    c = torch.exp((vals - mx).double()).cumsum(-1)
    before = torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], -1)
    top = torch.zeros_like(c).scatter_reduce(-1, seg, c, "amax")
    base = torch.zeros_like(c).scatter_reduce(-1, seg, before, "amin",
                                              include_self=False)
    s = (top.gather(-1, seg) - base.gather(-1, seg)).log().float()
    return torch.where(mx <= _DEAD, NEG_INF, mx + s)


def merge_rows(kh1, kh2, row_pb, row_pnb, row_score, row_dead, earlier,
               dense: bool):
    """Merge a frame's rows of equal key ``(kh1, kh2)`` (``(G, n)`` each;
    ``earlier (n, n)``: row j < row i). Returns ``(pb_m, pnb_m, total,
    order)`` in the merge's own row order: ``total`` is the group's
    ``logaddexp(pb, pnb) + row_score`` at one row a group (the lowest
    original row: the dense merge's representative, the sort merge's
    segment start) and ``NEG_INF`` elsewhere; ``order[g, j]`` is the
    original row at position ``j`` (None for the dense merge, whose order
    is the original one)."""
    if dense:
        eq = ((kh1[:, :, None] == kh1[:, None, :])
              & (kh2[:, :, None] == kh2[:, None, :]))            # (G, n, n)
        is_first = ~(eq & earlier).any(-1)

        def group_lse(x):
            xs = x[:, None, :]
            mx = torch.where(eq, xs, NEG_INF).amax(-1)
            s = torch.where(eq, torch.exp(xs - mx[..., None]), 0.0).sum(-1)
            return torch.where(mx <= _DEAD, NEG_INF, mx + torch.log(s))

        pb_m, pnb_m = group_lse(row_pb), group_lse(row_pnb)
        total = _logaddexp(pb_m, pnb_m) + row_score
        return (pb_m, pnb_m, torch.where(is_first & ~row_dead, total,
                                         NEG_INF), None)
    order = _sort_rows(kh1, kh2)
    kh1_s, kh2_s = kh1.gather(1, order), kh2.gather(1, order)
    seg_start = torch.cat(
        [torch.ones_like(kh1_s[:, :1], dtype=torch.bool),
         (kh1_s[:, 1:] != kh1_s[:, :-1]) | (kh2_s[:, 1:] != kh2_s[:, :-1])],
        1)
    pb_m = _segment_logaddexp_sorted(row_pb.gather(1, order), seg_start)
    pnb_m = _segment_logaddexp_sorted(row_pnb.gather(1, order), seg_start)
    total = _logaddexp(pb_m, pnb_m) + row_score.gather(1, order)
    return (pb_m, pnb_m, torch.where(seg_start & ~row_dead.gather(1, order),
                                     total, NEG_INF), order)


def dense_merge_default() -> bool:
    """The plain beam's merge: dense unless ``HCTR_DENSE_MERGE`` is ``0``
    or empty (the JAX package's ``dense_merge_default``)."""
    return os.environ.get("HCTR_DENSE_MERGE", "1") not in ("0", "")


def _end_steps(first: torch.Tensor, unknown_id: int, blank_id: int,
               suffix_frames: int) -> torch.Tensor:
    """Per sample: the frame after the last greedy character, + suffix."""
    B, T = first.shape
    prev = torch.cat([torch.full_like(first[:, :1], -1), first[:, :-1]], 1)
    keep = (first != blank_id) & (first != unknown_id) & (first != prev)
    t = torch.arange(T, device=first.device)
    last = torch.where(keep, t, -1).amax(dim=1)
    return torch.where(keep.any(dim=1),
                       torch.clamp(last + suffix_frames, max=T), 0)


def beam_search_from_topk(cand_vals: torch.Tensor, cand_idx: torch.Tensor, *,
                          beam_size: int = 10, unknown_id: int,
                          blank_id: int = 0, len_bonus: float = 0.0,
                          suffix_frames: int = 4, dense_merge: bool = True):
    """Prefix beam search over per-frame top-K candidates (``dense_merge``:
    the merge, see ``merge_rows``).

    ``cand_vals`` ``(B, T, K)`` f32 log-probs (descending) and ``cand_idx``
    ``(B, T, K)`` int32 classes -> ``(prefixes (B, T) int32, lengths (B,)
    int32)`` of each sample's best beam."""
    B, T, K = cand_vals.shape
    dev = cand_vals.device
    BM, L = beam_size, T
    n_rows = BM * K + BM
    cand_idx = cand_idx.to(torch.int32)
    end_step = _end_steps(cand_idx[:, :, 0], unknown_id, blank_id,
                          suffix_frames)

    prefixes = torch.zeros((B, BM, L), dtype=torch.int32, device=dev)
    lengths = torch.zeros((B, BM), dtype=torch.int32, device=dev)
    pb = torch.full((B, BM), NEG_INF, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((B, BM), NEG_INF, device=dev)
    h1 = torch.full((B, BM), _H1_SEED, dtype=torch.int32, device=dev)
    h2 = torch.full((B, BM), _H2_SEED, dtype=torch.int32, device=dev)

    bi = torch.arange(BM, device=dev).repeat_interleave(K)      # (BM*K,)
    row_parent = torch.cat([bi, torch.arange(BM, device=dev)])   # (n_rows,)
    row_ids = torch.arange(n_rows, dtype=torch.int32, device=dev)
    earlier = row_ids[None, :] < row_ids[:, None]                # j < i
    no_rep = torch.zeros((B, BM), dtype=torch.bool, device=dev)
    neg_rows = torch.full((B, BM), NEG_INF, device=dev)

    for t in range(int(end_step.max()) if B else 0):
        active = t < end_step                                    # (B,)
        cand_p = cand_vals[:, t]                                 # (B, K)
        cand = cand_idx[:, t]

        prob = _logaddexp(pb, pnb)                               # (B, BM)
        last = torch.gather(prefixes, 2,
                            (lengths - 1).clamp(min=0).long()[..., None])
        tail = torch.where(lengths > 0, last[..., 0], -1)

        # ---- rows A: extend (or blank stay) per (beam, candidate)
        cj = cand.repeat(1, BM)                                  # (B, BM*K)
        pj = cand_p.repeat(1, BM)
        prob_b, pb_b = prob[:, bi], pb[:, bi]
        is_blank = cj == blank_id
        is_unk = cj >= unknown_id
        is_rep = cj == tail[:, bi]
        beam_dead = prob_b <= _DEAD
        a_ext = ~is_blank & ~is_unk & ~beam_dead
        a_pb = torch.where(is_blank & ~beam_dead & ~is_unk, prob_b + pj,
                           NEG_INF)
        a_pnb = torch.where(a_ext, torch.where(is_rep, pb_b + pj,
                                               prob_b + pj), NEG_INF)
        # ---- rows B: one repeat-merge row per beam (top-K are distinct)
        rep_mask = (is_rep & ~is_blank & ~is_unk).view(B, BM, K)
        rep_p = torch.where(rep_mask, pj.view(B, BM, K), 0.0).sum(-1)
        b_pnb = torch.where(rep_mask.any(-1) & (prob > _DEAD), pnb + rep_p,
                            NEG_INF)

        row_char = torch.cat([cj, tail], 1)                      # (B, n_rows)
        row_is_ext = torch.cat([a_ext, no_rep], 1)
        row_pb = torch.cat([a_pb, neg_rows], 1)
        row_pnb = torch.cat([a_pnb, b_pnb], 1)

        # ---- keys; dead rows get a unique sink key so they never merge
        ph1, ph2 = h1[:, row_parent], h2[:, row_parent]
        eh1, eh2 = _hash_extend(ph1, ph2, row_char)
        row_dead = (row_pb <= _DEAD) & (row_pnb <= _DEAD)
        kh1 = torch.where(row_dead, _DEAD_KEY,
                          torch.where(row_is_ext, eh1, ph1))
        kh2 = torch.where(row_dead, row_ids,
                          torch.where(row_is_ext, eh2, ph2))
        row_len = lengths[:, row_parent] + row_is_ext.to(torch.int32)

        # ---- merge rows of equal hash
        pb_m, pnb_m, total, order = merge_rows(
            kh1, kh2, row_pb, row_pnb, row_len.float() * len_bonus,
            row_dead, earlier, dense_merge)

        # ---- best BM groups, ordered as lax.top_k
        top = torch.sort(total, dim=1, descending=True,
                         stable=True).indices[:, :BM]            # (B, BM)
        pick = top if order is None else order.gather(1, top)
        sel_alive = torch.gather(total, 1, top) > _DEAD
        sel_parent = row_parent[pick]
        sel_ext = torch.gather(row_is_ext, 1, pick)
        sel_char = torch.gather(row_char, 1, pick)

        new_prefixes = torch.gather(
            prefixes, 1, sel_parent[..., None].expand(B, BM, L))
        par_len = torch.gather(lengths, 1, sel_parent)
        app_pos = par_len.clamp(max=L - 1).long()[..., None]
        cur = torch.gather(new_prefixes, 2, app_pos)[..., 0]
        new_prefixes.scatter_(
            2, app_pos, torch.where(sel_ext, sel_char, cur)[..., None])
        par_h1 = torch.gather(h1, 1, sel_parent)
        par_h2 = torch.gather(h2, 1, sel_parent)
        nh1, nh2 = _hash_extend(par_h1, par_h2, sel_char)

        act = active[:, None]
        prefixes = torch.where(act[..., None], new_prefixes, prefixes)
        lengths = torch.where(act, par_len + sel_ext.to(torch.int32), lengths)
        pb = torch.where(act, torch.where(
            sel_alive, torch.gather(pb_m, 1, top), NEG_INF), pb)
        pnb = torch.where(act, torch.where(
            sel_alive, torch.gather(pnb_m, 1, top), NEG_INF), pnb)
        h1 = torch.where(act, torch.where(sel_ext, nh1, par_h1), h1)
        h2 = torch.where(act, torch.where(sel_ext, nh2, par_h2), h2)

    # best beam = index 0 (descending order); with no step, the empty prefix
    return prefixes[:, 0], lengths[:, 0]


def beam_search_fused(logits: torch.Tensor, *, beam_size: int = 10,
                      depth: int = 10, unknown_id: int, blank_id: int = 0,
                      len_bonus: float = 0.0, suffix_frames: int = 4,
                      dense_merge: bool = True):
    """Serving entry: raw ``(B, T, D)`` f32 logits -> the fused log-softmax +
    top-K (kernel K1 on the card) -> the prefix beam search. The ``(B, T,
    D)`` log-prob tensor is never materialised. Callers pass
    ``dense_merge=dense_merge_default()`` to honour ``HCTR_DENSE_MERGE``."""
    cand_vals, cand_idx, _blank, _n_above = topk_logsoftmax(logits, k=depth)
    return beam_search_from_topk(
        cand_vals, cand_idx, beam_size=beam_size, unknown_id=unknown_id,
        blank_id=blank_id, len_bonus=len_bonus, suffix_frames=suffix_frames,
        dense_merge=dense_merge)
