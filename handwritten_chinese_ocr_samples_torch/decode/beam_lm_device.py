"""LM-fused CTC beam search on the device, full per-frame search (the JAX
package's ``decode/beam_lm_device.py``, ``skip_search=False``).

Every frame up to a line's last greedy character + ``suffix_frames``
(``end_step``) is searched:

  * visual candidates: the frame's top-K CTC classes (kernel K1); linguistic
    candidates: each beam's top-M next characters from its LM distribution,
    whose CTC log-prob is gathered from the raw logits;
  * prefix extension with pb/pnb bookkeeping, rows of equal prefix merged by
    a stable sort on a two-lane prefix hash and a segmented logaddexp;
  * score ``(lm(prefix) + lm(suffix)) * lm_panelty + len * len_bonus``: the
    prefix part is kept incrementally, the suffix part (the next greedy
    characters, which change with the frame) comes from a grouped
    teacher-forced peek over each beam's KV cache: per layer one cache
    attention (kernel K2) plus the small own-row part, and one streaming
    log-sum-exp over the vocabulary (kernel K3);
  * committing the selected extensions reorders the KV cache by parent and
    writes each new token's k/v, which the peek already computed (kernel
    K4): no further LM forward.

Layout: the JAX package ``vmap``s G lines through one scan; here the G lines
of a group share the batch axes, ``(G, BM, ...)`` for the search state and
``G * BM`` beams for the LM cache, so a cache parent index is global
(``g * BM + parent``). Groups run one after another. The frame loop stops at
the group's largest ``end_step``: later frames are no-ops in the JAX program,
so results are unchanged.

Two id spaces: CTC classes (blank 0, characters 1..N, unknown N+1) and LM
tokens (specials 0..3, characters 4..); ``make_id_tables`` maps between them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..lm.cached import CachedLM, LMCache
from ..ops import logits_lse, peek_attention
from .beam_device import (_DEAD, _DEAD_KEY, _H1_SEED, _H2_SEED, NEG_INF,
                          _end_steps, _hash_extend, _logaddexp,
                          _segment_logaddexp_sorted, _sort_rows)

_SKIP_SLICE = ("not ported yet: the skip search (-ss) with its run phase, "
               "segment budget, peek-row compaction, context ladder and "
               "fused commit (ROADMAP.md queue 1, item 2)")
_DENSE = ("not ported yet: the dense LM merge (ROADMAP.md queue 1, item 2); "
          "the port's LM search uses the sort merge")


def make_id_tables(codec, tokenizer):
    """codec <-> LM id lookup tables (int32 numpy; -1 = no mapping)."""
    D = codec.num_classes
    V = tokenizer.vocab_size
    codec2lm = np.full((D,), tokenizer.unk_index, dtype=np.int32)
    lm2codec = np.full((V,), -1, dtype=np.int32)
    # the JAX codec's char -> id dict: the last of repeated characters wins
    for ch, cid in {c: i + 1 for i, c in enumerate(codec.chars_list)}.items():
        lid = tokenizer.indices.get(ch)
        if lid is not None:
            codec2lm[cid] = lid
            lm2codec[lid] = cid
    return codec2lm, lm2codec


class LMBeamState(NamedTuple):
    prefixes: torch.Tensor      # (G, BM, L) codec ids
    lengths: torch.Tensor       # (G, BM)
    pb: torch.Tensor            # (G, BM)
    pnb: torch.Tensor           # (G, BM)
    h1: torch.Tensor            # (G, BM)
    h2: torch.Tensor            # (G, BM)
    prefix_score: torch.Tensor  # (G, BM) summed log-probs of the prefix
    next_logp: torch.Tensor     # (G, BM, V) next-token log-probs
    cache: LMCache              # G * BM beams
    ovf: torch.Tensor           # (G,) a KV write would have passed lm_ctx


def _grouped_peek(clm: CachedLM, cache: LMCache, tokens: torch.Tensor,
                  n_tokens: torch.Tensor, next_logp: torch.Tensor, *,
                  full_kv: bool = False, want_last: bool = False,
                  extra_kv=None, pos_offset=None):
    """Score token continuations grouped by parent beam (peek mode).

    ``tokens (NB, R, S1)``: LM-token rows continuing each beam's prefix;
    ``n_tokens (NB, R)`` valid counts; ``next_logp (NB, V)`` scores each
    row's first token. The rows are teacher-forced, so all positions run in
    one causal forward: position s attends the beam's cache plus row tokens
    0..s. The last position's forward is never needed (its logits would
    score a token past the row), so the layers run on ``Sc = S1 - 1``.

    Returns the summed log-probs ``(NB, R)``, the position-0 log-probs
    ``(NB, R, V)`` (the extended beam's next distribution) and each row's
    first-token k/v ``(layers, NB, R, H, Dh)``, which is what committing the
    extension writes into the cache."""
    if full_kv or want_last or extra_kv is not None or pos_offset is not None:
        raise NotImplementedError(_SKIP_SLICE)
    NB, R, S1 = tokens.shape
    H, Dh = clm.n_heads, clm.d_head
    tokens = tokens.long()
    total = torch.where(n_tokens > 0, next_logp.gather(1, tokens[:, :, 0]),
                        0.0)
    Sc = S1 if S1 == 1 else S1 - 1
    s_ids = torch.arange(Sc, device=tokens.device)
    pos = cache.lengths.long()[:, None, None] + s_ids
    h = clm._embed_token(tokens[:, :, :Sc], pos)            # (NB, R, Sc, d)
    causal = (s_ids[None, :] <= s_ids[:, None])[None, None, :, None, :]
    scale = math.sqrt(Dh)
    k0s, v0s = [], []
    for li in range(clm.n_layers):
        lp = clm.layers[li]
        q, k, v = clm._qkv_proj(clm._ln(h, lp["ln1"]), li)  # (NB,R,Sc,H,Dh)
        k0s.append(k[:, :, 0])
        v0s.append(v[:, :, 0])
        qs = (q / scale).to(q.dtype)
        # cache part: every position sees the beam's whole valid prefix
        o1, m1, l1 = peek_attention.peek_cache_attention(
            qs.reshape(NB, R * Sc, H, Dh), cache.k[li], cache.v[li],
            cache.lengths)
        o1 = o1.view(NB, R, Sc, H, Dh)
        m1 = m1.view(NB, R, Sc, H)
        l1 = l1.view(NB, R, Sc, H)
        # own-row causal part: Sc keys, plain
        sc = torch.einsum("brshk,brthk->brsht", qs.float(), k.float())
        sc = torch.where(causal, sc, NEG_INF)
        m2 = sc.amax(-1)
        p2 = torch.where(causal, torch.exp(sc - m2[..., None]), 0.0)
        o2 = torch.einsum("brsht,brthk->brshk", p2.to(v.dtype).float(),
                          v.float())
        o = peek_attention.merge_partials(o1, m1, l1, o2, m2, p2.sum(-1))
        h = h + clm._attn_out(o.to(h.dtype), li)
        h = h + clm._ff(clm._ln(h, lp["ln2"]), li)

    xs = clm._ln(h, clm.ln_f)                                # (NB, R, Sc, d)
    logits0 = xs[:, :, 0].float() @ clm.emb32.T              # (NB, R, V)
    logp0 = torch.log_softmax(logits0, dim=-1)
    if S1 > 1:
        # token 1 is scored by position 0's materialised row
        c0 = (logits0.gather(-1, tokens[:, :, 1:2])[..., 0]
              - torch.logsumexp(logits0, dim=-1))
        if Sc > 1:
            # positions 1..Sc-1 score tokens 2..S1-1: a gathered logit and
            # a streamed log-sum-exp (kernel K3 on the card)
            tgt, lse = logits_lse.target_lse(xs[:, :, 1:].contiguous(),
                                             clm.emb, tokens[:, :, 2:S1])
            contrib = torch.cat([c0[..., None], tgt - lse], dim=-1)
        else:
            contrib = c0[..., None]
        s_valid = (torch.arange(1, S1, device=tokens.device)
                   < n_tokens[..., None])
        total = total + torch.where(s_valid, contrib, 0.0).sum(-1)
    return total, logp0, torch.stack(k0s), torch.stack(v0s)


def make_lm_beam_search(
    clm: CachedLM,
    codec2lm: np.ndarray,
    lm2codec: np.ndarray,
    *,
    beam_size: int = 10,
    depth: int = 10,
    unknown_id: int,
    blank_id: int = 0,
    lm_panelty: float = 0.8,
    len_bonus: float = 4.8,
    suffix_frames: int = 4,
    lm_ctx: int = 256,
    use_lm_pred: bool = True,
    skip_search: bool = False,
    group_size: int = 1,
    peek_rows: int | None = None,
    return_overflow: bool = False,
    ctx_ladder=None,
    fused_commit: bool = False,
    dense_merge: bool = False,
    on_select=None,
):
    """Build the LM-fused full search (the JAX package's signature, less
    the knobs that size only the skip search).

    Returned fn: ``fn(cand_vals (B,T,K), cand_idx (B,T,K), logits (B,T,D),
    logz (B,T)) -> (prefixes (B,T), lengths (B,)[, overflow (B,)])``.

    ``group_size=G`` searches G lines together (B must be divisible by G);
    ``return_overflow`` appends a per-line flag set when a beam's committed
    tokens would have written past ``lm_ctx`` (the write is dropped). ``on_select(t, totals, parents, chars)``, if given,
    sees each frame's selection, ``(G, BM)`` tensors of a group in rank
    order (for comparing two runs). The skip search and its knobs
    (``skip_search``, ``peek_rows``, ``ctx_ladder``, ``fused_commit``) and
    ``dense_merge`` raise ``NotImplementedError``."""
    if skip_search or peek_rows is not None or ctx_ladder is not None \
            or fused_commit:
        raise NotImplementedError(_SKIP_SLICE)
    if dense_merge:
        raise NotImplementedError(_DENSE)
    BM, K = beam_size, depth
    M = depth if use_lm_pred else 0      # LM proposals per beam
    C = K + M
    S = suffix_frames
    S1 = S + 1
    sos = 0  # tokenizer.sos_index
    dev = clm.device
    c2l = torch.as_tensor(codec2lm, dtype=torch.long, device=dev)
    l2c = torch.as_tensor(lm2codec, dtype=torch.long, device=dev)
    n_rows = BM * C + BM
    bi = torch.arange(BM, device=dev).repeat_interleave(C)       # (BM*C,)
    row_parent = torch.cat([bi, torch.arange(BM, device=dev)])   # (n_rows,)
    row_ids = torch.arange(n_rows, dtype=torch.int32, device=dev)
    slot_ext = 1 + torch.arange(C, device=dev).repeat(BM)        # (BM*C,)

    def decode_group(cand_vals, cand_idx, logits, logz):
        G, T, _ = cand_vals.shape
        L = T
        NB = G * BM
        gi = torch.arange(G, device=dev)[:, None]
        cand_idx = cand_idx.long()
        logz = logz.float()

        # ---- greedy top line, end step, per-frame greedy suffixes
        arg = cand_idx[:, :, 0]
        end_step = _end_steps(arg, unknown_id, blank_id, S)
        prev = torch.cat([torch.full_like(arg[:, :1], -1), arg[:, :-1]], 1)
        keep = (arg != blank_id) & (arg != unknown_id) & (arg != prev)
        rank = keep.long().cumsum(1)                   # kept frames <= t
        n_kept = keep.sum(1)
        kept = torch.zeros((G, T + 1), dtype=torch.long, device=dev)
        kept.scatter_(1, torch.where(keep, rank - 1, T), arg)
        sidx = rank[:, :, None] + torch.arange(S, device=dev)    # (G, T, S)
        s_ok = sidx < n_kept[:, None, None]
        suffix_codec = torch.where(
            s_ok, kept.gather(1, sidx.clamp(max=T - 1).view(G, -1))
            .view(G, T, S), 0)
        suffix_valid = s_ok.sum(-1)

        # ---- init: every beam shares the sos-primed cache
        cache = clm.init_cache(NB, lm_ctx)
        logits0, cache = clm.step(
            cache, torch.full((NB,), sos, dtype=torch.long, device=dev))
        V = logits0.shape[-1]
        pb = torch.full((G, BM), NEG_INF, device=dev)
        pb[:, 0] = 0.0
        state = LMBeamState(
            prefixes=torch.zeros((G, BM, L), dtype=torch.long, device=dev),
            lengths=torch.zeros((G, BM), dtype=torch.long, device=dev),
            pb=pb,
            pnb=torch.full((G, BM), NEG_INF, device=dev),
            h1=torch.full((G, BM), _H1_SEED, dtype=torch.int32, device=dev),
            h2=torch.full((G, BM), _H2_SEED, dtype=torch.int32, device=dev),
            prefix_score=torch.zeros((G, BM), device=dev),
            next_logp=torch.log_softmax(logits0, -1).view(G, BM, V),
            cache=cache,
            ovf=torch.zeros((G,), dtype=torch.bool, device=dev))

        def full_step(st: LMBeamState, t: int) -> LMBeamState:
            active = (t < end_step)[:, None]                        # (G, 1)
            vis_idx = cand_idx[:, t][:, None].expand(G, BM, K)
            vis_p = cand_vals[:, t].float()[:, None].expand(G, BM, K)
            # ---- linguistic candidates per beam
            if M > 0:
                lm_top = torch.sort(st.next_logp, dim=-1, descending=True,
                                    stable=True).indices[..., :M]
                ling = l2c[lm_top]                                  # (G,BM,M)
                # specials/unmapped and empty prefixes -> unknown (skipped)
                ling = torch.where((ling >= 0) & (st.lengths[..., None] > 0),
                                   ling, unknown_id)
                ling_p = (logits[:, t].float().gather(
                    1, ling.clamp(0, unknown_id).view(G, -1)).view(G, BM, M)
                    - logz[:, t][:, None, None])
                cj = torch.cat([vis_idx, ling], -1).reshape(G, BM * C)
                pj = torch.cat([vis_p, ling_p], -1).reshape(G, BM * C)
            else:
                cj = vis_idx.reshape(G, BM * C)
                pj = vis_p.reshape(G, BM * C)

            prob = _logaddexp(st.pb, st.pnb)
            tail = torch.where(
                st.lengths > 0,
                st.prefixes.gather(2, (st.lengths - 1).clamp(min=0)[..., None])
                [..., 0], -1)
            prob_b, pb_b = prob[:, bi], st.pb[:, bi]
            is_blank = cj == blank_id
            is_unk = cj >= unknown_id
            is_rep = cj == tail[:, bi]
            beam_dead = prob_b <= _DEAD
            a_ext = ~is_blank & ~is_unk & ~beam_dead
            a_pb = torch.where(is_blank & ~beam_dead, prob_b + pj, NEG_INF)
            a_pnb = torch.where(a_ext, torch.where(is_rep, pb_b + pj,
                                                   prob_b + pj), NEG_INF)
            # repeat-merge row per beam; a tail char proposed twice (visual
            # and LM) counts once per occurrence: + log(count)
            rep_mask = (is_rep & ~is_blank & ~is_unk).view(G, BM, C)
            rep_count = rep_mask.sum(-1)
            rep_p = torch.where(rep_mask, pj.view(G, BM, C), NEG_INF).amax(-1)
            b_pnb = torch.where(
                (rep_count > 0) & (prob > _DEAD),
                st.pnb + rep_p + torch.log(rep_count.clamp(min=1).float()),
                NEG_INF)

            row_char = torch.cat([cj, tail], 1)                  # (G, n_rows)
            row_is_ext = torch.cat(
                [a_ext, torch.zeros((G, BM), dtype=torch.bool, device=dev)], 1)
            row_pb = torch.cat([a_pb, torch.full((G, BM), NEG_INF,
                                                 device=dev)], 1)
            row_pnb = torch.cat([a_pnb, b_pnb], 1)
            ph1, ph2 = st.h1[:, row_parent], st.h2[:, row_parent]
            eh1, eh2 = _hash_extend(ph1, ph2, row_char)
            row_len = st.lengths[:, row_parent] + row_is_ext.long()
            row_dead = (row_pb <= _DEAD) & (row_pnb <= _DEAD)
            kh1 = torch.where(row_dead, _DEAD_KEY,
                              torch.where(row_is_ext, eh1, ph1))
            kh2 = torch.where(row_dead, row_ids,
                              torch.where(row_is_ext, eh2, ph2))

            # ---- LM peek table: slot 0 = stay (suffix only), 1.. = [c] +
            # suffix for each candidate
            suf_lm = c2l[suffix_codec[:, t]]                          # (G, S)
            n_suf = suffix_valid[:, t]                                # (G,)
            stay = torch.cat([suf_lm, torch.zeros_like(suf_lm[:, :1])], 1)
            ext = torch.cat(
                [c2l[cj.clamp(0, unknown_id)][..., None],
                 suf_lm[:, None, :].expand(G, BM * C, S)], -1)
            tokens = torch.cat(
                [stay[:, None, None, :].expand(G, BM, 1, S1),
                 ext.view(G, BM, C, S1)], 2)                  # (G,BM,R,S1)
            n_tok = torch.cat(
                [n_suf[:, None, None].expand(G, BM, 1),
                 (1 + n_suf)[:, None, None].expand(G, BM, C)], 2)
            R = 1 + C
            peek_scores, peek_logp0, peek_k0, peek_v0 = _grouped_peek(
                clm, st.cache, tokens.reshape(NB, R, S1),
                n_tok.reshape(NB, R), st.next_logp.view(NB, V))
            slot = torch.where(
                row_is_ext,
                torch.cat([slot_ext.expand(G, -1),
                           torch.zeros((G, BM), dtype=torch.long,
                                       device=dev)], 1), 0)
            row_lm = (st.prefix_score[:, row_parent]
                      + peek_scores.view(G, BM, R)[gi, row_parent, slot])
            row_pt = row_lm * lm_panelty + row_len.float() * len_bonus

            # ---- merge: stable sort by (h1, h2, row), segmented logaddexp
            order = _sort_rows(kh1, kh2)
            kh1_s, kh2_s = kh1.gather(1, order), kh2.gather(1, order)
            seg_start = torch.cat(
                [torch.ones((G, 1), dtype=torch.bool, device=dev),
                 (kh1_s[:, 1:] != kh1_s[:, :-1])
                 | (kh2_s[:, 1:] != kh2_s[:, :-1])], 1)
            pb_m = _segment_logaddexp_sorted(row_pb.gather(1, order),
                                             seg_start)
            pnb_m = _segment_logaddexp_sorted(row_pnb.gather(1, order),
                                              seg_start)
            total = _logaddexp(pb_m, pnb_m) + row_pt.gather(1, order)
            total = torch.where(seg_start & ~row_dead.gather(1, order),
                                total, NEG_INF)

            # ---- best BM groups, ordered as lax.top_k (ties: lower index)
            top = torch.sort(total, dim=1, descending=True,
                             stable=True).indices[:, :BM]
            pick = order.gather(1, top)                  # original row ids
            sel_parent = row_parent[pick]                             # (G,BM)
            sel_ext = row_is_ext.gather(1, pick)
            sel_char = row_char.gather(1, pick)
            sel_slot = slot.gather(1, pick)
            sel_alive = total.gather(1, top) > _DEAD
            sel_pb = torch.where(sel_alive, pb_m.gather(1, top), NEG_INF)
            sel_pnb = torch.where(sel_alive, pnb_m.gather(1, top), NEG_INF)
            do_step = sel_ext & sel_alive & active
            if on_select is not None:
                on_select(t, total.gather(1, top), sel_parent,
                          torch.where(sel_ext, sel_char, -1))

            new_prefixes = st.prefixes.gather(
                1, sel_parent[..., None].expand(G, BM, L))
            par_len = st.lengths.gather(1, sel_parent)
            app_pos = par_len.clamp(max=L - 1)[..., None]
            cur = new_prefixes.gather(2, app_pos)[..., 0]
            new_prefixes.scatter_(
                2, app_pos, torch.where(sel_ext, sel_char, cur)[..., None])
            par_h1 = st.h1.gather(1, sel_parent)
            par_h2 = st.h2.gather(1, sel_parent)
            nh1, nh2 = _hash_extend(par_h1, par_h2, sel_char)

            # ---- LM bookkeeping for the survivors
            sel_tok = c2l[sel_char.clamp(0, unknown_id)]
            inc = st.next_logp[gi, sel_parent, sel_tok]
            new_prefix_score = (st.prefix_score.gather(1, sel_parent)
                                + torch.where(sel_ext, inc, 0.0))
            # inactive lines reorder with the identity and write nothing
            reorder = torch.where(active, sel_parent,
                                  torch.arange(BM, device=dev))
            reorder_g = (reorder + gi * BM).view(NB)
            sel_g = (sel_parent + gi * BM).view(NB)
            slot_g = sel_slot.view(NB)
            do_g = do_step.view(NB)
            # the committed step is free: the peek computed the extension
            # token's k/v and next distribution
            Lc = st.cache.k.shape[2]
            glen = st.cache.lengths[reorder_g]
            wpos = torch.where(do_g, glen, Lc).to(torch.int32)
            new_cache = CachedLM.gather_write(
                st.cache, reorder_g.to(torch.int32),
                peek_k0[:, sel_g, slot_g].to(clm.dtype),
                peek_v0[:, sel_g, slot_g].to(clm.dtype), wpos)._replace(
                    lengths=torch.where(do_g, glen + 1, glen))
            new_next_logp = torch.where(
                do_g[:, None], peek_logp0[sel_g, slot_g],
                st.next_logp.view(NB, V)[reorder_g]).view(G, BM, V)
            return LMBeamState(
                prefixes=torch.where(active[..., None], new_prefixes,
                                     st.prefixes),
                lengths=torch.where(active, par_len + sel_ext.long(),
                                    st.lengths),
                pb=torch.where(active, sel_pb, st.pb),
                pnb=torch.where(active, sel_pnb, st.pnb),
                h1=torch.where(active, torch.where(sel_ext, nh1, par_h1),
                               st.h1),
                h2=torch.where(active, torch.where(sel_ext, nh2, par_h2),
                               st.h2),
                prefix_score=torch.where(active, new_prefix_score,
                                         st.prefix_score),
                next_logp=new_next_logp,
                cache=new_cache,
                ovf=st.ovf | (do_step & (glen.view(G, BM) >= Lc)).any(1))

        for t in range(int(end_step.max()) if G else 0):
            state = full_step(state, t)
        return (state.prefixes[:, 0].to(torch.int32),
                state.lengths[:, 0].to(torch.int32), state.ovf)

    def run(cand_vals, cand_idx, logits, logz):
        B = cand_vals.shape[0]
        if cand_vals.shape[-1] != K:
            raise ValueError(f"candidates have depth {cand_vals.shape[-1]}, "
                             f"the search was built for depth={K}")
        G = max(1, min(group_size, B))
        if B % G != 0:
            raise ValueError(f"batch {B} not divisible by group {G}")
        outs = [decode_group(cand_vals[s:s + G], cand_idx[s:s + G],
                             logits[s:s + G], logz[s:s + G])
                for s in range(0, B, G)]
        prefixes, lengths, ovf = (torch.cat(x) for x in zip(*outs))
        return (prefixes, lengths, ovf) if return_overflow else (prefixes,
                                                                 lengths)

    return run

