"""LM-fused CTC beam search on the device (the JAX package's
``decode/beam_lm_device.py``): the full per-frame search and the skip
search.

The full search searches every frame up to a line's last greedy character
+ ``suffix_frames`` (``end_step``):

  * visual candidates: the frame's top-K CTC classes (kernel K1); linguistic
    candidates: each beam's top-M next characters from its LM distribution,
    whose CTC log-prob is gathered from the raw logits;
  * prefix extension with pb/pnb bookkeeping, rows of equal prefix merged by
    a stable sort on a two-lane prefix hash and a segmented logaddexp (or,
    with ``dense_merge``, through an all-pairs equality matrix);
  * score ``(lm(prefix) + lm(suffix)) * lm_panelty + len * len_bonus``: the
    prefix part is kept incrementally, the suffix part (the next greedy
    characters, which change with the frame) comes from a grouped
    teacher-forced peek over each beam's KV cache: per layer one cache
    attention (kernel K2) plus the small own-row part, and one streaming
    log-sum-exp over the vocabulary (kernel K3);
  * committing the selected extensions reorders the KV cache by parent and
    writes each new token's k/v, which the peek already computed (kernel
    K4): no further LM forward.

The skip search (``skip_search=True``, the reference's pruning fast path)
classifies frames by K1's ``n_above``: runs of confident-blank frames fold
into one (logaddexp, +) operator by a segmented associative scan, and the
rest is cut into SEGMENTS, a run of up to ``run_max`` single-survivor
character frames (one teacher-forced LM forward for the whole run, no
search) closed by at most one ambiguous frame (one full search step).

Layout: the JAX package ``vmap``s G lines through one scan; here the G lines
of a group share the batch axes, ``(G, BM, ...)`` for the search state and
``G * BM`` beams for the LM cache, so a cache parent index is global
(``g * BM + parent``). Groups run one after another, and the step loop runs
on the host: the full search stops at the group's largest ``end_step``, the
skip search at the group's segment count, since later steps are no-ops in
the JAX program (the one flag such a no-op can still raise, a peek-row
overflow, is computed for them directly). The skip schedule is built on the
device in closed form from cumulative counts (``_segment_layout``); the host
reads one small summary of it a group.

Two id spaces: CTC classes (blank 0, characters 1..N, unknown N+1) and LM
tokens (specials 0..3, characters 4..); ``make_id_tables`` maps between them.

On a card, and where no ``on_select`` hook watches the steps, the skip
search runs its segment steps over static buffers and replays them from
CUDA graphs (``StepStore``): one graph launch a step in place of the ~1600
kernels the host would launch one at a time. The first group of new shapes,
the CPU and the hook run the same step eagerly on fresh tensors.

Spans (``utils/profiling``, off unless enabled): ``search.group`` a group,
and in the skip search ``search.schedule`` (the schedule's copy to the host
and the list made from it), ``search.segments`` (the whole segment loop)
and ``search.capture`` (``key``: a step's capture into a CUDA graph,
before the loop).
``segment_steps`` counts the skip search's segment steps, a group's at a
time; ``segment_graph_replays`` those replayed from a graph and
``segment_graph_captures`` the graphs captured.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..lm.cached import CachedLM, LMCache
from ..ops import cache_gather, logits_lse, peek_attention
from ..ops.launch_tally import tallying
from ..ops.topk_logsoftmax import PRUNE
from ..parallel.mesh import current_shard
from ..utils.profiling import span
from .beam_device import (_DEAD, _DEAD_KEY, _H1_SEED, _H2_SEED, NEG_INF,
                          _end_steps, _hash_extend, _logaddexp, merge_rows)


segment_steps = 0           # segment steps the skip search has run
segment_graph_replays = 0   # of those, replayed from a CUDA graph
segment_graph_captures = 0  # segment steps captured into CUDA graphs


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


def _run_write(base, n_com, Lc, k_tok, v_tok):
    """Multi-token run write: position t of beam b receives run token r iff
    ``t - base[b] == r < n_com[b]``. ``k_tok/v_tok (layers, B, RM, H, Dh)``
    in the cache dtype. Returns ``(k_rows, v_rows, written (B, Lc))``, the
    rows laid out on the cache's positions; positions past ``Lc`` never
    match."""
    RM = k_tok.shape[2]
    roff = (torch.arange(Lc, device=base.device)[None, :]
            - base.long()[:, None])                               # (B, Lc)
    written = (roff >= 0) & (roff < n_com.long()[:, None])
    r = roff.clamp(0, RM - 1)
    b = torch.arange(k_tok.shape[1], device=base.device)[:, None]
    return k_tok[:, b, r], v_tok[:, b, r], written


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
    """Score token continuations grouped by parent beam.

    ``tokens (NB, R, S1)``: LM-token rows continuing each beam's prefix;
    ``n_tokens (NB, R)`` valid counts; ``next_logp (NB, V)`` scores each
    row's first token. The rows are teacher-forced, so all positions run in
    one causal forward: position s attends the beam's cache plus row tokens
    0..s. In peek mode the last position's forward is never needed (its
    logits would score a token past the row), so the layers run on
    ``Sc = S1 - 1``; ``want_last`` needs every position.

    Returns the summed log-probs ``(NB, R)``, the position-0 log-probs
    ``(NB, R, V)`` (the extended beam's next distribution) and each row's
    first-token k/v ``(layers, NB, R, H, Dh)``, which is what committing the
    extension writes into the cache; with ``full_kv`` the k/v of every
    position ``(layers, NB, R, Sc, H, Dh)``. ``want_last`` (the run phase)
    appends the log-probs after each row's last valid token ``(NB, R, V)``,
    and streams the positions in between through the vocabulary LSE.

    ``extra_kv=(ek, ev, en)`` injects per-beam context that is not yet in
    the cache (the deferred run of the fused commit): ``ek/ev (layers, NB,
    E, H, Dh)`` for ``en (NB,)`` tokens between the cache and the rows, seen
    by every query; ``pos_offset (NB,)`` (= ``en``) shifts the positions to
    where those tokens will live."""
    NB, R, S1 = tokens.shape
    H, Dh = clm.n_heads, clm.d_head
    tokens = tokens.long()
    total = torch.where(n_tokens > 0, next_logp.gather(1, tokens[:, :, 0]),
                        0.0)
    Sc = S1 if (want_last or S1 == 1) else S1 - 1
    s_ids = torch.arange(Sc, device=tokens.device)
    base = cache.lengths.long()
    if pos_offset is not None:
        base = base + pos_offset.long()
    h = clm._embed_token(tokens[:, :, :Sc], base[:, None, None] + s_ids)
    causal = (s_ids[None, :] <= s_ids[:, None])[None, None, :, None, :]
    scale = math.sqrt(Dh)
    k0s, v0s = [], []
    for li in range(clm.n_layers):
        lp = clm.layers[li]
        q, k, v = clm._qkv_proj(clm._ln(h, lp["ln1"]), li)  # (NB,R,Sc,H,Dh)
        k0s.append(k if full_kv else k[:, :, 0])
        v0s.append(v if full_kv else v[:, :, 0])
        qs = (q / scale).to(q.dtype)
        # cache part: every position sees the beam's whole valid prefix
        o1, m1, l1 = peek_attention.peek_cache_attention(
            qs.reshape(NB, R * Sc, H, Dh), cache.k[li], cache.v[li],
            cache.lengths)
        o1 = o1.view(NB, R, Sc, H, Dh)
        m1 = m1.view(NB, R, Sc, H)
        l1 = l1.view(NB, R, Sc, H)
        if extra_kv is not None:
            # deferred-run part: E keys per beam, masked by r < en, plain
            ek, ev, en = extra_kv
            sc3 = torch.einsum("brshk,behk->brshe", qs.float(),
                               ek[li].float())
            e_ok = (torch.arange(ek.shape[2], device=en.device)[None, :]
                    < en[:, None])[:, None, None, None, :]
            sc3 = torch.where(e_ok, sc3, NEG_INF)
            m3 = sc3.amax(-1)
            p3 = torch.where(e_ok, torch.exp(sc3 - m3[..., None]), 0.0)
            o3 = torch.einsum("brshe,behk->brshk", p3.to(ev.dtype).float(),
                              ev[li].float())
            o1, m1, l1 = peek_attention.combine_partials(
                o1, m1, l1, o3, m3, p3.sum(-1))
        # own-row causal part: Sc keys, plain
        sc = torch.einsum("brshk,brthk->brsht", qs.float(), k.float())
        sc = torch.where(causal, sc, NEG_INF)
        m2 = sc.amax(-1)
        p2 = torch.where(causal, torch.exp(sc - m2[..., None]), 0.0)
        o2 = torch.einsum("brsht,brthk->brshk", p2.to(v.dtype).float(),
                          v.float())
        o = peek_attention.merge_partials(o1, m1, l1, o2, m2, p2.sum(-1))
        h = h + clm._attn_out(o.to(h.dtype), li)
        h = h + clm._ff_float(clm._ln(h, lp["ln2"]), li)

    xs = clm._ln(h, clm.ln_f)                                # (NB, R, Sc, d)
    s_valid = (torch.arange(1, S1, device=tokens.device)
               < n_tokens[..., None])
    if want_last:
        # full log-prob rows only at position 0 and at each row's last
        # valid position; the positions in between stream (target, LSE)
        last = (n_tokens.long() - 1).clamp(min=0)
        x_last = xs.gather(2, last[:, :, None, None].expand(
            NB, R, 1, xs.shape[-1]))[:, :, 0]
        x2 = torch.stack([xs[:, :, 0], x_last], 2)           # (NB, R, 2, d)
        logp2 = torch.log_softmax(x2.float() @ clm.emb32.T, dim=-1)
        if S1 > 1:
            tgt, lse = logits_lse.target_lse(xs[:, :, :-1].contiguous(),
                                             clm.emb, tokens[:, :, 1:])
            total = total + torch.where(s_valid, tgt - lse, 0.0).sum(-1)
        return (total, logp2[:, :, 0], torch.stack(k0s), torch.stack(v0s),
                logp2[:, :, 1])

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
        total = total + torch.where(s_valid, contrib, 0.0).sum(-1)
    return total, logp0, torch.stack(k0s), torch.stack(v0s)


# ------------------------------------------------ frame compaction helpers
def _comb(x, y):
    """Composition of two blank-run operators ``[[A, B], [-inf, 0]]`` over
    the (logaddexp, +) semiring, ``x`` the earlier; a set flag (a kept
    frame) resets the product."""
    fx, ax, bx = x
    fy, ay, by = y
    a = ay + ax
    b = _logaddexp(ay + bx, by)
    return fx | fy, torch.where(fy, ay, a), torch.where(fy, by, b)


def _interleave(a, b):
    out = torch.empty((a.shape[0], a.shape[1] + b.shape[1]), dtype=a.dtype,
                      device=a.device)
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _associative_scan(elems):
    """Inclusive scan of ``_comb`` along axis 1, in the tree order of
    ``jax.lax.associative_scan`` (pairs, recursion, odd fix-up): log2(T)
    levels of elementwise work, not a loop over frames."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _comb(tuple(e[:, 0:-1:2] for e in elems),
                    tuple(e[:, 1::2] for e in elems))
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _comb(tuple(e[:, :-1] for e in odd),
                     tuple(e[:, 2::2] for e in elems))
    else:
        even = _comb(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], 1) for e, r in zip(elems, even))
    return tuple(_interleave(a, b) for a, b in zip(even, odd))


def blank_run_scan(kept, op_a, op_b):
    """Per frame, the product of the blank operators since the last kept
    frame (inclusive): ``(A, B) (G, T)``. ``kept`` frames reset it."""
    _, a, b = _associative_scan((kept, op_a, op_b))
    return a, b


def _segment_layout(cf, amb, run_max: int):
    """The segment schedule in closed form. ``cf``/``amb`` ``(B, T)`` bool,
    disjoint: the char-fast and the ambiguous kept frames, in time order.
    A segment is a run of up to ``run_max`` char-fast frames closed by at
    most one ambiguous frame, so each block of n char-fast frames closed by
    an ambiguous one costs max(ceil(n / run_max), 1) segments and a trailing
    open block ceil(n / run_max); the i-th char-fast frame of a block lands
    in segment block_base + i // run_max at slot i % run_max, and the
    closing ambiguous frame in the block's last segment.

    Returns ``seg (B, T)`` (-1 for frames that are not kept), ``slot (B,
    T)`` (meaningful for char-fast frames) and the segment count ``(B,)``."""
    B, T = cf.shape
    cf_i, amb_i = cf.long(), amb.long()
    blk = amb_i.cumsum(1) - amb_i                   # ambiguous frames before
    cnt = torch.zeros((B, T + 1), dtype=torch.long, device=cf.device)
    cnt.scatter_add_(1, blk, cf_i)                  # char-fast frames a block
    n_amb = amb_i.sum(1, keepdim=True)
    blocks = torch.arange(T + 1, device=cf.device)[None, :]
    runs = (cnt + run_max - 1) // run_max
    cost = torch.where(blocks < n_amb, runs.clamp(min=1),
                       torch.where(blocks == n_amb, runs, 0))
    base = (cost.cumsum(1) - cost).gather(1, blk)
    i = (cf_i.cumsum(1) - cf_i) - (cnt.cumsum(1) - cnt).gather(1, blk)
    last = (runs.gather(1, blk) - 1).clamp(min=0)
    seg = torch.where(cf, base + i // run_max,
                      torch.where(amb, base + last, -1))
    return seg, i % run_max, cost.sum(1)


def segment_schedule(charfast, amb, budget: int, seg_budget: int,
                     run_max: int):
    """The skip search's segment schedule: ``cf_map (B, SB, RM)``, the
    frames of each segment's char-fast run in time order, and ``amb_map
    (B, SB)``, each segment's closing ambiguous frame (-1 = none). Kept
    frames past ``budget`` and segments past ``seg_budget`` are dropped.
    Built on the device from ``_segment_layout``; equal to the JAX
    package's sequential ``sched`` scan."""
    B, T = charfast.shape
    SB, RM = seg_budget, run_max
    kept = charfast | amb
    in_budget = kept & (kept.long().cumsum(1) <= budget)
    cf_b, amb_b = charfast & in_budget, amb & in_budget
    seg, slot, _ = _segment_layout(cf_b, amb_b, RM)
    t_all = torch.arange(T, device=seg.device).expand(B, T)
    # frames that land nowhere go to a discarded row SB
    tgt = torch.where(cf_b & (seg < SB), seg, SB)
    cf_map = torch.full((B, (SB + 1) * RM), -1, dtype=torch.long,
                        device=seg.device).scatter_(
        1, tgt * RM + torch.where(cf_b, slot, 0), t_all)
    tgt = torch.where(amb_b & (seg < SB), seg, SB)
    amb_map = torch.full((B, SB + 1), -1, dtype=torch.long,
                         device=seg.device).scatter_(1, tgt, t_all)
    return cf_map.view(B, SB + 1, RM)[:, :SB], amb_map[:, :SB]


def _frame_classes(arg, n_above, end, unknown_id: int, blank_id: int):
    """``(blank_fast, char_fast, ambiguous)`` frames ``(B, T)`` of the skip
    search, before each line's ``end``: single survivors that are the blank
    or a character, and frames with another count of classes above the
    prune threshold (``n_above`` from K1)."""
    in_range = (torch.arange(arg.shape[1], device=arg.device)[None, :]
                < end[:, None])
    fast = n_above == 1
    return (fast & (arg == blank_id) & in_range,
            fast & (arg != blank_id) & (arg < unknown_id) & in_range,
            ~fast & in_range)


# ------------------------------------------------- static segment steps
# the modules of the kernels a segment step launches: K2, K3, K4
_KERNELS = (peek_attention, logits_lse, cache_gather)


def _kernel_fns() -> tuple:
    """The wrappers a step reaches K2-K4 through: a step captured with
    other wrappers (their plain versions swapped in) is another graph."""
    return (peek_attention.peek_cache_attention, logits_lse.lse_rows,
            cache_gather.gather_write_kv)


def _use_static_steps(dev: torch.device, on_select) -> bool:
    """Whether the skip search steps its segments over a ``StepStore``'s
    static buffers: on a card, where no ``on_select`` hook watches the
    steps."""
    return dev.type == "cuda" and on_select is None


def _capture(body, pool, stream):
    """A CUDA graph of ``body``'s work, captured on ``stream`` into the
    memory pool ``pool``; nothing runs. ``thread_local``: a data shard's
    thread may capture while another one launches. Without a pool (the
    CPU) there is nothing to capture: the stand-in runs ``body`` at each
    replay."""
    if pool is None:
        return SimpleNamespace(replay=body)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(stream.device):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                body()
            finally:
                graph.capture_end()
    return graph


class StepStore:
    """The skip search's segment step over static buffers, and the CUDA
    graphs captured of it, for one LM replica on one data shard (kept in
    ``CachedLM.segment_graphs`` under ``parallel.mesh.current_shard()``).

    A group's search signature and shapes make its family. The first group
    of a family runs the eager loop on its own tensors (K2 and K3 set their
    kernels' attributes at their first launch) and leaves here only the
    keys of the steps it took: the cache depth ``Lc`` of the rung, the
    run's slots and the parity. From the family's next group on, ``load``
    copies the group's inputs into buffers of their shapes and its initial
    state into the state buffers of parity 0, and ``capture`` records each
    step key the family has taken, or this group will take, that has no
    graph yet into a CUDA graph in the store's one memory pool: every step
    of such a group replays a graph. A step reads parity p and writes
    parity 1 - p, K4 straight into that parity's KV cache, then advances
    ``seg``, the device scalar that picks the segment, so the host writes
    nothing a step. A replay adds to K2-K4's launch counters what its
    capture tallied (``ops/launch_tally``). Each parity's KV cache is a
    view, at depth ``Lc``, of one flat storage sized for the LM's context
    (grow-only in the beams); ``climb`` (a ladder rung, once a group)
    copies the state to the other parity, zero-padding the cache. No
    tensor that a graph allocates outlives its capture, so the graphs may
    replay in any order.

    So a family seen once (the eval CLI pads each batch to its widest line)
    allocates and captures nothing; the buffers and graphs of the
    ``SHAPES`` shapes loaded last are kept. On the CPU a step's stand-in
    for a graph runs it eagerly."""

    SHAPES = 4      # the engine's width buckets, and one more
    SEEN = 64       # families whose step keys are kept

    def __init__(self, clm: CachedLM):
        self.dev = clm.device
        self.kv_dims = (clm.n_layers, clm.n_heads, clm.d_head)
        self.dtype = clm.dtype
        self.max_len = int(clm.model.max_len)
        cuda = self.dev.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.stream = torch.cuda.Stream(self.dev) if cuda else None
        self.consts = {}    # search signature -> its constant tensors
        self.keys = {}      # family -> its step keys, least recent first
        self.shapes = {}    # shapes -> (inputs, states), least recent first
        self.kv = []        # each parity's flat (k, v) storage
        self.kv_size = 0
        self.graphs = {}    # family + step key -> (graph, K2-K4 launches)
        self.seg = self._alloc((1,), torch.long)

    @staticmethod
    def of(clm: CachedLM) -> "StepStore":
        """The store of ``clm`` for the calling thread's data shard."""
        shard = current_shard()
        if shard not in clm.segment_graphs:
            clm.segment_graphs[shard] = StepStore(clm)
        return clm.segment_graphs[shard]

    def _alloc(self, shape, dtype) -> torch.Tensor:
        # normal tensors, so that steps outside inference mode update them
        with torch.inference_mode(False):
            return torch.zeros(shape, dtype=dtype, device=self.dev)

    def _like(self, tensors: dict) -> dict:
        return {n: self._alloc(t.shape, t.dtype) for n, t in tensors.items()}

    @staticmethod
    def _fields(st: LMBeamState) -> dict:
        """The state's tensors but the cache's k/v."""
        out = st._asdict()
        out["cache_lengths"] = out.pop("cache").lengths
        return out

    def state(self, p: int, Lc: int | None = None) -> LMBeamState:
        """The static search state of parity ``p`` (its cache at depth
        ``Lc``, by default the current rung's)."""
        layers, H, Dh = self.kv_dims
        shape = (layers, self.NB, self.Lc if Lc is None else Lc, H, Dh)
        n = math.prod(shape)
        f = dict(self.st[p])
        lengths = f.pop("cache_lengths")
        k, v = self.kv[p]
        return LMBeamState(**f, cache=LMCache(k[:n].view(shape),
                                              v[:n].view(shape), lengths))

    def _write(self, p: int, st: LMBeamState) -> None:
        for n, t in self._fields(st).items():
            self.st[p][n].copy_(t)

    def load(self, sig, inputs: dict, state: LMBeamState, depth: int,
             plan) -> dict | None:
        """A group of the search of signature ``sig``: its ``inputs``, its
        initial ``state``, the depth its cache may deepen to and its
        ``plan``, each step's (cache depth, run slots). None where the
        family is new: the caller steps the group eagerly on its own
        tensors. Else the group is copied in (the state at parity 0,
        ``seg`` at 0) and the static inputs are returned, for the steps to
        read in place of the given ones."""
        layers, NB, Lc, H, Dh = state.cache.k.shape
        fields = self._fields(state)
        shape = tuple((n, tuple(t.shape), t.dtype)
                      for d in (inputs, fields) for n, t in d.items())
        family = (sig, shape)
        keys, d, p = set(), Lc, 0
        for d_s, slots in plan:
            if d_s != d:            # a climb moves the state across
                d, p = d_s, 1 - p
            keys.add((d, slots, p))
            p = 1 - p
        seen = self.keys.pop(family, None)
        self.keys[family] = keys | (seen or set())
        if len(self.keys) > self.SEEN:
            del self.keys[next(iter(self.keys))]
        if seen is None:
            return None
        size = layers * NB * max(self.max_len, depth, Lc) * H * Dh
        if size > self.kv_size:
            self.graphs.clear()          # they read the storage they had
            self.kv = []                 # freed before the larger one
            self.kv = [(self._alloc((size,), self.dtype),
                        self._alloc((size,), self.dtype)) for _ in range(2)]
            self.kv_size = size
        bufs = (self.shapes.pop(shape) if shape in self.shapes else
                (self._like(inputs), [self._like(fields) for _ in "01"]))
        self.shapes[shape] = bufs
        if len(self.shapes) > self.SHAPES:
            old = next(iter(self.shapes))
            del self.shapes[old]
            for key in [k for k in self.graphs if k[1] == old]:
                del self.graphs[key]
        self.sin, self.st = bufs
        for n, t in inputs.items():
            self.sin[n].copy_(t)
        self.NB, self.Lc, self.p = NB, Lc, 0
        self._write(0, state)
        dst = self.state(0).cache
        dst.k.copy_(state.cache.k)
        dst.v.copy_(state.cache.v)
        self.seg.zero_()
        self.family = family
        self.label = (f"G{self.sin['cf_map'].shape[0]} "
                      f"T{self.sin['cand_idx'].shape[1]} "
                      f"SB{self.sin['cf_map'].shape[1]}")
        return self.sin

    def capture(self, segment_step) -> None:
        """Capture each step key of the loaded family that has no graph
        yet. ``segment_step(st, cf_t, amb_t, n_slots, step, out)`` steps
        the group, reading the static inputs ``load`` returned."""
        global segment_graph_captures
        for key in sorted(self.keys[self.family]):
            if self.family + key in self.graphs:
                continue
            Lc, n_slots, p = key
            sin, seg, new = self.sin, self.seg, self.st[1 - p]
            src, dst = self.state(p, Lc), self.state(1 - p, Lc)

            def body(src=src, dst=dst, new=new, n_slots=n_slots):
                cf_t = sin["cf_map"].index_select(1, seg)[:, 0]
                amb_t = sin["amb_map"].index_select(1, seg)[:, 0]
                st = segment_step(src, cf_t, amb_t, n_slots, None, dst.cache)
                for n, t in self._fields(st).items():
                    new[n].copy_(t)
                seg.add_(1)
            with span("search.capture", key=f"{self.label} Lc{Lc} "
                                            f"slots{n_slots} p{p}"), \
                    tallying() as tally:
                graph = _capture(body, self.pool, self.stream)
            self.graphs[self.family + key] = (graph, tuple(
                tally.get(mod.__name__, 0) for mod in _KERNELS))
            segment_graph_captures += 1

    def climb(self, Lc: int) -> None:
        """Deepen the cache to ``Lc``: the state moves to the other
        parity, the cache zero-padded (every read masks by its lengths)."""
        src = self.state(self.p)
        self.p, self.Lc = 1 - self.p, Lc
        dst = self.state(self.p)
        self._write(self.p, src)
        lo = src.cache.k.shape[2]
        for a, b in ((dst.cache.k, src.cache.k), (dst.cache.v, src.cache.v)):
            a[:, :, :lo].copy_(b)
            a[:, :, lo:].zero_()

    def step(self, n_slots: int) -> LMBeamState:
        """One segment step of ``n_slots`` run slots, replayed from its
        graph; returns the new state."""
        global segment_graph_replays
        graph, launched = self.graphs[self.family
                                      + (self.Lc, n_slots, self.p)]
        graph.replay()
        for mod, n in zip(_KERNELS, launched):
            mod.launches += n
        segment_graph_replays += 1
        self.p = 1 - self.p
        return self.state(self.p)


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
    prune: float = PRUNE,
    kept_budget: int | None = None,
    group_size: int = 1,
    seg_budget: int | None = None,
    run_max: int = 8,
    peek_rows: int | None = None,
    return_overflow: bool = False,
    ctx_ladder=None,
    fused_commit: bool = False,
    dense_merge: bool = False,
    on_select=None,
):
    """Build the LM-fused search (the JAX package's signature, less its full
    search's ``frame_budget``, since the step loop stops at the group's last
    active step, and ``lm_depth``: the LM proposes ``depth`` characters, as
    every caller has it).

    Returned fn: ``fn(cand_vals (B,T,K), cand_idx (B,T,K), logits (B,T,D),
    logz (B,T)[, blank_lp (B,T), n_above (B,T)]) -> (prefixes (B,T),
    lengths (B,)[, overflow (B,)])``; the skip search takes K1's
    ``blank_lp`` and ``n_above`` (computed at the same ``prune``).

    ``group_size=G`` searches G lines together (B must be divisible by G);
    ``return_overflow`` appends a per-line flag set when a beam's committed
    tokens would have written past ``lm_ctx`` (the write is dropped) or a
    compacted peek dropped a useful row. Skip-search knobs, as in the JAX
    package: ``kept_budget`` caps the kept frames a line, ``seg_budget`` the
    segments a line, ``run_max`` the char-fast frames a segment;
    ``peek_rows`` compacts the peek table to the useful candidate rows
    (exact when at least ``count_peek_rows``; below ``2 * depth`` with LM
    proposals it needs ``return_overflow``); ``ctx_ladder=(segs, ctx)`` or a list of such
    rungs runs the first segments on a shallower KV cache, zero-padded
    between rungs; ``fused_commit`` defers the run's cache write into the
    next reorder. ``on_select(step, totals, parents, chars)``, if given,
    sees each search step's selection (the frame of the full search, the
    segment of the skip search), ``(G, BM)`` tensors of a group in rank
    order (for comparing two runs). ``dense_merge`` merges a step's rows
    of equal prefix through an all-pairs equality matrix instead of the
    sort (the JAX package's opt-in ``HCTR_LM_DENSE_MERGE=1``; the same
    groups and representatives, its group log-sum-exp max + exp-sum, so
    low-order bits differ from the sort merge's)."""
    BM, K = beam_size, depth
    M = depth if use_lm_pred else 0     # LM proposals per beam
    C = K + M
    P = C if peek_rows is None else max(1, min(peek_rows, C))
    if P < C and not return_overflow:
        raise ValueError(
            f"peek_rows={peek_rows} is below the always-exact bound {C} "
            f"(depth + LM proposals); pass return_overflow=True and check the "
            f"per-line flag, or leave peek_rows=None")
    if ctx_ladder is not None:
        if not skip_search:
            raise ValueError("ctx_ladder requires skip_search=True")
        rungs = (list(ctx_ladder) if ctx_ladder
                 and isinstance(ctx_ladder[0], (tuple, list))
                 else [tuple(ctx_ladder)])
        for i, (k_r, c_r) in enumerate(rungs):
            prev_k = rungs[i - 1][0] if i else 0
            prev_c = rungs[i - 1][1] if i else 0
            if not (prev_c < c_r < lm_ctx) or k_r <= prev_k or k_r < 1:
                raise ValueError(
                    f"ctx_ladder={ctx_ladder}: rungs must be strictly "
                    f"increasing (segments, ctx) pairs with every ctx "
                    f"< lm_ctx={lm_ctx}")
        ctx_ladder = rungs
    if fused_commit and not skip_search:
        raise ValueError("fused_commit requires skip_search=True "
                         "(there is no run phase to defer otherwise)")
    S = suffix_frames
    S1 = S + 1
    RM = run_max
    sos = 0  # tokenizer.sos_index
    dev = clm.device
    c2l = torch.as_tensor(codec2lm, dtype=torch.long, device=dev)
    l2c = torch.as_tensor(lm2codec, dtype=torch.long, device=dev)
    n_rows = BM * C + BM
    bi = torch.arange(BM, device=dev).repeat_interleave(C)       # (BM*C,)
    row_parent = torch.cat([bi, torch.arange(BM, device=dev)])   # (n_rows,)
    row_ids = torch.arange(n_rows, dtype=torch.int32, device=dev)
    full_slots = 1 + torch.arange(C, device=dev).repeat(BM)      # (BM*C,)
    earlier = row_ids[None, :] < row_ids[:, None]                # j < i
    # static segment steps: the constants live as long as the store's
    # graphs, which read them
    store = sig = None
    if skip_search and _use_static_steps(dev, on_select):
        store = StepStore.of(clm)
        sig = (BM, K, M, P, S, RM, unknown_id, blank_id, float(prune),
               float(lm_panelty), float(len_bonus), bool(fused_commit),
               bool(dense_merge), np.asarray(codec2lm).tobytes(),
               np.asarray(lm2codec).tobytes(), _kernel_fns())
        c2l, l2c, bi, row_parent, row_ids, full_slots, earlier = \
            store.consts.setdefault(sig, (c2l, l2c, bi, row_parent, row_ids,
                                          full_slots, earlier))

    def decode_group(cand_vals, cand_idx, logits, logz, blank_lp, n_above):
        global segment_steps
        G, T, _ = cand_vals.shape
        L = T
        NB = G * BM
        gi = torch.arange(G, device=dev)[:, None]
        g1 = gi[:, 0]
        cand_idx = cand_idx.long()
        cand_vals = cand_vals.float()
        logz = logz.float()

        # ---- greedy top line, end step, per-frame greedy suffixes
        arg = cand_idx[:, :, 0]
        end_step = _end_steps(arg, unknown_id, blank_id, S)
        prev = torch.cat([torch.full_like(arg[:, :1], -1), arg[:, :-1]], 1)
        keep = (arg != blank_id) & (arg != unknown_id) & (arg != prev)
        rank = keep.long().cumsum(1)                   # kept frames <= t
        n_kept = keep.sum(1)
        kept_chars = torch.zeros((G, T + 1), dtype=torch.long, device=dev)
        kept_chars.scatter_(1, torch.where(keep, rank - 1, T), arg)
        sidx = rank[:, :, None] + torch.arange(S, device=dev)    # (G, T, S)
        s_ok = sidx < n_kept[:, None, None]
        suffix_codec = torch.where(
            s_ok, kept_chars.gather(1, sidx.clamp(max=T - 1).view(G, -1))
            .view(G, T, S), 0)
        suffix_valid = s_ok.sum(-1)

        budget = T if kept_budget is None else min(kept_budget, T)
        SB = budget if seg_budget is None else min(seg_budget, budget)
        # a ladder spanning every segment would leave the cache at the
        # small rung for the whole decode: keep rungs that leave a
        # full-depth final chunk
        ladder = None
        if skip_search and ctx_ladder is not None:
            ladder = [r for r in ctx_ladder if r[0] < SB] or None

        # ---- init: every beam shares the sos-primed cache (at the first
        # rung's depth on a ladder: every shape and overflow bound below
        # derives from the cache itself)
        cache = clm.init_cache(NB, lm_ctx if ladder is None else ladder[0][1])
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

        def visual(t):
            """Frames ``t (G,)`` -> their top-K classes and log-probs; the
            skip search maps classes at or below ``prune`` to unknown."""
            g = g1.view(-1, *[1] * (t.dim() - 1))
            vis_idx = cand_idx[g, t]                           # (G, [F,] K)
            vis_p = cand_vals[g, t]
            if skip_search:
                vis_idx = torch.where(vis_p > prune, vis_idx, unknown_id)
            return vis_idx, vis_p

        def linguistic(st):
            """Each beam's top-M next characters, specials, unmapped tokens
            and empty prefixes mapped to unknown (skipped)."""
            lm_top = torch.sort(st.next_logp, dim=-1, descending=True,
                                stable=True).indices[..., :M]
            ling = l2c[lm_top]                                    # (G,BM,M)
            return torch.where((ling >= 0) & (st.lengths[..., None] > 0),
                               ling, unknown_id)

        def useful(idx):
            """Candidates the peek must score: not blank, not unknown."""
            return (idx != blank_id) & (idx < unknown_id)

        def full_step(st: LMBeamState, t, active, step, run_kv=None,
                      out=None):
            """One searched frame per line, ``t (G,)``, for the lines where
            ``active (G,)``; the others pass through unchanged.
            ``run_kv=(ek, ev, en)`` (fused commit): the preceding run's k/v
            not yet in the cache, attended by the peek and written by this
            step's reorder. ``out``: a cache whose k/v receive the
            reordered cache (the static steps)."""
            act = active[:, None]                                   # (G, 1)
            vis_idx, vis_p = visual(t)
            vis_idx = vis_idx[:, None].expand(G, BM, K)
            vis_p = vis_p[:, None].expand(G, BM, K)
            if M > 0:
                ling = linguistic(st)
                ling_p = (logits[g1, t].float().gather(
                    1, ling.clamp(0, unknown_id).view(G, -1)).view(G, BM, M)
                    - logz[g1, t][:, None, None])
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
            # suffix for each candidate; with peek-row compaction only the
            # first P useful candidates (stable order) get a row
            ext_c = cj.view(G, BM, C)
            if P < C:
                use = useful(ext_c)
                comp = torch.sort((~use).to(torch.int8), dim=-1,
                                  stable=True).indices[..., :P]   # (G,BM,P)
                ext_peek = ext_c.gather(-1, comp)
                slot_ext = torch.zeros((G, BM, C), dtype=torch.long,
                                       device=dev).scatter_(
                    -1, comp, 1 + torch.arange(P, device=dev).expand_as(comp))
                slot_ext = slot_ext.view(G, BM * C)
                peek_ovf = (use.sum(-1) > P).any(-1)
            else:
                ext_peek = ext_c
                slot_ext = full_slots.expand(G, -1)
                peek_ovf = torch.zeros((G,), dtype=torch.bool, device=dev)
            suf_lm = c2l[suffix_codec[g1, t]]                         # (G, S)
            n_suf = suffix_valid[g1, t]                                # (G,)
            stay = torch.cat([suf_lm, torch.zeros_like(suf_lm[:, :1])], 1)
            ext = torch.cat(
                [c2l[ext_peek.clamp(0, unknown_id)][..., None],
                 suf_lm[:, None, None, :].expand(G, BM, P, S)], -1)
            tokens = torch.cat(
                [stay[:, None, None, :].expand(G, BM, 1, S1), ext], 2)
            n_tok = torch.cat(
                [n_suf[:, None, None].expand(G, BM, 1),
                 (1 + n_suf)[:, None, None].expand(G, BM, P)], 2)
            R = 1 + P
            peek_scores, peek_logp0, peek_k0, peek_v0 = _grouped_peek(
                clm, st.cache, tokens.reshape(NB, R, S1),
                n_tok.reshape(NB, R), st.next_logp.view(NB, V),
                extra_kv=run_kv,
                pos_offset=None if run_kv is None else run_kv[2])
            slot = torch.where(
                row_is_ext,
                torch.cat([slot_ext, torch.zeros((G, BM), dtype=torch.long,
                                                 device=dev)], 1), 0)
            row_lm = (st.prefix_score[:, row_parent]
                      + peek_scores.view(G, BM, R)[gi, row_parent, slot])
            row_pt = row_lm * lm_panelty + row_len.float() * len_bonus

            # ---- merge: the sort merge (stable sort by (h1, h2, row),
            # segmented logaddexp) or the dense one (all-pairs equality)
            pb_m, pnb_m, total, order = merge_rows(
                kh1, kh2, row_pb, row_pnb, row_pt, row_dead, earlier,
                dense_merge)

            # ---- best BM groups, ordered as lax.top_k (ties: lower index)
            top = torch.sort(total, dim=1, descending=True,
                             stable=True).indices[:, :BM]
            pick = top if order is None else order.gather(1, top)
            sel_parent = row_parent[pick]                             # (G,BM)
            sel_ext = row_is_ext.gather(1, pick)
            sel_char = row_char.gather(1, pick)
            sel_slot = slot.gather(1, pick)
            sel_alive = total.gather(1, top) > _DEAD
            sel_pb = torch.where(sel_alive, pb_m.gather(1, top), NEG_INF)
            sel_pnb = torch.where(sel_alive, pnb_m.gather(1, top), NEG_INF)
            do_step = sel_ext & sel_alive & act
            if on_select is not None:
                on_select(step, total.gather(1, top), sel_parent,
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
            reorder = torch.where(act, sel_parent,
                                  torch.arange(BM, device=dev))
            reorder_g = (reorder + gi * BM).view(NB)
            sel_g = (sel_parent + gi * BM).view(NB)
            slot_g = sel_slot.view(NB)
            do_g = do_step.view(NB)
            # the committed step is free: the peek computed the extension
            # token's k/v and next distribution
            k_sel = peek_k0[:, sel_g, slot_g].to(clm.dtype)
            v_sel = peek_v0[:, sel_g, slot_g].to(clm.dtype)
            Lc = st.cache.k.shape[2]          # the current rung's depth
            if run_kv is None:
                glen = st.cache.lengths[reorder_g]
                wpos = torch.where(do_g, glen, Lc).to(torch.int32)
                new_cache = CachedLM.gather_write(
                    st.cache, reorder_g.to(torch.int32), k_sel, v_sel,
                    wpos, out=out)._replace(
                        lengths=torch.where(do_g, glen + 1, glen))
            else:
                # fused commit, plain: one pass merges the reorder, the new
                # parent's deferred run tokens at lengths..lengths+n-1 and
                # the extension token at lengths+n
                ek, ev, en = run_kv
                n_r = en[reorder_g]
                base = st.cache.lengths[reorder_g]
                glen = base + n_r
                wpos = torch.where(do_g, glen, Lc)
                k_run, v_run, run_any = _run_write(
                    base, n_r, Lc, ek[:, reorder_g], ev[:, reorder_g])
                perm = CachedLM.gather(st.cache, reorder_g)
                ext_m = (torch.arange(Lc, device=dev)[None, :]
                         == wpos[:, None])[None, :, :, None, None]
                run_m = run_any[None, :, :, None, None]
                new_cache = LMCache(
                    k=torch.where(ext_m, k_sel[:, :, None],
                                  torch.where(run_m, k_run, perm.k),
                                  out=None if out is None else out.k),
                    v=torch.where(ext_m, v_sel[:, :, None],
                                  torch.where(run_m, v_run, perm.v),
                                  out=None if out is None else out.v),
                    lengths=torch.where(do_g, glen + 1, glen).to(torch.int32))
            new_next_logp = torch.where(
                do_g[:, None], peek_logp0[sel_g, slot_g],
                st.next_logp.view(NB, V)[reorder_g]).view(G, BM, V)
            return LMBeamState(
                prefixes=torch.where(act[..., None], new_prefixes,
                                     st.prefixes),
                lengths=torch.where(act, par_len + sel_ext.long(),
                                    st.lengths),
                pb=torch.where(act, sel_pb, st.pb),
                pnb=torch.where(act, sel_pnb, st.pnb),
                h1=torch.where(act, torch.where(sel_ext, nh1, par_h1), st.h1),
                h2=torch.where(act, torch.where(sel_ext, nh2, par_h2), st.h2),
                prefix_score=torch.where(act, new_prefix_score,
                                         st.prefix_score),
                next_logp=new_next_logp,
                cache=new_cache,
                ovf=st.ovf | (do_step & (glen.view(G, BM) >= Lc)).any(1)
                | peek_ovf)

        def idle_peek_overflow(st, frames):
            """The peek-row overflow that the JAX program's no-op steps
            (after the group's last active step) raise at ``frames (G, F)``
            with the final state: some beam has more useful candidates than
            ``P``."""
            if P >= C:
                return st.ovf
            vis_idx, _ = visual(frames)                          # (G, F, K)
            n_vis = useful(vis_idx).sum(-1).amax(1)
            n_ling = (useful(linguistic(st)).sum(-1).amax(1) if M > 0
                      else torch.zeros_like(n_vis))
            return st.ovf | (n_vis + n_ling > P)

        if not skip_search:
            FB = int(end_step.max()) if G else 0
            for t in range(FB):
                tv = torch.full((G,), t, dtype=torch.long, device=dev)
                state = full_step(state, tv, t < end_step, t)
            if FB < T:
                state = state._replace(ovf=idle_peek_overflow(
                    state, torch.arange(FB, T, device=dev).expand(G, -1)))
            return (state.prefixes[:, 0].to(torch.int32),
                    state.lengths[:, 0].to(torch.int32), state.ovf)

        # ---- frame compaction: blank-fast frames update every beam by a
        # (logaddexp, +)-linear operator, and runs of them fold into one by
        # a segmented associative scan; no-op frames (survivor unknown, or
        # past end_step) are the identity; only kept frames (char-fast and
        # ambiguous) enter the sequential segments
        blankop, charfast, amb = _frame_classes(arg, n_above, end_step,
                                                unknown_id, blank_id)
        kept = amb | charfast
        p_top = cand_vals[:, :, 0]
        As, Bs = blank_run_scan(kept, torch.where(blankop, p_top, 0.0),
                                torch.where(blankop, p_top, NEG_INF))
        preA = torch.cat([torch.zeros_like(As[:, :1]), As[:, :-1]], 1)
        preB = torch.cat([torch.full_like(Bs[:, :1], NEG_INF), Bs[:, :-1]], 1)

        cf_map, amb_map = segment_schedule(charfast, amb, budget, SB, RM)
        # one copy to the host a group: the slots used a segment, and which
        # segments hold anything
        with span("search.schedule"):
            busy = torch.stack([(cf_map >= 0).sum(-1).amax(0),
                                (amb_map >= 0).any(0).long()]).cpu()
            slots = busy[0].tolist()
            filled = [i for i in range(SB) if slots[i] or busy[1, i]]
            n_seg = filled[-1] + 1 if filled else 0
        segment_steps += n_seg

        def run_phase(st: LMBeamState, cf_t, n_slots: int):
            """Commit a run of char-fast frames ``cf_t (G, RM)`` (-1 = empty
            slot): the per-frame pb/pnb/prefix update is elementwise per
            beam; the LM work is one grouped forward over each beam's
            committed tokens, which gives their k/v, their log-probs and
            the distribution after the run. Slots past ``n_slots`` are
            empty in every line and are not visited."""
            tc = cf_t.clamp(min=0)
            slot_on = cf_t >= 0
            char_s = cand_idx[gi, tc, 0]                          # (G, RM)
            p_s = cand_vals[gi, tc, 0]
            p0_s = blank_lp[gi, tc].float()
            a_s = torch.where(slot_on, preA[gi, tc], 0.0)
            b_s = torch.where(slot_on, preB[gi, tc], NEG_INF)
            pb, pnb, lengths = st.pb, st.pnb, st.lengths
            h1, h2, prefixes = st.h1, st.h2, st.prefixes
            tail = torch.where(
                lengths > 0,
                prefixes.gather(2, (lengths - 1).clamp(min=0)[..., None])
                [..., 0], -1)
            commit = torch.zeros((G, BM, RM), dtype=torch.bool, device=dev)
            for r in range(n_slots):
                on, ch = slot_on[:, r:r + 1], char_s[:, r:r + 1]
                p, p0 = p_s[:, r:r + 1], p0_s[:, r:r + 1]
                # fold the blank-fast run before this frame
                pb = _logaddexp(a_s[:, r:r + 1] + pb, b_s[:, r:r + 1] + pnb)
                prob = _logaddexp(pb, pnb)
                is_rep = ch == tail
                pb_live = pb > _DEAD
                ext = ~is_rep | pb_live           # appends the char
                merge = is_rep & ~pb_live         # folds into the tail
                n_pb = torch.where(ext, NEG_INF,
                                   torch.where(merge, prob + p0, pb))
                n_pnb = torch.where(
                    ext, torch.where(is_rep, pb + p, prob + p),
                    torch.where(merge, pnb + p, pnb))
                upd = on & (prob > _DEAD)
                ext_u = ext & upd
                app = lengths.clamp(max=L - 1)[..., None]
                cur = prefixes.gather(2, app)[..., 0]
                appended = prefixes.scatter(
                    2, app, torch.where(ext_u, ch, cur)[..., None])
                nh1, nh2 = _hash_extend(h1, h2, ch)
                pb = torch.where(upd, n_pb, pb)
                pnb = torch.where(upd, n_pnb, pnb)
                tail = torch.where(ext_u, ch, tail)
                lengths = lengths + ext_u.long()
                h1 = torch.where(ext_u, nh1, h1)
                h2 = torch.where(ext_u, nh2, h2)
                prefixes = torch.where(ext_u[..., None], appended, prefixes)
                commit[:, :, r] = ext_u

            # ---- one grouped LM forward over each beam's committed run,
            # its tokens compacted to the front in time order
            tok_s = c2l[char_s.clamp(0, unknown_id)]                # (G, RM)
            order = torch.sort((~commit).to(torch.int8), dim=-1,
                               stable=True).indices
            n_com = commit.sum(-1)                                  # (G, BM)
            ctok = torch.where(
                torch.arange(RM, device=dev) < n_com[..., None],
                tok_s[:, None, :].expand(G, BM, RM).gather(2, order), 0)
            total, _, k_full, v_full, last_lp = _grouped_peek(
                clm, st.cache, ctok.view(NB, 1, RM), n_com.view(NB, 1),
                st.next_logp.view(NB, V), full_kv=True, want_last=True)
            Lc = st.cache.k.shape[2]
            n_flat = n_com.view(NB)
            st = LMBeamState(
                prefixes=prefixes, lengths=lengths, pb=pb, pnb=pnb,
                h1=h1, h2=h2,
                prefix_score=st.prefix_score + total.view(G, BM),
                next_logp=torch.where(n_com[..., None] > 0,
                                      last_lp.view(G, BM, V), st.next_logp),
                cache=st.cache,           # written below or deferred
                ovf=st.ovf | (st.cache.lengths.view(G, BM) + n_com
                              > Lc).any(1))
            k_run = k_full[:, :, 0].to(clm.dtype)
            v_run = v_full[:, :, 0].to(clm.dtype)
            if fused_commit:
                return st, (k_run, v_run, n_flat.to(torch.int32))
            # immediate masked multi-token write
            kr, vr, w_any = _run_write(st.cache.lengths, n_flat, Lc,
                                       k_run, v_run)
            m_any = w_any[None, :, :, None, None]
            return st._replace(cache=LMCache(
                k=torch.where(m_any, kr, st.cache.k),
                v=torch.where(m_any, vr, st.cache.v),
                lengths=(st.cache.lengths + n_flat).to(torch.int32))), None

        def segment_step(st: LMBeamState, cf_t, amb_t, n_slots: int, step,
                         out=None):
            """One segment step: the run of ``cf_t (G, RM)`` over its first
            ``n_slots`` slots (none: no run phase), the blank fold before
            the closing ambiguous frame ``amb_t (G,)`` (-1 = none) and its
            search step. ``out``: as ``full_step``'s."""
            run_kv = None
            if n_slots:
                st, run_kv = run_phase(st, cf_t, n_slots)
            a_on = amb_t >= 0
            ta = amb_t.clamp(min=0)
            st = st._replace(pb=_logaddexp(
                torch.where(a_on, preA[g1, ta], 0.0)[:, None] + st.pb,
                torch.where(a_on, preB[g1, ta], NEG_INF)[:, None] + st.pnb))
            return full_step(st, ta, a_on, step, run_kv, out)

        # each step's cache depth: a ladder's rungs, then the full context
        depths = [lm_ctx] * n_seg
        if ladder is not None:
            rung_ctx = [c for _, c in ladder] + [lm_ctx]
            depths = [rung_ctx[sum(s >= k for k, _ in ladder)]
                      for s in range(n_seg)]
        static = None
        if store is not None:
            static = store.load(sig, dict(
                cand_vals=cand_vals, cand_idx=cand_idx, logits=logits,
                logz=logz, blank_lp=blank_lp, preA=preA, preB=preB,
                suffix_codec=suffix_codec, suffix_valid=suffix_valid,
                gi=gi, g1=g1, cf_map=cf_map, amb_map=amb_map), state, lm_ctx,
                list(zip(depths, slots)))
        if static is not None:
            # the steps read the group's tensors from the static buffers
            (cand_vals, cand_idx, logits, logz, blank_lp, preA, preB,
             suffix_codec, suffix_valid, gi, g1) = (static[n] for n in (
                 "cand_vals", "cand_idx", "logits", "logz", "blank_lp",
                 "preA", "preB", "suffix_codec", "suffix_valid", "gi", "g1"))
            store.capture(segment_step)
        with span("search.segments"):
            Lc = state.cache.k.shape[2]
            for s in range(n_seg):
                if depths[s] != Lc:
                    # climb to the next rung: zero-pad the cache depth (every
                    # read masks by ``lengths``, so the pad rows stay dead)
                    if static is not None:
                        store.climb(depths[s])
                    else:
                        grow = (0, 0, 0, 0, 0, depths[s] - Lc)
                        state = state._replace(cache=state.cache._replace(
                            k=F.pad(state.cache.k, grow),
                            v=F.pad(state.cache.v, grow)))
                    Lc = depths[s]
                if static is not None:
                    state = store.step(slots[s])
                else:
                    state = segment_step(state, cf_map[:, s], amb_map[:, s],
                                         slots[s], s)
        if n_seg < SB:
            # the JAX program's remaining segments are no-ops at frame 0
            state = state._replace(ovf=idle_peek_overflow(
                state, torch.zeros((G, 1), dtype=torch.long, device=dev)))
        # (the JAX program folds the blank frames after the last kept frame
        # into pb here; no output reads it)
        return (state.prefixes[:, 0].to(torch.int32),
                state.lengths[:, 0].to(torch.int32),
                state.ovf if static is None else state.ovf.clone())

    def run(cand_vals, cand_idx, logits, logz, blank_lp=None, n_above=None):
        B = cand_vals.shape[0]
        if cand_vals.shape[-1] != K:
            raise ValueError(f"candidates have depth {cand_vals.shape[-1]}, "
                             f"the search was built for depth={K}")
        if skip_search and (blank_lp is None or n_above is None):
            raise ValueError("the skip search needs K1's blank_lp and "
                             "n_above")
        G = max(1, min(group_size, B))
        if B % G != 0:
            raise ValueError(f"batch {B} not divisible by group {G}")
        outs = []
        for s in range(0, B, G):
            with span("search.group"):
                outs.append(decode_group(
                    cand_vals[s:s + G], cand_idx[s:s + G], logits[s:s + G],
                    logz[s:s + G],
                    None if blank_lp is None else blank_lp[s:s + G],
                    None if n_above is None else n_above[s:s + G]))
        prefixes, lengths, ovf = (torch.cat(x) for x in zip(*outs))
        return (prefixes, lengths, ovf) if return_overflow else (prefixes,
                                                                 lengths)

    return run


# ------------------------------------------------------------------ sizing
def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _host_kept_cf(arg, n_above, unknown_id, blank_id, suffix_frames):
    """One line on the host: the char-fast mask of its kept frames, in kept
    order (``fast`` for the counts)."""
    T = arg.shape[0]
    prev = np.concatenate([[-1], arg[:-1]])
    keep = (arg != blank_id) & (arg != unknown_id) & (arg != prev)
    end = (int(np.max(np.where(keep, np.arange(T), -1))) + suffix_frames
           if keep.any() else 0)
    end = min(end, T)
    fast = n_above[:end] == 1
    sv = arg[:end]
    charfast = fast & (sv != blank_id) & (sv < unknown_id)
    return fast, charfast


def count_kept_frames(cand_idx, n_above, *, unknown_id: int,
                      blank_id: int = 0, suffix_frames: int = 4) -> np.ndarray:
    """Per-line count of frames the skip search scans (char-fast plus
    ambiguous frames before ``end_step``): sizes ``kept_budget``. Host."""
    cand_idx, n_above = _np(cand_idx), _np(n_above)
    out = np.zeros((n_above.shape[0],), np.int64)
    for b in range(n_above.shape[0]):
        fast, charfast = _host_kept_cf(cand_idx[b, :, 0], n_above[b],
                                       unknown_id, blank_id, suffix_frames)
        out[b] = int((~fast).sum() + charfast.sum())
    return out


def count_segments(cand_idx, n_above, *, unknown_id: int, blank_id: int = 0,
                   suffix_frames: int = 4, run_max: int = 8) -> np.ndarray:
    """Per-line count of segments the skip search scans: each block of n
    consecutive char-fast kept frames closed by an ambiguous frame costs
    max(ceil(n / run_max), 1), a trailing open block ceil(n / run_max).
    Sizes ``seg_budget``. Host."""
    cand_idx, n_above = _np(cand_idx), _np(n_above)
    out = np.zeros((n_above.shape[0],), np.int64)
    for b in range(n_above.shape[0]):
        fast, charfast = _host_kept_cf(cand_idx[b, :, 0], n_above[b],
                                       unknown_id, blank_id, suffix_frames)
        kept_cf = charfast[~fast | charfast]     # cf mask in kept order
        amb_pos = np.nonzero(~kept_cf)[0]
        block = np.diff(np.concatenate([[-1], amb_pos])) - 1  # cf before amb
        segs = int(np.maximum(np.ceil(block / run_max), 1).sum())
        tail = kept_cf.size - (amb_pos[-1] + 1 if amb_pos.size else 0)
        out[b] = segs + int(np.ceil(tail / run_max))
    return out


def count_ladder_segments(cand_idx, n_above, *, ctx1: int, unknown_id: int,
                          blank_id: int = 0, suffix_frames: int = 4,
                          run_max: int = 8) -> int:
    """Sound ``ctx_ladder`` first-rung length: the largest segment count k
    such that no beam of any line can have committed more than ``ctx1`` LM
    tokens (<s> included) after the first k segments (a beam commits at
    most one token a kept frame). ``1 << 30`` when no line constrains it,
    0 when even one segment could overflow ``ctx1``. Host."""
    cand_idx, n_above = _np(cand_idx), _np(n_above)
    k_min = None
    for b in range(n_above.shape[0]):
        fast, charfast = _host_kept_cf(cand_idx[b, :, 0], n_above[b],
                                       unknown_id, blank_id, suffix_frames)
        kept_cf = charfast[~fast | charfast]
        seg_kept, cur, pos = [], 0, 0
        for cf in kept_cf:
            if cf:
                if pos >= run_max:               # run full: new segment
                    seg_kept.append(cur)
                    cur = pos = 0
                cur += 1
                pos += 1
            else:                                # ambiguous closes it
                seg_kept.append(cur + 1)
                cur = pos = 0
        if cur:
            seg_kept.append(cur)
        toks = 1 + np.cumsum(seg_kept) if seg_kept else np.array([1])
        if toks[-1] <= ctx1:
            continue        # the whole line fits in ctx1
        k_b = int(np.searchsorted(toks, ctx1, side="right"))
        k_min = k_b if k_min is None else min(k_min, k_b)
    return (1 << 30) if k_min is None else int(k_min)


def count_peek_rows(n_above, *, depth: int = 10,
                    use_lm_pred: bool = True) -> int:
    """Safe ``peek_rows``: per beam and frame the useful peek rows are at
    most the visual classes above the prune threshold (capped at
    ``depth``) plus the ``depth`` LM proposals."""
    return int(min(int(np.max(_np(n_above))), depth)
               + (depth if use_lm_pred else 0))


def _batch_classes(cand_idx, n_above, unknown_id, blank_id, suffix_frames):
    arg = cand_idx[:, :, 0].long()
    end = _end_steps(arg, unknown_id, blank_id, suffix_frames)
    _, cf, amb = _frame_classes(arg, n_above, end, unknown_id, blank_id)
    return arg, end, cf, amb


def make_count_stats(*, unknown_id: int, blank_id: int = 0,
                     suffix_frames: int = 4, run_max: int = 8):
    """Device reductions for ``decode.adaptive``'s sizing: ``fn(cand_idx,
    n_above)`` -> ``(4,)`` tensor of the batch maxima of greedy characters,
    end step, segments and classes above prune, read with one copy.
    ``n_above=None`` (full search) counts every frame as fast."""
    def stats(cand_idx, n_above):
        if n_above is None:
            n_above = torch.ones(cand_idx.shape[:2], dtype=torch.int32,
                                 device=cand_idx.device)
        arg, end, cf, amb = _batch_classes(cand_idx, n_above, unknown_id,
                                           blank_id, suffix_frames)
        prev = torch.cat([torch.full_like(arg[:, :1], -1), arg[:, :-1]], 1)
        keep = (arg != blank_id) & (arg != unknown_id) & (arg != prev)
        _, _, segs = _segment_layout(cf, amb, run_max)
        return torch.stack([keep.sum(1).max(), end.max(), segs.max(),
                            n_above.max().long()])
    return stats


def make_count_ladder(*, unknown_id: int, blank_id: int = 0,
                      suffix_frames: int = 4, run_max: int = 8):
    """Device twin of ``count_ladder_segments``: ``fn(cand_idx, n_above,
    ctx1)`` -> the segment of the densest line's ``ctx1``-th kept frame (a
    0-d tensor), the first segment that could push a beam past ``ctx1``
    slots."""
    def ladder(cand_idx, n_above, ctx1):
        _, _, cf, amb = _batch_classes(cand_idx, n_above, unknown_id,
                                       blank_id, suffix_frames)
        seg, _, _ = _segment_layout(cf, amb, run_max)
        kept = cf | amb
        hit = kept & (kept.long().cumsum(1) == int(ctx1))
        return torch.where(hit, seg, 1 << 30).amin(1).min()
    return ladder


def make_count_sizing(*, unknown_id: int, blank_id: int = 0,
                      suffix_frames: int = 4, run_max: int = 8):
    """``make_count_stats`` and ``make_count_ladder`` in one ``(5,)``
    tensor, one device-to-host copy a batch."""
    kw = dict(unknown_id=unknown_id, blank_id=blank_id,
              suffix_frames=suffix_frames, run_max=run_max)
    stats, ladder = make_count_stats(**kw), make_count_ladder(**kw)

    def sizing(cand_idx, n_above, ctx1):
        return torch.cat([stats(cand_idx, n_above),
                          ladder(cand_idx, n_above, ctx1).view(1)])
    return sizing
