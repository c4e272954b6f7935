"""Incremental (KV-cached) inference over ``CharTransformerLM`` weights
(the JAX package's ``lm/cached.py``).

The LM-fused beam search needs, per CTC frame and per beam, the next-token
distribution given the beam's prefix and the log-probability of a short
suffix given that prefix. ``CachedLM`` re-implements the model's forward
from its state dict for one token per beam (``step``) and for the grouped
peek of ``decode/beam_lm_device``, with per-beam prefix lengths. Cache
layout: ``k/v (layers, B, Lmax, H, Dh)`` and ``lengths (B,)``.

``dtype`` is the compute and cache dtype (bf16 on the card for serving).
Every floating weight is cast to it, as the JAX package casts its f32
leaves; the precision-critical spots (LayerNorm statistics, attention
scores and their softmax, the final logits) run in f32.
"""

from __future__ import annotations

import copy
import math
from typing import NamedTuple, Optional

import torch

from ..ops import cache_gather, int8_conv
from ..parallel import mesh
from .model import layer_norm

NEG = -1e30


class LMCache(NamedTuple):
    k: torch.Tensor        # (layers, B, Lmax, H, Dh)
    v: torch.Tensor        # (layers, B, Lmax, H, Dh)
    lengths: torch.Tensor  # (B,) int32 tokens already consumed


class CachedLM:
    """Single-token step and cache reorder over a ``CharTransformerLM``
    state dict (``lm/model.py`` names); ``quant_int8`` runs the step's FF
    and logits products in int8."""

    def __init__(self, model, state_dict, dtype: Optional[torch.dtype] = None,
                 quant_int8: bool = False,
                 device: Optional[torch.device] = None):
        if not model.tie_embeddings:
            raise ValueError("CachedLM scores with the tied embedding; this "
                             "LM has a separate head")
        self.model = model
        self.n_layers = model.n_layers
        self.n_heads = model.n_heads
        self.d_model = model.d_model
        self.d_head = model.d_model // model.n_heads
        self.dtype = dtype if dtype is not None else model.dtype
        dt = self.dtype

        def w(name):
            t = state_dict[name]
            if device is not None:
                t = t.to(device)
            return t.to(dt) if t.is_floating_point() else t

        self.emb = w("embed.weight").contiguous()            # (V, d)
        self.emb32 = self.emb.float()                        # f32 head
        self.pos = w("pos_embed")                            # (max_len, d)
        self.ln_f = (w("ln_f.weight"), w("ln_f.bias"))
        self.layers = []
        for i in range(self.n_layers):
            p = f"layer{i}."
            q, k, v = (w(p + f"attn.{n}.weight") for n in
                       ("query", "key", "value"))
            self.layers.append({
                "ln1": (w(p + "ln1.weight"), w(p + "ln1.bias")),
                # fused q/k/v: (d, 3 * H * Dh), one product for all three
                "qkv_w": torch.cat([q.T, k.T, v.T], dim=1).contiguous(),
                "qkv_b": torch.cat([w(p + f"attn.{n}.bias") for n in
                                    ("query", "key", "value")]),
                "out_w": w(p + "attn.out.weight").T.contiguous(),
                "out_b": w(p + "attn.out.bias"),
                "ln2": (w(p + "ln2.weight"), w(p + "ln2.bias")),
                "ff1_w": w(p + "ff1.weight").T.contiguous(),
                "ff1_b": w(p + "ff1.bias"),
                "ff2_w": w(p + "ff2.weight").T.contiguous(),
                "ff2_b": w(p + "ff2.bias"),
            })
        self.device = self.emb.device
        # the skip search's segment steps over static buffers, and their
        # CUDA graphs, one store a data shard
        # (``decode/beam_lm_device.StepStore``)
        self.segment_graphs = {}
        # int8 step (``quant_int8``): FF1, FF2 and the tied logits run
        # s8 x s8 -> s32 (kernel I1 on the card) with static per-out-channel
        # weight scales from the compute-dtype weights and a dynamic
        # per-tensor scale of the live x, as the JAX package's ``_q_mm``.
        # Attention, the KV cache and the LayerNorms stay in the compute
        # dtype, and so do the peeks of ``decode/beam_lm_device``: only
        # ``step`` takes the int8 branch, as in the JAX package.
        self.quant_int8 = bool(quant_int8)
        self._wq = {}
        if self.quant_int8:
            def quant(name, w_out_in):               # (N, K) -> packed s8
                w_q, s_w = int8_conv.quantize_weight(w_out_in, (1,))
                self._wq[name] = (int8_conv.pack_weight(w_q),
                                  s_w.reshape(-1))
            for i, lp in enumerate(self.layers):
                quant(f"ff1_{i}", lp["ff1_w"].T)
                quant(f"ff2_{i}", lp["ff2_w"].T)
            quant("logits", self.emb)

    # ------------------------------------------------------------ plumbing
    def replica(self, device) -> "CachedLM":
        """This LM with its weights copied to ``device`` once (itself where
        they already are): one replica a data shard."""
        device = mesh.canonical(device)
        if device == self.device:
            return self

        def to(x):
            if isinstance(x, torch.Tensor):
                return x.to(device)
            if isinstance(x, (tuple, list)):
                return type(x)(to(v) for v in x)
            if isinstance(x, dict):
                return {k: to(v) for k, v in x.items()}
            return x
        new = copy.copy(self)
        for name in ("emb", "emb32", "pos", "ln_f", "layers", "_wq"):
            setattr(new, name, to(getattr(self, name)))
        new.device = device
        new.segment_graphs = {}
        return new

    def init_cache(self, B: int, max_len: int) -> LMCache:
        shape = (self.n_layers, B, max_len, self.n_heads, self.d_head)
        return LMCache(
            k=torch.zeros(shape, dtype=self.dtype, device=self.device),
            v=torch.zeros(shape, dtype=self.dtype, device=self.device),
            lengths=torch.zeros((B,), dtype=torch.int32, device=self.device))

    @staticmethod
    def gather(cache: LMCache, idx: torch.Tensor) -> LMCache:
        """Beam reorder alone (plain indexing): ``new[l, p] =
        cache[l, idx[p]]``, lengths too."""
        idx = idx.long()
        return LMCache(k=cache.k[:, idx], v=cache.v[:, idx],
                       lengths=cache.lengths[idx])

    @staticmethod
    def gather_write(cache: LMCache, idx: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, wpos: torch.Tensor,
                     out: Optional[LMCache] = None) -> LMCache:
        """Beam reorder and one-token-per-row write (kernel K4 on the card):
        ``new.k[l, p, t] = k_new[l, p] if t == wpos[p] else
        cache.k[l, idx[p], t]``; ``wpos[p] >= Lmax`` writes nothing. Lengths
        are reordered, not advanced: the caller owns them. ``out``: a
        cache whose k/v receive the result (its lengths are not touched)."""
        args = (cache.k, cache.v, idx, k_new, v_new, wpos)
        k, v = (cache_gather.gather_write_kv(*args) if out is None else
                cache_gather.gather_write_kv(*args, out=(out.k, out.v)))
        return LMCache(k=k, v=v, lengths=cache.lengths[idx.long()])

    # ------------------------------------------------------------- layers
    @staticmethod
    def _ln(x, p):
        return layer_norm(x, *p)

    def _qkv_proj(self, x, li):
        """``(..., d)`` -> q, k, v ``(..., H, Dh)`` from one product."""
        lp = self.layers[li]
        out = x @ lp["qkv_w"] + lp["qkv_b"]
        out = out.view(*x.shape[:-1], 3, self.n_heads, self.d_head)
        return out[..., 0, :, :], out[..., 1, :, :], out[..., 2, :, :]

    def _attn_out(self, o, li):
        """``(..., H, Dh)`` -> ``(..., d)``."""
        lp = self.layers[li]
        return o.reshape(*o.shape[:-2], -1) @ lp["out_w"] + lp["out_b"]

    def _ff(self, h, li):
        """FF1 -> ReLU -> FF2 of ``step``: int8 under ``quant_int8``, each
        stage dequantised in f32 with its bias, then the compute dtype."""
        if not self.quant_int8:
            return self._ff_float(h, li)
        lp = self.layers[li]
        rows = h.reshape(-1, h.shape[-1])
        y = torch.relu(int8_conv.linear_int8(
            rows, *self._wq[f"ff1_{li}"], lp["ff1_b"].float(), self.dtype))
        y = int8_conv.linear_int8(y, *self._wq[f"ff2_{li}"],
                                  lp["ff2_b"].float(), self.dtype)
        return y.view(*h.shape[:-1], -1)

    def _ff_float(self, h, li):
        """FF1 -> ReLU -> FF2 in the compute dtype (the peeks' always)."""
        lp = self.layers[li]
        h = torch.relu(h @ lp["ff1_w"] + lp["ff1_b"])
        return h @ lp["ff2_w"] + lp["ff2_b"]

    def _embed_token(self, tokens, pos):
        """Embedding in the compute dtype, times sqrt(d) in that dtype, plus
        the positional row. Positions past ``max_len`` read its last row,
        as JAX's clamped gather does."""
        scale = torch.tensor(self.d_model ** 0.5, dtype=self.dtype)
        pos = pos.long().clamp(0, self.pos.shape[0] - 1)
        return self.emb[tokens.long()] * scale + self.pos[pos]

    def _logits(self, x):
        """Final LayerNorm and the tied head, f32 logits (f32 products of
        the compute-dtype operands, or int8 under ``quant_int8``)."""
        x = self._ln(x, self.ln_f)
        if self.quant_int8:
            rows = x.reshape(-1, x.shape[-1])
            return int8_conv.linear_int8(rows, *self._wq["logits"], None,
                                         torch.float32).view(
                                             *x.shape[:-1], -1)
        return x.float() @ self.emb32.T

    # ---------------------------------------------------------------- step
    def step(self, cache: LMCache, tokens: torch.Tensor,
             write_mask: Optional[torch.Tensor] = None):
        """Consume one token per batch element at its current position.

        Returns the next-token logits ``(B, V)`` f32 and the updated cache.
        Where ``write_mask`` is False the element's cache and length are
        unchanged and its logits are garbage (callers mask them out)."""
        B = tokens.shape[0]
        Lmax = cache.k.shape[2]
        dev = tokens.device
        if write_mask is None:
            write_mask = torch.ones((B,), dtype=torch.bool, device=dev)
        pos = cache.lengths.long()
        x = self._embed_token(tokens, pos)                     # (B, d)
        pos_ids = torch.arange(Lmax, device=dev)[None, :]
        # the write lands at pos where written; no row matches elsewhere
        hit = (pos_ids == pos[:, None]) & write_mask[:, None]  # (B, Lmax)
        ctx_mask = torch.where(write_mask[:, None], pos_ids <= pos[:, None],
                               pos_ids < pos[:, None])
        new_k, new_v = [], []
        for li in range(self.n_layers):
            hn = self._ln(x, self.layers[li]["ln1"])
            q, k_t, v_t = self._qkv_proj(hn, li)               # (B, H, Dh)
            k_li = torch.where(hit[:, :, None, None], k_t[:, None],
                               cache.k[li])
            v_li = torch.where(hit[:, :, None, None], v_t[:, None],
                               cache.v[li])
            new_k.append(k_li)
            new_v.append(v_li)
            s = torch.einsum("bhk,blhk->bhl", q.float(), k_li.float())
            s = s / math.sqrt(self.d_head)
            s = torch.where(ctx_mask[:, None, :], s, NEG)
            wts = torch.softmax(s, dim=-1).to(v_li.dtype)
            o = torch.einsum("bhl,blhk->bhk", wts, v_li)
            x = x + self._attn_out(o, li)
            x = x + self._ff(self._ln(x, self.layers[li]["ln2"]), li)
        logits = self._logits(x)
        lengths = torch.where(write_mask, cache.lengths + 1, cache.lengths)
        return logits, LMCache(k=torch.stack(new_k), v=torch.stack(new_v),
                               lengths=lengths.to(torch.int32))

    # ---------------------------------------------------------------- peek
    def peek_logprobs(self, cache: LMCache, next_logp: torch.Tensor,
                      suffix: torch.Tensor,
                      suffix_len: torch.Tensor) -> torch.Tensor:
        """Sum of the log-probs of ``suffix`` given each element's cached
        prefix, committing nothing to the cache.

        ``next_logp (B, V)`` is the log-softmax of the last committed
        ``step``'s logits and scores ``suffix[:, 0]``; the other suffix
        tokens run transiently, their k/v in ``(B, S, H, Dh)`` scratch
        appended to the cache's context. ``suffix (B, S)``, ``suffix_len
        (B,) <= S``; returns ``(B,)`` f32."""
        B, S = suffix.shape
        Lmax = cache.k.shape[2]
        dev = suffix.device
        suffix = suffix.long()
        lengths = cache.lengths.long()
        cache_mask = (torch.arange(Lmax, device=dev)[None, :]
                      < lengths[:, None])                      # (B, Lmax)
        first = next_logp.gather(-1, suffix[:, :1])[:, 0]
        total = torch.where(suffix_len > 0, first, torch.zeros_like(first))
        if S == 1:
            return total
        scratch_k = cache.k.new_zeros(
            (self.n_layers, B, S, self.n_heads, self.d_head))
        scratch_v = torch.zeros_like(scratch_k)
        s_ids = torch.arange(S, device=dev)[None, :]
        # token s sits at absolute position lengths + s
        x = self._embed_token(suffix[:, 0], lengths)
        for s in range(S - 1):
            h = x
            mask = torch.cat([cache_mask, (s_ids <= s).expand(B, S)], dim=1)
            for li in range(self.n_layers):
                lp = self.layers[li]
                q, k_t, v_t = self._qkv_proj(self._ln(h, lp["ln1"]), li)
                scratch_k[li, :, s] = k_t.to(scratch_k.dtype)
                scratch_v[li, :, s] = v_t.to(scratch_v.dtype)
                ctx_k = torch.cat([cache.k[li], scratch_k[li]], dim=1)
                ctx_v = torch.cat([cache.v[li], scratch_v[li]], dim=1)
                sc = torch.einsum("bhk,blhk->bhl", q.float(), ctx_k.float())
                sc = torch.where(mask[:, None, :],
                                 sc / math.sqrt(self.d_head), NEG)
                wts = torch.softmax(sc, dim=-1).to(ctx_v.dtype)
                h = h + self._attn_out(
                    torch.einsum("bhl,blhk->bhk", wts, ctx_v), li)
                h = h + self._ff(self._ln(h, lp["ln2"]), li)
            logp = torch.log_softmax(self._logits(h), dim=-1)
            contrib = logp.gather(-1, suffix[:, s + 1:s + 2])[:, 0]
            total = total + torch.where(s + 1 < suffix_len, contrib,
                                        torch.zeros_like(contrib))
            x = self._embed_token(suffix[:, s + 1], lengths + s + 1)
        return total
