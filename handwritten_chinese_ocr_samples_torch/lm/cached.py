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

import math
from typing import NamedTuple, Optional

import torch

from ..ops import cache_gather
from .model import layer_norm

NEG = -1e30


class LMCache(NamedTuple):
    k: torch.Tensor        # (layers, B, Lmax, H, Dh)
    v: torch.Tensor        # (layers, B, Lmax, H, Dh)
    lengths: torch.Tensor  # (B,) int32 tokens already consumed


class CachedLM:
    """Single-token step and cache reorder over a ``CharTransformerLM``
    state dict (``lm/model.py`` names)."""

    def __init__(self, model, state_dict, dtype: Optional[torch.dtype] = None,
                 quant_int8: bool = False,
                 device: Optional[torch.device] = None):
        if quant_int8:
            raise NotImplementedError(
                "not ported yet: int8 LM matmuls (ROADMAP.md queue 1, "
                "item 5)")
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

    # ------------------------------------------------------------ plumbing
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
                     v_new: torch.Tensor, wpos: torch.Tensor) -> LMCache:
        """Beam reorder and one-token-per-row write (kernel K4 on the card):
        ``new.k[l, p, t] = k_new[l, p] if t == wpos[p] else
        cache.k[l, idx[p], t]``; ``wpos[p] >= Lmax`` writes nothing. Lengths
        are reordered, not advanced: the caller owns them."""
        k, v = cache_gather.gather_write_kv(cache.k, cache.v, idx, k_new,
                                            v_new, wpos)
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
        the compute-dtype operands)."""
        x = self._ln(x, self.ln_f)
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
