"""Decoder-only character transformer LM (the JAX package's ``lm/model.py``).

Pre-norm blocks, learned positional embedding, tied input/output embedding
by default. Module and parameter names follow the flax tree, so
``utils.weights.lm_flax_to_torch`` maps one onto the other by path:

  * ``embed.weight`` ``(V, d)`` is flax ``embed/embedding``;
  * ``pos_embed`` ``(max_len, d)``;
  * ``layer{i}.attn.{query,key,value}`` are ``nn.Linear(d, H*Dh)`` (flax
    kernels ``(d, H, Dh)``), ``layer{i}.attn.out`` is ``nn.Linear(H*Dh, d)``
    (flax ``(H, Dh, d)``);
  * LayerNorms use eps 1e-6 with f32 statistics, as flax does.

``dtype`` is the compute dtype: parameters stay f32 and are cast at use, and
the logits come out f32.

Train mode (``model.train()`` with ``dropout > 0``) runs flax's five dropout
sites, each ``keep / (1 - rate)`` with ``keep ~ Bernoulli(1 - rate)`` drawn
from the ``generator`` passed to ``forward``: after the embedding plus
position, on the attention weights (one ``(1, 1, Lq, Lk)`` mask shared by
the batch and the heads, as flax's ``broadcast_dropout`` has it), after
attention, after ``relu(ff1)`` and after ``ff2``. The masks differ from
JAX's (no torch generator reproduces ``jax.random``). The eval forward has
no dropout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6

# Published configurations. ``char-512x6`` is the serving LM of the full-size
# artifact (the JAX package's ``demo/full/lm/config.json``), kept here because
# the card's machine does not receive that directory.
_CONFIGS = {
    "char-512x6": {"vocab_size": 7377, "d_model": 512, "n_layers": 6,
                   "n_heads": 8, "d_ff": 2048, "max_len": 160,
                   "dropout": 0.1, "tie_embeddings": True},
}


class Dropout:
    """The dropout of one forward: off without a generator, else flax's
    with ``keep ~ Bernoulli(1 - rate)`` drawn from ``generator`` on the
    activation's device."""

    def __init__(self, rate: float, generator: Optional[torch.Generator]):
        self.rate, self.generator = rate, generator

    def __call__(self, x: torch.Tensor, broadcast: bool = False
                 ) -> torch.Tensor:
        """``nn.Dropout``'s ``where(keep, x / (1 - rate), 0)``; with
        ``broadcast`` the attention weights' ``x * keep / (1 - rate)``, one
        ``(1, 1, Lq, Lk)`` mask for every batch row and head."""
        if self.generator is None:
            return x
        shape = (1, 1, *x.shape[-2:]) if broadcast else x.shape
        keep = torch.rand(shape, generator=self.generator,
                          device=x.device) < 1 - self.rate
        keep_prob = torch.tensor(1 - self.rate, dtype=x.dtype,
                                 device=x.device)
        if broadcast:
            return x * (keep.to(x.dtype) / keep_prob)
        return torch.where(keep, x / keep_prob, 0)


def get_lm_config(tag: str) -> dict:
    """A copy of the named LM configuration (``CharTransformerLM`` kwargs)."""
    if tag not in _CONFIGS:
        raise ValueError(f"unknown LM config {tag!r} "
                         f"(available: {sorted(_CONFIGS)})")
    return dict(_CONFIGS[tag])


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics and eps 1e-6; returns ``x.dtype``."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + LN_EPS)
    return (y * weight.float() + bias.float()).to(x.dtype)


class _LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return layer_norm(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``x @ W.T + b`` in ``x.dtype`` (product rounded before the bias add,
    as flax's Dense does)."""
    return x @ lin.weight.to(x.dtype).T + lin.bias.to(x.dtype)


class _Attention(nn.Module):
    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)
        self.out = nn.Linear(d, d)

    def forward(self, x, causal, drop: Dropout):
        B, L, d = x.shape
        H = self.n_heads
        Dh = d // H
        q = _linear(x, self.query).view(B, L, H, Dh)
        k = _linear(x, self.key).view(B, L, H, Dh)
        v = _linear(x, self.value).view(B, L, H, Dh)
        q = q / math.sqrt(Dh)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        s = s.masked_fill(~causal, torch.finfo(s.dtype).min)
        w = drop(torch.softmax(s, dim=-1), broadcast=True)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, d)
        return _linear(o, self.out)


class _Block(nn.Module):
    def __init__(self, d: int, n_heads: int, d_ff: int):
        super().__init__()
        self.ln1 = _LayerNorm(d)
        self.attn = _Attention(d, n_heads)
        self.ln2 = _LayerNorm(d)
        self.ff1 = nn.Linear(d, d_ff)
        self.ff2 = nn.Linear(d_ff, d)

    def forward(self, x, causal, drop: Dropout):
        x = x + drop(self.attn(self.ln1(x), causal, drop))
        h = drop(F.relu(_linear(self.ln2(x), self.ff1)))
        return x + drop(_linear(h, self.ff2))


class CharTransformerLM(nn.Module):
    """``tokens (B, L)`` int -> ``logits (B, L, V)`` f32; position t
    predicts token t + 1."""

    def __init__(self, vocab_size: int, d_model: int = 512, n_layers: int = 6,
                 n_heads: int = 8, d_ff: int = 2048, max_len: int = 512,
                 dropout: float = 0.1, tie_embeddings: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.d_ff = d_ff
        self.max_len = max_len
        self.dropout = dropout
        self.tie_embeddings = tie_embeddings
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, d_model))
        for i in range(n_layers):
            self.add_module(f"layer{i}", _Block(d_model, n_heads, d_ff))
        self.ln_f = _LayerNorm(d_model)
        if not tie_embeddings:
            self.lm_head = nn.Linear(d_model, vocab_size, bias=False)

    def config(self) -> dict:
        return {"vocab_size": self.vocab_size, "d_model": self.d_model,
                "n_layers": self.n_layers, "n_heads": self.n_heads,
                "d_ff": self.d_ff, "max_len": self.max_len,
                "dropout": self.dropout,
                "tie_embeddings": self.tie_embeddings}

    def forward(self, tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the train-mode dropout masks; train mode
        with ``dropout > 0`` needs one."""
        B, L = tokens.shape
        dt = self.dtype
        train = self.training and self.dropout > 0
        if train and generator is None:
            raise ValueError("train-mode dropout needs a generator")
        drop = Dropout(self.dropout, generator if train else None)
        scale = torch.tensor(self.d_model ** 0.5, dtype=dt)
        x = self.embed.weight.to(dt)[tokens] * scale + self.pos_embed[:L].to(dt)
        x = drop(x)
        causal = torch.ones(L, L, dtype=torch.bool,
                            device=tokens.device).tril()
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x, causal, drop)
        x = self.ln_f(x)
        head = (self.embed.weight if self.tie_embeddings
                else self.lm_head.weight)
        return (x @ head.to(dt).T).float()
