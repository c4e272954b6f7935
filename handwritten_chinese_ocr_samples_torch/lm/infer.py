"""Batched LM inference for the host beam: ``score`` and ``next_k_words``
(the JAX package's ``lm/infer.py``).

API parity with the reference's fairseq wrapper (`transformer_infer.py:41-76`):

  * ``score(sentences)``: sum of positional log-probs of each sentence's
    tokens — position ``t`` of the logits scores token ``t+1``; the sum runs
    over the first ``len(sentence)`` positions;
  * ``next_k_words(sentences, k)``: top-k vocabulary entries at position
    ``len(sentence)``, special symbols dropped by ``Tokenizer.decode``.

One forward of ``lm/model.CharTransformerLM`` on the scorer's device per
call; only one float or k indices per sentence come back to the host. Token
rows are ``<s>``, the sentence and ``</s>`` padding to the longest sentence
+ 2. The JAX scorer pads further, to multiples of 32, so that XLA compiles
each length once; eager PyTorch has nothing to compile, and the shorter
rows are a third of the work on short prefixes. The mask is causal, so the
padding changes no score. Ties in the top-k go to the lower id, as
``jax.lax.top_k`` sends them.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .tokenizer import Tokenizer


class LMScorer:
    """``model`` (a ``CharTransformerLM``, left untouched) and its
    ``state_dict`` run on ``device`` in the model's dtype."""

    def __init__(self, model, state_dict, tokenizer: Tokenizer,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.model = type(model)(**model.config(), dtype=model.dtype)
        self.model.load_state_dict(state_dict)
        self.model = self.model.to(self.device).eval()
        self.tokenizer = tokenizer

    def _tokens(self, sentences: Sequence[str], char_based: bool):
        ids = self.tokenizer.tokenize(
            sentences, char_based=char_based,
            fixed_len=max(len(s) for s in sentences) + 2)
        lengths = torch.tensor([len(s) for s in sentences],
                               device=self.device)
        return torch.from_numpy(ids).to(self.device), lengths

    @torch.inference_mode()
    def score(self, sentences: List[str], char_based: bool = False
              ) -> np.ndarray:
        if not sentences:
            return np.zeros((0,))
        tokens, lengths = self._tokens(sentences, char_based)
        logp = torch.log_softmax(self.model(tokens), dim=-1)   # (B, L, V)
        pos = logp[:, :-1].gather(-1, tokens[:, 1:, None])[..., 0]
        mask = (torch.arange(pos.shape[1], device=self.device)[None, :]
                < lengths[:, None])
        return (pos * mask).sum(-1).cpu().numpy()

    @torch.inference_mode()
    def next_k_words(self, sentences: List[str], k: int,
                     char_based: bool = False) -> List[List[str]]:
        if not sentences:
            return []
        tokens, lengths = self._tokens(sentences, char_based)
        logits = self.model(tokens)
        at = logits[torch.arange(len(sentences), device=self.device),
                    lengths]                                   # (B, V)
        idx = torch.sort(at, dim=-1, descending=True,
                         stable=True).indices[:, :k].cpu().numpy()
        return [self.tokenizer.decode(row) for row in idx]

    def perplexity(self, sentences: List[str], char_based: bool = True
                   ) -> float:
        """Corpus perplexity (exp of the mean NLL per token, base e),
        comparable to the reference's fairseq eval target
        (`third-party/README.md:95`: PPL ~29)."""
        total_lp, total_tok = 0.0, 0
        for i in range(0, len(sentences), 64):
            chunk = sentences[i: i + 64]
            scores = self.score(chunk, char_based=char_based)
            total_lp += float(scores.sum())
            total_tok += sum(len(s) for s in chunk)
        return float(np.exp(-total_lp / max(total_tok, 1)))
