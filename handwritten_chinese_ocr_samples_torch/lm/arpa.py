"""ARPA n-gram language model with KenLM ``score`` semantics (the JAX
package's ``lm/arpa.py``, a copy: pure Python, no tensors).

The reference's n-gram beam search calls
``kenlm.Model(path).score(' '.join(chars), eos=False)``
(`ctc_codec.py:120-122,276-281`). This module reads the standard ARPA text
format and reproduces ``score()`` exactly: per-word conditional log10
probabilities under Katz backoff, ``<s>`` context when ``bos`` (default),
an optional ``</s>`` term when ``eos``, out-of-vocabulary words mapped to
``<unk>``. An n-gram lookup is a hash-table walk on the host; the card runs
the transformer LM (``lm/model.py``).
"""

from __future__ import annotations

import gzip
import re
from typing import Dict, Sequence, Tuple

_NGRAM_RE = re.compile(r"^ngram (\d+)=(\d+)")


class ArpaLM:
    """ARPA-file n-gram model with KenLM ``score`` semantics (log10)."""

    def __init__(self, path: str):
        # probs[ngram tuple] = log10 p ; backoffs[ngram tuple] = log10 b
        self.probs: Dict[Tuple[str, ...], float] = {}
        self.backoffs: Dict[Tuple[str, ...], float] = {}
        self.order = 0
        self._load(path)

    def _load(self, path: str) -> None:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            section = 0  # 0 = header, N = reading N-grams
            for raw in f:
                line = raw.strip()
                if not line:
                    continue
                if line == "\\end\\":
                    break
                if line.startswith("\\") and line.endswith("-grams:"):
                    section = int(line[1:].split("-")[0])
                    self.order = max(self.order, section)
                    continue
                if section == 0:
                    continue  # header counts are not needed for lookup
                # fields are whitespace-separated (tabs between prob /
                # ngram / backoff, spaces between ngram words)
                parts = line.split()
                if len(parts) < section + 1:
                    continue
                logp = float(parts[0])
                words = tuple(parts[1: 1 + section])
                self.probs[words] = logp
                if len(parts) > section + 1:
                    self.backoffs[words] = float(parts[1 + section])
        if self.order == 0:
            raise ValueError(f"no n-gram sections found in {path}")

    # -------------------------------------------------------------- scoring
    def _known(self, w: str) -> str:
        return w if (w,) in self.probs else "<unk>"

    def logprob(self, context: Tuple[str, ...], word: str) -> float:
        """log10 p(word | context) with Katz backoff.

        ``context`` is already vocabulary-mapped and capped to order-1.
        """
        ng = context + (word,)
        p = self.probs.get(ng)
        if p is not None:
            return p
        if not context:
            return self.probs[("<unk>",)]   # safety net; words pre-mapped
        return (self.backoffs.get(context, 0.0)
                + self.logprob(context[1:], word))

    def score(self, sentence: str, bos: bool = True,
              eos: bool = True) -> float:
        """Total log10 probability of a space-separated sentence.

        Same contract as ``kenlm.Model.score`` — the reference calls it
        with ``eos=False`` on space-joined characters
        (`ctc_codec.py:276-281`).
        """
        words = [self._known(w) for w in sentence.split()]
        if eos:
            words = words + ["</s>"]
        context: Tuple[str, ...] = ("<s>",) if bos else ()
        total = 0.0
        for w in words:
            total += self.logprob(context[-(self.order - 1):]
                                  if self.order > 1 else (), w)
            context = context + (w,)
        return total

    def full_scores(self, sentence: str, bos: bool = True,
                    eos: bool = True):
        """Per-word (log10 prob, ngram order used, is_oov) like kenlm's."""
        raw = sentence.split()
        words = [self._known(w) for w in raw]
        oov = [w != k for w, k in zip(raw, words)]
        if eos:
            words = words + ["</s>"]
            oov = oov + [False]
        context: Tuple[str, ...] = ("<s>",) if bos else ()
        for w, is_oov in zip(words, oov):
            ctx = context[-(self.order - 1):] if self.order > 1 else ()
            # find matched order
            used = 1
            for k in range(len(ctx), -1, -1):
                if ctx[len(ctx) - k:] + (w,) in self.probs:
                    used = k + 1
                    break
            yield self.logprob(ctx, w), used, is_oov
            context = context + (w,)


def score_sentences(model: ArpaLM, sentences: Sequence[str],
                    eos: bool = False):
    """Batch scoring of space-joined character sentences."""
    return [model.score(s, eos=eos) for s in sentences]
