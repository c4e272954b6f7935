"""First-party n-gram estimator: char corpus -> ARPA model (the JAX
package's ``lm/ngram_train.py``, a copy: pure Python, no tensors, and its
ARPA output is byte-equal to the JAX package's,
``tests/test_torch_ngram_train.py``).

Plays the role kenlm's ``lmplz`` plays in the reference recipe
(`third-party/README.md:21-38`: train a 5-gram on the char-spaced corpus,
then ``build_binary`` it). kenlm is not installable in every environment,
so the framework estimates its own backoff models: interpolated
Witten-Bell smoothing, which needs no count-of-count statistics or
discount hyperparameters and stays well-behaved on the small synthetic
corpora the committed demos train on (modified Kneser-Ney degenerates
when count-of-counts are sparse).

The estimate is written as standard ARPA text, consumable by every
scorer in the stack — ``lm/arpa.py``, the HBLM binarizer
(``cli/lm_binarize``), the native C++ CBS decoder, and real kenlm.

Model definition (per history ``h`` with token count ``C(h)`` and
distinct-continuation count ``T(h)``):

    p(w | h)  = (c(hw) + T(h) * p(w | h')) / (C(h) + T(h))   for seen hw
    bow(h)    =  T(h)              / (C(h) + T(h))           otherwise

with ``h'`` the history minus its oldest word. Unseen-``hw`` mass equals
``bow(h) * p(w | h')`` exactly, so encoding seen probabilities plus the
backoff weight in ARPA form reproduces the interpolated model and every
conditional distribution sums to one (locked by the JAX package's
``tests/test_ngram_train.py``).
The unigram base case interpolates with the uniform distribution over the
predictable vocabulary (everything but ``<s>``); ``<s>`` itself is never
predicted and gets the conventional ``-99`` log10 stub, as lmplz writes it.
"""

from __future__ import annotations

import gzip
import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BOS, EOS, UNK = "<s>", "</s>", "<unk>"
_LOG10_STUB = -99.0  # conventional "never predicted" unigram stub for <s>


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def read_corpus(path: str) -> Iterable[List[str]]:
    """Token lists from a space-separated corpus file (``lm/corpus.py``
    output format); blank lines are skipped."""
    with _open(path) as f:
        for line in f:
            toks = line.split()
            if toks:
                yield toks


class NgramCounts:
    """Raw n-gram counts of a tokenized corpus, 1..order."""

    def __init__(self, order: int, vocab: Optional[Sequence[str]] = None):
        if order < 1:
            raise ValueError(f"order must be >= 1, got {order}")
        self.order = order
        # counts[n-1]: Counter over n-token tuples
        self.counts: List[Counter] = [Counter() for _ in range(order)]
        self.vocab: Optional[set] = set(vocab) if vocab is not None else None
        if self.vocab is not None:
            self.vocab -= {BOS, EOS, UNK}

    def _map(self, tok: str) -> str:
        if self.vocab is not None and tok not in self.vocab:
            return UNK
        return tok

    def add_sentence(self, tokens: Sequence[str]) -> None:
        toks = [BOS] + [self._map(t) for t in tokens] + [EOS]
        for n in range(1, self.order + 1):
            cn = self.counts[n - 1]
            for i in range(len(toks) - n + 1):
                if n == 1 and toks[i] == BOS:
                    continue  # <s> is context only, never a predicted event
                cn[tuple(toks[i:i + n])] += 1

    def add_corpus(self, sentences: Iterable[Sequence[str]]) -> "NgramCounts":
        for s in sentences:
            self.add_sentence(s)
        return self


def estimate_witten_bell(
    counts: NgramCounts,
) -> Tuple[Dict[Tuple[str, ...], float], Dict[Tuple[str, ...], float]]:
    """Interpolated Witten-Bell probabilities and backoff weights.

    Returns ``(log10_probs, log10_backoffs)`` keyed by n-gram tuple, in
    the backoff-ARPA encoding described in the module docstring.
    """
    order = counts.order
    if not counts.counts[0]:
        raise ValueError("empty corpus: no unigram events counted")

    # per-history token totals C(h) and continuation sets T(h), per order
    hist_total: List[Counter] = [Counter() for _ in range(order)]
    hist_cont: List[defaultdict] = [defaultdict(set) for _ in range(order)]
    for n in range(2, order + 1):
        for ng, c in counts.counts[n - 1].items():
            hist_total[n - 1][ng[:-1]] += c
            hist_cont[n - 1][ng[:-1]].add(ng[-1])

    probs: Dict[Tuple[str, ...], float] = {}
    backoffs: Dict[Tuple[str, ...], float] = {}

    # ---- unigrams: interpolate with uniform over the predictable vocab
    uni = counts.counts[0]
    vocab = sorted({w for (w,) in uni} | {UNK, EOS})
    n_tokens = sum(uni.values())
    t0 = len(uni)
    v = len(vocab)
    p_uni: Dict[str, float] = {}
    for w in vocab:
        p_uni[w] = (uni.get((w,), 0) + t0 / v) / (n_tokens + t0)
        probs[(w,)] = math.log10(p_uni[w])
    probs[(BOS,)] = _LOG10_STUB  # context-only event

    # ---- higher orders, bottom-up: when order n is estimated, every seen
    # (n-1)-gram prob and (n-2)-history backoff is already encoded, so the
    # interpolation target p(w|h') is a plain ARPA backoff walk.
    for n in range(2, order + 1):
        # backoff weights for the (n-1)-token histories actually observed
        # (written before the probs so the walk below can use them)
        for h in hist_total[n - 1]:
            bow = (len(hist_cont[n - 1][h])
                   / (hist_total[n - 1][h] + len(hist_cont[n - 1][h])))
            backoffs[h] = math.log10(bow)
        for ng, c in counts.counts[n - 1].items():
            h = ng[:-1]
            t_h = len(hist_cont[n - 1][h])
            c_h = hist_total[n - 1][h]
            p_low = _resolve_prob(ng[1:], probs, backoffs)
            probs[ng] = math.log10((c + t_h * p_low) / (c_h + t_h))

    return probs, backoffs


def _resolve_prob(ng, probs, backoffs) -> float:
    """Linear p(w | context) under the orders encoded so far — the
    standard ARPA backoff walk (longest match, multiply backoff weights
    while shortening the context)."""
    lp = probs.get(ng)
    if lp is not None:
        return 10.0 ** lp
    if len(ng) == 1:  # OOV (can't happen for corpus-derived queries)
        return 10.0 ** probs[(UNK,)]
    bow = backoffs.get(ng[:-1], 0.0)  # unseen context: free backoff
    return (10.0 ** bow) * _resolve_prob(ng[1:], probs, backoffs)


def write_arpa(
    probs: Dict[Tuple[str, ...], float],
    backoffs: Dict[Tuple[str, ...], float],
    order: int,
    out_path: str,
) -> None:
    """Serialize to standard ARPA text (what lmplz emits)."""
    by_order: List[List[Tuple[Tuple[str, ...], float]]] = [
        [] for _ in range(order)]
    for ng, lp in probs.items():
        by_order[len(ng) - 1].append((ng, lp))
    for rows in by_order:
        rows.sort(key=lambda r: r[0])

    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n")
        for n in range(1, order + 1):
            f.write(f"ngram {n}={len(by_order[n - 1])}\n")
        for n in range(1, order + 1):
            f.write(f"\n\\{n}-grams:\n")
            for ng, lp in by_order[n - 1]:
                word = " ".join(ng)
                bow = backoffs.get(ng) if n < order else None
                if bow is not None:
                    f.write(f"{lp:.7f}\t{word}\t{bow:.7f}\n")
                else:
                    f.write(f"{lp:.7f}\t{word}\n")
        f.write("\n\\end\\\n")


def train_ngram_arpa(
    corpus_path: str,
    out_path: str,
    order: int = 5,
    vocab: Optional[Sequence[str]] = None,
) -> Dict[str, int]:
    """corpus file -> ARPA file; returns ``{order_n: entry_count}``."""
    counts = NgramCounts(order, vocab=vocab).add_corpus(
        read_corpus(corpus_path))
    probs, backoffs = estimate_witten_bell(counts)
    write_arpa(probs, backoffs, order, out_path)
    sizes: Dict[str, int] = {}
    for ng in probs:
        sizes[f"ngram{len(ng)}"] = sizes.get(f"ngram{len(ng)}", 0) + 1
    return sizes
