"""Character tokenizer over a fairseq-style dictionary.

The port's own copy of the JAX package's ``lm/tokenizer.py`` (pure Python
and numpy), with the same behavioural contract:

* vocabulary = four specials ``<s> <pad> </s> <unk>`` at ids 0-3 followed by
  the dictionary entries in file order from id 4;
* ``tokenize`` emits ``<s>`` + token ids, padding the tail — and every row
  shorter than the widest — with ``</s>`` (the reference found sos-prefix +
  eos-fill to work better than pad-fill for its LM);
* when no fixed length is given, the row width derives from the *character*
  length of the longest input string plus one — even in whitespace-token
  mode, where that overshoots the token count (a reference quirk callers
  rely on for shape stability);
* ``decode`` yields only real vocabulary entries (ids 4+).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

_SPECIALS = ("<s>", "<pad>", "</s>", "<unk>")
SOS, PAD, EOS, UNK = range(4)


def _read_dict(path: str) -> Iterable[str]:
    """Yield vocabulary entries from a ``<entry> <count>`` per-line file."""
    with open(path, encoding="utf-8") as fh:
        for lineno, raw in enumerate(fh, start=1):
            # strip all trailing whitespace: "中 5 \n" must yield "中",
            # not a "中 5" symbol (hand-edited dict files do this)
            parts = raw.rstrip().rsplit(" ", 1)
            if len(parts) != 2:
                raise ValueError(
                    f"{path}:{lineno}: malformed dictionary line {raw!r}")
            yield parts[0]


class Tokenizer:
    """Maps characters (or whitespace tokens) to LM ids and back."""

    sos_index = SOS
    pad_index = PAD
    eos_index = EOS
    unk_index = UNK

    def __init__(self, dict_file: str):
        self._build(_read_dict(dict_file))

    @classmethod
    def from_characters(cls, characters: str) -> "Tokenizer":
        """Build directly from a vocabulary string (fresh training runs)."""
        self = cls.__new__(cls)
        self._build(dict.fromkeys(characters))
        return self

    def _build(self, entries: Iterable[str]) -> None:
        self.symbols: List[str] = list(_SPECIALS)
        self.symbols.extend(entries)
        self.indices = {sym: i for i, sym in enumerate(self.symbols)}
        for sp in _SPECIALS:  # specials win any collision with entries
            self.indices[sp] = self.symbols.index(sp)

    @property
    def vocab_size(self) -> int:
        return len(self.symbols)

    def save_dict(self, path: str) -> None:
        """Write the non-special vocabulary back out in dict-file format."""
        with open(path, "w", encoding="utf-8") as fh:
            fh.writelines(f"{sym} 1\n" for sym in self.symbols[len(_SPECIALS):])

    def tokenize(self, sentences: Sequence[str], char_based: bool = False,
                 fixed_len: int = -1) -> np.ndarray:
        """Sentences -> ``(len(sentences), L)`` int64 id matrix."""
        if fixed_len > 0:
            width = fixed_len
        else:
            width = max((len(s) for s in sentences), default=0) + 1
        out = np.full((len(sentences), width), EOS, dtype=np.int64)
        out[:, 0] = SOS
        lookup = self.indices
        for row, sent in zip(out, sentences):
            toks = sent if char_based else sent.split()
            ids = [lookup.get(t, UNK) for t in toks[: width - 1]]
            row[1: 1 + len(ids)] = ids
        return out

    def decode(self, tokens: Sequence[int]) -> List[str]:
        """Ids -> vocabulary entries, dropping all special ids."""
        table = self.symbols
        return [table[t] for t in map(int, tokens) if t >= len(_SPECIALS)]
