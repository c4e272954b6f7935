"""Text <-> CTC index codec (host side, pure numpy).

The port's own copy of the JAX package's ``core/codec.py``, cut to what the
serving, host beam and training paths use: the class space is
``['<blank>'] + chars + ['<unknown>']``, so ``blank_id`` is 0 and
``unknown_id`` is the last class, ``dict`` maps a character to its class,
labels are encoded for the CTC loss, and decoded index rows become strings
on the host.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def load_chars_list(path: str) -> str:
    """Load a vocabulary file (one character per line) into a string."""
    with open(path, "r", encoding="utf-8") as f:
        return "".join(line.strip("\n") for line in f)


class CTCCodec:
    """CTC class space over a vocabulary.

    ``num_classes = 1 (blank) + len(chars) + 1 (unknown)``.
    """

    def __init__(self, characters: str):
        self.chars_list = list(characters)
        self.dict = {c: i + 1 for i, c in enumerate(self.chars_list)}
        self.characters = ["<blank>"] + self.chars_list + ["<unknown>"]
        self.blank_id = 0
        self.unknown_id = len(self.characters) - 1
        self.dict["<blank>"] = self.blank_id
        self.dict["<unknown>"] = self.unknown_id
        # U1 table for vectorized index->string conversion (decoded rows
        # never hold blank/unknown, so placeholders are safe there).
        self._chars_u1 = np.array(["\x00"] + self.chars_list + ["\x00"],
                                  dtype="U1")

    @property
    def num_classes(self) -> int:
        return len(self.characters)

    def encode(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Text labels -> concatenated int32 index stream + int32 lengths;
        unknown characters map to the unknown index."""
        lengths = np.array([len(s) for s in texts], dtype=np.int32)
        flat = np.fromiter(
            (self.dict.get(ch, self.unknown_id) for s in texts for ch in s),
            dtype=np.int32,
            count=int(lengths.sum()),
        )
        return flat, lengths

    def encode_padded(
        self, texts: Sequence[str], max_len: int | None = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Text labels -> ``(B, L)`` int32 labels + ``(B, L)`` f32 paddings
        (1.0 marks padding); labels longer than ``max_len`` are cut."""
        lengths = [len(s) for s in texts]
        L = max_len if max_len is not None else max(lengths + [1])
        labels = np.zeros((len(texts), L), dtype=np.int32)
        paddings = np.ones((len(texts), L), dtype=np.float32)
        for i, s in enumerate(texts):
            n = min(len(s), L)
            labels[i, :n] = [self.dict.get(ch, self.unknown_id) for ch in s[:n]]
            paddings[i, :n] = 0.0
        return labels, paddings

    def compact_to_texts(self, chars: np.ndarray,
                         lengths: np.ndarray) -> List[str]:
        """Left-compacted ``(B, T)`` char indices + ``(B,)`` lengths ->
        strings, via one vectorized U1 gather per row."""
        chars = np.asarray(chars)
        lengths = np.asarray(lengths)
        out = []
        for b in range(chars.shape[0]):
            n = int(lengths[b])
            if n == 0:
                out.append("")
                continue
            row = self._chars_u1[chars[b, :n]]
            out.append(row.view(f"U{n}")[0])
        return out

