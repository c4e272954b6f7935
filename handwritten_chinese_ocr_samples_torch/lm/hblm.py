"""HBLM — first-party memory-mapped binary n-gram format (the JAX package's
``lm/hblm.py``, a copy: a file either package writes is byte-equal to the
other's, ``tests/test_torch_ngram.py``).

Plays the role KenLM's binary ``.klm`` plays in the reference
(`ctc_codec.py:120-122` loads ``kenlm.Model(path)``; the third-party
recipe builds it with ``build_binary``): instant model load for host
serving instead of re-parsing the ARPA text on every process start.
KenLM's own binary format is undocumented/unstable across versions, so
the framework defines its own: a flat little-endian file of open-addressed
hash tables, usable zero-copy via ``mmap`` from both Python (this module)
and the native C++ CBS decoder (``native/cbs_decoder.cc`` sniffs the magic
and mmaps the same layout).

Scoring semantics are identical to ``lm/arpa.py`` — ``kenlm.Model.score``
log10 Katz backoff — locked by equality tests.

File layout (all little-endian; offsets 8-byte aligned):

    0     magic            8 bytes  b"HBLM\\x01\\x00\\x00\\x00"
    8     order            uint32   N
    12    n_vocab          uint32   unigram count (word id space)
    16    vocab_blob_len   uint64   bytes of '\\n'-joined utf-8 words
    24    counts[N]        uint64   n-gram entries per order (1..N)
    24+8N slots[N-1]       uint64   hash-table slots per order (2..N)
    ...   vocab blob       words joined by '\\n', id = position; padded to 8
    ...   unigram array    n_vocab x {f32 prob, f32 backoff}
    ...   per order 2..N   slots[n] x {u64 keyhash, f32 prob, f32 backoff}

Word ids are unigram-section order (0..n_vocab-1). Higher-order keys are a
64-bit mix of the id sequence (FNV-1a step + splitmix64 finalizer); slots
use power-of-two tables with linear probing and ``2^64-1`` as the empty
sentinel. Like KenLM's probing format, lookups trust the 64-bit hash
(no stored key material) — collision probability is ~(entries^2)/2^64,
negligible at character-LM scale.
"""

from __future__ import annotations

import mmap
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

MAGIC = b"HBLM\x01\x00\x00\x00"
_EMPTY = 0xFFFFFFFFFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF
_ENTRY = np.dtype([("key", "<u8"), ("prob", "<f4"), ("backoff", "<f4")])
_UNI = np.dtype([("prob", "<f4"), ("backoff", "<f4")])


def ngram_hash(ids: Sequence[int]) -> int:
    """64-bit mix of a word-id sequence (must match the C++ twin)."""
    h = 0xCBF29CE484222325
    for i in ids:
        h ^= (int(i) + 0x9E3779B9) & _M64
        h = (h * 0x100000001B3) & _M64
    # splitmix64 finalizer — FNV alone avalanches poorly on short inputs
    h ^= h >> 30
    h = (h * 0xBF58476D1CE4E5B9) & _M64
    h ^= h >> 27
    h = (h * 0x94D049BB133111EB) & _M64
    h ^= h >> 31
    return 0 if h == _EMPTY else h


def _table_slots(n_entries: int) -> int:
    """Power-of-two slot count at <= 0.65 load."""
    slots = 4
    while slots * 0.65 < n_entries:
        slots *= 2
    return slots


def _pad8(n: int) -> int:
    return (8 - n % 8) % 8


def is_hblm(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(8) == MAGIC
    except OSError:
        return False


# ------------------------------------------------------------------ build
def build_hblm(arpa_path: str, out_path: str) -> None:
    """Convert a text ARPA model to an HBLM binary (the ``build_binary``
    role from the reference's kenlm recipe)."""
    from .arpa import ArpaLM

    src = ArpaLM(arpa_path)
    order = src.order

    # word id space = unigram entries, deterministic sorted order (the
    # ARPA dict is insertion-ordered by file; sorting makes the binary
    # independent of section ordering quirks)
    vocab = sorted(w for (w,) in (k for k in src.probs if len(k) == 1))
    word_id = {w: i for i, w in enumerate(vocab)}
    if "<unk>" not in word_id:
        raise ValueError(f"{arpa_path}: ARPA model has no <unk> unigram")

    counts = [0] * order
    for k in src.probs:
        counts[len(k) - 1] += 1

    # unigram dense arrays (packed 8 B/entry — id is implicit in position)
    uni = np.zeros((len(vocab),), dtype=_UNI)
    for w, i in word_id.items():
        uni["prob"][i] = src.probs[(w,)]
        uni["backoff"][i] = src.backoffs.get((w,), 0.0)

    # higher-order probing tables
    tables: List[np.ndarray] = []
    for n in range(2, order + 1):
        slots = _table_slots(counts[n - 1])
        tab = np.zeros((slots,), dtype=_ENTRY)
        tab["key"] = _EMPTY
        mask = slots - 1
        for k, p in src.probs.items():
            if len(k) != n:
                continue
            try:
                ids = [word_id[w] for w in k]
            except KeyError as e:
                raise ValueError(
                    f"{arpa_path}: {n}-gram word {e} has no unigram entry")
            h = ngram_hash(ids)
            s = h & mask
            while tab["key"][s] != _EMPTY:
                if tab["key"][s] == h:
                    break  # duplicate n-gram line: last write wins
                s = (s + 1) & mask
            tab["key"][s] = h
            tab["prob"][s] = p
            tab["backoff"][s] = src.backoffs.get(k, 0.0)
        tables.append(tab)

    blob = "\n".join(vocab).encode("utf-8")
    header = MAGIC + struct.pack("<II", order, len(vocab))
    header += struct.pack("<Q", len(blob))
    header += struct.pack(f"<{order}Q", *counts)
    if order > 1:
        header += struct.pack(f"<{order - 1}Q", *(len(t) for t in tables))

    with open(out_path, "wb") as f:
        f.write(header)
        f.write(b"\x00" * _pad8(len(header)))
        f.write(blob)
        f.write(b"\x00" * _pad8(len(blob)))
        f.write(uni.tobytes())
        for tab in tables:
            f.write(tab.tobytes())


# ------------------------------------------------------------------ load
class HblmLM:
    """mmap-backed n-gram model with ``kenlm.Model.score`` semantics.

    Same scoring surface as ``lm.arpa.ArpaLM`` (``score``, ``logprob``,
    ``order``) so callers (``KenLMBackend``, host beam search) are
    backend-agnostic.
    """

    def __init__(self, path: str):
        self.path = path
        f = open(path, "rb")
        try:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        finally:
            f.close()
        mm = self._mm
        if mm[:8] != MAGIC:
            raise ValueError(f"{path}: not an HBLM file")
        self.order, n_vocab = struct.unpack_from("<II", mm, 8)
        (blob_len,) = struct.unpack_from("<Q", mm, 16)
        off = 24
        self.counts = list(struct.unpack_from(f"<{self.order}Q", mm, off))
        off += 8 * self.order
        if self.order > 1:
            slots = struct.unpack_from(f"<{self.order - 1}Q", mm, off)
            off += 8 * (self.order - 1)
        else:
            slots = ()
        off += _pad8(off)
        blob = bytes(mm[off:off + blob_len])
        off += blob_len + _pad8(blob_len)
        self.vocab: List[str] = (
            blob.decode("utf-8").split("\n") if blob else [])
        if len(self.vocab) != n_vocab:
            raise ValueError(f"{path}: vocab blob count mismatch "
                             f"({len(self.vocab)} != {n_vocab})")
        self.word_id: Dict[str, int] = {
            w: i for i, w in enumerate(self.vocab)}
        if "<unk>" not in self.word_id:
            raise ValueError(f"{path}: model has no <unk>")
        self.unk_id = self.word_id["<unk>"]

        uni_bytes = n_vocab * 8
        self._uni = np.frombuffer(mm, dtype=_UNI, count=n_vocab, offset=off)
        off += uni_bytes + _pad8(uni_bytes)
        self._tables: List[np.ndarray] = []
        for n_slots in slots:
            self._tables.append(np.frombuffer(
                mm, dtype=_ENTRY, count=n_slots, offset=off))
            off += int(n_slots) * _ENTRY.itemsize

    # ------------------------------------------------------------ lookup
    def _find(self, ids: Tuple[int, ...]):
        """(prob, backoff) of an exact n-gram id tuple, or None."""
        n = len(ids)
        if n == 1:
            i = ids[0]
            row = self._uni[i]
            return float(row["prob"]), float(row["backoff"])
        tab = self._tables[n - 2]
        mask = len(tab) - 1
        h = ngram_hash(ids)
        s = h & mask
        keys = tab["key"]
        for _ in range(len(tab)):  # bounded: corrupt files raise, not hang
            k = int(keys[s])
            if k == h:
                row = tab[s]
                return float(row["prob"]), float(row["backoff"])
            if k == _EMPTY:
                return None
            s = (s + 1) & mask
        raise ValueError(f"{self.path}: hash table has no empty slots "
                         "(corrupt or truncated file)")

    def _logprob_ids(self, ctx: Tuple[int, ...], w: int) -> float:
        acc = 0.0
        while True:
            hit = self._find(ctx + (w,))
            if hit is not None:
                return hit[0] + acc
            if not ctx:
                return self._find((self.unk_id,))[0] + acc
            b = self._find(ctx)
            acc += b[1] if b is not None else 0.0
            ctx = ctx[1:]

    # ----------------------------------------------------------- scoring
    def _known_id(self, w: str) -> int:
        return self.word_id.get(w, self.unk_id)

    def logprob(self, context: Tuple[str, ...], word: str) -> float:
        """log10 p(word | context), words pre-mapped as in ``ArpaLM``."""
        ctx = tuple(self._known_id(w) for w in context)
        return self._logprob_ids(ctx[-(self.order - 1):] if self.order > 1
                                 else (), self._known_id(word))

    def score(self, sentence: str, bos: bool = True,
              eos: bool = True) -> float:
        """Total log10 probability — exactly ``kenlm.Model.score``."""
        ids = [self._known_id(w) for w in sentence.split()]
        if eos:
            ids.append(self._known_id("</s>"))
        ctx: Tuple[int, ...] = ((self._known_id("<s>"),) if bos else ())
        total = 0.0
        span = self.order - 1
        for w in ids:
            total += self._logprob_ids(ctx[-span:] if span else (), w)
            ctx = ctx + (w,)
        return total

    def close(self) -> None:
        # release mmap views before unmapping
        self._uni = None
        self._tables = []
        self._mm.close()


def load_ngram_lm(path: str):
    """ArpaLM or HblmLM by content sniff (text ARPA vs HBLM magic)."""
    if is_hblm(path):
        return HblmLM(path)
    from .arpa import ArpaLM
    return ArpaLM(path)
