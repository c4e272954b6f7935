"""Evaluation metrics: edit distance, CER, running meters (the JAX package's
``eval/metrics.py``).

``CER = sum(editdist(pred, truth)) / sum(len(truth))`` and ``acc = 1 - CER``
(`main.py:516-537`, `test.py:275-277`). The Levenshtein distance runs in
the port's own ``native/editdistance.cc``, compiled with the host C++
compiler at first use (``ops/_build.load_host``; a failed build raises).
``_levenshtein_np`` is the numpy version the tests hold it against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np

from ..ops import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_host("editdistance")
    lib.edit_distance_u32.restype = ctypes.c_int64
    lib.edit_distance_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64]
    return lib


def _levenshtein_np(a: np.ndarray, b: np.ndarray) -> int:
    """Row-vectorised DP Levenshtein over codepoint arrays."""
    if a.size == 0:
        return int(b.size)
    if b.size == 0:
        return int(a.size)
    prev = np.arange(b.size + 1, dtype=np.int64)
    cur = np.empty_like(prev)
    for i in range(1, a.size + 1):
        cur[0] = i
        sub = prev[:-1] + (b != a[i - 1])
        dele = prev[1:] + 1
        np.minimum(sub, dele, out=cur[1:])
        # insertion needs a sequential pass
        for j in range(1, b.size + 1):
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        prev, cur = cur, prev
    return int(prev[b.size])


def codepoints(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32)


def levenshtein(a: str, b: str) -> int:
    """Edit distance between two strings (unicode-codepoint granularity)."""
    aa, bb = codepoints(a), codepoints(b)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    return int(_lib().edit_distance_u32(aa.ctypes.data_as(u32p), aa.size,
                                        bb.ctypes.data_as(u32p), bb.size))


def cer_counts(preds: Sequence[str],
               truths: Sequence[str]) -> Tuple[int, int]:
    """(edit-distance sum, truth-length sum) of a batch; ``CER = dist_sum /
    len_sum`` accumulated over batches as `test.py:275-286` does."""
    dist = 0
    total = 0
    for p, t in zip(preds, truths):
        dist += levenshtein(p, t)
        total += len(t)
    return dist, total


class AverageMeter:
    """Running average meter (`main.py:561-576`)."""

    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)
