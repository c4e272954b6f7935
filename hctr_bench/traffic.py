"""The one traffic generator: every mix is a file of parameters
(``traffic/<name>.json``) that this module reads.

``kind: closed``: one client hands the engine chunks, each one pass over
the line set, and waits for each chunk's texts before it sends the next.
The lines of one width bucket form fixed batches of ``batch_size`` (in
name order, the short batch last); a chunk sends the buckets, their
batches and each batch's lines in orders drawn from the seed, so that the engine, which batches each bucket's lines in the order
they come, runs the same batches for every seed: the work of a chunk is
fixed, its order is the seed's.

``kind: open``: independent single-line requests due at a fixed mean rate
``rate_per_s``. The gaps between due times are the quantiles of the
exponential distribution at that rate, ``-ln(1 - (i + 1/2) / n) / rate``,
in an order drawn from the seed: every seed sends the same set of gaps
and, in whole passes over the line set, the same lines, in other orders.

Each stream has a generator of its own, from ``(seed, stream)``, so that
one stream's draws never shift another's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

ORDER, ARRIVALS, CHECK = 1, 2, 3


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


def chunk_order(seed: int, buckets: Sequence[int], batch: int,
                chunk: int) -> np.ndarray:
    """The line indices of chunk ``chunk`` (0, 1, ...) of a closed loop
    over lines whose width buckets are ``buckets``."""
    g = rng(seed, ORDER * 1000003 + chunk)
    groups = {}
    for i, b in enumerate(buckets):
        groups.setdefault(b, []).append(i)
    out = []
    for b in g.permutation(sorted(groups)).tolist():
        idx = groups[b]
        full = [idx[s:s + batch] for s in range(0, len(idx), batch)]
        short = [full.pop()] if len(full[-1]) < batch else []
        for k in g.permutation(len(full)).tolist() + list(
                range(len(full), len(full) + len(short))):
            rows = (full + short)[k]
            out += [rows[j] for j in g.permutation(len(rows))]
    return np.array(out)


def open_schedule(seed: int, n_lines: int, rate: float, seconds: float
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """``(due seconds from the window's start, line index)`` of each
    request due in ``[0, seconds)``."""
    n = int(round(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    g = rng(seed, ARRIVALS)
    gaps = gaps[g.permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    passes = -(-n // n_lines)
    lines = np.concatenate([g.permutation(n_lines) for _ in range(passes)])
    keep = due < seconds
    return due[keep], lines[:n][keep]


def check_sample(seed: int, population: Sequence[int], n: int,
                 always: Sequence[int] = ()) -> List[int]:
    """``n`` members of ``population`` drawn from the seed, plus each of
    ``always`` (the longest), in population order."""
    pop = list(population)
    g = rng(seed, CHECK)
    picked = set(g.choice(len(pop), size=min(n, len(pop)), replace=False)
                 .tolist())
    picked |= {pop.index(a) for a in always if a in pop}
    return [pop[i] for i in sorted(picked)]
