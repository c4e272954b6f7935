"""CTC posteriors with a trained recognizer's statistics (a copy of the JAX
package's ``utils/posteriors.py``, numpy only).

Measuring the LM-fused skip search needs posteriors that are confident
nearly everywhere (blank between emissions, 1-2 confident frames a
character, about 40-60 characters a 1200-frame line) with a small share of
ambiguous frames: a seeded recognizer's near-uniform posteriors make every
frame ambiguous. ``synth_peaky_logits`` gives the same array, bit for bit,
as the JAX package's from the same arguments.
"""

from __future__ import annotations

import numpy as np


def synth_peaky_logits(B: int, T: int, D: int, seed: int = 0,
                       chars_per_1200: int = 50,
                       ambiguous_frac: float = 0.04) -> np.ndarray:
    """(B, T, D) float32 logits at trained-model peakiness."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, D)).astype(np.float32) * 0.3
    n_char_mean = max(4, chars_per_1200 * T // 1200)
    for b in range(B):
        boost = np.zeros(T, np.int64)            # class boosted per frame
        n_char = int(rng.integers(n_char_mean * 4 // 5,
                                  n_char_mean * 6 // 5))
        pos = np.sort(rng.choice(np.arange(2, T - 4, 3), n_char,
                                 replace=False) +
                      rng.integers(0, 2, n_char))
        for t in pos:
            c = int(rng.integers(1, D - 1))
            for dt in range(int(rng.integers(1, 3))):
                boost[t + dt] = c
        for t in range(T):
            logits[b, t, boost[t]] += 14.0       # blank (0) or the char
        # ambiguous frames: two classes share the mass
        amb_ts = rng.choice(np.where(boost == 0)[0],
                            int(T * ambiguous_frac), replace=False)
        for t in amb_ts:
            ids = rng.choice(np.arange(D - 1), 2, replace=False)
            logits[b, t, 0] -= 14.0
            logits[b, t, ids] += 12.0
    return logits
