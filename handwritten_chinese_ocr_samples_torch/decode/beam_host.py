"""Context beam search (CBS) — host implementation, reference-equivalent
(the JAX package's ``decode/beam_host.py``; numpy and scipy only).

Prefix beam search over CTC posteriors with language-model fusion,
transcription-equivalent to the reference decoder (`ctc_codec.py:124-307`)
and to the JAX package's host decoder (``tests/test_torch_host_beam.py``).
It is the oracle of the native decoder (``beam_host_native.py``) and serves
the configurations the native one cannot: LM next-character proposals
(``use_lm_pred``, through ``lm_interface.TorchLMBackend.topk_next``) and a
transformer LM's scores without the device search.

Algorithm (full mode, `ctc_codec.py:183-285`):
  * greedy "top line" = collapsed argmax (char, t) pairs; search ends 4 frames
    after the last greedy character;
  * per frame, candidate set = top-``search_depth`` classes by posterior,
    optionally extended with LM-predicted next characters per beam
    (``use_lm_pred``, `ctc_codec.py:215-227`);
  * prefix extension with (pb, pnb) log-space bookkeeping and the standard
    logaddexp merge rules, unknown class skipped (`ctc_codec.py:233-265`);
  * LM scoring of ``prefix + suffix`` where suffix = the next <=4 greedy
    characters (context!), total = logaddexp(pb, pnb) + lm*lm_panelty +
    len(prefix)*len_bonus (`ctc_codec.py:267-281`);
  * keep ``beam_size`` best.

Skip mode (`ctc_codec.py:124-181`): frames where only one class clears the
prune threshold log(0.001) update every kept beam in place (no search, no LM
round-trip); all other frames fall back to the full search with the pruned
candidate set. The in-place update rules — including their deliberate
asymmetries vs. the merged rules — are reproduced exactly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.special import log_softmax

from .lm_interface import LMBackend, NullLM

NEG_INF = float("-inf")


@dataclass
class _Beam:
    prefix: str = ""
    pb: float = 0.0       # log P(prefix, last symbol blank)
    pnb: float = NEG_INF  # log P(prefix, last symbol non-blank)
    pt: float = 0.0       # LM + length score

    def prob(self) -> float:
        return np.logaddexp(self.pb, self.pnb)

    def total(self) -> float:
        return self.prob() + self.pt


@dataclass
class BeamSearchConfig:
    beam_size: int = 10
    search_depth: int = 10
    lm_panelty: float = 2.0    # 2: ngram, 0.8: transformer (`ctc_codec.py:34`)
    len_bonus: float = 5.8     # 5.8: ngram, 4.8: transformer (`ctc_codec.py:35`)
    use_lm_pred: bool = True   # LM proposes next-char candidates
    use_lm_score: bool = True  # LM scores prefixes (False => only len bonus)
    skip_search: bool = False
    prune_log_prob: float = math.log(0.001)
    suffix_len: int = 4


class BeamSearchDecoder:
    """Decode log-softmaxed (or raw) CTC posteriors with beam search + LM."""

    def __init__(self, codec, lm: Optional[LMBackend] = None,
                 config: Optional[BeamSearchConfig] = None):
        self.codec = codec
        self.lm = lm or NullLM()
        self.cfg = config or BeamSearchConfig()

    # ------------------------------------------------------------------ api
    def decode(self, preds: np.ndarray, already_log: bool = False
               ) -> List[str]:
        """``preds``: (T, B, D) logits or log-probs -> list of B texts."""
        if not already_log:
            preds = log_softmax(preds, axis=2)
        if self.cfg.skip_search:
            return [self._decode_one_skip(preds[:, b, :])
                    for b in range(preds.shape[1])]
        return [self._decode_one_full(preds[:, b, :])
                for b in range(preds.shape[1])]

    # ------------------------------------------------------------- helpers
    def _top_line(self, logp: np.ndarray) -> List[Tuple[str, int]]:
        """Collapsed greedy (char, frame) pairs (`ctc_codec.py:188-195`)."""
        idx = np.argmax(logp, axis=1)
        unk = self.codec.unknown_id
        line = []
        for t in range(len(idx)):
            i = int(idx[t])
            if i != 0 and i != unk and not (t > 0 and idx[t - 1] == i):
                line.append((self.codec.characters[i], t))
        return line

    def _suffix_after(self, top_line, t: int) -> str:
        s = "".join(c for c, tt in top_line if tt > t)
        return s[: self.cfg.suffix_len]

    def _end_step(self, top_line, T: int) -> int:
        if not top_line:
            return 0
        return min(top_line[-1][1] + self.cfg.suffix_len, T)

    # ------------------------------------------------------------ full CBS
    def _decode_one_full(self, logp: np.ndarray) -> str:
        T, D = logp.shape
        cfg = self.cfg
        top_line = self._top_line(logp)
        end = self._end_step(top_line, T)
        topk = np.argsort(-logp[:end], axis=1)[:, : cfg.search_depth]
        beams = [_Beam()]
        for t in range(end):
            suffix = self._suffix_after(top_line, t)
            beams = self._search_step(beams, topk[t], logp[t], suffix)
        return beams[0].prefix if beams else ""

    # ------------------------------------------------------------ skip CBS
    def _decode_one_skip(self, logp: np.ndarray) -> str:
        T, D = logp.shape
        cfg = self.cfg
        unk = self.codec.unknown_id
        top_line = self._top_line(logp)
        end = self._end_step(top_line, T)
        beams = [_Beam()]
        for t in range(end):
            p_t = logp[t]
            survivors = np.where(p_t > cfg.prune_log_prob)[0]
            if survivors.shape[0] == 1:
                pidx = int(survivors[0])
                if pidx >= unk:
                    continue  # sole survivor is <unknown>: frame ignored
                p = float(p_t[pidx])
                for beam in beams:
                    tail = (None if beam.prefix == ""
                            else self.codec.dict[beam.prefix[-1]])
                    if pidx == 0:
                        # blank: only pb refreshed (in-place fast path,
                        # `ctc_codec.py:156-157`)
                        beam.pb = beam.prob() + float(p_t[0])
                    elif pidx != tail:
                        beam.prefix += self.codec.characters[pidx]
                        beam.pnb = beam.prob() + p
                        beam.pb = NEG_INF
                    else:
                        if beam.pb != NEG_INF:
                            beam.prefix += self.codec.characters[pidx]
                            beam.pnb = beam.pb + p
                            beam.pb = NEG_INF
                        else:
                            prob = beam.prob()
                            beam.pnb = beam.pnb + p
                            beam.pb = prob + float(p_t[0])
            else:
                suffix = self._suffix_after(top_line, t)
                beams = self._search_step(beams, survivors, p_t, suffix)
        return beams[0].prefix if beams else ""

    # ------------------------------------------------- one search timestep
    def _search_step(self, beams: List[_Beam],
                     visual_candidates: Sequence[int],
                     p_t: np.ndarray, suffix: str) -> List[_Beam]:
        cfg = self.cfg
        unk = self.codec.unknown_id

        # Candidate sets: visual top-k, plus LM next-char proposals for
        # non-empty prefixes (`ctc_codec.py:213-231`).
        if cfg.use_lm_pred:
            lm_next = self.lm.topk_next([b.prefix for b in beams],
                                        cfg.search_depth)
            cand_sets = []
            for beam, nxt in zip(beams, lm_next):
                ids = list(visual_candidates)
                if beam.prefix:
                    ids += [self.codec.dict[c] for c in nxt
                            if c in self.codec.dict]
                cand_sets.append(ids)
        else:
            cand_sets = [list(visual_candidates)] * len(beams)

        gen: Dict[str, _Beam] = {}

        def bucket(prefix: str) -> _Beam:
            b = gen.get(prefix)
            if b is None:
                b = _Beam(prefix=prefix, pb=NEG_INF, pnb=NEG_INF)
                gen[prefix] = b
            return b

        for beam, cands in zip(beams, cand_sets):
            for idx in cands:
                idx = int(idx)
                if idx >= unk:
                    continue
                p = float(p_t[idx])
                prefix = beam.prefix
                if idx == 0:
                    g = bucket(prefix)
                    g.pb = np.logaddexp(g.pb, beam.prob() + p)
                    continue
                tail = None if prefix == "" else self.codec.dict[prefix[-1]]
                n_prefix = prefix + self.codec.characters[idx]
                g_new = bucket(n_prefix)
                if idx != tail:
                    g_new.pnb = np.logaddexp(g_new.pnb, beam.prob() + p)
                else:
                    # repeat char: split across blank/non-blank histories
                    g_new.pnb = np.logaddexp(g_new.pnb, beam.pb + p)
                    g_old = bucket(prefix)
                    g_old.pnb = np.logaddexp(g_old.pnb, beam.pnb + p)

        out = list(gen.values())
        if cfg.use_lm_score:
            scores = self.lm.score_batch([b.prefix + suffix for b in out])
            for b, s in zip(out, scores):
                b.pt = float(s) * cfg.lm_panelty + len(b.prefix) * cfg.len_bonus
        else:
            for b in out:
                b.pt = len(b.prefix) * cfg.len_bonus
        out.sort(key=lambda b: b.total(), reverse=True)
        return out[: cfg.beam_size]
