"""The plain reference: the `hctr` recognizer's eval forward, the greedy CTC
collapse, the char LM's forward, the program's LM-fused skip search stated
plainly and the scores that judge a served text, in plain PyTorch and
float32 with TF32 off.

It follows the architecture as published (SE-ResNet trunk with asymmetric
pooling, a per-column CTC head; a pre-norm decoder-only char transformer)
and reads its weights from the state dicts the benchmark loads, by name.
It imports nothing of the program, of the JAX package or of JAX, and works
out everything it needs (preprocessing, the class and token tables) again
from the raw files.

``Recognizer(quant_bits=4)`` is the control of an int8 configuration: every
conv's input and weight rounded to 4-bit integers (symmetric, the input's
scale from its absmax on a calibration batch, the weight's per output
channel), the products taken in f32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LN_EPS = 1e-6
UNREACHABLE = 1e9   # a gap for a text no path of the logits can give


@contextlib.contextmanager
def exact_f32():
    """Float32 products without TF32 while the block runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ------------------------------------------------------------ preprocessing
def bucket(width: int, widths: Sequence[int]) -> int:
    """The narrowest bucket that holds ``width``, else the widest."""
    for w in sorted(widths):
        if width <= w:
            return w
    return max(widths)


def pad_line(img: np.ndarray, height: int, widths: Sequence[int]
             ) -> np.ndarray:
    """A ``(height, w)`` uint8 line -> ``(height, bucket)`` uint8: cut on
    the right if wider, else its right edge column repeated."""
    if img.ndim != 2 or img.shape[0] != height:
        raise ValueError(f"the reference takes lines at height {height}, "
                         f"got {img.shape}")
    w = bucket(img.shape[1], widths)
    if img.shape[1] >= w:
        return img[:, :w].copy()
    out = np.empty((height, w), dtype=np.uint8)
    out[:, :img.shape[1]] = img
    out[:, img.shape[1]:] = img[:, -1:]
    return out


def normalise(u8: np.ndarray) -> torch.Tensor:
    return (torch.from_numpy(u8).float() - 127.5) / 127.5


# ------------------------------------------------------------ recognizer
class Recognizer:
    """The eval forward of `hctr` from its state dict: ``(B, H, W)``
    normalised lines -> ``(B, W, classes)`` f32 logits."""

    def __init__(self, state: Dict[str, torch.Tensor], channels: int,
                 blocks: Sequence[int], device, quant_bits: Optional[int] = None):
        self.w = {k: v.to(device=device, dtype=torch.float32)
                  for k, v in state.items()}
        self.channels, self.blocks = channels, tuple(blocks)
        self.device = torch.device(device)
        self.qmax = None if quant_bits is None else 2 ** (quant_bits - 1) - 1
        self.amax: Dict[str, float] = {}
        self._calibrating = False

    def calibrate(self, x: torch.Tensor) -> None:
        """Each conv's input absmax over ``x``, float, for the control."""
        self._calibrating, self.amax = True, {}
        try:
            self.forward(x)
        finally:
            self._calibrating = False

    def _fake_quant(self, name: str, x, w):
        q = self.qmax
        s_x = self.amax[name] / q
        x = torch.clamp(torch.round(x / s_x), -q, q) * s_x
        s_w = w.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-12) / q
        return x, torch.clamp(torch.round(w / s_w), -q, q) * s_w

    def _conv(self, name: str, x):
        w, b = self.w[f"{name}.weight"], self.w.get(f"{name}.bias")
        if self._calibrating:
            self.amax[name] = max(self.amax.get(name, 0.0),
                                  float(x.abs().max()))
        elif self.qmax is not None:
            x, w = self._fake_quant(name, x, w)
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2)

    def _bn(self, name: str, x):
        g, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        m, v = self.w[f"{name}.running_mean"], self.w[f"{name}.running_var"]
        scale = g * torch.rsqrt(v + BN_EPS)
        return (x - m[:, None, None]) * scale[:, None, None] + b[:, None, None]

    def _se(self, name: str, x):
        y = x.mean(dim=(2, 3))
        y = F.relu(y @ self.w[f"{name}.fc1.weight"].T)
        y = torch.sigmoid(y @ self.w[f"{name}.fc2.weight"].T)
        return x * y[:, :, None, None]

    def _block(self, name: str, x):
        out = F.relu(self._bn(f"{name}.bn1", self._conv(f"{name}.conv1", x)))
        out = self._se(f"{name}.se",
                       self._bn(f"{name}.bn2", self._conv(f"{name}.conv2", out)))
        if f"{name}.down_conv.weight" in self.w:
            x = self._bn(f"{name}.down_bn", self._conv(f"{name}.down_conv", x))
        return F.relu(out + x)

    @staticmethod
    def _pool(x):
        return F.max_pool2d(x, kernel_size=(2, 1), stride=(2, 1))

    @torch.no_grad()
    def features(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, H, W)`` normalised lines -> the trunk's ``(B, C, H / 32,
        W)`` output, the features the CTC head reads."""
        with exact_f32():
            x = x.to(self.device, torch.float32)[:, None]     # (B, 1, H, W)
            c = "cnn."
            x = F.relu(self._bn(c + "bn0_1", self._conv(c + "conv0_1", x)))
            x = F.relu(self._bn(c + "bn0_2", self._conv(c + "conv0_2", x)))
            x = self._pool(x)
            for stage in range(4):
                for b in range(self.blocks[stage]):
                    x = self._block(f"{c}block{stage + 1}_{b}", x)
                x = self._conv(f"{c}conv{stage + 1}", x)
                x = self._pool(F.relu(self._bn(f"{c}bn{stage + 1}", x)))
            return x

    @torch.no_grad()
    def head(self, feats: torch.Tensor) -> torch.Tensor:
        """The CTC head: ``(B, C, H', W)`` -> ``(B, W, classes)`` logits,
        the features flattened ``h * C + c`` a column."""
        with exact_f32():
            B, C, H, W = feats.shape
            flat = feats.permute(0, 3, 2, 1).reshape(B, W, H * C)
            return flat @ self.w["linear.weight"].T + self.w["linear.bias"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))


# ------------------------------------------------------------ CTC
class Classes:
    """The recognizer's class space: blank 0, characters 1..N (a repeated
    character takes its last class), unknown N + 1."""

    def __init__(self, chars: Sequence[str]):
        self.chars = list(chars)
        self.index = {c: i + 1 for i, c in enumerate(self.chars)}
        self.blank, self.unknown = 0, len(self.chars) + 1

    def ids(self, text: str) -> Optional[List[int]]:
        """The classes of ``text``, or None where a character has none."""
        out = [self.index.get(c) for c in text]
        return None if any(i is None for i in out) else out

    def text(self, ids: Sequence[int]) -> str:
        return "".join(self.chars[i - 1] for i in ids)


def greedy_ids(logits: torch.Tensor, blank: int, unknown: int) -> List[int]:
    """Greedy CTC collapse of ``(T, C)`` logits: a frame's argmax is kept
    where it is neither blank nor unknown and differs from the previous
    frame's argmax."""
    arg = logits.argmax(dim=-1).tolist()
    out, prev = [], -1
    for a in arg:
        if a != blank and a != unknown and a != prev:
            out.append(a)
        prev = a
    return out


def token_gap(logits: torch.Tensor, ids: Optional[Sequence[int]],
              blank: int, unknown: int) -> float:
    """The widest gap by which a served character's logit lies below the
    frame's best, on the alignment of ``ids`` that keeps that gap least:
    over every alignment of ``(T, C)`` logits that collapses to ``ids``
    (blank or unknown between characters and at the ends, a character
    held over consecutive frames), the least of the largest per-frame gap
    below the frame's best logit. 0 where the greedy collapse gives
    ``ids``."""
    if ids is None:
        return UNREACHABLE
    cost = (logits.max(dim=-1, keepdim=True).values - logits).double().cpu()
    T = cost.shape[0]
    sep = torch.minimum(cost[:, blank], cost[:, unknown])
    L = len(ids)
    S = 2 * L + 1
    lab = torch.tensor(list(ids), dtype=torch.long)
    odd = torch.arange(1, S, 2)
    # a character state may be entered from the one two back where the
    # character differs (a repeat needs a separator between)
    skip = torch.zeros(S, dtype=torch.bool)
    if L > 1:
        skip[odd[1:]] = lab[1:] != lab[:-1]
    inf = torch.full((2,), float("inf"), dtype=torch.float64)
    d = torch.full((S,), float("inf"), dtype=torch.float64)
    d[0] = sep[0]
    if L:
        d[1] = cost[0, lab[0]]
    c = torch.empty(S, dtype=torch.float64)
    for t in range(1, T):
        c[0::2] = sep[t]
        if L:
            c[odd] = cost[t, lab]
        prev1 = torch.cat([inf[:1], d[:-1]])
        prev2 = torch.where(skip, torch.cat([inf, d[:-2]]), inf[0])
        d = torch.maximum(c, torch.minimum(torch.minimum(d, prev1), prev2))
    end = float(d[-1] if L == 0 else torch.minimum(d[-1], d[-2]))
    return end if math.isfinite(end) else UNREACHABLE


# ------------------------------------------------------------ char LM
class CharLM:
    """The pre-norm char transformer (learned positions, tied head,
    LayerNorm eps 1e-6) from its state dict and configuration."""

    def __init__(self, state: Dict[str, torch.Tensor], config: dict,
                 symbols: Sequence[str], device):
        self.w = {k: v.to(device=device, dtype=torch.float32)
                  for k, v in state.items()}
        self.cfg = config
        self.device = torch.device(device)
        self.index = {s: i for i, s in enumerate(symbols)}
        for i, sp in enumerate(("<s>", "<pad>", "</s>", "<unk>")):
            self.index[sp] = i

    def tokens(self, text: str) -> List[int]:
        return [0] + [self.index.get(c, 3) for c in text]

    def _ln(self, name, x):
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + LN_EPS) * self.w[f"{name}.weight"]
                + self.w[f"{name}.bias"])

    def _lin(self, name, x):
        return x @ self.w[f"{name}.weight"].T + self.w[f"{name}.bias"]

    @torch.no_grad()
    def log_probs(self, tokens: torch.Tensor) -> torch.Tensor:
        """``(B, L)`` tokens -> ``(B, L, V)`` next-token log-probs."""
        with exact_f32():
            tokens = tokens.to(self.device)
            B, L = tokens.shape
            d, H = self.cfg["d_model"], self.cfg["n_heads"]
            Dh = d // H
            emb = self.w["embed.weight"]
            x = emb[tokens] * math.sqrt(d) + self.w["pos_embed"][:L]
            causal = torch.ones(L, L, dtype=torch.bool,
                                device=self.device).tril()
            for i in range(self.cfg["n_layers"]):
                p = f"layer{i}"
                h = self._ln(f"{p}.ln1", x)
                q, k, v = (self._lin(f"{p}.attn.{n}", h).view(B, L, H, Dh)
                           for n in ("query", "key", "value"))
                s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
                s = s.masked_fill(~causal, float("-inf"))
                o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
                x = x + self._lin(f"{p}.attn.out", o.reshape(B, L, d))
                h = self._ln(f"{p}.ln2", x)
                x = x + self._lin(f"{p}.ff2", F.relu(self._lin(f"{p}.ff1", h)))
            x = self._ln("ln_f", x)
            return torch.log_softmax(x @ emb.T, dim=-1)

    def score(self, texts: Sequence[Sequence[int]], block: int = 128
              ) -> tuple:
        """Each token list's log-probability after ``<s>`` (no end token)
        and the next-token log-probs after it: ``([float], (N, V))``, in
        blocks of ``block`` lists padded on the right."""
        sums, nexts = [], []
        for s in range(0, len(texts), block):
            part = [[0] + list(t) for t in texts[s:s + block]]
            L = max(len(t) for t in part)
            tok = torch.tensor([t + [1] * (L - len(t)) for t in part],
                               dtype=torch.long, device=self.device)
            n = torch.tensor([len(t) for t in part], device=self.device)
            lp = self.log_probs(tok)                          # (b, L, V)
            step = lp[:, :-1].gather(-1, tok[:, 1:, None])[..., 0]
            valid = (torch.arange(1, L, device=self.device)[None, :]
                     < n[:, None])
            sums += torch.where(valid, step, 0.0).sum(1).tolist()
            nexts.append(lp[torch.arange(len(part)), n - 1])
        return sums, torch.cat(nexts) if nexts else None


# ------------------------------------------------------------ LM search
def _lae(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    m = max(a, b)
    return m + math.log1p(math.exp(-abs(a - b)))


def _add(beams: dict, prefix: tuple, pb: float = -math.inf,
         pnb: float = -math.inf) -> None:
    if pb == -math.inf and pnb == -math.inf:
        return
    old = beams.get(prefix)
    beams[prefix] = ((pb, pnb) if old is None
                     else (_lae(old[0], pb), _lae(old[1], pnb)))


class LMSearch:
    """The program's skip search (the JAX package's ``decode/beam_lm_device``
    with ``skip_search=True``, after the original decoder's pruning fast
    path) in plain terms: one line a generator, the LM's work batched over
    the lines of a call, every LM number a full forward over a whole token
    list (no cache).

    Frames up to ``suffix_frames`` past the last greedy character are
    visited. A frame where one class alone lies above ``prune`` (a
    log-prob) updates every beam in place, with no search and no LM:

      * the unknown class: nothing;
      * the blank: ``pb = log(e^pb + e^pnb) + p``, ``pnb`` kept as it is;
      * a character other than the beam's last: appended, ``pnb =
        log(e^pb + e^pnb) + p``, ``pb = -inf``;
      * the beam's last character: appended where ``pb`` is live (``pnb =
        pb + p``, ``pb = -inf``), else folded into it (``pnb += p``, ``pb =
        log(e^pb + e^pnb)`` plus the blank's log-prob at the frame).

    Beams that so come to one prefix stay apart until the next search.
    Every other frame is searched: each beam's candidates are the frame's
    top ``depth`` classes above ``prune`` (the unknown class skipped) and,
    once its prefix is not empty, the classes of the LM's top ``depth``
    next tokens; a class proposed twice counts twice. Rows of equal prefix
    merge, and the ``beam`` best survive by ``log p_ctc + lm_panelty *
    log p_lm(prefix + suffix) + len_bonus * len(prefix)``, where
    ``suffix`` is the next ``suffix_frames`` greedy characters after the
    frame: a candidate is ranked with the LM's look-ahead over the greedy
    run that follows it, not by its prefix alone. The beams it ends with
    are returned in rank order (the first is the one the program serves),
    to be scored exactly."""

    def __init__(self, lm: CharLM, classes: "Classes", *, beam: int,
                 depth: int, prune: float, lm_panelty: float,
                 len_bonus: float, suffix_frames: int = 4):
        self.lm, self.cls = lm, classes
        self.beam, self.depth, self.prune = beam, depth, prune
        self.lp, self.lb, self.suffix = lm_panelty, len_bonus, suffix_frames
        n_cls = classes.unknown + 1
        self.tok_of = np.full(n_cls, 3, dtype=np.int64)     # <unk>
        self.cls_of = np.full(max(lm.index.values()) + 1, -1,
                              dtype=np.int64)
        for ch, c in classes.index.items():
            t = lm.index.get(ch)
            if t is not None:
                self.tok_of[c] = t
                self.cls_of[t] = c

    def tokens(self, prefix: Sequence[int]) -> List[int]:
        return self.tok_of[list(prefix)].tolist() if prefix else []

    def run(self, logps: List[torch.Tensor]) -> List[List[tuple]]:
        """``(T, C)`` log-probs a line -> each line's final beams, best
        first. A line's generator asks for token lists; each is answered
        with its LM log-prob after ``<s>`` and its top ``depth`` next
        tokens."""
        gens = [self._line(lp) for lp in logps]
        finals: List[List[tuple]] = [[] for _ in gens]
        asks = {i: self._step(g, None, finals, i) for i, g in enumerate(gens)}
        while any(a is not None for a in asks.values()):
            want = sorted({s for a in asks.values() if a for s in a})
            got = {}
            if want:
                sums, nexts = self.lm.score([list(s) for s in want])
                top = nexts.topk(self.depth, dim=-1)
                # ties in the order of a stable sort: the lower token first
                order = [sorted(zip((-v for v in vals), ids))
                         for vals, ids in zip(top.values.tolist(),
                                              top.indices.tolist())]
                got = {s: (sums[k], [tk for _, tk in order[k]])
                       for k, s in enumerate(want)}
            for i, a in list(asks.items()):
                if a is not None:
                    asks[i] = self._step(gens[i], {s: got[s] for s in a},
                                         finals, i)
        return finals

    @staticmethod
    def _step(gen, value, finals, i):
        try:
            return gen.send(value)
        except StopIteration as stop:
            finals[i] = stop.value
            return None

    def _fast(self, beams: list, c: int, p: float, p_blank: float) -> list:
        """A frame where class ``c`` alone lies above the prune."""
        if c == self.cls.blank:
            return [(pre, _lae(pb, pnb) + p, pnb) for pre, pb, pnb in beams]
        out = []
        for pre, pb, pnb in beams:
            if not pre or pre[-1] != c:
                out.append((pre + (c,), -math.inf, _lae(pb, pnb) + p))
            elif pb != -math.inf:
                out.append((pre + (c,), -math.inf, pb + p))
            else:
                out.append((pre, _lae(pb, pnb) + p_blank, pnb + p))
        return out

    def _line(self, logp: torch.Tensor):
        cls = self.cls
        blank, unk = cls.blank, cls.unknown
        T = logp.shape[0]
        vals, idx = logp.topk(self.depth, dim=-1)
        n_above = (logp > self.prune).sum(-1)
        arg = idx[:, 0]
        prev = torch.cat([arg.new_full((1,), -1), arg[:-1]])
        keep = (arg != blank) & (arg != unk) & (arg != prev)
        kept_at = keep.nonzero()[:, 0].tolist()
        greedy = self.tok_of[arg[kept_at].tolist()].tolist() if kept_at \
            else []
        end = min(kept_at[-1] + self.suffix, T) if kept_at else 0
        amb = (n_above[:end] != 1).nonzero()[:, 0].tolist()
        rows = dict(zip(amb, logp[amb].cpu().numpy())) if amb else {}
        vals, idx = vals[:end].tolist(), idx[:end].tolist()
        n_above = n_above[:end].tolist()
        p_blank = logp[:end, blank].tolist()
        beams = [((), 0.0, -math.inf)]           # (prefix, pb, pnb)
        n_kept = 0                                # greedy characters <= t
        for t in range(end):
            while n_kept < len(kept_at) and kept_at[n_kept] <= t:
                n_kept += 1
            if n_above[t] == 1:
                if idx[t][0] < unk:
                    beams = self._fast(beams, idx[t][0], vals[t][0],
                                       p_blank[t])
                continue
            suffix = tuple(greedy[n_kept:n_kept + self.suffix])
            got = yield [tuple(self.tokens(pre)) for pre, _, _ in beams
                         if pre]
            row = rows[t]
            vis = [(c, p) for c, p in zip(idx[t], vals[t])
                   if p > self.prune and c != unk]
            nxt: dict = {}
            for pre, pb, pnb in beams:
                cands = list(vis)
                if pre:
                    for tk in got[tuple(self.tokens(pre))][1]:
                        c = int(self.cls_of[tk])
                        if c > 0:
                            cands.append((c, float(row[c])))
                prob = _lae(pb, pnb)
                for c, p in cands:
                    if c == blank:
                        _add(nxt, pre, pb=prob + p)
                        continue
                    if pre and pre[-1] == c:
                        _add(nxt, pre, pnb=pnb + p)
                        ext = pb + p
                    else:
                        ext = prob + p
                    _add(nxt, pre + (c,), pnb=ext)
            ahead = {pre: tuple(self.tokens(pre)) + suffix for pre in nxt}
            got = yield list(ahead.values())

            def rank(item):
                pre, (pb, pnb) = item
                return (_lae(pb, pnb) + self.lp * got[ahead[pre]][0]
                        + self.lb * len(pre))
            beams = [(pre, pb, pnb) for pre, (pb, pnb) in
                     sorted(nxt.items(), key=rank, reverse=True)[:self.beam]]
        return [pre for pre, _, _ in beams]


def ctc_logp_many(logp: torch.Tensor, texts: Sequence[Sequence[int]],
                  blank: int) -> List[float]:
    """log p(text | one line's ``(T, C)`` log-probs), summed over every
    alignment, of each of ``texts``, worked out in f64 on the columns the
    texts use."""
    cols = sorted({blank} | {c for t in texts for c in t})
    where = {c: k for k, c in enumerate(cols)}
    sub = logp[:, cols].double().cpu()
    T = sub.shape[0]
    out = []
    for t in texts:
        if not t:
            out.append(float(sub[:, where[blank]].sum()))
            continue
        loss = F.ctc_loss(sub[:, None], torch.tensor([[where[c] for c in t]]),
                          torch.tensor([T]), torch.tensor([len(t)]),
                          blank=where[blank], reduction="sum",
                          zero_infinity=False)
        out.append(-float(loss))
    return out
