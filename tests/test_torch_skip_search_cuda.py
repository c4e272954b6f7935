"""The skip search's segment steps replayed from CUDA graphs, on the card:
marked ``cuda`` and skipped where there is none. At the trained ``demo/full``
LM's sizes (512d/6L, bf16) and the ``bf16-ss-b32`` cell's sizing (search
groups of 32 lines, beam 10, K 10, lp 0.8, lb 4.0, auto context, budget and
ladder), on each of the two width buckets' frame counts, two groups a
batch: the replayed decode gives the eager loop's prefixes, lengths and
texts, every run slot count 0..8 is stepped, a second decode captures
nothing, and the replays are the replayed decode's segment steps; also with
a shallow ladder rung that the steps climb from, the int8 LM step and the
fused commit, and from two data shards' threads at once.

This file imports no JAX, so that it runs on a machine without it; the
repository's ``conftest.py`` does, so on the card run it as

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_skip_search_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_torch.core.codec import (
    CTCCodec, load_chars_list)
from handwritten_chinese_ocr_samples_torch.decode import beam_lm_device as bl
from handwritten_chinese_ocr_samples_torch.decode.adaptive import (
    AdaptiveLMBeam)
from handwritten_chinese_ocr_samples_torch.lm.cached import CachedLM
from handwritten_chinese_ocr_samples_torch.lm.io import load_lm
from handwritten_chinese_ocr_samples_torch.ops import (
    cache_gather, logits_lse, peek_attention)
from handwritten_chinese_ocr_samples_torch.ops.topk_logsoftmax import (
    topk_logsoftmax)
from handwritten_chinese_ocr_samples_torch.utils.posteriors import (
    synth_peaky_logits)

pytestmark = pytest.mark.cuda

LM_DIR = "handwritten_chinese_ocr_samples_torch/assets/demo_full/lm"
CHARS = "demo/full/data/chars_list.txt"
GROUP, DEPTH, RUN_MAX = 32, 10, 8
LINES = 2 * GROUP       # two groups: the second captures the first's steps
PRUNE = math.log(1e-3)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segment steps replay from CUDA "
                    "graphs only there")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def search(card):
    """demo/full's codec and its trained LM in bf16 on the card, and the
    same LM with its step in int8."""
    codec = CTCCodec(load_chars_list(CHARS))
    model, state, tok = load_lm(LM_DIR)
    clm = {int8: CachedLM(model, state, dtype=torch.bfloat16,
                          quant_int8=int8, device=card)
           for int8 in (False, True)}
    return codec, clm, bl.make_id_tables(codec, tok)


def _logits(T, D, seed):
    """Peaky posteriors at a trained recognizer's statistics, whose first
    frames hold, in every line, blocks of 0..8 confident characters each
    closed by an ambiguous frame, so that the group's segments step every
    run slot count."""
    rng = np.random.default_rng(seed)
    lg = synth_peaky_logits(LINES, T, D, seed=seed)
    sizes = rng.permutation(RUN_MAX + 1)
    t = 0
    for n in sizes:
        kinds = [None] * int(n) + [0, "amb", 0]
        for kind in kinds:
            lg[:, t] = rng.normal(size=(LINES, D)) * 0.3
            for b in range(LINES):
                if kind == "amb":
                    lg[b, t, rng.choice(np.arange(1, D - 1), 2,
                                        replace=False)] += 12.0
                else:
                    lg[b, t, 0 if kind == 0
                       else int(rng.integers(1, D - 1))] += 14.0
            t += 1
    return lg


def _decode(beam, args):
    with torch.inference_mode():
        out = beam.decode(*args)
    torch.cuda.synchronize()
    return out


def _counts():
    """The K2-K4 launch counters and the segment step counters."""
    return (peek_attention.launches, logits_lse.launches,
            cache_gather.launches, bl.segment_steps,
            bl.segment_graph_captures, bl.segment_graph_replays)


def _since(before):
    return [b - a for a, b in zip(before, _counts())]


# (width, knobs): the two buckets; a shallow first rung (ctx 64, climbed
# at segment 8 of these lines, to ctx 144) against the default one (112,
# which covers every segment here); the int8 LM step; the fused commit
CASES = {"w1024": (1024, {}), "w1600": (1600, {}),
         "ladder": (1024, dict(ctx_ladder=64)),
         "lm_int8": (1024, dict(lm_int8=True)),
         "fused_commit": (1600, dict(fused_commit=True))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_steps_equal_eager_loop(search, card, monkeypatch, case):
    codec, clms, (c2l, l2c) = search
    width, knobs = CASES[case]
    knobs = dict(knobs)
    clm = clms[knobs.pop("lm_int8", False)]
    T = width // 4
    x = torch.from_numpy(_logits(T, codec.num_classes, seed=width)).to(card)
    vals, idx, blank_lp, n_above = topk_logsoftmax(x, k=DEPTH, prune=PRUNE)
    args = (vals, idx, x, torch.logsumexp(x.float(), -1), blank_lp, n_above)
    beam = AdaptiveLMBeam(clm, c2l, l2c, beam_size=10, depth=DEPTH,
                          unknown_id=codec.unknown_id, lm_panelty=0.8,
                          len_bonus=4.0, group_size=GROUP, prune=PRUNE,
                          **knobs)
    climbs = []
    climb = bl.StepStore.climb
    monkeypatch.setattr(bl.StepStore, "climb", lambda self, Lc: (
        climbs.append(Lc), climb(self, Lc)))
    before = _counts()
    first = _decode(beam, args)     # the first group eager, then captures
    assert _since(before)[4] > 0 or case not in ("w1024", "w1600")
    before = _counts()
    replayed = _decode(beam, args)
    k2, k3, k4, steps, caps, reps = _since(before)
    assert caps == 0 and reps == steps > 0
    # K4 once a step; the fused commit writes a step that follows a run
    # with its own pass instead
    assert k4 < steps if knobs.get("fused_commit") else k4 == steps
    monkeypatch.setattr(bl, "_use_static_steps", lambda dev, sel: False)
    before = _counts()
    eager = _decode(beam, args)
    assert _since(before) == [k2, k3, k4, steps, 0, 0]
    for got in (first, replayed):
        for a, b in zip(eager, got):
            assert torch.equal(a, b)
    texts = codec.compact_to_texts(replayed[0].cpu().numpy(),
                                   replayed[1].cpu().numpy())
    assert texts == codec.compact_to_texts(eager[0].cpu().numpy(),
                                           eager[1].cpu().numpy())
    # the graphs of these frames: keys (sig, shapes, Lc, slots, parity)
    store = bl.StepStore.of(clm)
    keys = [key for key in store.graphs
            if dict((n, s) for n, s, _ in key[1])["cand_idx"][1] == T]
    assert {key[3] for key in keys} >= set(range(RUN_MAX + 1))
    if "ctx_ladder" in knobs:
        # the replayed decode climbed the ladder: steps at both depths
        assert beam._ladder_k and climbs
        assert {key[2] for key in keys} >= {64, beam._ctx}


def test_shard_threads_capture_and_replay(search, card, monkeypatch):
    """Two data shards on the one card (``-dp 2``), each searched from its
    own thread with its own store: they capture side by side
    (``thread_local``) and replay, decode as one eager search does, and
    count the eager search's K2-K4 launches, K4 once a segment step: each
    graph tallies only its own thread's launches."""
    codec, clms, (c2l, l2c) = search
    clm = clms[False]
    x = torch.from_numpy(_logits(256, codec.num_classes, seed=7)).to(card)
    vals, idx, blank_lp, n_above = topk_logsoftmax(x, k=DEPTH, prune=PRUNE)
    args = (vals, idx, x, torch.logsumexp(x.float(), -1), blank_lp, n_above)
    kw = dict(beam_size=10, depth=DEPTH, unknown_id=codec.unknown_id,
              lm_panelty=0.8, len_bonus=4.0, group_size=GROUP, prune=PRUNE)
    sharded = AdaptiveLMBeam(clm, c2l, l2c, shards=[card, card], **kw)
    outs, counts = [], []
    for _ in range(3):
        before = _counts()
        outs.append(_decode(sharded, args))
        counts.append(_since(before))
    assert sum(c[4] for c in counts) > 0 and counts[2][4] == 0
    assert counts[2][5] == counts[2][3] > 0        # all replayed
    assert len(clm.segment_graphs) >= 2           # a store a shard
    monkeypatch.setattr(bl, "_use_static_steps", lambda dev, sel: False)
    before = _counts()
    eager = _decode(AdaptiveLMBeam(clm, c2l, l2c, **kw), args)
    want = _since(before)
    assert want[2] == want[3] > 0
    for out, c in zip(outs, counts):
        assert c[:4] == want[:4]
        for a, b in zip(eager, out):
            assert torch.equal(a, b)
