"""The port's LM-fused full search (``decode/beam_lm_device``) and its
sizing (``decode/adaptive``) against the JAX package's, on the setup of
``tests/test_beam_lm_device.py``: an f32 LM of d 32 and 2 layers (flax init,
converted weights) and seeded posteriors.

Decodes must be identical (prefixes and lengths), and so must the overflow
flag. The two searches merge equal prefixes with logaddexp sums taken in
another order, and the LM scores are f32 sums in another order, so scores
differ in the last bits; the seeded data has no tie that close.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.core.codec import (
    CTCCodec as JaxCodec)
from handwritten_chinese_ocr_samples_tpu.decode import adaptive as jad
from handwritten_chinese_ocr_samples_tpu.decode import beam_lm_device as jbl
from handwritten_chinese_ocr_samples_tpu.lm.cached import (
    CachedLM as JaxCachedLM)
from handwritten_chinese_ocr_samples_tpu.lm.model import (
    CharTransformerLM as FlaxLM)
from handwritten_chinese_ocr_samples_tpu.lm.tokenizer import (
    Tokenizer as JaxTokenizer)
from handwritten_chinese_ocr_samples_torch.core.codec import CTCCodec
from handwritten_chinese_ocr_samples_torch.decode import adaptive as ad
from handwritten_chinese_ocr_samples_torch.decode import beam_lm_device as bl
from handwritten_chinese_ocr_samples_torch.lm.cached import CachedLM
from handwritten_chinese_ocr_samples_torch.lm.model import CharTransformerLM
from handwritten_chinese_ocr_samples_torch.lm.tokenizer import Tokenizer
from handwritten_chinese_ocr_samples_torch.utils.weights import (
    lm_flax_to_torch)

from tests.test_torch_lm import one_torch_thread  # noqa: F401

CHARS = "abcdefgh"
KW = dict(beam_size=4, depth=5, lm_panelty=0.9, len_bonus=2.5)
AKW = dict(beam_size=4, depth=6, lm_panelty=0.7, len_bonus=1.5)


@pytest.fixture(scope="module")
def setup():
    jcodec, codec = JaxCodec(CHARS), CTCCodec(CHARS)
    jtok, tok = JaxTokenizer.from_characters(CHARS), \
        Tokenizer.from_characters(CHARS)
    cfg = dict(vocab_size=jtok.vocab_size, d_model=32, n_layers=2,
               n_heads=2, d_ff=64, max_len=64)
    flax_model = FlaxLM(**cfg)
    params = flax_model.init({"params": jax.random.key(5)},
                             jnp.zeros((1, 8), jnp.int32),
                             train=False)["params"]
    model = CharTransformerLM(**cfg)
    state = lm_flax_to_torch(jax.tree.map(np.asarray, params))
    jt = jbl.make_id_tables(jcodec, jtok)
    pt = bl.make_id_tables(codec, tok)
    np.testing.assert_array_equal(jt[0], pt[0])
    np.testing.assert_array_equal(jt[1], pt[1])
    return (codec, JaxCachedLM(flax_model, params), CachedLM(model, state),
            pt)


def _preds(T, B, seed):
    """``tests/test_beam_lm_device.py``'s posteriors, (T, B, D)."""
    rng = np.random.default_rng(seed)
    D = len(CHARS) + 2
    logits = rng.normal(size=(T, B, D))
    for b in range(B):
        for t in range(T):
            r = rng.random()
            if r < 0.4:
                logits[t, b, 0] += 7.0
            elif r < 0.75:
                logits[t, b, rng.integers(1, D - 1)] += 7.0
    return logits.astype(np.float32)


def _dense_char_line(T, n_chars, seed=0):
    """``tests/test_adaptive_lm.py``'s line of ``n_chars`` confident
    characters, (T, 1, D)."""
    rng = np.random.default_rng(seed)
    D = len(CHARS) + 2
    logits = rng.normal(size=(T, 1, D)) * 0.2
    logits[:, 0, 0] += 12.0
    for t in np.linspace(1, T - 2, n_chars).astype(int):
        logits[t, 0, 0] -= 12.0
        logits[t, 0, 1 + int(rng.integers(0, len(CHARS)))] += 12.0
    return logits.astype(np.float32)


def _inputs(logits_tbd, K):
    """The same (cand_vals, cand_idx, logits, logz) for both packages."""
    lg = jnp.asarray(logits_tbd.transpose(1, 0, 2))
    cv, ci = jax.lax.top_k(jax.nn.log_softmax(lg, axis=-1), K)
    lz = jax.scipy.special.logsumexp(lg, axis=-1)
    jargs = (cv, ci.astype(jnp.int32), lg, lz)
    targs = tuple(torch.from_numpy(np.array(a)) for a in jargs)
    return jargs, targs


def _equal(j_out, t_out):
    jp, jl = np.asarray(j_out[0]), np.asarray(j_out[1])
    tp, tl = t_out[0].numpy(), t_out[1].numpy()
    np.testing.assert_array_equal(tl, jl)
    for b in range(len(jl)):
        np.testing.assert_array_equal(tp[b, :jl[b]], jp[b, :jl[b]])


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("use_pred", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_full_search_matches_jax(setup, seed, use_pred, group):
    codec, jclm, clm, (c2l, l2c) = setup
    kw = dict(KW, unknown_id=codec.unknown_id, lm_ctx=64,
              use_lm_pred=use_pred, group_size=group, return_overflow=True)
    jargs, targs = _inputs(_preds(16, 4, seed), KW["depth"])
    want = jbl.make_lm_beam_search(jclm, c2l, l2c, **kw)(*jargs)
    got = bl.make_lm_beam_search(clm, c2l, l2c, **kw)(*targs)
    _equal(want, got)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[0].dtype == torch.int32 and got[0].shape == (4, 16)


def test_overflow_flag_matches_jax(setup):
    codec, jclm, clm, (c2l, l2c) = setup
    jargs, targs = _inputs(_dense_char_line(40, 12, seed=2), 6)
    for ctx, fired in ((8, True), (64, False)):
        kw = dict(AKW, unknown_id=codec.unknown_id, lm_ctx=ctx,
                  return_overflow=True)
        want = jbl.make_lm_beam_search(jclm, c2l, l2c, **kw)(*jargs)
        got = bl.make_lm_beam_search(clm, c2l, l2c, **kw)(*targs)
        assert bool(got[2].any()) is fired
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        _equal(want, got)


def test_selection_hook(setup):
    """The hook sees one selection per searched frame and changes
    nothing."""
    codec, _, clm, (c2l, l2c) = setup
    _, targs = _inputs(_preds(16, 2, 0), 5)
    kw = dict(KW, unknown_id=codec.unknown_id, lm_ctx=64, group_size=2)
    seen = []
    plain = bl.make_lm_beam_search(clm, c2l, l2c, **kw)(*targs)
    hooked = bl.make_lm_beam_search(
        clm, c2l, l2c, on_select=lambda t, tot, par, ch: seen.append(
            (t, tuple(tot.shape))), **kw)(*targs)
    assert all(torch.equal(a, b) for a, b in zip(plain, hooked))
    assert seen and all(s == (2, 4) for _, s in seen)
    assert [t for t, _ in seen] == list(range(len(seen)))


def test_unported_knobs_raise(setup):
    """The dense LM merge (opt-in in the JAX package) and the int8 LM are
    not ported: the search, its driver and the cached LM refuse them."""
    codec, _, clm, (c2l, l2c) = setup
    kw = dict(KW, unknown_id=codec.unknown_id)
    for extra in (dict(dense_merge=True),
                  dict(dense_merge=True, skip_search=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            bl.make_lm_beam_search(clm, c2l, l2c, **kw, **extra)
    for extra in (dict(dense_merge=True),
                  dict(dense_merge=True, skip_search=False)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ad.AdaptiveLMBeam(clm, c2l, l2c, unknown_id=codec.unknown_id,
                              lm_panelty=1.0, len_bonus=1.0, **extra)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CachedLM(clm.model, {}, quant_int8=True)


# ------------------------------------------------------ AdaptiveLMBeam
def test_adaptive_auto_matches_jax_and_direct(setup):
    codec, jclm, clm, (c2l, l2c) = setup
    jargs, targs = _inputs(_preds(16, 4, 3), 6)
    kw = dict(AKW, unknown_id=codec.unknown_id, skip_search=False)
    jbeam = jad.AdaptiveLMBeam(jclm, c2l, l2c, **kw)
    beam = ad.AdaptiveLMBeam(clm, c2l, l2c, **kw)
    want = jbeam.decode(*jargs)
    got = beam.decode(*targs)
    _equal(want, got)
    assert beam._ctx == jbeam._ctx
    assert beam.last_group == 4
    direct = bl.make_lm_beam_search(
        clm, c2l, l2c, **AKW, unknown_id=codec.unknown_id,
        lm_ctx=beam._ctx)(*targs)
    assert all(torch.equal(a, b) for a, b in zip(got, direct))


def test_adaptive_escalates_like_jax(setup, monkeypatch):
    """The first auto ctx holds the greedy characters but not <s>: both
    AdaptiveLMBeams must escalate and decode again, to the same text."""
    codec, jclm, clm, (c2l, l2c) = setup
    for mod in (jad, ad):
        monkeypatch.setattr(mod, "STABLE_CTX", (12, 64))
        monkeypatch.setattr(mod, "CTX_MARGIN", 0)
    jargs, targs = _inputs(_dense_char_line(40, 12, seed=5), 6)
    kw = dict(AKW, unknown_id=codec.unknown_id, skip_search=False)
    ctxs = []

    def search(*a, lm_ctx, **k):
        ctxs.append(lm_ctx)
        return bl.make_lm_beam_search(*a, lm_ctx=lm_ctx, **k)

    monkeypatch.setattr(ad, "make_lm_beam_search", search)
    jbeam = jad.AdaptiveLMBeam(jclm, c2l, l2c, **kw)
    beam = ad.AdaptiveLMBeam(clm, c2l, l2c, **kw)
    want = jbeam.decode(*jargs)
    got = beam.decode(*targs)
    assert ctxs == [12, 64]
    assert beam._ctx == jbeam._ctx == 64
    _equal(want, got)
    assert len(codec.compact_to_texts(*got)[0]) == 12


def test_adaptive_pinned_ctx_errors(setup):
    codec, _, clm, (c2l, l2c) = setup
    _, targs = _inputs(_dense_char_line(40, 12, seed=2), 6)
    kw = dict(AKW, unknown_id=codec.unknown_id, skip_search=False)
    with pytest.raises(RuntimeError, match="lm-ctx"):
        ad.AdaptiveLMBeam(clm, c2l, l2c, lm_ctx=8, **kw).decode(*targs)
    # sizing told the line is empty: <s> + 12 committed tokens overflow
    # the pinned 12, and a pinned context raises instead of escalating
    beam = ad.AdaptiveLMBeam(clm, c2l, l2c, lm_ctx=12, **kw)
    beam._greedy_chars = lambda cand_idx: 0
    with pytest.raises(RuntimeError, match="overflowed at pinned"):
        beam.decode(*targs)
    with pytest.raises(ValueError, match="max_len"):
        ad.AdaptiveLMBeam(clm, c2l, l2c, lm_ctx=65, **kw)


def _ctx_only(mod, max_len, **kw):
    clm = types.SimpleNamespace(model=types.SimpleNamespace(max_len=max_len))
    return mod.AdaptiveLMBeam(clm, None, None, unknown_id=9, lm_panelty=1.0,
                              len_bonus=1.0, skip_search=False, **kw)


@pytest.mark.parametrize("max_len,chars", [(512, 495), (512, 100),
                                           (160, 120), (160, 158),
                                           (160, 159), (600, 50)])
def test_auto_and_escalated_ctx_match_jax(max_len, chars):
    pair = [_ctx_only(jad, max_len), _ctx_only(ad, max_len)]
    results = []
    for beam in pair:
        try:
            results.append(beam._auto_ctx(chars))
        except ValueError:
            results.append("ValueError")
    assert results[0] == results[1]
    for ctx in (144, 512, max_len):
        got = []
        for beam in pair:
            beam._ctx = ctx
            try:
                got.append(beam._escalated_ctx())
            except RuntimeError:
                got.append("RuntimeError")
        assert got[0] == got[1], ctx


def test_pick_group_size_matches_jax():
    for batch in range(1, 40):
        for req in (1, 2, 4, 8, 16, 32):
            assert ad.pick_group_size(batch, req) == \
                jad.pick_group_size(batch, req)
    assert ad.pick_group_size(32, 16) == 8


def test_greedy_chars_match_jax():
    """The sizing's greedy character count is the first of the JAX
    package's ``make_count_stats`` maxima."""
    rng = np.random.default_rng(13)
    D = 10
    beam = _ctx_only(ad, 64)            # unknown_id = D - 1
    want = jbl.make_count_stats(unknown_id=beam.unknown_id)
    for trial in range(8):
        B = int(rng.integers(1, 5))
        T = int(rng.integers(4, 60))
        ci = np.zeros((B, T, 3), np.int32)
        ci[:, :, 0] = rng.integers(0, D, (B, T))
        w = int(want(jnp.asarray(ci), None)[0])
        assert beam._greedy_chars(torch.from_numpy(ci)) == w, trial
