"""The port's host beam search against the JAX package's, on the CPU.

* ``BeamSearchDecoder`` (Python): full and skip mode, each with no LM, the
  n-gram scoring (``demo/hard/lm/ngram.hblm``), char-LM proposals alone and
  proposals + scoring (a seeded 2-layer char LM, flax-initialised and
  converted), on ``utils/posteriors.synth_peaky_logits`` at demo/hard's 202
  classes and on near-uniform seeded logits: texts equal to JAX's.
* The native decoder (the port's own ``native/cbs_decoder.cc``): equal to
  the port's Python decoder and to the JAX package's native one in the
  cases of ``tests/test_native_cbs.py``, on raw logits too; it refuses LM
  proposals, and the library it loads is built from the port's source.
* ``lm/infer.LMScorer`` on the trained ``demo/hard`` LM: ``score`` within
  1e-5 of JAX's a scored token (a sentence's score is a sum of f32
  log-probs: at 40 characters it reaches -300, where one f32 step is 3e-5),
  ``next_k_words`` equal.
"""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import log_softmax

from handwritten_chinese_ocr_samples_tpu.core.codec import (
    CTCCodec as JaxCodec)
from handwritten_chinese_ocr_samples_tpu.decode import beam_host as jbh
from handwritten_chinese_ocr_samples_tpu.decode import (
    beam_host_native as jnative)
from handwritten_chinese_ocr_samples_tpu.decode import lm_interface as jli
from handwritten_chinese_ocr_samples_tpu.lm.infer import (
    LMScorer as JaxScorer)
from handwritten_chinese_ocr_samples_tpu.lm.io import load_lm as jax_load_lm
from handwritten_chinese_ocr_samples_tpu.lm.model import (
    CharTransformerLM as FlaxLM)
from handwritten_chinese_ocr_samples_tpu.lm.tokenizer import (
    Tokenizer as JaxTokenizer)
from handwritten_chinese_ocr_samples_torch.core.codec import (
    CTCCodec, load_chars_list)
from handwritten_chinese_ocr_samples_torch.decode import beam_host as pbh
from handwritten_chinese_ocr_samples_torch.decode import (
    beam_host_native as pnative)
from handwritten_chinese_ocr_samples_torch.decode import lm_interface as pli
from handwritten_chinese_ocr_samples_torch.lm.infer import LMScorer
from handwritten_chinese_ocr_samples_torch.lm.io import load_lm
from handwritten_chinese_ocr_samples_torch.lm.model import CharTransformerLM
from handwritten_chinese_ocr_samples_torch.lm.tokenizer import Tokenizer
from handwritten_chinese_ocr_samples_torch.ops import _build
from handwritten_chinese_ocr_samples_torch.utils.posteriors import (
    synth_peaky_logits)
from handwritten_chinese_ocr_samples_torch.utils.weights import (
    lm_flax_to_torch)

from tests.test_native_cbs import CHARS as ABC
from tests.test_native_cbs import _peaky, arpa_path  # noqa: F401
from tests.test_torch_lm import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARD = os.path.join(REPO, "demo", "hard")
HBLM = os.path.join(HARD, "lm", "ngram.hblm")
ASSETS = os.path.join(REPO, "handwritten_chinese_ocr_samples_torch",
                      "assets", "demo_hard")
LM_CFG = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=64)
SCORE_TOL = 1e-5    # a token's f32 log-prob, torch vs XLA matmul order
LM_KINDS = {        # (LM, use_lm_pred, use_lm_score)
    "none": (None, False, False),
    "ngram": ("ngram", False, True),
    "pred": ("tfm", True, False),
    "pred_score": ("tfm", True, True),
}


@pytest.fixture(scope="module")
def native_lib():
    return _build.load_host("cbs_decoder")


@pytest.fixture(scope="module")
def hard():
    """demo/hard's characters, both codecs and the LM backends of both
    packages: the n-gram and a seeded 2-layer char LM."""
    chars = load_chars_list(os.path.join(HARD, "data", "chars_list.txt"))
    jtok = JaxTokenizer.from_characters(chars)
    flax_lm = FlaxLM(vocab_size=jtok.vocab_size, **LM_CFG)
    lm_vars = flax_lm.init({"params": jax.random.key(3)},
                           jnp.zeros((1, 8), jnp.int32), train=False)
    state = lm_flax_to_torch(jax.tree.map(np.asarray, lm_vars["params"]))
    port_tfm = pli.TorchLMBackend(
        CharTransformerLM(vocab_size=jtok.vocab_size, **LM_CFG), state,
        Tokenizer.from_characters(chars), device="cpu")
    lms = {"ngram": (jli.KenLMBackend(HBLM), pli.KenLMBackend(HBLM)),
           "tfm": (jli.JaxLMBackend(JaxScorer(flax_lm, lm_vars, jtok)),
                   port_tfm)}
    return chars, JaxCodec(chars), CTCCodec(chars), lms


def _posteriors(kind, D):
    """(T, B, D) log-probs: peaky (a trained recognizer's statistics) or
    near-uniform (every frame ambiguous)."""
    if kind == "peaky":
        logits = synth_peaky_logits(3, 64, D, seed=4).transpose(1, 0, 2)
    else:
        rng = np.random.default_rng(5)
        logits = rng.normal(size=(6, 2, D)).astype(np.float32) * 0.3
    return log_softmax(logits, axis=2)


@pytest.mark.parametrize("post", ["peaky", "uniform"])
@pytest.mark.parametrize("kind", list(LM_KINDS))
@pytest.mark.parametrize("skip", [False, True], ids=["full", "skip"])
def test_python_decoder_matches_jax(hard, native_lib, skip, kind, post):
    _, jcodec, codec, lms = hard
    lm_name, pred, score = LM_KINDS[kind]
    kw = dict(beam_size=5, search_depth=4, lm_panelty=0.8, len_bonus=0.5,
              use_lm_pred=pred, use_lm_score=score, skip_search=skip)
    jlm, plm = lms[lm_name] if lm_name else (jli.NullLM(), pli.NullLM())
    logp = _posteriors(post, codec.num_classes)
    if post == "uniform" and skip:
        logp = logp[:3]       # skip mode searches all 202 classes a frame
    want = jbh.BeamSearchDecoder(jcodec, jlm, jbh.BeamSearchConfig(**kw)
                                 ).decode(logp, already_log=True)
    cfg = pbh.BeamSearchConfig(**kw)
    got = pbh.BeamSearchDecoder(codec, plm, cfg).decode(logp,
                                                        already_log=True)
    assert got == want
    if post == "peaky":
        assert any(want)
    native = pnative.try_native_host_decoder(codec, cfg, lm=plm)
    assert (native is None) == pred
    if native is not None:
        assert native.decode(logp, already_log=True) == want


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("use_lm", [False, True])
def test_native_matches_python_and_jax_native(
        arpa_path, native_lib, skip, use_lm):  # noqa: F811
    codec = CTCCodec(ABC)
    kw = dict(beam_size=5, search_depth=4, lm_panelty=1.3, len_bonus=0.9,
              use_lm_pred=False, use_lm_score=use_lm, skip_search=skip)
    cfg = pbh.BeamSearchConfig(**kw)
    oracle = pbh.BeamSearchDecoder(
        codec, pli.KenLMBackend(arpa_path) if use_lm else pli.NullLM(), cfg)
    native = pnative.NativeBeamSearchDecoder(
        codec, cfg, arpa_path=arpa_path if use_lm else None)
    jax_native = jnative.NativeBeamSearchDecoder(
        JaxCodec(ABC), jbh.BeamSearchConfig(**kw),
        arpa_path=arpa_path if use_lm else None)
    for seed in range(4):
        logits = _peaky(T=20, B=3, D=len(ABC) + 2, seed=seed)
        logp = log_softmax(logits, axis=2)
        want = oracle.decode(logp, already_log=True)
        assert native.decode(logp, already_log=True) == want
        assert native.decode(logits, already_log=False) == want
        assert jax_native.decode(logp, already_log=True) == want


def test_native_rejects_lm_pred_and_is_built_from_port_source(
        arpa_path, native_lib):  # noqa: F811
    with pytest.raises(ValueError):
        pnative.NativeBeamSearchDecoder(
            CTCCodec(ABC), pbh.BeamSearchConfig(use_lm_pred=True),
            arpa_path=arpa_path)
    info = _build.build_info["host:cbs_decoder"]
    src = _build.NATIVE / "cbs_decoder.cc"
    assert info["path"] == str(_build._library_path(src, _build.HOST_FLAGS))
    assert os.path.dirname(info["path"]) == str(_build.BUILD_DIR)
    flags = hashlib.sha256(" ".join(_build.HOST_FLAGS).encode())
    flags.update(src.read_bytes())
    assert flags.hexdigest()[:16] in os.path.basename(info["path"])


def test_native_decoder_is_chosen_by_file_format(
        arpa_path, native_lib, tmp_path):  # noqa: F811
    """An ARPA or HBLM file scores in the native decoder; a file of another
    format (a binary KenLM) is left to the Python decoder; a file that looks
    like a native format but does not load raises, and does not fall back
    to the Python decoder."""
    from handwritten_chinese_ocr_samples_torch.lm.hblm import build_hblm
    codec = CTCCodec(ABC)
    cfg = pbh.BeamSearchConfig(use_lm_pred=False, use_lm_score=True)
    hblm = str(tmp_path / "lm.hblm")
    build_hblm(arpa_path, hblm)
    for path in (arpa_path, hblm):
        assert isinstance(pnative.try_native_host_decoder(
            codec, cfg, kenlm_path=path), pnative.NativeBeamSearchDecoder)
    klm = tmp_path / "lm.klm"
    klm.write_bytes(b"mmap lm http://kheafield.com/code format version 5\n"
                    + bytes(64))
    assert pnative.try_native_host_decoder(codec, cfg,
                                           kenlm_path=str(klm)) is None
    bad = tmp_path / "bad.arpa"
    bad.write_text("\n\\data\\\nngram 1=0\n\n\\end\\\n")
    with pytest.raises(ValueError, match="bad.arpa"):
        pnative.try_native_host_decoder(codec, cfg, kenlm_path=str(bad))


@pytest.fixture(scope="module")
def trained_scorers():
    """The trained demo/hard char LM (128d/3L, f32) in both packages."""
    jm, jvars, jtok = jax_load_lm(os.path.join(HARD, "lm"))
    model, state, tok = load_lm(os.path.join(ASSETS, "lm"))
    return JaxScorer(jm, jvars, jtok), LMScorer(model, state, tok,
                                                device="cpu")


def test_lm_scorer_matches_jax(trained_scorers):
    jax_scorer, scorer = trained_scorers
    vocab = scorer.tokenizer.symbols[4:] + ["甲"]          # one OOV
    rng = np.random.default_rng(2)
    sents = [""] + ["".join(rng.choice(vocab, int(rng.integers(1, 40))))
                    for _ in range(31)]
    diff = np.abs(scorer.score(sents, char_based=True)
                  - jax_scorer.score(sents, char_based=True))
    assert (diff <= SCORE_TOL * np.array([len(s) for s in sents])).all()
    assert scorer.next_k_words(sents, 10, char_based=True) == \
        jax_scorer.next_k_words(sents, 10, char_based=True)
    assert scorer.perplexity(sents[1:]) == pytest.approx(
        jax_scorer.perplexity(sents[1:]), rel=SCORE_TOL)
    assert scorer.score([]).shape == (0,) and scorer.next_k_words([], 3) == []
