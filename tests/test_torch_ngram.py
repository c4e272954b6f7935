"""The port's n-gram LMs against the JAX package's, on the committed
``demo/hard/lm/ngram.arpa`` and ``ngram.hblm`` (a Witten-Bell trigram over
demo/hard's 200 characters): ``ArpaLM``, ``HblmLM`` and the native scorer
of the port's own ``native/cbs_decoder.cc`` give the JAX package's score of
the same file (the ARPA's f64 entries, the HBLM's f32 ones) on 200 seeded
sentences to 1e-9; the HBLM the port writes is byte-equal to the
one the JAX package writes, and ``ngram_hash`` is JAX's; the backends of
``decode/lm_interface`` score as JAX's do, and a file that is neither ARPA
nor HBLM (a binary KenLM ``.klm``) raises without ``kenlm``.
"""

import os

import numpy as np
import pytest

from handwritten_chinese_ocr_samples_tpu.decode.lm_interface import (
    KenLMBackend as JaxKenLM)
from handwritten_chinese_ocr_samples_tpu.lm import arpa as jarpa
from handwritten_chinese_ocr_samples_tpu.lm import hblm as jhblm
from handwritten_chinese_ocr_samples_torch.core.codec import CTCCodec
from handwritten_chinese_ocr_samples_torch.decode.beam_host import (
    BeamSearchConfig)
from handwritten_chinese_ocr_samples_torch.decode.beam_host_native import (
    NativeArpaLM, try_native_host_decoder)
from handwritten_chinese_ocr_samples_torch.decode.lm_interface import (
    KenLMBackend, NullLM, build_lm_backend)
from handwritten_chinese_ocr_samples_torch.lm import arpa, hblm
from handwritten_chinese_ocr_samples_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_DIR = os.path.join(REPO, "demo", "hard", "lm")
ARPA = os.path.join(LM_DIR, "ngram.arpa")
HBLM = os.path.join(LM_DIR, "ngram.hblm")
CHARS = os.path.join(REPO, "demo", "hard", "data", "chars_list.txt")
TOL = 1e-9          # log10 sums of the same f32/f64 table entries


@pytest.fixture(scope="module")
def native_lib():
    """The port's native library, built once from its own source."""
    return _build.load_host("cbs_decoder")


@pytest.fixture(scope="module")
def sentences():
    """200 seeded space-joined sentences over the LM's characters, with
    out-of-vocabulary characters and the empty sentence among them."""
    with open(CHARS, encoding="utf-8") as f:
        chars = [line.rstrip("\n") for line in f]
    pool = chars + ["甲", "乙", "x"]                 # three OOV
    rng = np.random.default_rng(0)
    out = [""]
    for _ in range(199):
        n = int(rng.integers(1, 16))
        out.append(" ".join(rng.choice(pool, n)))
    return out


@pytest.fixture(scope="module")
def jax_scores(sentences):
    """JAX ``score`` of each file: the ARPA through ``ArpaLM`` (f64 table
    entries), the HBLM through ``HblmLM`` (f32 entries)."""
    refs = {"arpa": jarpa.ArpaLM(ARPA), "hblm": jhblm.HblmLM(HBLM)}
    return {(f, eos): [ref.score(s, eos=eos) for s in sentences]
            for f, ref in refs.items() for eos in (False, True)}


@pytest.mark.parametrize("which", ["arpa", "hblm", "native_arpa",
                                   "native_hblm"])
@pytest.mark.parametrize("eos", [False, True])
def test_scores_match_jax(which, eos, sentences, jax_scores, native_lib):
    model = {"arpa": lambda: arpa.ArpaLM(ARPA),
             "hblm": lambda: hblm.HblmLM(HBLM),
             "native_arpa": lambda: NativeArpaLM(ARPA),
             "native_hblm": lambda: NativeArpaLM(HBLM)}[which]()
    assert model.order == 3
    want = jax_scores[which.split("_")[-1], eos]
    got = [model.score(s, eos=eos) for s in sentences]
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if not which.startswith("native"):
        assert got == want                     # the same Python code


def test_full_scores_and_logprob_match_jax(sentences):
    ours, ref = arpa.ArpaLM(ARPA), jarpa.ArpaLM(ARPA)
    ours_h, ref_h = hblm.HblmLM(HBLM), jhblm.HblmLM(HBLM)
    for s in sentences[:50]:
        assert list(ours.full_scores(s)) == list(ref.full_scores(s))
        words = s.split()
        if words:
            ctx = tuple(words[:-1][-2:])
            assert ours.logprob(ctx, words[-1]) == ref.logprob(ctx, words[-1])
            assert ours_h.logprob(ctx, words[-1]) == \
                ref_h.logprob(ctx, words[-1])
    assert arpa.score_sentences(ours, sentences[:20]) == \
        jarpa.score_sentences(ref, sentences[:20])


def test_hblm_writer_is_byte_equal(tmp_path):
    ours, ref = tmp_path / "port.hblm", tmp_path / "jax.hblm"
    hblm.build_hblm(ARPA, str(ours))
    jhblm.build_hblm(ARPA, str(ref))
    assert ours.read_bytes() == ref.read_bytes()
    assert hblm.is_hblm(str(ours)) and not hblm.is_hblm(ARPA)
    assert isinstance(hblm.load_ngram_lm(str(ours)), hblm.HblmLM)
    assert isinstance(hblm.load_ngram_lm(ARPA), arpa.ArpaLM)


def test_ngram_hash_matches_jax():
    rng = np.random.default_rng(1)
    for n in range(1, 7):
        for _ in range(50):
            ids = rng.integers(0, 1 << 31, n).tolist()
            assert hblm.ngram_hash(ids) == jhblm.ngram_hash(ids)
    assert hblm.ngram_hash([]) == jhblm.ngram_hash([])


@pytest.mark.parametrize("path", [ARPA, HBLM])
def test_kenlm_backend_matches_jax(path, sentences):
    texts = [s.replace(" ", "") for s in sentences[:64]]
    ours, ref = KenLMBackend(path), JaxKenLM(path)
    assert type(ours.model).__name__ == type(ref.model).__name__
    np.testing.assert_array_equal(ours.score_batch(texts),
                                  ref.score_batch(texts))
    assert ours.topk_next(texts[:3], 5) == [[], [], []]
    built = build_lm_backend(kenlm_path=path)
    assert isinstance(built, KenLMBackend) and built.path == path
    assert build_lm_backend() is None
    np.testing.assert_array_equal(NullLM().score_batch(texts[:4]),
                                  np.zeros(4))


def test_binary_klm_needs_kenlm(tmp_path, native_lib):
    """A binary KenLM file: the native reader refuses it, so the host beam
    keeps the Python decoder, whose backend raises without ``kenlm``."""
    klm = tmp_path / "model.klm"
    klm.write_bytes(b"mmap lm \x00" + bytes(range(256)))
    with pytest.raises(ValueError):
        NativeArpaLM(str(klm))
    with open(CHARS, encoding="utf-8") as f:
        codec = CTCCodec("".join(line.rstrip("\n") for line in f))
    cfg = BeamSearchConfig(use_lm_pred=False, use_lm_score=True)
    assert try_native_host_decoder(codec, cfg, kenlm_path=str(klm)) is None
    with pytest.raises(ValueError, match="kenlm"):
        KenLMBackend(str(klm))
