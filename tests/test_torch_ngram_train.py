"""The port's LM tooling on the host (``lm/ngram_train.py``, ``lm/corpus.py``,
``cli/lm_train_ngram.py``, ``cli/lm_binarize.py``) against the JAX
package's: the ARPA files byte for byte, the HBLM files byte for byte, and
the committed ``demo/hard/lm`` n-gram files regenerated from
``chip_smoke.py``'s copy of the demo's chain sampler.
"""

import json
import os

import numpy as np
import pytest

from handwritten_chinese_ocr_samples_tpu.cli import (
    lm_train_ngram as jax_cli_ngram)
from handwritten_chinese_ocr_samples_tpu.lm import corpus as jcorpus
from handwritten_chinese_ocr_samples_tpu.lm import ngram_train as jng
from handwritten_chinese_ocr_samples_torch.cli import (
    lm_binarize, lm_train_ngram)
from handwritten_chinese_ocr_samples_torch.lm import corpus, ngram_train
from handwritten_chinese_ocr_samples_torch.lm.hblm import HblmLM, build_hblm

import chip_smoke
from tests.test_ngram_train import ALPHABET, SENTS
from tools import make_hard_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARD_LM = os.path.join(REPO, "demo", "hard", "lm")


def _write_corpus(path, sents):
    path.write_text("\n".join(" ".join(s) for s in sents) + "\n",
                    encoding="utf-8")


@pytest.mark.parametrize("order", [1, 2, 3, 5])
@pytest.mark.parametrize("vocab", [None, ALPHABET[:6]])
def test_arpa_byte_equal_to_jax(tmp_path, order, vocab):
    src = tmp_path / "c.txt"
    _write_corpus(src, SENTS)
    got, want = tmp_path / "port.arpa", tmp_path / "jax.arpa"
    sizes = ngram_train.train_ngram_arpa(str(src), str(got), order=order,
                                         vocab=vocab)
    assert sizes == jng.train_ngram_arpa(str(src), str(want), order=order,
                                         vocab=vocab)
    assert got.read_bytes() == want.read_bytes()


def test_empty_corpus_raises():
    with pytest.raises(ValueError, match="empty corpus"):
        ngram_train.estimate_witten_bell(ngram_train.NgramCounts(2))


def test_sampler_copy_equals_make_hard_demo():
    assert chip_smoke.HARD_VOCAB == make_hard_demo.VOCAB
    assert chip_smoke.HARD_GROUPS == make_hard_demo.GROUPS
    for k in (0, 17, 199):
        a, pa = chip_smoke.successors(k, 42)
        b, pb = make_hard_demo.successors(k, 42)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pa, pb)
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    assert ([chip_smoke.sample_line(r1, 42) for _ in range(50)]
            == [make_hard_demo.sample_line(r2, 42) for _ in range(50)])


def test_demo_hard_ngram_regenerates(tmp_path):
    """``tools/make_hard_demo.train_ngram``'s recipe through the port's CLI
    gives the committed ``ngram.arpa`` and ``ngram.hblm`` byte for byte
    (203 / 1190 / 4450 n-grams), and ``lm_binarize --check`` passes."""
    src = tmp_path / "corpus.txt"
    _write_corpus(src, chip_smoke.hard_corpus())
    chars = tmp_path / "chars_list.txt"
    chars.write_text("\n".join(chip_smoke.HARD_VOCAB) + "\n",
                     encoding="utf-8")
    arpa, hblm = tmp_path / "ngram.arpa", tmp_path / "ngram.hblm"
    assert lm_train_ngram.main([str(src), str(arpa), "-o", "3",
                                "--chars-list", str(chars),
                                "--hblm", str(hblm)]) == 0
    with open(os.path.join(HARD_LM, "ngram.arpa"), "rb") as f:
        assert arpa.read_bytes() == f.read()
    with open(os.path.join(HARD_LM, "ngram.hblm"), "rb") as f:
        assert hblm.read_bytes() == f.read()
    lm = HblmLM(str(hblm))
    assert lm.counts == [203, 1190, 4450]
    lm.close()
    again = tmp_path / "again.hblm"
    assert lm_binarize.main([str(arpa), str(again), "--check"]) == 0
    assert again.read_bytes() == hblm.read_bytes()


def test_cli_matches_jax_cli(tmp_path):
    src = tmp_path / "c.txt"
    _write_corpus(src, SENTS)
    chars = tmp_path / "chars_list.txt"
    chars.write_text("\n".join(ALPHABET[:5]) + "\n", encoding="utf-8")
    out = {}
    for name, cli in (("port", lm_train_ngram), ("jax", jax_cli_ngram)):
        arpa, hblm = tmp_path / f"{name}.arpa", tmp_path / f"{name}.hblm"
        assert cli.main([str(src), str(arpa), "-o", "4", "--chars-list",
                         str(chars), "--hblm", str(hblm)]) == 0
        out[name] = (arpa.read_bytes(), hblm.read_bytes())
    assert out["port"] == out["jax"]


def test_binarize_check_fails_on_a_mismatch(tmp_path, monkeypatch):
    src = tmp_path / "c.txt"
    _write_corpus(src, SENTS)
    arpa = tmp_path / "m.arpa"
    ngram_train.train_ngram_arpa(str(src), str(arpa), order=2)
    build_hblm(str(arpa), str(tmp_path / "ok.hblm"))
    from handwritten_chinese_ocr_samples_torch.lm import arpa as arpa_mod
    real = arpa_mod.ArpaLM.score
    monkeypatch.setattr(arpa_mod.ArpaLM, "score",
                        lambda self, s, **kw: real(self, s, **kw) + 1.0)
    assert lm_binarize.main([str(arpa), str(tmp_path / "m.hblm"),
                             "--check"]) == 1


NEWS = [
    {"content": "  今天ＡＢＣ天气很好，１２３人去公园。 "},
    {"title": "no content"},
    {"content": "他说：“我们明天再来！”　Ｘ"},
    {"content": ""},
    {"content": "全角空格　和半角 space 混排１２"},
]


@pytest.mark.parametrize("workers", [1, 2])
def test_corpus_matches_jax(tmp_path, workers):
    src = tmp_path / "news.json"
    lines = [json.dumps(d, ensure_ascii=False) for d in NEWS]
    src.write_text("\n".join(lines[:2] + [""] + lines[2:]) + "\n",
                   encoding="utf-8")
    chars = tmp_path / "chars.txt"
    chars.write_text("\n".join("今天气很好人去公园他说我们明天再来和混排ABX123")
                     + "\n", encoding="utf-8")
    got, want = tmp_path / "port.txt", tmp_path / "jax.txt"
    n = corpus.preprocess_corpus(str(src), str(got), str(chars),
                                 workers=workers, chunk_size=1)
    assert n == jcorpus.preprocess_corpus(str(src), str(want), str(chars),
                                          workers=1) == 3
    assert got.read_bytes() == want.read_bytes()
    assert corpus.q2b("Ａ") == jcorpus.q2b("Ａ") == "A"
    assert corpus.q2b("　") == " "
    assert corpus.main(["-cf", str(src), "-rf", str(tmp_path / "cli.txt"),
                        "-cd", str(chars), "-j", "1"]) == 3
    assert (tmp_path / "cli.txt").read_bytes() == want.read_bytes()
