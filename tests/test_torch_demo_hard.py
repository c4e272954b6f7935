"""The trained ``demo/hard`` artifact in the port: the converted weights
committed under ``handwritten_chinese_ocr_samples_torch/assets/demo_hard``
(``tools/convert_to_torch.py``) equal a fresh conversion of the orbax trees,
the committed JAX texts of the test split equal the JAX engine's, and the
port's greedy, beam and skip-search (``-ss``, char LM in f32) texts on the
first 16 test lines equal the committed JAX texts. Everything in f32 on the
CPU.
"""

import json
import os

import pytest
import torch

from handwritten_chinese_ocr_samples_torch.core.codec import (
    CTCCodec, load_chars_list)
from handwritten_chinese_ocr_samples_torch.decode.lm_interface import (
    TorchLMBackend)
from handwritten_chinese_ocr_samples_torch.lm.io import load_lm
from handwritten_chinese_ocr_samples_torch.models.registry import (
    get_model_info)
from handwritten_chinese_ocr_samples_torch.serve.engine import ServingEngine
from tools import convert_to_torch as conv

from tests.test_torch_lm import one_torch_thread  # noqa: F401

ASSETS = conv.OUT
DATA = os.path.join(conv.DEMO, "data")
N_LINES = 16


@pytest.fixture(scope="module")
def committed():
    with open(os.path.join(ASSETS, "texts.json")) as f:
        return json.load(f)


def test_committed_weights_equal_fresh_conversion(tmp_path):
    conv.convert(conv.DEMO, str(tmp_path))
    for rel in ("hctr_tiny.pt", os.path.join("lm", "weights.pt")):
        want = torch.load(str(tmp_path / rel), weights_only=True)
        got = torch.load(os.path.join(ASSETS, rel), weights_only=True)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == torch.float32
            assert torch.equal(got[k], want[k]), (rel, k)
    for rel in ("config.json", "dict.txt"):
        with open(os.path.join(ASSETS, "lm", rel), "rb") as a, \
                open(str(tmp_path / "lm" / rel), "rb") as b:
            assert a.read() == b.read()


def test_committed_texts_cover_the_test_split(committed):
    files = sorted(os.listdir(os.path.join(DATA, "test")))
    assert committed["files"] == files and len(files) == 150
    for route in ("greedy", "beam", "ss"):
        assert len(committed[route]) == 150 and all(committed[route])
    with open(os.path.join(DATA, "test_img_id_gt.txt"), encoding="utf-8") as f:
        labels = dict(line.rstrip("\n").split(",", 1) for line in f
                      if line.strip())
    # the skip search with the trained LM reads every line
    # (demo/hard/RESULTS.md: CER 0.0000)
    assert committed["ss"] == [labels[f] for f in files]


@pytest.mark.parametrize("route", ["greedy", "ss"])
def test_committed_texts_match_jax_engine(committed, route):
    import jax
    jax.config.update("jax_platforms", "cpu")
    fresh = conv.reference_texts(conv.DEMO, n_lines=8, routes=(route,))
    assert fresh[route] == committed[route][:8]


def _port_engine(route):
    chars = load_chars_list(os.path.join(DATA, "chars_list.txt"))
    model, _ = get_model_info("hctr-tiny", chars_list_file=os.path.join(
        DATA, "chars_list.txt"))
    state = torch.load(os.path.join(ASSETS, "hctr_tiny.pt"),
                       weights_only=True)
    kw = {"greedy": dict(decode_method="greedy-search"),
          "beam": dict(decode_method="beam-search"),
          "ss": dict(decode_method="beam-search", use_lm_pred=True,
                     use_lm_score=True, skip_search=True, lm_f32=True,
                     lm=TorchLMBackend(*load_lm(os.path.join(ASSETS, "lm"))),
                     **conv.SS)}[route]
    return ServingEngine(model, state, CTCCodec(chars), widths=conv.WIDTHS,
                         device="cpu", **kw)


@pytest.mark.parametrize("route", ["greedy", "beam", "ss"])
def test_port_texts_match_committed(committed, route):
    files = [os.path.join(DATA, "test", f)
             for f in committed["files"][:N_LINES]]
    engine = _port_engine(route)
    got, _ = engine.infer_files_batched(files, batch_size=conv.BATCH)
    assert got == committed[route][:N_LINES]
    if route == "ss":
        assert engine._lm_beam.skip and engine._lm_beam._ctx == 64
