"""The port's export (``serve/export.py``, ``cli/export.py``) against its
eager routes and the JAX package's ``serve/export.py``, on the CPU, with
demo/hard's trained ``hctr-tiny`` carried across by ``flax_to_torch``.

* Each loaded recognizer program gives the eager port's ``(chars,
  lengths)`` bit for bit, and the JAX package's loaded StableHLO's, in f32
  on the same uint8 input; a program carries no weights: neither in its
  state nor, as bytes, anywhere in its archive (the example inputs too).
* int8, on the JAX calibration: the loaded program equals the eager int8
  port bit for bit. Against the JAX int8 export it holds to
  ``tests/test_torch_int8.py``'s rule: XLA divides by a baked-in constant
  as a multiply by its reciprocal (ROADMAP.md queue 3), so a value at a .5
  tie may quantize apart; the frames' argmax agree on 99.9% or more, and
  every line whose frames all agree has the JAX program's output.
* The LM bundle's scores agree with ``LMScorer`` within 1e-5 a token, its
  top-k with the live scorer's, and an over-long sentence scores the prefix
  the JAX ``ExportedLMScorer`` scores.
* ``cli/export.py`` end to end with ``--device cpu``, int8 and the LM;
  its ``--int8-calib`` batch (``serve/quant.calibration_images``) is the
  JAX CLI's.
"""

import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.eval.driver import (
    load_recognizer_variables)
from handwritten_chinese_ocr_samples_tpu.lm.model import (
    CharTransformerLM as FlaxLM)
from handwritten_chinese_ocr_samples_tpu.lm.tokenizer import (
    Tokenizer as JaxTokenizer)
from handwritten_chinese_ocr_samples_tpu.models import registry as jreg
from handwritten_chinese_ocr_samples_tpu.serve import export as jexport
from handwritten_chinese_ocr_samples_tpu.serve import quant as jquant
from handwritten_chinese_ocr_samples_tpu.serve.engine import (
    preprocess_fixed_shape as jax_preprocess)
from handwritten_chinese_ocr_samples_torch.cli import export as export_cli
from handwritten_chinese_ocr_samples_torch.lm.infer import LMScorer
from handwritten_chinese_ocr_samples_torch.lm.model import CharTransformerLM
from handwritten_chinese_ocr_samples_torch.lm.tokenizer import Tokenizer
from handwritten_chinese_ocr_samples_torch.models.registry import (
    get_model_info)
from handwritten_chinese_ocr_samples_torch.ops.decode import (
    greedy_decode_device)
from handwritten_chinese_ocr_samples_torch.serve import export, quant
from handwritten_chinese_ocr_samples_torch.serve.engine import (
    preprocess_fixed_shape)
from handwritten_chinese_ocr_samples_torch.utils.weights import (
    flax_to_torch, lm_flax_to_torch, quant_flax_to_torch)
from tools import convert_to_torch as conv

from tests.test_torch_lm import one_torch_thread  # noqa: F401

DATA = os.path.join(conv.DEMO, "data")
TEST = os.path.join(DATA, "test")
WIDTHS, BATCH = (192, 320), 2
CHARS = "abcdefgh"
LM_SMALL = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=64)
LM_TOL = 1e-5          # a token, f32
TINY_SITES = 17


def _lines(width, n=BATCH, start=0):
    files = sorted(os.listdir(TEST))[start: start + n]
    return np.concatenate([preprocess_fixed_shape(os.path.join(TEST, f),
                                                  128, width)
                           for f in files], axis=0)


@pytest.fixture(scope="module")
def trained():
    """demo/hard's hctr-tiny in f32 in both packages."""
    jax.config.update("jax_platforms", "cpu")
    jm, chars = jreg.get_model_info("hctr-tiny", data_dir=DATA,
                                    dtype=jnp.float32)
    jv = load_recognizer_variables(os.path.join(conv.DEMO, "checkpoint"))
    model, _ = get_model_info("hctr-tiny", data_dir=DATA)
    state = flax_to_torch(jax.tree.map(np.asarray, jv))
    return jm, jv, model, state, len(chars) + 1


def _holds_tensor(path, t):
    """Whether any member of the ``.pt2`` archive at ``path`` holds the
    raw bytes of ``t``."""
    raw = t.detach().contiguous().cpu().numpy().tobytes()
    with zipfile.ZipFile(path) as z:
        return any(raw in z.read(i) for i in z.infolist())


def _largest(weights):
    return max(weights.values(), key=lambda v: v.numel())


def _eager(model, x_u8, unknown_id):
    with torch.inference_mode():
        logits = model((torch.from_numpy(x_u8).float() - 127.5) / 127.5)
    return logits, greedy_decode_device(logits, unknown_id=unknown_id)


def test_export_matches_eager_and_jax(trained, tmp_path):
    jm, jv, model, state, unk = trained
    meta = export.export_model(model, state, str(tmp_path / "port"),
                               tag="hctr-tiny", widths=WIDTHS,
                               batch_sizes=(BATCH,), unknown_id=unk,
                               device="cpu")
    jmeta = jexport.export_model(jm, jv, str(tmp_path / "jax"),
                                 tag="hctr-tiny", widths=WIDTHS,
                                 batch_sizes=(BATCH,), unknown_id=unk)
    assert set(jmeta) <= set(meta) and not meta["int8"]
    assert meta["artifacts"] == [f"hctr-tiny_b{BATCH}_w{w}.pt2"
                                 for w in WIDTHS]
    assert meta["device"] == "cpu" and meta["compute_dtype"] == "float32"
    weights = export.load_weights(
        str(tmp_path / "port" / meta["weights"]), "cpu")
    assert set(weights) == set(state)
    for w, name, jname in zip(WIDTHS, meta["artifacts"], jmeta["artifacts"]):
        path = str(tmp_path / "port" / name)
        assert torch.export.load(path).state_dict == {}
        assert not _holds_tensor(path, _largest(weights))
        fn = export.load_exported(path)
        x = _lines(w)
        chars, lengths = fn(weights, torch.from_numpy(x))
        assert chars.dtype == lengths.dtype == torch.int32
        assert chars.shape == (BATCH, w) and lengths.shape == (BATCH,)
        _, (want_c, want_l) = _eager(model, x, unk)
        assert torch.equal(chars, want_c) and torch.equal(lengths, want_l)
        assert int(lengths.min()) > 0
        jc, jl = jexport.load_exported(str(tmp_path / "jax" / jname))(
            jv, jnp.asarray(x))
        np.testing.assert_array_equal(chars.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(jl))


def test_int8_export_round_trip(trained, tmp_path):
    jm, jv, model, state, unk = trained
    w = WIDTHS[1]
    x = _lines(w, n=4)
    xf = (jnp.asarray(x).astype(jnp.float32) - 127.5) / 127.5
    tree = jquant.calibrate_conv_amax(jm, jv, [xf])
    amax = quant_flax_to_torch(tree)
    meta = export.export_model(model, state, str(tmp_path / "port"),
                               tag="q", widths=(w,), batch_sizes=(4,),
                               unknown_id=unk, quant=amax, device="cpu")
    assert meta["int8"] is True
    assert json.load(open(tmp_path / "port" / "q_meta.json"))["int8"]
    assert all(m.int8 is None for m in quant.conv_sites(model).values())
    path = str(tmp_path / "port" / meta["artifacts"][0])
    code = export.load_exported(path).graph.python_code("self").src
    assert code.count("hctr.int8_conv") == TINY_SITES
    assert code.count("hctr.int8_quantize") == TINY_SITES
    weights = export.load_weights(
        str(tmp_path / "port" / meta["weights"]), "cpu")
    chars, lengths = export.load_exported(path)(weights, torch.from_numpy(x))

    quant.set_conv_amax(model, amax)
    try:
        logits, (want_c, want_l) = _eager(model, x, unk)
    finally:
        quant.set_conv_amax(model, None)
    assert torch.equal(chars, want_c) and torch.equal(lengths, want_l)

    jexport.export_model(jm, jv, str(tmp_path / "jax"), tag="q",
                         widths=(w,), batch_sizes=(4,), unknown_id=unk,
                         quant=tree)
    jc, jl = jexport.load_exported(str(tmp_path / "jax" / f"q_b4_w{w}"
                                       ".stablehlo"))(jv, jnp.asarray(x))
    jq = np.asarray(jm.apply(jv, xf, train=False, quant=tree))
    agree = logits.numpy().argmax(-1) == jq.argmax(-1)
    assert agree.mean() >= 0.999
    for b in np.flatnonzero(agree.all(axis=1)):
        assert int(lengths[b]) == int(jl[b])
        np.testing.assert_array_equal(chars[b].numpy(), np.asarray(jc[b]))


@pytest.fixture(scope="module")
def small_lm():
    tok = JaxTokenizer.from_characters(CHARS)
    fm = FlaxLM(vocab_size=tok.vocab_size, **LM_SMALL)
    variables = fm.init({"params": jax.random.key(7)},
                        jnp.zeros((1, 8), jnp.int32), train=False)
    model = CharTransformerLM(vocab_size=tok.vocab_size, **LM_SMALL)
    state = lm_flax_to_torch(jax.tree.map(np.asarray, variables["params"]))
    return fm, variables, tok, model, state


def test_lm_export_round_trip(small_lm, tmp_path):
    _, _, _, model, state = small_lm
    tok = Tokenizer.from_characters(CHARS)
    meta = export.export_lm(model, state, tok, str(tmp_path),
                            batch_sizes=(2,), lengths=(16,), device="cpu")
    assert meta["artifacts"] == ["lm_b2_l16.pt2"]
    assert (tmp_path / "lm_dict.txt").exists()
    live = LMScorer(model, state, tok, device="cpu")
    scorer = export.ExportedLMScorer(str(tmp_path))
    sents = ["abc", "h", "gfedc", "aa", "hhgg"]
    got = scorer.score(sents, char_based=True)
    want = live.score(sents, char_based=True)
    n = np.array([len(s) for s in sents])
    assert np.all(np.abs(got - want) <= LM_TOL * n)
    assert (scorer.next_k_words(sents, 3, char_based=True)
            == live.next_k_words(sents, 3, char_based=True))
    assert scorer.score([]).shape == (0,)
    assert scorer.next_k_words([], 3) == []


def test_lm_export_overflow_truncates_as_jax(small_lm, tmp_path):
    """Sentences past the largest length bucket score the prefix it holds,
    as the JAX ``ExportedLMScorer`` scores them."""
    fm, variables, jtok, model, state = small_lm
    export.export_lm(model, state, Tokenizer.from_characters(CHARS),
                     str(tmp_path / "port"), batch_sizes=(2,),
                     lengths=(16,), device="cpu")
    jexport.export_lm(fm, variables, jtok, str(tmp_path / "jax"),
                      batch_sizes=(2,), lengths=(16,))
    scorer = export.ExportedLMScorer(str(tmp_path / "port"))
    jscorer = jexport.ExportedLMScorer(str(tmp_path / "jax"))
    long = "abcdefgh" * 4
    sents = [long, "a", long[:15], "bca"]
    got = scorer.score(sents, char_based=True)
    want = jscorer.score(sents, char_based=True)
    n = np.array([min(len(s), 14) for s in sents])
    assert np.all(np.abs(got - want) <= LM_TOL * n)
    live = LMScorer(model, state, Tokenizer.from_characters(CHARS),
                    device="cpu")
    trunc = live.score([long[:14], "a"], char_based=True)
    assert np.all(np.abs(got[:2] - trunc) <= LM_TOL * n[:2])
    got_k = scorer.next_k_words([long], 3, char_based=True)
    assert got_k == jscorer.next_k_words([long], 3, char_based=True)
    assert len(got_k) == 1 and 1 <= len(got_k[0]) <= 3


def test_cli_export_end_to_end(tmp_path):
    out = tmp_path / "bundle"
    w = WIDTHS[0]
    res = export_cli.main([
        "-m", "hctr-tiny", "-f", os.path.join(conv.OUT, "hctr_tiny.pt"),
        "-o", str(out), "-w", str(w), "-b", "2",
        "-cl", os.path.join(DATA, "chars_list.txt"), "--int8-calib", TEST,
        "-tp", os.path.join(conv.OUT, "lm"), "--lm-lengths", "32",
        "--lm-batch-sizes", "2", "--device", "cpu"])
    meta = json.load(open(out / "hctr-tiny_meta.json"))
    assert meta == res["model"] and meta["int8"]
    assert meta["compute_dtype"] == "bfloat16"
    assert res["lm"]["artifacts"] == ["lm_b2_l32.pt2"]
    for name in meta["artifacts"] + res["lm"]["artifacts"] + [
            meta["weights"], "lm_weights.pt", "lm_dict.txt"]:
        assert (out / name).is_file()
    weights = export.load_weights(str(out / meta["weights"]), "cpu")
    lm_weights = export.load_weights(str(out / "lm_weights.pt"), "cpu")
    for name in meta["artifacts"]:
        assert not _holds_tensor(str(out / name), _largest(weights))
    for name in res["lm"]["artifacts"]:
        assert not _holds_tensor(str(out / name), _largest(lm_weights))
    fn = export.load_exported(str(out / meta["artifacts"][0]))
    chars, lengths = fn(weights, torch.from_numpy(_lines(w)))
    assert chars.shape == (2, w) and int(lengths.min()) > 0
    assert export.ExportedLMScorer(str(out)).score(
        ["一丁"], char_based=True).shape == (1,)

    with pytest.raises(SystemExit):
        export_cli.main(["-o", str(out)])
    # a reference .pth (refused until compat/torch_convert.py was ported),
    # built here from the same weights in the reference's layout: its bundle
    # holds the same weights
    from tests.torch_reference_layout import reference_state_dict
    ref = str(tmp_path / "ref.pth")
    torch.save(reference_state_dict(torch.load(
        os.path.join(conv.OUT, "hctr_tiny.pt"), weights_only=True)), ref)
    res = export_cli.main([
        "-m", "hctr-tiny", "-f", ref, "-o", str(tmp_path / "pth"), "-w",
        str(w), "-b", "2", "-cl", os.path.join(DATA, "chars_list.txt"),
        "--device", "cpu"])
    from_pth = export.load_weights(
        str(tmp_path / "pth" / res["model"]["weights"]), "cpu")
    assert from_pth.keys() == weights.keys()
    assert all(torch.equal(from_pth[k], weights[k]) for k in weights)


def test_calibration_images_match_jax_cli(tmp_path):
    """``calibration_images`` selects and pads as the JAX ``cli/export.py
    --int8-calib`` does: the folder's images by name, the first 16, at the
    first width; other files are passed over, an empty folder refused."""
    files = sorted(
        os.path.join(TEST, f) for f in os.listdir(TEST)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
    want = np.concatenate([jax_preprocess(f, 128, WIDTHS[0])
                           for f in files[:16]], axis=0)
    got = quant.calibration_images(TEST, 128, WIDTHS[0])
    assert got.dtype == np.uint8 and got.shape == (16, 128, WIDTHS[0], 1)
    np.testing.assert_array_equal(got, want)

    (tmp_path / "notes.txt").write_text("not an image")
    with pytest.raises(ValueError, match="no images"):
        quant.calibration_images(str(tmp_path), 128, WIDTHS[0])
    with pytest.raises(SystemExit, match="--int8-calib: no images"):
        export_cli.main(["-m", "hctr-tiny", "-f",
                         os.path.join(conv.OUT, "hctr_tiny.pt"),
                         "-o", str(tmp_path / "out"), "-w", "192",
                         "-cl", os.path.join(DATA, "chars_list.txt"),
                         "--int8-calib", str(tmp_path), "--device", "cpu"])
