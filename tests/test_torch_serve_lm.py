"""The port's LM-fused serving route (``ServingEngine`` with a transformer LM,
``ServingDaemon``, ``cli.deploy -utp -uts -tp``) against the JAX package's
``ServingEngine`` with ``JaxLMBackend``, on the same images and converted
weights: the committed ``demo/checkpoint`` (hctr-tiny) and a flax-initialised
tiny char LM, both in f32, full per-frame search. Served texts must be
identical. Everything runs on the CPU. The skip search (``-ss``, the
production LM route) is held the same way, at the reference prune and at a
calibrated one.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.core.codec import (
    CTCCodec as JaxCodec)
from handwritten_chinese_ocr_samples_tpu.decode.lm_interface import (
    JaxLMBackend)
from handwritten_chinese_ocr_samples_tpu.lm.infer import LMScorer
from handwritten_chinese_ocr_samples_tpu.lm.model import (
    CharTransformerLM as FlaxLM)
from handwritten_chinese_ocr_samples_tpu.lm.tokenizer import (
    Tokenizer as JaxTokenizer)
from handwritten_chinese_ocr_samples_tpu.models.hctr import (
    HCTRModel as FlaxHCTR)
from handwritten_chinese_ocr_samples_tpu.serve.engine import (
    ServingEngine as JaxEngine)
from handwritten_chinese_ocr_samples_tpu.utils.ckpt_io import (
    restore_pytree_host)
from handwritten_chinese_ocr_samples_torch.cli import deploy
from handwritten_chinese_ocr_samples_torch.core.codec import (
    CTCCodec, load_chars_list)
from handwritten_chinese_ocr_samples_torch.decode.lm_interface import (
    TorchLMBackend)
from handwritten_chinese_ocr_samples_torch.lm.model import CharTransformerLM
from handwritten_chinese_ocr_samples_torch.lm.tokenizer import Tokenizer
from handwritten_chinese_ocr_samples_torch.models.registry import (
    get_model_info)
from handwritten_chinese_ocr_samples_torch.serve.daemon import ServingDaemon
from handwritten_chinese_ocr_samples_torch.serve.engine import ServingEngine
from handwritten_chinese_ocr_samples_torch.utils.weights import (
    flax_to_torch, lm_flax_to_torch)

from tests.test_torch_lm import one_torch_thread  # noqa: F401
from tests.test_torch_serve import record_batches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo")
CHARS = os.path.join(DEMO, "data", "chars_list.txt")
WIDTHS = (64, 128)
BEAM = dict(beam_size=4, search_depth=5, lm_panelty=0.7, len_bonus=1.5)
LM_CFG = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=160)


@pytest.fixture(scope="module")
def demo():
    payload = restore_pytree_host(os.path.join(DEMO, "checkpoint"))
    variables = {"params": payload["params"],
                 "batch_stats": payload["batch_stats"]}
    test_dir = os.path.join(DEMO, "data", "test")
    files = [os.path.join(test_dir, f) for f in sorted(os.listdir(test_dir))]
    chars = load_chars_list(CHARS)
    jtok = JaxTokenizer.from_characters(chars)
    flax_lm = FlaxLM(vocab_size=jtok.vocab_size, **LM_CFG)
    lm_vars = flax_lm.init({"params": jax.random.key(5)},
                           jnp.zeros((1, 8), jnp.int32), train=False)
    jax_lm = JaxLMBackend(LMScorer(flax_lm, lm_vars, jtok))
    lm_state = lm_flax_to_torch(jax.tree.map(np.asarray, lm_vars["params"]))
    return variables, files[:4], chars, jax_lm, lm_state


def _torch_lm(chars, lm_state):
    model = CharTransformerLM(vocab_size=len(chars) + 4, **LM_CFG)
    return TorchLMBackend(model, lm_state, Tokenizer.from_characters(chars))


def _port_engine(demo, widths=WIDTHS, **kw):
    variables, _, chars, _, lm_state = demo
    model, _ = get_model_info("hctr-tiny", chars_list_file=CHARS)
    opts = dict(BEAM, lm=_torch_lm(chars, lm_state), use_lm_pred=True,
                use_lm_score=True, lm_f32=True)
    opts.update(kw)
    return ServingEngine(model, flax_to_torch(variables), CTCCodec(chars),
                         widths=widths, decode_method="beam-search",
                         device="cpu", **opts)


def _jax_texts(demo, files, widths=WIDTHS, dtype=jnp.float32, **kw):
    variables, _, chars, jax_lm, _ = demo
    codec = JaxCodec(chars)
    model = FlaxHCTR(num_classes=codec.num_classes, backbone_channels=64,
                     num_blocks=(1, 1, 1, 1), dtype=dtype)
    opts = dict(BEAM, skip_search=False)
    opts.update(kw)
    engine = JaxEngine(model, variables, codec, widths=widths,
                       decode_method="beam-search", lm=jax_lm,
                       use_lm_pred=True, use_lm_score=True, lm_f32=True,
                       **opts)
    assert engine._device_lm_beam
    return engine.infer_files(files)[0]


@pytest.fixture(scope="module")
def want(demo):
    return _jax_texts(demo, demo[1])


def test_engine_lm_route_matches_jax(demo, want):
    engine = _port_engine(demo)
    assert engine._device_lm_beam
    got, _ = engine.infer_files(demo[1])
    assert got == want
    assert all(want)                  # the trained demo reads every line
    assert engine.infer_files_batched(demo[1], batch_size=4)[0] == want


def test_daemon_lm_route_matches_jax(demo, want):
    engine = _port_engine(demo, lm_group=2)
    with ServingDaemon(engine, batch_size=2, max_delay_ms=30) as daemon:
        futs = [daemon.submit(f) for f in demo[1]]
    assert [f.result(timeout=300) for f in futs] == want
    assert engine._lm_beam.last_group == 2


def test_lm_knobs_reach_the_search(demo):
    engine = _port_engine(demo, lm_ctx=64, lm_group=1)
    beam = engine._lm_beam
    assert beam._ctx == 64 and beam._ctx_pinned and beam.group_size == 1
    assert beam._clm.dtype == torch.float32
    assert _port_engine(demo, lm_f32=False)._lm_beam._clm.dtype == \
        torch.bfloat16


def test_host_beam_and_int8_lm_engines_match_jax(demo):
    """The host-beam configurations build the host beam (LM proposals alone
    through the Python decoder and ``LMScorer``, the others native) and
    serve the JAX engine's texts; so does the int8 LM (``lm_int8``): the
    search's ``CachedLM`` runs its step in int8 and the texts are the JAX
    int8-LM engine's, with the recognizer in int8 too."""
    variables, files, chars, jax_lm, lm_state = demo
    lm = _torch_lm(chars, lm_state)
    model, _ = get_model_info("hctr-tiny", chars_list_file=CHARS)
    sd = flax_to_torch(variables)
    for kw, jkw, native in (
            (dict(lm=lm, use_lm_pred=True), dict(lm=jax_lm,
                                                 use_lm_pred=True), False),
            (dict(skip_search=True), dict(skip_search=True), True),
            (dict(use_lm_score=True), dict(use_lm_score=True), True)):
        engine = ServingEngine(model, sd, CTCCodec(chars), device="cpu",
                               widths=WIDTHS, decode_method="beam-search",
                               **BEAM, **kw)
        assert (type(engine._host_beam).__name__
                == ("Native" if native else "") + "BeamSearchDecoder")
        codec = JaxCodec(chars)
        jax_model = FlaxHCTR(num_classes=codec.num_classes,
                             backbone_channels=64, num_blocks=(1, 1, 1, 1))
        want, _ = JaxEngine(jax_model, variables, codec, widths=WIDTHS,
                            decode_method="beam-search", **BEAM,
                            **jkw).infer_files(files[:2])
        assert engine.infer_files(files[:2])[0] == want
    engine = _port_engine(demo, lm_int8=True, int8=True)
    assert engine._lm_beam._clm.quant_int8
    assert engine.infer_files(files[:2])[0] == _jax_texts(
        demo, files[:2], lm_int8=True, int8=True)


@pytest.fixture(scope="module")
def lm_dir(demo, tmp_path_factory):
    """A converted LM directory (config.json, dict.txt, weights.pt), the
    recognizer as a torch state dict, and a folder of the test images."""
    _, files, chars, _, lm_state = demo
    root = tmp_path_factory.mktemp("lm_cli")
    images = root / "images"
    images.mkdir()
    for f in files:
        shutil.copy(f, images)
    d = root / "lm"
    d.mkdir()
    model = CharTransformerLM(vocab_size=len(chars) + 4, **LM_CFG)
    (d / "config.json").write_text(json.dumps(model.config()))
    Tokenizer.from_characters(chars).save_dict(str(d / "dict.txt"))
    torch.save(lm_state, str(d / "weights.pt"))
    pt = str(root / "demo.pt")
    torch.save(flax_to_torch(demo[0]), pt)
    return str(d), pt, str(images)


@pytest.mark.parametrize("mode", [[], ["-b", "2", "--daemon"]])
def test_cli_deploy_lm_route_matches_jax(demo, lm_dir, mode):
    """The CLI's bf16 recognizer and one 128 bucket, on the JAX engine's
    texts for the same folder."""
    d, pt, images = lm_dir
    files = [os.path.join(images, f) for f in sorted(os.listdir(images))]
    want = _jax_texts(demo, files, widths=(128,), dtype=jnp.bfloat16)
    got = deploy.main(["-lang", "hctr-tiny", "-m", pt, "-i", images,
                       "-cl", CHARS, "-w", "128", "-d", "cpu",
                       "-dm", "beam-search", "-bs", "4", "-sd", "5",
                       "-lp", "0.7", "-lb", "1.5", "-utp", "-uts", "-tp", d,
                       "--lm-f32", *mode])
    assert got == want


@pytest.mark.parametrize("flags", [
    ["-ss"],                                  # skip search without an LM
    ["-utp"], ["-utp", "-tp", "LM"],          # LM proposals alone: host beam
    ["-uts"],                                 # LM scoring without an LM
    ["-uts", "-tp", "LM", "--lm-int8", "--lm-f32"]])
def test_cli_deploy_unported_lm_flags_error(lm_dir, demo, flags, capsys):
    """The flags once refused, the host beam's and ``--lm-int8``, now serve
    the JAX engine's texts for the same flags (``-utp`` without an LM serves
    the plain device beam, as in the JAX engine; the int8 LM runs in f32,
    as bf16 LM decodes are not bit-comparable between the packages)."""
    d, pt, _ = lm_dir
    argv = ["-lang", "hctr-tiny", "-m", pt, "-i", demo[1][0], "-cl", CHARS,
            "-d", "cpu", "-dm", "beam-search", "-w", "128",
            *[d if f == "LM" else f for f in flags]]
    variables, files, chars, jax_lm, _ = demo
    codec = JaxCodec(chars)
    model = FlaxHCTR(num_classes=codec.num_classes, backbone_channels=64,
                     num_blocks=(1, 1, 1, 1), dtype=jnp.bfloat16)
    kw = dict(skip_search="-ss" in flags, use_lm_score="-uts" in flags,
              use_lm_pred="-utp" in flags,
              lm=jax_lm if "LM" in flags else None,
              lm_int8="--lm-int8" in flags, lm_f32="--lm-f32" in flags)
    want, _ = JaxEngine(model, variables, codec, widths=(128,),
                        decode_method="beam-search", **kw).infer_files(
                            files[:1])
    assert deploy.main(argv) == want


# ------------------------------------------------- the skip search (-ss)
SS = dict(skip_search=True)


@pytest.fixture(scope="module")
def want_ss(demo):
    return _jax_texts(demo, demo[1], **SS)


@pytest.mark.parametrize("prune", [0.001, 0.05])
def test_engine_ss_route_matches_jax(demo, want_ss, prune):
    engine = _port_engine(demo, prune=prune, **SS)
    assert engine._lm_beam.skip and engine._device_lm_beam
    got, _ = engine.infer_files(demo[1])
    want = (want_ss if prune == 0.001
            else _jax_texts(demo, demo[1], prune=prune, **SS))
    assert got == want and all(want)
    assert engine.infer_files_batched(demo[1], batch_size=4)[0] == want
    assert engine._lm_beam._budget >= 16 and engine._lm_beam._peek > 0


def test_daemon_ss_route_matches_jax(demo, want_ss):
    engine = _port_engine(demo, lm_group=2, **SS)
    with ServingDaemon(engine, batch_size=2, max_delay_ms=30) as daemon:
        futs = [daemon.submit(f) for f in demo[1]]
    assert [f.result(timeout=300) for f in futs] == want_ss
    assert engine._lm_beam.last_group == 2


@pytest.mark.parametrize("route", ["lm", "ss"])
def test_batched_overlap_matches_jax(demo, want, want_ss, route):
    """One batch in flight on the LM routes (full search and ``-ss``): both
    width buckets and a ragged last batch (the 128 bucket's third line, a
    repeat, alone) serve the JAX engine's texts, and batch k+1 is
    dispatched before batch k's search runs in ``finalize``."""
    files = demo[1] + demo[1][1:2]
    engine = _port_engine(demo, **(SS if route == "ss" else {}))
    log = []
    engine.route.dispatch = record_batches(log, engine.route.dispatch)
    expected = want_ss if route == "ss" else want
    assert engine.infer_files_batched(files, batch_size=2)[0] == \
        expected + expected[1:2]
    assert log == [("dispatch", 0), ("dispatch", 1), ("finalize", 0),
                   ("dispatch", 2), ("finalize", 1), ("finalize", 2)]


def test_ss_knobs_reach_the_search(demo):
    engine = _port_engine(demo, seg_budget=40, run_max=4, ctx_ladder=0,
                          fused_commit=True, prune=0.01, **SS)
    beam = engine._lm_beam
    assert (beam._budget, beam._budget_pinned, beam.run_max,
            beam._ladder_ctx, beam._fused) == (40, True, 4, 0, True)
    assert beam._kw["prune"] == pytest.approx(np.log(0.01))
    assert engine._prune_lp == pytest.approx(np.log(0.01))


@pytest.mark.parametrize("mode", [[], ["-b", "2", "--daemon"],
                                  ["--fused-commit", "--seg-budget", "24"]])
def test_cli_deploy_ss_matches_jax(demo, lm_dir, mode):
    """``-ss`` through the CLI (bf16 recognizer, one 128 bucket) on the JAX
    engine's skip-search texts; the fused commit and a pinned segment
    budget decode the same."""
    d, pt, images = lm_dir
    files = [os.path.join(images, f) for f in sorted(os.listdir(images))]
    want = _jax_texts(demo, files, widths=(128,), dtype=jnp.bfloat16, **SS)
    got = deploy.main(["-lang", "hctr-tiny", "-m", pt, "-i", images,
                       "-cl", CHARS, "-w", "128", "-d", "cpu",
                       "-dm", "beam-search", "-bs", "4", "-sd", "5",
                       "-lp", "0.7", "-lb", "1.5", "-utp", "-uts", "-tp", d,
                       "-ss", "--lm-f32", *mode])
    assert got == want
