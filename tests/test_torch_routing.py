"""Decode routing of the port's ``ServingEngine`` against the JAX package's.

A beam search with an LM that is neither scored (``use_lm_score``) nor
proposing (``use_lm_pred``) ignores the LM: the JAX engine serves the plain
device beam then, whatever the LM is (a KenLM n-gram has no ``lm_model``, a
transformer LM has one). The port must serve the same texts, equal to those
of an engine with no LM. Weights: the committed ``demo/checkpoint``
(hctr-tiny), converted with ``flax_to_torch``. Everything runs on the CPU.
"""

import os

import jax.numpy as jnp
import pytest

from handwritten_chinese_ocr_samples_tpu.core.codec import (
    CTCCodec as JaxCodec)
from handwritten_chinese_ocr_samples_tpu.models.hctr import (
    HCTRModel as FlaxHCTR)
from handwritten_chinese_ocr_samples_tpu.serve.engine import (
    ServingEngine as JaxEngine)
from handwritten_chinese_ocr_samples_tpu.utils.ckpt_io import (
    restore_pytree_host)
from handwritten_chinese_ocr_samples_torch.core.codec import CTCCodec
from handwritten_chinese_ocr_samples_torch.models.registry import (
    get_model_info)
from handwritten_chinese_ocr_samples_torch.serve.engine import ServingEngine
from handwritten_chinese_ocr_samples_torch.utils.weights import flax_to_torch

from tests.test_torch_lm import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo")
CHARS = os.path.join(DEMO, "data", "chars_list.txt")
WIDTHS = (64, 128)
BEAM = dict(beam_size=4, search_depth=5, len_bonus=1.0)


class NgramStub:
    """An LM backend without ``lm_model``, as a KenLM n-gram is."""


class TransformerStub:
    """An LM backend with ``lm_model``, as a transformer LM is; never read
    on a route that ignores the LM."""
    lm_model = lm_params = tokenizer = None


@pytest.fixture(scope="module")
def demo():
    payload = restore_pytree_host(os.path.join(DEMO, "checkpoint"))
    variables = {"params": payload["params"],
                 "batch_stats": payload["batch_stats"]}
    test_dir = os.path.join(DEMO, "data", "test")
    files = [os.path.join(test_dir, f) for f in sorted(os.listdir(test_dir))]
    return variables, files[:4]


def _port_texts(variables, files, lm):
    model, chars = get_model_info("hctr-tiny", chars_list_file=CHARS)
    engine = ServingEngine(model, flax_to_torch(variables), CTCCodec(chars),
                           widths=WIDTHS, decode_method="beam-search",
                           device="cpu", lm=lm, **BEAM)
    assert not engine._device_lm_beam
    return engine.infer_files_batched(files, batch_size=4)[0]


@pytest.mark.parametrize("lm_cls", [NgramStub, TransformerStub])
def test_beam_with_an_unused_lm_serves_the_plain_beam(demo, lm_cls):
    variables, files = demo
    with open(CHARS, encoding="utf-8") as f:
        codec = JaxCodec("".join(line.strip("\n") for line in f))
    model = FlaxHCTR(num_classes=codec.num_classes, backbone_channels=64,
                     num_blocks=(1, 1, 1, 1), dtype=jnp.float32)
    jax_engine = JaxEngine(model, variables, codec, widths=WIDTHS,
                           decode_method="beam-search", lm=lm_cls(), **BEAM)
    assert jax_engine._device_beam and not jax_engine._host_beam_mode
    want, _ = jax_engine.infer_files(files)
    got = _port_texts(variables, files, lm_cls())
    assert got == want == _port_texts(variables, files, None)
    assert all(want)                  # the trained demo reads every line
