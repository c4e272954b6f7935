"""The codec, greedy and device beam decoding: the port against the JAX
package.

Both sides get the same numpy inputs; the outputs are integer index rows or
strings and must be identical (greedy: chars and lengths; beam: each best
prefix and its length). The beam side runs the JAX dense merge, which the
port ports.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import log_softmax

from handwritten_chinese_ocr_samples_tpu.core import codec as jax_codec
from handwritten_chinese_ocr_samples_tpu.decode.beam_device import (
    beam_search_from_topk as jax_beam, beam_search_fused as jax_fused)
from handwritten_chinese_ocr_samples_tpu.ops.decode import (
    greedy_decode_device as jax_greedy)
from handwritten_chinese_ocr_samples_tpu.ops.topk_logsoftmax import (
    topk_logsoftmax_xla)
from handwritten_chinese_ocr_samples_torch.core import codec as port_codec
from handwritten_chinese_ocr_samples_torch.decode.beam_device import (
    beam_search_fused, beam_search_from_topk)
from handwritten_chinese_ocr_samples_torch.ops.decode import (
    greedy_decode_device)

from tests.test_torch_lm import one_torch_thread  # noqa: F401

UNK = 9            # 8-char vocabulary: blank 0, chars 1-8, unknown 9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("chars_list", ["demo/data/chars_list.txt",
                                        "demo/full/data/chars_list.txt"])
def test_codec_matches_jax(chars_list):
    path = os.path.join(REPO, chars_list)
    chars = port_codec.load_chars_list(path)
    assert chars == jax_codec.load_chars_list(path)
    got, want = port_codec.CTCCodec(chars), jax_codec.CTCCodec(chars)
    assert (got.num_classes, got.blank_id, got.unknown_id) == \
        (want.num_classes, want.blank_id, want.unknown_id)
    assert got.characters == want.characters
    rng = np.random.default_rng(len(chars))
    rows = rng.integers(1, got.unknown_id, size=(4, 30)).astype(np.int32)
    lengths = np.array([0, 1, 17, 30], np.int32)
    assert got.compact_to_texts(rows, lengths) == \
        want.compact_to_texts(rows, lengths)


def _logits(B, T, seed, peaked=True, blank_bias=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, UNK + 1)).astype(np.float32)
    if peaked:
        x *= 4.0
    x[..., 0] += blank_bias
    return x


@pytest.mark.parametrize("seed,with_widths", [(0, False), (1, True),
                                              (2, False)])
def test_greedy_matches_jax(seed, with_widths):
    x = _logits(3, 40, seed, blank_bias=1.0)
    x[0, 5:9] = x[0, 5]                       # repeats across frames
    x[1, :, 3] = x[1].max(-1)                 # argmax ties -> lowest index
    widths = np.array([40, 17, 0], np.int32) if with_widths else None
    want = jax_greedy(jnp.asarray(x),
                      None if widths is None else jnp.asarray(widths),
                      unknown_id=UNK)
    got = greedy_decode_device(
        torch.from_numpy(x),
        None if widths is None else torch.from_numpy(widths),
        unknown_id=UNK)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _topk(x, k):
    vals, idx, _, _ = topk_logsoftmax_xla(jnp.asarray(x), k=k)
    return np.array(vals), np.array(idx)


def _assert_beams_equal(got, want):
    (gp, gl), (wp, wl) = got, want
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    for b in range(gl.shape[0]):
        n = int(gl[b])
        np.testing.assert_array_equal(gp[b, :n].numpy(),
                                      np.asarray(wp)[b, :n])


@pytest.mark.parametrize("seed,peaked,beam,depth,len_bonus", [
    (0, True, 4, 5, 0.0), (1, False, 4, 5, 0.0), (2, True, 10, 10, 5.7),
    (3, False, 6, 3, 1.0), (4, True, 3, 10, 0.5)])
def test_beam_matches_jax_dense_merge(seed, peaked, beam, depth, len_bonus):
    x = _logits(3, 30, seed, peaked=peaked)
    vals, idx = _topk(x, depth)
    want = jax_beam(jnp.asarray(vals), jnp.asarray(idx), beam_size=beam,
                    unknown_id=UNK, len_bonus=len_bonus, dense_merge=True)
    got = beam_search_from_topk(torch.from_numpy(vals), torch.from_numpy(idx),
                                beam_size=beam, unknown_id=UNK,
                                len_bonus=len_bonus)
    _assert_beams_equal(got, want)


def test_beam_all_blank_and_early_end():
    x = _logits(2, 20, 5)
    x[0, :, 0] += 100.0                       # all blank: no step runs
    x[1, 6:, 0] += 100.0                      # ends at frame 5 + 4
    vals, idx = _topk(x, 5)
    want = jax_beam(jnp.asarray(vals), jnp.asarray(idx), beam_size=4,
                    unknown_id=UNK, dense_merge=True)
    got = beam_search_from_topk(torch.from_numpy(vals), torch.from_numpy(idx),
                                beam_size=4, unknown_id=UNK)
    _assert_beams_equal(got, want)
    assert int(got[1][0]) == 0


def test_beam_fused_matches_jax_fused():
    x = log_softmax(_logits(2, 24, 6), axis=-1).astype(np.float32) * 1.3
    want = jax_fused(jnp.asarray(x), beam_size=5, depth=6, unknown_id=UNK,
                     dense_merge=True)
    got = beam_search_fused(torch.from_numpy(x), beam_size=5, depth=6,
                            unknown_id=UNK)
    _assert_beams_equal(got, want)
