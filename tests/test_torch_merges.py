"""The two opt-in merge variants of the device searches against the JAX
package's same variants, in f32.

  * ``HCTR_DENSE_MERGE=0``: the plain device beam's sort merge (stable sort
    on the two-lane prefix hash, payloads by gather, segment starts and a
    segmented logaddexp), read where the route is built, as the JAX engine
    and driver read ``dense_merge_default()``;
  * ``HCTR_LM_DENSE_MERGE=1``: the LM-fused search's dense merge
    (all-pairs hash equality, the lowest row representing its group,
    group log-sum-exp by max + exp-sum), read by ``AdaptiveLMBeam``, in the
    full and the skip search.

The JAX package notes that each variant's low-order bits differ from the
other's, so each is held against the same variant there: prefixes and
lengths equal, and the overflow flags.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import log_softmax

from handwritten_chinese_ocr_samples_tpu.core.codec import CTCCodec as JCodec
from handwritten_chinese_ocr_samples_tpu.decode import adaptive as jad
from handwritten_chinese_ocr_samples_tpu.decode.beam_device import (
    beam_search_from_topk as jax_beam, beam_search_fused as jax_fused,
    dense_merge_default as jax_dense_default)
from handwritten_chinese_ocr_samples_torch.core.codec import CTCCodec
from handwritten_chinese_ocr_samples_torch.decode import adaptive as ad
from handwritten_chinese_ocr_samples_torch.decode import beam_lm_device as bl
from handwritten_chinese_ocr_samples_torch.decode.beam_device import (
    beam_search_from_topk, dense_merge_default)
from handwritten_chinese_ocr_samples_torch.decode.routes import build_route

from tests.test_beam_skip_device import _peaky_preds
from tests.test_torch_beam_lm import KW, _inputs as _full_inputs, _preds
from tests.test_torch_beam_lm import setup  # noqa: F401
from tests.test_torch_decode import UNK, _assert_beams_equal, _logits, _topk
from tests.test_torch_lm import one_torch_thread  # noqa: F401
from tests.test_torch_skip_search import (
    AKW, BASE, _equal, _inputs as _skip_inputs, _jax_search)


# ------------------------------------------------ the plain beam's sort merge
@pytest.mark.parametrize("seed,peaked,beam,depth,len_bonus", [
    (0, True, 4, 5, 0.0), (1, False, 4, 5, 0.0), (2, True, 10, 10, 5.7),
    (3, False, 6, 3, 1.0), (4, True, 3, 10, 0.5)])
def test_beam_sort_merge_matches_jax(seed, peaked, beam, depth, len_bonus):
    x = _logits(3, 30, seed, peaked=peaked)
    vals, idx = _topk(x, depth)
    want = jax_beam(jnp.asarray(vals), jnp.asarray(idx), beam_size=beam,
                    unknown_id=UNK, len_bonus=len_bonus, dense_merge=False)
    got = beam_search_from_topk(torch.from_numpy(vals), torch.from_numpy(idx),
                                beam_size=beam, unknown_id=UNK,
                                len_bonus=len_bonus, dense_merge=False)
    _assert_beams_equal(got, want)


@pytest.mark.parametrize("value", [None, "1", "0", "", "yes"])
def test_dense_merge_default_reads_env_as_jax(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("HCTR_DENSE_MERGE", raising=False)
    else:
        monkeypatch.setenv("HCTR_DENSE_MERGE", value)
    assert dense_merge_default() == jax_dense_default()


@pytest.mark.parametrize("env,dense", [("0", False), ("1", True)])
def test_beam_route_takes_the_env_merge(env, dense, monkeypatch):
    """The route reads ``HCTR_DENSE_MERGE`` when it is built and its texts
    are the JAX fused search's with the same merge."""
    chars = "".join(chr(0x4E00 + i) for i in range(UNK - 1))
    monkeypatch.setenv("HCTR_DENSE_MERGE", env)
    route = build_route(CTCCodec(chars), "beam-search", beam_size=5,
                        search_depth=6, len_bonus=0.5, device="cpu")
    assert route.name == "beam" and route.dense_merge is dense
    x = log_softmax(_logits(4, 28, 7), axis=-1).astype(np.float32) * 1.3
    got = route.dispatch(torch.from_numpy(x))()
    jp, jl = jax_fused(jnp.asarray(x), beam_size=5, depth=6, unknown_id=UNK,
                       len_bonus=0.5, dense_merge=dense)
    assert got == JCodec(chars).compact_to_texts(np.asarray(jp),
                                                 np.asarray(jl))


# ---------------------------------------------------- the LM dense merge
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("use_pred", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_lm_full_search_dense_merge_matches_jax(setup, seed, use_pred,
                                                group):
    from handwritten_chinese_ocr_samples_tpu.decode import (
        beam_lm_device as jbl)
    codec, jclm, clm, (c2l, l2c) = setup
    kw = dict(KW, unknown_id=codec.unknown_id, lm_ctx=64,
              use_lm_pred=use_pred, group_size=group, return_overflow=True,
              dense_merge=True)
    jargs, targs = _full_inputs(_preds(16, 4, seed), KW["depth"])
    want = jbl.make_lm_beam_search(jclm, c2l, l2c, **kw)(*jargs)
    got = bl.make_lm_beam_search(clm, c2l, l2c, **kw)(*targs)
    _equal(want, got)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("use_pred", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_lm_skip_search_dense_merge_matches_jax(setup, seed, use_pred,
                                                group):
    codec, jclm, clm, (c2l, l2c) = setup
    jargs, targs = _skip_inputs(_peaky_preds(T=24, B=4, seed=seed))
    kw = dict(BASE, unknown_id=codec.unknown_id, use_lm_pred=use_pred,
              group_size=group, dense_merge=True)
    want = _jax_search(jclm, c2l, l2c, **kw)(*jargs)
    got = bl.make_lm_beam_search(clm, c2l, l2c, **kw)(*targs)
    _equal(want, got)
    assert int(got[1].min()) > 0


@pytest.mark.parametrize("env", ["1", "0"])
def test_adaptive_reads_lm_dense_merge_env(setup, env, monkeypatch):
    """``HCTR_LM_DENSE_MERGE`` picks the merge of ``AdaptiveLMBeam`` in
    both packages (read when it is built); the texts are JAX's."""
    codec, jclm, clm, (c2l, l2c) = setup
    monkeypatch.setenv("HCTR_LM_DENSE_MERGE", env)
    kw = dict(AKW, unknown_id=codec.unknown_id)
    jbeam = jad.AdaptiveLMBeam(jclm, c2l, l2c, **kw)
    beam = ad.AdaptiveLMBeam(clm, c2l, l2c, **kw)
    assert beam._dense is jbeam._dense is (env == "1")
    jargs, targs = _skip_inputs(_peaky_preds(T=16, B=4, seed=5))
    want = jbeam.decode(*jargs)
    got = beam.decode(*targs)
    _equal((*want, np.zeros(4, bool)), (*got, torch.zeros(4, dtype=bool)))
