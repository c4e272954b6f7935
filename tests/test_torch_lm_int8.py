"""The port's int8 LM step (``CachedLM(quant_int8=True)``, ``ops/int8_conv.
linear_int8``) against the JAX package's, on the CPU, where I1's wrappers
run their plain versions: the LM of ``tests/test_lm_cached.py`` (d 32, 2
layers, V 20) and that of ``tests/test_torch_beam_lm.py``'s ``setup``, both
flax-initialised and converted, in f32.

* The s8 weights of FF1, FF2 and the tied logits equal JAX's ``_wq``, and
  their scales agree to 1e-7 relative.
* Over 9 steps the int8 logits lie within a tenth of JAX int8's distance
  from JAX float (measured: 4.8e-7 against 0.042).
* The skip search (``AdaptiveLMBeam``) with the int8 LM on
  ``tests/test_adaptive_lm.py:380``'s posteriors gives JAX's int8 texts.
* The peeks stay float, as JAX's do: only ``step`` takes the int8 branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.decode import adaptive as jad
from handwritten_chinese_ocr_samples_tpu.lm.cached import (
    CachedLM as JaxCachedLM)
from handwritten_chinese_ocr_samples_tpu.lm.model import (
    CharTransformerLM as FlaxLM)
from handwritten_chinese_ocr_samples_torch.decode import adaptive as ad
from handwritten_chinese_ocr_samples_torch.decode import beam_lm_device as bl
from handwritten_chinese_ocr_samples_torch.lm.cached import CachedLM
from handwritten_chinese_ocr_samples_torch.lm.model import CharTransformerLM
from handwritten_chinese_ocr_samples_torch.ops import int8_conv as ic
from handwritten_chinese_ocr_samples_torch.utils.weights import (
    lm_flax_to_torch)

from tests.test_beam_skip_device import _peaky_preds
from tests.test_torch_beam_lm import setup  # noqa: F401
from tests.test_torch_lm import one_torch_thread  # noqa: F401
from tests.test_torch_skip_search import AKW, _inputs

V = 20
CFG = dict(vocab_size=V, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_len=64)


@pytest.fixture(scope="module")
def lms():
    """``tests/test_lm_cached.py``'s LM: JAX float, JAX int8, port int8."""
    jax.config.update("jax_platforms", "cpu")
    flax_model = FlaxLM(**CFG)
    params = flax_model.init({"params": jax.random.key(0)},
                             jnp.zeros((1, 8), jnp.int32),
                             train=False)["params"]
    state = lm_flax_to_torch(jax.tree.map(np.asarray, params))
    return (JaxCachedLM(flax_model, params),
            JaxCachedLM(flax_model, params, quant_int8=True),
            CachedLM(CharTransformerLM(**CFG), state, quant_int8=True),
            state)


def test_int8_weights_equal_jax(lms):
    _, jq, pq, _ = lms
    names = [f"ff{i}_{li}" for li in range(2) for i in (1, 2)] + ["logits"]
    assert sorted(pq._wq) == sorted(jq._wq) == sorted(names)
    for name in names:
        wq, s = (np.asarray(a) for a in jq._wq[name])
        if name != "logits":             # JAX keeps (K, N) and s (1, N)
            wq, s = wq.T, s.T
        pw, ps = pq._wq[name]
        N, K = wq.shape
        assert pw.dtype == torch.int8 and pw.shape[1] % 32 == 0
        np.testing.assert_array_equal(pw[:, :K].numpy(), wq)
        assert not pw[:, K:].any()
        np.testing.assert_allclose(ps.numpy(), s[:, 0], rtol=1e-7, atol=0)


def test_int8_step_matches_jax(lms):
    jf, jq, pq, _ = lms
    rng = np.random.default_rng(2)
    B, L = 4, 9
    tokens = rng.integers(0, V, (B, L)).astype(np.int32)
    cf, cq, cp = jf.init_cache(B, 16), jq.init_cache(B, 16), \
        pq.init_cache(B, 16)
    noise = diff = 0.0
    for t in range(L):
        lf, cf = jf.step(cf, jnp.asarray(tokens[:, t]))
        lq, cq = jq.step(cq, jnp.asarray(tokens[:, t]))
        lp, cp = pq.step(cp, torch.from_numpy(tokens[:, t]))
        assert lp.dtype == torch.float32 and lp.shape == (B, V)
        noise = max(noise, float(np.abs(np.asarray(lq) - np.asarray(lf))
                                 .max()))
        diff = max(diff, float(np.abs(lp.numpy() - np.asarray(lq)).max()))
        np.testing.assert_array_equal(lp.numpy().argmax(-1),
                                      np.asarray(lq).argmax(-1))
    assert noise > 0.01
    assert diff <= 0.1 * noise


def test_linear_int8_order_of_operations():
    """``((f32) acc * s_x) * s_w + bias``, each step rounded, with the
    dynamic ``s_x = max(|x|, 1e-8) / 127`` of the live rows."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(5, 40)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(12, 40)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=12).astype(np.float32))
    w_q, s_w = ic.quantize_weight(w, (1,))
    got = ic.linear_int8(x, ic.pack_weight(w_q), s_w.reshape(-1), b,
                         torch.float32)
    s_x = np.float32(np.abs(x.numpy()).max()) / np.float32(127)
    xq = np.clip(np.round(x.numpy() / s_x), -127, 127).astype(np.int64)
    acc = (xq @ w_q.numpy().astype(np.int64).T).astype(np.float32)
    want = (acc * s_x) * s_w.numpy().reshape(-1) + b.numpy()
    np.testing.assert_array_equal(got.numpy(), want)


def test_peeks_stay_float(setup):  # noqa: F811
    """The grouped peek reads FF and the logits in float: an int8 LM's peek
    equals the float LM's bit for bit on the same cache, while its FF in
    ``step`` differs."""
    codec, jclm, clm, (c2l, l2c) = setup
    state = lm_flax_to_torch(jax.tree.map(np.asarray, jclm.p))
    q8 = CachedLM(clm.model, state, quant_int8=True)
    assert q8.quant_int8 and not clm.quant_int8
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 3, clm.d_model, generator=g)
    for li in range(clm.n_layers):
        assert torch.equal(q8._ff_float(h, li), clm._ff_float(h, li))
        assert not torch.equal(q8._ff(h, li), clm._ff(h, li))
    logits, cache = clm.step(clm.init_cache(2, 16),
                             torch.zeros(2, dtype=torch.long))
    next_logp = torch.log_softmax(logits, -1)
    tokens = torch.randint(4, clm.emb.shape[0], (2, 3, 4), generator=g)
    n_tokens = torch.tensor([[4, 2, 1], [3, 4, 0]], dtype=torch.int32)
    for want_last in (False, True):
        want = bl._grouped_peek(clm, cache, tokens, n_tokens, next_logp,
                                want_last=want_last)
        got = bl._grouped_peek(q8, cache, tokens, n_tokens, next_logp,
                               want_last=want_last)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_adaptive_int8_decode_matches_jax(setup):  # noqa: F811
    """``tests/test_adaptive_lm.py:380``'s decode (peaky posteriors, T 16,
    B 8, seed 11, the skip search) with the int8 LM: the port's texts equal
    JAX's int8 decode in f32."""
    codec, jclm, clm, (c2l, l2c) = setup
    jq = JaxCachedLM(jclm.model, jclm.p, quant_int8=True)
    state = lm_flax_to_torch(jax.tree.map(np.asarray, jclm.p))
    pq = CachedLM(clm.model, state, quant_int8=True)
    jargs, targs = _inputs(_peaky_preds(T=16, B=8, seed=11))
    kw = dict(AKW, unknown_id=codec.unknown_id, skip_search=True)
    want = codec.compact_to_texts(*(np.asarray(a) for a in
                                    jad.AdaptiveLMBeam(jq, c2l, l2c, **kw)
                                    .decode(*jargs)))
    got = codec.compact_to_texts(*(a.numpy() for a in ad.AdaptiveLMBeam(
        pq, c2l, l2c, **kw).decode(*targs)))
    assert got == want and any(got)
