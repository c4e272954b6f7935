"""The port's char-LM training (``lm/train.py``, the train mode of
``lm/model.py``, ``lm/io.save_lm``) against the JAX package's ``lm/train.py``
on the same corpus and converted weights, on the CPU.

Tolerances: ``batches_from_corpus`` is exact; the schedule equals optax's
at every step of the warm-up (the first update's 0 included) and lies
within 1e-7 of the learning rate from it on the cosine (XLA's f32 cosine
against one rounded from a double); five f32 steps at dropout 0 from the same
weights give losses within 1e-5 relative and weights within 1e-5 of each
tensor's largest value (Adam divides each gradient by its own running
scale, so the products summed in another order move the update by a few
f32 ulps of the learning rate a step); the attention key biases, whose
gradient is 0 in exact arithmetic, within 4x the learning rates summed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.lm import train as jtrain
from handwritten_chinese_ocr_samples_tpu.lm.model import (
    CharTransformerLM as FlaxLM)
from handwritten_chinese_ocr_samples_tpu.lm.tokenizer import (
    Tokenizer as JaxTokenizer)
from handwritten_chinese_ocr_samples_torch.lm import train as ltrain
from handwritten_chinese_ocr_samples_torch.lm.infer import LMScorer
from handwritten_chinese_ocr_samples_torch.lm.io import load_lm, save_lm
from handwritten_chinese_ocr_samples_torch.lm.model import (
    CharTransformerLM, Dropout)
from handwritten_chinese_ocr_samples_torch.lm.tokenizer import Tokenizer
from handwritten_chinese_ocr_samples_torch.utils.weights import (
    lm_flax_to_torch)

from tests.test_torch_lm import one_torch_thread  # noqa: F401

CHARS = "天地人你我他上中下大小多"
SMALL = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=64)
STEP_TOL = 1e-5


def _corpus(n=48, seed=3):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(CHARS), int(rng.integers(1, 40))))
            for _ in range(n)]


@pytest.mark.parametrize("max_len,batch", [(64, 8), (32, 5)])
def test_batches_from_corpus_match_jax(max_len, batch):
    lines = _corpus()
    want = list(jtrain.batches_from_corpus(
        lines, JaxTokenizer.from_characters(CHARS), batch, max_len, seed=4))
    got = list(ltrain.batches_from_corpus(
        lines, Tokenizer.from_characters(CHARS), batch, max_len, seed=4))
    assert len(got) == len(want) == len(lines) // batch
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt.dtype == torch.int64 and gl.dtype == torch.int32
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert {t.shape[1] for t, _ in got} <= {32, 64}


@pytest.mark.parametrize("lr,warmup,decay", [(5e-4, 200, 375),
                                             (3e-3, 5, 24), (1e-3, 7, 1)])
def test_schedule_matches_optax(lr, warmup, decay):
    want = optax.join_schedules(
        [optax.linear_schedule(0.0, lr, warmup),
         optax.cosine_decay_schedule(lr, decay)], [warmup])
    got = ltrain.lm_schedule(lr, warmup, decay)
    assert got(0) == 0.0
    for count in range(warmup + decay + 5):
        w = np.float32(want(jnp.asarray(count, jnp.int32)))
        g = np.float32(got(count))
        if count < warmup:
            assert g == w, count
        else:
            assert abs(g - w) <= 1e-7 * lr, (count, g, w)


def _jax_state(seed=11):
    tok = JaxTokenizer.from_characters(CHARS)
    model = FlaxLM(vocab_size=tok.vocab_size, dropout=0.0, **SMALL)
    params = model.init({"params": jax.random.key(seed)},
                        jnp.zeros((1, 8), jnp.int32), train=False)["params"]
    return model, params


def test_five_steps_match_jax():
    """Five steps at dropout 0 in f32, warm-up 2 (the first update has lr
    0), the clip active: loss and every weight against JAX's."""
    lines = _corpus(40)
    lr, warmup, decay = 3e-3, 2, 5
    schedule = optax.join_schedules(
        [optax.linear_schedule(0.0, lr, warmup),
         optax.cosine_decay_schedule(lr, decay)], [warmup])
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(schedule, weight_decay=0.01))
    jm, params = _jax_state()
    opt = tx.init(params)
    jstep = jtrain.make_lm_train_step(jm, tx)

    model = CharTransformerLM(vocab_size=jm.vocab_size, dropout=0.0, **SMALL)
    state = lm_flax_to_torch(jax.tree.map(np.asarray, params))
    ptx = ltrain.AdamW(ltrain.lm_schedule(lr, warmup, decay))
    pstate = ltrain.make_lm_train_step(model, ptx)
    popt = ptx.init(list(state.values()))

    batches = list(ltrain.batches_from_corpus(
        lines, Tokenizer.from_characters(CHARS), 8, 64, seed=0))
    moved = 0.0
    for i, (toks, lengths) in enumerate(batches[:5]):
        params, opt, jloss = jstep(params, opt, jnp.asarray(toks.numpy()),
                                   jnp.asarray(lengths.numpy()),
                                   jax.random.key(i))
        new, popt, loss = pstate(state, popt, toks, lengths)
        if i == 0:       # lr 0: nothing moves
            assert all(torch.equal(new[k], state[k]) for k in state)
        state = new
        assert abs(float(loss) - float(jloss)) <= STEP_TOL * float(jloss)
        moved += ltrain.lm_schedule(lr, warmup, decay)(i)
        want = lm_flax_to_torch(jax.tree.map(np.asarray, params))
        for k, w in want.items():
            err = (state[k] - w).abs().max().item()
            if k.endswith("attn.key.bias"):
                # its gradient is 0 in exact arithmetic (a key bias adds
                # one constant to a row of scores), so Adam scales
                # rounding noise to steps of about lr in either sign
                assert err <= 4 * moved, (i, k)
                continue
            assert err <= STEP_TOL * max(w.abs().max().item(), 1e-3), (i, k)
    assert popt["count"] == 5


def test_dropout_sites():
    """Keep rate, inverted scaling, the attention mask shared by the batch
    and the heads, and the five sites: train mode with a generator draws,
    the same generator seed draws the same masks, eval and dropout 0 are
    the plain forward."""
    g = torch.Generator().manual_seed(0)
    drop = Dropout(0.25, g)
    kept = float(np.float32(1) / np.float32(0.75))
    y = drop(torch.ones(200, 300))
    assert set(torch.unique(y).tolist()) == {0.0, kept}
    assert abs((y > 0).float().mean().item() - 0.75) < 0.01
    w = drop(torch.ones(3, 4, 50, 50), broadcast=True)
    assert set(torch.unique(w).tolist()) == {0.0, kept}
    assert all(torch.equal(w[b, h], w[0, 0])
               for b in range(3) for h in range(4))
    assert torch.equal(Dropout(0.25, None)(y), y)

    model = CharTransformerLM(vocab_size=16, dropout=0.3, **SMALL)
    tokens = torch.randint(0, 16, (2, 10), generator=g)
    model.eval()
    plain = model(tokens)
    model.train()
    with pytest.raises(ValueError, match="generator"):
        model(tokens)
    a = model(tokens, torch.Generator().manual_seed(5))
    b = model(tokens, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.allclose(a, plain)
    # five sites a forward: one draw each after the embedding, plus four a
    # layer (attention weights, after attention, after relu(ff1), after ff2)
    calls = []
    orig = Dropout.__call__
    Dropout.__call__ = lambda self, x, broadcast=False: (
        calls.append(broadcast), orig(self, x, broadcast))[1]
    try:
        model(tokens, torch.Generator().manual_seed(5))
    finally:
        Dropout.__call__ = orig
    assert len(calls) == 1 + 4 * SMALL["n_layers"]
    assert calls.count(True) == SMALL["n_layers"]
    off = CharTransformerLM(vocab_size=16, dropout=0.0, **SMALL)
    off.load_state_dict(model.state_dict())
    assert torch.equal(off.train()(tokens), plain)


def test_save_lm_round_trip(tmp_path):
    jm, params = _jax_state()
    model = CharTransformerLM(vocab_size=jm.vocab_size, **SMALL)
    state = lm_flax_to_torch(jax.tree.map(np.asarray, params))
    tok = Tokenizer.from_characters(CHARS)
    save_lm(str(tmp_path / "lm"), model, state, tok)
    m2, s2, t2 = load_lm(str(tmp_path / "lm"))
    assert m2.config() == model.config()
    assert set(s2) == set(state) and all(torch.equal(s2[k], state[k])
                                         for k in state)
    assert t2.symbols == tok.symbols
    for name in ("config.json", "dict.txt", "weights.pt"):
        assert (tmp_path / "lm" / name).is_file()


def test_lm_overfits_tiny_corpus():
    """The twin of the JAX package's ``test_lm_overfits_tiny_corpus``."""
    corpus = ["天地人你我他"] * 64
    model, params, tok = ltrain.train_char_lm(
        corpus, CHARS, epochs=6, batch_size=16, max_len=32,
        lr=3e-3, warmup_steps=5, d_model=32, n_layers=2,
        log_every=10_000, dtype=torch.float32, device="cpu")
    scorer = LMScorer(model, params, tok, device="cpu")
    ppl = scorer.perplexity(["天地人你我他"])
    assert ppl < 4.0, ppl
    nxt = scorer.next_k_words(["天地人"], k=1, char_based=True)
    assert nxt[0][:1] == ["你"]
    assert math.isfinite(ppl)


def test_init_matches_flax_initialisers():
    """The trainer's first weights (``utils.weights.init_lm_state_dict``)
    against flax's init of the same LM, d 128, two layers: each tensor's
    standard deviation within 5% of flax's (a few thousand draws or more
    each: well inside), kernels truncated at two standard deviations of the
    untruncated normal (largest |w| <= 2 sqrt(1/fan_in) / 0.8796, in both)
    and the embeddings not (largest |w| over 3 of their std, in both);
    biases 0 and LayerNorms at identity, as flax's."""
    from handwritten_chinese_ocr_samples_torch.utils.weights import (
        init_lm_state_dict)
    cfg = dict(vocab_size=100, d_model=128, n_layers=2, n_heads=4,
               d_ff=512, max_len=64)
    flax_params = FlaxLM(**cfg).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 8), jnp.int32),
        train=False)["params"]
    want = lm_flax_to_torch(jax.tree.map(np.asarray, flax_params))
    got = init_lm_state_dict(dict(cfg, dropout=0.1, tie_embeddings=True),
                             torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == torch.float32, key
        if g.dim() == 1 or key.endswith("bias"):
            assert torch.equal(g, w), key
            continue
        assert abs(g.std().item() / w.std().item() - 1) < 0.05, key
        if key in ("embed.weight", "pos_embed"):
            for t in (g, w):
                assert t.abs().max().item() > 3 * t.std().item(), key
        else:
            cut = 2 * math.sqrt(1.0 / g.shape[1]) / 0.87962566103423978
            for t in (g, w):
                assert t.abs().max().item() <= cut * (1 + 1e-6), key
            assert g.abs().max().item() > 0.95 * cut, key
