"""The port's char LM (tokenizer, model, weight bridge, loading, KV-cached
step) against the JAX package's, on the same numpy inputs and converted
weights.

Tolerances: f32 logits of the full forward agree to 1e-5 (the same products
summed in another order); the KV-cached step's logits and cache to 1e-5
too, and in bf16 to one bf16 step of the largest value. Only small LMs (d 32, 2 layers) run a forward here; the full-width
``char-512x6`` is checked by its shapes alone.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.lm.cached import (
    CachedLM as JaxCachedLM)
from handwritten_chinese_ocr_samples_tpu.lm.model import (
    CharTransformerLM as FlaxLM)
from handwritten_chinese_ocr_samples_tpu.lm.tokenizer import (
    Tokenizer as JaxTokenizer)
from handwritten_chinese_ocr_samples_torch.lm.cached import CachedLM
from handwritten_chinese_ocr_samples_torch.lm.io import load_lm
from handwritten_chinese_ocr_samples_torch.lm.model import (
    CharTransformerLM, get_lm_config)
from handwritten_chinese_ocr_samples_torch.lm.tokenizer import Tokenizer
from handwritten_chinese_ocr_samples_torch.utils.weights import (
    lm_flax_to_torch, seeded_lm_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_DIR = os.path.join(REPO, "demo", "full", "lm")
CHARS_LIST = os.path.join(REPO, "demo", "full", "data", "chars_list.txt")
CHARS = "abcdefgh"
TOL = 1e-5
SMALL = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the machine's cores: one torch thread each
    keeps the many small ops of these tests from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_lm():
    """A flax LM of the JAX beam tests' size and its converted twin."""
    tok = JaxTokenizer.from_characters(CHARS)
    flax_model = FlaxLM(vocab_size=tok.vocab_size, **SMALL)
    params = flax_model.init({"params": jax.random.key(5)},
                             jnp.zeros((1, 8), jnp.int32),
                             train=False)["params"]
    model = CharTransformerLM(vocab_size=tok.vocab_size, **SMALL)
    state = lm_flax_to_torch(jax.tree.map(np.asarray, params))
    model.load_state_dict(state)
    return flax_model, params, model.eval(), state


def test_tokenizer_matches_jax():
    want, got = JaxTokenizer.from_characters(CHARS), \
        Tokenizer.from_characters(CHARS)
    assert got.symbols == want.symbols and got.indices == want.indices
    assert (got.sos_index, got.pad_index, got.eos_index, got.unk_index) \
        == (0, 1, 2, 3)
    sents = ["abc", "hgfa", "", "az"]
    for kw in (dict(char_based=True), dict(char_based=True, fixed_len=6),
               dict(char_based=False)):
        np.testing.assert_array_equal(got.tokenize(sents, **kw),
                                      want.tokenize(sents, **kw))
    assert got.decode([0, 4, 11, 3, 7]) == want.decode([0, 4, 11, 3, 7])


def test_tokenizer_from_chars_list_matches_dict_file():
    with open(CHARS_LIST, encoding="utf-8") as f:
        chars = "".join(line.strip("\n") for line in f)
    got = Tokenizer.from_characters(chars)
    for want in (Tokenizer(os.path.join(LM_DIR, "dict.txt")),
                 JaxTokenizer(os.path.join(LM_DIR, "dict.txt"))):
        assert got.symbols == want.symbols
        assert got.indices == want.indices
    assert got.vocab_size == 7377


def test_char_512x6_config_is_the_served_lm():
    with open(os.path.join(LM_DIR, "config.json")) as f:
        assert get_lm_config("char-512x6") == json.load(f)
    with pytest.raises(ValueError, match="unknown LM config"):
        get_lm_config("char-1024x12")


def test_forward_matches_flax(small_lm):
    flax_model, params, model, _ = small_lm
    tokens = np.random.default_rng(0).integers(
        0, flax_model.vocab_size, size=(3, 11))
    want = np.asarray(flax_model.apply({"params": params},
                                       jnp.asarray(tokens), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_full_config_state_dict_matches_flax_tree():
    """The converter maps every leaf of the full-width flax tree onto the
    torch module's state dict, shape for shape (no forward runs)."""
    cfg = get_lm_config("char-512x6")
    shapes = jax.eval_shape(
        lambda: FlaxLM(**cfg).init({"params": jax.random.key(0)},
                                   jnp.zeros((1, 8), jnp.int32),
                                   train=False))["params"]
    zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    got = {k: tuple(v.shape) for k, v in lm_flax_to_torch(zeros).items()}
    with torch.device("meta"):
        want = {k: tuple(v.shape)
                for k, v in CharTransformerLM(**cfg).state_dict().items()}
    assert got == want
    assert want["layer0.attn.query.weight"] == (512, 512)
    assert want["embed.weight"] == (7377, 512)
    assert want["pos_embed"] == (160, 512)


def test_bf16_leaves_upcast(small_lm):
    _, params, _, _ = small_lm
    import ml_dtypes
    bf = jax.tree.map(lambda a: np.asarray(a).astype(ml_dtypes.bfloat16),
                      params)
    state = lm_flax_to_torch(bf)
    assert all(t.dtype == torch.float32 for t in state.values())


def test_seeded_lm_state_dict_loads():
    cfg = dict(vocab_size=12, **SMALL, dropout=0.1, tie_embeddings=True)
    a, b = seeded_lm_state_dict(cfg, 3), seeded_lm_state_dict(cfg, 3)
    model = CharTransformerLM(**cfg)
    model.load_state_dict(a)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.weight"],
                           seeded_lm_state_dict(cfg, 4)["embed.weight"])
    assert torch.equal(a["layer1.ln2.weight"], torch.ones(32))


def test_load_lm_seed_and_directory(small_lm, tmp_path):
    model, state, tok = load_lm("seed:7", chars_list=CHARS)
    cfg = model.config()
    assert cfg == dict(get_lm_config("char-512x6"), vocab_size=12)
    assert set(state) == set(model.state_dict())
    assert tok.symbols == Tokenizer.from_characters(CHARS).symbols
    with pytest.raises(ValueError, match="chars_list"):
        load_lm("seed:7")

    _, _, small, small_state = small_lm
    d = tmp_path / "lm"
    d.mkdir()
    Tokenizer.from_characters(CHARS).save_dict(str(d / "dict.txt"))
    (d / "config.json").write_text(json.dumps(small.config()))
    (d / "weights").mkdir()                 # an orbax tree, not converted
    with pytest.raises(FileNotFoundError, match="lm_flax_to_torch"):
        load_lm(str(d))
    torch.save(small_state, str(d / "weights.pt"))
    model, state, tok = load_lm(str(d))
    assert model.config() == small.config() and tok.vocab_size == 12
    assert all(torch.equal(state[k], small_state[k]) for k in small_state)


def test_cached_step_matches_jax(small_lm):
    """The sos priming step and a few more tokens, with a write mask: logits
    and the KV cache agree with the JAX ``CachedLM.step``."""
    flax_model, params, model, state = small_lm
    jclm = JaxCachedLM(flax_model, params)
    clm = CachedLM(model, state)
    rng = np.random.default_rng(1)
    B, Lmax = 3, 9
    jcache, cache = jclm.init_cache(B, Lmax), clm.init_cache(B, Lmax)
    for step in range(5):
        toks = rng.integers(0, flax_model.vocab_size, B).astype(np.int32)
        mask = np.array([True, step % 2 == 0, step != 3])
        jl, jcache = jclm.step(jcache, jnp.asarray(toks), jnp.asarray(mask))
        tl, cache = clm.step(cache, torch.from_numpy(toks),
                             torch.from_numpy(mask))
        live = mask
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(cache.lengths.numpy(),
                                      np.asarray(jcache.lengths))
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v),
                                   rtol=TOL, atol=TOL)


def test_cached_step_bf16_matches_jax(small_lm):
    """The serving dtype: every weight and the cache in bf16, LayerNorm
    statistics, attention scores and logits in f32, as in the JAX package.
    Tolerance: one bf16 step (2^-8) of the largest value, for an
    activation that rounds the other way after a sum in another order."""
    flax_model, params, model, state = small_lm
    jclm = JaxCachedLM(flax_model, params, dtype=jnp.bfloat16)
    clm = CachedLM(model, state, dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    jcache, cache = jclm.init_cache(3, 8), clm.init_cache(3, 8)
    assert cache.k.dtype == torch.bfloat16
    for _ in range(6):
        toks = rng.integers(0, flax_model.vocab_size, 3).astype(np.int32)
        jl, jcache = jclm.step(jcache, jnp.asarray(toks))
        tl, cache = clm.step(cache, torch.from_numpy(toks))
        assert tl.dtype == torch.float32
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl,
                                   atol=2 ** -8 * np.abs(jl).max())
        jk = np.asarray(jcache.k, np.float32)
        np.testing.assert_allclose(cache.k.float().numpy(), jk,
                                   atol=2 ** -8 * np.abs(jk).max())


def test_cached_lm_matches_full_forward(small_lm):
    _, _, model, state = small_lm
    clm = CachedLM(model, state)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 12, (2, 6)))
    with torch.no_grad():
        full = model(tokens)
    cache = clm.init_cache(2, 8)
    steps = []
    for t in range(6):
        logits, cache = clm.step(cache, tokens[:, t])
        steps.append(logits)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_cached_lm_unported_options(small_lm):
    _, _, model, state = small_lm
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CachedLM(model, state, quant_int8=True)
    untied = CharTransformerLM(vocab_size=12, **SMALL, tie_embeddings=False)
    with pytest.raises(ValueError, match="tied"):
        CachedLM(untied, untied.state_dict())
