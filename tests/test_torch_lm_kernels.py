"""The plain versions of kernels K2 (peek attention), K3 (vocabulary
log-sum-exp) and K4 (KV-cache gather and write) against the JAX package's
Pallas kernels (interpret mode) and XLA oracles, at the shapes of
``tests/test_pallas_kernels.py``, in f32 and on bf16 inputs, with the edge
cases. The CUDA kernels themselves run on the card only (``chip_smoke.py``);
here each wrapper must take its plain version for a CPU tensor.

Tolerances: 1e-5 in f32 (the same sums in another order); on bf16 inputs
1e-3 relative, the products being exact in f32 and the sums in another order
but the attention weights rounded to bf16 before their product with v, where
an order change can move a weight by one bf16 step. K4 is a copy: exact.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.decode import beam_device as jbd
from handwritten_chinese_ocr_samples_tpu.lm.cached import (
    CachedLM as JaxCachedLM, LMCache as JaxLMCache)
from handwritten_chinese_ocr_samples_tpu.ops import cache_gather as jk4
from handwritten_chinese_ocr_samples_tpu.ops import logits_lse as jk3
from handwritten_chinese_ocr_samples_tpu.ops import peek_attention as jk2
from handwritten_chinese_ocr_samples_torch.decode import beam_device as bd
from handwritten_chinese_ocr_samples_torch.lm.cached import CachedLM, LMCache
from handwritten_chinese_ocr_samples_torch.ops import cache_gather as k4
from handwritten_chinese_ocr_samples_torch.ops import logits_lse as k3
from handwritten_chinese_ocr_samples_torch.ops import peek_attention as k2

from tests.test_torch_lm import one_torch_thread  # noqa: F401

F32_TOL = 1e-5
BF16_TOL = 1e-3


def _t(a):
    """numpy (bf16 via ml_dtypes) -> torch, same values."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_peek_attention_matches_jax(dtype):
    rng = np.random.default_rng(0)
    B, N, H, Dh, L = 4, 10, 2, 8, 16
    q = rng.normal(size=(B, N, H, Dh)).astype(dtype)
    k = rng.normal(size=(B, L, H, Dh)).astype(dtype)
    v = rng.normal(size=(B, L, H, Dh)).astype(dtype)
    lengths = np.asarray([0, 3, L, 7], np.int32)
    got = k2.peek_cache_attention(_t(q), _t(k), _t(v), _t(lengths))
    assert all(g.dtype == torch.float32 for g in got)
    tol = F32_TOL if dtype == np.float32 else BF16_TOL
    args = [jnp.asarray(a) for a in (q, k, v, lengths)]
    for want in (jk2.peek_cache_attention(*args, interpret=True),
                 jk2.peek_cache_attention_xla(*args)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                       atol=tol)
    o, m, lsum = got
    assert (m[0] == -1e30).all() and (lsum[0] == 0).all() and \
        (o[0] == 0).all()                      # the empty cache


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_peek_attention_deep_cache_matches_jax(dtype):
    """A 512-position cache (the largest ``STABLE_CTX``), lengths at the
    edges of the CUDA kernel's 64-key tiles, and N not a multiple of 16."""
    rng = np.random.default_rng(12)
    B, N, H, Dh, L = 6, 5, 2, 8, 512
    q = (rng.normal(size=(B, N, H, Dh)) / Dh ** 0.5).astype(dtype)
    k = rng.normal(size=(B, L, H, Dh)).astype(dtype)
    v = rng.normal(size=(B, L, H, Dh)).astype(dtype)
    lengths = np.asarray([0, 1, 63, 64, 65, 512], np.int32)
    got = k2.peek_cache_attention(_t(q), _t(k), _t(v), _t(lengths))
    tol = F32_TOL if dtype == np.float32 else BF16_TOL
    args = [jnp.asarray(a) for a in (q, k, v, lengths)]
    for want in (jk2.peek_cache_attention(*args, interpret=True),
                 jk2.peek_cache_attention_xla(*args)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                       atol=tol)
    o, m, lsum = got
    assert (m[0] == -1e30).all() and (lsum[0] == 0).all() and \
        (o[0] == 0).all()                      # the empty cache
    assert (lsum[1] == 1).all()               # one key: its weight is 1


def test_merge_and_combine_partials_match_jax():
    rng = np.random.default_rng(4)
    shape = (3, 5, 2)
    parts = []
    for _ in range(2):
        o = rng.normal(size=shape + (8,)).astype(np.float32)
        m = rng.normal(size=shape).astype(np.float32)
        lsum = rng.uniform(0.5, 3, size=shape).astype(np.float32)
        parts += [o, m, lsum]
    parts[2][0] = 0.0                    # a fully masked first partial
    parts[1][0] = -1e30
    tp = [torch.from_numpy(a) for a in parts]
    jp = [jnp.asarray(a) for a in parts]
    np.testing.assert_allclose(k2.merge_partials(*tp).numpy(),
                               np.asarray(jk2.merge_partials(*jp)),
                               rtol=F32_TOL, atol=F32_TOL)
    for g, w in zip(k2.combine_partials(*tp), jk2.combine_partials(*jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL)


# ------------------------------------------------------------------ K3
@pytest.mark.parametrize("shape,V,d", [((2, 3, 4), 300, 64),
                                       ((37,), 777, 96),
                                       ((1, 5), 128, 32)])
def test_lse_rows_and_target_logit_match_jax(shape, V, d):
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape + (d,)).astype(np.float32)
    emb = rng.normal(size=(V, d)).astype(np.float32)
    tgt = rng.integers(0, V, size=shape).astype(np.int32)
    lse = k3.lse_rows(_t(x), _t(emb))
    tgt_t, lse2 = k3.target_lse(_t(x), _t(emb), _t(tgt))
    assert lse.shape == shape and torch.equal(lse, lse2)
    want_t, want_lse = jk3.target_lse_xla(jnp.asarray(x), jnp.asarray(emb),
                                          jnp.asarray(tgt))
    pallas = jk3.lse_rows(jnp.asarray(x), jnp.asarray(emb), block_rows=16,
                          block_v=128, interpret=True)
    for w in (want_lse, pallas):
        np.testing.assert_allclose(lse.numpy(), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL)
    np.testing.assert_allclose(tgt_t.numpy(), np.asarray(want_t),
                               rtol=F32_TOL, atol=F32_TOL)


def test_lse_rows_lm_vocabulary_matches_jax():
    """The served LM's vocabulary and width (V = 7377, d = 512), with 37
    rows: neither a multiple of the CUDA kernel's 128-row nor of its
    128-entry vocabulary tile."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(37, 512)).astype(np.float32)
    emb = (rng.normal(size=(7377, 512)) / 512 ** 0.5).astype(np.float32)
    got = k3.lse_rows(_t(x), _t(emb))
    want = jk3.lse_rows(jnp.asarray(x), jnp.asarray(emb), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("V", [130, 777, 7375, 7377])
@pytest.mark.parametrize("rows,tile_rows,tile_v,blocks_per_sm", [
    (2520, 128, 256, 1), (37, 128, 256, 1), (2520, 64, 64, 4),
    (50000, 128, 256, 1)])
def test_lse_rows_vocabulary_splits_cover_v(V, rows, tile_rows, tile_v,
                                            blocks_per_sm):
    """The K3 wrapper's vocabulary ranges (the tensor-core path's tiles,
    then the SIMT path's): whole tiles, none empty, covering [0, V)
    exactly, and no more blocks than fit the SMs unless the row tiles
    alone do not."""
    n_sm = 132
    v_per_split, n_split = k3.plan_splits(rows, V, n_sm, tile_rows, tile_v,
                                          blocks_per_sm)
    assert v_per_split % tile_v == 0 and n_split >= 1
    ranges = [(s * v_per_split, min(V, (s + 1) * v_per_split))
              for s in range(n_split)]
    assert all(lo < hi for lo, hi in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == V
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    n_rt = -(-rows // tile_rows)
    if n_rt <= blocks_per_sm * n_sm:
        assert n_rt * n_split <= blocks_per_sm * n_sm
    else:
        assert n_split == 1


def test_lse_rows_bf16_inputs():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(9, 48)).astype(ml_dtypes.bfloat16)
    emb = rng.normal(size=(260, 48)).astype(ml_dtypes.bfloat16)
    got = k3.lse_rows(_t(x), _t(emb))
    _, want = jk3.target_lse_xla(jnp.asarray(x), jnp.asarray(emb),
                                 jnp.zeros((9,), jnp.int32))
    pallas = jk3.lse_rows(jnp.asarray(x), jnp.asarray(emb), block_rows=8,
                          block_v=128, interpret=True)
    for w in (want, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   rtol=BF16_TOL, atol=BF16_TOL)


# ------------------------------------------------------------------ K4
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_gather_write_kv_matches_jax(dtype):
    rng = np.random.default_rng(5)
    layers, B, L, H, Dh = 2, 6, 16, 2, 8
    k = rng.normal(size=(layers, B, L, H, Dh)).astype(dtype)
    v = rng.normal(size=(layers, B, L, H, Dh)).astype(dtype)
    kn = rng.normal(size=(layers, B, H, Dh)).astype(dtype)
    vn = rng.normal(size=(layers, B, H, Dh)).astype(dtype)
    lengths = rng.integers(0, L, size=(B,)).astype(np.int32)
    # repeated parents; writes at 0, inside, L - 1, at L and past L
    for idx, wpos in (([3, 3, 0, 5, 4, 1], [0, 7, L, 2, L - 1, L + 3]),
                      (list(range(B)), [L] * B)):
        idx = np.asarray(idx, np.int32)
        wpos = np.asarray(wpos, np.int32)
        got_k, got_v = k4.gather_write_kv(_t(k), _t(v), _t(idx), _t(kn),
                                          _t(vn), _t(wpos))
        jargs = [jnp.asarray(a) for a in (k, v, idx, kn, vn, wpos)]
        want = JaxCachedLM.gather_write_xla(
            JaxLMCache(k=jargs[0], v=jargs[1], lengths=jnp.asarray(lengths)),
            jargs[2], jargs[3], jargs[4], jargs[5])
        for w in ((want.k, want.v), jk4.gather_write_kv(*jargs)):
            np.testing.assert_array_equal(_np(got_k), np.asarray(w[0],
                                                                 np.float32))
            np.testing.assert_array_equal(_np(got_v), np.asarray(w[1],
                                                                 np.float32))
        # through CachedLM: lengths reorder with the beams, not advanced
        cache = CachedLM.gather_write(
            LMCache(k=_t(k), v=_t(v), lengths=_t(lengths)), _t(idx), _t(kn),
            _t(vn), _t(wpos))
        np.testing.assert_array_equal(cache.lengths.numpy(), lengths[idx])
        assert torch.equal(cache.k, got_k)


def test_wrappers_refuse_other_devices():
    q = torch.zeros((1, 2, 1, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        k2.peek_cache_attention(q, q, q, torch.zeros(1, device="meta"))
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        k3.lse_rows(x, x)
    c = torch.zeros((1, 1, 2, 1, 4), device="meta")
    n = torch.zeros((1, 1, 1, 4), device="meta")
    i = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        k4.gather_write_kv(c, c, i, n, n, i)
    with pytest.raises(ValueError, match="layers"):
        k4.gather_write_kv(c, c, i, n[0], n[0], i)


# ------------------------------------------------------- the sort merge
def test_sort_merge_matches_jax():
    """The stable (h1, h2, row) order and the segmented logaddexp of the
    LM search's merge, against the JAX package's ``lax.sort`` and
    associative scan, on rows with repeated keys, dead values and dead
    segments. Segment-start rows carry the segment total."""
    rng = np.random.default_rng(3)
    G, n = 4, 60
    kh1 = rng.integers(-3, 3, size=(G, n)).astype(np.int32)
    kh2 = rng.integers(-2, 2, size=(G, n)).astype(np.int32)
    kh1[:, :3] = [2 ** 31 - 1, -2 ** 31, 0x7FFFFFF0]
    vals = rng.normal(size=(G, n)).astype(np.float32) * 5
    vals[rng.random((G, n)) < 0.3] = -1e30
    order = bd._sort_rows(torch.from_numpy(kh1), torch.from_numpy(kh2))
    for g in range(G):
        _, _, jorder = jax.lax.sort(
            (jnp.asarray(kh1[g]), jnp.asarray(kh2[g]),
             jnp.arange(n, dtype=jnp.int32)), num_keys=2)
        np.testing.assert_array_equal(order[g].numpy(), np.asarray(jorder))
        o = np.asarray(jorder)
        s1, s2 = kh1[g][o], kh2[g][o]
        start = np.concatenate([[True], (s1[1:] != s1[:-1])
                                | (s2[1:] != s2[:-1])])
        want = np.asarray(jbd._segment_logaddexp_sorted(
            jnp.asarray(vals[g][o]), jnp.asarray(start)))
        got = bd._segment_logaddexp_sorted(
            torch.from_numpy(vals[g][o][None]),
            torch.from_numpy(start[None]))[0].numpy()
        np.testing.assert_allclose(got[start], want[start], rtol=F32_TOL,
                                   atol=F32_TOL)
