"""Kernel K1 (fused log-softmax + top-K): the port's plain version against
the JAX Pallas kernel (interpret mode) and its XLA oracle.

Tolerance: ``vals`` and ``blank`` to 1e-5 absolute (log-sum-exp summed in
another order); ``idx`` and ``n_above`` exactly, ties included (lowest index
first on both sides). The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.ops.topk_logsoftmax import (
    topk_logsoftmax as jax_topk, topk_logsoftmax_xla)
from handwritten_chinese_ocr_samples_torch.ops import topk_logsoftmax as k1

from tests.test_torch_lm import one_torch_thread  # noqa: F401

TOL = 1e-5


def _inputs(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=shape).astype(np.float32)
    # ties: a coarse grid repeats the maximum within rows; row 0 is constant
    x = rng.integers(0, 4, size=shape).astype(np.float32)
    x[:, 0] = 1.5
    return x


def _check(got, want):
    for g, w, name in zip(got, want, ("vals", "idx", "blank", "n_above")):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name in ("idx", "n_above"):
            assert g.dtype == np.int32, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("kind,shape,k", [
    ("normal", (2, 17, 300), 5), ("normal", (1, 8, 128), 3),
    ("normal", (3, 9, 500), 10), ("normal", (2, 8, 7375), 10),
    ("ties", (2, 9, 300), 5), ("ties", (1, 8, 7375), 10),
    # K = D (the Pallas kernel pads K to 128 lanes, so D <= 128), and D = 1
    ("normal", (2, 5, 100), 100), ("normal", (1, 3, 128), 128),
    ("normal", (2, 4, 7), 7), ("normal", (2, 3, 1), 1),
    ("normal", (1, 9, 1), 1)])
def test_plain_matches_pallas_and_xla(kind, shape, k):
    x = _inputs(kind, shape, seed=shape[-1])
    got = k1.topk_logsoftmax_plain(torch.from_numpy(x), k=k)
    _check(got, jax_topk(jnp.asarray(x), k=k, interpret=True))
    _check(got, topk_logsoftmax_xla(jnp.asarray(x), k=k))


@pytest.mark.parametrize("shape,k", [((2, 9, 300), 5), ((1, 8, 7375), 10)])
def test_plain_bf16_matches_pallas_and_xla(shape, k):
    """bf16 logits from the same numpy values: both sides cast to f32."""
    x = _inputs("normal", shape, seed=7)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x, dtype=jnp.bfloat16)
    got = k1.topk_logsoftmax_plain(xt, k=k)
    _check(got, jax_topk(xj, k=k, interpret=True))
    _check(got, topk_logsoftmax_xla(xj, k=k))
    _check(got, k1.topk_logsoftmax_plain(xt.float(), k=k))


@pytest.mark.parametrize("d,k", [(300, 10), (20, 20), (7375, 12)])
def test_plain_neg_inf_rows_match_xla(d, k):
    """Rows with 5 finite classes and K above that: the -inf classes follow
    in index order, no index twice, as in the XLA oracle. (The Pallas kernel
    masks winners with -1e30 and can repeat an index here.)"""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 6, d)).astype(np.float32)
    keep = rng.random((2, 6, d)).argsort(-1) < 5
    x[~keep] = -np.inf
    got = k1.topk_logsoftmax_plain(torch.from_numpy(x), k=k)
    idx = got[1].numpy()
    assert all(len(set(row)) == k for row in idx.reshape(-1, k))
    _check(got, topk_logsoftmax_xla(jnp.asarray(x), k=k))


@pytest.mark.parametrize("prune", [k1.PRUNE, -3.0])
def test_wrapper_on_cpu_is_the_plain_version(prune):
    x = torch.from_numpy(_inputs("normal", (2, 5, 200), seed=1))
    before = k1.launches
    got = k1.topk_logsoftmax(x, k=4, prune=prune)
    want = k1.topk_logsoftmax_plain(x, k=4, prune=prune)
    assert k1.launches == before          # CPU tensors launch no kernel
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _check(got, topk_logsoftmax_xla(jnp.asarray(x.numpy()), k=4,
                                    prune=prune))


def test_wrapper_on_cpu_bf16_is_the_plain_version():
    x = torch.from_numpy(_inputs("normal", (2, 5, 200), seed=2))
    x = x.to(torch.bfloat16)
    before = (k1.launches, dict(k1.launches_by_path))
    got = k1.topk_logsoftmax(x, k=4)
    assert (k1.launches, k1.launches_by_path) == before
    for g, w in zip(got, k1.topk_logsoftmax_plain(x, k=4)):
        assert torch.equal(g, w)
    assert got[0].dtype == got[2].dtype == torch.float32


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(3, 10), ValueError),                 # rank
    (torch.zeros(1, 2, 3), ValueError),               # k > D
])
def test_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        k1.topk_logsoftmax(bad, k=4)
