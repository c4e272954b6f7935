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
    ("ties", (2, 9, 300), 5), ("ties", (1, 8, 7375), 10)])
def test_plain_matches_pallas_and_xla(kind, shape, k):
    x = _inputs(kind, shape, seed=shape[-1])
    got = k1.topk_logsoftmax_plain(torch.from_numpy(x), k=k)
    _check(got, jax_topk(jnp.asarray(x), k=k, interpret=True))
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


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(3, 10), ValueError),                 # rank
    (torch.zeros(1, 2, 3), ValueError),               # k > D
])
def test_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        k1.topk_logsoftmax(bad, k=4)
