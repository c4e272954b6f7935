"""The port's training ops against the JAX package: CTC, dropout, train-mode
BatchNorm and the from-scratch initialisation.

Tolerances: the CTC loss and its gradient with respect to the logits 1e-5
relative (f32 in both); BatchNorm outputs and new running statistics 1e-5;
each initialised tensor's standard deviation within 5% of flax's
initialiser at the same shape. Dropout cannot match JAX's masks (no torch
generator reproduces ``jax.random.bits``), so it is held to its own
properties: scale, mask reuse in backward, determinism, keep fraction,
rate 1, and no mask saved for backward.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from handwritten_chinese_ocr_samples_tpu.ops.ctc import (
    ctc_loss_mean as jax_ctc)
from handwritten_chinese_ocr_samples_torch.models.hctr import (
    BatchNorm, Dropout, HCTRModel, hctr_model)
from handwritten_chinese_ocr_samples_torch.ops.ctc import (
    ctc_loss_mean, widths_to_paddings)
from handwritten_chinese_ocr_samples_torch.ops.dropout import (
    dropout_recompute, fold_in, keep_mask)
from handwritten_chinese_ocr_samples_torch.utils.weights import (
    init_state_dict)

from tests.test_torch_lm import one_torch_thread  # noqa: F401

CTC_TOL = 1e-5
BN_TOL = 1e-5


def _ctc_case(case: str):
    """(logits, labels, label_paddings, widths or None) for a case."""
    rng = np.random.default_rng(7)
    B, T, C, L = 4, 24, 9, 6
    logits = rng.normal(0, 2, (B, T, C)).astype(np.float32)
    labels = rng.integers(1, C, (B, L)).astype(np.int32)
    labels[1, 1] = labels[1, 0]                    # a repeat needs a blank
    lp = np.zeros((B, L), np.float32)
    lp[0, 4:] = 1.0
    lp[2, 1:] = 1.0
    widths = None
    if case == "width_mask":
        widths = np.array([24, 17, 9, 13], np.int32)
    elif case == "infeasible":
        widths = np.array([24, 17, 3, 13], np.int32)   # row 3: 6 labels, 13
        labels[3] = [1, 1, 1, 1, 1, 1]                 # frames: needs 11
        widths[3] = 8
    elif case == "nan_logits":
        logits[2, 5, 3] = np.nan
    return logits, labels, lp, widths


def _jax_loss_grad(logits, labels, lp, widths):
    paddings = (None if widths is None else jnp.asarray(
        (np.arange(logits.shape[1])[None] >= widths[:, None]),
        jnp.float32))
    return jax.value_and_grad(lambda x: jax_ctc(
        x, jnp.asarray(labels), jnp.asarray(lp), paddings))(
            jnp.asarray(logits))


@pytest.mark.parametrize("case", ["full_width", "width_mask", "infeasible",
                                  "nan_logits"])
def test_ctc_loss_mean_matches_jax(case):
    logits, labels, lp, widths = _ctc_case(case)
    x = torch.from_numpy(logits).requires_grad_()
    paddings = (None if widths is None else
                widths_to_paddings(torch.from_numpy(widths), x.shape[1]))
    loss = ctc_loss_mean(x, torch.from_numpy(labels), torch.from_numpy(lp),
                         paddings)
    loss.backward()
    got_grad = x.grad.numpy()
    want, want_grad = _jax_loss_grad(logits, labels, lp, widths)
    want, want_grad = float(want), np.asarray(want_grad)
    rows = [0, 1, 2, 3]
    if case == "infeasible":
        # optax approximates log(0) by -1e5, so JAX keeps the infeasible
        # row at about 1e5 / label length; the port zeroes it, as torch's
        # zero_infinity does: hold the port to JAX's loss without that row
        per_seq = optax.ctc_loss(
            jnp.asarray(logits[3:]),
            jnp.asarray(np.arange(24)[None] >= widths[3:, None], jnp.float32),
            jnp.asarray(labels[3:]), jnp.asarray(lp[3:]))
        row3 = float(per_seq[0]) / 6
        assert row3 > 1e4
        want -= row3 / 4
        rows = [0, 1, 2]
        assert np.all(got_grad[3] == 0.0)
    if case == "nan_logits":
        rows = [0, 1, 3]                 # the NaN row's gradient is NaN
    assert np.isfinite(loss.item())
    assert loss.item() == pytest.approx(want, rel=CTC_TOL)
    g, w = got_grad[rows], want_grad[rows]
    np.testing.assert_allclose(g, w, rtol=0, atol=CTC_TOL * np.abs(w).max())


def test_widths_to_paddings():
    got = widths_to_paddings(torch.tensor([0, 2, 5]), 4).numpy()
    np.testing.assert_array_equal(
        got, [[1, 1, 1, 1], [0, 0, 1, 1], [0, 0, 0, 0]])


# ----------------------------------------------------------------- dropout
def test_dropout_mask_and_scale():
    x = torch.randn(64, 257)
    y = dropout_recompute(x, 11, 0.3)
    mask = keep_mask(11, x.shape, 0.3, x.device)
    scale = torch.tensor(1 / 0.7, dtype=x.dtype).item()
    torch.testing.assert_close(y, torch.where(mask, x * scale, 0.0),
                               rtol=0, atol=0)
    thr = math.ceil(0.3 * 65536)
    g = torch.Generator().manual_seed(11)
    bits = torch.randint(0, 65536, x.shape, generator=g, dtype=torch.int32)
    assert torch.equal(mask, bits >= thr)
    # bf16: the scale is rounded to bf16 first, as the JAX op does
    xb = x.bfloat16()
    yb = dropout_recompute(xb, 11, 0.1)
    sb = torch.tensor(1 / 0.9, dtype=torch.bfloat16)
    assert torch.equal(yb, torch.where(keep_mask(11, x.shape, 0.1, x.device),
                                       xb * sb, 0.0))


def test_dropout_backward_uses_the_forward_mask():
    x = torch.randn(32, 100, requires_grad=True)
    y = dropout_recompute(x, 5, 0.5)
    g = torch.randn(32, 100)
    y.backward(g)
    kept = y.detach() != 0
    assert torch.equal(x.grad != 0, kept)
    torch.testing.assert_close(x.grad, torch.where(kept, g * 2.0, 0.0),
                               rtol=0, atol=0)


def test_dropout_same_seed_same_mask():
    x = torch.randn(8, 1000)
    assert torch.equal(dropout_recompute(x, 3, 0.1),
                       dropout_recompute(x, 3, 0.1))
    assert not torch.equal(dropout_recompute(x, 3, 0.1),
                           dropout_recompute(x, 4, 0.1))
    assert fold_in(3, 0, 1) == fold_in(3, 0, 1) != fold_in(3, 1, 0)


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.9])
def test_dropout_keep_fraction(rate):
    n = 1 << 20
    kept = keep_mask(fold_in(0, int(rate * 10)), (n,), rate,
                     torch.device("cpu")).float().mean().item()
    p = 1 - math.ceil(rate * 65536) / 65536
    assert abs(kept - p) <= 4 * math.sqrt(p * (1 - p) / n)


def test_dropout_rates_zero_one_and_eval():
    x = torch.randn(4, 8, 2, 5)
    d0, d1, d5 = Dropout(0.0, 0), Dropout(1.0, 1), Dropout(0.5, 2)
    assert d0(x, None) is x
    assert torch.equal(d1(x, 7), torch.zeros_like(x))
    d5.eval()
    assert d5(x, None) is x
    d5.train()
    with pytest.raises(ValueError, match="dropout_seed"):
        d5(x, None)
    with pytest.raises(ValueError):
        dropout_recompute(x, 0, 1.0)


def test_dropout_saves_no_mask():
    x = torch.randn(16, 64, 32, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = dropout_recompute(x * 1.0, 9, 0.3)
    assert sum(saved) == 0
    y.sum().backward()
    assert x.grad is not None
    # the model's sites save nothing either
    model = HCTRModel(num_classes=5, backbone_channels=64,
                      num_blocks=(1, 1, 1, 1))
    model.train()
    sizes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: sizes.append(t.dtype) or t, lambda t: t):
        model(torch.randn(2, 128, 8, 1), dropout_seed=1)
    assert torch.bool not in sizes


# --------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("offset", [0.0, 3.0])
def test_batchnorm_train_matches_flax(offset):
    rng = np.random.default_rng(1)
    x = (rng.normal(0, 2, (4, 6, 10, 12)) + offset).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    bias = rng.normal(0, 1, 12).astype(np.float32)
    mean0 = rng.normal(0, 1, 12).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 12).astype(np.float32)
    fbn = nn.BatchNorm(momentum=0.9, epsilon=1e-5)
    y, upd = fbn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
    bn = BatchNorm(12)
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0)})
    bn.train()
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=BN_TOL, atol=BN_TOL)
    new_mean, new_var = bn.new_running_stats()
    np.testing.assert_allclose(new_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=BN_TOL, atol=BN_TOL)
    np.testing.assert_allclose(new_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=BN_TOL, atol=BN_TOL)
    # the module's own statistics move only through the train step
    assert torch.equal(bn.running_mean, torch.from_numpy(mean0))
    # eval mode: the running statistics, unchanged
    bn.eval()
    y_eval = fbn.apply({"params": {"scale": scale, "bias": bias},
                        "batch_stats": {"mean": mean0, "var": var0}},
                       jnp.asarray(x), use_running_average=True)
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y_eval),
                               rtol=BN_TOL, atol=BN_TOL)


def test_batchnorm_train_gradient_is_exact():
    """The closed-form backward equals autograd of the same function in
    f64 (f32 inputs, tolerance 1e-5 of the largest gradient)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.normal(0, 1, (3, 5, 7, 9)) + 2).astype(
        np.float32)).requires_grad_()
    bn = BatchNorm(5)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
    g = torch.randn(3, 5, 7, 9)
    bn.train()
    bn(x).backward(g)
    x64 = x.detach().double().requires_grad_()
    w64 = bn.weight.detach().double().requires_grad_()
    b64 = bn.bias.detach().double().requires_grad_()
    mean = x64.mean((0, 2, 3))
    var = (x64.square().mean((0, 2, 3)) - mean.square()).clamp_min(0)
    y = ((x64 - mean[:, None, None]) * (torch.rsqrt(var + 1e-5) * w64)[
        :, None, None] + b64[:, None, None])
    y.backward(g.double())
    for got, want in ((x.grad, x64.grad), (bn.weight.grad, w64.grad),
                      (bn.bias.grad, b64.grad)):
        np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                   rtol=0, atol=1e-5 * want.abs().max())


# ----------------------------------------------------------- initialisation
def test_init_state_dict_matches_flax_initialisers():
    """Each tensor of the full-width ``hctr`` against flax's lecun-normal
    of the same shape: std within 5%, no value past the cut at 2 std.
    Tensors under 16384 elements (their sample std moves by more than 1%)
    are pooled after dividing by sqrt(1 / fan_in)."""
    model = hctr_model()
    sd = init_state_dict(model, torch.Generator().manual_seed(0))
    init = jax.nn.initializers.lecun_normal()
    key = jax.random.key(0)
    pooled, pooled_flax = [], []
    for i, (name, t) in enumerate(sd.items()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and t.dim() >= 2:
            fan_in = t[0].numel()
            # lecun-normal's std depends on the fan-in alone: a sample of
            # at most 2^18 values at this fan-in
            cols = min(t.shape[0], max(1, (1 << 18) // fan_in))
            want = np.asarray(init(jax.random.fold_in(key, i),
                                   (fan_in, cols), jnp.float32))
            bound = 2 * math.sqrt(1 / fan_in) / 0.87962566103423978
            assert t.abs().max().item() <= bound * (1 + 1e-6), name
            if t.numel() >= 16384:
                assert t.std().item() == pytest.approx(want.std(),
                                                       rel=0.05), name
            else:
                pooled.append(t.flatten().numpy() * math.sqrt(fan_in))
                pooled_flax.append(want.flatten() * math.sqrt(fan_in))
        elif leaf in ("weight", "running_var"):
            assert torch.equal(t, torch.ones_like(t)), name
        else:
            assert torch.equal(t, torch.zeros_like(t)), name
    assert np.concatenate(pooled).std() == pytest.approx(
        np.concatenate(pooled_flax).std(), rel=0.05)
    assert sum(t.numel() for n, t in sd.items()
               if not n.endswith(("running_mean", "running_var"))) == 53114383
