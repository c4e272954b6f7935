"""The port's train step against the JAX package's ``make_train_step``.

Same weights (the JAX ``create_train_state``'s, through ``flax_to_torch``),
same numpy batch, ``hctr-tiny`` topology at 12 classes, dropout rates 0.
The JAX step runs its model with f64 activations (parameters, optimizer
and the CTC on f32 logits as always): in f32 on the CPU, XLA's gradients
of this model stray from an f64 evaluation by up to 4% of a tensor's
largest gradient (the bias and weight gradients below a stack of
train-mode BatchNorms), while the port's stay within 2e-5, so the f32 JAX
step cannot be the yardstick at these tolerances. The port's gradients
are held to it with f32 and with f64 activations; its train steps run
with f64 activations: with f32 ones the SGD steps pass, but Adam's third
step moves ``conv0_1``'s weight 1.9e-6 from the JAX step's at lr 1e-3
(against 1e-3 * lr), as dividing by ``sqrt(nu)`` magnifies the f32
gradient noise of an element whose gradient is small against its history.

Tolerances (as ``chip_smoke.py``'s ``train_parity``): loss 1e-5 relative;
gradients within 1e-4 of each tensor's largest |g|, their global norm
within 1e-4 relative (the bias of a conv
that feeds a train-mode BatchNorm has a zero gradient in exact arithmetic:
it is held within 1e-4 of the largest gradient of the model); parameters
within 1e-3 * lr, except, for Adam, elements whose update direction u
(the clipped gradient plus the weight decay, what Adam normalises) is at
some step below 1e-4 of their tensor's largest |u| (of the model's, for
those conv biases): Adam moves each element by about lr * sign(u), so
these may flip at the noise floor; they are counted and bounded by 2 lr a
step. BatchNorm statistics within 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.models.hctr import (
    HCTRModel as FlaxHCTR)
from handwritten_chinese_ocr_samples_tpu.ops.ctc import (
    ctc_loss_mean as jax_ctc, widths_to_paddings as jax_paddings)
from handwritten_chinese_ocr_samples_tpu.train import step as jstep
from handwritten_chinese_ocr_samples_torch.models.hctr import HCTRModel
from handwritten_chinese_ocr_samples_torch.ops.ctc import (
    ctc_loss_mean, widths_to_paddings)
from handwritten_chinese_ocr_samples_torch.ops.dropout import fold_in
from handwritten_chinese_ocr_samples_torch.train import step as tstep
from handwritten_chinese_ocr_samples_torch.utils.weights import flax_to_torch

C, B, W, L = 12, 4, 48, 5
LR = {"SGD": 0.01, "Adam": 1e-3}
LOSS_TOL, GRAD_TOL, PARAM_TOL, STAT_TOL = 1e-5, 1e-4, 1e-3, 1e-5
NO_DROP = dict(stage_drop=(0.0,) * 4, block_drop=0.0)


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    lp = np.zeros((B, L), np.float32)
    lp[1, 3:] = 1.0
    lp[3, 4:] = 1.0
    return {"images": rng.uniform(-1, 1, (B, 128, W, 1)).astype(np.float32),
            "labels": rng.integers(1, C - 1, (B, L)).astype(np.int32),
            "label_paddings": lp,
            "widths": np.array([W, 40, 33, 45], np.int32)}


def _flax_model():
    return FlaxHCTR(num_classes=C, backbone_channels=64,
                    num_blocks=(1, 1, 1, 1), dtype=jnp.float64, **NO_DROP)


@pytest.fixture(scope="module")
def init_vars():
    with jax.enable_x64(True):
        state = jstep.create_train_state(_flax_model(), jax.random.key(0),
                                         input_shape=(B, 128, W, 1))
    return jax.tree.map(np.asarray, {"params": state.params,
                                     "batch_stats": state.batch_stats})


def _port_model(variables, dtype=torch.float64) -> HCTRModel:
    model = HCTRModel(num_classes=C, backbone_channels=64,
                      num_blocks=(1, 1, 1, 1), compute_dtype=dtype,
                      **NO_DROP)
    model.load_state_dict(flax_to_torch(variables))
    return model


def _port_grads(model, batch, mask: bool) -> dict:
    model.train()
    x = torch.from_numpy(batch["images"])
    pad = (widths_to_paddings(torch.from_numpy(batch["widths"]), W)
           if mask else None)
    loss = ctc_loss_mean(model(x), torch.from_numpy(batch["labels"]),
                         torch.from_numpy(batch["label_paddings"]), pad)
    names, params = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


def _amax(t: torch.Tensor) -> float:
    return t.max().item() if t.numel() else 0.0


def _zero_in_exact_arithmetic(name: str) -> bool:
    """A conv bias feeding a train-mode BatchNorm (all but the head's)."""
    return name.endswith("bias") and "conv" in name


def _check_grads(got: dict, want: dict):
    top = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        scale = (top if _zero_in_exact_arithmetic(name)
                 else w.abs().max().item())
        err = (got[name] - w).abs().max().item()
        assert err <= GRAD_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mask", [False, True])
def test_gradients_match_jax(init_vars, mask, dtype):
    batch = _batch(0)
    model = _port_model(init_vars, dtype)
    got = _port_grads(model, batch, mask)
    fm = _flax_model()
    with jax.enable_x64(True):
        pad = (jax_paddings(jnp.asarray(batch["widths"]), W) if mask
               else None)

        def loss_fn(params):
            logits, _ = fm.apply(
                {"params": params, "batch_stats": init_vars["batch_stats"]},
                jnp.asarray(batch["images"]), train=True,
                mutable=["batch_stats"])
            return jax_ctc(logits, jnp.asarray(batch["labels"]),
                           jnp.asarray(batch["label_paddings"]), pad)

        grads = jax.jit(jax.grad(loss_fn))(init_vars["params"])
    want = flax_to_torch({"params": jax.tree.map(np.asarray, grads)})
    _check_grads(got, want)


def _sync_adam(state, jstate) -> None:
    """Load the JAX step's parameters, statistics and Adam state."""
    model = state.module
    model.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats})))
    adam = jstate.opt_state.inner_state[2][0]
    for key in ("mu", "nu"):
        moments = flax_to_torch({"params": jax.tree.map(np.asarray,
                                                        getattr(adam, key))})
        for n, t in state.opt_state[key].items():
            t.copy_(moments[n])
    state.opt_state["count"].fill_(int(adam.count))


@pytest.mark.parametrize("kind", ["SGD", "Adam"])
@pytest.mark.parametrize("mask", [False, True])
def test_train_steps_match_jax(init_vars, kind, mask):
    """Three steps on three batches: loss and gradient norm each step,
    parameters and BatchNorm statistics after the first and the third.
    SGD runs free. Adam's sign-like first step parts the two trajectories
    at the elements it flips, so each of its steps starts from the JAX
    step's state (moments and count included)."""
    lr = LR[kind]
    with jax.enable_x64(True):
        jstate = jstep.create_train_state(
            _flax_model(), jax.random.key(0), input_shape=(B, 128, W, 1),
            tx=jstep.make_optimizer(kind, lr=lr))
        jtrain = jstep.make_train_step(use_width_mask=mask, donate=False)
    model = _port_model(init_vars)
    state = tstep.TrainState.create(model, tstep.make_optimizer(kind, lr=lr))
    train = tstep.make_train_step(use_width_mask=mask)
    flips = {n: torch.zeros_like(p, dtype=torch.bool)
             for n, p in model.named_parameters()}
    for i in range(3):
        batch = _batch(i)
        if kind == "Adam" and i:
            _sync_adam(state, jstate)
            flips = {n: torch.zeros_like(f) for n, f in flips.items()}
        # what Adam sees: the clipped gradient plus the weight decay
        grads = _port_grads(model, batch, mask)
        f = min(1.0, 5.0 / tstep.global_norm(list(grads.values())).item())
        params = dict(model.named_parameters())
        u = {n: f * g + 1e-4 * params[n].detach() for n, g in grads.items()}
        top = max(v.abs().max() for v in u.values())
        for name, v in u.items():
            scale = top if _zero_in_exact_arithmetic(name) else v.abs().max()
            flips[name] |= v.abs() < max(1e-4 * scale, 100 * tstep.ADAM_EPS)
        with jax.enable_x64(True):
            jstate, jm = jtrain(jstate, {k: jnp.asarray(v)
                                         for k, v in batch.items()},
                                jax.random.key(1))
        state, m = train(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, 1)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=LOSS_TOL), i
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=GRAD_TOL)
        assert float(m["skipped"]) == float(jm["skipped"]) == 0.0
        if i not in (0, 2):
            continue
        want = flax_to_torch(jax.tree.map(np.asarray, {
            "params": jstate.params, "batch_stats": jstate.batch_stats}))
        got = model.state_dict()
        excluded = 0
        for name, p in model.named_parameters():
            diff = (got[name] - want[name]).abs()
            if kind == "Adam":
                excluded += int(flips[name].sum())
                assert _amax(diff[flips[name]]) <= 2 * lr * (1 + 1e-3)
                diff = diff[~flips[name]]
            assert _amax(diff) <= PARAM_TOL * lr, (name, i)
        for name in got:
            if name.endswith(("running_mean", "running_var")):
                torch.testing.assert_close(got[name], want[name], rtol=0,
                                           atol=STAT_TOL)
        if kind == "Adam":
            print(f"step {i + 1}: {excluded} elements under 1e-4 of their "
                  f"tensor's max |g| left out")
    assert state.step == int(jstate.step) == 3


def test_nonfinite_batch_is_skipped(init_vars):
    model = _port_model(init_vars)
    state = tstep.TrainState.create(model, tstep.make_optimizer("Adam",
                                                                lr=0.01))
    train = tstep.make_train_step()
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    state, m = train(state, batch, 0)          # a first, finite step
    assert float(m["skipped"]) == 0.0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = {k: {n: t.clone() for n, t in v.items()}
                  if isinstance(v, dict) else
                  v.clone() if isinstance(v, torch.Tensor) else v
                  for k, v in state.opt_state.items()}
    bad = dict(batch, images=batch["images"].clone())
    bad["images"][0, 0, 0, 0] = float("nan")
    state, m = train(state, bad, 0)
    assert float(m["skipped"]) == 1.0
    assert state.step == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in state.opt_state.items():
        if isinstance(v, dict):
            for n, t in v.items():
                assert torch.equal(t, opt_before[k][n]), (k, n)
        elif isinstance(v, torch.Tensor):
            assert torch.equal(v, opt_before[k]), k


def test_learning_rate_schedule(init_vars):
    model = _port_model(init_vars)
    state = tstep.TrainState.create(model, tstep.make_optimizer("SGD",
                                                                lr=0.01))
    jstate = jstep.create_train_state(
        FlaxHCTR(num_classes=C, backbone_channels=64,
                 num_blocks=(1, 1, 1, 1)), jax.random.key(0),
        input_shape=(1, 128, 16, 1), lr=0.01)
    for epoch, want in [(0, 0.01), (29, 0.01), (30, 0.001), (60, 0.0001)]:
        tstep.adjust_learning_rate(state, 0.01, epoch)
        jlr = float(jstep.adjust_learning_rate(jstate, 0.01, epoch)
                    .opt_state.hyperparams["learning_rate"])
        assert state.opt_state["learning_rate"] == pytest.approx(want,
                                                                 rel=1e-6)
        assert jlr == pytest.approx(state.opt_state["learning_rate"],
                                    rel=1e-6)


@pytest.mark.parametrize("kind", ["SGD", "Adam"])
@pytest.mark.parametrize("norm", [3.0, 12.0])
def test_optimizer_update_matches_optax(kind, norm):
    """Clip (engaged above 5), weight decay and the optimizer, two updates
    on synthetic trees, against the JAX package's optax chain."""
    rng = np.random.default_rng(int(norm))
    shapes = {"a": (7, 3), "b": (11,), "c": (2, 2, 5)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    tx = jstep.make_optimizer(kind, lr=0.05)
    jp, jopt = dict(params), tx.init(params)
    names = list(shapes)
    tp = [torch.from_numpy(params[n].copy()) for n in names]
    opt = tstep.make_optimizer(kind, lr=0.05)
    topt = opt.init(dict(zip(names, tp)))
    for step in range(2):
        g = {k: rng.normal(0, 1, s).astype(np.float32)
             for k, s in shapes.items()}
        total = math.sqrt(sum(float((v ** 2).sum()) for v in g.values()))
        g = {k: v * np.float32(norm / total) for k, v in g.items()}
        upd, jopt = tx.update(g, jopt, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.from_numpy(g[n]) for n in names]
        gn = tstep.global_norm(tg)
        assert gn.item() == pytest.approx(norm, rel=1e-5)
        old = [t.clone() for t in tp]
        tp, topt = opt.update(tg, topt, names, tp, gn)
        for n, t in zip(names, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[n]),
                                       rtol=1e-6, atol=1e-7)
        if kind == "SGD" and step == 0:
            # the first SGD update is lr * (min(1, 5 / |g|) g + wd p)
            f = min(1.0, 5.0 / norm)
            for o, t, gt in zip(old, tp, tg):
                torch.testing.assert_close(
                    t, o - 0.05 * (f * gt + 1e-4 * o), rtol=0, atol=1e-6)


def test_remat_gradients_equal_plain():
    """``remat`` recomputes each block in backward; with dropout on, the
    regenerated masks make its gradients those of the plain model."""
    torch.manual_seed(0)
    plain = HCTRModel(num_classes=C, backbone_channels=64,
                      num_blocks=(1, 1, 1, 1))
    remat = HCTRModel(num_classes=C, backbone_channels=64,
                      num_blocks=(1, 1, 1, 1), remat=True)
    remat.load_state_dict(plain.state_dict())
    batch = _batch(4)
    out = []
    for model in (plain, remat):
        model.train()
        loss = ctc_loss_mean(model(torch.from_numpy(batch["images"]),
                                   dropout_seed=fold_in(3, 0)),
                             torch.from_numpy(batch["labels"]),
                             torch.from_numpy(batch["label_paddings"]))
        loss.backward()
        out.append((loss.item(), {n: p.grad for n, p in
                                  model.named_parameters()},
                    [bn.batch_stats for bn in model.batch_norms()]))
    assert out[0][0] == out[1][0]
    for n, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][n], g, rtol=1e-6, atol=1e-7)
    for (m0, v0), (m1, v1) in zip(out[0][2], out[1][2]):
        assert torch.equal(m0, m1) and torch.equal(v0, v1)
    # dropout was on: the loss differs from a dropout-free forward
    plain.eval()
    with torch.no_grad():
        ev = ctc_loss_mean(plain(torch.from_numpy(batch["images"])),
                           torch.from_numpy(batch["labels"]),
                           torch.from_numpy(batch["label_paddings"]))
    assert ev.item() != out[0][0]
