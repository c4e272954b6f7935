"""The port's classification path (``pred == "Classification"``) against
the JAX package's: ``make_classify_train_step``, ``make_classify_eval_step``
and the trainer's classification branch.

The steps run the ``innovation`` classifier narrowed for the CPU (64
channels, blocks [1, 1, 1, 1]; the JAX trunk is narrowed by a test-local
subclass patched over ``models/innovation.InnovationBackbone``) with the
multiscale fusion and the spatial attention on (``gamma`` 0.37), 12
classes, 32x32 squares, b4, from the same weights (the JAX
``create_train_state``'s, through ``flax_to_torch``). Dropout is off on
both sides: rates 0 on the port, flax's ``Dropout`` and the JAX package's
block dropout patched to the identity here. As in
``test_torch_train_step.py``, both compute with f64 activations and the
tolerances are that file's: loss 1e-5 relative, gradient norm 1e-4
relative, parameters 1e-3 * lr (Adam's flip-prone elements counted and
held to 2 lr), BatchNorm statistics 1e-5; the batch accuracy is equal.

The trainer runs the port's mirror of ``test_classify_train.py``'s
``TinyClassifier`` on that file's glyph set, to its accuracy bar.
"""

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests.test_classify_train import CHARS, make_char_dataset
from tests.test_torch_innovation import _NoDropout
from tests.test_torch_train_step import (_amax, _sync_adam,
                                         _zero_in_exact_arithmetic)

from flax import linen as fnn
from handwritten_chinese_ocr_samples_tpu.models import hctr as jhctr
from handwritten_chinese_ocr_samples_tpu.models import innovation as jinn
from handwritten_chinese_ocr_samples_tpu.train import step as jstep
from handwritten_chinese_ocr_samples_torch.models.hctr import (
    BatchNorm, Conv, Dropout)
from handwritten_chinese_ocr_samples_torch.models.innovation import (
    InnovationModel)
from handwritten_chinese_ocr_samples_torch.train import step as tstep
from handwritten_chinese_ocr_samples_torch.train.trainer import (
    Trainer, TrainerConfig)
from handwritten_chinese_ocr_samples_torch.utils.weights import flax_to_torch

from tests.test_torch_lm import one_torch_thread  # noqa: F401

C, B, H = 12, 4, 32
LR = {"SGD": 0.01, "Adam": 1e-3}
LOSS_TOL, GRAD_TOL, PARAM_TOL, STAT_TOL = 1e-5, 1e-4, 1e-3, 1e-5
GAMMA = 0.37


class _NarrowBackbone(jinn.InnovationBackbone):
    out_channels: int = 64
    num_blocks: Sequence[int] = (1, 1, 1, 1)


@pytest.fixture
def jax_patched(monkeypatch):
    monkeypatch.setattr(jinn, "InnovationBackbone", _NarrowBackbone)
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    monkeypatch.setattr(jhctr, "_Dropout", _NoDropout)


def _flax_model():
    return jinn.InnovationModel(num_classes=C, use_multiscale=True,
                                use_spatial_attn=True, dtype=jnp.float64)


def _jax_state(kind: str):
    with jax.enable_x64(True):
        state = jstep.create_train_state(
            _flax_model(), jax.random.key(0), input_shape=(B, H, H, 1),
            tx=jstep.make_optimizer(kind, lr=LR[kind]))
        params = jax.tree.map(np.asarray, state.params)
        params["spatial_attn"]["gamma"] = np.array([GAMMA], np.float32)
        return state.replace(params=jax.tree.map(jnp.asarray, params),
                             opt_state=state.tx.init(params))


def _port_model(jstate) -> InnovationModel:
    model = InnovationModel(C, True, True, torch.float64,
                            backbone_channels=64, num_blocks=(1, 1, 1, 1),
                            stage_drop=(0.0,) * 4, block_drop=0.0,
                            head_drop=0.0)
    model.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats})))
    return model


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"images": rng.uniform(-1, 1, (B, H, H, 1)).astype(np.float32),
            "labels": rng.integers(0, C, B).astype(np.int32)}


def _port_grads(model, batch) -> dict:
    model.train()
    logits = model(torch.from_numpy(batch["images"]))
    loss = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(batch["labels"]).long())
    names, params = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


@pytest.mark.parametrize("kind", ["SGD", "Adam"])
def test_classify_steps_match_jax(jax_patched, kind):
    """Two steps on two batches: loss, gradient norm and accuracy each step,
    parameters and BatchNorm statistics after each. Adam's second step
    starts from the JAX step's state (``test_torch_train_step.py``)."""
    lr = LR[kind]
    jstate = _jax_state(kind)
    with jax.enable_x64(True):
        jtrain = jstep.make_classify_train_step(donate=False)
    model = _port_model(jstate)
    state = tstep.TrainState.create(model, tstep.make_optimizer(kind, lr=lr))
    train = tstep.make_classify_train_step()
    for i in range(2):
        batch = _batch(i)
        if kind == "Adam" and i:
            _sync_adam(state, jstate)
        grads = _port_grads(model, batch)
        f = min(1.0, 5.0 / tstep.global_norm(list(grads.values())).item())
        params = dict(model.named_parameters())
        u = {n: f * g + 1e-4 * params[n].detach() for n, g in grads.items()}
        top = max(v.abs().max() for v in u.values())
        flips = {n: v.abs() < max(1e-4 * (top if _zero_in_exact_arithmetic(n)
                                           else v.abs().max()),
                                   100 * tstep.ADAM_EPS)
                 for n, v in u.items()}
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
        assert float(m["acc"]) == float(jm["acc"])
        assert float(m["skipped"]) == float(jm["skipped"]) == 0.0
        want = flax_to_torch(jax.tree.map(np.asarray, {
            "params": jstate.params, "batch_stats": jstate.batch_stats}))
        got = model.state_dict()
        for name, p in model.named_parameters():
            diff = (got[name] - want[name]).abs()
            if kind == "Adam":
                assert _amax(diff[flips[name]]) <= 2 * lr * (1 + 1e-3)
                diff = diff[~flips[name]]
            assert _amax(diff) <= PARAM_TOL * lr, (name, i)
        for name in got:
            if name.endswith(("running_mean", "running_var")):
                torch.testing.assert_close(got[name], want[name], rtol=0,
                                           atol=STAT_TOL)
    assert state.step == int(jstate.step) == 2


def test_classify_eval_step_matches_jax(jax_patched):
    jstate = _jax_state("Adam")
    batch = _batch(5)
    with jax.enable_x64(True):
        want = jstep.make_classify_eval_step(_flax_model())(
            jstate.params, jstate.batch_stats, jnp.asarray(batch["images"]))
    got = tstep.make_classify_eval_step(_port_model(jstate))(
        torch.from_numpy(batch["images"]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the first of equal maxima, as jnp.argmax
    x = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]])
    assert x.argmax(dim=-1).tolist() == np.asarray(
        jnp.argmax(jnp.asarray(x.numpy()), axis=-1)).tolist() == [1, 0]


def test_nonfinite_batch_is_skipped(jax_patched):
    jstate = _jax_state("Adam")
    model = _port_model(jstate)
    state = tstep.TrainState.create(model, tstep.make_optimizer("Adam",
                                                                lr=0.01))
    train = tstep.make_classify_train_step()
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    state, m = train(state, batch, 0)
    assert float(m["skipped"]) == 0.0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = {k: {n: t.clone() for n, t in state.opt_state[k].items()}
               for k in ("mu", "nu")}
    count = state.opt_state["count"].clone()
    bad = dict(batch, images=batch["images"].clone())
    bad["images"][1, 3, 3, 0] = float("nan")
    state, m = train(state, bad, 0)
    assert float(m["skipped"]) == 1.0 and state.step == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, held in moments.items():
        for n, t in held.items():
            assert torch.equal(state.opt_state[k][n], t), (k, n)
    assert torch.equal(state.opt_state["count"], count)


class TinyClassifier(nn.Module):
    """The port's mirror of ``test_classify_train.TinyClassifier``:
    conv(8)-BN-ReLU-pool-conv(16)-ReLU-mean-Dropout(0.1)-fc."""

    img_height = 32
    pad_mode = "NormalizePAD"
    optimizer = "Adam"
    pred = "Classification"

    def __init__(self, num_classes: int):
        super().__init__()
        self.conv = Conv(1, 8, 3, padding=1)
        self.bn = BatchNorm(8)
        self.conv2 = Conv(8, 16, 3, padding=1)
        self.drop = Dropout(0.1, 0)
        self.fc = nn.Linear(16, num_classes)

    def forward(self, x, dropout_seed=None):
        x = x.permute(0, 3, 1, 2)
        x = torch.nn.functional.max_pool2d(torch.relu(self.bn(self.conv(x))),
                                           2)
        x = torch.relu(self.conv2(x)).mean(dim=(2, 3))
        return self.fc(self.drop(x, dropout_seed))

    def batch_norms(self):
        return [self.bn]


def test_trainer_classification_e2e(tmp_path):
    """The trainer dispatches on ``pred``: one square bucket, the
    cross-entropy step, top-1 test accuracy; it learns the glyph set of the
    JAX test to that test's bar, and writes the JAX checkpoint names."""
    root = make_char_dataset(str(tmp_path / "chars"), n_train=64)
    cfg = TrainerConfig(data=root, model_type="innovation", batch_size=8,
                        lr=0.02, epochs=45, print_freq=1000, val_freq=0,
                        workers=0, seed=0, out_dir=str(tmp_path / "ckpt"),
                        device="cpu")
    trainer = Trainer(cfg, TinyClassifier(len(CHARS) + 2), CHARS)
    assert trainer.pred_mode == "Classification"
    loader = trainer._loader("train", shuffle=True)
    batch = trainer.device_batch(next(iter(loader)))
    assert batch["images"].shape == (8, 32, 32, 1)
    assert batch["labels"].dtype == torch.int32
    assert set(batch["labels"].tolist()) <= set(range(1, len(CHARS) + 1))
    trainer.fit()
    acc = trainer.evaluate("test")
    assert acc >= 0.9, acc
    assert "innovation_checkpoint" in {p.name for p in
                                       (tmp_path / "ckpt").iterdir()}


def test_trainer_rejects_unknown_pred_mode(tmp_path):
    root = make_char_dataset(str(tmp_path / "chars2"), n_train=4, n_test=2)

    class WeirdModel(TinyClassifier):
        pred = "Segmentation"

    with pytest.raises(ValueError, match="not expected pred mode"):
        Trainer(TrainerConfig(data=root, batch_size=2, device="cpu"),
                WeirdModel(4), CHARS)
