"""The port's trainer, checkpoints and ``cli/train.py`` against the JAX
package's.

``Trainer.fit`` runs both trainers on a tiny synthetic set
(``tests/util_synth.py``) for two epochs at ``lr_decay_epochs=1``, dropout
0, from the JAX trainer's initial weights. As in
``test_torch_train_step.py``, both models compute with f64 activations
(parameters, optimizer and the CTC on f32 logits as always), so that no
ReLU input lies within f32 rounding of zero in one and not the other.
Tolerances: per-step losses 3e-4 relative, final parameters 2.5e-3 * lr,
BatchNorm statistics 2.5e-4 of each tensor's largest value; the test
accuracy is equal. The first two are
wider than ``test_torch_train_step.py``'s because of the CTC: at these
untrained logits a sequence costs about 350 nats over 128 frames, and the
f32 CTC of either package computes its occupancies as exponentials of
differences of numbers that large, so the two gradients with respect to
the logits part by up to 7e-5 of their largest value on the first batch;
over four steps the losses part by up to 1.5e-4 relative, the
parameters by up to 1.2e-3 * lr and the running statistics, which follow
the parameters, by up to 1.24e-4 of a tensor's largest value (measured
here: twice each is the bound).
"""

import contextlib
import io
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_synth import make_dataset

from handwritten_chinese_ocr_samples_tpu.models.hctr import (
    HCTRModel as FlaxHCTR)
from handwritten_chinese_ocr_samples_tpu.train.trainer import (
    Trainer as JaxTrainer, TrainerConfig as JaxConfig)
from handwritten_chinese_ocr_samples_torch.cli import test as eval_cli
from handwritten_chinese_ocr_samples_torch.cli import train as train_cli
from handwritten_chinese_ocr_samples_torch.core.codec import load_chars_list
from handwritten_chinese_ocr_samples_torch.models.hctr import HCTRModel
from handwritten_chinese_ocr_samples_torch.train.checkpoint import (
    load_checkpoint, save_checkpoint)
from handwritten_chinese_ocr_samples_torch.train.step import (
    TrainState, make_optimizer)
from handwritten_chinese_ocr_samples_torch.train.trainer import (
    Trainer, TrainerConfig)
from handwritten_chinese_ocr_samples_torch.utils.weights import flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "handwritten_chinese_ocr_samples_torch",
                      "assets", "demo_hard")
DEMO_HARD = os.path.join(REPO, "demo", "hard", "data")
LR = 0.01
NO_DROP = dict(stage_drop=(0.0,) * 4, block_drop=0.0)
FIT = dict(batch_size=4, epochs=2, lr=LR, lr_decay_epochs=1, print_freq=1,
           val_freq=0, workers=2, seed=0, bucket_step=64, max_width=256,
           max_label_len=8)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    _, chars = make_dataset(root, n_train=8, n_val=4, n_test=4, seed=0)
    return root, chars


def _recorded(step, losses):
    def run(state, batch, seed):
        state, metrics = step(state, batch, seed)
        losses.append(float(metrics["loss"]))
        return state, metrics
    return run


@pytest.fixture(scope="module")
def jax_fit(synth, tmp_path_factory):
    root, chars = synth
    out = str(tmp_path_factory.mktemp("jax_out"))
    losses = []
    with jax.enable_x64(True), contextlib.redirect_stdout(io.StringIO()):
        trainer = JaxTrainer(
            JaxConfig(data=root, model_type="hctr-tiny", out_dir=out, **FIT),
            FlaxHCTR(num_classes=len(chars) + 2, backbone_channels=64,
                     num_blocks=(1, 1, 1, 1), dtype=jnp.float64, **NO_DROP),
            chars)
        init = jax.tree.map(np.asarray, {
            "params": trainer.state.params,
            "batch_stats": trainer.state.batch_stats})
        trainer.train_step = _recorded(trainer.train_step, losses)
        trainer.fit()
        acc = trainer.evaluate("test")
    final = flax_to_torch(jax.tree.map(np.asarray, {
        "params": trainer.state.params,
        "batch_stats": trainer.state.batch_stats}))
    return init, losses, final, acc, sorted(os.listdir(out))


def _tiny(chars, **kw):
    return HCTRModel(num_classes=len(chars) + 2, backbone_channels=64,
                     num_blocks=(1, 1, 1, 1), **kw)


def test_fit_matches_jax_trainer(synth, jax_fit, tmp_path):
    root, chars = synth
    init, jlosses, jfinal, jacc, jfiles = jax_fit
    losses = []
    trainer = Trainer(TrainerConfig(data=root, model_type="hctr-tiny",
                                    out_dir=str(tmp_path), device="cpu",
                                    **FIT),
                      _tiny(chars, compute_dtype=torch.float64, **NO_DROP),
                      chars)
    trainer.model.load_state_dict(flax_to_torch(init))
    trainer.train_step = _recorded(trainer.train_step, losses)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        trainer.fit()
    assert len(losses) == len(jlosses) == 4
    np.testing.assert_allclose(losses, jlosses, rtol=3e-4)
    got = trainer.model.state_dict()
    for name, want in jfinal.items():
        stat = name.endswith(("running_mean", "running_var"))
        tol = 2.5e-4 * want.abs().max().item() if stat else 2.5e-3 * LR
        torch.testing.assert_close(got[name], want, rtol=0, atol=tol)
    assert trainer.evaluate("test") == pytest.approx(jacc, abs=1e-12)
    # the JAX trainer's checkpoint names (orbax directories there)
    assert sorted(os.listdir(tmp_path)) == jfiles
    assert f"epoch 1: test acc {jacc:.4f}" in buf.getvalue()


def _wide_lines(root):
    # 47-52 characters of 24 px: 1128-1248 px wide at height 128
    return make_dataset(root, n_train=16, n_val=1, n_test=1, seed=3,
                        min_len=47, max_len=52)


def test_bucket_cap_crop_reproduced(tmp_path):
    """At ``--max-width 1200 --bucket-step 128`` the largest bucket is 1152:
    lines clipped to 1200 are cut to 1152, their labels left whole, as the
    JAX trainer's loader does."""
    _, chars = _wide_lines(str(tmp_path))
    cfg = dict(data=str(tmp_path), batch_size=4, max_width=1200,
               bucket_step=128, seed=0, workers=2)
    model = types.SimpleNamespace(img_height=128, pad_mode="NormalizePAD")
    jstub = types.SimpleNamespace(cfg=JaxConfig(**cfg), model=model,
                                  pred_mode="CTC")
    pstub = types.SimpleNamespace(cfg=TrainerConfig(**cfg), model=model)
    jl = JaxTrainer._loader(jstub, "train", shuffle=True)
    pl = Trainer._loader(pstub, "train", shuffle=True)
    jl.set_epoch(1)
    pl.set_epoch(1)
    cropped = whole = 0
    for jb, pb in zip(jl, pl, strict=True):
        assert np.array_equal(jb["images"], pb["images"])
        assert np.array_equal(jb["widths"], pb["widths"])
        assert jb["labels"] == pb["labels"]
        assert pb["images"].shape[2] <= 1152
        for w, label in zip(pb["widths"], pb["labels"]):
            cropped += int(w == 1152)
            whole += int(w == 1152 and len(label) * 24 > 1152)
    assert cropped and whole


def test_checkpoint_round_trip_and_resume(synth, tmp_path):
    root, chars = synth
    cfg = dict(data=root, model_type="hctr-tiny", out_dir=str(tmp_path),
               device="cpu", optimizer="adam", **dict(FIT, epochs=1))
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = Trainer(TrainerConfig(**cfg), _tiny(chars), chars)
        trainer.fit()
    path = os.path.join(str(tmp_path), "hctr-tiny_checkpoint")
    payload, epoch, best = load_checkpoint(path)
    assert epoch == 1 and payload["step"] == 2
    assert set(payload) == {"epoch", "best_acc", "params", "batch_stats",
                            "opt_state", "step"}
    with contextlib.redirect_stdout(io.StringIO()):
        resumed = Trainer(TrainerConfig(**dict(cfg, resume=path, epochs=2)),
                          _tiny(chars), chars)
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    assert resumed.best_acc == pytest.approx(best)
    for (n, a), b in zip(trainer.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
    for key in ("mu", "nu"):
        for n, t in trainer.state.opt_state[key].items():
            assert torch.equal(t, resumed.state.opt_state[key][n])
    assert int(resumed.state.opt_state["count"]) == 2
    # a checkpoint of another optimizer's state is a warm start
    with contextlib.redirect_stdout(io.StringIO()):
        warm = Trainer(TrainerConfig(**dict(cfg, resume=path,
                                            optimizer="sgd")),
                       _tiny(chars), chars)
    assert warm.start_epoch == 0 and warm.state.step == 0


def test_warm_start_from_a_state_dict():
    sd = torch.load(os.path.join(ASSETS, "hctr_tiny.pt"), weights_only=True)
    chars = load_chars_list(os.path.join(DEMO_HARD, "chars_list.txt"))
    model = _tiny(chars)
    state = TrainState.create(model, make_optimizer("SGD", lr=0.1))
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        state, epoch, best = load_checkpoint(
            os.path.join(ASSETS, "hctr_tiny.pt"), state)
    assert "warm start" in buf.getvalue()
    assert (epoch, best, state.step) == (0, 0.0, 0)
    for n, t in model.state_dict().items():
        assert t.dtype == torch.float32 and torch.equal(t, sd[n].float()), n
    assert all(not t.any() for t in state.opt_state["trace"].values())
    # weights that do not fit the model raise
    with pytest.raises(RuntimeError):
        load_checkpoint(os.path.join(ASSETS, "hctr_tiny.pt"), TrainState.create(
            _tiny(chars[:-1]), make_optimizer("SGD", lr=0.1)))


def test_save_checkpoint_best_names(synth, tmp_path):
    root, chars = synth
    model = _tiny(chars)
    state = TrainState.create(model, make_optimizer("SGD", lr=0.1))
    save_checkpoint(state, 3, 0.5, out_dir=str(tmp_path), model_type="hctr",
                    is_best=True, acc=0.5)
    save_checkpoint(state, 3, 0.75, out_dir=str(tmp_path), model_type="hctr",
                    is_best=True, acc=0.75, is_val=True)
    assert sorted(os.listdir(tmp_path)) == [
        "hctr_3ep_0.5000acc_checkpoint", "hctr_checkpoint",
        "val_hctr_3ep_0.7500acc_checkpoint"]


def test_val_freq_writes_val_checkpoints(synth, tmp_path):
    root, chars = synth
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = Trainer(TrainerConfig(
            data=root, model_type="hctr-tiny", out_dir=str(tmp_path),
            device="cpu", **dict(FIT, epochs=1, val_freq=1)),
            _tiny(chars), chars)
        calls = []
        evaluate = trainer.evaluate
        trainer.evaluate = lambda phase: calls.append(phase) or (
            0.25 if phase == "val" else evaluate(phase))
        trainer.fit()
    assert calls == ["val", "val", "test"]
    assert "val_hctr-tiny_0ep_0.2500acc_checkpoint" in os.listdir(tmp_path)


@pytest.fixture(scope="module")
def hard16(tmp_path_factory):
    """demo/hard's first 16 test lines as a train and a test split."""
    root = tmp_path_factory.mktemp("hard16")
    with open(os.path.join(DEMO_HARD, "test_img_id_gt.txt"),
              encoding="utf-8") as f:
        lines = [ln for ln in f.read().splitlines() if ln][:16]
    for phase in ("train", "test"):
        os.makedirs(root / phase)
        for ln in lines:
            name = ln.split(",", 1)[0]
            os.symlink(os.path.join(DEMO_HARD, "test", name),
                       root / phase / name)
        (root / f"{phase}_img_id_gt.txt").write_text(
            "\n".join(lines) + "\n", encoding="utf-8")
    os.symlink(os.path.join(DEMO_HARD, "chars_list.txt"),
               root / "chars_list.txt")
    return str(root)


def test_cli_train_writes_the_jax_names(hard16, tmp_path):
    """A warm start from the converted demo/hard weights, one epoch, on the
    CPU; the checkpoint evaluates through ``cli/test.py`` to the
    trainer's accuracy."""
    out = str(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cli.main(["-m", "hctr-tiny", "-d", hard16, "-re",
                        os.path.join(ASSETS, "hctr_tiny.pt"), "-b", "8",
                        "-ep", "1", "--seed", "0", "--out-dir", out,
                        "--device", "cpu", "-j", "2"])
    acc = float(re.search(r"epoch 0: test acc ([0-9.]+)",
                          buf.getvalue()).group(1))
    assert acc > 0.5
    files = sorted(os.listdir(out))
    assert files == sorted(["hctr-tiny_checkpoint",
                            f"hctr-tiny_1ep_{acc:.4f}acc_checkpoint"])
    with contextlib.redirect_stdout(io.StringIO()):
        cer = eval_cli.main(["-m", "hctr-tiny", "-f",
                             os.path.join(out, "hctr-tiny_checkpoint"),
                             "-i", hard16, "-bm", "-b", "8", "-d", "cpu",
                             "-dm", "greedy-search"])
    assert round(1.0 - cer, 4) == acc


@pytest.mark.parametrize("flags,item", [
    (["-m", "innovation"], "item 9"),
    (["-m", "hctr-tiny", "--distributed"], "item 8"),
    (["-m", "hctr-tiny", "--profile", "trace"], "item 9"),
])
def test_cli_train_unported_flags_stop(flags, item, tmp_path):
    with pytest.raises(SystemExit, match=item):
        train_cli.main([*flags, "-d", str(tmp_path), "--device", "cpu"])
