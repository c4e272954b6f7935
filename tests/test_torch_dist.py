"""Data-parallel training of the port (``parallel/mesh.py``,
``train/step.py``, ``train/trainer.py``, ``cli/train.py --distributed``)
against the JAX trainer's mesh step, with gloo process groups on the CPU.

Two ranks of 4 rows train the f64 ``hctr-tiny`` of
``tests/test_torch_trainer.py`` from the JAX trainer's initial weights, and
the JAX ``Trainer`` trains it on batches of 8 over its ``data`` mesh (the
8 virtual devices of ``conftest.py``): SGD for an epoch of two steps, Adam
for one step (its running statistics then come from the forward before the
update, whose rounding noise Adam magnifies). Per-step losses, final
parameters and BatchNorm statistics are held within
``test_torch_trainer.py``'s tolerances (losses 3e-4 relative, parameters
2.5e-3 * lr, statistics 2.5e-4 of each tensor's largest value), and for
SGD the test accuracy is equal.

For Adam (at lr 1e-3, as ``test_torch_train_step.py``'s) that file's rule
holds: Adam moves each element by about lr times the sign of its update
direction u (the clipped gradient plus the weight decay), so an element
whose u is below 1e-4 of its tensor's largest |u| (of the model's, for the
conv biases that feed a train-mode BatchNorm, zero in exact arithmetic)
may flip, within 2 lr; u is the port's one-process f64 step's, which that
file holds to the JAX step's gradients. (Measured here: 50 of 240k
elements flip, and they change the untrained model's greedy texts, so the
Adam run's accuracy is only held equal between the ranks.)

The two ranks end bit-equal, and only rank 0 prints and writes
checkpoints. The rank functions live in ``tests/torch_dist_workers.py`` (no
JAX there) and meet through a ``file://`` store under ``tmp_path``, so
concurrent test workers never share a port.
"""

import contextlib
import io
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tests import torch_dist_workers as workers
from tests.test_torch_train_step import _zero_in_exact_arithmetic
from tests.util_synth import make_dataset

from handwritten_chinese_ocr_samples_tpu.models.hctr import (
    HCTRModel as FlaxHCTR)
from handwritten_chinese_ocr_samples_tpu.train.trainer import (
    Trainer as JaxTrainer, TrainerConfig as JaxConfig)
from handwritten_chinese_ocr_samples_torch.data.bucketing import (
    AlignCollate, BucketSpec)
from handwritten_chinese_ocr_samples_torch.data.dataset import ImageDataset
from handwritten_chinese_ocr_samples_torch.data.loader import DataLoader
from handwritten_chinese_ocr_samples_torch.models.hctr import HCTRModel
from handwritten_chinese_ocr_samples_torch.ops.ctc import ctc_loss_mean
from handwritten_chinese_ocr_samples_torch.parallel import mesh
from handwritten_chinese_ocr_samples_torch.train import trainer as trainer_mod
from handwritten_chinese_ocr_samples_torch.train.step import global_norm
from handwritten_chinese_ocr_samples_torch.utils.weights import flax_to_torch

from tests.test_torch_lm import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = {"sgd": 0.01, "adam": 1e-3}
FIT = dict(batch_size=8, epochs=1, print_freq=1, val_freq=0, workers=2,
           seed=0, bucket_step=64, max_width=256, max_label_len=8)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    _, chars = make_dataset(root, n_train=16, n_val=4, n_test=8, seed=1)
    return root, chars


@pytest.fixture(scope="module")
def synth8(tmp_path_factory):
    """One batch of 8 training lines: Adam's single step."""
    root = str(tmp_path_factory.mktemp("synth8"))
    _, chars = make_dataset(root, n_train=8, n_val=4, n_test=8, seed=1)
    return root, chars


def _adam_directions(root, chars, init, cfg, tmp_path) -> dict:
    """Adam's update direction at the first step on the whole batch of 8:
    the clipped gradient plus the weight decay, by the port's one-process
    f64 step from ``init``."""
    model = HCTRModel(num_classes=len(chars) + 2, backbone_channels=64,
                      num_blocks=(1, 1, 1, 1), compute_dtype=torch.float64,
                      **workers.NO_DROP)
    t = trainer_mod.Trainer(trainer_mod.TrainerConfig(
        out_dir=str(tmp_path / "u"), device="cpu", **cfg), model, chars)
    t.model.load_state_dict(init)
    loader = t._loader("train", shuffle=True)
    loader.set_epoch(0)
    batch = t.device_batch(next(iter(loader)))
    names, params = zip(*t.model.train().named_parameters())
    loss = ctc_loss_mean(t.model(batch["images"]), batch["labels"],
                         batch["label_paddings"])
    grads = torch.autograd.grad(loss, params)
    norm = global_norm(list(grads)).item()
    clip = min(1.0, t.state.tx.clip_norm / norm)
    wd = t.state.tx.weight_decay
    return {n: g * clip + wd * p.detach()
            for n, g, p in zip(names, grads, params)}


def _spawn(fn, world, tmp_path, *args) -> list:
    """``fn(rank, world, init_file, *args, result_dir)`` on ``world`` gloo
    ranks; returns what each rank saved."""
    res = tmp_path / "ranks"
    res.mkdir()
    mp.spawn(fn, args=(world, str(tmp_path / "store"), *args, str(res)),
             nprocs=world, join=True)
    return [torch.load(res / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_two_ranks_match_jax_trainer(synth, synth8, optimizer, tmp_path):
    root, chars = synth if optimizer == "sgd" else synth8
    steps = 2 if optimizer == "sgd" else 1
    cfg = dict(data=root, model_type="hctr-tiny", optimizer=optimizer,
               lr=LR[optimizer], **FIT)
    jlosses = []
    with jax.enable_x64(True), contextlib.redirect_stdout(io.StringIO()):
        jt = JaxTrainer(
            JaxConfig(out_dir=str(tmp_path / "jax"), **cfg),
            FlaxHCTR(num_classes=len(chars) + 2, backbone_channels=64,
                     num_blocks=(1, 1, 1, 1), dtype=jnp.float64,
                     **workers.NO_DROP), chars)
        assert jt.mesh.shape["data"] == 8
        init = flax_to_torch(jax.tree.map(np.asarray, {
            "params": jt.state.params,
            "batch_stats": jt.state.batch_stats}))
        step = jt.train_step

        def recorded(state, batch, rng):
            state, metrics = step(state, batch, rng)
            jlosses.append(float(metrics["loss"]))
            return state, metrics
        jt.train_step = recorded
        jt.fit()
        jacc = jt.evaluate("test")
    jfinal = flax_to_torch(jax.tree.map(np.asarray, {
        "params": jt.state.params, "batch_stats": jt.state.batch_stats}))
    torch.save(init, tmp_path / "init.pt")
    ranks = _spawn(workers.fit_rank, 2, tmp_path, cfg, chars,
                   str(tmp_path / "init.pt"))
    r0, r1 = ranks
    assert r0["rows"] == r1["rows"] == [4] * steps
    assert len(jlosses) == steps
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=3e-4)
    assert r0["losses"] == r1["losses"]
    u = (_adam_directions(root, chars, init, cfg, tmp_path)
         if optimizer == "adam" else None)
    for name, want in jfinal.items():
        got = r0["state"][name]
        assert torch.equal(got, r1["state"][name]), name
        if name.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(
                got, want, rtol=0, atol=2.5e-4 * want.abs().max().item())
            continue
        err = (got - want).abs()
        tol = 2.5e-3 * LR[optimizer]
        if optimizer == "adam":          # flips at the noise floor
            top = (max(v.abs().max() for v in u.values())
                   if _zero_in_exact_arithmetic(name)
                   else u[name].abs().max())
            flip = err > tol
            assert (u[name][flip].abs() < 1e-4 * top).all(), name
            assert err.max().item() <= 2 * LR["adam"], name
        else:
            assert err.max().item() <= tol, name
    assert r0["acc"] == r1["acc"]
    if optimizer == "sgd":     # Adam's flips change this untrained model's
        assert r0["acc"] == pytest.approx(jacc, abs=1e-12)   # greedy texts
    # only rank 0 prints and writes; the JAX trainer's checkpoint names
    assert sorted(os.listdir(tmp_path / "ranks" / "out0")) == sorted(
        os.listdir(tmp_path / "jax"))
    assert not (tmp_path / "ranks" / "out1").exists()
    assert f"epoch 0: test acc {r0['acc']:.4f}" in r0["stdout"]
    assert r1["stdout"] == ""


def test_batchnorm_statistics_are_global(tmp_path):
    """Train-mode BatchNorm on two ranks of 3 rows: outputs, statistics,
    the input gradient of the global loss and the averaged parameter
    gradients equal the one-process layer's on all 6 rows (f64)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, 3, 7, generator=g, dtype=torch.float64) * 3 + 1
    dy = torch.randn(x.shape, generator=g, dtype=torch.float64)
    weight = torch.rand(5, generator=g, dtype=torch.float64) + 0.5
    bias = torch.randn(5, generator=g, dtype=torch.float64)
    torch.save({"x": x, "dy": dy, "weight": weight, "bias": bias},
               tmp_path / "x.pt")
    bn = workers.BatchNorm(5).double()
    bn.weight.data.copy_(weight)
    bn.bias.data.copy_(bias)
    xs = x.clone().requires_grad_()
    y = bn.train()(xs)
    (y * dy).sum().div(6).backward()
    ranks = _spawn(workers.batchnorm_rank, 2, tmp_path,
                   str(tmp_path / "x.pt"))
    kw = dict(rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(torch.cat([r["y"] for r in ranks]),
                               y.detach(), **kw)
    torch.testing.assert_close(torch.cat([r["dx"] for r in ranks]),
                               xs.grad, **kw)
    for r in ranks:
        for got, want in zip(r["stats"], bn.batch_stats):
            torch.testing.assert_close(got, want, **kw)
        torch.testing.assert_close(r["dweight"], bn.weight.grad, **kw)
        torch.testing.assert_close(r["dbias"], bn.bias.grad, **kw)


def test_indivisible_batch_raises(synth, monkeypatch):
    root, chars = synth
    monkeypatch.setattr(trainer_mod.mesh, "world_size", lambda: 3)
    model = HCTRModel(num_classes=len(chars) + 2, backbone_channels=64,
                      num_blocks=(1, 1, 1, 1))
    with pytest.raises(ValueError, match="batch size 8 .* 3 ranks"):
        trainer_mod.Trainer(trainer_mod.TrainerConfig(
            data=root, device="cpu", batch_size=8), model, chars)
    with pytest.raises(ValueError, match="batch size 8 .* 3 row shards"):
        DataLoader(ImageDataset(root, (1, 128), "train", 8), 8,
                   AlignCollate(), rows=(0, 3))
    with pytest.raises(ValueError, match="batch 8 not divisible by 3"):
        mesh.shard_rows(np.zeros((8, 2)), 3, 0)


def test_row_shards_are_the_whole_batch_rows(synth):
    """Each of 4 row shards decodes only its own rows and pads them to the
    whole batch's bucket: together they are the one-process batches."""
    root, _ = synth
    collate = AlignCollate(imgH=128, max_width=256,
                           bucket_spec=BucketSpec(tuple(range(64, 257, 64))))

    def batches(rows):
        loader = DataLoader(ImageDataset(root, (1, 128), "train", 8), 8,
                            collate, shuffle=True, seed=3,
                            group_by_width=True, num_workers=1, rows=rows)
        loader.set_epoch(1)
        return list(loader)

    whole = batches((0, 1))
    parts = [batches((i, 4)) for i in range(4)]
    assert len(whole) == 2
    for b, want in enumerate(whole):
        for key in ("images", "widths"):
            np.testing.assert_array_equal(
                np.concatenate([p[b][key] for p in parts]), want[key])
        assert sum((p[b]["labels"] for p in parts), ()) == want["labels"]


def test_initialize_distributed_without_launcher_is_a_noop(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.initialize_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert (mesh.rank(), mesh.world_size(), mesh.is_main()) == (0, 1, True)
    assert mesh.data_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="exceeds the 0 visible devices"):
        mesh.data_devices(2, "cuda")


def test_cli_train_distributed(synth, tmp_path):
    """``cli/train.py --distributed`` under ``torch.distributed.run`` with
    two gloo ranks on the CPU: one accuracy line, one set of checkpoints
    (rank 0's), the same as the one-process CLI's."""
    root, _ = synth
    argv = ["-m", "handwritten_chinese_ocr_samples_torch.cli.train", "-m",
            "hctr-tiny", "-d", root, "-b", "8", "-ep", "1", "--seed", "0",
            "--device", "cpu", "-j", "1", "--max-width", "256",
            "--bucket-step", "64"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    dist_out, one_out = tmp_path / "dist", tmp_path / "one"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", *argv, "--distributed", "--out-dir",
         str(dist_out)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    accs = re.findall(r"epoch 0: test acc ([0-9.]+)", proc.stdout)
    assert len(accs) == 1
    one = subprocess.run([sys.executable, *argv, "--out-dir", str(one_out)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    assert re.findall(r"epoch 0: test acc ([0-9.]+)", one.stdout) == accs
    assert sorted(os.listdir(dist_out)) == sorted(os.listdir(one_out)) == [
        "hctr-tiny_1ep_" + f"{float(accs[0]):.4f}acc_checkpoint",
        "hctr-tiny_checkpoint"]
