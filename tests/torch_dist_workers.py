"""Rank functions of ``tests/test_torch_dist.py``, spawned in gloo process
groups on the CPU. They import the port only (no JAX), and each rank writes
what it holds into ``<result_dir>/rank<r>.pt``."""

import contextlib
import io
import os

import torch

from handwritten_chinese_ocr_samples_torch.models.hctr import (
    BatchNorm, HCTRModel)
from handwritten_chinese_ocr_samples_torch.parallel import mesh
from handwritten_chinese_ocr_samples_torch.train.trainer import (
    Trainer, TrainerConfig)

NO_DROP = dict(stage_drop=(0.0,) * 4, block_drop=0.0)


def _join(rank: int, world: int, init_file: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    dev = mesh.initialize_distributed("cpu", f"file://{init_file}")
    assert dev == torch.device("cpu") and mesh.world_size() == world
    assert mesh.rank() == rank and mesh.is_main() == (rank == 0)


def fit_rank(rank: int, world: int, init_file: str, cfg: dict, chars: str,
             init_state: str, result_dir: str) -> None:
    """``Trainer.fit`` of an f64 ``hctr-tiny`` from the given weights,
    recording each step's loss; this rank's checkpoints go to its own
    ``out_dir``."""
    _join(rank, world, init_file)
    model = HCTRModel(num_classes=len(chars) + 2, backbone_channels=64,
                      num_blocks=(1, 1, 1, 1), compute_dtype=torch.float64,
                      **NO_DROP)
    out_dir = os.path.join(result_dir, f"out{rank}")
    trainer = Trainer(TrainerConfig(out_dir=out_dir, device="cpu", **cfg),
                      model, chars)
    trainer.model.load_state_dict(torch.load(init_state))
    losses, rows = [], []
    step = trainer.train_step

    def recorded(state, batch, seed):
        rows.append(int(batch["images"].shape[0]))
        state, metrics = step(state, batch, seed)
        losses.append(float(metrics["loss"]))
        return state, metrics

    trainer.train_step = recorded
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        trainer.fit()
        acc = trainer.evaluate("test")
    torch.save({"state": trainer.model.state_dict(), "losses": losses,
                "rows": rows, "acc": acc, "stdout": buf.getvalue()},
               os.path.join(result_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def batchnorm_rank(rank: int, world: int, init_file: str, x_path: str,
                   result_dir: str) -> None:
    """Train-mode ``BatchNorm`` forward and backward on this rank's rows
    of a saved batch, the loss a mean over the rows as the train step's;
    the gradients averaged over the ranks as the train step averages
    them."""
    _join(rank, world, init_file)
    saved = torch.load(x_path)
    x = mesh.shard_rows(saved["x"], world, rank).clone().requires_grad_()
    dy = mesh.shard_rows(saved["dy"], world, rank)
    bn = BatchNorm(x.shape[1]).double()
    bn.weight.data.copy_(saved["weight"])
    bn.bias.data.copy_(saved["bias"])
    bn.train()
    y = bn(x)
    (y * dy).sum().div(x.shape[0]).backward()
    loss, grads = mesh.all_reduce_mean(
        torch.zeros((), dtype=torch.float64),
        [bn.weight.grad, bn.bias.grad])
    # a rank's backward differentiates the sum of the ranks' losses: its
    # x gradient is W times the global loss's
    torch.save({"y": y.detach(), "dx": x.grad / world,
                "stats": bn.batch_stats, "dweight": grads[0],
                "dbias": grads[1]},
               os.path.join(result_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
