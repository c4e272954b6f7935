"""Checkpoint save/load with the reference's naming and resume semantics
(the JAX package's ``train/checkpoint.py``).

  * Every checkpoint is one ``torch.save`` file holding ``{epoch, best_acc,
    params, batch_stats, opt_state, step}``: ``params`` and ``batch_stats``
    map the model's state-dict names to CPU tensors, so
    ``{**params, **batch_stats}`` is its state dict.
  * The latest is always ``<model>_checkpoint``; when it is the best so far
    it is copied to ``[val_]<model>_{epoch}ep_{acc:.4f}acc_checkpoint``
    (`main.py:349-356,540-558`).
  * The save is synchronous and atomic (written beside, then renamed).
  * Resume restores the epoch, best_acc, optimizer state and step
    (`main.py:251-269`). A file with a bare state dict (``hctr_tiny.pt``),
    or with params and statistics but another optimizer's state, is a warm
    start: its weights in f32, a fresh optimizer, epoch 0.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Tuple

import torch

from .step import TrainState


def _opt_payload(opt_state: dict) -> dict:
    return {k: ({n: t.detach().cpu() for n, t in v.items()}
                if isinstance(v, dict) else
                v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in opt_state.items()}


def save_checkpoint(state: TrainState, epoch: int, best_acc: float,
                    out_dir: str = ".", model_type: str = "hctr",
                    is_best: bool = False, acc: float = 0.0,
                    is_val: bool = False) -> str:
    """Write the latest checkpoint; copy it to a best-tagged name when
    ``is_best``. Returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    module = state.module
    payload = {
        "epoch": epoch,
        "best_acc": float(best_acc),
        "params": {n: p.detach().cpu()
                   for n, p in module.named_parameters()},
        "batch_stats": {n: b.detach().cpu()
                        for n, b in module.named_buffers()},
        "opt_state": _opt_payload(state.opt_state),
        "step": state.step,
    }
    path = os.path.abspath(os.path.join(out_dir,
                                        f"{model_type}_checkpoint"))
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    if is_best:
        prefix = "val_" if is_val else ""
        shutil.copyfile(path, os.path.join(
            out_dir, f"{prefix}{model_type}_{epoch}ep_{acc:.4f}acc_checkpoint"))
    return path


def state_dict_of(payload: dict) -> dict:
    """The model state dict in a checkpoint payload or a bare state dict."""
    if "params" in payload and "batch_stats" in payload:
        return {**payload["params"], **payload["batch_stats"]}
    return payload


def load_checkpoint(path: str, state: TrainState | None = None
                    ) -> Tuple[Any, int, float]:
    """Load a checkpoint; returns ``(state_or_payload, epoch, best_acc)``.

    With a ``state`` the weights are loaded into its module: a full resume
    also restores the optimizer state and step (`main.py:257-263`), a warm
    start (a bare state dict, or another optimizer's state) keeps a fresh
    optimizer and restarts at epoch 0. Without one the payload is returned.
    A file whose weights do not fit the model raises.
    """
    payload = torch.load(path, map_location="cpu", weights_only=True)
    epoch = int(payload.get("epoch", 0))
    best_acc = float(payload.get("best_acc", 0.0))
    if state is None:
        return payload, epoch, best_acc
    module = state.module
    module.load_state_dict({k: v.float()
                            for k, v in state_dict_of(payload).items()})
    saved_opt = payload.get("opt_state")
    if saved_opt is not None and saved_opt.keys() == state.opt_state.keys():
        for key, value in saved_opt.items():
            held = state.opt_state[key]
            if isinstance(held, dict):
                for n, t in held.items():
                    t.copy_(value[n])
            elif isinstance(held, torch.Tensor):
                held.copy_(value)
            else:
                state.opt_state[key] = value
        state.step = int(payload["step"])
        return state, epoch, best_acc
    print(f"=> warm start from {path} (fresh optimizer, epoch 0, "
          f"best_acc {best_acc:.4f})")
    return state, 0, best_acc
