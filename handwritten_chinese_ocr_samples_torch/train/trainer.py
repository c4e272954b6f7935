"""The training driver on one device (the JAX package's
``train/trainer.py``; the reference's `main.py:180-537`).

Per epoch: step-decay LR -> the train loop (host decode and collate in the
loader's threads; label encoding, pinning and the copy to the card of the
next batch in a helper thread while the current step runs) -> validation
every ``val_freq`` steps -> the test evaluation (greedy, accuracy =
1 - CER) -> the checkpoint.

As in the JAX trainer, the width buckets are the multiples of
``bucket_step`` up to ``max_width`` without ``max_width`` itself
(``trainer.py:144``), so at ``--max-width 1200 --bucket-step 128`` the
largest bucket is 1152: a line clipped to 1200 by ``AlignCollate`` is cut
to 1152 by the padding, its label left whole (ROADMAP.md, queue 3). The
loss and the gradient norm are read on the host only every ``print_freq``
steps.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.codec import CTCCodec
from ..data.bucketing import AlignCollate, BucketSpec
from ..data.dataset import ImageDataset
from ..data.loader import DataLoader
from ..eval.metrics import AverageMeter, cer_counts
from ..ops.dropout import fold_in
from ..utils.weights import init_state_dict
from .checkpoint import load_checkpoint, save_checkpoint
from .step import (TrainState, adjust_learning_rate, make_eval_step,
                   make_optimizer, make_train_step)


@dataclass
class TrainerConfig:
    data: str
    model_type: str = "hctr"
    batch_size: int = 8
    lr: float = 0.001
    momentum: float = 0.9
    weight_decay: float = 1e-4
    epochs: int = 90
    lr_decay_epochs: int = 30   # reference: x0.1 every 30 (`main.py:579`)
    start_epoch: int = 0
    print_freq: int = 1000
    val_freq: int = 50000
    workers: int = 4
    seed: Optional[int] = None
    resume: str = ""
    test_only: bool = False
    test_verbose: bool = False
    max_width: int = 1600
    bucket_step: int = 128
    use_width_mask: bool = False
    out_dir: str = "."
    max_label_len: int = 160
    # empty: the model's ``optimizer`` attribute decides (`main.py:209-218`)
    optimizer: str = ""
    device: str = "cuda"


class Trainer:
    def __init__(self, cfg: TrainerConfig, model, characters: str):
        if getattr(model, "pred", "CTC") != "CTC":
            raise ValueError("the classification trainer (models/"
                             "innovation.py) is not ported: ROADMAP.md "
                             "queue 1, item 9")
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.codec = CTCCodec(characters)
        self.best_acc = 0.0

        seed = cfg.seed if cfg.seed is not None else 0
        self.dropout_seed = seed + 1
        model.load_state_dict(init_state_dict(
            model, torch.Generator().manual_seed(seed)))
        self.model = model.to(self.device)
        kind = {"sgd": "SGD", "adam": "Adam"}.get(
            cfg.optimizer.lower(), cfg.optimizer) or model.optimizer
        self.state = TrainState.create(self.model, make_optimizer(
            kind, lr=cfg.lr, momentum=cfg.momentum,
            weight_decay=cfg.weight_decay))
        self.train_step = make_train_step(use_width_mask=cfg.use_width_mask)
        self.eval_step = make_eval_step(self.model, self.codec.unknown_id,
                                        use_width_mask=cfg.use_width_mask)

        self.start_epoch = cfg.start_epoch
        if cfg.resume:
            self.state, epoch, self.best_acc = load_checkpoint(
                cfg.resume, self.state)
            self.start_epoch = epoch
            print(f"=> loaded checkpoint: {cfg.resume} (epoch {epoch})")

    # ------------------------------------------------------------- loaders
    def _loader(self, phase: str, shuffle: bool) -> DataLoader:
        cfg = self.cfg
        dataset = ImageDataset(cfg.data, (1, self.model.img_height), phase,
                               batch_size=cfg.batch_size)
        collate = AlignCollate(
            imgH=self.model.img_height, PAD=self.model.pad_mode,
            max_width=cfg.max_width,
            bucket_spec=BucketSpec(tuple(range(
                cfg.bucket_step, cfg.max_width + 1, cfg.bucket_step))))
        return DataLoader(dataset, cfg.batch_size, collate, shuffle=shuffle,
                          seed=cfg.seed or 0, group_by_width=shuffle,
                          num_workers=cfg.workers)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def device_batch(self, batch: dict) -> dict:
        """A host batch -> the train step's: images and labels on the
        device, label paddings and widths on the CPU (the CTC lengths)."""
        labels, label_paddings = self.codec.encode_padded(
            batch["labels"], max_len=self.cfg.max_label_len)
        return {"images": self._to_device(batch["images"]),
                "labels": self._to_device(labels),
                "label_paddings": torch.from_numpy(label_paddings),
                "widths": torch.from_numpy(batch["widths"])}

    def _device_iter(self, loader: DataLoader):
        """Batches ready for the step, the next one's label encoding and
        copy to the card overlapped with the current step (the loader
        itself prefetches host batches in a background thread)."""
        it = iter(loader)

        def fetch():
            batch = next(it, None)
            return None if batch is None else self.device_batch(batch)

        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(fetch)
            while True:
                cur = fut.result()
                if cur is None:
                    return
                fut = ex.submit(fetch)
                yield cur

    # --------------------------------------------------------------- train
    def fit(self):
        cfg = self.cfg
        if cfg.test_only:
            acc = self.evaluate("test")
            print(f"Test acc: {acc:.4f}")
            return

        train_loader = self._loader("train", shuffle=True)
        for epoch in range(self.start_epoch, cfg.epochs):
            adjust_learning_rate(self.state, cfg.lr, epoch,
                                 cfg.lr_decay_epochs)
            train_loader.set_epoch(epoch)
            self._train_epoch(train_loader, epoch)
            acc = self.evaluate("test")
            is_best = acc > self.best_acc
            self.best_acc = max(acc, self.best_acc)
            save_checkpoint(self.state, epoch + 1, self.best_acc,
                            out_dir=cfg.out_dir, model_type=cfg.model_type,
                            is_best=is_best, acc=acc)
            print(f"epoch {epoch}: test acc {acc:.4f} "
                  f"(best {self.best_acc:.4f})")

    def _train_epoch(self, loader: DataLoader, epoch: int):
        cfg = self.cfg
        batch_time = AverageMeter("time", ":.3f")
        data_time = AverageMeter("data", ":.3f")
        losses = AverageMeter("loss", ":.4f")
        dropout_seed = fold_in(self.dropout_seed, epoch)
        end = time.time()
        for i, batch in enumerate(self._device_iter(loader)):
            data_time.update(time.time() - end)
            n_items = int(batch["images"].shape[0])
            self.state, metrics = self.train_step(self.state, batch,
                                                  dropout_seed)
            if (i + 1) % cfg.print_freq == 0:
                loss = float(metrics["loss"])  # the host waits here
                losses.update(loss, n_items)
                print(f"Epoch [{epoch}][{i + 1}/{len(loader)}] "
                      f"{batch_time} {data_time} {losses} "
                      f"grad_norm {float(metrics['grad_norm']):.2f} "
                      f"skipped {float(metrics['skipped']):.0f}")
            if cfg.val_freq and (i + 1) % cfg.val_freq == 0:
                acc = self.evaluate("val")
                is_best = acc > self.best_acc
                self.best_acc = max(acc, self.best_acc)
                save_checkpoint(self.state, epoch, self.best_acc,
                                out_dir=cfg.out_dir,
                                model_type=cfg.model_type,
                                is_best=is_best, acc=acc, is_val=True)
            batch_time.update(time.time() - end)
            end = time.time()

    # ---------------------------------------------------------------- eval
    def evaluate(self, phase: str = "test") -> float:
        """Greedy decode of a split; accuracy = 1 - CER
        (`main.py:516-537`)."""
        dist_sum, len_sum = 0, 0
        for batch in self._loader(phase, shuffle=False):
            chars, lengths = self.eval_step(
                self._to_device(batch["images"]),
                self._to_device(batch["widths"]))
            preds = self.codec.compact_to_texts(chars.cpu().numpy(),
                                                lengths.cpu().numpy())
            d, t = cer_counts(preds, list(batch["labels"]))
            dist_sum += d
            len_sum += t
            if self.cfg.test_verbose:
                for p, g in zip(preds, batch["labels"]):
                    print(f"PRE: {p}\nTRU: {g}")
        return 1.0 - dist_sum / max(len_sum, 1)
