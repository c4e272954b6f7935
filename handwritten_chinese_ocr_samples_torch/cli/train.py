"""Training CLI on the card (the JAX package's ``cli/train.py``; flag surface
of the reference trainer, `main.py:86-135`).

    python -m handwritten_chinese_ocr_samples_torch.cli.train \\
        -m hctr -d <data_dir> -b 16 -lr 0.0005 --optimizer adam -ep 90

``-d`` is the dataset, as in the JAX CLI; the device is ``--device``
(default ``cuda``; ``--device cpu`` runs on the CPU). The recognizer
computes in bf16 with f32 parameters, as the JAX CLI's does. ``-re`` takes
a checkpoint this trainer wrote (full resume) or a state dict such as
``assets/demo_hard/hctr_tiny.pt`` (warm start). ``-m innovation`` trains
the isolated-character classifier (``-d`` holds 128x128 glyphs, each
labelled with its character: ``data/prep/gnt.py`` and ``flow.py`` make
them), with cross-entropy and top-1 test accuracy. ``--profile DIR``
writes a ``torch.profiler`` trace of steps 10-30 of the first epoch into
DIR.

``--distributed`` trains data-parallel with one process per card, as the
reference does (`main.py:157-237`); the JAX CLI drives every local chip
from one process instead. Launch it with ``torch.distributed.run``::

    python -m torch.distributed.run --nproc_per_node 4 \
        -m handwritten_chinese_ocr_samples_torch.cli.train --distributed \
        -m hctr -d <data_dir> -b 16 ...

Each process trains on ``cuda:LOCAL_RANK`` (``--device cpu``: gloo ranks
on the CPU) over ``-b / nproc`` rows of every batch of ``-b``, so the
step is the one-process step on the whole batch (``train/step.py``); only
rank 0 prints and writes checkpoints. Without the flag the port trains on
one card.
"""

from __future__ import annotations

import argparse
import random

import numpy as np


def build_argparser():
    parser = argparse.ArgumentParser(
        description="HCTR OCR textline training (PyTorch)")
    args = parser.add_argument_group("Options")
    args.add_argument("-m", "--model-type", type=str, required=True,
                      choices=["hctr", "hctr-tiny", "innovation"],
                      help="target model for different languages/scenarios")
    args.add_argument("-d", "--data", metavar="DIR", required=True,
                      help="path to dataset")
    args.add_argument("--device", type=str, default="cuda",
                      help="torch device")
    args.add_argument("-j", "--workers", default=4, type=int, metavar="N",
                      help="number of data loading workers")
    args.add_argument("-b", "--batch-size", default=8, type=int, metavar="N",
                      help="mini-batch size")
    args.add_argument("-lr", "--learning-rate", default=0.001, type=float,
                      metavar="LR", dest="lr", help="initial learning rate")
    args.add_argument("-mm", "--momentum", default=0.9, type=float,
                      metavar="M", help="momentum")
    args.add_argument("-wd", "--weight-decay", default=1e-4, type=float,
                      metavar="W", help="weight decay")
    args.add_argument("--lr-decay-epochs", default=30, type=int, metavar="N",
                      help="x0.1 LR step interval (reference hardcodes 30, "
                           "`main.py:579-584`)")
    args.add_argument("-pf", "--print-freq", default=1000, type=int,
                      metavar="N", help="print frequency")
    args.add_argument("-vf", "--val-freq", default=50000, type=int,
                      metavar="N", help="validate frequency")
    args.add_argument("-re", "--resume", default="", type=str, metavar="PATH",
                      help="path to latest checkpoint")
    args.add_argument("-te", "--test", action="store_true",
                      help="test model on test set")
    args.add_argument("-tv", "--testverbose", action="store_true",
                      help="output result when testing")
    args.add_argument("-ep", "--epochs", default=90, type=int, metavar="N",
                      help="number of total epochs to run")
    args.add_argument("--start-epoch", default=0, type=int, metavar="N",
                      help="manual epoch number")
    args.add_argument("--seed", default=None, type=int,
                      help="seed for initializing training")
    args.add_argument("--max-width", default=1600, type=int,
                      help="width cap (OOM guard, `dataset.py:100`)")
    args.add_argument("--bucket-step", default=128, type=int,
                      help="width bucket granularity")
    args.add_argument("--width-mask", action="store_true",
                      help="mask pad frames in CTC by true image width "
                           "(reference feeds full padded width)")
    args.add_argument("--out-dir", default=".", type=str,
                      help="checkpoint output directory")
    args.add_argument("--remat", action="store_true",
                      help="recompute residual blocks in the backward pass "
                           "(hctr only)")
    args.add_argument("--optimizer", default="model",
                      choices=["model", "sgd", "adam"],
                      help="override the model-attribute optimizer choice "
                           "(`main.py:209-218`; 'model' keeps it)")
    args.add_argument("--profile", default="", metavar="DIR",
                      help="write a torch.profiler trace of train steps "
                           "10-30 of the first epoch into DIR (view with "
                           "tensorboard --logdir DIR or Perfetto)")
    args.add_argument("--distributed", action="store_true",
                      help="data-parallel training, one process per card "
                           "(run under python -m torch.distributed.run)")
    return parser


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import torch
    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)
        torch.manual_seed(args.seed)

    from ..models.registry import get_model_info
    from ..parallel import mesh
    from ..train.trainer import Trainer, TrainerConfig

    device = args.device
    if args.distributed:
        device = str(mesh.initialize_distributed(args.device))

    extra = {"remat": True} if (args.remat
                                and args.model_type == "hctr") else {}
    model, characters = get_model_info(args.model_type, data_dir=args.data,
                                       dtype=torch.bfloat16, **extra)
    if mesh.is_main():
        print(f"Character vocabulary: {len(characters)}, "
              f"Model output classes: {len(characters) + 2}")

    cfg = TrainerConfig(
        data=args.data, model_type=args.model_type,
        batch_size=args.batch_size, lr=args.lr, momentum=args.momentum,
        weight_decay=args.weight_decay, epochs=args.epochs,
        lr_decay_epochs=args.lr_decay_epochs,
        start_epoch=args.start_epoch, print_freq=args.print_freq,
        val_freq=args.val_freq, workers=args.workers, seed=args.seed,
        resume=args.resume, test_only=args.test,
        test_verbose=args.testverbose, max_width=args.max_width,
        bucket_step=args.bucket_step, use_width_mask=args.width_mask,
        out_dir=args.out_dir, profile_dir=args.profile,
        optimizer="" if args.optimizer == "model" else args.optimizer,
        device=device)
    try:
        Trainer(cfg, model, characters).fit()
    finally:
        if args.distributed and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
