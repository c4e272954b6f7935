"""Training CLI on the card (the JAX package's ``cli/train.py``; flag surface
of the reference trainer, `main.py:86-135`).

    python -m handwritten_chinese_ocr_samples_torch.cli.train \\
        -m hctr -d <data_dir> -b 16 -lr 0.0005 --optimizer adam -ep 90

``-d`` is the dataset, as in the JAX CLI; the device is ``--device``
(default ``cuda``; ``--device cpu`` runs on the CPU). The recognizer
computes in bf16 with f32 parameters, as the JAX CLI's does. ``-re`` takes
a checkpoint this trainer wrote (full resume) or a state dict such as
``assets/demo_hard/hctr_tiny.pt`` (warm start). ``-m innovation``,
``--distributed`` and ``--profile`` stop with an error naming their
ROADMAP item.
"""

from __future__ import annotations

import argparse
import random

import numpy as np

_UNPORTED = {
    "distributed": "multi-device training (ROADMAP.md queue 1, item 8)",
    "profile": "the profiler trace of utils/profiling.py (ROADMAP.md "
               "queue 1, item 9)",
}


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
    later = parser.add_argument_group(
        "Not ported yet", "setting any of these stops with an error")
    later.add_argument("--distributed", action="store_true")
    later.add_argument("--profile", default="", metavar="DIR")
    return parser


def main(argv=None):
    args = build_argparser().parse_args(argv)
    for flag, what in _UNPORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag}: {what} is not ported yet")
    if args.model_type == "innovation":
        raise SystemExit("-m innovation: models/innovation.py and its "
                         "classification trainer are not ported yet "
                         "(ROADMAP.md queue 1, item 9)")

    import torch
    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)
        torch.manual_seed(args.seed)

    from ..models.registry import get_model_info
    from ..train.trainer import Trainer, TrainerConfig

    extra = {"remat": True} if (args.remat
                                and args.model_type == "hctr") else {}
    model, characters = get_model_info(args.model_type, data_dir=args.data,
                                       dtype=torch.bfloat16, **extra)
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
        out_dir=args.out_dir,
        optimizer="" if args.optimizer == "model" else args.optimizer,
        device=args.device)
    Trainer(cfg, model, characters).fit()


if __name__ == "__main__":
    main()
