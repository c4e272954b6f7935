"""The JAX training CLI's test accuracy on ``chip_smoke.py``'s ``train_cli``
command, the value that phase holds the port's CLI against, and the spread
of both CLIs over seeds on the CPU.

    env JAX_PLATFORMS=cpu python tools/train_cli_reference.py
    env JAX_PLATFORMS=cpu python tools/train_cli_reference.py --seed 0 1 2
    python tools/train_cli_reference.py --port --seed 0 1 2
    ... [--f32]

``train_cli`` warm-starts the port's ``cli/train.py`` from
``handwritten_chinese_ocr_samples_torch/assets/demo_hard/hctr_tiny.pt`` (a
bare state dict: fresh optimizer, epoch 0) and trains one epoch of
``demo/hard``'s 1200 training lines at batch 8, seed 0. ``demo/hard/
checkpoint`` itself is a full training checkpoint (epoch 142): ``-re`` on
it resumes at epoch 142, so ``-ep 1`` would train nothing. This script
writes its parameters and batch statistics alone (f32, an orbax tree, as
``tools/make_fullsize_demo.py --step strip`` writes a serving artifact)
into a temporary directory, links ``demo/hard/data``'s train and test
splits there as ``chip_smoke.py`` does, and runs, once for each seed,

    python -m handwritten_chinese_ocr_samples_tpu.cli.train -m hctr-tiny \\
        -d <tmp>/data -re <tmp>/hctr_tiny -b 8 -ep 1 --seed <seed> \\
        --out-dir <tmp>/out

on the CPU: a warm start from the same weights, with the same flags.
``--port`` runs the port's CLI instead, with ``train_cli``'s arguments
(``-re`` the converted state dict) and ``--device cpu`` (``--device cuda``
on the card's machine). ``--f32`` runs the
CLI with its recognizer in f32 instead of bf16 (both CLIs hard-code bf16;
the run patches the registry's ``get_model_info``). It prints each
run's test accuracy as ``<cli>_test_acc <seed> <acc>`` and, with several
seeds, their mean and range.

Needs the JAX package (JAX, flax, orbax) unless ``--port``; the port never
imports this file.
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEMO_DATA = os.path.join(REPO, "demo", "hard", "data")
PORT_WEIGHTS = os.path.join(REPO, "handwritten_chinese_ocr_samples_torch",
                            "assets", "demo_hard", "hctr_tiny.pt")
LINKED = ("train", "test", "train_img_id_gt.txt", "test_img_id_gt.txt",
          "chars_list.txt")


def jax_weights(tmp: str) -> str:
    """demo/hard/checkpoint's parameters and batch statistics alone, as an
    orbax tree under ``tmp``."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp
    from handwritten_chinese_ocr_samples_tpu.utils.ckpt_io import (
        restore_pytree_host)
    payload = restore_pytree_host(
        os.path.join(REPO, "demo", "hard", "checkpoint"))
    weights = os.path.join(tmp, "hctr_tiny")
    ocp.PyTreeCheckpointer().save(weights, jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        {"params": payload["params"],
         "batch_stats": payload["batch_stats"]}))
    return weights


# the CLI with its registry's get_model_info forced to an f32 recognizer
_F32 = ("import sys, {pkg}.models.registry as r; g = r.get_model_info; "
        "r.get_model_info = lambda *a, **k: g(*a, **dict(k, dtype={f32})); "
        "import {f32_mod}; from {pkg}.cli.train import main; "
        "sys.argv = ['train'] + {argv!r}; main()")


def train_once(port: bool, seed: int, weights: str, data: str,
               out_dir: str, f32: bool = False,
               device: str = "cpu") -> float:
    """One CLI run; returns the test accuracy it printed."""
    pkg = ("handwritten_chinese_ocr_samples_torch" if port
           else "handwritten_chinese_ocr_samples_tpu")
    args = ["-m", "hctr-tiny", "-d", data, "-re", weights, "-b", "8",
            "-ep", "1", "--seed", str(seed), "--out-dir", out_dir]
    if port:
        args += ["--device", device]
    argv = [sys.executable, "-m", f"{pkg}.cli.train", *args]
    if f32:
        mod, dt = (("torch", "torch.float32") if port
                   else ("jax.numpy", "jax.numpy.float32"))
        argv = [sys.executable, "-c", _F32.format(
            pkg=pkg, f32=dt, f32_mod=mod, argv=args)]
    run = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    print(run.stdout, end="")
    if run.returncode:
        print(run.stderr, end="", file=sys.stderr)
        raise SystemExit(run.returncode)
    acc = re.findall(r"epoch 0: test acc ([0-9.]+)", run.stdout)
    if not acc:
        raise SystemExit("the CLI printed no test accuracy")
    return float(acc[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, nargs="+", default=[0],
                        help="the CLI's --seed, one run each (default 0, "
                             "train_cli's)")
    parser.add_argument("--port", action="store_true",
                        help="run the port's cli/train.py instead")
    parser.add_argument("--f32", action="store_true",
                        help="the recognizer in f32 instead of bf16")
    parser.add_argument("--device", default="cpu",
                        help="the port's --device (default cpu)")
    args = parser.parse_args(argv)
    if args.device != "cpu" and not args.port:
        parser.error("--device is the port's; the JAX CLI runs on the CPU")
    name = ("port_cli" if args.port else "jax_cli") + (
        "_f32" if args.f32 else "") + (
        "" if args.device == "cpu" else f"_{args.device}")
    accs = []
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        for link in LINKED:
            os.symlink(os.path.join(DEMO_DATA, link),
                       os.path.join(data, link))
        weights = PORT_WEIGHTS if args.port else jax_weights(tmp)
        for seed in args.seed:
            accs.append(train_once(args.port, seed, weights, data,
                                   os.path.join(tmp, f"out{seed}"),
                                   args.f32, args.device))
            print(f"{name}_test_acc {seed} {accs[-1]}", flush=True)
    if len(accs) > 1:
        print(f"{name}_test_acc_mean {statistics.mean(accs)} "
              f"min {min(accs)} max {max(accs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
