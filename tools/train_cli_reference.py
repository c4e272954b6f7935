"""The JAX training CLI's test accuracy on ``chip_smoke.py``'s ``train_cli``
command, the value that phase holds the port's CLI against.

    env JAX_PLATFORMS=cpu python tools/train_cli_reference.py

``train_cli`` warm-starts the port's ``cli/train.py`` from
``handwritten_chinese_ocr_samples_torch/assets/demo_hard/hctr_tiny.pt`` (a
bare state dict: fresh optimizer, epoch 0) and trains one epoch of
``demo/hard``'s 1200 training lines at batch 8, seed 0. ``demo/hard/
checkpoint`` itself is a full training checkpoint (epoch 142): ``-re`` on
it resumes at epoch 142, so ``-ep 1`` would train nothing. This script
writes its parameters and batch statistics alone (f32, an orbax tree, as
``tools/make_fullsize_demo.py --step strip`` writes a serving artifact)
into a temporary directory, links ``demo/hard/data``'s train and test
splits there as ``chip_smoke.py`` does, and runs

    python -m handwritten_chinese_ocr_samples_tpu.cli.train -m hctr-tiny \\
        -d <tmp>/data -re <tmp>/hctr_tiny -b 8 -ep 1 --seed 0 \\
        --out-dir <tmp>/out

on the CPU: a warm start from the same weights, with the same flags. It
prints the CLI's output and, last, the test accuracy it reports.

Needs the JAX package (JAX, flax, orbax); the port never imports this file.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEMO_DATA = os.path.join(REPO, "demo", "hard", "data")
LINKED = ("train", "test", "train_img_id_gt.txt", "test_img_id_gt.txt",
          "chars_list.txt")


def main() -> int:
    import jax
    import numpy as np
    import orbax.checkpoint as ocp
    from handwritten_chinese_ocr_samples_tpu.utils.ckpt_io import (
        restore_pytree_host)

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        for name in LINKED:
            os.symlink(os.path.join(DEMO_DATA, name),
                       os.path.join(data, name))
        payload = restore_pytree_host(
            os.path.join(REPO, "demo", "hard", "checkpoint"))
        weights = os.path.join(tmp, "hctr_tiny")
        ocp.PyTreeCheckpointer().save(weights, jax.tree.map(
            lambda a: np.asarray(a, np.float32),
            {"params": payload["params"],
             "batch_stats": payload["batch_stats"]}))
        argv = [sys.executable, "-m",
                "handwritten_chinese_ocr_samples_tpu.cli.train",
                "-m", "hctr-tiny", "-d", data, "-re", weights, "-b", "8",
                "-ep", "1", "--seed", "0",
                "--out-dir", os.path.join(tmp, "out")]
        run = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                             env=dict(os.environ, JAX_PLATFORMS="cpu"))
        print(run.stdout, end="")
        if run.returncode:
            print(run.stderr, end="", file=sys.stderr)
            return run.returncode
    acc = re.findall(r"epoch 0: test acc ([0-9.]+)", run.stdout)
    if not acc:
        raise SystemExit("the JAX CLI printed no test accuracy")
    print(f"jax_cli_test_acc {acc[-1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
