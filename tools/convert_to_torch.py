"""Convert the trained ``demo/hard`` artifact for the PyTorch port, and record
the JAX package's texts on its test split as the port's reference.

    env JAX_PLATFORMS=cpu python tools/convert_to_torch.py
    env JAX_PLATFORMS=cpu python tools/convert_to_torch.py --skip-texts

Reads ``demo/hard/checkpoint`` (the trained ``hctr-tiny``) and
``demo/hard/lm`` (the trained 128d/3L char LM, orbax ``weights/``) with the
JAX package, and writes with the port's ``utils.weights`` into
``handwritten_chinese_ocr_samples_torch/assets/demo_hard/``:

  * ``hctr_tiny.pt``: the recognizer's state dict (f32, as stored);
  * ``lm/``: ``config.json``, ``dict.txt`` and ``weights.pt``, a directory
    that the port's ``lm/io.load_lm`` reads;
  * ``texts.json``: the JAX ``ServingEngine``'s texts for every line of
    ``demo/hard/data/test``, on the greedy route, the plain device beam and
    the LM-fused skip search (``-dm beam-search -utp -uts -tp lm -ss -lp 0.8
    -lb 0.0``, LM in f32, the CLI's other defaults), with the recognizer in
    f32, batch 8. ``chip_smoke.py`` holds the card's texts against them.

Needs the JAX package (JAX, flax, orbax); the port never imports this file.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEMO = os.path.join(REPO, "demo", "hard")
OUT = os.path.join(REPO, "handwritten_chinese_ocr_samples_torch", "assets",
                   "demo_hard")
WIDTHS = (512, 1024, 1600)
BATCH = 8
# the skip-search route of demo/hard/RESULTS.md (grid-searched knobs)
SS = dict(lm_panelty=0.8, len_bonus=0.0)


def convert(demo: str, out: str) -> None:
    """The recognizer and the LM, as the port reads them."""
    import jax
    import numpy as np
    import torch

    from handwritten_chinese_ocr_samples_tpu.eval.driver import (
        load_recognizer_variables)
    from handwritten_chinese_ocr_samples_tpu.lm.io import load_lm
    from handwritten_chinese_ocr_samples_torch.utils.weights import (
        flax_to_torch, lm_flax_to_torch)

    os.makedirs(os.path.join(out, "lm"), exist_ok=True)
    variables = load_recognizer_variables(os.path.join(demo, "checkpoint"))
    torch.save(flax_to_torch(jax.tree.map(np.asarray, variables)),
               os.path.join(out, "hctr_tiny.pt"))
    _, lm_vars, _ = load_lm(os.path.join(demo, "lm"))
    torch.save(lm_flax_to_torch(jax.tree.map(np.asarray, lm_vars["params"])),
               os.path.join(out, "lm", "weights.pt"))
    for name in ("config.json", "dict.txt"):
        shutil.copy(os.path.join(demo, "lm", name),
                    os.path.join(out, "lm", name))


def reference_texts(demo: str, n_lines: int | None = None,
                    routes=("greedy", "beam", "ss")) -> dict:
    """The JAX engine's texts for the test split (its first ``n_lines``)
    on ``routes``."""
    import jax.numpy as jnp

    from handwritten_chinese_ocr_samples_tpu.core.codec import CTCCodec
    from handwritten_chinese_ocr_samples_tpu.decode.lm_interface import (
        build_lm_backend)
    from handwritten_chinese_ocr_samples_tpu.eval.driver import (
        load_recognizer_variables)
    from handwritten_chinese_ocr_samples_tpu.models.registry import (
        get_model_info)
    from handwritten_chinese_ocr_samples_tpu.serve.engine import (
        ServingEngine)

    data = os.path.join(demo, "data")
    test_dir = os.path.join(data, "test")
    files = sorted(f for f in os.listdir(test_dir)
                   if f.endswith(".png"))[:n_lines]
    paths = [os.path.join(test_dir, f) for f in files]
    model, characters = get_model_info("hctr-tiny", data_dir=data,
                                       dtype=jnp.float32)
    codec = CTCCodec(characters)
    variables = load_recognizer_variables(os.path.join(demo, "checkpoint"))
    lm = build_lm_backend(tfm_path=os.path.join(demo, "lm"), use_tfm=True)
    settings = {
        "greedy": dict(decode_method="greedy-search"),
        "beam": dict(decode_method="beam-search"),
        "ss": dict(decode_method="beam-search", lm=lm, use_lm_pred=True,
                   use_lm_score=True, skip_search=True, lm_f32=True, **SS),
    }
    out = {"files": files, "widths": list(WIDTHS), "batch": BATCH,
           "recognizer_dtype": "float32",
           "ss_route": "-dm beam-search -utp -uts -tp lm -ss -lp 0.8 -lb 0.0"
                       " --lm-f32"}
    for name in routes:
        kw = settings[name]
        t0 = time.time()
        engine = ServingEngine(model, variables, codec, widths=WIDTHS, **kw)
        out[name], _ = engine.infer_files_batched(paths, batch_size=BATCH)
        print(f"{name}: {len(paths)} lines in {time.time() - t0:.1f} s",
              flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--demo", default=DEMO)
    parser.add_argument("--out", default=OUT)
    parser.add_argument("--skip-texts", action="store_true",
                        help="convert the weights only")
    args = parser.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    convert(args.demo, args.out)
    if not args.skip_texts:
        with open(os.path.join(args.out, "texts.json"), "w") as f:
            json.dump(reference_texts(args.demo), f, ensure_ascii=False,
                      indent=0)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
