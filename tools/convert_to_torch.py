"""Convert the trained ``demo/hard`` artifact for the PyTorch port, and record
the JAX package's texts on its test split as the port's reference.

    env JAX_PLATFORMS=cpu python tools/convert_to_torch.py
    env JAX_PLATFORMS=cpu python tools/convert_to_torch.py --skip-texts
    env JAX_PLATFORMS=cpu python tools/convert_to_torch.py --int8

Reads ``demo/hard/checkpoint`` (the trained ``hctr-tiny``) and
``demo/hard/lm`` (the trained 128d/3L char LM, orbax ``weights/``) with the
JAX package, and writes with the port's ``utils.weights`` into
``handwritten_chinese_ocr_samples_torch/assets/demo_hard/``:

  * ``hctr_tiny.pt``: the recognizer's state dict (f32, as stored);
  * ``lm/``: ``config.json``, ``dict.txt`` and ``weights.pt``, a directory
    that the port's ``lm/io.load_lm`` reads;
  * ``texts.json``: the JAX ``ServingEngine``'s texts for every line of
    ``demo/hard/data/test``, with the recognizer in f32, batch 8: on the
    greedy route, the plain device beam, the LM-fused skip search
    (``-dm beam-search -utp -uts -tp lm -ss -lp 0.8 -lb 0.0``, LM in f32,
    the CLI's other defaults), and the three host-beam routes of
    ``HOST_ROUTES`` (the n-gram skip search, the skip search without an LM,
    LM proposals alone with the LM in f32); and, under ``eval``, the JAX
    eval CLI's (``cli/test.py -bm``, recognizer in bf16) texts and CER for
    the three commands of ``demo/hard/RESULTS.md`` at ``-b 8``, each with
    its command line. ``chip_smoke.py`` holds the card's texts against
    them.

``--full`` converts the trained full-size ``demo/full`` artifact instead:
``demo/full/checkpoint`` (the 38M ``hctr``) and ``demo/full/lm`` (the
512d/6L char LM) into
``handwritten_chinese_ocr_samples_torch/assets/demo_full/``:

  * ``hctr.pt.xz``: the recognizer's state dict in the dtypes the checkpoint
    stores (bf16), packed by the port's ``utils.weights.save_packed``
    (``torch.save``, ``lzma``, parts ``hctr.pt.xz.0``, ``.1``, ... of at
    most 48 MB, the manifest ``hctr.pt.xz.json``);
  * ``lm/``: ``config.json``, ``dict.txt`` and ``weights.pt.xz`` packed the
    same way;
  * ``texts.json``: the JAX eval CLI's texts and CER (``cli/test.py -bm -b
    25``, recognizer in bf16) for ``demo/full/RESULTS.md``'s two commands
    (``FULL_EVAL_COMMANDS``), each with its command line, and under
    ``engine_greedy`` and ``engine_ss`` the JAX ``ServingEngine``'s texts
    at batch 8 on its width buckets (which pad a line otherwise than the
    eval's batches do), bf16, greedy and the skip search at RESULTS.md's
    lp and lb; every route on all 150 test lines.

    env JAX_PLATFORMS=cpu python tools/convert_to_torch.py --full
    env JAX_PLATFORMS=cpu python tools/convert_to_torch.py --full --skip-texts

``--int8`` writes ``int8.json`` alone, the int8 reference (``texts.json``
is not regenerated: its ``-utp`` route takes about 10 minutes): the JAX
``ServingEngine``'s calibration tree on its first batch of 8 (recognizer in
f32), its int8 texts for the test split on the greedy route and on the
skip search with the int8 LM (``-ss --lm-int8 --lm-f32``, lp 0.8, lb 0.0),
and the JAX eval CLI's texts and CER for ``INT8_EVAL_COMMANDS`` (``--int8``,
recognizer in bf16, ``-b 8``).

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
NGRAM = os.path.join(DEMO, "lm", "ngram.hblm")
# the host-beam routes: ServingEngine keywords (with "lm" naming the
# backend) and the deploy CLI's flags
HOST_ROUTES = {
    "ngram_ss": (dict(lm="ngram", use_lm_score=True, skip_search=True, **SS),
                 "-dm beam-search -ss -kp demo/hard/lm/ngram.hblm -lp 0.8 "
                 "-lb 0.0"),
    "ss_nolm": (dict(skip_search=True, **SS),
                "-dm beam-search -ss -lp 0.8 -lb 0.0"),
    "utp": (dict(lm="tfm", use_lm_pred=True, **SS),
            "-dm beam-search -utp -tp lm -lp 0.8 -lb 0.0"),
}
# demo/hard/RESULTS.md's three eval commands (cli/test.py -bm, after
# "-m hctr-tiny -f <weights> -i demo/hard/data -bm -b 8")
EVAL_BATCH = 8
EVAL_COMMANDS = {
    "greedy": ["-dm", "greedy-search"],
    "lm_ss": ["-dm", "beam-search", "-utp", "-uts", "-tp", "LM", "-ss",
              "-lp", "0.8", "-lb", "0.0"],
    "ngram_ss": ["-dm", "beam-search", "-ss", "-kp", "NGRAM", "-lp", "0.8",
                 "-lb", "0.0"],
}


# the int8 eval commands: RESULTS.md's greedy and LM -ss commands with the
# int8 flags
INT8_EVAL_COMMANDS = {
    "greedy": EVAL_COMMANDS["greedy"] + ["--int8"],
    "lm_ss": EVAL_COMMANDS["lm_ss"] + ["--int8", "--lm-int8"],
}

FULL = os.path.join(REPO, "demo", "full")
FULL_OUT = os.path.join(REPO, "handwritten_chinese_ocr_samples_torch",
                        "assets", "demo_full")
FULL_BATCH = 25
# demo/full/RESULTS.md's two eval commands (tools/make_fullsize_demo.py:
# 500-510 with its grid search's lp 0.8 and lb 4.0), after "-m hctr -f
# <weights> -i demo/full/data -cl demo/full/data/chars_list.txt -bm -b 25"
FULL_EVAL_COMMANDS = {
    "greedy": ["-dm", "greedy-search"],
    "lm_ss": ["-dm", "beam-search", "-utp", "-uts", "-ss", "-tp", "LM",
              "-lp", "0.8", "-lb", "4.0"],
}
# the same routes through ServingEngine at this batch, its default buckets
FULL_ENGINE_BATCH = 8


def eval_argv(name: str, model_file: str, data: str, lm_dir: str,
              ngram: str = NGRAM, batch: int = EVAL_BATCH,
              commands=EVAL_COMMANDS, model: str = "hctr-tiny",
              extra=()) -> list:
    """The eval CLI's arguments of ``commands[name]``."""
    subst = {"LM": lm_dir, "NGRAM": ngram}
    return (["-m", model, "-f", model_file, "-i", data, *extra, "-bm", "-b",
             str(batch), "-tv", "-jw", "2"]
            + [subst.get(a, a) for a in commands[name]])


def parse_eval_output(out: str):
    """``(texts, CER)`` from the eval CLI's ``-tv`` output."""
    texts = [line[5:] for line in out.splitlines() if line.startswith("PRE: ")]
    cer = [float(line.split(":", 1)[1]) for line in out.splitlines()
           if line.startswith("Total Test CER:")]
    return texts, cer[-1]


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


def convert_full(demo: str = FULL, out: str = FULL_OUT) -> dict:
    """The full-size recognizer and LM in their stored dtypes, packed as
    the port reads them; returns each packed file's manifest."""
    import jax
    import numpy as np
    import torch

    from handwritten_chinese_ocr_samples_tpu.utils.ckpt_io import (
        restore_pytree_host)
    from handwritten_chinese_ocr_samples_torch.utils.weights import (
        flax_to_torch, lm_flax_to_torch, save_packed)

    def stored(convert, collection: str, tree) -> dict:
        """``convert``'s f32 state dict of the orbax ``tree`` cast back to
        the one dtype its leaves are stored in (bf16 -> f32 -> bf16 is
        exact)."""
        leaves = jax.tree.leaves(tree)
        dtypes = {np.dtype(a.dtype).name for a in leaves}
        if len(dtypes) != 1:
            raise ValueError(f"{collection} mixes dtypes {sorted(dtypes)}")
        dtype = getattr(torch, dtypes.pop())
        state = convert({collection: jax.tree.map(np.asarray, tree)})
        return {k: v.to(dtype) for k, v in state.items()}

    os.makedirs(os.path.join(out, "lm"), exist_ok=True)
    payload = restore_pytree_host(os.path.join(demo, "checkpoint"))
    manifests = {"hctr": save_packed(
        {**stored(flax_to_torch, "params", payload["params"]),
         **stored(flax_to_torch, "batch_stats", payload["batch_stats"])},
        os.path.join(out, "hctr.pt.xz"))}
    lm_params = restore_pytree_host(
        os.path.join(demo, "lm", "weights"))["params"]
    manifests["lm"] = save_packed(
        stored(lambda t: lm_flax_to_torch(t["params"]), "params", lm_params),
        os.path.join(out, "lm", "weights.pt.xz"))
    for name in ("config.json", "dict.txt"):
        shutil.copy(os.path.join(demo, "lm", name),
                    os.path.join(out, "lm", name))
    return manifests


def reference_eval_full(demo: str = FULL) -> dict:
    """The JAX eval CLI's texts and CER for each of ``FULL_EVAL_COMMANDS``
    on ``demo/full``'s test split, bf16, ``-b 25``."""
    import contextlib
    import io

    from handwritten_chinese_ocr_samples_tpu.cli.test import build_argparser
    from handwritten_chinese_ocr_samples_tpu.eval.driver import run_benchmark

    data = os.path.join(demo, "data")
    chars = os.path.join(data, "chars_list.txt")
    shown = {"LM": "demo/full/lm"}
    out = {}
    for name in FULL_EVAL_COMMANDS:
        argv = eval_argv(name, os.path.join(demo, "checkpoint"), data,
                         os.path.join(demo, "lm"), batch=FULL_BATCH,
                         commands=FULL_EVAL_COMMANDS, model="hctr",
                         extra=("-cl", chars))
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_benchmark(build_argparser().parse_args(argv))
        texts, cer = parse_eval_output(buf.getvalue())
        seconds = time.time() - t0
        out[name] = {
            "command": " ".join(
                ["-m hctr -f demo/full/checkpoint -i demo/full/data -cl "
                 "demo/full/data/chars_list.txt -bm -b 25"]
                + [shown.get(a, a) for a in FULL_EVAL_COMMANDS[name]]),
            "lines": len(texts), "cer": cer, "texts": texts,
            "cpu_seconds": round(seconds, 1)}
        print(f"eval {name}: CER {cer}, {len(texts)} lines in "
              f"{seconds:.1f} s", flush=True)
    return out


def reference_engine_full(demo: str = FULL) -> dict:
    """The JAX ``ServingEngine``'s texts for ``demo/full``'s test split in
    the split's order, recognizer and LM in bf16, batch 8 on the buckets
    (512, 1024, 1600): greedy, and the skip search at RESULTS.md's lp 0.8
    and lb 4.0."""
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
    paths = [os.path.join(data, "test", n) for n in manifest_files(data)]
    model, characters = get_model_info("hctr", data_dir=data,
                                       dtype=jnp.bfloat16)
    codec = CTCCodec(characters)
    variables = load_recognizer_variables(os.path.join(demo, "checkpoint"))
    settings = {
        "engine_greedy": dict(decode_method="greedy-search"),
        "engine_ss": dict(
            decode_method="beam-search", use_lm_pred=True,
            use_lm_score=True, skip_search=True, lm_panelty=0.8,
            len_bonus=4.0, lm=build_lm_backend(
                tfm_path=os.path.join(demo, "lm"), use_tfm=True))}
    out = {}
    for name, kw in settings.items():
        t0 = time.time()
        engine = ServingEngine(model, variables, codec, **kw)
        texts, _ = engine.infer_files_batched(paths,
                                              batch_size=FULL_ENGINE_BATCH)
        seconds = time.time() - t0
        out[name] = {"texts": texts, "lines": len(texts),
                     "batch": FULL_ENGINE_BATCH,
                     "widths": list(engine.widths),
                     "cpu_seconds": round(seconds, 1)}
        print(f"{name}: {len(texts)} lines in {seconds:.1f} s", flush=True)
    return out


def manifest_files(data: str) -> list:
    """The test split's file names in its manifest's order, the eval's
    loader order."""
    with open(os.path.join(data, "test_img_id_gt.txt"),
              encoding="utf-8") as f:
        return [row.split(",", 1)[0] for row in f if "," in row]


def write_full_texts(demo: str, out: str) -> None:
    """``texts.json`` of ``demo/full``: every eval and engine route on
    every test line."""
    texts = {"files": manifest_files(os.path.join(demo, "data")),
             "batch": FULL_BATCH, "recognizer_dtype": "bfloat16",
             **reference_eval_full(demo), **reference_engine_full(demo)}
    with open(os.path.join(out, "texts.json"), "w", encoding="utf-8") as f:
        json.dump(texts, f, ensure_ascii=False, indent=0)


def reference_texts(demo: str, n_lines: int | None = None,
                    routes=("greedy", "beam", "ss", *HOST_ROUTES)) -> dict:
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
    files, paths = test_paths(demo, n_lines)
    model, characters = get_model_info("hctr-tiny", data_dir=data,
                                       dtype=jnp.float32)
    codec = CTCCodec(characters)
    variables = load_recognizer_variables(os.path.join(demo, "checkpoint"))
    lm = build_lm_backend(tfm_path=os.path.join(demo, "lm"), use_tfm=True)
    lms = {"tfm": lm, "ngram": build_lm_backend(
        kenlm_path=os.path.join(demo, "lm", "ngram.hblm"))}
    settings = {
        "greedy": dict(decode_method="greedy-search"),
        "beam": dict(decode_method="beam-search"),
        "ss": dict(decode_method="beam-search", lm=lm, use_lm_pred=True,
                   use_lm_score=True, skip_search=True, lm_f32=True, **SS),
    }
    for name, (kw, _) in HOST_ROUTES.items():
        kw = dict(kw, decode_method="beam-search", lm_f32=True)
        kw["lm"] = lms.get(kw.get("lm"))
        settings[name] = kw
    out = {"files": files, "widths": list(WIDTHS), "batch": BATCH,
           "recognizer_dtype": "float32",
           "ss_route": "-dm beam-search -utp -uts -tp lm -ss -lp 0.8 -lb 0.0"
                       " --lm-f32",
           "host_routes": {k: v[1] for k, v in HOST_ROUTES.items()}}
    for name in routes:
        kw = settings[name]
        t0 = time.time()
        engine = ServingEngine(model, variables, codec, widths=WIDTHS, **kw)
        out[name], _ = engine.infer_files_batched(paths, batch_size=BATCH)
        print(f"{name}: {len(paths)} lines in {time.time() - t0:.1f} s",
              flush=True)
    return out


def reference_eval(demo: str, data: str | None = None,
                   commands=tuple(EVAL_COMMANDS),
                   table=EVAL_COMMANDS) -> dict:
    """The JAX eval CLI's texts and CER for ``commands`` (keys of
    ``table``) on the test split of ``data`` (``demo``'s own by default), in
    bf16 at ``-b 8``."""
    import contextlib
    import io

    from handwritten_chinese_ocr_samples_tpu.cli.test import build_argparser
    from handwritten_chinese_ocr_samples_tpu.data.dataset import ImageDataset
    from handwritten_chinese_ocr_samples_tpu.eval.driver import run_benchmark

    data = data or os.path.join(demo, "data")
    n = len(ImageDataset(data, (1, 128), "test", batch_size=EVAL_BATCH))
    files = [os.path.basename(p) for p, _ in ImageDataset(
        data, (1, 128), "test").data_list[:n]]
    out = {}
    for name in commands:
        argv = eval_argv(name, os.path.join(demo, "checkpoint"), data,
                         os.path.join(demo, "lm"),
                         ngram=os.path.join(demo, "lm", "ngram.hblm"),
                         commands=table)
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_benchmark(build_argparser().parse_args(argv))
        texts, cer = parse_eval_output(buf.getvalue())
        shown = {"LM": "demo/hard/lm", "NGRAM": "demo/hard/lm/ngram.hblm"}
        out[name] = {"command": " ".join(shown.get(a, a)
                                         for a in table[name]),
                     "cer": cer, "texts": texts}
        print(f"eval {name}: CER {cer}, {len(texts)} lines in "
              f"{time.time() - t0:.1f} s", flush=True)
    return {"files": files, "batch": EVAL_BATCH,
            "recognizer_dtype": "bfloat16", **out}


def test_paths(demo: str, n_lines: int | None = None) -> tuple:
    """The test split's file names (sorted) and paths, its first
    ``n_lines``."""
    test_dir = os.path.join(demo, "data", "test")
    files = sorted(f for f in os.listdir(test_dir)
                   if f.endswith(".png"))[:n_lines]
    return files, [os.path.join(test_dir, f) for f in files]


def first_batch(demo: str):
    """The JAX engine's first serving batch of the test split (the batch
    its int8 engine calibrates on), ``(8, 128, W, 1)`` uint8: the first
    ``BATCH`` lines of the first line's width bucket, in file order."""
    import numpy as np

    from handwritten_chinese_ocr_samples_tpu.serve.engine import (
        _pad_fixed_shape, _read_gray)
    _, paths = test_paths(demo)
    batch, first = [], None
    for p in paths:
        src = _read_gray(p)
        w = int(128 * src.shape[1] / src.shape[0])
        bucket = next((b for b in WIDTHS if w <= b), WIDTHS[-1])
        first = first or bucket
        if bucket == first:
            batch.append(_pad_fixed_shape(src, 128, bucket))
        if len(batch) == BATCH:
            return np.concatenate(batch)
    raise ValueError(f"fewer than {BATCH} lines in the first bucket")


def reference_int8(demo: str, n_lines: int | None = None) -> dict:
    """The JAX int8 engine's calibration tree and texts (greedy, and the
    skip search with the int8 LM), recognizer and LM in f32, batch 8."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from handwritten_chinese_ocr_samples_tpu.core.codec import CTCCodec
    from handwritten_chinese_ocr_samples_tpu.decode.lm_interface import (
        build_lm_backend)
    from handwritten_chinese_ocr_samples_tpu.eval.driver import (
        load_recognizer_variables)
    from handwritten_chinese_ocr_samples_tpu.models.registry import (
        get_model_info)
    from handwritten_chinese_ocr_samples_tpu.serve.engine import (
        ServingEngine)

    files, paths = test_paths(demo, n_lines)
    data = os.path.join(demo, "data")
    model, characters = get_model_info("hctr-tiny", data_dir=data,
                                       dtype=jnp.float32)
    codec = CTCCodec(characters)
    variables = load_recognizer_variables(os.path.join(demo, "checkpoint"))
    lm = build_lm_backend(tfm_path=os.path.join(demo, "lm"), use_tfm=True)
    settings = {
        "greedy": dict(decode_method="greedy-search"),
        "ss": dict(decode_method="beam-search", lm=lm, use_lm_pred=True,
                   use_lm_score=True, skip_search=True, lm_f32=True,
                   lm_int8=True, **SS),
    }
    out = {"files": files, "widths": list(WIDTHS), "batch": BATCH,
           "recognizer_dtype": "float32",
           "ss_route": "-dm beam-search -utp -uts -tp lm -ss -lp 0.8 -lb 0.0"
                       " --lm-f32 --int8 --lm-int8"}
    trees = []
    for name, kw in settings.items():
        t0 = time.time()
        engine = ServingEngine(model, variables, codec, widths=WIDTHS,
                               int8=True, **kw)
        out[name], _ = engine.infer_files_batched(paths, batch_size=BATCH)
        trees.append(jax.tree.map(lambda a: float(np.float32(a)),
                                  engine._quant))
        print(f"int8 {name}: {len(paths)} lines in {time.time() - t0:.1f} s",
              flush=True)
    if trees[0] != trees[1]:
        raise AssertionError("the two engines calibrated differently")
    out["calibration"] = trees[0]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--demo", default=DEMO)
    parser.add_argument("--out", default=OUT)
    parser.add_argument("--skip-texts", action="store_true",
                        help="convert the weights only")
    parser.add_argument("--int8", action="store_true",
                        help="write int8.json alone")
    parser.add_argument("--full", action="store_true",
                        help="convert demo/full into assets/demo_full")
    args = parser.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.full:
        t0 = time.time()
        for name, m in convert_full(FULL, FULL_OUT).items():
            print(f"{name}: {m['raw_bytes']} bytes -> "
                  f"{[p['bytes'] for p in m['parts']]} "
                  f"({time.time() - t0:.1f} s)", flush=True)
        if not args.skip_texts:
            write_full_texts(FULL, FULL_OUT)
        print(f"wrote {FULL_OUT}")
        return 0
    if args.int8:
        ref = reference_int8(args.demo)
        ref["eval"] = reference_eval(args.demo, commands=tuple(
            INT8_EVAL_COMMANDS), table=INT8_EVAL_COMMANDS)
        with open(os.path.join(args.out, "int8.json"), "w") as f:
            json.dump(ref, f, ensure_ascii=False, indent=0)
        print(f"wrote {os.path.join(args.out, 'int8.json')}")
        return 0
    convert(args.demo, args.out)
    if not args.skip_texts:
        texts = reference_texts(args.demo)
        texts["eval"] = reference_eval(args.demo)
        with open(os.path.join(args.out, "texts.json"), "w") as f:
            json.dump(texts, f, ensure_ascii=False, indent=0)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
