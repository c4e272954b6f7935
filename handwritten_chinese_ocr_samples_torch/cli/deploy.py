"""Serving CLI on the card (the JAX package's ``cli/deploy.py``).

    python -m handwritten_chinese_ocr_samples_torch.cli.deploy \\
        -m <weights.pt | seed:<n>> -i <image or folder> [-dm beam-search] \\
        [-b 4] [--daemon] [-cl chars_list.txt] [-d cuda] \\
        [-utp -uts -tp <lm dir | seed:<n>> [-ss] [--lm-int8]] \\
        [-ss -kp <ngram>] [--int8]

``-m`` takes a torch state dict saved with ``torch.save`` (for example
``utils.weights.flax_to_torch`` of a JAX checkpoint, converted where JAX is
installed), a reference ``.pth``/``.pth.tar`` checkpoint
(``compat/torch_convert.py``) or ``seed:<n>``, random full-size weights
from a seed. ``-tp``
takes an LM directory (``config.json``, ``dict.txt``, ``weights.pt``) or
``seed:<n>``, the ``char-512x6`` LM with random weights over the ``-cl``
characters; ``-dm beam-search -uts -tp ...`` serves the LM-fused device
search, and ``-ss`` its skip search (the production LM route; ``--prune``,
``--seg-budget``, ``--run-max``, ``--ctx-ladder`` and ``--fused-commit``
size it). ``-kp`` takes an n-gram LM (text ARPA or HBLM) that scores the
beams of the host beam search, which also serves ``-ss`` without a
transformer LM and ``-utp`` without ``-uts``. ``--int8`` serves the
recognizer's convs in int8, calibrated on the first request's batch;
``--lm-int8`` runs the LM-fused search's LM step in int8. The flags are the
JAX CLI's.
"""

from __future__ import annotations

import argparse
import logging as log
import os
import sys


def build_argparser():
    parser = argparse.ArgumentParser(description="HCTR OCR serving (PyTorch)")
    args = parser.add_argument_group("Options")
    args.add_argument("-lang", "--language", type=str, default="hctr",
                      choices=["hctr", "hctr-tiny"],
                      help="model language/scenario tag")
    args.add_argument("-m", "--model", type=str, required=True,
                      metavar="PATH", help="torch state dict (.pt) or "
                      "'seed:<n>' for seeded random weights")
    args.add_argument("-i", "--input", type=str, required=True, metavar="PATH",
                      help="input image or folder")
    args.add_argument("-d", "--device", type=str, default="cuda",
                      help="torch device")
    args.add_argument("-ni", "--number-iter", type=int, default=20,
                      help="number of inference iterations (latency avg)")
    args.add_argument("-b", "--batch-size", type=int, default=1,
                      help="folder inputs: serve in width-bucketed batches "
                           "of this size (1 = one image per call)")
    args.add_argument("--daemon", action="store_true",
                      help="serve the input folder through the deadline-"
                           "batching request-queue daemon")
    args.add_argument("--max-delay-ms", type=float, default=50.0,
                      help="daemon mode: max per-request queueing latency")
    args.add_argument("--stdin", dest="stdin_stream", action="store_true",
                      help="daemon mode: read image paths from stdin (one "
                           "per line), write 'path\\tprediction' to stdout "
                           "as each resolves; exits after EOF drains")
    args.add_argument("-cl", "--chars-list", type=str, default=None,
                      help="chars_list.txt path")
    args.add_argument("-w", "--widths", type=str, default="512,1024,1600",
                      help="comma-separated serving width buckets")
    args.add_argument("-dm", "--method", type=str, default="greedy-search",
                      choices=["greedy-search", "beam-search"],
                      help="decode method")
    args.add_argument("-bs", "--beam-size", dest="beam_size", type=int,
                      default=10)
    args.add_argument("-sd", "--search-depth", dest="search_depth", type=int,
                      default=10)
    args.add_argument("-lb", "--len-bonus", dest="len_bonus", type=float,
                      default=5.7)
    args.add_argument("-tp", "--tfm-path", dest="tfm_path", type=str,
                      default="", help="char LM: a directory (config.json, "
                      "dict.txt, weights.pt) or 'seed:<n>'")
    args.add_argument("-kp", "--kenlm-path", dest="kenlm_path", type=str,
                      default="", help="n-gram LM (text ARPA or HBLM) "
                      "scoring the beams of the host beam search")
    args.add_argument("-utp", "--use-tfm-pred", dest="use_tfm_pred",
                      action="store_true",
                      help="LM proposes candidates")
    args.add_argument("-uts", "--use-tfm-score", dest="use_tfm_score",
                      action="store_true", help="LM scores the beams")
    args.add_argument("-lp", "--lm-panelty", dest="lm_panelty", type=float,
                      default=1.9)
    # LM-fused search sizing (0 = auto from each batch; decode/adaptive.py)
    args.add_argument("-lc", "--lm-ctx", dest="lm_ctx", type=int, default=0)
    args.add_argument("-g", "--lm-group", dest="lm_group", type=int,
                      default=8)
    args.add_argument("--lm-f32", dest="lm_f32", action="store_true",
                      help="run the LM in f32 (default bf16)")
    args.add_argument("-ss", "--skip-search", action="store_true",
                      help="the skip search: confident frames skip the "
                           "candidate search")
    args.add_argument("--seg-budget", dest="seg_budget", type=int, default=0,
                      help="skip search: segments a line (0 = auto)")
    args.add_argument("--run-max", dest="run_max", type=int, default=8,
                      help="skip search: char-fast frames a segment")
    args.add_argument("--prune", dest="prune", type=float, default=0.001,
                      metavar="P", help="skip search: a frame with more or "
                      "fewer than one class above probability P is searched")
    args.add_argument("--ctx-ladder", dest="ctx_ladder", type=int,
                      default=112, help="skip search: first-rung KV depth "
                      "of the context ladder (0 = off)")
    args.add_argument("--fused-commit", dest="fused_commit",
                      action="store_true", help="skip search: write a run's "
                      "tokens with the next reorder")
    args.add_argument("--lm-int8", dest="lm_int8", action="store_true",
                      help="int8-quantize the fused LM's FF and logits "
                           "matmuls")
    args.add_argument("--int8", dest="int8", action="store_true",
                      help="post-training int8 quantization of the "
                           "recognizer convs (calibrated on the first "
                           "request)")
    return parser


def load_weights(spec: str, model):
    """``seed:<n>`` -> seeded random weights; a reference ``.pth`` or
    ``.pth.tar`` -> its converted state dict; a packed ``.pt.xz``
    (``utils.weights.load_packed``: its parts and manifest beside it) -> its
    state dict in f32; else a ``torch.save``d state dict or a checkpoint of
    the port's trainer."""
    import torch
    from ..train.checkpoint import state_dict_of
    from ..utils.weights import (PACKED_SUFFIX, load_packed,
                                 normalize_serving_dtype, seeded_state_dict)
    if spec.startswith("seed:"):
        return seeded_state_dict(model, int(spec.split(":", 1)[1]))
    if spec.endswith((".pth", ".pth.tar")):
        from ..compat.torch_convert import convert_checkpoint
        return convert_checkpoint(spec)
    if spec.endswith(PACKED_SUFFIX):
        return normalize_serving_dtype(load_packed(spec))
    if os.path.isdir(spec):
        raise ValueError(
            f"{spec} is a directory (an orbax checkpoint?): the port reads "
            "torch state dicts; convert with utils.weights.flax_to_torch "
            "where JAX is installed")
    return state_dict_of(torch.load(spec, map_location="cpu",
                                    weights_only=True))


def main(argv=None):
    log.basicConfig(format="[ %(levelname)s ] %(message)s", level=log.INFO,
                    stream=sys.stdout)
    parser = build_argparser()
    args = parser.parse_args(argv)
    import torch
    from ..core.codec import CTCCodec
    from ..models.registry import get_model_info
    from ..serve.engine import ServingEngine

    model, characters = get_model_info(
        args.language,
        data_dir=args.input if os.path.isdir(args.input) else None,
        chars_list_file=args.chars_list, dtype=torch.bfloat16)
    codec = CTCCodec(characters)
    lm = None
    if args.method == "beam-search":
        from ..decode.lm_interface import build_lm_backend
        # LM wiring as `deploy.py:76-87` / `ctc_codec.py:101-122`
        lm = build_lm_backend(
            args.tfm_path, kenlm_path=args.kenlm_path,
            use_tfm=args.use_tfm_pred or args.use_tfm_score,
            chars_list=characters)
    widths = tuple(int(w) for w in args.widths.split(","))
    engine = ServingEngine(
        model, load_weights(args.model, model), codec, widths=widths,
        decode_method=args.method, beam_size=args.beam_size,
        search_depth=args.search_depth, lm_panelty=args.lm_panelty,
        len_bonus=args.len_bonus, lm=lm, use_lm_pred=args.use_tfm_pred,
        use_lm_score=args.use_tfm_score or bool(args.kenlm_path),
        skip_search=args.skip_search,
        lm_ctx=args.lm_ctx, lm_group=args.lm_group,
        seg_budget=args.seg_budget, run_max=args.run_max,
        ctx_ladder=args.ctx_ladder, fused_commit=args.fused_commit,
        lm_f32=args.lm_f32, lm_int8=args.lm_int8, int8=args.int8,
        prune=args.prune, device=args.device)
    lm_name = "" if lm is None else ", LM " + getattr(lm, "path",
                                                      args.tfm_path)
    log.info(f"Serving {args.language} on {engine.device} "
             f"(widths {widths}, {args.method}{lm_name}; decoder "
             f"{engine.route.decoder})")

    if args.daemon and args.stdin_stream:
        return serve_stdin(engine, args)

    if os.path.isfile(args.input):
        files = [args.input]
        iters = args.number_iter
    else:
        files = [os.path.join(args.input, f)
                 for f in sorted(os.listdir(args.input))
                 if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))]
        iters = 1

    if args.daemon:
        import time
        from concurrent.futures import ThreadPoolExecutor
        from ..serve.daemon import ServingDaemon
        bs = max(args.batch_size, 1)
        with ServingDaemon(engine, batch_size=bs,
                           max_delay_ms=args.max_delay_ms) as daemon, \
                ThreadPoolExecutor(max_workers=8) as pool:
            t0 = time.perf_counter()
            futs = list(pool.map(daemon.submit, files))
            texts = [f.result() for f in futs]
            dt = time.perf_counter() - t0
        for f, t in zip(files, texts):
            log.info(f"Showing the prediction...\nfile:\t{f}\npred:\t{t}")
        log.info(f"Daemon throughput: {len(files) / dt:.2f} lines/sec "
                 f"(batch {bs}, deadline {args.max_delay_ms} ms)")
    elif args.batch_size > 1 and len(files) > 1:
        texts, lps = engine.infer_files_batched(
            files, batch_size=args.batch_size)
        for f, t in zip(files, texts):
            log.info(f"Showing the prediction...\nfile:\t{f}\npred:\t{t}")
        log.info(f"Batched throughput: {lps:.2f} lines/sec "
                 f"(batch {args.batch_size})")
    else:
        texts, avg_ms = engine.infer_files(files, iterations=iters)
        for f, t in zip(files, texts):
            log.info(f"Showing the prediction...\nfile:\t{f}\npred:\t{t}")
        log.info(f"Average latency: {avg_ms} ms")
    return texts


def serve_stdin(engine, args) -> None:
    """Continuous service loop: stdin paths -> ``path\tprediction`` lines on
    stdout as each resolves (errors as ``path\tERROR: ...``). EOF stops
    intake; queued requests drain before exit."""
    import threading
    from ..serve.daemon import ServingDaemon

    out_lock = threading.Lock()

    def emit(path, fut):
        try:
            line = f"{path}\t{fut.result()}"
        except Exception as e:  # noqa: BLE001 - reported per request
            line = f"{path}\tERROR: {e}"
        with out_lock:
            print(line, flush=True)

    bs = max(args.batch_size, 1)
    log.info(f"daemon ready (batch {bs}, deadline {args.max_delay_ms} ms); "
             f"reading image paths from stdin")
    with ServingDaemon(engine, batch_size=bs,
                       max_delay_ms=args.max_delay_ms) as daemon:
        for raw in sys.stdin:
            path = raw.strip()
            if not path:
                continue
            try:
                fut = daemon.submit(path)
            except Exception as e:  # noqa: BLE001 - unreadable file etc.
                with out_lock:
                    print(f"{path}\tERROR: {e}", flush=True)
                continue
            fut.add_done_callback(lambda f, p=path: emit(p, f))
    log.info("stdin closed; drained")


if __name__ == "__main__":
    main()
