"""Eval/inference CLI on the card (the JAX package's ``cli/test.py``; flag
surface of the reference's `test.py:24-106`).

    # single image, greedy
    python -m handwritten_chinese_ocr_samples_torch.cli.test \\
        -m hctr -f <weights.pt> -i image.png -dm greedy-search

    # CER on a test set
    python -m ...cli.test -m hctr-tiny -f <weights.pt> -i <data_dir> -bm -b 8

    # beam search + char LM (skip search), grid search over (lp, lb)
    python -m ...cli.test -m hctr-tiny -f <weights.pt> -i <data_dir> -bm \\
        -dm beam-search -utp -uts -tp <lm_dir> -ss -gs

    # beam search + n-gram (host beam, native decoder)
    python -m ...cli.test ... -bm -dm beam-search -ss -kp <ngram.hblm>

    # int8 recognizer convs (first-batch calibration), int8 LM step
    python -m ...cli.test ... -bm -dm greedy-search --int8
    python -m ...cli.test ... -bm -dm beam-search -utp -uts -tp <lm_dir> \\
        -ss --int8 --lm-int8

``-f`` takes the port's state dict (``torch.save``, e.g. ``utils.weights.
flax_to_torch`` of a JAX checkpoint), a checkpoint of the port's trainer
(``<model>_checkpoint``), a reference ``.pth``/``.pth.tar`` checkpoint
(``compat/torch_convert.py``) or ``seed:<n>``; ``-d cpu`` runs on the
CPU. ``--profile DIR`` writes a ``torch.profiler`` trace of the run (with
``-gs``, of the first grid point) into DIR. ``-m innovation`` stops with an
error, as the JAX CLI fails on the classifier's ``(B, classes)`` logits:
``cli/train.py -m innovation --test`` evaluates it. ``-dp N`` shards each
batch's rows over the first N cards from this one process (one weight
replica a card; ``-d cpu``: N CPU shards), as the JAX CLI shards over N
chips; N must divide ``-b`` and not exceed the visible cards.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_argparser():
    parser = argparse.ArgumentParser(description="HCTR OCR textline testing "
                                                 "(PyTorch)")
    args = parser.add_argument_group("Options")
    args.add_argument("-m", "--model-type", dest="model_type", type=str,
                      required=True,
                      choices=["hctr", "hctr-tiny", "innovation"],
                      help="target model for different languages/scenarios")
    args.add_argument("-f", "--model-file", dest="model_file", type=str,
                      metavar="PATH", required=True,
                      help="torch state dict (.pt), a checkpoint of the "
                           "port's trainer, a reference .pth/.pth.tar, or "
                           "'seed:<n>'")
    args.add_argument("-i", "--input", dest="input", type=str,
                      metavar="PATH", required=True,
                      help="path to input image or testset")
    args.add_argument("-d", "--device", type=str, default="cuda",
                      help="torch device")
    args.add_argument("-b", "--batch-size", dest="batch_size", type=int,
                      metavar="N", default=1, help="mini-batch size")
    args.add_argument("-bm", "--benchmark-mode", dest="benchmark_mode",
                      action="store_true",
                      help="benchmark CER on input testset")
    args.add_argument("-dm", "--decode-method", dest="decode_method",
                      type=str, default="beam-search",
                      choices=["greedy-search", "beam-search"],
                      help="method to decode the CTC output")
    args.add_argument("-ss", "--skip-search", dest="skip_search",
                      action="store_true",
                      help="skip high-confidence frames in beam search")
    args.add_argument("--prune", dest="prune", type=float, default=0.001,
                      metavar="P",
                      help="skip-search ambiguity threshold as a "
                           "probability (default 0.001, the reference's "
                           "`ctc_codec.py:128`)")
    args.add_argument("-kp", "--kenlm-path", dest="kenlm_path", type=str,
                      metavar="PATH", default="",
                      help="n-gram model (text ARPA or HBLM) for scoring "
                           "in beam search")
    args.add_argument("-utp", "--use-tfm-pred", dest="use_tfm_pred",
                      action="store_true",
                      help="use transformer LM for candidate prediction")
    args.add_argument("-tp", "--transformer-path", dest="tfm_path", type=str,
                      metavar="DIR", default="",
                      help="char LM: a directory (config.json, dict.txt, "
                           "weights.pt) or 'seed:<n>'")
    args.add_argument("-uts", "--use-tfm-score", dest="use_tfm_score",
                      action="store_true",
                      help="use transformer LM for scoring in beam search")
    args.add_argument("-bs", "--beam-size", dest="beam_size", type=int,
                      default=10, help="beam size for beam search")
    args.add_argument("-sd", "--search-depth", dest="search_depth", type=int,
                      default=10, help="search depth (top-k) for beam search")
    args.add_argument("-lp", "--lm-panelty", dest="lm_panelty", type=float,
                      default=0.8, help="LM penalty for sentence scoring")
    args.add_argument("-lb", "--len-bonus", dest="len_bonus", type=float,
                      default=4.8, help="length bonus for sentence scoring")
    # device LM-fused search sizing (0 = auto from each batch;
    # decode/adaptive.py)
    args.add_argument("-lc", "--lm-ctx", dest="lm_ctx", type=int, default=0,
                      help="LM KV-cache context length (0 = auto)")
    args.add_argument("-g", "--lm-group", dest="lm_group", type=int,
                      default=8, help="lines searched together by the "
                                      "device LM-fused search")
    args.add_argument("--seg-budget", dest="seg_budget", type=int, default=0,
                      help="skip search: segments a line (0 = auto)")
    args.add_argument("--run-max", dest="run_max", type=int, default=8,
                      help="skip search: char-fast frames a segment")
    args.add_argument("--ctx-ladder", dest="ctx_ladder", type=int,
                      default=112, help="skip search: first-rung KV depth "
                      "of the context ladder (0 = off)")
    args.add_argument("--fused-commit", dest="fused_commit",
                      action="store_true", help="skip search: write a run's "
                      "tokens with the next reorder")
    args.add_argument("--lm-f32", dest="lm_f32", action="store_true",
                      help="run the fused LM in float32 (default bfloat16)")
    args.add_argument("--lm-int8", dest="lm_int8", action="store_true",
                      help="int8-quantize the fused LM's FF and logits "
                           "matmuls (per-channel weight scales, dynamic "
                           "activation scale; attention/KV stay bf16)")
    args.add_argument("-dp", "--data-parallel", dest="data_parallel",
                      type=int, metavar="N", default=0,
                      help="shard eval batches over N devices (data-"
                           "parallel decode; 0 = single device)")
    args.add_argument("--int8", dest="int8", action="store_true",
                      help="post-training int8 quantization of the "
                           "recognizer convs (calibrated on the first "
                           "batch)")
    args.add_argument("-jw", "--workers", type=int, metavar="N", default=4,
                      help="number of data loading workers (benchmark mode)")
    args.add_argument("-tv", "--test-verbose", dest="test_verbose",
                      action="store_true",
                      help="print PRE/TRU pairs during testing")
    args.add_argument("-pf", "--print-freq", dest="print_freq", type=int,
                      metavar="N", default=100, help="log print frequency")
    args.add_argument("-cl", "--chars-list", dest="chars_list", type=str,
                      default=None, help="explicit chars_list.txt path")
    args.add_argument("--host-beam", dest="host_beam", action="store_true",
                      help="force the host beam-search decoder")
    args.add_argument("--profile", default="", metavar="DIR",
                      help="write a torch.profiler trace of the run into "
                           "DIR (with -gs: first grid point only)")
    # hyper-param grid search (`test.py:92-105`)
    args.add_argument("-gs", "--grid-search", action="store_true",
                      help="grid search lm_panelty and len_bonus")
    args.add_argument("-al", "--alpha-lower", type=float, default=0.7)
    args.add_argument("-au", "--alpha-upper", type=float, default=1.1)
    args.add_argument("-ac", "--alpha-count", type=int, default=10)
    args.add_argument("-bl", "--beta-lower", type=float, default=4.2)
    args.add_argument("-bu", "--beta-upper", type=float, default=6.6)
    args.add_argument("-bc", "--beta-count", type=int, default=25)
    return parser


def run(args):
    from ..eval.driver import run_benchmark, run_single
    if args.benchmark_mode:
        return run_benchmark(args)
    return run_single(args)


def run_profiled(args):
    """``run``, inside a ``torch.profiler`` trace when ``--profile`` is
    set."""
    if not args.profile:
        return run(args)
    from ..utils.profiling import profile_trace
    with profile_trace(args.profile):
        result = run(args)
    print(f"profiler trace -> {args.profile}")
    return result


def main(argv=None):
    """Returns the CER (``-bm``), the best ``(lm_panelty, len_bonus, CER)``
    (``-gs``), or None (single mode)."""
    args = build_argparser().parse_args(argv)
    if not args.grid_search:
        return run_profiled(args)
    # grid search over (alpha=lm_panelty, beta=len_bonus), `test.py:349-382`
    best = (None, None, float("inf"))
    first = True
    for alpha in np.linspace(args.alpha_lower, args.alpha_upper,
                             args.alpha_count):
        for beta in np.linspace(args.beta_lower, args.beta_upper,
                                args.beta_count):
            args.lm_panelty = float(alpha)
            args.len_bonus = float(beta)
            print(f"grid search: lm_panelty={alpha:.3f} len_bonus={beta:.3f}")
            cer = run_profiled(args) if first else run(args)
            first = False
            if cer is not None and cer < best[2]:
                best = (alpha, beta, cer)
    print(f"best: lm_panelty={best[0]} len_bonus={best[1]} CER={best[2]}")
    return best


if __name__ == "__main__":
    main()
