"""Char-corpus -> n-gram ARPA (+ optional HBLM) — the ``lmplz`` role (the
JAX package's ``cli/lm_train_ngram.py``, with the flags it has).

The reference's LM recipe (`third-party/README.md:21-38`) shells out to
kenlm: ``lmplz -o 5 < corpus > model.arpa`` then ``build_binary``. This
CLI is the first-party equivalent over the same char-spaced corpus format
(``lm/corpus.py`` output):

    python -m handwritten_chinese_ocr_samples_torch.cli.lm_train_ngram \
        corpus.txt model.arpa -o 5 --chars-list chars_list.txt \
        --hblm model.hblm
"""

from __future__ import annotations

import argparse
import sys
import time


def build_argparser():
    parser = argparse.ArgumentParser(
        description="Estimate a Witten-Bell n-gram ARPA model from a "
                    "space-separated char corpus")
    parser.add_argument("corpus", help="corpus file (.txt / .txt.gz), one "
                                       "space-separated sentence per line")
    parser.add_argument("out", help="output ARPA file")
    parser.add_argument("-o", "--order", type=int, default=5,
                        help="model order (default 5, as the reference "
                             "recipe)")
    parser.add_argument("--chars-list", default=None,
                        help="restrict the vocabulary to this chars_list "
                             "file; out-of-list tokens count as <unk>")
    parser.add_argument("--hblm", default=None,
                        help="also binarize the result to this HBLM path")
    return parser


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from ..lm.ngram_train import train_ngram_arpa

    vocab = None
    if args.chars_list:
        with open(args.chars_list, encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f if line.rstrip("\n")]

    t0 = time.monotonic()
    sizes = train_ngram_arpa(args.corpus, args.out, order=args.order,
                             vocab=vocab)
    took = time.monotonic() - t0
    pretty = " ".join(f"{k}={v}" for k, v in sorted(sizes.items()))
    print(f"wrote {args.out}: {pretty} ({took:.2f}s)")

    if args.hblm:
        from ..lm.hblm import build_hblm
        build_hblm(args.out, args.hblm)
        print(f"wrote {args.hblm}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
