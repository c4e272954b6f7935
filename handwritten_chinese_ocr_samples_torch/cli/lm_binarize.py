"""ARPA → HBLM binarizer — the ``kenlm build_binary`` role (the JAX
package's ``cli/lm_binarize.py``, with the flags it has).

The reference's recipe trains a 5-gram with kenlm's ``lmplz`` and then
binarizes it for fast load (`third-party/README.md`); its decode path
loads the result with ``kenlm.Model`` (`ctc_codec.py:120-122`). This CLI
converts a text ARPA model into the first-party HBLM mmap format
(``lm/hblm.py``), loadable by both the Python scorer and the native C++
CBS decoder:

    python -m handwritten_chinese_ocr_samples_torch.cli.lm_binarize \
        ngram.arpa ngram.hblm
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_argparser():
    parser = argparse.ArgumentParser(
        description="Convert a text ARPA n-gram model to HBLM binary")
    parser.add_argument("arpa", help="input ARPA file (.arpa / .arpa.gz)")
    parser.add_argument("out", help="output HBLM file (.hblm)")
    parser.add_argument("--check", action="store_true",
                        help="after writing, reload and cross-check "
                             "scores against the ARPA source")
    return parser


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from ..lm.hblm import HblmLM, build_hblm

    t0 = time.monotonic()
    build_hblm(args.arpa, args.out)
    build_s = time.monotonic() - t0

    t0 = time.monotonic()
    lm = HblmLM(args.out)
    load_s = time.monotonic() - t0
    size_mb = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out}: order={lm.order} vocab={len(lm.vocab)} "
          f"ngrams={lm.counts} {size_mb:.2f} MB "
          f"(build {build_s:.2f}s, load {load_s * 1e3:.1f} ms)")

    if args.check:
        from ..lm.arpa import ArpaLM
        src = ArpaLM(args.arpa)
        probe = [w for w in lm.vocab
                 if w not in ("<s>", "</s>", "<unk>")][:64]
        sent = " ".join(probe)
        for eos in (False, True):
            a, h = src.score(sent, eos=eos), lm.score(sent, eos=eos)
            if abs(a - h) > 1e-4:
                print(f"CHECK FAILED (eos={eos}): arpa={a} hblm={h}",
                      file=sys.stderr)
                return 1
        print("check ok: scores match the ARPA source")
    return 0


if __name__ == "__main__":
    sys.exit(main())
