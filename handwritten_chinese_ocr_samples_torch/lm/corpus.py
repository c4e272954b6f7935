"""LM corpus preparation: news2016zh JSON -> char-spaced training corpus
(the JAX package's ``lm/corpus.py``, a copy: pure Python).

Behavioral parity with the reference tool (`third-party/preprocess_news2016.py`):
extract each JSON line's ``content``; full-width -> half-width conversion
(``Q2B``, `preprocess_news2016.py:62-71`); drop characters outside the
``chars_list`` vocabulary; space-join the survivors one char apart
(`LineProcessor.process` :50-59). Chunks of lines go to a pool of
``spawn``ed worker processes, and the results are written in input order in
one streaming pass, with no intermediate per-worker files.

CLI: ``python -m handwritten_chinese_ocr_samples_torch.lm.corpus -cf ... -rf
... -cd ...`` mirroring the reference flags.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Iterable, List, Set


def q2b(uchar: str) -> str:
    """Full-width to half-width (`preprocess_news2016.py:62-71`)."""
    code = ord(uchar)
    if code == 0x3000:
        code = 0x0020
    else:
        code -= 0xFEE0
    if code < 0x0020 or code > 0x7E:
        return uchar
    return chr(code)


class LineProcessor:
    """Q2B -> vocabulary filter -> char spacing."""

    def __init__(self, chars_dict_path: str):
        self.common_char: Set[str] = set()
        with open(chars_dict_path, "r", encoding="utf-8") as f:
            for line in f:
                self.common_char.add(line.strip())

    def process(self, line: str) -> str:
        line = "".join(q2b(u) for u in line)
        line = "".join(c for c in line if c in self.common_char)
        return " ".join(line)


def iter_contents(json_path: str) -> Iterable[str]:
    with open(json_path, "r", encoding="utf-8") as f:
        for jline in f:
            if not jline.strip():
                continue
            content = json.loads(jline).get("content", "").strip()
            if content:
                yield content


def _process_chunk(args):
    chars_dict, chunk = args
    proc = LineProcessor(chars_dict)
    return [proc.process(line) for line in chunk]


def preprocess_corpus(corpus_file: str, result_file: str, chars_dict: str,
                      workers: int = 8, chunk_size: int = 2000) -> int:
    """Stream-preprocess the corpus; returns number of lines written."""
    n = 0
    with open(result_file, "w", encoding="utf-8") as out:
        if workers <= 1:
            proc = LineProcessor(chars_dict)
            for content in iter_contents(corpus_file):
                out.write(proc.process(content) + "\n")
                n += 1
            return n
        with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            chunk: List[str] = []

            def chunks():
                nonlocal chunk
                for content in iter_contents(corpus_file):
                    chunk.append(content)
                    if len(chunk) >= chunk_size:
                        yield (chars_dict, chunk)
                        chunk = []
                if chunk:
                    yield (chars_dict, chunk)

            for lines in pool.map(_process_chunk, chunks()):
                for line in lines:
                    out.write(line + "\n")
                    n += 1
    return n


def build_argparser():
    parser = argparse.ArgumentParser(
        description="News2016 preprocessing (PyTorch port)")
    args = parser.add_argument_group("Options")
    args.add_argument("-cf", "--corpus-file", type=str, metavar="PATH",
                      required=True, help="corpus json file (news2016zh)")
    args.add_argument("-rf", "--result-file", type=str, metavar="PATH",
                      required=True, help="preprocessed corpus output")
    args.add_argument("-cd", "--chars-dict", type=str, metavar="PATH",
                      required=True, help="valid character dictionary")
    args.add_argument("-j", "--workers", default=8, type=int, metavar="N")
    return parser


def main(argv=None):
    args = build_argparser().parse_args(argv)
    for p in (args.corpus_file, args.chars_dict):
        if not os.path.isfile(p):
            raise FileNotFoundError(p)
    n = preprocess_corpus(args.corpus_file, args.result_file,
                          args.chars_dict, workers=args.workers)
    print(f"done! {n} lines -> {args.result_file}")
    return n


if __name__ == "__main__":
    main()
